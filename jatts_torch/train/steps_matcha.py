"""Matcha-TTS loss assembly (counterpart of jatts_tpu/train/steps_matcha.py).

The schedule of the reference trainer: the forward-sum (CTC) loss, weighted
by ``lambda_align``, while ``step < dp_train_start_steps``; the duration
loss when ``step > dp_train_start_steps``; the binarization loss, weighted
by ``lambda_align``, when ``step > bin_loss_start_steps``. The JAX package
multiplies each term by a 0/1 gate so the whole schedule lives in one
compiled program; here a closed gate skips the forward-sum loss (its CTC
recursion is a Python loop over frames) and the duration loss, and reports
them as 0, which is the value and the gradient the gated product has.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from jatts_torch.ops.masks import sequence_mask


def matchatts_kwargs(batch: Dict[str, Any], model=None) -> Dict[str, Any]:
    """batch -> the model's ``forward`` kwargs; MatchaTTS_MAS finds its own
    durations, so ``ds`` goes only to MatchaTTS."""
    kwargs = dict(
        xs=batch["xs"], ilens=batch["ilens"], ys=batch["ys"], olens=batch["olens"],
        spembs=batch.get("spembs"), sids=batch.get("sids"),
    )
    if "ds" in batch and (model is None or "MAS" not in type(model).__name__):
        kwargs["ds"] = batch["ds"]
    return kwargs


def matchatts_loss(model, batch: Dict[str, Any], criterions, config, step):
    out = model(**matchatts_kwargs(batch, model))
    dp_start = float(config.get("dp_train_start_steps", 0) or 0)
    bin_start = float(config.get("bin_loss_start_steps", 0) or 0)
    lambda_align = float(config.get("lambda_align", 1.0))
    zero = torch.zeros((), device=out["cfm_loss"].device)

    loss = out["cfm_loss"]
    stats = {"train/cfm_loss": out["cfm_loss"]}

    if "EncoderPriorLoss" in criterions:
        mask = sequence_mask(out["olens_in"], out["ys"].shape[1], torch.float32)
        prior = criterions["EncoderPriorLoss"](out["hs"], out["ys"], mask)
        loss = loss + prior
        stats["train/encoder_prior_loss"] = prior

    if "DurationPredictorLoss" in criterions:
        dur = zero
        if step > dp_start:
            d_target = out["ds"] if "ds" in out else batch["ds"]
            dur = criterions["DurationPredictorLoss"](out["d_outs"], d_target, batch["ilens"])
            loss = loss + dur
        stats["train/duration_loss"] = dur

    if "ForwardSumLoss" in criterions and "log_p_attn" in out:
        fsum = zero
        if step < dp_start:
            fsum = criterions["ForwardSumLoss"](out["log_p_attn"], batch["ilens"], batch["olens"])
            loss = loss + lambda_align * fsum
        stats["train/forward_sum_loss"] = fsum

    if "bin_loss" in out:
        gated = out["bin_loss"] if step > bin_start else zero
        loss = loss + lambda_align * gated
        stats["train/binary_loss"] = gated

    return loss, stats
