"""VITS loss assembly (counterpart of jatts_tpu/train/steps_vits.py).

``lambda_mel`` · masked L1 of the mel + the flow KL (channel-first, as the
reference's loss takes it) + the schedule of the alignment losses: the
duration loss (or, for the stochastic predictor, the mean of its NLL) when
``step > dp_train_start_steps``; the forward-sum (CTC) loss, weighted by
``lambda_align``, while ``step < dp_train_start_steps``; the binarization
loss, weighted by ``lambda_align``, when ``step > bin_loss_start_steps``.
As in ``steps_matcha.py``, a closed gate skips its loss and reports 0,
the value and the gradient of the JAX package's gated product.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from jatts_torch.parallel.mesh import global_mean


def vits_kwargs(batch: Dict[str, Any], model=None) -> Dict[str, Any]:
    """batch -> ``VITS.forward`` kwargs: VITS searches its own durations."""
    return dict(
        xs=batch["xs"], ilens=batch["ilens"], ys=batch["ys"], olens=batch["olens"],
        spembs=batch.get("spembs"), sids=batch.get("sids"),
    )


def vits_loss(model, batch: Dict[str, Any], criterions, config, step):
    out = model(**vits_kwargs(batch, model))
    dp_start = float(config.get("dp_train_start_steps", 0) or 0)
    bin_start = float(config.get("bin_loss_start_steps", 0) or 0)
    lambda_align = float(config.get("lambda_align", 1.0))
    lambda_mel = float(config.get("lambda_mel", 1.0))
    zero = torch.zeros((), device=out["outs"].device)

    mel_loss = criterions["MelLoss"](None, out["outs"], out["ys"], out["olens_in"])

    def tr(x):
        return x.transpose(1, 2)

    kl_loss = criterions["KLDivergenceLoss"](
        tr(out["z_p"]), tr(out["logs_q"]), tr(out["m_p"]), tr(out["logs_p"]), tr(out["y_mask"]),
    )
    loss = lambda_mel * mel_loss + kl_loss
    stats = {"train/mel_loss": mel_loss, "train/kl_loss": kl_loss}

    if out.get("dur_nll") is not None:
        dur = zero
        if step > dp_start:
            dur = global_mean(out["dur_nll"])
            loss = loss + dur
        stats["train/duration_loss"] = dur
    elif "DurationPredictorLoss" in criterions:
        dur = zero
        if step > dp_start:
            dur = criterions["DurationPredictorLoss"](out["d_outs"], out["ds"], batch["ilens"])
            loss = loss + dur
        stats["train/duration_loss"] = dur

    if "ForwardSumLoss" in criterions:
        fsum = zero
        if step < dp_start:
            fsum = criterions["ForwardSumLoss"](out["log_p_attn"], batch["ilens"], batch["olens"])
            loss = loss + lambda_align * fsum
        stats["train/forward_sum_loss"] = fsum

    gated = out["bin_loss"] if step > bin_start else zero
    loss = loss + lambda_align * gated
    stats["train/binary_loss"] = gated
    return loss, stats
