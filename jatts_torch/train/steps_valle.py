"""VALL-E loss assembly (counterpart of jatts_tpu/train/steps_valle.py): the
model's own cross-entropy, reported as ``train/loss_ce``, for the AR and the
NAR alike (the NAR draws its training levels itself)."""

from __future__ import annotations

from typing import Any, Dict


def valle_kwargs(batch: Dict[str, Any], model=None) -> Dict[str, Any]:
    """batch -> the model's ``forward`` kwargs; the AR takes codec level 0
    of ``resps``, the NAR all 8 levels."""
    resps = batch["resps"]
    if model is not None and type(model).__name__ == "VALLEAR" and resps.dim() == 3:
        resps = resps[:, :, 0]
    return dict(
        text=batch["text"], text_lens=batch["text_lens"],
        proms=batch["proms"], prom_lens=batch["prom_lens"],
        resps=resps, resp_lens=batch["resp_lens"],
    )


def valle_loss(model, batch: Dict[str, Any], criterions, config, step):
    out = model(**valle_kwargs(batch, model))
    return out["loss"], {"train/loss_ce": out["loss"]}
