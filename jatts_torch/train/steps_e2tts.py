"""E2-TTS loss assembly (counterpart of jatts_tpu/train/steps_e2tts.py): the
model's own flow-matching loss, reported as ``train/cfm_loss``; its draws
come from the trainer's noise generator."""

from __future__ import annotations

from typing import Any, Dict


def e2tts_kwargs(batch: Dict[str, Any], model=None) -> Dict[str, Any]:
    return dict(text=batch["xs"], feats=batch["ys"], feats_lengths=batch["olens"])


def e2tts_loss(model, batch: Dict[str, Any], criterions, config, step):
    out = model(**e2tts_kwargs(batch, model))
    return out["loss"], {"train/cfm_loss": out["loss"]}
