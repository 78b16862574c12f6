"""E2-TTS loss assembly (counterpart of jatts_tpu/train/steps_e2tts.py): the
model's own flow-matching loss, reported as ``train/cfm_loss``; its draws
come from the trainer's noise generator. Under sequence parallelism the
text, when the trainer cut it, is gathered back whole, and the model runs
on its block of the frames when the trainer cut the frames (a frame count
the model axis does not divide stays whole, and every model rank then
computes the whole)."""

from __future__ import annotations

from typing import Any, Dict

from jatts_torch.parallel.mesh import active, unshard


def e2tts_kwargs(batch: Dict[str, Any], model=None) -> Dict[str, Any]:
    return dict(text=batch["xs"], feats=batch["ys"], feats_lengths=batch["olens"])


def e2tts_loss(model, batch: Dict[str, Any], criterions, config, step):
    kwargs = e2tts_kwargs(batch, model)
    m = active()
    if m is not None and m.seq_parallel:
        if "xs" in m.seq_keys:
            kwargs["text"] = unshard(kwargs["text"], 1, m)
        kwargs["seq_parallel"] = "ys" in m.seq_keys
    out = model(**kwargs)
    return out["loss"], {"train/cfm_loss": out["loss"]}
