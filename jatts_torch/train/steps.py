"""Per-model loss assembly (counterpart of jatts_tpu/train/steps.py).

A loss function takes ``(model, batch, criterions, config, step)`` with
``batch`` a dict of tensors on the model's device, runs the model in its
current mode (the trainer sets training or eval) and returns
``(loss, stats)``; BatchNorm's running statistics update inside the
model's forward in training mode, as flax's ``mutable=["batch_stats"]`` does.
"""

from __future__ import annotations

from typing import Any, Dict

from jatts_torch.train.steps_e2tts import e2tts_kwargs, e2tts_loss
from jatts_torch.train.steps_matcha import matchatts_kwargs, matchatts_loss
from jatts_torch.train.steps_valle import valle_kwargs, valle_loss
from jatts_torch.train.steps_vits import vits_kwargs, vits_loss


def fastspeech2_kwargs(batch: Dict[str, Any], model=None) -> Dict[str, Any]:
    """batch -> ``FastSpeech2.forward`` kwargs, with the speaker embeddings
    (``spembs``, from the ``spkemb`` dumps) and ids (``sids``) when the
    batch has them."""
    return dict(
        xs=batch["xs"], ilens=batch["ilens"], ys=batch["ys"], olens=batch["olens"],
        ds=batch["ds"], ps=batch["ps"], es=batch["es"],
        spembs=batch.get("spembs"), sids=batch.get("sids"),
    )


def fastspeech2_loss(model, batch: Dict[str, Any], criterions, config, step):
    out = model(**fastspeech2_kwargs(batch, model))
    mel_loss = criterions["MelLoss"](
        out["after_outs"], out["before_outs"], out["ys"], out["olens"]
    )
    duration_loss = criterions["DurationPredictorLoss"](
        out["d_outs"], batch["ds"], batch["ilens"]
    )
    pitch_loss = criterions["PitchLoss"](out["p_outs"], batch["ps"], batch["ilens"])
    energy_loss = criterions["EnergyLoss"](out["e_outs"], batch["es"], batch["ilens"])
    loss = mel_loss + duration_loss + pitch_loss + energy_loss
    stats = {
        "train/mel_loss": mel_loss,
        "train/duration_loss": duration_loss,
        "train/pitch_loss": pitch_loss,
        "train/energy_loss": energy_loss,
    }
    return loss, stats


LOSS_FN_REGISTRY = {
    "FastSpeech2Trainer": fastspeech2_loss,
    "MatchaTTSTrainer": matchatts_loss,
    "VALLETrainer": valle_loss,
    "VITSTrainer": vits_loss,
    "E2TTSTrainer": e2tts_loss,
}
KWARGS_REGISTRY = {
    "FastSpeech2Trainer": fastspeech2_kwargs,
    "MatchaTTSTrainer": matchatts_kwargs,
    "VALLETrainer": valle_kwargs,
    "VITSTrainer": vits_kwargs,
    "E2TTSTrainer": e2tts_kwargs,
}

NOT_PORTED = ()  # every trainer type of the JAX package is ported


def _refuse(trainer_type: str):
    raise ValueError(f"unknown trainer_type {trainer_type!r} (the port trains {', '.join(LOSS_FN_REGISTRY)})")


def get_loss_fn(trainer_type: str):
    if trainer_type not in LOSS_FN_REGISTRY:
        _refuse(trainer_type)
    return LOSS_FN_REGISTRY[trainer_type]


def get_kwargs_fn(trainer_type: str):
    if trainer_type not in KWARGS_REGISTRY:
        _refuse(trainer_type)
    return KWARGS_REGISTRY[trainer_type]
