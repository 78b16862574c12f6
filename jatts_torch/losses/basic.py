"""Masked L1/MSE losses (counterpart of jatts_tpu/losses/basic.py).

Every reduction is the mean over the unmasked elements, computed with
mask-multiplication so shapes stay static: ``sum(err·mask) / max(sum(mask), 1)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from jatts_torch.losses.align import BinLoss, ForwardSumLoss
from jatts_torch.ops.masks import sequence_mask


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``err`` over positions where ``mask`` (broadcastable) is 1."""
    mask = mask.to(err.dtype).expand(err.shape)
    return (err * mask).sum() / mask.sum().clamp(min=1.0)


def masked_l1(pred, target, mask):
    return _masked_mean((pred - target).abs(), mask)


def masked_mse(pred, target, mask):
    return _masked_mean((pred - target) ** 2, mask)


class L1Loss:
    """before+after postnet masked L1."""

    def __init__(self, use_masking: bool = True, reduction: str = "mean"):
        self.use_masking = use_masking

    def __call__(self, after_outs: Optional[torch.Tensor], before_outs, ys, olens):
        t = ys.shape[1]
        if self.use_masking:
            mask = sequence_mask(olens, t, torch.float32)[..., None]
        else:
            mask = torch.ones(ys.shape[0], t, 1, device=ys.device)
        loss = masked_l1(before_outs, ys, mask)
        if after_outs is not None:
            loss = loss + masked_l1(after_outs, ys, mask)
        return loss


class MelLoss:
    """Dispatcher kept for config parity (``_type: L1Loss`` only)."""

    def __init__(self, _type: str = "L1Loss", params: Optional[dict] = None, **kw):
        if _type != "L1Loss":
            raise ValueError(f"unsupported MelLoss type {_type}")
        self.criterion = L1Loss(**(params or {}))

    def __call__(self, after_outs, before_outs, ys, olens):
        return self.criterion(after_outs, before_outs, ys, olens)


class DurationPredictorLoss:
    """Masked MSE in the log domain: target ``log(ds + offset)``."""

    def __init__(self, use_masking: bool = True, offset: float = 1.0, reduction="mean"):
        self.use_masking = use_masking
        self.offset = offset

    def __call__(self, d_outs, ds, ilens):
        t = ds.shape[1]
        mask = (
            sequence_mask(ilens, t, torch.float32)
            if self.use_masking
            else torch.ones_like(d_outs)
        )
        target = torch.log(ds.float() + self.offset)
        return masked_mse(d_outs, target, mask)


class _VarianceLoss:
    def __init__(self, use_masking: bool = True, reduction: str = "mean"):
        self.use_masking = use_masking

    def __call__(self, outs, targets, lens):
        t = targets.shape[1]
        mask = (
            sequence_mask(lens, t, torch.float32)[..., None]
            if self.use_masking
            else torch.ones_like(outs)
        )
        return masked_mse(outs, targets, mask)


class PitchLoss(_VarianceLoss):
    """Masked MSE of token-averaged pitch."""


class EnergyLoss(_VarianceLoss):
    """Masked MSE of token-averaged energy."""


LOSS_REGISTRY = {
    "L1Loss": L1Loss,
    "MelLoss": MelLoss,
    "DurationPredictorLoss": DurationPredictorLoss,
    "PitchLoss": PitchLoss,
    "EnergyLoss": EnergyLoss,
    "ForwardSumLoss": ForwardSumLoss,
    "BinLoss": BinLoss,
}
