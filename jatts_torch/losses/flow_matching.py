"""Flow-matching losses (counterpart of jatts_tpu/losses/flow_matching.py)."""

from __future__ import annotations

import math

import torch

from jatts_torch.parallel.mesh import global_sum, share


class CFMLoss:
    """No-op kept for the registry: the OT-CFM loss is computed inside the
    CFM module."""

    def __init__(self, **kw):
        pass

    def __call__(self, *args, **kwargs):
        return None


class EncoderPriorLoss:
    """Matcha's prior loss: masked mean of 0.5 (hs - ys)^2 plus the FULL
    log(2 pi), as the reference and the JAX package add it (upstream
    Matcha-TTS adds half; the constant shifts the value, not the
    gradients)."""

    def __init__(self, **kw):
        pass

    def __call__(self, hs: torch.Tensor, ys: torch.Tensor, olens_mask: torch.Tensor) -> torch.Tensor:
        """hs, ys: ``[B, T, C]``; olens_mask: ``[B, T]`` or ``[B, T, 1]``."""
        if olens_mask.dim() == 2:
            olens_mask = olens_mask[..., None]
        err = 0.5 * (hs - ys) ** 2
        mask = olens_mask.to(err.dtype).expand(err.shape)  # losses/basic.py:_masked_mean
        return (err * mask).sum() / global_sum(mask.sum()).clamp(min=1.0) + math.log(2.0 * math.pi) * share()
