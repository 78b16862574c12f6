"""Duration-based length regulation (counterpart of jatts_tpu/ops/upsample.py).

Frames are assigned to tokens by a one-hot matrix built from the duration
cumsum, ``R[b, t, j] = 1 iff cumsum(d)[j-1] <= t < cumsum(d)[j]``, so the
expansion is one batched matmul at a static output length.
"""

from __future__ import annotations

from typing import Optional

import torch


def duration_assignment(
    ds: torch.Tensor, t_feats: int, d_masks: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Hard assignment matrix ``[B, T_feats, T_text]`` (float32) from integer
    durations; frames beyond ``sum(ds)`` get an all-zero row."""
    ds = ds.float()
    if d_masks is not None:
        ds = ds * d_masks.float()
    cum = torch.cumsum(ds, dim=-1)
    start = cum - ds
    t = torch.arange(t_feats, device=ds.device, dtype=torch.float32)[None, :, None]
    r = (t >= start[:, None, :]) & (t < cum[:, None, :])
    return r.float()


def regulate_length(
    hs: torch.Tensor,
    ds: torch.Tensor,
    t_feats: int,
    d_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Expand ``hs [B, T_text, C]`` by durations ``ds [B, T_text]`` to
    ``[B, t_feats, C]``; the product is taken in float32."""
    r = duration_assignment(ds, t_feats, d_masks)
    return torch.bmm(r, hs.float()).to(hs.dtype)


def predicted_durations_to_int(d_outs: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Log-domain predictor output -> int durations, ``max(round(exp(d)-1), 0)``
    with speed control ``alpha``. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    d = torch.clamp(torch.round(torch.exp(d_outs) - 1.0), min=0.0)
    if alpha != 1.0:
        d = torch.round(d * alpha)
    return d.to(torch.int32)
