"""Duration-based length regulation (counterpart of jatts_tpu/ops/upsample.py).

Frames are assigned to tokens by a one-hot matrix built from the duration
cumsum, ``R[b, t, j] = 1 iff cumsum(d)[j-1] <= t < cumsum(d)[j]``, so the
expansion is one batched matmul at a static output length. Gaussian
upsampling (Matcha-TTS+MAS) is the same product with a soft assignment.
"""

from __future__ import annotations

from typing import Optional

import torch

from jatts_torch.ops.masks import sequence_mask


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


def gaussian_upsampling(
    hs: torch.Tensor,
    ds: torch.Tensor,
    h_masks: Optional[torch.Tensor] = None,
    d_masks: Optional[torch.Tensor] = None,
    delta: float = 0.1,
    t_feats: Optional[int] = None,
) -> torch.Tensor:
    """Soft Gaussian upsampling of ``hs [B, T_text, C]`` by durations ``ds
    [B, T_text]`` to ``[B, T_feats, C]``: frame t attends to token j with
    weight softmax_j(-delta (t - c_j)^2), c = cumsum(ds) - ds / 2.

    As the JAX package has it: with ``h_masks [B, T_feats]`` the frame
    index is multiplied by the mask, so frames past ``olens`` sit at t = 0;
    invalid tokens (``d_masks [B, T_text]`` False) get the finite energy
    -1e9, and a row with no valid token is zeroed rather than NaN. The
    output length is ``t_feats`` or, by default, ``h_masks.shape[-1]``."""
    if t_feats is None:
        if h_masks is None:
            raise ValueError("need h_masks or t_feats for the output length")
        t_feats = h_masks.shape[-1]
    ds = ds.float()
    t = torch.arange(t_feats, device=ds.device, dtype=torch.float32)[None, :]
    if h_masks is not None:
        t = t * h_masks.float()
    c = torch.cumsum(ds, dim=-1) - ds / 2.0
    energy = -delta * (t[:, :, None] - c[:, None, :]) ** 2
    if d_masks is not None:
        energy = torch.where(d_masks[:, None, :], energy, torch.full((), -1e9, device=ds.device))
    p_attn = _softmax_lastaxis(energy)
    if d_masks is not None:
        p_attn = torch.where(d_masks.any(dim=-1)[:, None, None], p_attn, torch.zeros((), device=ds.device))
    return torch.bmm(p_attn, hs.float()).to(hs.dtype)


def _softmax_lastaxis(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's max-shifted softmax, spelled out."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def average_by_duration(
    xs: torch.Tensor,
    ds: torch.Tensor,
    text_lengths: torch.Tensor,
    feats_lengths: torch.Tensor,
    only_positive: bool = False,
) -> torch.Tensor:
    """Frame-level ``xs [B, T_feats]`` averaged over each token's frames
    into ``[B, T_text]`` (0 for a token with no frame). ``only_positive``
    averages the positive (voiced) frames only, as FastPitch's
    preprocessing does."""
    t_text = ds.shape[1]
    t_feats = xs.shape[1]
    d_masks = sequence_mask(text_lengths, t_text)
    r = duration_assignment(ds, t_feats, d_masks)
    r = r * sequence_mask(feats_lengths, t_feats, torch.float32)[:, :, None]
    w = xs.float()
    if only_positive:
        pos = (w > 0.0).float()
        num = torch.einsum("btj,bt->bj", r, w * pos)
        den = torch.einsum("btj,bt->bj", r, pos)
    else:
        num = torch.einsum("btj,bt->bj", r, w)
        den = r.sum(dim=1)
    avg = torch.where(den > 0, num / den.clamp(min=1.0), torch.zeros((), device=xs.device))
    return avg.to(xs.dtype)
