"""Length masks (counterpart of jatts_tpu/ops/masks.py)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, maxlen: int, dtype=torch.bool) -> torch.Tensor:
    """``[B] -> [B, maxlen]``, True (or 1) on valid positions."""
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def pad_mask(lengths: torch.Tensor, maxlen: int, dtype=torch.bool) -> torch.Tensor:
    """True (or 1) on PAD positions: the reference's ``make_pad_mask``."""
    if dtype == torch.bool:
        return ~sequence_mask(lengths, maxlen)
    return 1 - sequence_mask(lengths, maxlen, dtype)


def attn_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """``[B, 1, maxlen]`` self-attention key mask."""
    return sequence_mask(lengths, maxlen)[:, None, :]


def causal_mask(maxlen: int, device=None) -> torch.Tensor:
    """``[maxlen, maxlen]`` lower-triangular bool mask (the reference's
    ``subsequent_mask``)."""
    return torch.tril(torch.ones(maxlen, maxlen, dtype=torch.bool, device=device))
