"""Length masks (counterpart of jatts_tpu/ops/masks.py)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, maxlen: int, dtype=torch.bool) -> torch.Tensor:
    """``[B] -> [B, maxlen]``, True (or 1) on valid positions."""
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def attn_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """``[B, 1, maxlen]`` self-attention key mask."""
    return sequence_mask(lengths, maxlen)[:, None, :]
