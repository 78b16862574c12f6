"""Positional encodings (counterpart of jatts_tpu/modules/positional.py).

Tables are built in float64 with numpy, like the JAX package, and cast to
the activation dtype. They are non-persistent buffers: no state_dict keys,
as in the reference. In training the encodings apply dropout
(``dropout_rate``) where the JAX modules do: to the scaled input, and for
the relative encodings also to the positional table.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from jatts_torch.modules.dropout import Dropout


def sinusoid_table(t: int, d_model: int) -> np.ndarray:
    """``[t, d_model]`` sin/cos interleaved table."""
    position = np.arange(t, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((t, d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def rel_sinusoid_table(t: int, d_model: int) -> np.ndarray:
    """``[2t-1, d_model]`` relative table: positions t-1 … 0 … -(t-1)."""
    pe_pos = sinusoid_table(t, d_model)
    pe_neg = np.zeros((t, d_model))
    position = np.arange(t, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model)
    )
    pe_neg[:, 0::2] = np.sin(-position * div_term)
    pe_neg[:, 1::2] = np.cos(-position * div_term)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)


def _table(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(table)).to(like.device, like.dtype)


class PositionalEncoding(nn.Module):
    """Absolute sinusoidal PE: ``x*sqrt(d) + pe``."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = _table(sinusoid_table(x.shape[1], self.d_model), x)
        return self.dropout(x * math.sqrt(self.d_model) + pe[None])


class ScaledPositionalEncoding(nn.Module):
    """Learnable-alpha PE: ``x + alpha*pe``."""

    def __init__(self, d_model: int, init_alpha: float = 1.0, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.alpha = nn.Parameter(torch.tensor([init_alpha]))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = _table(sinusoid_table(x.shape[1], self.d_model), x)
        return self.dropout(x + self.alpha.to(x.dtype) * pe[None])


class LegacyRelPositionalEncoding(nn.Module):
    """Legacy relative PE: returns ``(x*sqrt(d), pos_emb [1, T, d])``.

    Keeps the reference quirk: the reversed table is built once at
    ``max_len`` and its first T rows are sliced, so row p is
    PE(max_len-1-p), not PE(T-1-p)."""

    def __init__(self, d_model: int, max_len: int = 5000, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.max_len = max_len
        self.dropout = Dropout(dropout_rate)
        table = sinusoid_table(max_len, d_model)[::-1].copy()
        self.register_buffer("pe", torch.from_numpy(table).float(), persistent=False)

    def forward(self, x: torch.Tensor):
        t = x.shape[1]
        if t <= self.max_len:
            pe = self.pe[:t].to(x.dtype)
        else:
            pe = _table(sinusoid_table(t, self.d_model)[::-1][:t], x)
        return self.dropout(x * math.sqrt(self.d_model)), self.dropout(pe[None])


class RelPositionalEncoding(nn.Module):
    """Returns ``(x*sqrt(d), pos_emb [1, 2T-1, d])``."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor):
        pe = _table(rel_sinusoid_table(x.shape[1], self.d_model), x)
        return self.dropout(x * math.sqrt(self.d_model)), self.dropout(pe[None])
