"""Positional encodings (counterpart of jatts_tpu/modules/positional.py).

Tables are built in float64 with numpy, like the JAX package, and cast to
the activation dtype. Under a compute dtype (``modules/layers.py``) the
``sqrt(d)`` scale is rounded to it first, as the JAX modules' ``jnp.sqrt(
jnp.asarray(d, x.dtype))`` is. They are non-persistent buffers: no state_dict keys,
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
from jatts_torch.modules.layers import in_dtype, per_shape


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


@per_shape
def abs_table(t: int, d_model: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``sinusoid_table(t, d_model)`` on ``device`` in ``dtype``, built once
    per shape, as :func:`rel_table` is (a table copied from pageable host
    memory on every call also breaks a CUDA graph capture). Callers must not
    write to it."""
    return torch.from_numpy(np.ascontiguousarray(sinusoid_table(t, d_model))).to(device, dtype)


@per_shape
def rel_table(t: int, d_model: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``rel_sinusoid_table(t, d_model)`` on ``device`` in ``dtype``, built
    once per shape, as the JAX package folds it into its traced program: a
    table rebuilt with numpy and copied from pageable host memory on every
    call costs milliseconds of host time and holds the stream. Callers must
    not write to it."""
    return torch.from_numpy(np.ascontiguousarray(rel_sinusoid_table(t, d_model))).to(device, dtype)


def _sqrt_d(enc: nn.Module) -> float:
    return in_dtype(math.sqrt(enc.d_model), enc.compute_dtype)


class PositionalEncoding(nn.Module):
    """Absolute sinusoidal PE: ``x*sqrt(d) + pe``."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.compute_dtype = None
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = abs_table(x.shape[1], self.d_model, x.device, x.dtype)
        return self.dropout(x * _sqrt_d(self) + pe[None])


class ScaledPositionalEncoding(nn.Module):
    """Learnable-alpha PE: ``x + alpha*pe``."""

    def __init__(self, d_model: int, init_alpha: float = 1.0, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.alpha = nn.Parameter(torch.tensor([init_alpha]))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = abs_table(x.shape[1], self.d_model, x.device, x.dtype)
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
        self.compute_dtype = None
        self.dropout = Dropout(dropout_rate)
        table = sinusoid_table(max_len, d_model)[::-1].copy()
        self.register_buffer("pe", torch.from_numpy(table).float(), persistent=False)

    def forward(self, x: torch.Tensor):
        t = x.shape[1]
        if t <= self.max_len:
            pe = self.pe[:t].to(x.dtype)
        else:
            pe = _table(sinusoid_table(t, self.d_model)[::-1][:t], x)
        return self.dropout(x * _sqrt_d(self)), self.dropout(pe[None], rows=False)


class RelPositionalEncoding(nn.Module):
    """Returns ``(x*sqrt(d), pos_emb [1, 2T-1, d])``."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.compute_dtype = None
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor):
        pe = rel_table(x.shape[1], self.d_model, x.device, x.dtype)
        return self.dropout(x * _sqrt_d(self)), self.dropout(pe[None], rows=False)
