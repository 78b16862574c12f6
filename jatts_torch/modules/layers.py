"""Layers with flax's compute ``dtype`` (the JAX modules' ``dtype=``).

Parameters are created and kept in float32 (or whatever ``.to`` made
them); ``compute_dtype`` is the type a layer computes in:

- :class:`Linear`, :class:`Conv1d`, :class:`ConvTranspose1d` cast their
  input, weight and bias to it and return it (flax ``nn.Dense``,
  ``nn.Conv``, ``nn.ConvTranspose`` under ``promote_dtype``);
  :class:`Embedding` gathers the float32 rows and casts them (``nn.Embed``);
- :class:`LayerNorm` and :class:`GroupNorm` take their statistics and the
  affine in float32 and return the compute dtype, as flax's
  ``_compute_stats`` / ``_normalize`` do (``modules/batchnorm.py`` does the
  same for BatchNorm).

``compute_dtype=None`` casts nothing: the layer is torch's own and computes
in the dtype of its parameters and input (a model whose parameters a
caller made bfloat16 with ``.to``, as the served programs are). Gradients
reach the float32 parameters through the casts. The casts are explicit,
not ``torch.autocast``, whose per-op lists are not flax's.

A model sets the dtype of every such layer below it with
:func:`set_compute_dtype`; a part that the JAX package builds without a
``dtype`` (so in float32) is built from torch's own layers, which have no
``compute_dtype`` and are left as they are.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t: Optional[torch.Tensor], dt: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dt)


def per_shape(fn):
    """A cache of 32 entries for a table a forward builds once per shape
    (the oldest entry goes first). While ``torch.export`` traces, a table
    already made is handed out (it becomes a constant of the exported
    program, on its device) and a table made then is not kept: it is a fake
    tensor, which must not reach a later eager call."""
    cache = {}

    @functools.wraps(fn)
    def table(*args):
        if args in cache:
            return cache[args]
        out = fn(*args)
        if not torch.compiler.is_exporting():
            if len(cache) >= 32:
                del cache[next(iter(cache))]
            cache[args] = out
        return out

    return table


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype: Optional[torch.dtype]) -> float:
    """``value`` rounded to ``dtype`` (a JAX scalar made with
    ``jnp.asarray(v, x.dtype)``), as a Python float; unrounded for ``None``.
    A Python scalar keeps torch's single kernel, so a float32 result does
    not move. Rounded once for each value and dtype, not on every call."""
    return value if dtype is None else float(torch.tensor(value, dtype=dtype))


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv1d(nn.Conv1d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return self._conv_forward(x, self.weight, self.bias)
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))

    def pointwise(self, x: torch.Tensor) -> torch.Tensor:
        """A kernel-1 convolution on feature-last ``x`` [..., C_in], as a
        matmul, with :meth:`forward`'s casts."""
        w, dt = self.weight[..., 0], self.compute_dtype
        if dt is None:
            return F.linear(x, w, self.bias)
        return F.linear(x.to(dt), w.to(dt), _cast(self.bias, dt))


class ConvTranspose1d(nn.ConvTranspose1d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose1d(
            x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


class Embedding(nn.Embedding):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape, _cast(self.weight, torch.float32),
                         _cast(self.bias, torch.float32), self.eps)
        return y.to(dt)


class GroupNorm(nn.GroupNorm):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.group_norm(x.float(), self.num_groups, _cast(self.weight, torch.float32),
                         _cast(self.bias, torch.float32), self.eps)
        return y.to(dt)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Set ``compute_dtype`` on ``module`` and every module below it that
    has one. A part that must stay float32 is built from torch's own layers
    (no ``compute_dtype``), so the walk may start at the model's root."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
