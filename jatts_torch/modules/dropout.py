"""Dropout with flax's semantics, drawing its masks from an explicit
``torch.Generator`` (counterpart of ``flax.linen.Dropout`` as the JAX
package's modules use it).

In training each element is kept with probability ``1 - rate`` and scaled
by ``1 / (1 - rate)``; in eval mode, or at rate 0, the input passes
unchanged. The masks come from ``generator`` (``None``: torch's default
generator for the tensor's device). A trainer owns one generator, seeds it
from its ``--seed`` and hands it to every dropout of a model with
:func:`set_dropout_generator`. The masks are not jax.random's bits, so a
parity test against the JAX package runs with every rate at 0. Under a
mesh (``parallel/mesh.py:draw``) a mask is drawn at the global batch's
shape and each rank keeps its part, so the masks do not depend on the
mesh; ``rows=False`` marks a tensor without a batch axis.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jatts_torch.parallel.mesh import draw


class Dropout(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, rows: bool = True) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = draw(lambda s: torch.rand(s, generator=self.generator, device=x.device), x.shape, rows) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every :class:`Dropout` of ``model`` draws from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_dropout_rate(model: nn.Module, rate: float) -> None:
    """Set every :class:`Dropout` of ``model`` to ``rate`` (0 turns dropout
    off while BatchNorm keeps its training behaviour)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = float(rate)
