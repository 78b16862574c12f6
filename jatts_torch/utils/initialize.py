"""Weight re-initialization (counterpart of jatts_tpu/utils/initialize.py).

Applied by the trainer right after a model is built, with the model's
``init_type``, as the JAX package applies it to its flax tree:

- every ``bias`` -> zeros;
- embeddings (the tables of ``nn.Embedding`` modules, flax's ``embedding``
  leaves, such as ``sid_emb``, and any parameter under a module path
  containing "embed", which also covers the pitch/energy embedding
  convolutions, as in the JAX package), norm scales and other 1-dim
  parameters, and the running statistics (buffers) -> left alone;
- every other parameter with ndim > 1 (linear and conv weights,
  ``pos_bias_u``/``pos_bias_v``) -> drawn from the chosen initializer with
  torch's fan convention on the torch layout ``[out, in, k...]``:
  ``fan_in = in·receptive``, ``fan_out = out·receptive``.

Draws come from a ``torch.Generator`` seeded by the caller; they are not
jax.random's bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _fans(shape) -> tuple:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def _draw(shape, init_type: str, generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    if init_type == "xavier_uniform":
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
    if init_type == "xavier_normal":
        return torch.randn(shape, generator=generator) * math.sqrt(2.0 / (fan_in + fan_out))
    if init_type == "kaiming_uniform":
        bound = math.sqrt(6.0 / fan_in)
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
    if init_type == "kaiming_normal":
        return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)
    if init_type == "chainer":
        return torch.randn(shape, generator=generator) / math.sqrt(fan_in)
    raise ValueError(f"Unknown initialization: {init_type}")


@torch.no_grad()
def initialize(model: nn.Module, init_type: Optional[str], seed: int = 0) -> nn.Module:
    """Re-initialize ``model``'s parameters in place; ``init_type`` None,
    "" or "none" leaves them as they are. Returns the model."""
    if not init_type or init_type == "none":
        return model
    g = torch.Generator().manual_seed(seed)
    tables = {id(m.weight) for m in model.modules() if isinstance(m, nn.Embedding)}
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "bias":
            param.zero_()
        elif param.ndim <= 1 or id(param) in tables or any("embed" in p.lower() for p in parts[:-1]):
            continue
        else:
            param.copy_(_draw(tuple(param.shape), init_type, g).to(param.dtype))
    return model
