"""Weight re-initialization (counterpart of jatts_tpu/utils/initialize.py).

Applied by the trainer right after a model is built, with the model's
``init_type``, as the JAX package applies it to its flax tree:

- every ``bias`` -> zeros;
- embeddings (the tables of ``nn.Embedding`` modules, flax's ``embedding``
  leaves, such as ``sid_emb``, and any parameter under a module path
  containing "embed", which also covers the pitch/energy embedding
  convolutions, as in the JAX package), norm scales and other 1-dim
  parameters, and the running statistics (buffers) -> left alone;
- every other parameter with ndim > 1 -> drawn from the chosen initializer
  with the fans the JAX package reads off the same parameter in flax's
  layout, ``receptive = prod(shape[:-2])``, ``fan_in = shape[-2]·receptive``,
  ``fan_out = shape[-1]·receptive``:

  - weights of ``nn.Linear`` and ``nn.Conv{1,2}d`` (torch ``[out, in,
    k...]``, flax ``[k..., in, out]``) and of ``nn.ConvTranspose{1,2}d``
    (torch ``[in, out, k...]``, flax ``[k..., out, in]``, the mapping of
    ``jatts_tpu/vocoder/convert.py:_convT_w``) are read in that flax
    layout: ``fan_in = shape[1]·receptive``, ``fan_out =
    shape[0]·receptive`` of the torch shape, torch's own reading;
  - any other parameter (``pos_bias_u``/``pos_bias_v`` ``[H, d_k]``) is
    stored as flax stores it and is read as it stands: ``fan_in = H``;
  - a module may name its own parameters in ``INIT_RULES``:
    ``"torch_layout"`` reads one as a Conv weight, ``"keep"`` leaves one
    alone (the weight-normed convolutions of ``modules/wavenet.py``: ``v``
    ``[out, in, k]`` is drawn, the scale ``g``, a 1-dim leaf in flax kept
    as ``[out, 1, 1]``, is not).

Draws come from a ``torch.Generator`` seeded by the caller; they are not
jax.random's bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


# modules whose weight torch keeps in another layout than flax's
_TORCH_LAYOUT = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)


def _fans(shape) -> tuple:
    """The JAX package's fans of a flax-layout shape ``[k..., in, out]``."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def flax_shape(shape) -> tuple:
    """A torch Linear/Conv/ConvTranspose weight's shape in flax's layout:
    ``[a, b, k...]`` -> ``[k..., b, a]`` (Conv ``[out, in, k]`` -> ``[k, in,
    out]``, ConvTranspose ``[in, out, k]`` -> ``[k, out, in]``)."""
    return tuple(shape[2:]) + (shape[1], shape[0])


def _draw(shape, fan_shape, init_type: str, generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(fan_shape)
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
    torch_layout = {id(m.weight) for m in model.modules() if isinstance(m, _TORCH_LAYOUT)}
    keep = set()
    for m in model.modules():
        for pname, rule in getattr(m, "INIT_RULES", {}).items():
            param = getattr(m, pname, None)
            if isinstance(param, nn.Parameter):
                (torch_layout if rule == "torch_layout" else keep).add(id(param))
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "bias":
            param.zero_()
        elif (param.ndim <= 1 or id(param) in tables or id(param) in keep
              or any("embed" in p.lower() for p in parts[:-1])):
            continue
        else:
            shape = tuple(param.shape)
            fan_shape = flax_shape(shape) if id(param) in torch_layout else shape
            param.copy_(_draw(shape, fan_shape, init_type, g).to(param.dtype))
    return model
