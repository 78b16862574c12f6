"""Transfer-learning helpers on ``state_dict`` keys (counterpart of
jatts_tpu/utils/model_io.py, which works on flax trees): a module is a key
prefix such as ``encoder`` or ``decoder.encoders.0``, matched as the JAX
helpers match ``/``-joined paths, by ``str.startswith``."""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Sequence, Union

import torch

StateLike = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _keys(params: StateLike) -> List[str]:
    if isinstance(params, torch.nn.Module):
        return [n for n, _ in params.named_parameters()]
    return list(params)


def filter_modules(params: StateLike, modules: Sequence[str]) -> List[str]:
    """The ``modules`` that prefix some key of ``params`` (a model or a
    state_dict); a warning names the others."""
    keys = _keys(params)
    matched = [m for m in modules if any(k.startswith(m) for k in keys)]
    missing = set(modules) - set(matched)
    if missing:
        logging.warning(f"modules not found in params: {sorted(missing)}")
    return matched


def get_partial_params(
    src_params: Mapping[str, torch.Tensor], dst_params: Mapping[str, torch.Tensor], modules: Sequence[str]
) -> Dict[str, torch.Tensor]:
    """``dst_params`` with the entries under ``modules`` taken from
    ``src_params`` where the key exists there with the same shape; a
    warning names each entry skipped."""
    merged = dict(dst_params)
    for key, dst in dst_params.items():
        if not any(key.startswith(m) for m in modules):
            continue
        src = src_params.get(key)
        if src is not None and tuple(src.shape) == tuple(dst.shape):
            merged[key] = src
        else:
            logging.warning(f"skip transfer of {key} (missing or shape mismatch)")
    return merged


def freeze_modules_mask(params: StateLike, modules: Sequence[str]) -> Dict[str, bool]:
    """``{key: trainable}``: False under ``modules``, True elsewhere."""
    return {k: not any(k.startswith(m) for m in modules) for k in _keys(params)}


def freeze_optimizer(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                     frozen_modules: Sequence[str]) -> torch.optim.Optimizer:
    """Take the parameters under ``frozen_modules`` out of ``optimizer``'s
    parameter groups, so that no update (weight decay included) moves them,
    as the JAX helper's ``optax.set_to_zero`` branch does. Call it before
    the first step; returns ``optimizer``."""
    mask = freeze_modules_mask(model, frozen_modules)
    frozen = {id(p) for n, p in model.named_parameters() if not mask[n]}
    for group in optimizer.param_groups:
        group["params"] = [p for p in group["params"] if id(p) not in frozen]
    return optimizer
