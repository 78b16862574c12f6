"""LR schedules and the optimizer (counterpart of jatts_tpu/train/schedulers.py).

A schedule is a plain function of the optimizer's update count, as the
optax schedules are: the first update uses ``schedule(0)`` (optax calls the
schedule with the count *before* the update), and ``warmuplr`` clamps that
step to 1. The trainer sets each update's learning rate itself, so no torch
``LRScheduler`` (whose first ``step()`` would shift the count by one) is used.

Gradient clipping is optax's ``clip_by_global_norm`` rule
(:func:`clip_by_global_norm`): gradients are scaled by ``max_norm / norm``
only when ``norm >= max_norm``, as ``(g / norm) * max_norm``; torch's
``clip_grad_norm_`` divides by ``norm + 1e-6`` instead.
``torch.optim.Adam``'s bias correction equals ``optax.adam``'s, and AdamW's
decoupled decay equals ``optax.adamw``'s.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

Schedule = Callable[[int], float]


def warmuplr(base_lr: float, warmup_steps: int = 25000) -> Schedule:
    """ESPnet WarmupLR: ``base_lr·w^0.5·min(s^-0.5, s·w^-1.5)``, s >= 1."""

    def schedule(step: int) -> float:
        s = max(float(step), 1.0)
        return base_lr * warmup_steps**0.5 * min(s**-0.5, s * warmup_steps**-1.5)

    return schedule


def steplr(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    def schedule(step: int) -> float:
        return base_lr * gamma ** math.floor(step / step_size)

    return schedule


def exponentiallr(base_lr: float, gamma: float) -> Schedule:
    def schedule(step: int) -> float:
        return base_lr * gamma**step

    return schedule


def _linear(init: float, end: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule."""

    def schedule(step: int) -> float:
        count = min(max(step, 0), transition_steps)
        return (init - end) * (1.0 - count / transition_steps) + end

    return schedule


def e2tts_sequentiallr(base_lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warm-up from 1e-8 to ``base_lr``, then linear decay to 1e-8
    (optax.join_schedules of two linear schedules at ``warmup_steps``)."""
    up = _linear(1e-8, base_lr, warmup_steps)
    down = _linear(base_lr, 1e-8, max(total_steps - warmup_steps, 1))

    def schedule(step: int) -> float:
        return up(step) if step < warmup_steps else down(step - warmup_steps)

    return schedule


def build_schedule(config: Dict[str, Any]) -> Schedule:
    """The schedule from the experiment config (``scheduler`` /
    ``scheduler_type``, ``scheduler_params``, ``optimizer_params.lr``)."""
    base_lr = float(config.get("optimizer_params", {}).get("lr", 1e-3))
    name = (config.get("scheduler") or config.get("scheduler_type") or "constant").lower()
    params = config.get("scheduler_params", {}) or {}
    if name == "warmuplr":
        return warmuplr(base_lr, int(params.get("warmup_steps", 25000)))
    if name == "steplr":
        return steplr(base_lr, int(params["step_size"]), float(params.get("gamma", 0.1)))
    if name == "exponentiallr":
        return exponentiallr(base_lr, float(params["gamma"]))
    if name in ("e2tts_sequentiallr", "sequentiallr"):
        return e2tts_sequentiallr(
            base_lr,
            int(params.get("warmup_steps", 1000)),
            int(config.get("train_max_steps", 100000)),
        )
    if name == "constant":
        return lambda step: base_lr
    raise ValueError(f"unknown scheduler: {name}")


def build_optimizer(config: Dict[str, Any], params: Iterable[torch.nn.Parameter]):
    """Adam, AdamW (``optimizer_type: AdamW`` or a ``weight_decay``) or SGD
    over ``params``, at ``schedule(0)``; the trainer sets the rate of every
    later update. Clipping (``grad_norm``) is the trainer's, by
    :func:`clip_by_global_norm`."""
    schedule = build_schedule(config)
    opt_name = (config.get("optimizer_type") or "Adam").lower()
    opt_params = dict(config.get("optimizer_params", {}))
    opt_params.pop("lr", None)
    betas = tuple(opt_params.pop("betas", (0.9, 0.999)))
    eps = float(opt_params.pop("eps", 1e-8))
    weight_decay = float(opt_params.pop("weight_decay", 0.0))
    lr = schedule(0)
    if opt_name in ("adam", "adamw"):
        if opt_name == "adamw" or weight_decay:
            return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    if opt_name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(opt_params.pop("momentum", 0.0)))
    raise ValueError(f"unknown optimizer: {opt_name}")


def global_norm(grads: List[torch.Tensor], sharded: Optional[Sequence[bool]] = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, in f32 (optax.global_norm),
    over the logical parameters: a gradient marked in ``sharded`` is this
    rank's block of a tensor-parallel parameter, whose blocks' squares are
    summed over ``group`` (the model axis), so the parameter counts once."""
    if not sharded or not any(sharded):
        return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    whole = [g.float().pow(2).sum() for g, s in zip(grads, sharded) if not s]
    blocks = sum(g.float().pow(2).sum() for g, s in zip(grads, sharded) if s)
    dist.all_reduce(blocks, group=group)
    return torch.sqrt(sum(whole) + blocks if whole else blocks)


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, sharded: Optional[Sequence[bool]] = None,
                        group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when ``norm >= max_norm`` every
    gradient becomes ``(g / norm) * max_norm``; below it they are unchanged.
    Returns the norm before clipping (:func:`global_norm`'s, ``sharded``
    and ``group`` as there)."""
    norm = global_norm(grads, sharded, group)
    if bool(norm >= max_norm):
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(max_norm)
    return norm
