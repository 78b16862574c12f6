"""Activation checkpointing (counterpart of the JAX package's ``nn.remat``
with an optional ``jax.checkpoint_policies`` name).

:func:`checkpointed` runs ``fn(*args)`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward keeps
only ``fn``'s inputs (or, under a selective policy, the outputs the policy
saves) and the backward runs ``fn`` again. The policy names are the
``jax.checkpoint_policies`` entries that take no argument:

    None, ``nothing_saveable``       full remat: nothing inside is kept
    ``everything_saveable``          every op's output kept (remat's
                                     bookkeeping, nothing recomputed)
    ``dots_saveable`` (alias         matmuls and convolutions kept, the rest
    ``checkpoint_dots``)             recomputed
    ``dots_with_no_batch_dims_saveable`` (alias
    ``checkpoint_dots_with_no_batch_dims``)
                                     matmuls without batch dims kept (what
                                     ``nn.Linear`` runs), the rest recomputed

A selective policy is a ``create_selective_checkpoint_contexts`` policy over
the aten ops it sees: ``nn.Linear`` reaches it as ``addmm`` or ``mm`` (no
batch dims), a batched matmul as ``bmm`` or ``baddbmm``, a convolution as
``convolution``. The flash-attention op ``jatts::flash_attn_fwd`` is not a
dot, as a ``pallas_call`` is not a ``dot_general`` for JAX: under
``dots_saveable`` its forward kernel runs again in the backward.

The port draws its dropout masks from its own ``torch.Generator`` objects
(``modules/dropout.py``), which ``torch.utils.checkpoint`` does not restore.
:func:`checkpointed` takes the generators ``fn`` draws from, records their
states before the forward, sets them to those states for the recomputation
and puts back, after it, the states they had when it began: the recomputed
masks are the forward's and the draws after the backward are the ones a
plain step makes. The caller applies remat only in training with grad mode
on; in eval, under ``no_grad`` and under ``torch.export`` the plain call runs,
as ``nn.remat`` changes nothing there.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

_aten = torch.ops.aten
DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
DOTS = DOTS_NO_BATCH | frozenset({
    _aten.bmm.default, _aten.baddbmm.default, _aten.convolution.default, _aten._convolution.default,
})

# jax.checkpoint_policies name -> the set of aten ops whose outputs are kept
# (None: nothing, "all": everything)
POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": DOTS,
    "checkpoint_dots": DOTS,
    "dots_with_no_batch_dims_saveable": DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": DOTS_NO_BATCH,
}


def resolve_policy(name: Optional[str]) -> Optional[Callable]:
    """The selective-checkpoint policy function for a
    ``jax.checkpoint_policies`` name, or None for full remat (``None``,
    ``nothing_saveable``). Raises ``ValueError`` naming any other name (one
    JAX lacks, or one of JAX's that takes arguments)."""
    if name is None:
        return None
    if name not in POLICIES:
        raise ValueError(
            f"remat_policy {name!r} is not a jax.checkpoint_policies name that takes no argument; "
            f"use one of {sorted(POLICIES)} or None"
        )
    saved = POLICIES[name]
    if saved is None:
        return None

    def policy(ctx, func, *args, **kwargs):
        keep = saved == "all" or func in saved
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE

    policy.__name__ = name
    return policy


def dropout_generators(*modules: nn.Module) -> List[torch.Generator]:
    """The distinct generators the dropouts of ``modules`` draw from."""
    from jatts_torch.modules.dropout import Dropout

    out: List[torch.Generator] = []
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, Dropout) and m.generator is not None and all(m.generator is not g for g in out):
                out.append(m.generator)
    return out


@contextlib.contextmanager
def _replay(generators: Sequence[torch.Generator], states: Sequence[torch.Tensor]) -> Iterator[None]:
    now = [g.get_state() for g in generators]
    for g, s in zip(generators, states):
        g.set_state(s)
    try:
        yield
    finally:
        for g, s in zip(generators, now):
            g.set_state(s)


@contextlib.contextmanager
def _both(first, second) -> Iterator[None]:
    with first, second:
        yield


def checkpointed(fn: Callable, *args, policy: Optional[Callable] = None,
                 generators: Iterable[torch.Generator] = ()):
    """``fn(*args)`` with its activations recomputed in the backward
    (``policy`` from :func:`resolve_policy`; None: full remat). Every
    generator in ``generators`` replays, in the recomputation, the draws it
    made in the forward."""
    gens = list(generators)
    states = [g.get_state() for g in gens]

    def context_fn():
        if policy is None:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            fwd, rec = create_selective_checkpoint_contexts(policy)
        return fwd, _both(_replay(gens, states), rec)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


class Remat:
    """A model's remat setting: ``use_remat`` and the policy resolved once
    (an unknown ``remat_policy`` raises at construction, and only under
    ``use_remat``, as the JAX model reads it only then)."""

    def __init__(self, use_remat: bool = False, remat_policy: Optional[str] = None):
        self.on = bool(use_remat)
        self.name = remat_policy
        self.policy = resolve_policy(remat_policy) if self.on else None

    def active(self, module: nn.Module) -> bool:
        """Remat applies to ``module`` now: on, training, grad mode on."""
        return self.on and module.training and torch.is_grad_enabled()

    def __call__(self, fn: Callable, *args, generators: Iterable[torch.Generator] = ()):
        return checkpointed(fn, *args, policy=self.policy, generators=generators)
