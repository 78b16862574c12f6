"""The device mesh and the batch's layout over it (counterpart of
jatts_tpu/parallel/mesh.py).

One process drives one device. The processes join one
``torch.distributed`` group from torchrun's environment
(:func:`init_distributed`: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), over the backend the caller names
(``nccl`` on the card, ``gloo`` on the CPU). :func:`get_mesh` lays the
ranks out as a 2-D ``DeviceMesh`` ``("data", "model")``, model the inner
axis, as ``mesh_utils.create_device_mesh((n_data, n_model))`` does there.

A step over the mesh computes what the one-process step computes on the
same global batch, up to f32 reduction order, as the JAX package's
sharding (layout, not math) does:

- every rank builds the identical global batch; :func:`shard_batch` gives
  each data rank its block of rows and, under sequence parallelism, each
  model rank its block of every time axis that :func:`_seq_shardable`
  admits; under tensor parallelism the model ranks of a data rank hold the
  same rows;
- a random draw (:func:`draw`) is drawn at the global batch's shape from
  the trainer's per-step generator and cut to this rank's part, so the
  masks and the noise do not depend on the mesh;
- a loss is this rank's sum over the count of the whole world
  (:func:`global_sum`), so the ranks' losses add up to the global loss
  (model ranks that hold the same rows count their rows M times and add M
  equal shares); BatchNorm's statistics are the world's sums over the
  world's count (:func:`all_reduce_sum`), which is the global batch's;
- the trainer sums the gradients over the world (over the data axis for a
  tensor-parallel shard, whose gather already summed over the model axis).

Tensor parallelism: :func:`tp_plan` is the JAX rule
(``shard_params_tp``: a parameter of at least ``min_size`` elements and two
dimensions is split over "model" along its output dimension, else its
input dimension, when the axis size divides it), mapped from flax's
``[in, out]`` to the port's layout; :func:`shard_parameters` keeps 1/M of
each such parameter on a rank (and so 1/M of its Adam moments and its
EMA) and gathers the whole where a module reads it; the gather's gradient
is the sum over the model axis of the ranks' gradients, cut to the shard.

The collectives are ``all_reduce`` and ``all_gather``; a reduce-scatter is
an ``all_reduce`` cut to the shard. Gloo takes them on CPU and CUDA
tensors, NCCL on CUDA tensors.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

AXES = ("data", "model")


def init_distributed(backend: str, timeout: float = 600.0) -> Tuple[int, int, int]:
    """Join the process group from torchrun's environment; returns
    ``(rank, world_size, local_rank)``. ``backend`` is ``nccl`` or ``gloo``,
    as the caller names it; ``timeout`` (seconds) bounds every collective,
    so a rank that never arrives fails the others instead of hanging them."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
        )
    return rank, world, local_rank


def local_device(device_type: str) -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK mod the card count}`` (two
    ranks may share one card), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


class SeqScope:
    """Under sequence parallelism: the global positions ``index`` [n_local]
    of this rank's rows along axis 1 of a sequence ``length`` long."""

    def __init__(self, index: torch.Tensor, length: int):
        self.index = index
        self.length = int(length)


class Mesh:
    """This process's place in the ``(n_data, n_model)`` layout of the
    world: its coordinates, the groups along each axis, whether time axes
    are cut over "model" (``seq_parallel``, which the trainer sets from its
    config) and which keys of the current batch :func:`shard_batch` cut
    (``seq_keys``)."""

    def __init__(self, n_data: int, n_model: int, device_type: str):
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if n_data * n_model != world:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, the world has {world}")
        self.device_mesh = init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)
        self.n_data, self.n_model = n_data, n_model
        self.size = world
        self.data_group = self.device_mesh.get_group("data")
        self.model_group = self.device_mesh.get_group("model")
        self.data_rank = dist.get_rank(self.data_group)
        self.model_rank = dist.get_rank(self.model_group)
        self.seq_parallel = False
        self.seq_keys: frozenset = frozenset()
        self.seq: Optional[SeqScope] = None

    def rows(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This data rank's block of a global tensor's batch axis."""
        b = x.shape[axis] // self.n_data
        return x.narrow(axis, self.data_rank * b, b)

    def frames(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """This model rank's block of a global tensor's time axis."""
        n = x.shape[axis] // self.n_model
        return x.narrow(axis, self.model_rank * n, n)


def get_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cpu") -> Mesh:
    """The world as a ``(n_data, n_model)`` mesh (``n_data`` defaults to
    the world size over ``n_model``). Every rank calls it."""
    if n_data is None:
        n_data = dist.get_world_size() // n_model
    return Mesh(n_data, n_model, device_type)


# -- the mesh a step runs on -----------------------------------------------

_ACTIVE: Optional[Mesh] = None


def active() -> Optional[Mesh]:
    """The mesh of the step being computed, None outside a mesh step."""
    return _ACTIVE


@contextlib.contextmanager
def activate(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the block's forwards and backwards as one mesh step."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def seq_scope(index: torch.Tensor, length: int) -> Iterator[None]:
    """Inside the block, axis 1 of a tensor :func:`draw` draws for is this
    model rank's part (global positions ``index``) of a ``length`` long
    sequence. Without an active mesh it does nothing."""
    m = active()
    if m is None:
        yield
        return
    prev, m.seq = m.seq, SeqScope(index, length)
    try:
        yield
    finally:
        m.seq = prev


def draw(sample: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int], rows: bool = True) -> torch.Tensor:
    """``sample(shape)`` as the one-process step draws it: under a mesh,
    ``sample`` draws at the global batch's shape (axis 0 times the data
    axis when ``rows``; axis 1 the whole sequence inside :func:`seq_scope`)
    and this rank keeps its part. ``rows=False`` is for a tensor without a
    batch axis (a positional table), drawn whole on every rank."""
    shape = tuple(int(s) for s in shape)
    m = active()
    if m is None or not rows:
        return sample(shape)
    g = list(shape)
    g[0] *= m.n_data
    seq = m.seq if m.seq is not None and len(shape) > 1 and shape[1] == len(m.seq.index) else None
    if seq is not None:
        g[1] = seq.length
    out = sample(tuple(g)).narrow(0, m.data_rank * shape[0], shape[0])
    if seq is not None:
        out = out.index_select(1, seq.index.to(out.device))
    return out


# -- collectives -------------------------------------------------------------


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank of the active mesh, without a
    gradient (a loss's count); ``x`` itself outside a mesh step."""
    m = active()
    if m is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def share() -> float:
    """This rank's share of a constant term of a loss (1 over the world's
    size under a mesh), so that the ranks' losses add up to it once."""
    m = active()
    return 1.0 if m is None else 1.0 / m.size


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the elements of every rank: this rank's sum over
    the world's count under a mesh (:func:`global_sum`)."""
    if active() is None:
        return x.mean()
    return x.sum() / global_sum(torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (the world by default) of the active
    mesh, with its gradient (each rank's gradient is the sum of the ranks'
    gradients); ``x`` itself outside a mesh step."""
    if active() is None:
        return x
    return _AllReduce.apply(x.contiguous(), group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.group, ctx.rank, ctx.size = dim, group, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``group`` concatenated along ``dim`` in rank
    order; the gradient of a block is the sum of the ranks' gradients of it."""
    return _Gather.apply(x, dim, group)


# -- the batch ---------------------------------------------------------------


def pad_batch_to_devices(batch: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Pad the batch axis up to a multiple of ``n`` by repeating the last
    element; every ``*lens`` of the repeated rows is zeroed, so they are
    masked out of every model's loss."""
    b = None
    for v in batch.values():
        if isinstance(v, np.ndarray):
            b = v.shape[0]
            break
    if b is None or b % n == 0:
        return batch
    pad = n - b % n
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            reps = np.repeat(v[-1:], pad, axis=0)
            if k.endswith("lens"):
                reps = np.zeros_like(reps)
            out[k] = np.concatenate([v, reps], axis=0)
        elif isinstance(v, list):
            out[k] = v + [v[-1]] * pad
        else:
            out[k] = v
    return out


def _seq_shardable(k: str, v: np.ndarray, time_axis: int, n_model: int) -> bool:
    """Whether a batch entry's time axis is cut over "model": not the
    per-sample ``*lens``, and only a time length the axis size divides."""
    return (
        n_model > 1
        and v.ndim > time_axis
        and v.shape[time_axis] % n_model == 0
        and not k.endswith("lens")
    )


def shard_batch(batch: Dict[str, Any], mesh: Mesh, seq_parallel: bool = False) -> Dict[str, Any]:
    """This rank's part of the identical global numpy batch: the data rank's
    block of rows of every array (the batch size must be a multiple of the
    data axis, which padding to the device count makes it) and, with
    ``seq_parallel``, the model rank's block of axis 1 of every entry
    :func:`_seq_shardable` admits. Other entries pass through. Records the
    cut keys in ``mesh.seq_keys``."""
    out, cut = {}, set()
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            b = v.shape[0] // mesh.n_data
            v = v[mesh.data_rank * b:(mesh.data_rank + 1) * b]
            if seq_parallel and _seq_shardable(k, v, 1, mesh.n_model):
                n = v.shape[1] // mesh.n_model
                v = v[:, mesh.model_rank * n:(mesh.model_rank + 1) * n]
                cut.add(k)
            out[k] = np.ascontiguousarray(v)
        elif isinstance(v, list) and len(v) % mesh.n_data == 0:
            b = len(v) // mesh.n_data
            out[k] = v[mesh.data_rank * b:(mesh.data_rank + 1) * b]
        else:
            out[k] = v
    mesh.seq_keys = frozenset(cut)
    return out


# -- tensor parallelism --------------------------------------------------------

# modules whose weight is flax's kernel reversed: Linear [out, in] for
# [in, out], Conv [out, in/g, k] for [k, in/g, out]
_REVERSED = (nn.Linear, nn.Conv1d, nn.Conv2d)


def tp_plan(model: nn.Module, n_model: int, min_size: int = 2**16) -> Dict[str, int]:
    """The parameters the JAX rule (``shard_params_tp``) shards over
    "model", each with the dimension of the port's tensor it splits:
    a parameter with two or more dimensions and at least ``min_size``
    elements is split along flax's last dimension when ``n_model`` divides
    it, else along its second to last, else kept whole."""
    plan: Dict[str, int] = {}
    if n_model == 1:
        return plan
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            rev = isinstance(mod, _REVERSED) and p_name == "weight"
            shape = tuple(p.shape)[::-1] if rev else tuple(p.shape)
            if len(shape) < 2 or p.numel() < min_size:
                continue
            if shape[-1] % n_model == 0:
                fd = len(shape) - 1
            elif shape[-2] % n_model == 0:
                fd = len(shape) - 2
            else:
                continue
            plan[f"{mod_name}.{p_name}" if mod_name else p_name] = len(shape) - 1 - fd if rev else fd
    return plan


class _Shard(nn.Module):
    """Parametrization of a tensor-parallel parameter: the module stores
    this rank's block along ``dim`` and reads the whole, gathered over the
    model axis."""

    def __init__(self, dim: int, group, rank: int, n: int):
        super().__init__()
        self.dim, self.group, self.rank, self.n = dim, group, rank, n

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return gather(shard, self.dim, self.group)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        size = full.shape[self.dim] // self.n
        return full.narrow(self.dim, self.rank * size, size).clone()


def shard_parameters(model: nn.Module, plan: Dict[str, int], mesh: Mesh) -> Dict[str, nn.Parameter]:
    """Keep this model rank's block of every parameter of ``plan``; returns
    the stored blocks by the parameter's name."""
    out = {}
    for name, dim in plan.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        parametrize.register_parametrization(
            mod, attr, _Shard(dim, mesh.model_group, mesh.model_rank, mesh.n_model), unsafe=True,
        )
        out[name] = mod.parametrizations[attr].original
    return out


def shard_of(full: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's block of a whole tensor along ``dim``."""
    size = full.shape[dim] // mesh.n_model
    return full.narrow(dim, mesh.model_rank * size, size)


def unshard(shard: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from the model ranks' blocks (no gradient)."""
    parts = [torch.empty_like(shard) for _ in range(mesh.n_model)]
    dist.all_gather(parts, shard.detach().contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=dim)
