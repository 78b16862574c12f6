"""The trainer (counterpart of jatts_tpu/train/trainer.py:Trainer), on one
device or on a mesh of processes.

One step is, in the JAX package's order: forward and loss in training mode
(BatchNorm updates its running statistics inside the forward), the
gradients, the global-norm clip (optax's rule), the Adam update at
``schedule(update_count)``, then the EMA of the weights. With
``gradient_accumulate_steps: k`` the gradients are averaged over k steps
(``optax.MultiSteps``: a running mean) and the clip and the update happen on
every k-th step only; the EMA and the running statistics move every step,
as they do there.

Dropout masks come from one ``torch.Generator`` that the trainer re-seeds
from ``(seed, step)`` before each step, in the role of the JAX trainer's
``fold_in(rng, step)``: the masks of a step do not depend on how the run got
there, so a resumed run draws what an uninterrupted one would. The training
noise (the JAX package's "noise" stream: Matcha's t and z, VITS's eps and
the stochastic duration predictor's e_q) comes from a second generator,
re-seeded the same way from its own stream and handed to every module with
a ``noise_generator`` (``modules/noise.py``).

``run()`` keeps the JAX loop's boundary-crossing rule for the log, eval and
save intervals and its deferred stop (``request_stop``, set by the CLI's
SIGTERM handler, raises ``SystemExit(143)`` at the next step boundary).
``steps_per_execution`` (a K-step ``lax.scan`` that saves TPU dispatches)
is accepted and has no effect: the K steps run one by one, which the JAX
package pins as equal (tests/test_train_loop.py). ``rng_impl`` (the TPU's
dropout-mask generator) is accepted and has no effect either.

The parameters are float32; a model may compute in another dtype
(``model_params.dtype``, flax's compute dtype), as the JAX modules do.
Each log interval writes the averaged ``train/*`` stats, ``train/lr`` and,
on the card, ``mem/*`` to an event file in ``outdir`` (``utils/events.py``),
each eval interval ``eval/*``, at the JAX trainer's tags and steps; after
the eval interval ``eval_hook(trainer)`` runs (``train/intermediate.py``).

With a ``mesh`` (``parallel/mesh.py``; the config's ``mesh: {model: M,
sequence_parallel: ...}``), every rank sees the identical global batch,
pads it to the mesh's device count (the JAX trainer's quirk: the count,
not the data axis) and keeps its part; the step computes what the
one-process step computes on the global batch, up to f32 reduction order.
The gradients are summed over the world (a tensor-parallel block over the
data axis: its gather summed it over the model axis), the clip's norm
counts each parameter once, Adam, the accumulation and the EMA run on each
rank's blocks, the stats are summed over the world before they are logged,
and the event file and the logs are rank 0's. A stop asked on any rank
(``request_stop``) is agreed by all at the step boundary. A checkpoint is
the whole state in the one-process format, whatever the mesh: every rank
takes part in its save (rank 0 writes) and its load. Sequence parallelism
is ported for the models with ``supports_seq_parallel`` (E2-TTS). The
eval hook runs on rank 0 when no parameter is sharded and is skipped
otherwise.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from jatts_torch.modules.dropout import set_dropout_generator
from jatts_torch.modules.noise import set_noise_generator
from jatts_torch.parallel.mesh import (
    Mesh, activate, pad_batch_to_devices, shard_batch, shard_of, shard_parameters, tp_plan, unshard,
)
from jatts_torch.train.schedulers import build_optimizer, build_schedule, clip_by_global_norm, global_norm
from jatts_torch.utils.checkpoint import checkpoint_dir, find_latest_checkpoint, restore_checkpoint, save_checkpoint
from jatts_torch.utils.events import EventWriter
from jatts_torch.utils.initialize import initialize

# the noise generator's seeds: the dropout seeds with the top bit set
NOISE_STREAM = 1 << 63

LossFn = Callable[..., Any]
# signature: (model, batch, criterions, config, step) -> (loss, stats_dict)


class Trainer:
    """Steps-based training loop with interval hooks (log/eval/save)."""

    def __init__(
        self,
        config: Dict[str, Any],
        model: torch.nn.Module,
        criterions: Dict[str, Any],
        loss_fn: LossFn,
        train_loader,
        dev_loader=None,
        outdir: str = "exp/tmp",
        seed: int = 0,
        eval_hook: Optional[Callable[["Trainer"], None]] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.mesh = mesh
        self.seq_parallel = bool((config.get("mesh") or {}).get("sequence_parallel", False)) and mesh is not None
        if self.seq_parallel:
            if mesh.n_model < 2:
                raise ValueError("sequence_parallel needs mesh.model >= 2")
            if not getattr(model, "supports_seq_parallel", False):
                raise ValueError(f"sequence parallelism is not ported for {type(model).__name__} (E2TTS takes it)")
            mesh.seq_parallel = True
        self.is_main = mesh is None or dist.get_rank() == 0
        dtypes = {p.dtype for p in model.parameters()}
        if dtypes != {torch.float32}:
            raise TypeError(f"the parameters must be float32; the model holds {sorted(map(str, dtypes))}")
        self.config = config
        self.model = model
        self.criterions = criterions
        self.loss_fn = loss_fn
        self.train_loader = train_loader
        self.dev_loader = dev_loader
        self.outdir = outdir
        self.seed = int(seed)
        self.device = next(model.parameters()).device
        self.steps = 0
        self.epochs = 0
        self.schedule = build_schedule(config)
        self.accum = int(config.get("gradient_accumulate_steps", 1) or 1)
        self.max_grad_norm = float(config.get("grad_norm", 0) or 0)
        self.ema_decay = float(config.get("ema_decay", 0.0) or 0.0)
        k_exec = int(config.get("steps_per_execution", 1) or 1)
        if k_exec > 1:
            logging.info(
                f"steps_per_execution={k_exec} has no effect on the GPU: the steps run one by one"
            )
        if config.get("rng_impl"):
            logging.info(f"rng_impl={config['rng_impl']} has no effect: dropout draws from a torch.Generator")
        self.generator = torch.Generator(device=self.device)
        set_dropout_generator(model, self.generator)
        self.noise_generator = torch.Generator(device=self.device)
        set_noise_generator(model, self.noise_generator)
        self.names: List[str] = [n for n, _ in model.named_parameters()]
        self.params: List[torch.nn.Parameter] = list(model.parameters())
        self.tp: Dict[str, int] = {}  # tensor-parallel parameters -> the dimension split
        self.sharded: List[bool] = [False] * len(self.params)
        self._sd_keys: List[str] = []  # the one-process state_dict's keys, in order
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.updates = 0  # optimizer updates applied (optax's inner count)
        self.mini_step = 0  # position inside a gradient-accumulation window
        self.acc_grads: Optional[List[torch.Tensor]] = None
        self.ema: Optional[List[torch.Tensor]] = None
        self.history: List[Dict[str, float]] = []  # every training step's stats
        self.total_train_loss: Dict[str, float] = defaultdict(float)
        self.finish_train = False
        self.request_stop = False
        self.eval_hook = eval_hook
        self._writer: Optional[EventWriter] = None
        os.makedirs(outdir, exist_ok=True)

    @property
    def writer(self) -> EventWriter:
        """The scalar event file in ``outdir`` (``utils/events.py``), made at
        the first logged scalar."""
        if self._writer is None:
            self._writer = EventWriter(self.outdir)
        return self._writer

    def _device_memory_stats(self) -> Dict[str, float]:
        """``mem/*`` in GiB, as the JAX trainer logs them; none on the CPU."""
        if self.device.type != "cuda":
            return {}
        return {
            "mem/bytes_in_use_gb": torch.cuda.memory_allocated(self.device) / 2**30,
            "mem/peak_bytes_gb": torch.cuda.max_memory_allocated(self.device) / 2**30,
        }

    # -- state ------------------------------------------------------------
    def init_state(self) -> None:
        """Re-initialize the weights per the model's ``init_type`` (seeded
        from ``seed``), build the optimizer and the EMA copy."""
        init_type = getattr(self.model, "init_type", None)
        if init_type and init_type != "none":
            initialize(self.model, init_type, seed=self.seed + 1)
        if self.mesh is not None and self.mesh.n_model > 1 and not self.tp:
            self.tp = tp_plan(self.model, self.mesh.n_model)
            self._sd_keys = list(self.model.state_dict())
            blocks = shard_parameters(self.model, self.tp, self.mesh)
            stored = dict(self.model.named_parameters())
            self.params = [blocks[n] if n in blocks else stored[n] for n in self.names]
            self.sharded = [n in blocks for n in self.names]
        self.optimizer = build_optimizer(self.config, self.params)
        self.ema = [p.detach().clone() for p in self.params] if self.ema_decay > 0 else None
        n_params = sum(p.numel() for p in self.params)
        logging.info(f"model parameters: {n_params:,} on this rank ({sum(self.sharded)} tensors sharded)")

    def _local(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Under a mesh, this rank's part of the global numpy batch, padded
        to the device count first; the batch itself otherwise."""
        if self.mesh is None:
            return batch
        batch = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
        return shard_batch(pad_batch_to_devices(batch, self.mesh.size), self.mesh, self.seq_parallel)

    def _sum_stats(self, stats: Dict[str, Any]) -> Dict[str, float]:
        """The stats as floats, summed over the world under a mesh (each
        rank's loss is its share of the global one)."""
        keys = sorted(stats)
        vals = torch.stack([torch.as_tensor(stats[k], device=self.device).detach().float() for k in keys])
        if self.mesh is not None:
            dist.all_reduce(vals)
        return dict(zip(keys, vals.tolist()))

    def _reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum the gradients over the world, a tensor-parallel block's over
        the data axis, in one flat buffer a group."""
        for shard, group, n in ((False, None, self.mesh.size), (True, self.mesh.data_group, self.mesh.n_data)):
            sel = [g for g, s in zip(grads, self.sharded) if s == shard]
            if not sel or n == 1:
                continue
            flat = torch.cat([g.reshape(-1) for g in sel])
            dist.all_reduce(flat, group=group)
            off = 0
            for g in sel:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A numpy batch as tensors on the model's device (integer arrays
        as int64, float arrays as float32); ``utt_ids`` dropped."""
        out = {}
        for k, v in batch.items():
            if k == "utt_ids" or v is None:
                continue
            arr = np.asarray(v)
            t = torch.from_numpy(arr.astype(np.int64 if arr.dtype.kind in "iu" else np.float32))
            out[k] = t.to(self.device, non_blocking=True)
        return out

    # -- steps ------------------------------------------------------------
    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One training step on a numpy (or tensor) batch; returns its stats."""
        if self.optimizer is None:
            self.init_state()
        batch = self._local(batch)
        tb = batch if all(isinstance(v, torch.Tensor) for v in batch.values()) else self.to_device(batch)
        self.model.train()
        self.generator.manual_seed((self.seed << 32) + self.steps)
        self.noise_generator.manual_seed(((self.seed << 32) + self.steps) | NOISE_STREAM)
        with activate(self.mesh):
            loss, stats = self.loss_fn(self.model, tb, self.criterions, self.config, self.steps)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        model_group = None
        if self.mesh is not None:
            self._reduce_grads(grads)
            model_group = self.mesh.model_group
        grad_norm = global_norm(grads, self.sharded, model_group)

        if self.accum > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for a, g in zip(self.acc_grads, grads):
                a.add_((g - a) / (n + 1))  # running mean (optax.MultiSteps)
            emit = n == self.accum - 1
            update = self.acc_grads
        else:
            emit, update = True, grads
        if emit:
            if self.max_grad_norm > 0:
                clip_by_global_norm(update, self.max_grad_norm, self.sharded, model_group)
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.updates)
            for p, g in zip(self.params, update):
                p.grad = g
            self.optimizer.step()
            for p in self.params:
                p.grad = None
            self.updates += 1
            if self.acc_grads is not None:
                for a in self.acc_grads:
                    a.zero_()
        self.mini_step = (self.mini_step + 1) % self.accum
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema, self.params):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        self.steps += 1
        out = self._sum_stats({**stats, "train/loss": loss})
        out["train/grad_norm"] = float(grad_norm)
        self.history.append(out)
        return out

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """Loss and stats of one batch in eval mode (running statistics, no
        dropout); the mode is restored after."""
        was_training = self.model.training
        self.model.eval()
        try:
            with activate(self.mesh):
                loss, stats = self.loss_fn(
                    self.model, self.to_device(self._local(batch)), self.criterions, self.config, self.steps
                )
        finally:
            self.model.train(was_training)
        return self._sum_stats({**stats, "loss": loss})

    # -- loop -------------------------------------------------------------
    def run(self) -> None:
        max_steps = int(self.config["train_max_steps"])
        log_every = int(self.config.get("log_interval_steps", 100))
        save_every = int(self.config.get("save_interval_steps", 10000))
        eval_every = int(self.config.get("eval_interval_steps", 10000))
        t0 = time.time()
        while not self.finish_train:
            if hasattr(self.train_loader.sampler, "set_epoch"):
                self.train_loader.sampler.set_epoch(self.epochs)
            for batch in self.train_loader:
                stats = self.train_step(batch)
                self._after_steps(1, stats, log_every, save_every, eval_every, t0)
                if self.steps % log_every < 1:
                    t0 = time.time()
                if self.steps >= max_steps:
                    self.finish_train = True
                    break
            self.epochs += 1
        logging.info(f"finished training at {self.steps} steps")

    def _after_steps(self, dk, stats, log_every, save_every, eval_every, t0):
        for k, v in stats.items():
            self.total_train_loss[k] += v * dk
        # boundary-crossing checks, as the JAX loop has them for K-step dispatches
        if (self.steps % log_every) < dk:
            self._log_interval(log_every, t0)
        if eval_every and (self.steps % eval_every) < dk:
            self._eval_interval()
        if (self.steps % save_every) < dk:
            self.save_checkpoint()
        stop = self.request_stop
        if self.mesh is not None:  # all ranks stop at the same step
            flag = torch.tensor([float(stop)], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            stop = bool(flag.item())
        if stop:
            raise SystemExit(143)  # deferred preemption stop, at a step boundary

    def _log_interval(self, interval: int, t0: float) -> None:
        dt = time.time() - t0
        if not self.is_main:
            self.total_train_loss = defaultdict(float)
            return
        msgs = []
        for k, v in sorted(self.total_train_loss.items()):
            self.writer.add_scalar(k, v / interval, self.steps)
            msgs.append(f"{k}={v / interval:.4f}")
        lr = self.schedule(self.steps // self.accum)
        self.writer.add_scalar("train/lr", lr, self.steps)
        for k, v in self._device_memory_stats().items():
            self.writer.add_scalar(k, v, self.steps)
            msgs.append(f"{k}={v:.2f}")
        logging.info(
            f"(steps {self.steps}) {' '.join(msgs)} lr={lr:.2e} "
            f"({interval / max(dt, 1e-9):.2f} steps/s)"
        )
        self.total_train_loss = defaultdict(float)

    def _eval_interval(self) -> None:
        if self.dev_loader is None:
            return
        totals: Dict[str, float] = defaultdict(float)
        count = 0
        for batch in self.dev_loader:
            for k, v in self.eval_step(batch).items():
                totals[k] += v
            count += 1
        if not self.is_main:
            return
        for k, v in totals.items():
            # loss functions emit 'train/<name>': the tag is 'eval/<name>'
            tag = k.split("/", 1)[1] if k.startswith("train/") else k
            self.writer.add_scalar(f"eval/{tag}", v / max(count, 1), self.steps)
        logging.info(
            f"(steps {self.steps}) eval "
            + " ".join(f"{k}={v / max(count, 1):.4f}" for k, v in sorted(totals.items()))
        )
        if self.eval_hook is not None:
            if self.tp:
                logging.info("eval hook skipped: the model's parameters are sharded over the mesh")
            else:
                self.eval_hook(self)

    # -- checkpoint -------------------------------------------------------
    def save_checkpoint(self) -> str:
        if self.optimizer is None:
            raise RuntimeError("call init_state before save_checkpoint")
        opt = self.optimizer.state_dict()
        if self.tp:
            opt = {**opt, "state": {i: {k: self._whole(i, v) for k, v in st.items()}
                                    for i, st in opt["state"].items()}}
        state = {
            "model": self._model_state(),
            "optimizer": {
                "state_dict": opt,
                "updates": self.updates,
                "mini_step": self.mini_step,
                "acc_grads": None if self.acc_grads is None else [
                    self._whole(i, a) for i, a in enumerate(self.acc_grads)],
            },
            "steps": self.steps,
            "epochs": self.epochs,
            "ema": None if self.ema is None else {
                n: self._whole(i, e) for i, (n, e) in enumerate(zip(self.names, self.ema))},
        }
        if self.is_main:
            path = save_checkpoint(self.outdir, self.steps, state)
        else:
            path = checkpoint_dir(self.outdir, self.steps)
        if self.mesh is not None:
            dist.barrier()
        logging.info(f"saved checkpoint: {path}")
        return path

    # -- the whole state from the ranks' blocks, and back ------------------
    def _pkey(self, name: str) -> str:
        """A state_dict key as the sharded model stores it."""
        if name not in self.tp:
            return name
        mod, _, attr = name.rpartition(".")
        return f"{mod}.parametrizations.{attr}.original" if mod else f"parametrizations.{attr}.original"

    def _whole(self, i: int, t):
        """Parameter ``i``'s tensor ``t`` (the weight, a moment, the EMA) whole."""
        if not self.sharded[i] or not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        return unshard(t, self.tp[self.names[i]], self.mesh)

    def _block(self, i: int, t):
        """This rank's block of parameter ``i``'s whole tensor ``t``."""
        if not self.sharded[i] or not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        return shard_of(t, self.tp[self.names[i]], self.mesh).clone()

    def _model_state(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict in the one-process layout and key order."""
        sd = self.model.state_dict()
        if not self.tp:
            return sd
        index = {n: i for i, n in enumerate(self.names)}
        return {k: self._whole(index[k], sd[self._pkey(k)]) if k in self.tp else sd[k] for k in self._sd_keys}

    def _load_model_state(self, sd: Dict[str, torch.Tensor]) -> None:
        if not self.tp:
            self.model.load_state_dict(sd)
            return
        index = {n: i for i, n in enumerate(self.names)}
        self.model.load_state_dict({self._pkey(k): self._block(index[k], v) if k in self.tp else v
                                    for k, v in sd.items()})

    def load_checkpoint(self, path: Optional[str] = None, load_only_params: bool = False) -> None:
        """Resume from ``path`` (default: the latest under ``outdir``). With
        ``load_only_params`` only the weights, the running statistics and,
        when EMA is on, the EMA copy are taken."""
        if path is None:
            path = find_latest_checkpoint(self.outdir)
            if path is None:
                raise FileNotFoundError(f"no checkpoint under {self.outdir}")
        if self.optimizer is None:
            raise RuntimeError("call init_state before load_checkpoint")
        restored = restore_checkpoint(path, map_location=self.device)
        self._load_model_state(restored["model"])
        if self.ema is not None:
            ema = restored.get("ema")
            with torch.no_grad():
                for i, (e, name) in enumerate(zip(self.ema, self.names)):
                    e.copy_(self.params[i] if ema is None else self._block(i, ema[name]))
        if not load_only_params:
            opt = restored["optimizer"]
            sd = opt["state_dict"]
            if self.tp:
                sd = {**sd, "state": {i: {k: self._block(int(i), v) for k, v in st.items()}
                                      for i, st in sd["state"].items()}}
            self.optimizer.load_state_dict(sd)
            self.updates = int(opt["updates"])
            self.mini_step = int(opt["mini_step"])
            acc = opt["acc_grads"]
            self.acc_grads = None if acc is None else [self._block(i, a) for i, a in enumerate(acc)]
            self.steps = int(restored["steps"])
            self.epochs = int(restored.get("epochs", 0))
        logging.info(f"loaded checkpoint from {path} (steps={self.steps})")
