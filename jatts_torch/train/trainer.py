"""Single-GPU trainer (counterpart of jatts_tpu/train/trainer.py:Trainer).

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
there, so a resumed run draws what an uninterrupted one would.

``run()`` keeps the JAX loop's boundary-crossing rule for the log, eval and
save intervals and its deferred stop (``request_stop``, set by the CLI's
SIGTERM handler, raises ``SystemExit(143)`` at the next step boundary).
``steps_per_execution`` (a K-step ``lax.scan`` that saves TPU dispatches)
is accepted and has no effect: the K steps run one by one, which the JAX
package pins as equal (tests/test_train_loop.py).

Not ported: the device mesh (data, tensor and sequence parallelism),
multihost, ``rng_impl``, the tensorboard writer and the intermediate-results
hook; training in a dtype other than float32.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from jatts_torch.modules.dropout import set_dropout_generator
from jatts_torch.train.schedulers import build_optimizer, build_schedule, clip_by_global_norm, global_norm
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint, save_checkpoint
from jatts_torch.utils.initialize import initialize

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
    ):
        mesh = config.get("mesh") or {}
        if int(mesh.get("model", 1)) > 1 or mesh.get("sequence_parallel"):
            raise ValueError("mesh parallelism is not ported: the trainer runs on one GPU")
        dtypes = {p.dtype for p in model.parameters()}
        if dtypes != {torch.float32}:
            raise TypeError(f"training runs in float32 only; the model holds {sorted(map(str, dtypes))}")
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
        self.generator = torch.Generator(device=self.device)
        set_dropout_generator(model, self.generator)
        self.names: List[str] = [n for n, _ in model.named_parameters()]
        self.params: List[torch.nn.Parameter] = list(model.parameters())
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.updates = 0  # optimizer updates applied (optax's inner count)
        self.mini_step = 0  # position inside a gradient-accumulation window
        self.acc_grads: Optional[List[torch.Tensor]] = None
        self.ema: Optional[List[torch.Tensor]] = None
        self.history: List[Dict[str, float]] = []  # every training step's stats
        self.total_train_loss: Dict[str, float] = defaultdict(float)
        self.finish_train = False
        self.request_stop = False
        os.makedirs(outdir, exist_ok=True)

    # -- state ------------------------------------------------------------
    def init_state(self) -> None:
        """Re-initialize the weights per the model's ``init_type`` (seeded
        from ``seed``), build the optimizer and the EMA copy."""
        init_type = getattr(self.model, "init_type", None)
        if init_type and init_type != "none":
            initialize(self.model, init_type, seed=self.seed + 1)
        self.optimizer = build_optimizer(self.config, self.params)
        self.ema = [p.detach().clone() for p in self.params] if self.ema_decay > 0 else None
        n_params = sum(p.numel() for p in self.params)
        logging.info(f"model parameters: {n_params:,}")

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
        tb = batch if all(isinstance(v, torch.Tensor) for v in batch.values()) else self.to_device(batch)
        self.model.train()
        self.generator.manual_seed((self.seed << 32) + self.steps)
        loss, stats = self.loss_fn(self.model, tb, self.criterions, self.config, self.steps)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        grad_norm = global_norm(grads)

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
                clip_by_global_norm(update, self.max_grad_norm)
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
        out = {k: float(v.detach()) for k, v in stats.items()}
        out["train/loss"] = float(loss.detach())
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
            loss, stats = self.loss_fn(
                self.model, self.to_device(batch), self.criterions, self.config, self.steps
            )
        finally:
            self.model.train(was_training)
        out = {k: float(v) for k, v in stats.items()}
        out["loss"] = float(loss)
        return out

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
        if self.request_stop:
            raise SystemExit(143)  # deferred preemption stop, at a step boundary

    def _log_interval(self, interval: int, t0: float) -> None:
        dt = time.time() - t0
        msgs = [f"{k}={v / interval:.4f}" for k, v in sorted(self.total_train_loss.items())]
        lr = self.schedule(self.steps // self.accum)
        if self.device.type == "cuda":
            msgs.append(f"mem/peak_gb={torch.cuda.max_memory_allocated(self.device) / 2**30:.2f}")
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
        logging.info(
            f"(steps {self.steps}) eval "
            + " ".join(f"{k}={v / max(count, 1):.4f}" for k, v in sorted(totals.items()))
        )

    # -- checkpoint -------------------------------------------------------
    def save_checkpoint(self) -> str:
        if self.optimizer is None:
            raise RuntimeError("call init_state before save_checkpoint")
        state = {
            "model": self.model.state_dict(),
            "optimizer": {
                "state_dict": self.optimizer.state_dict(),
                "updates": self.updates,
                "mini_step": self.mini_step,
                "acc_grads": self.acc_grads,
            },
            "steps": self.steps,
            "epochs": self.epochs,
            "ema": None if self.ema is None else dict(zip(self.names, self.ema)),
        }
        path = save_checkpoint(self.outdir, self.steps, state)
        logging.info(f"saved checkpoint: {path}")
        return path

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
        self.model.load_state_dict(restored["model"])
        if self.ema is not None:
            ema = restored.get("ema") or dict(zip(self.names, self.params))
            with torch.no_grad():
                for e, name in zip(self.ema, self.names):
                    e.copy_(ema[name])
        if not load_only_params:
            opt = restored["optimizer"]
            self.optimizer.load_state_dict(opt["state_dict"])
            self.updates = int(opt["updates"])
            self.mini_step = int(opt["mini_step"])
            self.acc_grads = opt["acc_grads"]
            self.steps = int(restored["steps"])
            self.epochs = int(restored.get("epochs", 0))
        logging.info(f"loaded checkpoint from {path} (steps={self.steps})")
