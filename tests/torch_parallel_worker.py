"""One rank of a jatts_torch training mesh on the CPU, over gloo, for
tests/test_torch_parallel.py. Imports no jax.

    python tests/torch_parallel_worker.py --jobs jobs.pt --rank R --world W --port P

``jobs.pt`` (``torch.save``) holds a list of jobs, run in order; each job
builds its model from a class path, kwargs and a state_dict, trains it with
``jatts_torch.train.trainer.Trainer`` on a ``(n_data, n_model)`` mesh and
writes what the test compares under its ``outdir``:

- ``trajectory``: ``steps`` steps over ``batches``; rank 0 writes
  ``history.pt`` (every step's stats) and every rank takes part in the
  final ``save_checkpoint``;
- ``resume``: ``steps`` steps and a save; rank 0 alone then resumes that
  checkpoint in a one-process trainer, takes one step and saves; the mesh
  resumes that one and takes one more step and saves;
- ``stop``: rank ``stop_rank`` asks to stop after ``stop_after`` steps;
  every rank writes ``stopped.rank{R}.pt`` with its step count and exit code.

``draws`` (E2-TTS) replaces ``jatts_torch.models.e2tts.draw`` by the given
global arrays, as tests/test_torch_e2tts.py:inject_draws does; ``dropout``
sets every dropout rate.
"""

import argparse
import datetime
import importlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models import e2tts  # noqa: E402
from jatts_torch.modules.dropout import set_dropout_rate  # noqa: E402
from jatts_torch.parallel.mesh import get_mesh  # noqa: E402
from jatts_torch.train.steps import get_loss_fn  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402


class Loader:
    """The batches in order, every epoch; ``on_batch(i)`` runs before the
    i-th batch is handed out."""

    def __init__(self, batches, on_batch=None):
        self.batches = batches
        self.sampler = self
        self.on_batch = on_batch

    def set_epoch(self, e):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if self.on_batch is not None:
                self.on_batch(i)
            yield b


def build(job, mesh, outdir, batches=None, on_batch=None):
    mod, cls = job["model"].rsplit(".", 1)
    model = getattr(importlib.import_module(mod), cls)(**job["kwargs"], device="cpu")
    model.load_state_dict(job["state_dict"])
    if job.get("dropout") is not None:
        set_dropout_rate(model, job["dropout"])
    crits = {n: LOSS_REGISTRY[n]() for n in job.get("criterions", ())}
    return Trainer(job["config"], model, crits, get_loss_fn(job["config"]["trainer_type"]),
                   Loader(batches if batches is not None else job["batches"], on_batch),
                   outdir=outdir, seed=0, mesh=mesh)


def inject(draws):
    seen = {"uniform": 0, "normal": 0}

    def take(kind, shape, generator, device, low=0.0, high=1.0):
        want = draws[kind][seen[kind] % len(draws[kind])]
        seen[kind] += 1
        assert tuple(shape) == tuple(want.shape), (kind, shape, want.shape)
        return want.clone().to(device)

    e2tts.draw = take


def run_job(job, rank):
    n_data, n_model = job["mesh"]
    mesh = get_mesh(n_data, n_model)
    out = job["outdir"]
    if job.get("draws") is not None:
        inject(job["draws"])
    kind = job["kind"]
    if kind == "trajectory":
        tr = build(job, mesh, out)
        tr.init_state()
        tr.config["train_max_steps"] = job["steps"]
        tr.run()
        if rank == 0:
            torch.save(tr.history, os.path.join(out, "history.pt"))
        tr.save_checkpoint()
    elif kind == "resume":
        steps = job["steps"]
        tr = build(job, mesh, out)
        tr.init_state()
        tr.config["train_max_steps"] = steps
        tr.run()
        first = tr.save_checkpoint()
        if rank == 0:  # one rank resumes the mesh's checkpoint
            one = build(job, None, os.path.join(out, "one"))
            one.init_state()
            one.load_checkpoint(first)
            one.train_step(job["batches"][steps % len(job["batches"])])
            torch.save(one.history, os.path.join(out, "one", "history.pt"))
            one.save_checkpoint()
        dist.barrier()
        back = build(job, mesh, os.path.join(out, "back"))
        back.init_state()
        back.load_checkpoint(os.path.join(out, "one", f"checkpoint-{steps + 1}steps"))
        back.train_step(job["batches"][(steps + 1) % len(job["batches"])])
        if rank == 0:
            torch.save(back.history, os.path.join(out, "back", "history.pt"))
        back.save_checkpoint()
    elif kind == "stop":
        holder = {}

        def on_batch(i):
            if rank == job["stop_rank"] and i == job["stop_after"]:
                holder["tr"].request_stop = True

        tr = build(job, mesh, out, on_batch=on_batch)
        holder["tr"] = tr
        tr.init_state()
        tr.config["train_max_steps"] = job["steps"]
        code = 0
        try:
            tr.run()
        except SystemExit as e:
            code = e.code
        torch.save({"steps": tr.steps, "code": code}, os.path.join(out, f"stopped.rank{rank}.pt"))
    else:
        raise ValueError(kind)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args.port}", rank=args.rank,
                            world_size=args.world, timeout=datetime.timedelta(seconds=45))
    try:
        for job in torch.load(args.jobs, weights_only=False):
            os.makedirs(job["outdir"], exist_ok=True)
            run_job(job, args.rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
