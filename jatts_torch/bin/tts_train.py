"""Train a TTS model, tts1/tts3 stage 3 (counterpart of jatts_tpu/bin/tts_train.py).

Builds the datasets, batcher, model, losses and optimizer from the recipe's
yaml, overlays the CLI's arguments, writes ``outdir/config.yml`` and trains
on one GPU, or on several with ``--multihost``, writing
``checkpoint-{N}steps`` directories as the JAX CLI does:

    python -m jatts_torch.bin.tts_train --train-csv dump/train.csv \\
        --dev-csv dump/dev.csv --stats dump/stats.npz --token-list data/tokens.txt \\
        --config egs/jsut/tts1/conf/fastspeech2.v1.yaml --outdir exp/fastspeech2 \\
        --attn-backend flash

It runs on the CUDA card unless ``--device cpu`` is given. ``--attn-backend``
overrides ``model_params.attn_backend`` (``flash``: the hand-written
attention kernels forward and backward). Feature dumps and the stats file
may be ``.h5`` (needs h5py) or ``.npz`` with the same keys. The models are
FastSpeech2 (multi-speaker too: with ``spkemb`` in ``feat_list`` and
``spk_embed_dim`` in ``model_params``, as egs/jvs/tts1/conf/fastspeech2.v1.yaml
has them, each batch carries its ``spembs``; ``conformer_rel_pos_type:
latest`` with ``flash`` trains through K1r), Matcha-TTS (``MatchaTTS`` on
the csv's durations, tts1, and ``MatchaTTS_MAS``, tts2, which searches its
own with the fused MAS kernel; mel-only ``feat_list``; no ``attn_backend``),
mel-VITS (``VITS``, tts2, e.g. ``--config egs/jsut/tts2/conf/vits.v1.bs32.yaml``:
the fused MAS search on every micro-step; mel-only; no ``attn_backend``)
the VALL-E AR (``VALLEAR``, tts3 stage 3, e.g.
``--config egs/hificaptain_jp_female/tts3/conf/valle_ar.given.bs32.yaml``)
and NAR (``VALLENAR``, tts3 stage 4, e.g.
``--config egs/hificaptain_jp_female/tts3/conf/valle_nar.given.bs32.yaml``:
``attn_backend: flash`` trains through the non-causal tensor-core kernels)
and E2-TTS (``E2TTS``, tts2, e.g.
``--config egs/hificaptain_jp_female/tts2/conf/e2tts.v1.yaml``: mel-only;
``attn_backend: flash`` runs its bf16 attention forward and backward on the
tensor cores); ``batch_size_per_gpu`` selects frame-budget batching
(``DynamicBatchSampler``, capped at ``max_samples`` utterances, shuffled
from ``sampler_random_seed``); ``model_params.dtype`` (yaml ``dtype: bfloat16``) is
the model's compute dtype, as the JAX CLI reads it: every family computes
in it and its parameters stay float32.

Several GPUs: one process a device, launched by torchrun, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; ``--multihost`` asks for the process group:

    torchrun --nproc_per_node 4 -m jatts_torch.bin.tts_train --multihost \
        --config egs/hificaptain_jp_female/tts3/conf/valle_ar.given.bs128.4chips.yaml ...

``--dist-backend`` names the backend (``nccl`` by default on the card,
``gloo`` on the CPU; nothing falls back from one to the other). The
world is a ``(data, model)`` mesh (``parallel/mesh.py``): the yaml's
``mesh: {model: M}`` shards the large parameters over M ranks (tensor
parallelism) and ``sequence_parallel: true`` cuts E2-TTS's frames over
them; the data axis takes the rest. Every rank reads the same csv with the
same sampler seed and takes its part of each global batch, so
``batch_size``/``batch_size_per_gpu`` keep their JAX meaning (the global
batch; for ``batch_size_per_gpu`` the global frame budget).
``n_data_devices`` is accepted and read nowhere, as in the JAX CLI.
Without ``--multihost`` a ``mesh`` with ``model: 1`` is ignored and a
larger one raises.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import logging
import os
import signal
from typing import Any, Dict, Optional, Sequence

import torch

from jatts_torch.data.batcher import COLLATER_REGISTRY, BatchSampler, DataLoader, DynamicBatchSampler
from jatts_torch.data.dataset import TTSDataset
from jatts_torch.device import resolve_device
from jatts_torch.losses.basic import LOSS_REGISTRY
from jatts_torch.models.e2tts import E2TTS
from jatts_torch.models.fastspeech2 import FastSpeech2
from jatts_torch.models.matchatts import MatchaTTS
from jatts_torch.models.matchatts_mas import MatchaTTS_MAS
from jatts_torch.models.valle import VALLEAR, VALLENAR
from jatts_torch.models.vits import VITS
from jatts_torch.parallel.mesh import get_mesh, init_distributed, local_device
from jatts_torch.train.intermediate import make_mel_eval_hook
from jatts_torch.train.steps import get_loss_fn
from jatts_torch.train.trainer import Trainer
from jatts_torch.utils.config import dump_config, load_config

MODELS = {
    "FastSpeech2": FastSpeech2, "MatchaTTS": MatchaTTS, "MatchaTTS_MAS": MatchaTTS_MAS, "VITS": VITS,
    "VALLEAR": VALLEAR, "VALLENAR": VALLENAR, "E2TTS": E2TTS,
}
NOT_PORTED = ()  # every model type of the JAX package is ported
# as in the JAX package: their attention never takes the kernel
EAGER_ATTENTION = ("MatchaTTS", "MatchaTTS_MAS", "VITS")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_criterions(config: Dict[str, Any]) -> Dict[str, Any]:
    crits = {}
    for name, params in (config.get("criterions") or {}).items():
        params = dict(params or {})
        _type = params.pop("_type", None)
        if name == "MelLoss" and _type:
            crits[name] = LOSS_REGISTRY["MelLoss"](_type=_type, params=params)
        else:
            crits[name] = LOSS_REGISTRY[name](**params)
    return crits


def run(
    train_csv: str,
    dev_csv: str,
    stats: str,
    token_list: str,
    config: Dict[str, Any],
    outdir: str,
    resume: Optional[str] = None,
    pretrain: Optional[str] = None,
    seed: int = 0,
    device: Optional[str] = None,
    attn_backend: Optional[str] = None,
    multihost: bool = False,
    dist_backend: Optional[str] = None,
) -> Trainer:
    """Train per ``config`` (the recipe's yaml as a dict) and return the
    trainer. ``resume`` "" resumes from the latest checkpoint under
    ``outdir``, a path from that checkpoint; ``pretrain`` loads weights only.
    A final checkpoint is written however the run ends. ``multihost`` joins
    (or uses) the process group of torchrun's environment over
    ``dist_backend`` (default ``nccl`` on the card, ``gloo`` on the CPU)
    and trains over the mesh of ``config["mesh"]``; a group this call
    made is destroyed at its end."""
    dev = resolve_device(device)
    config = dict(config)
    config.update(
        train_csv=train_csv, dev_csv=dev_csv, stats=stats, token_list=token_list,
        outdir=outdir, resume=resume, pretrain=pretrain, seed=seed,
    )
    model_type = config.get("model_type", "FastSpeech2")
    if model_type not in MODELS:
        raise ValueError(f"unknown model_type {model_type!r} (the port trains {', '.join(MODELS)})")
    mesh_cfg = config.get("mesh") or {}
    n_model = int(mesh_cfg.get("model", 1))
    if not multihost and (n_model > 1 or mesh_cfg.get("sequence_parallel")):
        raise ValueError(f"mesh {mesh_cfg} needs {n_model} or more ranks: launch with torchrun and --multihost")
    owns_group = False
    if multihost:
        owns_group = not torch.distributed.is_initialized()
        init_distributed(dist_backend or ("nccl" if dev.type == "cuda" else "gloo"))
        dev = local_device(dev.type)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    is_main = not multihost or torch.distributed.get_rank() == 0

    with open(token_list, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    model_params = dict(config.get("model_params") or {})
    model_params["idim"] = n_vocab
    if attn_backend is not None:
        if model_type in EAGER_ATTENTION:
            raise ValueError(f"{model_type} has no attn_backend: its attention runs eager")
        model_params["attn_backend"] = attn_backend
    config["model_params"] = dict(model_params)
    dtype = DTYPES[model_params.pop("dtype", "float32")]

    os.makedirs(outdir, exist_ok=True)
    if is_main:
        dump_config(config, os.path.join(outdir, "config.yml"))

    ds_kwargs = dict(
        stats_path=stats,
        feat_list=config.get("feat_list", ["mel"]),
        token_list_path=token_list,
        hop_size=config.get("hop_size", 300),
        sampling_rate=config.get("sampling_rate", 24000),
        allow_cache=config.get("allow_cache", False),
        prompt_strategy=config.get("prompt_strategy"),
    )
    train_set = TTSDataset(train_csv, **ds_kwargs)
    dev_set = TTSDataset(dev_csv, **ds_kwargs)
    lengths = [train_set.get_frame_len(i) for i in range(len(train_set))]
    if config.get("batch_size_per_gpu"):  # frame-budget batching (E2-TTS)
        sampler = DynamicBatchSampler(
            lengths, int(config["batch_size_per_gpu"]), max_samples=int(config.get("max_samples", 0)),
            seed=config.get("sampler_random_seed", seed),
        )
    else:
        sampler = BatchSampler(lengths, int(config.get("batch_size", 16)), seed=seed)
    collater_kwargs = {"out_feat_type": config.get("out_feat_type", "mel")}
    collater_kwargs.update(config.get("collater_params") or {})
    if (
        config.get("collater_type") == "VALLECollater"
        and "prompt_max_frame_length" not in collater_kwargs
        and "prompt_max_frame_length" in model_params
    ):
        # one yaml key rules the model's and the collater's prompt crop
        collater_kwargs["prompt_max_frame_length"] = int(model_params["prompt_max_frame_length"])
    collater = COLLATER_REGISTRY[config.get("collater_type", "FastSpeech2Collater")](**collater_kwargs)
    k_exec = int(config.get("steps_per_execution", 1) or 1)
    train_loader = DataLoader(
        train_set, sampler, collater,
        prefetch=int(config.get("num_prefetch_batches", max(2, k_exec))),
    )
    dev_lengths = [dev_set.get_frame_len(i) for i in range(len(dev_set))]
    dev_loader = DataLoader(
        dev_set, BatchSampler(dev_lengths, int(config.get("batch_size", 16)), shuffle=False),
        collater,
    )

    torch.manual_seed(seed)  # the model's initial draws
    model = MODELS[model_type](**model_params, device=dev, dtype=dtype)
    eval_hook = None
    if model_type in ("FastSpeech2", "MatchaTTS", "MatchaTTS_MAS", "VITS"):
        n_save = int(config.get("num_save_intermediate_results", 4))
        eval_hook = make_mel_eval_hook(
            [dev_set[i] for i in range(min(n_save, len(dev_set)))], num_save=n_save,
            max_frames=int(config.get("eval_max_frames", 1024)),
        )
    mesh = get_mesh(n_model=n_model, device_type=dev.type) if multihost else None
    if mesh is not None:
        logging.info(f"mesh: data={mesh.n_data} model={mesh.n_model}")
    trainer = Trainer(
        config, model, build_criterions(config), get_loss_fn(config["trainer_type"]),
        train_loader, dev_loader, outdir=outdir, seed=seed, eval_hook=eval_hook, mesh=mesh,
    )
    trainer.init_state()
    if pretrain:
        trainer.load_checkpoint(pretrain, load_only_params=True)
    if resume is not None:
        trainer.load_checkpoint(resume or None)

    # preemption: the first SIGTERM asks for a stop at the next step
    # boundary, a second one exits at once; the final save runs either way
    sig_count = [0]

    def on_term(signum, frame):
        sig_count[0] += 1
        trainer.request_stop = True
        if sig_count[0] > 1:
            raise SystemExit(128 + signum)

    prev_term = signal.signal(signal.SIGTERM, on_term)
    try:
        trainer.run()
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        try:
            trainer.save_checkpoint()
            logging.info(f"saved final checkpoint at {trainer.steps} steps")
        except Exception as e:  # noqa: BLE001 - must not mask the original exception
            logging.error(f"final checkpoint save failed: {e}")
        if owns_group:
            torch.distributed.destroy_process_group()
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    parser = argparse.ArgumentParser(description="Train a TTS model (stage 3).")
    parser.add_argument("--train-csv", required=True)
    parser.add_argument("--dev-csv", required=True)
    parser.add_argument("--stats", required=True)
    parser.add_argument("--token-list", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--resume", default=None, nargs="?", const="")
    parser.add_argument("--pretrain", default=None, help="params-only init checkpoint")
    parser.add_argument("--multihost", action="store_true",
                        help="train over the process group of torchrun's environment")
    parser.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                        help="the process group's backend (default: nccl on the card, gloo on the CPU)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; an error without a card)")
    parser.add_argument("--attn-backend", default=None, choices=("xla", "flash", "auto"),
                        help="override model_params.attn_backend")
    args = parser.parse_args(argv)

    rank0 = int(os.environ.get("RANK", 0)) == 0 if args.multihost else True
    logging.basicConfig(
        force=True,
        level=logging.INFO if args.verbose > 0 and rank0 else logging.WARNING,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    config = load_config(args.config)
    config["verbose"] = args.verbose
    return run(
        args.train_csv, args.dev_csv, args.stats, args.token_list, config, args.outdir,
        resume=args.resume, pretrain=args.pretrain, seed=args.seed, device=args.device,
        attn_backend=args.attn_backend, multihost=args.multihost, dist_backend=args.dist_backend,
    )


if __name__ == "__main__":
    main()
