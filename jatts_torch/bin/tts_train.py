"""Train a TTS model, tts1 stage 3 (counterpart of jatts_tpu/bin/tts_train.py).

Builds the datasets, batcher, model, losses and optimizer from the recipe's
yaml, overlays the CLI's arguments, writes ``outdir/config.yml`` and trains
on one GPU, writing ``checkpoint-{N}steps`` directories as the JAX CLI does:

    python -m jatts_torch.bin.tts_train --train-csv dump/train.csv \\
        --dev-csv dump/dev.csv --stats dump/stats.npz --token-list data/tokens.txt \\
        --config egs/jsut/tts1/conf/fastspeech2.v1.yaml --outdir exp/fastspeech2 \\
        --attn-backend flash

It runs on the CUDA card unless ``--device cpu`` is given. ``--attn-backend``
overrides ``model_params.attn_backend`` (``flash``: the hand-written
attention kernels forward and backward). Feature dumps and the stats file
may be ``.h5`` (needs h5py) or ``.npz`` with the same keys. FastSpeech2 is
the one model ported so far; ``--multihost`` is not ported.
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

from jatts_torch.data.batcher import COLLATER_REGISTRY, BatchSampler, DataLoader
from jatts_torch.data.dataset import TTSDataset
from jatts_torch.device import resolve_device
from jatts_torch.losses.basic import LOSS_REGISTRY
from jatts_torch.models.fastspeech2 import FastSpeech2
from jatts_torch.train.steps import get_loss_fn
from jatts_torch.train.trainer import Trainer
from jatts_torch.utils.config import dump_config, load_config

MODELS = {"FastSpeech2": FastSpeech2}
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
) -> Trainer:
    """Train per ``config`` (the recipe's yaml as a dict) and return the
    trainer. ``resume`` "" resumes from the latest checkpoint under
    ``outdir``, a path from that checkpoint; ``pretrain`` loads weights only.
    A final checkpoint is written however the run ends."""
    dev = resolve_device(device)
    config = dict(config)
    config.update(
        train_csv=train_csv, dev_csv=dev_csv, stats=stats, token_list=token_list,
        outdir=outdir, resume=resume, pretrain=pretrain, seed=seed,
    )
    model_type = config.get("model_type", "FastSpeech2")
    if model_type not in MODELS:
        raise ValueError(f"model_type {model_type!r} is not ported yet")
    if config.get("batch_size_per_gpu"):
        raise ValueError("frame-budget batching (batch_size_per_gpu) is not ported yet")

    with open(token_list, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    model_params = dict(config.get("model_params") or {})
    model_params["idim"] = n_vocab
    if attn_backend is not None:
        model_params["attn_backend"] = attn_backend
    config["model_params"] = dict(model_params)
    dtype = DTYPES[model_params.pop("dtype", "float32")]

    os.makedirs(outdir, exist_ok=True)
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
    sampler = BatchSampler(lengths, int(config.get("batch_size", 16)), seed=seed)
    collater_kwargs = {"out_feat_type": config.get("out_feat_type", "mel")}
    collater_kwargs.update(config.get("collater_params") or {})
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

    model = MODELS[model_type](**model_params, device=dev, dtype=dtype)
    trainer = Trainer(
        config, model, build_criterions(config), get_loss_fn(config["trainer_type"]),
        train_loader, dev_loader, outdir=outdir, seed=seed,
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
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Train a TTS model (stage 3).")
    parser.add_argument("--train-csv", required=True)
    parser.add_argument("--dev-csv", required=True)
    parser.add_argument("--stats", required=True)
    parser.add_argument("--token-list", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--resume", default=None, nargs="?", const="")
    parser.add_argument("--pretrain", default=None, help="params-only init checkpoint")
    parser.add_argument("--multihost", action="store_true", help="not ported: raises")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; an error without a card)")
    parser.add_argument("--attn-backend", default=None, choices=("xla", "flash", "auto"),
                        help="override model_params.attn_backend")
    args = parser.parse_args(argv)

    logging.basicConfig(
        force=True,
        level=logging.INFO if args.verbose > 0 else logging.WARNING,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    if args.multihost:
        raise SystemExit("--multihost is not ported: the port trains on one GPU")
    config = load_config(args.config)
    config["verbose"] = args.verbose
    run(
        args.train_csv, args.dev_csv, args.stats, args.token_list, config, args.outdir,
        resume=args.resume, pretrain=args.pretrain, seed=args.seed, device=args.device,
        attn_backend=args.attn_backend,
    )


if __name__ == "__main__":
    main()
