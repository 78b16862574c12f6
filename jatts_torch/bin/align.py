"""Stage-0 native forced alignment: fill csv ``durations`` (+ start/end crop)
with no external aligner (counterpart of jatts_tpu/bin/align.py).

Trains the in-framework aligner (jatts_torch/aligner.py: AlignmentModule +
ForwardSum CTC + the batched MAS Viterbi kernels) on the corpus's
(phoneme, mel) pairs and rewrites each csv with per-token frame durations
whose sum matches the mel frame count the stage-1 preprocessing asserts.

Usage (tts1 stage 0, after data preparation when no label directory is given):

    python -m jatts_torch.bin.align --csv data/train.csv data/dev.csv data/test.csv \\
        --config conf/fastspeech2.v1.yaml --outdir exp/aligner

It runs on the CUDA card unless ``--device cpu`` is given. Forced alignment
is transductive: every csv (train+dev+test) is used for training AND gets
durations.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import json
import logging
import os
from typing import Optional, Sequence

import torch

from jatts_torch.aligner import (
    Aligner,
    build_vocab,
    dump_durations,
    make_batches,
    normalize_mels,
    prepare_item,
    row_updates_from_durations,
    train_aligner,
)
from jatts_torch.device import resolve_device
from jatts_torch.features.extractors import LogMelExtractor
from jatts_torch.utils.io import read_audio, read_csv, write_csv


def run(
    csv_paths: Sequence[str],
    config: dict,
    outdir: str,
    steps: int = 2000,
    batch_size: int = 16,
    adim: int = 256,
    elayers: int = 2,
    lr: float = 1e-3,
    seed: int = 0,
    out_suffix: str = "",
    device: Optional[str] = None,
) -> dict:
    """Align every row of ``csv_paths`` with the mel/STFT settings of
    ``config`` (the recipe's yaml as a dict) and rewrite the csvs.

    Returns what a caller may want to look at afterwards: the trained
    ``model``, the ``items`` and padded ``batches``, the per-item
    ``durations`` (with edge silence), the training ``history``, the
    ``vocab`` and the number of rows skipped."""
    device = resolve_device(device)
    sr = int(config["sampling_rate"])
    hop = int(config["hop_size"])
    mel_ex = LogMelExtractor(
        sampling_rate=sr,
        fft_size=config["fft_size"],
        hop_size=hop,
        win_length=config.get("win_length"),
        num_mels=config["num_mels"],
        fmin=config.get("fmin"),
        fmax=config.get("fmax"),
        device=device,
    )

    csvs = []
    for path in csv_paths:
        rows, fieldnames = read_csv(path, dict_reader=True)
        csvs.append({"path": path, "rows": rows, "fieldnames": fieldnames})
    vocab = build_vocab([c["rows"] for c in csvs])
    logging.info("vocab: %d tokens (+<sil>)", len(vocab) - 1)

    # ---- corpus -> work items (mel computed once, shared by train + dump)
    items, owners = [], []
    n_skipped = 0
    for ci, c in enumerate(csvs):
        for ri, row in enumerate(c["rows"]):
            wav, _ = read_audio(
                row["wav_path"], sr, row.get("start") or None, row.get("end") or None,
            )
            it = prepare_item(row, mel_ex(wav), vocab, len(wav), hop)
            if it is None:
                n_skipped += 1
                logging.warning("skipping %s (no phonemes or too short)", row.get("sample_id"))
                continue
            items.append(it)
            owners.append((ci, ri))
    if not items:
        raise SystemExit("no alignable rows found")
    logging.info("prepared %d items (%d skipped)", len(items), n_skipped)
    normalize_mels(items)
    batches = make_batches(items, batch_size)
    logging.info("%d padded batches (%d shapes)", len(batches),
                 len({(b["xs"].shape[1], b["ys"].shape[1]) for b in batches}))

    # ---- train (transductive: on the very rows being aligned)
    model = Aligner(
        idim=len(vocab), odim=int(config["num_mels"]), adim=adim, elayers=elayers,
        seed=seed, device=device,
    )
    history = train_aligner(model, batches, steps=steps, lr=lr, seed=seed)

    os.makedirs(outdir, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(outdir, "aligner.pt"))
    with open(os.path.join(outdir, "aligner.json"), "w") as f:
        json.dump({"vocab": vocab, "adim": adim, "elayers": elayers,
                   "num_mels": int(config["num_mels"])}, f)

    # ---- Viterbi dump -> csv updates
    durations = dump_durations(model, batches, items)
    for it, ds, (ci, ri) in zip(items, durations, owners):
        csvs[ci]["rows"][ri].update(row_updates_from_durations(it, ds, hop, sr))

    for c in csvs:
        fieldnames = list(c["fieldnames"])
        for col in ("start", "end", "durations"):
            if col not in fieldnames:
                fieldnames.append(col)
        out = c["path"] + out_suffix
        write_csv(c["rows"], out, fieldnames=fieldnames)
        logging.info("wrote %s", out)
    return {"model": model, "items": items, "batches": batches, "durations": durations,
            "history": history, "vocab": vocab, "n_skipped": n_skipped}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Native forced alignment (stage 0, no external aligner)."
    )
    parser.add_argument("--csv", nargs="+", required=True,
                        help="csvs to align (train+dev+test; rewritten)")
    parser.add_argument("--config", required=True,
                        help="recipe yaml (for the mel/STFT settings)")
    parser.add_argument("--outdir", required=True,
                        help="aligner checkpoint/log directory")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--adim", type=int, default=256)
    parser.add_argument("--elayers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out-suffix", default="",
                        help="write <csv><suffix> instead of in-place")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; an error without a card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        force=True,
        level=logging.INFO if args.verbose > 0 else logging.WARNING,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    import yaml

    with open(args.config) as f:
        config = yaml.load(f, Loader=yaml.SafeLoader)
    run(
        args.csv, config, args.outdir, steps=args.steps, batch_size=args.batch_size,
        adim=args.adim, elayers=args.elayers, lr=args.lr, seed=args.seed,
        out_suffix=args.out_suffix, device=args.device,
    )


if __name__ == "__main__":
    main()
