"""Per-speaker f0 search range from the corpus (counterpart of
egs/jvs/tts1/local/prepare_f0_range.py): for each speaker of ``--csv`` the
NCCF f0 (``ops/pitch.py:estimate_f0``, 40-800 Hz) of its first
``--n-per-spk`` wavs, on ``--device`` (default: the CUDA card), and
``f0min = max(0.8 · p1, 40)``, ``f0max = min(1.2 · p99, 800)`` of the voiced
frames, written as yaml:

    python -m jatts_torch.egs.jvs.tts1.local.prepare_f0_range --csv data/train.csv --out conf/f0.yaml
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

from jatts_torch.device import resolve_device
from jatts_torch.ops.pitch import estimate_f0
from jatts_torch.utils.io import read_audio, read_csv


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", required=True)
    parser.add_argument("--out", default="conf/f0.yaml")
    parser.add_argument("--sampling-rate", type=int, default=24000)
    parser.add_argument("--hop-size", type=int, default=300)
    parser.add_argument("--n-per-spk", type=int, default=20)
    parser.add_argument("--device", default=None, help="torch device (default: cuda; an error without a card)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    rows, _ = read_csv(args.csv, dict_reader=True)
    per_spk = defaultdict(list)
    for row in rows:
        per_spk[row["spk"]].append(row)

    ranges = {}
    for spk, spk_rows in sorted(per_spk.items()):
        f0s = []
        for row in spk_rows[: args.n_per_spk]:
            wav, _ = read_audio(row["wav_path"], args.sampling_rate)
            f0 = estimate_f0(torch.from_numpy(wav).to(dev), args.sampling_rate, args.hop_size,
                             f0min=40.0, f0max=800.0).cpu().numpy()
            f0s.append(f0[f0 > 0])
        f0s = np.concatenate(f0s) if f0s else np.zeros(1)
        if f0s.size == 0:  # every frame unvoiced: the full range
            f0s = np.zeros(1)
        ranges[spk] = {
            "f0min": int(max(np.percentile(f0s, 1) * 0.8, 40)),
            "f0max": int(min(np.percentile(f0s, 99) * 1.2, 800)),
        }
        print(spk, ranges[spk])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    import yaml

    with open(args.out, "w") as f:
        yaml.dump(ranges, f)
    return ranges


if __name__ == "__main__":
    main()
