"""F0 histograms per speaker, to pick f0min/f0max (counterpart of
jatts_tpu/bin/create_histogram.py; reference jatts/bin/create_histogram.py:20-152).

    python -m jatts_torch.bin.create_histogram --csv data/train.csv --outdir exp/f0_hist

The f0 track is the port's NCCF estimator (``ops/pitch.py:estimate_f0``,
f0 40-800 Hz) on the CUDA card unless ``--device cpu`` is given. Each
speaker gets ``<spk>_f0_histogram.png`` (100 bins over 0-800 Hz, drawn
without matplotlib by ``utils/plot.py``) and a printed line of its 1st and
99th percentiles of voiced f0.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import os
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from jatts_torch.utils.io import read_audio, read_csv


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Write the histograms; returns each speaker's voiced f0 values."""
    parser = argparse.ArgumentParser(description="Create f0 histograms.")
    parser.add_argument("--csv", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--sampling-rate", type=int, default=24000)
    parser.add_argument("--hop-size", type=int, default=300)
    parser.add_argument("--n-per-spk", type=int, default=50)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; an error without a card)")
    args = parser.parse_args(argv)

    import torch

    from jatts_torch.device import resolve_device
    from jatts_torch.ops.pitch import estimate_f0
    from jatts_torch.utils.plot import plot_histogram

    dev = resolve_device(args.device)
    rows, _ = read_csv(args.csv, dict_reader=True)
    per_spk = defaultdict(list)
    for row in rows:
        per_spk[row.get("spk", "all")].append(row)

    os.makedirs(args.outdir, exist_ok=True)
    voiced = {}
    for spk, spk_rows in per_spk.items():
        f0s = []
        for row in spk_rows[: args.n_per_spk]:
            wav, _ = read_audio(row["wav_path"], args.sampling_rate)
            with torch.no_grad():
                f0 = estimate_f0(torch.from_numpy(wav).to(dev), args.sampling_rate, args.hop_size,
                                 f0min=40.0, f0max=800.0).cpu().numpy()
            f0s.append(f0[f0 > 0])
        f0s = np.concatenate(f0s) if f0s else np.zeros(0)
        voiced[spk] = f0s
        plot_histogram(f0s, os.path.join(args.outdir, f"{spk}_f0_histogram.png"), bins=100, value_range=(0, 800),
                       title=f"{spk} f0 histogram (n={len(f0s)})")
        if len(f0s):
            print(f"{spk}: p01={np.percentile(f0s, 1):.0f} p99={np.percentile(f0s, 99):.0f}")
    return voiced


if __name__ == "__main__":
    main()
