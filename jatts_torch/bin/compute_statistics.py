"""Per-feature mean and scale over the training set, tts1 stage 1b
(counterpart of jatts_tpu/bin/compute_statistics.py):

    python -m jatts_torch.bin.compute_statistics --csv dump/train.csv \\
        --config conf/fastspeech2.v1.yaml --out dump/stats.npz

Streams float64 sums over every row's dump (``.h5`` or ``.npz``, read by
suffix); a 1-d feature counts as one column. ``--out`` ending in ``.npz``
writes one numpy archive, any other suffix an HDF5 file (needs h5py), with
the keys ``<feat>_mean`` and ``<feat>_scale``. Codec codes are skipped.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import logging
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from jatts_torch.utils.config import load_config
from jatts_torch.utils.io import read_array, read_csv, write_hdf5


def run(csv: str, config: Dict[str, Any], out: str) -> Dict[str, np.ndarray]:
    """Write the stats of ``csv``'s dumps to ``out`` and return them."""
    feat_list = [f for f in config.get("feat_list", ["mel"]) if not f.startswith("encodec")]
    rows, _ = read_csv(csv, dict_reader=True)
    sums: Dict[str, Any] = {f: None for f in feat_list}
    sqs: Dict[str, Any] = {f: None for f in feat_list}
    counts = {f: 0 for f in feat_list}
    for row in rows:
        for feat in feat_list:
            x = np.asarray(read_array(row["feat_path"], feat), dtype=np.float64)
            if x.ndim == 1:
                x = x[:, None]
            if sums[feat] is None:
                sums[feat] = x.sum(0)
                sqs[feat] = (x**2).sum(0)
            else:
                sums[feat] += x.sum(0)
                sqs[feat] += (x**2).sum(0)
            counts[feat] += len(x)
    stats: Dict[str, np.ndarray] = {}
    for feat in feat_list:
        mean = sums[feat] / counts[feat]
        var = sqs[feat] / counts[feat] - mean**2
        stats[f"{feat}_mean"] = mean.astype(np.float32)
        stats[f"{feat}_scale"] = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        logging.info(f"{feat}: n={counts[feat]} mean[0]={mean.flat[0]:.4f}")
    if out.endswith(".npz"):
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez(out, **stats)
    else:
        for key, value in stats.items():
            write_hdf5(out, key, value)
    return stats


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Compute statistics (stage 1).")
    parser.add_argument("--csv", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--out", required=True, help="output stats.h5 or stats.npz")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(force=True, level=logging.INFO if args.verbose > 0 else logging.WARNING)
    run(args.csv, load_config(args.config), args.out)


if __name__ == "__main__":
    main()
