"""Build tokens.txt from the phoneme column, tts1 stage 2 (counterpart of
jatts_tpu/bin/generate_token_list.py): ``<blank>``, ``<unk>``, the
space-split tokens seen more than ``--cutoff`` times (sorted), ``<sos/eos>``.

    python -m jatts_torch.bin.generate_token_list --csv data/train.csv --out data/tokens.txt
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
from collections import Counter
from typing import List, Optional, Sequence

from jatts_torch.utils.io import read_csv


def run(csvs: Sequence[str], out: str, column: str = "phonemes", cutoff: int = 0) -> List[str]:
    """Write the token list of ``csvs`` to ``out`` and return it."""
    counter: Counter = Counter()
    for path in csvs:
        rows, _ = read_csv(path, dict_reader=True)
        for row in rows:
            counter.update(row[column].split(" "))
    vocab = [t for t, c in counter.most_common() if c > cutoff and t]
    tokens = ["<blank>", "<unk>", *sorted(vocab), "<sos/eos>"]
    with open(out, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    print(f"wrote {len(tokens)} tokens to {out}")
    return tokens


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Generate token list (stage 2).")
    parser.add_argument("--csv", nargs="+", required=True)
    parser.add_argument("--out", required=True, help="output tokens.txt")
    parser.add_argument("--column", default="phonemes")
    parser.add_argument("--cutoff", type=int, default=0)
    args = parser.parse_args(argv)
    run(args.csv, args.out, column=args.column, cutoff=args.cutoff)


if __name__ == "__main__":
    main()
