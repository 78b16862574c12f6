"""VALL-E data preparation (counterpart of
egs/hificaptain_jp_female/tts3/local/data_prep.py): csv rows with G2P
phonemes from ``--transcript`` (``utt:text`` lines; the wavs found anywhere
under ``--db-root``), the first ``--n-test`` rows the test split, the next
``--n-dev`` the dev split, and every row given a training utterance drawn
by ``random.Random(--seed)`` as its speaker prompt (``prompt_wav_path``,
``prompt_phonemes``: the "given" strategy):

    python -m jatts_torch.egs.hificaptain_jp_female.tts3.local.data_prep \\
        --db-root downloads/hi-fi-captain/ja-JP/female --transcript transcript.txt --outdir data
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Optional, Sequence

from jatts_torch.egs.prep import write_splits
from jatts_torch.text import g2p_phonemes
from jatts_torch.utils.io import find_files


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--db-root", required=True)
    parser.add_argument("--transcript", required=True, help="utt:text lines")
    parser.add_argument("--outdir", default="data")
    parser.add_argument("--n-dev", type=int, default=100)
    parser.add_argument("--n-test", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    wavs = {os.path.splitext(os.path.basename(p))[0]: p for p in find_files(args.db_root, "*.wav")}
    rows = []
    with open(args.transcript, encoding="utf-8") as f:
        for line in f:
            if ":" not in line:
                continue
            utt, text = line.strip().split(":", 1)
            if utt not in wavs:
                continue
            rows.append({
                "sample_id": utt,
                "spk": "hfc_female",
                "wav_path": wavs[utt],
                "start": "",
                "end": "",
                "original_text": text,
                "phonemes": " ".join(g2p_phonemes(text)),
            })

    rng = random.Random(args.seed)
    test = rows[: args.n_test]
    dev = rows[args.n_test : args.n_test + args.n_dev]
    train = rows[args.n_test + args.n_dev :]
    for subset in (train, dev, test):
        for r in subset:
            p = rng.choice(train)
            r["prompt_wav_path"] = p["wav_path"]
            r["prompt_phonemes"] = p["phonemes"]
    write_splits(args.outdir, train, dev, test)


if __name__ == "__main__":
    main()
