"""Hi-Fi-Captain (ja, female) tts1 data preparation (counterpart of
egs/hificaptain_jp_female/tts1/local/data_prep.py): ``train_parallel`` and
``train_non_parallel`` make the train split, ``dev`` the dev split, ``eval``
the test split, with G2P phonemes; Julius ``.lab`` files under ``--labdir``
give phonemes, durations and the crop (``text/julius.py``):

    python -m jatts_torch.egs.hificaptain_jp_female.tts1.local.data_prep \\
        --db-root downloads/hi-fi-captain/ja-JP/female --outdir data --hop-size 512 --fs 48000
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

from jatts_torch.egs.prep import julius_updates, write_splits
from jatts_torch.text import g2p_phonemes

SETS = ["train_parallel", "train_non_parallel", "dev", "eval"]


def read_texts(db_root: str) -> Dict[str, Dict[str, str]]:
    """Each set's ``text/<set>.txt`` as ``{sample_id: text}``."""
    texts = {}
    for _set in SETS:
        with open(os.path.join(db_root, "text", f"{_set}.txt"), encoding="utf-8") as f:
            lines = f.read().splitlines()
        texts[_set] = {ln.split(" ")[0]: ln.split(" ", 1)[1] for ln in lines if ln}
    return texts


def split_of(_set: str) -> str:
    return "train" if _set.startswith("train") else ("dev" if _set == "dev" else "test")


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--db-root", required=True)
    parser.add_argument("--outdir", default="data")
    parser.add_argument("--labdir", default=None, help="julius .lab dir")
    parser.add_argument("--hop-size", type=int, default=512)
    parser.add_argument("--fs", type=int, default=48000)
    args = parser.parse_args(argv)

    texts = read_texts(args.db_root)
    splits = {"train": [], "dev": [], "test": []}
    for _set in SETS:
        for sample_id, text in texts[_set].items():
            wav_path = os.path.join(args.db_root, "wav", _set, sample_id + ".wav")
            if not os.path.exists(wav_path):
                continue
            row = {
                "sample_id": sample_id,
                "spk": "female",
                "wav_path": wav_path,
                "start": "",
                "end": "",
                "original_text": text,
                "phonemes": " ".join(g2p_phonemes(text)),
            }
            if args.labdir:
                lab = os.path.join(args.labdir, f"{sample_id}.lab")
                if os.path.exists(lab):
                    upd = julius_updates(lab, wav_path, args.hop_size, args.fs)
                    if upd is not None:
                        row.update(upd)
            splits[split_of(_set)].append(row)
    write_splits(args.outdir, splits["train"], splits["dev"], splits["test"])


if __name__ == "__main__":
    main()
