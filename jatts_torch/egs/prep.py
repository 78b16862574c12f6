"""What the stage-0 data preps share: the Julius ``.lab`` updates of a csv
row and the train/dev/test csvs."""

from __future__ import annotations

import os
import wave
from typing import Dict, List, Optional

from jatts_torch.text.julius import cropped_n_samples, lab_to_row_updates, parse_lab
from jatts_torch.utils.io import write_csv


def wav_n_samples(wav_path: str, fs: int) -> int:
    """The wav's sample count at ``fs``, from its header."""
    with wave.open(wav_path, "rb") as w:
        return int(round(w.getnframes() * fs / w.getframerate()))


def julius_updates(lab: str, wav_path: str, hop_size: int, fs: int) -> Optional[Dict[str, str]]:
    """The row updates (start, end, phonemes, durations) of the Julius
    alignment ``lab`` of ``wav_path``: the silB..silE crop's frames shared
    out over the phones (``text/julius.py``); None for an empty ``.lab``."""
    with open(lab, encoding="utf-8") as f:
        lines = f.read().splitlines()
    if not lines:
        return None
    _, _, ustart, uend = parse_lab(lines)
    n_samples = cropped_n_samples(ustart, uend, fs, wav_n_samples(wav_path, fs))
    return lab_to_row_updates(lab, n_samples, hop_size, fs)


def write_splits(outdir: str, train: List[dict], dev: List[dict], test: List[dict]) -> None:
    """``outdir/{train,dev,test}.csv`` and the counts line the scripts print."""
    os.makedirs(outdir, exist_ok=True)
    write_csv(train, os.path.join(outdir, "train.csv"))
    write_csv(dev, os.path.join(outdir, "dev.csv"))
    write_csv(test, os.path.join(outdir, "test.csv"))
    print(f"train/dev/test = {len(train)}/{len(dev)}/{len(test)}")
