"""JSUT tts2 data preparation (counterpart of egs/jsut/tts2/local/data_prep.py):
the implicit-alignment recipe, so no durations; an energy-based silence trim
gives each row's start/end, G2P its phonemes:

    python -m jatts_torch.egs.jsut.tts2.local.data_prep --db-root downloads/jsut --outdir data
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from jatts_torch.egs.prep import write_splits
from jatts_torch.text import g2p_phonemes
from jatts_torch.utils.io import read_audio


def trim_silence(wav: np.ndarray, sr: int, top_db: float = 30.0, frame: int = 2048,
                 hop: int = 512) -> Tuple[float, float]:
    """librosa.effects.trim-style energy trim -> (start_s, end_s): the
    first and last frame within ``top_db`` of the loudest frame's RMS."""
    if len(wav) < frame:
        return 0.0, len(wav) / sr
    n = 1 + (len(wav) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt((wav[idx] ** 2).mean(axis=1) + 1e-12)
    db = 20 * np.log10(rms / max(rms.max(), 1e-12))
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return 0.0, len(wav) / sr
    start = keep[0] * hop / sr
    end = min(keep[-1] * hop + frame, len(wav)) / sr
    return start, end


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--db-root", required=True)
    parser.add_argument("--outdir", default="data")
    parser.add_argument("--n-dev", type=int, default=250)
    parser.add_argument("--n-test", type=int, default=250)
    parser.add_argument("--sampling-rate", type=int, default=24000)
    args = parser.parse_args(argv)

    transcript = os.path.join(args.db_root, "basic5000", "transcript_utf8.txt")
    wavdir = os.path.join(args.db_root, "basic5000", "wav")
    rows = []
    with open(transcript, encoding="utf-8") as f:
        for line in f:
            utt, text = line.strip().split(":", 1)
            wav_path = os.path.join(wavdir, f"{utt}.wav")
            if not os.path.exists(wav_path):
                continue
            wav, sr = read_audio(wav_path, args.sampling_rate)
            start, end = trim_silence(wav, sr)
            rows.append({
                "sample_id": utt,
                "spk": "jsut",
                "wav_path": wav_path,
                "start": f"{start:.3f}",
                "end": f"{end:.3f}",
                "original_text": text,
                "phonemes": " ".join(g2p_phonemes(text)),
            })

    test = rows[: args.n_test]
    dev = rows[args.n_test : args.n_test + args.n_dev]
    train = rows[args.n_test + args.n_dev :]
    write_splits(args.outdir, train, dev, test)


if __name__ == "__main__":
    main()
