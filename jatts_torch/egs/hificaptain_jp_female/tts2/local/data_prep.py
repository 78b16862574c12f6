"""Hi-Fi-Captain (ja, female) tts2 data preparation (counterpart of
egs/hificaptain_jp_female/tts2/local/data_prep.py): the implicit-alignment
recipe. Each row's start/end is the energy-based silence trim of the JSUT
tts2 prep at 48 kHz settings (40 dB, 4096-sample frames, hop 600), and each
test row takes a training utterance drawn with ``random`` seeded by
``--seed`` as its prompt (``prompt_*`` columns, for the E2-TTS infill
decode):

    python -m jatts_torch.egs.hificaptain_jp_female.tts2.local.data_prep \\
        --db-root downloads/hi-fi-captain/ja-JP/female --outdir data --sampling-rate 48000
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Optional, Sequence

from jatts_torch.egs.hificaptain_jp_female.tts1.local.data_prep import SETS, read_texts, split_of
from jatts_torch.egs.prep import write_splits
from jatts_torch.egs.jsut.tts2.local.data_prep import trim_silence
from jatts_torch.text import g2p_phonemes
from jatts_torch.utils.io import read_audio

TRIM_TOP_DB = 40.0
TRIM_FRAME = 4096
TRIM_HOP = 600


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--db-root", required=True)
    parser.add_argument("--outdir", default="data")
    parser.add_argument("--sampling-rate", type=int, default=48000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    rng = random.Random(args.seed)

    texts = read_texts(args.db_root)
    splits = {"train": [], "dev": [], "test": []}
    for _set in SETS:
        split = split_of(_set)
        for sample_id, text in texts[_set].items():
            wav_path = os.path.join(args.db_root, "wav", _set, sample_id + ".wav")
            if not os.path.exists(wav_path):
                continue
            wav, sr = read_audio(wav_path, args.sampling_rate)
            start, end = trim_silence(wav, sr, top_db=TRIM_TOP_DB, frame=TRIM_FRAME, hop=TRIM_HOP)
            row = {
                "sample_id": sample_id,
                "spk": "female",
                "wav_path": wav_path,
                "start": f"{start:.4f}",
                "end": f"{end:.4f}",
                "original_text": text,
                "phonemes": " ".join(g2p_phonemes(text)),
            }
            if split == "test" and splits["train"]:
                p = rng.choice(splits["train"])
                for k in ("sample_id", "wav_path", "original_text", "phonemes", "start", "end"):
                    row[f"prompt_{k}"] = p[k]
            splits[split].append(row)
    write_splits(args.outdir, splits["train"], splits["dev"], splits["test"])


if __name__ == "__main__":
    main()
