"""JSUT tts1 data preparation (counterpart of egs/jsut/tts1/local/data_prep.py).

Builds train/dev/test csvs from the JSUT corpus layout
(``basic5000/transcript_utf8.txt`` + ``wav/``): the first ``--n-test`` rows
are the test split, the next ``--n-dev`` the dev split. Durations come from
the Julius ``.lab`` files when ``--labdir`` holds one for the utterance
(seconds to frames with the rounding residue shared out, ``text/julius.py``),
which also give its phonemes and the silB..silE crop:

    python -m jatts_torch.egs.jsut.tts1.local.data_prep --db-root downloads/jsut --outdir data [--labdir lab]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from jatts_torch.egs.prep import julius_updates, write_splits
from jatts_torch.text import g2p_phonemes


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--db-root", required=True)
    parser.add_argument("--outdir", default="data")
    parser.add_argument("--labdir", default=None, help="forced-alignment .lab dir")
    parser.add_argument("--hop-size", type=int, default=300)
    parser.add_argument("--fs", type=int, default=24000)
    parser.add_argument("--n-dev", type=int, default=250)
    parser.add_argument("--n-test", type=int, default=250)
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
            row = {
                "sample_id": utt,
                "spk": "jsut",
                "wav_path": wav_path,
                "start": "",
                "end": "",
                "original_text": text,
                "phonemes": " ".join(g2p_phonemes(text)),
            }
            if args.labdir:
                lab = os.path.join(args.labdir, f"{utt}.lab")
                if os.path.exists(lab):
                    upd = julius_updates(lab, wav_path, args.hop_size, args.fs)
                    if upd is not None:
                        row.update(upd)
            rows.append(row)

    test = rows[: args.n_test]
    dev = rows[args.n_test : args.n_test + args.n_dev]
    train = rows[args.n_test + args.n_dev :]
    write_splits(args.outdir, train, dev, test)


if __name__ == "__main__":
    main()
