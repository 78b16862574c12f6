"""JVS multi-speaker data preparation (counterpart of
egs/jvs/tts1/local/data_prep.py): walks ``<spk>/parallel100`` of every
speaker directory in order and writes csv rows with a ``spk`` column and a
per-speaker reference wav for the speaker embedding, taken from the train
slice. Per speaker the first ``--test-per-spk`` rows go to the test split,
the next ``--dev-per-spk`` to the dev split. Julius ``.lab`` files
(``<spk>_<utt>.lab``) under ``--labdir`` give phonemes, durations and the
crop:

    python -m jatts_torch.egs.jvs.tts1.local.data_prep --db-root downloads/jvs_ver1 --outdir data
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
    parser.add_argument("--dev-per-spk", type=int, default=3)
    parser.add_argument("--test-per-spk", type=int, default=3)
    parser.add_argument(
        "--labdir", default=None,
        help="forced-alignment .lab dir (<spk>_<utt>.lab) for the external-duration FastSpeech2 conf; "
        "MAS confs train without it",
    )
    parser.add_argument("--hop-size", type=int, default=300)
    parser.add_argument("--fs", type=int, default=24000)
    args = parser.parse_args(argv)

    train, dev, test = [], [], []
    for spk in sorted(os.listdir(args.db_root)):
        spk_dir = os.path.join(args.db_root, spk, "parallel100")
        transcript = os.path.join(spk_dir, "transcripts_utf8.txt")
        wavdir = os.path.join(spk_dir, "wav24kHz16bit")
        if not os.path.exists(transcript):
            continue
        rows = []
        with open(transcript, encoding="utf-8") as f:
            for line in f:
                if ":" not in line:
                    continue
                utt, text = line.strip().split(":", 1)
                wav_path = os.path.join(wavdir, f"{utt}.wav")
                if not os.path.exists(wav_path):
                    continue
                row = {
                    "sample_id": f"{spk}_{utt}",
                    "spk": spk,
                    "wav_path": wav_path,
                    "start": "",
                    "end": "",
                    "original_text": text,
                    "phonemes": " ".join(g2p_phonemes(text)),
                    "ref_wav_path": "",
                }
                if args.labdir:
                    lab = os.path.join(args.labdir, f"{spk}_{utt}.lab")
                    if os.path.exists(lab):
                        upd = julius_updates(lab, wav_path, args.hop_size, args.fs)
                        if upd is not None:
                            row.update(upd)
                rows.append(row)
        if not rows:
            continue
        n_held = args.test_per_spk + args.dev_per_spk
        # the reference wav comes from the train slice: rows[0] is a test row
        ref_wav = rows[n_held]["wav_path"] if len(rows) > n_held else rows[-1]["wav_path"]
        for r in rows:
            r["ref_wav_path"] = ref_wav
        test.extend(rows[: args.test_per_spk])
        dev.extend(rows[args.test_per_spk : n_held])
        train.extend(rows[n_held:])

    write_splits(args.outdir, train, dev, test)


if __name__ == "__main__":
    main()
