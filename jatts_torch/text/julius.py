"""Julius forced-alignment post-processing, shared across tts1 recipes
(counterpart of jatts_tpu/text/julius.py).

Reference: utils/data_prep_post_julius.py:23-148 (.lab -> durations with
frame-count adjustment), utils/data_prep_post_for_test_set.py (test-set
phoneme regeneration), utils/prepare_julius.py (kana transcripts) — the
reference keeps this logic inside one-off scripts; here it is a reusable
library for the tts1 data preps (stage 0), with no torch in it.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Tuple


def parse_lab(
    lines: Sequence[str],
) -> Tuple[List[str], List[Tuple[float, float, str]], str, str]:
    """Parse a Julius .lab segmentation (``start end phone`` per line).

    Strips silB/silE and returns the utterance crop boundaries the reference
    derives from them (utils/data_prep_post_julius.py:118-131): start = the
    start of the line after silB, end = the end of the line before silE.

    Returns (phonemes, intervals, utt_start, utt_end) — utt_start/utt_end as
    strings (they go straight into csv columns), empty when no sil markers.
    """
    lines = [ln for ln in (ln.strip() for ln in lines) if ln]
    phonemes: List[str] = []
    intervals: List[Tuple[float, float, str]] = []
    utt_start, utt_end = "", ""
    for i, line in enumerate(lines):
        start, end, phn = line.split(" ")
        if phn == "silB":
            utt_start = lines[i + 1].split(" ")[0]
            continue
        if phn == "silE":
            utt_end = lines[i - 1].split(" ")[1]
            continue
        intervals.append((float(start), float(end), phn))
        phonemes.append(phn)
    return phonemes, intervals, utt_start, utt_end


def expected_total_frames(n_samples: int, hop_size: int) -> int:
    """Number of feature frames for a waveform of ``n_samples``
    (utils/data_prep_post_julius.py:46-50): floor(n/hop) + 1 — matching the
    centered-STFT frame count used in feature extraction."""
    if n_samples % hop_size == 0:
        return int(n_samples / hop_size) + 1
    return math.floor(n_samples / hop_size) + 1


def calculate_frames(
    n_samples: int,
    intervals: Sequence[Tuple[float, float, str]],
    hop_size: int,
    fs: int,
) -> List[int]:
    """Seconds -> integer frame durations, reference-exact
    (utils/data_prep_post_julius.py:23-80):

    1. floor each interval's duration / frame_shift;
    2. expected total = frames for the silB..silE-cropped waveform;
    3. distribute the shortfall one frame at a time, largest truncation
       error first.

    ``n_samples`` is the sample count of the cropped waveform (the reference
    re-loads the wav with librosa to count it; callers here pass it in so no
    audio IO happens inside the math).
    """
    frame_shift = hop_size / fs
    frames = [int((end - start) / frame_shift) for start, end, _ in intervals]
    total = sum(frames)

    expected = expected_total_frames(n_samples, hop_size)
    adjustment = expected - total
    assert adjustment >= 0, (
        f"expected total frames ({expected}) is smaller than "
        f"total frames ({total})"
    )
    if adjustment > 0:
        diffs = [
            f - (end - start) / frame_shift
            for (start, end, _), f in zip(intervals, frames)
        ]
        order = sorted(range(len(diffs)), key=lambda i: abs(diffs[i]), reverse=True)
        for i in order:
            if adjustment == 0:
                break
            frames[i] += 1
            adjustment -= 1
    return frames


def lab_to_row_updates(
    lab_path: str, n_samples: int, hop_size: int, fs: int
) -> dict | None:
    """.lab file -> csv-row updates {start, end, phonemes, durations}
    (the reference's per-item loop body, data_prep_post_julius.py:110-145).
    Returns None when segmentation failed (empty .lab)."""
    with open(lab_path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    if len(lines) < 1:
        return None
    phonemes, intervals, utt_start, utt_end = parse_lab(lines)
    if not intervals:
        return None
    durations = calculate_frames(n_samples, intervals, hop_size, fs)
    return {
        "start": utt_start,
        "end": utt_end,
        "phonemes": " ".join(phonemes),
        "durations": " ".join(str(d) for d in durations),
    }


def cropped_n_samples(start: str, end: str, fs: int, wav_n_samples: int) -> int:
    """Sample count of the silB..silE crop — what the reference counts by
    re-loading the wav with librosa offset/duration
    (data_prep_post_julius.py:38-45)."""
    if start == "" or end == "":
        return wav_n_samples
    return int(round((float(end) - float(start)) * fs))


def julius_transcript(text: str, for_segmentation: bool = True) -> str:
    """Japanese text -> hiragana transcript for the Julius segmentation kit
    (reference utils/prepare_julius.py:29-32 / data_prep_post_for_test_set
    phoneme regeneration). Uses the package G2P (pyopenjtalk when available,
    pure-python kana fallback otherwise)."""
    from jatts_torch.text.japanese import _kata_to_hira, text_to_kana

    hira = _kata_to_hira(text_to_kana(text))
    return hira.replace("。", "").replace("、", " sp ")


def post_process_csv_rows(
    rows: Sequence[dict],
    juliusdir: str,
    hop_size: int,
    fs: int,
    n_samples_fn,
) -> List[dict]:
    """Apply Julius .lab results to csv rows (reference
    data_prep_post_julius.py __main__ loop). ``n_samples_fn(row) -> int``
    supplies the cropped waveform length; rows whose segmentation failed are
    dropped (reference :117-118)."""
    out = []
    for row in rows:
        lab_path = os.path.join(juliusdir, row["sample_id"] + ".lab")
        if not os.path.exists(lab_path):
            continue
        with open(lab_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        if len(lines) < 1:
            continue
        phonemes, intervals, utt_start, utt_end = parse_lab(lines)
        if not intervals:
            continue
        new_row = dict(row)
        new_row["start"] = utt_start
        new_row["end"] = utt_end
        n_samples = n_samples_fn(new_row)
        durations = calculate_frames(n_samples, intervals, hop_size, fs)
        new_row["phonemes"] = " ".join(phonemes)
        new_row["durations"] = " ".join(str(d) for d in durations)
        out.append(new_row)
    return out
