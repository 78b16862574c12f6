"""csv / wav IO (counterpart of jatts_tpu/utils/io.py; the HDF5 helpers are
not ported yet).

WAV IO is scipy-based; the csv contract matches the JAX package's so recipe
artifacts are interchangeable.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.io.wavfile
import scipy.signal


def read_csv(path: str, dict_reader: bool = False) -> Tuple[Any, List[str]]:
    """Rows and field names; rows are dicts with ``dict_reader``, else lists."""
    with open(path, newline="") as f:
        if dict_reader:
            reader = csv.DictReader(f)
            fieldnames = list(reader.fieldnames or [])
            return [dict(r) for r in reader], fieldnames
        reader = csv.reader(f)
        return [r for r in reader], []


def write_csv(
    data: Sequence[Dict[str, Any]], path: str, fieldnames: Optional[Sequence[str]] = None
) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if fieldnames is None:
        if not data:
            raise ValueError(
                f"write_csv: no rows for {path}: data prep found nothing "
                "(wrong --db-root / corpus layout, or every row filtered)"
            )
        fieldnames = list(data[0].keys())
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(fieldnames), extrasaction="ignore")
        writer.writeheader()
        for row in data:
            writer.writerow(row)


def read_audio(
    path: str,
    sampling_rate: Optional[int] = None,
    start: Optional[float] = None,
    end: Optional[float] = None,
    gain: float = 1.0,
) -> Tuple[np.ndarray, int]:
    """Load wav -> float32 [-1, 1], optional crop/resample/gain."""
    sr, wav = scipy.io.wavfile.read(path)
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    elif wav.dtype == np.uint8:
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    else:
        wav = wav.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sampling_rate is not None and sr != sampling_rate:
        n_out = int(round(len(wav) * sampling_rate / sr))
        wav = scipy.signal.resample_poly(wav, sampling_rate, sr).astype(np.float32)[:n_out]
        sr = sampling_rate
    if start is not None or end is not None:
        s = int(float(start) * sr) if start not in (None, "") else 0
        e = int(float(end) * sr) if end not in (None, "") else len(wav)
        wav = wav[s:e]
    wav = wav * gain
    if np.abs(wav).max() > 1.0:
        logging.warning(f"{path}: audio exceeds [-1, 1] after gain; clipping")
        wav = np.clip(wav, -1.0, 1.0)
    return wav, sr


def write_audio(path: str, wav: np.ndarray, sampling_rate: int) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    # round + /32768 scale: exact inverse of read_audio, so read->write->read
    # is idempotent (astype truncation would shift every sample ~1 LSB)
    pcm = np.clip(np.round(wav * 32768.0), -32768, 32767).astype(np.int16)
    scipy.io.wavfile.write(path, sampling_rate, pcm)
