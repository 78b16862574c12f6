"""csv / wav / feature-dump IO (counterpart of jatts_tpu/utils/io.py).

WAV IO is scipy-based; the csv contract matches the JAX package's so recipe
artifacts are interchangeable.

Feature dumps: the JAX package writes one HDF5 file per utterance (``mel``,
``pitch``, ``energy``, ``spkemb`` …) and a stats file (``<feat>_mean``,
``<feat>_scale``). ``h5py`` is imported inside the HDF5 functions only, and
they raise an ImportError that names it where it is missing. The port also
reads the same arrays from a numpy ``.npz`` archive with the same keys,
because a machine without ``h5py`` must still train; :func:`read_array`
picks the format by the file's suffix, and a ``.h5`` path never silently
becomes anything else.
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


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing .h5 feature dumps needs the h5py package; "
            "without it, dump features as .npz with the same keys"
        ) from e
    return h5py


def read_hdf5(hdf5_name: str, hdf5_path: str) -> np.ndarray:
    if not os.path.exists(hdf5_name):
        raise FileNotFoundError(f"no such hdf5 file: {hdf5_name}")
    with _h5py().File(hdf5_name, "r") as f:
        if hdf5_path not in f:
            raise KeyError(f"no such dataset {hdf5_path} in {hdf5_name}")
        return f[hdf5_path][()]


def write_hdf5(hdf5_name: str, hdf5_path: str, write_data, is_overwrite: bool = True) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(hdf5_name)), exist_ok=True)
    write_data = np.asarray(write_data)
    with _h5py().File(hdf5_name, "a") as f:
        if hdf5_path in f:
            if not is_overwrite:
                raise RuntimeError(f"dataset {hdf5_path} exists in {hdf5_name}")
            del f[hdf5_path]
        f.create_dataset(hdf5_path, data=write_data)


def list_hdf5(hdf5_name: str) -> List[str]:
    h5py = _h5py()
    with h5py.File(hdf5_name, "r") as f:
        keys: List[str] = []
        f.visit(lambda k: keys.append(k) if isinstance(f[k], h5py.Dataset) else None)
    return keys


def read_array(path: str, key: str) -> np.ndarray:
    """Array ``key`` of a feature dump: ``.h5`` through :func:`read_hdf5`,
    ``.npz`` through ``numpy.load``. Raises FileNotFoundError or KeyError
    as :func:`read_hdf5` does, ValueError on any other suffix."""
    if path.endswith(".h5"):
        return read_hdf5(path, key)
    if path.endswith(".npz"):
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such npz file: {path}")
        with np.load(path) as f:
            if key not in f.files:
                raise KeyError(f"no such array {key} in {path}")
            return f[key]
    raise ValueError(f"feature dump {path}: expected a .h5 or .npz file")


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
