"""TTSDataset: csv + per-utterance feature dump + stats -> normalized numpy
dicts (counterpart of jatts_tpu/data/dataset.py).

Framework-free: the batcher (``data/batcher.py``) pads items into numpy
batches; the trainer moves them to the device. Feature dumps and the stats
file are ``.h5`` or ``.npz`` by their suffix (``utils/io.py:read_array``),
with the JAX package's keys.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from jatts_torch.data.token_id_converter import TokenIDConverter
from jatts_torch.utils.io import read_array, read_csv


class Scaler:
    """Per-feature standard-scaler parameters from the stats file
    (``<feat>_mean``, ``<feat>_scale``)."""

    def __init__(self, stats_path: str, feat_list: Sequence[str]):
        self.mean: Dict[str, np.ndarray] = {}
        self.scale: Dict[str, np.ndarray] = {}
        for feat in feat_list:
            if feat.startswith("encodec"):
                continue  # discrete codes are not normalized
            self.mean[feat] = np.asarray(read_array(stats_path, f"{feat}_mean"))
            self.scale[feat] = np.asarray(read_array(stats_path, f"{feat}_scale"))

    def transform(self, feat: str, x: np.ndarray) -> np.ndarray:
        if feat not in self.mean:
            return x
        return (x - self.mean[feat]) / self.scale[feat]



class TTSDataset:
    """Rows of a recipe csv as dicts: ``utt_id``, ``spk``, token ids ``x``
    (int64), ``durations`` (int64) when the csv has them, and the
    normalized features of ``feat_list`` (float32; pitch/energy as
    ``[T, 1]``). Training items only: the inference mode of the JAX dataset
    and the VALL-E prompts are not ported yet."""

    def __init__(
        self,
        csv_path: str,
        stats_path: Optional[str],
        feat_list: Sequence[str],
        token_list_path: str,
        phoneme_column: str = "phonemes",
        prompt_strategy: Optional[str] = None,
        hop_size: int = 300,
        sampling_rate: int = 24000,
        allow_cache: bool = False,
    ):
        if prompt_strategy is not None:
            raise ValueError("prompt_strategy (VALL-E prompts) is not ported yet")
        self.data, self.fieldnames = read_csv(csv_path, dict_reader=True)
        self.feat_list = list(feat_list)
        self.token_converter = TokenIDConverter(token_list_path)
        self.phoneme_column = phoneme_column
        self.hop_size = hop_size
        self.sampling_rate = sampling_rate
        self.scaler = (
            Scaler(stats_path, feat_list) if (stats_path and os.path.exists(stats_path)) else None
        )
        self.allow_cache = allow_cache
        self._cache: Dict[int, Dict[str, Any]] = {}

    @property
    def vocab_size(self) -> int:
        return self.token_converter.get_num_vocabulary_size()

    def __len__(self) -> int:
        return len(self.data)

    def get_frame_len(self, idx: int) -> int:
        """Frame count from csv start/end (or the durations) for length bucketing."""
        row = self.data[idx]
        if row.get("start") and row.get("end"):
            dur_s = float(row["end"]) - float(row["start"])
            return int(dur_s * self.sampling_rate / self.hop_size)
        if row.get("durations"):
            return int(sum(int(d) for d in row["durations"].split()))
        return 0

    def _tokenize(self, row: Dict[str, str]) -> np.ndarray:
        tokens = row[self.phoneme_column].split(" ")
        return np.asarray(self.token_converter.tokens2ids(tokens), dtype=np.int64)

    def _load_feats(self, feat_path: str, items: Dict[str, Any]) -> None:
        for feat in self.feat_list:
            x = np.asarray(read_array(feat_path, feat))
            if self.scaler is not None:
                x = self.scaler.transform(feat, x)
            if feat in ("pitch", "energy") and x.ndim == 1:
                x = x[:, None]
            if feat == "spkemb" and x.ndim == 1:
                x = x[None, :]
            items[feat] = x.astype(np.float32) if x.dtype.kind == "f" else x

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if self.allow_cache and idx in self._cache:
            return self._cache[idx]
        row = self.data[idx]
        items: Dict[str, Any] = {"utt_id": row.get("sample_id", str(idx))}
        items["spk"] = row.get("spk", "")
        items["x"] = self._tokenize(row)
        if row.get("durations"):
            items["durations"] = np.asarray(
                [int(d) for d in row["durations"].split()], dtype=np.int64
            )
        self._load_feats(row["feat_path"], items)
        for k in ("ref_wav_path", "wav_path", "original_text"):
            if row.get(k):
                items[k] = row[k]
        if self.allow_cache:
            self._cache[idx] = items
        return items
