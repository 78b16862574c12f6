"""Bucketed batching (counterpart of jatts_tpu/data/batcher.py).

Batches are padded up to bucket boundaries (text to a multiple of 16
tokens, features to a multiple of 64 frames), as the JAX package pads them
to bound its compiled programs; the port keeps the same shapes so that both
see the same batches. The sampler's seeded per-epoch shuffle of the batch
order is the JAX package's, so both visit the batches in the same order.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np


def round_up(x: int, m: int) -> int:
    return int(math.ceil(max(x, 1) / m) * m)


class BatchSampler:
    """Sort by length, fixed batch size, seeded per-epoch shuffle of the
    batch order."""

    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        order = np.argsort(np.asarray(self.lengths), kind="stable")
        self.batches: List[List[int]] = [
            list(order[i : i + batch_size]) for i in range(0, len(order), batch_size)
        ]
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[List[int]]:
        batches = list(self.batches)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(batches)
        return iter(batches)


def _pad_to(x: np.ndarray, t: int) -> np.ndarray:
    return np.pad(x, [(0, t - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


class FastSpeech2Collater:
    """Pads dataset items into one numpy batch: xs [B, Tx] int32, ilens,
    ys [B, Ty, D] float32, olens, and when present ds [B, Tx] int32,
    ps/es [B, Tx, 1] float32, spembs [B, D]."""

    def __init__(
        self, pad_text_multiple: int = 16, pad_feats_multiple: int = 64, out_feat_type: str = "mel"
    ):
        self.pad_text_multiple = pad_text_multiple
        self.pad_feats_multiple = pad_feats_multiple
        self.out_feat_type = out_feat_type

    def __call__(self, items: List[Dict[str, Any]]) -> Dict[str, Any]:
        xs = [it["x"] for it in items]
        ilens = np.asarray([len(x) for x in xs], np.int32)
        t_text = round_up(int(ilens.max()), self.pad_text_multiple)
        batch: Dict[str, Any] = {
            "utt_ids": [it.get("utt_id", "") for it in items],
            "xs": np.stack([_pad_to(x, t_text) for x in xs]).astype(np.int32),
            "ilens": ilens,
        }
        if self.out_feat_type in items[0]:
            ys = [it[self.out_feat_type] for it in items]
            olens = np.asarray([len(y) for y in ys], np.int32)
            t_feats = round_up(int(olens.max()), self.pad_feats_multiple)
            batch["ys"] = np.stack([_pad_to(y, t_feats) for y in ys]).astype(np.float32)
            batch["olens"] = olens
        if "durations" in items[0]:
            batch["ds"] = np.stack([_pad_to(it["durations"], t_text) for it in items]).astype(np.int32)
        if "pitch" in items[0]:
            batch["ps"] = np.stack([_pad_to(it["pitch"], t_text) for it in items]).astype(np.float32)
        if "energy" in items[0]:
            batch["es"] = np.stack([_pad_to(it["energy"], t_text) for it in items]).astype(np.float32)
        if "spkemb" in items[0]:
            batch["spembs"] = np.stack([it["spkemb"].reshape(-1) for it in items]).astype(np.float32)
        return batch


COLLATER_REGISTRY = {"FastSpeech2Collater": FastSpeech2Collater}


class DataLoader:
    """Sampler + collater -> numpy batches, with optional background
    prefetch: ``prefetch > 0`` builds batches on a daemon thread (file
    reads and numpy release the GIL) while the device runs. Exceptions in
    the worker reach the consumer; a consumer that stops early stops the
    worker."""

    def __init__(self, dataset, sampler, collater, prefetch: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.collater = collater
        self.prefetch = int(prefetch or 0)

    def __len__(self) -> int:
        return len(self.sampler)

    def _make(self, batch_idx):
        return self.collater([self.dataset[i] for i in batch_idx])

    def __iter__(self):
        if self.prefetch <= 0:
            for batch_idx in self.sampler:
                yield self._make(batch_idx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch_idx in self.sampler:
                    if not put(self._make(batch_idx)):
                        return
                put(end)
            except BaseException as e:  # noqa: BLE001 - handed to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            t.join()
        finally:
            stop.set()
