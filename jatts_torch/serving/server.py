"""Micro-batching request server over the port's ServingBundle,
E2ttsServingBundle or ValleServingBundle (counterpart of
jatts_tpu/serving/server.py).

The bundle runs at a fixed batch size, but requests arrive one utterance
at a time. A background thread groups up to ``bundle.batch_size`` queued
requests inside a bounded latency window and runs them as one call; each
caller gets exactly the result it would have got alone, because rows are
independent and cropped by their own lengths.

Usage:
    server = BatchingServer(bundle, max_delay_ms=5)
    fut = server.submit(token_ids=[...])          # non-blocking -> Future
    wav = fut.result()["wav"]
    server.close()

Requests with different ``seed`` values never share a call (the seed is a
per-call input), so the batcher groups by seed, and streamed and whole
requests never share one. A request to a multi-speaker bundle may carry
``spemb=[...]`` (its speaker embedding); a batch stacks them, with a zero
row for a request without one. A request to an E2-TTS bundle carries
``token_ids``, ``prompt_mels`` (its raw prompt log-mel) and ``gen_frames``,
and gets back its generated mel; one to a VALL-E bundle carries
``token_ids`` and ``prompt_codes`` and gets back its RVQ codes.

``submit_stream`` (a mel bundle with a stream step) returns a
:class:`StreamHandle` that yields the utterance's pcm16 chunks as the
dispatcher produces them.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from queue import Empty, Queue
from typing import Any, Dict, List, Optional

import numpy as np

from jatts_torch.serving.bundle import E2ttsServingBundle, ServingBundle, ValleServingBundle


class _Request:
    __slots__ = ("fields", "seed", "future", "chunks")

    def __init__(self, fields: Dict[str, Any], seed: int, stream: bool = False):
        self.fields = fields
        self.seed = int(seed)
        self.future: Future = Future()
        # a streamed request gets a queue of chunks instead of one result
        self.chunks: Optional[Queue] = Queue() if stream else None


class StreamHandle:
    """Iterator over one streamed utterance's audio chunks.

    Yields dicts ``{"wav": int16 [<= chunk*hop], "start_sample": int}`` in
    order as the dispatcher produces them; raises if the batch failed. The
    first chunk is available while later chunks are still computing."""

    def __init__(self, req: _Request):
        self._req = req

    def __iter__(self):
        while True:
            kind, payload = self._req.chunks.get()
            if kind == "err":
                raise payload
            if kind == "end":
                return
            if len(payload["wav"]):  # finished rows get empty tails
                yield payload


class BatchingServer:
    """Groups per-utterance requests into fixed-batch bundle calls.

    Dispatch rule: once the oldest queued request has waited ``max_delay_ms``
    (or a full batch is available, whichever is first), every queued request
    with the same seed, up to ``bundle.batch_size``, runs as one call."""

    # per-bundle-kind request fields, in the order of bundle.synthesize
    _FIELDS = {
        ServingBundle: ("token_ids",),
        ValleServingBundle: ("token_ids", "prompt_codes"),
        E2ttsServingBundle: ("token_ids", "prompt_mels", "gen_frames"),
    }

    def __init__(self, bundle, max_delay_ms: float = 5.0):
        self.bundle = bundle
        self._required = self._FIELDS[type(bundle)]
        self.batch_size = int(bundle.batch_size)
        self.max_delay = float(max_delay_ms) / 1000.0
        self._queue: "Queue[Optional[_Request]]" = Queue()
        self._pending: List[_Request] = []
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "rows": 0}
        self._thread = threading.Thread(
            target=self._loop, name="jatts-torch-serving-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, seed: int = 0, **fields) -> Future:
        """Enqueue one utterance (``token_ids=[...]``, and ``spemb=[...]``
        for a multi-speaker bundle; ``token_ids``, ``prompt_mels`` and
        ``gen_frames`` for an E2-TTS bundle; ``token_ids`` and
        ``prompt_codes`` for a VALL-E bundle); returns a Future of the
        bundle's per-utterance result."""
        req = _Request(self._checked(fields), seed)
        self._queue.put(req)
        return req.future

    def submit_stream(self, seed: int = 0, **fields) -> StreamHandle:
        """Enqueue one utterance for chunked synthesis; returns an iterator
        of its audio chunks (:class:`StreamHandle`). Needs a mel bundle with
        a stream step (``bin/export_serving.py --vocoder stream``).

        The chunk loop runs on the one dispatcher thread, so requests queued
        behind a stream wait for its chunks before their batch runs. On one
        card the device is busy with those chunks either way; traffic that
        must not wait behind streams gets a BatchingServer of its own, or
        the stream step a smaller chunk."""
        if getattr(self.bundle, "stream", None) is None:
            raise ValueError("bundle was exported without stream= support")
        req = _Request(self._checked(fields), seed, stream=True)
        self._queue.put(req)
        return StreamHandle(req)

    def _checked(self, fields: Dict[str, Any]) -> Dict[str, Any]:
        if self._closed:
            raise RuntimeError("server is closed")
        missing = [k for k in self._required if k not in fields]
        if missing:
            raise TypeError(f"missing request fields: {missing}")
        # fail fast at submit so a bad request cannot poison its batch-mates
        longest = self.bundle.buckets[-1]
        if len(fields["token_ids"]) > longest:
            raise ValueError(
                f"text length {len(fields['token_ids'])} exceeds largest "
                f"bucket {longest}"
            )
        return fields

    def synthesize(self, seed: int = 0, **fields):
        """Blocking convenience wrapper around submit()."""
        return self.submit(seed=seed, **fields).result()

    def close(self, timeout: Optional[float] = 10.0):
        """Drain the queue, stop the dispatcher thread."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self):
        stop = False
        while not (stop and not self._pending and self._queue.empty()):
            # block for the first request, then hold the window open
            if not self._pending:
                item = self._queue.get()
                if item is None:
                    stop = True
                    continue
                self._pending.append(item)
            deadline = time.monotonic() + self.max_delay
            while len(self._pending) < self.batch_size:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    item = self._queue.get(timeout=wait)
                except Empty:
                    break
                if item is None:
                    stop = True
                    break
                self._pending.append(item)
            # one seed (a per-call input) and one mode a group: streamed and
            # whole requests run different calls
            head = self._pending[0]
            seed, stream = head.seed, head.chunks is not None
            batch = [
                r for r in self._pending if r.seed == seed and (r.chunks is not None) == stream
            ][: self.batch_size]
            self._pending = [r for r in self._pending if r not in batch]
            if stream:
                self._dispatch_stream(batch, seed)
            else:
                self._dispatch(batch, seed)
        # report shutdown to anything still queued (submit raced close)
        while True:
            try:
                item = self._queue.get_nowait()
            except Empty:
                break
            if item is not None:
                item.future.set_exception(RuntimeError("server closed"))
                if item.chunks is not None:
                    item.chunks.put(("err", RuntimeError("server closed")))

    def _kwargs(self, batch: List[_Request], seed: int) -> Dict[str, Any]:
        kwargs: Dict[str, Any] = {"seed": seed}
        if isinstance(self.bundle, ServingBundle) and any("spemb" in r.fields for r in batch):
            kwargs["spembs"] = np.stack([
                np.asarray(r.fields["spemb"], np.float32) if "spemb" in r.fields
                else np.zeros((self.bundle.spk_dim,), np.float32)
                for r in batch
            ])
        return kwargs

    def _count(self, batch: List[_Request]) -> None:
        self.stats["batches"] += 1
        self.stats["rows"] += self.batch_size
        self.stats["requests"] += len(batch)

    def _dispatch(self, batch: List[_Request], seed: int):
        self._count(batch)
        try:
            args = [[r.fields[k] for r in batch] for k in self._required]
            results = self.bundle.synthesize(*args, **self._kwargs(batch, seed))
        except Exception as e:  # propagate to every caller in the group
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        for r, res in zip(batch, results):
            if not r.future.cancelled():
                r.future.set_result(res)

    def _dispatch_stream(self, batch: List[_Request], seed: int):
        """One mel call, then one stream-step call a chunk; each request's
        queue gets its row of a chunk as soon as the chunk's fetch lands
        (caller k plays chunk 0 while chunk 1 computes)."""
        self._count(batch)
        try:
            token_ids = [r.fields["token_ids"] for r in batch]
            for rows in self.bundle.synthesize_streaming(token_ids, **self._kwargs(batch, seed)):
                for r, row in zip(batch, rows):
                    r.chunks.put(("chunk", row))
        except Exception as e:  # propagate to every caller in the group
            for r in batch:
                r.chunks.put(("err", e))
            return
        for r in batch:
            r.chunks.put(("end", None))
