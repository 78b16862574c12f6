"""Streaming (chunked) HiFi-GAN vocoding (counterpart of jatts_tpu/vocoder/streaming.py).

The generator is a pure conv stack, so chunking is exact by construction:
vocode a mel window that reaches ``context`` frames past the chunk on each
side and crop the interior; with ``context`` at least the stack's receptive
field, every cropped sample sees the mel values the whole-utterance call saw.
The first and last windows are not padded: they start and end at the true
mel boundary, so the convolutions' own zero padding is the whole call's (a
zero-padded input would leak the conv biases and leaky-relu into the crop).

The receptive field comes from the generator's hyperparameters
(:func:`min_context_frames`): the input conv, each stage's transposed conv
and residual stacks at that stage's rate, and the output conv, in mel
frames. ``tests/test_torch_streaming_vocoder.py`` pins the concatenation to
the whole call at the computed context, a context of 1 to a detectable
error, and both to the JAX package's streaming vocoder on the same weights.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np
import torch


def hop_size(voc) -> int:
    """Samples per mel frame: the product of the generator's upsample scales."""
    return math.prod(int(s) for s in voc.upsample_scales)


def _resblock_context(voc) -> int:
    """One-sided receptive field of a stage's residual stacks, in samples at
    that stage's rate: the widest block's chain of dilated convs (plus its
    undilated follow-ups)."""
    worst = 0
    for rk, rds in zip(voc.resblock_kernel_sizes, voc.resblock_dilations):
        half = (rk - 1) // 2
        ctx = sum(half * d for d in rds)
        if voc.use_additional_convs:
            ctx += half * len(rds)
        worst = max(worst, ctx)
    return worst


def min_context_frames(voc) -> int:
    """One-sided receptive field of the generator, in mel frames (ceil)."""
    ctx = (voc.kernel_size - 1) / 2  # input conv
    res = _resblock_context(voc)
    rate = 1  # samples per mel frame at the current stage's input
    for scale, k in zip(voc.upsample_scales, voc.upsample_kernel_sizes):
        # transposed conv: each output draws on <= ceil(k/s) input positions
        ctx += math.ceil(k / scale) / rate
        rate *= int(scale)
        ctx += res / rate  # the residual stacks at this stage's output rate
    ctx += (voc.kernel_size - 1) / 2 / rate  # output conv
    return int(math.ceil(ctx))


@torch.no_grad()
def vocode_streaming(voc, mel: torch.Tensor, *, chunk: int = 64,
                     context: Optional[int] = None) -> Iterator[torch.Tensor]:
    """Yield waveform chunks left to right for a batch of mels.

    voc: :class:`~jatts_torch.vocoder.hifigan.HiFiGANGenerator` (or any pure
    conv ``[B, T, C] -> [B, T*hop, 1]`` module with its hyperparameters);
    mel [B, T, n_mels], normalised as the generator takes it; ``chunk`` mel
    frames a chunk (the last one the remainder); ``context`` frames of look
    back and look ahead a window, by default the receptive field (less
    breaks exactness). Yields [B, chunk_i*hop, 1] tensors whose
    concatenation equals ``voc(mel)`` up to the convolutions' summation
    order (1e-5 absolute in f32, pinned by the tests)."""
    if context is None:
        context = min_context_frames(voc)
    hop = hop_size(voc)
    t = mel.shape[1]
    for s in range(0, t, chunk):
        e = min(t, s + chunk)
        ws, we = max(0, s - context), min(t, e + context)
        wav = voc(mel[:, ws:we])
        yield wav[:, (s - ws) * hop:(e - ws) * hop]


def vocode_streaming_np(voc, mel: torch.Tensor, *, chunk: int = 64,
                        context: Optional[int] = None) -> Iterator[np.ndarray]:
    """:func:`vocode_streaming` with each chunk fetched to the host as
    numpy: the fetch is the chunk's completion barrier, so a serving loop
    plays chunk k while chunk k + 1 computes."""
    for w in vocode_streaming(voc, mel, chunk=chunk, context=context):
        yield w.float().cpu().numpy()
