"""Stage-1 feature extractors (counterpart of jatts_tpu/features/extractors.py;
only the log-mel extractor is ported so far).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from jatts_torch.device import resolve_device
from jatts_torch.ops.dsp import logmelfilterbank

# Audio is padded up to a bucket boundary (multiples of hop*BUCKET_FRAMES)
# and the result cropped back to the true frame count, as the JAX package
# does to bound its number of compiled programs; kept here so that both give
# the same frames. Only the last ~n_fft/(2*hop) frames can differ marginally
# from unpadded extraction (zero- vs reflect-padding at the tail).
BUCKET_FRAMES = 64


def _pad_to_bucket(audio: np.ndarray, hop: int) -> tuple:
    n_frames = 1 + len(audio) // hop
    bucket = -(-n_frames // BUCKET_FRAMES) * BUCKET_FRAMES
    target_len = (bucket - 1) * hop + hop - 1  # ensures 1 + len//hop == bucket
    target_len = max(target_len, len(audio))
    return np.pad(audio, (0, target_len - len(audio))), n_frames


class LogMelExtractor:
    """numpy waveform -> numpy log-mel ``[n_frames, num_mels]``, computed on
    ``device`` (default the card)."""

    def __init__(
        self,
        sampling_rate: int,
        fft_size: int = 1024,
        hop_size: int = 256,
        win_length: Optional[int] = None,
        window: str = "hann",
        num_mels: int = 80,
        fmin: Optional[float] = None,
        fmax: Optional[float] = None,
        log_base: Optional[float] = 10.0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if window != "hann":
            raise ValueError(f"only the hann window is supported, got {window}")
        self.device = resolve_device(device)
        self.kw = dict(
            sampling_rate=sampling_rate, fft_size=fft_size, hop_size=hop_size,
            win_length=win_length, num_mels=num_mels,
            fmin=fmin, fmax=fmax, log_base=log_base,
        )

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        padded, n_frames = _pad_to_bucket(np.asarray(audio, np.float32), self.kw["hop_size"])
        mel = logmelfilterbank(torch.from_numpy(padded).to(self.device), **self.kw)
        return mel[:n_frames].cpu().numpy()
