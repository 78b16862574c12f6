"""Stage-1 feature extractors (counterpart of jatts_tpu/features/extractors.py):
log-mel, pitch (``Dio``: continuous log-f0 from the NCCF track of
``ops/pitch.py``, token-averaged) and energy. Each computes on ``device``
(default the card) and returns numpy.
"""

from __future__ import annotations

import logging
from typing import Optional, Union

import numpy as np
import torch

from jatts_torch.device import resolve_device
from jatts_torch.ops.dsp import adjust_num_frames, energy as energy_op, logmelfilterbank
from jatts_torch.ops.pitch import continuous_f0, estimate_f0

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


def _average_by_duration(x: np.ndarray, d: np.ndarray, reduction_factor: int) -> np.ndarray:
    """Mean of the positive (voiced) frames of each token, 0 for a token
    with none; the frames may overhang the durations' sum by at most the
    reduction factor."""
    if not 0 <= len(x) - d.sum() < reduction_factor + 1:
        raise ValueError(f"{len(x)} frames for durations summing to {d.sum()}")
    d_cumsum = np.pad(np.cumsum(d).astype(int), (1, 0))
    out = []
    for start, end in zip(d_cumsum[:-1], d_cumsum[1:]):
        seg = x[start:end]
        seg = seg[seg > 0.0]
        out.append(seg.mean() if len(seg) else 0.0)
    return np.asarray(out)


class Dio:
    """Pitch extractor: NCCF f0 on ``device``, then (numpy) continuous
    interpolation over unvoiced frames, log, length adjustment and
    token averaging."""

    def __init__(
        self,
        fs: int = 22050,
        n_fft: int = 1024,
        hop_length: int = 256,
        f0min: float = 80.0,
        f0max: float = 400.0,
        use_token_averaged_f0: bool = True,
        use_continuous_f0: bool = True,
        use_log_f0: bool = True,
        reduction_factor: Optional[int] = 1,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.fs = fs
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.f0min = f0min
        self.f0max = f0max
        self.use_token_averaged_f0 = use_token_averaged_f0
        self.use_continuous_f0 = use_continuous_f0
        self.use_log_f0 = use_log_f0
        self.reduction_factor = reduction_factor or 1

    def __call__(
        self,
        audio: np.ndarray,
        feat_length: Optional[int] = None,
        durations: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        padded, n_frames = _pad_to_bucket(np.asarray(audio, np.float32), self.hop_length)
        f0 = estimate_f0(
            torch.from_numpy(padded).to(self.device), self.fs, self.hop_length,
            frame_length=self.n_fft, f0min=self.f0min, f0max=self.f0max,
        )[:n_frames].cpu().numpy()
        if (f0 == 0).all():
            logging.warning("All frames seem to be unvoiced.")
        if self.use_continuous_f0:
            f0 = continuous_f0(f0)
        if self.use_log_f0:
            with np.errstate(divide="ignore"):
                f0 = np.where(f0 > 0, np.log(np.maximum(f0, 1e-10)), 0.0)
        if feat_length is not None:
            f0 = adjust_num_frames(f0, feat_length)
        if self.use_token_averaged_f0 and durations is not None:
            f0 = _average_by_duration(f0, np.asarray(durations) * self.reduction_factor, self.reduction_factor)
        return f0.astype(np.float32)


class Energy:
    """Frame energy (the L2 norm of the STFT magnitude) on ``device``, then
    length adjustment and token averaging."""

    def __init__(
        self,
        fs: int = 22050,
        n_fft: int = 1024,
        win_length: Optional[int] = None,
        hop_length: int = 256,
        window: str = "hann",
        use_token_averaged_energy: bool = True,
        reduction_factor: Optional[int] = 1,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if window != "hann":
            raise ValueError(f"only the hann window is supported, got {window}")
        self.device = resolve_device(device)
        self.fs = fs
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.use_token_averaged_energy = use_token_averaged_energy
        self.reduction_factor = reduction_factor or 1

    def __call__(
        self,
        audio: np.ndarray,
        feat_length: Optional[int] = None,
        durations: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        padded, n_frames = _pad_to_bucket(np.asarray(audio, np.float32), self.hop_length)
        e = energy_op(
            torch.from_numpy(padded).to(self.device), self.n_fft, self.hop_length, self.win_length
        )[:n_frames].cpu().numpy()
        if feat_length is not None:
            e = adjust_num_frames(e, feat_length)
        if self.use_token_averaged_energy and durations is not None:
            e = _average_by_duration(e, np.asarray(durations) * self.reduction_factor, self.reduction_factor)
        return e.astype(np.float32)
