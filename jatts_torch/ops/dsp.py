"""DSP feature extraction: STFT and log-mel (counterpart of
jatts_tpu/ops/dsp.py; ``energy``, Griffin-Lim and pitch are not ported yet).

Framing is a gather, the FFT is ``torch.fft.rfft`` and the mel projection a
single matmul, all on the tensor's device.

Numerics are librosa-compatible: center=True reflect padding, periodic Hann
window, Slaney-scale mel filterbank with Slaney normalization.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# windows / filterbanks (host-side constants, float64 then cast)
# ---------------------------------------------------------------------------


def periodic_hann(win_length: int) -> np.ndarray:
    """scipy.signal.get_window('hann', n, fftbins=True) equivalent."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    # np.where evaluates both branches: keep the log's argument positive for
    # f=0 rows (they take the linear branch anyway) to avoid a divide warning
    f_safe = np.maximum(f, 1e-10)
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(f_safe / min_log_hz) / logstep, mel
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """librosa.filters.mel-compatible (htk=False, norm='slaney') -> [n_mels, n_fft//2+1]."""
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float64)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered framing with reflect padding: ``[T] -> [n_frames, n_fft]``."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(audio[None, None, :], (pad, pad), mode="reflect")[0, 0]
    n_frames = 1 + audio.shape[0] // hop
    starts = torch.arange(n_frames, device=audio.device) * hop
    idx = starts[:, None] + torch.arange(n_fft, device=audio.device)[None, :]
    return x[idx]


def stft_magnitude(
    audio: torch.Tensor, n_fft: int, hop: int, win_length: Optional[int] = None
) -> torch.Tensor:
    """|STFT| with librosa semantics -> ``[n_frames, n_fft//2 + 1]``."""
    win_length = win_length or n_fft
    window = periodic_hann(win_length)
    if win_length < n_fft:  # center-pad window to n_fft like librosa
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    frames = frame_signal(audio.float(), n_fft, hop)
    frames = frames * torch.as_tensor(window, dtype=torch.float32, device=audio.device)[None, :]
    return torch.fft.rfft(frames, dim=-1).abs()


def logmelfilterbank(
    audio: torch.Tensor,
    sampling_rate: int,
    fft_size: int = 1024,
    hop_size: int = 256,
    win_length: Optional[int] = None,
    num_mels: int = 80,
    fmin: Optional[float] = None,
    fmax: Optional[float] = None,
    eps: float = 1e-10,
    log_base: Optional[float] = 10.0,
) -> torch.Tensor:
    """Log-mel feature ``[n_frames, num_mels]`` of a 1-D waveform tensor."""
    fmin = 0.0 if fmin is None else fmin
    fmax = sampling_rate / 2.0 if fmax is None else fmax
    spc = stft_magnitude(audio, fft_size, hop_size, win_length)
    basis = torch.as_tensor(
        mel_filterbank(sampling_rate, fft_size, num_mels, fmin, fmax),
        dtype=torch.float32, device=audio.device,
    )
    mel = torch.matmul(spc, basis.T).clamp(min=eps)
    if log_base is None:
        return torch.log(mel)
    if log_base == 10.0:
        return torch.log10(mel)
    if log_base == 2.0:
        return torch.log2(mel)
    raise ValueError(f"{log_base} is not supported.")


def energy(
    audio: torch.Tensor, n_fft: int = 1024, hop: int = 256, win_length: Optional[int] = None
) -> torch.Tensor:
    """Per-frame energy ``[n_frames]``: the L2 norm of the STFT magnitude
    over frequency, floored at sqrt(1e-10)."""
    spc = stft_magnitude(audio, n_fft, hop, win_length)
    return torch.sqrt(torch.clamp((spc**2).sum(dim=-1), min=1e-10))

