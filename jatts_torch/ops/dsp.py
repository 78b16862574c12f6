"""DSP feature extraction: STFT, log-mel, energy and Griffin-Lim
(counterpart of jatts_tpu/ops/dsp.py).

Framing is ``unfold`` over a numpy-style reflect-padded signal, the FFT is
``torch.fft``, the mel projection a single matmul and the inverse STFT's
overlap-add ``F.fold``, all on the tensor's device.

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


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``numpy.pad(x, pad, mode="reflect")`` of a 1-D tensor, for any
    ``pad``: past the signal's length numpy reflects again, so the index
    is periodic with period 2(T-1) (``F.pad`` refuses such a pad)."""
    n = x.shape[0]
    i = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        return x[torch.zeros_like(i)]
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return x[torch.where(j >= n, period - j, j)]


def frames_of(x: torch.Tensor, n_frames: int, length: int, hop: int) -> torch.Tensor:
    """``[n_frames, length]`` windows of ``x`` starting every ``hop``
    samples, as ``unfold`` views; an index past the end reads the last
    sample, as the JAX package's gather clamps it."""
    need = (n_frames - 1) * hop + length
    if x.shape[0] < need:
        x = torch.cat([x, x[-1:].expand(need - x.shape[0])])
    return x.unfold(0, length, hop)[:n_frames]


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered framing with reflect padding: ``[T] -> [n_frames, n_fft]``."""
    pad = n_fft // 2
    return frames_of(reflect_pad(audio, pad), 1 + audio.shape[0] // hop, n_fft, hop)


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



def adjust_num_frames(x: np.ndarray, num_frames: int) -> np.ndarray:
    """Pad with zeros or crop trailing frames to ``num_frames``."""
    if num_frames > len(x):
        pad = [(0, num_frames - len(x))] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad)
    return x[:num_frames]


def _hann(n_fft: int, device) -> torch.Tensor:
    return torch.as_tensor(periodic_hann(n_fft), dtype=torch.float32, device=device)


def _stft_complex(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    frames = frame_signal(audio.float(), n_fft, hop)
    return torch.fft.rfft(frames * _hann(n_fft, audio.device)[None, :], dim=-1)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """``[n_frames, n_fft]`` -> the sum of the frames placed every ``hop``
    samples, ``[n_fft + hop * (n_frames - 1)]`` (``F.fold``)."""
    n_frames, n_fft = frames.shape
    total = n_fft + hop * (n_frames - 1)
    return torch.nn.functional.fold(
        frames.T[None], output_size=(1, total), kernel_size=(1, n_fft), stride=(1, hop)
    ).reshape(total)


def _istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add (librosa center semantics).
    The overlap-add sums in another order than the JAX package's
    scatter-add, so the two agree to f32 rounding, not bitwise."""
    window = _hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window[None, :]
    wav = _overlap_add(frames, hop)
    wsum = _overlap_add((window**2)[None, :].expand(frames.shape[0], n_fft), hop)
    wav = wav / wsum.clamp(min=1e-8)
    pad = n_fft // 2
    return wav[pad : pad + length]


def griffin_lim(
    log_mel: torch.Tensor,
    sampling_rate: int,
    fft_size: int = 1024,
    hop_size: int = 256,
    num_mels: int = 80,
    fmin: Optional[float] = None,
    fmax: Optional[float] = None,
    log_base: Optional[float] = 10.0,
    n_iter: int = 32,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Weights-free mel inversion: log-mel ``[T, num_mels]`` -> waveform
    ``[length]`` (default ``T * hop_size``) on the log-mel's device.

    The pseudo-inverse of the Slaney mel basis (numpy, on the f32 basis,
    as the JAX package computes it) recovers a linear magnitude; then
    ``n_iter`` phase iterations (ISTFT -> STFT -> magnitude projection) are
    queued on the device one after another, with no host sync between
    them."""
    fmin = 0.0 if fmin is None else fmin
    fmax = sampling_rate / 2.0 if fmax is None else fmax
    log_mel = log_mel.float()
    if log_base is None:
        mel = torch.exp(log_mel)
    elif log_base == 10.0:
        mel = torch.pow(10.0, log_mel)
    elif log_base == 2.0:
        mel = torch.pow(2.0, log_mel)
    else:
        raise ValueError(f"{log_base} is not supported.")
    basis = np.asarray(mel_filterbank(sampling_rate, fft_size, num_mels, fmin, fmax), np.float32)
    inv = torch.as_tensor(np.linalg.pinv(basis), dtype=torch.float32, device=log_mel.device)
    mag = torch.matmul(mel, inv.T).clamp(min=0.0)  # [T, n_bins]

    t_frames = log_mel.shape[0]
    length = length if length is not None else t_frames * hop_size
    # frame_signal gives 1 + wav_len // hop = t_frames frames: the magnitude grid
    wav_len = (t_frames - 1) * hop_size
    wav = _istft(mag.to(torch.complex64), fft_size, hop_size, wav_len)
    for _ in range(n_iter):
        spec = _stft_complex(wav, fft_size, hop_size)
        phase = spec / spec.abs().clamp(min=1e-8)
        wav = _istft(mag[: spec.shape[0]] * phase, fft_size, hop_size, wav_len)
    out = torch.zeros(length, dtype=torch.float32, device=log_mel.device)
    n = min(length, wav_len)
    out[:n] = wav[:n]
    return out
