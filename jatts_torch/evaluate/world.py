"""WORLD-comparable spectral analysis for objective evaluation (counterpart
of jatts_tpu/evaluate/world.py).

MCD is computed on mel-cepstra from a CheapTrick envelope and SPTK's
sp2mc (order 39, alpha 0.466, 5 ms shift, fft 1024), re-implemented in
float64 numpy:

- ``cheaptrick``: WORLD's pitch-adaptive spectral envelope (Morise 2015):
  a 3*T0 Hanning window with DC removal, the power spectrum with DC
  correction below f0, rectangular smoothing of width 2f0/3, and q1=-0.15
  liftering with sinc recovery; a loop over frames.
- ``sp2mc`` / ``mc2sp``: the one-sided real cepstrum of log |H|^2 (c0
  halved) warped by the all-pass ``freqt`` recursion, and its inverse.
- ``spc2npow`` / ``extfrm``: the power VAD that picks MCD's frames.

The f0 that places the pitch-adaptive window comes from the port's NCCF
estimator (``ops/pitch.py:estimate_f0``) on the caller's device, fed the
float32 audio that the JAX package's estimator is fed. Everything else is
numpy and scipy, and this module imports torch only inside
``world_f0``: ``world_extract`` given an ``f0`` runs in a process that
never touches the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.signal import firwin, lfilter

MCEP_DIM = 39
MCEP_ALPHA = 0.466
MCEP_SHIFT_MS = 5
MCEP_FFTL = 1024
_Q1 = -0.15
_DEFAULT_F0 = 500.0


def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70.0) -> np.ndarray:
    """255-tap FIR high-pass (reference signal.py:12-29)."""
    nyquist = fs // 2
    fil = firwin(255, cutoff / nyquist, pass_zero=False)
    return lfilter(fil, 1, x)


# ---------------------------------------------------------------------------
# CheapTrick
# ---------------------------------------------------------------------------


def _windowed_waveform(x: np.ndarray, fs: int, f0: float, center: int) -> np.ndarray:
    """3*T0 Hanning-windowed segment around ``center`` with DC removal
    (WORLD GetWindowedWaveform)."""
    half = int(round(1.5 * fs / f0))
    base = np.arange(-half, half + 1)
    idx = np.clip(center + base, 0, len(x) - 1)
    window = 0.5 * np.cos(np.pi * base * f0 / (1.5 * fs)) + 0.5
    seg = x[idx] * window
    # remove window-weighted DC so the spectrum's 0 Hz bin is clean
    seg -= window * (seg.sum() / max(window.sum(), 1e-12))
    return seg


def _dc_correction(power: np.ndarray, f0: float, fs: int, fft_size: int) -> np.ndarray:
    """Mirror the spectrum below f0 back onto the low bins (WORLD
    DCCorrection): bins under f0 get the values at (f0 - f) added."""
    freq = np.arange(fft_size // 2 + 1) * fs / fft_size
    upper = int(f0 * fft_size / fs) + 1
    mirror = np.interp(f0 - freq[:upper], freq, power)
    out = power.copy()
    out[:upper] += mirror
    return out


def _linear_smoothing(power: np.ndarray, width: float, fs: int, fft_size: int) -> np.ndarray:
    """Rectangular smoothing of the power spectrum over ``width`` Hz (WORLD
    LinearSmoothing), via cumulative integration of a mirrored extension."""
    half = fft_size // 2
    boundary = int(width * fft_size / fs) + 1
    # mirrored extension (WORLD mirrors both ends)
    # right-edge mirror around the last bin: power[-2], power[-3], ...,
    # power[-1-boundary] (the boundary>1 case was off by one, starting at
    # power[-3] — caught by a brute-force mirrored-smoothing comparison)
    ext = np.concatenate([power[1 : boundary + 1][::-1], power, power[-1 - boundary : -1][::-1]])
    # ensure long enough
    while len(ext) < half + 1 + 2 * boundary:
        ext = np.concatenate([ext, ext[-1:]])
    offset = boundary
    cum = np.concatenate([[0.0], np.cumsum(ext)])
    df = fs / fft_size
    w_bins = width / df
    lo = np.arange(half + 1) + offset - w_bins / 2.0
    hi = lo + w_bins
    # fractional-bin integral of the piecewise-constant extension
    def frac_cum(pos):
        i = np.clip(np.floor(pos).astype(int), 0, len(ext) - 1)
        frac = pos - np.floor(pos)
        return cum[i] + ext[i] * frac

    out = (frac_cum(hi) - frac_cum(lo)) / w_bins
    return np.maximum(out, 1e-12)


def _smoothing_with_recovery(log_power: np.ndarray, f0: float, fs: int, fft_size: int) -> np.ndarray:
    """Cepstral liftering: sinc smoothing lifter * q1 compensation lifter
    (WORLD SmoothingWithRecovery); returns the spectral envelope |H|^2."""
    half = fft_size // 2
    full = np.concatenate([log_power, log_power[-2:0:-1]])
    cep = np.fft.ifft(full).real
    q = np.arange(fft_size) / fs
    q[fft_size // 2 + 1 :] = (fft_size - np.arange(fft_size // 2 + 1, fft_size)) / fs
    with np.errstate(divide="ignore", invalid="ignore"):
        smoothing = np.sin(np.pi * f0 * q) / (np.pi * f0 * q)
    smoothing[0] = 1.0
    compensation = (1.0 - 2.0 * _Q1) + 2.0 * _Q1 * np.cos(2.0 * np.pi * q * f0)
    cep = cep * smoothing * compensation
    log_env = np.fft.fft(cep).real
    return np.exp(log_env[: half + 1])


def cheaptrick(
    x: np.ndarray,
    f0: np.ndarray,
    temporal_positions: np.ndarray,
    fs: int,
    fft_size: int = MCEP_FFTL,
) -> np.ndarray:
    """Pitch-adaptive spectral envelope ``[T, fft_size//2+1]`` (power).

    Faithful numpy port of WORLD CheapTrick's algorithm; unvoiced frames
    (f0 below the fft-size lower limit) use the 500 Hz default like WORLD.
    """
    f0_low_limit = fs * 3.0 / (fft_size - 3.0)
    out = np.empty((len(f0), fft_size // 2 + 1))
    for i, (cf0, pos) in enumerate(zip(f0, temporal_positions)):
        cur = _DEFAULT_F0 if cf0 <= f0_low_limit else float(cf0)
        center = int(round(pos * fs + 0.001))
        seg = _windowed_waveform(x, fs, cur, center)
        spec = np.abs(np.fft.rfft(seg, fft_size)) ** 2
        spec = _dc_correction(spec, cur, fs, fft_size)
        spec = _linear_smoothing(spec, cur * 2.0 / 3.0, fs, fft_size)
        out[i] = _smoothing_with_recovery(np.log(spec + 1e-30), cur, fs, fft_size)
    return out


# ---------------------------------------------------------------------------
# SPTK mel-cepstrum conversion
# ---------------------------------------------------------------------------


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """All-pass frequency transform of (batched) cepstra
    (SPTK freqt; c: [..., M1+1] -> [..., order+1])."""
    c = np.asarray(c, dtype=np.float64)
    batch = c.shape[:-1]
    wc = np.zeros(batch + (order + 1,))
    for k in range(c.shape[-1] - 1, -1, -1):
        prev = wc.copy()
        wc[..., 0] = c[..., k] + alpha * prev[..., 0]
        if order >= 1:
            wc[..., 1] = (1.0 - alpha * alpha) * prev[..., 0] + alpha * prev[..., 1]
        for m in range(2, order + 1):
            wc[..., m] = prev[..., m - 1] + alpha * (prev[..., m] - wc[..., m - 1])
    return wc


def sp2mc(powerspec: np.ndarray, order: int = MCEP_DIM, alpha: float = MCEP_ALPHA) -> np.ndarray:
    """Power spectrum ``[..., H]`` -> mel-cepstrum ``[..., order+1]``
    (pysptk.sp2mc semantics: log -> one-sided real cepstrum, c0 halved ->
    freqt warping)."""
    logp = np.log(np.maximum(powerspec, 1e-30))
    c = np.fft.irfft(logp, axis=-1)  # [..., fftl], symmetric
    half = powerspec.shape[-1] - 1
    c = c[..., : half + 1].copy()
    c[..., 0] *= 0.5
    return freqt(c, order, alpha)


def mc2sp(mc: np.ndarray, alpha: float, fftlen: int) -> np.ndarray:
    """Inverse of sp2mc (round-trip tested): mel-cepstrum -> power spectrum
    ``[..., fftlen//2+1]``."""
    half = fftlen // 2
    c = freqt(mc, half, -alpha)
    c[..., 0] *= 2.0
    sym = np.concatenate([c, c[..., -2:0:-1]], axis=-1)
    logp = np.fft.fft(sym, axis=-1).real[..., : half + 1]
    return np.exp(logp)


# ---------------------------------------------------------------------------
# power VAD (reference signal.py:31-104, exact)
# ---------------------------------------------------------------------------


def spc2npow(spectrogram: np.ndarray) -> np.ndarray:
    """Normalized frame power in dB relative to the utterance mean
    (reference spc2npow/_spvec2pow, signal.py:31-75)."""
    sp = np.asarray(spectrogram, dtype=np.float64)
    fftl2 = sp.shape[-1] - 1
    power = (sp[..., 0] + sp[..., fftl2] + 2.0 * sp[..., 1:fftl2].sum(axis=-1)) / (
        2 * fftl2
    )
    return 10.0 * np.log10(power / power.mean())


def extfrm(data: np.ndarray, npow: np.ndarray, power_threshold: float = -20.0) -> np.ndarray:
    """Keep frames with npow above threshold (reference signal.py:78-104)."""
    return data[npow > power_threshold]


def _low_cut_scaled(x: np.ndarray, fs: int) -> np.ndarray:
    """The analysis signal: int16-scaled float64 audio through the
    high-pass filter."""
    return low_cut_filter(np.asarray(x, dtype=np.float64) * np.iinfo(np.int16).max, fs)


def _n_frames(n_samples: int, fs: int) -> int:
    return n_samples // int(fs * MCEP_SHIFT_MS / 1000) + 1


def world_f0(
    x: np.ndarray,
    fs: int,
    f0min: float = 40.0,
    f0max: float = 800.0,
    device=None,
) -> np.ndarray:
    """The f0 track ``world_extract`` places its windows with: float32 Hz,
    one value per 5 ms frame, computed on ``device`` (default the card)."""
    return _f0_of_filtered(_low_cut_scaled(x, fs), fs, f0min, f0max, device)


def _f0_of_filtered(xf: np.ndarray, fs: int, f0min: float, f0max: float, device) -> np.ndarray:
    import torch

    from jatts_torch.device import resolve_device
    from jatts_torch.ops.pitch import estimate_f0

    hop = int(fs * MCEP_SHIFT_MS / 1000)
    n_frames = _n_frames(len(xf), fs)
    # the JAX package's estimator is fed ``jnp.asarray(x / int16max)``,
    # float32 with x64 off: the same values here
    audio = torch.from_numpy((xf / np.iinfo(np.int16).max).astype(np.float32))
    with torch.no_grad():
        f0 = estimate_f0(audio.to(resolve_device(device)), fs, hop, f0min=f0min, f0max=f0max)
    f0 = f0.cpu().numpy()[:n_frames]
    if len(f0) < n_frames:
        f0 = np.pad(f0, (0, n_frames - len(f0)))
    return f0


def world_extract(
    x: np.ndarray,
    fs: int,
    f0min: float = 40.0,
    f0max: float = 800.0,
    device=None,
    f0: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """mcep/f0/npow at 5 ms shift (the reference's world_extract with
    harvest replaced by the NCCF estimator). ``f0``, when given, is
    ``world_f0``'s track computed beforehand, and then no torch runs."""
    xf = _low_cut_scaled(x, fs)
    n_frames = _n_frames(len(xf), fs)
    if f0 is None:
        f0 = _f0_of_filtered(xf, fs, f0min, f0max, device)
    if len(f0) != n_frames:
        raise ValueError(f"f0 has {len(f0)} frames, the signal {n_frames}")
    # positions at the INTEGER hop the f0 estimator frames with: exact
    # i*5 ms drifts from i*hop samples when fs % 200 != 0
    hop = int(fs * MCEP_SHIFT_MS / 1000)
    positions = np.arange(n_frames) * (hop / fs)
    sp = cheaptrick(xf, f0, positions, fs, MCEP_FFTL)
    mcep = sp2mc(sp, MCEP_DIM, MCEP_ALPHA)
    npow = spc2npow(sp)
    return {"sp": sp, "mcep": mcep, "f0": f0, "npow": npow}
