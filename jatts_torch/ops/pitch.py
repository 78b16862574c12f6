"""F0 estimation on the device (counterpart of jatts_tpu/ops/pitch.py).

Stage 1, the coarse track: frame-wise normalized autocorrelation (NCCF)
computed with FFTs:

  frame -> remove DC -> FFT autocorrelation -> normalize by energy ->
  restrict lag to [sr/f0max, sr/f0min] -> peak + parabolic interpolation ->
  voicing decision (NCCF threshold) -> 3-point median.

Stage 2, opt-in (``refine=True``): a StoneMask-style refinement. Per frame,
a Blackman window sized 3/f0 is centered on the frame; the instantaneous
frequency at each harmonic of the coarse estimate comes from two windowed
DFTs (the window and its analytic derivative) evaluated at the exact
harmonic frequencies, in two passes (2 harmonics, then 6), and the refined
f0 is the amplitude-weighted mean of if_k / k. Implausible refinements and
frames whose window hangs off the signal keep the coarse value.

Frames are ``unfold`` views of a numpy-style reflect-padded signal (see
``ops/dsp.py:reflect_pad``); ``argmax`` takes the first of equal peaks, as
the JAX package's does. The harmonic phases reach ~700 rad in f32, so they
go through ``torch.sin``/``torch.cos``, the accurate functions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jatts_torch.ops.dsp import frames_of, reflect_pad


def stonemask_refine(
    audio: torch.Tensor,
    f0: torch.Tensor,
    fs: int,
    hop: int,
    f0min: float = 40.0,
    n_harmonics: int = 6,
) -> torch.Tensor:
    """Refine a coarse f0 track by harmonic instantaneous frequency.
    ``audio [T], f0 [n_frames] (0 = unvoiced) -> refined f0 [n_frames]``.
    Frame i is centered on sample ``i * hop``."""
    dev = audio.device
    n_frames = f0.shape[0]
    half = int(1.5 * fs / f0min) + 1  # the 3/f0 window's reach at f0min
    # reflect (not zero) padding keeps pseudo-periodic structure at the edges
    x = reflect_pad(audio.float(), half)
    seg = frames_of(x, n_frames, 2 * half + 1, hop)  # [N, L]
    centers = torch.arange(n_frames, device=dev) * hop
    t = (torch.arange(2 * half + 1, device=dev) - half) / fs  # [L] seconds

    f0 = f0.float()
    voiced = f0 > 0
    f0safe = torch.where(voiced, f0.clamp(min=f0min), torch.full_like(f0, 100.0))
    w_dur = 3.0 / f0safe  # Blackman support [-1.5/f0, 1.5/f0]
    phase = 2.0 * math.pi * t[None, :] / w_dur[:, None]  # [N, L]
    in_win = t.abs()[None, :] <= (1.5 / f0safe)[:, None]
    zero = torch.zeros((), device=dev)
    win = torch.where(in_win, 0.42 + 0.5 * torch.cos(phase) + 0.08 * torch.cos(2 * phase), zero)
    dwin = torch.where(  # d(win)/dt [1/s]
        in_win,
        -(2.0 * math.pi / w_dur[:, None]) * (0.5 * torch.sin(phase) + 0.16 * torch.sin(2 * phase)),
        zero,
    )
    xw = seg * win
    xdw = seg * dwin

    def fix_f0(base: torch.Tensor, n_harm: int) -> torch.Tensor:
        """Amplitude-weighted mean of if_k / k over the first ``n_harm``
        harmonics of ``base`` [N]; the window stays the one sized by the
        initial estimate."""
        num = torch.zeros_like(base)
        den = torch.zeros_like(base)
        for k in range(1, n_harm + 1):
            freq = float(k) * base
            ang = 2.0 * math.pi * freq[:, None] * t[None, :]
            c, s = torch.cos(ang), torch.sin(ang)
            # S(f) = sum x e^{-j 2 pi f t}: re = sum x c, im = -sum x s
            re_m = (xw * c).sum(dim=1)
            im_m = -(xw * s).sum(dim=1)
            re_d = (xdw * c).sum(dim=1)
            im_d = -(xdw * s).sum(dim=1)
            power = re_m * re_m + im_m * im_m
            # x(t) = A e^{j 2 pi f0 t}: Im(S_w' conj(S_w)) = 2 pi (f - f0) |S_w|^2
            f_inst = freq - (im_d * re_m - re_d * im_m) / (2.0 * math.pi * power.clamp(min=1e-20))
            amp = power.clamp(min=0.0).sqrt()
            ok = freq < 0.5 * fs  # harmonics above Nyquist contribute nothing
            num = num + torch.where(ok, amp, zero) * torch.where(ok, f_inst, zero)
            den = den + torch.where(ok, amp, zero) * float(k)
        return num / den.clamp(min=1e-12)

    # a 2-harmonic pass re-centers the comb, then the full pass
    tentative = fix_f0(f0safe, 2)
    tentative_ok = (tentative > 0.0) & (tentative <= 2.0 * f0safe)
    tentative = torch.where(tentative_ok, tentative, f0safe)
    refined = fix_f0(tentative, n_harmonics)
    ok = tentative_ok & ((refined - f0safe).abs() <= 0.2 * f0safe)
    # frames whose window hangs off the signal see reflected samples: keep
    # the coarse value there
    margin = 1.5 * fs / f0safe
    cf = centers.float()
    interior = (cf >= margin) & (cf <= audio.shape[0] - 1 - margin)
    refined = torch.where(ok & interior, refined, f0safe)
    return torch.where(voiced, refined, zero)


def estimate_f0(
    audio: torch.Tensor,
    fs: int,
    hop: int,
    frame_length: int = 2048,
    f0min: float = 40.0,
    f0max: float = 400.0,
    threshold: float = 0.35,
    refine: bool = False,
) -> torch.Tensor:
    """``[T] -> [n_frames]`` f0 in Hz, 0 for unvoiced, on the audio's
    device; n_frames = 1 + T // hop (the mel frame count). ``refine=True``
    applies the StoneMask stage to the coarse track."""
    dev = audio.device
    n_frames = 1 + audio.shape[0] // hop
    x = reflect_pad(audio.float(), frame_length // 2)
    frames = frames_of(x, n_frames, frame_length, hop)  # [N, L]
    frames = frames - frames.mean(dim=1, keepdim=True)

    # FFT autocorrelation
    nfft = 2 * frame_length
    spec = torch.fft.rfft(frames, n=nfft, dim=1)
    ac = torch.fft.irfft(spec * spec.conj(), n=nfft, dim=1)[:, :frame_length]
    ac0 = ac[:, :1].clamp(min=1e-10)
    nccf = ac / ac0

    lag_min = int(fs / f0max)
    lag_max = min(int(fs / f0min), frame_length - 2)
    window = nccf[:, lag_min : lag_max + 1]  # [N, L_range]
    best = torch.argmax(window, dim=1)  # the first of equal peaks
    peak = window.gather(1, best[:, None])[:, 0]

    # parabolic interpolation around the peak
    last = window.shape[1] - 1
    y0 = window.gather(1, (best - 1).clamp(0, last)[:, None])[:, 0]
    y2 = window.gather(1, (best + 1).clamp(0, last)[:, None])[:, 0]
    denom = y0 - 2 * peak + y2
    zero = torch.zeros((), device=dev)
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (y0 - y2) / denom, zero).clamp(-0.5, 0.5)
    lag = (best + lag_min).float() + delta

    f0 = fs / lag.clamp(min=1.0)
    voiced = (peak > threshold) & (ac0[:, 0] > 1e-6)
    f0 = torch.where(voiced, f0, zero)

    # 3-point median smoothing against octave spikes
    f0_pad = torch.cat([f0[:1], f0, f0[-1:]])
    f0 = torch.stack([f0_pad[:-2], f0_pad[1:-1], f0_pad[2:]]).median(dim=0).values
    if refine:
        f0 = stonemask_refine(audio, f0, fs, hop, f0min=f0min)
    return f0


def continuous_f0(f0: np.ndarray) -> np.ndarray:
    """Linear interpolation over unvoiced frames (numpy, float64)."""
    f0 = np.asarray(f0, dtype=np.float64).copy()
    if (f0 == 0).all():
        return f0
    nz = np.nonzero(f0)[0]
    f0[: nz[0]] = f0[nz[0]]
    f0[nz[-1] :] = f0[nz[-1]]
    nz = np.nonzero(f0)[0]
    f0 = np.interp(np.arange(len(f0)), nz, f0[nz])
    return f0
