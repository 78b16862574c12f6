"""DTW-based objective metrics of tts1 stage 5 (counterpart of
jatts_tpu/evaluate/dtw_based.py; reference jatts/evaluate/dtw_based.py:17-78).

Mel-cepstra come from the WORLD-comparable analysis of ``world.py``
(CheapTrick + SPTK sp2mc, 39-dim, alpha 0.466, 5 ms shift, fft 1024), so
MCD is on the tech report's scale. The procedure is the reference's: the
power VAD (-20 dB against the mean) before the MCD DTW, c0 in the
distance, the voiced frames' mcep DTW reused for the F0 metrics, and DDUR
from energy-trimmed waveform lengths. f0 comes from the NCCF estimator
rather than WORLD harvest, and the DTW is an exact full DP rather than
fastdtw's approximation. The DCT-of-log-mel cepstra stay available as
``mcep_method="dct"`` for cheap smoke runs.

The work splits in two: ``device_features`` runs on the device (the f0
track; for ``dct`` the log-mel too), and ``calculate_mcd_f0`` given those
features runs numpy and scipy only. So a pool of worker processes can do
the host part while one process owns the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from jatts_torch.evaluate.world import extfrm, world_extract, world_f0

MCEP_METHODS = ("world", "dct")


def trim_silence_samples(
    x: np.ndarray, top_db: float = 60.0, frame: int = 2048, hop: int = 512
) -> int:
    """librosa.effects.trim-style energy trim -> number of kept samples
    (reference dtw_based.py:66-69 uses librosa defaults).

    Matches librosa semantics: CENTERED rms frames (frame i spans
    i*hop ± frame/2 over a zero-padded signal) and kept interval
    [keep[0]*hop, (keep[-1]+1)*hop) — an uncentered end of
    keep[-1]*hop+frame overestimates each trim by frame-hop samples,
    which biases DDUR when only one of the two signals has trailing
    silence."""
    if len(x) == 0:
        return 0
    pad = frame // 2
    xp = np.concatenate([np.zeros(pad), np.asarray(x, np.float64), np.zeros(pad)])
    n = 1 + (len(xp) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt((xp[idx] ** 2).mean(axis=1) + 1e-12)
    db = 20.0 * np.log10(rms / max(rms.max(), 1e-12))
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return 0
    start = keep[0] * hop
    end = min((keep[-1] + 1) * hop, len(x))
    return max(end - start, 0)


def _dct_extract(x, fs, f0min, f0max, mcep_dim=39, n_fft=1024, n_shift=256, device=None):
    """DCT-of-log-mel cepstra (cheap, NOT on the reference's mcep scale),
    on ``device``."""
    import scipy.fftpack
    import torch

    from jatts_torch.device import resolve_device
    from jatts_torch.ops.dsp import logmelfilterbank
    from jatts_torch.ops.pitch import estimate_f0

    # float32 audio, as ``jnp.asarray`` makes it with x64 off
    audio = torch.from_numpy(np.asarray(x, np.float32)).to(resolve_device(device))
    with torch.no_grad():
        mel = logmelfilterbank(
            audio, fs, fft_size=n_fft, hop_size=n_shift,
            num_mels=80, fmin=f0min, fmax=fs / 2, log_base=None,
        ).cpu().numpy()
        f0 = estimate_f0(audio, fs, n_shift, f0min=f0min, f0max=f0max).cpu().numpy()
    mcep = scipy.fftpack.dct(mel, type=2, axis=1, norm="ortho")[:, : mcep_dim + 1]
    n = min(len(mcep), len(f0))
    npow = 10.0 * (mel[:n].mean(axis=1) - mel.mean()) / np.log(10.0)
    return {"mcep": mcep[:n], "f0": f0[:n], "npow": npow}


def device_features(
    x: np.ndarray,
    fs: int,
    f0min: float = 40.0,
    f0max: float = 800.0,
    mcep_method: str = "world",
    device=None,
) -> Dict[str, np.ndarray]:
    """The part of one signal's analysis that runs on ``device``: the f0
    track for ``world``, the whole features for ``dct``."""
    if mcep_method == "world":
        return {"f0": world_f0(x, fs, f0min, f0max, device)}
    if mcep_method == "dct":
        return _dct_extract(x, fs, f0min, f0max, device=device)
    raise ValueError(f"mcep_method must be one of {MCEP_METHODS}, got {mcep_method!r}")


def _features(x, fs, f0min, f0max, mcep_method, device, pre):
    if pre is None:
        pre = device_features(x, fs, f0min, f0max, mcep_method, device)
    if mcep_method == "world":
        return world_extract(x, fs, f0min, f0max, f0=pre["f0"])
    return pre


def dtw_path(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Full-DP DTW with Euclidean local distance -> aligned index pairs
    (exact variant of the reference's fastdtw). Vectorized anti-diagonal
    sweep keeps it O(T^2) numpy ops, not python loops."""
    t1, t2 = len(x), len(y)
    dist = np.sqrt(
        np.maximum(
            (x**2).sum(1)[:, None] - 2 * x @ y.T + (y**2).sum(1)[None, :], 0.0
        )
    )
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    # anti-diagonal wavefront: cells (i, j) with i+j = d depend only on d-1, d-2
    for d in range(2, t1 + t2 + 1):
        i_lo = max(1, d - t2)
        i_hi = min(t1, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        best = np.minimum(acc[i - 1, j - 1], np.minimum(acc[i - 1, j], acc[i, j - 1]))
        acc[i, j] = dist[i - 1, j - 1] + best
    i, j = t1, t2
    path = []
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        choices = [
            (acc[i - 1, j - 1], i - 1, j - 1),
            (acc[i - 1, j], i - 1, j),
            (acc[i, j - 1], i, j - 1),
        ]
        _, i, j = min(choices, key=lambda c: c[0])
    path.reverse()
    idx = np.asarray(path)
    return idx[:, 0], idx[:, 1]


def calculate_mcd_f0(
    x: np.ndarray,
    y: np.ndarray,
    fs: int,
    f0min: float = 40.0,
    f0max: float = 800.0,
    mcep_method: str = "world",
    device=None,
    precomputed: Optional[Sequence[Dict[str, np.ndarray]]] = None,
) -> Dict[str, float]:
    """MCD / F0RMSE / F0CORR / DDUR between generated ``x`` and reference
    ``y`` (reference dtw_based.py:17-78; x, y in [-1, 1]).
    ``precomputed``: ``device_features`` of (x, y) computed beforehand;
    then no torch runs."""
    pre_x, pre_y = precomputed if precomputed is not None else (None, None)
    gen = _features(x, fs, f0min, f0max, mcep_method, device, pre_x)
    gt = _features(y, fs, f0min, f0max, mcep_method, device, pre_y)

    # --- MCD on power-VAD frames (c0 included, as the reference does)
    gen_mcep = extfrm(gen["mcep"], gen["npow"])
    gt_mcep = extfrm(gt["mcep"], gt["npow"])
    if len(gen_mcep) < 2 or len(gt_mcep) < 2:
        return {
            "mcd": float("nan"), "f0rmse": float("nan"),
            "f0corr": float("nan"), "ddur": float("nan"),
        }
    gi, ri = dtw_path(gen_mcep, gt_mcep)
    diff2sum = ((gen_mcep[gi] - gt_mcep[ri]) ** 2).sum(axis=1)
    mcd = float(np.mean(10.0 / np.log(10.0) * np.sqrt(2.0 * diff2sum)))

    # --- F0 metrics: DTW the voiced-frame mceps, apply the path to f0
    # (reference dtw_based.py:41-56)
    gen_vidx = np.where(gen["f0"] > 0)[0]
    gt_vidx = np.where(gt["f0"] > 0)[0]
    if len(gen_vidx) > 1 and len(gt_vidx) > 1:
        fi, fj = dtw_path(gen["mcep"][gen_vidx], gt["mcep"][gt_vidx])
        a = gen["f0"][gen_vidx][fi]
        b = gt["f0"][gt_vidx][fj]
        f0rmse = float(np.sqrt(np.mean((a - b) ** 2)))
        f0corr = float(np.corrcoef(a, b)[0, 1]) if len(a) > 1 else float("nan")
    else:
        f0rmse, f0corr = float("nan"), float("nan")

    # --- DDUR: energy-trimmed waveform length difference in seconds
    ddur = float(
        abs(trim_silence_samples(x) - trim_silence_samples(y)) / fs
    )
    return {"mcd": mcd, "f0rmse": f0rmse, "f0corr": f0corr, "ddur": ddur}
