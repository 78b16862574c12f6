"""jatts_torch.ops.pitch against jatts_tpu.ops.pitch on the CPU: the NCCF
f0 track (coarse and refined), the StoneMask-style refinement alone and
continuous_f0, on periodic signals, noise, silence and a signal shorter
than the analysis pad."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_tpu.ops import pitch as jpitch  # noqa: E402
from jatts_torch.ops import dsp as tdsp  # noqa: E402
from jatts_torch.ops import pitch as tpitch  # noqa: E402
from tests.test_f0_accuracy import _contour, synth_speechlike  # noqa: E402

SR, HOP = 24000, 300
F0 = dict(f0min=40.0, f0max=400.0)


def _tone(n, f=220.3):
    return (0.5 * np.sin(2 * np.pi * f * np.arange(n) / SR)).astype(np.float32)


PERIODIC = {
    "tone": lambda: _tone(SR // 2),
    "pulses": lambda: synth_speechlike(_contour("flat", SR // 2, 160), seed=1),
    "pulses_vibrato": lambda: synth_speechlike(_contour("vibrato", SR // 2, 90), seed=2),
    # 700 samples: shorter than the pad of frame_length // 2 = 1024, so the
    # reflect padding reflects again past the signal's ends
    "shorter_than_pad": lambda: _tone(700, 200.0),
}


def _both(wav, refine=False, **kw):
    kw = {**F0, **kw}
    want = np.asarray(jpitch.estimate_f0(jnp.asarray(wav), SR, HOP, refine=refine, **kw))
    got = tpitch.estimate_f0(torch.from_numpy(wav), SR, HOP, refine=refine, **kw).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (1 + len(wav) // HOP,)
    return got, want


@pytest.mark.parametrize("refine", [False, True], ids=["coarse", "refined"])
@pytest.mark.parametrize("name", list(PERIODIC))
def test_estimate_f0_periodic_matches_jax(name, refine):
    """The same voicing on every frame; f0 within 1e-3 relative of the JAX
    f0 (measured 3.5e-7: two f32 FFTs, the same peak, the same parabola),
    and within 1e-2 Hz after refinement."""
    got, want = _both(PERIODIC[name](), refine)
    np.testing.assert_array_equal(got > 0, want > 0)
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)
    if refine:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_reflect_pad_follows_numpy_past_the_signal():
    for n in (1, 2, 5, 700):
        x = np.arange(n, dtype=np.float32)
        for pad in (0, 1, n + 3, 3 * n + 1, 1024):
            np.testing.assert_array_equal(
                tdsp.reflect_pad(torch.from_numpy(x), pad).numpy(), np.pad(x, (pad, pad), mode="reflect")
            )


def _nccf_margins(wav, frame_length=2048, threshold=0.35):
    """Per frame (float64, the same framing): |NCCF peak - threshold| and
    the gap between the two largest NCCF values in the lag range."""
    n = 1 + len(wav) // HOP
    x = np.pad(wav.astype(np.float64), frame_length // 2, mode="reflect")
    frames = x[np.arange(n)[:, None] * HOP + np.arange(frame_length)[None]]
    frames = frames - frames.mean(1, keepdims=True)
    spec = np.fft.rfft(frames, n=2 * frame_length, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), n=2 * frame_length, axis=1)[:, :frame_length]
    nccf = ac / np.maximum(ac[:, :1], 1e-10)
    win = np.sort(nccf[:, int(SR / F0["f0max"]) : min(int(SR / F0["f0min"]), frame_length - 2) + 1], axis=1)
    return np.abs(win[:, -1] - threshold), win[:, -1] - win[:, -2]


@pytest.mark.parametrize("kind", ["white", "lowpass"])
def test_estimate_f0_noise_differs_only_at_ties(kind):
    """On noise the NCCF peak wanders around the voicing threshold and
    near-equal lags compete: a frame may differ only within one frame (the
    3-point median) of a frame whose peak lies within 1e-4 of the threshold
    or whose top two lags lie within 1e-4 of each other; at most 1% of
    frames differ."""
    rng = np.random.default_rng(3)
    wav = rng.standard_normal(3 * SR)
    if kind == "lowpass":  # an AR(1) colour puts many peaks near the threshold
        from scipy.signal import lfilter

        wav = lfilter([1.0], [1.0, -0.97], wav)
    wav = (0.3 * wav / np.abs(wav).max()).astype(np.float32)
    got, want = _both(wav)
    to_thr, gap = _nccf_margins(wav)
    ambiguous = (to_thr < 1e-4) | (gap < 1e-4)
    near = ambiguous | np.r_[ambiguous[1:], False] | np.r_[False, ambiguous[:-1]]
    differ = (got > 0) != (want > 0)
    both = (got > 0) & (want > 0)
    differ[both] |= np.abs(got[both] - want[both]) > 1e-3 * want[both]
    print(f"{kind} noise: {int(differ.sum())} of {len(got)} frames differ, "
          f"{int((want > 0).sum())} voiced, {int(ambiguous.sum())} ambiguous")
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert differ.sum() <= 0.01 * len(got)


def test_estimate_f0_silence_is_unvoiced():
    got, want = _both(np.zeros(SR // 4, np.float32), refine=True)
    assert not got.any() and not want.any()


@pytest.mark.parametrize("name", ["tone", "pulses_vibrato"])
def test_stonemask_refine_matches_jax(name):
    """The refinement alone, on the JAX coarse track with an unvoiced
    stretch cut in: refined f0 within 1e-2 Hz, unvoiced frames stay 0."""
    wav = PERIODIC[name]()
    coarse = np.array(jpitch.estimate_f0(jnp.asarray(wav), SR, HOP, **F0))
    coarse[10:14] = 0.0
    want = np.asarray(jpitch.stonemask_refine(jnp.asarray(wav), jnp.asarray(coarse), SR, HOP, f0min=40.0))
    got = tpitch.stonemask_refine(torch.from_numpy(wav), torch.from_numpy(coarse), SR, HOP, f0min=40.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert not got[10:14].any()
    assert (got != coarse).any()  # interior frames were refined


@pytest.mark.parametrize("f0", [
    [0, 0, 120.5, 0, 0, 130.25, 140.0, 0],
    [0, 0, 0],
    [100.0, 0, 0, 0, 200.0],
    [0, 0, 0, 150.0],
])
def test_continuous_f0_exact(f0):
    f0 = np.asarray(f0, np.float32)
    got = tpitch.continuous_f0(f0)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jpitch.continuous_f0(f0))
