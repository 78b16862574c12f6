"""jatts_torch.features.extractors Dio and Energy against the JAX package's
extractors on the CPU: frame-level (with ``feat_length``) and token-averaged
(with durations), on speech-like pulse trains with unvoiced stretches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_tpu.features import extractors as jext  # noqa: E402
from jatts_torch.features import extractors as text  # noqa: E402
from tests.test_f0_accuracy import synth_speechlike  # noqa: E402

SR, HOP, N_FFT = 24000, 300, 2048


def _utterance(seed, n_frames):
    """A pulse train whose f0 glides 110 -> 180 Hz, with two unvoiced
    stretches (noise), ``(n_frames - 1) * HOP + 17`` samples long."""
    n = (n_frames - 1) * HOP + 17
    c = np.linspace(110.0, 180.0, n)
    c[int(0.2 * n) : int(0.3 * n)] = 0.0
    c[int(0.7 * n) : int(0.75 * n)] = 0.0
    return synth_speechlike(c, seed=seed)


def _durations(n_frames, n_tokens, seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, n_frames), n_tokens - 1, replace=False))
    return np.diff(np.concatenate([[0], cuts, [n_frames]]))


@pytest.mark.parametrize("mode", ["frames", "feat_length_pad", "feat_length_crop", "tokens"])
def test_dio_matches_jax(mode):
    """Log continuous f0: 1e-3 absolute (a relative 1e-3 in f0, the
    periodic-signal tolerance of tests/test_torch_pitch.py), on the same
    voicing; token means of the voiced frames to the same."""
    wav = _utterance(0, 90)
    kw = dict(fs=SR, n_fft=N_FFT, hop_length=HOP, f0min=40.0, f0max=400.0)
    call = {"frames": {}, "feat_length_pad": dict(feat_length=93),
            "feat_length_crop": dict(feat_length=88),
            "tokens": dict(feat_length=90, durations=_durations(90, 17, 1))}[mode]
    want = jext.Dio(**kw)(wav, **call)
    got = text.Dio(**kw, device="cpu")(wav, **call)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((17,) if mode == "tokens" else (call.get("feat_length", 90),))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_dio_raw_f0_and_reduction_factor():
    """Without continuity or log the unvoiced frames stay 0 (the same ones);
    with reduction factor 2 the token averages span twice the frames."""
    wav = _utterance(1, 64)
    kw = dict(fs=SR, n_fft=N_FFT, hop_length=HOP, use_continuous_f0=False, use_log_f0=False)
    want = jext.Dio(**kw)(wav)
    got = text.Dio(**kw, device="cpu")(wav)
    np.testing.assert_array_equal(got > 0, want > 0)
    assert (got == 0).any() and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)
    d = _durations(32, 8, 2)
    kw = dict(fs=SR, n_fft=N_FFT, hop_length=HOP, reduction_factor=2)
    np.testing.assert_allclose(text.Dio(**kw, device="cpu")(wav, 64, d), jext.Dio(**kw)(wav, 64, d),
                               rtol=0, atol=1e-3)
    with pytest.raises(ValueError):  # the frames overhang the durations by more than r
        text.Dio(**kw, device="cpu")(wav, 64, d[:-1])


@pytest.mark.parametrize("mode", ["frames", "feat_length_pad", "tokens"])
def test_energy_matches_jax(mode):
    """Frame energy to 1e-4 relative (the |STFT| tolerance of
    tests/test_torch_dsp.py::test_energy_matches_jax), token means too."""
    wav = _utterance(2, 80)
    call = {"frames": {}, "feat_length_pad": dict(feat_length=84),
            "tokens": dict(feat_length=80, durations=_durations(80, 13, 3))}[mode]
    kw = dict(fs=SR, n_fft=N_FFT, hop_length=HOP)
    want = jext.Energy(**kw)(wav, **call)
    got = text.Energy(**kw, device="cpu")(wav, **call)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((13,) if mode == "tokens" else (call.get("feat_length", 80),))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
