"""The stage-1 front end and the Griffin-Lim inversion on the card against
the same calls on the CPU (marked ``cuda``: they skip without a card), and
the new entry points' default device. This file imports no jax and no flax,
so it runs where the card is:

    python -m pytest tests/test_torch_frontend_card.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.features.extractors import Dio, Energy  # noqa: E402
from jatts_torch.ops import dsp, pitch  # noqa: E402

SR, HOP = 24000, 300


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def pulses(f0_contour, seed=0, snr_db=25):
    """A glottal pulse train through a glottal resonator and three formants,
    plus noise (the known-truth signal of tests/test_f0_accuracy.py)."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    onsets = np.where(np.diff(np.floor(np.cumsum(f0_contour / SR))) > 0)[0]
    x = np.zeros(len(f0_contour))
    x[onsets] = 1.0 + 0.05 * rng.standard_normal(len(onsets))
    x = lfilter([1.0], [1, -1.95, 0.9506], x)
    for fc, bw in ((700, 130), (1220, 150), (2600, 200)):
        r = np.exp(-np.pi * bw / SR)
        x = lfilter([1.0], [1, -2 * r * np.cos(2 * np.pi * fc / SR), r * r], x)
    x = x / (np.abs(x).max() + 1e-9)
    noise = rng.standard_normal(len(x))
    noise *= np.sqrt((x**2).mean()) / np.sqrt((noise**2).mean()) * 10 ** (-snr_db / 20)
    return (x + noise).astype(np.float32)


SIGNALS = {
    "flat": lambda: pulses(np.full(SR, 160.0), seed=1),
    "vibrato": lambda: pulses(135.0 + 5.4 * np.sin(2 * np.pi * 5 * np.arange(SR) / SR), seed=2),
    "tone": lambda: (0.5 * np.sin(2 * np.pi * 220.3 * np.arange(SR // 2) / SR)).astype(np.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [False, True], ids=["coarse", "refined"])
@pytest.mark.parametrize("name", list(SIGNALS))
def test_estimate_f0_on_card_matches_cpu(name, refine):
    """The same voicing; f0 within 1e-3 relative (1e-2 Hz refined), the
    CPU tests' tolerances against the JAX package."""
    _card()
    wav = torch.from_numpy(SIGNALS[name]())
    got = pitch.estimate_f0(wav.cuda(), SR, HOP, refine=refine).cpu().numpy()
    want = pitch.estimate_f0(wav, SR, HOP, refine=refine).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)
    if refine:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


@pytest.mark.cuda
def test_stonemask_refine_on_card_matches_cpu():
    _card()
    wav = torch.from_numpy(SIGNALS["vibrato"]())
    coarse = pitch.estimate_f0(wav, SR, HOP)
    want = pitch.stonemask_refine(wav, coarse, SR, HOP).numpy()
    got = pitch.stonemask_refine(wav.cuda(), coarse.cuda(), SR, HOP).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_iter", [1, 32])
def test_griffin_lim_on_card_matches_cpu(n_iter):
    """Within 1e-3 * max|wav| after one iteration and 2e-2 after 32, the
    bounds tests/test_torch_dsp.py holds the CPU route to."""
    _card()
    log_mel = dsp.logmelfilterbank(torch.from_numpy(SIGNALS["flat"]()), SR, 2048, HOP, num_mels=80,
                                   fmin=80, fmax=7600)
    kw = dict(fft_size=2048, hop_size=HOP, num_mels=80, fmin=80.0, fmax=7600.0, n_iter=n_iter)
    want = dsp.griffin_lim(log_mel, SR, **kw).numpy()
    got = dsp.griffin_lim(log_mel.cuda(), SR, **kw).cpu().numpy()
    assert got.shape == want.shape == (log_mel.shape[0] * HOP,)
    assert np.abs(got - want).max() <= (1e-3 if n_iter == 1 else 2e-2) * np.abs(want).max()


@pytest.mark.cuda
def test_dio_and_energy_on_card_match_cpu():
    """Token-averaged log-f0 to 1e-3 on the same voicing, energy to 1e-4
    relative, as on the CPU against the JAX package."""
    _card()
    wav = SIGNALS["vibrato"]()
    n = 1 + len(wav) // HOP
    d = np.full(n // 4, 4)
    d[-1] += n - d.sum()
    kw = dict(fs=SR, n_fft=2048, hop_length=HOP, f0min=40.0, f0max=400.0)
    got = Dio(**kw, device="cuda")(wav, n, d)
    want = Dio(**kw, device="cpu")(wav, n, d)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    got = Energy(fs=SR, n_fft=2048, hop_length=HOP, device="cuda")(wav, n, d)
    want = Energy(fs=SR, n_fft=2048, hop_length=HOP, device="cpu")(wav, n, d)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_frontend_entry_points_default_to_cuda(tmp_path):
    """Without a card the new entry points raise before they read
    anything; nothing falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from jatts_torch.bin import preprocess, tts_decode
    from jatts_torch.vocoder.vocoder import GriffinLimVocoder

    for make in (lambda: Dio(), lambda: Energy(), lambda: GriffinLimVocoder({}),
                 lambda: preprocess.run("x.csv", {}, str(tmp_path)),
                 lambda: tts_decode.run("x.csv", "s.npz", "t.txt", {"model_type": "FastSpeech2"}, str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
