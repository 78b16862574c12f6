"""jatts_torch.vocoder.vocoder against jatts_tpu.vocoder on the CPU: the
HiFi-GAN Vocoder on one parallel_wavegan-layout checkpoint with weight-norm
pairs, its stats renormalisation, and the Griffin-Lim vocoder."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_tpu.utils.io import write_hdf5  # noqa: E402
from jatts_tpu.vocoder import GriffinLimVocoder as JGriffinLimVocoder  # noqa: E402
from jatts_tpu.vocoder import Vocoder as JVocoder  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from jatts_torch.vocoder.vocoder import GriffinLimVocoder, Vocoder, fold_weight_norm  # noqa: E402

N_MELS = 8
GEN = dict(in_channels=N_MELS, channels=16, kernel_size=7, upsample_scales=[5, 4],
           upsample_kernel_sizes=[10, 8], resblock_kernel_sizes=[3, 7],
           resblock_dilations=[[1, 3], [1, 3]], use_additional_convs=True)


def _pwg_checkpoint(path, seed):
    """A parallel_wavegan pickle: ``{"model": {"generator": sd}}`` where
    every conv weight is a ``weight_g``/``weight_v`` pair (g over the first
    dimension, as torch's weight_norm keeps it), made from ``seed``."""
    rng = np.random.default_rng(seed)
    port = HiFiGANGenerator(**GEN, device="cpu")
    sd = {}
    for k, v in port.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith(".weight") and v.dim() == 3:
            base = k[: -len("weight")]
            sd[base + "weight_v"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            sd[base + "weight_g"] = torch.from_numpy(
                rng.uniform(0.2, 1.0, size=(shape[0], 1, 1)).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((0.1 * rng.normal(size=shape)).astype(np.float32))
    torch.save({"model": {"generator": sd, "discriminator": {}}, "steps": 7}, path)
    return sd


def _stats(tmp_path, rng):
    mean = rng.normal(size=N_MELS).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=N_MELS).astype(np.float32)
    h5 = str(tmp_path / "voc_stats.h5")
    write_hdf5(h5, "mean", mean)
    write_hdf5(h5, "scale", scale)
    npz = str(tmp_path / "voc_stats.npz")
    np.savez(npz, mean=mean, scale=scale)
    return h5, npz


@pytest.mark.parametrize("stats", [None, "h5", "npz"])
def test_vocoder_matches_jax(tmp_path, stats):
    """The same file through both packages: the waveform at
    tests/test_torch_hifigan.py's tolerance (rtol 1e-3, atol 1e-4), T * hop
    samples; the model stats denormalise and the vocoder stats (.h5 for
    both, or .npz for the port) renormalise."""
    rng = np.random.default_rng(0)
    ckpt = str(tmp_path / "checkpoint-7steps.pkl")
    _pwg_checkpoint(ckpt, 1)
    config = {"sampling_rate": 24000, "generator_params": GEN}
    h5, npz = _stats(tmp_path, rng)
    want_voc = JVocoder(ckpt, config, h5 if stats else None)
    got_voc = Vocoder(ckpt, config, {"h5": h5, "npz": npz}.get(stats), device="cpu")
    assert got_voc.hop_size == want_voc.hop_size == 20
    mel = rng.normal(size=(37, N_MELS)).astype(np.float32)
    m_mean = rng.normal(size=N_MELS).astype(np.float32)
    m_scale = rng.uniform(0.5, 2.0, size=N_MELS).astype(np.float32)
    want = want_voc.decode(mel, m_mean, m_scale)
    got = got_voc.decode(mel, m_mean, m_scale)
    assert got.shape == want.shape == (37 * 20,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_vocoder_renormalises_and_folds(tmp_path):
    """decode == the generator, with the pairs folded by hand, on
    ((mel * model_scale + model_mean) - mean) / scale, zero-padded to 64
    frames and cropped to T * hop."""
    rng = np.random.default_rng(2)
    ckpt = str(tmp_path / "g.pkl")
    sd = _pwg_checkpoint(ckpt, 3)
    _, npz = _stats(tmp_path, rng)
    voc = Vocoder(ckpt, {"generator_params": GEN}, npz, device="cpu")
    folded = fold_weight_norm(sd)
    k = "upsamples.1.1.weight"
    v, g = sd["upsamples.1.1.weight_v"], sd["upsamples.1.1.weight_g"]
    np.testing.assert_allclose(folded[k], g * v / v.flatten(1).norm(dim=1)[:, None, None], rtol=1e-6)
    assert not any(key.endswith(("weight_g", "weight_v")) for key in folded)
    gen = HiFiGANGenerator(**GEN, device="cpu")
    gen.load_state_dict(folded, strict=True)
    mel = rng.normal(size=(70, N_MELS)).astype(np.float32)
    m_mean, m_scale = np.float32(0.3), np.float32(1.7)
    x = ((mel * m_scale + m_mean) - np.load(npz)["mean"]) / np.load(npz)["scale"]
    x = np.pad(x, ((0, 128 - 70), (0, 0))).astype(np.float32)
    with torch.no_grad():
        want = gen(torch.from_numpy(x)[None])[0, : 70 * 20, 0].numpy()
    np.testing.assert_allclose(voc.decode(mel, m_mean, m_scale), want, rtol=1e-6, atol=1e-7)


def test_griffin_lim_vocoder_matches_jax():
    """Edge padding to 64 frames, crop to T * hop; one iteration within
    1e-3 * max|wav| of the JAX vocoder (tests/test_torch_dsp.py's
    tolerance for one iteration, where both packages' f32 still agree)."""
    config = {"sampling_rate": 24000, "fft_size": 1024, "hop_size": 256, "num_mels": 40,
              "fmin": 0, "fmax": 8000}
    rng = np.random.default_rng(4)
    mel = (rng.normal(size=(50, 40)) * 0.3).astype(np.float32)
    m_mean = rng.normal(size=40).astype(np.float32) - 2.0
    m_scale = np.full(40, 0.5, np.float32)
    want = JGriffinLimVocoder(config, n_iter=1).decode(mel, m_mean, m_scale)
    got = GriffinLimVocoder(config, n_iter=1, device="cpu").decode(mel, m_mean, m_scale)
    assert got.shape == want.shape == (50 * 256,)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
