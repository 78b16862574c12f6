"""jatts_torch/vocoder/streaming.py against the port's whole-utterance
HiFi-GAN and against jatts_tpu/vocoder/streaming.py on the same weights
(carried by ``utils/convert.py``), on the CPU in f32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.vocoder import streaming as jstreaming  # noqa: E402
from jatts_tpu.vocoder.hifigan import HiFiGANGenerator as JHiFiGAN  # noqa: E402
from jatts_torch.utils.convert import hifigan_state_dict_from_jax  # noqa: E402
from jatts_torch.vocoder import streaming  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

SMALL = dict(in_channels=8, channels=32, upsample_scales=(4, 3), upsample_kernel_sizes=(8, 6),
             resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3)))
T = 50


@pytest.fixture(autouse=True)
def one_thread():
    """torch's intra-op threads capped at 1 for each test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """The JAX generator with numpy-made weights, the port's on the same
    weights, and a mel [2, T, 8]."""
    jvoc = JHiFiGAN(**SMALL)
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(2, T, 8)).astype(np.float32)
    variables = randomize(jvoc.init(jax.random.key(0), jnp.asarray(mel)), 1)
    voc = HiFiGANGenerator(**SMALL, device="cpu")
    voc.load_state_dict(hifigan_state_dict_from_jax(variables), strict=True)
    return jvoc, variables, voc, mel


@pytest.mark.parametrize("kw", [{}, SMALL], ids=["shipped", "small"])
def test_context_and_hop_equal_the_jax_ones(kw):
    port, jax_voc = HiFiGANGenerator(**kw, device="cpu"), JHiFiGAN(**kw)
    assert streaming.min_context_frames(port) == jstreaming.min_context_frames(jax_voc)
    assert streaming.hop_size(port) == jstreaming.hop_size(jax_voc) == port.hop_size
    assert streaming._resblock_context(port) == jstreaming._resblock_context(jax_voc)


def test_hparams_rebuild_the_generator(small):
    voc = small[2]
    again = HiFiGANGenerator(**voc.hparams(), device="cpu")
    again.load_state_dict(voc.state_dict(), strict=True)
    mel = torch.from_numpy(small[3])
    with torch.no_grad():
        assert torch.equal(again(mel), voc(mel))


@pytest.mark.parametrize("chunk", [16, 50, 64])  # interior windows / exactly one / one short
def test_chunks_equal_the_whole_utterance(small, chunk):
    voc, mel = small[2], torch.from_numpy(small[3])
    with torch.no_grad():
        full = voc(mel).numpy()
    assert full.shape == (2, T * voc.hop_size, 1)
    ctx = streaming.min_context_frames(voc)
    assert 0 < ctx < T
    chunks = list(streaming.vocode_streaming(voc, mel, chunk=chunk))
    assert len(chunks) == -(-T // chunk)
    streamed = np.concatenate([c.numpy() for c in chunks], axis=1)
    assert streamed.shape == full.shape
    np.testing.assert_allclose(streamed, full, rtol=0, atol=1e-5)


def test_too_small_context_is_detectably_wrong(small):
    voc, mel = small[2], torch.from_numpy(small[3])
    with torch.no_grad():
        full = voc(mel).numpy()
    streamed = np.concatenate(list(streaming.vocode_streaming_np(voc, mel, chunk=16, context=1)), axis=1)
    assert np.abs(streamed - full).max() > 1e-4


@pytest.mark.parametrize("chunk,context", [(16, None), (20, 3)])
def test_chunks_equal_the_jax_streaming_vocoder(small, chunk, context):
    jvoc, variables, voc, mel = small
    want = list(jstreaming.vocode_streaming_np(jvoc, variables, jnp.asarray(mel), chunk=chunk, context=context))
    got = list(streaming.vocode_streaming_np(voc, torch.from_numpy(mel), chunk=chunk, context=context))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
