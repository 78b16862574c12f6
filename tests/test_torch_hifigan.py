"""jatts_torch HiFiGANGenerator against jatts_tpu's on the CPU, in f32, and
the layout round trip through ``hifigan_torch_to_flax``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.vocoder.convert import hifigan_torch_to_flax  # noqa: E402
from jatts_tpu.vocoder.hifigan import HiFiGANGenerator as JHiFiGAN  # noqa: E402
from jatts_torch.utils.convert import hifigan_state_dict_from_jax  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from tests.torch_parity import assert_trees_equal, randomize, state_dict_numpy  # noqa: E402


def _config(scales, additional=True):
    return dict(
        in_channels=8, channels=16, kernel_size=7, upsample_scales=scales,
        upsample_kernel_sizes=tuple(2 * s for s in scales),
        resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3)),
        use_additional_convs=additional,
    )


def _jax(cfg, seed):
    model = JHiFiGAN(**cfg)
    variables = model.init(jax.random.key(0), jnp.zeros((1, 10, 8), jnp.float32))
    return model, randomize(variables, seed)


@pytest.mark.parametrize("scales,additional", [((5, 4), True), ((3, 2), True), ((5, 4), False)])
def test_hifigan_parity(scales, additional):
    cfg = _config(scales, additional)
    model, variables = _jax(cfg, 0)
    mel = np.random.default_rng(1).normal(size=(2, 23, 8)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(mel)))
    port = HiFiGANGenerator(**cfg, device="cpu")
    port.load_state_dict(hifigan_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    hop = int(np.prod(scales))
    assert port.hop_size == hop
    assert got.shape == want.shape == (2, 23 * hop, 1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_hifigan_layout_round_trip():
    cfg = _config((5, 4))
    _, variables = _jax(cfg, 2)
    port = HiFiGANGenerator(**cfg, device="cpu")
    port.load_state_dict(hifigan_state_dict_from_jax(variables), strict=True)
    assert_trees_equal(hifigan_torch_to_flax(state_dict_numpy(port)), variables)
