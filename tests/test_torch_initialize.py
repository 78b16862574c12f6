"""jatts_torch/utils/initialize.py against jatts_tpu/utils/initialize.py on
the CPU: the two draw different bits from their seeds, so the test holds
the spread of each parameter's draws, which the fans decide.

Tolerance: the std of n draws estimates the initializer's std with a
relative standard error of at most ~1/sqrt(2n) (normal draws; uniform draws
less), so two independent estimates differ by ~1/sqrt(n) relative. The
parameters below give n >= 768 draws a side (pos_bias_u and pos_bias_v
together), 3.6% for one standard error of the difference; the test allows
10% (2.8 standard errors). A wrong fan reading is off by sqrt(d_k / H) =
9.8x at (2 heads, adim 384)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.modules import attention as jattn  # noqa: E402
from jatts_tpu.modules import positional as jpos  # noqa: E402
from jatts_tpu.utils.initialize import initialize as jinitialize  # noqa: E402
from jatts_tpu.vocoder.convert import _convT_w  # noqa: E402
from jatts_torch.modules import attention as tattn  # noqa: E402
from jatts_torch.utils.initialize import flax_shape, initialize  # noqa: E402

N_HEAD, N_FEAT = 2, 384
REL_TOL = 0.10
INIT_TYPES = ("kaiming_normal", "chainer", "xavier_uniform")


def _jax_params(init_type):
    t = 5
    x = jnp.zeros((1, t, N_FEAT), jnp.float32)
    pe = jpos.LegacyRelPositionalEncoding(N_FEAT).apply({}, x)[1]
    mod = jattn.LegacyRelPositionMultiHeadedAttention(N_HEAD, N_FEAT)
    params = mod.init(jax.random.key(0), x, x, x, pe, None)["params"]
    return jinitialize(params, init_type, jax.random.key(1))


def _port_params(init_type):
    mod = tattn.LegacyRelPositionMultiHeadedAttention(N_HEAD, N_FEAT)
    initialize(mod, init_type, seed=0)
    return dict(mod.named_parameters())


def _std(*arrays):
    return float(np.concatenate([np.asarray(a, dtype=np.float64).ravel() for a in arrays]).std())


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_pos_bias_std_matches_jax(init_type):
    jp = _jax_params(init_type)
    tp = _port_params(init_type)
    want = _std(jp["pos_bias_u"], jp["pos_bias_v"])
    got = _std(tp["pos_bias_u"].detach().numpy(), tp["pos_bias_v"].detach().numpy())
    assert abs(got - want) <= REL_TOL * want, (init_type, got, want)


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_linear_std_unchanged(init_type):
    """Linear weights keep torch's reading, fan_in = in: the JAX package's
    std and the closed form both hold (147,456 draws: 1% allowed)."""
    jp = _jax_params(init_type)
    got = _std(_port_params(init_type)["linear_q.weight"].detach().numpy())
    want = _std(jp["linear_q"]["kernel"])
    fan_in = fan_out = N_FEAT
    closed = {
        "kaiming_normal": math.sqrt(2.0 / fan_in),
        "chainer": 1.0 / math.sqrt(fan_in),
        "xavier_uniform": math.sqrt(2.0 / (fan_in + fan_out)),
    }[init_type]
    assert abs(got - want) <= 0.01 * want
    assert abs(got - closed) <= 0.01 * closed


def test_flax_shape_maps_torch_layouts_as_the_converter_does():
    w = np.zeros((8, 4, 6), np.float32)  # ConvTranspose1d [in, out, k]
    assert flax_shape(w.shape) == _convT_w(w).shape == (6, 4, 8)
    assert flax_shape((16, 8)) == (8, 16)  # Linear [out, in] -> Dense [in, out]
    assert flax_shape((32, 16, 3, 5)) == (3, 5, 16, 32)  # Conv2d -> [kh, kw, in, out]


@pytest.mark.parametrize("init_type", ("kaiming_normal", "chainer", "xavier_normal"))
def test_conv_transpose_std_matches_the_jax_reading(init_type):
    """nn.ConvTranspose1d [in, out, k], as flax holds it after
    hifigan_torch_to_flax ([k, out, in]): fan_in = out·k (32,768 draws: 2%
    allowed)."""
    c_in, c_out, k = 64, 32, 16
    mod = torch.nn.Sequential(torch.nn.ConvTranspose1d(c_in, c_out, k))
    initialize(mod, init_type, seed=0)
    got = _std(mod[0].weight.detach().numpy())
    params = {"upsample_0": {"kernel": jnp.asarray(_convT_w(np.zeros((c_in, c_out, k), np.float32)))}}
    want = _std(jinitialize(params, init_type, jax.random.key(0))["upsample_0"]["kernel"])
    assert abs(got - want) <= 0.02 * want, (got, want)
