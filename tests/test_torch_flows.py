"""jatts_torch's stochastic duration predictor (``modules/flows.py``)
against jatts_tpu's on the CPU, in f32: the rational-quadratic spline
forward and inverse, inside and outside the tails, and its round trip; the
dilated depth-separable convolution, the conv flow with a non-zero
``proj``, the elementwise affine flow and ``log_flow``; the predictor's NLL
on injected e_q and its inference durations exactly on an injected draw;
then VITS and MatchaTTS_MAS under ``duration_predictor_type: stochastic``
against JAX. Weights are numpy-made; tolerances 1e-5 of scale for a
module, 1e-4 for a model; integer durations exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from jatts_tpu.models.matchatts_mas import MatchaTTS_MAS as JMatchaTTS_MAS  # noqa: E402
from jatts_tpu.models.vits import VITS as JVITS  # noqa: E402
from jatts_tpu.modules import flows as jfl  # noqa: E402
from jatts_torch.models.matchatts_mas import MatchaTTS_MAS  # noqa: E402
from jatts_torch.modules import flows as tfl  # noqa: E402
from jatts_torch.utils.convert import LIST_RENAMES, flax_to_state_dict, matchatts_state_dict_from_jax  # noqa: E402
from tests.test_torch_matcha import CONFIG as MATCHA_CONFIG  # noqa: E402
from tests.test_torch_matcha import inject_cfm_noise  # noqa: E402
from tests.test_torch_matcha import make_batch as matcha_batch  # noqa: E402
from tests.test_torch_vits import (  # noqa: E402
    ADIM, as_np, cf, init_shapes, inject_normal, japply, jax_vits, make_batch, port_vits, scaled_err, t, tensors,
)
from tests.torch_parity import randomize  # noqa: E402

B, T, C = 2, 12, 8
LENS = np.array([12, 7])
MASK = (np.arange(T)[None] < LENS[:, None]).astype(np.float32)[..., None]


def sd_of(params):
    return flax_to_state_dict({"params": params}, every=LIST_RENAMES)


# ---------------------------------------------------------------------------
# the spline and the flows
# ---------------------------------------------------------------------------

def _spline_params(seed, n=400, bins=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, bins)).astype(np.float32), rng.normal(size=(n, bins)).astype(np.float32),
            rng.normal(size=(n, bins - 1)).astype(np.float32))


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_matches_jax_inside_and_outside_the_tails(inverse):
    uw, uh, ud = _spline_params(0)
    x = np.random.default_rng(1).uniform(-7.0, 7.0, 400).astype(np.float32)
    x[:4] = [-5.0, 5.0, -6.5, 6.5]  # the bounds and past them
    want_y, want_ld = jfl.rational_quadratic_spline(x, uw, uh, ud, inverse=inverse)
    got_y, got_ld = tfl.rational_quadratic_spline(t(x), t(uw), t(uh), t(ud), inverse=inverse)
    assert scaled_err(as_np(got_y), want_y) <= 1e-5
    assert scaled_err(as_np(got_ld), want_ld) <= 1e-5
    outside = np.abs(x) > 5.0
    assert outside.sum() > 50
    np.testing.assert_array_equal(as_np(got_y)[outside], x[outside])
    assert not as_np(got_ld)[outside].any()


def test_spline_round_trip():
    """inverse(forward(x)) == x to 1e-4, and the two log-determinants cancel
    to 1e-4 of their scale (the inverse's quadratic root in f32)."""
    uw, uh, ud = _spline_params(2)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-6.0, 6.0, 400).astype(np.float32))
    y, ld = tfl.rational_quadratic_spline(x, t(uw), t(uh), t(ud))
    back, ld_inv = tfl.rational_quadratic_spline(y, t(uw), t(uh), t(ud), inverse=True)
    assert float((back - x).abs().max()) <= 1e-4
    assert scaled_err(as_np(-ld_inv), as_np(ld)) <= 1e-4


def test_dds_conv_and_conv_flow_match_jax():
    """Dilations 1, 3, 9 with SAME padding, LayerNorm eps 1e-5, exact gelu;
    the conv flow's zero-initialised proj randomised, forward, inverse and
    the round trip."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    g = rng.normal(size=(B, T, C)).astype(np.float32)
    jd = jfl.DilatedDepthSeparableConv(C, 3, 3)
    p = randomize(init_shapes(jd, x, MASK, g), 5)
    want = japply(jd, p, x, MASK, g)
    port = tfl.DilatedDepthSeparableConv(C, 3, 3)
    port.load_state_dict(sd_of(p["params"]))
    assert [m.dilation[0] for m in port.dw] == [1, 3, 9]
    with torch.no_grad():
        got = port(cf(x), cf(MASK), cf(g)).transpose(1, 2)
    assert scaled_err(as_np(got), want) <= 1e-5

    z = rng.normal(size=(B, T, 2)).astype(np.float32) * 2.0
    jf = jfl.ConvFlow(2, C, 3, 3)
    p = randomize(init_shapes(jf, z, MASK, g), 6)
    assert np.abs(p["params"]["proj"]["kernel"]).max() > 0.1
    want_y, want_ld = japply(jf, p, z, MASK, g)
    want_inv = japply(jf, p, z, MASK, g, True)
    port = tfl.ConvFlow(2, C, 3, 3)
    port.load_state_dict(sd_of(p["params"]))
    with torch.no_grad():
        got_y, got_ld = port(cf(z), cf(MASK), cf(g))
        got_inv = port(cf(z), cf(MASK), cf(g), inverse=True)
        back = port(port(cf(z * MASK), cf(MASK), cf(g))[0], cf(MASK), cf(g), inverse=True)
    assert scaled_err(as_np(got_y.transpose(1, 2)), want_y) <= 1e-5
    assert scaled_err(as_np(got_ld), want_ld) <= 1e-5
    assert scaled_err(as_np(got_inv.transpose(1, 2)), want_inv) <= 1e-5
    assert scaled_err(as_np(back.transpose(1, 2)), z * MASK) <= 1e-4
    assert scaled_err(as_np(got_y.transpose(1, 2)), z * MASK) > 0.1  # not the identity


def test_elementwise_affine_flow_and_log_flow_match_jax():
    rng = np.random.default_rng(7)
    z = rng.normal(size=(B, T, 2)).astype(np.float32)
    ja = jfl.ElementwiseAffineFlow(2)
    p = randomize(init_shapes(ja, z, MASK), 8)
    want_y, want_ld = japply(ja, p, z, MASK)
    want_inv = japply(ja, p, z, MASK, True)
    port = tfl.ElementwiseAffineFlow(2)
    port.load_state_dict(sd_of(p["params"]))
    with torch.no_grad():
        got_y, got_ld = port(cf(z), cf(MASK))
        got_inv = port(cf(z), cf(MASK), inverse=True)
    assert scaled_err(as_np(got_y.transpose(1, 2)), want_y) <= 1e-5
    assert scaled_err(as_np(got_ld), want_ld) <= 1e-5
    assert scaled_err(as_np(got_inv.transpose(1, 2)), want_inv) <= 1e-5
    w = np.abs(z) * 3.0
    w[0, 0] = 0.0  # below eps: clamped
    want_y, want_ld = jfl.log_flow(w, MASK)
    got_y, got_ld = tfl.log_flow(cf(w), cf(MASK))
    assert scaled_err(as_np(got_y.transpose(1, 2)), want_y) <= 1e-5
    assert scaled_err(as_np(got_ld), want_ld) <= 1e-5
    got = tfl.log_flow(cf(z), cf(MASK), inverse=True).transpose(1, 2)
    assert scaled_err(as_np(got), jfl.log_flow(z, MASK, inverse=True)) <= 1e-5


# ---------------------------------------------------------------------------
# the predictor
# ---------------------------------------------------------------------------

def _sdp_pair(seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w = (rng.integers(1, 6, (B, T, 1)) * MASK).astype(np.float32)
    jm = jfl.StochasticDurationPredictor(C, 3, 0.0, flows=3)
    p = randomize(init_shapes(jm, x, MASK, w), seed)
    port = tfl.StochasticDurationPredictor(C, 3, 0.0, flows=3)
    port.load_state_dict(sd_of(p["params"]))
    return jm, p, port, x, w


def _log_w(port, x, z, noise_scale):
    """The port's durations before ceil (guards the seeds)."""
    xm, mask = cf(x), cf(MASK)
    h = port.proj(port.dds(port.pre(xm), mask)) * mask
    zz = cf(z) * noise_scale
    for flow in list(reversed(port.flows[1:]))[:-1]:
        zz = flow(torch.flip(zz, [1]), mask, g=h, inverse=True)
    zz = port.flows[0](torch.flip(zz, [1]), mask, inverse=True)
    return as_np(torch.exp(zz[:, :1]) * mask)[:, 0]


def test_sdp_nll_on_injected_e_q_matches_jax():
    jm, p, port, x, w = _sdp_pair()
    e_q = np.random.default_rng(10).normal(size=(B, T, 2)).astype(np.float32)
    with inject_normal(e_q):
        want = japply(jm, p, x, MASK, w, rngs={"noise": jax.random.key(0)})
    with torch.no_grad():
        got = port(t(x), t(MASK), w=t(w), e_q=t(e_q))
    assert scaled_err(as_np(got), want) <= 1e-5
    # x carries no gradient into the text encoder
    xt = t(x).requires_grad_(True)
    port(xt, t(MASK), w=t(w), e_q=t(e_q)).sum().backward()
    assert xt.grad is None


def test_sdp_inference_durations_exactly():
    """ceil(exp(z0)) on the same draw; the first conv flow is skipped."""
    jm, p, port, x, _ = _sdp_pair(11)
    z = np.random.default_rng(12).normal(size=(B, T, 2)).astype(np.float32)
    with inject_normal(z):
        want = japply(jm, p, x, MASK, None, None, True, 0.8, rngs={"noise": jax.random.key(0)})
    with torch.no_grad():
        got = port(t(x), t(MASK), inverse=True, noise_scale=0.8, z=t(z))
        cont = _log_w(port, x, z, 0.8)
    np.testing.assert_array_equal(as_np(got), np.asarray(want))
    valid = MASK[..., 0] > 0
    assert np.abs(cont - np.round(cont))[valid].min() > 1e-4 and as_np(got)[valid].max() > 1
    # the first conv flow does not take part
    with torch.no_grad():
        port.flows[1].proj.weight.add_(1.0)
        np.testing.assert_array_equal(as_np(port(t(x), t(MASK), inverse=True, noise_scale=0.8, z=t(z))), as_np(got))


# ---------------------------------------------------------------------------
# the models under duration_predictor_type: stochastic
# ---------------------------------------------------------------------------

STOCH = {"duration_predictor_type": "stochastic"}


def test_vits_stochastic_training_forward_and_inference_match_jax():
    model, variables = jax_vits(seed=13, **STOCH)
    b = make_batch(13, extra=(("e_q", (2, 6, 2)), ("z_dur", (2, 6, 2))))
    with inject_normal(b["eps"], b["e_q"]):
        want, _ = japply(model, variables, b["xs"], b["ilens"], b["ys"], b["olens"], deterministic=False,
                         rngs={"dropout": jax.random.key(0), "noise": jax.random.key(1)}, mutable=["batch_stats"])
    port = port_vits(variables, mas_backend="scan", **STOCH).train()
    got = port(*tensors(b, "xs", "ilens", "ys", "olens"), noise_eps=t(b["eps"]), noise_e_q=t(b["e_q"]))
    np.testing.assert_array_equal(as_np(got["ds"]), np.asarray(want["ds"]))
    assert not as_np(got["d_outs"]).any()
    for key in ("dur_nll", "outs", "z_p", "m_p", "logs_p"):
        assert scaled_err(as_np(got[key]), want[key]) <= 1e-4, key

    port = port_vits(variables, **STOCH)
    eps = np.random.default_rng(14).normal(size=(2, 40, ADIM)).astype(np.float32)
    with inject_normal(b["z_dur"], eps):
        want = japply(model, variables, b["xs"], b["ilens"], 40, method=JVITS.inference,
                      rngs={"noise": jax.random.key(0)})
    got = port.inference(*tensors(b, "xs", "ilens"), 40, eps=t(eps), z_dur=t(b["z_dur"]))
    np.testing.assert_array_equal(as_np(got["duration"]), np.asarray(want["duration"]))
    np.testing.assert_array_equal(as_np(got["olens"]), np.asarray(want["olens"]))
    assert as_np(got["duration"]).sum() > 0
    assert scaled_err(as_np(got["feat_gen"]), want["feat_gen"]) <= 1e-4


def test_matcha_mas_stochastic_matches_jax():
    """The ``sdp`` of MatchaTTS_MAS (dropout 0.5, so both sides run
    deterministic: running statistics, no dropout): dur_nll and the CFM
    loss on the same noise, then inference durations exactly."""
    jmodel = JMatchaTTS_MAS(**MATCHA_CONFIG, **STOCH, mas_backend="scan")
    b = matcha_batch(15)
    args = (b["xs"], b["ilens"], b["ys"], b["olens"])
    variables = randomize(init_shapes(jmodel, *args, deterministic=False), 15)
    assert "sdp" in variables["params"] and "duration_predictor" not in variables["params"]
    e_q = np.random.default_rng(16).normal(size=(2, 6, 2)).astype(np.float32)
    with inject_cfm_noise(b["t"], b["z"]), inject_normal(e_q):
        want = japply(jmodel, variables, *args, deterministic=True, rngs={"noise": jax.random.key(1)})
    port = MatchaTTS_MAS(**MATCHA_CONFIG, **STOCH, mas_backend="scan", device="cpu")
    port.load_state_dict(matchatts_state_dict_from_jax(variables), strict=True)
    assert any(k.startswith("sdp.post_flows.3.") for k in port.state_dict())
    port.eval()
    with torch.no_grad():
        got = port(*tensors(b, "xs", "ilens", "ys", "olens"), noise_t=t(b["t"]), noise_z=t(b["z"]),
                   noise_e_q=t(e_q))
    np.testing.assert_array_equal(as_np(got["ds"]), np.asarray(want["ds"]))
    assert scaled_err(as_np(got["dur_nll"]), want["dur_nll"]) <= 1e-4
    assert abs(float(got["cfm_loss"]) - float(want["cfm_loss"])) <= 1e-4 * max(1.0, abs(float(want["cfm_loss"])))

    z_dur = np.random.default_rng(17).normal(size=(2, 6, 2)).astype(np.float32)
    z = np.random.default_rng(18).normal(size=(2, 40, MATCHA_CONFIG["odim"])).astype(np.float32)
    with inject_cfm_noise(z=z), inject_normal(z_dur):
        want = japply(jmodel, variables, b["xs"], b["ilens"], 40, n_timesteps=2, method=JMatchaTTS_MAS.inference,
                      rngs={"noise": jax.random.key(0)})
    got = port.inference(*tensors(b, "xs", "ilens"), 40, n_timesteps=2, z=t(z), z_dur=t(z_dur))
    np.testing.assert_array_equal(as_np(got["duration"]), np.asarray(want["duration"]))
    np.testing.assert_array_equal(as_np(got["olens"]), np.asarray(want["olens"]))
    assert scaled_err(as_np(got["feat_gen"]), want["feat_gen"]) <= 1e-4
