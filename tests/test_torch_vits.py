"""jatts_torch's mel-VITS against jatts_tpu's on the CPU, in f32: the
weight-normed WaveNet and its parts, the text and posterior encoders, the
residual coupling layer and block (forward, inverse, round trip), the KL
losses, the VITS training forward (MAS durations exactly, under JAX's
``scan`` and ``pallas_interpret``), inference (durations and olens
exactly), speaker embeddings and the weight layout through the JAX
package's own importer. Weights are numpy-made (``tests/torch_parity.py``),
every zero-initialised projection among them, and carried by
``jatts_torch.utils.convert``. Tolerances: 1e-5 of each output's scale for
a module, 1e-4 for the whole model. JAX's noise (the posterior's eps, the
prior's eps) goes in through :func:`inject_normal`."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.losses.kl import KLDivergenceLoss as JKL, KLDivergenceLossWithoutFlow as JKLNoFlow  # noqa: E402
from jatts_tpu.models.vits import VITS as JVITS  # noqa: E402
from jatts_tpu.modules import vits_modules as jvm  # noqa: E402
from jatts_tpu.modules import wavenet as jwn  # noqa: E402
from jatts_tpu.utils.initialize import initialize as jinitialize  # noqa: E402
from jatts_tpu.utils.torch_import import convert_vits  # noqa: E402
from jatts_torch.losses.kl import KLDivergenceLoss, KLDivergenceLossWithoutFlow  # noqa: E402
from jatts_torch.models.vits import VITS  # noqa: E402
from jatts_torch.modules import vits_modules as tvm  # noqa: E402
from jatts_torch.modules import wavenet as twn  # noqa: E402
from jatts_torch.utils.convert import LIST_RENAMES, _wn_leaf, flax_to_state_dict, vits_state_dict_from_jax  # noqa: E402
from jatts_torch.utils.initialize import initialize  # noqa: E402
from tests.test_model_vits import TINY  # noqa: E402
from tests.test_torch_matcha import as_np, init_shapes, japply, scaled_err  # noqa: E402
from tests.torch_parity import assert_trees_equal, randomize, state_dict_numpy  # noqa: E402

# every dropout off, so the JAX training forward and the port's agree
NO_DROPOUT = dict(
    text_encoder_dropout_rate=0.0, text_encoder_positional_dropout_rate=0.0,
    text_encoder_attention_dropout_rate=0.0, transformer_dec_dropout_rate=0.0,
    transformer_dec_positional_dropout_rate=0.0, transformer_dec_attn_dropout_rate=0.0,
    duration_predictor_dropout_rate=0.0,
)
CONFIG = {**TINY, **NO_DROPOUT}
ODIM, ADIM = TINY["odim"], TINY["adim"]
DUR_BIAS = np.log(3.0)  # durations ~ round(exp(log 3 + noise) - 1) ~ 2 a token


@contextlib.contextmanager
def inject_normal(*draws):
    """``jax.random.normal`` returns ``draws`` in turn (each call's shape
    checked) while JAX traces inside the block: the JAX modules' noise
    ("noise" stream) becomes the port's injected noise."""
    queue = [np.asarray(d, np.float32) for d in draws]
    real = jax.random.normal

    def fake(key, shape=(), dtype=jnp.float32):
        want = queue.pop(0)
        assert tuple(shape) == want.shape, (shape, want.shape)
        return jnp.asarray(want, dtype)

    jax.random.normal = fake
    try:
        yield
    finally:
        jax.random.normal = real
    assert not queue, f"{len(queue)} draws left"


def sd_of(params):
    """A flax module's params -> the port's state_dict of the same module."""
    return flax_to_state_dict({"params": params}, every=LIST_RENAMES, leaf=_wn_leaf)


def t(x):
    return torch.from_numpy(np.asarray(x))


def cf(x):
    """Feature-last numpy -> channel-first tensor."""
    return t(x).transpose(1, 2)


B, T = 2, 16
LENS = np.array([16, 11])


def _frames(c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, c)).astype(np.float32)
    mask = (np.arange(T)[None] < LENS[:, None]).astype(np.float32)[..., None]
    return x, mask


# ---------------------------------------------------------------------------
# WaveNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_weight_norm", [True, False])
def test_wnconv_matches_jax(use_weight_norm):
    x, _ = _frames(6, 0)
    jm = jwn.WNConv(10, 5, 2, use_weight_norm=use_weight_norm)
    p = randomize(init_shapes(jm, x), 1)
    want = japply(jm, p, x)
    port = twn.WNConv(6, 10, 5, 2, use_weight_norm=use_weight_norm)
    port.load_state_dict(sd_of(p["params"]))
    with torch.no_grad():
        got = port(cf(x)).transpose(1, 2)
    assert scaled_err(as_np(got), want) <= 1e-5
    if use_weight_norm:
        assert port.weight_g.shape == (10, 1, 1) and port.weight_v.shape == (10, 6, 5)
        assert not any("parametrizations" in k for k in port.state_dict())
        # the norm's clamp: a zero v gives a zero kernel, not NaN
        with torch.no_grad():
            port.weight_v.zero_()
        assert bool(torch.isfinite(port.kernel()).all()) and not port.kernel().any()


@pytest.mark.parametrize("with_g", [False, True])
def test_residual_block_matches_jax(with_g):
    x, mask = _frames(8, 2)
    g = np.random.default_rng(3).normal(size=(B, 1, 5)).astype(np.float32) if with_g else None
    jm = jwn.ResidualBlock(3, 8, 12, 8, 1, 5 if with_g else -1)
    p = randomize(init_shapes(jm, x, mask, g), 4)
    assert ("conv1x1_glo" in p["params"]) == with_g
    if with_g:
        assert "b" not in p["params"]["conv1x1_glo"]
    want_x, want_s = japply(jm, p, x, mask, g)
    port = twn.ResidualBlock(3, 8, 12, 8, 1, 5 if with_g else -1)
    port.load_state_dict(sd_of(p["params"]))
    with torch.no_grad():
        got_x, got_s = port(cf(x), cf(mask), cf(g) if with_g else None)
    assert scaled_err(as_np(got_x.transpose(1, 2)), want_x) <= 1e-5
    assert scaled_err(as_np(got_s.transpose(1, 2)), want_s) <= 1e-5


@pytest.mark.parametrize("base_dilation", [1, 2])
def test_wavenet_matches_jax(base_dilation):
    """4 layers in 2 stacks: dilations 1, 1, 1, 1 or 1, 2, 1, 2; the skip
    sum scaled by sqrt(1/4); frames past the mask stay 0."""
    x, mask = _frames(8, 5)
    g = np.random.default_rng(6).normal(size=(B, 1, 5)).astype(np.float32)
    kw = dict(kernel_size=3, layers=4, stacks=2, base_dilation=base_dilation, residual_channels=8,
              gate_channels=16, skip_channels=8, global_channels=5)
    jm = jwn.WaveNet(**kw)
    p = randomize(init_shapes(jm, x, mask, g), 7)
    want = japply(jm, p, x, mask, g)
    port = twn.WaveNet(**kw)
    port.load_state_dict(sd_of(p["params"]))
    assert [layer.conv.dilation for layer in port.conv_layers] == [1, base_dilation] * 2
    with torch.no_grad():
        got = port(cf(x), cf(mask), cf(g)).transpose(1, 2)
    assert scaled_err(as_np(got), want) <= 1e-5
    assert np.abs(as_np(got)[1, 11:]).max() == 0.0


# ---------------------------------------------------------------------------
# encoders and the flow
# ---------------------------------------------------------------------------

def test_text_encoder_matches_jax():
    rng = np.random.default_rng(8)
    ilens = np.array([7, 4])
    xs = (rng.integers(1, 25, (2, 7)) * (np.arange(7)[None] < ilens[:, None])).astype(np.int32)
    kw = dict(attention_dim=16, attention_heads=2, linear_units=32, blocks=2, use_macaron_style=True,
              use_conformer_conv=True, conformer_kernel_size=3, dropout_rate=0.0,
              pos_enc_layer_type="legacy_rel_pos", selfattention_layer_type="legacy_rel_selfattn")
    jm = jvm.TextEncoder(25, **kw)
    p = randomize(init_shapes(jm, xs, ilens), 9)
    want = japply(jm, p, xs, ilens)
    port = tvm.TextEncoder(25, **kw)
    port.load_state_dict(flax_to_state_dict(p, every=LIST_RENAMES))
    with torch.no_grad():
        got = port.eval()(t(xs).long(), t(ilens))
    for name, g, w in zip(("h", "m", "logs", "mask"), got, want):
        assert scaled_err(as_np(g), w) <= 1e-5, name
    assert np.abs(as_np(got[1])[1, 4:]).max() == 0.0


def test_posterior_encoder_with_injected_eps():
    ys, _ = _frames(ODIM, 10)
    olens = np.array([16, 9])
    g = np.random.default_rng(11).normal(size=(B, 1, 5)).astype(np.float32)
    eps = np.random.default_rng(12).normal(size=(B, T, 6)).astype(np.float32)
    kw = dict(out_channels=6, hidden_channels=8, kernel_size=5, layers=3, global_channels=5)
    jm = jvm.PosteriorEncoder(**kw)
    p = randomize(init_shapes(jm, ys, olens, g), 13)
    with inject_normal(eps):
        want = japply(jm, p, ys, olens, g, rngs={"noise": jax.random.key(0)})
    port = tvm.PosteriorEncoder(ODIM, **kw)
    port.load_state_dict(sd_of(p["params"]))
    with torch.no_grad():
        got = port(t(ys), t(olens), t(g), eps=t(eps))
    for name, gg, w in zip(("z", "m", "logs", "mask"), got, want):
        assert scaled_err(as_np(gg), w) <= 1e-5, name
    # drawn eps: the module's generator fixes it
    port.noise_generator = torch.Generator().manual_seed(3)
    z1 = port(t(ys), t(olens))[0]
    port.noise_generator = torch.Generator().manual_seed(3)
    assert torch.equal(z1, port(t(ys), t(olens))[0])


@pytest.mark.parametrize("use_only_mean", [True, False])
def test_coupling_layer_forward_and_inverse(use_only_mean):
    """proj is randomised (zero at init, where any coupling is the identity)."""
    x, mask = _frames(8, 14)
    g = np.random.default_rng(15).normal(size=(B, 1, 5)).astype(np.float32)
    kw = dict(half_channels=4, hidden_channels=8, kernel_size=3, layers=2, global_channels=5,
              use_only_mean=use_only_mean)
    jm = jvm.ResidualAffineCouplingLayer(**kw)
    p = randomize(init_shapes(jm, x, mask, g), 16)
    assert np.abs(p["params"]["proj"]["kernel"]).max() > 0.1
    want_y, want_ld = japply(jm, p, x, mask, g)
    want_inv = japply(jm, p, x, mask, g, True)
    port = tvm.ResidualAffineCouplingLayer(**kw)
    port.load_state_dict(sd_of(p["params"]))
    with torch.no_grad():
        got_y, got_ld = port(cf(x), cf(mask), cf(g))
        got_inv = port(cf(x), cf(mask), cf(g), inverse=True)
        # the round trip on masked frames (xa passes through unmasked)
        back = port(port(cf(x * mask), cf(mask), cf(g))[0], cf(mask), cf(g), inverse=True)
    assert scaled_err(as_np(got_y.transpose(1, 2)), want_y) <= 1e-5
    assert scaled_err(as_np(got_ld), want_ld) <= 1e-5
    assert scaled_err(as_np(got_inv.transpose(1, 2)), want_inv) <= 1e-5
    assert scaled_err(as_np(back.transpose(1, 2)), x * mask) <= 1e-5


def test_coupling_block_forward_inverse_and_round_trip():
    x, mask = _frames(8, 17)
    g = np.random.default_rng(18).normal(size=(B, 1, 5)).astype(np.float32)
    kw = dict(in_channels=8, hidden_channels=8, flows=3, kernel_size=3, layers=2, global_channels=5)
    jm = jvm.ResidualAffineCouplingBlock(**kw)
    p = randomize(init_shapes(jm, x, mask, g), 19)
    want = japply(jm, p, x, mask, g)
    want_inv = japply(jm, p, x, mask, g, True)
    port = tvm.ResidualAffineCouplingBlock(**kw)
    port.load_state_dict(sd_of(p["params"]))
    assert sorted({k.split(".")[1] for k in port.state_dict()}) == ["0", "2", "4"]
    with torch.no_grad():
        got = port(t(x), t(mask), t(g))
        got_inv = port(t(x), t(mask), t(g), inverse=True)
        back = port(got, t(mask), t(g), inverse=True)
    assert scaled_err(as_np(got), want) <= 1e-5
    assert scaled_err(as_np(got_inv), want_inv) <= 1e-5
    assert scaled_err(as_np(back), x * mask) <= 1e-5
    # the flips matter: without them the block is another map
    assert scaled_err(as_np(got), x) > 0.1


def test_kl_losses_match_jax():
    rng = np.random.default_rng(20)
    z_p, logs_q, m_p, logs_p = (rng.normal(size=(2, 6, 10)).astype(np.float32) * s for s in (1, 0.3, 1, 0.3))
    z_mask = (np.arange(10)[None, None] < np.array([10, 7])[:, None, None]).astype(np.float32)
    want = JKL()(z_p, logs_q, m_p, logs_p, z_mask)
    got = KLDivergenceLoss()(*(t(a) for a in (z_p, logs_q, m_p, logs_p, z_mask)))
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    # divided by the frames (17), not frames x channels
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * np.exp(-2 * logs_p)
    assert abs(float(got) - float((kl * z_mask).sum() / 17)) <= 1e-5 * max(1.0, abs(float(got)))
    want = JKLNoFlow()(m_p, logs_q, z_p, logs_p)
    got = KLDivergenceLossWithoutFlow()(*(t(a) for a in (m_p, logs_q, z_p, logs_p)))
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))


# ---------------------------------------------------------------------------
# VITS
# ---------------------------------------------------------------------------

XLENS = np.array([6, 4])


def make_batch(seed=0, t_feats=24, olens=(24, 17), extra=()):
    rng = np.random.default_rng(seed)
    xs = rng.integers(1, TINY["idim"], (2, 6)) * (np.arange(6)[None] < XLENS[:, None])
    b = {
        "xs": xs.astype(np.int32), "ilens": XLENS.astype(np.int32),
        "ys": rng.normal(size=(2, t_feats, ODIM)).astype(np.float32),
        "olens": np.asarray(olens, np.int32),
        "eps": rng.normal(size=(2, t_feats, ADIM)).astype(np.float32),
    }
    for name, shape in extra:
        b[name] = rng.normal(size=shape).astype(np.float32)
    return b


def tensors(b, *keys):
    return [torch.from_numpy(np.asarray(b[k]).astype(np.int64 if b[k].dtype.kind == "i" else np.float32))
            for k in keys]


def jax_vits(seed=0, spembs=None, **extra):
    model = JVITS(**CONFIG, **extra)
    b = make_batch()
    variables = randomize(init_shapes(model, b["xs"], b["ilens"], b["ys"], b["olens"], spembs,
                                      deterministic=False), seed)
    if "linear" in variables["params"]["duration_predictor"]:
        variables["params"]["duration_predictor"]["linear"]["bias"][:] = DUR_BIAS
    return model, variables


def port_vits(variables, **extra):
    port = VITS(**CONFIG, **extra, device="cpu")
    port.load_state_dict(vits_state_dict_from_jax(variables), strict=True)
    return port


FORWARD_KEYS = ("outs", "d_outs", "bin_loss", "log_p_attn", "m_p", "logs_p", "m_q", "logs_q", "z", "z_p", "y_mask")


@pytest.mark.parametrize("jbackend", ["scan", "pallas_interpret"])
def test_vits_training_forward_matches_jax(jbackend):
    """Every key of the dict within 1e-4 of its scale; ds exactly under the
    port's plain search against JAX's scan and the Pallas pair."""
    model, variables = jax_vits(seed=1, mas_backend=jbackend)
    b = make_batch(1)
    with inject_normal(b["eps"]):
        want, _ = japply(model, variables, b["xs"], b["ilens"], b["ys"], b["olens"], deterministic=False,
                         rngs={"dropout": jax.random.key(0), "noise": jax.random.key(1)}, mutable=["batch_stats"])
    port = port_vits(variables, mas_backend="scan").train()
    got = port(*tensors(b, "xs", "ilens", "ys", "olens"), noise_eps=t(b["eps"]))
    np.testing.assert_array_equal(as_np(got["ds"]), np.asarray(want["ds"]))
    np.testing.assert_array_equal(as_np(got["ds"]).sum(1), b["olens"])
    np.testing.assert_array_equal(as_np(got["olens_in"]), b["olens"])
    for key in FORWARD_KEYS:
        assert scaled_err(as_np(got[key]), want[key]) <= 1e-4, key
    assert got["dur_nll"] is None and want["dur_nll"] is None
    assert set(got) == set(want)


def test_vits_inference_matches_jax_on_injected_noise():
    """feat_gen on the same eps within 1e-4; durations and olens exactly
    (olens = min(max(sum d, 1), max_t_feats), no rounding to even). JAX
    runs on the port's state_dict read back by convert_vits."""
    model, variables = jax_vits(seed=2)
    b = make_batch(2)
    max_frames = 20  # below one row's sum of durations: olens is clipped there
    eps = np.random.default_rng(9).normal(size=(2, max_frames, ADIM)).astype(np.float32)
    port = port_vits(variables)
    back = convert_vits(state_dict_numpy(port), model)
    with inject_normal(eps):
        want = japply(model, back, b["xs"], b["ilens"], max_frames, method=JVITS.inference,
                      rngs={"noise": jax.random.key(0)})
    got = port.inference(*tensors(b, "xs", "ilens"), max_frames, eps=t(eps))
    np.testing.assert_array_equal(as_np(got["duration"]), np.asarray(want["duration"]))
    np.testing.assert_array_equal(as_np(got["olens"]), np.asarray(want["olens"]))
    assert as_np(got["olens"]).min() > 0 and as_np(got["olens"]).max() == max_frames
    assert (as_np(got["duration"]).sum(1) > max_frames).any()
    assert scaled_err(as_np(got["feat_gen"]), want["feat_gen"]) <= 1e-4
    assert port.training  # inference leaves the mode as it was
    # the predicted durations sit clear of the rounding boundaries
    hs = japply(model, back, b["xs"], b["ilens"], method=lambda m, x, i: m.text_encoder(x, i)[0])
    d_masks = np.arange(6)[None] < XLENS[:, None]
    d_log = japply(model, back, hs, d_masks, method=lambda m, h, dm: m.duration_predictor(h, dm))
    e = np.exp(np.asarray(d_log)) - 1.0
    assert np.abs(e - np.floor(e) - 0.5)[d_masks].min() > 1e-3
    # a generator's seed fixes the drawn noise
    g = [torch.Generator().manual_seed(s) for s in (5, 5, 6)]
    outs = [port.inference(*tensors(b, "xs", "ilens"), max_frames, generator=gi)["feat_gen"] for gi in g]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("integration", ["add", "concat"])
def test_speaker_embeddings_match_jax(integration):
    """spk_embed_dim: the L2-normalised spembs added through ``projection``
    or concatenated and projected, and g = spembs reaching every WaveNet's
    conv1x1_glo; the training forward and inference against JAX."""
    extra = dict(spk_embed_dim=6, spk_embed_integration_type=integration)
    spembs = np.random.default_rng(5).normal(size=(2, 6)).astype(np.float32)
    model, variables = jax_vits(seed=5, spembs=spembs, **extra)
    port = port_vits(variables, mas_backend="scan", **extra)
    glo = [k for k in port.state_dict() if "conv1x1_glo" in k]
    assert glo and all(port.state_dict()[k].shape[1] == 6 for k in glo if k.endswith("weight_v"))
    b = make_batch(5)
    with inject_normal(b["eps"]):
        want, _ = japply(model, variables, b["xs"], b["ilens"], b["ys"], b["olens"], spembs, deterministic=False,
                         rngs={"dropout": jax.random.key(0), "noise": jax.random.key(1)}, mutable=["batch_stats"])
    got = port.train()(*tensors(b, "xs", "ilens", "ys", "olens"), spembs=t(spembs), noise_eps=t(b["eps"]))
    np.testing.assert_array_equal(as_np(got["ds"]), np.asarray(want["ds"]))
    for key in ("outs", "z", "z_p", "m_p", "log_p_attn"):
        assert scaled_err(as_np(got[key]), want[key]) <= 1e-4, key
    eps = np.random.default_rng(6).normal(size=(2, 40, ADIM)).astype(np.float32)
    with inject_normal(eps):
        want = japply(model, variables, b["xs"], b["ilens"], 40, spembs, method=JVITS.inference,
                      rngs={"noise": jax.random.key(0)})
    # a fresh port: the training forward moved the BatchNorm statistics
    port = port_vits(variables, **extra)
    got = port.inference(*tensors(b, "xs", "ilens"), 40, t(spembs), eps=t(eps))
    np.testing.assert_array_equal(as_np(got["duration"]), np.asarray(want["duration"]))
    assert scaled_err(as_np(got["feat_gen"]), want["feat_gen"]) <= 1e-4


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"spk_embed_dim": 6}], ids=["single", "spembs"])
def test_layout_round_trip_through_the_jax_importer(extra):
    """convert_vits reads the port's state_dict back into the same
    variables, leaf for leaf: the couplings at flow.flows.{0,2}, the
    weight-normed convs as weight_g [out, 1, 1] and weight_v [out, in, k]."""
    spembs = np.ones((2, 6), np.float32) if extra else None
    model, variables = jax_vits(seed=4, spembs=spembs, **extra)
    port = port_vits(variables, **extra)
    sd = port.state_dict()
    assert sd["flow.flows.2.encoder.conv_layers.1.conv.weight_g"].shape == (2 * ADIM, 1, 1)
    assert sd["flow.flows.2.encoder.conv_layers.1.conv.weight_v"].shape == (2 * ADIM, ADIM, 5)
    assert not any(k.startswith("flow.flows.1.") for k in sd)
    assert_trees_equal(convert_vits(state_dict_numpy(port), model), variables)


def test_initializer_keeps_wn_scales_and_draws_with_jax_fans():
    """xavier_uniform on VITS: every weight_v drawn within the bound of the
    JAX package's fans of its flax leaf v [k, in, out] and reaching most of
    it; weight_g (flax's 1-dim g) left as it was, as JAX leaves it."""
    model, variables = jax_vits(seed=6)
    port = port_vits(variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    initialize(port, "xavier_uniform", seed=1)
    want = jinitialize(variables["params"], "xavier_uniform", jax.random.key(3))
    g_keys = [k for k in before if k.endswith("weight_g")]
    assert g_keys and all(torch.equal(port.state_dict()[k], before[k]) for k in g_keys)
    v_keys = [k for k in before if k.endswith("weight_v")]
    for k in v_keys:
        out, cin, ksz = before[k].shape
        bound = np.sqrt(6.0 / (cin * ksz + out * ksz))
        got = port.state_dict()[k]
        assert float(got.abs().max()) <= bound * (1 + 1e-6), k
        assert float(got.abs().max()) >= 0.8 * bound, k
    # JAX: the same leaves drawn from the same bound, g untouched
    jv = want["posterior_encoder"]["encoder"]["conv_layers_0"]["conv"]
    k, cin, out = jv["v"].shape
    assert float(np.abs(np.asarray(jv["v"])).max()) <= np.sqrt(6.0 / (cin * k + out * k)) * (1 + 1e-6)
    np.testing.assert_array_equal(
        np.asarray(jv["g"]), variables["params"]["posterior_encoder"]["encoder"]["conv_layers_0"]["conv"]["g"])
