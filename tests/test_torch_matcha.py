"""jatts_torch's Matcha family against jatts_tpu's on the CPU, in f32: the
U-Net's parts and whole with padded frames, the length helpers, the CFM
loss and Euler sampler on injected noise, MatchaTTS and MatchaTTS_MAS
training forwards and inference, and the weight layout through the JAX
package's own importer. Weights are numpy-made (``tests/torch_parity.py``)
and carried by ``jatts_torch.utils.convert``. On the JAX side the CFM's t
and z go in through ``flax.linen.intercept_methods``."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.models.matchatts import MatchaTTS as JMatchaTTS  # noqa: E402
from jatts_tpu.models.matchatts_mas import MatchaTTS_MAS as JMatchaTTS_MAS  # noqa: E402
from jatts_tpu.modules import matcha_decoder as jdec  # noqa: E402
from jatts_tpu.modules.cfm import CFM as JCFM  # noqa: E402
from jatts_tpu.ops import masks as jmasks  # noqa: E402
from jatts_tpu.ops import upsample as jup  # noqa: E402
from jatts_tpu.utils.initialize import initialize as jinitialize  # noqa: E402
from jatts_tpu.utils.torch_import import convert_matchatts  # noqa: E402
from jatts_torch.models.matchatts import MatchaTTS  # noqa: E402
from jatts_torch.models.matchatts_mas import MatchaTTS_MAS  # noqa: E402
from jatts_torch.modules import matcha_decoder as tdec  # noqa: E402
from jatts_torch.modules.cfm import CFM  # noqa: E402
from jatts_torch.ops import masks as tmasks  # noqa: E402
from jatts_torch.ops import upsample as tup  # noqa: E402
from jatts_torch.utils.convert import flax_to_state_dict, matcha_estimator_renames, matchatts_state_dict_from_jax  # noqa: E402
from jatts_torch.utils.initialize import initialize  # noqa: E402
from tests.test_model_matchatts import TINY  # noqa: E402
from tests.torch_parity import assert_trees_equal, randomize, state_dict_numpy  # noqa: E402
from tests.torch_replica import TMatchaDecoder  # noqa: E402

# every dropout off, so the JAX training forward and the port's agree
NO_DROPOUT = dict(
    transformer_enc_dropout_rate=0.0, transformer_enc_positional_dropout_rate=0.0,
    transformer_enc_attn_dropout_rate=0.0, duration_predictor_dropout_rate=0.0,
    decoder_dropout=0.0,
)
CONFIG = {**TINY, **NO_DROPOUT}
ODIM = TINY["odim"]
# durations ~ round(exp(log 3 + noise) - 1) ~ 2 a token
DUR_BIAS = np.log(3.0)


def init_shapes(module, *args, method=None, **kwargs):
    """A flax module's variables as zeros of their shapes: ``randomize``
    replaces every leaf, and tracing for the shapes alone is far quicker
    than an eager ``init`` on the CPU."""
    rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1), "noise": jax.random.key(2)}
    shapes = jax.eval_shape(lambda: module.init(rngs, *args, method=method, **kwargs))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def japply(module, variables, *args, **kwargs):
    """``module.apply`` under ``jax.jit``, the inputs as constants: one
    compile is far quicker than eager flax on the CPU."""
    return jax.jit(lambda v: module.apply(v, *args, **kwargs))(variables)


def scaled_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def as_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@contextlib.contextmanager
def inject_cfm_noise(t=None, z=None):
    """Hand ``t`` and ``z`` to the JAX CFM's ``__call__`` and ``z`` to its
    ``inference``, which otherwise draw them from the "noise" stream."""

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, JCFM):
            if context.method_name == "__call__":
                kwargs = {**kwargs, "t": jnp.asarray(t), "z": jnp.asarray(z)}
            elif context.method_name == "inference":
                kwargs = {**kwargs, "z": jnp.asarray(z)}
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        yield


# ---------------------------------------------------------------------------
# the U-Net's parts
# ---------------------------------------------------------------------------

B, T = 2, 16
LENS = np.array([16, 11])


def _frames(c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, c)).astype(np.float32)
    mask = (np.arange(T)[None] < LENS[:, None]).astype(np.float32)
    return x, mask


def _part_sd(params, flax_path, torch_prefix):
    """A part's flax params, placed at ``flax_path`` of the estimator, as
    the port's state_dict of that part (the prefix stripped)."""
    tree = params
    for name in reversed(("decoder", "estimator") + flax_path):
        tree = {name: tree}
    sd = flax_to_state_dict({"params": tree}, matcha_estimator_renames(2))
    return {k[len(torch_prefix):]: v for k, v in sd.items()}


def test_block1d_and_resnet_with_padded_frames():
    x, mask = _frames(24, 0)
    temb = np.random.default_rng(1).normal(size=(B, 40)).astype(np.float32)
    jb = jdec.Block1D(16)
    p = randomize(init_shapes(jb, x, mask[..., None]), 2)
    want = japply(jb, p, x, mask[..., None])
    port = tdec.Block1D(24, 16)
    port.load_state_dict(_part_sd(p["params"], ("final_block",), "decoder.estimator.final_block."))
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(mask)[:, None]).transpose(1, 2)
    assert scaled_err(as_np(got), want) <= 1e-5
    assert np.abs(as_np(got)[1, 11:]).max() == 0.0

    jr = jdec.ResnetBlock1D(16)
    p = randomize(init_shapes(jr, x, mask[..., None], temb), 3)
    want = japply(jr, p, x, mask[..., None], temb)
    port = tdec.ResnetBlock1D(24, 16, 40)
    port.load_state_dict(_part_sd(p["params"], ("down_resnet_0",), "decoder.estimator.down_blocks.0.0."))
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(mask)[:, None],
                   torch.from_numpy(temb)).transpose(1, 2)
    assert scaled_err(as_np(got), want) <= 1e-5


def test_snakebeta_ff_and_transformer_block_with_padded_frames():
    x, mask = _frames(16, 4)
    jf = jdec.SnakeBetaFF(16, 64)
    p = randomize(init_shapes(jf, x), 5)
    want = japply(jf, p, x)
    port = tdec.SnakeBetaFF(16, 64)
    port.load_state_dict(_part_sd(p["params"], ("down_tf_0_0", "ff"), "decoder.estimator.down_blocks.0.1.0.ff."))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert scaled_err(as_np(got), want) <= 1e-5

    jt = jdec.BasicTransformerBlock(16, 2, 8)
    valid = mask > 0
    p = randomize(init_shapes(jt, x, valid), 6)
    want = japply(jt, p, x, valid)
    port = tdec.BasicTransformerBlock(16, 2, 8)
    port.load_state_dict(_part_sd(p["params"], ("down_tf_0_0",), "decoder.estimator.down_blocks.0.1.0."))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(valid))
    assert scaled_err(as_np(got), want) <= 1e-5
    with pytest.raises(ValueError, match="snakebeta"):
        tdec.BasicTransformerBlock(16, 2, 8, act_fn="gelu")


def _decoder_pair(seed=7):
    jm = jdec.MatchaDecoder(ODIM, (16, 16), 0.0, 8, 1, 2, 2)
    x, mask = _frames(ODIM, seed)
    mu = np.random.default_rng(seed + 1).normal(size=x.shape).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    p = randomize(init_shapes(jm, x, mask, mu, t), seed)
    port = CFM(ODIM, (16, 16), 0.0, 8, 1, 2, 2)
    port.load_state_dict(matchatts_sd_of_decoder(p))
    return jm, p, port.estimator, (x, mask, mu, t)


def matchatts_sd_of_decoder(p):
    """The estimator's flax params as a CFM's state_dict (``estimator.*``)."""
    sd = flax_to_state_dict({"params": {"decoder": {"estimator": p["params"]}}}, matcha_estimator_renames(2))
    return {k[len("decoder."):]: v for k, v in sd.items()}


def test_matcha_decoder_with_padded_frames():
    jm, p, port, (x, mask, mu, t) = _decoder_pair()
    want = japply(jm, p, x, mask, mu, t)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, mask, mu, t)))
    assert scaled_err(as_np(got), want) <= 1e-5
    assert np.abs(as_np(got)[1, 11:]).max() == 0.0
    with pytest.raises(ValueError, match="even"):
        port(*(torch.from_numpy(a[:, :15] if a.ndim > 1 else a) for a in (x, mask, mu, t)))


def test_decoder_keys_are_the_reference_layout():
    """The port's estimator names and shapes every parameter as the
    reference's Decoder (tests/torch_replica.py:TMatchaDecoder) does."""
    _, p, port, _ = _decoder_pair()
    ref = TMatchaDecoder(ODIM, channels=(16, 16), heads=2, head_dim=8)
    assert set(port.state_dict()) == set(ref.state_dict())
    assert all(port.state_dict()[k].shape == v.shape for k, v in ref.state_dict().items())


# ---------------------------------------------------------------------------
# the length helpers
# ---------------------------------------------------------------------------

def test_gaussian_upsampling_matches_jax_with_masked_rows_and_frames():
    rng = np.random.default_rng(0)
    hs = rng.normal(size=(3, 6, 5)).astype(np.float32)
    ds = rng.integers(0, 5, (3, 6)).astype(np.float32)
    ilens = np.array([6, 3, 0])  # the last row has no valid token
    olens = np.array([20, 9, 4])  # frames past olens sit at t = 0
    d_masks = np.arange(6)[None] < ilens[:, None]
    h_masks = (np.arange(24)[None] < olens[:, None]).astype(np.float32)
    want = jup.gaussian_upsampling(hs, ds, h_masks, d_masks)
    got = tup.gaussian_upsampling(*(torch.from_numpy(a) for a in (hs, ds, h_masks, d_masks)))
    assert scaled_err(as_np(got), want) <= 1e-6
    assert np.isfinite(as_np(got)).all() and np.abs(as_np(got)[2]).max() == 0.0
    want = jup.gaussian_upsampling(hs, ds, t_feats=24)
    got = tup.gaussian_upsampling(torch.from_numpy(hs), torch.from_numpy(ds), t_feats=24)
    assert scaled_err(as_np(got), want) <= 1e-6
    with pytest.raises(ValueError):
        tup.gaussian_upsampling(torch.from_numpy(hs), torch.from_numpy(ds))


@pytest.mark.parametrize("only_positive", [False, True])
def test_average_by_duration_and_masks_exactly(only_positive):
    rng = np.random.default_rng(1)
    # eighths: every sum and quotient is exact in f32, so the two agree bit for bit
    xs = (rng.integers(-16, 40, (3, 30)) / 8.0).astype(np.float32)
    ds = rng.integers(0, 6, (3, 7)).astype(np.int32)
    tl, fl = np.array([7, 4, 0]), np.array([30, 12, 5])
    want = jup.average_by_duration(xs, ds, tl, fl, only_positive)
    got = tup.average_by_duration(*(torch.from_numpy(a) for a in (xs, ds, tl, fl)), only_positive)
    np.testing.assert_array_equal(as_np(got), np.asarray(want))
    lens = np.array([3, 0, 5])
    for dtype, jdtype in ((torch.bool, jnp.bool_), (torch.float32, jnp.float32)):
        np.testing.assert_array_equal(as_np(tmasks.pad_mask(torch.from_numpy(lens), 6, dtype)),
                                      np.asarray(jmasks.pad_mask(lens, 6, jdtype)))
    np.testing.assert_array_equal(as_np(tmasks.causal_mask(5)), np.asarray(jmasks.causal_mask(5)))


# ---------------------------------------------------------------------------
# the CFM
# ---------------------------------------------------------------------------

def _cfm_pair(seed=3):
    x, mask = _frames(ODIM, seed)
    mu = np.random.default_rng(seed + 1).normal(size=x.shape).astype(np.float32)
    jc = JCFM(ODIM, (16, 16), 0.0, 8, 1, 2, 2)
    t = np.array([[[0.25]], [[0.7]]], np.float32)
    z = np.random.default_rng(seed + 2).normal(size=x.shape).astype(np.float32)
    p = randomize(init_shapes(jc, x, mask, mu, True, t, z), seed)
    port = CFM(ODIM, (16, 16), 0.0, 8, 1, 2, 2)
    port.load_state_dict(matchatts_sd_of_decoder({"params": p["params"]["estimator"]}))
    return jc, p, port, (x, mask, mu, t, z)


def test_cfm_loss_and_euler_sampler_on_injected_noise():
    jc, p, port, (x, mask, mu, t, z) = _cfm_pair()
    want_loss, want_y = japply(jc, p, x * mask[..., None], mask, mu, True, t, z)
    with torch.no_grad():
        got_loss, got_y = port(*(torch.from_numpy(a) for a in (x * mask[..., None], mask, mu)),
                               t=torch.from_numpy(t), z=torch.from_numpy(z))
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * max(1.0, abs(float(want_loss)))
    assert scaled_err(as_np(got_y), want_y) <= 1e-6

    want = japply(jc, p, mu, mask, 3, 0.5, z=z, method=JCFM.inference)
    got = port.inference(torch.from_numpy(mu), torch.from_numpy(mask), 3, 0.5, z=torch.from_numpy(z))
    assert scaled_err(as_np(got), want) <= 1e-4
    # drawn noise: a generator's seed fixes it, the temperature scales it
    g = [torch.Generator().manual_seed(s) for s in (5, 5, 6)]
    outs = [port.inference(torch.from_numpy(mu), torch.from_numpy(mask), 2, 0.667, generator=gi) for gi in g]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# MatchaTTS and MatchaTTS_MAS
# ---------------------------------------------------------------------------

XLENS = np.array([6, 4])


def make_batch(seed=0, t_feats=32, olens=(29, 20)):
    """A training batch: ids, lengths, mels, durations summing to olens
    (MatchaTTS) and the CFM's t and z."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(1, TINY["idim"], (2, 6)) * (np.arange(6)[None] < XLENS[:, None])
    ds = np.zeros((2, 6), np.int32)
    for b, (n, o) in enumerate(zip(XLENS, olens)):
        cut = np.sort(rng.choice(np.arange(1, o), n - 1, replace=False))
        ds[b, :n] = np.diff(np.concatenate([[0], cut, [o]]))
    return {
        "xs": xs.astype(np.int32), "ilens": XLENS.astype(np.int32),
        "ys": rng.normal(size=(2, t_feats, ODIM)).astype(np.float32),
        "olens": np.asarray(olens, np.int32), "ds": ds,
        "t": rng.uniform(0.05, 0.95, (2, 1, 1)).astype(np.float32),
        "z": rng.normal(size=(2, t_feats, ODIM)).astype(np.float32),
    }


def jax_model_and_vars(cls, seed=0, **extra):
    model = cls(**CONFIG, **extra)
    b = make_batch()
    args = (b["xs"], b["ilens"], b["ys"], b["olens"]) + ((b["ds"],) if cls is JMatchaTTS else ())
    variables = randomize(init_shapes(model, *args, deterministic=False), seed)
    variables["params"]["duration_predictor"]["linear"]["bias"][:] = DUR_BIAS
    return model, variables


def port_of(cls, variables, **extra):
    port = cls(**CONFIG, **extra, device="cpu")
    port.load_state_dict(matchatts_state_dict_from_jax(variables), strict=True)
    return port


def tensors(b, *keys):
    return [torch.from_numpy(np.asarray(b[k]).astype(np.int64 if b[k].dtype.kind == "i" else np.float32))
            for k in keys]


def test_matchatts_training_forward_matches_jax():
    model, variables = jax_model_and_vars(JMatchaTTS)
    b = make_batch(1)
    with inject_cfm_noise(b["t"], b["z"]):
        want, _ = japply(model, variables, b["xs"], b["ilens"], b["ys"], b["olens"], b["ds"],
                              deterministic=False, rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
    port = port_of(MatchaTTS, variables).train()
    got = port(*tensors(b, "xs", "ilens", "ys", "olens", "ds"),
               noise_t=torch.from_numpy(b["t"]), noise_z=torch.from_numpy(b["z"]))
    loss = float(got["cfm_loss"].detach())
    assert abs(loss - float(want["cfm_loss"])) <= 1e-5 * max(1.0, abs(float(want["cfm_loss"])))
    for key in ("d_outs", "hs"):
        assert scaled_err(as_np(got[key]), want[key]) <= 1e-5, key
    np.testing.assert_array_equal(as_np(got["olens_in"]), np.asarray(want["olens_in"]))


@pytest.mark.parametrize("cls,jcls", [(MatchaTTS, JMatchaTTS), (MatchaTTS_MAS, JMatchaTTS_MAS)])
def test_inference_matches_jax(cls, jcls):
    """feat_gen on the same noise; integer durations and olens exactly. JAX
    runs on the port's state_dict read back by convert_matchatts, the JAX
    package's importer of reference checkpoints."""
    model, variables = jax_model_and_vars(jcls, seed=2)
    b = make_batch(2)
    max_frames = 40
    z = np.random.default_rng(9).normal(size=(2, max_frames, ODIM)).astype(np.float32)
    port = port_of(cls, variables)
    back = convert_matchatts(state_dict_numpy(port), model)
    with inject_cfm_noise(z=z):
        want = japply(model, back, b["xs"], b["ilens"], max_frames, n_timesteps=3, method=jcls.inference)
    got = port.inference(*tensors(b, "xs", "ilens"), max_frames, n_timesteps=3, z=torch.from_numpy(z))
    np.testing.assert_array_equal(as_np(got["duration"]), np.asarray(want["duration"]))
    np.testing.assert_array_equal(as_np(got["olens"]), np.asarray(want["olens"]))
    assert as_np(got["olens"]).min() > 0 and (as_np(got["olens"]) % 2 == 0).all()
    assert scaled_err(as_np(got["feat_gen"]), want["feat_gen"]) <= 1e-4
    assert port.training  # inference leaves the mode as it was


@pytest.mark.parametrize("integration", ["add", "concat"])
def test_speaker_embeddings_match_jax(integration):
    """spk_embed_dim (the JVS Matcha confs set 192): the L2-normalised
    spembs added through ``projection`` or concatenated and projected;
    the encoder output and inference against JAX."""
    extra = dict(spk_embed_dim=6, spk_embed_integration_type=integration)
    model = JMatchaTTS(**CONFIG, **extra)
    b = make_batch(5)
    spembs = np.random.default_rng(5).normal(size=(2, 6)).astype(np.float32)
    variables = randomize(init_shapes(model, b["xs"], b["ilens"], b["ys"], b["olens"], b["ds"], spembs,
                                      deterministic=False), 5)
    variables["params"]["duration_predictor"]["linear"]["bias"][:] = DUR_BIAS
    port = port_of(MatchaTTS, variables, **extra)
    xs, ilens = tensors(b, "xs", "ilens")
    hs, _ = japply(model, variables, b["xs"], b["ilens"], spembs, method=JMatchaTTS.encode)
    with torch.no_grad():
        got_hs, _ = port.eval().encode(xs, ilens, torch.from_numpy(spembs))
    assert scaled_err(as_np(got_hs), hs) <= 1e-5
    z = np.random.default_rng(6).normal(size=(2, 40, ODIM)).astype(np.float32)
    with inject_cfm_noise(z=z):
        want = japply(model, variables, b["xs"], b["ilens"], 40, spembs, n_timesteps=2, method=JMatchaTTS.inference)
    got = port.inference(xs, ilens, 40, torch.from_numpy(spembs), n_timesteps=2, z=torch.from_numpy(z))
    np.testing.assert_array_equal(as_np(got["duration"]), np.asarray(want["duration"]))
    assert scaled_err(as_np(got["feat_gen"]), want["feat_gen"]) <= 1e-4


def test_predicted_durations_clear_of_rounding_boundaries():
    """Guards the inference test's seeds: exp(d) - 1 of every valid token
    stays at least 1e-3 from .5, so reduction-order noise cannot flip a
    duration."""
    for jcls in (JMatchaTTS, JMatchaTTS_MAS):
        model, variables = jax_model_and_vars(jcls, seed=2)
        b = make_batch(2)
        hs, d_masks = japply(model, variables, b["xs"], b["ilens"], method=jcls.encode)
        d_log = japply(model, variables, hs, d_masks, method=lambda m, h, dm: m.duration_predictor(h, dm))
        e = np.exp(np.asarray(d_log)) - 1.0
        assert np.abs(e - np.floor(e) - 0.5)[np.asarray(d_masks)].min() > 1e-3


@pytest.mark.parametrize("jbackend", ["scan", "pallas_interpret"])
def test_matchatts_mas_training_forward_matches_jax(jbackend):
    model, variables = jax_model_and_vars(JMatchaTTS_MAS, seed=3, mas_backend=jbackend)
    b = make_batch(3)
    with inject_cfm_noise(b["t"], b["z"]):
        want, _ = japply(model, variables, b["xs"], b["ilens"], b["ys"], b["olens"], deterministic=False,
                              rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
    port = port_of(MatchaTTS_MAS, variables, mas_backend="scan").train()
    got = port(*tensors(b, "xs", "ilens", "ys", "olens"),
               noise_t=torch.from_numpy(b["t"]), noise_z=torch.from_numpy(b["z"]))
    np.testing.assert_array_equal(as_np(got["ds"]), np.asarray(want["ds"]))
    np.testing.assert_array_equal(as_np(got["ds"]).sum(1), b["olens"])
    for key in ("bin_loss", "log_p_attn", "hs", "d_outs"):
        assert scaled_err(as_np(got[key]), want[key]) <= 1e-5, key
    loss = float(got["cfm_loss"].detach())
    assert abs(loss - float(want["cfm_loss"])) <= 1e-5 * max(1.0, abs(float(want["cfm_loss"])))
    assert got["dur_nll"] is None and want["dur_nll"] is None


def test_mas_refuses_the_stochastic_duration_predictor():
    """The stochastic predictor is ported (``modules/flows.py``, held to
    JAX in tests/test_torch_flows.py): it replaces the conv predictor as
    ``sdp``; only an unknown duration_predictor_type is refused."""
    port = MatchaTTS_MAS(**TINY, duration_predictor_type="stochastic", device="cpu")
    assert hasattr(port, "sdp") and not hasattr(port, "duration_predictor")
    with pytest.raises(ValueError, match="duration_predictor_type"):
        MatchaTTS_MAS(**TINY, duration_predictor_type="flow", device="cpu")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,jcls", [(MatchaTTS, JMatchaTTS), (MatchaTTS_MAS, JMatchaTTS_MAS)])
def test_layout_round_trip_through_the_jax_importer(cls, jcls):
    """convert_matchatts reads the port's state_dict back into the same
    variables, leaf for leaf (test_inference_matches_jax runs JAX on them)."""
    model, variables = jax_model_and_vars(jcls, seed=4)
    port = port_of(cls, variables)
    assert_trees_equal(convert_matchatts(state_dict_numpy(port), model), variables)


def test_initializer_keeps_norms_and_snakebeta_and_draws_with_jax_fans():
    """xavier_uniform on MatchaTTS_MAS: GroupNorm and LayerNorm scales stay
    1, every bias 0, SnakeBeta's log-scale alpha and beta stay 0, as the JAX
    initializer leaves them; every other weight is drawn inside the bound of
    the JAX package's fans of the same leaf (ConvTranspose's [k, out, in]
    included) and reaches most of it."""
    model, variables = jax_model_and_vars(JMatchaTTS_MAS, seed=5)
    want = jinitialize(variables["params"], "xavier_uniform", jax.random.key(3))
    port = port_of(MatchaTTS_MAS, variables)
    initialize(port, "xavier_uniform", seed=1)
    got = convert_matchatts(state_dict_numpy(port), model)["params"]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    kept = drawn = 0
    for path, w in flat_w:
        g = np.asarray(flat_g[path])
        name = str(path[-1].key)
        if name in ("alpha", "beta", "scale", "bias", "embedding") or np.ndim(w) <= 1:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
            kept += 1
            continue
        shape = np.shape(w)
        receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        bound = np.sqrt(6.0 / (shape[-2] * receptive + shape[-1] * receptive))
        assert np.abs(g).max() <= bound * (1 + 1e-6), path
        if g.size >= 64:
            assert np.abs(g).max() >= 0.8 * bound, path
        drawn += 1
    assert kept > 20 and drawn > 20
    fresh = initialize(MatchaTTS_MAS(**TINY, device="cpu"), "xavier_uniform", seed=1)
    est = fresh.decoder.estimator
    snake = est.down_blocks[0][1][0].ff.net[0]
    assert not snake.alpha.detach().any() and not snake.beta.detach().any()
    norm = est.final_block.block[1]
    assert bool((norm.weight == 1).all()) and bool((norm.bias == 0).all())
    assert isinstance(est.up_blocks[0][2].conv, torch.nn.ConvTranspose1d)
