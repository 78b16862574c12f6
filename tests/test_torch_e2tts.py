"""The E2-TTS slice of jatts_torch against jatts_tpu on the CPU: the UNetT
backbone's parts (mish, the sinusoidal time embedding, rotary embedding,
RMSNorm, the time MLP, the convolutional position embedding, the
feed-forward) in f32 and bf16, the text embedding with ids past N and under
``drop_text``, ``E2Attention`` under ``xla`` and ``flash`` (the flash path's
plain twin against JAX's call padded to a multiple of 128, with a row past
its length), the whole UNetT under both backends and its text-embedding
cache, the training loss and ``pred`` with JAX's five draws injected while
JAX traces and the port's ``draw`` monkeypatched, its gradients against
``jax.grad``, CFG inference with sway on injected noise, the spans of
``mask_from_frac_lengths`` integer for integer, the weights through
``convert_e2tts``, and a 2-D key mask at the attention gate.

Small size: dim 32, depth 4, 2 heads of d 64 (the flash kernel's width),
8 mels, B = 3 with ragged lengths, N = 40 frames (S = 41 with the time
token: not a multiple of 128). Both sides run the same numpy-made weights,
carried by ``utils/convert.py:e2tts_state_dict_from_jax``; the JAX applies
are jitted, and the JAX side's attention takes its XLA branch on the CPU
(under ``flash`` after the 128-padding). torch runs on one intra-op thread.

Tolerances (f32 unless stated): outputs and losses to 1e-5 of max(1,
max|JAX's|) (only the summation order differs); gradients relative 1e-4 per
parameter in the norm; bf16: the port's output within 2% of JAX's bf16
output by relative RMS, and no further from the f32 output than JAX's own
bf16 output (1.25x), since bf16 has 8 significant bits and the two
frameworks round at other places. Spans: exact.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.models import e2tts as je2  # noqa: E402
from jatts_tpu.modules import e2tts_backbone as jbb  # noqa: E402
from jatts_tpu.utils.torch_import import convert_e2tts  # noqa: E402
from jatts_torch.models import e2tts  # noqa: E402
from jatts_torch.modules import e2tts_backbone as bb  # noqa: E402
from jatts_torch.modules.attention import MultiHeadedAttention, _flash_ok, _key_mask  # noqa: E402
from jatts_torch.utils.convert import E2TTS_RENAMES, e2tts_state_dict_from_jax, flax_to_state_dict  # noqa: E402
from tests.torch_parity import assert_trees_equal, randomize  # noqa: E402

TINY = dict(idim=20, odim=8, dim=32, depth=4, heads=2, ff_mult=2, pe_attn_head=1)
B, N, NT = 3, 40, 12
LENS = np.array([40, 29, 13], np.int32)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """torch's intra-op threads capped at 1 for each test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def assert_close(got, want, tol=ATOL):
    """max |got - want| <= tol x max(1, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def assert_bf16_close(got, want_bf16, want_f32):
    """The port's bf16 output within 2% of JAX's by relative RMS, and no
    further from the f32 output than JAX's own bf16 output (1.25x)."""
    assert rel(got, want_bf16) <= 0.02, rel(got, want_bf16)
    assert rel(got, want_f32) <= 1.25 * rel(want_bf16, want_f32), (rel(got, want_f32), rel(want_bf16, want_f32))


def t(x):
    return torch.from_numpy(np.asarray(x))


def make_batch(seed=0, nt=NT):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, TINY["idim"], (B, nt)).astype(np.int32)
    text[1, 7:] = -1  # a padded row
    return dict(text=text, feats=rng.normal(size=(B, N, TINY["odim"])).astype(np.float32), lens=LENS.copy())


@pytest.fixture(scope="module")
def weights():
    """JAX E2TTS variables with numpy-made values (the RMSNorm scales
    non-unit) and the port's state_dict of them."""
    jm = je2.E2TTS(**TINY)
    b = make_batch()
    init = jax.jit(lambda k: jm.init({"params": k, "noise": k, "dropout": k}, jnp.asarray(b["text"]),
                                     jnp.asarray(b["feats"]), jnp.asarray(b["lens"]), deterministic=True))
    v = {"params": randomize(init(jax.random.PRNGKey(0))["params"], 1)}
    return v, e2tts_state_dict_from_jax(v, TINY["depth"])


def port_model(sd, **kw):
    m = e2tts.E2TTS(**{**TINY, **kw}, device="cpu")
    m.load_state_dict(sd, strict=True)
    return m.eval()


def net_inputs(seed):
    """UNetT's inputs: x, cond, text, time, drop_audio_cond, drop_text, mask
    (row 1 drops the audio, row 2 the text and the audio)."""
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(B, N, TINY["odim"])).astype(np.float32),
        rng.normal(size=(B, N, TINY["odim"])).astype(np.float32),
        make_batch(seed)["text"],
        np.array([0.1, 0.5, 0.9], np.float32),
        np.array([False, True, True]),
        np.array([False, False, True]),
        np.arange(N)[None] < LENS[:, None],
    ]


def jax_net(v, args, **kw):
    jm = je2.E2TTS(**{**TINY, **kw})
    return np.asarray(jax.jit(lambda v_, a: jm.apply(v_, *a, method=lambda mdl, *x: mdl.net(*x)))(
        v, [jnp.asarray(a) for a in args]))


# ---------------------------------------------------------------------------
# the backbone's parts
# ---------------------------------------------------------------------------


def _flax_part(module, args, seed, **apply_kw):
    """A flax module's numpy-made variables and its jitted output."""
    v = jax.jit(lambda k: module.init(k, *args))(jax.random.PRNGKey(0))
    v = {"params": randomize(v["params"], seed)}
    return v, np.asarray(jax.jit(lambda v_, a: module.apply(v_, *a, **apply_kw))(v, args))


PART_RENAMES = E2TTS_RENAMES + (
    (r"^mlp1$", "time_mlp/0"), (r"^mlp2$", "time_mlp/2"),
    (r"^conv1$", "conv1d/0"), (r"^conv2$", "conv1d/2"),
    (r"^to_out$", "to_out/0"),
    (r"^proj_in$", "ff/0/0"), (r"^proj_out$", "ff/2"),
)


def _part(name, dtype):
    """(flax module, port module, inputs) of one backbone part."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, N, 32)).astype(np.float32) * 2
    if name == "rmsnorm":
        return jbb.RMSNorm(), bb.RMSNorm(32), [x.astype(jnp.bfloat16) if dtype == torch.bfloat16 else x]
    if name == "time_embed":
        time = np.array([0.0, 0.37, 1.0], np.float32)
        return jbb.TimestepEmbedding(32, dtype=jdt), bb.TimestepEmbedding(32, compute_dtype=dtype), [time]
    if name == "conv_pos_embed":
        return (jbb.ConvPositionEmbedding(32, dtype=jdt), bb.ConvPositionEmbedding(32, compute_dtype=dtype),
                [x])
    if name == "feed_forward":
        return jbb.E2FeedForward(32, 2, dtype=jdt), bb.E2FeedForward(32, 2, compute_dtype=dtype), [x]
    raise ValueError(name)


@pytest.mark.parametrize("name", ["rmsnorm", "time_embed", "conv_pos_embed", "feed_forward"])
def test_backbone_part_matches_flax_f32_and_bf16(name):
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        jmod, mod, args = _part(name, dtype)
        v, want = _flax_part(jmod, [jnp.asarray(a) for a in args], 3)
        sd = flax_to_state_dict(v, PART_RENAMES)
        mod.load_state_dict(sd, strict=True)
        got = mod.eval()(*[t(np.asarray(a, np.float32)).to(dtype) if a.dtype == jnp.bfloat16 else t(a) for a in args])
        assert got.dtype == dtype
        outs[dtype] = (got.detach().float().numpy(), want.astype(np.float32))
    assert_close(*outs[torch.float32])
    got16, want16 = outs[torch.bfloat16]
    assert_bf16_close(got16, want16, outs[torch.float32][1])


def test_functions_match_jax():
    """mish, the sinusoidal embedding (scale 1000, denominator half - 1),
    the float64 rotary table and the interleaved rotation."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 3, 50, 64)) * 4).astype(np.float32)
    assert_close(bb.mish(t(x)).numpy(), np.asarray(jbb.mish(jnp.asarray(x))))
    time = np.array([0.0, 0.013, 0.5, 1.0], np.float32)
    # the angles reach 1000 rad, where one f32 ulp is 6.1e-5, and the two
    # exp implementations differ by an ulp on some frequencies: two ulps
    assert_close(bb.sinus_position_embedding(t(time), 256).numpy(),
                 np.asarray(jbb.sinus_position_embedding(jnp.asarray(time), 256)), tol=2 * 2.0 ** -14)
    freqs = bb.rotary_freqs(50, 64)
    assert freqs.dtype == np.float64
    np.testing.assert_array_equal(freqs, jbb.rotary_freqs(50, 64))
    want = np.asarray(jbb.apply_rope(jnp.asarray(x), jnp.asarray(freqs, jnp.float32)))
    got = bb.apply_rope(t(x), *bb.rope_tables(50, 64, torch.float32, "cpu"))
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("nt", [NT, 55])
def test_text_embedding_pads_cuts_and_drops(weights, nt):
    """ids + 1 (pad -1 -> filler 0), padded with the filler to N or cut to N
    (nt 55 > N 40), all filler under drop_text; exact against flax."""
    v, sd = weights
    args = net_inputs(11)
    args[2] = make_batch(11, nt=nt)["text"]
    jm = je2.E2TTS(**TINY)
    want = np.asarray(jax.jit(lambda a: jm.apply(v, *a, return_text_embed=True,
                                                 method=lambda mdl, *x, **k: mdl.net(*x, **k)))(
        [jnp.asarray(a) for a in args]))
    got = port_model(sd).backbone(*[t(a) for a in args], return_text_embed=True)
    assert got.shape == (B, N, TINY["odim"])
    np.testing.assert_array_equal(got.detach().numpy(), want)
    filler = sd["backbone.text_embed.text_embed.weight"][0].numpy()
    assert (got[2].detach().numpy() == filler).all()  # row 2 drops its text


# ---------------------------------------------------------------------------
# attention and the whole UNetT
# ---------------------------------------------------------------------------


def _attn_case(seed):
    rng = np.random.default_rng(seed)
    s = 41  # the time token and 40 frames: not a multiple of 128
    x = rng.normal(size=(B, s, 32)).astype(np.float32)
    mask = np.arange(s)[None] < np.array([41, 30, 14])[:, None]
    return x, mask


def test_text_table_gradient_is_the_embedding_gradient_in_one_product():
    """The table's gradient is one_hot(ids)^T . grad (one product in a fixed
    order: the embedding's own backward adds rows with atomics on the card);
    the lookup is the embedding's bit for bit, the gradient within f32
    rounding of it, with the filler row taking most of the positions."""
    rng = np.random.default_rng(3)
    weight = torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32)).requires_grad_()
    ids = torch.from_numpy(np.where(rng.random((3, 40)) < 0.7, 0, rng.integers(1, 9, (3, 40))))
    grad = torch.from_numpy(rng.normal(size=(3, 40, 5)).astype(np.float32))
    out = bb._TableLookup.apply(weight, ids)
    (got,) = torch.autograd.grad(out, weight, grad)
    want_out = torch.nn.functional.embedding(ids, weight)
    (want,) = torch.autograd.grad(want_out, weight, grad)
    assert torch.equal(out, want_out)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6) and not torch.all(got == 0)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_e2_attention_matches_jax_padded_call(backend):
    """E2Attention on S = 41 against JAX's on the sequence padded to 128
    (the JAX flash path's padding, pad keys masked), sliced back: the port
    pads nothing. Rows past their length are 0 on both sides."""
    x, mask = _attn_case(2)
    jmod = jbb.E2Attention(32, 2, 64, 1, dropout_rate=0.0)
    s_pad = 128
    xp = np.pad(x, ((0, 0), (0, s_pad - x.shape[1]), (0, 0)))
    mp = np.pad(mask, ((0, 0), (0, s_pad - x.shape[1])))
    freqs = jnp.asarray(jbb.rotary_freqs(s_pad, 64), jnp.float32)
    v = jax.jit(lambda k: jmod.init(k, jnp.asarray(xp), freqs, jnp.asarray(mp)))(jax.random.PRNGKey(0))
    v = {"params": randomize(v["params"], 4)}
    want = np.asarray(jax.jit(lambda v_: jmod.apply(v_, jnp.asarray(xp), freqs, jnp.asarray(mp)))(v))[:, :41]
    mod = bb.E2Attention(32, 2, 64, 1, dropout_rate=0.0, attn_backend=backend)
    mod.load_state_dict(flax_to_state_dict(v, PART_RENAMES), strict=True)
    got = mod(t(x), bb.rope_tables(41, 64, torch.float32, "cpu"), t(mask)).detach().numpy()
    assert_close(got, want)
    assert (got[2, 14:] == 0).all() and (want[2, 14:] == 0).all()


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_unett_matches_jax(weights, backend):
    """The whole UNetT on S = 41: under flash JAX pads to 128 and the port
    does not, and no output row changes."""
    v, sd = weights
    args = net_inputs(12)
    want = jax_net(v, args, attn_backend=backend)
    got = port_model(sd, attn_backend=backend).backbone(*[t(a) for a in args])
    assert got.dtype == torch.float32
    assert_close(got.detach().numpy(), want)


def test_unett_bf16_matches_jax(weights):
    v, sd = weights
    args = net_inputs(13)
    want32 = jax_net(v, args)
    want16 = jax_net(v, args, dtype=jnp.bfloat16, attn_backend="flash")
    m = port_model(sd, dtype=torch.bfloat16, attn_backend="flash")
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    got = m.backbone(*[t(a) for a in args])
    assert got.dtype == torch.float32
    assert_bf16_close(got.detach().numpy(), want16, want32)


def test_unett_text_embed_cache_is_exact(weights):
    """UNetT with a precomputed text embedding equals the self-computing
    call bit for bit, for both CFG branches."""
    _, sd = weights
    net = port_model(sd).backbone
    args = [t(a) for a in net_inputs(14)]
    for drop in (torch.zeros(B, dtype=torch.bool), torch.ones(B, dtype=torch.bool)):
        a = args[:4] + [drop, drop, args[6]]
        want = net(*a)
        te = net(*a, return_text_embed=True)
        assert torch.equal(net(*a, text_embed=te), want)


# ---------------------------------------------------------------------------
# the draws, the training loss, inference
# ---------------------------------------------------------------------------


def make_draws(seed):
    """The training forward's five draws, in the JAX model's order: the
    span fraction (in [0.7, 1)) and start, x0, t, the audio and the
    both-drop uniforms (row 0 drops the audio, row 1 both)."""
    rng = np.random.default_rng(seed)
    return dict(
        uniform=[rng.uniform(0.7, 1.0, B).astype(np.float32), rng.uniform(0, 1, B).astype(np.float32),
                 rng.uniform(0, 1, B).astype(np.float32), np.array([0.1, 0.9, 0.8], np.float32),
                 np.array([0.9, 0.05, 0.7], np.float32)],
        normal=[rng.normal(size=(B, N, TINY["odim"])).astype(np.float32)],
    )


@contextlib.contextmanager
def inject_draws(monkeypatch, draws):
    """``jax.random.uniform`` and ``jax.random.normal`` return ``draws``
    while JAX traces inside the block, and the port's ``draw`` returns the
    same arrays; each kind cycles through its list, so every trace and
    every call sees the same values (shapes checked)."""
    seen = {"uniform": 0, "normal": 0}

    def take(kind, shape):
        want = draws[kind][seen[kind] % len(draws[kind])]
        seen[kind] += 1
        assert tuple(shape) == want.shape, (kind, shape, want.shape)
        return want

    def juniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(take("uniform", shape), dtype)

    def jnormal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(take("normal", shape), dtype)

    def port_draw(kind, shape, generator, device, low=0.0, high=1.0):
        return torch.from_numpy(take(kind, shape)).to(device)

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "uniform", juniform)
        mp.setattr(jax.random, "normal", jnormal)
        mp.setattr(e2tts, "draw", port_draw)
        yield seen


def test_mask_from_frac_lengths_is_integer_exact(monkeypatch):
    """The same draws give the same spans; fractions whose product with the
    length lies a hair under an integer in f32 take the f32 floor on both
    sides."""
    seq = np.array([40, 29, 13, 1, 100, 7], np.int32)
    frac = np.array([0.7, 0.99999994, 0.7692307, 0.75, 0.81, 0.857142857], np.float32)
    u = np.array([0.0, 0.5, 0.99999994, 0.3, 0.123, 0.999], np.float32)
    with inject_draws(monkeypatch, {"uniform": [frac, u], "normal": []}):
        want = np.asarray(jax.jit(lambda s: je2.mask_from_frac_lengths(jax.random.PRNGKey(0), s, 0.7, 1.0, 120))(
            jnp.asarray(seq)))
        got = e2tts.mask_from_frac_lengths(t(seq), 0.7, 1.0, 120).numpy()
    np.testing.assert_array_equal(got, want)
    lengths = (frac * seq.astype(np.float32)).astype(np.int32)
    np.testing.assert_array_equal(got.sum(1), lengths)


def test_draws_are_the_generator_s():
    """Without a patch the draws come from the generator: the same seed
    gives the same spans and loss, and a uniform keeps to [low, high)."""
    g = torch.Generator().manual_seed(3)
    u = e2tts.draw("uniform", (1000,), g, "cpu", 0.7, 1.0)
    assert float(u.min()) >= 0.7 and float(u.max()) < 1.0
    seq = torch.tensor([40, 29, 13])
    a = e2tts.mask_from_frac_lengths(seq, 0.7, 1.0, 40, torch.Generator().manual_seed(5))
    b = e2tts.mask_from_frac_lengths(seq, 0.7, 1.0, 40, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


def _jax_loss(v, batch, **kw):
    jm = je2.E2TTS(**{**TINY, **kw})
    return jm.apply(v, jnp.asarray(batch["text"]), jnp.asarray(batch["feats"]), jnp.asarray(batch["lens"]),
                    deterministic=True, rngs={"noise": jax.random.PRNGKey(1)})


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_training_loss_and_gradients_match_jax(weights, monkeypatch, backend):
    """The loss, ``cond`` and ``pred`` with the five draws injected on both
    sides (dropout off), and the gradients against jax.grad."""
    v, sd = weights
    batch = make_batch(21)
    with inject_draws(monkeypatch, make_draws(22)) as seen:
        want = jax.jit(lambda v_: _jax_loss(v_, batch, attn_backend=backend))(v)
        jgrad = jax.jit(jax.grad(lambda p: _jax_loss({"params": p}, batch, attn_backend=backend)["loss"]))(
            v["params"])
        m = port_model(sd, attn_backend=backend)
        got = m(t(batch["text"]).long(), t(batch["feats"]), t(batch["lens"]).long())
        assert seen == {"uniform": 15, "normal": 3}  # two JAX traces and the port's call
    assert_close(got["cond"].numpy(), want["cond"])
    assert_close(got["pred"].detach().numpy(), want["pred"])
    assert_close(float(got["loss"].detach()), float(want["loss"]))
    want_g = e2tts_state_dict_from_jax({"params": jax.device_get(jgrad)}, TINY["depth"])
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(got["loss"], params)
    assert set(names) == set(want_g)
    for name, g in zip(names, grads):
        assert rel(g.numpy(), want_g[name].numpy()) <= 1e-4, (name, rel(g.numpy(), want_g[name].numpy()))


def test_bf16_training_loss_matches_jax(weights, monkeypatch):
    v, sd = weights
    batch = make_batch(23)
    with inject_draws(monkeypatch, make_draws(24)):
        want16 = jax.jit(lambda v_: _jax_loss(v_, batch, dtype=jnp.bfloat16, attn_backend="flash"))(v)
        want32 = jax.jit(lambda v_: _jax_loss(v_, batch))(v)
        got = port_model(sd, dtype=torch.bfloat16, attn_backend="flash")(
            t(batch["text"]).long(), t(batch["feats"]), t(batch["lens"]).long())
    assert got["pred"].dtype == torch.float32
    assert_bf16_close(got["pred"].detach().numpy(), want16["pred"], want32["pred"])
    np.testing.assert_allclose(float(got["loss"].detach()), float(want16["loss"]), rtol=2e-2)


@pytest.mark.parametrize("cfg", [2.0, 0.0])
def test_inference_with_cfg_and_sway_matches_jax(weights, monkeypatch, cfg):
    """4 Euler steps, sway -1, CFG 2 (one doubled-batch forward a step) and
    0 (one plain forward), on injected noise: the output, the kept prompt
    frames and the zeros past each duration."""
    v, sd = weights
    rng = np.random.default_rng(31)
    t_max = 48
    cond = rng.normal(size=(B, t_max, TINY["odim"])).astype(np.float32)
    text = make_batch(31)["text"]
    ref, dur = np.array([8, 0, 20], np.int32), np.array([40, 33, 60], np.int32)  # 60 clips to 48
    y0 = rng.normal(size=(B, t_max, TINY["odim"])).astype(np.float32)
    jm = je2.E2TTS(**TINY)
    with inject_draws(monkeypatch, {"uniform": [], "normal": [y0]}):
        want = jax.jit(lambda: jm.apply(v, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(ref), jnp.asarray(dur),
                                        4, cfg, -1.0, method=je2.E2TTS.inference,
                                        rngs={"noise": jax.random.PRNGKey(0)}))()
        got = port_model(sd).inference(t(cond), t(text).long(), t(ref).long(), t(dur).long(), steps=4,
                                       cfg_strength=cfg, sway_sampling_coef=-1.0)
    np.testing.assert_array_equal(got["olens"].numpy(), [40, 33, 48])
    out = got["feat_gen"].numpy()
    assert_close(out, want["feat_gen"])
    np.testing.assert_array_equal(out[0, :8], cond[0, :8])
    assert (out[1, 33:] == 0).all()


def test_state_dict_round_trips_through_convert_e2tts(weights):
    """e2tts_state_dict_from_jax inverts convert_e2tts: skip projections on
    the later half only, RMSNorm scales under ``.weight``, grouped
    convolution kernels [C, C/16, 31]."""
    v, sd = weights
    d = TINY["depth"]
    assert [f"backbone.layers.{i}.0.weight" in sd for i in range(d)] == [False, False, True, True]
    assert sd["backbone.input_embed.conv_pos_embed.conv1d.0.weight"].shape == (32, 2, 31)
    assert sd["backbone.text_embed.text_embed.weight"].shape == (TINY["idim"] + 1, TINY["odim"])
    m = port_model(sd)
    back = convert_e2tts({k: x.numpy() for k, x in m.state_dict().items()}, je2.E2TTS(**TINY))
    assert_trees_equal(back["params"], v["params"])


def test_use_remat_raises():
    with pytest.raises(NotImplementedError, match="use_remat"):
        e2tts.E2TTS(**TINY, use_remat=True, device="cpu")


# ---------------------------------------------------------------------------
# the attention gate's 2-D key mask
# ---------------------------------------------------------------------------


def test_two_d_key_mask_takes_the_kernel_route():
    """[B, N] and [B, 1, N] key masks pass the flash gate alike, give K1 the
    same [B, N] mask, and the same output; a [B, N, N] mask does not pass."""
    rng = np.random.default_rng(41)
    mask2 = t(np.arange(30)[None] < np.array([30, 17, 5])[:, None])
    mask3 = mask2[:, None]
    for backend in ("flash", "auto", "xla"):
        assert _flash_ok(backend, mask2, 4096) == _flash_ok(backend, mask3, 4096)
    assert _flash_ok("flash", mask2, 30) and not _flash_ok("flash", mask2[:, None].expand(3, 30, 30), 30)
    assert torch.equal(_key_mask(mask2), _key_mask(mask3)) and _key_mask(mask2).shape == (3, 30)
    mha = MultiHeadedAttention(2, 32, attn_backend="flash")
    x = t(rng.normal(size=(3, 30, 32)).astype(np.float32))
    assert torch.equal(mha(x, x, x, mask2), mha(x, x, x, mask3))
