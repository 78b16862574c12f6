"""K1r and the latest rel-pos attention against the JAX package on the CPU.

K1r is the fused rel-pos form of the flash-attention kernels: q and k of
width d_qk = d_k + n_feat, v and the output of width d_v = d_k, no bias
(``jatts_tpu/modules/attention.py:372-385``). Its plain versions
(``flash_attention_ref`` / ``flash_attention_bwd_ref``) are held to the
Pallas kernel's own reference, ``mha_reference``, fed as
``_flash_attend`` feeds the TPU kernel: v zero-padded to d_qk, the output
sliced back to d_v; and to its VJP. The kernels themselves are compared with
these plain versions on the card (``tests/test_torch_package.py``, ``cuda``
marker, and ``chip_smoke.py``).

Then ``rel_shift_gather`` and ``relpos_fused_features`` against JAX, the
latest ``RelPositionMultiHeadedAttention`` under ``xla``, ``flash`` (the
fused features through the plain K1r on CPU tensors) and ``auto`` against
the JAX module's eager output and against the JAX fused computation rebuilt
from ``relpos_fused_features`` + ``mha_reference`` (the JAX module's own
fused branch needs a TPU), and the latest ``ConformerEncoder`` in eval and
training mode. Weights are made with numpy from a seed and carried by
``utils/convert.py``.

Tolerances: the plain K1r versions against ``mha_reference`` and its VJP,
rtol = atol = 1e-5 (f32, summation order only); ``rel_shift_gather`` is
data movement, equal; the fused features rtol = atol = 1e-5 of their
largest magnitude; the attention and conformer outputs rtol = atol = 1e-4,
the JAX package's own tolerance for its fused path
(``tests/test_attention_fused_relpos.py``), and the same for the eager path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import vjp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference  # noqa: E402

from jatts_tpu.modules.attention import RelPositionMultiHeadedAttention as JRelMHA  # noqa: E402
from jatts_tpu.modules.attention import rel_shift_gather as j_rel_shift_gather  # noqa: E402
from jatts_tpu.modules.attention import relpos_fused_features as j_relpos_fused_features  # noqa: E402
from jatts_tpu.modules.conformer import ConformerEncoder as JConformer  # noqa: E402
from jatts_tpu.modules.positional import RelPositionalEncoding as JRelPE  # noqa: E402
from jatts_tpu.ops.masks import attn_mask as jattn_mask  # noqa: E402
from jatts_torch.modules.attention import (  # noqa: E402
    RelPositionMultiHeadedAttention,
    rel_shift_gather,
    relpos_fused_features,
)
from jatts_torch.modules.conformer import ConformerEncoder  # noqa: E402
from jatts_torch.modules.positional import RelPositionalEncoding, rel_sinusoid_table  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402
from jatts_torch.ops.masks import attn_mask  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax, flax_to_state_dict  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

K1R_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
B, H, T = 3, 2, 77
LENS = np.array([T, 40, 9])  # full, ragged, short
PAIRS = [(24, 8), (192, 64), (576, 192)]  # (d_qk, d_v): d_k + n_feat, d_k for 2 heads


def _k1r_inputs(d_qk, d_v, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, H, T, d_qk)).astype(np.float32) for _ in range(2))
    v, do = (rng.normal(size=(B, H, T, d_v)).astype(np.float32) for _ in range(2))
    mask = np.arange(T)[None, :] < LENS[:, None]
    do = do * mask[:, None, :, None]  # padded rows are discarded downstream: no gradient
    return q, k, v, mask, do


def _jax_k1r(q, k, v, mask, do, sm_scale):
    """``mha_reference`` on the TPU wrapper's padded call (v zero-padded to
    d_qk, the output sliced to d_v), segment ids 1 on valid / 0 on padded
    positions, and its VJP -> (out, [dq, dk, dv]). Its VJP takes only
    ``sm_scale = 1``, so q comes in pre-scaled (the same function)."""
    d_qk, d_v = q.shape[-1], v.shape[-1]
    seg = jnp.asarray(mask.astype(np.int32))
    ids = SegmentIds(q=seg, kv=seg)

    def f(q, k, v):
        vp = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, d_qk - d_v)))
        return mha_reference(q * sm_scale, k, vp, None, ids, sm_scale=1.0)[..., :d_v]

    out, pullback = vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in pullback(jnp.asarray(do))]


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_k1r_plain_versions_match_mha_reference(d_qk, d_v):
    """Forward on valid rows (the reference's padded rows attend padded
    keys, the port's attend the valid ones) and dq, dk, dv everywhere."""
    q, k, v, mask, do = _k1r_inputs(d_qk, d_v, seed=d_qk)
    scale = d_v ** -0.5
    want_out, want = _jax_k1r(q, k, v, mask, do, scale)
    o, lse = k1.flash_attention_ref(_t(q), _t(k), _t(v), None, _t(mask), scale, return_lse=True)
    assert o.shape == (B, H, T, d_v) and torch.isfinite(lse).all()
    rows = np.broadcast_to(mask[:, None, :, None], o.shape)
    np.testing.assert_allclose(o.numpy()[rows], want_out[rows], **K1R_TOL)
    got = k1.flash_attention_bwd_ref(_t(q), _t(k), _t(v), None, _t(mask), scale, o, lse, _t(do))
    assert got[3] is None
    for name, g, w, width in zip(("dq", "dk", "dv"), got, want, (d_qk, d_qk, d_v)):
        assert g.shape[-1] == width, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **K1R_TOL)


def test_k1r_backward_matches_autograd_of_the_plain_forward():
    q, k, v, mask, do = _k1r_inputs(192, 64, seed=1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    scale = 64 ** -0.5
    want = torch.autograd.grad(k1.flash_attention_ref(*leaves, None, _t(mask), scale), leaves, _t(do))
    o, lse = k1.flash_attention_ref(_t(q), _t(k), _t(v), None, _t(mask), scale, return_lse=True)
    got = k1.flash_attention_bwd_ref(_t(q), _t(k), _t(v), None, _t(mask), scale, o, lse, _t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **K1R_TOL)


def test_k1r_autograd_route_on_cpu_matches_the_reference_vjp():
    """``flash_attention`` on CPU tensors trains through the plain version;
    its gradients equal the reference VJP's, and it launches nothing."""
    q, k, v, mask, do = _k1r_inputs(192, 64, seed=2)
    _, want = _jax_k1r(q, k, v, mask, do, 0.125)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, None, _t(mask), 0.125)
    got = torch.autograd.grad(out, leaves, _t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **K1R_TOL)
    assert (k1.launches_relpos, k1.launches_bwd_dkv_relpos, k1.launches_bwd_dq_relpos) == (0, 0, 0)


def test_k1r_row_that_sees_no_key_is_zero():
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(2, 2, 12, 24)).astype(np.float32)) for _ in range(2))
    v, do = (torch.from_numpy(rng.normal(size=(2, 2, 12, 8)).astype(np.float32)) for _ in range(2))
    mask = torch.stack([torch.arange(12) < 12, torch.zeros(12, dtype=torch.bool)])
    o, lse = k1.flash_attention_ref(q, k, v, None, mask, 8 ** -0.5, return_lse=True)
    assert torch.all(o[1] == 0) and torch.isinf(lse[1]).all() and torch.isfinite(lse[0]).all()
    dq, dk, dv, _ = k1.flash_attention_bwd_ref(q, k, v, None, mask, 8 ** -0.5, o, lse, do)
    assert torch.all(dq[1] == 0) and torch.all(dk[1] == 0) and torch.all(dv[1] == 0)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def test_k1r_wrapper_checks_widths():
    q = torch.zeros(1, 2, 4, 24)
    with pytest.raises(ValueError, match="do not match"):
        k1.flash_attention(q, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8))
    # on the CPU any d_v goes through the plain version
    assert k1.flash_attention(q, q, torch.zeros(1, 2, 4, 8)).shape == (1, 2, 4, 8)
    assert (576, 192) in k1.RELPOS_PAIRS and (192, 64) in k1.RELPOS_PAIRS


@pytest.mark.parametrize("t", [1, 13, 40])
def test_rel_shift_gather_matches_jax(t):
    x = np.random.default_rng(t).normal(size=(2, 3, t, 2 * t - 1)).astype(np.float32)
    want = np.asarray(j_rel_shift_gather(jnp.asarray(x), t))
    got = rel_shift_gather(torch.from_numpy(x), t)
    np.testing.assert_array_equal(got.numpy(), want)


def test_relpos_fused_features_match_jax_and_the_shifted_bias():
    b, h, t, dk = 2, 4, 24, 8
    n_feat = h * dk
    rng = np.random.default_rng(0)
    q_v = rng.standard_normal((b, h, t, dk)).astype(np.float32)
    w_pos = rng.standard_normal((n_feat, n_feat)).astype(np.float32)
    want_ut, want_phi = (np.asarray(x) for x in j_relpos_fused_features(jnp.asarray(q_v), jnp.asarray(w_pos), t, n_feat))
    ut, phi = relpos_fused_features(torch.from_numpy(q_v), torch.from_numpy(w_pos), t, n_feat)
    assert ut.shape == (b, h, t, n_feat) and phi.shape == (t, n_feat)
    for got, want in ((ut, want_ut), (phi, want_phi)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the identity itself: u~ . phi^T == rel_shift_gather(q_v . p^T)
    pos_emb = torch.from_numpy(rel_sinusoid_table(t, n_feat).astype(np.float32))
    p = (pos_emb @ torch.from_numpy(w_pos)).reshape(1, 2 * t - 1, h, dk).transpose(1, 2)
    bd = rel_shift_gather(torch.from_numpy(q_v) @ p.transpose(-1, -2), t)
    np.testing.assert_allclose((ut @ phi.T).numpy(), bd.numpy(), **TOL)


def _attention_setup(seed=0, b=2, t=16, n_feat=32, h=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, n_feat)).astype(np.float32)
    xs, pos_emb = JRelPE(n_feat, 0.0).apply({}, jnp.asarray(x), deterministic=True)
    mod = JRelMHA(n_head=h, n_feat=n_feat, dropout_rate=0.0)
    variables = randomize(mod.init({"params": jax.random.key(0)}, xs, xs, xs, pos_emb, deterministic=True), seed + 1)
    mask = np.array([[True] * t, [True] * (t - 5) + [False] * 5])[:, None, :]
    return x, xs, pos_emb, mod, variables, mask


def test_relpos_encoding_table_matches_jax():
    """The port's encoding gives the JAX one's scaled input and its
    [1, 2T-1, d] table (positions T-1 … -(T-1))."""
    x, xs, pos_emb, *_ = _attention_setup()
    got_x, got_pe = RelPositionalEncoding(x.shape[-1]).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(xs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_pe.numpy(), np.asarray(pos_emb), rtol=1e-6, atol=1e-6)
    assert got_pe.shape == (1, 2 * x.shape[1] - 1, x.shape[-1])


@pytest.mark.parametrize("backend", ["xla", "flash", "auto"])
def test_relpos_attention_matches_jax_module(backend):
    """Every backend against the JAX module's eager output on all rows."""
    _, xs, pos_emb, mod, variables, mask = _attention_setup()
    want = np.asarray(mod.apply(variables, xs, xs, xs, pos_emb, jnp.asarray(mask), deterministic=True))
    port = RelPositionMultiHeadedAttention(4, 32, attn_backend=backend)
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    port.eval()
    t_xs, t_pe = torch.from_numpy(np.array(xs)), torch.from_numpy(np.array(pos_emb))
    with torch.no_grad():
        got = port(t_xs, t_xs, t_xs, t_pe, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_relpos_attention_flash_matches_the_jax_fused_computation():
    """The port's flash branch against the JAX fused branch rebuilt from its
    parts: ``relpos_fused_features`` on the module's parameters, the
    concatenated q and k, and ``mha_reference`` on the padded call. Valid
    rows (the reference's padded rows attend padded keys)."""
    _, xs, pos_emb, _, variables, mask = _attention_setup(seed=3)
    p = variables["params"]
    b, t, n_feat, h = 2, 16, 32, 4
    dk = n_feat // h

    def proj(name):
        y = xs @ p[name]["kernel"] + p[name]["bias"]
        return y.reshape(b, t, h, dk).transpose(0, 2, 1, 3)

    q, k, v = proj("linear_q"), proj("linear_k"), proj("linear_v")
    q_u = q + p["pos_bias_u"][None, :, None, :]
    q_v = q + p["pos_bias_v"][None, :, None, :]
    ut, phi = j_relpos_fused_features(q_v, p["linear_pos"]["kernel"], t, n_feat)
    q_cat = np.asarray(jnp.concatenate([q_u, ut], axis=-1))
    k_cat = np.asarray(jnp.concatenate([k, jnp.broadcast_to(phi[None, None], (b, h, t, n_feat))], axis=-1))
    out, _ = _jax_k1r(q_cat, k_cat, np.asarray(v), mask[:, 0], np.zeros((b, h, t, dk), np.float32), dk ** -0.5)
    want = out.transpose(0, 2, 1, 3).reshape(b, t, n_feat) @ p["linear_out"]["kernel"] + p["linear_out"]["bias"]

    port = RelPositionMultiHeadedAttention(h, n_feat, attn_backend="flash")
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    t_xs = torch.from_numpy(np.array(xs))
    with torch.no_grad():
        got = port(t_xs, t_xs, t_xs, torch.from_numpy(np.array(pos_emb)), torch.from_numpy(mask)).numpy()
    valid = mask[:, 0]
    np.testing.assert_allclose(got[valid], np.asarray(want)[valid], **TOL)


def _conformer_cfg(**extra):
    return dict(
        attention_dim=32, attention_heads=2, linear_units=48, num_blocks=2, input_layer=None,
        pos_enc_layer_type="rel_pos", selfattention_layer_type="rel_selfattn",
        cnn_module_kernel=7, dropout_rate=0.0, positional_dropout_rate=0.0,
        attention_dropout_rate=0.0, **extra,
    )


def _conformer_state_dict(variables):
    wrapped = {c: {"encoder": tree} for c, tree in variables.items()}
    return {k[len("encoder."):]: v for k, v in fastspeech2_state_dict_from_jax(wrapped).items()}


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("train", [False, True])
def test_latest_conformer_matches_jax(backend, train):
    """The latest conformer (rel_pos + rel_selfattn) in eval mode and in
    training mode (dropout 0, BatchNorm on batch statistics, flax's
    ``mutable=["batch_stats"]``), on a ragged batch."""
    t, lens = 21, np.array([21, 14, 5])
    xs = np.random.default_rng(4).normal(size=(len(lens), t, 32)).astype(np.float32)
    cfg = _conformer_cfg()
    jmod = JConformer(**cfg)
    mask_j = jattn_mask(jnp.asarray(lens), t)
    variables = randomize(jmod.init(jax.random.key(0), jnp.asarray(xs), mask_j), 5)
    if train:
        want, _ = jmod.apply(variables, jnp.asarray(xs), mask_j, deterministic=False,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.key(1)})
    else:
        want = jmod.apply(variables, jnp.asarray(xs), mask_j)
    port = ConformerEncoder(attn_backend=backend, **cfg)
    port.load_state_dict(_conformer_state_dict(variables), strict=True)
    port.train(train)
    with torch.set_grad_enabled(train):
        got = port(torch.from_numpy(xs), attn_mask(torch.from_numpy(lens), t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_latest_conformer_flash_gradients_match_xla():
    """Training through the fused branch (plain K1r on the CPU) gives the
    eager branch's gradients: the decomposition is exact."""
    t, lens = 17, np.array([17, 9])
    rng = np.random.default_rng(6)
    xs = torch.from_numpy(rng.normal(size=(2, t, 32)).astype(np.float32))
    grads = {}
    for backend in ("xla", "flash"):
        torch.manual_seed(0)
        port = ConformerEncoder(attn_backend=backend, **_conformer_cfg())
        out = port(xs, attn_mask(torch.from_numpy(lens), t))
        params = list(port.parameters())
        grads[backend] = torch.autograd.grad((out ** 2).sum(), params)
    for gx, gf in zip(grads["xla"], grads["flash"]):
        np.testing.assert_allclose(gf.numpy(), gx.numpy(), rtol=1e-4, atol=1e-4 * max(1.0, gx.abs().max().item()))
