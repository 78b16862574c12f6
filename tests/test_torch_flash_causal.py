"""K1b: the causal form of the flash-attention plain versions
(``flash_attention_ref`` / ``flash_attention_bwd_ref`` with ``causal=True``)
and of the ``FlashAttention`` route on CPU tensors, against the Pallas
kernel's own reference, ``mha_reference(..., causal=True, segment_ids=...)``,
and its VJP, on a batch with a ragged key mask, at head dims 64 and 192,
with and without a bias. The kernels are compared with these plain versions
on the card (``tests/test_torch_package.py``, ``cuda`` marker, and
``chip_smoke.py`` phase 11).

``mha_reference``'s VJP takes only ``sm_scale = 1``, so both sides get q
and the bias pre-scaled by ``d ** -0.5`` there (the same function). Its
segment ids let a padded query row attend the padded keys; the port's rows
attend the valid keys, so forward outputs are compared on valid rows, and
the output gradient is 0 on padded rows (what the VALL-E trunk's ``* m``
gives), where both sides' gradients then agree everywhere.

Tolerances: f32 on both sides, only the summation order differs:
rtol = atol = 2e-5 on values of magnitude <= ~5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import vjp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference  # noqa: E402

from jatts_torch.ops import flash_attention as k1  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
B, H, T = 3, 2, 77
LENS = np.array([T, 40, 9])  # full, ragged, short


def _inputs(d, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, T, d)).astype(np.float32) for _ in range(4))
    ab = (rng.normal(size=(B, H, T, T)) * np.sqrt(d)).astype(np.float32) if with_bias else None
    mask = np.arange(T)[None, :] < LENS[:, None]
    do = do * mask[:, None, :, None]  # the trunk's `* m`: no gradient from padded rows
    return q, k, v, ab, mask, do


def _jax_reference(q, k, v, ab, mask, do):
    """mha_reference (causal, segment ids 1 on valid / 0 on padded) and its
    VJP -> (out, [dq, dk, dv, dab])."""
    scale = q.shape[-1] ** -0.5
    seg = jnp.asarray(mask.astype(np.int32))
    ids = SegmentIds(q=seg, kv=seg)

    def f(q, k, v, ab):
        return mha_reference(q * scale, k, v, None if ab is None else ab * scale, ids,
                             causal=True, sm_scale=1.0)

    args = [jnp.asarray(x) for x in (q, k, v)] + [None if ab is None else jnp.asarray(ab)]
    out, pullback = vjp(f, *args)
    return np.asarray(out), [None if g is None else np.asarray(g) for g in pullback(jnp.asarray(do))]


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("d", [64, 192])
@pytest.mark.parametrize("with_bias", [False, True])
def test_causal_plain_versions_match_mha_reference(d, with_bias):
    q, k, v, ab, mask, do = _inputs(d, with_bias, seed=d)
    want_out, want = _jax_reference(q, k, v, ab, mask, do)
    tq, tk, tv, tab, tmask, tdo = (_t(x) for x in (q, k, v, ab, mask, do))
    scale = d ** -0.5
    o, lse = k1.flash_attention_ref(tq, tk, tv, tab, tmask, scale, return_lse=True, causal=True)
    rows = np.broadcast_to(mask[:, None, :, None], o.shape)
    np.testing.assert_allclose(o.numpy()[rows], want_out[rows], **TOL)
    assert torch.isfinite(lse).all()
    got = k1.flash_attention_bwd_ref(tq, tk, tv, tab, tmask, scale, o, lse, tdo, causal=True)
    for name, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    # keys above the diagonal take no gradient: dk/dv of the last key come
    # from the last row alone, d(ab) is 0 above the diagonal
    if with_bias:
        upper = torch.ones(T, T, dtype=torch.bool).triu(1)
        assert torch.all(got[3][..., upper] == 0)


@pytest.mark.parametrize("d", [64, 192])
def test_causal_backward_matches_autograd_of_the_plain_forward(d):
    q, k, v, ab, mask, do = _inputs(d, True, seed=1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, ab)]
    scale = d ** -0.5
    out = k1.flash_attention_ref(*leaves, _t(mask), scale, causal=True)
    want = torch.autograd.grad(out, leaves, _t(do))
    o, lse = k1.flash_attention_ref(*(_t(x) for x in (q, k, v, ab)), _t(mask), scale, return_lse=True, causal=True)
    got = k1.flash_attention_bwd_ref(*(_t(x) for x in (q, k, v, ab)), _t(mask), scale, o, lse, _t(do), causal=True)
    for name, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)


def test_causal_autograd_route_on_cpu_matches_the_reference_vjp():
    """``flash_attention(..., causal=True)`` on CPU tensors trains through
    the plain causal version; its gradients equal the reference VJP's, and
    it launches nothing."""
    q, k, v, ab, mask, do = _inputs(64, True, seed=2)
    _, want = _jax_reference(q, k, v, ab, mask, do)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, ab)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, _t(mask), 64 ** -0.5, causal=True)
    got = torch.autograd.grad(out, leaves, _t(do))
    for name, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    assert (k1.launches_causal, k1.launches_bwd_dkv_causal, k1.launches_bwd_dq_causal) == (0, 0, 0)


def test_causal_row_that_sees_no_key_is_zero():
    """Keys valid only from position 5 on: rows 0..4 see no key. Their
    output, lse (+inf) and gradients are 0 / finite, never NaN."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 2, 12, 64)).astype(np.float32)) for _ in range(4))
    mask = torch.arange(12)[None, :] >= 5
    o, lse = k1.flash_attention_ref(q, k, v, None, mask, 0.125, return_lse=True, causal=True)
    assert torch.all(o[:, :, :5] == 0) and torch.isinf(lse[:, :, :5]).all()
    assert torch.isfinite(lse[:, :, 5:]).all()
    dq, dk, dv, _ = k1.flash_attention_bwd_ref(q, k, v, None, mask, 0.125, o, lse, do, causal=True)
    assert torch.all(dq[:, :, :5] == 0) and torch.all(dk[:, :, :5] == 0) and torch.all(dv[:, :, :5] == 0)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def test_causal_needs_square_attention():
    q = torch.zeros(1, 1, 4, 64)
    k = torch.zeros(1, 1, 5, 64)
    for fn in (
        lambda: k1.flash_attention(q, k, k, causal=True),
        lambda: k1.flash_attention_ref(q, k, k, causal=True),
    ):
        with pytest.raises(ValueError, match="Tq == Tk"):
            fn()
