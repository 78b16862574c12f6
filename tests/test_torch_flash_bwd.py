"""K1-bwd: the plain version of the flash-attention backward
(``flash_attention_bwd_ref``) and the ``FlashAttention`` route on CPU
tensors, against ``jax.grad`` of the JAX package's eager attention
(``_attend`` over ``(q·kᵀ + ab)·scale``, the path JAX takes on the CPU), on
a padded batch with a row of the batch that has no valid key. The kernels
themselves are compared with the plain version on the card by
``tests/test_torch_package.py`` (``cuda`` marker; that file imports no flax,
which the card's machine lacks).

Tolerances: f32 on both sides, so only the summation order differs:
rtol = atol = 2e-5 on gradients of magnitude <= ~3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.modules.attention import _attend  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
B, H, T, D = 3, 2, 13, 64
LENS = np.array([T, 5, 0])  # full, padded, no valid key
SCALE = D ** -0.5


def _inputs(seed=0, with_bias=True):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4))
    ab = (rng.normal(size=(B, H, T, T)) * np.sqrt(D)).astype(np.float32) if with_bias else None
    mask = np.arange(T)[None, :] < LENS[:, None]
    return q, k, v, ab, mask, do


def _jax_grads(q, k, v, ab, mask, do):
    """dq, dk, dv, dab of sum(out·do) through the JAX eager attention."""

    def f(q, k, v, ab):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k)
        if ab is not None:
            s = s + ab
        return _attend(s * SCALE, v, jnp.asarray(mask)[:, None, :], 0.0, True)

    args = [jnp.asarray(x) for x in (q, k, v)] + [None if ab is None else jnp.asarray(ab)]
    out, vjp = jax.vjp(f, *args)
    return np.asarray(out), [None if g is None else np.asarray(g) for g in vjp(jnp.asarray(do))]


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("with_bias", [True, False])
def test_bwd_ref_matches_jax_grad_of_eager_attention(with_bias):
    q, k, v, ab, mask, do = _inputs(with_bias=with_bias)
    want_out, want = _jax_grads(q, k, v, ab, mask, do)
    tq, tk, tv, tab, tmask, tdo = (_t(x) for x in (q, k, v, ab, mask, do))
    o, lse = k1.flash_attention_ref(tq, tk, tv, tab, tmask, SCALE, return_lse=True)
    np.testing.assert_allclose(o.numpy(), want_out, **TOL)
    assert torch.isinf(lse[2]).all() and torch.isfinite(lse[:2]).all()
    got = k1.flash_attention_bwd_ref(tq, tk, tv, tab, tmask, SCALE, o, lse, tdo)
    for name, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    dq, dk, dv, dab = got
    # the row with no valid key: exactly 0, never NaN; masked keys: 0
    assert torch.all(dq[2] == 0) and torch.all(dk[2] == 0) and torch.all(dv[2] == 0)
    assert torch.all(dk[1, :, LENS[1]:] == 0) and torch.all(dv[1, :, LENS[1]:] == 0)
    if with_bias:
        assert torch.all(dab[2] == 0) and torch.all(dab[1, :, :, LENS[1]:] == 0)


def test_flash_attention_autograd_on_cpu_matches_jax_grad():
    """The wrapper's CPU route (the plain version under autograd) trains:
    its gradients equal jax.grad's, and it launches nothing."""
    q, k, v, ab, mask, do = _inputs(seed=1)
    _, want = _jax_grads(q, k, v, ab, mask, do)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, ab)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, torch.from_numpy(mask), SCALE)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    assert (k1.launches, k1.launches_bwd_dkv, k1.launches_bwd_dq) == (0, 0, 0)


def test_bwd_wrapper_refuses_cpu_tensors():
    """``flash_attention_bwd`` is the kernels' wrapper: CPU tensors are not
    its route (the CPU trains through the plain version under autograd)."""
    q, k, v, ab, mask, do = (_t(x) for x in _inputs())
    o, lse = k1.flash_attention_ref(q, k, v, ab, mask, SCALE, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        k1.flash_attention_bwd(q, k, v, ab, mask, SCALE, o, lse, do)
