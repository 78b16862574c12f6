"""The hand-written kernels as ``torch.library`` ops (``jatts::``), on the CPU.

``torch.library.opcheck`` on each op's CPU implementation (the plain
version) and its fake: ``jatts::flash_attn_fwd`` with and without lse, a
bias, a key mask, the causal form and K1r's d_qk != d_v, with its gradient
registered; ``jatts::flash_attn_bwd_dkv`` and ``jatts::flash_attn_bwd_dq``;
``jatts::mas_decisions``, ``jatts::mas_backtrace`` and ``jatts::mas_path``.
The forward op and the gradient that the op registers (the two backward
ops) against ``jax.vjp`` of the JAX package's eager attention and against
the plain version under autograd; the fakes refuse, on CUDA fake tensors
made without a card, what the kernels refuse, so a bad call fails while
``torch.export`` traces; an exported graph calls the ops; the CPU training
route is unchanged (the plain version under autograd, bit for bit).

Tolerances: f32 on both sides, so only the summation order differs: 2e-5
on values and gradients of magnitude <= ~3 (as tests/test_torch_flash_bwd.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from jatts_tpu.modules.attention import _attend  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402
from jatts_torch.ops import mas  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
B, H, T, D = 3, 2, 13, 64
LENS = np.array([T, 5, 0])  # full, padded, no valid key
SCALE = D ** -0.5
FWD = torch.ops.jatts.flash_attn_fwd.default


def _inputs(seed=0, d_qk=D, d_v=D, with_bias=True, grad=False):
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.normal(size=(B, H, T, d_qk)).astype(np.float32)) for _ in range(2))
    v, do = (torch.from_numpy(rng.normal(size=(B, H, T, d_v)).astype(np.float32)) for _ in range(2))
    ab = torch.from_numpy((rng.normal(size=(B, H, T, T)) * np.sqrt(d_qk)).astype(np.float32)) if with_bias else None
    mask = torch.from_numpy(np.arange(T)[None, :] < LENS[:, None])
    leaves = [t.requires_grad_() if grad else t for t in (q, k, v, ab) if t is not None]
    return (*leaves, None, mask, do) if ab is None else (*leaves, mask, do)


@pytest.mark.parametrize("form", ["bias", "plain", "causal", "relpos"])
def test_flash_fwd_op_passes_opcheck(form):
    d_qk, d_v = (192, 64) if form == "relpos" else (D, D)
    for grad in (False, True):
        q, k, v, ab, mask, _ = _inputs(d_qk=d_qk, d_v=d_v, with_bias=form == "bias", grad=grad)
        for with_lse in ((True,) if grad else (False, True)):
            torch.library.opcheck(FWD, (q, k, v, ab, mask, SCALE, form == "causal", with_lse))


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_flash_bwd_ops_pass_opcheck(causal):
    q, k, v, ab, mask, do = _inputs(seed=1, with_bias=not causal)
    out, lse = k1.flash_attention_ref(q, k, v, ab, mask, SCALE, return_lse=True, causal=causal)
    di = (out * do).sum(-1)
    torch.library.opcheck(torch.ops.jatts.flash_attn_bwd_dkv.default, (q, k, v, ab, mask, SCALE, lse, di, do, causal))
    for with_dab in (False, True):
        torch.library.opcheck(torch.ops.jatts.flash_attn_bwd_dq.default,
                              (q, k, v, ab, mask, SCALE, lse, di, do, with_dab, causal))


def _mas_inputs(seed=2):
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(3, 40, 37)).astype(np.float32)), -1)
    return lp, torch.tensor([37, 20, 1]), torch.tensor([40, 33, 5])


def test_mas_ops_pass_opcheck():
    lp, tl, fl = _mas_inputs()
    torch.library.opcheck(torch.ops.jatts.mas_decisions.default, (lp, tl))
    bits = mas.mas_decisions(lp, tl)
    torch.library.opcheck(torch.ops.jatts.mas_backtrace.default, (bits, tl, fl, 37))
    for return_bits in (False, True):
        torch.library.opcheck(torch.ops.jatts.mas_path.default, (lp, tl, fl, return_bits, mas.SMEM_BITS_BYTES))
    # the wrappers on the CPU are the ops' plain versions
    assert torch.equal(mas.mas_path_fused(lp, tl, fl), mas.mas_path_ref(lp, tl, fl))
    path, got_bits = mas.mas_path_fused(lp, tl, fl, return_bits=True)
    assert torch.equal(got_bits, bits) and torch.equal(bits, mas.pack_bits(mas.mas_decisions_ref(lp, tl)))
    assert torch.equal(mas.mas_backtrace(bits, tl, fl, 37), path)


def _jax_vjp(q, k, v, ab, mask, do):
    def f(q, k, v, ab):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) + ab
        return _attend(s * SCALE, v, jnp.asarray(mask.numpy())[:, None, :], 0.0, True)

    out, vjp = jax.vjp(f, *(jnp.asarray(x.detach().numpy()) for x in (q, k, v, ab)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]


def test_the_forward_ops_gradient_is_the_backward_ops():
    """Through the op, the gradient is the registered backward (the dk/dv
    and dq ops' plain versions: the explicit formulas); against jax.vjp of
    the eager attention and autograd of the plain version."""
    q, k, v, ab, mask, do = _inputs(seed=3, grad=True)
    want_out, want = _jax_vjp(q, k, v, ab, mask, do)
    out, lse = FWD(q, k, v, ab, mask, SCALE, False, True)
    assert not lse.requires_grad
    got = torch.autograd.grad(out, (q, k, v, ab), do)
    plain = torch.autograd.grad(k1.flash_attention_ref(q, k, v, ab, mask, SCALE), (q, k, v, ab), do)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for name, g, w, p in zip(("dq", "dk", "dv", "dab"), got, want, plain):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **TOL)
    # no d(ab) asked: the dq op writes none
    q2, k2, v2 = (x.detach().requires_grad_() for x in (q, k, v))
    out2, _ = FWD(q2, k2, v2, ab.detach(), mask, SCALE, False, True)
    assert torch.equal(torch.autograd.grad(out2, q2, do)[0], got[0])


def test_cpu_training_route_is_the_plain_version_under_autograd():
    """flash_attention on CPU tensors that take a gradient is the plain
    version itself (the CPU trainers' bits); without a gradient it is the
    op, whose output has the same bits."""
    q, k, v, ab, mask, do = _inputs(seed=4, grad=True)
    got = k1.flash_attention(q, k, v, ab, mask, SCALE)
    want = k1.flash_attention_ref(q, k, v, ab, mask, SCALE)
    assert torch.equal(got, want)
    for g, w in zip(torch.autograd.grad(got, (q, k, v, ab), do), torch.autograd.grad(want, (q, k, v, ab), do)):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert torch.equal(k1.flash_attention(q, k, v, ab, mask, SCALE), want)
    k1.reset_launches()
    assert k1.launches == 0


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "relpos_bias", "mixed"])
def test_fakes_refuse_on_cuda_what_the_kernels_refuse(bad):
    """A CUDA fake tensor needs no card: the fake checks the card's forms,
    so an artifact that could not run there fails at export."""
    d = 16 if bad == "head_dim" else D
    dtype = torch.float16 if bad == "dtype" else torch.float32
    with FakeTensorMode():
        q, k = (torch.empty(2, 2, 8, 192 if bad == "relpos_bias" else d, dtype=dtype, device="cuda") for _ in range(2))
        v = torch.empty(2, 2, 8, 64 if bad == "relpos_bias" else d, dtype=dtype, device="cuda")
        ab = torch.empty(2, 2, 8, 8, dtype=dtype, device="cuda") if bad == "relpos_bias" else None
        if bad == "mixed":
            k = torch.empty(2, 2, 8, d)
        with pytest.raises((TypeError, ValueError)):
            FWD(q, k, v, ab, None, SCALE, False, False)
        # the same shapes on the CPU are the plain version's, which takes them
        if bad != "mixed":
            out, lse = FWD(*(torch.empty(x.shape, dtype=x.dtype) for x in (q, k, v)),
                           None if ab is None else torch.empty(ab.shape, dtype=dtype), None, SCALE, False, True)
            assert out.shape == (2, 2, 8, v.shape[3]) and lse.shape == (2, 2, 8)


def test_an_exported_graph_calls_the_ops():
    class Attend(torch.nn.Module):
        def forward(self, q, k, v, mask, lp, tl, fl):
            return k1.flash_attention(q, k, v, None, mask, SCALE), mas.mas_path_fused(lp, tl, fl)

    q, k, v, _, mask, _ = _inputs(seed=5, with_bias=False)
    lp, tl, fl = _mas_inputs()
    with torch.no_grad():
        ep = torch.export.export(Attend(), (q, k, v, mask, lp, tl, fl), strict=False)
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert {"jatts.flash_attn_fwd.default", "jatts.mas_path.default"} <= targets
    got = ep.module()(q, k, v, mask, lp, tl, fl)
    assert torch.equal(got[0], k1.flash_attention_ref(q, k, v, None, mask, SCALE))
    assert torch.equal(got[1], mas.mas_path_ref(lp, tl, fl))
