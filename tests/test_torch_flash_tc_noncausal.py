"""The VALL-E NAR's attention backward on the tensor cores: the non-causal
bf16 dk/dv and dq at d 64 with a key mask (``launch_dkv<false>`` and
``launch_dq<false>`` of ``csrc/flash_attn_bwd_tc.cu``).

On the CPU: the backward's dispatch rule sends bf16, d 64, no bias to the
tensor-core kernels whether causal or not; the source instantiates both
forms and admits Tq != Tk only without the causal mask; a CPU call counts no
launch; and a plain-torch model of the kernels' non-causal arithmetic
(64 x 64 tiles over every key tile, P and dS rounded to bf16 before their
products, dk, dv and dq rounded once) held against
``flash_attention_bwd_ref`` per batch item within ``chip_smoke.py``'s bf16
tolerance (``chip_smoke.item_err``: 1e-2 x max(1, max|plain|) of each item),
at Tq == Tk, Tq < Tk and Tq > Tk, with a row that has one valid key and one
with none; the check catches the causal tile skip left on by far more than
its tolerance.

Marked ``cuda`` (skipped without a card; the card's machine runs them with
``python -m pytest tests/test_torch_flash_tc_noncausal.py -m cuda``): the
kernels against the plain backward at the NAR's width on ragged rows, at
S = 1 and at Tq != Tk, the same bits from run to run and for an item alone,
the autograd chain through ``FlashAttention`` and the C entries' refusal of
a causal call with Tq != Tk. Imports no flax."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.ops import flash_attention as k1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "jatts_torch" / "csrc"
TILE = 64

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL_BF16 = chip_smoke.TOL_BWD["bf16"]
_item_err = chip_smoke.item_err  # max |got - want| over max(1, max|want|) of each batch item, worst item


# ---------------------------------------------------------------------------
# dispatch rule, source, counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("has_bias", [False, True])
def test_bwd_rule_sends_both_valle_forms_to_the_tensor_cores(dtype, causal, d, has_bias):
    """bf16, d 64, no bias: the tensor-core dk/dv and dq, the AR's causal
    form and the NAR's non-causal one alike; bf16 non-causal at d 192 with a
    bias: K1-bwd's bf16 kernels with a bias
    (``tests/test_torch_flash_tc_bias_bwd.py``); bf16 otherwise with a bias
    or at another width d_qk = d_v stays on the scalar kernels (K1r's bf16
    kernels take d_qk != d_v only: ``tests/test_torch_flash_tc_relpos_bwd.py``)."""
    rule = {k1.dkv_kernel(dtype, causal, d, d, has_bias), k1.dq_kernel(dtype, causal, d, d, has_bias)}
    assert k1.KERNEL_BWD_TC_RELPOS not in rule
    if dtype == torch.bfloat16:
        want = (k1.KERNEL_BWD_TC if d == 64 and not has_bias
                else k1.KERNEL_BWD_TC_BIAS if d == 192 and has_bias and not causal else k1.KERNEL_BWD)
        assert rule == {want}
    else:
        assert k1.KERNEL_BWD_TC not in rule


def test_source_holds_both_forms_of_both_kernels():
    bwd = (CSRC / f"{k1.KERNEL_BWD_TC}.cu").read_text()
    assert bwd.count("__global__") == 2 and bwd.count("template <bool CAUSAL>") == 4  # 2 kernels, 2 launchers
    for form in ("launch_dkv<true>", "launch_dkv<false>", "launch_dq<true>", "launch_dq<false>"):
        assert form in bwd, form
    # non-causal: dk/dv from query tile 0, dq over every key tile, no diagonal mask
    assert "const int q_begin = CAUSAL ? k0 : 0;" in bwd
    assert "const int k_end = CAUSAL ? min(Tk, q0 + BQ) : Tk;" in bwd
    assert "const bool diag = CAUSAL && q0 == k0;" in bwd and "if (CAUSAL && k0 == q0)" in bwd
    # Tq == Tk only for the causal form; no bias, d 64, bf16 for both
    assert "(causal && Tq != Tk)" in bwd and "Tq <= 0 || Tk <= 0" in bwd
    assert "atomicAdd" not in bwd and "torch/" not in bwd


def test_cpu_noncausal_call_launches_no_kernel():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 9, 64, generator=g).bfloat16().requires_grad_()
    k, v = (torch.randn(2, 2, 13, 64, generator=g).bfloat16().requires_grad_() for _ in range(2))
    mask = torch.arange(13)[None, :] < torch.tensor([[13], [4]])
    k1.reset_launches()
    out = k1.flash_attention(q, k, v, None, mask)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and k.grad is not None
    counters = (k1.launches, k1.launches_tc, k1.launches_bwd_dkv, k1.launches_bwd_dq,
                k1.launches_bwd_dkv_tc_noncausal, k1.launches_bwd_dq_tc_noncausal)
    assert counters == (0,) * 6


# ---------------------------------------------------------------------------
# a CPU model of the kernels' non-causal arithmetic
# ---------------------------------------------------------------------------


def _np_inputs(seed, b, h, tq, tk, d, rows):
    """bf16 q, do [B, H, Tq, d] and k, v [B, H, Tk, d] from numpy, and a bool
    key mask [B, Tk] from (first valid key, count) per item."""
    rng = np.random.default_rng(seed)

    def bf16(t):
        return torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32)).bfloat16()

    q, do, k, v = bf16(tq), bf16(tq), bf16(tk), bf16(tk)
    pos = torch.arange(tk)
    mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in rows])
    return q, k, v, do, mask


def _seen(key_mask, rows, cols, causal):
    seen = key_mask[:, None, None, cols].expand(-1, 1, len(rows), -1)
    return seen & (cols[None, :] <= rows[:, None])[None, None] if causal else seen


def tc_model_dkv(q, k, v, key_mask, scale, lse, di, do, causal=False):
    """The dk/dv kernel's arithmetic: per 64-key tile, the query tiles from
    0 (causal: from the diagonal one); P^T = exp(S^T scale - lse) in f32 (0
    where unseen), dV += bf16(P^T).dO, dP^T = V.dO^T, dS^T = P^T (dP^T - di)
    scale in f32, dK += bf16(dS^T).Q, f32 accumulation; dk, dv rounded once."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk, dv = torch.zeros(b, h, tk, d), torch.zeros(b, h, tk, d)
    for k0 in range(0, tk, TILE):
        cols = torch.arange(k0, min(tk, k0 + TILE))
        acc_k = torch.zeros(b, h, len(cols), d)
        acc_v = torch.zeros(b, h, len(cols), d)
        for q0 in range(k0 if causal else 0, tq, TILE):
            rows = torch.arange(q0, min(tq, q0 + TILE))
            st = (kf[:, :, cols] @ qf[:, :, rows].transpose(-1, -2)) * scale
            pt = torch.exp(st - lse[:, :, None, rows])
            pt = pt.masked_fill(~_seen(key_mask, rows, cols, causal).transpose(-1, -2), 0.0)
            acc_v += pt.bfloat16().float() @ dof[:, :, rows]
            dpt = vf[:, :, cols] @ dof[:, :, rows].transpose(-1, -2)
            dst = pt * (dpt - di[:, :, None, rows]) * scale
            acc_k += dst.bfloat16().float() @ qf[:, :, rows]
        dk[:, :, cols], dv[:, :, cols] = acc_k, acc_v
    return dk.bfloat16(), dv.bfloat16()


def tc_model_dq(q, k, v, key_mask, scale, lse, di, do, causal=False):
    """The dq kernel's arithmetic: per 64-row query tile, every key tile
    (causal: up to the diagonal one); P = exp(S scale - lse) in f32 (0
    where unseen), dP = dO.V^T, dS = P (dP - di) scale in f32, dQ +=
    bf16(dS).K with f32 accumulation; dq rounded once."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros(b, h, tq, d)
    for q0 in range(0, tq, TILE):
        rows = torch.arange(q0, min(tq, q0 + TILE))
        acc = torch.zeros(b, h, len(rows), d)
        for k0 in range(0, min(tk, q0 + TILE) if causal else tk, TILE):
            cols = torch.arange(k0, min(tk, k0 + TILE))
            s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale
            p = torch.exp(s - lse[:, :, rows, None]).masked_fill(~_seen(key_mask, rows, cols, causal), 0.0)
            dp = dof[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
            ds = p * (dp - di[:, :, rows, None]) * scale
            acc += ds.bfloat16().float() @ kf[:, :, cols]
        dq[:, :, rows] = acc
    return dq.bfloat16()


MODEL_CASES = [
    # (B, H, Tq, Tk, d), key rows per item: a full row, ragged ones, one valid key, none
    ((4, 2, 200, 200, 64), [(0, 200), (0, 131), (0, 1), (0, 0)]),
    ((3, 2, 150, 333, 64), [(0, 333), (37, 100), (0, 0)]),   # Tq < Tk, keys that start inside a tile
    ((3, 2, 261, 90, 64), [(0, 90), (0, 1), (64, 26)]),      # Tq > Tk
]


def _plain(q, k, v, do, mask, scale):
    """The plain forward (lse, output in bf16 as the kernels get it) and the
    plain backward fed that output, as chip_smoke's checks feed both."""
    o, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(), None, mask, scale, return_lse=True)
    o = o.bfloat16()
    dq, dk, dv, _ = k1.flash_attention_bwd_ref(q.float(), k.float(), v.float(), None, mask, scale, o.float(), lse,
                                               do.float())
    di = (o.float() * do.float()).sum(-1)
    return lse, di, (dq, dk, dv)


@pytest.mark.parametrize("shape,rows", MODEL_CASES, ids=["square", "tq_lt_tk", "tq_gt_tk"])
def test_cpu_model_of_the_noncausal_rounding_stays_inside_the_tolerance(shape, rows):
    b, h, tq, tk, d = shape
    q, k, v, do, mask = _np_inputs(5 + tq, b, h, tq, tk, d, rows)
    scale = d ** -0.5
    lse, di, (dq, dk, dv) = _plain(q, k, v, do, mask, scale)
    dk_m, dv_m = tc_model_dkv(q, k, v, mask, scale, lse, di, do)
    dq_m = tc_model_dq(q, k, v, mask, scale, lse, di, do)
    errs = {"dq": _item_err(dq_m, dq), "dk": _item_err(dk_m, dk), "dv": _item_err(dv_m, dv)}
    print(f"non-causal tensor-core model {shape}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" (tol {TOL_BF16:.0e})")
    # inside the tolerance, and not the plain version itself (the rounding shows)
    assert all(0 < e <= TOL_BF16 for e in errs.values()), errs
    none = torch.isinf(lse)[..., None].expand_as(dq_m)
    assert bool(none.any()) == ((0, 0) in rows) and torch.all(dq_m[none] == 0)
    unseen = ~mask[:, None, :, None].expand_as(dk_m)
    assert torch.all(dk_m[unseen] == 0) and torch.all(dv_m[unseen] == 0)


def test_the_check_catches_the_causal_skip_left_on():
    """The non-causal dk/dv and dq computed with the causal tile skip and
    diagonal mask (a kernel whose CAUSAL stayed true) miss every later key:
    per item that is far outside the tolerance."""
    b, h, t, d = 2, 2, 200, 64
    q, k, v, do, mask = _np_inputs(9, b, h, t, t, d, [(0, 200), (0, 150)])
    scale = d ** -0.5
    lse, di, (dq, dk, dv) = _plain(q, k, v, do, mask, scale)
    wrong_dk, wrong_dv = tc_model_dkv(q, k, v, mask, scale, lse, di, do, causal=True)
    wrong_dq = tc_model_dq(q, k, v, mask, scale, lse, di, do, causal=True)
    for got, want in ((wrong_dq, dq), (wrong_dk, dk), (wrong_dv, dv)):
        assert _item_err(got, want) > 10 * TOL_BF16


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

NAR_ROWS = [(0, 754), (0, 753), (0, 611), (0, 1), (0, 0), (0, 65), (37, 377), (0, 251)] * 2
CASES = [
    # (B, H, Tq, Tk, d), key rows per item
    ((16, 16, 754, 754, 64), NAR_ROWS),                        # the NAR's attention, chip_smoke's rows
    ((2, 2, 1, 1, 64), [(0, 1), (0, 0)]),                      # S = 1
    ((3, 2, 200, 333, 64), [(0, 333), (37, 100), (0, 0)]),     # Tq < Tk
    ((3, 2, 517, 130, 64), [(0, 130), (0, 1), (64, 66)]),      # Tq > Tk
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(shape, rows, seed):
    return tuple(x.cuda() for x in _np_inputs(seed, *shape, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", CASES, ids=["nar", "S1", "tq_lt_tk", "tq_gt_tk"])
def test_tc_noncausal_backward_matches_plain_on_card(shape, rows):
    _card()
    q, k, v, do, mask = _card_inputs(shape, rows, 31)
    scale = shape[4] ** -0.5
    lse, di, want = _plain(q, k, v, do, mask, scale)
    k1.reset_launches()
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do)
    dq, dab = k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do)
    torch.cuda.synchronize()
    assert (k1.launches_bwd_dkv_tc_noncausal, k1.launches_bwd_dq_tc_noncausal) == (1, 1)
    assert (k1.launches_bwd_dkv_tc, k1.launches_bwd_dq_tc, k1.launches_bwd_dkv_causal) == (0, 0, 0)
    assert dab is None
    for got, w in zip((dq, dk, dv), want):
        assert torch.isfinite(got).all() and _item_err(got, w) <= TOL_BF16
    none = torch.isinf(lse)[..., None].expand_as(dq)
    assert torch.all(dq[none] == 0)
    unseen = ~mask[:, None, :, None].expand_as(dk)
    assert torch.all(dk[unseen] == 0) and torch.all(dv[unseen] == 0)
    again = (k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do)[0],
             *k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do))
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))


@pytest.mark.cuda
def test_tc_noncausal_row_does_not_depend_on_its_batch():
    _card()
    q, k, v, do, mask = _card_inputs((4, 2, 300, 300, 64), [(0, 300), (0, 120), (5, 77), (0, 0)], 32)
    scale = 0.125
    out, lse = k1.flash_attention_fwd(q, k, v, None, mask, scale)
    di = (out.float() * do.float()).sum(-1)
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do)
    dq = k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do)[0]
    one = [x[2:3].contiguous() for x in (q, k, v, do, mask, lse, di)]
    dk1, dv1 = k1.flash_attention_bwd_dkv(*one[:3], None, one[4], scale, one[5], one[6], one[3])
    dq1 = k1.flash_attention_bwd_dq(*one[:3], None, one[4], scale, one[5], one[6], one[3])[0]
    torch.cuda.synchronize()
    assert torch.equal(dk[2:3], dk1) and torch.equal(dv[2:3], dv1) and torch.equal(dq[2:3], dq1)


@pytest.mark.cuda
def test_tc_noncausal_autograd_chain_matches_plain_on_card():
    """FlashAttention forward + backward (the tensor-core forward's output
    and lse feeding the non-causal tensor-core dk/dv and dq) against
    autograd through the plain forward in f32."""
    _card()
    q, k, v, do, mask = _card_inputs((3, 2, 300, 300, 64), [(0, 300), (0, 211), (37, 100)], 33)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, None, mask)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k1.launches_tc, k1.launches_bwd_dkv_tc_noncausal, k1.launches_bwd_dq_tc_noncausal) == (1, 1, 1)
    ref_leaves = [x.float().detach().requires_grad_() for x in (q, k, v)]
    ref = k1.flash_attention_ref(*ref_leaves, None, mask)
    want = torch.autograd.grad(ref, ref_leaves, do.float())
    assert _item_err(out.detach(), ref.detach()) <= TOL_BF16
    for g, w in zip(got, want):
        assert _item_err(g, w) <= TOL_BF16


@pytest.mark.cuda
def test_tc_entries_refuse_a_causal_call_with_tq_other_than_tk():
    _card()
    q, k, v, do, mask = _card_inputs((2, 2, 128, 192, 64), [(0, 192), (0, 100)], 34)
    lse = torch.zeros(2, 2, 128, device="cuda")
    di = torch.zeros_like(lse)
    out = torch.empty_like(k)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), None, mask.data_ptr(), lse.data_ptr(), di.data_ptr(),
            do.data_ptr(), out.data_ptr()]
    for name, extra in (("dkv", torch.empty_like(v).data_ptr()), ("dq", None)):
        fn = k1._bwd_kernel_fn(k1.KERNEL_BWD_TC, f"jatts_flash_attn_bwd_{name}_tc")
        assert fn(*ptrs, extra, 2, 2, 128, 192, 64, 64, 1, 1, 0.125, stream) != 0
