"""K1b — VALL-E's causal flash attention — on the tensor cores: the causal
forms of ``csrc/flash_attn_fwd_tc.cu`` and the dk/dv and dq kernels of
``csrc/flash_attn_bwd_tc.cu``.

On the CPU: which calls take the dk/dv and dq kernels (``dkv_kernel``,
``dq_kernel``; the forward's rule, ``fwd_kernel``, is
``test_torch_flash_tc.py``'s), what their sources hold, that an edited
shared header rebuilds the libraries, and a plain-torch model of the
kernels' arithmetic (64 x 64 tiles, the causal tile skip, P and dS rounded
to bf16 before their products) held
against ``flash_attention_ref`` / ``flash_attention_bwd_ref(causal=True)``
within ``chip_smoke.py``'s bf16 tolerances, 1e-2 x max(1, max|plain|) of
each batch item (``chip_smoke.item_err``): the rounding the kernels add
stays inside the tolerance the card holds them to, and a wrong key tile
does not.

Marked ``cuda`` (skipped without a card; the card's machine runs them with
``python -m pytest tests/test_torch_flash_tc_causal.py -m cuda``): the
kernels against the plain versions at VALL-E's shape with ragged key rows,
at a T that ends inside a diagonal tile, at T = 1 and with rows that see no
key (exactly 0 there, dq too, and dk, dv exactly 0 on keys no row sees),
the forward at every width with and without a bias, a row alone against its
batched row bit for bit, dq the same bits from run to run, the dq entry
refusing a bias, and the autograd chain through ``FlashAttention``. Imports
no flax."""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.ops import build  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "jatts_torch" / "csrc"
TILE = 64

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL_BF16 = chip_smoke.TOL["bf16"]
assert TOL_BF16 == chip_smoke.TOL_BWD["bf16"]
_item_err = chip_smoke.item_err  # max |got - want| over max(1, max|want|) of each batch item, worst item


# ---------------------------------------------------------------------------
# dispatch rules and sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d_qk,d_v", [(64, 64), (128, 128), (192, 192), (256, 256), (192, 64), (576, 192)])
@pytest.mark.parametrize("has_bias", [False, True])
def test_dkv_rule_sends_valle_form_to_the_tensor_cores(dtype, causal, d_qk, d_v, has_bias):
    """bf16, d_qk = d_v = 64, no bias, causal (the AR) or not (the NAR,
    ``tests/test_torch_flash_tc_noncausal.py``) -> the tensor-core dk/dv;
    f32, non-causal, a K1r pair without a bias or K1-bwd's d 192 with or
    without one -> the 3xTF32 one (``tests/test_torch_flash_tc_f32_bwd.py``);
    everything else stays on the scalar kernel."""
    tc = dtype == torch.bfloat16 and (d_qk, d_v) == (64, 64) and not has_bias
    tc_f32 = dtype == torch.float32 and not causal and (
        ((d_qk, d_v) in k1.RELPOS_PAIRS and not has_bias) or (d_qk, d_v) == (192, 192))
    want = k1.KERNEL_BWD_TC if tc else k1.KERNEL_BWD_TC_F32 if tc_f32 else k1.KERNEL_BWD
    assert k1.dkv_kernel(dtype, causal, d_qk, d_v, has_bias) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d_qk,d_v", [(64, 64), (128, 128), (192, 192), (256, 256), (192, 64), (576, 192)])
@pytest.mark.parametrize("has_bias", [False, True])
def test_dq_rule_sends_valle_form_to_the_tensor_cores(dtype, causal, d_qk, d_v, has_bias):
    """dq by dk/dv's rule: VALL-E's forms (causal or not) on the tensor-core
    dq, K1r's f32 form and K1-bwd's f32 d 192 (with a bias, and its d(ab), or
    without) on the 3xTF32 one; any other bias, d != 64 and f32 causal on
    the scalar one."""
    tc = dtype == torch.bfloat16 and (d_qk, d_v) == (64, 64) and not has_bias
    tc_f32 = dtype == torch.float32 and not causal and (
        ((d_qk, d_v) in k1.RELPOS_PAIRS and not has_bias) or (d_qk, d_v) == (192, 192))
    want = k1.KERNEL_BWD_TC if tc else k1.KERNEL_BWD_TC_F32 if tc_f32 else k1.KERNEL_BWD
    assert k1.dq_kernel(dtype, causal, d_qk, d_v, has_bias) == want


def test_sources_hold_the_causal_forms_and_a_plain_c_interface():
    fwd = (CSRC / f"{k1.KERNEL_TC}.cu").read_text()
    bwd = (CSRC / f"{k1.KERNEL_BWD_TC}.cu").read_text()
    common = (CSRC / "tc_common.cuh").read_text()
    # the forward: CAUSAL a compile-time flag, instantiated with and without bias
    assert "template <int DQK, int DV, bool BIAS, bool CAUSAL>" in fwd
    assert "launch<D, D, true, true>" in fwd and "launch<D, D, false, true>" in fwd
    assert "launch<D, D, true, false>" in fwd and "launch<D, D, false, false>" in fwd
    # the dk/dv and dq kernels: their own C entries with jatts_flash_attn_bwd_dkv's
    # and jatts_flash_attn_bwd_dq's arguments; the causal form a compile-time
    # flag of both (the non-causal ones: tests/test_torch_flash_tc_noncausal.py)
    assert 'extern "C" int jatts_flash_attn_bwd_dkv_tc(' in bwd
    assert 'extern "C" int jatts_flash_attn_bwd_dq_tc(' in bwd
    assert "template <bool CAUSAL>" in bwd and "launch_dkv<true>" in bwd and "launch_dq<true>" in bwd
    assert bwd.count("__global__") == 2
    assert "flash_attn_bwd_dkv_tc_kernel(" in bwd and "flash_attn_bwd_dq_tc_kernel(" in bwd
    # dQ += dS.K from registers against the k slab MN-major, as the forward's P.V
    assert "wgmma_rs(acc, da[kk], k_desc + 128 * kk)" in bwd
    for src in (fwd, bwd):
        assert '#include "tc_common.cuh"' in src
        assert "torch/" not in src and "#include <ATen" not in src and "atomicAdd" not in src
    # the shared helpers live once, in the header
    for helper in ("void wgmma_ss(", "void wgmma_rs(", "void tma_load(", "void mbar_wait(", "bool make_map(",
                   "uint64_t slab_desc("):
        assert helper in common and helper not in fwd and helper not in bwd, helper
    # the scalar forward no longer runs any bf16 form
    scalar = (CSRC / f"{k1.KERNEL}.cu").read_text()
    assert "if (is_bf16) return (int)cudaErrorInvalidValue;" in scalar


def test_an_edited_header_changes_the_library_path(tmp_path, monkeypatch):
    """The library name hashes every csrc header, so an edited header is
    rebuilt instead of loading a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {name: build.library_path(name) for name in (k1.KERNEL_TC, k1.KERNEL_BWD_TC)}
    assert before == {name: build.library_path(name) for name in before}  # stable
    header = csrc / "tc_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in before}
    assert all(after[name] != before[name] for name in before)
    assert all(p.parent == before[name].parent for name, p in after.items())


def test_cpu_call_launches_no_kernel():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 9, 64, generator=g).bfloat16().requires_grad_() for _ in range(3))
    k1.reset_launches()
    out = k1.flash_attention(q, k, v, causal=True)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and q.grad is not None
    assert (k1.launches_tc, k1.launches_bwd_dkv_tc, k1.launches_bwd_dq_tc, k1.launches_causal) == (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# a CPU model of the kernels' rounding
# ---------------------------------------------------------------------------


def _seen(key_mask, rows, cols):
    """[B, 1, len(rows), len(cols)]: key valid and col <= row."""
    return key_mask[:, None, None, cols] & (cols[None, :] <= rows[:, None])[None, None]


def tc_model_forward(q, k, v, key_mask, scale):
    """flash_attn_fwd_tc.cu's causal arithmetic: per 64-row query tile, the
    key tiles up to the diagonal one, an online softmax in f32 over f32
    products of the bf16 inputs, P rounded to bf16 for the P.V product (the
    row sum over the f32 P), the output rounded once. Returns (out bf16,
    lse f32, +inf on a row that sees no key)."""
    b, h, t, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(b, h, t, d)
    lse = torch.full((b, h, t), float("inf"))
    for q0 in range(0, t, TILE):
        rows = torch.arange(q0, min(t, q0 + TILE))
        m = torch.full((b, h, len(rows)), float("-inf"))
        l_ = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        for k0 in range(0, min(t, q0 + TILE), TILE):  # the causal tile skip
            cols = torch.arange(k0, min(t, k0 + TILE))
            s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale
            s = s.masked_fill(~_seen(key_mask, rows, cols), float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            shift = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
            alpha = torch.exp(m - shift)
            p = torch.exp(s - shift[..., None])
            l_ = l_ * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :, cols]
            m = m_new
        seen = l_ > 0
        out[:, :, rows] = torch.where(seen[..., None], acc / l_.clamp_min(1e-30)[..., None], torch.zeros_like(acc))
        lse[:, :, rows] = torch.where(seen, m + torch.log(l_.clamp_min(1e-30)), torch.full_like(m, float("inf")))
    return out.bfloat16(), lse


def tc_model_dkv(q, k, v, key_mask, scale, lse, di, do):
    """flash_attn_bwd_tc.cu's arithmetic: per 64-key tile, the query tiles
    from the diagonal one on; P^T = exp(S^T scale - lse) in f32 (0 where
    unseen), dV += bf16(P^T).dO, dP^T = V.dO^T, dS^T = P^T (dP^T - di) scale
    in f32, dK += bf16(dS^T).Q, f32 accumulation; dk, dv rounded once."""
    b, h, t, d = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk, dv = torch.zeros(b, h, t, d), torch.zeros(b, h, t, d)
    for k0 in range(0, t, TILE):
        cols = torch.arange(k0, min(t, k0 + TILE))
        acc_k = torch.zeros(b, h, len(cols), d)
        acc_v = torch.zeros(b, h, len(cols), d)
        for q0 in range(k0, t, TILE):  # rows before k0 see no key of the tile
            rows = torch.arange(q0, min(t, q0 + TILE))
            st = (kf[:, :, cols] @ qf[:, :, rows].transpose(-1, -2)) * scale
            pt = torch.exp(st - lse[:, :, None, rows])
            pt = pt.masked_fill(~_seen(key_mask, rows, cols).transpose(-1, -2), 0.0)
            acc_v += pt.bfloat16().float() @ dof[:, :, rows]
            dpt = vf[:, :, cols] @ dof[:, :, rows].transpose(-1, -2)
            dst = pt * (dpt - di[:, :, None, rows]) * scale
            acc_k += dst.bfloat16().float() @ qf[:, :, rows]
        dk[:, :, cols], dv[:, :, cols] = acc_k, acc_v
    return dk.bfloat16(), dv.bfloat16()


def tc_model_dq(q, k, v, key_mask, scale, lse, di, do, round_ds=True):
    """flash_attn_bwd_tc.cu's dq arithmetic: per 64-row query tile, the key
    tiles up to the diagonal one; P = exp(S scale - lse) in f32 (0 where
    unseen), dP = dO.V^T, dS = P (dP - di) scale in f32, dQ += bf16(dS).K
    with f32 accumulation; dq rounded once. ``round_ds=False`` keeps dS in
    f32: the scalar kernel's arithmetic."""
    b, h, t, d = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros(b, h, t, d)
    for q0 in range(0, t, TILE):
        rows = torch.arange(q0, min(t, q0 + TILE))
        acc = torch.zeros(b, h, len(rows), d)
        for k0 in range(0, min(t, q0 + TILE), TILE):  # the causal tile skip
            cols = torch.arange(k0, min(t, k0 + TILE))
            s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale
            p = torch.exp(s - lse[:, :, rows, None]).masked_fill(~_seen(key_mask, rows, cols), 0.0)
            dp = dof[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
            ds = p * (dp - di[:, :, rows, None]) * scale
            acc += (ds.bfloat16().float() if round_ds else ds) @ kf[:, :, cols]
        dq[:, :, rows] = acc
    return dq.bfloat16()


def _np_inputs(seed, b, h, t, d, rows):
    """bf16 q, k, v, do from numpy and a bool key mask [B, T] from (first
    valid key, count) per item."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32)).bfloat16()
                   for _ in range(4))
    pos = torch.arange(t)
    mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in rows])
    return q, k, v, do, mask


def test_cpu_model_of_the_kernels_rounding_stays_inside_the_tolerance():
    """At a small VALL-E-like shape (d 64, T = 200: a tile past the diagonal
    one, T ending inside a tile) with ragged key rows, including one whose
    first 37 rows see no key and one with no key at all."""
    b, h, t, d = 4, 2, 200, 64
    q, k, v, do, mask = _np_inputs(7, b, h, t, d, [(0, 200), (0, 131), (37, 100), (0, 0)])
    scale = d ** -0.5
    o, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(), None, mask, scale, return_lse=True, causal=True)
    out_m, lse_m = tc_model_forward(q, k, v, mask, scale)
    assert _item_err(out_m, o) <= TOL_BF16
    none = torch.isinf(lse)
    assert torch.equal(none, torch.isinf(lse_m)) and int(none.sum()) == 2 * (37 + t)
    lse_err = (lse_m - lse).masked_fill(none, 0).abs().max().item()
    assert lse_err <= 1e-4 * max(1.0, lse.masked_fill(none, 0).abs().max().item())
    assert torch.all(out_m[none[..., None].expand_as(out_m)] == 0)
    # the backward as chip_smoke checks it: the kernel fed the plain output
    # in bf16 (its di), the plain backward the f32 one
    di = (o.bfloat16().float() * do.float()).sum(-1)
    dk_m, dv_m = tc_model_dkv(q, k, v, mask, scale, lse, di, do)
    _, dk, dv, _ = k1.flash_attention_bwd_ref(q.float(), k.float(), v.float(), None, mask, scale, o, lse,
                                              do.float(), causal=True)
    assert _item_err(dk_m, dk) <= TOL_BF16 and _item_err(dv_m, dv) <= TOL_BF16
    unseen = ~mask[:, None, :, None].expand_as(dk_m)
    assert torch.all(dk_m[unseen] == 0) and torch.all(dv_m[unseen] == 0)
    # and the rounding is visible: the model is not the plain version itself
    assert _item_err(dk_m, dk) > 0 and _item_err(out_m, o) > 0


@pytest.mark.parametrize("shape,rows", [
    ((8, 2, 300, 64), [(0, 300), (0, 299), (0, 211), (0, 131), (0, 1), (0, 64), (0, 65), (0, 250)]),
    ((3, 2, 200, 64), [(0, 200), (37, 100), (0, 0)]),
], ids=["valle_rows", "no_key"])
def test_cpu_model_of_the_dq_kernels_rounding_stays_inside_the_tolerance(shape, rows):
    """The tensor-core dq (dS rounded to bf16 before dS.K, dq once) held per
    batch item to the plain backward, as chip_smoke's checks hold it: fed
    di from the plain output in bf16, as chip_smoke feeds the kernel path,
    and from the f32 output. The split says where the scalar bf16 dq's error
    comes from: the rounded output's di alone (an f32 dq from it), dq's own
    rounding alone, the scalar kernel's arithmetic and the new kernel's."""
    b, h, t, d = shape
    q, k, v, do, mask = _np_inputs(11, b, h, t, d, rows)
    scale = d ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    o, lse = k1.flash_attention_ref(qf, kf, vf, None, mask, scale, return_lse=True, causal=True)
    dq = k1.flash_attention_bwd_ref(qf, kf, vf, None, mask, scale, o, lse, dof, causal=True)[0]
    di32, di16 = (o * dof).sum(-1), (o.bfloat16().float() * dof).sum(-1)
    o_alone = k1.flash_attention_bwd_ref(qf, kf, vf, None, mask, scale, o.bfloat16().float(), lse, dof,
                                         causal=True)[0]
    split = {
        "o rounded alone": _item_err(o_alone, dq),
        "dq rounded alone": _item_err(dq.bfloat16(), dq),
        "scalar, o bf16": _item_err(tc_model_dq(q, k, v, mask, scale, lse, di16, do, round_ds=False), dq),
        "tc, o f32": _item_err(tc_model_dq(q, k, v, mask, scale, lse, di32, do), dq),
        "tc, o bf16": _item_err(tc_model_dq(q, k, v, mask, scale, lse, di16, do), dq),
    }
    print("dq per-item error over max(1, max|plain| of the item): "
          + ", ".join(f"{name} {err:.2e}" for name, err in split.items()) + f" (tol {TOL_BF16:.0e})")
    assert all(0 < err <= TOL_BF16 for err in split.values()), split
    dq_m = tc_model_dq(q, k, v, mask, scale, lse, di16, do)
    none = torch.isinf(lse)[..., None].expand_as(dq_m)
    assert bool(none.any()) == (rows[-1] == (0, 0)) and torch.all(dq_m[none] == 0)


def test_item_tolerance_catches_a_wrong_key_tile():
    """At VALL-E's length an item with one valid key puts every row's dO on
    key 0 (|dv| ~ 100). Held per item, a dv with two key tiles of the other
    item swapped fails the check; held to max|plain| of the whole tensor,
    it would pass."""
    b, h, t, d = 2, 2, 1088, 64
    q, k, v, do, mask = _np_inputs(3, b, h, t, d, [(0, t), (0, 1)])
    q, k, v, do = (x.float() for x in (q, k, v, do))
    scale = d ** -0.5
    o, lse = k1.flash_attention_ref(q, k, v, None, mask, scale, return_lse=True, causal=True)
    _, dk, dv, _ = k1.flash_attention_bwd_ref(q, k, v, None, mask, scale, o, lse, do, causal=True)
    assert dv[1].abs().max() > 10 * dv[0].abs().max()

    def swapped(x):
        y = x.clone()
        y[0, :, 2 * TILE:3 * TILE] = x[0, :, 3 * TILE:4 * TILE]
        return y

    for want in (dk, dv):
        assert _item_err(want, want) == 0 and _item_err(swapped(want), want) > 10 * TOL_BF16
    whole = (swapped(dv) - dv).abs().max().item() / max(1.0, dv.abs().max().item())
    assert whole < TOL_BF16


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

VALLE_ROWS = [(0, 1088), (0, 1087), (0, 900), (0, 611), (0, 1), (0, 64), (0, 65), (0, 1000)] * 2
CASES = [
    # (B, H, T, d), key rows per item
    ((16, 16, 1088, 64), VALLE_ROWS),                           # VALL-E's attention, chip_smoke's rows
    ((3, 2, 1000, 64), [(0, 1000), (0, 999), (0, 517)]),        # T ends inside a diagonal tile
    ((2, 2, 1, 64), [(0, 1), (0, 0)]),                          # T = 1
    ((3, 2, 200, 64), [(0, 200), (37, 100), (0, 0)]),           # rows that see no key
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(shape, rows, seed):
    q, k, v, do, mask = _np_inputs(seed, *shape, rows)
    return q.cuda(), k.cuda(), v.cuda(), do.cuda(), mask.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", CASES, ids=["valle", "T1000", "T1", "no_key"])
def test_tc_causal_forward_and_dkv_match_plain_on_card(shape, rows):
    _card()
    q, k, v, do, mask = _card_inputs(shape, rows, 21)
    scale = shape[3] ** -0.5
    o, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(), None, mask, scale, return_lse=True, causal=True)
    di = (o.bfloat16().float() * do.float()).sum(-1)
    k1.reset_launches()
    out, lse_k = k1.flash_attention_fwd(q, k, v, None, mask, scale, causal=True)
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do, causal=True)
    dq, dab = k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do, causal=True)
    torch.cuda.synchronize()
    assert (k1.launches_tc, k1.launches_causal, k1.launches_bwd_dkv_tc, k1.launches_bwd_dkv_causal) == (1, 1, 1, 1)
    assert (k1.launches_bwd_dq_tc, k1.launches_bwd_dq_causal) == (1, 1) and dab is None
    dq_r, dk_r, dv_r, _ = k1.flash_attention_bwd_ref(q.float(), k.float(), v.float(), None, mask, scale, o, lse,
                                                     do.float(), causal=True)
    assert _item_err(out, o) <= TOL_BF16
    assert _item_err(dk, dk_r) <= TOL_BF16 and _item_err(dv, dv_r) <= TOL_BF16
    assert _item_err(dq, dq_r) <= TOL_BF16 and torch.isfinite(dq).all()
    none = torch.isinf(lse)
    assert torch.equal(none, torch.isinf(lse_k)) and bool((lse_k[none] > 0).all())
    assert (lse_k - lse).masked_fill(none, 0).abs().max().item() <= 1e-4 * max(
        1.0, lse.masked_fill(none, 0).abs().max().item())
    assert torch.all(out[none[..., None].expand_as(out)] == 0)
    assert torch.all(dq[none[..., None].expand_as(dq)] == 0)
    unseen = ~mask[:, None, :, None].expand_as(dk)
    assert torch.all(dk[unseen] == 0) and torch.all(dv[unseen] == 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("with_bias", [False, True])
def test_tc_causal_forward_matches_plain_at_every_width_on_card(d, with_bias):
    """Every causal instantiation the forward's rule dispatches, at a T
    that ends inside a diagonal tile (200 = 3 x 64 + 8), with rows that see
    no key: out and lse against the plain forward, 0 on unseen rows."""
    _card()
    b, h, t = 3, 2, 200
    q, k, v, _, mask = _card_inputs((b, h, t, d), [(0, t), (0, 131), (37, 100)], 24 + d)
    ab = None
    if with_bias:
        rng = np.random.default_rng(d)
        ab = torch.from_numpy(rng.normal(size=(b, h, t, t)).astype(np.float32)).bfloat16().cuda()
    scale = d ** -0.5
    o, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(), None if ab is None else ab.float(), mask,
                                    scale, return_lse=True, causal=True)
    k1.reset_launches()
    out, lse_k = k1.flash_attention_fwd(q, k, v, ab, mask, scale, causal=True)
    torch.cuda.synchronize()
    assert (k1.launches_tc, k1.launches_causal) == (1, 1)
    assert _item_err(out, o) <= TOL_BF16
    none = torch.isinf(lse)
    assert int(none.sum()) == h * 37 and torch.equal(none, torch.isinf(lse_k))
    assert (lse_k - lse).masked_fill(none, 0).abs().max().item() <= 1e-4 * max(
        1.0, lse.masked_fill(none, 0).abs().max().item())
    assert torch.all(out[none[..., None].expand_as(out)] == 0)


@pytest.mark.cuda
def test_tc_causal_row_does_not_depend_on_its_batch():
    """An item alone and inside a batch of others gives the same bits:
    forward, lse, dk, dv and dq."""
    _card()
    q, k, v, do, mask = _card_inputs((4, 2, 300, 64), [(0, 300), (0, 120), (5, 77), (0, 0)], 22)
    scale = 0.125
    out, lse = k1.flash_attention_fwd(q, k, v, None, mask, scale, causal=True)
    di = (out.float() * do.float()).sum(-1)
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do, causal=True)
    dq = k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do, causal=True)[0]
    one = [x[2:3].contiguous() for x in (q, k, v, do, mask, lse, di)]
    out1, lse1 = k1.flash_attention_fwd(*one[:3], None, one[4], scale, causal=True)
    dk1, dv1 = k1.flash_attention_bwd_dkv(*one[:3], None, one[4], scale, one[5], one[6], one[3], causal=True)
    dq1 = k1.flash_attention_bwd_dq(*one[:3], None, one[4], scale, one[5], one[6], one[3], causal=True)[0]
    torch.cuda.synchronize()
    assert torch.equal(out[2:3], out1) and torch.equal(lse[2:3], lse1)
    assert torch.equal(dk[2:3], dk1) and torch.equal(dv[2:3], dv1) and torch.equal(dq[2:3], dq1)


@pytest.mark.cuda
def test_tc_dq_same_bits_each_run_and_refuses_a_bias_on_card():
    """No atomics: two runs of the tensor-core dq give the same bits (the
    bitwise resume of VALL-E training rests on it). Its C entry refuses
    what its form does not take: a bias, a d(ab) output, f32."""
    _card()
    q, k, v, do, mask = _card_inputs((4, 4, 1088, 64), VALLE_ROWS[:4], 25)
    scale = 0.125
    _, lse = k1.flash_attention_fwd(q, k, v, None, mask, scale, causal=True)
    di = torch.randn(lse.shape, device="cuda")
    k1.reset_launches()
    runs = [k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do, causal=True)[0] for _ in range(3)]
    torch.cuda.synchronize()
    assert k1.launches_bwd_dq_tc == 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    fn = k1._bwd_kernel_fn(k1.KERNEL_BWD_TC, "jatts_flash_attn_bwd_dq_tc")
    ab = torch.zeros(4, 4, 1088, 1088, device="cuda", dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    rest = [mask.data_ptr(), lse.data_ptr(), di.data_ptr(), do.data_ptr(), runs[0].data_ptr()]
    for ab_ptr, dab_ptr, is_bf16 in ((ab.data_ptr(), None, 1), (None, ab.data_ptr(), 1), (None, None, 0)):
        rc = fn(*ptrs, ab_ptr, *rest, dab_ptr, 4, 4, 1088, 1088, 64, 64, is_bf16, 1, scale, stream)
        assert rc != 0
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_tc_causal_autograd_chain_matches_plain_on_card():
    """FlashAttention forward + backward (the tensor-core forward's output
    and lse feeding the tensor-core dk/dv and dq) against autograd through
    the plain causal forward in f32."""
    _card()
    q, k, v, do, mask = _card_inputs((3, 2, 300, 64), [(0, 300), (0, 211), (37, 100)], 23)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, None, mask, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k1.launches_tc, k1.launches_bwd_dkv_tc, k1.launches_bwd_dq_tc, k1.launches_bwd_dq_causal) == (1, 1, 1, 1)
    ref_leaves = [x.float().detach().requires_grad_() for x in (q, k, v)]
    ref = k1.flash_attention_ref(*ref_leaves, None, mask, causal=True)
    want = torch.autograd.grad(ref, ref_leaves, do.float())
    assert _item_err(out.detach(), ref.detach()) <= TOL_BF16
    for g, w in zip(got, want):
        assert _item_err(g, w) <= TOL_BF16
