"""The f32 flash-attention forward on the tensor cores in 3xTF32
(``csrc/flash_attn_fwd_tc_f32.cu``): K1's and K1r's non-causal f32 forms,
the ones FastSpeech2 trains through.

On the CPU: a model of the kernel's arithmetic (64-key tiles, the online
softmax in the base-2 domain, every operand of both products split into
hi = rna(x) and lo = rna(x - hi) by bit arithmetic as ``cvt.rna.tf32.f32``
rounds, the product hi.lo + lo.hi + hi.hi, P.V summed over v's keys in the
kernel's permuted order) held against ``flash_attention_ref`` and against
the JAX package's reference on the same numpy-made inputs: the installed
``mha_reference`` on the TPU wrapper's padded K1r call (as
``tests/test_torch_relpos.py`` builds it) and on a biased K1 call. The
tolerances are ``chip_smoke.py``'s f32 ones, unchanged: 1e-4 absolute for
K1's forms, 1e-5 relative to max(1, max|plain|) for K1r's, the
log-sum-exp within 1e-4 x max(1, |lse|). The same model with one TF32 pass,
or with bf16 pieces, gives the errors that decided the route (``-s`` prints
them); a wrong key tile or a wrong key permutation fails the check by more
than 10x. Then ``fwd_kernel``'s rule, the source, and the library name's
hash over ``csrc/*.cuh``.

Marked ``cuda`` (skipped without a card; the card's machine runs them with
``python -m pytest tests/test_torch_flash_tc_f32.py -m cuda``): every form
against the plain version at a ragged T, T = 1, Tq != Tk with an odd Tk
(the bias read pair by pair) and a masked leading key tile, and an item
with no valid key (exactly 0, lse +inf); the same bits from run to run and
for a row alone as in its batch; the C entry refusing what it does not
take; the autograd chain (its lse feeding the scalar backward)."""

import contextlib
import importlib.util
import math
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference  # noqa: E402

from jatts_torch.ops import build  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "jatts_torch" / "csrc"
TILE = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# position a of each group of 8 keys in the transposed v slab holds key PI[a]:
# the k8 .tf32 A fragment's columns (c, c + 4) are the S accumulator's (2c, 2c + 1)
PI = (0, 2, 4, 6, 1, 3, 5, 7)

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL_K1 = chip_smoke.TOL["f32"]  # absolute
TOL_K1R = chip_smoke.TOL_K1R["f32"]  # relative to max(1, max|plain|)


# ---------------------------------------------------------------------------
# a CPU model of the kernel's arithmetic
# ---------------------------------------------------------------------------


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: round to nearest at bit 13, ties away from zero,
    the 13 low bits zero (adding 0x1000 to the bits of a finite float rounds
    its magnitude, whatever its sign); the kernel rounds with the same two
    integer operations."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _bf16_pieces(x, n):
    pieces, rest = [], x.float()
    for _ in range(n):
        p = rest.bfloat16().float()
        pieces.append(p)
        rest = rest - p
    return pieces


def product(a, b, route):
    """a @ b in f32 as a route computes it: ``3xtf32`` the kernel's,
    ``1xtf32`` one TF32 pass, ``bf16x3`` hi.lo + lo.hi + hi.hi of bf16
    pieces, ``bf16x6`` the six products of three bf16 pieces, ``f32`` plain."""
    if route == "f32":
        return a @ b
    if route == "1xtf32":
        return tf32_rna(a) @ tf32_rna(b)
    if route == "3xtf32":
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        return ah @ bl + al @ bh + ah @ bh
    if route == "bf16x3":
        (ah, al), (bh, bl) = _bf16_pieces(a, 2), _bf16_pieces(b, 2)
        return ah @ bl + al @ bh + ah @ bh
    if route == "bf16x6":
        (a1, a2, a3), (b1, b2, b3) = _bf16_pieces(a, 3), _bf16_pieces(b, 3)
        return a1 @ b3 + a2 @ b2 + a3 @ b1 + a1 @ b2 + a2 @ b1 + a1 @ b1
    raise ValueError(route)


def tc_f32_model(q, k, v, ab, key_mask, scale, route="3xtf32", v_perm=PI, v_tiles=None):
    """flash_attn_fwd_tc_f32.cu's arithmetic on f32 CPU tensors -> (out,
    lse): per 64-key tile (keys past Tk zero and unseen), S = Q.K^T (+ ab)
    by ``route``, scaled by the f32 sm_scale*log2(e), the online softmax
    with exp2 (a row with no key so far shifts by 0), P.V summed over the
    keys in the order PI of each group of 8 with v's rows in the order
    ``v_perm`` (the kernel: the same), out = acc * (1/l), lse = (m +
    log2 l) ln 2 (+inf where l = 0). ``v_tiles[t]`` names the v tile read
    for key tile t (the kernel: t)."""
    b, h, tq, _ = q.shape
    tk, d_v = k.shape[2], v.shape[3]
    n_tiles = -(-tk // TILE)
    pad = n_tiles * TILE - tk
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    maskp = torch.nn.functional.pad(key_mask, (0, pad), value=False)
    abp = None if ab is None else torch.nn.functional.pad(ab, (0, pad))
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    p_order = [8 * g + a for g in range(TILE // 8) for a in PI]
    v_order = [8 * g + a for g in range(TILE // 8) for a in v_perm]
    m = torch.full((b, h, tq), float("-inf"))
    l_ = torch.zeros(b, h, tq)
    acc = torch.zeros(b, h, tq, d_v)
    for t in range(n_tiles):
        cols = slice(TILE * t, TILE * (t + 1))
        s = product(q, kp[:, :, cols].transpose(-1, -2), route)
        if abp is not None:
            s = s + abp[..., cols]
        s = torch.where(maskp[:, None, None, cols], s * scale2, torch.tensor(float("-inf")))
        m_new = torch.maximum(m, s.amax(-1))
        shift = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - shift)
        p = torch.exp2(s - shift[..., None])
        l_ = l_ * alpha + p.sum(-1)
        src = t if v_tiles is None else v_tiles[t]
        vt = vp[:, :, TILE * src:TILE * (src + 1)]
        acc = acc * alpha[..., None] + product(p[..., p_order], vt[:, :, v_order], route)
        m = m_new
    seen = l_ > 0
    inv = torch.where(seen, 1.0 / l_, torch.zeros_like(l_))
    lse = torch.where(seen, (m + torch.log2(l_)) * LN2, torch.full_like(m, float("inf")))
    return acc * inv[..., None], lse


def _np_inputs(seed, b, h, tq, tk, d_qk, d_v, bias, rows):
    """The check's distributions, made with numpy: q, k, v ~ N(0, 1), the
    bias ~ N(0, d_qk) (the scale of q.k^T); rows: (first valid key, count)
    per batch item."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, tq, d_qk)).astype(np.float32)
    k = rng.normal(size=(b, h, tk, d_qk)).astype(np.float32)
    v = rng.normal(size=(b, h, tk, d_v)).astype(np.float32)
    ab = (rng.normal(size=(b, h, tq, tk)) * np.sqrt(d_qk)).astype(np.float32) if bias else None
    pos = np.arange(tk)
    mask = np.stack([(pos >= a) & (pos < a + n) for a, n in rows])
    return q, k, v, ab, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


@contextlib.contextmanager
def _one_thread():
    """The models' many small ops on one thread: under the suite's parallel
    workers a thread pool each costs far more than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _err(got, want, relpos):
    """chip_smoke's measure: max |got - want|, for K1r over max(1, max|want|)."""
    err = (got - want).abs().max().item()
    return err / max(1.0, want.abs().max().item()) if relpos else err


def _ref64(q, k, v, ab, mask, scale):
    """The function in float64: the yardstick of the route errors."""
    s = q.double() @ k.double().transpose(-1, -2)
    if ab is not None:
        s = s + ab.double()
    s = (s * scale).masked_fill(~mask[:, None, None, :], float("-inf"))
    return torch.nan_to_num(torch.softmax(s, -1)) @ v.double()


FORMS = {
    # name: (d_qk, d_v, bias); K1 at the JSUT width with its dense bias, K1r's pair
    "k1": (192, 192, True),
    "k1r": (576, 192, False),
}
ROWS = [(0, 200), (0, 131), (37, 100), (0, 0)]  # full, ragged, a late start, no valid key


@pytest.mark.parametrize("form", list(FORMS))
def test_cpu_model_matches_the_plain_version(form):
    """At T = 200 (a tile past three, T ending inside one) with ragged key
    rows and an item with no valid key: out, lse and the unseen rows."""
    d_qk, d_v, bias = FORMS[form]
    q, k, v, ab, mask = (_t(x) for x in _np_inputs(1, 4, 2, 200, 200, d_qk, d_v, bias, ROWS))
    scale = d_v ** -0.5
    want, lse = k1.flash_attention_ref(q, k, v, ab, mask, scale, return_lse=True)
    with _one_thread():
        out, lse_m = tc_f32_model(q, k, v, ab, mask, scale)
    err = _err(out, want, form == "k1r")
    assert 0 < err <= (TOL_K1R if form == "k1r" else TOL_K1), err
    none = torch.isinf(lse)
    assert int(none.sum()) == 2 * 200 and torch.equal(none, torch.isinf(lse_m)) and bool((lse_m[none] > 0).all())
    assert (lse_m - lse).masked_fill(none, 0).abs().max().item() <= 1e-4 * max(
        1.0, lse.masked_fill(none, 0).abs().max().item())
    assert torch.all(out[none[..., None].expand_as(out)] == 0)


def _jax_forward(q, k, v, ab, mask, scale):
    """``mha_reference`` as ``_flash_attend`` feeds the TPU kernel: segment
    ids 1 on valid and 0 on padded positions, v zero-padded to d_qk and the
    output sliced back to d_v where d_qk != d_v (K1r)."""
    d_qk, d_v = q.shape[-1], v.shape[-1]
    seg = jnp.asarray(mask.astype(np.int32))
    vp = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, d_qk - d_v)))
    out = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp), None if ab is None else jnp.asarray(ab),
                        SegmentIds(q=seg, kv=seg), sm_scale=scale)
    return np.asarray(out)[..., :d_v]


@pytest.mark.parametrize("form", list(FORMS))
def test_cpu_model_matches_the_jax_reference(form):
    """The model against the installed Pallas kernel's own reference on the
    TPU wrapper's call, on the valid query rows (the reference's padded rows
    attend padded keys, the port's attend the valid ones); the item with no
    valid key has no valid row and is 0 in the model."""
    d_qk, d_v, bias = FORMS[form]
    q, k, v, ab, mask = _np_inputs(2, 4, 2, 200, 200, d_qk, d_v, bias, ROWS)
    scale = d_v ** -0.5
    want = _jax_forward(q, k, v, ab, mask, scale)
    with _one_thread():
        out, lse = tc_f32_model(*(_t(x) for x in (q, k, v, ab, mask)), scale)
    rows = np.broadcast_to(mask[:, None, :, None], out.shape)
    got, ref = out.numpy()[rows], want[rows]
    err = np.abs(got - ref).max()
    if form == "k1r":
        err /= max(1.0, np.abs(ref).max())
    assert err <= (TOL_K1R if form == "k1r" else TOL_K1), err
    assert torch.all(out[3] == 0) and torch.isinf(lse[3]).all()


@pytest.mark.parametrize("form", list(FORMS))
def test_route_errors_record_the_precision_decision(form):
    """The check's inputs at B,H,T = 2,2,512 against float64: one TF32 pass
    misses the f32 tolerance, 3xTF32 holds it; the bf16 splits are printed
    beside (``-s``)."""
    d_qk, d_v, bias = FORMS[form]
    rows = [(0, 512), (0, 300)]
    q, k, v, ab, mask = (_t(x) for x in _np_inputs(0, 2, 2, 512, 512, d_qk, d_v, bias, rows))
    scale = d_v ** -0.5
    exact = _ref64(q, k, v, ab, mask, scale)
    with _one_thread():
        errs = {route: _err(tc_f32_model(q, k, v, ab, mask, scale, route=route)[0].double(), exact, form == "k1r")
                for route in ("f32", "1xtf32", "bf16x3", "3xtf32", "bf16x6")}
    tol = TOL_K1R if form == "k1r" else TOL_K1
    print(f"{form} ({d_qk}, {d_v}{', bias' if bias else ''}), error against float64 "
          f"({'relative to max(1, max|ref|)' if form == 'k1r' else 'absolute'}; tol {tol:.0e}): "
          + ", ".join(f"{r} {e:.2e}" for r, e in errs.items()))
    assert errs["1xtf32"] > tol
    assert errs["3xtf32"] <= tol / 4 and errs["f32"] <= tol / 4


@pytest.mark.parametrize("form", list(FORMS))
def test_a_wrong_key_tile_or_permutation_fails_the_check(form):
    """Held to the plain version as the card holds the kernel: reading the
    v tiles of keys 64..127 and 128..191 the wrong way round, or writing v's
    keys unpermuted under the permuted P, fails by more than 10x."""
    d_qk, d_v, bias = FORMS[form]
    q, k, v, ab, mask = (_t(x) for x in _np_inputs(3, 2, 2, 256, 256, d_qk, d_v, bias, [(0, 256), (0, 250)]))
    scale = d_v ** -0.5
    want = k1.flash_attention_ref(q, k, v, ab, mask, scale)
    tol = TOL_K1R if form == "k1r" else TOL_K1
    relpos = form == "k1r"
    with _one_thread():
        assert _err(tc_f32_model(q, k, v, ab, mask, scale)[0], want, relpos) <= tol
        swapped = tc_f32_model(q, k, v, ab, mask, scale, v_tiles=[0, 2, 1, 3])[0]
        unpermuted = tc_f32_model(q, k, v, ab, mask, scale, v_perm=tuple(range(8)))[0]
    assert _err(swapped, want, relpos) > 10 * tol and _err(unpermuted, want, relpos) > 10 * tol


def _rz(x):
    """float64 -> f32 rounded toward zero: how a tensor-core f32 sum rounds."""
    x32 = x.float()
    return torch.where(x32.double().abs() > x.abs(), torch.nextafter(x32, torch.zeros_like(x32)), x32)


def truncating_model(q, k, v, key_mask, scale, fresh):
    """K1r's arithmetic (no bias) with each wgmma's sum (8 exact products of
    TF32 pieces added to the accumulator) rounded toward zero to f32. With
    ``fresh`` the kernel's chains: each 32-column k slab's S in a fresh
    accumulator, its 8 small terms first, added to S in f32, and each (key
    half, 64-column chunk) slab's P.V likewise into O; else one chain over
    all of d_qk for S and over all the keys for O."""
    b, h, tq, d_qk = q.shape
    tk, d_v = k.shape[2], v.shape[3]
    (qh, ql), (kh, kl), (vh, vl) = ((x.double() for x in split_tf32(y)) for y in (q, k, v))
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    order = [8 * g + a for g in range(TILE // 8) for a in PI]
    m = torch.full((b, h, tq), float("-inf"))
    l_ = torch.zeros(b, h, tq)
    o = torch.zeros(b, h, tq, d_v)
    for k0 in range(0, tk, TILE):
        ks = slice(k0, k0 + TILE)
        s = torch.zeros(b, h, tq, TILE)
        for d0 in range(0, d_qk, 32):
            acc = torch.zeros_like(s) if fresh else s
            def step(a, c, d):
                return a[..., d:d + 8], c[:, :, ks, d:d + 8]

            cols = range(d0, d0 + 32, 8)
            if fresh:  # the small terms of the slab, then its big ones
                steps = [step(a, c, d) for d in cols for a, c in ((qh, kl), (ql, kh))]
                steps += [step(qh, kh, d) for d in cols]
            else:  # hi.lo, lo.hi, hi.hi a k-step
                steps = [step(a, c, d) for d in cols for a, c in ((qh, kl), (ql, kh), (qh, kh))]
            for a, c in steps:
                acc = _rz(acc.double() + a @ c.transpose(-1, -2))
            s = s + acc if fresh else acc
        s = torch.where(key_mask[:, None, None, ks], s * scale2, torch.tensor(float("-inf")))
        m_new = torch.maximum(m, s.amax(-1))
        shift = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - shift)
        p = torch.exp2(s - shift[..., None])
        l_ = l_ * alpha + p.sum(-1)
        ph, pl = (x.double() for x in split_tf32(p[..., order]))
        o = o * alpha[..., None]
        for half in range(2):
            acc = torch.zeros_like(o) if fresh else o
            for j in range(32 * half, 32 * half + 32, 8):
                vj = [k0 + i for i in order[j:j + 8]]
                for a, c in ((ph, vl), (pl, vh), (ph, vh)):
                    acc = _rz(acc.double() + a[..., j:j + 8] @ c[:, :, vj])
            o = o + acc if fresh else acc
        m = m_new
    return o / l_[..., None]


def test_truncating_sums_need_the_kernels_short_chains():
    """The tensor cores' f32 sums truncate. Modelled so, one chain over all
    of d_qk and all the keys misses K1r's 1e-5, as the kernel did on the card
    before its chains were cut; the kernel's fresh chains stay well inside
    it."""
    q, k, v, _, mask = (_t(x) for x in _np_inputs(0, 2, 2, 64, 512, 576, 192, False, [(0, 512), (0, 300)]))
    scale = 192 ** -0.5
    exact = _ref64(q, k, v, None, mask, scale)
    with _one_thread():
        errs = {fresh: _err(truncating_model(q, k, v, mask, scale, fresh).double(), exact, True)
                for fresh in (False, True)}
    print(f"k1r with truncating tensor-core sums: one chain {errs[False]:.2e}, the kernel's chains {errs[True]:.2e} "
          f"(tol {TOL_K1R:.0e})")
    assert errs[False] > TOL_K1R and errs[True] <= TOL_K1R / 4


def test_tf32_rounding_by_bit_arithmetic():
    """rna: the 13 low bits zero, the nearest 11-bit significand, ties away
    from zero; lo carries the rest to ~2^-22 of |x|."""
    one = 1.0 + 2.0 ** -11  # halfway between two tf32 values above 1
    x = torch.tensor([1.0, one, -one, 1.0 + 2.0 ** -12, 3.0 - 2.0 ** -12, 0.0, -2.5e-30])
    hi = tf32_rna(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert hi.tolist()[:6] == [1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, 0.0]
    r = torch.from_numpy(np.random.default_rng(4).normal(size=10000).astype(np.float32))
    hi, lo = split_tf32(r)
    assert torch.all((hi - r).abs() <= r.abs() * 2.0 ** -11)
    assert torch.all((hi.double() + lo.double() - r.double()).abs() <= r.abs().double() * 2.0 ** -21)


# ---------------------------------------------------------------------------
# the rule, the source, the library
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d_qk,d_v", [(64, 64), (128, 128), (192, 192), (256, 256), (192, 64), (576, 192)])
def test_f32_forward_rule(causal, d_qk, d_v):
    """f32 non-causal at every admitted width but 256 -> the 3xTF32 kernel;
    f32 causal and d 256 -> the scalar kernel; bf16 -> the bf16 kernel."""
    want = k1.KERNEL if causal or d_qk == 256 else k1.KERNEL_TC_F32
    assert k1.fwd_kernel(torch.float32, causal, d_qk, d_v) == want
    assert k1.fwd_kernel(torch.bfloat16, causal, d_qk, d_v) == k1.KERNEL_TC
    assert ((d_qk, d_v) in k1.TC_F32_PAIRS) == (d_qk != 256)


def test_source_is_a_3xtf32_tensor_core_kernel_with_a_plain_c_interface():
    src = (CSRC / f"{k1.KERNEL_TC_F32}.cu").read_text()
    assert 'extern "C" int jatts_flash_attn_fwd_tc_f32(' in src
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in src
    # hi and lo rounded as cvt.rna.tf32.f32 rounds, in integer arithmetic (tf32_rna above)
    assert "(__float_as_uint(x) + 0x1000u) & 0xFFFFE000u" in src and "fence.proxy.async.shared::cta" in src
    assert "cp.async.bulk.tensor" in src and "mbarrier" in src
    assert '#include "tc_common.cuh"' in src
    assert "torch/" not in src and "#include <ATen" not in src
    assert "atomicAdd" not in src and not re.search(r"\b(atom|red)\.(global|shared|add)", src)
    for d in (64, 128, 192):
        assert f"case {d}: return (int)launch_d<{d}>" in src
    for d_qk, d_v in k1.RELPOS_PAIRS:
        assert f"launch<{d_qk}, {d_v}, false>" in src
    # the shared helpers come from the header
    for helper in ("void tma_load(", "void mbar_wait(", "uint64_t slab_desc(", "EncodeTiled encode_fn("):
        assert helper not in src, helper


def test_an_edited_header_rebuilds_the_library(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = build.library_path(k1.KERNEL_TC_F32)
    assert before == build.library_path(k1.KERNEL_TC_F32)
    header = csrc / "tc_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path(k1.KERNEL_TC_F32)
    assert after != before and after.parent == before.parent


def test_study_variants_apply_to_the_source():
    """``bin/study_fwd_tc_f32.py`` times one-change variants of the source on
    the card: each change still finds what it changes."""
    from jatts_torch.bin import study_fwd_tc_f32 as study

    src = (CSRC / f"{k1.KERNEL_TC_F32}.cu").read_text()
    for name, change in study.VARIANTS.items():
        assert (change(src) == src) == (name == "final"), name


def test_cpu_call_launches_no_kernel():
    q, k, v, ab, mask = (_t(x) for x in _np_inputs(5, 2, 2, 9, 9, 192, 192, True, [(0, 9), (0, 4)]))
    k1.reset_launches()
    out = k1.flash_attention(q, k, v, ab, mask)
    assert out.dtype == torch.float32 and (k1.launches, k1.launches_tc_f32) == (0, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_FORMS = [(d, d, b) for d in (64, 128, 192) for b in (False, True)] + [(192, 64, False), (576, 192, False)]
CARD_CASES = [
    # (B, H, Tq, Tk), key rows per item
    ((3, 2, 130, 130), [(0, 130), (0, 77), (0, 0)]),
    ((2, 2, 1000, 1000), [(0, 1000), (5, 611)]),  # T ends inside a tile
    ((2, 2, 1, 1), [(0, 1), (0, 0)]),
    ((2, 2, 70, 203), [(0, 203), (64, 65)]),  # Tq != Tk, odd Tk, a masked leading tile
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, shape, d_qk, d_v, bias, rows):
    b, h, tq, tk = shape
    return tuple(None if x is None else x.cuda()
                 for x in (_t(y) for y in _np_inputs(seed, b, h, tq, tk, d_qk, d_v, bias, rows)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", CARD_CASES, ids=["T130", "T1000", "T1", "Tq70_Tk203"])
@pytest.mark.parametrize("d_qk,d_v,bias", CARD_FORMS)
def test_tc_f32_forward_matches_plain_on_card(shape, rows, d_qk, d_v, bias):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, ab, mask = _card_inputs(6, shape, d_qk, d_v, bias, rows)
    scale = d_v ** -0.5
    k1.reset_launches()
    out, lse_k = k1.flash_attention_fwd(q, k, v, ab, mask, scale)
    out_nolse = k1.flash_attention(q, k, v, ab, mask, scale)
    torch.cuda.synchronize()
    assert k1.launches_tc_f32 == 2 and k1.launches_tc == 0
    assert (k1.launches_relpos if d_qk != d_v else k1.launches) == 2
    want, lse = k1.flash_attention_ref(q, k, v, ab, mask, scale, return_lse=True)
    assert out.dtype == torch.float32 and torch.equal(out, out_nolse)
    err = _err(out, want, d_qk != d_v)
    assert math.isfinite(err) and err <= (TOL_K1R if d_qk != d_v else TOL_K1), err
    none = torch.isinf(lse)
    assert torch.equal(none, torch.isinf(lse_k)) and bool((lse_k[none] > 0).all())
    assert (lse_k - lse).masked_fill(none, 0).abs().max().item() <= 1e-4 * max(
        1.0, lse.masked_fill(none, 0).abs().max().item())
    assert torch.all(out[none[..., None].expand_as(out)] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d_qk,d_v,bias", [(192, 192, True), (576, 192, False)])
def test_tc_f32_same_bits_each_run_and_alone_on_card(d_qk, d_v, bias):
    """No atomics: three runs give the same bits, and an item alone gives
    the bits it has inside its batch."""
    _card()
    q, k, v, ab, mask = _card_inputs(7, (4, 2, 300, 300), d_qk, d_v, bias, [(0, 300), (0, 120), (5, 77), (0, 0)])
    scale = d_v ** -0.5
    runs = [k1.flash_attention_fwd(q, k, v, ab, mask, scale) for _ in range(3)]
    one = [None if x is None else x[1:2].contiguous() for x in (q, k, v, ab, mask)]
    alone = k1.flash_attention_fwd(*one, scale)
    torch.cuda.synchronize()
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])
    assert torch.equal(alone[0], runs[0][0][1:2]) and torch.equal(alone[1], runs[0][1][1:2])


@pytest.mark.cuda
def test_tc_f32_c_entry_refuses_other_forms_on_card():
    """bf16, causal, d 256 and a bias on K1r's pair are not this kernel's."""
    _card()
    fn = k1._kernel_fn(k1.KERNEL_TC_F32)
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.zeros(2, 2, 64, 576, device="cuda")
    ab = torch.zeros(2, 2, 64, 64, device="cuda")
    out = torch.empty(2, 2, 64, 576, device="cuda")
    p = [x.data_ptr()] * 3
    for ab_ptr, d_qk, d_v, is_bf16, causal in ((None, 192, 192, 1, 0), (None, 192, 192, 0, 1),
                                               (None, 256, 256, 0, 0), (ab.data_ptr(), 576, 192, 0, 0)):
        assert fn(*p, ab_ptr, None, out.data_ptr(), None, 2, 2, 64, 64, d_qk, d_v, is_bf16, causal, 0.1, stream) != 0


@pytest.mark.cuda
def test_tc_f32_autograd_chain_matches_plain_on_card():
    """FlashAttention in f32 (the 3xTF32 forward's output and lse feeding
    the scalar dk/dv and dq kernels) against autograd through the plain
    forward, each gradient within chip_smoke's f32 backward tolerance of
    max(1, max|plain|)."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, ab, mask = _card_inputs(8, (3, 2, 200, 200), 192, 192, True, [(0, 200), (0, 131), (37, 100)])
    rng = np.random.default_rng(9)
    do = torch.from_numpy(rng.normal(size=(3, 2, 200, 192)).astype(np.float32)).cuda()
    leaves = [x.detach().requires_grad_() for x in (q, k, v, ab)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves[:3], leaves[3], mask)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k1.launches_tc_f32, k1.launches_bwd_dkv, k1.launches_bwd_dq) == (1, 1, 1)
    ref_leaves = [x.detach().requires_grad_() for x in (q, k, v, ab)]
    want = torch.autograd.grad(k1.flash_attention_ref(*ref_leaves[:3], ref_leaves[3], mask), ref_leaves, do)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= chip_smoke.TOL_BWD["f32"] * max(1.0, w.abs().max().item())
