"""K1r's bf16 backward on the tensor cores (``csrc/flash_attn_bwd_tc_relpos.cu``):
the dk/dv and dq kernels of FastSpeech2's bf16-compute JVS-latest training
under ``attn_backend: flash``.

On the CPU: a model of the kernels' arithmetic — 64-row tiles, a cluster of
d_qk / 192 blocks a tile, each block's partial scores over its 192 columns
in f32, the partials summed in f32 in rank order by every block, dp over
d_v in f32, p and ds formed in f32 and rounded to bf16 only as the A
operands of dV += P^T.dO (block r's 64-column chunk of dv), dK += dS^T.Q and
dQ += dS.K (block r's 192 columns), every output rounded once to bf16 — held
against ``flash_attention_bwd_ref`` and against the JAX package's reference
(``jax.vjp`` of the installed ``mha_reference`` on the TPU wrapper's padded
K1r call, as ``tests/test_torch_flash_tc_f32_bwd.py`` builds it) at both
(d_qk, d_v) pairs, with ragged key masks, an item whose first key tile has
no valid key, an item with no valid key and Tq != Tk both ways, within
``chip_smoke.py``'s unchanged K1r bf16 tolerance, 1e-2 of max(1,
max|plain|) of each batch item (``chip_smoke.item_err``). Mistakes the
check must catch by more than 10x: a swapped query (or key) tile in the
output products, a block summing a stale partial, a dropped key mask. A
block that sums the partials in another order passes the tolerance but no
longer holds the other blocks' scores bit for bit: the model shows that,
the card's bitwise checks hold the kernels to it. Then the dispatch rule,
the source (a plain C interface, bf16 ``wgmma``, the cluster launch and its
st.async exchange, no atomics) and ``bin/study_bwd_tc_relpos.py``'s
variants. The ``cuda`` tests are in ``tests/test_torch_flash_tc_relpos_bwd_card.py``."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import vjp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference  # noqa: E402

from jatts_torch.ops import flash_attention as k1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "jatts_torch" / "csrc"
TILE = 64
WS = 192  # q and k columns a block owns
LOG2E = 1.4426950408889634

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL = chip_smoke.TOL_K1R["bf16"]  # relative to max(1, max|plain|) of each batch item
item_err = chip_smoke.item_err
PAIRS = [(192, 64), (576, 192)]
# full, ragged, the first key tile without a valid key (keys 70..169), no valid key
ROWS = [(0, 200), (0, 131), (70, 100), (0, 0)]
NAMES = ("dq", "dk", "dv")


# ---------------------------------------------------------------------------
# a CPU model of the kernels' arithmetic
# ---------------------------------------------------------------------------


def _pad(x, n, dim, value=0.0):
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, n - x.shape[dim]]
    return torch.nn.functional.pad(x, pad, value=value)


def _a(x):
    """An f32 fragment rounded to bf16 as a wgmma A operand."""
    return x.to(torch.bfloat16).float()


def _rank_sum(parts, order):
    s = parts[order[0]]
    for r in order[1:]:
        s = s + parts[r]
    return s


def bwd_model(q, k, v, key_mask, scale, lse, di, do, w_tiles=None, stale=False, drop_mask=False, order0=None):
    """flash_attn_bwd_tc_relpos.cu's arithmetic on bf16 CPU tensors -> dict of
    dq, dk, dv (bf16) and ``same_s``: whether every block of every cluster
    held the same scores bit for bit. Rows are padded to 64-row tiles (keys
    past Tk unseen, queries past Tq with lse = +inf and di = 0). Block r of a
    cluster owns q and k columns 192r.. (and dk's or dq's) and dv's 64-column
    chunk r. Mistakes: ``w_tiles[t]`` names the query tile (dk/dv) or key
    tile (dq) whose q, do or k the output products of tile t read (the
    kernel: t); ``stale`` makes block 0 sum block 1's partial of the tile
    before; ``drop_mask`` leaves p unmasked on masked keys; ``order0`` is the
    order in which block 0 sums the partials (the kernel: rank order)."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    b, h, tq, d_qk = q.shape
    tk, d_v = k.shape[2], v.shape[3]
    nq = d_qk // WS
    assert d_v == 64 * nq
    tq_p, tk_p = -(-tq // TILE) * TILE, -(-tk // TILE) * TILE
    n_qt, n_kt = tq_p // TILE, tk_p // TILE
    qp, dop = _pad(qf, tq_p, 2), _pad(dof, tq_p, 2)
    kp, vp = _pad(kf, tk_p, 2), _pad(vf, tk_p, 2)
    maskp = _pad(key_mask, tk_p, 1, value=False)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    scale2 = f32(scale) * f32(LOG2E)
    lse2 = _pad(lse.float(), tq_p, 2, value=float("inf")) * f32(LOG2E)
    dip = _pad(di.float(), tq_p, 2)
    ranks = tuple(range(nq))
    part = [slice(WS * r, WS * r + WS) for r in range(nq)]
    chunk = [slice(64 * r, 64 * r + 64) for r in range(nq)]
    same_s = True

    def scores(parts, prev, r):
        """Block r's scores: the partials summed in its order."""
        seen = list(parts)
        if stale and r == 0 and nq > 1:
            seen[1] = torch.zeros_like(parts[1]) if prev is None else prev[1]
        return _rank_sum(seen, order0 if r == 0 and order0 else ranks)

    # dk/dv: a cluster per key tile (the key tiles a batch dimension), the loop over query tiles
    K, V = kp.view(b, h, n_kt, TILE, d_qk), vp.view(b, h, n_kt, TILE, d_v)
    kvalid = torch.ones(()) > 0 if drop_mask else maskp.view(b, 1, n_kt, TILE, 1)
    dK, dV = torch.zeros_like(K), torch.zeros_like(V)
    prev = None
    for t in range(n_qt):
        rows = slice(TILE * t, TILE * (t + 1))
        Q, dO = qp[:, :, None, rows], dop[:, :, None, rows]
        parts = [K[..., part[r]] @ Q[..., part[r]].transpose(-1, -2) for r in range(nq)]  # keys x queries
        dpt = V @ dO.transpose(-1, -2)
        cl2, cdi = lse2[:, :, None, None, rows], dip[:, :, None, None, rows]
        w = t if w_tiles is None else w_tiles[t]
        Qw, dOw = qp[:, :, None, TILE * w:TILE * (w + 1)], dop[:, :, None, TILE * w:TILE * (w + 1)]
        s_first = None
        for r in range(nq):
            s = scores(parts, prev, r)
            if s_first is None:
                s_first = s
            same_s &= bool(torch.equal(s.view(torch.int32), s_first.view(torch.int32)))
            p = torch.where(kvalid, torch.exp2(s * scale2 - cl2), torch.zeros(()))
            ds = p * (dpt - cdi) * scale
            dV[..., chunk[r]] += _a(p) @ dOw[..., chunk[r]]
            dK[..., part[r]] += _a(ds) @ Qw[..., part[r]]
        prev = parts

    # dq: a cluster per query tile, the loop over key tiles
    Qr, dOr = qp.view(b, h, n_qt, TILE, d_qk), dop.view(b, h, n_qt, TILE, d_v)
    rl2, rdi = lse2.view(b, h, n_qt, TILE, 1), dip.view(b, h, n_qt, TILE, 1)
    dQ = torch.zeros_like(Qr)
    prev = None
    for t in range(n_kt):
        keys = slice(TILE * t, TILE * (t + 1))
        Kt, Vt = kp[:, :, None, keys], vp[:, :, None, keys]
        parts = [Qr[..., part[r]] @ Kt[..., part[r]].transpose(-1, -2) for r in range(nq)]  # queries x keys
        dpm = dOr @ Vt.transpose(-1, -2)
        valid = torch.ones(()) > 0 if drop_mask else maskp[:, None, None, None, keys]
        w = t if w_tiles is None else w_tiles[t]
        Kw = kp[:, :, None, TILE * w:TILE * (w + 1)]
        for r in range(nq):
            s = scores(parts, prev, r)
            p = torch.where(valid, torch.exp2(s * scale2 - rl2), torch.zeros(()))
            ds = p * (dpm - rdi) * scale
            dQ[..., part[r]] += _a(ds) @ Kw[..., part[r]]
        prev = parts
    return {
        "dq": dQ.view(b, h, tq_p, d_qk)[:, :, :tq].to(torch.bfloat16),
        "dk": dK.view(b, h, tk_p, d_qk)[:, :, :tk].to(torch.bfloat16),
        "dv": dV.view(b, h, tk_p, d_v)[:, :, :tk].to(torch.bfloat16),
        "same_s": same_s,
    }


def _np_inputs(seed, b, h, tq, tk, d_qk, d_v, rows):
    """q, k, v, do ~ N(0, 1) made with numpy and rounded to bf16, do zero on
    padded query rows (the conformer discards them, and the JAX reference's
    padded rows attend padded keys); rows: (first valid key, count) per
    batch item -> bf16 numpy-valued f32 arrays and the mask."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, tq, d_qk)).astype(np.float32)
    k = rng.normal(size=(b, h, tk, d_qk)).astype(np.float32)
    v = rng.normal(size=(b, h, tk, d_v)).astype(np.float32)
    do = rng.normal(size=(b, h, tq, d_v)).astype(np.float32)
    pos = np.arange(tk)
    mask = np.stack([(pos >= a) & (pos < a + n) for a, n in rows])
    if tq == tk:
        do = do * mask[:, None, :, None]
    rnd = [torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v, do)]
    return (*rnd, mask)


def _t(x):
    t = torch.from_numpy(x)
    return t if t.dtype == torch.bool else t.to(torch.bfloat16)


def _plain(q, k, v, do, mask, scale):
    """The plain forward's lse, di as the wrapper forms it, and the plain
    backward, in bf16."""
    o, lse = k1.flash_attention_ref(q, k, v, None, mask, scale, return_lse=True)
    di = (o.float() * do.float()).sum(-1)
    dq, dk, dv, _ = k1.flash_attention_bwd_ref(q, k, v, None, mask, scale, o, lse, do)
    return lse, di, {"dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_cpu_model_matches_the_plain_version(d_qk, d_v):
    q, k, v, do, mask = (_t(x) for x in _np_inputs(1, 4, 2, 200, 200, d_qk, d_v, ROWS))
    scale = d_v ** -0.5
    lse, di, want = _plain(q, k, v, do, mask, scale)
    got = bwd_model(q, k, v, mask, scale, lse, di, do)
    for name in NAMES:
        err = item_err(got[name], want[name])
        assert 0 < err <= TOL, (name, err)
    assert got["same_s"]
    # a key no row sees: dk, dv exactly 0; an item without a valid key: all 0
    unseen = ~mask[:, None, :, None]
    assert torch.all(got["dk"].masked_select(unseen) == 0) and torch.all(got["dv"].masked_select(unseen) == 0)
    assert torch.all(got["dq"].masked_select(torch.isinf(lse)[..., None]) == 0)
    assert all(torch.all(got[n][3] == 0) for n in NAMES)


def _jax_bwd(q, k, v, mask, do, scale):
    """``jax.vjp`` of ``mha_reference`` on the TPU wrapper's padded K1r call
    (v zero-padded to d_qk, the output sliced to d_v), segment ids 1 on valid
    and 0 on padded positions; q pre-scaled, as the reference's VJP takes
    sm_scale = 1 only -> [dq, dk, dv] in f32."""
    d_qk, d_v = q.shape[-1], v.shape[-1]
    seg = jnp.asarray(mask.astype(np.int32))
    ids = SegmentIds(q=seg, kv=seg)

    def f(q, k, v):
        vp = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, d_qk - d_v)))
        return mha_reference(q * scale, k, vp, None, ids, sm_scale=1.0)[..., :d_v]

    _, pullback = vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [torch.from_numpy(np.array(g)) for g in pullback(jnp.asarray(do))]


@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_cpu_model_matches_the_jax_reference(d_qk, d_v):
    """The model against the VJP of the installed Pallas kernel's own
    reference on the TPU wrapper's call, in f32 on the same bf16 values,
    every element (do is zero on the padded rows, so the two conventions for
    those rows agree)."""
    q, k, v, do, mask = _np_inputs(2, 4, 2, 200, 200, d_qk, d_v, ROWS)
    scale = d_v ** -0.5
    want = _jax_bwd(q, k, v, mask, do, scale)
    tq, tk, tv, tdo, tmask = (_t(x) for x in (q, k, v, do, mask))
    lse, di, _ = _plain(tq, tk, tv, tdo, tmask, scale)
    got = bwd_model(tq, tk, tv, tmask, scale, lse, di, tdo)
    for name, w in zip(NAMES, want):
        err = item_err(got[name], w)
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("tq,tk", [(70, 203), (203, 70)])
def test_cpu_model_takes_tq_other_than_tk(tq, tk):
    """Tq != Tk both ways, each ending inside a tile."""
    q, k, v, do, mask = (_t(x) for x in _np_inputs(3, 2, 2, tq, tk, 576, 192, [(0, tk), (5, tk // 2)]))
    scale = 192 ** -0.5
    lse, di, want = _plain(q, k, v, do, mask, scale)
    got = bwd_model(q, k, v, mask, scale, lse, di, do)
    assert max(item_err(got[n], want[n]) for n in NAMES) <= TOL


def test_mistakes_fail_the_check_by_more_than_10x():
    """Held as the card holds the kernels (per item, 1e-2): the output
    products of two tiles swapped, a block summing a stale partial, or the
    key mask dropped, each fail by more than 10x. A block that sums the
    partials in another order stays inside the tolerance, and only the bits
    show it."""
    q, k, v, do, mask = (_t(x) for x in _np_inputs(4, 2, 2, 256, 256, 576, 192, [(0, 256), (0, 150)]))
    scale = 192 ** -0.5
    lse, di, want = _plain(q, k, v, do, mask, scale)

    def worst(got):
        return max(item_err(got[n], want[n]) for n in NAMES)

    assert worst(bwd_model(q, k, v, mask, scale, lse, di, do)) <= TOL
    mistakes = {
        "swapped": bwd_model(q, k, v, mask, scale, lse, di, do, w_tiles=[0, 2, 1, 3]),
        "stale": bwd_model(q, k, v, mask, scale, lse, di, do, stale=True),
        "unmasked": bwd_model(q, k, v, mask, scale, lse, di, do, drop_mask=True),
    }
    reordered = bwd_model(q, k, v, mask, scale, lse, di, do, order0=(2, 1, 0))
    print("k1r bf16 backward mistakes, worst item's error: "
          + ", ".join(f"{n} {worst(g):.2e}" for n, g in mistakes.items()) + f" (tol {TOL:.0e})")
    for name, got in mistakes.items():
        assert worst(got) > 10 * TOL, name
    assert worst(reordered) <= TOL and not reordered["same_s"]


# ---------------------------------------------------------------------------
# the rule, the source, the study
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d_qk,d_v", [(64, 64), (192, 192), (192, 64), (576, 192)])
@pytest.mark.parametrize("has_bias", [False, True])
def test_bwd_rule_sends_k1r_bf16_to_the_tensor_cores(dtype, causal, d_qk, d_v, has_bias):
    """bf16, non-causal, a K1r pair, no bias -> the bf16 tensor-core dk/dv
    and dq; no other form goes there. bf16, non-causal, (192, 192) with a
    bias -> K1-bwd's bf16 kernels with a bias
    (``tests/test_torch_flash_tc_bias_bwd.py``)."""
    want_relpos = dtype == torch.bfloat16 and not causal and (d_qk, d_v) in k1.RELPOS_PAIRS and not has_bias
    want_bias = dtype == torch.bfloat16 and not causal and (d_qk, d_v) == (192, 192) and has_bias
    for rule in (k1.dkv_kernel, k1.dq_kernel):
        assert (rule(dtype, causal, d_qk, d_v, has_bias) == k1.KERNEL_BWD_TC_RELPOS) == want_relpos
        assert (rule(dtype, causal, d_qk, d_v, has_bias) == k1.KERNEL_BWD_TC_BIAS) == want_bias


def test_source_is_a_cluster_bf16_kernel_with_a_plain_c_interface():
    src = (CSRC / f"{k1.KERNEL_BWD_TC_RELPOS}.cu").read_text()
    common = (CSRC / "tc_common.cuh").read_text()
    assert 'extern "C" int jatts_flash_attn_bwd_dkv_tc_relpos(' in src
    assert 'extern "C" int jatts_flash_attn_bwd_dq_tc_relpos(' in src
    assert "tc_f32_common" not in src
    # the argument list of jatts_flash_attn_bwd_{dkv,dq}_tc_f32: 10 pointers, 8 ints, the scale, the stream
    for name in ("dkv", "dq"):
        sig = re.search(rf'extern "C" int jatts_flash_attn_bwd_{name}_tc_relpos\((.*?)\)', src, re.S).group(1)
        args = [a.strip() for a in sig.split(",")]
        assert len(args) == 20 and sum("void*" in a for a in args) == 11 and args[-2] == "float sm_scale", name
    # bf16 wgmma (the header's), the partial and dp from shared memory, the
    # outputs with A from registers against the streamed slab MN-major
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in common
    assert "wgmma_ss(acc, " in src and "wgmma_ss(dp, " in src
    assert "wgmma_rs(o[c], da[kk], slab_desc(y_addr + c * SLAB) + 128 * kk)" in src
    assert "wgmma_rs(ov, pa[kk], slab_desc(y_addr + (NS + role) * SLAB) + 128 * kk)" in src
    assert "tf32" not in src
    # a cluster over the widths, the partials exchanged by st.async in
    # distributed shared memory (tc_cluster.cuh's helpers, the f32 backward's)
    cluster = (CSRC / "tc_cluster.cuh").read_text()
    assert "cudaLaunchAttributeClusterDimension" in src and "cudaLaunchKernelEx" in src
    assert '#include "tc_cluster.cuh"' in src and '#include "tc_common.cuh"' in cluster
    assert "%%cluster_ctarank" in cluster and "mapa.shared::cluster" in cluster and "barrier.cluster" in cluster
    assert "st.async.shared::cluster.mbarrier::complete_tx::bytes" in cluster
    assert "cluster_sync();" in src and "st_async4(" in src and "st_async_ack(" in src
    assert "tma_load(" in src and "torch/" not in src and "#include <ATen" not in src
    assert "atomicAdd" not in src and not re.search(r"\b(atom|red)\.(global|shared|add)", src)
    # both K1r pairs instantiated, one template for both kernels
    for d_qk, d_v in k1.RELPOS_PAIRS:
        assert f"launch<{d_qk}, {d_v}, DQ>" in src
    assert src.count("__global__") == 1 and "template <int DQK, int DV, bool DQ>" in src
    # the shared helpers live once, in the headers
    for helper in ("void wgmma_ss(", "void wgmma_rs(", "void tma_load(", "void mbar_wait(", "bool make_map(",
                   "uint64_t slab_desc(", "void frag_to_a("):
        assert helper in common and helper not in src, helper
    for helper in ("void st_async4(", "uint32_t peer_addr(", "void mbar_wait_cluster(", "int slot_of("):
        assert helper in cluster and helper not in src, helper


def test_the_scalar_relpos_kernels_stay_beside():
    """The scalar bf16 K1r backward serves no route but is still built, for
    the timings beside the new kernels (``_lib=KERNEL_BWD``)."""
    scalar = (CSRC / f"{k1.KERNEL_BWD}.cu").read_text()
    assert "launch_relpos<__nv_bfloat16, 576, 192, DKV>(a)" in scalar
    assert "launch_relpos<__nv_bfloat16, 192, 64, DKV>(a)" in scalar
    assert k1._BWD_SUFFIX[k1.KERNEL_BWD_TC_RELPOS] == "_tc_relpos"


def test_study_variants_apply_to_the_source():
    """``bin/study_bwd_tc_relpos.py`` times one-change variants on the card:
    each change still finds what it changes."""
    from jatts_torch.bin import study_bwd_tc_relpos as study

    files = study.sources((study.SOURCE,))
    for name, change in study.VARIANTS.items():
        assert (change(files) == files) == (name == "final"), name
    assert "#define RELPOS_STAMPS" in study.VARIANTS["stamps"](files)[study.SOURCE]


def test_cpu_backward_launches_no_kernel():
    q, k, v, do, mask = (_t(x) for x in _np_inputs(5, 2, 2, 9, 9, 576, 192, [(0, 9), (0, 4)]))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, None, mask)
    grads = torch.autograd.grad(out, leaves, do)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in grads)
    assert (k1.launches_bwd_dkv_tc_relpos, k1.launches_bwd_dq_tc_relpos, k1.launches_bwd_dkv_relpos) == (0, 0, 0)
