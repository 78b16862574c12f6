"""K1r's f32 backward on the tensor cores in 3xTF32 (``csrc/flash_attn_bwd_tc_f32.cu``):
the dk/dv and dq kernels of FastSpeech2's JVS-latest training path.

On the CPU: a model of the kernels' arithmetic — 64-row tiles, every operand
split into hi = rna(x) and lo = rna(x - hi) by bit arithmetic (the forward
test's helpers, copied), the products hi.lo + lo.hi + hi.hi, the scores and dp
summed one 32-column slab at a time in f32 and the score blocks' partials
in rank order, the output products one 32-row half at a time with the
summed index permuted (the A fragment in the order PI, the transposed slab's
rows in the order ``perm``) — held against ``flash_attention_bwd_ref`` and
against the JAX package's reference (``jax.vjp`` of the installed
``mha_reference`` on the TPU wrapper's padded K1r call, as
``tests/test_torch_relpos.py`` builds it) at both (d_qk, d_v) pairs, with
key masks, an item whose first key tile has no valid key and an item with
no valid key, within ``chip_smoke.py``'s unchanged K1r f32 tolerance, 1e-5
of max(1, max|plain|) of each batch item (``chip_smoke.item_err``). A model
of the tensor cores' truncating f32 sums shows that one long chain (the
scores over all of d_qk, dk over all the queries) misses that tolerance
where the kernels' short chains hold it (``-s`` prints both). Mistakes the
check must catch by more than 10x: a swapped query tile, a missing or wrong
permutation, a block that sums a stale partial. A block that sums the
partials in another order passes the tolerance (the difference is one
rounding) but no longer holds the other blocks' scores bit for bit: the
model shows that, the card's bitwise checks hold the kernels to it. Then the
dispatch rule, the source (a plain C interface, ``wgmma`` .tf32, the cluster
launch and its st.async exchange, no atomics) and the library hash over
``csrc/*.cuh``.

Marked ``cuda`` (skipped without a card; the card's machine runs them with
``python -m pytest tests/test_torch_flash_tc_f32_bwd.py -m cuda``): both
kernels at both pairs against the plain version at ragged T, T = 1, Tq != Tk
both ways and a masked leading key tile (dq exactly 0 on rows that see no
key, dk and dv exactly 0 on keys no row sees); the same bits from run to run
and for an item alone as in its batch; the C entries refusing what they do
not take; the autograd chain through ``FlashAttention``. Imports no flax."""

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
from jax import vjp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference  # noqa: E402

from jatts_torch.ops import build  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "jatts_torch" / "csrc"
TILE = 64
WS = 192  # q and k columns a score block owns
LOG2E = 1.4426950408889634

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL = chip_smoke.TOL_K1R["f32"]  # relative to max(1, max|plain|) of each batch item
item_err = chip_smoke.item_err
# position a of each group of 8 of the summed index holds PI[a]: the k8 .tf32
# A fragment's columns (c, c + 4) are the accumulator's (2c, 2c + 1)
PI = (0, 2, 4, 6, 1, 3, 5, 7)


# ---------------------------------------------------------------------------
# tests/test_torch_flash_tc_f32.py's helpers (a copy: the card's machine has
# another top-level `tests` package, so one test file cannot import another)
# ---------------------------------------------------------------------------


def tf32_rna(x):
    """``cvt.rna.tf32.f32``'s rounding in two integer operations, as the
    kernels do it."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _rz(x):
    """float64 -> f32 rounded toward zero: how a tensor-core f32 sum rounds."""
    x32 = x.float()
    return torch.where(x32.double().abs() > x.abs(), torch.nextafter(x32, torch.zeros_like(x32)), x32)


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


# ---------------------------------------------------------------------------
# a CPU model of the kernels' arithmetic
# ---------------------------------------------------------------------------


def prod3(a, b):
    """a @ b in 3xTF32: hi.lo + lo.hi + hi.hi of the split pieces, in f32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return ah @ bl + al @ bh + ah @ bh


def chained(x, y, cols):
    """x[..., cols] . y[..., cols]^T as a block sums it: each 32-column
    slab's product in a fresh accumulator, added to the running sum in f32."""
    run = None
    for c in range(cols.start, cols.stop, 32):
        part = prod3(x[..., c:c + 32], y[..., c:c + 32].transpose(-1, -2))
        run = part if run is None else run + part
    return run


def _rank_sum(parts, order):
    s = parts[order[0]]
    for r in order[1:]:
        s = s + parts[r]
    return s


def _positions(order):
    """Tile positions (64) in the order ``order`` within each group of 8."""
    return [8 * g + a for g in range(TILE // 8) for a in order]


def _pad(x, n, dim, value=0.0):
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, n - x.shape[dim]]
    return torch.nn.functional.pad(x, pad, value=value)


def bwd_model(q, k, v, key_mask, scale, lse, di, do, perm=PI, w_tiles=None, stale=False, dp_block_order=None,
              ab=None, bias_untransposed=False, bias_after_scale=False, dab_unwritten=False):
    """flash_attn_bwd_tc_f32.cu's arithmetic on f32 CPU tensors -> dict of
    dq, dk, dv, dab (with ``ab``) and ``same_s``: whether every block of
    every cluster held the same scores bit for bit. Rows are padded to
    64-row tiles (keys past Tk unseen, queries past Tq with lse = +inf and
    di = 0). ``perm`` is the row order of the transposed slabs in each group
    of 8 (the kernel: PI, the A fragment's order); ``w_tiles[t]`` names the
    query tile whose q and do the dk/dv output product of tile t reads (the
    kernel: t); ``stale`` makes the dk/dv dp block sum score block 1's
    partial of the tile before; ``dp_block_order`` the order in which the
    dk/dv dp block sums the score blocks' partials (the kernel: rank order).
    ``ab`` [B, H, Tq, Tk] (K1-bwd, one score block) is added to score block
    0's partial before the push, each tile's 64 x 64 slab staged query-major
    and read transposed by dk/dv (keys x queries); d(ab) starts as NaN (the
    wrapper's torch.empty) and the dq kernel writes ds on each key tile and
    zeros where it skips one (an item's tile with no valid key). Mistakes:
    ``bias_untransposed`` (dk/dv reads the slab as if key-major),
    ``bias_after_scale`` (p = exp(s * scale + ab - lse)), ``dab_unwritten``
    (a skipped tile's d(ab) left as it was)."""
    b, h, tq, d_qk = q.shape
    tk, d_v = k.shape[2], v.shape[3]
    nq = d_qk // WS
    tq_p, tk_p = -(-tq // TILE) * TILE, -(-tk // TILE) * TILE
    n_qt, n_kt = tq_p // TILE, tk_p // TILE
    qp, dop = _pad(q, tq_p, 2), _pad(do, tq_p, 2)
    kp, vp = _pad(k, tk_p, 2), _pad(v, tk_p, 2)
    maskp = _pad(key_mask, tk_p, 1, value=False)
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    lse2 = _pad(lse, tq_p, 2, value=float("inf")) * torch.tensor(LOG2E, dtype=torch.float32)
    abp = None if ab is None else _pad(_pad(ab, tq_p, 2), tk_p, 3)  # the slab's zeros past Tq and Tk
    early = ab is not None and not bias_after_scale  # the kernel: into the scores, before the scale

    def late(bias):
        """The mistake's bias after the scale (base 2), else nothing."""
        return 0.0 if ab is None or early else bias * torch.tensor(LOG2E, dtype=torch.float32)
    dip = _pad(di, tq_p, 2)
    a_pos, b_pos = _positions(PI), _positions(perm)
    halves = [(slice(32 * hf, 32 * hf + 32)) for hf in range(2)]
    ranks = tuple(range(nq))
    same_s = True

    # dk/dv: a cluster per key tile (the key tiles a batch dimension), the loop over query tiles
    K, V = kp.view(b, h, n_kt, TILE, d_qk), vp.view(b, h, n_kt, TILE, d_v)
    kvalid = maskp.view(b, 1, n_kt, TILE, 1)
    dK, dV = torch.zeros_like(K), torch.zeros_like(V)
    prev_parts = None
    for t in range(n_qt):
        rows = slice(TILE * t, TILE * (t + 1))
        Q, dO = qp[:, :, None, rows], dop[:, :, None, rows]
        parts = [chained(K, Q, slice(WS * r, WS * r + WS)) for r in range(nq)]
        bias = None
        if ab is not None:
            slab = abp[:, :, rows].view(b, h, TILE, n_kt, TILE)  # [query, key tile, key]
            # element (key r, query c) of key tile kt: slab (c, r); the mistake reads slab (r, c)
            bias = slab.permute(0, 1, 3, 2, 4) if bias_untransposed else slab.permute(0, 1, 3, 4, 2)
            if early:
                parts[0] = parts[0] + bias
        s = _rank_sum(parts, ranks)
        dp_parts = list(parts)
        if stale and nq > 1:
            dp_parts[1] = torch.zeros_like(parts[1]) if prev_parts is None else prev_parts[1]
        s_dp = _rank_sum(dp_parts, dp_block_order or ranks)
        same_s &= bool(torch.equal(s.view(torch.int32), s_dp.view(torch.int32)))
        prev_parts = parts
        dpt = chained(V, dO, slice(0, d_v))
        cl2, cdi = lse2[:, :, None, None, rows], dip[:, :, None, None, rows]
        p = torch.where(kvalid, torch.exp2(s * scale2 + late(bias) - cl2), torch.zeros(()))
        p_dv = torch.where(kvalid, torch.exp2(s_dp * scale2 + late(bias) - cl2), torch.zeros(()))
        ds = p * (dpt - cdi) * scale
        w = t if w_tiles is None else w_tiles[t]
        wrows = slice(TILE * w, TILE * (w + 1))
        Qw, dOw = qp[:, :, None, wrows], dop[:, :, None, wrows]
        for hs in halves:
            a_idx = [i for i in a_pos if hs.start <= i < hs.stop]
            b_idx = [i for i in b_pos if hs.start <= i < hs.stop]
            dV = dV + prod3(p_dv[..., a_idx], dOw[..., b_idx, :])
            dK = dK + prod3(ds[..., a_idx], Qw[..., b_idx, :])

    # dq: a cluster per query tile, the loop over key tiles
    Qr, dOr = qp.view(b, h, n_qt, TILE, d_qk), dop.view(b, h, n_qt, TILE, d_v)
    rl2, rdi = lse2.view(b, h, n_qt, TILE, 1), dip.view(b, h, n_qt, TILE, 1)
    dQ = torch.zeros_like(Qr)
    dab = None if ab is None else torch.full((b, h, n_qt, TILE, tk_p), float("nan"))
    for t in range(n_kt):
        keys = slice(TILE * t, TILE * (t + 1))
        Kt, Vt = kp[:, :, None, keys], vp[:, :, None, keys]
        parts = [chained(Qr, Kt, slice(WS * r, WS * r + WS)) for r in range(nq)]
        bias = None if ab is None else abp[..., keys].view(b, h, n_qt, TILE, TILE)  # [query, key]: as it stands
        if early:
            parts[0] = parts[0] + bias
        s = _rank_sum(parts, ranks)
        dpm = chained(dOr, Vt, slice(0, d_v))
        valid = maskp[:, None, None, None, keys]
        p = torch.where(valid, torch.exp2(s * scale2 + late(bias) - rl2), torch.zeros(()))
        ds = p * (dpm - rdi) * scale
        if dab is not None:
            # an item's tile with no valid key: every consumer skips it, and
            # the kernel writes zeros there (the mistake: nothing)
            skipped = ~maskp[:, keys].any(-1)[:, None, None, None, None]
            dab[..., keys] = torch.where(skipped, dab[..., keys] if dab_unwritten else torch.zeros(()), ds)
        for hs in halves:
            a_idx = [i for i in a_pos if hs.start <= i < hs.stop]
            b_idx = [i for i in b_pos if hs.start <= i < hs.stop]
            dQ = dQ + prod3(ds[..., a_idx], Kt[..., b_idx, :])
    return {
        "dq": dQ.view(b, h, tq_p, d_qk)[:, :, :tq],
        "dk": dK.view(b, h, tk_p, d_qk)[:, :, :tk],
        "dv": dV.view(b, h, tk_p, d_v)[:, :, :tk],
        "dab": None if dab is None else dab.view(b, h, tq_p, tk_p)[:, :, :tq, :tk],
        "same_s": same_s,
    }


def _np_inputs(seed, b, h, tq, tk, d_qk, d_v, rows):
    """q, k, v, do ~ N(0, 1) made with numpy, do zero on padded query rows
    (the conformer discards them, and the JAX reference's padded rows attend
    padded keys); rows: (first valid key, count) per batch item."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, tq, d_qk)).astype(np.float32)
    k = rng.normal(size=(b, h, tk, d_qk)).astype(np.float32)
    v = rng.normal(size=(b, h, tk, d_v)).astype(np.float32)
    do = rng.normal(size=(b, h, tq, d_v)).astype(np.float32)
    pos = np.arange(tk)
    mask = np.stack([(pos >= a) & (pos < a + n) for a, n in rows])
    if tq == tk:
        do = do * mask[:, None, :, None]
    return q, k, v, do, mask


def _t(x):
    return torch.from_numpy(x)


def _plain(q, k, v, do, mask, scale, ab=None):
    """The plain forward's o and lse, di, and the plain backward."""
    o, lse = k1.flash_attention_ref(q, k, v, ab, mask, scale, return_lse=True)
    di = (o * do).sum(-1)
    dq, dk, dv, dab = k1.flash_attention_bwd_ref(q, k, v, ab, mask, scale, o, lse, do)
    return o, lse, di, {"dq": dq, "dk": dk, "dv": dv, "dab": dab}


PAIRS = [(192, 64), (576, 192)]
# full, ragged, the first key tile without a valid key (keys 70..169), no valid key
ROWS = [(0, 200), (0, 131), (70, 100), (0, 0)]


@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_cpu_model_matches_the_plain_version(d_qk, d_v):
    q, k, v, do, mask = (_t(x) for x in _np_inputs(1, 4, 2, 200, 200, d_qk, d_v, ROWS))
    scale = d_v ** -0.5
    _, lse, di, want = _plain(q, k, v, do, mask, scale)
    with _one_thread():
        got = bwd_model(q, k, v, mask, scale, lse, di, do)
    for name in ("dq", "dk", "dv"):
        err = item_err(got[name], want[name])
        assert 0 < err <= TOL, (name, err)
    assert got["same_s"]
    # a key no row sees: dk, dv exactly 0; an item without a valid key: all 0
    unseen = ~mask[:, None, :, None]
    assert torch.all(got["dk"].masked_select(unseen) == 0) and torch.all(got["dv"].masked_select(unseen) == 0)
    assert all(torch.all(got[n][3] == 0) for n in ("dq", "dk", "dv"))


def _jax_bwd(q, k, v, mask, do, scale):
    """``jax.vjp`` of ``mha_reference`` on the TPU wrapper's padded K1r call
    (v zero-padded to d_qk, the output sliced to d_v), segment ids 1 on valid
    and 0 on padded positions; q pre-scaled, as the reference's VJP takes
    sm_scale = 1 only -> [dq, dk, dv]."""
    d_qk, d_v = q.shape[-1], v.shape[-1]
    seg = jnp.asarray(mask.astype(np.int32))
    ids = SegmentIds(q=seg, kv=seg)

    def f(q, k, v):
        vp = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, d_qk - d_v)))
        return mha_reference(q * scale, k, vp, None, ids, sm_scale=1.0)[..., :d_v]

    _, pullback = vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in pullback(jnp.asarray(do))]


@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_cpu_model_matches_the_jax_reference(d_qk, d_v):
    """The model against the VJP of the installed Pallas kernel's own
    reference on the TPU wrapper's call, every element (do is zero on the
    padded rows, so the two conventions for those rows agree)."""
    q, k, v, do, mask = _np_inputs(2, 4, 2, 200, 200, d_qk, d_v, ROWS)
    scale = d_v ** -0.5
    want = _jax_bwd(q, k, v, mask, do, scale)
    tq, tk, tv, tdo, tmask = (_t(x) for x in (q, k, v, do, mask))
    _, lse, di, _ = _plain(tq, tk, tv, tdo, tmask, scale)
    with _one_thread():
        got = bwd_model(tq, tk, tv, tmask, scale, lse, di, tdo)
    for name, w in zip(("dq", "dk", "dv"), want):
        err = item_err(got[name], torch.from_numpy(np.array(w)))
        assert err <= TOL, (name, err)


def test_cpu_model_takes_tq_other_than_tk():
    """Tq != Tk both ways, each ending inside a tile."""
    for tq, tk in ((70, 203), (203, 70)):
        q, k, v, do, mask = (_t(x) for x in _np_inputs(3, 2, 2, tq, tk, 576, 192, [(0, tk), (5, tk // 2)]))
        scale = 192 ** -0.5
        _, lse, di, want = _plain(q, k, v, do, mask, scale)
        with _one_thread():
            got = bwd_model(q, k, v, mask, scale, lse, di, do)
        assert max(item_err(got[n], want[n]) for n in ("dq", "dk", "dv")) <= TOL


def test_mistakes_fail_the_check_by_more_than_10x():
    """Held as the card holds the kernels (per item, 1e-5): the output
    products of two query tiles swapped, the transposed slabs unpermuted or
    wrongly permuted under the permuted A fragment, or a block summing a
    stale partial, each fail by more than 10x. A block that sums the
    partials in another order stays inside the tolerance, and only the
    bits show it."""
    q, k, v, do, mask = (_t(x) for x in _np_inputs(4, 2, 2, 256, 256, 576, 192, [(0, 256), (0, 250)]))
    scale = 192 ** -0.5
    _, lse, di, want = _plain(q, k, v, do, mask, scale)

    def worst(got):
        return max(item_err(got[n], want[n]) for n in ("dq", "dk", "dv"))

    with _one_thread():
        assert worst(bwd_model(q, k, v, mask, scale, lse, di, do)) <= TOL
        swapped = bwd_model(q, k, v, mask, scale, lse, di, do, w_tiles=[0, 2, 1, 3])
        unpermuted = bwd_model(q, k, v, mask, scale, lse, di, do, perm=tuple(range(8)))
        reversed_ = bwd_model(q, k, v, mask, scale, lse, di, do, perm=tuple(reversed(PI)))
        stale = bwd_model(q, k, v, mask, scale, lse, di, do, stale=True)
        reordered = bwd_model(q, k, v, mask, scale, lse, di, do, dp_block_order=(2, 1, 0))
    for name, got in (("swapped", swapped), ("unpermuted", unpermuted), ("reversed", reversed_), ("stale", stale)):
        assert worst(got) > 10 * TOL, name
    assert worst(reordered) <= TOL and not reordered["same_s"]


# ---------------------------------------------------------------------------
# K1-bwd's form: (d_qk, d_v) = (192, 192), a dense bias and d(ab)
# ---------------------------------------------------------------------------

K1_DIMS = (192, 192)
# (Tq, Tk), key rows per item: every key; keys 70.. (the first key tile has
# no valid key, nor has the last); no valid key
K1_CASES = [((150, 203), [(0, 203), (70, 100), (0, 0)]), ((203, 150), [(0, 150), (70, 60), (0, 0)])]
DAB_NAMES = ("dq", "dk", "dv", "dab")


def _np_bias_inputs(seed, b, h, tq, tk, rows):
    """``_np_inputs`` at K1-bwd's width plus a dense bias at the scale of
    q.k^T (N(0, 1) x sqrt(d), as ``chip_smoke.py`` makes it); do zero on an
    item with no valid key (the JAX reference's rows there attend every
    key, uniformly) -> q, k, v, ab, do, mask."""
    q, k, v, do, mask = _np_inputs(seed, b, h, tq, tk, *K1_DIMS, rows)
    rng = np.random.default_rng(seed + 1)
    ab = (rng.normal(size=(b, h, tq, tk)) * math.sqrt(K1_DIMS[0])).astype(np.float32)
    do = do * mask.any(-1)[:, None, None, None]
    return q, k, v, ab, do, mask


def _jax_bwd_bias(q, k, v, ab, mask, do, scale):
    """``jax.vjp`` of the installed ``mha_reference`` with a bias, segment
    ids 1 on every query and on the valid keys, 0 on the masked ones (a
    query sees its item's valid keys); q and ab pre-scaled, as the
    reference's VJP takes sm_scale = 1 only ((q.k^T + ab) * scale =
    (q * scale).k^T + ab * scale) -> [dq, dk, dv, dab]."""
    ids = SegmentIds(q=jnp.ones((q.shape[0], q.shape[2]), jnp.int32), kv=jnp.asarray(mask.astype(np.int32)))

    def f(q, k, v, ab):
        return mha_reference(q * scale, k, v, ab * scale, ids, sm_scale=1.0)

    _, pullback = vjp(f, *(jnp.asarray(x) for x in (q, k, v, ab)))
    return [torch.from_numpy(np.array(g)) for g in pullback(jnp.asarray(do))]


def _finite_err(got, want):
    """``item_err``, a NaN read as an infinite error (the card's checks
    require finite outputs)."""
    err = item_err(got, want)
    return err if math.isfinite(err) else math.inf


@pytest.mark.parametrize("shape,rows", K1_CASES, ids=["Tq150_Tk203", "Tq203_Tk150"])
def test_cpu_model_with_a_bias_matches_the_plain_version_and_the_jax_reference(shape, rows):
    """K1-bwd's form (192, 192) with a bias: the model's dq, dk, dv and
    d(ab) per item within 1e-5 of ``flash_attention_bwd_ref`` and of the
    VJP of the installed Pallas kernel's reference; d(ab) written on every
    element (no NaN of the empty buffer left), exactly 0 on masked keys
    (the skipped leading tile too) and on rows that see no key, dk and dv
    exactly 0 on keys that no row sees."""
    tq, tk = shape
    q, k, v, ab, do, mask = _np_bias_inputs(11, 3, 2, tq, tk, rows)
    scale = K1_DIMS[0] ** -0.5
    jax_want = dict(zip(DAB_NAMES, _jax_bwd_bias(q, k, v, ab, mask, do, scale)))
    tq_, tk_, tv, tab, tdo, tmask = (_t(x) for x in (q, k, v, ab, do, mask))
    _, lse, di, want = _plain(tq_, tk_, tv, tdo, tmask, scale, tab)
    with _one_thread():
        got = bwd_model(tq_, tk_, tv, tmask, scale, lse, di, tdo, ab=tab)
    for name in DAB_NAMES:
        err, err_jax = _finite_err(got[name], want[name]), _finite_err(got[name], jax_want[name])
        assert 0 < err <= TOL and err_jax <= TOL, (name, err, err_jax)
    assert got["same_s"]
    unseen = ~tmask[:, None, None, :]
    assert torch.all(got["dab"].masked_select(unseen) == 0)
    assert torch.all(got["dab"].masked_select(torch.isinf(lse)[..., None]) == 0)
    assert torch.all(got["dk"].masked_select(unseen.transpose(-1, -2)) == 0)
    assert torch.all(got["dv"].masked_select(unseen.transpose(-1, -2)) == 0)
    assert all(torch.all(got[n][2] == 0) for n in DAB_NAMES)


def test_bias_mistakes_fail_the_check_by_more_than_10x():
    """Held as the card holds the kernels (per item, 1e-5; a NaN fails):
    dk/dv reading the query-major bias slab without transposing it, the bias
    added after the scale, and d(ab) left unwritten (the empty buffer's NaN)
    on a key tile that dq skips, each fail by more than 10x."""
    (tq, tk), rows = K1_CASES[0]
    q, k, v, ab, do, mask = (_t(x) for x in _np_bias_inputs(12, 3, 2, tq, tk, rows))
    scale = K1_DIMS[0] ** -0.5
    _, lse, di, want = _plain(q, k, v, do, mask, scale, ab)

    def worst(got):
        return max(_finite_err(got[n], want[n]) for n in DAB_NAMES)

    with _one_thread():
        assert worst(bwd_model(q, k, v, mask, scale, lse, di, do, ab=ab)) <= TOL
        untransposed = bwd_model(q, k, v, mask, scale, lse, di, do, ab=ab, bias_untransposed=True)
        after = bwd_model(q, k, v, mask, scale, lse, di, do, ab=ab, bias_after_scale=True)
        unwritten = bwd_model(q, k, v, mask, scale, lse, di, do, ab=ab, dab_unwritten=True)
    print("k1-bwd bias mistakes, worst item's error: " + ", ".join(
        f"{name} {worst(got):.2e}" for name, got in (("untransposed", untransposed), ("after the scale", after),
                                                     ("unwritten", unwritten))) + f" (tol {TOL:.0e})")
    for name, got in (("untransposed", untransposed), ("after the scale", after), ("unwritten", unwritten)):
        assert worst(got) > 10 * TOL, name
    # the first two are wrong in their values, the last only on the skipped tiles
    assert math.isfinite(worst(untransposed)) and math.isfinite(worst(after)) and worst(unwritten) == math.inf


def _exact64(q, k, v, do, mask, scale):
    """The function in float64: lse, di, dk."""
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = p @ v.double()
    di = (o * do.double()).sum(-1)
    ds = p * (do.double() @ v.double().transpose(-1, -2) - di[..., None]) * scale
    return lse, di, ds.transpose(-1, -2) @ q.double()


def truncating_dk(q, k, v, do, mask, scale, lse, di, fresh):
    """dk of one 64-key tile (B = H = 1) with each wgmma's sum (8 exact
    products of TF32 pieces added to its accumulator) rounded toward zero to
    f32. ``fresh``: the kernels' chains (the scores per 32-column slab, its 8
    small terms first, added in f32 and the parts in rank order; dp per slab;
    dk per 32-query half, added in f32); else one chain over all of d_qk for
    the scores and dp and over all the queries for dk."""
    d_qk, d_v = q.shape[-1], v.shape[-1]
    tq = q.shape[2]
    nt = tq // TILE
    pieces = {name: [x.double() for x in split_tf32(t[0, 0])] for name, t in (("q", q), ("k", k), ("v", v), ("do", do))}
    qh, ql = (x.view(nt, TILE, d_qk) for x in pieces["q"])
    doh, dol = (x.view(nt, TILE, d_v) for x in pieces["do"])
    kh, kl = pieces["k"]
    vh, vl = pieces["v"]

    def chain(xh, xl, yh, yl, width, fresh_slabs, parts=1):
        """x . y^T over `width` columns (x [64, w], y [nt, 64, w]) -> [nt, 64, 64] f32."""
        total, acc = None, torch.zeros(nt, TILE, TILE)
        per = width // parts
        for r in range(parts):
            part = None
            for d0 in range(per * r, per * (r + 1), 32):
                if fresh_slabs:
                    acc = torch.zeros(nt, TILE, TILE)
                cols = range(d0, d0 + 32, 8)
                steps = ([(xh, yl, d), (xl, yh, d)] for d in cols)
                steps = [s for pair in steps for s in pair] + [(xh, yh, d) for d in cols]
                if not fresh_slabs:  # hi.lo, lo.hi, hi.hi a k-step
                    steps = [s for d in cols for s in ((xh, yl, d), (xl, yh, d), (xh, yh, d))]
                for a, c, d in steps:
                    acc = _rz(acc.double() + a[:, d:d + 8] @ c[..., d:d + 8].transpose(-1, -2))
                if fresh_slabs:
                    part = acc if part is None else part + acc
            if fresh_slabs:
                total = part if total is None else total + part
        return total if fresh_slabs else acc

    parts = d_qk // WS
    st = chain(kh, kl, qh, ql, d_qk, fresh, parts)  # [nt, keys, queries]
    dpt = chain(vh, vl, doh, dol, d_v, fresh)
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    lse2 = lse[0, 0].float().view(nt, 1, TILE) * torch.tensor(LOG2E, dtype=torch.float32)
    kvalid = mask[0, :TILE].view(1, TILE, 1)
    p = torch.where(kvalid, torch.exp2(st * scale2 - lse2), torch.zeros(()))
    ds = p * (dpt - di[0, 0].float().view(nt, 1, TILE)) * scale
    order = _positions(PI)
    dsh, dsl = (x.double() for x in split_tf32(ds[..., order]))
    qth, qtl = (x[:, order] for x in (qh, ql))  # [nt, 64 queries (permuted), d_qk]
    dk = torch.zeros(TILE, d_qk)
    for t in range(nt):
        for hf in range(2):
            acc = torch.zeros(TILE, d_qk) if fresh else dk
            for j in range(32 * hf, 32 * hf + 32, 8):
                for a, c in ((dsh, qtl), (dsl, qth), (dsh, qth)):
                    acc = _rz(acc.double() + a[t, :, j:j + 8] @ c[t, j:j + 8])
            dk = dk + acc if fresh else acc
    return dk


def test_truncating_sums_need_the_kernels_short_chains():
    """The tensor cores' f32 sums truncate. Modelled so, one chain over all
    of d_qk for the scores and over all 1024 queries for dk misses K1r's
    1e-5; the kernels' chains stay well inside it."""
    q, k, v, do, mask = (_t(x) for x in _np_inputs(0, 1, 1, 1024, 64, 576, 192, [(0, 64)]))
    scale = 192 ** -0.5
    lse, di, exact = _exact64(q, k, v, do, mask, scale)
    with _one_thread():
        errs = {fresh: item_err(truncating_dk(q, k, v, do, mask, scale, lse.float(), di.float(), fresh)[None],
                                exact[0, 0, :64][None])
                for fresh in (False, True)}
    print(f"k1r dk with truncating tensor-core sums: one chain {errs[False]:.2e}, the kernels' chains "
          f"{errs[True]:.2e} (tol {TOL:.0e})")
    assert errs[False] > TOL and errs[True] <= TOL / 4


# ---------------------------------------------------------------------------
# the rule, the source, the library
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d_qk,d_v", [(64, 64), (192, 192), (256, 256), (192, 64), (576, 192)])
@pytest.mark.parametrize("has_bias", [False, True])
def test_bwd_rule_sends_k1r_f32_to_the_3xtf32_kernels(dtype, causal, d_qk, d_v, has_bias):
    """f32, non-causal, a K1r pair without a bias or K1-bwd's (192, 192)
    with or without one -> the 3xTF32 dk/dv and dq; the bf16 K1r backward
    and K1-bwd's other forms stay scalar (VALL-E's forms aside: bf16, d 64,
    no bias, causal or not)."""
    f32_tc = dtype == torch.float32 and not causal and (
        ((d_qk, d_v) in k1.RELPOS_PAIRS and not has_bias) or (d_qk, d_v) == (192, 192))
    valle = dtype == torch.bfloat16 and (d_qk, d_v) == (64, 64) and not has_bias
    want = k1.KERNEL_BWD_TC_F32 if f32_tc else k1.KERNEL_BWD_TC if valle else k1.KERNEL_BWD
    assert k1.dkv_kernel(dtype, causal, d_qk, d_v, has_bias) == want
    assert k1.dq_kernel(dtype, causal, d_qk, d_v, has_bias) == want


def test_source_is_a_cluster_3xtf32_kernel_with_a_plain_c_interface():
    src = (CSRC / f"{k1.KERNEL_BWD_TC_F32}.cu").read_text()
    header = (CSRC / "tc_f32_common.cuh").read_text()
    assert 'extern "C" int jatts_flash_attn_bwd_dkv_tc_f32(' in src
    assert 'extern "C" int jatts_flash_attn_bwd_dq_tc_f32(' in src
    assert '#include "tc_f32_common.cuh"' in src and '#include "tc_common.cuh"' in header
    # 3xTF32 on the .tf32 wgmma, hi and lo by integer rounding (the header's, shared with the forward)
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in header
    assert "(__float_as_uint(x) + 0x1000u) & 0xFFFFE000u" in header
    assert "wgmma_3xtf32(" in src and "split_tf32(" in src
    # a cluster over the widths, the partials exchanged by st.async in distributed shared memory
    assert "cudaLaunchAttributeClusterDimension" in src and "cudaLaunchKernelEx" in src
    assert "%%cluster_ctarank" in src and "mapa.shared::cluster" in src and "barrier.cluster" in src
    assert "st.async.shared::cluster.mbarrier::complete_tx::bytes" in src
    assert "cp.async.bulk.tensor" in (CSRC / "tc_common.cuh").read_text() and "tma_load(" in src
    assert "torch/" not in src and "#include <ATen" not in src
    assert "atomicAdd" not in src and not re.search(r"\b(atom|red)\.(global|shared|add)", src)
    # every form of BWD_TC_F32_FORMS instantiated: K1r's pairs without a bias,
    # K1-bwd's (192, 192) with and without one
    assert "template <int DQK, int DV, bool DQ, bool BIAS>" in src
    for d_qk, d_v, bias in k1.BWD_TC_F32_FORMS:
        assert f"launch<{d_qk}, {d_v}, DQ, {str(bias).lower()}>" in src
    # the bias: each tile staged by cp.async in its natural layout (the
    # header's pair staging), added to the scores before the push; d(ab)
    # stored by the dq score block, zeros on a skipped tile
    assert "stage_bias_tile<BLD>(" in src and "void stage_bias2_f32(" in header and "cp.async" in header
    assert "put_dab2(c0, j, h, 0.f, 0.f)" in src and "put_dab2(c0, j, h, a[4 * j + 2 * h]" in src
    # the shared helpers live once, in the headers
    for helper in ("uint32_t tf32_rna(", "void wgmma_tf32(", "bool make_map_f32(", "void tma_load(", "void mbar_wait(",
                   "void stage_bias2_f32(", "void cp_async8("):
        assert helper not in src, helper
    assert src.count("__global__") == 1  # one template: the dk/dv kernel (DQ false) and the dq kernel


def test_an_edited_f32_header_rebuilds_both_f32_libraries(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    names = (k1.KERNEL_TC_F32, k1.KERNEL_BWD_TC_F32)
    before = {n: build.library_path(n) for n in names}
    assert before == {n: build.library_path(n) for n in names}
    header = csrc / "tc_f32_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] and after[n].parent == before[n].parent for n in names)


def test_study_variants_apply_to_the_source():
    """``bin/study_bwd_tc_f32.py`` times one-change variants on the card:
    each change still finds what it changes."""
    from jatts_torch.bin import study_bwd_tc_f32 as study

    files = study.sources((study.SOURCE, study.HEADER))
    for name, change in study.VARIANTS.items():
        assert (change(files) == files) == (name == "final"), name


def test_cpu_backward_launches_no_kernel():
    q, k, v, do, mask = (_t(x) for x in _np_inputs(5, 2, 2, 9, 9, 192, 64, [(0, 9), (0, 4)]))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, None, mask)
    torch.autograd.grad(out, leaves, do)
    assert (k1.launches_bwd_dkv_tc_f32, k1.launches_bwd_dq_tc_f32, k1.launches_bwd_dkv_relpos) == (0, 0, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_CASES = [
    # (B, H, Tq, Tk), key rows per item
    ((3, 2, 130, 130), [(0, 130), (0, 77), (0, 0)]),
    ((3, 2, 1000, 1000), [(0, 1000), (5, 611), (64, 65)]),  # T ends inside a tile; a masked leading tile
    ((2, 2, 1, 1), [(0, 1), (0, 0)]),
    ((2, 2, 70, 203), [(0, 203), (64, 65)]),
    ((2, 2, 203, 70), [(0, 70), (5, 40)]),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(seed, shape, d_qk, d_v, rows):
    b, h, tq, tk = shape
    return tuple(_t(x).cuda() for x in _np_inputs(seed, b, h, tq, tk, d_qk, d_v, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", CARD_CASES, ids=["T130", "T1000", "T1", "Tq70_Tk203", "Tq203_Tk70"])
@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_tc_f32_bwd_matches_plain_on_card(shape, rows, d_qk, d_v):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask = _card_inputs(6, shape, d_qk, d_v, rows)
    scale = d_v ** -0.5
    _, lse, di, want = _plain(q, k, v, do, mask, scale)
    k1.reset_launches()
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do)
    dq, dab = k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do)
    torch.cuda.synchronize()
    assert (k1.launches_bwd_dkv_tc_f32, k1.launches_bwd_dq_tc_f32) == (1, 1)
    assert (k1.launches_bwd_dkv_relpos, k1.launches_bwd_dq_relpos) == (1, 1) and dab is None
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        err = item_err(got, want[name])
        assert math.isfinite(err) and err <= TOL, (name, err)
    unseen = ~mask[:, None, :, None]
    assert torch.all(dk.masked_select(unseen) == 0) and torch.all(dv.masked_select(unseen) == 0)
    assert torch.all(dq.masked_select(torch.isinf(lse)[..., None]) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_tc_f32_bwd_same_bits_each_run_and_alone_on_card(d_qk, d_v):
    """No atomics: three runs give the same bits, and an item alone gives
    the bits it has inside its batch."""
    _card()
    q, k, v, do, mask = _card_inputs(7, (4, 2, 300, 300), d_qk, d_v, [(0, 300), (0, 120), (5, 77), (0, 0)])
    scale = d_v ** -0.5
    _, lse, di, _ = _plain(q, k, v, do, mask, scale)

    def run(*xs):
        q, k, v, do, mask, lse, di = xs
        return (*k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do),
                k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do)[0])

    xs = (q, k, v, do, mask, lse, di)
    runs = [run(*xs) for _ in range(3)]
    alone = run(*(x[1:2].contiguous() for x in xs))
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other, runs[0]))
    assert all(torch.equal(a, b[1:2]) for a, b in zip(alone, runs[0]))


@pytest.mark.cuda
def test_tc_f32_bwd_c_entries_refuse_other_forms_on_card():
    """bf16, causal, a bias anywhere but at (192, 192), d_qk == d_v other
    than 192, and a d(ab) output without a bias are not these kernels'."""
    _card()
    lib = build.load(k1.KERNEL_BWD_TC_F32)
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.zeros(2, 2, 64, 576, device="cuda")
    ab = torch.zeros(2, 2, 64, 64, device="cuda").data_ptr()
    rows = torch.zeros(2, 2, 64, device="cuda")
    out = torch.empty(2, 2, 64, 576, device="cuda")
    for name in ("dkv", "dq"):
        fn = k1._bwd_kernel_fn(k1.KERNEL_BWD_TC_F32, f"jatts_flash_attn_bwd_{name}_tc_f32")
        assert getattr(lib, f"jatts_flash_attn_bwd_{name}_tc_f32") is not None
        p = [x.data_ptr()] * 3
        for ab_ptr, d_qk, d_v, is_bf16, causal in ((None, 576, 192, 1, 0), (None, 576, 192, 0, 1),
                                                   (ab, 576, 192, 0, 0), (ab, 192, 64, 0, 0), (None, 128, 128, 0, 0),
                                                   (ab, 128, 128, 0, 0), (ab, 192, 192, 1, 0), (ab, 192, 192, 0, 1)):
            assert fn(*p, ab_ptr, None, rows.data_ptr(), rows.data_ptr(), x.data_ptr(), out.data_ptr(),
                      out.data_ptr() if name == "dkv" else None, 2, 2, 64, 64, d_qk, d_v, is_bf16, causal, 0.1,
                      stream) != 0, (name, ab_ptr is not None, d_qk, d_v, is_bf16, causal)
    fn = k1._bwd_kernel_fn(k1.KERNEL_BWD_TC_F32, "jatts_flash_attn_bwd_dq_tc_f32")
    for d_qk, d_v in ((576, 192), (192, 192)):
        assert fn(*[x.data_ptr()] * 3, None, None, rows.data_ptr(), rows.data_ptr(), x.data_ptr(), out.data_ptr(),
                  ab, 2, 2, 64, 64, d_qk, d_v, 0, 0, 0.1, stream) != 0


@pytest.mark.cuda
def test_tc_f32_bwd_autograd_chain_matches_plain_on_card():
    """FlashAttention in f32 at K1r's pair (the 3xTF32 forward's output and
    lse feeding the 3xTF32 dk/dv and dq) against autograd through the plain
    forward, each gradient per item within K1r's f32 tolerance."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask = _card_inputs(8, (3, 2, 200, 200), 576, 192, [(0, 200), (0, 131), (37, 100)])
    scale = 192 ** -0.5
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, None, mask, scale)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k1.launches_tc_f32, k1.launches_bwd_dkv_tc_f32, k1.launches_bwd_dq_tc_f32) == (1, 1, 1)
    ref_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(k1.flash_attention_ref(*ref_leaves, None, mask, scale), ref_leaves, do)
    for g, w in zip(got, want):
        assert item_err(g, w) <= TOL


# K1-bwd's form on the card: (B, H, Tq, Tk), key rows per item
K1_CARD_CASES = [
    # T ends inside a tile; keys 70.. (a masked leading key tile, trailing ones); no valid key
    ((3, 2, 1000, 1000), [(0, 1000), (70, 611), (0, 0)]),
    ((2, 2, 1, 1), [(0, 1), (0, 0)]),
    ((2, 2, 70, 203), [(0, 203), (64, 65)]),
    ((2, 2, 203, 70), [(0, 70), (5, 40)]),
    # an odd Tk: the bias and d(ab) go one float at a time
    ((3, 2, 131, 131), [(0, 131), (0, 77), (0, 0)]),
]


def _k1_card_inputs(seed, shape, rows, with_bias=True):
    b, h, tq, tk = shape
    q, k, v, ab, do, mask = (_t(x).cuda() for x in _np_bias_inputs(seed, b, h, tq, tk, rows))
    return q, k, v, ab if with_bias else None, do, mask


def _k1_zeros(lse, mask, dq, dk, dv, dab):
    """Exact zeros: dq and d(ab) on rows that see no key, dk and dv on keys
    that no row sees, d(ab) on masked keys (skipped key tiles too)."""
    rows_none = torch.isinf(lse)[..., None]
    unseen = ~mask[:, None, :, None]
    ok = bool((dq.masked_select(rows_none) == 0).all())
    ok &= bool((dk.masked_select(unseen) == 0).all()) and bool((dv.masked_select(unseen) == 0).all())
    if dab is not None:
        ok &= bool((dab.masked_select(rows_none) == 0).all())
        ok &= bool((dab.masked_select(unseen.transpose(-1, -2)) == 0).all())
    return ok


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", K1_CARD_CASES, ids=["T1000", "T1", "Tq70_Tk203", "Tq203_Tk70", "T131"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_k1bwd_tc_f32_matches_plain_on_card(shape, rows, with_bias):
    """K1-bwd's (192, 192) on the 3xTF32 kernels (counted besides
    ``launches_bwd_dkv`` / ``_dq``), each output per item within 1e-5 of
    the plain version, the exact zeros of ``_k1_zeros``."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, ab, do, mask = _k1_card_inputs(13, shape, rows, with_bias)
    scale = K1_DIMS[0] ** -0.5
    _, lse, di, want = _plain(q, k, v, do, mask, scale, ab)
    k1.reset_launches()
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, ab, mask, scale, lse, di, do)
    dq, dab = k1.flash_attention_bwd_dq(q, k, v, ab, mask, scale, lse, di, do)
    torch.cuda.synchronize()
    assert (k1.launches_bwd_dkv_tc_f32, k1.launches_bwd_dq_tc_f32, k1.launches_bwd_dkv, k1.launches_bwd_dq) == (
        1, 1, 1, 1)
    assert (dab is None) == (ab is None)
    for name, got in zip(DAB_NAMES, (dq, dk, dv, dab)):
        if got is not None:
            err = item_err(got, want[name])
            assert math.isfinite(err) and err <= TOL, (name, err)
    assert _k1_zeros(lse, mask, dq, dk, dv, dab)


@pytest.mark.cuda
def test_k1bwd_tc_f32_same_bits_each_run_and_alone_on_card():
    """With a bias: three runs give the same bits, an item alone the bits it
    has inside its batch, and d(ab) into a NaN-filled buffer leaves no NaN
    (every element written, zeros on the skipped key tiles)."""
    _card()
    q, k, v, ab, do, mask = _k1_card_inputs(14, (4, 2, 300, 300), [(0, 300), (0, 120), (70, 77), (0, 0)])
    scale = K1_DIMS[0] ** -0.5
    _, lse, di, _ = _plain(q, k, v, do, mask, scale, ab)

    def run(*xs):
        q, k, v, ab, do, mask, lse, di = xs
        return (*k1.flash_attention_bwd_dkv(q, k, v, ab, mask, scale, lse, di, do),
                *k1.flash_attention_bwd_dq(q, k, v, ab, mask, scale, lse, di, do))

    xs = (q, k, v, ab, do, mask, lse, di)
    runs = [run(*xs) for _ in range(3)]
    alone = run(*(x[1:2].contiguous() for x in xs))
    dq, dab = torch.empty_like(q), torch.full_like(ab, float("nan"))
    k1._launch_bwd("dq", q, k, v, ab, mask, scale, lse, di, do, dq, dab, False)
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other, runs[0]))
    assert all(torch.equal(a, b[1:2]) for a, b in zip(alone, runs[0]))
    assert torch.equal(dab, runs[0][3]) and torch.equal(dq, runs[0][2])
    dk_, dv_, dq_, dab_ = runs[0]
    assert _k1_zeros(lse, mask, dq_, dk_, dv_, dab_)


@pytest.mark.cuda
def test_k1bwd_tc_f32_autograd_chain_matches_plain_on_card():
    """FlashAttention in f32 at K1-bwd's (192, 192) with a bias that takes a
    gradient (the 3xTF32 forward's output and lse feeding the 3xTF32 dk/dv
    and dq, which writes d(ab)) against autograd through the plain forward,
    each gradient per item within 1e-5."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, ab, do, mask = _k1_card_inputs(15, (3, 2, 200, 200), [(0, 200), (0, 131), (70, 100)])
    scale = K1_DIMS[0] ** -0.5
    leaves = [x.detach().requires_grad_() for x in (q, k, v, ab)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, mask, scale)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k1.launches_tc_f32, k1.launches_bwd_dkv_tc_f32, k1.launches_bwd_dq_tc_f32) == (1, 1, 1)
    ref_leaves = [x.detach().requires_grad_() for x in (q, k, v, ab)]
    want = torch.autograd.grad(k1.flash_attention_ref(*ref_leaves, mask, scale), ref_leaves, do)
    for name, g, w in zip(DAB_NAMES, got, want):
        assert item_err(g, w) <= TOL, name
