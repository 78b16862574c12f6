"""K1-bwd's bf16 backward with a bias on the tensor cores
(``csrc/flash_attn_bwd_tc_bias.cu``): the dk/dv and dq/d(ab) kernels of
FastSpeech2's bf16-compute JSUT training under ``attn_backend: flash`` (the
legacy rel-pos call, ``matrix_bd`` as the bias, d_qk = d_v = 192).

On the CPU: a model of the kernels' arithmetic — 64-row tiles, the scores and
dp in f32, the bias added to the scores in f32 before the scale (the dk/dv
kernel, keys x queries, reading the query-major bias tile transposed), p and
ds formed in f32 and rounded to bf16 only as the A operands of dV += P^T.dO,
dK += dS^T.Q and dQ += dS.K (the dk/dv kernel's warpgroup B forming ds from
warpgroup A's f32 p of the same tile), d(ab) the f32 ds rounded once to
bf16, written on every element (zeros on a key tile the dq kernel skips),
every output rounded once — held per batch item within ``chip_smoke.py``'s
K1-bwd bf16 tolerance (1e-2 of max(1, max|plain|) of the item,
``chip_smoke.item_err``) against ``flash_attention_bwd_ref`` and against the
JAX package's reference (``jax.vjp`` of the installed ``mha_reference`` with
``ab``), with ragged key masks, an item whose first key tile has no valid
key, an item with no valid key and Tq != Tk both ways. Exact zeros: d(ab) on
masked keys and on rows that see no key, dk and dv on keys that no row sees.
Mistakes the check must catch by more than 10x: dk/dv reading the bias tile
untransposed, the bias dropped, d(ab) left unwritten on a skipped key tile
(the empty buffer's NaN), and warpgroup B forming ds from the previous
tile's p. Then the dispatch rule, the source (a plain C interface, bf16
``wgmma``, no atomics, ``cudaGetLastError`` returned),
``bin/study_bwd_tc_bias.py``'s variants and a CPU backward that launches no
kernel. The ``cuda`` tests are in ``tests/test_torch_flash_tc_bias_bwd_card.py``."""

import importlib.util
import math
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
D = 192
LOG2E = 1.4426950408889634

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL = chip_smoke.TOL_BWD["bf16"]  # relative to max(1, max|plain|) of each batch item
item_err = chip_smoke.item_err
NAMES = ("dq", "dk", "dv", "dab")
# (B, H, Tq, Tk), key rows per item (first valid key, count): every key,
# ragged, keys 70.. (the first key tile has no valid key), no valid key;
# then Tq != Tk both ways, each ending inside a tile
CASES = [
    ((4, 2, 200, 200), [(0, 200), (0, 131), (70, 100), (0, 0)]),
    ((3, 2, 70, 203), [(0, 203), (70, 100), (0, 0)]),
    ((3, 2, 203, 70), [(0, 70), (5, 40), (0, 0)]),
]


@pytest.fixture
def one_thread():
    """Torch's intra-op threads capped at 1 for the test (restored after):
    the test's many small ops gain nothing from a thread pool, and under the
    suite's parallel workers one pool a worker costs them most of their
    time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# a CPU model of the kernels' arithmetic
# ---------------------------------------------------------------------------


def _pad(x, n, dim, value=0.0):
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, n - x.shape[dim]]
    return torch.nn.functional.pad(x, pad, value=value)


def _a(x):
    """An f32 fragment rounded to bf16 as a wgmma A operand."""
    return x.to(torch.bfloat16).float()


def _exp_arg(s, b, scale2, lse2):
    """(s + b) in f32, then fma(., scale2, -lse2) rounded once to f32."""
    x = s + b
    return (x.double() * scale2.double() - lse2.double()).float()


def bwd_model(q, k, v, ab, key_mask, scale, lse, di, do, untransposed=False, no_bias=False, dab_unwritten=False,
              stale_p=False):
    """flash_attn_bwd_tc_bias.cu's arithmetic on bf16 CPU tensors -> dict of
    dq, dk, dv, dab (bf16). Rows are padded to 64-row tiles (keys past Tk
    unseen, queries past Tq with lse = +inf, di = 0 and a zero bias).
    Mistakes: ``untransposed`` makes dk/dv add the bias tile as it lies
    (query-major) to its keys x queries scores; ``no_bias`` drops the bias;
    ``dab_unwritten`` leaves d(ab) as the empty buffer (NaN) on the key
    tiles that dq skips; ``stale_p`` makes dk/dv's warpgroup B form ds from
    the p of the tile before (zeros at the first)."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    abf = torch.zeros_like(ab, dtype=torch.float32) if no_bias else ab.float()
    b, h, tq, d = q.shape
    tk = k.shape[2]
    tq_p, tk_p = -(-tq // TILE) * TILE, -(-tk // TILE) * TILE
    n_qt, n_kt = tq_p // TILE, tk_p // TILE
    qp, dop = _pad(qf, tq_p, 2), _pad(dof, tq_p, 2)
    kp, vp = _pad(kf, tk_p, 2), _pad(vf, tk_p, 2)
    abp = _pad(_pad(abf, tq_p, 2), tk_p, 3)
    maskp = _pad(key_mask, tk_p, 1, value=False)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    scale2 = f32(scale) * f32(LOG2E)
    lse2 = _pad(lse.float(), tq_p, 2, value=float("inf")) * f32(LOG2E)
    dip = _pad(di.float(), tq_p, 2)

    # dk/dv: a block per key tile (the key tiles a batch dimension), the loop over query tiles
    K, V = kp.view(b, h, n_kt, TILE, d), vp.view(b, h, n_kt, TILE, d)
    kvalid = maskp.view(b, 1, n_kt, TILE, 1)
    dK, dV = torch.zeros_like(K), torch.zeros_like(V)
    prev = torch.zeros(b, h, n_kt, TILE, TILE)
    for t in range(n_qt):
        rows = slice(TILE * t, TILE * (t + 1))
        Q, dO = qp[:, :, None, rows], dop[:, :, None, rows]
        tile = abp[:, :, rows].view(b, h, TILE, n_kt, TILE).permute(0, 1, 3, 2, 4)  # [.., key tile, query, key]
        bias = tile if untransposed else tile.transpose(-1, -2)  # keys x queries
        st = K @ Q.transpose(-1, -2)
        p = torch.where(kvalid, torch.exp2(_exp_arg(st, bias, scale2, lse2[:, :, None, None, rows])), torch.zeros(()))
        dV += _a(p) @ dO
        dpt = V @ dO.transpose(-1, -2)
        ds = (prev if stale_p else p) * (dpt - dip[:, :, None, None, rows]) * scale
        dK += _a(ds) @ Q
        prev = p

    # dq and d(ab): a block per query tile, the loop over key tiles; a key
    # tile without a valid key (per item) is skipped and its d(ab) written 0
    Qr, dOr = qp.view(b, h, n_qt, TILE, d), dop.view(b, h, n_qt, TILE, d)
    rl2, rdi = lse2.view(b, h, n_qt, TILE, 1), dip.view(b, h, n_qt, TILE, 1)
    dQ = torch.zeros_like(Qr)
    dab = torch.full((b, h, tq_p, tk_p), float("nan"))
    for t in range(n_kt):
        keys = slice(TILE * t, TILE * (t + 1))
        Kt, Vt = kp[:, :, None, keys], vp[:, :, None, keys]
        valid = maskp[:, None, None, None, keys]
        bias = abp[:, :, :, keys].view(b, h, n_qt, TILE, TILE)
        s = Qr @ Kt.transpose(-1, -2)
        p = torch.where(valid, torch.exp2(_exp_arg(s, bias, scale2, rl2)), torch.zeros(()))
        ds = p * (dOr @ Vt.transpose(-1, -2) - rdi) * scale
        dQ += _a(ds) @ Kt
        skipped = ~maskp[:, keys].any(-1)[:, None, None, None, None]
        written = torch.where(skipped, torch.full((), float("nan") if dab_unwritten else 0.0), _a(ds))
        dab[:, :, :, keys] = written.view(b, h, tq_p, TILE)
    return {
        "dq": dQ.view(b, h, tq_p, d)[:, :, :tq].to(torch.bfloat16),
        "dk": dK.view(b, h, tk_p, d)[:, :, :tk].to(torch.bfloat16),
        "dv": dV.view(b, h, tk_p, d)[:, :, :tk].to(torch.bfloat16),
        "dab": dab[:, :, :tq, :tk].to(torch.bfloat16),
    }


def _np_inputs(seed, shape, rows):
    """q, k, v, do ~ N(0, 1) and a dense bias at the scale of q.k^T (N(0, 1)
    x sqrt(d), as ``chip_smoke.py`` makes it), made with numpy and rounded to
    bf16; do zero on padded query rows where Tq == Tk (the conformer discards
    them, and the JAX reference's padded rows attend padded keys) and on an
    item with no valid key (the JAX reference's rows there attend every key)
    -> bf16-valued f32 arrays and the mask."""
    b, h, tq, tk = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, tq, D)).astype(np.float32)
    k = rng.normal(size=(b, h, tk, D)).astype(np.float32)
    v = rng.normal(size=(b, h, tk, D)).astype(np.float32)
    do = rng.normal(size=(b, h, tq, D)).astype(np.float32)
    ab = (rng.normal(size=(b, h, tq, tk)) * math.sqrt(D)).astype(np.float32)
    pos = np.arange(tk)
    mask = np.stack([(pos >= a) & (pos < a + n) for a, n in rows])
    if tq == tk:
        do = do * mask[:, None, :, None]
    do = do * mask.any(-1)[:, None, None, None]
    rnd = [torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v, do, ab)]
    return (*rnd, mask)


def _t(x):
    t = torch.from_numpy(x)
    return t if t.dtype == torch.bool else t.to(torch.bfloat16)


def _plain(q, k, v, ab, do, mask, scale):
    """The plain forward's lse, di as the wrapper forms it, and the plain
    backward, in bf16."""
    o, lse = k1.flash_attention_ref(q, k, v, ab, mask, scale, return_lse=True)
    di = (o.float() * do.float()).sum(-1)
    return lse, di, dict(zip(NAMES, k1.flash_attention_bwd_ref(q, k, v, ab, mask, scale, o, lse, do)))


def _jax_bwd(q, k, v, ab, mask, do, scale):
    """``jax.vjp`` of the installed ``mha_reference`` with a bias, segment
    ids 1 on every query and on the valid keys, 0 on the masked ones (a
    query sees its item's valid keys); q and ab pre-scaled, as the
    reference's VJP takes sm_scale = 1 only ((q.k^T + ab) * scale =
    (q * scale).k^T + ab * scale) -> [dq, dk, dv, dab] in f32."""
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


@pytest.mark.parametrize("shape,rows", CASES, ids=["T200", "Tq70_Tk203", "Tq203_Tk70"])
def test_cpu_model_matches_the_plain_version_and_the_jax_reference(shape, rows, one_thread):
    """Per item within 1e-2 of ``flash_attention_bwd_ref`` and of the VJP of
    the installed Pallas kernel's reference on the same bf16 values; d(ab)
    written on every element, exactly 0 on masked keys (the skipped leading
    tile too) and on rows that see no key; dk and dv exactly 0 on keys that
    no row sees; an item without a valid key all 0."""
    q, k, v, do, ab, mask = _np_inputs(1, shape, rows)
    scale = D ** -0.5
    jax_want = dict(zip(NAMES, _jax_bwd(q, k, v, ab, mask, do, scale)))
    tq, tk, tv, tdo, tab, tmask = (_t(x) for x in (q, k, v, do, ab, mask))
    lse, di, want = _plain(tq, tk, tv, tab, tdo, tmask, scale)
    got = bwd_model(tq, tk, tv, tab, tmask, scale, lse, di, tdo)
    for name in NAMES:
        err, err_jax = _finite_err(got[name], want[name]), _finite_err(got[name], jax_want[name])
        assert 0 < err <= TOL and err_jax <= TOL, (name, err, err_jax)
    unseen = ~tmask[:, None, None, :]
    assert torch.all(got["dab"].masked_select(unseen) == 0)
    assert torch.all(got["dab"].masked_select(torch.isinf(lse)[..., None]) == 0)
    assert torch.all(got["dq"].masked_select(torch.isinf(lse)[..., None]) == 0)
    assert torch.all(got["dk"].masked_select(unseen.transpose(-1, -2)) == 0)
    assert torch.all(got["dv"].masked_select(unseen.transpose(-1, -2)) == 0)
    assert all(torch.all(got[n][-1] == 0) for n in NAMES)


def test_mistakes_fail_the_check_by_more_than_10x(one_thread):
    """Held as the card holds the kernels (per item, 1e-2; a NaN fails): the
    dk/dv kernel reading the bias tile untransposed, the bias dropped, d(ab)
    left unwritten (the empty buffer's NaN) on a key tile that dq skips, and
    warpgroup B forming ds from the previous tile's p, each fail by more
    than 10x."""
    shape, rows = CASES[0]
    q, k, v, do, ab, mask = (_t(x) for x in _np_inputs(2, shape, rows))
    scale = D ** -0.5
    lse, di, want = _plain(q, k, v, ab, do, mask, scale)

    def worst(got):
        return max(_finite_err(got[n], want[n]) for n in NAMES)

    assert worst(bwd_model(q, k, v, ab, mask, scale, lse, di, do)) <= TOL
    mistakes = {name: bwd_model(q, k, v, ab, mask, scale, lse, di, do, **{name: True})
                for name in ("untransposed", "no_bias", "dab_unwritten", "stale_p")}
    print("k1-bwd bf16 bias mistakes, worst item's error: "
          + ", ".join(f"{n} {worst(g):.2e}" for n, g in mistakes.items()) + f" (tol {TOL:.0e})")
    for name, got in mistakes.items():
        assert worst(got) > 10 * TOL, name
    # the unwritten d(ab) is wrong only on the skipped tiles, the others in their values
    assert worst(mistakes["dab_unwritten"]) == math.inf
    assert all(math.isfinite(worst(mistakes[n])) for n in ("untransposed", "no_bias", "stale_p"))


# ---------------------------------------------------------------------------
# the rule, the source, the study
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d_qk,d_v", [(64, 64), (128, 128), (192, 192), (256, 256), (192, 64), (576, 192)])
@pytest.mark.parametrize("has_bias", [False, True])
def test_bwd_rule_sends_the_bf16_bias_form_to_the_tensor_cores(dtype, causal, d_qk, d_v, has_bias):
    """bf16, non-causal, (192, 192), a bias -> the new dk/dv and dq; no other
    form goes there (the causal bf16 d 192 with a bias stays scalar)."""
    want = dtype == torch.bfloat16 and not causal and (d_qk, d_v) == (D, D) and has_bias
    for rule in (k1.dkv_kernel, k1.dq_kernel):
        assert (rule(dtype, causal, d_qk, d_v, has_bias) == k1.KERNEL_BWD_TC_BIAS) == want
    if dtype == torch.bfloat16 and causal and (d_qk, d_v) == (D, D) and has_bias:
        assert k1.dkv_kernel(dtype, causal, d_qk, d_v, has_bias) == k1.KERNEL_BWD


def test_source_is_a_bf16_tensor_core_kernel_pair_with_a_plain_c_interface():
    src = (CSRC / f"{k1.KERNEL_BWD_TC_BIAS}.cu").read_text()
    common = (CSRC / "tc_common.cuh").read_text()
    assert k1._BWD_SUFFIX[k1.KERNEL_BWD_TC_BIAS] == "_tc_bias"
    # the argument list of jatts_flash_attn_bwd_{dkv,dq}: 10 pointers, 8 ints, the scale, the stream
    for name in ("dkv", "dq"):
        sig = re.search(rf'extern "C" int jatts_flash_attn_bwd_{name}_tc_bias\((.*?)\)', src, re.S).group(1)
        args = [a.strip() for a in sig.split(",")]
        assert len(args) == 20 and sum("void*" in a for a in args) == 11 and args[-2] == "float sm_scale", name
    # every launch's error returned; every other form refused
    assert src.count("return cudaGetLastError();") == 1 and "cudaErrorInvalidValue" in src
    assert "ab == nullptr || Dqk != D || Dv != D" in src and "!is_bf16 || causal" in src
    # bf16 wgmma (the header's) from shared memory and, for the output products, A from registers
    assert '#include "tc_common.cuh"' in src and "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in common
    assert "wgmma_ss(acc, " in src and "wgmma_rs(o[c], da[kk], " in src and "wgmma_rs(o[c], pa[kk], " in src
    assert "tf32" not in src and "tma_load(" in src
    # two kernels: dq with one consumer warpgroup, dk/dv with two and a p handoff under mbarriers
    assert src.count("__global__") == 2 and "constexpr int NT_DKV = 288;" in src
    assert "mbar_wait(&ctl.p_full[pb]" in src and "mbar_arrive(&ctl.p_empty[pb]);" in src
    # the bias a TMA box of the stage where a map can stride its rows (every
    # training call), else staged by the producer's cp.async windows, counted
    # by the stage's barrier
    assert "const bool tma_bias = Tk % 8 == 0" in src and "make_map(&m[4], ab, BH, Tq, Tk)" in src
    assert "tma_load(st + BIAS_OFF, &map_ab, &ctl.full[slot], c0, r0, bh);" in src  # dq: keys c0, queries r0
    assert "tma_load(st + BIAS_OFF, &map_ab, &ctl.full[slot], r0, c0, bh);" in src  # dk/dv: keys r0, queries c0
    assert "cp.async.mbarrier.arrive.noinc" in src and "stage_bias(" in src
    # no atomics, no cluster, no library
    assert "atomicAdd" not in src and not re.search(r"\b(atom|red)\.(global|shared|add)", src)
    assert "cudaLaunchKernelEx" not in src and "torch/" not in src and "#include <ATen" not in src
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()


def _tile_at(r, k):
    """``tile_at`` of the source: the byte of (row r, key k) in a stage's
    128-byte-swizzled TMA bias tile."""
    return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + 2 * (k & 7)


def test_tma_bias_tile_reads_follow_the_swizzle_without_bank_conflicts():
    """The consumers read the TMA bias tile where TMA's 128-byte swizzle put
    each key (16-byte chunk c of row r at chunk c ^ (r % 8)), each element
    once; a warp's 2-byte reads, along a row in dq and down a column in dk/dv
    (queries x keys read transposed), meet no bank conflict (two lanes on
    one bank read one 4-byte word); without the swizzle dq's would be 8-way
    and dk/dv's 4-way."""
    src = (CSRC / f"{k1.KERNEL_BWD_TC_BIAS}.cu").read_text()
    assert "return (uint32_t)(r * 128 + ((((k >> 3) ^ r) & 7) << 4) + 2 * (k & 7));" in src
    assert "tile_at(quad_row + 8 * h, 8 * j + cc + e)" in src
    assert "tb[h][e] = tile_at(cc + e, quad_row + 8 * h)" in src and "TMA_BIAS ? tb[h][e] + 1024 * j" in src
    assert all(_tile_at(8 * j + r, k) == _tile_at(r, k) + 1024 * j for j in range(8) for r in range(8)
               for k in range(64))
    swizzled = {r * 128 + (((k >> 3) ^ (r % 8)) << 4) + 2 * (k % 8): (r, k) for r in range(64) for k in range(64)}
    assert {_tile_at(r, k): (r, k) for r in range(64) for k in range(64)} == swizzled

    def ways(addrs):
        words = {}
        for a in addrs:
            words.setdefault((a // 4) % 32, set()).add(a // 4)
        return max(len(w) for w in words.values())

    for at, want in ((_tile_at, 1), (lambda r, k: r * 128 + 2 * k, None)):
        worst = {"dq": 0, "dkv": 0}
        for warp in range(4):
            for j in range(8):
                for h in range(2):
                    for e in range(2):
                        lanes = [(16 * warp + lane // 4, 2 * (lane % 4)) for lane in range(32)]
                        # dq: row quad_row + 8h, key 8j + cc + e; dk/dv: row (query) 8j + cc + e, key quad_row + 8h
                        worst["dq"] = max(worst["dq"], ways(at(qr + 8 * h, 8 * j + cc + e) for qr, cc in lanes))
                        worst["dkv"] = max(worst["dkv"], ways(at(8 * j + cc + e, qr + 8 * h) for qr, cc in lanes))
        if want is None:
            assert worst == {"dq": 8, "dkv": 4}
        else:
            assert worst == {"dq": want, "dkv": want}


def test_the_scalar_kernels_stay_beside():
    """The scalar bf16 K1-bwd with a bias serves no route at d 192 but is
    still built, for the timings beside the new kernels
    (``_lib=KERNEL_BWD``)."""
    scalar = (CSRC / f"{k1.KERNEL_BWD}.cu").read_text()
    assert 'extern "C" int jatts_flash_attn_bwd_dkv(' in scalar and 'extern "C" int jatts_flash_attn_bwd_dq(' in scalar
    assert k1.dkv_kernel(torch.bfloat16, True, D, D, True) == k1.KERNEL_BWD


def test_study_variants_apply_to_the_source():
    """``bin/study_bwd_tc_bias.py`` times one-change variants on the card:
    each change still finds what it changes."""
    from jatts_torch.bin import study_bwd_tc_bias as study

    files = study.sources((study.SOURCE,))
    for name, change in study.VARIANTS.items():
        assert (change(files) == files) == (name == "final"), name
    assert "#define BIAS_STAMPS" in study.VARIANTS["stamps"](files)[study.SOURCE]
    recompute = study.VARIANTS["recompute"](files)[study.SOURCE]
    assert "p_full" not in recompute.split("---- B: dP^T")[1].split("epilogue")[0]


def test_cpu_backward_launches_no_kernel(one_thread):
    q, k, v, do, ab, mask = (_t(x) for x in _np_inputs(5, (2, 2, 9, 9), [(0, 9), (0, 4)]))
    leaves = [x.requires_grad_() for x in (q, k, v, ab)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, mask)
    grads = torch.autograd.grad(out, leaves, do)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in grads)
    assert (k1.launches_bwd_dkv_tc_bias, k1.launches_bwd_dq_tc_bias, k1.launches_bwd_dkv, k1.launches_bwd_dq) == (
        0, 0, 0, 0)
