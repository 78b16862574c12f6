"""The fused MAS search (``jatts_torch/csrc/mas_path.cu``) on the CPU.

The kernel runs only on the card. Here a model of its schedule, in numpy,
is held against the JAX package integer for integer: the lanes and slots of
each consumer warp (token 32 s + l in slot s of lane l), the rotating
shuffle and lane 0's read of the slot before, the halo slot a warp
recomputes from the warp before and its refresh every 32 frames, one
ballot word a slot in K2's packed layout, the bits in "shared memory" or,
past the capacity, flushed a stage at a time (at chunk boundaries of the lp
ring) to a device-memory scratch and staged back in whole frames, and the
backtrace's 32-frame windows walked with a one-hot ``m += window & m``.
(The producer warps only copy lp; the model reads it directly.) The
wrapper's CPU route and the source's shape are checked too."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_tpu.ops.mas import mas_path as jax_mas_path  # noqa: E402
from jatts_tpu.ops.mas_pallas import mas_path_pallas  # noqa: E402
from jatts_torch.ops import mas  # noqa: E402
from test_torch_mas import CASES, _case, _log_softmax, _torch_args  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "jatts_torch" / "csrc" / "mas_path.cu"
NEG = np.float32(-1e9)
MAX_SLOTS = 4   # kMaxSlots
EXCHANGE = 32   # kExchange
MIN_STAGE_ROWS = 32  # kMinStageRows
MASK32 = 0xFFFFFFFF


def layout(n_words):
    """(warps, slots a warp): one warp up to 4 slots, else the fewest warps
    of at most 4 slots, the slots spread evenly."""
    n_warps = -(-n_words // MAX_SLOTS)
    return n_warps, -(-n_words // n_warps)


def _brev32(x):
    return int(f"{x:032b}"[::-1], 2)


def _popc32(x):
    return bin(x & MASK32).count("1")


def model_utterance(lp, tl, fl, smem_bits_bytes=mas.SMEM_BITS_BYTES, full_bits=False):
    """One block of the kernel. lp: f32 [T_feats, T_text]. Returns (path
    int32 [T_feats], the words the forward wrote to device memory or None,
    the route)."""
    t_feats, t_text = lp.shape
    n_words = (t_text + 31) // 32
    n_warps, r_slots = layout(n_words)
    tl = min(int(tl), t_text)
    last_tok = tl - 1
    s = min(int(fl) - 1, t_feats - 1)
    in_smem = t_feats * n_words * 4 <= smem_bits_bytes
    # rows of bits in shared memory: all, or a stage of at least a chunk
    smem_rows = t_feats if in_smem else min(max(smem_bits_bytes // (4 * n_words), MIN_STAGE_ROWS), t_feats - 1)
    group = 4 if n_warps > 1 else 32  # frames a chunk of the lp ring
    gbits = np.zeros((t_feats, n_words), np.uint32) if (full_bits or not in_smem) else None
    sbits = np.zeros((smem_rows, n_words), np.uint32)
    seg0 = 0  # the frame of sbits' row 0

    def flush(j_end):
        nonlocal seg0
        gbits[seg0:j_end] = sbits[: j_end - seg0]
        seg0 = j_end
    path = np.zeros(t_feats, np.int64)
    path[max(s, 0):] = last_tok

    # forward: q[w, r, l] is token 32 (w R + r) + l; qh[w, l] the halo slot
    lane = np.arange(32)
    slot = np.arange(n_warps)[:, None] * r_slots + np.arange(r_slots)[None, :]   # [W, R]
    tok = 32 * slot[:, :, None] + lane                                           # [W, R, 32]
    tok_h = 32 * (slot[:, 0] - 1)[:, None] + lane                                # [W, 32]
    in_range = tok < t_text
    valid, valid_h = tok < tl, (tok_h >= 0) & (tok_h < tl)
    halo = n_warps > 1

    def lp_at(j, toks, ok):
        return np.where(ok, lp[j][np.clip(toks, 0, t_text - 1)], NEG).astype(np.float32)

    q = np.where((tok == 0) & valid, lp[0, 0], NEG).astype(np.float32)
    qh = np.where((tok_h == 0) & valid_h, lp[0, 0], NEG).astype(np.float32)
    f_end = t_feats if full_bits else max(s + 1, 1)
    for j in range(1, f_end):
        # the kernel flushes a full stage before a group of frames
        j0 = 1 + (j - 1) // group * group
        if j == j0 and gbits is not None and not in_smem and j0 + min(group, f_end - j0) - seg0 > smem_rows:
            flush(j0)
        t = np.roll(q, 1, axis=-1)    # __shfl_sync(q, (lane + 31) & 31)
        th = np.roll(qh, 1, axis=-1)
        first = np.empty((n_warps, r_slots), np.float32)  # lane 0: lane 31 of the slot before
        first[:, 1:] = t[:, :-1, 0]
        first[:, 0] = np.where(np.arange(n_warps) > 0, th[:, 0], NEG) if halo else NEG
        left = t.copy()
        left[:, :, 0] = first
        decide = in_range & (left >= q)
        words = (decide.astype(np.uint64) << lane.astype(np.uint64)).sum(-1).astype(np.uint32)  # ballots
        q = (np.maximum(left, q) + lp_at(j, tok, valid)).astype(np.float32)
        if halo:
            lh = th.copy()
            lh[:, 0] = NEG  # lane 0 of the halo goes stale
            qh = (np.maximum(lh, qh) + lp_at(j, tok_h, valid_h)).astype(np.float32)
        keep = slot < n_words
        sbits[j - seg0, slot[keep]] = words[keep]
        if halo and j % EXCHANGE == 0:
            qh[1:] = q[:-1, r_slots - 1]  # the owner's last slot, exact at frame j

    if gbits is not None:
        flush(f_end)  # bits_out, or the last stage of the scratch

    # backtrace
    a0 = max(last_tok, 0)
    f = s
    while f >= 1:
        if in_smem:
            r0, rows = 1, sbits
            base = 0
        else:
            r0 = max(1, f + 1 - smem_rows)
            rows = np.zeros((smem_rows, n_words), np.uint32)
            rows[: f + 1 - r0] = gbits[r0: f + 1]  # the staged frames
            base = r0
        g = f
        while g >= r0:
            n = min(32, g - r0 + 1)
            rev = [0] * 32
            for k in range(n):
                row = rows[g - k - base]
                w = a0 >> 5
                hi, lo = int(row[w]), int(row[w - 1]) if w > 0 else 0
                window = (((hi << 32) | lo) >> min((a0 & 31) + 1, 32)) & MASK32  # __funnelshift_rc
                rev[k] = _brev32(window)
                if a0 < 32:
                    rev[k] &= ~(1 << a0) & MASK32
            m, mine = 1, [0] * 32
            for k in range(32):
                m = (m + (rev[k] & m)) & MASK32
                mine[k] = m
            for k in range(n):
                path[g - 1 - k] = a0 - _popc32(mine[k] - 1)
            a0 -= _popc32(m - 1)
            g -= n
        f = r0 - 1
    route = "smem" if in_smem else "global"
    return path.astype(np.int32), gbits, route


def model(lp, tl, fl, **kw):
    """The kernel's model over a batch: (path [B, T_feats], bits or None,
    the route)."""
    outs = [model_utterance(lp[i], tl[i], fl[i], **kw) for i in range(lp.shape[0])]
    path = np.stack([o[0] for o in outs])
    bits = None if outs[0][1] is None else np.stack([o[1] for o in outs]).view(np.int32)
    return path, bits, outs[0][2]


def _jax_paths(lp, tl, fl):
    scan = np.asarray(jax_mas_path(jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl)))
    pallas = np.asarray(mas_path_pallas(jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl), interpret=True))
    return scan, pallas


def _wide(t_feats=100, t_text=300, b=3, seed=11):
    """More than 4 words a frame: three warps, each with a halo, and more
    than 64 frames, so the halos are refreshed twice."""
    rng = np.random.default_rng(seed)
    lp = _log_softmax(rng.normal(size=(b, t_feats, t_text)).astype(np.float32))
    return lp, np.array([300, 161, 129])[:b], np.array([100, 97, 64])[:b]


MODEL_CASES = CASES + ["wide"]


def _model_case(name):
    return _wide() if name == "wide" else _case(name)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_model_path_equals_jax_scan_and_pallas(name):
    lp, tl, fl = _model_case(name)
    scan, pallas = _jax_paths(lp, tl, fl)
    path, bits, route = model(lp, tl, fl)
    assert route == "smem" and bits is None
    if name == "wide":
        assert layout((lp.shape[2] + 31) // 32) == (3, 4)
    np.testing.assert_array_equal(path, scan)
    if name != "edges":  # a row with no token: the JAX pair disagrees there (test_torch_mas.py)
        np.testing.assert_array_equal(path, pallas)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_model_past_the_shared_capacity_equals_jax(name):
    """The bits in device memory, staged back a few frames at a time: the
    capacity shrunk to 3 frames' words (not the data grown)."""
    lp, tl, fl = _model_case(name)
    n_words = (lp.shape[2] + 31) // 32
    path, bits, route = model(lp, tl, fl, smem_bits_bytes=3 * 4 * n_words)
    assert route == ("smem" if lp.shape[1] <= 3 else "global")
    np.testing.assert_array_equal(path, _jax_paths(lp, tl, fl)[0])


@pytest.mark.parametrize("name", MODEL_CASES)
@pytest.mark.parametrize("capacity", ["default", "shrunk"])
def test_model_bits_out_equals_packed_plain_decisions(name, capacity):
    lp, tl, fl = _model_case(name)
    kw = {} if capacity == "default" else {"smem_bits_bytes": 2 * 4 * ((lp.shape[2] + 31) // 32)}
    path, bits, _ = model(lp, tl, fl, full_bits=True, **kw)
    lp_t, tl_t, fl_t = _torch_args(lp, tl, fl)
    want = mas.pack_bits(mas.mas_decisions_ref(lp_t, tl_t)).numpy()
    np.testing.assert_array_equal(bits, want)  # bits past T_text and frame 0 zero too
    np.testing.assert_array_equal(path, mas.mas_path_ref(lp_t, tl_t, fl_t).numpy())


def test_model_no_token_but_frames_follows_the_scan_version():
    rng = np.random.default_rng(7)
    lp = _log_softmax(rng.normal(size=(1, 12, 8)).astype(np.float32))
    tl, fl = np.array([0]), np.array([9])
    path, _, _ = model(lp, tl, fl)
    np.testing.assert_array_equal(path, _jax_paths(lp, tl, fl)[0])
    assert path[0].tolist() == [0] * 8 + [-1] * 4


def test_model_walk_crosses_word_and_chunk_edges():
    """A path that falls by one token a frame for 70 frames crosses two
    32-frame windows, word edges and the token-0 clamp, with delta = 32 in
    a window (the one-hot's overflow)."""
    t_feats, t_text = 90, 70
    lp = np.full((1, t_feats, t_text), -5.0, np.float32)
    for j in range(t_feats):
        lp[0, j, min(j, t_text - 1)] = 0.0  # the diagonal
    tl, fl = np.array([t_text]), np.array([t_feats])
    path, _, _ = model(lp, tl, fl)
    np.testing.assert_array_equal(path, _jax_paths(lp, tl, fl)[0])
    assert path[0, :70].tolist() == list(range(70))


def test_layout_covers_every_word():
    for n_words in range(1, 33):
        n_warps, r = layout(n_words)
        assert n_warps * r >= n_words and (n_warps - 1) * r < n_words and r <= MAX_SLOTS
        assert n_warps == 1 or r >= 3


def test_source_shape_and_constants():
    """One kernel template and one plain-C entry point, no torch headers,
    the TPU kernels named, and the constants the model mirrors."""
    src = SOURCE.read_text()
    assert src.count("__global__") == 1 and src.count('extern "C"') == 1
    assert 'extern "C" int jatts_mas_path(' in src
    assert "torch/" not in src and "#include <ATen" not in src
    assert "mas_pallas.py" in src and ":139" in src and ":161" in src
    assert re.search(r"kMaxSlots = (\d+);", src).group(1) == str(MAX_SLOTS)
    assert re.search(r"kExchange = (\d+);", src).group(1) == str(EXCHANGE)
    assert "-1e9f" in src and "__funnelshift_rc" in src and "__brev" in src
    # the flags stay IEEE: log-probs near 0 can be subnormal
    from jatts_torch.ops import build

    assert not {"--use_fast_math", "-ftz=true"} & set(build.NVCC_FLAGS)
    # the wrapper's capacity fits a block's dynamic shared memory beside the
    # largest mbarriers, lp ring and exchange: one consumer warp, or 8 with halos
    frames = [int(x) for x in re.search(r"kFrames = HALO \? (\d+) : (\d+);", src).groups()]
    chunks = [int(x) for x in re.search(r"kChunks = HALO \? (\d+) : (\d+);", src).groups()]
    halo_ring = 16 * chunks[0] + chunks[0] * frames[0] * 256 * 16 + 2 * 256 * 4
    one_ring = 16 * chunks[1] + chunks[1] * frames[1] * 32 * 16
    assert mas.SMEM_BITS_BYTES <= mas.MAX_SMEM_BITS_BYTES == 232448 - max(halo_ring, one_ring)


def test_build_command_targets_hopper(monkeypatch):
    from jatts_torch.ops import build

    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    out = build.library_path(mas.KERNEL_PATH)
    cmd = build.nvcc_command(mas.KERNEL_PATH, out)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1] == str(SOURCE) and out.parent == ROOT / "build" / "kernels"


@pytest.mark.parametrize("name", ["pallas_test_small", "edges", "one_frame"])
def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing(name):
    lp_t, tl_t, fl_t = _torch_args(*_case(name))
    mas.reset_launches()
    path = mas.mas_path_fused(lp_t, tl_t, fl_t)
    assert torch.equal(path, mas.mas_path_ref(lp_t, tl_t, fl_t))
    path2, bits = mas.mas_path_fused(lp_t, tl_t, fl_t, return_bits=True)
    assert torch.equal(path2, path)
    assert torch.equal(bits, mas.pack_bits(mas.mas_decisions_ref(lp_t, tl_t)))
    assert mas.path_launches == 0 and mas.path_routes == {"smem": 0, "global": 0}
    # the backends: auto takes the plain version on the CPU, cuda refuses
    assert torch.equal(mas.select_mas("auto")(lp_t, tl_t, fl_t), path)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mas.select_mas("cuda")(lp_t, tl_t, fl_t)


@pytest.mark.parametrize("bad", ["rank", "text_lengths", "feats_lengths", "devices"])
def test_wrapper_rejects_bad_shapes(bad):
    lp, tl, fl = _torch_args(*_case("pallas_test_small"))
    with pytest.raises(ValueError):
        if bad == "rank":
            mas.mas_path_fused(lp[0], tl, fl)
        elif bad == "text_lengths":
            mas.mas_path_fused(lp, tl[:1], fl)
        elif bad == "feats_lengths":
            mas.mas_path_fused(lp, tl, fl.float())
        else:
            mas.mas_path_fused(lp.to("meta"), tl, fl)


def test_reset_launches_clears_the_fused_counters():
    mas.path_launches = 3
    mas.path_routes["global"] = 2
    mas.reset_launches()
    assert mas.path_launches == 0 and mas.path_routes == {"smem": 0, "global": 0}
