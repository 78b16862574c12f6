"""Where the MAS search's time goes on the card: the fused kernel
(``csrc/mas_path.cu``) beside the K2 then K3 pair (``csrc/mas_viterbi.cu``),
and the floor that the search's dependency chain sets.

    python -m jatts_torch.bin.study_mas [--shapes bench,aligner] [--variants final,frames16,...]

It builds, with ``nvcc`` (all at once, the flags of ``ops/build.py``), under
the git-ignored ``build/study_mas/``:

- each source with ``%clock64`` read by thread 0 of every block (a
  consumer of the fused kernel) at the start and end of the forward and at
  the end of the backtrace, written to a ``__device__`` array; the script
  prints, over the blocks, the cycles a forward frame step and a backtrace
  step (the fused kernel runs ``feats_len - 1`` of each; K2 every frame, K3
  stages and walks every frame);
- variants of the fused source, one change each, timed in turns with it:
  ``frames16``, ``frames64`` (frames a chunk of the lp ring, 32 in the
  source), ``producers2``, ``producers7`` (producer warps, 3 in the
  source), ``slots2``, ``slots1`` (at most 2 or 1 slots a consumer warp, so
  128 tokens run on 2 or 4 consumer warps with halos);
- ``floor``: one warp of a small kernel of its own, with no memory in the
  loop, repeating one step ``steps`` times between two reads of
  ``%clock64`` and ``%globaltimer``: ``max_add``, the bare recurrence
  ``q = max(a, q) + c`` (the chain floor); ``shfl_max_add``, the fused
  forward's chain (a rotating shuffle, lane 0's select, the max and the
  add); ``fwd_4slots``, the fused forward's whole step at 4 slots without
  loads or stores (4 shuffles, selects, ballots, maxes and adds);
  ``onehot``, the fused backtrace's chain ``m += w & m``.

It prints the card's name, power limit and SM clock (``nvidia-smi``) beside
the readings, and the times by CUDA events and by graph replay of each
variant and the pair at 16 x 1024 x 128 (lengths drawn as
``chip_smoke.mas_cases`` draws them) and at an aligner-sized batch (16 x
1210 x 102), with whether each path equals the plain version's.
:func:`floors` is what ``chip_smoke.py`` calls for its chain floor.
"""

from __future__ import annotations

import ctypes
import subprocess

STAMP_HEADER = """
__device__ long long g_mas_stamps[4 * 4096];
#define MAS_STAMP(i) do { if (threadIdx.x == 0) g_mas_stamps[4 * blockIdx.x + (i)] = clock64(); } while (0)
extern "C" int jatts_mas_stamps(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_mas_stamps, (size_t)n * sizeof(long long));
}

namespace {
"""

FLOOR_SOURCE = r"""
#include <cuda_runtime.h>

__global__ void floor_kernel(const float* x, const unsigned* w, long long* out, int kind, int steps) {
  const int lane = threadIdx.x;
  const unsigned full = 0xffffffffu;
  float q[4], a = x[32 + lane], c = x[64 + lane];
  for (int r = 0; r < 4; ++r) q[r] = x[lane] + r;
  unsigned m = 1u, win = w[lane], acc = 0u;
  __syncwarp();
  unsigned long long g0, g1;
  const long long t0 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  if (kind == 0) {
#pragma unroll 16
    for (int i = 0; i < steps; ++i) q[0] = fmaxf(a, q[0]) + c;
  } else if (kind == 1) {
#pragma unroll 16
    for (int i = 0; i < steps; ++i) {
      const float t = __shfl_sync(full, q[0], (lane + 31) & 31);
      q[0] = fmaxf(lane == 0 ? a : t, q[0]) + c;
    }
  } else if (kind == 2) {
#pragma unroll 8
    for (int i = 0; i < steps; ++i) {
      float t[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) t[r] = __shfl_sync(full, q[r], (lane + 31) & 31);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float left = lane == 0 ? (r > 0 ? t[r > 0 ? r - 1 : 0] : a) : t[r];
        const unsigned v = __ballot_sync(full, left >= q[r]);
        if (lane == r) acc ^= v;
        q[r] = fmaxf(left, q[r]) + c;
      }
    }
  } else {
#pragma unroll 16
    for (int i = 0; i < steps; ++i) m += win & m;
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = (long long)(g1 - g0);
    out[2] = (long long)(__float_as_uint(q[0] + q[1] + q[2] + q[3]) ^ m ^ acc);  // keeps the loops
  }
}

extern "C" int jatts_mas_floor(const void* x, const void* w, void* out, int kind, int steps, void* stream) {
  floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const float*)x, (const unsigned*)w, (long long*)out, kind,
                                                   steps);
  return (int)cudaGetLastError();
}
"""

FLOORS = ("max_add", "shfl_max_add", "fwd_4slots", "onehot")


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the source no longer has one {old!r}")
    return src.replace(old, new)


def stamped_fused(src: str) -> str:
    src = _sub(src, "\nnamespace {\n", STAMP_HEADER)
    src = _sub(src, "  if (warp >= n_cons) {\n", "  MAS_STAMP(0);\n  if (warp >= n_cons) {\n")
    src = _sub(src, "  __syncthreads();  // every row of bits written\n",
               "  __syncthreads();  // every row of bits written\n  MAS_STAMP(1);\n")
    return _sub(src, "    if (!in_smem) __syncthreads();  // the next stage overwrites what warp 0 read\n  }\n}",
                "    if (!in_smem) __syncthreads();  // the next stage overwrites what warp 0 read\n  }\n"
                "  MAS_STAMP(2);\n}")


def stamped_pair(src: str) -> str:
    src = _sub(src, "\nnamespace {\n", STAMP_HEADER)
    src = _sub(src, "  for (int j0 = 1; j0 < t_feats; j0 += kFwdChunk) {",
               "  MAS_STAMP(0);\n  for (int j0 = 1; j0 < t_feats; j0 += kFwdChunk) {")
    src = _sub(src, "    for (int u = 0; u < kFwdChunk; ++u) cur[u] = nxt[u];\n  }\n}",
               "    for (int u = 0; u < kFwdChunk; ++u) cur[u] = nxt[u];\n  }\n  MAS_STAMP(1);\n}")
    src = _sub(src, "  if (tid == 0) s_a = last_tok;\n", "  if (tid == 0) s_a = last_tok;\n  MAS_STAMP(2);\n")
    return _sub(src, "    // thread 0 writes it again\n  }\n}", "    // thread 0 writes it again\n  }\n  MAS_STAMP(3);\n}")


def build_libs(texts):
    """name -> the loaded library of each source text (name -> text),
    compiled in parallel under ``build/study_mas/<name>/``."""
    from jatts_torch.ops import build

    root = build.BUILD_DIR.parent / "study_mas"
    procs = {}
    for name, text in texts.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "src.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "src.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{report}")
        libs[name] = ctypes.CDLL(str(d / "lib.so"))
    return libs


def floors(steps: int = 1023 * 64, lib=None):
    """name -> (cycles a step, ns a step) of each of ``FLOORS`` on the
    card, each the least of 3 runs of ``steps`` steps."""
    import torch

    lib = lib if lib is not None else build_libs({"floor": FLOOR_SOURCE})["floor"]
    fn = lib.jatts_mas_floor
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = -torch.rand(96, device="cuda", generator=g)
    w = torch.randint(0, 2 ** 31, (32,), device="cuda", generator=g, dtype=torch.int64).to(torch.int32)
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    result = {}
    for kind, name in enumerate(FLOORS):
        runs = []
        for _ in range(4):  # the first warms the clocks up
            rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), kind, steps, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"floor kernel launch failed with CUDA error {rc}")
            torch.cuda.synchronize()
            runs.append((int(out[0]) / steps, int(out[1]) / steps))
        result[name] = min(runs[1:])
    return result


def _frames(n):
    return lambda src: _sub(src, "kFrames = HALO ? 4 : 32;", f"kFrames = HALO ? 4 : {n};")


def _slots(n):
    """At most ``n`` slots a consumer warp: 128 tokens on 4 / n warps with
    halos."""
    def change(src):
        src = _sub(src, "constexpr int kMaxSlots = 4; ", f"constexpr int kMaxSlots = {n}; ")
        return _sub(src, "  if (r == 3)\n", "".join(
            f"  if (r == {m})\n    return launch<{m}, true>(lp_f, tl, fl, out, gbits, full, b, t_feats, t_text, "
            "n_words, smem_rows, smem_bytes,\n                           n_warps, st);\n" for m in range(1, 3))
            + "  if (r == 3)\n")
    return change


def _producers(n):
    return lambda src: _sub(src, "constexpr int kProducers = 3;", f"constexpr int kProducers = {n};")


# one change each to the fused source
VARIANTS = {"final": lambda src: src, "frames16": _frames(16), "frames64": _frames(64), "slots2": _slots(2),
            "slots1": _slots(1), "producers2": _producers(2), "producers7": _producers(7)}


def _lengths(rng, b, t_feats, t_text):
    # as chip_smoke.mas_cases draws the 16 x 1024 x 128 case
    return rng.integers(t_text // 2, t_text + 1, (b,)).tolist(), rng.integers(t_feats // 2, t_feats + 1, (b,)).tolist()


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    from jatts_torch.ops import build, mas

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="bench,aligner", help="comma-separated of bench (16x1024x128), "
                                                                 "aligner (16x1210x102)")
    ap.add_argument("--variants", default="final", help=f"comma-separated of {list(VARIANTS)}")
    args = ap.parse_args(argv)
    names = ["final"] + [n for n in args.variants.split(",") if n != "final"]
    if not torch.cuda.is_available():
        raise SystemExit("study_mas: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi name, power limit, SM clock, max SM clock: "
          f"{smi.stdout.strip()}", flush=True)
    fused_src = (build.CSRC_DIR / f"{mas.KERNEL_PATH}.cu").read_text()
    libs = build_libs({
        **{f"fused_{n}": stamped_fused(VARIANTS[n](fused_src)) for n in names},
        "pair": stamped_pair((build.CSRC_DIR / f"{mas.KERNEL}.cu").read_text()),
        "floor": FLOOR_SOURCE,
    })
    fl_steps = floors(lib=libs["floor"])
    print("chain floors, one warp, no memory: " + "; ".join(
        f"{n} {c:.2f} cycles ({ns:.3f} ns) a step" for n, (c, ns) in fl_steps.items()), flush=True)

    fused = {}
    for n in names:
        fn = libs[f"fused_{n}"].jatts_mas_path
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fused[n] = fn
    k2, k3 = libs["pair"].jatts_mas_fwd, libs["pair"].jatts_mas_backtrace
    k2.restype = k3.restype = ctypes.c_int
    k2.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    k3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for lib in libs.values():
        if hasattr(lib, "jatts_mas_stamps"):
            lib.jatts_mas_stamps.restype = ctypes.c_int
            lib.jatts_mas_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]

    shapes = {"bench": (16, 1024, 128), "aligner": (16, 1210, 102)}
    rng = np.random.default_rng(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    for key in args.shapes.split(","):
        b, t_feats, t_text = shapes[key]
        tl_l, fl_l = _lengths(rng, b, t_feats, t_text)
        lp = torch.log_softmax(torch.randn(b, t_feats, t_text, device="cuda", generator=g), -1)
        tl = torch.tensor(tl_l, dtype=torch.int32, device="cuda")
        fl = torch.tensor(fl_l, dtype=torch.int32, device="cuda")
        n_words = (t_text + 31) // 32
        paths = {n: torch.empty(b, t_feats, dtype=torch.int32, device="cuda") for n in names + ["pair"]}
        bits = torch.empty(b, t_feats, n_words, dtype=torch.int32, device="cuda")

        def runner(n):
            def run():  # the stream read at each call, so a graph capture takes the launches
                stream = torch.cuda.current_stream().cuda_stream
                if n == "pair":
                    rc = k2(lp.data_ptr(), tl.data_ptr(), bits.data_ptr(), b, t_feats, t_text, stream)
                    rc = rc or k3(bits.data_ptr(), tl.data_ptr(), fl.data_ptr(), paths[n].data_ptr(), b, t_feats,
                                  t_text, stream)
                else:
                    rc = fused[n](lp.data_ptr(), tl.data_ptr(), fl.data_ptr(), paths[n].data_ptr(), None, None, b,
                                  t_feats, t_text, mas.SMEM_BITS_BYTES, stream)
                if rc != 0:
                    raise RuntimeError(f"{n}: launch failed with CUDA error {rc}")
            return run

        runs = {n: runner(n) for n in names + ["pair"]}
        host = (ctypes.c_longlong * (4 * b))()
        want = mas.mas_path_ref(lp, tl, fl)
        fl_c = np.minimum(np.array(fl_l), t_feats)
        walk = np.maximum(fl_c - 1, 1)  # the fused backtrace's steps; its forward runs as many frames
        cyc = {}
        for n, run in runs.items():
            for _ in range(3):  # warm: the last run's stamps are read
                run()
            torch.cuda.synchronize()
            lib = libs["pair" if n == "pair" else f"fused_{n}"]
            rc = lib.jatts_mas_stamps(host, 4 * b)
            if rc != 0:
                raise RuntimeError(f"reading the stamps failed with CUDA error {rc}")
            st = np.array(host[:], dtype=np.int64).reshape(b, 4)
            if n == "pair":
                cyc[n] = ((st[:, 1] - st[:, 0]) / max(t_feats - 1, 1), (st[:, 3] - st[:, 2]) / t_feats)
            else:
                cyc[n] = ((st[:, 1] - st[:, 0]) / walk, (st[:, 2] - st[:, 1]) / walk)

        times = {n: ([], []) for n in runs}
        for _ in range(3):  # in turns
            for n, run in runs.items():
                times[n][0].append(_events_ms(run))
                times[n][1].append(_graph_ms(run))
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60).stdout.strip()
        print(f"{key} {b}x{t_feats}x{t_text}: cycles a step (mean over the blocks, range) of the forward and the "
              f"backtrace (the pair: K2 and K3, K3 a frame); ms a search, least of 3 in turns by events and by "
              f"graph replay; SM clock after {clock}", flush=True)
        for n in runs:
            (fwd, bt), (ev, gr) = cyc[n], times[n]
            print(f"  {n}: forward {fwd.mean():.1f} ({fwd.min():.1f}-{fwd.max():.1f}), backtrace {bt.mean():.1f} "
                  f"({bt.min():.1f}-{bt.max():.1f}); events {min(ev):.4f} ({', '.join(f'{x:.4f}' for x in ev)}), "
                  f"graph {min(gr):.4f} ({', '.join(f'{x:.4f}' for x in gr)}); path equals the plain "
                  f"version's: {bool(torch.equal(paths[n], want))}", flush=True)
    return 0


def _events_ms(fn, iters=20):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters=20, replays=5):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


if __name__ == "__main__":
    raise SystemExit(main())
