"""Time variants of K1-bwd's bf16 backward with a bias on the tensor cores
(``csrc/flash_attn_bwd_tc_bias.cu``) on the card, in turns, at a bf16-compute
JSUT training step's decoder attention (B, H, T = 24, 2, 896, d 192, a dense
bias, every key valid):

    python -m jatts_torch.bin.study_bwd_tc_bias [--variants final,stamps,...] [--t 896]

Each variant is the source with one change, built by ``nvcc`` (all at once)
into its own library under the git-ignored ``build/study_bwd_bias/``
(``bin/study_fwd_tc_f32.py``'s machinery):

- ``final``: the source as it stands;
- ``recompute``: the dk/dv kernel without the handoff between its
  warpgroups: B forms S^T, the bias and P^T itself (12 more wgmmas a tile,
  1.25x the products) instead of reading A's p from shared memory, the
  other design the split could take (the same bits);
- ``windows``: the bias staged by the producer's cp.async windows (9
  chunks a row, 18 a lane), the path of a Tk that is not a multiple of 8,
  where Tk % 8 == 0 would take it as a TMA box (the same bits);
- ``ring3``: three ring stages instead of two, timed for dq only (its
  shared memory holds a third stage, dk/dv's does not): whether the
  consumers' wait for a stage is the loads' latency, which a deeper ring
  hides, or their bandwidth, which it does not (the same bits);
- ``stamps``: the source with ``BIAS_STAMPS`` defined: thread 0 of each
  consumer warpgroup reads ``%clock`` at the phase boundaries of every tile
  and sums each phase's cycles; the first block of (b, h) 0 writes the sums
  over row 0 of the warpgroup's output at columns 8i (in bf16: three
  significant digits), and the script prints them per tile. dq: the wait
  for the resident q and do (once), the stage wait, S (and dP's issue), the
  bias and p, dP's wait and ds, the d(ab) stores, the dQ product, the
  release. dk/dv warpgroup A: the resident wait, the stage wait, S^T, the
  bias and p, the handoff (the wait for its buffer and the stores), the dV
  product, the release; B: the resident wait, the stage wait, dP^T, the wait
  for A's p, ds, the dK product, the release.

``stamps`` is wrong by design (its stamps overwrite outputs). The script checks
nothing but that every variant launches. It prints the card's name and power
limit, each variant's ms for the dk/dv and the dq kernel (the least of 3 rounds
of 10 launches, variants in turns) and whether its outputs have the bits of
``final``'s.
"""

from __future__ import annotations

import subprocess

from jatts_torch.bin.study_fwd_tc_f32 import _on, _sub, build_variants, sources

SOURCE = "flash_attn_bwd_tc_bias.cu"
SHAPE = (24, 2)
SYMBOLS = ("jatts_flash_attn_bwd_dkv_tc_bias", "jatts_flash_attn_bwd_dq_tc_bias")
STAMPED = {
    "dq": ("x wait", "stage wait", "S", "bias p", "dp ds", "dab", "output", "release"),
    "dkv A": ("x wait", "stage wait", "S", "bias p", "handoff", "dV", "release"),
    "dkv B": ("x wait", "stage wait", "dP", "p wait", "ds", "dK", "release"),
}

HANDOFF_A = """        // hand p to B: buffer t & 1, once B has read what it held two tiles ago
        const int pb = t & 1;
        if (t >= 2) mbar_wait(&ctl.p_empty[pb], ((t >> 1) - 1) & 1);
        float4* pt = reinterpret_cast<float4*>(pbuf + pb * PTILE);
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4)
          pt[q4 * 128 + t4] = make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3]);
        mbar_arrive(&ctl.p_full[pb]);
"""
HANDOFF_B = """        const int pb = t & 1;
        mbar_wait(&ctl.p_full[pb], (t >> 1) & 1);
        STAMP(3)
"""
RECOMPUTE_B = """        float sp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(sp, slab_desc(x_addr + s * SLAB) + 2 * kk, slab_desc(y_addr + s * SLAB) + 2 * kk,
                     s > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sp);
        const uint8_t* bias = ring + slot * STAGE + BIAS_OFF;
        const uint32_t a0 = bias_at(ab_bh + (size_t)c0 * Tk + r0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(&ctl.lse2[slot][8 * j + cc]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const int qc = 8 * j + cc + e, kr = quad_row + 8 * h;
              const uint32_t off = TMA_BIAS ? tile_at(cc + e, kr) + 1024 * j
                                            : qc * BROW + ((a0 + 2u * (uint32_t)qc * (uint32_t)Tk) & 15u) + 2 * kr;
              const float b = bf16_lo(*reinterpret_cast<const unsigned short*>(bias + off));
              sp[i] = key_valid(mask_b, r0 + kr, Tk)
                          ? exp2f(__fmaf_rn(__fadd_rn(sp[i], b), scale2, -(e ? l2.y : l2.x))) : 0.f;
            }
        }
        STAMP(3)
"""


def _recompute(src):
    src = _sub(src, HANDOFF_A, "")
    src = _sub(src, HANDOFF_B, RECOMPUTE_B)
    src = _sub(src, "        const float4* pt = reinterpret_cast<const float4*>(pbuf + pb * PTILE);\n", "")
    src = _sub(src, "const float4 p = pt[j * 128 + t4];",
               "const float4 p = make_float4(sp[4 * j], sp[4 * j + 1], sp[4 * j + 2], sp[4 * j + 3]);")
    return _sub(src, "        mbar_arrive(&ctl.p_empty[pb]);\n", "")


def _windows(src):
    return _sub(src, "const bool tma_bias = Tk % 8 == 0", "const bool tma_bias = false && Tk % 8 == 0")


def _ring3(src):
    return _sub(src, "constexpr int R_S = 2;", "constexpr int R_S = 3;")


def _stamps(src):
    return _sub(src, '#include "tc_common.cuh"\n', '#define BIAS_STAMPS\n#include "tc_common.cuh"\n')


VARIANTS = {"final": lambda f: f, "recompute": _on(SOURCE, _recompute), "windows": _on(SOURCE, _windows),
            "ring3": _on(SOURCE, _ring3),
            "stamps": _on(SOURCE, _stamps)}
# variants that only one kernel can take (ring3's dk/dv would not fit in shared memory)
ONLY = {"ring3": "dq"}


def study(fns, t):
    """Every variant of ``fns`` at (24, 2, t, t): dk/dv, then dq."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    b, h = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, h, t, 192, device="cuda", generator=g).bfloat16() for _ in range(4))
    ab = (torch.randn(b, h, t, t, device="cuda", generator=g) * 192 ** 0.5).bfloat16()
    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
    scale = 192 ** -0.5
    o, lse = k1.flash_attention_fwd(q, k, v, ab, mask, scale)
    di = (o.float() * do.float()).sum(-1)
    outs = {"dkv": (torch.empty_like(k), torch.empty_like(v)), "dq": (torch.empty_like(q), torch.empty_like(ab))}
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, kind):
        a, b_ = outs[kind]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ab.data_ptr(), mask.data_ptr(), lse.data_ptr(),
                di.data_ptr(), do.data_ptr(), a.data_ptr(), b_.data_ptr(), b, h, t, t, 192, 192, 1, 0, scale, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    for kind, symbol in zip(("dkv", "dq"), SYMBOLS):
        kind_fns = {name: f for name, f in fns.items() if ONLY.get(name, kind) == kind}
        bits = {}
        for name, f in kind_fns.items():
            call(f[symbol], kind)
            torch.cuda.synchronize()
            bits[name] = torch.cat([x.flatten() for x in outs[kind]]).clone()
        times = {name: [] for name in kind_fns}
        for _ in range(3):
            for name, f in kind_fns.items():
                call(f[symbol], kind)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(f[symbol], kind)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 10)
        print(f"{kind} bf16 {b},{h},{t},192 with a bias: " + "; ".join(
            f"{name} {min(ms):.4f} ms ({', '.join(f'{x:.4f}' for x in ms)}; bits of final: "
            f"{bool(torch.equal(bits[name], bits['final']))})" for name, ms in times.items()), flush=True)
        if "stamps" not in fns:
            continue
        call(fns["stamps"][symbol], kind)
        torch.cuda.synchronize()
        tiles = -(-t // 64)
        rows = ([("dq", outs["dq"][0][0, 0, 0])] if kind == "dq"
                else [("dkv A", outs["dkv"][1][0, 0, 0]), ("dkv B", outs["dkv"][0][0, 0, 0])])
        for who, row in rows:
            names = STAMPED[who]
            cyc = row[:8 * len(names):8].float().tolist()
            print(f"  stamps {who}, cycles a tile (of {tiles}): " + ", ".join(
                f"{n} {c / (1 if n == 'x wait' else tiles):.0f}" for n, c in zip(names, cyc))
                + f"; a tile in all {sum(cyc[1:]) / tiles:.0f}", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names (final is always run)")
    ap.add_argument("--t", type=int, default=896, help="Tq = Tk (893: a length that takes the cp.async windows)")
    args = ap.parse_args(argv)
    names = ["final"] + [n for n in args.variants.split(",") if n != "final"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"study_bwd_tc_bias: unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("study_bwd_tc_bias: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}", flush=True)
    fns = build_variants({n: VARIANTS[n] for n in names}, SOURCE, sources((SOURCE,)), SYMBOLS, n_pointers=10,
                         study="study_bwd_bias")
    study(fns, args.t)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
