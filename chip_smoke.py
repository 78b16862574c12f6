#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (jatts_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run with a non-zero exit:
  1. device: name, count and ``nvidia-smi`` name/power limit;
  2. build every hand-written kernel from ``jatts_torch/csrc`` (one ``nvcc``
     per source, all at once; each one's seconds and ptxas report printed;
     a register spill in a tensor-core kernel fails the run);
  3. K1 (flash attention) against its plain PyTorch version on the card at
     the serving path's shapes, f32 (TF32 off; the 3xTF32 tensor-core kernel,
     ``flash_attn_fwd_tc_f32.cu``) and bf16 (the tensor-core kernel,
     ``flash_attn_fwd_tc.cu``), error beside tolerance; then each
     tensor-core kernel at every (d_qk, d_v) it is built for (K1's head dims
     with and without bias, K1r's pairs), at a ragged T, at T = 1, at Tq !=
     Tk, with rows that see no key and on the log-sum-exp, in f32 the scalar
     kernel beside it on the same inputs;
  4. K1's times with CUDA events (and, for the tensor-core kernel and SDPA,
     replayed from a CUDA graph, without the host's time between launches)
     beside their bounds, their plain versions' and one library call's
     (SDPA, the yardstick, never used by the port):
     the tensor-core kernel at the serving decoder and encoder shapes (bf16),
     the 3xTF32 kernel at the training decoder shape (f32, with lse; graph
     replay too, the scalar kernel on the same inputs beside; the bound on
     the tensor cores in 3xTF32, the CUDA cores' beside);
  5. K2 (MAS forward) and K3 (MAS backtrace), each against its plain twin
     and the pair against the plain search, count of differing elements
     beside the limit 0, at 16x1024x128, at a ragged width, on edge-case
     lengths, on a quantised input full of ties, at the widest block and
     over more frames than K3 stages at once;
  6. K2's and K3's times at 16x1024x128, the plain versions' and the bound;
  7. the serving slice: 16 requests through BatchingServer at the full JSUT
     width (FastSpeech2 adim 384, 4+4 conformer blocks, HiFi-GAN 512 ch,
     hop 300) in bf16 with ``attn_backend="flash"`` and seed-made weights,
     with the launch counts set to 0 just before and read just after (every
     K1 launch on the tensor-core kernel); then the output checks and the
     slice against the port's eager path on a small f32 input;
  8. the aligner slice: a synthetic tone corpus (64 utterances, wavs and
     csvs in a temporary directory) through ``jatts_torch/bin/align.py:run``
     with the JSUT feature settings and the CLI's defaults (adim 256, 2
     layers, batch 16, f32), launch counts set to 0 just before and read
     just after; then the duration invariants, the accuracy against the
     known alignment, the same dump with ``mas_backend="scan"``, K2 and K3
     against their twins on the largest batch's lattice, and the time of a
     training step and its parts;
  9. K1-bwd (flash-attention backward: the dk/dv kernel and the dq/d(ab)
     kernel) against its plain version for each output at the training
     shapes and at other head dims, in f32 and bf16, with and without bias,
     at a ragged length and with a row of no valid key; against autograd
     through K1's plain version; then the kernels' times beside the plain
     version's, SDPA forward+backward's (the yardstick, never used by the
     port) and the bound;
 10. the training slice: phase 8's corpus and durations become .npz dumps
     (log-mel, per-token log tone frequency as pitch, per-token energy),
     and ``jatts_torch/bin/tts_train.py:run`` trains FastSpeech2 at the full
     JSUT width (egs/jsut/tts1/conf/fastspeech2.v1.yaml, batch 32, f32) with
     ``attn_backend: flash`` for 200 steps (warm-up 50), launch counts set
     to 0 just before and read just after (every forward on the 3xTF32
     tensor-core kernel, none on the scalar one or the bf16 one; dk/dv and dq
     scalar, none on the 3xTF32 backward); then the loss, launch,
     checkpoint/resume and inference checks, the time of one step and its
     parts, a profiled step, and the same step under ``attn_backend: xla``;
 11. K1b (the causal form of K1 and K1-bwd: the forward, dk/dv and dq
     kernels; in bf16 the forward on the tensor cores, ``flash_attn_fwd_tc.cu``,
     and at d 64 without bias dk/dv and dq too, ``flash_attn_bwd_tc.cu``,
     each launch checked from the counters) against their plain versions at
     VALL-E's attention shape in bf16 with a ragged key mask, in f32, at a T
     that ends inside a diagonal tile, at T = 1, at d = 192 with a bias, and
     with rows that see no key (bf16 and f32; each output within its
     tolerance of every batch item's own magnitude; unseen rows and keys
     exactly 0); FlashAttention forward + backward in bf16 at VALL-E's shape against
     autograd through the plain forward (the tensor-core lse feeding both
     tensor-core backward kernels); then their times at VALL-E's shape by
     CUDA events and graph replays beside the plain versions', two SDPA
     yardsticks (never used by the port: a boolean causal and key-padding
     mask, and ``is_causal`` without a mask; the backend printed) and the
     bounds, the non-causal forward over 1, 9 and 17 key tiles a block
     beside the causal one, and the scalar forward, dk/dv and dq, which
     VALL-E's bf16 form no longer takes, in f32;
 12. the VALL-E AR slice: a synthetic 64-utterance codec corpus (.npz
     dumps) trains through ``jatts_torch/bin/tts_train.py:run`` on
     egs/hificaptain_jp_female/tts3/conf/valle_ar.given.bs32.yaml as it
     stands (d_model 1024, 16 heads, 12 layers, bf16 compute, batch 16 x
     accumulation 2, AdamW) with ``attn_backend: flash`` for 200 steps
     (warm-up 50), launch counts set to 0 just before and read just after
     (every K1b forward, dk/dv and dq on the tensor-core kernels, 12 a
     step, no scalar bf16 one);
     then the loss, launch and bitwise-resume checks, the time of a step and
     its parts, a profiled step, K1b at the batch's own shape, the same step
     under ``attn_backend: xla``; then ``ar_generate`` from the trained model
     on 4 dev rows (time a step, codes in range) and its KV-cached logits
     against the flash trunk's, teacher-forced, in f32;
 13. K1r (the fused rel-pos form of K1 and K1-bwd, d_qk != d_v: the
     forward, dk/dv and dq kernels) against their plain versions at the
     JVS/JSUT width's pair (d_qk 576, d_v 192) in bf16 and f32, at the small
     pair (192, 64), at a ragged T, at T = 1, at Tq != Tk, with rows that see
     no key and with keys that start inside a tile, each output within its
     tolerance of every batch item's own max(1, max|plain|); the f32 dk/dv
     and dq on the 3xTF32 tensor-core kernels (``flash_attn_bwd_tc_f32.cu``,
     each launch checked from the counters), with the same bits on a second
     run and for an item alone, the scalar ones checked on the same inputs;
     the backward also against autograd through the plain forward; then
     their times at the training decoder shape (f32, by CUDA events and by
     graph replay, the scalar forward, dk/dv and dq on the same inputs
     beside) and the serving decoder shape (bf16) beside the plain
     versions', SDPA's with a boolean key mask (the yardstick, never used by
     the port; its backend printed) and the bounds (f32 on the tensor cores
     in 3xTF32, the CUDA cores' beside);
 14. the JVS-latest path: egs/jvs/tts1/conf/fastspeech2.v1.yaml (adim 384,
     2 heads, 4+4 blocks, ``spk_embed_dim`` 192 ``add``) with
     ``conformer_rel_pos_type: latest`` and ``attn_backend: flash``: 16
     requests with a seed-made unit ``spemb`` each through BatchingServer in
     bf16 (K1r 8 launches a batch, all on the tensor-core kernel), the same
     model small in f32 against its
     eager path; then phase 8's corpus with a seed-made 192-d ``spkemb`` an
     utterance (4 synthetic speakers) trains 200 steps through
     ``jatts_torch/bin/tts_train.py:run`` (f32, batch 32, warm-up 50), launch
     counts set to 0 just before and read just after (K1r 8 launches a step
     each, every forward on the 3xTF32 kernel and every dk/dv and dq on the
     3xTF32 backward kernels, no K1 or K1-bwd launch); the loss, bitwise
     resume, a step's time
     and parts, a profiled step, and the same step under ``attn_backend:
     xla`` (the eager rel_shift_gather path) on the same weights and batch.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Exits 2 without a CUDA device or
without the jatts_torch package beside this file.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s of the bf16
# and TF32 tensor cores and of f32 on the CUDA cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def ops_ms(flops, dtype_name):
    """Least ms of ``flops`` of products on the tensor cores: bf16 at its
    rate, f32 as 3xTF32 (three TF32 products each, the f32-faithful route
    the card offers), so every f32 row is held to the same yardstick."""
    if dtype_name == "f32":
        return 3 * flops / PEAK_FLOPS_S["tf32"] * 1e3
    return flops / PEAK_FLOPS_S[dtype_name] * 1e3


def cuda_core_ms(flops):
    """The same products as f32 FMAs on the CUDA cores: the yardstick of the
    f32 rows before the tensor-core route, printed beside for comparison."""
    return flops / PEAK_FLOPS_S["f32"] * 1e3

# K1 tolerances on max |kernel - plain|: f32 differs by summation order only;
# bf16 output is rounded once to bf16 (half an ulp is 2^-8 |o|, |o| < 4 here)
TOL = {"f32": 1e-4, "bf16": 1e-2}
# K1-bwd tolerances on max |kernel - plain| over dq, dk, dv, d(ab), relative
# to max(1, max |plain|): f32 differs by summation order only (sums of up to
# 1024 terms); bf16 outputs are rounded once to bf16 (2^-9 relative)
TOL_BWD = {"f32": 1e-4, "bf16": 1e-2}
# K1r tolerances on max |kernel - plain| of each output, relative to
# max(1, max |plain|): f32 by summation order only (sums of <= 1024 terms of
# <= 576 products), bf16 rounded once to bf16
TOL_K1R = {"f32": 1e-5, "bf16": 1e-2}


def ptxas_entry(line: str) -> str:
    """``flash_attn_fwd_relpos_kernel<bf16,576,192>`` from the mangled name
    on a ptxas "Compiling entry function" line."""
    name = re.search(r"\d((?:flash_attn|mas)_[a-z0-9_]*?_kernel)(?=[IPEv])", line)
    if name is None:
        return line.strip()
    targs = re.search(r"_kernelI(.+?)EEv", line)  # a template's arguments
    args, rest = [], targs.group(1) if targs else ""
    while rest:
        if rest.startswith("13__nv_bfloat16"):
            args.append("bf16")
            rest = rest[len("13__nv_bfloat16"):]
        elif rest.startswith("f"):
            args.append("f32")
            rest = rest[1:]
        elif rest.startswith("Lb"):
            if name.group(1) == "flash_attn_bwd_tc_f32_kernel":  # <D_QK, D_V, DQ>
                args.append("dq" if rest[2] == "1" else "dk/dv")
            elif name.group(1) in ("flash_attn_fwd_tc_kernel", "flash_attn_fwd_tc_f32_kernel") and (
                    "bias" not in " ".join(args)):
                args.append("bias" if rest[2] == "1" else "no bias")  # <D_QK, D_V, BIAS(, CAUSAL)>
            else:
                args.append("causal" if rest[2] == "1" else "non-causal")
            rest = rest[4:]
        elif rest.startswith("Li"):
            args.append(rest[2:rest.index("E")])
            rest = rest[rest.index("E") + 1:]
        else:
            args.append(rest)
            break
    return name.group(1) + (f"<{','.join(args)}>" if args else "")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3, host_clock: bool = False) -> float:
    """Mean ms of a call by CUDA events; with ``host_clock`` by the host's
    clock between two synchronises, for calls that the host holds back."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if host_clock:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean ms of a call replayed from a CUDA graph of ``iters`` calls:
    the device's time for the call's kernels without the host's time
    between launches, which CUDA events over back-to-back calls also count
    (the wrapper's Python and ctypes work, ~0.05 ms a call)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def k1_inputs(b, h, t, d, dtype, with_bias, seed):
    """Main-path-like K1 inputs: bias at the scale of q·kᵀ, varied key
    lengths (cycled over the batch) including a full row, one key and no
    valid key."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    ab = None
    if with_bias:
        ab = (torch.randn(b, h, t, t, device="cuda", generator=g) * math.sqrt(d)).to(dtype)
    lens = ([t, t - 1, (3 * t) // 4, t // 2, 17, 1, 0, t - 63] * (b // 8 + 1))[:b]
    lens = [max(0, min(t, n)) for n in lens]
    key_mask = torch.arange(t, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
    return q, k, v, ab, key_mask, lens


def k1_bound_ms(b, h, t, d, elem_bytes, with_bias, dtype_name, with_lse=False):
    io = 4 * b * h * t * d * elem_bytes + b * t  # q, k, v, out, key mask
    if with_bias:
        io += b * h * t * t * elem_bytes
    if with_lse:
        io += b * h * t * 4
    flops = 4 * b * h * t * t * d  # every key valid in the timing inputs
    t_bytes = io / PEAK_BYTES_S * 1e3
    t_ops = ops_ms(flops, dtype_name)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), io, flops


def tc_cases(dtype_name="bf16"):
    """The tensor-core forwards' checks: (name, (B, H, Tq, Tk), (d_qk, d_v),
    bias, key rows as (first valid key, number of valid keys) cycled over
    the batch). Every form the kernel of ``dtype_name`` is built for (bf16:
    flash_attn_fwd_tc.cu, f32: the 3xTF32 flash_attn_fwd_tc_f32.cu); T ends
    inside a tile (1000 = 15 x 64 + 40), T = 1, Tq != Tk with an odd Tk (the
    bias read pair by pair) and a leading key tile with no valid key
    (skipped), rows that see no key."""
    from jatts_torch.ops import flash_attention as k1

    pairs = k1.TC_F32_PAIRS if dtype_name == "f32" else [(d, d) for d in k1.HEAD_DIMS] + list(k1.RELPOS_PAIRS)
    ragged = [(0, 1000), (0, 999), (3, 517), (0, 1), (0, 0), (0, 64), (64, 65), (0, 1000)]
    cases = [(f"d={d_qk} bias={bias}", (8, 2, 1000, 1000), (d_qk, d_v), bias, ragged)
             for d_qk, d_v in pairs if d_qk == d_v for bias in (False, True)]
    cases += [(f"K1r {d_qk},{d_v}", (8, 2, 1000, 1000), (d_qk, d_v), False, ragged)
              for d_qk, d_v in pairs if d_qk != d_v]
    for d_qk, d_v in ((192, 192), k1.RELPOS_PAIRS[-1]):
        bias = d_qk == d_v
        cases += [
            (f"T=1 {d_qk},{d_v}", (2, 2, 1, 1), (d_qk, d_v), bias, [(0, 1), (0, 0)]),
            (f"Tq!=Tk {d_qk},{d_v}", (2, 2, 70, 203), (d_qk, d_v), bias, [(0, 203), (64, 65)]),
        ]
    return cases


def check_tc(seed, dtype_name="bf16"):
    """A tensor-core forward (non-causal; bf16: flash_attn_fwd_tc.cu, f32:
    the 3xTF32 flash_attn_fwd_tc_f32.cu) against flash_attention_ref in f32
    (TF32 off) on the same inputs, with and without the log-sum-exp: K1's
    forms within TOL[dtype] absolute, K1r's within TOL_K1R[dtype] of max(1,
    max|plain|); lse within 1e-4 of max(1, max|lse|); a row that sees no key
    exactly 0 with lse +inf. In f32 the scalar kernel, which the forms no
    longer take, is held the same way on the same inputs. Returns the
    largest |kernel - plain| of K1's forms and of K1r's (and in f32 the
    scalar kernel's, "scalar_k1" and "scalar_k1r")."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    counter = "launches_tc_f32" if dtype_name == "f32" else "launches_tc"
    worst = {"k1": 0.0, "k1r": 0.0, "scalar_k1": 0.0, "scalar_k1r": 0.0}
    for i, (name, (b, h, tq, tk), (d_qk, d_v), bias, rows) in enumerate(tc_cases(dtype_name)):
        g = torch.Generator(device="cuda").manual_seed(seed + i)
        q = torch.randn(b, h, tq, d_qk, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, h, tk, d_qk, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, h, tk, d_v, device="cuda", generator=g).to(dtype)
        ab = (torch.randn(b, h, tq, tk, device="cuda", generator=g) * math.sqrt(d_qk)).to(dtype) if bias else None
        pos = torch.arange(tk, device="cuda")
        key_mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in (rows * b)[:b]])
        scale = d_v ** -0.5
        before = (getattr(k1, counter), k1.launches, k1.launches_relpos)
        out, lse_k = k1.flash_attention_fwd(q, k, v, ab, key_mask, scale)
        out_nolse = k1.flash_attention(q, k, v, ab, key_mask, scale)
        torch.cuda.synchronize()
        after = (getattr(k1, counter), k1.launches, k1.launches_relpos)
        form = 1 if d_qk == d_v else 2
        check(after[0] - before[0] == 2 and after[form] - before[form] == 2,
              f"tc {dtype_name} {name}: launches {before} -> {after}")
        want, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(),
                                           None if ab is None else ab.float(), key_mask, scale, return_lse=True)
        check(bool(torch.equal(out, out_nolse)), f"tc {name}: the forward with and without lse differ")
        err = (out.float() - want).abs().max().item()
        if d_qk == d_v:
            rel, tol = err, TOL[dtype_name]
        else:
            rel, tol = err / max(1.0, want.abs().max().item()), TOL_K1R[dtype_name]
        none = torch.isinf(lse)
        lse_err = (lse_k - lse).masked_fill(none, 0.0).abs().max().item()
        lse_tol = 1e-4 * max(1.0, lse.masked_fill(none, 0.0).abs().max().item())
        print(f"tc check {dtype_name} {name} B,H,Tq,Tk={b},{h},{tq},{tk}: max_abs_err {err:.3e} "
              f"({'absolute' if d_qk == d_v else f'{rel:.2e} relative'}; tol {tol:.0e}); lse err {lse_err:.1e} "
              f"(tol {lse_tol:.1e}); rows that see no key {int(none.sum())}", flush=True)
        check(math.isfinite(err) and rel <= tol, f"tc {name}: err {rel} > {tol}")
        check(bool(torch.equal(none, torch.isinf(lse_k))) and bool((lse_k[none] > 0).all()),
              f"tc {name}: +inf lse rows differ")
        check(lse_err <= lse_tol, f"tc {name}: lse err {lse_err}")
        check(bool((out.masked_select(none[..., None]) == 0).all()), f"tc {name}: a row that sees no key is not 0")
        key = "k1" if d_qk == d_v else "k1r"
        worst[key] = max(worst[key], err)
        if dtype_name == "f32":
            out_s, lse_s = k1._launch_fwd(q, k, v, ab, key_mask, scale, True, False, _kernel=k1.KERNEL)
            torch.cuda.synchronize()
            err_s = (out_s - want).abs().max().item()
            rel_s = err_s if d_qk == d_v else err_s / max(1.0, want.abs().max().item())
            lse_err_s = (lse_s - lse).masked_fill(none, 0.0).abs().max().item()
            print(f"    the scalar kernel on the same inputs: max_abs_err {err_s:.3e}"
                  + ("" if d_qk == d_v else f" ({rel_s:.2e} relative)") + f"; lse err {lse_err_s:.1e}", flush=True)
            check(math.isfinite(err_s) and rel_s <= tol and lse_err_s <= lse_tol
                  and bool(torch.equal(none, torch.isinf(lse_s))), f"tc {name}: the scalar kernel's err {rel_s}")
            check(bool((out_s.masked_select(none[..., None]) == 0).all()), f"tc {name}: scalar row without key not 0")
            worst["scalar_" + key] = max(worst["scalar_" + key], err_s)
    return worst


def time_k1_more(seed, where):
    """K1 at the serving encoder shape (bf16, the tensor-core kernel) and at
    the FS2 training decoder shape (f32 with the log-sum-exp, the 3xTF32
    tensor-core kernel, also replayed from a CUDA graph, beside the scalar
    kernel on the same inputs), each beside SDPA with the bias folded into a
    float mask (mask = ab·scale: SDPA adds its mask after the scale) and the
    bound (f32: on the tensor cores in 3xTF32, the CUDA cores' beside); the
    training shape also beside the plain version."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    res = {}
    for key, (b, h, t, d), dtype, dtype_name in (
        ("enc", (8, 2, 128, 192), torch.bfloat16, "bf16"),
        ("train", (32, 2, 1024, 192), torch.float32, "f32"),
    ):
        q, k, v, ab, _, _ = k1_inputs(b, h, t, d, dtype, True, seed)
        full = torch.ones(b, t, dtype=torch.bool, device="cuda")
        scale = d ** -0.5
        mask = (ab.float() * scale).to(dtype)
        if key == "enc":
            kernel_ms = time_ms(lambda: k1.flash_attention(q, k, v, ab, full, scale))
            plain = None
            # the call is host-bound here: graph replays tell the kernels apart
            res["enc_graph"] = (
                graph_ms(lambda: k1.flash_attention(q, k, v, ab, full, scale)),
                graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale)),
            )
        else:
            kernel_ms = time_ms(lambda: k1.flash_attention_fwd(q, k, v, ab, full, scale), iters=10, warmup=2)
            res["train_graph"] = graph_ms(lambda: k1.flash_attention_fwd(q, k, v, ab, full, scale), iters=10,
                                          replays=3)
            res["train_scalar"] = time_ms(lambda: k1._launch_fwd(q, k, v, ab, full, scale, True, False,
                                                                 _kernel=k1.KERNEL), iters=5, warmup=1)
            plain = time_ms(lambda: k1.flash_attention_ref(q, k, v, ab, full, scale, return_lse=True),
                            iters=3, warmup=1)
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), iters=5 if key == "train" else 20)
        bound = k1_bound_ms(b, h, t, d, 2 if dtype_name == "bf16" else 4, True, dtype_name,
                            with_lse=key == "train")
        res[key] = {"ms": kernel_ms, "plain_ms": plain, "sdpa_ms": sdpa, "bound": bound}
        print(
            f"K1 time {dtype_name} B,H,T,d={b},{h},{t},{d} ({'serving encoder, tensor-core kernel' if key == 'enc' else 'training decoder with lse, 3xTF32 tensor-core kernel'}): "
            f"kernel {kernel_ms:.4f} ms, plain {'-' if plain is None else f'{plain:.4f} ms'}, sdpa {sdpa:.4f} ms, "
            + (f"graph replay: kernel {res['enc_graph'][0]:.4f} ms, sdpa {res['enc_graph'][1]:.4f} ms, "
               if key == "enc" else
               f"graph replay {res['train_graph']:.4f} ms, the scalar kernel on the same inputs "
               f"{res['train_scalar']:.4f} ms, ")
            + f"bound {bound[0]:.4f} ms by {bound[1]} ({bound[2] / 1e6:.1f} MB, {bound[3] / 1e9:.2f} GFLOP"
            + (f"; on the CUDA cores {cuda_core_ms(bound[3]):.4f} ms" if key == "train" else "") + f"); {where}",
            flush=True,
        )
        del q, k, v, ab, mask
    return res


# ---------------------------------------------------------------------------
# K2 / K3: MAS Viterbi
# ---------------------------------------------------------------------------

def mas_cases(seed):
    """name -> (log_p_attn, text_lengths, feats_lengths) on the card."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def lattice(b, t_feats, t_text):
        return torch.log_softmax(torch.randn(b, t_feats, t_text, device="cuda", generator=g), -1)

    def lens(values):
        return torch.tensor(values, device="cuda")

    rng = np.random.default_rng(seed)
    b, t_feats, t_text = 16, 1024, 128  # lengths drawn as benchmarks/bench_mas_pallas.py draws them
    bench_tl = rng.integers(t_text // 2, t_text + 1, (b,)).tolist()
    bench_fl = rng.integers(t_feats // 2, t_feats + 1, (b,)).tolist()
    return {
        "16x1024x128": (lattice(b, t_feats, t_text), lens(bench_tl), lens(bench_fl)),
        # T_text not a multiple of 32: a ragged last ballot word
        "5x1000x77": (lattice(5, 1000, 77), lens([77, 33, 32, 31, 1]), lens([1000, 999, 500, 40, 77])),
        # text_len 1, feats_len 1, feats_len < text_len, zero-length rows
        "edges 6x24x8": (lattice(6, 24, 8), lens([1, 8, 8, 0, 5, 0]), lens([24, 1, 5, 0, 0, 9])),
        "one frame 3x1x4": (lattice(3, 1, 4), lens([1, 4, 0]), lens([1, 1, 0])),
        # multiples of 0.25: equal cells abound, so the tie rule decides
        "ties 4x300x200": ((lattice(4, 300, 200) * 4).round() / 4,
                           lens([200, 150, 5, 200]), lens([300, 300, 100, 200])),
        # the widest block (32 warps) and more frames than K3 stages at once
        "2x5000x1024": (lattice(2, 5000, 1024), lens([1024, 700]), lens([5000, 3000])),
        "2x9000x20": (lattice(2, 9000, 20), lens([20, 7]), lens([9000, 3000])),
    }


def check_mas(name, lp, tl, fl):
    """K2 against mas_decisions_ref, K3 (fed the twin's bits) against
    mas_backtrace_ref, the pair against mas_path_ref. Returns the three
    counts of differing elements and the largest |kernel - twin| of K2's
    decisions (0 or 1 a bit) and of K3's token indices; fails the run
    unless every count is 0."""
    import torch

    from jatts_torch.ops import mas

    t_text = lp.shape[2]
    bits = mas.mas_decisions(lp, tl)
    torch.cuda.synchronize()
    d_ref = mas.mas_decisions_ref(lp, tl)
    bits_ref = mas.pack_bits(d_ref)
    n_k2 = int((bits != bits_ref).sum())
    err_k2 = int((mas.unpack_bits(bits, t_text).int() - d_ref.int()).abs().max())
    path = mas.mas_backtrace(bits_ref, tl, fl, t_text)
    torch.cuda.synchronize()
    path_ref = mas.mas_backtrace_ref(d_ref, tl, fl)
    n_k3 = int((path != path_ref).sum())
    err_k3 = int((path - path_ref).abs().max())
    pair = mas.mas_path_cuda(lp, tl, fl)
    torch.cuda.synchronize()
    n_pair = int((pair != mas.mas_path_ref(lp, tl, fl)).sum())
    print(
        f"K2/K3 check {name} (B,T_feats,T_text={tuple(lp.shape)}): K2 {n_k2} of {bits.numel()} "
        f"words differ, K3 {n_k3} of {path.numel()} frames, pair {n_pair} of {pair.numel()} "
        f"frames (limit 0)", flush=True,
    )
    check(n_k2 == 0 and n_k3 == 0 and n_pair == 0, f"MAS kernels disagree with their twins at {name}")
    return (n_k2, n_k3, n_pair), (err_k2, err_k3)


def mas_bounds_ms(tl, fl, t_feats, t_text):
    """Least time for K2 and K3 by bytes, for these lengths. K2 needs lp
    only at tokens below text_len (the rest is masked) and writes every
    packed word; K3 needs the bits only of frames below feats_len (the
    rest is pinned) and writes every frame's index. The operations (a max,
    an add and a compare a needed cell) are far below."""
    b = tl.numel()
    n_words = (t_text + 31) // 32
    cells = int(tl.clamp(0, t_text).sum()) * t_feats
    frames = int(fl.clamp(0, t_feats).sum())
    k2_bytes = cells * 4 + b * 4 + b * t_feats * n_words * 4
    k3_bytes = frames * n_words * 4 + 2 * b * 4 + b * t_feats * 4
    k2_ops_ms = 3 * cells / PEAK_FLOPS_S["f32"] * 1e3
    k2_ms, k3_ms = k2_bytes / PEAK_BYTES_S * 1e3, k3_bytes / PEAK_BYTES_S * 1e3
    check(k2_ops_ms < k2_ms, "K2 bound: operations above bytes")
    return k2_ms, k2_bytes, k3_ms, k3_bytes


def time_mas(lp, tl, fl, where):
    """(K2 ms, K3 ms, plain K2 ms, plain K3 ms, K2 bound ms, K3 bound ms),
    the times by CUDA events."""
    from jatts_torch.ops import mas

    t_text = lp.shape[2]
    bits = mas.mas_decisions(lp, tl)
    k2_ms = time_ms(lambda: mas.mas_decisions(lp, tl))
    k3_ms = time_ms(lambda: mas.mas_backtrace(bits, tl, fl, t_text))
    d_ref = mas.unpack_bits(bits, t_text)
    k2_plain = time_ms(lambda: mas.mas_decisions_ref(lp, tl), iters=2, warmup=1)
    k3_plain = time_ms(lambda: mas.mas_backtrace_ref(d_ref, tl, fl), iters=2, warmup=1)
    b, t_feats, _ = lp.shape
    k2_bound, k2_bytes, k3_bound, k3_bytes = mas_bounds_ms(tl, fl, t_feats, t_text)
    steps = max(t_feats - 1, 1)
    print(
        f"K2 time f32 {b}x{t_feats}x{t_text}: kernel {k2_ms:.4f} ms ({k2_ms * 1e6 / steps:.1f} ns "
        f"per frame step), plain {k2_plain:.2f} ms, bound {k2_bound:.5f} ms by bytes "
        f"({k2_bytes / 1e6:.2f} MB at these lengths); {where}", flush=True,
    )
    print(
        f"K3 time {b}x{t_feats}x{t_text}: kernel {k3_ms:.4f} ms ({k3_ms * 1e6 / steps:.1f} ns "
        f"per frame step), plain {k3_plain:.2f} ms, bound {k3_bound:.5f} ms by bytes "
        f"({k3_bytes / 1e6:.2f} MB at these lengths); {where}", flush=True,
    )
    return k2_ms, k3_ms, k2_plain, k3_plain, k2_bound, k3_bound


# ---------------------------------------------------------------------------
# the aligner slice
# ---------------------------------------------------------------------------

ALIGN_CONFIG = {  # egs/jsut/tts1/conf/fastspeech2.v1.yaml, the feature settings
    "sampling_rate": 24000, "fft_size": 2048, "hop_size": 300, "win_length": None,
    "num_mels": 80, "fmin": 80, "fmax": 7600,
}
ALIGN_STEPS = 300


def write_tone_corpus(root, seed, n_utts=64, n_phones=40):
    """A corpus with a known alignment: each phone a distinct tone (the
    centre of every second mel filter), 20-100 phones an utterance, 4-12
    frames a phone, 60 ms of silence at both ends, no start/end crop yet.
    Returns (csv paths, {utt: frames per phone})."""
    import numpy as np

    from jatts_torch.ops.dsp import mel_filterbank
    from jatts_torch.utils.io import write_audio, write_csv

    sr, hop, n_fft = (ALIGN_CONFIG[k] for k in ("sampling_rate", "hop_size", "fft_size"))
    rng = np.random.default_rng(seed)
    phones = [f"p{i:02d}" for i in range(n_phones)]
    bank = mel_filterbank(sr, n_fft, ALIGN_CONFIG["num_mels"], ALIGN_CONFIG["fmin"], ALIGN_CONFIG["fmax"])
    centres = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)[bank.argmax(axis=1)]
    freqs = dict(zip(phones, centres[1::2]))
    check(len(freqs) == n_phones, "fewer mel filters than two a phone")
    sil = np.zeros(int(0.06 * sr), np.float32)
    rows, truth = [], {}
    for i in range(n_utts):
        utt = f"U{i:03d}"
        ph = rng.choice(phones, int(rng.integers(20, 101))).tolist()
        durs = rng.integers(4, 13, len(ph))
        segs = [sil] + [
            0.4 * np.sin(2 * np.pi * freqs[p] * np.arange(d * hop) / sr).astype(np.float32)
            for p, d in zip(ph, durs)
        ] + [sil]
        wav_path = str(Path(root) / "wav" / f"{utt}.wav")
        write_audio(wav_path, np.concatenate(segs), sr)
        rows.append({"sample_id": utt, "spk": "syn", "wav_path": wav_path, "start": "", "end": "",
                     "original_text": "x", "phonemes": " ".join(ph)})
        truth[utt] = durs
    n_dev = n_utts // 8
    paths = [str(Path(root) / "train.csv"), str(Path(root) / "dev.csv")]
    write_csv(rows[n_dev:], paths[0])
    write_csv(rows[:n_dev], paths[1])
    return paths, truth, freqs


def frame_accuracy(ds, durs):
    """Fraction of frames assigned to the right phone index."""
    import numpy as np

    pred = np.repeat(np.arange(len(ds)), ds)
    true = np.repeat(np.arange(len(durs)), durs)
    n = min(len(pred), len(true))
    return float(np.mean(pred[:n] == true[:n]))


def aligner_slice(seed, where, root):
    """Phase 8, on a corpus written under ``root`` (kept for phase 10).
    Returns (K2 launches, K3 launches) of the main-path run, what check_mas
    found on the run's own largest lattice, the csv paths and the phones'
    tone frequencies."""
    import numpy as np
    import torch

    from jatts_torch import aligner
    from jatts_torch.bin import align as align_cli
    from jatts_torch.losses.align import ForwardSumLoss
    from jatts_torch.ops import mas
    from jatts_torch.utils.io import read_audio, read_csv

    sr, hop = ALIGN_CONFIG["sampling_rate"], ALIGN_CONFIG["hop_size"]
    paths, truth, freqs = write_tone_corpus(root, seed)
    mas.reset_launches()
    t0 = time.perf_counter()
    out = align_cli.run(paths, ALIGN_CONFIG, str(Path(root) / "exp"), steps=ALIGN_STEPS, seed=seed)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k2_launches, k3_launches = mas.fwd_launches, mas.backtrace_launches
    check((Path(root) / "exp" / "aligner.pt").exists(), "aligner.pt was not saved")

    rows = [r for p in paths for r in read_csv(p, dict_reader=True)[0]]
    accs = []
    for row in rows:
        check(bool(row.get("durations")), f"{row['sample_id']}: no durations")
        got = np.asarray([int(d) for d in row["durations"].split()])
        check(len(got) == len(row["phonemes"].split()), f"{row['sample_id']}: one duration a phone")
        check(bool((got >= 1).all()), f"{row['sample_id']}: a duration below 1")
        wav, _ = read_audio(row["wav_path"], sr, row["start"], row["end"])
        check(int(got.sum()) == 1 + len(wav) // hop,
              f"{row['sample_id']}: durations sum {got.sum()} != 1 + {len(wav)} // {hop}")
        accs.append(frame_accuracy(got, truth[row["sample_id"]]))

    model, batches, items = out["model"], out["batches"], out["items"]
    fsum_hist = out["history"]["fsum"]
    n_batches = len(batches)
    shapes = sorted({(b["xs"].shape[0], b["ys"].shape[1], b["xs"].shape[1]) for b in batches})
    print(
        f"aligner: {len(items)} utterances in {n_batches} batches {shapes} (B, T_feats, T_text), "
        f"{ALIGN_STEPS} steps, whole run {run_s:.1f} s; K2 launches {k2_launches}, K3 launches "
        f"{k3_launches} (steps + dump batches = {ALIGN_STEPS + n_batches})", flush=True,
    )
    check(len(rows) == len(items) == 64 and out["n_skipped"] == 0, "rows were skipped")
    check(k2_launches > 0 and k3_launches > 0, "K2/K3 were not launched on the aligner path")
    check(k2_launches == ALIGN_STEPS + n_batches, f"K2 launches {k2_launches} != steps + dump batches")
    check(k3_launches == ALIGN_STEPS + n_batches, f"K3 launches {k3_launches} != steps + dump batches")
    check(all(math.isfinite(x) for x in out["history"]["loss"]), "a training loss is not finite")
    first, last = float(np.mean(fsum_hist[:4])), float(np.mean(fsum_hist[-4:]))
    print(f"aligner ForwardSum loss: first 4 steps {first:.4f}, last 4 steps {last:.4f}", flush=True)
    check(last < first, "the ForwardSum loss did not fall")
    acc = float(np.mean(accs))
    print(f"aligner frame accuracy against the known alignment: {acc:.3f} (limit 0.5)", flush=True)
    check(acc > 0.5, f"frame accuracy {acc}")

    # the same dump through the plain search
    model.mas_backend = "scan"
    scan_durations = aligner.dump_durations(model, batches, items)
    model.mas_backend = "auto"
    n_diff = sum(int((a != b).sum()) for a, b in zip(out["durations"], scan_durations))
    print(f"aligner dump, kernels vs mas_backend='scan': {n_diff} durations differ (limit 0)", flush=True)
    check(n_diff == 0, "durations differ between the kernels and the plain search")
    check((mas.fwd_launches, mas.backtrace_launches) == (k2_launches, k3_launches),
          "the plain search launched a kernel")

    # K2 and K3 against their twins at the main path's own largest shape
    big = max(batches, key=lambda b: b["ys"].shape[1] * b["xs"].shape[1])
    xs, ilens, ys, olens = aligner._batch_tensors(big, torch.device("cuda"))
    with torch.no_grad():
        lp = model(xs, ilens, ys, olens)["log_p_attn"]
    own_check = check_mas("aligner's largest batch", lp, ilens, olens)
    time_mas(lp, ilens, olens, where)

    # times: a dump batch, a training step, and the step's parts (each part
    # is timed on the host's clock; the optimizer runs at lr 0 so the weights stay)
    def host_ms(fn, iters=3):
        return time_ms(fn, iters=iters, warmup=1, host_clock=True)

    dump_ms = host_ms(lambda: aligner.dump_durations(model, batches, items))
    fsum = ForwardSumLoss()
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, weight_decay=1e-6)
    model.train()
    fwd_ms = host_ms(lambda: model(xs, ilens, ys, olens))
    fwd_out = model(xs, ilens, ys, olens)
    mas_ms = time_ms(lambda: mas.mas_path_cuda(fwd_out["log_p_attn"].detach(), ilens, olens))

    def ctc_loss():
        return fsum(fwd_out["log_p_attn"], ilens, olens) + fwd_out["bin_loss"]

    ctc_ms = host_ms(ctc_loss, iters=2)
    loss = ctc_loss()
    bwd_ms = host_ms(lambda: torch.autograd.grad(loss, list(model.parameters()), retain_graph=True), iters=2)

    def whole_step():
        o = model(xs, ilens, ys, olens)
        total = fsum(o["log_p_attn"], ilens, olens) + o["bin_loss"]
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()

    step_ms = host_ms(whole_step)
    opt_ms = host_ms(opt.step, iters=5)
    model.eval()
    print(
        f"aligner f32 adim 256, batch {tuple(ys.shape[:2])} frames x {xs.shape[1]} tokens: "
        f"training step {step_ms:.1f} ms = encoder+lattice+MAS forward {fwd_ms:.2f} ms "
        f"(K2+K3 {mas_ms:.4f} ms) + CTC loop forward {ctc_ms:.1f} ms + backward {bwd_ms:.1f} ms "
        f"+ optimizer {opt_ms:.2f} ms; dump {dump_ms / n_batches:.2f} ms per batch "
        f"({n_batches} batches); {where}", flush=True,
    )
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.train()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        whole_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    model.eval()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms > 0, "profile of one training step: the profiler saw no device time")
    print(
        f"profile of one training step: wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy_ms:.2f} ms in {sum(e.count for e in events)} kernels, idle share "
        f"{1 - busy_ms / wall_ms:.3f}", flush=True,
    )
    return k2_launches, k3_launches, own_check, paths, freqs


# ---------------------------------------------------------------------------
# K1-bwd: flash-attention backward
# ---------------------------------------------------------------------------

def k1bwd_inputs(b, h, t, d, dtype, with_bias, seed):
    """k1_inputs plus an output gradient."""
    import torch

    q, k, v, ab, key_mask, lens = k1_inputs(b, h, t, d, dtype, with_bias, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(b, h, t, d, device="cuda", generator=g).to(dtype)
    return q, k, v, ab, key_mask, do, lens


def check_k1bwd(b, h, t, d, dtype_name, with_bias, seed, against_autograd=False):
    """K1-bwd's four outputs against flash_attention_bwd_ref, both fed the
    plain forward's o and lse; K1's own lse against the plain one; rows with
    no valid key 0. Returns the largest |kernel - plain| over the outputs."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    q, k, v, ab, key_mask, do, lens = k1bwd_inputs(b, h, t, d, dtype, with_bias, seed)
    scale = d ** -0.5
    o, lse = k1.flash_attention_ref(q, k, v, ab, key_mask, scale, return_lse=True)
    _, lse_k = k1.flash_attention_fwd(q, k, v, ab, key_mask, scale)
    got = k1.flash_attention_bwd(q, k, v, ab, key_mask, scale, o, lse, do)
    torch.cuda.synchronize()

    def f32(x):
        return None if x is None else x.float()

    want = k1.flash_attention_bwd_ref(f32(q), f32(k), f32(v), f32(ab), key_mask, scale, f32(o), lse, f32(do))
    tol = TOL_BWD[dtype_name]
    errs, mags = {}, {}
    for name, g_, w in zip(("dq", "dk", "dv", "dab"), got, want):
        if w is None:
            check(g_ is None, "K1-bwd wrote d(ab) without a bias")
            continue
        check(bool(torch.isfinite(g_).all()), f"K1-bwd {name} not finite at {(b, h, t, d)}")
        mags[name] = max(1.0, w.abs().max().item())
        errs[name] = (g_.float() - w).abs().max().item()
        check(errs[name] <= tol * mags[name],
              f"K1-bwd {dtype_name} {(b, h, t, d)} {name} err {errs[name]} > {tol} x {mags[name]}")
    both_inf = torch.isinf(lse) & torch.isinf(lse_k)
    check(bool((torch.isinf(lse) == torch.isinf(lse_k)).all()), "K1 lse: +inf rows differ")
    lse_err = (lse_k - lse).masked_fill(both_inf, 0.0).abs().max().item()
    check(lse_err <= 1e-4 * max(1.0, lse.masked_fill(both_inf, 0).abs().max().item()), f"K1 lse err {lse_err}")
    for i, n in enumerate(lens):
        if n == 0:
            check(all(bool((x[i] == 0).all()) for x in got if x is not None),
                  "K1-bwd: a row with no valid key is not 0")
    line = ", ".join(f"{n} {errs[n]:.2e}" for n in errs)
    print(
        f"K1-bwd check {dtype_name} B,H,T,d={b},{h},{t},{d} bias={with_bias}: max_abs_err {line} "
        f"(tol {tol:.0e} x max(1, max|plain|) = {tol * max(mags.values()):.1e}); "
        f"K1 lse err {lse_err:.1e}; rows with no valid key: {lens.count(0)}", flush=True,
    )
    if against_autograd:
        leaves = [x.float().detach().requires_grad_() for x in (q, k, v, ab) if x is not None]
        args = leaves + ([None] if ab is None else [])
        out = k1.flash_attention_ref(*args, key_mask, scale)
        ag = torch.autograd.grad(out, leaves, do.float())
        ag_err = max((g_.float() - a).abs().max().item() for g_, a in zip(got, ag))
        print(f"K1-bwd vs autograd through the plain K1: max_abs_err {ag_err:.2e} "
              f"(tol {tol * max(mags.values()):.1e})", flush=True)
        check(ag_err <= tol * max(mags.values()), "K1-bwd disagrees with autograd of the plain K1")
    return max(errs.values())


def k1bwd_bounds_ms(b, h, t, d, elem, dtype_name):
    """Least times of the two K1-bwd kernels with a dense bias and every key
    valid: each input read once, each output written once; operations are
    the 2*T*T*d products each kernel does (dkv: scores again, dp, dv, dk;
    dq: scores again, dp, dq) on the tensor cores (:func:`ops_ms`: f32 as
    3xTF32)."""
    n = b * h * t * d * elem
    bias = b * h * t * t * elem
    rows = 2 * b * h * t * 4 + b * t  # lse, di, key mask
    dkv_bytes = 4 * n + bias + rows + 2 * n
    dq_bytes = 4 * n + bias + rows + n + bias
    out = []
    for nbytes, products in ((dkv_bytes, 4), (dq_bytes, 3)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        flops = 2 * products * b * h * t * t * d
        t_ops = ops_ms(flops, dtype_name)
        out.append((max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, flops))
    return out


def time_k1bwd(seed, where):
    """K1-bwd at the training decoder shape: the two kernels, the plain
    backward, SDPA forward+backward with a float bias that takes a gradient
    (the library yardstick), K1's forward with the log-sum-exp, bounds."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    b, h, t, d = 32, 2, 1024, 192
    q, k, v, ab, _, do, _ = k1bwd_inputs(b, h, t, d, torch.float32, True, seed)
    full = torch.ones(b, t, dtype=torch.bool, device="cuda")
    scale = d ** -0.5
    o, lse = k1.flash_attention_fwd(q, k, v, ab, full, scale)
    di = (o * do).sum(-1)
    fwd_ms = time_ms(lambda: k1.flash_attention_fwd(q, k, v, ab, full, scale), iters=10)
    dkv_ms = time_ms(lambda: k1.flash_attention_bwd_dkv(q, k, v, ab, full, scale, lse, di, do), iters=10)
    dq_ms = time_ms(lambda: k1.flash_attention_bwd_dq(q, k, v, ab, full, scale, lse, di, do), iters=10)
    plain_ms = time_ms(lambda: k1.flash_attention_bwd_ref(q, k, v, ab, full, scale, o, lse, do), iters=5, warmup=1)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    bias = (ab * scale).detach().requires_grad_()  # SDPA adds its mask after the scale

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias, scale=scale)
        torch.autograd.grad(out, (qs, ks, vs, bias), do)

    library_ms = time_ms(sdpa_fwd_bwd, iters=5, warmup=1)
    (dkv_bound, dkv_by, dkv_bytes, dkv_flops), (dq_bound, dq_by, dq_bytes, dq_flops) = k1bwd_bounds_ms(
        b, h, t, d, 4, "f32")
    print(
        f"K1-bwd time f32 B,H,T,d={b},{h},{t},{d} with bias: dkv kernel {dkv_ms:.4f} ms (bound "
        f"{dkv_bound:.4f} ms by {dkv_by}: {dkv_bytes / 1e6:.1f} MB, {dkv_flops / 1e9:.1f} GFLOP; on the CUDA "
        f"cores {cuda_core_ms(dkv_flops):.4f} ms), dq kernel {dq_ms:.4f} ms (bound {dq_bound:.4f} ms by {dq_by}: "
        f"{dq_bytes / 1e6:.1f} MB, {dq_flops / 1e9:.1f} GFLOP; on the CUDA cores {cuda_core_ms(dq_flops):.4f} "
        f"ms); plain backward {plain_ms:.4f} ms; sdpa forward+backward "
        f"{library_ms:.4f} ms; K1 forward with lse {fwd_ms:.4f} ms; {where}", flush=True,
    )
    return {"dkv": (dkv_ms, dkv_bound, dkv_by, cuda_core_ms(dkv_flops)),
            "dq": (dq_ms, dq_bound, dq_by, cuda_core_ms(dq_flops)),
            "plain_ms": plain_ms, "library_ms": library_ms, "fwd_ms": fwd_ms}


# ---------------------------------------------------------------------------
# K1b: the causal form of K1 and K1-bwd
# ---------------------------------------------------------------------------

# VALL-E AR's attention (egs/hificaptain_jp_female/tts3/conf/valle_ar.given.bs32.yaml:
# d_model 1024, 16 heads, batch 16; the packed length of phase 12's corpus)
VALLE_ATTN = (16, 16, 1088, 64)


def k1b_cases():
    """(name, (B, H, T, d), dtype, with bias, key mask rows as (first valid
    key, number of valid keys) cycled over the batch)."""
    b, h, t, d = VALLE_ATTN
    ragged = [(0, t), (0, t - 1), (0, 900), (0, 611), (0, 1), (0, 64), (0, 65), (0, 1000)]
    return [
        ("VALL-E shape", (b, h, t, d), "bf16", False, ragged),
        ("f32", (4, 4, 512, 64), "f32", False, [(0, 512), (0, 300), (0, 33), (0, 129)]),
        # T ends inside a diagonal tile (1000 = 15 x 64 + 40; 31 x 32 + 8)
        ("ragged T", (3, 2, 1000, 64), "f32", False, [(0, 1000), (0, 999), (0, 517)]),
        ("ragged T bf16", (3, 2, 1000, 64), "bf16", False, [(0, 1000), (0, 999), (0, 517)]),
        ("T=1", (2, 2, 1, 64), "f32", False, [(0, 1), (0, 0)]),
        ("T=1 bf16", (2, 2, 1, 64), "bf16", False, [(0, 1), (0, 0)]),
        ("d=192 bias", (2, 2, 300, 192), "f32", True, [(0, 300), (0, 250)]),
        ("d=192 bias bf16", (2, 2, 300, 192), "bf16", True, [(0, 300), (0, 250)]),
        # rows 0..36 of the second item see no valid key (its keys start at 37),
        # the third sees none at all
        ("rows without a key", (3, 2, 200, 64), "f32", False, [(0, 200), (37, 100), (0, 0)]),
        ("rows without a key bf16", (3, 2, 200, 64), "bf16", False, [(0, 200), (37, 100), (0, 0)]),
    ]


def k1b_inputs(shape, dtype, with_bias, rows, seed):
    import torch

    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, t, d, device="cuda", generator=g).to(dtype) for _ in range(4))
    ab = (torch.randn(b, h, t, t, device="cuda", generator=g) * math.sqrt(d)).to(dtype) if with_bias else None
    pos = torch.arange(t, device="cuda")
    key_mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in (rows * b)[:b]])
    return q, k, v, ab, key_mask, do


def k1b_on_tc(dtype_name, d, with_bias):
    """Which K1b kernels a form takes on the card: (forward, dk/dv, dq) on
    the tensor cores — the forward in bf16, dk/dv and dq in VALL-E's form
    (bf16, d 64, no bias)."""
    bf16 = dtype_name == "bf16"
    valle = bf16 and d == 64 and not with_bias
    return bf16, valle, valle


def item_err(got, want):
    """The worst batch item's max |got - want| over max(1, max|want|) of
    that item. Each item is held to its own magnitude: key 0 of an item
    with one valid key collects every row's dO (|dv| ~ 110 at VALL-E's
    shape), which a tolerance over the whole tensor would lend to the
    other items, whose gradients are ~0.1."""
    err = (got.float() - want.float()).flatten(1).abs().amax(1)
    return (err / want.float().flatten(1).abs().amax(1).clamp_min(1.0)).max().item()


def check_k1b(name, shape, dtype_name, with_bias, rows, seed, against_autograd=False):
    """The three causal kernels against flash_attention_ref /
    flash_attention_bwd_ref(causal=True) on the same inputs (the backward
    fed the plain forward's o and lse), each output within its tolerance
    of every batch item's own max(1, max|plain|) (item_err), K1b's lse
    against the plain one, rows that see no key 0 in the output and dq,
    keys that no row sees 0 in dk and dv, and each launch on the kernel the
    dispatch rules give the form (the tensor-core forward for bf16, the
    tensor-core dk/dv and dq for bf16 at d 64 without bias). Returns the largest
    |kernel - plain| of each output ("fwd", "dq", "dk", "dv")."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    q, k, v, ab, key_mask, do = k1b_inputs(shape, dtype, with_bias, rows, seed)
    d = shape[3]
    scale = d ** -0.5

    def f32(x):
        return None if x is None else x.float()

    def counts():
        return (k1.launches_tc, k1.launches_bwd_dkv_tc, k1.launches_bwd_dq_tc, k1.launches_causal,
                k1.launches_bwd_dkv_causal, k1.launches_bwd_dq_causal)

    before = counts()
    out_k, lse_k = k1.flash_attention_fwd(q, k, v, ab, key_mask, scale, causal=True)
    out_nolse = k1.flash_attention(q, k, v, ab, key_mask, scale, causal=True)
    o, lse = k1.flash_attention_ref(f32(q), f32(k), f32(v), f32(ab), key_mask, scale,
                                    return_lse=True, causal=True)
    got = k1.flash_attention_bwd(q, k, v, ab, key_mask, scale, o.to(dtype), lse, do, causal=True)
    torch.cuda.synchronize()
    ran = tuple(a - b for a, b in zip(counts(), before))
    tc_fwd, tc_dkv, tc_dq = k1b_on_tc(dtype_name, d, with_bias)
    check(ran == (2 * tc_fwd, int(tc_dkv), int(tc_dq), 2, 1, 1),
          f"K1b {name}: launches (tc forward, tc dk/dv, tc dq, causal forward, causal dk/dv, causal dq) {ran}")
    want = k1.flash_attention_bwd_ref(f32(q), f32(k), f32(v), f32(ab), key_mask, scale, o, lse,
                                      f32(do), causal=True)
    check(bool(torch.equal(out_k, out_nolse)), f"K1b {name}: the forward with and without lse differ")
    fwd_err = (out_k.float() - o).abs().max().item()
    rel = {"fwd": item_err(out_k, o)}
    check(math.isfinite(fwd_err) and rel["fwd"] <= TOL[dtype_name],
          f"K1b {name} forward err {rel['fwd']} x max(1, max|plain| of its item) > {TOL[dtype_name]}")
    seen_none = torch.isinf(lse)
    check(bool(torch.equal(seen_none, torch.isinf(lse_k))), f"K1b {name}: +inf lse rows differ")
    lse_err = (lse_k - lse).masked_fill(seen_none, 0.0).abs().max().item()
    check(lse_err <= 1e-4 * max(1.0, lse.masked_fill(seen_none, 0).abs().max().item()),
          f"K1b {name} lse err {lse_err}")
    tol = TOL_BWD[dtype_name]
    errs = {"fwd": fwd_err}
    for gname, g_, w in zip(("dq", "dk", "dv", "dab"), got, want):
        if w is None:
            check(g_ is None, "K1b wrote d(ab) without a bias")
            continue
        check(bool(torch.isfinite(g_).all()), f"K1b {name} {gname} not finite")
        errs[gname] = (g_.float() - w).abs().max().item()
        rel[gname] = item_err(g_, w)
        check(rel[gname] <= tol,
              f"K1b {name} {gname} err {rel[gname]} x max(1, max|plain| of its item) > {tol}")
    # rows that see no key: output and dq exactly 0; keys that no row sees
    # (causal: a valid key j is seen by row j, so the masked ones): dk, dv 0
    zero_rows = seen_none[..., None].expand_as(out_k)
    check(bool((out_k[zero_rows] == 0).all()) and bool((got[0][zero_rows] == 0).all()),
          f"K1b {name}: a row that sees no key is not 0")
    unseen = ~key_mask[:, None, :, None].expand_as(got[1])
    check(bool((got[1][unseen] == 0).all()) and bool((got[2][unseen] == 0).all()),
          f"K1b {name}: dk or dv of a key that no row sees is not 0")
    line = ", ".join(f"{n} {errs[n]:.2e} ({rel[n]:.2e})" for n in errs)
    print(
        f"K1b check {name} {dtype_name} B,H,T,d={','.join(map(str, shape))} bias={with_bias} (forward on "
        f"{'tensor cores' if tc_fwd else 'CUDA cores'}, dk/dv and dq on "
        f"{'tensor cores' if tc_dkv else 'CUDA cores'}): "
        f"max_abs_err (worst item's over max(1, max|plain| of the item)) {line}; tol {TOL[dtype_name]:.0e} "
        f"forward, {tol:.0e} backward; lse err {lse_err:.1e}; rows that see no key {int(seen_none.sum())}, "
        f"keys that no row sees {int((~key_mask).sum()) * shape[1]}", flush=True,
    )
    if against_autograd:
        leaves = [x.float().detach().requires_grad_() for x in (q, k, v)]
        out = k1.flash_attention_ref(*leaves, f32(ab), key_mask, scale, causal=True)
        ag = torch.autograd.grad(out, leaves, do.float())
        ag_rel = max(item_err(g_, a) for g_, a in zip(got, ag))
        print(f"K1b backward vs autograd through the plain causal forward: worst item's max_abs_err over "
              f"max(1, max|plain| of the item) {ag_rel:.2e} (tol {tol:.0e})", flush=True)
        check(ag_rel <= tol, "K1b backward disagrees with autograd")
    return errs


def check_k1b_chain(shape, rows, seed):
    """The autograd chain of VALL-E's attention in bf16: FlashAttention (the
    tensor-core forward, whose output and lse feed the tensor-core dk/dv and
    dq) forward and backward, against autograd through the plain
    causal forward in f32 on the same inputs. The output within TOL["bf16"]
    and each gradient within TOL_BWD["bf16"] of every batch item's own
    max(1, max|plain|) (item_err). Returns the largest |kernel - plain| of
    the output and of dq, dk, dv."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    q, k, v, _, key_mask, do = k1b_inputs(shape, torch.bfloat16, False, rows, seed)
    scale = shape[3] ** -0.5
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = (k1.launches_tc, k1.launches_bwd_dkv_tc, k1.launches_bwd_dq_tc)
    out = k1.flash_attention(*leaves, None, key_mask, scale, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    ran = tuple(a - b for a, b in zip((k1.launches_tc, k1.launches_bwd_dkv_tc, k1.launches_bwd_dq_tc), before))
    check(ran == (1, 1, 1), f"K1b autograd chain: launches (tc forward, tc dk/dv, tc dq) {ran} != (1, 1, 1)")
    ref_leaves = [x.float().detach().requires_grad_() for x in (q, k, v)]
    ref = k1.flash_attention_ref(*ref_leaves, None, key_mask, scale, causal=True)
    want = torch.autograd.grad(ref, ref_leaves, do.float())
    errs, parts = {}, []
    for gname, g_, w, tol in zip(("fwd", "dq", "dk", "dv"), (out.detach(), *got), (ref.detach(), *want),
                                 (TOL["bf16"], *[TOL_BWD["bf16"]] * 3)):
        errs[gname] = (g_.float() - w).abs().max().item()
        rel = item_err(g_, w)
        parts.append(f"{gname} {errs[gname]:.2e} ({rel:.2e}, tol {tol:.0e})")
        check(math.isfinite(errs[gname]) and rel <= tol,
              f"K1b autograd chain: {gname} err {rel} x max(1, max|plain| of its item) > {tol}")
    print(f"K1b autograd chain bf16 B,H,T,d={','.join(map(str, shape))} (FlashAttention forward + backward vs "
          f"autograd through the plain causal forward in f32): max_abs_err (worst item's over max(1, max|plain| "
          f"of the item)) " + ", ".join(parts), flush=True)
    return errs


def k1b_bounds_ms(b, h, t, d, elem, dtype_name="bf16"):
    """Least times of the three causal kernels with every key valid, on the
    tensor cores (:func:`ops_ms`: f32 as 3xTF32): the forward
    needs the causal half of 2 products (4·B·H·T²·d/2 FLOP), the backward
    2.5x that (dk/dv: the scores again, dp, dv, dk; dq: the scores again,
    dp, dq; split 4:3 as the two kernels do them). Bytes: each input read
    once, each output written once (q, k, v, o, do, dq, dk, dv in the
    working type; lse, di f32; the key mask)."""
    n = b * h * t * d * elem
    rows = b * h * t * 4
    half = b * h * t * t * d  # 2 products' worth over the causal half = 2 * (2·T²·d / 2)
    out = {}
    for name, nbytes, flops in (
        ("fwd", 4 * n + rows + b * t, 2 * half),
        ("dkv", 6 * n + 2 * rows + b * t, 4 * half),
        ("dq", 5 * n + 2 * rows + b * t, 3 * half),
    ):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops_ms(flops, dtype_name)
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)
    return out


def sdpa_choice(q, k, v, **kwargs):
    """The name of the SDPA backend PyTorch's dispatcher picks for these
    inputs, or "unknown" where this PyTorch does not say."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, **kwargs)).name
    except Exception:  # a private entry point: its absence only costs the name
        return "unknown"


def time_k1b(seed, where):
    """K1b at VALL-E's shape, every key valid. bf16, the main path's
    kernels (the tensor-core forward, dk/dv and dq), by CUDA events and
    replayed from a CUDA graph; beside the plain versions, two SDPA
    yardsticks (never used by the port) — a boolean causal ∧ key-padding
    mask, and ``is_causal=True`` without a mask (the same function with
    every key valid), each forward alone and forward + backward, with the
    backend the dispatcher picks — the bounds, and the scalar dq's bf16
    form, which the main path no longer takes, called through its C entry
    on the same inputs. Then the scalar forward, dk/dv and dq, which VALL-E's
    bf16 form no longer takes, in f32 beside their plain versions, SDPA with
    the boolean mask and the f32 bounds."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, t, d = VALLE_ATTN
    q, k, v, _, key_mask, do = k1b_inputs(VALLE_ATTN, torch.bfloat16, False, [(0, t)], seed)
    scale = d ** -0.5
    o, lse = k1.flash_attention_fwd(q, k, v, None, key_mask, scale, causal=True)
    di = (o.float() * do.float()).sum(-1)

    def fwd():
        return k1.flash_attention_fwd(q, k, v, None, key_mask, scale, causal=True)

    def dkv():
        return k1.flash_attention_bwd_dkv(q, k, v, None, key_mask, scale, lse, di, do, causal=True)

    def dq():
        return k1.flash_attention_bwd_dq(q, k, v, None, key_mask, scale, lse, di, do, causal=True)

    res = {"fwd": time_ms(fwd), "fwd_graph": graph_ms(fwd), "dkv": time_ms(dkv), "dkv_graph": graph_ms(dkv),
           "dq": time_ms(dq), "dq_graph": graph_ms(dq)}
    # the scalar dq on the same bf16 inputs, the kernel the tensor-core dq
    # replaced on VALL-E's path (its C entry directly: no wrapper, no count)
    scalar_dq = k1._bwd_kernel_fn(k1.KERNEL_BWD, "jatts_flash_attn_bwd_dq")
    dq_scalar_out = torch.empty_like(q)

    def dq_scalar():
        rc = scalar_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, key_mask.data_ptr(), lse.data_ptr(),
                       di.data_ptr(), do.data_ptr(), dq_scalar_out.data_ptr(), None, b, h, t, t, d, d, 1, 1,
                       scale, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the scalar bf16 dq refused its launch ({rc})")

    res["dq_scalar_bf16"] = time_ms(dq_scalar, iters=10)
    dq_err = item_err(dq()[0], dq_scalar_out)
    check(dq_err <= TOL_BWD["bf16"], f"K1b dq: tensor-core and scalar bf16 dq differ by {dq_err}")
    # the non-causal form on the same queries with the first 64, 576 and all
    # 1088 keys: 1, 9 and 17 key tiles in every one of the same 17 x B*H
    # blocks. The causal call does 153 = 17 x 9 tile pairs a head, the 9-tile
    # call's work over the same blocks: if the causal form were slow only
    # for its short blocks, the two would take the same time. A line through
    # the three splits a block's time into a fixed part and a part a tile.
    res["fwd_tiles_graph"] = {}
    for n in (1, 9, 17):
        kk, vv = k[:, :, :64 * n].contiguous(), v[:, :, :64 * n].contiguous()
        mk = key_mask[:, :64 * n].contiguous()
        res["fwd_tiles_graph"][n] = graph_ms(lambda: k1.flash_attention_fwd(q, kk, vv, None, mk, scale))  # noqa: B023
    res["fwd_full_graph"] = res["fwd_tiles_graph"][17]
    per_tile, fixed = statistics.linear_regression(list(res["fwd_tiles_graph"]),
                                                   list(res["fwd_tiles_graph"].values()))
    res["fwd_fit"] = {"fixed_ms": fixed, "per_tile_ms": per_tile}
    res["plain_fwd_ms"] = time_ms(lambda: k1.flash_attention_ref(q, k, v, None, key_mask, scale, causal=True),
                                  iters=3, warmup=1)
    res["plain_bwd_ms"] = time_ms(lambda: k1.flash_attention_bwd_ref(q, k, v, None, key_mask, scale, o, lse, do,
                                                                     causal=True), iters=3, warmup=1)
    mask = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None] & key_mask[:, None, None, :]
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    for key, kwargs in (("sdpa_mask", {"attn_mask": mask}), ("sdpa_causal", {"is_causal": True})):
        res[f"{key}_backend"] = sdpa_choice(q, k, v, scale=scale, **kwargs)
        res[f"{key}_fwd_ms"] = time_ms(lambda: sdpa(q, k, v, scale=scale, **kwargs))
        res[f"{key}_fwd_graph_ms"] = graph_ms(lambda: sdpa(q, k, v, scale=scale, **kwargs))

        def fwd_bwd():
            torch.autograd.grad(sdpa(qs, ks, vs, scale=scale, **kwargs), (qs, ks, vs), do)

        res[f"{key}_ms"] = time_ms(fwd_bwd, iters=10, warmup=2)
    res["bounds"] = k1b_bounds_ms(b, h, t, d, 2, "bf16")
    parts = "; ".join(
        f"{n} kernel {res[n]:.4f} ms{graph} (bound {res['bounds'][n][0]:.4f} ms by {res['bounds'][n][1]}: "
        f"{res['bounds'][n][2] / 1e6:.1f} MB, {res['bounds'][n][3] / 1e9:.1f} GFLOP)"
        for n, graph in (("fwd", f", graph {res['fwd_graph']:.4f} ms (non-causal on the same queries with "
                                 + ", ".join(f"{m} key tiles a block {ms:.4f} ms"
                                             for m, ms in res["fwd_tiles_graph"].items())
                                 + f": {res['fwd_fit']['fixed_ms']:.4f} ms + {res['fwd_fit']['per_tile_ms']:.5f} "
                                 f"ms a tile; causal / 9 tiles {res['fwd_graph'] / res['fwd_tiles_graph'][9]:.3f}x"
                                 "), tensor cores"),
                         ("dkv", f", graph {res['dkv_graph']:.4f} ms, tensor cores"),
                         ("dq", f", graph {res['dq_graph']:.4f} ms, tensor cores; the scalar bf16 dq on the same "
                                f"inputs {res['dq_scalar_bf16']:.4f} ms, worst item's difference {dq_err:.2e}"))
    )
    yard = "; ".join(
        f"sdpa {label} ({res[f'{key}_backend']}) forward {res[f'{key}_fwd_ms']:.4f} ms (graph "
        f"{res[f'{key}_fwd_graph_ms']:.4f} ms), forward+backward {res[f'{key}_ms']:.4f} ms"
        for key, label in (("sdpa_mask", "bool causal & key mask"), ("sdpa_causal", "is_causal, no mask")))
    print(
        f"K1b time bf16 causal B,H,T,d={b},{h},{t},{d}, every key valid: {parts}; plain forward "
        f"{res['plain_fwd_ms']:.4f} ms, plain backward {res['plain_bwd_ms']:.4f} ms; {yard}; {where}", flush=True,
    )
    del q, k, v, do, o, lse, di, qs, ks, vs, dq_scalar_out
    # the scalar forward, dk/dv and dq, f32 only on VALL-E's path now
    q, k, v, _, key_mask, do = k1b_inputs(VALLE_ATTN, torch.float32, False, [(0, t)], seed)
    o, lse = k1.flash_attention_fwd(q, k, v, None, key_mask, scale, causal=True)
    di = (o * do).sum(-1)
    f32 = {"fwd": time_ms(lambda: k1.flash_attention_fwd(q, k, v, None, key_mask, scale, causal=True),
                          iters=5, warmup=1),
           "dkv": time_ms(lambda: k1.flash_attention_bwd_dkv(q, k, v, None, key_mask, scale, lse, di, do,
                                                             causal=True), iters=5, warmup=1),
           "dq": time_ms(lambda: k1.flash_attention_bwd_dq(q, k, v, None, key_mask, scale, lse, di, do,
                                                           causal=True), iters=5, warmup=1)}
    f32["plain_fwd_ms"] = time_ms(lambda: k1.flash_attention_ref(q, k, v, None, key_mask, scale, causal=True),
                                  iters=3, warmup=1)
    f32["plain_bwd_ms"] = time_ms(lambda: k1.flash_attention_bwd_ref(q, k, v, None, key_mask, scale, o, lse, do,
                                                                     causal=True), iters=3, warmup=1)
    f32["sdpa_fwd_ms"] = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), iters=5, warmup=1)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    f32["sdpa_ms"] = time_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs, attn_mask=mask, scale=scale),
                                                         (qs, ks, vs), do), iters=3, warmup=1)
    f32["bounds"] = k1b_bounds_ms(b, h, t, d, 4, "f32")
    print(
        f"K1b time f32 causal B,H,T,d={b},{h},{t},{d} (the scalar kernels): "
        + "; ".join(f"{n} kernel {f32[n]:.4f} ms (bound {f32['bounds'][n][0]:.4f} ms by {f32['bounds'][n][1]}; "
                    f"on the CUDA cores {cuda_core_ms(f32['bounds'][n][3]):.4f} ms)" for n in ("fwd", "dkv", "dq"))
        + f"; plain forward {f32['plain_fwd_ms']:.4f} ms, plain backward {f32['plain_bwd_ms']:.4f} ms; sdpa "
        f"(bool causal & key mask) forward {f32['sdpa_fwd_ms']:.4f} ms, forward+backward {f32['sdpa_ms']:.4f} ms; "
        f"{where}", flush=True,
    )
    res["f32"] = f32
    return res


def k1b_phase(seed, where):
    """Phase 11: every K1b case, the bf16 autograd chain at VALL-E's shape,
    then the times. Returns the largest errors of each output, by the
    kernel that computed it ("fwd_tc", "fwd", "dkv_tc", "dkv", "dq_tc",
    "dq"), and the times."""
    errs = dict.fromkeys(("fwd_tc", "fwd", "dkv_tc", "dkv", "dq_tc", "dq"), 0.0)
    for i, (name, shape, dtype_name, with_bias, rows) in enumerate(k1b_cases()):
        e = check_k1b(name, shape, dtype_name, with_bias, rows, seed + i, against_autograd=(name == "f32"))
        merge_k1b_errs(errs, e, *k1b_on_tc(dtype_name, shape[3], with_bias))
    b, h, t, d = VALLE_ATTN
    chain = check_k1b_chain(VALLE_ATTN, [(0, t), (0, t - 1), (0, 900), (0, 611), (0, 1), (0, 64), (0, 65), (0, 1000)],
                            seed + 50)
    merge_k1b_errs(errs, chain, True, True, True)
    return errs, time_k1b(seed + 100, where)


def merge_k1b_errs(errs, e, tc_fwd, tc_dkv, tc_dq):
    """Fold one check's errors into the per-kernel maxima of k1b_phase."""
    fk, dk, qk = ("fwd_tc" if tc_fwd else "fwd"), ("dkv_tc" if tc_dkv else "dkv"), ("dq_tc" if tc_dq else "dq")
    errs[fk] = max(errs[fk], e["fwd"])
    errs[dk] = max(errs[dk], e["dk"], e["dv"])
    errs[qk] = max(errs[qk], e["dq"])


# ---------------------------------------------------------------------------
# K1r: the fused rel-pos form of K1 and K1-bwd (d_qk != d_v)
# ---------------------------------------------------------------------------

# the latest rel-pos attention at the JVS/JSUT width (adim 384, 2 heads):
# d_qk = d_k + n_feat = 192 + 384, d_v = d_k = 192
K1R_DIMS = (576, 192)
K1R_TRAIN = (32, 2, 1024)  # the training decoder: batch 32, <= 1024 frames, f32
K1R_SERVE = (8, 2, 1024)  # the serving decoder: batch 8, 1024 frames, bf16


def k1r_cases():
    """(name, (B, H, T) or (B, H, Tq, Tk), (d_qk, d_v), dtype, key mask rows
    as (first valid key, number of valid keys) cycled over the batch)."""
    b, h, t = K1R_SERVE
    ragged = [(0, t), (0, t - 1), (0, 900), (0, 611), (0, 1), (0, 64), (0, 65), (0, 1000)]
    small = [(0, 300), (0, 250), (0, 1), (0, 77)]
    return [
        ("serving decoder", (b, h, t), K1R_DIMS, "bf16", ragged),
        ("f32", (4, 2, 512), K1R_DIMS, "f32", [(0, 512), (0, 300), (0, 33), (0, 129)]),
        ("small pair", (4, 2, 300), (192, 64), "f32", small),
        ("small pair bf16", (4, 2, 300), (192, 64), "bf16", small),
        # T ends inside a tile (1000 = 15 x 64 + 40 = 31 x 32 + 8)
        ("ragged T", (3, 2, 1000), K1R_DIMS, "f32", [(0, 1000), (0, 999), (0, 517)]),
        ("T=1", (2, 2, 1), K1R_DIMS, "f32", [(0, 1), (0, 0)]),
        # the second item's keys start at 37, the third has no valid key
        ("rows without a key", (3, 2, 200), K1R_DIMS, "f32", [(0, 200), (37, 100), (0, 0)]),
        # Tq != Tk both ways, each ending inside a tile
        ("Tq != Tk", (2, 2, 70, 203), K1R_DIMS, "f32", [(0, 203), (64, 65)]),
        ("Tq != Tk small pair", (2, 2, 203, 70), (192, 64), "f32", [(0, 70), (5, 40)]),
        # valid keys from inside a 64-key tile: 100..249 (the first key tile
        # has none), 70..99
        ("keys from inside a tile", (3, 2, 300), K1R_DIMS, "f32", [(0, 300), (100, 150), (70, 30)]),
    ]


def k1r_inputs(shape, dims, dtype, rows, seed):
    import torch

    b, h, tq, tk = shape if len(shape) == 4 else (*shape, shape[-1])
    d_qk, d_v = dims
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, tq, d_qk, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, h, tk, d_qk, device="cuda", generator=g).to(dtype)
    v = torch.randn(b, h, tk, d_v, device="cuda", generator=g).to(dtype)
    do = torch.randn(b, h, tq, d_v, device="cuda", generator=g).to(dtype)
    pos = torch.arange(tk, device="cuda")
    key_mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in (rows * b)[:b]])
    return q, k, v, key_mask, do


def _tc_f32_bwd_launches():
    from jatts_torch.ops import flash_attention as k1

    return (k1.launches_bwd_dkv_tc_f32, k1.launches_bwd_dq_tc_f32)


def check_k1r(name, shape, dims, dtype_name, rows, seed, against_autograd=False):
    """The three K1r kernels against flash_attention_ref /
    flash_attention_bwd_ref on the same inputs (the backward fed the plain
    forward's o and lse), the kernel's lse against the plain one, rows that
    see no key exactly 0 in the output and dq, keys that no row sees exactly
    0 in dk and dv, each output within its tolerance of every batch item's
    own max(1, max|plain|) (item_err), and each launch on the kernel the
    dispatch rules give the form: the forward on the tensor cores (bf16) or
    the 3xTF32 kernel (f32), the f32 dk/dv and dq on the 3xTF32 tensor-core
    kernels (each of their counters one up with its ``_relpos`` one), the
    bf16 ones on the scalar kernels. In f32 also the backward's bits from run
    to run and for item 1 alone, and the scalar dk/dv and dq on the same
    inputs. Returns the largest |kernel - plain| of the forward, of the
    backward, and of the scalar backward (f32; None in bf16, where the
    backward is the scalar one)."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    q, k, v, key_mask, do = k1r_inputs(shape, dims, dtype, rows, seed)
    scale = dims[1] ** -0.5  # 1/sqrt(d_k), as the attention layer passes it
    before = _legacy_launches()
    counter = "launches_tc_f32" if dtype_name == "f32" else "launches_tc"
    tc_before, relpos_before, bwd_tc_before = getattr(k1, counter), _relpos_launches(), _tc_f32_bwd_launches()
    out_k, lse_k = k1.flash_attention_fwd(q, k, v, None, key_mask, scale)
    out_nolse = k1.flash_attention(q, k, v, None, key_mask, scale)
    o, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(), None, key_mask, scale, return_lse=True)
    got = k1.flash_attention_bwd(q, k, v, None, key_mask, scale, o.to(dtype), lse, do)
    torch.cuda.synchronize()
    check(_legacy_launches() == before, f"K1r {name}: a d_qk == d_v kernel launched")
    check(getattr(k1, counter) - tc_before == 2, f"K1r {name}: the forward missed its tensor-core kernel ({counter})")
    relpos = tuple(a - b for a, b in zip(_relpos_launches(), relpos_before))
    bwd_tc = tuple(a - b for a, b in zip(_tc_f32_bwd_launches(), bwd_tc_before))
    on_tc = dtype_name == "f32"
    check(relpos == (2, 1, 1) and bwd_tc == ((1, 1) if on_tc else (0, 0)),
          f"K1r {name}: launches (relpos forward, dk/dv, dq) {relpos}, on the 3xTF32 dk/dv and dq {bwd_tc}")
    want = k1.flash_attention_bwd_ref(q.float(), k.float(), v.float(), None, key_mask, scale, o, lse, do.float())
    check(bool(torch.equal(out_k, out_nolse)), f"K1r {name}: the forward with and without lse differ")
    tol = TOL_K1R[dtype_name]
    abs_errs = {"out": (out_k.float() - o).abs().max().item()}
    errs = {"out": item_err(out_k, o)}
    for gname, g_, w, width in zip(("dq", "dk", "dv"), got, want, (dims[0], dims[0], dims[1])):
        check(g_.shape[-1] == width and bool(torch.isfinite(g_).all()), f"K1r {name} {gname}")
        abs_errs[gname] = (g_.float() - w).abs().max().item()
        errs[gname] = item_err(g_, w)
    check(got[3] is None, f"K1r {name}: a d(ab) without a bias")
    for gname, e in errs.items():
        check(math.isfinite(e) and e <= tol,
              f"K1r {name} {dtype_name} {gname} err {e} x max(1, max|plain| of its item) > {tol}")
    seen_none = torch.isinf(lse)
    check(bool(torch.equal(seen_none, torch.isinf(lse_k))), f"K1r {name}: +inf lse rows differ")
    lse_err = (lse_k - lse).masked_fill(seen_none, 0.0).abs().max().item()
    check(lse_err <= 1e-4 * max(1.0, lse.masked_fill(seen_none, 0).abs().max().item()),
          f"K1r {name} lse err {lse_err}")
    zero_rows = seen_none[..., None]
    check(bool((out_k.masked_select(zero_rows) == 0).all()) and bool((got[0].masked_select(zero_rows) == 0).all()),
          f"K1r {name}: a row that sees no key is not 0")
    unseen = ~key_mask[:, None, :, None]
    check(bool((got[1].masked_select(unseen) == 0).all()) and bool((got[2].masked_select(unseen) == 0).all()),
          f"K1r {name}: dk or dv of a key that no row sees is not 0")
    extra, scalar_err = "", None
    if on_tc:
        # no atomics: the same bits on a second run and for item 1 alone
        di = (o * do.float()).sum(-1)
        again = (*k1.flash_attention_bwd_dkv(q, k, v, None, key_mask, scale, lse, di, do),
                 k1.flash_attention_bwd_dq(q, k, v, None, key_mask, scale, lse, di, do)[0])
        one = [x[1:2].contiguous() for x in (q, k, v, key_mask, lse, di, do)]
        alone = (*k1.flash_attention_bwd_dkv(*one[:3], None, one[3], scale, *one[4:]),
                 k1.flash_attention_bwd_dq(*one[:3], None, one[3], scale, *one[4:])[0])
        # the scalar kernels on the same inputs
        scalar = (torch.empty_like(k), torch.empty_like(v), torch.empty_like(q))
        k1._launch_bwd("dkv", q, k, v, None, key_mask, scale, lse, di, do, scalar[0], scalar[1], False,
                       _lib=k1.KERNEL_BWD)
        k1._launch_bwd("dq", q, k, v, None, key_mask, scale, lse, di, do, scalar[2], None, False, _lib=k1.KERNEL_BWD)
        torch.cuda.synchronize()
        mine = (got[1], got[2], got[0])
        check(all(torch.equal(a, b) for a, b in zip(again, mine)), f"K1r {name}: dk, dv, dq differ between runs")
        check(all(torch.equal(a, b[1:2]) for a, b in zip(alone, mine)),
              f"K1r {name}: item 1 alone differs from item 1 in its batch")
        scalar_rel = max(item_err(g_, w) for g_, w in zip(scalar, (want[1], want[2], want[0])))
        scalar_err = max((g_.float() - w).abs().max().item() for g_, w in zip(scalar, (want[1], want[2], want[0])))
        check(scalar_rel <= tol, f"K1r {name}: the scalar backward on the same inputs err {scalar_rel} > {tol}")
        extra = (f"; dk/dv and dq on the 3xTF32 tensor-core kernels, the same bits on a second run and for item 1 "
                 f"alone; the scalar dk/dv and dq on the same inputs {scalar_rel:.2e}")
    print(
        f"K1r check {name} {dtype_name} B,H,Tq,Tk={q.shape[0]},{q.shape[1]},{q.shape[2]},{k.shape[2]} "
        f"d_qk,d_v={dims[0]},{dims[1]}: "
        + ", ".join(f"{n} {abs_errs[n]:.2e} ({e:.2e})" for n, e in errs.items())
        + f" (max |kernel - plain| (worst item's over max(1, max|plain| of the item)); tol {tol:.0e}); lse err "
        f"{lse_err:.1e}; rows that see no key {int(seen_none.sum())}, keys that no row sees "
        f"{int((~key_mask).sum()) * q.shape[1]}{extra}", flush=True,
    )
    if against_autograd:
        leaves = [x.float().detach().requires_grad_() for x in (q, k, v)]
        ag = torch.autograd.grad(k1.flash_attention_ref(*leaves, None, key_mask, scale), leaves, do.float())
        ag_err = max(item_err(g_, a) for g_, a in zip(got, ag))
        print(f"K1r backward vs autograd through the plain forward: worst item's max_abs_err over max(1, max|plain| "
              f"of the item) {ag_err:.2e} (tol {tol:.0e})", flush=True)
        check(ag_err <= tol, "K1r backward disagrees with autograd")
    return abs_errs["out"], max(abs_errs["dq"], abs_errs["dk"], abs_errs["dv"]), scalar_err


def k1r_bounds_ms(b, h, t, d_qk, d_v, elem, dtype_name, with_lse):
    """Least times of the three K1r kernels with every key valid: operations
    2·B·H·T²·(sum of the product widths) (forward: s over d_qk, p·v over
    d_v; dk/dv: s, dp, dv, dk; dq: s, dp, dq); bytes: each input read once, each
    output written once (q, k, dq, dk of width d_qk; v, o, do, dv of width
    d_v; lse and di f32; the key mask). Operations on the tensor cores
    (:func:`ops_ms`: f32 as 3xTF32)."""
    nq, nv = b * h * t * d_qk * elem, b * h * t * d_v * elem
    rows, mask = b * h * t * 4, b * t
    sq = 2 * b * h * t * t
    out = {}
    for name, nbytes, flops in (
        ("fwd", 2 * nq + 2 * nv + mask + (rows if with_lse else 0), sq * (d_qk + d_v)),
        ("dkv", 3 * nq + 3 * nv + 2 * rows + mask, sq * (2 * d_qk + 2 * d_v)),
        ("dq", 3 * nq + 2 * nv + 2 * rows + mask, sq * (2 * d_qk + d_v)),
    ):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops_ms(flops, dtype_name)
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)
    return out


def sdpa_backend(q, k, v, mask, scale):
    """The first SDPA backend, in PyTorch's order of preference, that takes
    these inputs (a d_qk != d_v call with a boolean mask)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            # a refusing backend warns why before it raises
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    fail("no SDPA backend takes the K1r shape")


def time_k1r(seed, where):
    """The three K1r kernels at the training decoder shape (f32, all on the
    3xTF32 tensor-core kernels; by CUDA events and replayed from a CUDA
    graph, the scalar forward, dk/dv and dq on the same inputs beside) and
    the forward at the serving decoder shape (bf16), every key valid, beside
    the plain versions, SDPA with a boolean key mask (forward, and forward +
    backward at the training shape; the yardstick only) and the bounds (f32:
    on the tensor cores in 3xTF32, the CUDA cores' beside)."""
    import torch
    from torch.nn.attention import sdpa_kernel

    from jatts_torch.ops import flash_attention as k1

    d_qk, d_v = K1R_DIMS
    scale = d_v ** -0.5
    res = {}
    b, h, t = K1R_TRAIN
    q, k, v, key_mask, do = k1r_inputs(K1R_TRAIN, K1R_DIMS, torch.float32, [(0, t)], seed)
    o, lse = k1.flash_attention_fwd(q, k, v, None, key_mask, scale)
    di = (o * do).sum(-1)
    res["fwd"] = time_ms(lambda: k1.flash_attention_fwd(q, k, v, None, key_mask, scale), iters=10, warmup=2)
    res["fwd_scalar"] = time_ms(lambda: k1._launch_fwd(q, k, v, None, key_mask, scale, True, False,
                                                       _kernel=k1.KERNEL), iters=5, warmup=1)
    res["fwd_graph"] = graph_ms(lambda: k1.flash_attention_fwd(q, k, v, None, key_mask, scale), iters=10, replays=3)
    res["dkv"] = time_ms(lambda: k1.flash_attention_bwd_dkv(q, k, v, None, key_mask, scale, lse, di, do),
                         iters=10, warmup=2)
    res["dq"] = time_ms(lambda: k1.flash_attention_bwd_dq(q, k, v, None, key_mask, scale, lse, di, do),
                        iters=10, warmup=2)
    res["dkv_graph"] = graph_ms(lambda: k1.flash_attention_bwd_dkv(q, k, v, None, key_mask, scale, lse, di, do),
                                iters=10, replays=3)
    res["dq_graph"] = graph_ms(lambda: k1.flash_attention_bwd_dq(q, k, v, None, key_mask, scale, lse, di, do),
                               iters=10, replays=3)
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    res["dkv_scalar"] = time_ms(lambda: k1._launch_bwd("dkv", q, k, v, None, key_mask, scale, lse, di, do, dk, dv,
                                                       False, _lib=k1.KERNEL_BWD), iters=5, warmup=1)
    res["dq_scalar"] = time_ms(lambda: k1._launch_bwd("dq", q, k, v, None, key_mask, scale, lse, di, do, dq, None,
                                                      False, _lib=k1.KERNEL_BWD), iters=5, warmup=1)
    res["plain_fwd_ms"] = time_ms(lambda: k1.flash_attention_ref(q, k, v, None, key_mask, scale), iters=3, warmup=1)
    res["plain_bwd_ms"] = time_ms(lambda: k1.flash_attention_bwd_ref(q, k, v, None, key_mask, scale, o, lse, do),
                                  iters=3, warmup=1)
    # the backward's precision at this shape: items 0-1 against float64 (the
    # same lse and o), the 3xTF32 kernels, the scalar ones, the plain f32
    # backward (cuBLAS, TF32 off); worst item's error over max(1, max|exact|)
    want = k1.flash_attention_bwd_ref(q, k, v, None, key_mask, scale, o, lse, do)[:3]
    tc = (k1.flash_attention_bwd_dq(q, k, v, None, key_mask, scale, lse, di, do)[0],
          *k1.flash_attention_bwd_dkv(q, k, v, None, key_mask, scale, lse, di, do))
    k1._launch_bwd("dkv", q, k, v, None, key_mask, scale, lse, di, do, dk, dv, False, _lib=k1.KERNEL_BWD)
    k1._launch_bwd("dq", q, k, v, None, key_mask, scale, lse, di, do, dq, None, False, _lib=k1.KERNEL_BWD)
    q2, k2, v2, do2 = (x[:2].double() for x in (q, k, v, do))
    p2 = torch.exp((q2 @ k2.transpose(-1, -2)) * scale - lse[:2].double()[..., None])
    ds2 = p2 * (do2 @ v2.transpose(-1, -2) - (o[:2].double() * do2).sum(-1)[..., None]) * scale
    exact = (ds2 @ k2, ds2.transpose(-1, -2) @ q2, p2.transpose(-1, -2) @ do2)
    res["vs_f64"] = {name: max(item_err(g_[:2], e) for g_, e in zip(got, exact))
                     for name, got in (("tc_f32", tc), ("scalar", (dq, dk, dv)), ("plain", want))}
    del want, tc, q2, k2, v2, do2, p2, ds2, exact
    mask = key_mask[:, None, None, :]
    backend = sdpa_backend(q, k, v, mask, scale)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)
        torch.autograd.grad(out, (qs, ks, vs), do)

    with sdpa_kernel(backend):
        res["sdpa_fwd_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), iters=5, warmup=1)
        res["sdpa_ms"] = time_ms(sdpa_fwd_bwd, iters=3, warmup=1)
    res["sdpa_backend"] = backend.name
    res["bounds"] = k1r_bounds_ms(b, h, t, d_qk, d_v, 4, "f32", with_lse=True)
    del q, k, v, do, o, lse, di, qs, ks, vs, dk, dv, dq
    parts = "; ".join(
        f"{n} kernel {res[n]:.4f} ms (3xTF32 tensor cores; graph replay {res[n + '_graph']:.4f} ms; the scalar "
        f"{n} on the same inputs {res[n + '_scalar']:.4f} ms) (bound {res['bounds'][n][0]:.4f} ms by "
        f"{res['bounds'][n][1]}: {res['bounds'][n][2] / 1e6:.1f} MB, {res['bounds'][n][3] / 1e9:.1f} GFLOP; on the "
        f"CUDA cores {cuda_core_ms(res['bounds'][n][3]):.4f} ms)"
        for n in ("fwd", "dkv", "dq"))
    print(
        f"K1r time f32 B,H,T={b},{h},{t} d_qk,d_v={d_qk},{d_v}, every key valid: {parts}; plain forward "
        f"{res['plain_fwd_ms']:.4f} ms, plain backward {res['plain_bwd_ms']:.4f} ms; sdpa ({backend.name}, "
        f"bool key mask) forward {res['sdpa_fwd_ms']:.4f} ms, forward+backward {res['sdpa_ms']:.4f} ms; {where}",
        flush=True,
    )
    print("K1r f32 backward at that shape against float64, items 0-1 (worst item's max |err| over max(1, "
          "max|exact|) of dq, dk, dv): " + ", ".join(f"{n} {e:.2e}" for n, e in (
              ("3xTF32 tensor-core kernels", res["vs_f64"]["tc_f32"]), ("scalar kernels", res["vs_f64"]["scalar"]),
              ("plain f32 backward", res["vs_f64"]["plain"]))), flush=True)
    # the serving decoder, bf16, forward only (no lse)
    b, h, t = K1R_SERVE
    q, k, v, key_mask, _ = k1r_inputs(K1R_SERVE, K1R_DIMS, torch.bfloat16, [(0, t)], seed + 1)
    mask = key_mask[:, None, None, :]
    serve = {"fwd": time_ms(lambda: k1.flash_attention(q, k, v, None, key_mask, scale), iters=10)}
    serve["plain_fwd_ms"] = time_ms(lambda: k1.flash_attention_ref(q, k, v, None, key_mask, scale), iters=5, warmup=1)
    backend = sdpa_backend(q, k, v, mask, scale)
    with sdpa_kernel(backend):
        serve["sdpa_fwd_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), iters=10)
        serve["sdpa_graph_ms"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale))
    serve["graph_ms"] = graph_ms(lambda: k1.flash_attention(q, k, v, None, key_mask, scale))
    serve["sdpa_backend"] = backend.name
    serve["bound"] = k1r_bounds_ms(b, h, t, d_qk, d_v, 2, "bf16", with_lse=False)["fwd"]
    print(
        f"K1r time bf16 B,H,T={b},{h},{t} d_qk,d_v={d_qk},{d_v} (serving decoder, tensor-core kernel): forward "
        f"{serve['fwd']:.4f} ms (graph replay {serve['graph_ms']:.4f} ms; bound {serve['bound'][0]:.4f} ms by "
        f"{serve['bound'][1]}: {serve['bound'][2] / 1e6:.1f} MB, {serve['bound'][3] / 1e9:.1f} GFLOP); plain "
        f"{serve['plain_fwd_ms']:.4f} ms; sdpa ({backend.name}, bool key mask) {serve['sdpa_fwd_ms']:.4f} ms "
        f"(graph replay {serve['sdpa_graph_ms']:.4f} ms); {where}", flush=True,
    )
    res["serve"] = serve
    return res


def k1r_phase(seed, where):
    """Phase 13: every K1r case, then the times. Returns the largest errors
    of the forward by dtype (bf16 runs the tensor-core kernel, f32 the
    3xTF32 one) and of the backward by kernel ("tc_f32": the f32 dk/dv and
    dq; "scalar": the bf16 ones and the scalar kernels on the f32 cases'
    inputs), and the times."""
    fwd_err, bwd_err = {"f32": 0.0, "bf16": 0.0}, {"tc_f32": 0.0, "scalar": 0.0}
    for i, (name, shape, dims, dtype_name, rows) in enumerate(k1r_cases()):
        fe, be, se = check_k1r(name, shape, dims, dtype_name, rows, seed + i, against_autograd=(name == "f32"))
        fwd_err[dtype_name] = max(fwd_err[dtype_name], fe)
        if dtype_name == "f32":
            bwd_err["tc_f32"], bwd_err["scalar"] = max(bwd_err["tc_f32"], be), max(bwd_err["scalar"], se)
        else:
            bwd_err["scalar"] = max(bwd_err["scalar"], be)
    return fwd_err, bwd_err, time_k1r(seed + 100, where)


def jvs_serving(seed, where):
    """Phase 14, serving: the JVS conf's FastSpeech2 with latest rel-pos
    attention and K1r in bf16 behind BatchingServer, 16 requests with a
    seed-made unit ``spemb`` each; then the same model small in f32 against
    its eager path. Returns the K1r forward launches and the numbers."""
    import numpy as np
    import torch

    from jatts_torch.models.fastspeech2 import FastSpeech2
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.serving import BatchingServer, ServingBundle
    from jatts_torch.utils.config import load_config
    from jatts_torch.vocoder.hifigan import HiFiGANGenerator

    sr, max_frames, bucket, batch = 24000, 1024, 128, 8
    mp = {**load_config(str(JVS_CONF))["model_params"], "conformer_rel_pos_type": "latest"}
    spk_dim = int(mp["spk_embed_dim"])
    torch.manual_seed(seed)
    fs2 = FastSpeech2(idim=64, **{**mp, "attn_backend": "flash"}, device="cuda", dtype=torch.bfloat16)
    voc = HiFiGANGenerator(device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        # as phase 7: centre the random durations on max_frames / bucket frames a token
        fs2.duration_predictor.linear.weight.mul_(0.1)
        fs2.duration_predictor.linear.bias.fill_(math.log(1.0 + max_frames / bucket))
    rng = np.random.default_rng(seed)
    mel_mean = rng.normal(-4.0, 1.0, 80).astype(np.float32)
    mel_scale = rng.uniform(0.5, 2.0, 80).astype(np.float32)
    requests = [rng.integers(1, 64, size=int(n)).tolist() for n in rng.integers(40, bucket + 1, size=16)]
    requests[0] = rng.integers(1, 64, size=bucket).tolist()
    spembs = rng.normal(size=(16, spk_dim)).astype(np.float32)
    spembs /= np.linalg.norm(spembs, axis=1, keepdims=True)
    bundle = ServingBundle(fs2, voc, mel_mean, mel_scale, batch_size=batch, buckets=[bucket],
                           max_frames=max_frames, wav_format="f32")
    check(bundle.spk_dim == spk_dim, "the bundle does not take speaker embeddings")
    bundle.synthesize(requests[:batch], spembs=spembs[:batch])  # warm-up
    torch.cuda.synchronize()

    k1.reset_launches()
    t0 = time.perf_counter()
    with BatchingServer(bundle, max_delay_ms=20.0) as server:
        futures = [server.submit(token_ids=ids, spemb=se) for ids, se in zip(requests, spembs)]
        results = [f.result(timeout=600) for f in futures]
    served_s = time.perf_counter() - t0
    launches, legacy = k1.launches_relpos, _legacy_launches()
    batches = server.stats["batches"]
    print(f"JVS-latest serving: {len(results)} requests with spemb in {batches} batches, {served_s:.3f} s; "
          f"K1r launches {launches}, K1 {legacy[0]}", flush=True)
    check(launches == 8 * batches and launches > 0, f"K1r launches {launches} != 8 per batch x {batches}")
    check(legacy == (0, 0, 0), f"a d_qk == d_v kernel launched while serving the latest model: {legacy}")
    check(k1.launches_tc == launches, f"K1r tensor-core launches {k1.launches_tc} != K1r launches {launches}")
    hop = voc.hop_size
    olens = []
    for i, r in enumerate(results):
        n = r["mel"].shape[0]
        olens.append(n)
        check(0 < n <= max_frames and r["wav"].shape == (n * hop,), f"JVS request {i}: olens {n}")
        check(bool(np.isfinite(r["wav"]).all() and np.isfinite(r["mel"]).all()), f"JVS request {i}: not finite")
    alone = bundle.synthesize([requests[3]], spembs=spembs[3:4])[0]
    diff = float(np.abs(alone["wav"] - results[3]["wav"]).max())
    other = bundle.synthesize([requests[3]], spembs=spembs[4:5])[0]
    print(f"JVS request 3 alone vs in its batch: max |wav diff| {diff:.3e}; with another speaker's spemb "
          f"olens {other['mel'].shape[0]} vs {results[3]['mel'].shape[0]}", flush=True)
    check(alone["wav"].shape == results[3]["wav"].shape and diff <= 1e-3, "JVS: alone != batched")
    check(other["mel"].shape != alone["mel"].shape or not np.allclose(other["mel"], alone["mel"]),
          "JVS: the speaker embedding changes nothing")

    pcm = ServingBundle(fs2, voc, mel_mean, mel_scale, batch_size=batch, buckets=[bucket], max_frames=max_frames)
    batch_ms = time_ms(lambda: pcm.synthesize(requests[:batch], spembs=spembs[:batch]), iters=5, warmup=1)
    audio_s = sum(min(max_frames, n) for n in olens[:batch]) * hop / sr
    xs, ilens = pcm.prepare(requests[:batch])
    se = pcm.prepare_spembs(spembs[:batch])
    with torch.no_grad():
        fs2_ms = time_ms(lambda: fs2.inference(xs, ilens, max_frames, se), iters=5, warmup=1)
    print(
        f"JVS-latest serving bf16 pcm16 B={batch} bucket={bucket} max_frames={max_frames}: {batch_ms:.2f} ms "
        f"per batch, RTF {batch_ms / 1e3 / audio_s:.5f} ({audio_s:.2f} s of audio); fastspeech2 {fs2_ms:.2f} ms "
        f"of it; {where}", flush=True,
    )
    del fs2, voc, bundle, pcm

    # the same model small in f32: K1r against the eager rel_shift_gather path
    torch.manual_seed(seed + 1)
    small = {**mp, "idim": 64, "elayers": 1, "dlayers": 1, "device": "cuda"}
    ref_model = FastSpeech2(**{**small, "attn_backend": "xla"})
    k1r_model = FastSpeech2(**{**small, "attn_backend": "flash"})
    k1r_model.load_state_dict(ref_model.state_dict())
    for m in (ref_model, k1r_model):
        with torch.no_grad():
            m.duration_predictor.linear.weight.mul_(0.1)
            m.duration_predictor.linear.bias.fill_(math.log(5.0))
    xs = torch.randint(1, 64, (2, 40), device="cuda")
    ilens = torch.tensor([40, 23], device="cuda")
    se = torch.from_numpy(spembs[:2]).cuda()
    k1.reset_launches()
    with torch.no_grad():
        want = ref_model.inference(xs, ilens, 256, se)
        got = k1r_model.inference(xs, ilens, 256, se)
    check(k1.launches_relpos == 2, f"the small f32 model launched K1r {k1.launches_relpos} times, not 2")
    check(torch.equal(want["duration"], got["duration"]), "JVS: durations differ between K1r and eager")
    feat_err = (want["feat_gen"] - got["feat_gen"]).abs().max().item()
    print(f"JVS-latest f32 K1r vs eager (1+1 blocks, B=2, T=40): feat_gen max_abs_err {feat_err:.3e} (tol 1e-3)",
          flush=True)
    check(feat_err <= 1e-3, "JVS: feat_gen differs between K1r and eager")
    return launches, {"batch_ms": batch_ms, "rtf": batch_ms / 1e3 / audio_s, "fs2_ms": fs2_ms}


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

JSUT_CONF = ROOT / "egs" / "jsut" / "tts1" / "conf" / "fastspeech2.v1.yaml"
JVS_CONF = ROOT / "egs" / "jvs" / "tts1" / "conf" / "fastspeech2.v1.yaml"
JVS_SPEAKERS = 4  # synthetic speakers of phase 14's corpus
TRAIN_STEPS = 200  # the conf's train_max_steps is 100000
TRAIN_WARMUP = 50  # the conf's warmup_steps is 4000


def write_fs2_corpus(root, align_paths, freqs, tag="fs2", spk_dim=0, seed=0):
    """Phase 8's rows (cropped by start/end, with durations) as FastSpeech2
    training data: per utterance an .npz with the log-mel at the JSUT
    settings cropped to the durations' sum (as jatts_tpu/bin/preprocess.py
    crops it), the per-token pitch (log of the phone's tone frequency) and
    the per-token energy (the STFT-magnitude energy of ops/dsp.py averaged
    over the token's frames, as the JAX Energy extractor averages it), and
    with ``spk_dim`` a ``spkemb`` of that width (one of 4 seed-made unit
    speaker vectors plus a little per-utterance noise, as x-vectors of one
    speaker vary); the stats (``<feat>_mean``/``_scale`` over the train rows,
    as jatts_tpu/bin/compute_statistics.py computes them: a 1-d dump counts
    as a column), tokens.txt and the train/dev csvs, named by ``tag``.
    Returns (train csv, dev csv, stats, tokens)."""
    import numpy as np
    import torch

    from jatts_torch.features.extractors import LogMelExtractor
    from jatts_torch.ops.dsp import energy
    from jatts_torch.utils.io import read_audio, read_csv, write_csv

    c = ALIGN_CONFIG
    sr, hop = c["sampling_rate"], c["hop_size"]
    mel_ex = LogMelExtractor(
        sampling_rate=sr, fft_size=c["fft_size"], hop_size=hop, win_length=c["win_length"],
        num_mels=c["num_mels"], fmin=c["fmin"], fmax=c["fmax"], device="cuda",
    )
    tokens = str(Path(root) / "tokens.txt")
    with open(tokens, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank>", "<unk>", *sorted(freqs), "<sos/eos>"]) + "\n")
    rng = np.random.default_rng(seed)
    speakers = rng.normal(size=(JVS_SPEAKERS, max(spk_dim, 1)))
    speakers /= np.linalg.norm(speakers, axis=1, keepdims=True)
    sums, sqs, counts = {}, {}, {}
    out_paths = []
    n_utt = 0
    for split, path in zip(("train", "dev"), align_paths):
        rows, _ = read_csv(path, dict_reader=True)
        for row in rows:
            wav, _ = read_audio(row["wav_path"], sr, row["start"], row["end"])
            ds = np.asarray([int(x) for x in row["durations"].split()])
            mel = mel_ex(wav)
            check(abs(len(mel) - int(ds.sum())) <= 3, f"{row['sample_id']}: mel frames != sum(durations)")
            mel = mel[: int(ds.sum())]
            e = energy(torch.from_numpy(wav).cuda(), c["fft_size"], hop).cpu().numpy()[: len(mel)]
            bounds = np.concatenate([[0], np.cumsum(ds)])
            e_tok = np.asarray([
                seg[seg > 0].mean() if (seg > 0).any() else 0.0
                for seg in (e[a:z] for a, z in zip(bounds[:-1], bounds[1:]))
            ], np.float32)
            p_tok = np.log([freqs[p] for p in row["phonemes"].split()]).astype(np.float32)
            feat_path = str(Path(root) / f"dump_{tag}" / f"{row['sample_id']}.npz")
            Path(feat_path).parent.mkdir(parents=True, exist_ok=True)
            feats = {"mel": mel.astype(np.float32), "pitch": p_tok, "energy": e_tok}
            if spk_dim:
                spk = n_utt % JVS_SPEAKERS
                row["spk"] = f"spk{spk}"
                feats["spkemb"] = (speakers[spk] + 0.05 * rng.normal(size=spk_dim) / math.sqrt(spk_dim)).astype(np.float32)
            n_utt += 1
            np.savez(feat_path, **feats)
            row["feat_path"] = feat_path
            if split == "train":
                for name, x in feats.items():
                    x = x if x.ndim > 1 else x[:, None]
                    x = x.astype(np.float64)
                    sums[name] = sums.get(name, 0.0) + x.sum(0)
                    sqs[name] = sqs.get(name, 0.0) + (x ** 2).sum(0)
                    counts[name] = counts.get(name, 0) + len(x)
        out = str(Path(root) / f"{split}_{tag}.csv")
        write_csv(rows, out)
        out_paths.append(out)
    stats = {}
    for name in sums:
        mean = sums[name] / counts[name]
        stats[f"{name}_mean"] = mean.astype(np.float32)
        stats[f"{name}_scale"] = np.sqrt(np.maximum(sqs[name] / counts[name] - mean ** 2, 1e-12)).astype(np.float32)
    stats_path = str(Path(root) / f"stats_{tag}.npz")
    np.savez(stats_path, **stats)
    return out_paths[0], out_paths[1], stats_path, tokens


def _legacy_launches():
    from jatts_torch.ops import flash_attention as k1

    return (k1.launches, k1.launches_bwd_dkv, k1.launches_bwd_dq)


def _relpos_launches():
    from jatts_torch.ops import flash_attention as k1

    return (k1.launches_relpos, k1.launches_bwd_dkv_relpos, k1.launches_bwd_dq_relpos)


# what the training slice runs: phase 10, the JSUT conf (legacy rel-pos, K1
# and K1-bwd, the backward scalar), or phase 14, the JVS conf with speaker
# embeddings and latest rel-pos attention (K1r, the backward on the 3xTF32
# kernels: bwd_tc_f32 says how many of the dk/dv and dq launches take them).
# A kernel is named by the substrings of its profiler key, demangled or not
SLICES = {
    "jsut": dict(conf=JSUT_CONF, tag="fs2", spk_dim=0, latest=False, counts=_legacy_launches,
                 others=_relpos_launches, names=("K1 fwd (3xTF32 tc)", "K1-bwd dkv", "dq"), bwd_tc_f32=False,
                 kernels=(("flash_attn_fwd_tc_f32_kernel",), ("flash_attn_bwd_dkv_kernel",),
                          ("flash_attn_bwd_dq_kernel",))),
    "jvs": dict(conf=JVS_CONF, tag="jvs", spk_dim=192, latest=True, counts=_relpos_launches,
                others=_legacy_launches, names=("K1r fwd (3xTF32 tc)", "K1r dkv (3xTF32 tc)", "dq (3xTF32 tc)"),
                bwd_tc_f32=True,
                kernels=(("flash_attn_fwd_tc_f32_kernel",),
                         ("flash_attn_bwd_tc_f32_kernel<576, 192, false>", "flash_attn_bwd_tc_f32_kernelILi576ELi192ELb0E"),
                         ("flash_attn_bwd_tc_f32_kernel<576, 192, true>", "flash_attn_bwd_tc_f32_kernelILi576ELi192ELb1E"))),
}


def training_slice(root, align_paths, freqs, seed, where, which="jsut"):
    """Phase 10 (``which="jsut"``) or phase 14's training (``"jvs"``).
    Returns the launches of the training run (forward, dk/dv, dq kernels of
    the slice's form) and the numbers the record and PERF.md need."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jatts_torch.bin import tts_train
    from jatts_torch.models.fastspeech2 import FastSpeech2
    from jatts_torch.modules.dropout import set_dropout_rate
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.train.trainer import Trainer
    from jatts_torch.utils.checkpoint import find_latest_checkpoint
    from jatts_torch.utils.config import load_config

    sl = SLICES[which]
    conf = sl["conf"]
    names = sl["names"]
    t0 = time.perf_counter()
    train_csv, dev_csv, stats, tokens = write_fs2_corpus(
        root, align_paths, freqs, tag=sl["tag"], spk_dim=sl["spk_dim"], seed=seed)
    print(f"training corpus ({which}): .npz dumps, stats, tokens.txt in {time.perf_counter() - t0:.1f} s",
          flush=True)
    config = load_config(str(conf))
    if sl["latest"]:
        config["model_params"] = {**config["model_params"], "conformer_rel_pos_type": "latest"}
    print(
        f"training config {conf.relative_to(ROOT)}{' with conformer_rel_pos_type latest' if sl['latest'] else ''}"
        f" and attn_backend flash; reductions: "
        f"train_max_steps {config['train_max_steps']} -> {TRAIN_STEPS}, warmup_steps "
        f"{config['scheduler_params']['warmup_steps']} -> {TRAIN_WARMUP}", flush=True,
    )
    config["train_max_steps"] = TRAIN_STEPS
    config["scheduler_params"] = {**config["scheduler_params"], "warmup_steps": TRAIN_WARMUP}
    outdir = str(Path(root) / f"exp_{sl['tag']}")

    k1.reset_launches()
    t0 = time.perf_counter()
    trainer = tts_train.run(train_csv, dev_csv, stats, tokens, config, outdir, seed=seed,
                            device="cuda", attn_backend="flash")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, others = sl["counts"](), sl["others"]()
    fwd_tc_f32, bwd_tc_f32 = k1.launches_tc_f32, _tc_f32_bwd_launches()
    check(k1.launches_tc == 0, f"training ({which}, f32) launched the bf16 tensor-core kernel {k1.launches_tc} times")

    losses = [h["train/loss"] for h in trainer.history]
    batches = trainer.train_loader.sampler.batches
    print(
        f"training ({which}): {len(trainer.train_loader.dataset)} utterances in {len(batches)} batches of "
        f"<= {config['batch_size']}, {trainer.steps} steps in {run_s:.1f} s; launches {names[0]} {launches[0]}, "
        f"{names[1]} {launches[1]}, {names[2]} {launches[2]} (8 a step = {8 * TRAIN_STEPS}); the other "
        f"form's {others}", flush=True,
    )
    check(trainer.steps == TRAIN_STEPS, f"trained {trainer.steps} steps")
    check(all(math.isfinite(v) for h in trainer.history for v in h.values()), "a training stat is not finite")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"training loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f}", flush=True)
    check(last < first, "the training loss did not fall")
    check(launches[0] > 0 and launches[1] > 0 and launches[2] > 0, f"{names[0]} not launched in training")
    check(launches == (8 * TRAIN_STEPS,) * 3, f"launches {launches} != 8 a step each")
    check(others == (0, 0, 0), f"the other attention form launched {others} in this training run")
    print(f"training ({which}): forwards on the 3xTF32 tensor-core kernel {fwd_tc_f32} of {launches[0]}, on the "
          f"scalar kernel {launches[0] - fwd_tc_f32}", flush=True)
    check(fwd_tc_f32 == launches[0], f"{launches[0] - fwd_tc_f32} f32 forwards missed the 3xTF32 kernel")
    want_bwd = launches[1:] if sl["bwd_tc_f32"] else (0, 0)
    print(f"training ({which}): dk/dv and dq on the 3xTF32 tensor-core kernels {bwd_tc_f32} of {launches[1:]}",
          flush=True)
    check(bwd_tc_f32 == want_bwd, f"training ({which}): dk/dv and dq on the 3xTF32 kernels {bwd_tc_f32} != {want_bwd}")

    # the checkpoint, and a resumed trainer
    ckpt = find_latest_checkpoint(outdir)
    check(ckpt is not None and ckpt.endswith(f"checkpoint-{TRAIN_STEPS}steps"), f"checkpoint {ckpt}")
    model_params = trainer.config["model_params"]
    model2 = FastSpeech2(**model_params, device="cuda")
    resumed = Trainer(trainer.config, model2, trainer.criterions, trainer.loss_fn, trainer.train_loader,
                      outdir=outdir, seed=seed)
    resumed.init_state()
    resumed.load_checkpoint()
    same = all(torch.equal(model2.state_dict()[k], v) for k, v in trainer.model.state_dict().items())
    print(f"resume from {Path(ckpt).name}: steps {resumed.steps}, parameters bitwise equal {same}", flush=True)
    check(resumed.steps == TRAIN_STEPS and same, "the resumed trainer differs")

    # the trained weights in inference
    dev_set = trainer.dev_loader.dataset
    dev_batch = trainer.dev_loader.collater([dev_set[i] for i in range(min(4, len(dev_set)))])
    xs = torch.from_numpy(dev_batch["xs"]).long().cuda()
    ilens = torch.from_numpy(dev_batch["ilens"]).long().cuda()
    spembs = torch.from_numpy(dev_batch["spembs"]).cuda() if "spembs" in dev_batch else None
    with torch.no_grad():
        inf = model2.inference(xs, ilens, 1024, spembs)
    olens = inf["olens"].tolist()
    print(f"inference on 4 dev rows: olens {olens} (true {dev_batch['olens'].tolist()})", flush=True)
    check(bool(torch.isfinite(inf["feat_gen"]).all()) and bool((inf["duration"] >= 0).all()),
          "inference of the trained model")
    del resumed, model2

    # one step at the largest batch and its parts
    big = max(batches, key=lambda idx: sum(trainer.train_loader.dataset.get_frame_len(i) for i in idx))
    tb = trainer.to_device(trainer.train_loader.collater([trainer.train_loader.dataset[i] for i in big]))
    shape = (tb["ys"].shape[0], tb["ys"].shape[1], tb["xs"].shape[1])
    model, params, crit = trainer.model, trainer.params, trainer.criterions

    def host_ms(fn, iters=3):
        return time_ms(fn, iters=iters, warmup=1, host_clock=True)

    def loss_of(m):
        return trainer.loss_fn(m, tb, crit, trainer.config, 0)[0]

    model.train()
    fwd_ms = host_ms(lambda: loss_of(model))
    loss = loss_of(model)
    grads = torch.autograd.grad(loss, params, retain_graph=True)
    bwd_ms = host_ms(lambda: torch.autograd.grad(loss, params, retain_graph=True))
    for p, g in zip(params, grads):
        p.grad = g
    opt_ms = host_ms(trainer.optimizer.step, iters=5)
    step_ms = host_ms(lambda: trainer.train_step(tb))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(tb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms > 0, "profile of one training step: the profiler saw no device time")
    kn = sl["kernels"]
    k_ms = {name: sum(e.self_device_time_total for e in events if any(alt in e.key for alt in name)) / 1e3
            for name in kn}
    check(all(k_ms[name] > 0 for name in kn), f"profile of one training step: no time for {names} ({k_ms})")
    print(
        f"training step ({which}) f32, batch {shape} (B, T_feats, T_text): whole step {step_ms:.1f} ms "
        f"(host clock); forward+loss {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, optimizer {opt_ms:.2f} ms; "
        f"{where}", flush=True,
    )
    print(
        f"profile of one training step: wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy_ms:.1f} ms in {sum(e.count for e in events)} kernels, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; {names[0]} {k_ms[kn[0]]:.2f} ms, {names[1]} "
        f"{k_ms[kn[1]]:.2f} ms, {names[2]} {k_ms[kn[2]]:.2f} ms (8 launches each)", flush=True,
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")

    # the same step under attn_backend xla, same weights and batch, dropout 0
    state = model.state_dict()
    pair = {}
    for backend in ("flash", "xla"):
        m = FastSpeech2(**{**model_params, "attn_backend": backend}, device="cuda")
        m.load_state_dict(state)
        set_dropout_rate(m, 0.0)
        m.train()
        k1.reset_launches()
        lss = loss_of(m)
        pair[backend] = (float(lss.detach()), torch.autograd.grad(lss, list(m.parameters())))
        want = (8, 8, 8) if backend == "flash" else (0, 0, 0)
        want_bwd = want[1:] if sl["bwd_tc_f32"] else (0, 0)
        check(sl["counts"]() == want and sl["others"]() == (0, 0, 0) and k1.launches_tc_f32 == want[0]
              and _tc_f32_bwd_launches() == want_bwd,
              f"{backend} step: {names[0]} launches {sl['counts']()} != {want} (3xTF32 {k1.launches_tc_f32}, "
              f"3xTF32 dk/dv and dq {_tc_f32_bwd_launches()})")
        pair[backend] += (host_ms(lambda: torch.autograd.grad(loss_of(m), list(m.parameters()))),)
        del m
    (lf, gf, f_ms), (lx, gx, x_ms) = pair["flash"], pair["xla"]
    loss_rel = abs(lf - lx) / abs(lx)
    diff = math.sqrt(sum(float((a - b).double().pow(2).sum()) for a, b in zip(gf, gx)))
    norm = math.sqrt(sum(float(b.double().pow(2).sum()) for b in gx))
    print(
        f"flash vs xla, one step at batch {shape}, dropout 0: loss {lf:.6f} vs {lx:.6f} (rel diff "
        f"{loss_rel:.2e}, tol 1e-4), gradients |g_flash - g_xla| / |g_xla| {diff / norm:.2e} (tol 1e-3); "
        f"forward+backward flash {f_ms:.1f} ms, xla {x_ms:.1f} ms", flush=True,
    )
    check(loss_rel <= 1e-4 and diff / norm <= 1e-3, "flash and xla training steps disagree")
    return launches, {"step_ms": step_ms, "run_s": run_s, "k_ms": k_ms, "idle": 1 - busy_ms / wall_ms,
                      "flash_ms": f_ms, "xla_ms": x_ms, "fwd_tc_f32": fwd_tc_f32, "bwd_tc_f32": bwd_tc_f32}


# ---------------------------------------------------------------------------
# the VALL-E AR slice
# ---------------------------------------------------------------------------

TTS3_CONF = ROOT / "egs" / "hificaptain_jp_female" / "tts3" / "conf" / "valle_ar.given.bs32.yaml"
VALLE_STEPS = 200  # the conf's train_max_steps is 400000
VALLE_WARMUP = 50  # the conf's warmup_steps is 8000
CODEC_HOP = 320  # EnCodec at 24 kHz: 75 frames a second


def write_codec_corpus(root, seed, n_utts=64, n_phones=40):
    """A codec corpus with something to learn: each phone a fixed seeded
    8-level code, repeated over its 3-9 frames; 20-80 phones an utterance.
    Per utterance an .npz with ``encodec`` [T, 8] int64; train/dev csvs
    (start/end from the frame count, for the length buckets), tokens.txt
    and an empty stats file (codes take no stats). Returns (train csv, dev
    csv, stats, tokens)."""
    import numpy as np

    from jatts_torch.utils.io import write_csv

    rng = np.random.default_rng(seed)
    phones = [f"p{i:02d}" for i in range(n_phones)]
    codebook = rng.integers(0, 1024, (n_phones, 8))
    tokens = str(Path(root) / "tokens.txt")
    with open(tokens, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank>", "<unk>", *phones, "<sos/eos>"]) + "\n")
    rows = []
    for i in range(n_utts):
        idx = rng.integers(0, n_phones, int(rng.integers(20, 81)))
        codes = np.repeat(codebook[idx], rng.integers(3, 10, len(idx)), axis=0).astype(np.int64)
        feat_path = str(Path(root) / "codec" / f"V{i:03d}.npz")
        Path(feat_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(feat_path, encodec=codes)
        rows.append({"sample_id": f"V{i:03d}", "spk": "syn", "start": "0",
                     "end": f"{len(codes) * CODEC_HOP / 24000:.6f}",
                     "phonemes": " ".join(phones[j] for j in idx), "feat_path": feat_path})
    paths = [str(Path(root) / "train_codec.csv"), str(Path(root) / "dev_codec.csv")]
    n_dev = n_utts // 8
    write_csv(rows[n_dev:], paths[0])
    write_csv(rows[:n_dev], paths[1])
    stats = str(Path(root) / "stats_codec.npz")
    np.savez(stats)
    return paths[0], paths[1], stats, tokens


def valle_slice(root, seed, where):
    """Phase 12. Returns the K1b launches of the training run (forward,
    dk/dv, dq; every one on the tensor-core kernels) and of
    the f32 flash step (the scalar kernels), the own-shape check's errors
    and the numbers PERF.md needs."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jatts_torch.bin import tts_train
    from jatts_torch.models.valle import VALLEAR, ar_generate
    from jatts_torch.modules.dropout import set_dropout_rate
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.train.trainer import Trainer
    from jatts_torch.utils.checkpoint import find_latest_checkpoint
    from jatts_torch.utils.config import load_config

    train_csv, dev_csv, stats, tokens = write_codec_corpus(root, seed)
    config = load_config(str(TTS3_CONF))
    mp = config["model_params"]
    print(
        f"VALL-E config {TTS3_CONF.relative_to(ROOT)} (d_model {mp['d_model']}, {mp['n_heads']} heads, "
        f"{mp['n_layers']} layers, dtype {mp['dtype']}, batch {config['batch_size']} x accumulation "
        f"{config['gradient_accumulate_steps']}, {config['optimizer_type']}) with attn_backend flash; "
        f"reductions: train_max_steps {config['train_max_steps']} -> {VALLE_STEPS}, warmup_steps "
        f"{config['scheduler_params']['warmup_steps']} -> {VALLE_WARMUP}; a 64-utterance synthetic codec "
        f"corpus", flush=True,
    )
    config["train_max_steps"] = VALLE_STEPS
    config["scheduler_params"] = {**config["scheduler_params"], "warmup_steps": VALLE_WARMUP}
    outdir = str(Path(root) / "exp_valle")

    k1.reset_launches()
    t0 = time.perf_counter()
    trainer = tts_train.run(train_csv, dev_csv, stats, tokens, config, outdir, seed=seed,
                            device="cuda", attn_backend="flash")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = (k1.launches_causal, k1.launches_bwd_dkv_causal, k1.launches_bwd_dq_causal)
    other = (k1.launches, k1.launches_bwd_dkv, k1.launches_bwd_dq)
    tc = (k1.launches_tc, k1.launches_bwd_dkv_tc, k1.launches_bwd_dq_tc)
    layers = trainer.model.n_layers
    loader = trainer.train_loader
    batches = loader.sampler.batches
    print(
        f"VALL-E training: {len(loader.dataset)} utterances in {len(batches)} batches of <= "
        f"{config['batch_size']}, {trainer.steps} steps ({trainer.updates} updates) in {run_s:.1f} s; "
        f"launches K1b forward {launches[0]}, dk/dv {launches[1]}, dq {launches[2]} ({layers} a step = "
        f"{layers * VALLE_STEPS}), of them on the tensor cores: forward {tc[0]}, dk/dv {tc[1]}, dq {tc[2]} "
        f"(scalar bf16 dq {launches[2] - tc[2]}); non-causal K1/K1-bwd {other}", flush=True,
    )
    check(trainer.steps == VALLE_STEPS, f"trained {trainer.steps} steps")
    check(all(math.isfinite(v) for h in trainer.history for v in h.values()), "a training stat is not finite")
    losses = [h["train/loss_ce"] for h in trainer.history]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"VALL-E loss_ce: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
          f"(limit: at most 0.9 x the first)", flush=True)
    check(last <= 0.9 * first, "the VALL-E loss did not fall by 10%")
    check(min(launches) > 0, "K1b was not launched in VALL-E training")
    check(launches == (layers * VALLE_STEPS,) * 3 and other == (0, 0, 0),
          f"launches {launches} / {other} != {layers} causal a step each")
    check(tc == (layers * VALLE_STEPS,) * 3 and launches[2] - tc[2] == 0,
          f"tensor-core launches (forward, dk/dv, dq) {tc} != {layers * VALLE_STEPS} each: every bf16 K1b "
          f"forward, dk/dv and dq of VALL-E must take the tensor-core kernels, the scalar bf16 dq none")

    # the checkpoint, and a resumed trainer
    model_params = dict(trainer.config["model_params"])
    dtype = tts_train.DTYPES[model_params.pop("dtype")]
    ckpt = find_latest_checkpoint(outdir)
    check(ckpt is not None and ckpt.endswith(f"checkpoint-{VALLE_STEPS}steps"), f"checkpoint {ckpt}")
    model2 = VALLEAR(**model_params, device="cuda", dtype=dtype)
    resumed = Trainer(trainer.config, model2, trainer.criterions, trainer.loss_fn, loader, outdir=outdir, seed=seed)
    resumed.init_state()
    resumed.load_checkpoint()
    same = all(torch.equal(model2.state_dict()[k], v) for k, v in trainer.model.state_dict().items())
    same_opt = resumed.updates == trainer.updates and resumed.mini_step == trainer.mini_step
    print(f"resume from {Path(ckpt).name}: steps {resumed.steps}, updates {resumed.updates}, parameters "
          f"bitwise equal {same}", flush=True)
    check(resumed.steps == VALLE_STEPS and same and same_opt, "the resumed VALL-E trainer differs")
    del resumed, model2

    # one step at the largest batch and its parts
    model, params = trainer.model, trainer.params
    big = max(batches, key=lambda idx: sum(loader.dataset.get_frame_len(i) for i in idx))
    tb = trainer.to_device(loader.collater([loader.dataset[i] for i in big]))
    s_len = tb["text"].shape[1] + tb["proms"].shape[1] + tb["resps"].shape[1] + 2
    shape = (tb["text"].shape[0], s_len)

    def host_ms(fn, iters=3):
        return time_ms(fn, iters=iters, warmup=1, host_clock=True)

    def loss_of(m, b=tb):
        return trainer.loss_fn(m, b, trainer.criterions, trainer.config, 0)[0]

    def eval_loss():
        model.eval()
        with torch.no_grad():
            out = float(loss_of(model))
        model.train()
        return out

    # the timing below takes optimizer steps; the trained weights come back after it
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    trained_loss = eval_loss()
    model.train()
    fwd_ms = host_ms(lambda: loss_of(model))
    loss = loss_of(model)
    bwd_ms = host_ms(lambda: torch.autograd.grad(loss, params, retain_graph=True))
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.grad = g
    opt_ms = host_ms(trainer.optimizer.step, iters=5)
    for p in params:
        p.grad = None
    del loss, grads
    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(lambda: trainer.train_step(tb))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(tb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms > 0, "profile of one VALL-E step: the profiler saw no device time")
    k_ms = {name: sum(e.self_device_time_total for e in events if name in e.key) / 1e3
            for name in ("flash_attn_fwd_tc_kernel", "flash_attn_bwd_dkv_tc_kernel", "flash_attn_bwd_dq_tc_kernel",
                         "flash_attn_fwd_kernel", "flash_attn_bwd_dkv_kernel", "flash_attn_bwd_dq_kernel")}
    k1b_ms = sum(k_ms.values())
    print(
        f"VALL-E training micro-step bf16, batch {shape} (B, S packed): whole step {step_ms:.1f} ms (host "
        f"clock, peak memory {peak_gb:.1f} GiB); forward+loss {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, "
        f"optimizer {opt_ms:.2f} ms; {where}", flush=True,
    )
    print(
        f"profile of one VALL-E micro-step: wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy_ms:.1f} ms in {sum(e.count for e in events)} kernels, idle share {1 - busy_ms / wall_ms:.3f}; "
        f"K1b forward {k_ms['flash_attn_fwd_tc_kernel']:.2f} ms (tensor cores), dk/dv "
        f"{k_ms['flash_attn_bwd_dkv_tc_kernel']:.2f} ms (tensor cores), dq "
        f"{k_ms['flash_attn_bwd_dq_tc_kernel']:.2f} ms (tensor cores) ({layers} launches each; scalar forward "
        f"{k_ms['flash_attn_fwd_kernel']:.2f} ms, scalar dk/dv {k_ms['flash_attn_bwd_dkv_kernel']:.2f} ms, scalar "
        f"dq {k_ms['flash_attn_bwd_dq_kernel']:.2f} ms); K1b {k1b_ms:.2f} ms = {k1b_ms / busy_ms:.3f} of the "
        f"device time", flush=True,
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    timed_loss = eval_loss()
    model.load_state_dict(trained)
    print(f"VALL-E loss_ce on that batch, eval mode: {trained_loss:.4f} trained, {timed_loss:.4f} after the timed "
          f"optimizer steps (the trained weights are restored for what follows)", flush=True)

    # K1b against its plain version on this batch's own attention shape and key mask
    total = (tb["text_lens"] + tb["prom_lens"] + tb["resp_lens"] + 2).tolist()
    own = check_k1b("phase 12's largest batch", (shape[0], model.n_heads, s_len, model.d_model // model.n_heads),
                    "bf16", False, [(0, n) for n in total], seed + 7)

    # the same step under attn_backend xla: bf16 as trained (loose bound:
    # the two round to bf16 at other places), then f32 on 4 rows (tight)
    state = trained
    small = {k: v[:4] for k, v in tb.items()}

    def step_pair(dt, batch, tol_loss, tol_grad, timed):
        pair = {}
        for backend in ("flash", "xla"):
            m = VALLEAR(**{**model_params, "attn_backend": backend}, device="cuda", dtype=dt)
            m.load_state_dict(state)
            set_dropout_rate(m, 0.0)
            m.train()
            k1.reset_launches()
            lss = loss_of(m, batch)
            g = torch.autograd.grad(lss, list(m.parameters()))
            # bf16: the forward, dk/dv and dq on the tensor cores; f32: the scalar kernels
            n_tc = layers if backend == "flash" and dt == torch.bfloat16 else 0
            want = (layers,) * 3 + (n_tc,) * 3 if backend == "flash" else (0,) * 6
            got_launches = (k1.launches_causal, k1.launches_bwd_dkv_causal, k1.launches_bwd_dq_causal,
                            k1.launches_tc, k1.launches_bwd_dkv_tc, k1.launches_bwd_dq_tc)
            check(got_launches == want, f"{backend} step: K1b launches (forward, dk/dv, dq, tc forward, tc dk/dv, "
                                        f"tc dq) {got_launches} != {want}")
            ms = host_ms(lambda: torch.autograd.grad(loss_of(m, batch), list(m.parameters()))) if timed else None
            pair[backend] = (float(lss.detach()), g, ms, got_launches)
            del m
        (lf, gf, f_ms, f_launches), (lx, gx, x_ms, _) = pair["flash"], pair["xla"]
        loss_rel = abs(lf - lx) / abs(lx)
        diff = math.sqrt(sum(float((a - b).double().pow(2).sum()) for a, b in zip(gf, gx)))
        norm = math.sqrt(sum(float(b.double().pow(2).sum()) for b in gx))
        name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dt]
        times = f"; forward+backward flash {f_ms:.1f} ms, xla {x_ms:.1f} ms" if timed else ""
        print(
            f"VALL-E flash vs xla, {name}, batch {tuple(batch['text'].shape[:1]) + (s_len,)}, dropout 0: loss "
            f"{lf:.6f} vs {lx:.6f} (rel diff {loss_rel:.2e}, tol {tol_loss:.0e}), gradients |g_flash - g_xla| "
            f"/ |g_xla| {diff / norm:.2e} (tol {tol_grad:.0e}){times}", flush=True,
        )
        check(loss_rel <= tol_loss and diff / norm <= tol_grad, f"VALL-E flash and xla steps disagree ({name})")
        return f_ms, x_ms, diff / norm, f_launches

    flash_ms, xla_ms, rel_bf16, _ = step_pair(dtype, tb, 1e-2, 5e-2, True)
    _, _, rel_f32, f32_launches = step_pair(torch.float32, small, 1e-4, 1e-3, False)

    # decode: ar_generate from the trained model on 4 dev rows
    dev_set = trainer.dev_loader.dataset
    rows = min(4, len(dev_set))
    db = trainer.to_device(trainer.dev_loader.collater([dev_set[i] for i in range(rows)]))
    args4 = (db["text"], db["text_lens"], db["proms"], db["prom_lens"])
    max_steps = int(db["resps"].shape[1])
    model.eval()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ar_generate(model, *args4, max_steps=8, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ar_generate(model, *args4, max_steps=max_steps, generator=gen)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    codes, lens = out["codes"], out["resp_lens"]
    print(
        f"VALL-E decode, {rows} dev rows, max_steps {max_steps}: {dec_s * 1e3 / max_steps:.2f} ms a step, "
        f"{rows * max_steps / dec_s:.0f} codes/s ({dec_s:.2f} s); resp_lens {lens.tolist()} (true "
        f"{db['resp_lens'].tolist()}); {where}", flush=True,
    )
    check(codes.shape == (rows, max_steps), f"codes {tuple(codes.shape)}")
    check(int(codes.min()) >= 0 and int(codes.max()) <= model.stop_token, "a code out of range")
    check(bool((lens <= max_steps).all()) and bool((lens >= 0).all()), "a stop past max_steps")

    # the KV cache against the causal kernel: an f32 copy, the decode
    # teacher-forced on the drawn codes vs the flash trunk over them
    f32m = VALLEAR(**{**model_params, "attn_backend": "flash"}, device="cuda", dtype=torch.float32).eval()
    f32m.load_state_dict(state)
    forced = ar_generate(f32m, *args4, max_steps=max_steps, forced=codes)
    n = max_steps
    k1.reset_launches()
    with torch.no_grad():
        logits, _ = f32m.trunk(*args4, codes[..., None], torch.full((rows,), n, device="cuda"),
                               torch.ones(rows, dtype=torch.long, device="cuda"))
    check(k1.launches_causal == layers and k1.launches_tc == 0,
          "the teacher-forced f32 trunk did not run the scalar K1b forward")
    start = (db["text_lens"] + db["prom_lens"] + 1)[:, None] + torch.arange(n, device="cuda")[None, :]
    trunk = torch.gather(logits, 1, start[..., None].expand(rows, n, logits.shape[-1]))
    kv_err = (forced["logits"] - trunk).abs().max().item()
    kv_tol = 1e-3 * max(1.0, trunk.abs().max().item())
    print(f"VALL-E KV-cached decode vs the flash trunk, teacher-forced, f32, {rows} x {n} codes: max_abs_err "
          f"{kv_err:.2e} (tol 1e-3 x max(1, max|trunk|) = {kv_tol:.1e})", flush=True)
    check(kv_err <= kv_tol, "the KV-cached logits disagree with the causal trunk")
    return launches, f32_launches[:3], own, {
        "step_ms": step_ms, "run_s": run_s, "k_ms": k_ms, "k1b_share": k1b_ms / busy_ms,
        "idle": 1 - busy_ms / wall_ms, "flash_ms": flash_ms, "xla_ms": xla_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "jatts_torch" / "csrc").is_dir():
        print(f"chip_smoke: no jatts_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from jatts_torch.models.fastspeech2 import FastSpeech2
    from jatts_torch.ops import build
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.ops import mas
    from jatts_torch.serving import BatchingServer, ServingBundle
    from jatts_torch.vocoder.hifigan import HiFiGANGenerator

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    nvcc_s = {}
    kernels = [k1.KERNEL, k1.KERNEL_TC, k1.KERNEL_TC_F32, k1.KERNEL_BWD, k1.KERNEL_BWD_TC, k1.KERNEL_BWD_TC_F32,
               mas.KERNEL]
    reports = build.build(kernels, seconds=nvcc_s)
    print(f"build: {', '.join(kernels)} in {time.perf_counter() - t0:.1f} s (nvcc each: "
          + ", ".join(f"{n} {sec:.1f} s" for n, sec in nvcc_s.items()) + ")", flush=True)
    spills = []
    for kernel, report in reports.items():
        entry = ""
        for line in report.splitlines():
            if "Compiling entry function" in line:
                entry = ptxas_entry(line)
            elif ("registers" in line or "spill" in line) and "(C75" not in line:
                print(f"  ptxas {kernel} {entry}: {line.strip()}", flush=True)
                spilled = re.search(r"(\d+) bytes spill stores", line)
                tc = (k1.KERNEL_TC, k1.KERNEL_TC_F32, k1.KERNEL_BWD_TC, k1.KERNEL_BWD_TC_F32)
                if kernel in tc and spilled and int(spilled.group(1)):
                    spills.append(entry)
    # the tensor-core kernels hold their accumulators in registers: a spill
    # there is a design fault, not a slowdown to live with
    check(not spills, f"ptxas spilled registers in {spills}")

    # 3. K1 against its plain version at the main path's shapes
    max_err = {"f32": 0.0, "bf16": 0.0}
    for dtype_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for (b, h, t, d), with_bias in (
            ((8, 2, 128, 192), True),    # encoder
            ((8, 2, 1024, 192), True),   # decoder
            ((8, 2, 1000, 192), False),  # ragged edge, MHA form (ab=None)
            ((2, 2, 1000, 192), True),   # ragged edge with bias
        ):
            q, k, v, ab, key_mask, lens = k1_inputs(b, h, t, d, dtype, with_bias, args.seed)
            tc_before = (k1.launches_tc, k1.launches_tc_f32)
            got = k1.flash_attention(q, k, v, ab, key_mask)
            torch.cuda.synchronize()
            ran = (k1.launches_tc - tc_before[0], k1.launches_tc_f32 - tc_before[1])
            check(ran == ((1, 0) if dtype == torch.bfloat16 else (0, 1)),
                  f"K1 {dtype_name}: bf16 must take the tensor-core kernel, f32 the 3xTF32 one; ran {ran}")
            want = k1.flash_attention_ref(
                q.float(), k.float(), v.float(), None if ab is None else ab.float(), key_mask
            )
            err = (got.float() - want).abs().max().item()
            check(math.isfinite(err), f"K1 {dtype_name} {(b, h, t, d)} not finite")
            print(
                f"K1 check {dtype_name} B,H,T,d={b},{h},{t},{d} bias={with_bias}: "
                f"max_abs_err {err:.3e} (tol {TOL[dtype_name]:.0e})", flush=True,
            )
            check(err <= TOL[dtype_name], f"K1 {dtype_name} {(b, h, t, d)} err {err} > tol")
            empty = [i for i, n in enumerate(lens) if n == 0]
            check(all(bool((got[i] == 0).all()) for i in empty), "K1: a row with no valid key is not 0")
            max_err[dtype_name] = max(max_err[dtype_name], err)
    tc_err = check_tc(args.seed)
    tc_f32_err = check_tc(args.seed + 50, "f32")

    # 4. timing at the decoder shape, bf16 (the tensor-core kernel)
    b, h, t, d = 8, 2, 1024, 192
    q, k, v, ab, _, _ = k1_inputs(b, h, t, d, torch.bfloat16, True, args.seed + 1)
    full = torch.ones(b, t, dtype=torch.bool, device="cuda")
    scale = d ** -0.5
    # SDPA adds its mask after the scale: the same function is mask = ab*scale
    sdpa_mask = (ab.float() * scale).to(torch.bfloat16)
    ms = time_ms(lambda: k1.flash_attention(q, k, v, ab, full, scale))
    plain_ms = time_ms(lambda: k1.flash_attention_ref(q, k, v, ab, full, scale))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask, scale=scale))
    bound_ms, bound_by, io, flops = k1_bound_ms(b, h, t, d, 2, True, "bf16")
    graph_k1_ms = graph_ms(lambda: k1.flash_attention(q, k, v, ab, full, scale))
    library_graph_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask, scale=scale))
    print(
        f"K1 time bf16 B,H,T,d={b},{h},{t},{d} (serving decoder, tensor-core kernel): kernel {ms:.4f} ms "
        f"(graph replay {graph_k1_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (graph replay "
        f"{library_graph_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
        f"({io / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {smi_line}", flush=True,
    )
    del q, k, v, ab, sdpa_mask
    where = smi_line
    k1_more = time_k1_more(args.seed + 4, where)

    # 5. K2 and K3 against their plain versions
    cases = mas_cases(args.seed)
    mas_checks = [check_mas(case, lp, tl, fl) for case, (lp, tl, fl) in cases.items()]

    # 6. their times at 16x1024x128
    k2_ms, k3_ms, k2_plain_ms, k3_plain_ms, k2_bound_ms, k3_bound_ms = time_mas(
        *cases["16x1024x128"], where)
    del cases

    # 7. the serving slice, at the full JSUT width, bf16, K1 on
    sr, max_frames, bucket, batch = 24000, 1024, 128, 8
    torch.manual_seed(args.seed)
    fs2 = FastSpeech2(idim=64, attn_backend="flash", device="cuda", dtype=torch.bfloat16)
    voc = HiFiGANGenerator(device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        # random init rounds most durations to 0; centre them on
        # max_frames / bucket frames per token so olens lands near max_frames
        fs2.duration_predictor.linear.weight.mul_(0.1)
        fs2.duration_predictor.linear.bias.fill_(math.log(1.0 + max_frames / bucket))
    rng = np.random.default_rng(args.seed)
    mel_mean = rng.normal(-4.0, 1.0, 80).astype(np.float32)
    mel_scale = rng.uniform(0.5, 2.0, 80).astype(np.float32)
    requests = [
        rng.integers(1, 64, size=int(n)).tolist() for n in rng.integers(40, bucket + 1, size=16)
    ]
    requests[0] = rng.integers(1, 64, size=bucket).tolist()  # one full bucket
    bundle = ServingBundle(
        fs2, voc, mel_mean, mel_scale, batch_size=batch, buckets=[bucket],
        max_frames=max_frames, wav_format="f32",
    )
    bundle.synthesize(requests[:batch])  # warm-up (cuDNN/cuBLAS plans)
    torch.cuda.synchronize()

    k1.reset_launches()
    t0 = time.perf_counter()
    with BatchingServer(bundle, max_delay_ms=20.0) as server:
        futures = [server.submit(token_ids=ids) for ids in requests]
        results = [f.result(timeout=600) for f in futures]
    served_s = time.perf_counter() - t0
    launches = k1.launches
    batches = server.stats["batches"]
    print(
        f"served {len(results)} requests in {batches} batches, {served_s:.3f} s; "
        f"K1 launches {launches}", flush=True,
    )
    check(launches > 0, "K1 was not launched on the main path")
    check(launches == 8 * batches, f"K1 launches {launches} != 8 per batch x {batches}")
    serve_tc = k1.launches_tc
    print(f"K1 launches on the tensor-core kernel: {serve_tc} of {launches}", flush=True)
    check(serve_tc == launches, f"{launches - serve_tc} bf16 K1 launches missed the tensor-core kernel")

    hop = voc.hop_size
    olens = []
    for i, r in enumerate(results):
        n = r["mel"].shape[0]
        olens.append(n)
        check(0 < n <= max_frames, f"request {i}: olens {n}")
        check(r["wav"].shape == (n * hop,), f"request {i}: wav {r['wav'].shape} != olens*hop")
        check(bool(np.isfinite(r["wav"]).all() and np.isfinite(r["mel"]).all()), f"request {i}: not finite")
    alone = bundle.synthesize([requests[3]])[0]
    diff = float(np.abs(alone["wav"] - results[3]["wav"]).max())
    print(f"request 3 alone vs in its batch: max |wav diff| {diff:.3e}", flush=True)
    check(alone["wav"].shape == results[3]["wav"].shape and diff <= 1e-3, "alone != batched")
    print(f"olens: min {min(olens)} max {max(olens)} mean {np.mean(olens):.1f} (max_frames {max_frames})")

    pcm = ServingBundle(
        fs2, voc, mel_mean, mel_scale, batch_size=batch, buckets=[bucket], max_frames=max_frames,
    )
    full_batch = requests[:batch]
    batch_ms = time_ms(lambda: pcm.synthesize(full_batch), iters=5, warmup=1)
    audio_s = sum(min(max_frames, n) for n in olens[:batch]) * hop / sr
    print(
        f"serving bf16 pcm16 B={batch} bucket={bucket} max_frames={max_frames}: "
        f"{batch_ms:.2f} ms per batch, RTF {batch_ms / 1e3 / audio_s:.5f} "
        f"({audio_s:.2f} s of audio; capacity RTF {batch_ms / 1e3 / (batch * max_frames * hop / sr):.5f}); "
        f"{smi_line}", flush=True,
    )

    # where the time of a served batch goes: FastSpeech2 vs HiFi-GAN, and
    # the device's busy share from a profiler trace of one batch
    xs, ilens = pcm.prepare(full_batch)
    with torch.no_grad():
        fs2_ms = time_ms(lambda: fs2.inference(xs, ilens, max_frames), iters=5, warmup=1)
        mel = fs2.inference(xs, ilens, max_frames)["feat_gen"]
        voc_ms = time_ms(lambda: voc(mel), iters=5, warmup=1)
    enc = k1_inputs(batch, 2, bucket, 192, torch.bfloat16, True, args.seed + 2)[:4]
    enc_mask = torch.ones(batch, bucket, dtype=torch.bool, device="cuda")
    k1_enc_ms = time_ms(lambda: k1.flash_attention(*enc, enc_mask))
    print(
        f"batch split: fastspeech2 {fs2_ms:.2f} ms (K1 4 x {k1_enc_ms:.4f} ms at T={bucket} "
        f"+ 4 x {ms:.4f} ms at T={max_frames}), hifigan {voc_ms:.2f} ms", flush=True,
    )
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pcm.synthesize(full_batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: op-level entries carry their kernels' time again
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms > 0, "profile of one batch: the profiler saw no device time")
    print(
        f"profile of one batch: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True,
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} {e.key[:90]}")

    # reference: the slice with K1 against the port's eager path, f32, small input
    torch.manual_seed(args.seed + 1)
    small = dict(idim=64, elayers=1, dlayers=1, device="cuda")
    ref_model = FastSpeech2(attn_backend="xla", **small)
    k1_model = FastSpeech2(attn_backend="flash", **small)
    k1_model.load_state_dict(ref_model.state_dict())
    for m in (ref_model, k1_model):
        with torch.no_grad():
            m.duration_predictor.linear.weight.mul_(0.1)
            m.duration_predictor.linear.bias.fill_(math.log(5.0))
    xs = torch.randint(1, 64, (2, 40), device="cuda")
    ilens = torch.tensor([40, 23], device="cuda")
    with torch.no_grad():
        want = ref_model.inference(xs, ilens, 256)
        got = k1_model.inference(xs, ilens, 256)
    check(torch.equal(want["duration"], got["duration"]), "durations differ between K1 and eager")
    feat_err = (want["feat_gen"] - got["feat_gen"]).abs().max().item()
    print(f"slice f32 K1 vs eager (1+1 blocks, B=2, T=40): feat_gen max_abs_err {feat_err:.3e} (tol 1e-3)")
    check(feat_err <= 1e-3, "feat_gen differs between K1 and eager")

    del fs2, voc, bundle, pcm, ref_model, k1_model

    # 8. the aligner slice; its corpus and durations feed phase 10
    tmp = tempfile.TemporaryDirectory(prefix="jatts_smoke_")
    k2_launches, k3_launches, own_check, align_paths, freqs = aligner_slice(args.seed, where, tmp.name)
    mas_checks.append(own_check)

    # 9. K1-bwd against its plain version, then its times
    bwd_err = {"f32": 0.0, "bf16": 0.0}
    for (b, h, t, d), dtype_name, with_bias in (
        ((32, 2, 1024, 192), "f32", True),   # the training decoder
        ((32, 2, 112, 192), "f32", True),    # the training encoder
        ((8, 2, 256, 64), "f32", True),
        ((8, 2, 256, 128), "f32", True),
        ((8, 2, 256, 256), "f32", True),
        ((8, 2, 1024, 192), "bf16", True),
        ((8, 2, 256, 256), "bf16", True),
        ((8, 2, 1024, 192), "f32", False),   # MHA form, no bias
        ((8, 2, 1000, 192), "f32", True),    # ragged edge
    ):
        err = check_k1bwd(b, h, t, d, dtype_name, with_bias, args.seed, against_autograd=(t == 1024 and b == 32))
        bwd_err[dtype_name] = max(bwd_err[dtype_name], err)
    bwd_times = time_k1bwd(args.seed + 3, where)

    # 10. the training slice
    train_launches, train = training_slice(tmp.name, align_paths, freqs, args.seed, where)

    # 11. K1b against its plain version, then its times
    k1b_err, k1b_times = k1b_phase(args.seed, where)

    # 12. the VALL-E AR slice
    valle_launches, valle_f32_launches, valle_own, valle = valle_slice(tmp.name, args.seed, where)

    # 13. K1r against its plain version, then its times
    k1r_fwd_err, k1r_bwd_err, k1r_times = k1r_phase(args.seed, where)

    # 14. the JVS-latest path: serving, then training on phase 8's corpus
    # with speaker embeddings
    jvs_serve_launches, jvs_serve = jvs_serving(args.seed, where)
    jvs_launches, jvs = training_slice(tmp.name, align_paths, freqs, args.seed, where, which="jvs")
    tmp.cleanup()
    # K2, K3, pair: differing elements over every case and the run's own
    # lattice; K2, K3: the largest |kernel - twin| seen there
    mas_mismatches = [sum(counts[i] for counts, _ in mas_checks) for i in range(3)]
    mas_max_err = [max(errs[i] for _, errs in mas_checks) for i in range(2)]

    mas_row = {"route": "cuda", "source": "jatts_torch/csrc/mas_viterbi.cu",
               "bound_by": "bytes", "library_ms": None}
    bwd_row = {"route": "cuda", "source": "jatts_torch/csrc/flash_attn_bwd.cu",
               "max_abs_err": max(bwd_err.values()), "plain_ms": bwd_times["plain_ms"],
               "library_ms": bwd_times["library_ms"]}
    train_k1 = k1_more["train"]
    # f32 rows: bound_ms on the tensor cores in 3xTF32, cuda_core_bound_ms the
    # same products as f32 FMAs (the yardstick before)
    train_scalar = train_launches[0] - train["fwd_tc_f32"]
    record = {"kernels": [{
        "name": k1.KERNEL,
        "route": "cuda",
        "source": "jatts_torch/csrc/flash_attn_fwd.cu",
        "replaces": "jatts_tpu/modules/attention.py:158",
        # f32 causal and d 256 only now: the bf16 launches are the tensor-core
        # kernel's, the f32 non-causal ones the 3xTF32 kernel's; timed at the
        # FS2 training decoder (f32, lse) on the 3xTF32 kernel's inputs
        "launches": launches - serve_tc + train_scalar,
        "launches_by_path": {"serving": launches - serve_tc, "training": train_scalar},
        "max_abs_err": tc_f32_err["scalar_k1"],
        "ms": k1_more["train_scalar"],
        "plain_ms": train_k1["plain_ms"],
        "bound_ms": train_k1["bound"][0],
        "bound_by": train_k1["bound"][1],
        "cuda_core_bound_ms": cuda_core_ms(train_k1["bound"][3]),
        "library_ms": train_k1["sdpa_ms"],
    }, {
        "name": k1.KERNEL_TC_F32,
        "route": "cuda",
        "source": "jatts_torch/csrc/flash_attn_fwd_tc_f32.cu",
        "replaces": "jatts_tpu/modules/attention.py:158",
        "launches": train["fwd_tc_f32"],
        "launches_by_path": {"training": train["fwd_tc_f32"]},
        "max_abs_err": max(max_err["f32"], tc_f32_err["k1"]),
        "ms": train_k1["ms"],
        "plain_ms": train_k1["plain_ms"],
        "bound_ms": train_k1["bound"][0],
        "bound_by": train_k1["bound"][1],
        "cuda_core_bound_ms": cuda_core_ms(train_k1["bound"][3]),
        "library_ms": train_k1["sdpa_ms"],
        "graph_ms": k1_more["train_graph"],
        "scalar_ms": k1_more["train_scalar"],
    }, {
        "name": f"{k1.KERNEL_TC_F32}_relpos",
        "route": "cuda",
        "source": "jatts_torch/csrc/flash_attn_fwd_tc_f32.cu",
        "replaces": "jatts_tpu/modules/attention.py:372",
        "launches": jvs["fwd_tc_f32"],
        "launches_by_path": {"training": jvs["fwd_tc_f32"]},
        "max_abs_err": max(k1r_fwd_err["f32"], tc_f32_err["k1r"]),
        "ms": k1r_times["fwd"],
        "plain_ms": k1r_times["plain_fwd_ms"],
        "bound_ms": k1r_times["bounds"]["fwd"][0],
        "bound_by": k1r_times["bounds"]["fwd"][1],
        "cuda_core_bound_ms": cuda_core_ms(k1r_times["bounds"]["fwd"][3]),
        "library_ms": k1r_times["sdpa_fwd_ms"],
        "graph_ms": k1r_times["fwd_graph"],
        "scalar_ms": k1r_times["fwd_scalar"],
    }, {
        "name": k1.KERNEL_TC,
        "route": "cuda",
        "source": "jatts_torch/csrc/flash_attn_fwd_tc.cu",
        "replaces": "jatts_tpu/modules/attention.py:158",
        "launches": serve_tc,
        "max_abs_err": max(max_err["bf16"], tc_err["k1"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        # a call replayed from a CUDA graph, without the host's time between launches
        "graph_ms": graph_k1_ms,
        "library_graph_ms": library_graph_ms,
        "encoder": {"ms": k1_more["enc"]["ms"], "graph_ms": k1_more["enc_graph"][0],
                    "bound_ms": k1_more["enc"]["bound"][0], "library_ms": k1_more["enc"]["sdpa_ms"],
                    "library_graph_ms": k1_more["enc_graph"][1]},
    }, {
        "name": f"{k1.KERNEL_TC}_relpos",
        "route": "cuda",
        "source": "jatts_torch/csrc/flash_attn_fwd_tc.cu",
        "replaces": "jatts_tpu/modules/attention.py:372",
        "launches": jvs_serve_launches,
        "max_abs_err": max(k1r_fwd_err["bf16"], tc_err["k1r"]),
        "ms": k1r_times["serve"]["fwd"],
        "plain_ms": k1r_times["serve"]["plain_fwd_ms"],
        "bound_ms": k1r_times["serve"]["bound"][0],
        "bound_by": k1r_times["serve"]["bound"][1],
        "library_ms": k1r_times["serve"]["sdpa_fwd_ms"],
        "graph_ms": k1r_times["serve"]["graph_ms"],
        "library_graph_ms": k1r_times["serve"]["sdpa_graph_ms"],
    }, {
        "name": "flash_attn_bwd_dkv",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "launches": train_launches[1], "ms": bwd_times["dkv"][0], "bound_ms": bwd_times["dkv"][1],
        "bound_by": bwd_times["dkv"][2], "cuda_core_bound_ms": bwd_times["dkv"][3], **bwd_row,
    }, {
        "name": "flash_attn_bwd_dq",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "launches": train_launches[2], "ms": bwd_times["dq"][0], "bound_ms": bwd_times["dq"][1],
        "bound_by": bwd_times["dq"][2], "cuda_core_bound_ms": bwd_times["dq"][3], **bwd_row,
    }, {
        "name": "mas_fwd", "replaces": "jatts_tpu/ops/mas_pallas.py:139", "launches": k2_launches,
        "mismatches": mas_mismatches[0] + mas_mismatches[2], "max_abs_err": mas_max_err[0], "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms, **mas_row,
    }, {
        "name": "mas_backtrace", "replaces": "jatts_tpu/ops/mas_pallas.py:161", "launches": k3_launches,
        "mismatches": mas_mismatches[1] + mas_mismatches[2], "max_abs_err": mas_max_err[1], "ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound_ms, **mas_row,
    }] + [{
        "name": name, "route": "cuda", "source": f"jatts_torch/csrc/{src}",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": n, "launches_by_path": by_path, "max_abs_err": err, "ms": times[key],
        "plain_ms": times["plain_fwd_ms" if key == "fwd" else "plain_bwd_ms"],
        "bound_ms": times["bounds"][key][0], "bound_by": times["bounds"][key][1],
        "library_ms": times[library],
        **extra,
    } for name, src, line, key, n, by_path, err, times, library, extra in (
        # VALL-E's bf16 forms: the tensor-core forward, dk/dv and dq; the library
        # call is SDPA with is_causal (every key valid in the timing)
        ("flash_attn_fwd_tc_causal", "flash_attn_fwd_tc.cu", 758, "fwd", valle_launches[0],
         {"valle_training": valle_launches[0]}, max(k1b_err["fwd_tc"], valle_own["fwd"]), k1b_times,
         "sdpa_causal_fwd_ms", {"graph_ms": k1b_times["fwd_graph"],
                                "noncausal_graph_ms_by_key_tiles": k1b_times["fwd_tiles_graph"],
                                "library_graph_ms": k1b_times["sdpa_causal_fwd_graph_ms"],
                                "library_backend": k1b_times["sdpa_causal_backend"],
                                "library_mask_ms": k1b_times["sdpa_mask_fwd_ms"]}),
        ("flash_attn_bwd_dkv_tc_causal", "flash_attn_bwd_tc.cu", 1121, "dkv", valle_launches[1],
         {"valle_training": valle_launches[1]}, max(k1b_err["dkv_tc"], valle_own["dk"], valle_own["dv"]),
         k1b_times, "sdpa_causal_ms", {"graph_ms": k1b_times["dkv_graph"],
                                       "library_backend": k1b_times["sdpa_causal_backend"],
                                       "library_mask_ms": k1b_times["sdpa_mask_ms"]}),
        ("flash_attn_bwd_dq_tc_causal", "flash_attn_bwd_tc.cu", 1456, "dq", valle_launches[2],
         {"valle_training": valle_launches[2]}, max(k1b_err["dq_tc"], valle_own["dq"]), k1b_times,
         "sdpa_causal_ms", {"graph_ms": k1b_times["dq_graph"],
                            "scalar_bf16_ms": k1b_times["dq_scalar_bf16"],
                            "library_backend": k1b_times["sdpa_causal_backend"],
                            "library_mask_ms": k1b_times["sdpa_mask_ms"]}),
        # the scalar forward, dk/dv and dq no longer run VALL-E's bf16 form:
        # phase 12's f32 flash step launches them, and they are timed in f32
        ("flash_attn_fwd_causal", "flash_attn_fwd.cu", 758, "fwd", valle_f32_launches[0],
         {"valle_training": 0, "valle_step_f32": valle_f32_launches[0]}, k1b_err["fwd"], k1b_times["f32"],
         "sdpa_fwd_ms", {"timed_dtype": "f32", "cuda_core_bound_ms": cuda_core_ms(k1b_times["f32"]["bounds"]["fwd"][3])}),
        ("flash_attn_bwd_dkv_causal", "flash_attn_bwd.cu", 1121, "dkv", valle_f32_launches[1],
         {"valle_training": 0, "valle_step_f32": valle_f32_launches[1]}, k1b_err["dkv"], k1b_times["f32"],
         "sdpa_ms", {"timed_dtype": "f32", "cuda_core_bound_ms": cuda_core_ms(k1b_times["f32"]["bounds"]["dkv"][3])}),
        ("flash_attn_bwd_dq_causal", "flash_attn_bwd.cu", 1456, "dq", valle_f32_launches[2],
         {"valle_training": 0, "valle_step_f32": valle_f32_launches[2]}, k1b_err["dq"], k1b_times["f32"],
         "sdpa_ms", {"timed_dtype": "f32", "cuda_core_bound_ms": cuda_core_ms(k1b_times["f32"]["bounds"]["dq"][3])}),
    )] + [{
        "name": f"{name}_relpos", "route": "cuda", "source": f"jatts_torch/csrc/{src}",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": n_serve + n_train, "launches_by_path": {"serving": n_serve, "training": n_train},
        "max_abs_err": err, "ms": k1r_times[f"{key}_scalar"],
        "plain_ms": k1r_times["plain_fwd_ms" if key == "fwd" else "plain_bwd_ms"],
        "bound_ms": k1r_times["bounds"][key][0], "bound_by": k1r_times["bounds"][key][1],
        "cuda_core_bound_ms": cuda_core_ms(k1r_times["bounds"][key][3]),
        "library_ms": k1r_times["sdpa_fwd_ms" if key == "fwd" else "sdpa_ms"],
    } for name, src, line, key, n_serve, n_train, err in (
        # the scalar K1r forward, dk/dv and dq no longer run on the main path:
        # bf16 is the tensor-core forward's, f32 the 3xTF32 kernels'; timed
        # beside them on the same inputs (the bf16 K1r backward stays here)
        ("flash_attn_fwd", "flash_attn_fwd.cu", 758, "fwd", 0, jvs_launches[0] - jvs["fwd_tc_f32"],
         tc_f32_err["scalar_k1r"]),
        ("flash_attn_bwd_dkv", "flash_attn_bwd.cu", 1121, "dkv", 0, jvs_launches[1] - jvs["bwd_tc_f32"][0],
         k1r_bwd_err["scalar"]),
        ("flash_attn_bwd_dq", "flash_attn_bwd.cu", 1456, "dq", 0, jvs_launches[2] - jvs["bwd_tc_f32"][1],
         k1r_bwd_err["scalar"]),
    )] + [{
        # K1r's f32 dk/dv and dq on the tensor cores (3xTF32), JVS-latest training
        "name": f"{k1.KERNEL_BWD_TC_F32}_{key}", "route": "cuda",
        "source": f"jatts_torch/csrc/{k1.KERNEL_BWD_TC_F32}.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": n, "launches_by_path": {"training": n}, "max_abs_err": k1r_bwd_err["tc_f32"],
        "ms": k1r_times[key], "graph_ms": k1r_times[f"{key}_graph"], "scalar_ms": k1r_times[f"{key}_scalar"],
        "plain_ms": k1r_times["plain_bwd_ms"], "bound_ms": k1r_times["bounds"][key][0],
        "bound_by": k1r_times["bounds"][key][1], "cuda_core_bound_ms": cuda_core_ms(k1r_times["bounds"][key][3]),
        "library_ms": k1r_times["sdpa_ms"], "library_backend": k1r_times["sdpa_backend"],
    } for key, line, n in (("dkv", 1121, jvs["bwd_tc_f32"][0]), ("dq", 1456, jvs["bwd_tc_f32"][1]))]}
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
