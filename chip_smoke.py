#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (jatts_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run with a non-zero exit:
  1. device: name, count and ``nvidia-smi`` name/power limit;
  2. build every hand-written kernel from ``jatts_torch/csrc`` (one ``nvcc``
     per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, f32 (TF32 off) and bf16, error beside tolerance;
  4. time each kernel, its plain version and one library call (yardstick
     only, never used by the port) with CUDA events, beside its bound;
  5. serve 16 requests through BatchingServer at the full JSUT width
     (FastSpeech2 adim 384, 4+4 conformer blocks, HiFi-GAN 512 ch, hop 300)
     in bf16 with ``attn_backend="flash"`` and seed-made weights, with the
     launch counts set to 0 just before and read just after; then check
     the output and the slice against the port's eager path on a small
     f32 input.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Exits 2 without a CUDA device or
without the jatts_torch package beside this file.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bf16": 989e12, "f32": 67e12}

# K1 tolerances on max |kernel - plain|: f32 differs by summation order only;
# bf16 output is rounded once to bf16 (half an ulp is 2^-8 |o|, |o| < 4 here)
TOL = {"f32": 1e-4, "bf16": 1e-2}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_inputs(b, h, t, d, dtype, with_bias, seed):
    """Main-path-like K1 inputs: bias at the scale of q·kᵀ, varied key
    lengths including a full row, one key and no valid key."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    ab = None
    if with_bias:
        ab = (torch.randn(b, h, t, t, device="cuda", generator=g) * math.sqrt(d)).to(dtype)
    lens = [t, t - 1, (3 * t) // 4, t // 2, 17, 1, 0, t - 63][:b]
    key_mask = torch.arange(t, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
    return q, k, v, ab, key_mask, lens


def k1_bound_ms(b, h, t, d, elem_bytes, with_bias, dtype_name):
    io = 4 * b * h * t * d * elem_bytes + b * t  # q, k, v, out, key mask
    if with_bias:
        io += b * h * t * t * elem_bytes
    flops = 4 * b * h * t * t * d  # every key valid in the timing inputs
    t_bytes = io / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), io, flops


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
    reports = build.build([k1.KERNEL])
    print(f"build: {k1.KERNEL} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in reports[k1.KERNEL].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

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
            got = k1.flash_attention(q, k, v, ab, key_mask)
            torch.cuda.synchronize()
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

    # 4. timing at the decoder shape, bf16
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
    print(
        f"K1 time bf16 B,H,T,d={b},{h},{t},{d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({io / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {name}, {smi_line}", flush=True,
    )
    del q, k, v, ab, sdpa_mask

    # 5. the slice: serving at the full JSUT width, bf16, K1 on
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
        f"{name}, {smi_line}", flush=True,
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
    if busy_ms > 0:
        print(
            f"profile of one batch: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
            f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True,
        )
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} {e.key[:90]}")
    else:
        print("profile of one batch: the profiler saw no device time (not measured)")

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

    record = {"kernels": [{
        "name": k1.KERNEL,
        "route": "cuda",
        "source": "jatts_torch/csrc/flash_attn_fwd.cu",
        "replaces": "jatts_tpu/modules/attention.py:158",
        "launches": launches,
        "max_abs_err": max(max_err.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
