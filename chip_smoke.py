#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (jatts_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run with a non-zero exit:
  1. device: name, count and ``nvidia-smi`` name/power limit;
  2. build every hand-written kernel from ``jatts_torch/csrc`` (one ``nvcc``
     per source, all at once);
  3. K1 (flash attention) against its plain PyTorch version on the card at
     the serving path's shapes, f32 (TF32 off) and bf16, error beside
     tolerance;
  4. K1's time, its plain version's and one library call's (yardstick only,
     never used by the port) with CUDA events, beside its bound;
  5. K2 (MAS forward) and K3 (MAS backtrace), each against its plain twin
     and the pair against the plain search, count of differing elements
     beside the limit 0, at 16x1024x128, at a ragged width, on edge-case
     lengths, on a quantised input full of ties, at the widest block and
     over more frames than K3 stages at once;
  6. K2's and K3's times at 16x1024x128, the plain versions' and the bound;
  7. the serving slice: 16 requests through BatchingServer at the full JSUT
     width (FastSpeech2 adim 384, 4+4 conformer blocks, HiFi-GAN 512 ch,
     hop 300) in bf16 with ``attn_backend="flash"`` and seed-made weights,
     with the launch counts set to 0 just before and read just after; then
     the output checks and the slice against the port's eager path on a
     small f32 input;
  8. the aligner slice: a synthetic tone corpus (64 utterances, wavs and
     csvs in a temporary directory) through ``jatts_torch/bin/align.py:run``
     with the JSUT feature settings and the CLI's defaults (adim 256, 2
     layers, batch 16, f32), launch counts set to 0 just before and read
     just after; then the duration invariants, the accuracy against the
     known alignment, the same dump with ``mas_backend="scan"``, K2 and K3
     against their twins on the largest batch's lattice, and the time of a
     training step and its parts.
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
import tempfile
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


def print_unported_bounds():
    """Bounds of the attention kernels that are not ported yet, from the
    shapes the JAX package's recipes give them (no time: nothing to run)."""
    # K1b, causal form without bias: VALL-E trunk, d_model 1024 / 16 heads
    # (egs/hificaptain_jp_female/tts3/conf), per-card batch 16, S ~ 1536, bf16
    b, h, t, d = 16, 16, 1536, 64
    io = 4 * b * h * t * d * 2 + b * t
    flops = 4 * b * h * t * t * d // 2  # the causal half
    t_bytes, t_ops = io / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS_S["bf16"] * 1e3
    print(
        f"K1b bound (not ported) causal bf16 B,H,T,d={b},{h},{t},{d}: {max(t_bytes, t_ops):.4f} ms by "
        f"{'bytes' if t_bytes >= t_ops else 'operations'} ({io / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
        f"{flops / 1e9:.1f} GFLOP -> {t_ops:.4f} ms)", flush=True,
    )
    # K1-bwd at K1's decoder shape with the dense bias: reads q, k, v, out,
    # d(out), ab and the row log-sum-exp, writes dq, dk, dv, d(ab); five
    # products (scores again, dv, dp, dq, dk) of 2*T*T*d each
    b, h, t, d = 8, 2, 1024, 192
    io = 8 * b * h * t * d * 2 + 2 * b * h * t * t * 2 + b * h * t * 4 + b * t
    flops = 10 * b * h * t * t * d
    t_bytes, t_ops = io / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS_S["bf16"] * 1e3
    print(
        f"K1-bwd bound (not ported) bf16 B,H,T,d={b},{h},{t},{d} with bias: {max(t_bytes, t_ops):.4f} ms "
        f"by {'bytes' if t_bytes >= t_ops else 'operations'} ({io / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
        f"{flops / 1e9:.1f} GFLOP -> {t_ops:.4f} ms)", flush=True,
    )


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
    return paths, truth


def frame_accuracy(ds, durs):
    """Fraction of frames assigned to the right phone index."""
    import numpy as np

    pred = np.repeat(np.arange(len(ds)), ds)
    true = np.repeat(np.arange(len(durs)), durs)
    n = min(len(pred), len(true))
    return float(np.mean(pred[:n] == true[:n]))


def aligner_slice(seed, where):
    """Phase 8. Returns (K2 launches, K3 launches) of the main-path run and
    what check_mas found on the run's own largest lattice."""
    import numpy as np
    import torch

    from jatts_torch import aligner
    from jatts_torch.bin import align as align_cli
    from jatts_torch.losses.align import ForwardSumLoss
    from jatts_torch.ops import mas
    from jatts_torch.utils.io import read_audio, read_csv

    sr, hop = ALIGN_CONFIG["sampling_rate"], ALIGN_CONFIG["hop_size"]
    with tempfile.TemporaryDirectory(prefix="jatts_align_") as root:
        paths, truth = write_tone_corpus(root, seed)
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
    return k2_launches, k3_launches, own_check


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
    reports = build.build([k1.KERNEL, mas.KERNEL])
    print(f"build: {k1.KERNEL}, {mas.KERNEL} in {time.perf_counter() - t0:.1f} s", flush=True)
    for kernel, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {kernel}: {line.strip()}", flush=True)

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
        f"({io / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {smi_line}", flush=True,
    )
    del q, k, v, ab, sdpa_mask
    print_unported_bounds()
    where = smi_line

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

    # 8. the aligner slice
    k2_launches, k3_launches, own_check = aligner_slice(args.seed, where)
    mas_checks.append(own_check)
    # K2, K3, pair: differing elements over every case and the run's own
    # lattice; K2, K3: the largest |kernel - twin| seen there
    mas_mismatches = [sum(counts[i] for counts, _ in mas_checks) for i in range(3)]
    mas_max_err = [max(errs[i] for _, errs in mas_checks) for i in range(2)]

    mas_row = {"route": "cuda", "source": "jatts_torch/csrc/mas_viterbi.cu",
               "bound_by": "bytes", "library_ms": None}
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
    }, {
        "name": "mas_fwd", "replaces": "jatts_tpu/ops/mas_pallas.py:139", "launches": k2_launches,
        "mismatches": mas_mismatches[0] + mas_mismatches[2], "max_abs_err": mas_max_err[0], "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms, **mas_row,
    }, {
        "name": "mas_backtrace", "replaces": "jatts_tpu/ops/mas_pallas.py:161", "launches": k3_launches,
        "mismatches": mas_mismatches[1] + mas_mismatches[2], "max_abs_err": mas_max_err[1], "ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound_ms, **mas_row,
    }]}
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
