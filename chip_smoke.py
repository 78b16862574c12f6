#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (jatts_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run with a non-zero exit:
  1. device: name, count and ``nvidia-smi`` name/power limit;
  2. build every hand-written kernel from ``jatts_torch/csrc`` (one ``nvcc``
     per source, all at once; each one's seconds and ptxas report printed;
     a register spill in a tensor-core kernel or in the fused MAS search,
     ``mas_path.cu``, fails the run);
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
  5. the fused MAS search (``mas_path.cu``, K2 and K3 in one launch: its
     path against the plain search, its ``bits_out`` against the packed
     plain decisions, with the bits in shared memory where they fit and
     through device memory at a capacity of 4 frames, each route printed),
     K2 (MAS forward) and K3 (MAS backtrace) each against its plain twin and
     the pair against the plain search, count of differing elements beside
     the limit 0, at 16x1024x128, at a ragged width, on edge-case lengths,
     on a quantised input full of ties, at the widest block (its bits past
     shared memory) and over more frames than K3 stages at once;
  6. at 16x1024x128: the fused search's time by CUDA events and by graph
     replay beside the K2+K3 pair's on the same inputs, the plain search's,
     the byte bound and the chain floor (``jatts_torch/bin/study_mas.py``'s
     bare max+add recurrence, measured here, times the longest utterance's
     frames); K2's and K3's own times, plain versions and bounds;
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
     just after (every search on the fused kernel, steps + dump batches
     launches, none of K2 or K3); then the duration invariants, the
     accuracy against the known alignment, the same dump with
     ``mas_backend="scan"`` (0 durations differ, no kernel launched), the
     MAS kernels against their twins and phase 6's times on the largest
     batch's lattice, and the time of a training step and its parts;
  9. K1-bwd (flash-attention backward: the dk/dv kernel and the dq/d(ab)
     kernel) against its plain version for each output, per batch item, at
     the training shapes and at other head dims, in f32 and bf16, with and
     without bias, at a ragged length, with a masked leading key tile and
     with rows of no valid key (their dq and d(ab), unseen keys' dk and dv,
     masked keys' d(ab) exactly 0); the f32 d 192 forms on the 3xTF32
     tensor-core kernels (``flash_attn_bwd_tc_f32.cu``), the bf16 d 192
     form with a bias on the bf16 tensor-core kernels
     (``flash_attn_bwd_tc_bias.cu``; at T 1024 and 1000, the bias a TMA
     box, and at 999 with a masked leading key tile and 1, the bias by
     cp.async windows), each launch checked from the counters, the
     same bits on a second run, the scalar kernels checked on the same
     inputs; every other form on the scalar ones;
     against autograd through K1's plain version; then the kernels' times at
     the training decoder by CUDA events and graph replay beside the scalar
     kernels' on the same inputs, the plain version's, SDPA
     forward+backward's (the yardstick, never used by the port) and the
     bounds, and their error against float64 beside the scalar kernels' and
     the plain f32 backward's;
 10. the training slice: phase 8's corpus and durations become .npz dumps
     (log-mel, per-token log tone frequency as pitch, per-token energy),
     and ``jatts_torch/bin/tts_train.py:run`` trains FastSpeech2 at the full
     JSUT width (egs/jsut/tts1/conf/fastspeech2.v1.yaml, batch 32, f32) with
     ``attn_backend: flash`` for 50 steps (warm-up 25), launch counts set
     to 0 just before and read just after (every forward on the 3xTF32
     tensor-core kernel, none on the scalar one or the bf16 one; every dk/dv
     and dq on the 3xTF32 backward kernels, none on the scalar ones); then
     the loss, launch,
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
     accumulation 2, AdamW) with ``attn_backend: flash`` for 50 steps
     (warm-up 25), launch counts set to 0 just before and read just after
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
     and dq on the 3xTF32 tensor-core kernels (``flash_attn_bwd_tc_f32.cu``),
     the bf16 ones on the bf16 tensor-core kernels
     (``flash_attn_bwd_tc_relpos.cu``; each launch checked from the
     counters), with the same bits on a second run and for an item alone,
     the scalar ones checked on the same inputs;
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
     utterance (4 synthetic speakers) trains 50 steps through
     ``jatts_torch/bin/tts_train.py:run`` (f32, batch 32, warm-up 25), launch
     counts set to 0 just before and read just after (K1r 8 launches a step
     each, every forward on the 3xTF32 kernel and every dk/dv and dq on the
     3xTF32 backward kernels, no K1 or K1-bwd launch); the loss, bitwise
     resume, a step's time
     and parts, a profiled step, and the same step under ``attn_backend:
     xla`` (the eager rel_shift_gather path) on the same weights and batch;
 15. the tts1 recipe, stages 1-4, through the port's CLIs on phase 8's
     aligned corpus (egs/jsut/tts1/conf/fastspeech2.v1.yaml): stage 1
     (``bin/preprocess.py``: log-mel, NCCF pitch and energy on the card,
     ``.npz`` dumps; timed, profiled, 4 utterances held against the same
     CLI on the CPU), ``Dio``'s f0 on the card against known-truth glottal
     pulse trains, stages 1b and 2 (``bin/compute_statistics.py``,
     ``bin/generate_token_list.py``), stage 3 (``bin/tts_train.main`` with
     ``--attn-backend flash``, 50 steps on those dumps) and stage 4
     (``bin/tts_decode.main``, batch 8, 2048 frames, with a seed-made
     HiFi-GAN checkpoint in parallel_wavegan's layout and again with
     ``--vocoder griffin_lim``; every K1 launch on the 3xTF32 kernel, 8 a
     batch; the mels against ``FastSpeech2.inference``, the wavs against
     the generator on torch-folded weights and Griffin-Lim on the CPU);
 16. the Matcha family at the JSUT width (f32, TF32 off): 16 requests
     through BatchingServer on egs/jsut/tts1/conf/matcha_tts.v1.prior.steplr.large.yaml
     as it stands (seed-made weights, phase 7's HiFi-GAN, 10 ODE steps),
     with every launch count at 0 just before and read just after (none:
     Matcha's attention runs eager, as in the JAX package), the seed (same
     bits; another seed, other audio) and the served mel against
     ``MatchaTTS.inference`` on the same noise; then phase 8's corpus as
     mel-only dumps trains Matcha-TTS (tts1, 50 steps, batch 32) and
     Matcha-TTS+MAS (egs/jsut/tts2/conf/matcha_tts.mas.v1.yaml, 50 steps,
     batch 16, its gates cut to 20 and 30 steps) through
     ``jatts_torch/bin/tts_train.py:run``, launch counts set to 0 just
     before and read just after (tts2: one fused MAS search a step, no K2 or
     K3, no flash; tts1: none); the falling loss, each gate, the last two
     steps replayed bitwise from the interval checkpoint (deterministic
     cuDNN), the tts2 step's own lattice through the MAS checks, the same
     step under ``mas_backend: scan`` (identical durations and losses), a
     step's time and parts, the CTC loop's and the fused search's shares;
 17. mel-VITS at the JSUT width (egs/jsut/tts2/conf/vits.v1.bs32.yaml as it
     stands: adim 384, a 6-block text encoder, a 16-layer posterior
     WaveNet, 4 couplings x 4 layers, a 4-block decoder of 1536 units; f32,
     TF32 off; seed-made weights, the flows' projections non-zero): 16
     requests through BatchingServer with phase 7's HiFi-GAN and
     ``noise_scale`` 0.667 (0 launches; the seed; the served mel against
     ``VITS.inference`` on the same generator; the inverse flow's and the
     decoder's times); then phase 8's corpus as mel-only dumps trains 50
     micro-steps through ``jatts_torch/bin/tts_train.py:run`` (batch 8,
     accumulation 4, the gates cut to 20 and 30 steps), launch counts set
     to 0 just before and read just after (one fused MAS search a
     micro-step, each held against the plain search on its own lattice as
     the run goes; no K2, K3 or flash), the gates, the mel and KL losses on
     a fixed batch before and after, the last two micro-steps replayed
     bitwise from ``checkpoint-48steps``, the largest lattice through the
     MAS checks, a micro-step's time with and without the forward-sum loss,
     the CTC loop's and the fused search's shares; then ``bin/tts_decode.py``
     on the trained checkpoint (its duration bias centred) with phase 15's
     HiFi-GAN checkpoint and with Griffin-Lim, the mels against
     ``VITS.inference``;
 18. the VALL-E NAR: phase 12's codec corpus trains 100 micro-steps through
     ``jatts_torch/bin/tts_train.py:run`` on
     egs/hificaptain_jp_female/tts3/conf/valle_nar.given.bs32.yaml as it
     stands (d_model 1024, 16 heads, 12 layers, 7 levels, bf16 compute,
     batch 16 x accumulation 2, AdamW, warm-up 50) with ``attn_backend:
     flash``, launch counts set to 0 just before and read just after (every
     forward on the tensor-core kernel, every dk/dv and dq on the
     non-causal tensor-core forms of ``flash_attn_bwd_tc.cu``, 12 a
     micro-step, nothing else); the falling loss, micro-steps 98-99
     replayed bitwise from ``checkpoint-98steps`` with the same levels
     drawn, a micro-step's time and a profiled one, the same step under
     ``attn_backend: xla`` (bf16, then f32 on 4 rows); the non-causal dk/dv
     and dq against the plain backward at the run's largest batch and on
     ragged forms (a row with one valid key, one with none, S = 1, Tq !=
     Tk), their bits on a second run, the scalar kernels on the same
     inputs, the autograd chain; their times by CUDA events and graph
     replay beside the scalar kernels', the plain versions', SDPA's with a
     boolean key mask (the yardstick, never used by the port) and the
     bounds; then ``bin/ttslm_decode.py`` on 4 dev rows with phase 12's AR
     and this NAR (bf16 parameters, 256 steps): codes [T, 8] in the
     codebook, level 0 the AR's output (row 0 also against ``ar_generate``
     called directly), every fill against ``nar_generate`` called directly
     with the CLI's generator;
 19. E2-TTS: a 64-utterance 48 kHz tone corpus (3-12 s, each row's prompt
     the next utterance) through stages 1, 1b and 2 at the features of
     egs/hificaptain_jp_female/tts2/conf/e2tts.v1.yaml; 8 requests served
     through BatchingServer on an ``E2ttsServingBundle`` at the conf's
     width (dim 1024, depth 24, 16 heads of d 64, bf16, flash, seed-made
     weights; 32 ODE steps with CFG 2 as one doubled-batch forward, sway
     -1, capacity 3000 frames; batch 4, text buckets 64/128/256), launch
     counts set to 0 just before and read just after (24 tensor-core
     forwards an ODE step, nothing else), every served mel against
     ``E2TTS.inference`` on the same generator bit for bit, another seed
     another mel; the conf as it stands trains 100 micro-steps through
     ``bin/tts_train.py:run`` (frame budget 8640, max_samples 32,
     accumulation 4, AdamW, ``e2tts_sequentiallr`` with warm-up 25, EMA,
     flash; every forward on the tensor-core kernel and every dk/dv and dq
     on the non-causal tensor-core forms, 24 a micro-step, nothing else),
     the falling loss, micro-steps 98-99 replayed bitwise from
     ``checkpoint-98steps`` with the same draws, a micro-step's time and a
     profiled one, the same step under ``xla`` (bf16, then f32 on 2 rows),
     the kernels per item against their plain versions at the run's largest
     batch and their times beside the bounds and SDPA; the served forward
     at (8, 16, 3001, 64) and the decode's at (2, 16, 3001, 64) against
     their plain versions and timed; then ``bin/e2tts_decode.py`` on 4 dev
     rows with the trained checkpoint's EMA weights and Griffin-Lim, each
     mel against ``E2TTS.inference`` with the CLI's generator;
 20. the serving artifact (``jatts_torch/serving/export.py``): FastSpeech2
     at the JSUT conf's width (bf16, flash, seed-made weights) + HiFi-GAN
     exported as a pcm16 wav artifact and as a mel artifact with a stream
     step (chunk 128), B=8, text buckets 32/64/128, 1024 frames, each loaded
     on the card (one CUDA graph a bucket and one of the stream step; the
     artifact's MiB, the load-and-capture seconds and the graph pool's
     bytes printed); each bucket's replay against the eager program bit for
     bit (wav, olens) with 8 K1 tc launches a replay; 10 batches eager and
     replayed in turns (median ms, RTF); time to first audio and ms a chunk,
     the chunks against the wav artifact within 1 LSB (the differing samples
     counted); 16 requests through BatchingServer, 8 streamed and 8 whole;
     the fused VALL-E AR+NAR program at the tts3 confs' width (bf16
     parameters, 4 rows, max_steps 256; the prefix, one AR step and the NAR
     fill as graphs) against the eager program on the same seed code for
     code, ms an AR step replayed and eager; the E2-TTS artifact (the conf as
     it stands, 4 requests, capacity 3000, 32 steps; one graph of the whole
     CFG Euler loop) against the in-process bundle bit for bit. The kernels'
     counters count Python calls, once at a capture: the record counts a
     replayed program's launches as launches a replay times replays;
 21. mixed precision (``model_params.dtype`` as flax's compute dtype): the
     JSUT and JVS-latest FastSpeech2 steps at 24 x 896 x 112 on seed-made
     weights at the confs' widths, f32 and bf16 compute under ``xla`` and
     ``flash`` (median ms of 10 steps after 2, device-busy ms of a profiled
     step, peak GiB, the launches of each forward and backward route, held
     to the dispatch rules; the two dtypes' first-step losses within 2e-2);
     the bf16 backwards a bf16 flash step takes (K1-bwd with the
     ``matrix_bd`` bias at d 192 on its bf16 tensor-core kernels, 8 dk/dv
     and 8 dq a JSUT step; K1r's (576, 192) on its bf16 tensor-core kernels;
     no launch on the scalar ones, which are checked and timed beside on the
     same inputs) against their plain twins at the step's shapes, timed by
     CUDA events and graph replay beside the plain backward, SDPA's
     forward+backward (each new kernel must be under it) and the bounds;
     Matcha-TTS's tts1 step at 16 x 704 x 96 and a VITS micro-step at 8 x
     896 x 112 past ``dp_train_start_steps``, f32 and bf16 alternating in 3
     rounds of 10 steps, each dtype's host profile (op events, casts and
     the host ms inside them); then
     ``bin/tts_train.py`` on the JSUT conf with ``dtype: bfloat16`` and
     flash for 4 steps over two eval intervals (every dk/dv and dq on
     K1-bwd's bf16 tensor-core kernels with its bias): the intermediate hook's
     files (valid PNGs) and the event file read back by
     ``jatts_torch/utils/events.py`` with every CRC checked and ``mem/*``.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Exits 2 without a CUDA device or
without the jatts_torch package beside this file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
            if name.group(1) in ("flash_attn_bwd_tc_f32_kernel", "flash_attn_bwd_tc_relpos_kernel") and not {
                    "dq", "dk/dv"} & set(args):
                args.append("dq" if rest[2] == "1" else "dk/dv")  # <D_QK, D_V, DQ(, BIAS)>
            elif name.group(1) == "flash_attn_bwd_tc_f32_kernel":
                args.append("bias" if rest[2] == "1" else "no bias")
            elif name.group(1) == "mas_path_kernel":
                args.append("halo" if rest[2] == "1" else "one warp")  # <R, HALO>
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
    mas_backtrace_ref, the pair against mas_path_ref, and the fused search
    (``csrc/mas_path.cu``: its path, and its ``bits_out`` against the packed
    twin bits) with the bits in shared memory where they fit and through
    device memory (a capacity of 4 frames' words). Returns the five counts
    of differing elements (K2 words, K3 frames, pair frames, fused frames,
    fused words), the largest |kernel - twin| of K2's decisions (0 or 1 a
    bit), of K3's token indices and of the fused path's, and the fused
    search's routes; fails the run unless every count is 0."""
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
    search_ref = mas.mas_path_ref(lp, tl, fl)
    n_pair = int((pair != search_ref).sum())
    n_fused = n_fused_bits = err_fused = 0
    routes = []
    for capacity in (mas.SMEM_BITS_BYTES, 4 * 4 * ((t_text + 31) // 32)):
        before = dict(mas.path_routes)
        fused = mas.mas_path_fused(lp, tl, fl, smem_bits_bytes=capacity)
        fused_b, fused_bits = mas.mas_path_fused(lp, tl, fl, return_bits=True, smem_bits_bytes=capacity)
        torch.cuda.synchronize()
        routes.append(next(r for r in mas.path_routes if mas.path_routes[r] > before[r]))
        n_fused += int((fused != search_ref).sum()) + int((fused_b != search_ref).sum())
        err_fused = max(err_fused, int((fused - search_ref).abs().max()), int((fused_b - search_ref).abs().max()))
        n_fused_bits += int((fused_bits != bits_ref).sum())
    print(
        f"K2/K3 check {name} (B,T_feats,T_text={tuple(lp.shape)}): K2 {n_k2} of {bits.numel()} "
        f"words differ, K3 {n_k3} of {path.numel()} frames, pair {n_pair} of {pair.numel()} "
        f"frames; fused search (routes {'+'.join(routes)}) {n_fused} of {2 * 2 * pair.numel()} frames, "
        f"bits_out {n_fused_bits} of {2 * bits.numel()} words (limit 0)", flush=True,
    )
    check(n_k2 == 0 and n_k3 == 0 and n_pair == 0, f"MAS kernels disagree with their twins at {name}")
    check(n_fused == 0 and n_fused_bits == 0, f"the fused MAS search disagrees with the plain version at {name}")
    return (n_k2, n_k3, n_pair, n_fused, n_fused_bits), (err_k2, err_k3, err_fused), routes


def mas_bounds_ms(tl, fl, t_feats, t_text):
    """Least time for K2, K3 and the fused search by bytes, for these
    lengths. K2 needs lp only at tokens below text_len (the rest is masked)
    and writes every packed word; K3 needs the bits only of frames below
    feats_len (the rest is pinned) and writes every frame's index. The fused
    search reads lp at tokens below text_len of frames below feats_len, the
    lengths, and writes the path: no bits. The operations (a max, an add and
    a compare a needed cell, f32 on the CUDA cores) are far below."""
    b = tl.numel()
    n_words = (t_text + 31) // 32
    cells = int(tl.clamp(0, t_text).sum()) * t_feats
    frames = int(fl.clamp(0, t_feats).sum())
    fused_cells = int((tl.clamp(0, t_text) * fl.clamp(0, t_feats)).sum())
    k2_bytes = cells * 4 + b * 4 + b * t_feats * n_words * 4
    k3_bytes = frames * n_words * 4 + 2 * b * 4 + b * t_feats * 4
    fused_bytes = fused_cells * 4 + 2 * b * 4 + b * t_feats * 4
    k2_ops_ms = 3 * cells / PEAK_FLOPS_S["f32"] * 1e3
    fused_ops_ms = 3 * fused_cells / PEAK_FLOPS_S["f32"] * 1e3
    k2_ms, k3_ms = k2_bytes / PEAK_BYTES_S * 1e3, k3_bytes / PEAK_BYTES_S * 1e3
    fused_ms = fused_bytes / PEAK_BYTES_S * 1e3
    check(k2_ops_ms < k2_ms and fused_ops_ms < fused_ms, "MAS bounds: operations above bytes")
    return k2_ms, k2_bytes, k3_ms, k3_bytes, fused_ms, fused_bytes


def time_mas(lp, tl, fl, where, floors):
    """K2's and K3's times, their plain versions' and bounds, and the fused
    search's by CUDA events and by graph replay beside the K2 then K3 pair
    on the same inputs, the plain search, the byte bound and the chain
    floor (``floors``: ``study_mas.floors()``'s ns a step of the bare
    recurrence, times the longest utterance's T_feats - 1 steps). Returns a
    dict of ms."""
    from jatts_torch.ops import mas

    t_text = lp.shape[2]
    bits = mas.mas_decisions(lp, tl)
    k2_ms = time_ms(lambda: mas.mas_decisions(lp, tl))
    k3_ms = time_ms(lambda: mas.mas_backtrace(bits, tl, fl, t_text))
    d_ref = mas.unpack_bits(bits, t_text)
    k2_plain = time_ms(lambda: mas.mas_decisions_ref(lp, tl), iters=2, warmup=1)
    k3_plain = time_ms(lambda: mas.mas_backtrace_ref(d_ref, tl, fl), iters=2, warmup=1)
    b, t_feats, _ = lp.shape
    k2_bound, k2_bytes, k3_bound, k3_bytes, fused_bound, fused_bytes = mas_bounds_ms(tl, fl, t_feats, t_text)
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
    ms = time_ms(lambda: mas.mas_path_fused(lp, tl, fl))
    gms = graph_ms(lambda: mas.mas_path_fused(lp, tl, fl))
    pair_ms = time_ms(lambda: mas.mas_path_cuda(lp, tl, fl))
    pair_gms = graph_ms(lambda: mas.mas_path_cuda(lp, tl, fl))
    plain_ms = time_ms(lambda: mas.mas_path_ref(lp, tl, fl), iters=2, warmup=1)
    walk = max(int(fl.clamp(1, t_feats).max()) - 1, 1)
    floor_ms = walk * floors["max_add"][1] / 1e6
    print(
        f"fused MAS search f32 {b}x{t_feats}x{t_text}: kernel {ms:.4f} ms (graph replay {gms:.4f} ms, "
        f"{gms * 1e6 / walk:.1f} ns per frame of the longest utterance's {walk}), K2+K3 pair {pair_ms:.4f} ms "
        f"(graph replay {pair_gms:.4f} ms), plain {plain_ms:.2f} ms, bound {fused_bound:.5f} ms by bytes "
        f"({fused_bytes / 1e6:.2f} MB at these lengths), chain floor {floor_ms:.5f} ms ({walk} dependent "
        f"max+add at {floors['max_add'][1]:.3f} ns, {floors['max_add'][0]:.2f} cycles); {where}", flush=True,
    )
    return {"k2_ms": k2_ms, "k3_ms": k3_ms, "k2_plain": k2_plain, "k3_plain": k3_plain, "k2_bound": k2_bound,
            "k3_bound": k3_bound, "ms": ms, "graph_ms": gms, "pair_ms": pair_ms, "pair_graph_ms": pair_gms,
            "plain_ms": plain_ms, "bound_ms": fused_bound, "chain_floor_ms": floor_ms}


# ---------------------------------------------------------------------------
# the aligner slice
# ---------------------------------------------------------------------------

ALIGN_CONFIG = {  # egs/jsut/tts1/conf/fastspeech2.v1.yaml, the feature settings
    "sampling_rate": 24000, "fft_size": 2048, "hop_size": 300, "win_length": None,
    "num_mels": 80, "fmin": 80, "fmax": 7600,
}
ALIGN_STEPS = 200  # the CLI's default is 2000 (300 before phase 21 needed the run's time)


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


def aligner_slice(seed, where, root, floors):
    """Phase 8, on a corpus written under ``root`` (kept for phase 10).
    Returns the (fused search, K2, K3) launches of the main-path run, what
    check_mas found on the run's own largest lattice, the MAS times there
    (time_mas), the csv paths and the phones' tone frequencies."""
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
    launches = (mas.path_launches, mas.fwd_launches, mas.backtrace_launches)
    routes = dict(mas.path_routes)
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
        f"{ALIGN_STEPS} steps, whole run {run_s:.1f} s; fused MAS search launches {launches[0]} (routes "
        f"{routes}), K2 launches {launches[1]}, K3 launches {launches[2]} (steps + dump batches = "
        f"{ALIGN_STEPS + n_batches})", flush=True,
    )
    check(len(rows) == len(items) == 64 and out["n_skipped"] == 0, "rows were skipped")
    check(launches[0] > 0, "the fused MAS search was not launched on the aligner path")
    check(launches[0] == ALIGN_STEPS + n_batches, f"fused MAS launches {launches[0]} != steps + dump batches")
    check(launches[1:] == (0, 0), f"K2/K3 launched on the aligner path: {launches[1:]}")
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
    check((mas.path_launches, mas.fwd_launches, mas.backtrace_launches) == launches,
          "the plain search launched a kernel")

    # the MAS kernels against their twins at the main path's own largest shape
    big = max(batches, key=lambda b: b["ys"].shape[1] * b["xs"].shape[1])
    xs, ilens, ys, olens = aligner._batch_tensors(big, torch.device("cuda"))
    with torch.no_grad():
        lp = model(xs, ilens, ys, olens)["log_p_attn"]
    own_check = check_mas("aligner's largest batch", lp, ilens, olens)
    times = time_mas(lp, ilens, olens, where, floors)

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
    mas_ms = time_ms(lambda: mas.mas_path_fused(fwd_out["log_p_attn"].detach(), ilens, olens))

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
        f"(fused MAS search {mas_ms:.4f} ms) + CTC loop forward {ctc_ms:.1f} ms + backward {bwd_ms:.1f} ms "
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
    return launches, own_check, times, paths, freqs


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


def _k1bwd_tc_launches():
    """(3xTF32 dk/dv, dq, bf16-with-a-bias dk/dv, dq) launches so far."""
    from jatts_torch.ops import flash_attention as k1

    return _tc_f32_bwd_launches() + (k1.launches_bwd_dkv_tc_bias, k1.launches_bwd_dq_tc_bias)


def check_k1bwd(b, h, t, d, dtype_name, with_bias, seed, against_autograd=False, rows=None):
    """K1-bwd's four outputs against flash_attention_bwd_ref, both fed the
    plain forward's o and lse, each within TOL_BWD of every batch item's own
    max(1, max|plain|) (item_err); K1's own lse against the plain one; dq
    and d(ab) on rows that see no key, dk and dv on keys that no row sees
    and d(ab) on masked keys exactly 0. The f32 (192, 192) forms must run on
    the 3xTF32 kernels, the bf16 (192, 192) form with a bias on the bf16
    tensor-core kernels with a bias, and every other form on the scalar ones
    (by the counters); on a tensor-core route also the same bits on a second
    run, the scalar kernels checked on the same inputs and the worst item
    against float64. ``rows``: the key mask as (first valid key, count) per
    item, cycled over the batch, instead of k1_inputs' lengths. Returns the
    largest |kernel - plain| over the outputs, the library that ran
    (``dkv_kernel``'s), and the scalar kernels' largest |kernel - plain| on
    the same inputs (None where they were the rule's)."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    q, k, v, ab, key_mask, do, _ = k1bwd_inputs(b, h, t, d, dtype, with_bias, seed)
    if rows is not None:
        pos = torch.arange(t, device="cuda")
        key_mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in (rows * b)[:b]])
    scale = d ** -0.5
    o, lse = k1.flash_attention_ref(q, k, v, ab, key_mask, scale, return_lse=True)
    _, lse_k = k1.flash_attention_fwd(q, k, v, ab, key_mask, scale)
    lib = k1.dkv_kernel(dtype, False, d, d, with_bias)
    # the tensor-core routes at d 192: f32 with or without a bias, bf16 with one
    want_lib = (k1.KERNEL_BWD_TC_F32 if d == 192 and dtype_name == "f32"
                else k1.KERNEL_BWD_TC_BIAS if d == 192 and with_bias else k1.KERNEL_BWD)
    check(lib == want_lib and k1.dq_kernel(dtype, False, d, d, with_bias) == lib,
          f"K1-bwd {dtype_name} d {d} bias={with_bias}: the rule sends it to {lib}, not {want_lib}")
    on_tc = lib != k1.KERNEL_BWD
    before = _k1bwd_tc_launches()
    got = k1.flash_attention_bwd(q, k, v, ab, key_mask, scale, o, lse, do)
    torch.cuda.synchronize()
    ran = tuple(x - y for x, y in zip(_k1bwd_tc_launches(), before))
    want_ran = ((1, 1, 0, 0) if lib == k1.KERNEL_BWD_TC_F32 else (0, 0, 1, 1) if on_tc else (0, 0, 0, 0))
    check(ran == want_ran, f"K1-bwd {dtype_name} d {d}: dk/dv and dq on the 3xTF32 and bf16 tensor-core kernels "
                           f"{ran}, not {want_ran}")

    def f32(x):
        return None if x is None else x.float()

    want = k1.flash_attention_bwd_ref(f32(q), f32(k), f32(v), f32(ab), key_mask, scale, f32(o), lse, f32(do))
    tol = TOL_BWD[dtype_name]
    errs, rel = {}, {}
    for name, g_, w in zip(("dq", "dk", "dv", "dab"), got, want):
        if w is None:
            check(g_ is None, "K1-bwd wrote d(ab) without a bias")
            continue
        check(bool(torch.isfinite(g_).all()), f"K1-bwd {name} not finite at {(b, h, t, d)}")
        errs[name] = (g_.float() - w).abs().max().item()
        rel[name] = item_err(g_, w)
        check(rel[name] <= tol,
              f"K1-bwd {dtype_name} {(b, h, t, d)} {name} err {rel[name]} x max(1, max|plain| of its item) > {tol}")
    both_inf = torch.isinf(lse) & torch.isinf(lse_k)
    check(bool((torch.isinf(lse) == torch.isinf(lse_k)).all()), "K1 lse: +inf rows differ")
    lse_err = (lse_k - lse).masked_fill(both_inf, 0.0).abs().max().item()
    check(lse_err <= 1e-4 * max(1.0, lse.masked_fill(both_inf, 0).abs().max().item()), f"K1 lse err {lse_err}")
    rows_none, unseen = torch.isinf(lse)[..., None], ~key_mask[:, None, :, None]
    dq, dk, dv, dab = got
    zeros = bool((dq.masked_select(rows_none) == 0).all()) and bool((dk.masked_select(unseen) == 0).all())
    zeros &= bool((dv.masked_select(unseen) == 0).all())
    if dab is not None:
        zeros &= bool((dab.masked_select(rows_none) == 0).all())
        zeros &= bool((dab.masked_select(unseen.transpose(-1, -2)) == 0).all())
    check(zeros, f"K1-bwd {dtype_name} {(b, h, t, d)}: dq or d(ab) of a row that sees no key, dk or dv of a key "
                 "that no row sees, or d(ab) of a masked key is not 0")
    extra, scalar_err = "", None
    if on_tc:
        di = (o.float() * do.float()).sum(-1)
        again = k1.flash_attention_bwd(q, k, v, ab, key_mask, scale, o, lse, do)
        scalar = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), None if ab is None else
                  torch.empty_like(ab))
        k1._launch_bwd("dkv", q, k, v, ab, key_mask, scale, lse, di, do, scalar[1], scalar[2], False,
                       _lib=k1.KERNEL_BWD)
        k1._launch_bwd("dq", q, k, v, ab, key_mask, scale, lse, di, do, scalar[0], scalar[3], False,
                       _lib=k1.KERNEL_BWD)
        torch.cuda.synchronize()
        check(all(x is None or torch.equal(x, y) for x, y in zip(again, got)),
              f"K1-bwd {lib}: bits differ between runs")
        pairs = [(g_, w) for g_, w in zip(scalar, want) if w is not None]
        scalar_rel = max(item_err(g_, w) for g_, w in pairs)
        scalar_err = max((g_ - w).abs().max().item() for g_, w in pairs)
        check(scalar_rel <= tol, f"K1-bwd: the scalar kernels on the same inputs err {scalar_rel} > {tol}")
        # the worst item against float64, fed the same o and lse: the kernels'
        # error and the plain f32 version's, each over max(1, max|exact|)
        i = max(range(b), key=lambda j: max(item_err(g_[j:j + 1], w[j:j + 1]) for g_, w in zip(got, want)
                                            if w is not None))
        q2, k2, v2, do2, o2 = (x[i:i + 1].double() for x in (q, k, v, do, o))
        s2 = q2 @ k2.transpose(-1, -2) + (0.0 if ab is None else ab[i:i + 1].double())
        p2 = torch.exp(s2 * scale - lse[i:i + 1].double()[..., None])
        p2 = p2.masked_fill(~key_mask[i:i + 1, None, None, :], 0.0)
        ds2 = p2 * (do2 @ v2.transpose(-1, -2) - (o2 * do2).sum(-1)[..., None]) * scale
        exact = (ds2 @ k2, ds2.transpose(-1, -2) @ q2, p2.transpose(-1, -2) @ do2, ds2)
        f64 = {name: (item_err(g_[i:i + 1], e), item_err(w[i:i + 1], e))
               for name, g_, w, e in zip(("dq", "dk", "dv", "dab"), got, want, exact) if w is not None}
        extra = (f"; on {lib}, the same bits on a second run; the scalar kernels on the same "
                 f"inputs {scalar_rel:.2e}; the worst item ({int(key_mask[i].sum())} valid keys) against float64, "
                 f"kernels / plain f32: " + ", ".join(f"{n} {a:.2e} / {c:.2e}" for n, (a, c) in f64.items()))
    line = ", ".join(f"{n} {errs[n]:.2e} ({rel[n]:.2e})" for n in errs)
    print(
        f"K1-bwd check {dtype_name} B,H,T,d={b},{h},{t},{d} bias={with_bias}: max_abs_err {line} (max |kernel - "
        f"plain| (worst item's over max(1, max|plain| of the item)); tol {tol:.0e}); K1 lse err {lse_err:.1e}; "
        f"rows that see no key {int(rows_none.sum())}, masked keys {int((~key_mask).sum())}{extra}", flush=True,
    )
    if against_autograd:
        leaves = [x.float().detach().requires_grad_() for x in (q, k, v, ab) if x is not None]
        args = leaves + ([None] if ab is None else [])
        out = k1.flash_attention_ref(*args, key_mask, scale)
        ag = torch.autograd.grad(out, leaves, do.float())
        ag_err = max(item_err(g_, a) for g_, a in zip(got, ag))
        print(f"K1-bwd vs autograd through the plain K1: worst item's max_abs_err over max(1, max|plain| of the "
              f"item) {ag_err:.2e} (tol {tol:.0e})", flush=True)
        check(ag_err <= tol, "K1-bwd disagrees with autograd of the plain K1")
    return max(errs.values()), lib, scalar_err


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
    """K1-bwd at the training decoder shape (f32, a dense bias, every key
    valid): the two 3xTF32 kernels the rule takes, by CUDA events and
    replayed from a CUDA graph, the scalar kernels on the same inputs
    beside; the plain backward, SDPA forward+backward with a float bias that
    takes a gradient (the library yardstick), K1's forward with the
    log-sum-exp, the bounds; then the error against float64 (items 0-1) of
    the 3xTF32 kernels, the scalar ones and the plain f32 backward."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    b, h, t, d = 32, 2, 1024, 192
    q, k, v, ab, _, do, _ = k1bwd_inputs(b, h, t, d, torch.float32, True, seed)
    full = torch.ones(b, t, dtype=torch.bool, device="cuda")
    scale = d ** -0.5
    o, lse = k1.flash_attention_fwd(q, k, v, ab, full, scale)
    di = (o * do).sum(-1)
    res = {"fwd_ms": time_ms(lambda: k1.flash_attention_fwd(q, k, v, ab, full, scale), iters=10)}
    res["dkv"] = time_ms(lambda: k1.flash_attention_bwd_dkv(q, k, v, ab, full, scale, lse, di, do), iters=10)
    res["dq"] = time_ms(lambda: k1.flash_attention_bwd_dq(q, k, v, ab, full, scale, lse, di, do), iters=10)
    res["dkv_graph"] = graph_ms(lambda: k1.flash_attention_bwd_dkv(q, k, v, ab, full, scale, lse, di, do),
                                iters=10, replays=3)
    res["dq_graph"] = graph_ms(lambda: k1.flash_attention_bwd_dq(q, k, v, ab, full, scale, lse, di, do),
                               iters=10, replays=3)
    sq, sk, sv, sdab = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), torch.empty_like(ab)
    res["dkv_scalar"] = time_ms(lambda: k1._launch_bwd("dkv", q, k, v, ab, full, scale, lse, di, do, sk, sv, False,
                                                       _lib=k1.KERNEL_BWD), iters=5, warmup=1)
    res["dq_scalar"] = time_ms(lambda: k1._launch_bwd("dq", q, k, v, ab, full, scale, lse, di, do, sq, sdab, False,
                                                      _lib=k1.KERNEL_BWD), iters=5, warmup=1)
    res["plain_ms"] = time_ms(lambda: k1.flash_attention_bwd_ref(q, k, v, ab, full, scale, o, lse, do), iters=5,
                              warmup=1)
    # the precision at this shape: items 0-1 against float64 (the same lse
    # and o); worst item's error over max(1, max|exact|) of dq, dk, dv, d(ab)
    want = k1.flash_attention_bwd_ref(q, k, v, ab, full, scale, o, lse, do)
    dq, dab = k1.flash_attention_bwd_dq(q, k, v, ab, full, scale, lse, di, do)
    tc = (dq, *k1.flash_attention_bwd_dkv(q, k, v, ab, full, scale, lse, di, do), dab)
    q2, k2, v2, ab2, do2 = (x[:2].double() for x in (q, k, v, ab, do))
    p2 = torch.exp((q2 @ k2.transpose(-1, -2) + ab2) * scale - lse[:2].double()[..., None])
    ds2 = p2 * (do2 @ v2.transpose(-1, -2) - (o[:2].double() * do2).sum(-1)[..., None]) * scale
    exact = (ds2 @ k2, ds2.transpose(-1, -2) @ q2, p2.transpose(-1, -2) @ do2, ds2)
    res["vs_f64"] = {name: max(item_err(g_[:2], e) for g_, e in zip(got, exact))
                     for name, got in (("tc_f32", tc), ("scalar", (sq, sk, sv, sdab)), ("plain", want))}
    del want, tc, dq, dab, q2, k2, v2, ab2, do2, p2, ds2, exact, sq, sk, sv, sdab
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    bias = (ab * scale).detach().requires_grad_()  # SDPA adds its mask after the scale

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias, scale=scale)
        torch.autograd.grad(out, (qs, ks, vs, bias), do)

    res["library_ms"] = time_ms(sdpa_fwd_bwd, iters=5, warmup=1)
    bounds = k1bwd_bounds_ms(b, h, t, d, 4, "f32")
    res["bounds"] = dict(zip(("dkv", "dq"), bounds))
    parts = "; ".join(
        f"{n} kernel {res[n]:.4f} ms (3xTF32 tensor cores; graph replay {res[n + '_graph']:.4f} ms; the scalar {n} "
        f"on the same inputs {res[n + '_scalar']:.4f} ms) (bound {bound:.4f} ms by {by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.1f} GFLOP; on the CUDA cores {cuda_core_ms(flops):.4f} ms)"
        for n, (bound, by, nbytes, flops) in res["bounds"].items())
    print(
        f"K1-bwd time f32 B,H,T,d={b},{h},{t},{d} with bias: {parts}; plain backward {res['plain_ms']:.4f} ms; "
        f"sdpa forward+backward {res['library_ms']:.4f} ms; K1 forward with lse {res['fwd_ms']:.4f} ms; {where}",
        flush=True,
    )
    print("K1-bwd f32 backward at that shape against float64, items 0-1 (worst item's max |err| over max(1, "
          "max|exact|) of dq, dk, dv, d(ab)): " + ", ".join(f"{n} {e:.2e}" for n, e in (
              ("3xTF32 tensor-core kernels", res["vs_f64"]["tc_f32"]), ("scalar kernels", res["vs_f64"]["scalar"]),
              ("plain f32 backward", res["vs_f64"]["plain"]))), flush=True)
    return res


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


def _tc_bwd_launches():
    """K1r's dk/dv and dq on their tensor-core kernels: the 3xTF32 ones (f32),
    then the bf16 ones."""
    from jatts_torch.ops import flash_attention as k1

    return _tc_f32_bwd_launches() + (k1.launches_bwd_dkv_tc_relpos, k1.launches_bwd_dq_tc_relpos)


def check_k1r(name, shape, dims, dtype_name, rows, seed, against_autograd=False):
    """The three K1r kernels against flash_attention_ref /
    flash_attention_bwd_ref on the same inputs (the backward fed the plain
    forward's o and lse), the kernel's lse against the plain one, rows that
    see no key exactly 0 in the output and dq, keys that no row sees exactly
    0 in dk and dv, each output within its tolerance of every batch item's
    own max(1, max|plain|) (item_err), and each launch on the kernel the
    dispatch rules give the form: the forward on the tensor cores (bf16) or
    the 3xTF32 kernel (f32), the f32 dk/dv and dq on the 3xTF32 tensor-core
    kernels, the bf16 ones on the bf16 tensor-core kernels
    (``csrc/flash_attn_bwd_tc_relpos.cu``; each of their counters one up with
    its ``_relpos`` one). Also the backward's bits from run to run and for
    item 1 alone, and the scalar dk/dv and dq on the same inputs. Returns
    the largest |kernel - plain| of the forward, of the backward, and of the
    scalar backward."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    q, k, v, key_mask, do = k1r_inputs(shape, dims, dtype, rows, seed)
    scale = dims[1] ** -0.5  # 1/sqrt(d_k), as the attention layer passes it
    before = _legacy_launches()
    counter = "launches_tc_f32" if dtype_name == "f32" else "launches_tc"
    tc_before, relpos_before, bwd_tc_before = getattr(k1, counter), _relpos_launches(), _tc_bwd_launches()
    out_k, lse_k = k1.flash_attention_fwd(q, k, v, None, key_mask, scale)
    out_nolse = k1.flash_attention(q, k, v, None, key_mask, scale)
    o, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(), None, key_mask, scale, return_lse=True)
    got = k1.flash_attention_bwd(q, k, v, None, key_mask, scale, o.to(dtype), lse, do)
    torch.cuda.synchronize()
    check(_legacy_launches() == before, f"K1r {name}: a d_qk == d_v kernel launched")
    check(getattr(k1, counter) - tc_before == 2, f"K1r {name}: the forward missed its tensor-core kernel ({counter})")
    relpos = tuple(a - b for a, b in zip(_relpos_launches(), relpos_before))
    bwd_tc = tuple(a - b for a, b in zip(_tc_bwd_launches(), bwd_tc_before))
    check(relpos == (2, 1, 1) and bwd_tc == ((1, 1, 0, 0) if dtype_name == "f32" else (0, 0, 1, 1)),
          f"K1r {name}: launches (relpos forward, dk/dv, dq) {relpos}, on the 3xTF32 and the bf16 tensor-core "
          f"dk/dv and dq {bwd_tc}")
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
    # no atomics: the same bits on a second run and for item 1 alone (di as
    # the wrapper forms it, from o in the inputs' dtype)
    di = (o.to(dtype).float() * do.float()).sum(-1)
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
    extra = (f"; dk/dv and dq on the {'3xTF32' if dtype_name == 'f32' else 'bf16'} tensor-core kernels, the "
             f"same bits on a second run and for item 1 alone; the scalar dk/dv and dq on the same inputs "
             f"{scalar_rel:.2e}")
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
    dq; "tc_relpos": the bf16 ones; "scalar": the scalar kernels on every
    case's inputs), and the times."""
    fwd_err, bwd_err = {"f32": 0.0, "bf16": 0.0}, {"tc_f32": 0.0, "tc_relpos": 0.0, "scalar": 0.0}
    for i, (name, shape, dims, dtype_name, rows) in enumerate(k1r_cases()):
        fe, be, se = check_k1r(name, shape, dims, dtype_name, rows, seed + i, against_autograd=(name == "f32"))
        fwd_err[dtype_name] = max(fwd_err[dtype_name], fe)
        key = "tc_f32" if dtype_name == "f32" else "tc_relpos"
        bwd_err[key], bwd_err["scalar"] = max(bwd_err[key], be), max(bwd_err["scalar"], se)
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
    # bf16 parameters, no compute cast: the served program as it was built before the compute dtype
    fs2 = FastSpeech2(idim=64, **{**mp, "attn_backend": "flash"}, device="cuda", dtype=None).to(torch.bfloat16)
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
TRAIN_STEPS = 50  # the conf's train_max_steps is 100000 (200, then 100, before phases 19 and 21 needed the run's time)
TRAIN_WARMUP = 25  # the conf's warmup_steps is 4000 (50 at 100 steps)


def write_fs2_corpus(root, align_paths, freqs, tag="fs2", spk_dim=0, seed=0, mel_only=False):
    """Phase 8's rows (cropped by start/end, with durations) as FastSpeech2
    training data: per utterance an .npz with the log-mel at the JSUT
    settings cropped to the durations' sum (as jatts_tpu/bin/preprocess.py
    crops it), unless ``mel_only`` (Matcha's dumps) the per-token pitch (log
    of the phone's tone frequency) and the per-token energy (the
    STFT-magnitude energy of ops/dsp.py averaged over the token's frames, as
    the JAX Energy extractor averages it), and
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
            feat_path = str(Path(root) / f"dump_{tag}" / f"{row['sample_id']}.npz")
            Path(feat_path).parent.mkdir(parents=True, exist_ok=True)
            feats = {"mel": mel.astype(np.float32)}
            if not mel_only:
                e = energy(torch.from_numpy(wav).cuda(), c["fft_size"], hop).cpu().numpy()[: len(mel)]
                bounds = np.concatenate([[0], np.cumsum(ds)])
                feats["pitch"] = np.log([freqs[p] for p in row["phonemes"].split()]).astype(np.float32)
                feats["energy"] = np.asarray([
                    seg[seg > 0].mean() if (seg > 0).any() else 0.0
                    for seg in (e[a:z] for a, z in zip(bounds[:-1], bounds[1:]))
                ], np.float32)
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
# and K1-bwd with its bias), or phase 14, the JVS conf with speaker
# embeddings and latest rel-pos attention (K1r); each backward on the 3xTF32
# kernels, all of its dk/dv and dq launches. A kernel is named by the
# substrings of its profiler key, demangled or not
SLICES = {
    "jsut": dict(conf=JSUT_CONF, tag="fs2", spk_dim=0, latest=False, counts=_legacy_launches,
                 others=_relpos_launches, names=("K1 fwd (3xTF32 tc)", "K1-bwd dkv (3xTF32 tc)", "dq (3xTF32 tc)"),
                 kernels=(("flash_attn_fwd_tc_f32_kernel",),
                          ("flash_attn_bwd_tc_f32_kernel<192, 192, false, true>",
                           "flash_attn_bwd_tc_f32_kernelILi192ELi192ELb0ELb1E"),
                          ("flash_attn_bwd_tc_f32_kernel<192, 192, true, true>",
                           "flash_attn_bwd_tc_f32_kernelILi192ELi192ELb1ELb1E"))),
    "jvs": dict(conf=JVS_CONF, tag="jvs", spk_dim=192, latest=True, counts=_relpos_launches,
                others=_legacy_launches, names=("K1r fwd (3xTF32 tc)", "K1r dkv (3xTF32 tc)", "dq (3xTF32 tc)"),
                kernels=(("flash_attn_fwd_tc_f32_kernel",),
                         ("flash_attn_bwd_tc_f32_kernel<576, 192, false, false>",
                          "flash_attn_bwd_tc_f32_kernelILi576ELi192ELb0ELb0E"),
                         ("flash_attn_bwd_tc_f32_kernel<576, 192, true, false>",
                          "flash_attn_bwd_tc_f32_kernelILi576ELi192ELb1ELb0E"))),
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
    print(f"training ({which}): dk/dv and dq on the 3xTF32 tensor-core kernels {bwd_tc_f32} of {launches[1:]}",
          flush=True)
    check(bwd_tc_f32 == launches[1:],
          f"training ({which}): dk/dv and dq on the 3xTF32 kernels {bwd_tc_f32} != {launches[1:]}")

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
        check(sl["counts"]() == want and sl["others"]() == (0, 0, 0) and k1.launches_tc_f32 == want[0]
              and _tc_f32_bwd_launches() == want[1:],
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
VALLE_STEPS = 50  # the conf's train_max_steps is 400000 (200, then 100, before phases 19 and 21 needed the run's time)
VALLE_WARMUP = 25  # the conf's warmup_steps is 8000 (50 at 100 steps)
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
        "idle": 1 - busy_ms / wall_ms, "flash_ms": flash_ms, "xla_ms": xla_ms,
        "corpus": (train_csv, dev_csv, stats, tokens), "outdir": outdir}


# ---------------------------------------------------------------------------
# the tts1 recipe, stages 1-4
# ---------------------------------------------------------------------------

RECIPE_STEPS = 50  # stage 3 of phase 15: the conf's train_max_steps is 100000
RECIPE_WARMUP = 10  # the conf's warmup_steps is 4000
RECIPE_BATCH = 8  # tts_decode's default batch
HIFIGAN = dict(in_channels=80, out_channels=1, channels=512, kernel_size=7, upsample_scales=[5, 5, 4, 3],
               upsample_kernel_sizes=[10, 10, 8, 6], resblock_kernel_sizes=[3, 7, 11],
               resblock_dilations=[[1, 3, 5]] * 3, use_additional_convs=True)


def glottal_pulses(f0_contour, sr, seed, shimmer=0.05, snr_db=25):
    """The known-truth signal of tests/test_f0_accuracy.py: a glottal pulse
    train at the per-sample f0, a glottal resonator, three formants and
    noise at ``snr_db``."""
    import numpy as np
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    onsets = np.where(np.diff(np.floor(np.cumsum(f0_contour / sr))) > 0)[0]
    x = np.zeros(len(f0_contour))
    x[onsets] = 1.0 + shimmer * rng.standard_normal(len(onsets))
    x = lfilter([1.0], [1, -1.95, 0.9506], x)
    for fc, bw in ((700, 130), (1220, 150), (2600, 200)):
        r = np.exp(-np.pi * bw / sr)
        x = lfilter([1.0], [1, -2 * r * np.cos(2 * np.pi * fc / sr), r * r], x)
    x = x / (np.abs(x).max() + 1e-9)
    noise = rng.standard_normal(len(x))
    noise *= np.sqrt((x**2).mean()) / np.sqrt((noise**2).mean()) * 10 ** (-snr_db / 20)
    return (x + noise).astype(np.float32)


def f0_truth_on_card(where):
    """Dio on the card (the raw f0: no interpolation, no log, no token
    means) on glottal pulse trains at 24 kHz, flat and with 5 Hz vibrato,
    at three pitches; held to the JAX op's bounds in tests/test_f0_accuracy.py:
    no gross errors (> 20% off), fine RMSE < 5 Hz, voicing errors < 0.02."""
    import numpy as np

    from jatts_torch.features.extractors import Dio

    sr, hop = 24000, 300
    dio = Dio(fs=sr, n_fft=2048, hop_length=hop, f0min=70.0, f0max=600.0, use_token_averaged_f0=False,
              use_continuous_f0=False, use_log_f0=False, device="cuda")
    for kind in ("flat", "vibrato"):
        for base in (90, 160, 300):
            t = np.arange(sr) / sr
            c = np.full(sr, float(base)) if kind == "flat" else base * 1.5 + 0.06 * base * np.sin(2 * np.pi * 5 * t)
            f0 = dio(glottal_pulses(c, sr, seed=base))
            truth = c[np.clip(np.arange(len(f0)) * hop, 0, sr - 1)]
            tv, ev = truth > 0, f0 > 0
            vde = float((tv != ev).mean())
            both = tv & ev
            err = np.abs(f0[both] - truth[both])
            rel = err / truth[both]
            gross = float((rel > 0.2).mean()) if both.any() else 1.0
            fine = err[rel <= 0.2]
            rmse = float(np.sqrt((fine**2).mean())) if len(fine) else float("inf")
            print(f"f0 truth on the card, {kind} {base} Hz: gross {gross:.3f} (limit 0), fine RMSE {rmse:.3f} Hz "
                  f"(limit 5), voicing errors {vde:.4f} (limit 0.02); {where}", flush=True)
            check(gross == 0.0 and rmse < 5.0 and vde < 0.02, f"f0 truth on the card: {kind} {base} Hz")


def write_pwg_checkpoint(root, seed, stats):
    """A seed-made HiFi-GAN in parallel_wavegan's layout: the generator's
    state_dict with every conv weight as a weight_g/weight_v pair, under
    ``{"model": {"generator": ...}}``; its config yaml and its own mel stats
    (``mean``/``scale`` near the acoustic model's). Returns (checkpoint,
    config, stats) paths and the pairs."""
    import numpy as np
    import torch
    import yaml

    from jatts_torch.vocoder.hifigan import HiFiGANGenerator

    torch.manual_seed(seed)
    gen = HiFiGANGenerator(**HIFIGAN, device="cpu")
    rng = np.random.default_rng(seed)
    sd = {}
    for k, w in gen.state_dict().items():
        if k.endswith(".weight") and w.dim() == 3:
            base = k[: -len("weight")]
            v = w * torch.from_numpy(rng.uniform(0.5, 2.0, (w.shape[0], 1, 1)).astype(np.float32))
            sd[base + "weight_v"] = v
            sd[base + "weight_g"] = w.flatten(1).norm(dim=1).reshape(-1, 1, 1)
        else:
            sd[k] = w
    ckpt = str(Path(root) / "hifigan" / "checkpoint-0steps.pkl")
    Path(ckpt).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {"generator": sd}, "steps": 0}, ckpt)
    conf = str(Path(root) / "hifigan" / "config.yml")
    with open(conf, "w") as f:
        yaml.dump({"sampling_rate": 24000, "generator_params": HIFIGAN}, f)
    voc_stats = str(Path(root) / "hifigan" / "stats.npz")
    with np.load(stats) as st:
        np.savez(voc_stats, mean=(st["mel_mean"] + rng.normal(0, 0.1, 80)).astype(np.float32),
                 scale=(st["mel_scale"] * rng.uniform(0.8, 1.2, 80)).astype(np.float32))
    return ckpt, conf, voc_stats, sd


def recipe_slice(root, align_paths, seed, where):
    """Phase 15: tts1 stages 1-4 through the port's CLIs on phase 8's
    aligned corpus. Returns the two decode runs' K1 launches (all on the
    3xTF32 tensor-core kernel)."""
    import numpy as np
    import torch
    import yaml
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jatts_torch.bin import compute_statistics, generate_token_list, preprocess, tts_decode, tts_train
    from jatts_torch.data.batcher import round_up
    from jatts_torch.data.dataset import TTSDataset
    from jatts_torch.models.fastspeech2 import FastSpeech2
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.ops.dsp import _stft_complex, mel_filterbank
    from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint
    from jatts_torch.utils.config import load_config
    from jatts_torch.utils.io import read_audio, read_csv, write_csv
    from jatts_torch.vocoder.hifigan import HiFiGANGenerator
    from jatts_torch.vocoder.vocoder import GriffinLimVocoder

    t_phase = time.perf_counter()
    root = Path(root) / "recipe"
    conf = load_config(str(JSUT_CONF))
    sr, hop = conf["sampling_rate"], conf["hop_size"]

    # stage 1 on the card, train and dev, .npz dumps
    csvs = {split: str(root / f"{split}.csv") for split in ("train", "dev")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio_s = 0.0
    for split, src in zip(("train", "dev"), align_paths):
        audio_s += preprocess.run(src, conf, str(root / "dump" / split), out_csv=csvs[split], device="cuda",
                                  dump_format="npz")
    torch.cuda.synchronize()
    stage1_s = time.perf_counter() - t0
    rows = {split: read_csv(csvs[split], dict_reader=True)[0] for split in csvs}
    n_utts = sum(len(r) for r in rows.values())
    print(f"stage 1 (preprocess, mel + pitch + energy, .npz, JSUT feature settings): {n_utts} utterances, "
          f"{audio_s:.2f} s of audio; {where}", flush=True)
    print(f"stage 1 wall: {stage1_s:.2f} s; {where}", flush=True)
    print(f"stage 1 seconds per hour of audio: {stage1_s / audio_s * 3600:.2f} s; {where}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        preprocess.run(align_paths[1], conf, str(root / "dump_profiled"), out_csv=str(root / "profiled.csv"),
                       device="cuda", dump_format="npz")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms > 0, "profile of stage 1: the profiler saw no device time")
    stage1_busy = busy_ms / wall_ms
    print(f"stage 1 profiled on the dev rows: wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms in "
          f"{sum(e.count for e in events)} kernels; {where}", flush=True)
    print(f"stage 1 device busy share: {stage1_busy:.4f}; {where}", flush=True)

    # 4 utterances' dumps against the same CLI on the CPU
    four = str(root / "four.csv")
    write_csv(read_csv(align_paths[1], dict_reader=True)[0][:4], four)
    preprocess.run(four, conf, str(root / "dump_cpu"), out_csv=str(root / "four_cpu.csv"), device="cpu",
                   dump_format="npz")
    errs = {"mel": 0.0, "mel_linear": 0.0, "mel_all": (0.0, 0.0), "pitch": 0.0, "energy": 0.0}
    for cpu_row, row in zip(read_csv(str(root / "four_cpu.csv"), dict_reader=True)[0], rows["dev"]):
        check(cpu_row["sample_id"] == row["sample_id"], "stage 1 rows out of order")
        with np.load(cpu_row["feat_path"]) as want, np.load(row["feat_path"]) as got:
            check(sorted(got.files) == sorted(want.files) == ["energy", "mel", "pitch", "wave"],
                  f"stage 1 keys {got.files}")
            check(np.array_equal(got["wave"], want["wave"]), "stage 1 waves differ")
            check(np.array_equal(got["pitch"] > 0, want["pitch"] > 0), f"{row['sample_id']}: voicing differs")
            # the mel to 2e-6 of the utterance's peak in the linear domain
            # (the |STFT| tolerance); the log-mel to 5e-5 where the mel is
            # within 2% of the peak: below, two FFTs' rounding noise (~1e-7
            # of the peak) is a large share of a quiet bin
            lin_got, lin_want = 10.0 ** got["mel"].astype(np.float64), 10.0 ** want["mel"].astype(np.float64)
            peak = lin_want.max()
            log_err = np.abs(got["mel"] - want["mel"])
            loud = lin_want >= 0.02 * peak
            errs["mel"] = max(errs["mel"], float(log_err[loud].max()))
            errs["mel_linear"] = max(errs["mel_linear"], float(np.abs(lin_got - lin_want).max() / peak))
            worst = np.unravel_index(log_err.argmax(), log_err.shape)
            if log_err[worst] > errs["mel_all"][0]:
                errs["mel_all"] = (float(log_err[worst]), float(lin_want[worst] / peak))
            errs["pitch"] = max(errs["pitch"], float(np.abs(got["pitch"] - want["pitch"]).max()))
            errs["energy"] = max(errs["energy"], float(
                (np.abs(got["energy"] - want["energy"]) / (1e-4 * np.abs(want["energy"]) + 1e-5)).max()))
    print(f"stage 1, card vs CPU on 4 dev utterances: mel max_abs_err {errs['mel_linear']:.2e} of the peak "
          f"(tol 2e-6), log-mel {errs['mel']:.2e} where the mel is >= 2% of the peak (tol 5e-5; over every bin "
          f"{errs['mel_all'][0]:.2e}, at {errs['mel_all'][1]:.1e} of the peak), log-f0 {errs['pitch']:.2e} (tol "
          f"1e-3, same voicing), energy {errs['energy']:.3f} of its tolerance (1e-4 relative + 1e-5)", flush=True)
    check(errs["mel_linear"] <= 2e-6 and errs["mel"] <= 5e-5 and errs["pitch"] <= 1e-3 and errs["energy"] <= 1.0,
          "stage 1 card vs CPU")

    f0_truth_on_card(where)

    # stages 1b and 2
    stats = str(root / "stats.npz")
    compute_statistics.run(csvs["train"], conf, stats)
    tokens = str(root / "tokens.txt")
    vocab = generate_token_list.run([csvs["train"], csvs["dev"]], tokens)
    with np.load(stats) as st:
        check(sorted(st.files) == sorted(f"{f}_{s}" for f in ("mel", "pitch", "energy") for s in ("mean", "scale"))
              and st["mel_mean"].shape == (80,) and st["pitch_mean"].shape == (1,), f"stats {st.files}")
    check(len(vocab) == 43, f"{len(vocab)} tokens, want 40 phones + 3")

    # stage 3 through the CLI's main
    reduced = dict(conf, train_max_steps=RECIPE_STEPS,
                   scheduler_params={**conf["scheduler_params"], "warmup_steps": RECIPE_WARMUP})
    conf_path = str(root / "fastspeech2.yaml")
    with open(conf_path, "w") as f:
        yaml.dump(reduced, f)
    print(f"stage 3 config {JSUT_CONF.relative_to(ROOT)} with --attn-backend flash; reductions: train_max_steps "
          f"{conf['train_max_steps']} -> {RECIPE_STEPS}, warmup_steps {conf['scheduler_params']['warmup_steps']} "
          f"-> {RECIPE_WARMUP}", flush=True)
    expdir = str(root / "exp")
    t0 = time.perf_counter()
    trainer = tts_train.main(["--train-csv", csvs["train"], "--dev-csv", csvs["dev"], "--stats", stats,
                              "--token-list", tokens, "--config", conf_path, "--outdir", expdir,
                              "--attn-backend", "flash", "--seed", str(seed), "--verbose", "0"])
    torch.cuda.synchronize()
    stage3_s = time.perf_counter() - t0
    losses = [h["train/loss"] for h in trainer.history]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"stage 3: {trainer.steps} steps in {stage3_s:.1f} s on the stage-1 dumps; loss mean of the first 10 "
          f"steps {first:.4f}, of the last 10 {last:.4f}; {where}", flush=True)
    check(trainer.steps == RECIPE_STEPS and all(math.isfinite(v) for v in losses), "stage 3 training")
    check(last < first, "stage 3: the training loss did not fall")
    del trainer

    # stage 4: the dev rows, then the same rows under other ids, so that a
    # second batch of the same shape gives the CLI's steady-state RTF
    dev_rows = rows["dev"]
    decode_csv = str(root / "decode.csv")
    write_csv(dev_rows + [dict(r, sample_id=r["sample_id"] + "_again") for r in dev_rows], decode_csv)
    ckpt, voc_conf, voc_stats, pairs = write_pwg_checkpoint(root, seed, stats)
    exp_conf = load_config(str(Path(expdir) / "config.yml"))
    check(exp_conf["model_params"]["attn_backend"] == "flash", "config.yml lost the attention backend")
    exp_conf["vocoder"] = {"checkpoint": ckpt, "config": voc_conf, "stats": voc_stats}
    exp_conf_path = str(root / "exp_config.yml")
    with open(exp_conf_path, "w") as f:
        yaml.dump(exp_conf, f)
    n_batches = -(-len(dev_rows) * 2 // RECIPE_BATCH)
    decoded = {}
    for name, extra in (("hifigan", []), ("griffin_lim", ["--vocoder", "griffin_lim"])):
        k1.reset_launches()
        t0 = time.perf_counter()
        decoded[name] = tts_decode.main([
            "--csv", decode_csv, "--stats", stats, "--token-list", tokens, "--expdir", expdir,
            "--config", exp_conf_path, "--outdir", str(root / f"decode_{name}"),
            "--batch-size", str(RECIPE_BATCH), "--max-frames", "2048", "--verbose", "0", *extra])
        torch.cuda.synchronize()
        decoded[name]["wall_s"] = time.perf_counter() - t0
        decoded[name]["k1"] = (k1.launches, k1.launches_tc_f32, k1.launches - k1.launches_tc_f32,
                               k1.launches_tc + k1.launches_relpos + k1.launches_causal)
        n, tc, scalar, other = decoded[name]["k1"]
        print(f"stage 4 ({name}): {len(decoded[name]['olens'])} utterances in {n_batches} batches of "
              f"{RECIPE_BATCH}, vocoder {decoded[name]['vocoder']}; K1 launches {n}, on the 3xTF32 tensor-core "
              f"kernel {tc}, on the scalar kernel {scalar}, other forms {other} (8 a batch = {8 * n_batches})",
              flush=True)
        check(tc == 8 * n_batches and scalar == 0 and other == 0, f"stage 4 ({name}): K1 launches {decoded[name]['k1']}")
    hg, gl = decoded["hifigan"], decoded["griffin_lim"]
    check(hg["vocoder"] == "Vocoder" and gl["vocoder"] == "GriffinLimVocoder", "stage 4 vocoder choice")
    check(hg["olens"] == gl["olens"], "the two decode runs predicted different lengths")
    min_frames = conf["fft_size"] // hop + 1
    olens = hg["olens"]
    check(len(olens) == 2 * len(dev_rows) and min(olens.values()) >= min_frames,
          f"stage 4: degenerate or missing predictions {olens}")
    wavs = {}
    for name in decoded:
        for utt, olen in olens.items():
            wav, wav_sr = read_audio(str(root / f"decode_{name}" / "wav" / f"{utt}.wav"))
            check(wav_sr == sr and len(wav) == olen * hop and bool(np.isfinite(wav).all()),
                  f"stage 4 ({name}) {utt}: {len(wav)} samples, want {olen * hop}")
            wavs[(name, utt)] = wav
    print(f"stage 4: one wav per row in each run, olens * {hop} samples (olens {min(olens.values())}-"
          f"{max(olens.values())} frames)", flush=True)

    # the mels against FastSpeech2.inference on the same batch
    mp = dict(exp_conf["model_params"])
    model = FastSpeech2(**mp, device="cuda")
    model.load_state_dict(restore_checkpoint(find_latest_checkpoint(expdir), map_location="cuda")["model"])
    model.eval()
    ds = TTSDataset(decode_csv, stats, conf["feat_list"], tokens, is_inference=True)
    items = [ds[i] for i in range(len(ds))]
    mel_err, mel_max = 0.0, 0.0
    for i in range(0, len(items), RECIPE_BATCH):
        chunk = items[i : i + RECIPE_BATCH]
        xs = torch.zeros((len(chunk), round_up(max(len(it["x"]) for it in chunk), 16)), dtype=torch.long)
        for j, it in enumerate(chunk):
            xs[j, : len(it["x"])] = torch.from_numpy(it["x"])
        ilens = torch.tensor([len(it["x"]) for it in chunk])
        with torch.no_grad():
            want = model.inference(xs.cuda(), ilens.cuda(), 2048)
        for j, it in enumerate(chunk):
            olen = int(want["olens"][j])
            ref = want["feat_gen"][j, :olen].cpu().numpy()
            for name in decoded:
                got = np.load(str(root / f"decode_{name}" / "wav" / f"{it['utt_id']}_mel.npy"))
                check(got.shape == ref.shape, f"{it['utt_id']}: mel {got.shape} vs {ref.shape}")
                mel_err = max(mel_err, float(np.abs(got - ref).max()))
            mel_max = max(mel_max, float(np.abs(ref).max()))
    print(f"stage 4 _mel.npy vs FastSpeech2.inference on the same batches: max_abs_err {mel_err:.2e} "
          f"(tol 1e-5; max |mel| {mel_max:.2f})", flush=True)
    check(mel_err <= 1e-5, "stage 4 mels differ from FastSpeech2.inference")

    # the HiFi-GAN wavs against the generator on weights folded by torch
    gen = HiFiGANGenerator(**HIFIGAN, device="cuda")
    folded = {}
    for k, v in pairs.items():
        if k.endswith("weight_v"):
            folded[k[: -len("_v")]] = torch._weight_norm(v, pairs[k[: -1] + "g"], 0)
        elif not k.endswith("weight_g"):
            folded[k] = v
    gen.load_state_dict(folded, strict=True)
    with np.load(stats) as st, np.load(voc_stats) as vs:
        m_mean, m_scale, v_mean, v_scale = st["mel_mean"], st["mel_scale"], vs["mean"], vs["scale"]
    hg_err = 0.0
    for utt in olens:
        mel = np.load(str(root / "decode_hifigan" / "wav" / f"{utt}_mel.npy"))
        x = ((mel * m_scale + m_mean) - v_mean) / v_scale
        x = np.pad(x.astype(np.float32), ((0, -(-len(x) // 64) * 64 - len(x)), (0, 0)))
        with torch.no_grad():
            ref = gen(torch.from_numpy(x)[None].cuda())[0, : len(mel) * hop, 0].cpu().numpy()
        hg_err = max(hg_err, float(np.abs(wavs[("hifigan", utt)] - np.clip(ref, -1, 1)).max()))
    print(f"stage 4 HiFi-GAN wavs vs the generator on torch-folded weights: max_abs_err {hg_err:.2e} "
          f"(tol 1e-4: the wav's 16-bit rounding is 1.5e-5)", flush=True)
    check(hg_err <= 1e-4, "stage 4 HiFi-GAN wavs differ from the folded generator")

    # one Griffin-Lim wav against the same call on the CPU (and the card's).
    # The iteration is chaotic where the spectrum is sparse (these tones):
    # a bin near zero takes its phase from rounding noise, so after 32
    # iterations two FFT libraries' waveforms part ways (the port and the
    # JAX package on one CPU do too) while each fits the target magnitude
    # as well. So the two are held by that fit, the spectral convergence
    # ||STFT(wav)| - M| / |M| that Griffin-Lim lowers, M the magnitude it
    # inverts: within 2% of each other, and below the fit it starts from
    utt = dev_rows[0]["sample_id"]
    gl_conf = {k: conf[k] for k in ("sampling_rate", "fft_size", "hop_size", "num_mels", "fmin", "fmax")}
    mel = np.load(str(root / "decode_griffin_lim" / "wav" / f"{utt}_mel.npy"))
    on_card = GriffinLimVocoder(gl_conf, device="cuda").decode(mel, m_mean, m_scale)
    on_cpu = GriffinLimVocoder(gl_conf, device="cpu").decode(mel, m_mean, m_scale)
    start_wav = GriffinLimVocoder(gl_conf, n_iter=0, device="cuda").decode(mel, m_mean, m_scale)
    basis = mel_filterbank(sr, conf["fft_size"], conf["num_mels"], conf["fmin"], conf["fmax"]).astype(np.float32)
    target = np.maximum((10.0 ** (mel * m_scale + m_mean).astype(np.float64)) @ np.linalg.pinv(basis).T, 0.0)

    def fit(wav):
        mag = _stft_complex(torch.from_numpy(wav), conf["fft_size"], hop).abs().double().numpy()[: len(target)]
        return float(np.linalg.norm(mag - target) / np.linalg.norm(target))

    sc_card, sc_cpu, sc_start = fit(on_card), fit(on_cpu), fit(start_wav)
    wav_diff = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    file_err = float(np.abs(wavs[("griffin_lim", utt)] - np.clip(on_card, -1, 1)).max())
    print(f"stage 4 Griffin-Lim {utt}, 32 iterations: spectral convergence card {sc_card:.4f}, CPU {sc_cpu:.4f} "
          f"(within 2% of each other), from {sc_start:.4f} before the iterations; the waveforms differ by "
          f"{wav_diff:.2e} of max|wav| (phase noise in near-empty bins); the CLI's wav vs the card's call "
          f"{file_err:.2e} (tol 1e-4)", flush=True)
    check(abs(sc_card - sc_cpu) <= 0.02 * sc_cpu and sc_card < sc_start and file_err <= 1e-4,
          "stage 4 Griffin-Lim")

    first = hg["batches"][0]
    steady = [b for b in hg["batches"] if not b["first_of_shape"]]
    check(len(steady) >= 1 and hg["rtf"] is not None, "stage 4: no steady-state batch")
    decode_ms = 1e3 * sum(b["seconds"] for b in steady) / len(steady)
    gl_ms = 1e3 * float(np.mean(gl["vocoder_s"]))
    hg_ms = 1e3 * float(np.mean(hg["vocoder_s"]))
    audio_dec = sum(olens.values()) * hop / sr
    print(f"stage 4 decode batch shape {first['shape']} (B, T_text), max_frames 2048: first batch "
          f"{1e3 * first['seconds']:.1f} ms; {where}", flush=True)
    print(f"stage 4 decode ms per batch (steady state, FastSpeech2 to the host): {decode_ms:.2f} ms; {where}",
          flush=True)
    print(f"stage 4 decode RTF (steady state, the CLI's): {hg['rtf']:.6f}; {where}", flush=True)
    print(f"stage 4 HiFi-GAN ms per utterance (f32, 512 ch): {hg_ms:.2f} ms; {where}", flush=True)
    print(f"stage 4 Griffin-Lim ms per utterance (32 iterations): {gl_ms:.2f} ms; {where}", flush=True)
    print(f"stage 4 whole CLI: HiFi-GAN run {hg['wall_s']:.2f} s, Griffin-Lim run {gl['wall_s']:.2f} s for "
          f"{audio_dec:.1f} s of audio; {where}", flush=True)
    print(f"phase 15 (stages 1-4 and their checks): {time.perf_counter() - t_phase:.1f} s; {where}", flush=True)
    return hg["k1"][1] + gl["k1"][1]


# ---------------------------------------------------------------------------
# the Matcha family: serving, tts1 training, tts2 (MAS) training
# ---------------------------------------------------------------------------

MATCHA_CONF = ROOT / "egs" / "jsut" / "tts1" / "conf" / "matcha_tts.v1.prior.steplr.large.yaml"
MATCHA_MAS_CONF = ROOT / "egs" / "jsut" / "tts2" / "conf" / "matcha_tts.mas.v1.yaml"
MATCHA_STEPS = 50  # both confs' train_max_steps is 100000
MATCHA_RESUME = 48  # an interval checkpoint: steps 48 and 49 are replayed from it
MAS_GATES = {"dp_train_start_steps": 20, "bin_loss_start_steps": 30}  # the conf's 10000 and 15000


def launch_counts():
    """Every kernel's launch counter: K1's forms and the MAS search's."""
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.ops import mas

    counts = {f"k1.{n}": v for n, v in vars(k1).items() if n.startswith("launches") and isinstance(v, int)}
    counts.update({"mas.path": mas.path_launches, "mas.fwd": mas.fwd_launches,
                   "mas.backtrace": mas.backtrace_launches})
    return counts


def reset_all_launches():
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.ops import mas

    k1.reset_launches()
    mas.reset_launches()


def profile_ms(fn):
    """Wall ms of one call under the profiler, device busy ms and the CUDA
    events (kernels only: op-level entries carry their kernels' time again)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms > 0, "profile: the profiler saw no device time")
    return wall_ms, busy_ms, events


def matcha_serving(seed, where):
    """Phase 16, serving: the JSUT Matcha-TTS conf as it stands, f32, seed-made
    weights, phase 7's HiFi-GAN; 16 requests through BatchingServer."""
    import numpy as np
    import torch

    from jatts_torch.models.matchatts import MatchaTTS
    from jatts_torch.serving import BatchingServer, ServingBundle
    from jatts_torch.serving.bundle import inference_kwargs
    from jatts_torch.utils.config import load_config
    from jatts_torch.vocoder.hifigan import HiFiGANGenerator

    config = load_config(str(MATCHA_CONF))
    kw = inference_kwargs(config)
    sr, max_frames, bucket, batch = config["sampling_rate"], 1024, 128, 8
    torch.manual_seed(seed)
    model = MatchaTTS(idim=64, **config["model_params"], device="cuda").eval()
    voc = HiFiGANGenerator(device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        # as phase 7: centre the random durations on max_frames / bucket frames a token
        model.duration_predictor.linear.weight.mul_(0.1)
        model.duration_predictor.linear.bias.fill_(math.log(1.0 + max_frames / bucket))
    rng = np.random.default_rng(seed)
    mel_mean = rng.normal(-4.0, 1.0, 80).astype(np.float32)
    mel_scale = rng.uniform(0.5, 2.0, 80).astype(np.float32)
    requests = [rng.integers(1, 64, size=int(n)).tolist() for n in rng.integers(40, bucket + 1, size=16)]
    requests[0] = rng.integers(1, 64, size=bucket).tolist()
    bundle = ServingBundle(model, voc, mel_mean, mel_scale, batch_size=batch, buckets=[bucket],
                           max_frames=max_frames, wav_format="f32", infer_kwargs=kw)
    print(f"Matcha serving: {MATCHA_CONF.relative_to(ROOT)} as it stands (adim 384, 4 conformer blocks, U-Net "
          f"{config['model_params']['decoder_channels']}, {kw['n_timesteps']} ODE steps, temperature "
          f"{kw['temperature']}), f32, TF32 off; HiFi-GAN 512 ch bf16", flush=True)
    bundle.synthesize(requests[:batch])  # warm-up (cuDNN/cuBLAS plans)
    torch.cuda.synchronize()

    reset_all_launches()
    t0 = time.perf_counter()
    with BatchingServer(bundle, max_delay_ms=20.0) as server:
        futures = [server.submit(token_ids=ids) for ids in requests]
        results = [f.result(timeout=600) for f in futures]
    served_s = time.perf_counter() - t0
    counts = launch_counts()
    print(f"Matcha served {len(results)} requests in {server.stats['batches']} batches, {served_s:.3f} s; "
          f"kernel launches {sum(counts.values())} (flash {sum(v for k, v in counts.items() if k.startswith('k1'))},"
          f" MAS {counts['mas.path'] + counts['mas.fwd'] + counts['mas.backtrace']}; limit 0)", flush=True)
    check(sum(counts.values()) == 0, f"Matcha serving launched a kernel: {counts}")
    hop = voc.hop_size
    for i, r in enumerate(results):
        n = r["mel"].shape[0]
        check(0 < n <= max_frames and n % 2 == 0, f"Matcha request {i}: olens {n}")
        check(r["wav"].shape == (n * hop,), f"Matcha request {i}: wav {r['wav'].shape} != olens*hop")
        check(bool(np.isfinite(r["wav"]).all() and np.isfinite(r["mel"]).all()), f"Matcha request {i}: not finite")

    # the seed reaches the ODE noise
    full = requests[:batch]
    a, b, c = (bundle.synthesize(full, seed=s) for s in (0, 0, 1))
    same = all(np.array_equal(x["wav"], y["wav"]) and np.array_equal(x["mel"], y["mel"]) for x, y in zip(a, b))
    other = max(float(np.abs(x["mel"] - y["mel"]).max()) for x, y in zip(a, c))
    print(f"Matcha seed: seed 0 twice bitwise equal {same}; seed 1 vs 0 max |mel diff| {other:.3e} "
          f"(limit > 1e-3)", flush=True)
    check(same and other > 1e-3, "the serving seed does not fix (or does not reach) the ODE noise")
    # the served mel against MatchaTTS.inference on the same noise
    xs, ilens = bundle.prepare(full)
    with torch.no_grad():
        ref = model.inference(xs, ilens, max_frames, generator=torch.Generator(device="cuda").manual_seed(0), **kw)
    ref_mel = (ref["feat_gen"].float() * bundle.mel_scale + bundle.mel_mean).cpu().numpy()
    ref_olens = ref["olens"].tolist()
    check([r["mel"].shape[0] for r in a] == ref_olens, "served olens != MatchaTTS.inference olens")
    mel_err = max(float(np.abs(r["mel"] - ref_mel[i, :n]).max()) for i, (r, n) in enumerate(zip(a, ref_olens)))
    mel_top = max(1.0, float(np.abs(ref_mel).max()))
    print(f"Matcha served mel vs MatchaTTS.inference on the same noise: max |diff| {mel_err:.3e} "
          f"(tol 1e-5 x {mel_top:.2f})", flush=True)
    check(mel_err <= 1e-5 * mel_top, "the served mel differs from MatchaTTS.inference")

    # times: a pcm16 batch, the U-Net an ODE step, HiFi-GAN, a profiled batch
    pcm = ServingBundle(model, voc, mel_mean, mel_scale, batch_size=batch, buckets=[bucket],
                        max_frames=max_frames, infer_kwargs=kw)
    batch_ms = time_ms(lambda: pcm.synthesize(full), iters=3, warmup=1)
    audio_s = sum(ref_olens) * hop / sr
    mask = torch.ones(batch, max_frames, device="cuda")
    x = torch.randn(batch, max_frames, 80, device="cuda")
    mu = torch.randn(batch, max_frames, 80, device="cuda")
    t = torch.full((batch,), 0.5, device="cuda")
    with torch.no_grad():
        unet_ms = time_ms(lambda: model.decoder.estimator(x, mask, mu, t), iters=5, warmup=1)
        mel_b = torch.from_numpy(ref_mel).cuda().to(torch.bfloat16)
        voc_ms = time_ms(lambda: voc(mel_b), iters=5, warmup=1)
        acoustic_ms = time_ms(lambda: model.inference(xs, ilens, max_frames, **kw), iters=3, warmup=1)
    wall_ms, busy_ms, events = profile_ms(lambda: pcm.synthesize(full))
    print(
        f"Matcha serving f32 pcm16 B={batch} bucket={bucket} max_frames={max_frames}: {batch_ms:.2f} ms per batch, "
        f"RTF {batch_ms / 1e3 / audio_s:.5f} ({audio_s:.2f} s of audio); MatchaTTS.inference {acoustic_ms:.2f} ms "
        f"(U-Net {unet_ms:.2f} ms an ODE step x {kw['n_timesteps']}), HiFi-GAN {voc_ms:.2f} ms; profiled batch: "
        f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; {where}",
        flush=True,
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"batch_ms": batch_ms, "rtf": batch_ms / 1e3 / audio_s, "unet_ms": unet_ms, "voc_ms": voc_ms,
            "acoustic_ms": acoustic_ms, "idle": 1 - busy_ms / wall_ms}


def _batch_at(loader, step):
    """The batch a run took at ``step``: epoch step // n, position step % n
    of that epoch's shuffled order (every epoch holds the sampler's n batches)."""
    n = len(loader.sampler)
    epoch, pos = divmod(step, n)
    loader.sampler.set_epoch(epoch)
    return loader._make(list(loader.sampler)[pos])


def matcha_training(root, csvs, seed, where, which):
    """Phase 16, training: ``which`` "tts1" (MatchaTTS on the csv's
    durations) or "tts2" (MatchaTTS_MAS, the fused MAS search on every
    step). Returns the MAS search's launches in the run and the numbers the
    record and PERF.md need."""
    import numpy as np
    import torch

    from jatts_torch.bin import tts_train
    from jatts_torch.modules.noise import set_noise_generator
    from jatts_torch.modules.dropout import set_dropout_rate
    from jatts_torch.ops import mas
    from jatts_torch.train.steps_matcha import matchatts_kwargs
    from jatts_torch.train.trainer import Trainer
    from jatts_torch.utils.config import load_config

    mas_run = which == "tts2"
    conf = MATCHA_MAS_CONF if mas_run else MATCHA_CONF
    config = load_config(str(conf))
    cuts = [f"train_max_steps {config['train_max_steps']} -> {MATCHA_STEPS}",
            f"save_interval_steps {config['save_interval_steps']} -> {MATCHA_RESUME}"]
    config.update(train_max_steps=MATCHA_STEPS, save_interval_steps=MATCHA_RESUME)
    if mas_run:
        cuts += [f"{k} {config[k]} -> {v}" for k, v in MAS_GATES.items()]
        config.update(MAS_GATES)
    print(f"Matcha training ({which}): {conf.relative_to(ROOT)} (batch {config['batch_size']}, "
          f"{config['optimizer_type']} {config['optimizer_params']['lr']}, {config['scheduler_type']}, grad_norm "
          f"{config['grad_norm']}), f32; reductions: {', '.join(cuts)}", flush=True)
    outdir = str(Path(root) / f"exp_matcha_{which}")
    # deterministic cuDNN for the run, the replay and the backend comparison,
    # so that equal inputs give equal bits; the times below are taken without it
    torch.backends.cudnn.deterministic = True
    reset_all_launches()
    t0 = time.perf_counter()
    trainer = tts_train.run(*csvs, config, outdir, seed=seed, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    hist = trainer.history
    loader = trainer.train_loader
    n_mas = counts["mas.path"]
    print(f"Matcha training ({which}): {len(loader.dataset)} utterances in {len(loader.sampler)} batches, "
          f"{trainer.steps} steps in {run_s:.1f} s; launches: fused MAS search {n_mas} (limit "
          f"{MATCHA_STEPS if mas_run else 0}), K2 {counts['mas.fwd']}, K3 {counts['mas.backtrace']}, flash "
          f"{sum(v for k, v in counts.items() if k.startswith('k1'))} (limit 0)", flush=True)
    check(trainer.steps == MATCHA_STEPS, f"trained {trainer.steps} steps")
    check(all(math.isfinite(v) for h in hist for v in h.values()), "a Matcha training stat is not finite")
    check(all(v == 0 for k, v in counts.items() if k != "mas.path"), f"Matcha training launched {counts}")
    check(n_mas == (MATCHA_STEPS if mas_run else 0), f"fused MAS search launches {n_mas}")
    # the ungated part of the loss must fall (the gates move the rest)
    core = [h["train/cfm_loss"] + h["train/encoder_prior_loss"] for h in hist]
    first, last = float(np.mean(core[:10])), float(np.mean(core[-10:]))
    print(f"Matcha training ({which}): cfm + prior loss, mean of the first 10 steps {first:.4f}, of the last 10 "
          f"{last:.4f}; whole loss {hist[0]['train/loss']:.4f} -> {hist[-1]['train/loss']:.4f}", flush=True)
    check(last < first, "the Matcha loss did not fall")
    if mas_run:
        gated = ("train/forward_sum_loss", "train/duration_loss", "train/binary_loss")
        on = [tuple(h[k] != 0.0 for k in gated) for h in hist]
        want = [(s < 20, s > 20, s > 30) for s in range(MATCHA_STEPS)]
        print(f"Matcha-MAS gates: forward-sum on {sum(o[0] for o in on)} steps, duration {sum(o[1] for o in on)}, "
              f"bin {sum(o[2] for o in on)} (20, 29, 19)", flush=True)
        check(on == want, "a Matcha-MAS loss gate opened at the wrong step")

    # resume from the interval checkpoint and replay the last two steps
    model2 = tts_train.MODELS[config["model_type"]](**trainer.config["model_params"], device="cuda")
    resumed = Trainer(trainer.config, model2, trainer.criterions, trainer.loss_fn, loader,
                      outdir=outdir + "_resumed", seed=seed)
    resumed.init_state()
    resumed.load_checkpoint(str(Path(outdir) / f"checkpoint-{MATCHA_RESUME}steps"))
    replay = [resumed.train_step(_batch_at(loader, s)) for s in range(MATCHA_RESUME, MATCHA_STEPS)]
    same_stats = replay == hist[MATCHA_RESUME:]
    same = all(torch.equal(model2.state_dict()[k], v) for k, v in trainer.model.state_dict().items())
    print(f"Matcha resume ({which}) from checkpoint-{MATCHA_RESUME}steps, steps {MATCHA_RESUME}-{MATCHA_STEPS - 1} "
          f"replayed: stats bitwise equal {same_stats}, parameters bitwise equal {same}", flush=True)
    check(same_stats and same, "the resumed Matcha trainer differs")
    del resumed, model2

    model, params, crit = trainer.model, trainer.params, trainer.criterions
    big = max(loader.sampler.batches, key=lambda idx: sum(loader.dataset.get_frame_len(i) for i in idx))
    tb = trainer.to_device(loader._make(big))
    shape = (tb["ys"].shape[0], tb["ys"].shape[1], tb["xs"].shape[1])
    out = {"run_s": run_s, "launches": n_mas}
    if mas_run:
        # on the step's own lattice: the kernels against the plain search
        with torch.no_grad():
            lp = model(**matchatts_kwargs(tb, model))["log_p_attn"].detach()
        out["own_check"] = check_mas("Matcha-MAS step's lattice", lp, tb["ilens"], tb["olens"])
        out["mas_ms"] = time_ms(lambda: mas.mas_path_fused(lp, tb["ilens"], tb["olens"]))
        # the same step under mas_backend scan: identical durations and losses
        m = tts_train.MODELS[config["model_type"]](**trainer.config["model_params"], device="cuda")
        m.load_state_dict(model.state_dict())
        set_dropout_rate(m, 0.0)
        m.train()
        res = {}
        before = mas.path_launches
        for backend in ("auto", "scan"):
            m.mas_backend = backend
            rows = []
            for step in (0, 40):
                set_noise_generator(m, torch.Generator(device="cuda").manual_seed(seed + 7))
                with torch.no_grad():
                    fwd = m(**matchatts_kwargs(tb, m))
                    set_noise_generator(m, torch.Generator(device="cuda").manual_seed(seed + 7))
                    loss, stats = trainer.loss_fn(m, tb, crit, trainer.config, step)
                rows.append((fwd["ds"], float(loss), {k: float(v) for k, v in stats.items()}))
            res[backend] = rows
        check(mas.path_launches - before == 4, f"auto launched the fused search {mas.path_launches - before} "
              "times in 4 forwards, scan must launch none")
        same_ds = all(torch.equal(a[0], s[0]) for a, s in zip(res["auto"], res["scan"]))
        same_loss = all(a[1:] == s[1:] for a, s in zip(res["auto"], res["scan"]))
        print(f"Matcha-MAS step at batch {shape}, mas_backend auto vs scan (dropout 0, the same noise): ds "
              f"identical {same_ds} ({int(res['auto'][0][0].sum())} frames), losses and stats identical at steps 0 "
              f"and 40 {same_loss} (loss {res['auto'][0][1]:.6f}, {res['auto'][1][1]:.6f})", flush=True)
        check(same_ds and same_loss, "mas_backend auto and scan disagree on the Matcha-MAS step")
        del m

    torch.backends.cudnn.deterministic = False

    # one step at the largest batch and its parts (host clock)
    def host_ms(fn, iters=3):
        return time_ms(fn, iters=iters, warmup=1, host_clock=True)

    def loss_at(step):
        return trainer.loss_fn(model, tb, crit, trainer.config, step)[0]

    def step_at(step):
        grads = torch.autograd.grad(loss_at(step), params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = g
        trainer.optimizer.step()
        for p in params:
            p.grad = None

    model.train()
    t_gate = 0 if mas_run else 1  # tts2: forward-sum on; tts1: the duration loss on
    fwd_ms = host_ms(lambda: loss_at(t_gate))
    loss = loss_at(t_gate)
    bwd_ms = host_ms(lambda: torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True))
    step_ms = host_ms(lambda: step_at(t_gate))
    wall_ms, busy_ms, events = profile_ms(lambda: step_at(t_gate))
    mas_dev = sum(e.self_device_time_total for e in events if "mas_path_kernel" in e.key) / 1e3
    out.update(step_ms=step_ms, fwd_ms=fwd_ms, bwd_ms=bwd_ms, idle=1 - busy_ms / wall_ms, shape=shape)
    line = (f"Matcha training step ({which}) f32, batch {shape} (B, T_feats, T_text), gates of step {t_gate}: "
            f"whole step {step_ms:.1f} ms (host clock); forward+loss {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms")
    if mas_run:
        from jatts_torch.losses.align import ForwardSumLoss

        lpg = model(**matchatts_kwargs(tb, model))["log_p_attn"]
        fsum = ForwardSumLoss()
        ctc_fwd = host_ms(lambda: fsum(lpg, tb["ilens"], tb["olens"]))
        ctc_bwd = host_ms(lambda: torch.autograd.grad(fsum(lpg, tb["ilens"], tb["olens"]), lpg))
        step_late = host_ms(lambda: step_at(40))
        out.update(ctc_ms=ctc_bwd, ctc_share=ctc_bwd / step_ms, step_late_ms=step_late, mas_dev_ms=mas_dev)
        line += (f"; the CTC loop forward {ctc_fwd:.1f} ms, forward+backward {ctc_bwd:.1f} ms = "
                 f"{ctc_bwd / step_ms:.3f} of the step; the step at 40 (no forward-sum) {step_late:.1f} ms; the "
                 f"fused MAS search {out['mas_ms']:.4f} ms alone, {mas_dev:.4f} ms of device time in the profiled "
                 f"step = {mas_dev / step_ms:.5f} of the step")
    print(line + f"; {where}", flush=True)
    print(f"profile of one Matcha step ({which}): wall {wall_ms:.1f} ms under the profiler, device busy "
          f"{busy_ms:.1f} ms in {sum(e.count for e in events)} kernels, idle share {1 - busy_ms / wall_ms:.3f}",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return out


def matcha_slice(root, align_paths, freqs, seed, where):
    """Phase 16. Returns the serving numbers and both trainings'."""
    t_phase = time.perf_counter()
    serve = matcha_serving(seed, where)
    train_csv, dev_csv, stats, tokens = write_fs2_corpus(root, align_paths, freqs, tag="matcha", seed=seed,
                                                         mel_only=True)
    tts1 = matcha_training(root, (train_csv, dev_csv, stats, tokens), seed, where, "tts1")
    # tts2 finds its own durations: the same rows without the durations column
    tts2 = matcha_training(root, (*mel_only_csvs(train_csv, dev_csv), stats, tokens), seed, where, "tts2")
    print(f"phase 16 (Matcha serving, tts1 and tts2 training): {time.perf_counter() - t_phase:.1f} s; {where}",
          flush=True)
    return serve, tts1, tts2



# ---------------------------------------------------------------------------
# phase 17: mel-VITS (serving, tts2 training with the fused MAS search on
# every micro-step, decode)
# ---------------------------------------------------------------------------

VITS_CONF = ROOT / "egs" / "jsut" / "tts2" / "conf" / "vits.v1.bs32.yaml"
VITS_STEPS = 50  # the conf's train_max_steps is 100000
VITS_RESUME = 48  # an interval checkpoint at an accumulation boundary: steps 48 and 49 are replayed


def randomize_flow_projections(model, seed):
    """Seed-made values for the flows' zero-initialised projections (the
    couplings' and the conv flows' ``proj``), so that no flow is the identity."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "flows." in name and ".proj." in name:
                p.copy_((torch.randn(p.shape, generator=g) * 0.02).to(p.device))


def vits_serving(seed, where):
    """Phase 17, serving: the JSUT mel-VITS conf as it stands, f32, seed-made
    weights (the flows' projections non-zero), phase 7's HiFi-GAN,
    ``noise_scale`` 0.667; 16 requests through BatchingServer."""
    import numpy as np
    import torch

    from jatts_torch.models.vits import VITS
    from jatts_torch.serving import BatchingServer, ServingBundle
    from jatts_torch.serving.bundle import inference_kwargs
    from jatts_torch.utils.config import load_config
    from jatts_torch.vocoder.hifigan import HiFiGANGenerator

    config = load_config(str(VITS_CONF))
    kw = inference_kwargs(config)
    sr, max_frames, bucket, batch = config["sampling_rate"], 1024, 128, 8
    torch.manual_seed(seed)
    model = VITS(idim=64, **config["model_params"], device="cuda").eval()
    randomize_flow_projections(model, seed)
    voc = HiFiGANGenerator(device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        # as phase 7: centre the random durations on max_frames / bucket frames a token
        model.duration_predictor.linear.weight.mul_(0.1)
        model.duration_predictor.linear.bias.fill_(math.log(1.0 + max_frames / bucket))
    rng = np.random.default_rng(seed)
    mel_mean = rng.normal(-4.0, 1.0, 80).astype(np.float32)
    mel_scale = rng.uniform(0.5, 2.0, 80).astype(np.float32)
    requests = [rng.integers(1, 64, size=int(n)).tolist() for n in rng.integers(40, bucket + 1, size=16)]
    requests[0] = rng.integers(1, 64, size=bucket).tolist()
    bundle = ServingBundle(model, voc, mel_mean, mel_scale, batch_size=batch, buckets=[bucket],
                           max_frames=max_frames, wav_format="f32", infer_kwargs=kw)
    mp = config["model_params"]
    print(f"VITS serving: {VITS_CONF.relative_to(ROOT)} as it stands (adim {mp['adim']}, {mp['aheads']} heads, "
          f"{len(model.text_encoder.encoder.encoders)}-block text encoder, "
          f"{len(model.posterior_encoder.encoder.conv_layers)}-layer posterior WaveNet, "
          f"{len(model.flow.flows) // 2} couplings x {len(model.flow.flows[0].encoder.conv_layers)} layers, decoder "
          f"{mp['dlayers']} blocks of {mp['dunits']} units, kernel {mp['conformer_dec_kernel_size']}; noise_scale "
          f"{kw['noise_scale']}), f32, TF32 off; HiFi-GAN 512 ch bf16", flush=True)
    bundle.synthesize(requests[:batch])  # warm-up (cuDNN/cuBLAS plans)
    torch.cuda.synchronize()

    reset_all_launches()
    t0 = time.perf_counter()
    with BatchingServer(bundle, max_delay_ms=20.0) as server:
        futures = [server.submit(token_ids=ids) for ids in requests]
        results = [f.result(timeout=600) for f in futures]
    served_s = time.perf_counter() - t0
    counts = launch_counts()
    print(f"VITS served {len(results)} requests in {server.stats['batches']} batches, {served_s:.3f} s; "
          f"kernel launches {sum(counts.values())} (limit 0: no attention kernel, no search at inference)",
          flush=True)
    check(sum(counts.values()) == 0, f"VITS serving launched a kernel: {counts}")
    hop = voc.hop_size
    for i, r in enumerate(results):
        n = r["mel"].shape[0]
        check(0 < n <= max_frames, f"VITS request {i}: olens {n}")
        check(r["wav"].shape == (n * hop,), f"VITS request {i}: wav {r['wav'].shape} != olens*hop")
        check(bool(np.isfinite(r["wav"]).all() and np.isfinite(r["mel"]).all()), f"VITS request {i}: not finite")

    # the seed reaches the prior's noise
    full = requests[:batch]
    a, b, c = (bundle.synthesize(full, seed=s) for s in (0, 0, 1))
    same = all(np.array_equal(x["wav"], y["wav"]) and np.array_equal(x["mel"], y["mel"]) for x, y in zip(a, b))
    other = max(float(np.abs(x["mel"] - y["mel"]).max()) for x, y in zip(a, c))
    print(f"VITS seed: seed 0 twice bitwise equal {same}; seed 1 vs 0 max |mel diff| {other:.3e} "
          f"(limit > 1e-3)", flush=True)
    check(same and other > 1e-3, "the serving seed does not fix (or does not reach) the VITS noise")
    xs, ilens = bundle.prepare(full)
    with torch.no_grad():
        ref = model.inference(xs, ilens, max_frames, generator=torch.Generator(device="cuda").manual_seed(0), **kw)
    ref_mel = (ref["feat_gen"].float() * bundle.mel_scale + bundle.mel_mean).cpu().numpy()
    ref_olens = ref["olens"].tolist()
    check([r["mel"].shape[0] for r in a] == ref_olens, "served olens != VITS.inference olens")
    mel_err = max(float(np.abs(r["mel"] - ref_mel[i, :n]).max()) for i, (r, n) in enumerate(zip(a, ref_olens)))
    mel_top = max(1.0, float(np.abs(ref_mel).max()))
    print(f"VITS served mel vs VITS.inference on the same generator: max |diff| {mel_err:.3e} "
          f"(tol 1e-5 x {mel_top:.2f})", flush=True)
    check(mel_err <= 1e-5 * mel_top, "the served mel differs from VITS.inference")

    # times: a pcm16 batch, VITS.inference, its inverse flow and decoder at
    # the full capacity, HiFi-GAN, a profiled batch
    pcm = ServingBundle(model, voc, mel_mean, mel_scale, batch_size=batch, buckets=[bucket],
                        max_frames=max_frames, infer_kwargs=kw)
    batch_ms = time_ms(lambda: pcm.synthesize(full), iters=3, warmup=1)
    audio_s = sum(ref_olens) * hop / sr
    adim = mp["adim"]
    y_mask = torch.ones(batch, max_frames, 1, device="cuda")
    z_p = torch.randn(batch, max_frames, adim, device="cuda")
    full_lens = torch.full((batch,), max_frames, device="cuda")
    with torch.no_grad():
        flow_ms = time_ms(lambda: model.flow(z_p, y_mask, inverse=True), iters=5, warmup=1)
        dec_ms = time_ms(lambda: model._decode(z_p, full_lens, max_frames), iters=5, warmup=1)
        mel_b = torch.from_numpy(ref_mel).cuda().to(torch.bfloat16)
        voc_ms = time_ms(lambda: voc(mel_b), iters=5, warmup=1)
        acoustic_ms = time_ms(lambda: model.inference(xs, ilens, max_frames, **kw), iters=3, warmup=1)
    wall_ms, busy_ms, events = profile_ms(lambda: pcm.synthesize(full))
    print(
        f"VITS serving f32 pcm16 B={batch} bucket={bucket} max_frames={max_frames}: {batch_ms:.2f} ms per batch, "
        f"RTF {batch_ms / 1e3 / audio_s:.5f} ({audio_s:.2f} s of audio, olens {min(ref_olens)}-{max(ref_olens)}); "
        f"VITS.inference {acoustic_ms:.2f} ms (at {batch} x {max_frames}: the inverse flow {flow_ms:.2f} ms, the "
        f"decoder {dec_ms:.2f} ms), HiFi-GAN {voc_ms:.2f} ms; profiled batch: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; {where}",
        flush=True,
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"batch_ms": batch_ms, "rtf": batch_ms / 1e3 / audio_s, "acoustic_ms": acoustic_ms, "flow_ms": flow_ms,
            "decoder_ms": dec_ms, "voc_ms": voc_ms, "idle": 1 - busy_ms / wall_ms}


def vits_training(root, csvs, seed, where):
    """Phase 17, training: ``bin/tts_train.py:run`` on the JSUT conf (batch
    8, accumulation 4, Adam, StepLR, grad norm 1), the gates cut to 20 and
    30 steps. Every micro-step's search (the fused kernel) is held against
    the plain search on the same lattice as it runs. Returns the numbers
    the record and PERF.md need."""
    import numpy as np
    import torch

    from jatts_torch.bin import tts_train
    from jatts_torch.losses.align import ForwardSumLoss
    from jatts_torch.modules.noise import set_noise_generator
    from jatts_torch.ops import mas
    from jatts_torch.train.steps_vits import vits_kwargs
    from jatts_torch.train.trainer import Trainer
    from jatts_torch.utils.config import load_config

    config = load_config(str(VITS_CONF))
    cuts = [f"train_max_steps {config['train_max_steps']} -> {VITS_STEPS}",
            f"save_interval_steps {config['save_interval_steps']} -> {VITS_RESUME}"]
    cuts += [f"{k} {config[k]} -> {v}" for k, v in MAS_GATES.items()]
    config.update(train_max_steps=VITS_STEPS, save_interval_steps=VITS_RESUME, **MAS_GATES)
    accum = int(config["gradient_accumulate_steps"])
    print(f"VITS training: {VITS_CONF.relative_to(ROOT)} (batch {config['batch_size']}, accumulation {accum}, "
          f"{config['optimizer_type']} {config['optimizer_params']['lr']}, {config['scheduler_type']}, grad_norm "
          f"{config['grad_norm']}, lambda_mel {config['lambda_mel']}, lambda_align {config['lambda_align']}), f32; "
          f"reductions: {', '.join(cuts)}", flush=True)
    outdir = str(Path(root) / "exp_vits")

    # every search the run makes, against the plain search on its lattice;
    # the initial weights, for the losses on a fixed batch
    real_fused, real_init = mas.mas_path_fused, Trainer.init_state
    searched = {"calls": 0, "cells": 0, "differ": 0}
    initial = {}

    def checked(lp, tl, fl):
        path = real_fused(lp, tl, fl)
        ref = mas.mas_path_ref(lp, tl, fl)
        searched["calls"] += 1
        searched["cells"] += path.numel()
        searched["differ"] += int((path != ref).sum())
        return path

    def init_and_keep(self):
        real_init(self)
        initial.update({k: v.detach().clone() for k, v in self.model.state_dict().items()})

    torch.backends.cudnn.deterministic = True
    mas.mas_path_fused, Trainer.init_state = checked, init_and_keep
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        trainer = tts_train.run(*csvs, config, outdir, seed=seed, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        mas.mas_path_fused, Trainer.init_state = real_fused, real_init
    hist = trainer.history
    loader = trainer.train_loader
    n_mas = counts["mas.path"]
    print(f"VITS training: {len(loader.dataset)} utterances in {len(loader.sampler)} batches, {trainer.steps} "
          f"steps in {run_s:.1f} s; the trainer's step count counts micro-steps: {trainer.steps} micro-steps, "
          f"{trainer.updates} optimizer updates (accumulation {accum}); launches: fused MAS search {n_mas} (limit "
          f"{VITS_STEPS}: one a micro-step, {accum} an update), K2 {counts['mas.fwd']}, K3 "
          f"{counts['mas.backtrace']}, flash {sum(v for k, v in counts.items() if k.startswith('k1'))} (limit 0); "
          f"every micro-step's search against the plain search on its lattice: {searched['calls']} searches, "
          f"{searched['differ']} of {searched['cells']} frames differ (limit 0)", flush=True)
    check(trainer.steps == VITS_STEPS and trainer.updates == VITS_STEPS // accum,
          f"trained {trainer.steps} micro-steps, {trainer.updates} updates")
    check(all(math.isfinite(v) for h in hist for v in h.values()), "a VITS training stat is not finite")
    check(all(v == 0 for k, v in counts.items() if k != "mas.path"), f"VITS training launched {counts}")
    check(n_mas == VITS_STEPS and searched["calls"] == VITS_STEPS, f"fused MAS search launches {n_mas}")
    check(searched["differ"] == 0, "the fused search disagrees with the plain search on a VITS micro-step")
    gated = ("train/forward_sum_loss", "train/duration_loss", "train/binary_loss")
    on = [tuple(h[k] != 0.0 for k in gated) for h in hist]
    dp, bn = MAS_GATES["dp_train_start_steps"], MAS_GATES["bin_loss_start_steps"]
    want = [(s < dp, s > dp, s > bn) for s in range(VITS_STEPS)]
    print(f"VITS gates: forward-sum on {sum(o[0] for o in on)} steps, duration {sum(o[1] for o in on)}, "
          f"bin {sum(o[2] for o in on)} ({tuple(map(sum, zip(*want)))})", flush=True)
    check(on == want, "a VITS loss gate opened at the wrong step")

    # the mel and KL losses on a fixed batch (the largest), eval mode, the
    # same noise: the initial weights against the trained ones
    model, params, crit = trainer.model, trainer.params, trainer.criterions
    big = max(loader.sampler.batches, key=lambda idx: sum(loader.dataset.get_frame_len(i) for i in idx))
    tb = trainer.to_device(loader._make(big))
    shape = (tb["ys"].shape[0], tb["ys"].shape[1], tb["xs"].shape[1])
    m0 = tts_train.MODELS["VITS"](**trainer.config["model_params"], device="cuda")
    m0.load_state_dict(initial)
    fixed = {}
    for name, m in (("initial", m0), ("trained", model)):
        set_noise_generator(m, torch.Generator(device="cuda").manual_seed(seed + 7))
        with torch.no_grad():
            _, st = trainer.loss_fn(m.eval(), tb, crit, trainer.config, VITS_STEPS)
        fixed[name] = (float(st["train/mel_loss"]), float(st["train/kl_loss"]))
    set_noise_generator(model, trainer.noise_generator)
    del m0
    print(f"VITS losses on the largest batch {shape} (B, T_feats, T_text), eval mode, the same noise: mel "
          f"{fixed['initial'][0]:.4f} -> {fixed['trained'][0]:.4f}, KL {fixed['initial'][1]:.4f} -> "
          f"{fixed['trained'][1]:.4f} (initial -> after {trainer.updates} updates); in the run's stats: mel "
          f"{np.mean([h['train/mel_loss'] for h in hist[:10]]):.4f} -> "
          f"{np.mean([h['train/mel_loss'] for h in hist[-10:]]):.4f}, KL "
          f"{np.mean([h['train/kl_loss'] for h in hist[:10]]):.4f} -> "
          f"{np.mean([h['train/kl_loss'] for h in hist[-10:]]):.4f} (means of the first and last 10 micro-steps)",
          flush=True)
    check(fixed["trained"][0] < fixed["initial"][0] and fixed["trained"][1] < fixed["initial"][1],
          "the VITS mel and KL losses did not fall")

    # resume from the interval checkpoint and replay the last two micro-steps
    model2 = tts_train.MODELS["VITS"](**trainer.config["model_params"], device="cuda")
    resumed = Trainer(trainer.config, model2, crit, trainer.loss_fn, loader, outdir=outdir + "_resumed", seed=seed)
    resumed.init_state()
    resumed.load_checkpoint(str(Path(outdir) / f"checkpoint-{VITS_RESUME}steps"))
    replay = [resumed.train_step(_batch_at(loader, s)) for s in range(VITS_RESUME, VITS_STEPS)]
    same_stats = replay == hist[VITS_RESUME:]
    same = all(torch.equal(model2.state_dict()[k], v) for k, v in model.state_dict().items())
    same_acc = all(torch.equal(a, b) for a, b in zip(resumed.acc_grads, trainer.acc_grads))
    print(f"VITS resume from checkpoint-{VITS_RESUME}steps, micro-steps {VITS_RESUME}-{VITS_STEPS - 1} replayed: "
          f"stats bitwise equal {same_stats}, parameters bitwise equal {same}, accumulated gradients bitwise "
          f"equal {same_acc}", flush=True)
    check(same_stats and same and same_acc, "the resumed VITS trainer differs")
    del resumed, model2

    # on the largest batch's lattice: the kernels against the plain search, and their time
    model.train()
    with torch.no_grad():
        lp = model(**vits_kwargs(tb, model))["log_p_attn"].detach()
    out = {"run_s": run_s, "launches": n_mas, "updates": trainer.updates, "fixed": fixed, "shape": shape,
           "searched": dict(searched)}
    out["own_check"] = check_mas("VITS step's lattice", lp, tb["ilens"], tb["olens"])
    out["mas_ms"] = time_ms(lambda: mas.mas_path_fused(lp, tb["ilens"], tb["olens"]))
    torch.backends.cudnn.deterministic = False

    # one micro-step (forward, loss, backward) at the largest batch, with
    # and without the forward-sum loss, and its parts (host clock)
    def host_ms(fn, iters=3):
        return time_ms(fn, iters=iters, warmup=1, host_clock=True)

    def loss_at(step):
        return trainer.loss_fn(model, tb, crit, trainer.config, step)[0]

    def micro_at(step):
        torch.autograd.grad(loss_at(step), params, allow_unused=True)

    fwd_ms = host_ms(lambda: loss_at(0))
    loss = loss_at(0)
    bwd_ms = host_ms(lambda: torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True))
    del loss
    step_ms = host_ms(lambda: micro_at(0))
    step_late = host_ms(lambda: micro_at(40))
    lpg = model(**vits_kwargs(tb, model))["log_p_attn"]
    fsum = ForwardSumLoss()
    ctc_fwd = host_ms(lambda: fsum(lpg, tb["ilens"], tb["olens"]))
    ctc_ms = host_ms(lambda: torch.autograd.grad(fsum(lpg, tb["ilens"], tb["olens"]), lpg))
    del lpg
    wall_ms, busy_ms, events = profile_ms(lambda: micro_at(40))
    mas_dev = sum(e.self_device_time_total for e in events if "mas_path_kernel" in e.key) / 1e3
    wall0, busy0, _ = profile_ms(lambda: micro_at(0))
    out.update(step_ms=step_ms, step_late_ms=step_late, fwd_ms=fwd_ms, bwd_ms=bwd_ms, ctc_ms=ctc_ms,
               ctc_share=ctc_ms / step_ms, mas_dev_ms=mas_dev, mas_share=mas_dev / step_late,
               idle=1 - busy_ms / wall_ms, idle_fsum=1 - busy0 / wall0)
    print(f"VITS micro-step f32 (forward, loss, backward), batch {shape} (B, T_feats, T_text): with the "
          f"forward-sum loss (step 0) {step_ms:.1f} ms (forward+loss {fwd_ms:.1f}, backward {bwd_ms:.1f}), the CTC "
          f"loop's forward {ctc_fwd:.1f} ms, forward+backward {ctc_ms:.1f} ms = {ctc_ms / step_ms:.3f} of it, idle "
          f"share {1 - busy0 / wall0:.3f}; without it (step 40) {step_late:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; the fused MAS search {out['mas_ms']:.4f} ms alone, {mas_dev:.4f} ms of "
          f"device time in the profiled micro-step = {mas_dev / step_late:.5f} of it (host clock; {accum} "
          f"micro-steps and one Adam update an optimizer step); {where}", flush=True)
    print(f"profile of one VITS micro-step (step 40): wall {wall_ms:.1f} ms under the profiler, device busy "
          f"{busy_ms:.1f} ms in {sum(e.count for e in events)} kernels", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return out, outdir


def vits_decode(root, expdir, csvs, dur_csv, stats, tokens, seed, where):
    """Phase 17, decode: ``bin/tts_decode.py`` with the trained checkpoint,
    phase 15's seed-made HiFi-GAN checkpoint and Griffin-Lim, the dev rows
    twice (a second batch of a shape gives the steady state); the mels
    against ``VITS.inference`` on the generator of each batch. The run's 12
    updates at lr 1e-4 leave the duration predictor near its initial 0
    frames a token, so its output bias is set to the corpus's mean
    log(1 + frames) (from ``dur_csv``'s durations) in a copy of the
    checkpoint, as phase 7 centres its random durations."""
    import numpy as np
    import torch
    import yaml

    from jatts_torch.bin import tts_decode
    from jatts_torch.data.batcher import round_up
    from jatts_torch.data.dataset import TTSDataset
    from jatts_torch.models.vits import VITS
    from jatts_torch.utils.checkpoint import checkpoint_steps, find_latest_checkpoint, restore_checkpoint, save_checkpoint
    from jatts_torch.utils.config import load_config
    from jatts_torch.utils.io import read_audio, read_csv, write_csv

    train_expdir = expdir
    dur_rows, _ = read_csv(dur_csv, dict_reader=True)
    log_d = float(np.mean([np.log1p(float(d)) for r in dur_rows for d in r["durations"].split()]))
    src = find_latest_checkpoint(train_expdir)
    state = restore_checkpoint(src, map_location="cpu")
    state["model"]["duration_predictor.linear.bias"].fill_(log_d)
    expdir = str(Path(root) / "exp_vits_decode")
    save_checkpoint(expdir, checkpoint_steps(src), state)
    print(f"VITS decode: the trained checkpoint with the duration predictor's output bias set to the corpus's "
          f"mean log(1 + frames) {log_d:.4f}", flush=True)
    # one full batch of dev rows, then the same rows under other ids: the
    # second batch has the first one's shape
    dev_rows, _ = read_csv(csvs[1], dict_reader=True)
    base = [dict(dev_rows[i % len(dev_rows)], sample_id=f"{dev_rows[i % len(dev_rows)]['sample_id']}_{i}")
            for i in range(RECIPE_BATCH)]
    decode_csv = str(Path(root) / "vits_decode.csv")
    write_csv(base + [dict(r, sample_id=r["sample_id"] + "_again") for r in base], decode_csv)
    ckpt, voc_conf, voc_stats, _ = write_pwg_checkpoint(root, seed, stats)
    exp_conf = load_config(str(Path(train_expdir) / "config.yml"))
    exp_conf["vocoder"] = {"checkpoint": ckpt, "config": voc_conf, "stats": voc_stats}
    exp_conf_path = str(Path(root) / "vits_exp_config.yml")
    with open(exp_conf_path, "w") as f:
        yaml.dump(exp_conf, f)
    hop, sr = int(exp_conf["hop_size"]), int(exp_conf["sampling_rate"])
    decoded = {}
    for name, extra in (("hifigan", []), ("griffin_lim", ["--vocoder", "griffin_lim"])):
        reset_all_launches()
        t0 = time.perf_counter()
        decoded[name] = tts_decode.main([
            "--csv", decode_csv, "--stats", stats, "--token-list", tokens, "--expdir", expdir,
            "--config", exp_conf_path, "--outdir", str(Path(root) / f"vits_decode_{name}"),
            "--batch-size", str(RECIPE_BATCH), "--max-frames", "2048", "--verbose", "0", *extra])
        torch.cuda.synchronize()
        decoded[name]["wall_s"] = time.perf_counter() - t0
        check(sum(launch_counts().values()) == 0, f"VITS decode ({name}) launched a kernel")
    hg, gl = decoded["hifigan"], decoded["griffin_lim"]
    check(hg["vocoder"] == "Vocoder" and gl["vocoder"] == "GriffinLimVocoder", "VITS decode vocoder choice")
    check(hg["olens"] == gl["olens"], "the two VITS decode runs predicted different lengths")
    olens = hg["olens"]
    min_frames = int(exp_conf.get("fft_size", 2048)) // hop + 1
    check(len(olens) == 2 * RECIPE_BATCH and min(olens.values()) >= min_frames,
          f"VITS decode: degenerate or missing predictions {olens}")
    for name in decoded:
        for utt, olen in olens.items():
            wav, wav_sr = read_audio(str(Path(root) / f"vits_decode_{name}" / "wav" / f"{utt}.wav"))
            check(wav_sr == sr and len(wav) == olen * hop and bool(np.isfinite(wav).all()),
                  f"VITS decode ({name}) {utt}: {len(wav)} samples, want {olen * hop}")

    model = VITS(**exp_conf["model_params"], device="cuda")
    model.load_state_dict(restore_checkpoint(find_latest_checkpoint(expdir), map_location="cuda")["model"])
    model.eval()
    ds = TTSDataset(decode_csv, stats, exp_conf["feat_list"], tokens, is_inference=True)
    items = [ds[i] for i in range(len(ds))]
    mel_err, mel_max = 0.0, 0.0
    for i in range(0, len(items), RECIPE_BATCH):
        chunk = items[i : i + RECIPE_BATCH]
        xs = torch.zeros((len(chunk), round_up(max(len(it["x"]) for it in chunk), 16)), dtype=torch.long)
        for j, it in enumerate(chunk):
            xs[j, : len(it["x"])] = torch.from_numpy(it["x"])
        ilens = torch.tensor([len(it["x"]) for it in chunk])
        with torch.no_grad():
            want = model.inference(xs.cuda(), ilens.cuda(), 2048, noise_scale=float(exp_conf["noise_scale"]),
                                   generator=torch.Generator(device="cuda").manual_seed(i))
        for j, it in enumerate(chunk):
            olen = int(want["olens"][j])
            ref = want["feat_gen"][j, :olen].cpu().numpy()
            check(olens[it["utt_id"]] == olen, f"{it['utt_id']}: olens {olens[it['utt_id']]} vs {olen}")
            for name in decoded:
                got = np.load(str(Path(root) / f"vits_decode_{name}" / "wav" / f"{it['utt_id']}_mel.npy"))
                mel_err = max(mel_err, float(np.abs(got - ref).max()))
            mel_max = max(mel_max, float(np.abs(ref).max()))
    tol = 1e-5 * max(1.0, mel_max)
    steady = {name: [b["seconds"] * 1e3 for b in d["batches"] if not b["first_of_shape"]] for name, d in decoded.items()}
    first = {name: [b["seconds"] * 1e3 for b in d["batches"] if b["first_of_shape"]] for name, d in decoded.items()}
    print(f"VITS decode: {len(olens)} utterances (olens {min(olens.values())}-{max(olens.values())} frames) in "
          f"batches of {RECIPE_BATCH} at 2048 frames; _mel.npy vs VITS.inference on each batch's generator: max "
          f"|diff| {mel_err:.2e} (tol {tol:.2e}); " + "; ".join(
              f"{name}: first batch {first[name][0]:.2f} ms, steady {statistics.median(steady[name]):.2f} ms, RTF "
              f"{decoded[name]['rtf']:.6f}, vocoder {1e3 * statistics.median(decoded[name]['vocoder_s']):.2f} ms an "
              f"utterance, wall {decoded[name]['wall_s']:.1f} s" for name in decoded) + f"; {where}", flush=True)
    check(mel_err <= tol, "the decoded VITS mels differ from VITS.inference")
    check(all(steady[name] for name in decoded), "VITS decode: no steady-state batch")
    return {name: {"first_ms": first[name][0], "steady_ms": statistics.median(steady[name]),
                   "rtf": decoded[name]["rtf"], "vocoder_ms": 1e3 * statistics.median(decoded[name]["vocoder_s"])}
            for name in decoded}


def mel_only_csvs(train_csv, dev_csv):
    """The rows of a corpus without their durations column: a model that
    searches its own (tts2)."""
    from jatts_torch.utils.io import read_csv, write_csv

    out = []
    for path in (train_csv, dev_csv):
        rows, _ = read_csv(path, dict_reader=True)
        path_out = path.replace(".csv", "_nodur.csv")
        write_csv([{k: v for k, v in r.items() if k != "durations"} for r in rows], path_out)
        out.append(path_out)
    return out


def vits_slice(root, align_paths, freqs, seed, where):
    """Phase 17. Returns the serving, training and decode numbers."""
    t_phase = time.perf_counter()
    serve = vits_serving(seed, where)
    train_csv, dev_csv, stats, tokens = write_fs2_corpus(root, align_paths, freqs, tag="vits", seed=seed,
                                                         mel_only=True)
    csvs = mel_only_csvs(train_csv, dev_csv)
    train, expdir = vits_training(root, (*csvs, stats, tokens), seed, where)
    decode = vits_decode(root, expdir, csvs, train_csv, stats, tokens, seed, where)
    print(f"phase 17 (VITS serving, tts2 training, decode): {time.perf_counter() - t_phase:.1f} s; {where}",
          flush=True)
    return serve, train, decode


# ---------------------------------------------------------------------------
# phase 18: the VALL-E NAR (training with the non-causal bf16 backward on the
# tensor cores, the 7-level fill, the tts3 decode CLI)
# ---------------------------------------------------------------------------

NAR_CONF = ROOT / "egs" / "hificaptain_jp_female" / "tts3" / "conf" / "valle_nar.given.bs32.yaml"
NAR_STEPS = 100  # the conf's train_max_steps is 400000 (200 before phase 19 needed the run's time)
NAR_WARMUP = 50  # the conf's warmup_steps is 8000
NAR_RESUME = 98  # an interval checkpoint at an accumulation boundary: micro-steps 98 and 99 are replayed
NAR_DECODE_STEPS = 256  # the decode CLI's --max-steps (the AR's capacity, which the NAR fills)
# the launches of one non-causal bf16 backward at d 64: dk/dv and dq on the
# tensor cores, counted apart from the causal ones, and nothing else
NAR_BWD_LAUNCH = {"k1.launches_bwd_dkv": 1, "k1.launches_bwd_dq": 1, "k1.launches_bwd_dkv_tc_noncausal": 1,
                  "k1.launches_bwd_dq_tc_noncausal": 1}


def launches_since(before):
    """The counters of :func:`launch_counts` that moved since ``before``, by how much."""
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


def nar_cases(b, h, s):
    """(name, (B, H, Tq, Tk, d), key mask rows as (first valid key, number
    of valid keys) cycled over the batch): the NAR's own largest attention
    with ragged rows (one with a single valid key, one with none), S = 1,
    Tq < Tk, Tq > Tk and a T that ends inside a tile."""
    ragged = [(0, s), (0, s - 1), (0, min(s, 611)), (0, 1), (0, 0), (0, min(s, 65)), (37, s // 2), (0, s // 3)]
    return [
        ("the NAR's largest batch", (b, h, s, s, 64), ragged),
        ("S=1", (2, 2, 1, 1, 64), [(0, 1), (0, 0)]),
        ("Tq < Tk", (3, 2, 200, 333, 64), [(0, 333), (37, 100), (0, 0)]),
        ("Tq > Tk", (3, 2, 517, 130, 64), [(0, 130), (0, 1), (64, 66)]),
        ("ragged T", (3, 2, 1000, 1000, 64), [(0, 1000), (0, 999), (0, 517)]),
    ]


def nar_inputs(shape, rows, seed):
    import torch

    b, h, tq, tk, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(b, h, tq, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h, tk, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    pos = torch.arange(tk, device="cuda")
    key_mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in (rows * b)[:b]])
    return q, k, v, key_mask, do


def check_nar_bwd(name, shape, rows, seed, label="NAR"):
    """The non-causal bf16 dk/dv and dq at d 64 (``launch_dkv<false>``,
    ``launch_dq<false>`` of ``flash_attn_bwd_tc.cu``) against
    ``flash_attention_bwd_ref`` on the same inputs (both fed the plain
    forward's lse and its output rounded to bf16), each output within
    TOL_BWD["bf16"] of every batch item's own max(1, max|plain|)
    (``item_err``); dq 0 on rows that see no key, dk and dv 0 on masked keys;
    one launch each on the non-causal tensor-core counters and none on the
    causal ones; the same bits on a second run; the scalar kernels
    (``flash_attn_bwd.cu``, the form's kernels before) on the same inputs.
    Returns the largest |kernel - plain| of each of dq, dk, dv and the
    scalar kernels' largest over the three."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    q, k, v, key_mask, do = nar_inputs(shape, rows, seed)
    scale = shape[4] ** -0.5
    o, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(), None, key_mask, scale, return_lse=True)
    o = o.bfloat16()
    before = launch_counts()
    got = k1.flash_attention_bwd(q, k, v, None, key_mask, scale, o, lse, do)
    torch.cuda.synchronize()
    ran = launches_since(before)
    check(ran == NAR_BWD_LAUNCH, f"{label} backward {name}: launches {ran} != {NAR_BWD_LAUNCH}")
    again = k1.flash_attention_bwd(q, k, v, None, key_mask, scale, o, lse, do)
    want = k1.flash_attention_bwd_ref(q.float(), k.float(), v.float(), None, key_mask, scale, o.float(), lse,
                                      do.float())
    di = (o.float() * do.float()).sum(-1)
    scalar = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    k1._launch_bwd("dkv", q, k, v, None, key_mask, scale, lse, di, do, scalar[1], scalar[2], False, _lib=k1.KERNEL_BWD)
    k1._launch_bwd("dq", q, k, v, None, key_mask, scale, lse, di, do, scalar[0], None, False, _lib=k1.KERNEL_BWD)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got[:3], again[:3])), f"{label} backward {name}: bits differ between runs")
    check(got[3] is None, f"the {label} backward wrote d(ab) without a bias")
    tol = TOL_BWD["bf16"]
    errs, rel, scalar_rel = {}, {}, 0.0
    scalar_err = 0.0
    for gname, g_, w, s_ in zip(("dq", "dk", "dv"), got, want, scalar):
        check(bool(torch.isfinite(g_).all()), f"{label} backward {name} {gname} not finite")
        errs[gname] = (g_.float() - w).abs().max().item()
        rel[gname] = item_err(g_, w)
        check(rel[gname] <= tol, f"{label} backward {name} {gname} err {rel[gname]} x max(1, max|plain| of its item) > {tol}")
        scalar_rel = max(scalar_rel, item_err(s_, w))
        scalar_err = max(scalar_err, (s_.float() - w).abs().max().item())
    check(scalar_rel <= tol, f"{label} backward {name}: the scalar kernels on the same inputs err {scalar_rel} > {tol}")
    rows_none = torch.isinf(lse)[..., None].expand_as(got[0])
    unseen = ~key_mask[:, None, :, None].expand_as(got[1])
    check(bool((got[0][rows_none] == 0).all()) and bool((got[1][unseen] == 0).all())
          and bool((got[2][unseen] == 0).all()),
          f"{label} backward {name}: dq of a row that sees no key, or dk/dv of a masked key, is not 0")
    b, h, tq, tk, d = shape
    print(f"{label} backward check bf16 non-causal B,H,Tq,Tk,d={b},{h},{tq},{tk},{d} (dk/dv and dq on the tensor cores): "
          f"max_abs_err " + ", ".join(f"{n} {errs[n]:.2e} ({rel[n]:.2e})" for n in errs)
          + f" (max |kernel - plain| (worst item's over max(1, max|plain| of the item)); tol {tol:.0e}); the same "
          f"bits on a second run; the scalar kernels on the same inputs {scalar_rel:.2e}; rows that see no key "
          f"{int(torch.isinf(lse).sum())}, masked keys {int((~key_mask).sum())}", flush=True)
    return errs, scalar_err


def check_nar_chain(shape, rows, seed, label="NAR"):
    """The NAR's attention autograd chain in bf16: FlashAttention (the
    tensor-core forward, whose output and lse feed the non-causal
    tensor-core dk/dv and dq) against autograd through the plain forward in
    f32 on the same inputs; the output within TOL["bf16"], each gradient
    within TOL_BWD["bf16"] of every item's own max(1, max|plain|). Returns
    the largest |kernel - plain| of the output and of the gradients."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    q, k, v, key_mask, do = nar_inputs(shape, rows, seed)
    scale = shape[4] ** -0.5
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = launch_counts()
    out = k1.flash_attention(*leaves, None, key_mask, scale)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    ran = launches_since(before)
    want = {**NAR_BWD_LAUNCH, "k1.launches": 1, "k1.launches_tc": 1}
    check(ran == want, f"{label} autograd chain: launches {ran} != {want}")
    ref_leaves = [x.float().detach().requires_grad_() for x in (q, k, v)]
    ref = k1.flash_attention_ref(*ref_leaves, None, key_mask, scale)
    want = torch.autograd.grad(ref, ref_leaves, do.float())
    errs, parts = {}, []
    for gname, g_, w, tol in zip(("fwd", "dq", "dk", "dv"), (out.detach(), *got), (ref.detach(), *want),
                                 (TOL["bf16"], *[TOL_BWD["bf16"]] * 3)):
        errs[gname] = (g_.float() - w).abs().max().item()
        rel = item_err(g_, w)
        parts.append(f"{gname} {errs[gname]:.2e} ({rel:.2e}, tol {tol:.0e})")
        check(math.isfinite(errs[gname]) and rel <= tol,
              f"{label} autograd chain: {gname} err {rel} x max(1, max|plain| of its item) > {tol}")
    print(f"{label} autograd chain bf16 B,H,T,d={shape[0]},{shape[1]},{shape[2]},{shape[4]} (FlashAttention forward + "
          f"backward vs autograd through the plain forward in f32): max_abs_err (worst item's over max(1, "
          f"max|plain| of the item)) " + ", ".join(parts), flush=True)
    return errs


def nar_bounds_ms(b, h, tq, tk, d):
    """Least times of the three non-causal bf16 kernels with every key
    valid: operations on the bf16 tensor cores (the forward's 2 products,
    4·B·H·Tq·Tk·d FLOP; dk/dv's 4: the scores again, dp, dv, dk; dq's 3:
    the scores again, dp, dq), bytes each input read once and each output
    written once (q, k, v, o, do, dq, dk, dv in bf16; lse, di f32; the key
    mask)."""
    nq, nk = b * h * tq * d * 2, b * h * tk * d * 2
    rows, mask = b * h * tq * 4, b * tk
    pair = 2 * b * h * tq * tk * d  # one product
    out = {}
    for name, nbytes, flops in (("fwd", 2 * nq + 2 * nk + rows + mask, 2 * pair),
                                ("dkv", 2 * nq + 4 * nk + 2 * rows + mask, 4 * pair),
                                ("dq", 3 * nq + 2 * nk + 2 * rows + mask, 3 * pair)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops_ms(flops, "bf16")
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)
    return out


def time_nar_attn(shape, seed, where, label="NAR"):
    """The NAR's attention at ``shape`` (B, H, S, d), every key valid, bf16
    non-causal: the tensor-core forward, dk/dv and dq by CUDA events and
    replayed from a CUDA graph; beside them the scalar dk/dv and dq
    (``flash_attn_bwd.cu``) on the same inputs, the plain forward and
    backward, SDPA with the boolean key mask (forward, and forward +
    backward: the yardstick, never used by the port; its backend printed)
    and the bounds."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, s, d = shape
    q, k, v, key_mask, do = nar_inputs((b, h, s, s, d), [(0, s)], seed)
    scale = d ** -0.5
    o, lse = k1.flash_attention_fwd(q, k, v, None, key_mask, scale)
    di = (o.float() * do.float()).sum(-1)

    def fwd():
        return k1.flash_attention_fwd(q, k, v, None, key_mask, scale)

    def dkv():
        return k1.flash_attention_bwd_dkv(q, k, v, None, key_mask, scale, lse, di, do)

    def dq():
        return k1.flash_attention_bwd_dq(q, k, v, None, key_mask, scale, lse, di, do)

    res = {"fwd": time_ms(fwd), "fwd_graph": graph_ms(fwd), "dkv": time_ms(dkv), "dkv_graph": graph_ms(dkv),
           "dq": time_ms(dq), "dq_graph": graph_ms(dq)}
    sq, sk, sv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    res["dkv_scalar"] = time_ms(lambda: k1._launch_bwd("dkv", q, k, v, None, key_mask, scale, lse, di, do, sk, sv,
                                                       False, _lib=k1.KERNEL_BWD), iters=3, warmup=1)
    res["dq_scalar"] = time_ms(lambda: k1._launch_bwd("dq", q, k, v, None, key_mask, scale, lse, di, do, sq, None,
                                                      False, _lib=k1.KERNEL_BWD), iters=3, warmup=1)
    res["plain_fwd_ms"] = time_ms(lambda: k1.flash_attention_ref(q, k, v, None, key_mask, scale), iters=3, warmup=1)
    res["plain_bwd_ms"] = time_ms(lambda: k1.flash_attention_bwd_ref(q, k, v, None, key_mask, scale, o, lse, do),
                                  iters=3, warmup=1)
    mask = key_mask[:, None, None, :]
    res["sdpa_backend"] = sdpa_choice(q, k, v, attn_mask=mask, scale=scale)
    res["sdpa_fwd_ms"] = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))
    res["sdpa_fwd_graph_ms"] = graph_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    res["sdpa_ms"] = time_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs, attn_mask=mask, scale=scale),
                                                         (qs, ks, vs), do), iters=10, warmup=2)
    res["bounds"] = nar_bounds_ms(b, h, s, s, d)
    res["shape"] = shape
    parts = "; ".join(
        f"{n} kernel {res[n]:.4f} ms (graph replay {res[n + '_graph']:.4f} ms{extra}) (bound {bd[0]:.4f} ms by "
        f"{bd[1]}: {bd[2] / 1e6:.1f} MB, {bd[3] / 1e9:.1f} GFLOP)"
        for n, bd, extra in (("fwd", res["bounds"]["fwd"], ""),
                             ("dkv", res["bounds"]["dkv"], f"; the scalar dk/dv on the same inputs "
                                                           f"{res['dkv_scalar']:.4f} ms"),
                             ("dq", res["bounds"]["dq"], f"; the scalar dq on the same inputs {res['dq_scalar']:.4f} ms")))
    print(f"{label} attention time bf16 non-causal B,H,S,d={b},{h},{s},{d}, every key valid, tensor cores: {parts}; plain "
          f"forward {res['plain_fwd_ms']:.4f} ms, plain backward {res['plain_bwd_ms']:.4f} ms; sdpa (bool key mask, "
          f"{res['sdpa_backend']}) forward {res['sdpa_fwd_ms']:.4f} ms (graph {res['sdpa_fwd_graph_ms']:.4f} ms), "
          f"forward+backward {res['sdpa_ms']:.4f} ms; backward kernels dk/dv + dq {res['dkv'] + res['dq']:.4f} ms = "
          f"{(res['dkv'] + res['dq']) / res['sdpa_ms']:.3f} x sdpa's forward+backward; {where}", flush=True)
    return res


def nar_training(corpus, outdir, seed, where):
    """Phase 18, training: ``bin/tts_train.py:run`` on the NAR conf as it
    stands (d_model 1024, 16 heads, 12 layers, bf16, batch 16 x accumulation
    2, AdamW) with ``attn_backend: flash`` on phase 12's codec corpus, launch
    counts set to 0 just before and read just after; the falling loss, the
    last two micro-steps replayed bitwise from an interval checkpoint with
    the same levels drawn, one step under ``flash`` against one under
    ``xla`` (dropout 0), a micro-step's time and a profiled one. Returns the
    trainer, the launches and the numbers the record and PERF.md need."""
    import numpy as np
    import torch

    from jatts_torch.bin import tts_train
    from jatts_torch.models.valle import VALLENAR
    from jatts_torch.modules.dropout import set_dropout_rate
    from jatts_torch.train.steps_valle import valle_kwargs
    from jatts_torch.train.trainer import Trainer
    from jatts_torch.utils.config import load_config

    config = load_config(str(NAR_CONF))
    mp = config["model_params"]
    cuts = [f"train_max_steps {config['train_max_steps']} -> {NAR_STEPS}",
            f"warmup_steps {config['scheduler_params']['warmup_steps']} -> {NAR_WARMUP}",
            f"save_interval_steps {config['save_interval_steps']} -> {NAR_RESUME}"]
    print(f"VALL-E NAR config {NAR_CONF.relative_to(ROOT)} (d_model {mp['d_model']}, {mp['n_heads']} heads, "
          f"{mp['n_layers']} layers, {mp['n_resp_levels']} levels, dtype {mp['dtype']}, batch {config['batch_size']} "
          f"x accumulation {config['gradient_accumulate_steps']}, {config['optimizer_type']}) with attn_backend flash; "
          f"reductions: {', '.join(cuts)}; phase 12's 64-utterance synthetic codec corpus", flush=True)
    config.update(train_max_steps=NAR_STEPS, save_interval_steps=NAR_RESUME)
    config["scheduler_params"] = {**config["scheduler_params"], "warmup_steps": NAR_WARMUP}

    # the batches of the steps to be replayed, and every step's levels: the
    # wrapper draws them as the model does (one randint from its noise
    # generator) and hands them in
    real_step, real_fwd = Trainer.train_step, VALLENAR.forward
    kept, levels = {}, []

    def keep_step(self, batch):
        if self.steps >= NAR_RESUME:
            kept[self.steps] = batch
        return real_step(self, batch)

    def drawn_fwd(self, text, *args, quant_levels=None, **kwargs):
        if quant_levels is None and self.training:
            quant_levels = torch.randint(0, self.n_resp_levels, (text.shape[0],), generator=self.noise_generator,
                                         device=text.device)
            levels.append(quant_levels.tolist())
        return real_fwd(self, text, *args, quant_levels=quant_levels, **kwargs)

    Trainer.train_step, VALLENAR.forward = keep_step, drawn_fwd
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        trainer = tts_train.run(*corpus, config, outdir, seed=seed, device="cuda", attn_backend="flash")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        Trainer.train_step, VALLENAR.forward = real_step, real_fwd
    run_levels = list(levels)
    layers = trainer.model.n_layers
    loader = trainer.train_loader
    n = layers * NAR_STEPS
    want = {"k1.launches": n, "k1.launches_tc": n, "k1.launches_bwd_dkv": n, "k1.launches_bwd_dq": n,
            "k1.launches_bwd_dkv_tc_noncausal": n, "k1.launches_bwd_dq_tc_noncausal": n}
    print(f"VALL-E NAR training: {len(loader.dataset)} utterances in {len(loader.sampler)} batches of <= "
          f"{config['batch_size']}, {trainer.steps} micro-steps ({trainer.updates} updates) in {run_s:.1f} s; launches: "
          f"forward {counts['k1.launches']} (tensor cores {counts['k1.launches_tc']}), dk/dv "
          f"{counts['k1.launches_bwd_dkv']} (non-causal tensor cores {counts['k1.launches_bwd_dkv_tc_noncausal']}), "
          f"dq {counts['k1.launches_bwd_dq']} (non-causal tensor cores {counts['k1.launches_bwd_dq_tc_noncausal']}); "
          f"limit {layers} a micro-step each = {n}, every other counter 0 (the causal ones "
          f"{[counts[k] for k in ('k1.launches_causal', 'k1.launches_bwd_dkv_tc', 'k1.launches_bwd_dq_tc')]}); levels "
          f"drawn in the first 4 micro-steps {run_levels[:4]}", flush=True)
    check(trainer.steps == NAR_STEPS, f"trained {trainer.steps} NAR micro-steps")
    check(all(math.isfinite(v) for h in trainer.history for v in h.values()), "a NAR training stat is not finite")
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"NAR training launches {counts}: every forward, dk/dv and dq must take the tensor-core kernels (the "
          f"non-causal backward), {layers} a micro-step, and nothing else may launch")
    losses = [h["train/loss_ce"] for h in trainer.history]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"VALL-E NAR loss_ce: mean of the first 10 micro-steps {first:.4f}, of the last 10 {last:.4f} (limit: at "
          f"most 0.9 x the first)", flush=True)
    check(last <= 0.9 * first, "the NAR loss did not fall by 10%")

    # resume from the interval checkpoint and replay the last two micro-steps
    model_params = dict(trainer.config["model_params"])
    dtype = tts_train.DTYPES[model_params.pop("dtype")]
    model2 = VALLENAR(**model_params, device="cuda", dtype=dtype)
    resumed = Trainer(trainer.config, model2, trainer.criterions, trainer.loss_fn, loader, outdir=outdir + "_resumed",
                      seed=seed)
    resumed.init_state()
    resumed.load_checkpoint(str(Path(outdir) / f"checkpoint-{NAR_RESUME}steps"))
    levels.clear()
    VALLENAR.forward = drawn_fwd
    try:
        replay = [resumed.train_step(kept[s]) for s in range(NAR_RESUME, NAR_STEPS)]
    finally:
        VALLENAR.forward = real_fwd
    same_levels = levels == run_levels[NAR_RESUME:NAR_STEPS]
    same_stats = replay == trainer.history[NAR_RESUME:]
    same = all(torch.equal(model2.state_dict()[k], v) for k, v in trainer.model.state_dict().items())
    print(f"VALL-E NAR resume from checkpoint-{NAR_RESUME}steps, micro-steps {NAR_RESUME}-{NAR_STEPS - 1} replayed: "
          f"levels drawn {levels} (the run's {run_levels[NAR_RESUME:NAR_STEPS]}), stats bitwise equal {same_stats}, "
          f"parameters bitwise equal {same}", flush=True)
    check(same_levels and same_stats and same, "the resumed NAR trainer differs")
    del resumed, model2

    # one micro-step at the largest batch, its parts and a profile
    model, params = trainer.model, trainer.params
    big = max(loader.sampler.batches, key=lambda idx: sum(loader.dataset.get_frame_len(i) for i in idx))
    tb = trainer.to_device(loader._make(big))
    s_len = tb["text"].shape[1] + tb["proms"].shape[1] + tb["resps"].shape[1] + 2
    shape = (tb["text"].shape[0], s_len)
    fixed = torch.arange(shape[0], device="cuda") % model.n_resp_levels  # every level, the same in every call

    def host_ms(fn, iters=3):
        return time_ms(fn, iters=iters, warmup=1, host_clock=True)

    def loss_of(m, b=tb):
        return m(**valle_kwargs(b, m), quant_levels=fixed[:b["text"].shape[0]])["loss"]

    model.train()
    fwd_ms = host_ms(lambda: loss_of(model))
    loss = loss_of(model)
    bwd_ms = host_ms(lambda: torch.autograd.grad(loss, params, retain_graph=True))
    del loss
    micro_ms = host_ms(lambda: torch.autograd.grad(loss_of(model), params))
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(loss_of(model), params)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    wall_ms, busy_ms, events = profile_ms(lambda: torch.autograd.grad(loss_of(model), params))
    names = ("flash_attn_fwd_tc_kernel", "flash_attn_bwd_dkv_tc_kernel", "flash_attn_bwd_dq_tc_kernel",
             "flash_attn_bwd_dkv_kernel", "flash_attn_bwd_dq_kernel")
    k_ms = {nm: sum(e.self_device_time_total for e in events if nm in e.key) / 1e3 for nm in names}
    attn_ms = sum(k_ms.values())
    print(f"VALL-E NAR micro-step bf16 (forward, loss, backward; the optimizer aside), batch {shape} (B, S packed): "
          f"{micro_ms:.1f} ms (host clock, peak memory {peak_gb:.1f} GiB); forward+loss {fwd_ms:.1f} ms, backward "
          f"{bwd_ms:.1f} ms; {where}", flush=True)
    print(f"profile of one NAR micro-step: wall {wall_ms:.1f} ms under the profiler, device busy {busy_ms:.1f} ms in "
          f"{sum(e.count for e in events)} kernels, idle share {1 - busy_ms / wall_ms:.3f}; attention: forward "
          f"{k_ms[names[0]]:.2f} ms, dk/dv {k_ms[names[1]]:.2f} ms, dq {k_ms[names[2]]:.2f} ms (tensor cores, "
          f"{layers} launches each; the scalar dk/dv {k_ms[names[3]]:.2f} ms, dq {k_ms[names[4]]:.2f} ms) = "
          f"{attn_ms / busy_ms:.3f} of the device time", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    check(k_ms[names[1]] > 0 and k_ms[names[2]] > 0 and k_ms[names[3]] == 0 and k_ms[names[4]] == 0,
          "the profiled NAR micro-step did not run its backward on the tensor-core kernels")

    # the same step under attn_backend xla, dropout 0, the same levels: bf16
    # as trained (loose bound: the two round to bf16 at other places), then
    # f32 on 4 rows (tight)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    small = {k: v[:4] for k, v in tb.items()}

    def step_pair(dt, batch, tol_loss, tol_grad):
        pair = {}
        for backend in ("flash", "xla"):
            m = VALLENAR(**{**model_params, "attn_backend": backend}, device="cuda", dtype=dt)
            m.load_state_dict(state)
            set_dropout_rate(m, 0.0)
            m.train()
            reset_all_launches()
            lss = loss_of(m, batch)
            g = torch.autograd.grad(lss, list(m.parameters()))
            counts_now = launch_counts()
            got = tuple(counts_now[f"k1.launches{k}"] for k in ("", "_bwd_dkv", "_bwd_dq"))
            check(got == ((layers,) * 3 if backend == "flash" else (0, 0, 0)),
                  f"NAR {backend} step: launches (forward, dk/dv, dq) {got}")
            pair[backend] = (float(lss.detach()), g)
            del m
        (lf, gf), (lx, gx) = pair["flash"], pair["xla"]
        loss_rel = abs(lf - lx) / abs(lx)
        diff = math.sqrt(sum(float((a - b).double().pow(2).sum()) for a, b in zip(gf, gx)))
        norm = math.sqrt(sum(float(b.double().pow(2).sum()) for b in gx))
        name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dt]
        print(f"VALL-E NAR flash vs xla, {name}, batch {tuple(batch['text'].shape[:1]) + (s_len,)}, dropout 0, levels "
              f"{fixed[:batch['text'].shape[0]].tolist()}: loss {lf:.6f} vs {lx:.6f} (rel diff {loss_rel:.2e}, tol "
              f"{tol_loss:.0e}), gradients |g_flash - g_xla| / |g_xla| {diff / norm:.2e} (tol {tol_grad:.0e})",
              flush=True)
        check(loss_rel <= tol_loss and diff / norm <= tol_grad, f"NAR flash and xla steps disagree ({name})")
        return diff / norm

    rel_bf16 = step_pair(dtype, tb, 1e-2, 5e-2)
    rel_f32 = step_pair(torch.float32, small, 1e-4, 1e-3)
    return trainer, counts, {"run_s": run_s, "micro_ms": micro_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                             "peak_gb": peak_gb, "idle": 1 - busy_ms / wall_ms, "busy_ms": busy_ms,
                             "wall_ms": wall_ms, "k_ms": k_ms, "attn_share": attn_ms / busy_ms, "shape": shape,
                             "loss": (first, last), "rel_bf16": rel_bf16, "rel_f32": rel_f32}


def nar_decode(root, corpus, ar_outdir, nar_outdir, seed, where):
    """Phase 18, decode: ``bin/ttslm_decode.py`` on 4 dev rows (each its own
    codes as the prompt) with phase 12's trained AR and this phase's NAR
    (bf16 parameters, ``--max-steps`` NAR_DECODE_STEPS); the codes [T, 8]
    in the codebook, level 0 the AR's output (for row 0 also against
    ``ar_generate`` called directly with the CLI's generator), every row's
    fill against ``nar_generate`` called directly with the CLI's generator
    on the CLI's padded inputs."""
    import numpy as np
    import torch

    from jatts_torch.bin import ttslm_decode
    from jatts_torch.data.batcher import round_up
    from jatts_torch.data.token_id_converter import TokenIDConverter
    from jatts_torch.models.valle import VALLEAR, VALLENAR, ar_generate, nar_generate
    from jatts_torch.utils.config import load_config
    from jatts_torch.utils.io import read_csv, write_csv

    _, dev_csv, _, tokens = corpus
    rows = read_csv(dev_csv, dict_reader=True)[0][:4]
    csv = str(Path(root) / "decode_nar.csv")
    write_csv([{**r, "prompt_feat_path": r["feat_path"]} for r in rows], csv)
    outdir = str(Path(root) / "decode_nar")
    cfg = {name: str(Path(d) / "config.yml") for name, d in (("ar", ar_outdir), ("nar", nar_outdir))}
    argv = ["--csv", csv, "--token-list", tokens, "--ar-expdir", ar_outdir, "--ar-config", cfg["ar"],
            "--nar-expdir", nar_outdir, "--nar-config", cfg["nar"], "--outdir", outdir,
            "--max-steps", str(NAR_DECODE_STEPS), "--device", "cuda", "--verbose", "0"]
    t0 = time.perf_counter()
    out = ttslm_decode.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = out["rows"]
    check(len(got) == len(rows), f"the decode CLI wrote {len(got)} of {len(rows)} rows")
    with open(tokens, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    ar = ttslm_decode.load_model(VALLEAR, load_config(cfg["ar"]), n_vocab, torch.bfloat16, None, ar_outdir, "cuda")
    nar = ttslm_decode.load_model(VALLENAR, load_config(cfg["nar"]), n_vocab, torch.bfloat16, None, nar_outdir,
                                  "cuda")
    conv = TokenIDConverter(tokens)
    tp_cap = ar.prompt_max_frame_length
    differ = 0
    for i, (row, res) in enumerate(zip(rows, got)):
        codes = np.load(str(Path(outdir) / "codes" / f"{row['sample_id']}.npy"))
        check(codes.shape == (res["n_gen"], 8) and codes.dtype == np.int32, f"codes {codes.shape} {codes.dtype}")
        check(int(codes.min()) >= 0 and int(codes.max()) < nar.n_tokens, "a decoded code out of the codebook")
        # the CLI's padded inputs, built here again
        ids = conv.tokens2ids(row["phonemes"].split(" "))
        prom = np.load(row["feat_path"])["encodec"][:tp_cap]
        xs = torch.zeros(1, round_up(len(ids), 16), dtype=torch.long, device="cuda")
        xs[0, :len(ids)] = torch.tensor(ids, device="cuda")
        proms = torch.zeros(1, tp_cap, 8, dtype=torch.long, device="cuda")
        proms[0, :len(prom)] = torch.from_numpy(prom).cuda()
        args = (xs, torch.tensor([len(ids)], device="cuda"), proms, torch.tensor([len(prom)], device="cuda"))
        level0 = torch.from_numpy(res["level0"]).cuda()[None]
        check(np.array_equal(codes[:, 0], res["level0"][:res["n_gen"]]), f"row {i}: level 0 is not the AR's output")
        if i == 0:
            direct = ar_generate(ar, *args, max_steps=NAR_DECODE_STEPS,
                                 generator=torch.Generator(device="cuda").manual_seed(i))
            check(torch.equal(direct["codes"], level0), "row 0: the CLI's AR output differs from ar_generate's")
        fill = nar_generate(nar, *args, level0, torch.tensor([res["n_gen"]], device="cuda"),
                            generator=torch.Generator(device="cuda").manual_seed(1000 + i))
        differ += int((fill[0, :res["n_gen"]].cpu().numpy() != codes).sum())
    n_codes = sum(r["n_gen"] for r in got) * 8
    ar_s, nar_s = sum(r["ar_s"] for r in got), sum(r["nar_s"] for r in got)
    level_ms = nar_s / len(got) / nar.n_resp_levels * 1e3
    step_ms = ar_s / len(got) / (NAR_DECODE_STEPS - 1) * 1e3
    print(f"VALL-E decode CLI (bin/ttslm_decode.py, bf16 parameters) on {len(got)} dev rows, --max-steps "
          f"{NAR_DECODE_STEPS}: frames {[r['n_gen'] for r in got]}; AR {step_ms:.2f} ms a step, NAR {level_ms:.2f} ms "
          f"a level (7 levels a row at the full capacity), {n_codes} codes in {ar_s + nar_s:.2f} s = "
          f"{n_codes / (ar_s + nar_s):.0f} codes/s (the CLI's wall {wall_s:.1f} s with loading); codes [T, 8] in "
          f"[0, {nar.n_tokens}); level 0 the AR's output; the fill against nar_generate called directly: {differ} of "
          f"{n_codes} codes differ (limit 0); {where}", flush=True)
    check(differ == 0, "the decode CLI's NAR fill differs from nar_generate's")
    return {"step_ms": step_ms, "level_ms": level_ms, "codes_s": n_codes / (ar_s + nar_s), "rows": len(got),
            "frames": [r["n_gen"] for r in got]}


def nar_slice(root, corpus, ar_outdir, seed, where):
    """Phase 18: the VALL-E NAR's training on phase 12's corpus, its
    attention kernels against their plain versions at its own largest
    shape and on ragged forms, their times, then the tts3 decode CLI with
    phase 12's AR. Returns the training launches and the numbers the record
    and PERF.md need."""
    t_phase = time.perf_counter()
    outdir = str(Path(root) / "exp_valle_nar")
    trainer, counts, train = nar_training(corpus, outdir, seed, where)
    b, s = train["shape"]
    h = trainer.model.n_heads
    del trainer
    errs = {"dkv": 0.0, "dq": 0.0, "scalar": 0.0}
    for i, (name, shape, rows) in enumerate(nar_cases(b, h, s)):
        e, scalar_err = check_nar_bwd(name, shape, rows, seed + 60 + i)
        errs["dkv"] = max(errs["dkv"], e["dk"], e["dv"])
        errs["dq"], errs["scalar"] = max(errs["dq"], e["dq"]), max(errs["scalar"], scalar_err)
    chain = check_nar_chain((b, h, s, s, 64), nar_cases(b, h, s)[0][2], seed + 70)
    errs["fwd"] = chain["fwd"]
    errs["dkv"] = max(errs["dkv"], chain["dk"], chain["dv"])
    errs["dq"] = max(errs["dq"], chain["dq"])
    times = time_nar_attn((b, h, s, 64), seed + 80, where)
    decode = nar_decode(root, corpus, ar_outdir, outdir, seed, where)
    print(f"phase 18 (VALL-E NAR training, kernels, decode): {time.perf_counter() - t_phase:.1f} s; {where}",
          flush=True)
    return counts, {"train": train, "errs": errs, "times": times, "decode": decode}


# ---------------------------------------------------------------------------
# phase 19: E2-TTS (the tts2 features, CFG infill serving, frame-budget
# training on the bf16 tensor-core forward and non-causal backward, the
# stage-4 decode CLI)
# ---------------------------------------------------------------------------

E2_CONF = ROOT / "egs" / "hificaptain_jp_female" / "tts2" / "conf" / "e2tts.v1.yaml"
E2_STEPS = 100  # the conf's train_max_steps is 1000000 (200 before phase 21 needed the run's time)
E2_WARMUP = 25  # the conf's warmup_steps is 20000 (50 at 200 micro-steps)
E2_RESUME = 98  # an interval checkpoint at an accumulation boundary: micro-steps 98 and 99 are replayed
E2_BUCKETS = (64, 128, 256)  # the serving bundle's text buckets
E2_SERVE_BATCH = 4
E2_REQUESTS = 8
E2_DECODE_ROWS = 4
E2_FRAMES_PER_PHONE = 12  # bin/e2tts_decode.py's --frames-per-phone


def write_e2_corpus(root, conf, seed, n_utts=64, n_phones=40):
    """Tones as write_tone_corpus makes them, at the E2 conf's feature
    settings (48 kHz, hop 512, fft 2048, 80 mels from 0 Hz): each phone the
    centre of every second mel filter, 4-12 frames a phone, 3-12 s an
    utterance with 60 ms of silence at both ends; start and end in the csv
    (the frame counts the frame-budget batcher sorts by); each row's prompt
    is the next utterance's wav and phonemes. Returns (csv paths, {utt:
    (phones, frames per phone)})."""
    import numpy as np

    from jatts_torch.ops.dsp import mel_filterbank
    from jatts_torch.utils.io import write_audio, write_csv

    sr, hop, n_fft = (int(conf[k]) for k in ("sampling_rate", "hop_size", "fft_size"))
    fmin = float(conf.get("fmin") or 0.0)
    fmax = float(conf.get("fmax") or sr / 2)
    bank = mel_filterbank(sr, n_fft, conf["num_mels"], fmin, fmax)
    centres = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)[bank.argmax(axis=1)]
    rng = np.random.default_rng(seed)
    phones = [f"p{i:02d}" for i in range(n_phones)]
    freqs = dict(zip(phones, centres[1::2]))
    sil = np.zeros(int(0.06 * sr), np.float32)
    utts, truth = [], {}
    for i in range(n_utts):
        utt = f"E{i:03d}"
        target = rng.uniform(3.0, 12.0) * sr - 2 * len(sil)
        ph, durs = [], []
        while sum(durs) * hop < target:
            ph.append(str(rng.choice(phones)))
            durs.append(int(rng.integers(4, 13)))
        wav = np.concatenate([sil] + [
            0.4 * np.sin(2 * np.pi * freqs[p] * np.arange(d * hop) / sr).astype(np.float32) for p, d in zip(ph, durs)
        ] + [sil])
        wav_path = str(Path(root) / "wav" / f"{utt}.wav")
        write_audio(wav_path, wav, sr)
        utts.append((utt, wav_path, len(wav) / sr, " ".join(ph)))
        truth[utt] = (ph, durs)
    rows = [{"sample_id": utt, "spk": "syn", "wav_path": path, "start": "0.0", "end": f"{secs:.6f}",
             "original_text": "x", "phonemes": ph, "prompt_wav_path": utts[(i + 1) % n_utts][1],
             "prompt_phonemes": utts[(i + 1) % n_utts][3]}
            for i, (utt, path, secs, ph) in enumerate(utts)]
    n_dev = n_utts // 8
    paths = [str(Path(root) / "train_src.csv"), str(Path(root) / "dev_src.csv")]
    write_csv(rows[n_dev:], paths[0])
    write_csv(rows[:n_dev], paths[1])
    return paths, truth


def e2_features(root, seed, where):
    """Phase 19, stages 1, 1b and 2 through the port's CLIs at the E2 conf's
    feature settings: mel-only .npz dumps on the card, the mel statistics,
    the token list. Returns (train csv, dev csv, stats, tokens), the conf and
    the corpus's phones and durations."""
    import numpy as np
    import torch

    from jatts_torch.bin import compute_statistics, generate_token_list, preprocess
    from jatts_torch.utils.config import load_config
    from jatts_torch.utils.io import read_csv

    conf = load_config(str(E2_CONF))
    src, truth = write_e2_corpus(root, conf, seed)
    csvs = [str(Path(root) / "train.csv"), str(Path(root) / "dev.csv")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio_s = sum(preprocess.run(s_, conf, str(Path(root) / "dump"), out_csv=c, device="cuda", dump_format="npz")
                  for s_, c in zip(src, csvs))
    torch.cuda.synchronize()
    stage1_s = time.perf_counter() - t0
    stats = str(Path(root) / "stats.npz")
    compute_statistics.run(csvs[0], conf, stats)
    tokens = str(Path(root) / "tokens.txt")
    vocab = generate_token_list.run(csvs, tokens)
    rows = read_csv(csvs[0], dict_reader=True)[0] + read_csv(csvs[1], dict_reader=True)[0]
    frames = []
    for row in rows:
        with np.load(row["feat_path"]) as f:
            check(sorted(f.files) == ["mel", "wave"] and f["mel"].shape[1] == conf["num_mels"], f"E2 dump {f.files}")
            n_truth = sum(truth[row["sample_id"]][1])
            check(abs(f["mel"].shape[0] - n_truth - 0.12 * conf["sampling_rate"] / conf["hop_size"]) <= 2,
                  f"{row['sample_id']}: {f['mel'].shape[0]} frames for {n_truth} frames of tones")
            frames.append(f["mel"].shape[0])
    with np.load(stats) as st:
        check(sorted(st.files) == ["mel_mean", "mel_scale"] and st["mel_mean"].shape == (80,), f"stats {st.files}")
    check(len(vocab) == 43 and "<blank>" in vocab, f"{len(vocab)} tokens, want 40 phones + 3 with <blank>")
    print(f"E2-TTS stages 1, 1b, 2 ({E2_CONF.relative_to(ROOT)} features: {conf['sampling_rate']} Hz, fft "
          f"{conf['fft_size']}, hop {conf['hop_size']}, {conf['num_mels']} mels, mel only, .npz on the card): "
          f"{len(rows)} utterances, {audio_s:.1f} s of audio, {min(frames)}-{max(frames)} frames, stage 1 "
          f"{stage1_s:.2f} s; {len(vocab)} tokens; {where}", flush=True)
    return (csvs[0], csvs[1], stats, tokens), conf, truth


def e2_model(conf, n_vocab, seed, backend="flash", dtype_name=None):
    """E2TTS at the conf's width with weights made from ``seed`` (flax's
    default initialisers, as the trainer starts from them)."""
    import torch

    from jatts_torch.bin.tts_train import DTYPES
    from jatts_torch.models.e2tts import E2TTS

    mp = dict(conf["model_params"])
    dtype = DTYPES[dtype_name or mp.pop("dtype")]
    mp.pop("dtype", None)
    torch.manual_seed(seed)
    return E2TTS(**mp, idim=n_vocab, attn_backend=backend, device="cuda", dtype=dtype)


def e2_fwd_bound_ms(b, h, tq, d, valid, with_lse=False):
    """Least time of the bf16 non-causal forward whose key rows hold
    ``valid`` [B] valid keys (the kernel skips a key tile with none, so the
    products count the valid keys): 4·H·Tq·d·Σvalid FLOP on the bf16 tensor
    cores; bytes q and o, k and v of the valid keys, the key mask (and the
    lse)."""
    n_valid = sum(valid)
    nbytes = 2 * (2 * b * h * tq * d) + 2 * (2 * h * n_valid * d) + b * tq + (b * h * tq * 4 if with_lse else 0)
    flops = 4 * h * tq * d * n_valid
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops_ms(flops, "bf16")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, flops


def time_e2_fwd(name, b, valid, tq, seed, where):
    """E2's served forward (no lse) at [B, 16, Tq, 64] with ``valid`` keys a
    row: the tensor-core kernel held per item against the plain version
    (TOL["bf16"] of the item's max(1, max|plain|)), timed by CUDA events and
    by graph replay beside the plain version, SDPA with the boolean key
    mask (the yardstick, never used by the port) and the bound."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, d = 16, 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, tq, d, device="cuda", generator=g).bfloat16() for _ in range(3))
    key_mask = torch.arange(tq, device="cuda")[None] < torch.tensor(valid, device="cuda")[:, None]
    scale = d ** -0.5

    def fwd():
        with torch.no_grad():
            return k1.flash_attention(q, k, v, None, key_mask, scale)

    before = launch_counts()
    got = fwd()
    torch.cuda.synchronize()
    ran = launches_since(before)
    check(ran == {"k1.launches": 1, "k1.launches_tc": 1}, f"E2 forward {name}: launches {ran}")
    want = k1.flash_attention_ref(q, k, v, None, key_mask, scale)
    err, rel = (got.float() - want.float()).abs().max().item(), item_err(got, want)
    check(rel <= TOL["bf16"], f"E2 forward {name}: err {rel} x max(1, max|plain| of its item) > {TOL['bf16']}")
    mask = key_mask[:, None, None, :]
    res = {"shape": [b, h, tq, d], "valid": list(valid), "max_abs_err": err, "ms": time_ms(fwd, iters=10),
           "graph_ms": graph_ms(fwd, iters=10, replays=3),
           "plain_ms": time_ms(lambda: k1.flash_attention_ref(q, k, v, None, key_mask, scale), iters=2, warmup=1),
           "library_backend": sdpa_choice(q, k, v, attn_mask=mask, scale=scale),
           "library_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), iters=10),
           "bound": e2_fwd_bound_ms(b, h, tq, d, valid)}
    bd = res["bound"]
    print(f"E2 forward {name} bf16 non-causal B,H,T,d={b},{h},{tq},{d}, valid keys {valid}: max_abs_err {err:.2e} "
          f"({rel:.2e} of the item's max(1, max|plain|), tol {TOL['bf16']:.0e}); kernel {res['ms']:.4f} ms (graph "
          f"replay {res['graph_ms']:.4f} ms) (bound {bd[0]:.4f} ms by {bd[1]}: {bd[2] / 1e6:.1f} MB, "
          f"{bd[3] / 1e9:.1f} GFLOP); plain {res['plain_ms']:.2f} ms; sdpa (bool key mask, "
          f"{res['library_backend']}) {res['library_ms']:.4f} ms; {where}", flush=True)
    return res


def e2_step_profile(model, cond, text, ref_lens, duration, kw, name, where):
    """One ODE step of ``E2TTS.inference`` (``steps`` 1, with the text
    embedding and the noise) under the profiler: its wall and device-busy
    ms and kernel count, the share the host holds the card idle."""
    import torch

    args = dict(kw, steps=1)
    wall_ms, busy_ms, events = profile_ms(lambda: model.inference(
        cond, text, ref_lens, duration, generator=torch.Generator(device="cuda").manual_seed(0), **args))
    n = sum(e.count for e in events)
    print(f"profile of {name} first ODE step (B={cond.shape[0]}, CFG doubles it): wall {wall_ms:.1f} ms under the "
          f"profiler, device busy {busy_ms:.1f} ms in {n} kernels, idle share {1 - busy_ms / wall_ms:.3f}; {where}",
          flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": n, "idle": 1 - busy_ms / wall_ms}


def e2_serving(corpus, conf, truth, seed, where):
    """Phase 19, serving: E2ttsServingBundle at the conf's width (bf16,
    flash, seed-made weights, ``nfe_step`` 32, CFG 2, sway -1, capacity
    ``max_duration`` frames, batch 4, text buckets 64/128/256) behind
    BatchingServer; 8 requests of a 200-400-frame prompt cut at a phone
    boundary from another utterance's dump and 20-80 target phones,
    ``gen_frames`` 12 a phone. Launch counts set to 0 just before and read
    just after; every served mel against ``E2TTS.inference`` on the bundle's
    inputs and a generator of the same seed, bit for bit; another seed,
    another mel."""
    import numpy as np
    import torch

    from jatts_torch.data.token_id_converter import TokenIDConverter
    from jatts_torch.serving import BatchingServer, E2ttsServingBundle
    from jatts_torch.serving.bundle import inference_kwargs
    from jatts_torch.utils.io import read_csv

    train_csv, dev_csv, stats, tokens = corpus
    conv = TokenIDConverter(tokens)
    with np.load(stats) as st:
        mean, scale = st["mel_mean"], st["mel_scale"]
    model = e2_model(conf, len(conv.token_list), seed).eval()
    kw = inference_kwargs(conf)
    max_frames = int(conf["max_duration"])
    bundle = E2ttsServingBundle(model, mean, scale, batch_size=E2_SERVE_BATCH, buckets=E2_BUCKETS,
                                max_frames=max_frames, infer_kwargs=kw)
    rows = read_csv(train_csv, dict_reader=True)[0]
    rng = np.random.default_rng(seed + 19)
    sil = round(0.06 * conf["sampling_rate"] / conf["hop_size"])
    reqs = []
    for j in range(E2_REQUESTS):
        prom_row, tgt_row = rows[2 * j], rows[2 * j + 1]
        ph, durs = truth[prom_row["sample_id"]]
        cut = int(np.searchsorted(np.cumsum(durs), int(rng.integers(200, 401)) - sil, side="right"))
        with np.load(prom_row["feat_path"]) as f:
            prompt = f["mel"][: sil + sum(durs[:cut])]
        target = tgt_row["phonemes"].split(" ")[: int(rng.integers(20, 81))]
        ids = conv.tokens2ids(ph[:cut] + ["<blank>"] + target)
        reqs.append({"token_ids": ids, "prompt_mels": prompt, "gen_frames": E2_FRAMES_PER_PHONE * len(target)})
    check(all(200 <= len(r["prompt_mels"]) <= 400 for r in reqs), "an E2 prompt outside 200-400 frames")
    reset_all_launches()
    t0 = time.perf_counter()
    with BatchingServer(bundle, max_delay_ms=50) as server:
        futs = [server.submit(seed=seed, **r) for r in reqs]
        served = [f.result(timeout=600) for f in futs]
        batches = server.stats["batches"]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    n_tc = model.backbone.depth * kw["steps"] * batches
    check(batches == E2_REQUESTS // E2_SERVE_BATCH, f"E2 server ran {batches} batches")
    check(all(counts[c] == (n_tc if c in ("k1.launches", "k1.launches_tc") else 0) for c in counts),
          f"E2 serving launches {counts}: want {n_tc} on the tensor-core forward and nothing else")
    for r, mel in zip(reqs, served):
        check(mel.shape == (r["gen_frames"], 80) and bool(np.isfinite(mel).all()), f"E2 served mel {mel.shape}")
    # each served batch again through E2TTS.inference on the bundle's inputs
    batch_ms, differ = [], 0
    for k in range(batches):
        part = reqs[k * E2_SERVE_BATCH:(k + 1) * E2_SERVE_BATCH]
        cond, text, ref_lens, duration = bundle.prepare(*[[r[f] for r in part] for f in
                                                          ("token_ids", "prompt_mels", "gen_frames")])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = model.inference((cond - bundle.mel_mean) / bundle.mel_scale, text, ref_lens, duration,
                              generator=torch.Generator(device="cuda").manual_seed(seed), **kw)["feat_gen"]
        mel = out.float() * bundle.mel_scale + bundle.mel_mean
        host = mel.cpu().numpy()
        batch_ms.append((time.perf_counter() - t1) * 1e3)
        for i, r in enumerate(part):
            got = served[k * E2_SERVE_BATCH + i]
            differ += int((host[i, int(ref_lens[i]):int(duration[i])] != got).sum())
        durations = (duration + 1).tolist()  # the time token, then the frames: the keys each row sees
    step_prof = e2_step_profile(model, (cond - bundle.mel_mean) / bundle.mel_scale, text, ref_lens, duration, kw,
                                "a served batch's", where)
    other = bundle.synthesize(*[[r[f] for r in reqs[:E2_SERVE_BATCH]] for f in
                                ("token_ids", "prompt_mels", "gen_frames")], seed=seed + 1)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(other, served))
    buckets = sorted({min(b for b in E2_BUCKETS if b >= len(r["token_ids"])) for r in reqs})
    print(f"E2-TTS serving ({E2_CONF.relative_to(ROOT)}: dim {conf['model_params']['dim']}, depth "
          f"{model.backbone.depth}, bf16, flash, seed-made weights; nfe_step {kw['steps']}, cfg {kw['cfg_strength']}, "
          f"sway {kw['sway_sampling_coef']}; capacity {max_frames} frames): {E2_REQUESTS} requests through "
          f"BatchingServer in {batches} batches of {E2_SERVE_BATCH} (text buckets used {buckets}), prompts "
          f"{[len(r['prompt_mels']) for r in reqs]} frames, gen_frames {[r['gen_frames'] for r in reqs]}; wall "
          f"{wall_s:.2f} s; launches: forward {counts['k1.launches']} (tensor cores {counts['k1.launches_tc']}), "
          f"limit {model.backbone.depth} x {kw['steps']} = {model.backbone.depth * kw['steps']} a batch, every other "
          f"counter 0; a served batch through E2TTS.inference again: {', '.join(f'{m:.1f}' for m in batch_ms)} ms "
          f"(host clock, to the fetch), {differ} values differ from the served mels (limit 0); seed {seed + 1} moves "
          f"the mel by up to {moved:.3f} (limit > 1e-3); {where}", flush=True)
    check(differ == 0, "the served E2 mels differ from E2TTS.inference on the same generator")
    check(moved > 1e-3, "another seed gave the same E2 mel")
    fwd = time_e2_fwd("served batch", 2 * E2_SERVE_BATCH, durations * 2, max_frames + 1, seed + 91, where)
    del bundle, model
    torch.cuda.empty_cache()
    return counts["k1.launches_tc"], {"batch_ms": batch_ms, "wall_s": wall_s, "fwd": fwd, "batches": batches,
                                      "step": step_prof}


def e2_training(corpus, conf, outdir, seed, where):
    """Phase 19, training: ``bin/tts_train.py:run`` on the E2 conf as it
    stands (dim 1024, depth 24, 16 heads of d 64, bf16, frame budget 8640 x
    max_samples 32, accumulation 4, AdamW, e2tts_sequentiallr, EMA, clip 1)
    with ``attn_backend: flash`` on phase 19's corpus, launch counts set to 0
    just before and read just after; the falling loss; micro-steps 98-99
    replayed bitwise from checkpoint-98steps with the same draws; a
    micro-step's time and a profiled one; the same step under ``xla`` (bf16
    at the largest batch, then f32 on 2 rows); the kernels per item against
    their plain versions at the largest batch and their times."""
    import numpy as np
    import torch

    from jatts_torch.bin import tts_train
    from jatts_torch.models.e2tts import E2TTS
    from jatts_torch.modules.dropout import set_dropout_rate
    from jatts_torch.modules.noise import set_noise_generator
    from jatts_torch.train.steps_e2tts import e2tts_kwargs
    from jatts_torch.train.trainer import Trainer

    config = dict(conf)
    mp = config["model_params"]
    cuts = [f"train_max_steps {config['train_max_steps']} -> {E2_STEPS}",
            f"warmup_steps {config['scheduler_params']['warmup_steps']} -> {E2_WARMUP}",
            f"save_interval_steps {config['save_interval_steps']} -> {E2_RESUME}"]
    print(f"E2-TTS config {E2_CONF.relative_to(ROOT)} (dim {mp['dim']}, depth {mp['depth']}, {mp['heads']} heads, "
          f"ff_mult {mp['ff_mult']}, dtype {mp['dtype']}, frame budget {config['batch_size_per_gpu']} x max_samples "
          f"{config['max_samples']}, accumulation {config['gradient_accumulate_steps']}, {config['optimizer_type']}, "
          f"{config['scheduler']}, ema {config['ema_decay']}) with attn_backend flash; reductions: {', '.join(cuts)}; "
          f"phase 19's 64-utterance synthetic 48 kHz corpus", flush=True)
    config.update(train_max_steps=E2_STEPS, save_interval_steps=E2_RESUME)
    config["scheduler_params"] = {**config["scheduler_params"], "warmup_steps": E2_WARMUP}

    real_step = Trainer.train_step
    kept = {}

    def keep_step(self, batch):
        if self.steps >= E2_RESUME:
            kept[self.steps] = batch
        return real_step(self, batch)

    # deterministic cuDNN (the position convolutions) for the run and the replay
    torch.backends.cudnn.deterministic = True
    Trainer.train_step = keep_step
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        trainer = tts_train.run(*corpus, config, outdir, seed=seed, device="cuda", attn_backend="flash")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        Trainer.train_step = real_step
    depth = trainer.model.backbone.depth
    loader = trainer.train_loader
    n = depth * E2_STEPS
    want = {"k1.launches": n, "k1.launches_tc": n, "k1.launches_bwd_dkv": n, "k1.launches_bwd_dq": n,
            "k1.launches_bwd_dkv_tc_noncausal": n, "k1.launches_bwd_dq_tc_noncausal": n}
    sizes = [len(b) for b in loader.sampler.batches]
    frames = [sum(loader.dataset.get_frame_len(i) for i in b) for b in loader.sampler.batches]
    n_params = sum(p.numel() for p in trainer.params)
    print(f"E2-TTS training ({n_params:,} parameters, f32): {len(loader.dataset)} utterances in "
          f"{len(loader.sampler)} frame-budget batches "
          f"(utterances {sizes}, frames {frames}; dropped {loader.sampler.n_dropped}), {trainer.steps} micro-steps "
          f"({trainer.updates} updates) in {run_s:.1f} s; launches: forward {counts['k1.launches']} (tensor cores "
          f"{counts['k1.launches_tc']}), dk/dv {counts['k1.launches_bwd_dkv']} (non-causal tensor cores "
          f"{counts['k1.launches_bwd_dkv_tc_noncausal']}), dq {counts['k1.launches_bwd_dq']} (non-causal tensor cores "
          f"{counts['k1.launches_bwd_dq_tc_noncausal']}); limit {depth} a micro-step each = {n}, every other counter "
          f"0", flush=True)
    check(trainer.steps == E2_STEPS, f"trained {trainer.steps} E2 micro-steps")
    check(all(math.isfinite(v) for h in trainer.history for v in h.values()), "an E2 training stat is not finite")
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"E2 training launches {counts}: every forward, dk/dv and dq must take the tensor-core kernels (the "
          f"non-causal backward), {depth} a micro-step, and nothing else may launch")
    losses = [h["train/cfm_loss"] for h in trainer.history]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    print(f"E2-TTS cfm_loss: mean of the first 20 micro-steps {first:.4f}, of the last 20 {last:.4f} (limit: at most "
          f"0.9 x the first)", flush=True)
    check(last <= 0.9 * first, "the E2 loss did not fall by 10%")

    # resume from the interval checkpoint and replay the last two micro-steps
    model_params = dict(trainer.config["model_params"])
    dtype = tts_train.DTYPES[model_params.pop("dtype")]
    model2 = E2TTS(**model_params, device="cuda", dtype=dtype)
    resumed = Trainer(trainer.config, model2, trainer.criterions, trainer.loss_fn, loader, outdir=outdir + "_resumed",
                      seed=seed)
    resumed.init_state()
    resumed.load_checkpoint(str(Path(outdir) / f"checkpoint-{E2_RESUME}steps"))
    replay = [resumed.train_step(kept[s]) for s in range(E2_RESUME, E2_STEPS)]
    torch.backends.cudnn.deterministic = False
    same_stats = replay == trainer.history[E2_RESUME:]
    same = all(torch.equal(model2.state_dict()[k], v) for k, v in trainer.model.state_dict().items())
    same_ema = all(torch.equal(a, b) for a, b in zip(resumed.ema, trainer.ema))
    print(f"E2-TTS resume from checkpoint-{E2_RESUME}steps, micro-steps {E2_RESUME}-{E2_STEPS - 1} replayed with the "
          f"same draws: stats bitwise equal {same_stats}, parameters bitwise equal {same}, EMA bitwise equal "
          f"{same_ema}", flush=True)
    check(same_stats and same and same_ema, "the resumed E2 trainer differs")
    del resumed, model2
    torch.cuda.empty_cache()

    # one micro-step at the largest batch, its parts and a profile
    model, params = trainer.model, trainer.params
    big = max(loader.sampler.batches, key=lambda idx: sum(loader.dataset.get_frame_len(i) for i in idx))
    tb = trainer.to_device(loader._make(big))
    b, s_len = tb["ys"].shape[0], tb["ys"].shape[1] + 1

    def host_ms(fn, iters=3):
        return time_ms(fn, iters=iters, warmup=1, host_clock=True)

    def loss_of(m, bt=tb, draw_seed=7):
        set_noise_generator(m, torch.Generator(device="cuda").manual_seed(draw_seed))
        return m(**e2tts_kwargs(bt, m))["loss"]

    model.train()
    fwd_ms = host_ms(lambda: loss_of(model))
    loss = loss_of(model)
    bwd_ms = host_ms(lambda: torch.autograd.grad(loss, params, retain_graph=True))
    del loss
    micro_ms = host_ms(lambda: torch.autograd.grad(loss_of(model), params))
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(loss_of(model), params)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    wall_ms, busy_ms, events = profile_ms(lambda: torch.autograd.grad(loss_of(model), params))
    names = ("flash_attn_fwd_tc_kernel", "flash_attn_bwd_dkv_tc_kernel", "flash_attn_bwd_dq_tc_kernel",
             "flash_attn_bwd_dkv_kernel", "flash_attn_bwd_dq_kernel")
    k_ms = {nm: sum(e.self_device_time_total for e in events if nm in e.key) / 1e3 for nm in names}
    attn_ms = sum(k_ms.values())
    frames = int(tb["olens"].sum())
    print(f"E2-TTS micro-step bf16 (forward, loss, backward; the optimizer aside), largest batch B={b}, S={s_len} "
          f"({frames} frames): {micro_ms:.1f} ms (host clock, peak memory {peak_gb:.1f} GiB); forward+loss "
          f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms; {where}", flush=True)
    print(f"profile of one E2 micro-step: wall {wall_ms:.1f} ms under the profiler, device busy {busy_ms:.1f} ms in "
          f"{sum(e.count for e in events)} kernels, idle share {1 - busy_ms / wall_ms:.3f}; attention: forward "
          f"{k_ms[names[0]]:.2f} ms, dk/dv {k_ms[names[1]]:.2f} ms, dq {k_ms[names[2]]:.2f} ms (tensor cores, "
          f"{depth} launches each; the scalar dk/dv {k_ms[names[3]]:.2f} ms, dq {k_ms[names[4]]:.2f} ms) = "
          f"{attn_ms / busy_ms:.3f} of the device time", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    check(k_ms[names[1]] > 0 and k_ms[names[2]] > 0 and k_ms[names[3]] == 0 and k_ms[names[4]] == 0,
          "the profiled E2 micro-step did not run its backward on the tensor-core kernels")

    # the same step under attn_backend xla, dropout 0, the same draws: bf16
    # as trained (loose bound: the two round to bf16 at other places), then
    # f32 on 2 rows (tight)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    small = {k: v[:2] for k, v in tb.items()}

    def step_pair(dt, batch, tol_loss, tol_grad):
        pair = {}
        for backend in ("flash", "xla"):
            m = E2TTS(**{**model_params, "attn_backend": backend}, device="cuda", dtype=dt)
            m.load_state_dict(state)
            set_dropout_rate(m, 0.0)
            m.train()
            reset_all_launches()
            lss = loss_of(m, batch)
            g = torch.autograd.grad(lss, list(m.parameters()))
            counts_now = launch_counts()
            got = tuple(counts_now[f"k1.launches{k}"] for k in ("", "_bwd_dkv", "_bwd_dq"))
            check(got == ((depth,) * 3 if backend == "flash" else (0, 0, 0)),
                  f"E2 {backend} step: launches (forward, dk/dv, dq) {got}")
            pair[backend] = (float(lss.detach()), g)
            del m
        (lf, gf), (lx, gx) = pair["flash"], pair["xla"]
        loss_rel = abs(lf - lx) / abs(lx)
        diff = math.sqrt(sum(float((a - b_).double().pow(2).sum()) for a, b_ in zip(gf, gx)))
        norm = math.sqrt(sum(float(b_.double().pow(2).sum()) for b_ in gx))
        name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dt]
        print(f"E2-TTS flash vs xla, {name}, batch B={batch['ys'].shape[0]}, S={s_len}, dropout 0, the same draws: "
              f"loss {lf:.6f} vs {lx:.6f} (rel diff {loss_rel:.2e}, tol {tol_loss:.0e}), gradients |g_flash - g_xla| "
              f"/ |g_xla| {diff / norm:.2e} (tol {tol_grad:.0e})", flush=True)
        check(loss_rel <= tol_loss and diff / norm <= tol_grad, f"E2 flash and xla steps disagree ({name})")
        return diff / norm

    rel_bf16 = step_pair(dtype, tb, 1e-2, 5e-2)
    rel_f32 = step_pair(torch.float32, small, 1e-4, 1e-3)
    del state
    torch.cuda.empty_cache()

    # the kernels per item at the largest batch (each row's valid keys: the
    # time token and its frames), then their times with every key valid
    rows = [(0, 1 + int(x)) for x in tb["olens"]]
    shape = (b, 16, s_len, s_len, 64)
    e, scalar_err = check_nar_bwd("E2's largest batch", shape, rows, seed + 92, label="E2")
    chain = check_nar_chain(shape, rows, seed + 93, label="E2")
    errs = {"fwd": chain["fwd"], "dkv": max(e["dk"], e["dv"], chain["dk"], chain["dv"]),
            "dq": max(e["dq"], chain["dq"]), "scalar": scalar_err}
    times = time_nar_attn((b, 16, s_len, 64), seed + 94, where, label="E2")
    return trainer, counts, {"run_s": run_s, "micro_ms": micro_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                             "peak_gb": peak_gb, "idle": 1 - busy_ms / wall_ms, "busy_ms": busy_ms,
                             "wall_ms": wall_ms, "k_ms": k_ms, "attn_share": attn_ms / busy_ms,
                             "shape": (b, s_len), "frames": frames, "loss": (first, last), "rel_bf16": rel_bf16,
                             "rel_f32": rel_f32, "errs": errs, "times": times}


def e2_decode(root, corpus, conf, expdir, seed, where):
    """Phase 19, stage 4: ``bin/e2tts_decode.py`` on 4 dev rows with the
    trained checkpoint (its EMA weights) at ``--max-frames`` 3000 with
    ``--vocoder griffin_lim``; launch counts set to 0 just before and read
    just after (one tensor-core forward a layer an ODE step, nothing
    else); each row's mel against ``E2TTS.inference`` on the CLI's inputs
    with its generator, bit for bit; the wavs finite and gen frames x hop
    samples long."""
    import numpy as np
    import torch

    from jatts_torch.bin import e2tts_decode
    from jatts_torch.serving.bundle import inference_kwargs
    from jatts_torch.utils.config import load_config
    from jatts_torch.utils.io import read_audio, read_csv, write_csv

    _, dev_csv, stats, tokens = corpus
    rows = read_csv(dev_csv, dict_reader=True)[0][:E2_DECODE_ROWS]
    csv = str(Path(root) / "decode_e2.csv")
    write_csv(rows, csv)
    cfg = str(Path(expdir) / "config.yml")  # the training run's, attn_backend flash
    outdir = Path(root) / "decode_e2"
    max_frames = int(conf["max_duration"])
    reset_all_launches()
    t0 = time.perf_counter()
    out = e2tts_decode.main(["--csv", csv, "--stats", stats, "--token-list", tokens, "--expdir", expdir,
                             "--config", cfg, "--outdir", str(outdir), "--vocoder", "griffin_lim",
                             "--max-frames", str(max_frames), "--device", "cuda", "--verbose", "0"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    with open(tokens, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    model = e2tts_decode.load_model(load_config(cfg), n_vocab, None, expdir, "cuda")
    kw = inference_kwargs(conf)
    n_fwd = model.backbone.depth * kw["steps"] * len(rows)
    check(out["vocoder"] == "GriffinLimVocoder" and len(out["rows"]) == len(rows), f"E2 decode {out['vocoder']}")
    check(all(counts[c] == (n_fwd if c in ("k1.launches", "k1.launches_tc") else 0) for c in counts),
          f"E2 decode launches {counts}: want {n_fwd} on the tensor-core forward and nothing else")
    conv = e2tts_decode.TokenIDConverter(tokens)
    ex = e2tts_decode.LogMelExtractor(conf["sampling_rate"], conf["fft_size"], conf["hop_size"],
                                      num_mels=conf["num_mels"], fmin=conf.get("fmin"), fmax=conf.get("fmax"),
                                      device="cuda")
    with np.load(stats) as st:
        mean, scale = st["mel_mean"], st["mel_scale"]
    differ, lens = 0, []
    for i, (row, res) in enumerate(zip(rows, out["rows"])):
        prompt = (ex(read_audio(row["prompt_wav_path"], conf["sampling_rate"])[0]) - mean) / scale
        cond = torch.zeros(1, max_frames, conf["num_mels"], device="cuda")
        cond[0, :res["n_prompt"]] = torch.from_numpy(prompt[:res["n_prompt"]].astype(np.float32)).cuda()
        ids = conv.tokens2ids(row["prompt_phonemes"].split(" ") + ["<blank>"] + row["phonemes"].split(" "))
        want = model.inference(cond, torch.tensor([ids], device="cuda"), torch.tensor([res["n_prompt"]], device="cuda"),
                               torch.tensor([res["duration"]], device="cuda"),
                               generator=torch.Generator(device="cuda").manual_seed(i), **kw)["feat_gen"]
        mel = np.load(str(outdir / "wav" / f"{row['sample_id']}_mel.npy"))
        differ += int((want[0, res["n_prompt"]:res["duration"]].float().cpu().numpy() != mel).sum())
        wav, _ = read_audio(str(outdir / "wav" / f"{row['sample_id']}.wav"))
        check(len(wav) == res["gen"] * conf["hop_size"] and bool(np.isfinite(wav).all()),
              f"E2 decode wav {len(wav)} samples for {res['gen']} frames")
        lens.append((res["n_prompt"], res["gen"]))
    step_prof = e2_step_profile(model, cond, torch.tensor([ids], device="cuda"),
                                torch.tensor([res["n_prompt"]], device="cuda"),
                                torch.tensor([res["duration"]], device="cuda"), kw, "a decode row's", where)
    row_ms = [r["seconds"] * 1e3 for r in out["rows"]]
    print(f"E2-TTS decode CLI (bin/e2tts_decode.py, EMA weights, --max-frames {max_frames}, --vocoder griffin_lim) on "
          f"{len(rows)} dev rows: (prompt, generated) frames {lens}; the model {', '.join(f'{m:.1f}' for m in row_ms)} "
          f"ms a row (host clock, to the fetch) (the CLI's wall "
          f"{wall_s:.1f} s with loading and Griffin-Lim); launches: forward {counts['k1.launches']} (tensor cores "
          f"{counts['k1.launches_tc']}), limit {model.backbone.depth} x {kw['steps']} x {len(rows)} = {n_fwd}; the "
          f"mels against E2TTS.inference with the CLI's generator: {differ} values differ (limit 0); {where}",
          flush=True)
    check(differ == 0, "the E2 decode CLI's mels differ from E2TTS.inference on the same generator")
    valid = [res["duration"] + 1 for res in out["rows"]]
    fwd = time_e2_fwd("decode row", 2, valid[:1] * 2, max_frames + 1, seed + 95, where)
    del model
    torch.cuda.empty_cache()
    return counts["k1.launches_tc"], {"row_ms": row_ms, "wall_s": wall_s, "fwd": fwd, "step": step_prof}


def e2_slice(root, seed, where):
    """Phase 19: E2-TTS's features, serving, training and decode. Returns
    the launches of each path and the numbers the record and PERF.md need."""
    import torch

    t_phase = time.perf_counter()
    root = Path(root) / "e2tts"
    corpus, conf, truth = e2_features(root, seed, where)
    serve_tc, serve = e2_serving(corpus, conf, truth, seed, where)
    outdir = str(root / "exp")
    trainer, counts, train = e2_training(corpus, conf, outdir, seed, where)
    del trainer
    torch.cuda.empty_cache()
    decode_tc, decode = e2_decode(root, corpus, conf, outdir, seed, where)
    print(f"phase 19 (E2-TTS features, serving, training, kernels, decode): {time.perf_counter() - t_phase:.1f} s; "
          f"{where}", flush=True)
    return {"serve_tc": serve_tc, "train": counts, "decode_tc": decode_tc}, {"serve": serve, "train": train,
                                                                               "decode": decode}


ART_BUCKETS = (32, 64, 128)  # the JSUT artifact's text buckets
ART_BATCH = 8
ART_FRAMES = 1024
ART_CHUNK = 128  # the stream step's mel frames a chunk
ART_TIMED = 10  # batches timed eagerly and replayed, in turns
ART_SERVED = 16  # requests through BatchingServer, half of them streamed
VALLE_ART_ROWS = 4
VALLE_ART_STEPS = 256  # the fused program's max_steps
VALLE_ART_BUCKET = 64
E2_ART_REQUESTS = 4
E2_ART_BUCKET = 128
ART_VOCAB = 64


def pool_bytes():
    """Bytes held by private memory pools (the CUDA graphs'): the segments
    of the allocator's snapshot outside the default pool."""
    import torch

    segs = torch.cuda.memory._snapshot()["segments"]
    return sum(s["total_size"] for s in segs if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))


def _load(path, where, label):
    """load_bundle on the card, timed (rebuild, eager warm-ups, captures),
    and the pool bytes its captures added."""
    import torch

    from jatts_torch.serving import load_bundle

    torch.cuda.synchronize()
    before = pool_bytes()
    t0 = time.perf_counter()
    bundle = load_bundle(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pool = pool_bytes() - before
    print(f"artifact {label}: {os.path.getsize(path) / 2**20:.1f} MiB; load and capture {load_s:.2f} s, graph pool "
          f"{pool} bytes ({pool / 2**20:.1f} MiB); {where}", flush=True)
    return bundle, {"mib": os.path.getsize(path) / 2**20, "load_s": load_s, "pool_bytes": pool}


def _tc_a_replay(call):
    return call.launches.get("flash_attention.launches_tc", 0)


def artifact_jsut(root, seed, where):
    """Phase 20, the JSUT artifacts: FastSpeech2 at the conf's width (bf16,
    flash, seed-made weights) + HiFi-GAN, B=8, buckets 32/64/128, 1024
    frames, exported three times and each loaded on the card (one graph a
    bucket, the stream step's): a pcm16 wav artifact with phase 7's bf16
    HiFi-GAN, and a pcm16 wav artifact and a mel artifact with a stream step
    (chunk 128) with the f32 HiFi-GAN ``vocoder/vocoder.py:Vocoder`` builds.
    Each bucket's replay against the eager program bit for bit; 10 batches
    eager and replayed in turns; time to first audio and ms a chunk, the
    chunks against the f32 wav artifact; 16 requests, half streamed, through
    BatchingServer. The stream pair's vocoder is f32 because a chunk equals
    the whole call's samples only where the convolutions' arithmetic does:
    cuDNN picks its algorithm by length, and bf16 activations turn another
    summation order into whole-ulp differences (32 LSB on an H100 with a
    bf16 generator, PERF.md)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from jatts_torch.models.fastspeech2 import FastSpeech2
    from jatts_torch.serving import BatchingServer, build_infer_fn, export_bundle
    from jatts_torch.serving.export import build_stream_step_fn
    from jatts_torch.utils.config import load_config
    from jatts_torch.vocoder.hifigan import HiFiGANGenerator

    conf = load_config(str(JSUT_CONF))
    mp = dict(conf["model_params"], idim=ART_VOCAB, attn_backend="flash")
    torch.manual_seed(seed)
    fs2 = FastSpeech2(**mp, device="cuda", dtype=None).to(torch.bfloat16)
    voc16 = HiFiGANGenerator(**HIFIGAN, device="cuda", dtype=torch.bfloat16)
    voc32 = HiFiGANGenerator(**HIFIGAN, device="cuda")
    voc32.load_state_dict(voc16.state_dict())
    with torch.no_grad():
        # durations centred on max_frames / bucket frames a token, as in phase 7
        fs2.duration_predictor.linear.weight.mul_(0.1)
        fs2.duration_predictor.linear.bias.fill_(math.log(1.0 + ART_FRAMES / ART_BUCKETS[-1]))
    rng = np.random.default_rng(seed + 20)
    mean, scale = rng.normal(-4.0, 1.0, 80).astype(np.float32), rng.uniform(0.5, 2.0, 80).astype(np.float32)
    config = {"model_type": "FastSpeech2", "model_params": mp}
    meta = {"model_type": "FastSpeech2", "model_params": mp, "num_mels": 80, "sampling_rate": 24000,
            "hop_size": voc16.hop_size, "max_frames": ART_FRAMES}
    paths = {}
    for name, voc in (("wav_bf16_voc", voc16), ("wav", voc32)):
        fn, w = build_infer_fn(config, fs2, mean, scale, ART_FRAMES, vocoder=SimpleNamespace(model=voc, mean=None,
                                                                                             scale=None))
        paths[name] = export_bundle(str(root / f"jsut_{name}.npz"), fn, ART_BATCH, ART_BUCKETS,
                                    dict(meta, output="wav", wav_format="pcm16"), weights=w)
    fn, w = build_infer_fn(config, fs2, mean, scale, ART_FRAMES)
    stream = build_stream_step_fn(SimpleNamespace(model=voc32, mean=None, scale=None), ART_FRAMES, 80, chunk=ART_CHUNK)
    paths["mel"] = export_bundle(str(root / "jsut_mel_stream.npz"), fn, ART_BATCH, ART_BUCKETS,
                                 dict(meta, output="mel"), weights=w, stream=stream)
    del fs2, voc16, voc32, fn, w, stream
    torch.cuda.empty_cache()
    wav_b, wav_load = _load(paths["wav_bf16_voc"], where, "JSUT wav pcm16, bf16 HiFi-GAN")
    ref_b, ref_load = _load(paths["wav"], where, "JSUT wav pcm16, f32 HiFi-GAN")
    mel_b, mel_load = _load(paths["mel"], where, f"JSUT mel + stream step (chunk {ART_CHUNK}), f32 HiFi-GAN")
    check(all(sorted(b.graphs) == list(ART_BUCKETS) for b in (wav_b, ref_b, mel_b))
          and mel_b.stream_graph is not None, "a bucket or the stream step was not captured")
    tc = {b: _tc_a_replay(g) for b, g in wav_b.graphs.items()}
    check(all(n == 8 for n in tc.values()), f"K1 tc launches a replay {tc}, want 8 a bucket")

    # each bucket: 8 requests of lengths inside it, the replay against the
    # eager program on the same inputs
    lo = 1
    per_bucket = {}
    for b in ART_BUCKETS:
        reqs = [rng.integers(1, ART_VOCAB, size=int(n)).tolist() for n in rng.integers(lo, b + 1, size=ART_BATCH)]
        reqs[0] = rng.integers(1, ART_VOCAB, size=b).tolist()
        per_bucket[b], lo = reqs, b + 1
        xs, ilens = wav_b.prepare(reqs)
        eager = {k: v.clone() for k, v in wav_b.program(xs, ilens, None, wav_b.generator).items()}
        replay = wav_b.run(xs, ilens)
        differ = int((eager["wav"] != replay["wav"]).sum()) + int((eager["olens"] != replay["olens"]).sum())
        print(f"artifact JSUT bucket {b}: replay vs eager program, {differ} values differ (wav {tuple(replay['wav'].shape)}"
              f" int16, olens {replay['olens'].tolist()}; limit 0); K1 tc launches a replay {tc[b]}", flush=True)
        check(differ == 0, f"bucket {b}: the graph replay differs from the eager program")

    # 10 batches at bucket 128, eager and replayed in turns (host clock, to the fetch)
    full = per_bucket[ART_BUCKETS[-1]]
    graphs = wav_b.graphs
    times = {"eager": [], "replay": []}
    for i in range(ART_TIMED):
        for mode in (("eager", "replay") if i % 2 == 0 else ("replay", "eager")):
            wav_b.graphs = {} if mode == "eager" else graphs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = wav_b.synthesize(full)
            times[mode].append((time.perf_counter() - t0) * 1e3)
    wav_b.graphs = graphs
    med = {k: statistics.median(v) for k, v in times.items()}
    audio_s = sum(len(r["wav"]) for r in out) / 24000
    print(f"artifact JSUT served batch (B={ART_BATCH}, bucket {ART_BUCKETS[-1]}, {ART_FRAMES} frames, pcm16, bf16 "
          f"HiFi-GAN): median of "
          f"{ART_TIMED} eager {med['eager']:.2f} ms (min {min(times['eager']):.2f}), replayed {med['replay']:.2f} ms "
          f"(min {min(times['replay']):.2f}); RTF eager {med['eager'] / 1e3 / audio_s:.5f}, replayed "
          f"{med['replay'] / 1e3 / audio_s:.5f} ({audio_s:.2f} s of audio); {where}", flush=True)

    # streaming: time to first audio, ms a chunk, the chunks against the f32 wav artifact
    ref = ref_b.synthesize(full)
    list(mel_b.synthesize_streaming(full))  # one pass before the timed one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = mel_b.synthesize_streaming(full)
    rows = [next(it)]
    ttfa_ms = (time.perf_counter() - t0) * 1e3
    chunk_ms = []
    while True:
        t1 = time.perf_counter()
        try:
            rows.append(next(it))
        except StopIteration:
            break
        chunk_ms.append((time.perf_counter() - t1) * 1e3)
    worst, n_diff = 0, 0
    for i, r in enumerate(ref):
        got = np.concatenate([row[i]["wav"] for row in rows])
        check(got.dtype == np.int16 and got.shape == r["wav"].shape, f"stream row {i}: {got.shape} vs {r['wav'].shape}")
        d = np.abs(got.astype(np.int32) - r["wav"].astype(np.int32))
        worst, n_diff = max(worst, int(d.max(initial=0))), n_diff + int((d > 0).sum())
    n_samples = sum(len(r["wav"]) for r in ref)
    print(f"artifact JSUT streaming (f32 HiFi-GAN, chunk {ART_CHUNK} frames, window {mel_b.stream.window}, context "
          f"{mel_b.stream.context}): time to first audio {ttfa_ms:.2f} ms, {len(chunk_ms)} more chunks at median "
          f"{statistics.median(chunk_ms):.2f} ms; chunks vs the f32 wav artifact: max |diff| {worst} LSB (limit 1), "
          f"{n_diff} of {n_samples} samples differ; {where}", flush=True)
    check(worst <= 1, "the streamed chunks differ from the wav artifact by more than 1 LSB")

    # BatchingServer: 8 streamed requests (bucket 128) and 8 whole ones (bucket 64)
    streamed_reqs, whole_reqs = per_bucket[ART_BUCKETS[-1]], per_bucket[ART_BUCKETS[-2]]
    t0 = time.perf_counter()
    with BatchingServer(mel_b, max_delay_ms=50) as server:
        handles = [server.submit_stream(token_ids=r) for r in streamed_reqs]
        futs = [server.submit(token_ids=r) for r in whole_reqs]
        streamed = [np.concatenate([c["wav"] for c in h]) for h in handles]
        whole = [f.result(timeout=600) for f in futs]
    served_s = time.perf_counter() - t0
    check(server.stats["requests"] == ART_SERVED and server.stats["batches"] == 2,
          f"server stats {server.stats}: want {ART_SERVED} requests in 2 batches")
    s_worst = max(int(np.abs(s.astype(np.int32) - r["wav"].astype(np.int32)).max(initial=0))
                  for s, r in zip(streamed, ref))
    check(s_worst <= 1 and all(len(s) == len(r["wav"]) for s, r in zip(streamed, ref)),
          "the served streams differ from the wav artifact")
    check(all(r["mel"].ndim == 2 and r["mel"].shape[1] == 80 and bool(np.isfinite(r["mel"]).all()) for r in whole),
          "a whole request's mel is not [olens, 80] and finite")
    print(f"artifact JSUT BatchingServer: {ART_SERVED} requests ({len(streamed_reqs)} streamed, {len(whole_reqs)} "
          f"whole) in {server.stats['batches']} batches, {served_s:.3f} s; the streams vs the wav artifact max "
          f"|diff| {s_worst} LSB; {where}", flush=True)
    replayed = {}
    for b in (wav_b, ref_b, mel_b):
        for k, v in b.graph_launches().items():
            replayed[k] = replayed.get(k, 0) + v
    out = {"load": {"wav_bf16_voc": wav_load, "wav": ref_load, "mel": mel_load}, "batch_ms": med, "ttfa_ms": ttfa_ms,
           "chunk_ms": statistics.median(chunk_ms), "stream_worst_lsb": worst, "stream_differ": n_diff,
           "replayed": replayed}
    del wav_b, ref_b, mel_b
    torch.cuda.empty_cache()
    return out


def artifact_valle(root, seed, where):
    """Phase 20, the fused VALL-E program: the AR and NAR confs as they
    stand (d_model 1024, 12 layers, bf16 compute and parameters, flash,
    seed-made weights), 4 rows, max_steps 256, one text bucket; loaded on
    the card (the prefix, one AR step and the NAR fill as graphs). The
    replay against the eager program on the same seed, code for code; ms an
    AR step replayed and eager."""
    import numpy as np
    import torch

    from jatts_torch.bin.tts_train import DTYPES
    from jatts_torch.models.valle import VALLEAR, VALLENAR
    from jatts_torch.serving import build_valle_fn, export_valle_bundle
    from jatts_torch.utils.config import load_config

    def build(cls, conf_path):
        params = dict(load_config(str(conf_path))["model_params"], idim=ART_VOCAB, attn_backend="flash")
        ctor = dict(params)
        dtype = DTYPES[ctor.pop("dtype")]
        torch.manual_seed(seed)
        model = cls(**ctor, device="cuda", dtype=dtype)
        return model.to(torch.bfloat16).eval(), params  # bf16 parameters, as bin/export_serving.py makes them

    (ar, ar_params), (nar, nar_params) = build(VALLEAR, TTS3_CONF), build(VALLENAR, NAR_CONF)
    fn, w = build_valle_fn(ar, nar, VALLE_ART_STEPS)
    path = export_valle_bundle(str(root / "valle.npz"), fn, VALLE_ART_ROWS, [VALLE_ART_BUCKET],
                               prompt_frames=ar.prompt_max_frame_length, n_prom_levels=ar.n_prom_levels,
                               meta={"model_type": "VALLE", "sampling_rate": 24000, "max_steps": VALLE_ART_STEPS,
                                     "ar_params": ar_params, "nar_params": nar_params}, weights=w)
    del ar, nar, fn, w
    torch.cuda.empty_cache()
    vb, load = _load(path, where, f"VALL-E AR+NAR ({VALLE_ART_ROWS} rows, max_steps {VALLE_ART_STEPS})")
    rng = np.random.default_rng(seed + 21)
    tok = [rng.integers(0, ART_VOCAB, size=int(n)).tolist() for n in rng.integers(30, VALLE_ART_BUCKET + 1,
                                                                                  size=VALLE_ART_ROWS)]
    prom = [rng.integers(0, 1024, size=(int(n), 8)) for n in rng.integers(75, vb.prompt_frames + 1,
                                                                         size=VALLE_ART_ROWS)]
    args = vb.prepare(tok, prom)
    start, step, fill = vb.graphs[VALLE_ART_BUCKET]
    results = {}
    for mode in ("eager", "replay"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vb.program(*args, generator=torch.Generator(device="cuda").manual_seed(seed)) if mode == "eager" \
            else vb.run(*args, seed=seed)
        results[mode] = ({k: v.cpu() for k, v in out.items()}, (time.perf_counter() - t0) * 1e3)
    (want, eager_ms), (got, replay_ms) = results["eager"], results["replay"]
    differ = int((want["codes"] != got["codes"]).sum()) + int((want["resp_lens"] != got["resp_lens"]).sum())
    # an AR step alone: eager on the program's state, and the step graph's replay
    p, steps = vb.program, VALLE_ART_STEPS - 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = p.start(*args, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        p.step(state, gen)
    torch.cuda.synchronize()
    eager_step_ms = (time.perf_counter() - t0) * 1e3 / steps
    vb.generator.manual_seed(seed)
    start(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    replay_step_ms = (time.perf_counter() - t0) * 1e3 / steps
    tc = _tc_a_replay(fill)
    print(f"artifact VALL-E fused program (ar and nar confs as they stand: d_model {p.ar.d_model}, {p.ar.n_layers} "
          f"layers, bf16 parameters, flash; {VALLE_ART_ROWS} rows, bucket {VALLE_ART_BUCKET}, max_steps "
          f"{VALLE_ART_STEPS}): replay vs eager program on seed {seed}, {differ} codes and lengths differ (limit 0), "
          f"resp_lens {got['resp_lens'].tolist()}; the whole call eager {eager_ms:.1f} ms, replayed {replay_ms:.1f} ms; "
          f"an AR step eager {eager_step_ms:.3f} ms, replayed {replay_step_ms:.3f} ms; K1 tc launches a fill replay "
          f"{tc} ({p.nar.n_layers} x {p.nar.n_resp_levels}); {where}", flush=True)
    check(differ == 0, "the replayed VALL-E program differs from the eager one")
    check(tc == p.nar.n_layers * p.nar.n_resp_levels, f"K1 tc launches a fill replay {tc}")
    check(bool(((got["codes"] >= 0) & (got["codes"] <= 1024)).all()), "a VALL-E code out of range")
    out = {"load": load, "eager_ms": eager_ms, "replay_ms": replay_ms, "eager_step_ms": eager_step_ms,
           "replay_step_ms": replay_step_ms, "replayed": vb.graph_launches()}
    del vb, state
    torch.cuda.empty_cache()
    return out


def artifact_e2(root, seed, where):
    """Phase 20, the E2-TTS artifact: the conf as it stands (bf16, flash,
    seed-made weights, 32 steps, CFG, sway), 4 requests at a capacity of
    ``max_duration`` frames, one text bucket; loaded on the card (one graph
    of the whole CFG Euler loop) and held to the in-process bundle on the
    same seed, bit for bit."""
    import numpy as np
    import torch

    from jatts_torch.serving import E2ttsServingBundle
    from jatts_torch.serving.bundle import inference_kwargs
    from jatts_torch.serving.export import build_e2tts_bundle_cli
    from jatts_torch.utils.config import load_config

    conf = load_config(str(E2_CONF))
    model = e2_model(conf, ART_VOCAB, seed).eval()
    rng = np.random.default_rng(seed + 22)
    mean, scale = rng.normal(-4.0, 1.0, 80).astype(np.float32), rng.uniform(0.5, 2.0, 80).astype(np.float32)
    max_frames = int(conf["max_duration"])
    config = dict(conf, model_params=dict(conf["model_params"], idim=ART_VOCAB, attn_backend="flash"))
    path = build_e2tts_bundle_cli(str(root / "e2tts"), config, model, mean, scale, E2_ART_REQUESTS, [E2_ART_BUCKET],
                                  max_frames, ["cuda"])
    inproc = E2ttsServingBundle(model, mean, scale, batch_size=E2_ART_REQUESTS, buckets=[E2_ART_BUCKET],
                                max_frames=max_frames, infer_kwargs=inference_kwargs(conf))
    loaded, load = _load(path, where, f"E2-TTS ({E2_ART_REQUESTS} requests, capacity {max_frames})")
    fields = [[rng.integers(0, ART_VOCAB, size=int(n)).tolist() for n in rng.integers(60, E2_ART_BUCKET + 1,
                                                                                      size=E2_ART_REQUESTS)],
              [(rng.normal(size=(int(n), 80)) * scale + mean).astype(np.float32)
               for n in rng.integers(200, 401, size=E2_ART_REQUESTS)],
              [12 * int(n) for n in rng.integers(20, 81, size=E2_ART_REQUESTS)]]
    results = {}
    for label, bundle in (("in-process", inproc), ("artifact", loaded)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[label] = (bundle.synthesize(*fields, seed=seed), (time.perf_counter() - t0) * 1e3)
    (want, eager_ms), (got, replay_ms) = results["in-process"], results["artifact"]
    differ = sum(int((a != b).sum()) for a, b in zip(got, want))
    tc = _tc_a_replay(loaded.graphs[E2_ART_BUCKET])
    steps = loaded.program.infer_kwargs["steps"]
    print(f"artifact E2-TTS ({E2_CONF.relative_to(ROOT)} as it stands, bf16, flash; {steps} steps, CFG, sway): "
          f"replayed vs the in-process bundle on seed {seed}, {differ} values differ (limit 0), mels "
          f"{[g.shape[0] for g in got]} frames; a batch in process {eager_ms:.1f} ms, replayed {replay_ms:.1f} ms; "
          f"K1 tc launches a replay {tc} ({model.backbone.depth} x {steps}); {where}", flush=True)
    check(differ == 0, "the E2 artifact's replay differs from the in-process bundle")
    check(all(g.shape == (n, 80) and bool(np.isfinite(g).all()) for g, n in zip(got, fields[2])),
          "an E2 mel is not [gen_frames, 80] and finite")
    check(tc == model.backbone.depth * steps, f"K1 tc launches a replay {tc}")
    out = {"load": load, "eager_ms": eager_ms, "replay_ms": replay_ms, "replayed": loaded.graph_launches()}
    del loaded, inproc, model
    torch.cuda.empty_cache()
    return out


def artifact_noise_models(root, seed, where):
    """Phase 20, Matcha-TTS and mel-VITS mel artifacts (the JSUT confs as
    they stand, f32, TF32 off, seed-made weights as phases 16 and 17 make
    them; B=8, bucket 128, 1024 frames): the graph's replay against the
    eager program on the same seed bit for bit (mel, olens), another seed
    other mels; the noise drawn inside the graph from the bundle's
    registered generator."""
    import numpy as np
    import torch

    from jatts_torch.models.matchatts import MatchaTTS
    from jatts_torch.models.vits import VITS
    from jatts_torch.serving import build_infer_fn, export_bundle
    from jatts_torch.utils.config import load_config

    out = {}
    for name, cls, conf_path in (("matcha", MatchaTTS, MATCHA_CONF), ("vits", VITS, VITS_CONF)):
        config = load_config(str(conf_path))
        mp = dict(config["model_params"], idim=ART_VOCAB)
        torch.manual_seed(seed)
        model = cls(**mp, device="cuda").eval()
        with torch.no_grad():
            model.duration_predictor.linear.weight.mul_(0.1)
            model.duration_predictor.linear.bias.fill_(math.log(1.0 + ART_FRAMES / ART_BUCKETS[-1]))
        if cls is VITS:
            randomize_flow_projections(model, seed)
        rng = np.random.default_rng(seed + 23)
        mean, scale = rng.normal(-4.0, 1.0, 80).astype(np.float32), rng.uniform(0.5, 2.0, 80).astype(np.float32)
        fn, w = build_infer_fn(config, model, mean, scale, ART_FRAMES)
        path = export_bundle(str(root / f"{name}.npz"), fn, ART_BATCH, ART_BUCKETS[-1:],
                             {"model_type": config["model_type"], "model_params": mp, "num_mels": 80,
                              "sampling_rate": 24000, "hop_size": 300, "max_frames": ART_FRAMES, "output": "mel"},
                             weights=w)
        del model, fn, w
        torch.cuda.empty_cache()
        bundle, load = _load(path, where, f"{cls.__name__} mel (f32)")
        reqs = [rng.integers(1, ART_VOCAB, size=int(n)).tolist() for n in rng.integers(40, 129, size=ART_BATCH)]
        xs, ilens = bundle.prepare(reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = {k: v.cpu() for k, v in bundle.program(xs, ilens, None,
                                                       torch.Generator(device="cuda").manual_seed(seed)).items()}
        eager_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        replay = {k: v.cpu() for k, v in bundle.run(xs, ilens, seed=seed).items()}
        replay_ms = (time.perf_counter() - t0) * 1e3
        other = bundle.run(xs, ilens, seed=seed + 1)["mel"].cpu()
        differ = int((eager["mel"] != replay["mel"]).sum()) + int((eager["olens"] != replay["olens"]).sum())
        moved = float((other - replay["mel"]).abs().max())
        print(f"artifact {cls.__name__} ({conf_path.relative_to(ROOT)} as it stands, f32, {bundle.program.infer_kwargs})"
              f": replay vs eager program on seed {seed}, {differ} values differ (limit 0), olens "
              f"{replay['olens'].tolist()}; seed {seed + 1} moves the mel by up to {moved:.3f} (limit > 1e-3); a batch "
              f"eager {eager_ms:.1f} ms, replayed {replay_ms:.1f} ms; {where}", flush=True)
        check(differ == 0, f"the {cls.__name__} replay differs from the eager program")
        check(moved > 1e-3, f"another seed gave the same {cls.__name__} mel")
        out[name] = {"load": load, "eager_ms": eager_ms, "replay_ms": replay_ms}
        del bundle
        torch.cuda.empty_cache()
    return out


def artifact_slice(root, seed, where):
    """Phase 20: the serving artifact. Returns the kernels' launches made by
    graph replays on each path, and the numbers PERF.md needs."""
    t_phase = time.perf_counter()
    root = Path(root) / "artifact"
    root.mkdir(parents=True, exist_ok=True)
    reset_all_launches()
    jsut = artifact_jsut(root, seed, where)
    noise = artifact_noise_models(root, seed, where)
    valle = artifact_valle(root, seed, where)
    e2 = artifact_e2(root, seed, where)
    eager = launch_counts()
    replayed = {path: out["replayed"].get("flash_attention.launches_tc", 0)
                for path, out in (("served_artifact", jsut), ("valle_fused", valle), ("e2tts_artifact", e2))}
    print(f"phase 20 (the serving artifact): K1 tc launches replayed {replayed}; launched eagerly (the warm-ups "
          f"before each capture, the captures and the eager references) {eager['k1.launches_tc']}; every other counter "
          f"{ {k: v for k, v in eager.items() if v and k not in ('k1.launches', 'k1.launches_tc')} }; "
          f"{time.perf_counter() - t_phase:.1f} s; {where}", flush=True)
    check(all(n > 0 for n in replayed.values()), f"a served program replayed no K1 tc launch: {replayed}")
    return replayed, {"jsut": jsut, "noise": noise, "valle": valle, "e2": e2}


# ---------------------------------------------------------------------------
# phase 21: mixed precision (flax's compute dtype) on the mel families
# ---------------------------------------------------------------------------

MP_FS2 = (24, 896, 112)  # a FastSpeech2 step's batch: B, T_feats, T_text (phases 10 and 14's largest)
MP_MATCHA = (16, 704, 96)  # Matcha-TTS's tts1 step (phase 16's largest)
MP_VITS = (8, 896, 112)  # a VITS micro-step (phase 17's largest)
MP_TIMED = 10  # steps timed after MP_WARM warm-up steps
MP_WARM = 2
MP_SMALL_TIMED = 10  # the Matcha and VITS steps: timed steps a round
MP_SMALL_ROUNDS = 3  # rounds, f32 and bf16 alternating in each
MP_CLI_STEPS = 4  # the bf16 CLI run: an eval interval at 2 and 4
SDPA_ROUNDS = 5  # rounds of SDPA's forward+backward beside the bf16 backward pairs
# the backward routes a FastSpeech2 step can take, by the counters of ops/flash_attention.py
MP_ROUTES = ("launches", "launches_relpos", "launches_tc", "launches_tc_f32", "launches_bwd_dkv", "launches_bwd_dq",
             "launches_bwd_dkv_relpos", "launches_bwd_dq_relpos", "launches_bwd_dkv_tc_f32", "launches_bwd_dq_tc_f32",
             "launches_bwd_dkv_tc_relpos", "launches_bwd_dq_tc_relpos", "launches_bwd_dkv_tc_bias",
             "launches_bwd_dq_tc_bias")


def mp_batch(shape, odim, seed, spk_dim=0, pitch=True):
    """A padded numpy batch as the collaters make it: the first row at full
    length, the others 60-100% of it; integer durations summing to each
    row's frames."""
    import numpy as np

    b, t_feats, t_text = shape
    rng = np.random.default_rng(seed)
    ilens = np.concatenate([[t_text], rng.integers(int(0.6 * t_text), t_text + 1, b - 1)]).astype(np.int64)
    olens = np.concatenate([[t_feats], rng.integers(int(0.6 * t_feats), t_feats + 1, b - 1)]).astype(np.int64)
    olens = olens - olens % 2  # the Matcha U-Net's even frames; harmless for the others
    ds = np.zeros((b, t_text), np.int64)
    for i in range(b):
        cut = np.sort(rng.choice(np.arange(1, olens[i]), ilens[i] - 1, replace=False))
        ds[i, : ilens[i]] = np.diff(np.concatenate([[0], cut, [olens[i]]]))
    text_mask = np.arange(t_text)[None] < ilens[:, None]
    feat_mask = (np.arange(t_feats)[None] < olens[:, None])[..., None]
    batch = {
        "xs": (rng.integers(1, 64, (b, t_text)) * text_mask).astype(np.int64), "ilens": ilens,
        "ys": (rng.normal(size=(b, t_feats, odim)) * feat_mask).astype(np.float32), "olens": olens, "ds": ds,
    }
    if pitch:
        batch["ps"] = (rng.normal(size=(b, t_text, 1)) * text_mask[..., None]).astype(np.float32)
        batch["es"] = (rng.normal(size=(b, t_text, 1)) * text_mask[..., None]).astype(np.float32)
    if spk_dim:
        batch["spembs"] = rng.normal(size=(b, spk_dim)).astype(np.float32)
    return batch


class _NoLoader:
    sampler = None

    def __iter__(self):
        return iter(())


def mp_trainer(config, model_type, dtype_name, seed, outdir, **extra):
    """A Trainer on a seed-made model of the conf's published widths, the
    compute dtype ``dtype_name``."""
    import torch

    from jatts_torch.bin import tts_train
    from jatts_torch.train.steps import get_loss_fn
    from jatts_torch.train.trainer import Trainer

    torch.manual_seed(seed)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    mp = {k: v for k, v in config["model_params"].items() if k != "dtype"}
    model = tts_train.MODELS[model_type](idim=64, **{**mp, **extra}, device="cuda", dtype=dtype)
    check({p.dtype for p in model.parameters()} == {torch.float32}, f"{model_type} {dtype_name}: parameters not f32")
    trainer = Trainer(config, model, tts_train.build_criterions(config), get_loss_fn(config["trainer_type"]),
                      _NoLoader(), outdir=outdir, seed=seed)
    trainer.init_state()
    return trainer


def device_busy_ms(fn):
    """Wall ms of one call and the device's busy ms in it, from a profile of
    the CUDA activity alone (kernels and copies; a CPU trace would cost the
    phase seconds a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3
    check(busy_ms > 0, "profile: the profiler saw no device time")
    return wall_ms, busy_ms


def mp_time_steps(trainer, tb, warm, timed, label, where, busy=True):
    """Median ms of ``timed`` steps after ``warm`` (host clock, each ending in
    a synchronise), device-busy ms of one profiled step (``busy``), peak GiB,
    and the flash counters' launches over the timed steps."""
    import statistics

    import torch

    from jatts_torch.ops import flash_attention as k1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = trainer.train_step(tb)
    for _ in range(warm - 1):
        trainer.train_step(tb)
    torch.cuda.synchronize()
    k1.reset_launches()
    ms = []
    for _ in range(timed):
        t0 = time.perf_counter()
        trainer.train_step(tb)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: getattr(k1, n) for n in MP_ROUTES}
    wall_ms, busy_ms = device_busy_ms(lambda: trainer.train_step(tb)) if busy else (None, None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(v) for v in first.values()), f"{label}: a stat is not finite")
    res = {"ms": statistics.median(ms), "ms_all": ms, "busy_ms": busy_ms, "wall_ms": wall_ms, "peak_gib": peak,
           "launches": launches, "loss0": first["train/loss"]}
    busy_text = f"one profiled step busy {busy_ms:.1f} of {wall_ms:.1f} ms; " if busy else ""
    print(f"{label}: median {res['ms']:.1f} ms of {timed} steps after {warm} (min {min(ms):.1f}, max {max(ms):.1f}); "
          f"{busy_text}peak {peak:.2f} GiB; launches over the "
          f"timed steps " + ", ".join(f"{n[9:] or 'K1'} {v}" for n, v in launches.items() if v) + f"; {where}",
          flush=True)
    return res


def mp_fs2_steps(root, seed, where):
    """The JSUT and JVS-latest FastSpeech2 steps at 24 x 896 in f32 and in
    bf16 compute, under ``xla`` and ``flash``, side by side on the same
    seed-made weights and batch; the launches each step takes, checked
    against the dispatch rules (bf16 + flash: the tensor-core forward, and
    the backward on K1r's bf16 tensor-core kernels at JVS-latest or on
    K1-bwd's bf16 tensor-core kernels with its bias at JSUT, none on the
    scalar ones; f32 + flash: the 3xTF32 kernels; xla: none), and each
    dtype's first-step loss against the other's."""
    from jatts_torch.utils.config import load_config

    out = {}
    for which, conf, extra, spk in (("jsut", JSUT_CONF, {}, 0),
                                    ("jvs_latest", JVS_CONF, {"conformer_rel_pos_type": "latest"}, 192)):
        config = load_config(str(conf))
        b, t_feats, t_text = MP_FS2
        batch = mp_batch(MP_FS2, int(config["num_mels"]), seed, spk_dim=spk)
        rel = which == "jvs_latest"
        for backend in ("xla", "flash"):
            for dtype_name in ("f32", "bf16"):
                label = f"mixed precision, {which} FastSpeech2 step {dtype_name} {backend} at {b} x {t_feats} x {t_text}"
                tr = mp_trainer(config, "FastSpeech2", dtype_name, seed, str(Path(root) / f"mp_{which}"),
                                attn_backend=backend, **extra)
                res = mp_time_steps(tr, tr.to_device(batch), MP_WARM, MP_TIMED, label, where)
                n = res["launches"]
                steps = MP_TIMED
                fwd = n["launches_relpos"] if rel else n["launches"]
                dkv, dq = ((n["launches_bwd_dkv_relpos"], n["launches_bwd_dq_relpos"]) if rel
                           else (n["launches_bwd_dkv"], n["launches_bwd_dq"]))
                if backend == "xla":
                    check(all(v == 0 for v in n.values()), f"{label}: xla launched {n}")
                else:
                    check(fwd == dkv == dq == 8 * steps, f"{label}: forward, dk/dv, dq launches {fwd, dkv, dq}")
                    tc = (n["launches_tc"], n["launches_tc_f32"], n["launches_bwd_dkv_tc_f32"],
                          n["launches_bwd_dq_tc_f32"], n["launches_bwd_dkv_tc_relpos"], n["launches_bwd_dq_tc_relpos"],
                          n["launches_bwd_dkv_tc_bias"], n["launches_bwd_dq_tc_bias"])
                    relpos_bf16 = (8 * steps, 8 * steps) if rel else (0, 0)
                    bias_bf16 = (0, 0) if rel else (8 * steps, 8 * steps)
                    want = ((8 * steps, 0, 0, 0, *relpos_bf16, *bias_bf16) if dtype_name == "bf16"
                            else (0, 8 * steps, 8 * steps, 8 * steps, 0, 0, 0, 0))
                    check(tc == want, f"{label}: tensor-core routes {tc} != {want}")
                # the launches on the scalar backward: 0 at both (K1-bwd's bf16 form with its bias at JSUT, K1r's
                # at JVS-latest, each on its tensor-core kernels)
                res["scalar_bwd"] = ((dkv - n["launches_bwd_dkv_tc_relpos"] - n["launches_bwd_dkv_tc_bias"],
                                      dq - n["launches_bwd_dq_tc_relpos"] - n["launches_bwd_dq_tc_bias"])
                                     if dtype_name == "bf16" and backend == "flash" else (0, 0))
                check(res["scalar_bwd"] == (0, 0), f"{label}: scalar K1-bwd or K1r backward {res['scalar_bwd']}")
                out[(which, backend, dtype_name)] = res
                del tr
        for backend in ("xla", "flash"):
            l32, l16 = out[(which, backend, "f32")]["loss0"], out[(which, backend, "bf16")]["loss0"]
            rel_d = abs(l16 - l32) / abs(l32)
            print(f"mixed precision, {which} {backend}: first-step loss bf16 {l16:.5f} vs f32 {l32:.5f} (rel "
                  f"{rel_d:.2e}, tol 2e-2)", flush=True)
            check(rel_d <= 2e-2, f"{which} {backend}: the bf16 step's loss is {rel_d:.2e} from the f32 one's")
    return out


def mp_bwd_times(q, k, v, ab, full, scale, do):
    """One bf16 backward pair (the form's tensor-core dk/dv and dq) at a
    step's shape with every key valid: each kernel by CUDA events and by
    graph replay, the scalar kernels on the same inputs beside
    (``_lib=KERNEL_BWD``), the plain backward and SDPA's forward+backward
    (the yardstick, never used by the port; the bias, if any, as a float
    mask after the scale): the median of SDPA_ROUNDS rounds of 5 calls, each
    round's mean kept (``library_rounds``)."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    o, lse = k1.flash_attention_fwd(q, k, v, ab, full, scale)
    di = (o.float() * do.float()).sum(-1)
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    dab = None if ab is None else torch.empty_like(ab)

    def dkv():
        return k1.flash_attention_bwd_dkv(q, k, v, ab, full, scale, lse, di, do)

    def dq_():
        return k1.flash_attention_bwd_dq(q, k, v, ab, full, scale, lse, di, do)

    r = {"dkv": time_ms(dkv, iters=10, warmup=2), "dq": time_ms(dq_, iters=10, warmup=2),
         "dkv_graph": graph_ms(dkv, iters=10, replays=3), "dq_graph": graph_ms(dq_, iters=10, replays=3),
         "dkv_scalar": time_ms(lambda: k1._launch_bwd("dkv", q, k, v, ab, full, scale, lse, di, do, dk, dv, False,
                                                      _lib=k1.KERNEL_BWD), iters=3, warmup=1),
         "dq_scalar": time_ms(lambda: k1._launch_bwd("dq", q, k, v, ab, full, scale, lse, di, do, dq, dab, False,
                                                     _lib=k1.KERNEL_BWD), iters=3, warmup=1),
         "plain_ms": time_ms(lambda: k1.flash_attention_bwd_ref(q, k, v, ab, full, scale, o, lse, do), iters=3,
                             warmup=1)}
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    if ab is not None:
        leaves.append((ab * scale).detach().requires_grad_())  # SDPA adds its mask after the scale

    def sdpa():
        out_ = torch.nn.functional.scaled_dot_product_attention(
            *leaves[:3], attn_mask=leaves[3] if ab is not None else None, scale=scale)
        torch.autograd.grad(out_, leaves, do)

    r["library_rounds"] = [time_ms(sdpa, iters=5, warmup=2 if i == 0 else 0) for i in range(SDPA_ROUNDS)]
    r["library_ms"] = statistics.median(r["library_rounds"])
    return r


def check_mp_bwd(seed, where):
    """The bf16 backwards a bf16 ``flash`` step launches, each against its
    plain twin at the step's shapes (K1-bwd with the ``matrix_bd`` bias at d
    192, JSUT, on its bf16 tensor-core kernels with a bias; K1r's (576, 192),
    JVS-latest, on its bf16 tensor-core kernels; the scalar ones on the same
    inputs beside), then timed with every key valid by CUDA events and graph
    replay beside the scalar kernels, the plain backward, SDPA's
    forward+backward and the bounds."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    b, t = MP_FS2[0], MP_FS2[1]
    full = torch.ones(b, t, dtype=torch.bool, device="cuda")
    res = {}
    # K1-bwd: bf16 with a bias at d 192 goes to its tensor-core kernels (ops/flash_attention.py:_bwd_kernel)
    err, lib, serr = check_k1bwd(b, 2, t, 192, "bf16", True, seed)
    check(lib == k1.KERNEL_BWD_TC_BIAS, f"K1-bwd bf16 with a bias ran on {lib}")
    _, lib_enc, serr_enc = check_k1bwd(b, 2, MP_FS2[2], 192, "bf16", True, seed + 4)  # the encoder's T_text
    check(lib_enc == k1.KERNEL_BWD_TC_BIAS, f"K1-bwd bf16 with a bias at the encoder ran on {lib_enc}")
    q, k, v, ab, _, do, _ = k1bwd_inputs(b, 2, t, 192, torch.bfloat16, True, seed + 1)
    r = mp_bwd_times(q, k, v, ab, full, 192 ** -0.5, do)
    r.update(max_abs_err=err, scalar_max_abs_err=max(serr, serr_enc), shape=[b, 2, t, 192],
             bounds=dict(zip(("dkv", "dq"), k1bwd_bounds_ms(b, 2, t, 192, 2, "bf16"))))
    res["k1"] = r
    del q, k, v, ab, do
    # K1r: the bf16 (576, 192) form, on its tensor-core kernels
    _, rerr, rserr = check_k1r("JVS-latest step, bf16", (b, 2, t), K1R_DIMS, "bf16", [(0, t), (0, t - 101)], seed)
    q, k, v, _, do = k1r_inputs((b, 2, t), K1R_DIMS, torch.bfloat16, [(0, t)], seed + 2)
    r = mp_bwd_times(q, k, v, None, full, 192 ** -0.5, do)  # d_k of the model; the features ride in d_qk
    r.update(max_abs_err=rerr, scalar_max_abs_err=rserr, shape=[b, 2, t, *K1R_DIMS],
             bounds={n: v for n, v in k1r_bounds_ms(b, 2, t, *K1R_DIMS, 2, "bf16", True).items() if n != "fwd"})
    res["k1r"] = r
    del q, k, v, do
    for name, r in res.items():
        print(f"mixed precision, the tensor-core bf16 backward ({name}, B,H,T,d={r['shape']}, every key valid): "
              f"dk/dv {r['dkv']:.4f} ms (bound {r['bounds']['dkv'][0]:.4f} by {r['bounds']['dkv'][1]}), dq "
              f"{r['dq']:.4f} ms (bound {r['bounds']['dq'][0]:.4f} by {r['bounds']['dq'][1]}); graph replay dk/dv "
              f"{r['dkv_graph']:.4f} ms, dq {r['dq_graph']:.4f} ms; the scalar kernels on the same inputs dk/dv "
              f"{r['dkv_scalar']:.4f} ms, dq {r['dq_scalar']:.4f} ms (max_abs_err {r['scalar_max_abs_err']:.2e}); "
              f"plain backward {r['plain_ms']:.4f} ms; sdpa forward+backward {r['library_ms']:.4f} ms (median of "
              f"rounds {', '.join(f'{x:.4f}' for x in r['library_rounds'])}); each kernel "
              f"under sdpa forward+backward: {r['dkv'] < r['library_ms'] and r['dq'] < r['library_ms']}; max_abs_err "
              f"{r['max_abs_err']:.2e}; {where}", flush=True)
    k1_under = res["k1"]["dkv"] < res["k1"]["library_ms"] and res["k1"]["dq"] < res["k1"]["library_ms"]
    check(k1_under, "K1-bwd's bf16 tensor-core kernels with a bias: not each under SDPA's forward+backward")
    return res


def host_profile(fn):
    """One call under torch.profiler's CPU activity: the host's op events,
    the casts among them (``aten::_to_copy``, what ``.to`` dispatches to)
    with the host ms inside them, and the ops' own host ms (the sum of
    their self times; the rest of the wall time is Python)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    ops = [e for e in ka if e.key.startswith("aten::")]
    casts = [e for e in ops if e.key == "aten::_to_copy"]
    return {"wall_ms": wall_ms, "ops": sum(e.count for e in ops), "casts": sum(e.count for e in casts),
            "cast_ms": sum(e.cpu_time_total for e in casts) / 1e3,
            "op_self_ms": sum(e.self_cpu_time_total for e in ops) / 1e3}


def mp_small_steps(root, seed, where):
    """Matcha-TTS's tts1 step and a VITS micro-step past
    ``dp_train_start_steps`` (no forward-sum loss), f32 against bf16
    compute, on seed-made weights at the JSUT confs' widths: MP_SMALL_ROUNDS
    rounds of MP_SMALL_TIMED steps, the two dtypes alternating within each
    round (the device-busy profile in the first round only); then one
    host-profiled step of each."""
    import statistics

    import torch

    from jatts_torch.ops import mas
    from jatts_torch.utils.config import load_config

    out = {}
    for family, conf, shape, model_type in (("matcha_tts1", MATCHA_CONF, MP_MATCHA, "MatchaTTS"),
                                            ("vits", VITS_CONF, MP_VITS, "VITS")):
        config = load_config(str(conf))
        batch = mp_batch(shape, int(config["num_mels"]), seed, pitch=False)
        if family == "vits":
            batch.pop("ds")
        trainers = {}
        for dtype_name in ("f32", "bf16"):
            tr = trainers[dtype_name] = mp_trainer(config, model_type, dtype_name, seed,
                                                   str(Path(root) / f"mp_{family}_{dtype_name}"))
            tr.steps = int(config.get("dp_train_start_steps", 0) or 0) + 1
            out[(family, dtype_name)] = {"rounds": [], "mas_launches": 0, "steps": 0}
        tbs = {d: tr.to_device(batch) for d, tr in trainers.items()}
        for r in range(MP_SMALL_ROUNDS):
            warm = MP_WARM if r == 0 else 1
            for dtype_name, tr in trainers.items():
                label = f"mixed precision, {family} {'micro-' if family == 'vits' else ''}step {dtype_name} at " \
                        f"{' x '.join(map(str, shape))}, round {r + 1} of {MP_SMALL_ROUNDS}"
                before = mas.path_launches
                res = mp_time_steps(tr, tbs[dtype_name], warm, MP_SMALL_TIMED, label, where, busy=r == 0)
                check("train/forward_sum_loss" not in tr.history[-1]
                      or tr.history[-1]["train/forward_sum_loss"] == 0.0, f"{label}: the forward-sum loss ran")
                o = out[(family, dtype_name)]
                o["mas_launches"] += mas.path_launches - before
                o["steps"] += warm + MP_SMALL_TIMED + (r == 0)
                o["rounds"].append(res)
        for dtype_name, tr in trainers.items():
            o = out[(family, dtype_name)]
            before = mas.path_launches
            o["host"] = h = host_profile(lambda: tr.train_step(tbs[dtype_name]))
            o["mas_launches"] += mas.path_launches - before
            o["steps"] += 1
            check(o["mas_launches"] == (o["steps"] if family == "vits" else 0),
                  f"{family} {dtype_name}: fused MAS search launched {o['mas_launches']} in {o['steps']} steps")
            rounds = o["rounds"]
            o.update(ms=statistics.median(x["ms"] for x in rounds), round_ms=[x["ms"] for x in rounds],
                     busy_ms=rounds[0]["busy_ms"],
                     peak_gib=max(x["peak_gib"] for x in rounds), loss0=rounds[0]["loss0"])
            print(f"mixed precision, {family} {dtype_name}: medians of the {MP_SMALL_ROUNDS} rounds "
                  + ", ".join(f"{x:.1f}" for x in o["round_ms"]) + f" ms (median {o['ms']:.1f}); device busy "
                  f"{o['busy_ms']:.1f} ms a step (round 1); peak {o['peak_gib']:.2f} GiB with both dtypes' trainers "
                  f"resident; a host-profiled step: {h['ops']} aten op events, {h['casts']} of "
                  f"them casts (aten::_to_copy) with {h['cast_ms']:.1f} ms of host time inside them, the ops' own "
                  f"host time {h['op_self_ms']:.1f} ms, wall {h['wall_ms']:.1f} ms under the profiler; {where}",
                  flush=True)
        f32, bf16 = out[(family, "f32")], out[(family, "bf16")]
        faster = [b < a for a, b in zip(f32["round_ms"], bf16["round_ms"])]
        verdict = ("bf16 faster in every round" if all(faster) else
                   "bf16 slower in every round" if not any(faster) else "unresolved: the rounds disagree")
        bf16["verdict"] = verdict
        print(f"mixed precision, {family}: bf16 against f32 step, round by round: "
              + ", ".join(f"{b:.1f} vs {a:.1f}" for a, b in zip(f32["round_ms"], bf16["round_ms"]))
              + f" ms; {verdict}; {where}", flush=True)
        l32, l16 = f32["loss0"], bf16["loss0"]
        print(f"mixed precision, {family}: first-step loss bf16 {l16:.5f} vs f32 {l32:.5f} (rel "
              f"{abs(l16 - l32) / abs(l32):.2e}, tol 2e-2)", flush=True)
        check(abs(l16 - l32) <= 2e-2 * abs(l32), f"{family}: bf16 and f32 first-step losses disagree")
        del trainers, tbs, tr
    torch.cuda.empty_cache()
    return out


def png_ok(path):
    """The PNG signature and a positive IHDR size."""
    import struct

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        return False
    w, h = struct.unpack(">II", data[16:24])
    return w > 0 and h > 0


def mp_cli_run(root, align_paths, freqs, seed, where):
    """``bin/tts_train.py`` on the JSUT conf with ``dtype: bfloat16`` and
    ``attn_backend: flash`` on phase 8's aligned corpus: 4 steps over 2 eval
    intervals, the hook's files, the event file read back by
    ``utils/events.py`` (every CRC checked) with its ``mem/*``."""
    import csv as csv_mod

    import torch

    from jatts_torch.bin import tts_train
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.utils.config import load_config
    from jatts_torch.utils.events import read_scalars

    train_csv, dev_csv, stats, tokens = write_fs2_corpus(root, align_paths, freqs, tag="mp", seed=seed)
    with open(dev_csv, encoding="utf-8") as f:
        dev_ids = [row["sample_id"] for row in csv_mod.DictReader(f)][:2]
    config = load_config(str(JSUT_CONF))
    config["model_params"] = {**config["model_params"], "dtype": "bfloat16"}
    config.update(train_max_steps=MP_CLI_STEPS, eval_interval_steps=2, log_interval_steps=2,
                  save_interval_steps=MP_CLI_STEPS, batch_size=8, num_save_intermediate_results=2,
                  eval_max_frames=1024)
    outdir = Path(root) / "mp_cli"
    k1.reset_launches()
    t0 = time.perf_counter()
    trainer = tts_train.run(train_csv, dev_csv, stats, tokens, config, str(outdir), seed=seed, device="cuda",
                            attn_backend="flash")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {n: getattr(k1, n) for n in MP_ROUTES}
    check(trainer.steps == MP_CLI_STEPS and trainer.model.compute_dtype == torch.bfloat16,
          "the bf16 CLI run: steps or compute dtype")
    check({p.dtype for p in trainer.model.parameters()} == {torch.float32}, "the bf16 CLI run: parameters not f32")
    files = {}
    for steps in (2, 4):
        d = outdir / "predictions" / f"{steps}steps"
        names = sorted(p.name for p in d.iterdir()) if d.is_dir() else []
        files[steps] = names
        want = sorted(f"{u}{s}" for u in dev_ids for s in (".png", "_dur.txt", "_pitch.png"))
        check(names == want, f"the hook at {steps} steps wrote {names}")
        check(all(png_ok(d / n) for n in names if n.endswith(".png")), f"an invalid PNG under {d}")
    scalars = read_scalars(str(outdir))
    tags = {(t, s) for s, t, _ in scalars}
    want_tags = {(t, s) for s in (2, 4) for t in ("train/loss", "train/lr", "train/grad_norm", "eval/loss",
                                                  "mem/bytes_in_use_gb", "mem/peak_bytes_gb")}
    check(want_tags <= tags, f"the event file lacks {sorted(want_tags - tags)}")
    peak = max(v for _, t, v in scalars if t == "mem/peak_bytes_gb")
    check(0.0 < peak < 80.0 and all(math.isfinite(v) for _, _, v in scalars), "the event file's values")
    check(launches["launches_tc"] > 0 and launches["launches_bwd_dkv"] > 0 and launches["launches_tc_f32"] == 0
          and launches["launches_bwd_dkv_tc_f32"] == 0, f"the bf16 CLI run's launches {launches}")
    # every dk/dv and dq on K1-bwd's bf16 tensor-core kernels with its bias, none on the scalar ones
    check((launches["launches_bwd_dkv_tc_bias"], launches["launches_bwd_dq_tc_bias"])
          == (launches["launches_bwd_dkv"], launches["launches_bwd_dq"]) and launches["launches_bwd_dkv"] > 0,
          f"the bf16 CLI run's backward launches {launches}")
    print(f"mixed precision CLI (bin/tts_train.py, JSUT conf, dtype bfloat16, flash): {MP_CLI_STEPS} steps in "
          f"{run_s:.1f} s; predictions at 2 and 4 steps: {len(files[2])} + {len(files[4])} files, PNGs valid; "
          f"event file {len(scalars)} scalars, every CRC checked, mem/peak_bytes_gb {peak:.2f}; launches "
          + ", ".join(f"{n[9:] or 'K1'} {v}" for n, v in launches.items() if v) + f"; {where}", flush=True)
    return {"run_s": run_s, "launches": launches, "scalars": len(scalars)}


def mp_bwd_entry(r, key, scalar=False):
    """A bf16 backward kernel's numbers at a phase-21 step's shape, for the
    record; ``scalar``: K1r's scalar kernels, timed beside its tensor-core
    ones."""
    ms, err = (r[f"{key}_scalar"], r["scalar_max_abs_err"]) if scalar else (r[key], r["max_abs_err"])
    return {"shape": r["shape"], "ms": ms, "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
            "bound_ms": r["bounds"][key][0], "bound_by": r["bounds"][key][1], "max_abs_err": err}


def mixed_precision_slice(root, align_paths, freqs, seed, where):
    """Phase 21 (its CLI run on phase 8's aligned corpus). Returns each
    kernel's launches in the phase, by the form that took it, and the
    numbers the record and PERF.md need."""
    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    fs2 = part("FastSpeech2 steps", mp_fs2_steps, root, seed, where)
    bwd = part("bf16 backward kernels", check_mp_bwd, seed, where)
    small = part("Matcha and VITS steps", mp_small_steps, root, seed, where)
    cli = part("bf16 CLI", mp_cli_run, root, align_paths, freqs, seed, where)
    def n(which, dtype_name, name):
        return fs2[(which, "flash", dtype_name)]["launches"][name]

    # each kernel's launches in the phase, by the form that took it
    launches = {
        "tc": n("jsut", "bf16", "launches_tc") + cli["launches"]["launches_tc"],
        "tc_relpos": n("jvs_latest", "bf16", "launches_tc"),
        "tc_f32": n("jsut", "f32", "launches_tc_f32"),
        "tc_f32_relpos": n("jvs_latest", "f32", "launches_tc_f32"),
        "bwd_scalar": fs2[("jsut", "flash", "bf16")]["scalar_bwd"],  # 0, 0: the scalar K1-bwd is off the path
        "bwd_tc_bias": (n("jsut", "bf16", "launches_bwd_dkv_tc_bias"), n("jsut", "bf16", "launches_bwd_dq_tc_bias")),
        "bwd_tc_bias_cli": (cli["launches"]["launches_bwd_dkv_tc_bias"], cli["launches"]["launches_bwd_dq_tc_bias"]),
        "bwd_scalar_relpos": fs2[("jvs_latest", "flash", "bf16")]["scalar_bwd"],
        "bwd_tc_relpos": (n("jvs_latest", "bf16", "launches_bwd_dkv_tc_relpos"),
                          n("jvs_latest", "bf16", "launches_bwd_dq_tc_relpos")),
        "bwd_tc_f32": (n("jsut", "f32", "launches_bwd_dkv_tc_f32"), n("jsut", "f32", "launches_bwd_dq_tc_f32")),
        "bwd_tc_f32_relpos": (n("jvs_latest", "f32", "launches_bwd_dkv_tc_f32"),
                              n("jvs_latest", "f32", "launches_bwd_dq_tc_f32")),
        "mas_path": sum(small[("vits", d)]["mas_launches"] for d in ("f32", "bf16")),
    }
    print(f"phase 21 (mixed precision) {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{n} {sec:.1f} s" for n, sec in parts.items()), flush=True)
    return launches, {"fs2": fs2, "bwd": bwd, "small": small, "cli": cli}


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
               k1.KERNEL_BWD_TC_RELPOS, k1.KERNEL_BWD_TC_BIAS, mas.KERNEL, mas.KERNEL_PATH]
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
                no_spill = (k1.KERNEL_TC, k1.KERNEL_TC_F32, k1.KERNEL_BWD_TC, k1.KERNEL_BWD_TC_F32,
                            k1.KERNEL_BWD_TC_RELPOS, k1.KERNEL_BWD_TC_BIAS, mas.KERNEL_PATH)
                if kernel in no_spill and spilled and int(spilled.group(1)):
                    spills.append(entry)
    # the tensor-core kernels hold their accumulators in registers, the
    # fused MAS search its chain's state: a spill there is a design fault,
    # not a slowdown to live with
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

    # 5. the fused MAS search, K2 and K3 against their plain versions
    cases = mas_cases(args.seed)
    mas_checks = [check_mas(case, lp, tl, fl) for case, (lp, tl, fl) in cases.items()]

    # 6. their times at 16x1024x128, beside the chain floor
    from jatts_torch.bin import study_mas

    floors = study_mas.floors()
    print("MAS chain floors, one warp, no memory (jatts_torch/bin/study_mas.py): " + "; ".join(
        f"{n} {c:.2f} cycles ({ns:.3f} ns) a step" for n, (c, ns) in floors.items()) + f"; {where}", flush=True)
    mas_times = time_mas(*cases["16x1024x128"], where, floors)
    del cases

    # 7. the serving slice, at the full JSUT width, bf16, K1 on
    sr, max_frames, bucket, batch = 24000, 1024, 128, 8
    torch.manual_seed(args.seed)
    fs2 = FastSpeech2(idim=64, attn_backend="flash", device="cuda", dtype=None).to(torch.bfloat16)
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
    mas_launches, own_check, mas_align_times, align_paths, freqs = aligner_slice(args.seed, where, tmp.name, floors)
    mas_checks.append(own_check)

    # 9. K1-bwd against its plain version (f32 d 192 on the 3xTF32 kernels,
    # bf16 d 192 with a bias on the bf16 tensor-core kernels, the scalar ones
    # beside on the same inputs), then its times
    bwd_err = {"tc_f32": 0.0, "tc_bias": 0.0, "scalar": 0.0}
    for (b, h, t, d), dtype_name, with_bias, rows in (
        ((32, 2, 1024, 192), "f32", True, None),   # the training decoder
        ((32, 2, 112, 192), "f32", True, None),    # the training encoder
        ((8, 2, 256, 64), "f32", True, None),
        ((8, 2, 256, 128), "f32", True, None),
        ((8, 2, 256, 256), "f32", True, None),
        ((8, 2, 1024, 192), "bf16", True, None),
        ((8, 2, 256, 256), "bf16", True, None),
        ((8, 2, 1024, 192), "f32", False, None),   # MHA form, no bias
        ((8, 2, 1000, 192), "f32", True, None),    # ragged edge
        ((8, 2, 1000, 192), "bf16", True, None),
        ((8, 2, 256, 192), "bf16", False, None),   # bf16 MHA form: the scalar kernels'
        # keys 70..680: a whole masked leading key tile (and trailing ones),
        # which dq skips and must still write d(ab) = 0 on; an odd T
        ((4, 2, 999, 192), "f32", True, [(0, 999), (70, 611), (0, 17), (0, 0)]),
        ((4, 2, 999, 192), "bf16", True, [(0, 999), (70, 611), (0, 17), (0, 0)]),
        ((2, 2, 1, 192), "bf16", True, [(0, 1), (0, 0)]),
    ):
        err, lib, scalar_err = check_k1bwd(b, h, t, d, dtype_name, with_bias, args.seed,
                                           against_autograd=(t == 1024 and b == 32), rows=rows)
        if lib == k1.KERNEL_BWD:
            bwd_err["scalar"] = max(bwd_err["scalar"], err)
        else:
            key = "tc_f32" if lib == k1.KERNEL_BWD_TC_F32 else "tc_bias"
            bwd_err[key], bwd_err["scalar"] = max(bwd_err[key], err), max(bwd_err["scalar"], scalar_err)
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

    # 15. the tts1 recipe, stages 1-4, through the port's CLIs on phase 8's corpus
    decode_tc_f32 = recipe_slice(tmp.name, align_paths, args.seed, where)

    # 16. the Matcha family: serving, then tts1 and tts2 (MAS) training on phase 8's corpus
    matcha_serve, matcha_tts1, matcha_tts2 = matcha_slice(tmp.name, align_paths, freqs, args.seed, where)
    mas_checks.append(matcha_tts2["own_check"])

    # 17. mel-VITS: serving, then tts2 training on phase 8's corpus (the
    # fused MAS search on every micro-step), then decode
    vits_serve, vits_train, vits_dec = vits_slice(tmp.name, align_paths, freqs, args.seed, where)
    mas_checks.append(vits_train["own_check"])

    # 18. the VALL-E NAR: training on phase 12's codec corpus, its attention
    # kernels (the non-causal bf16 backward on the tensor cores), then the
    # tts3 decode CLI with phase 12's AR
    nar_launches, nar = nar_slice(tmp.name, valle["corpus"], valle["outdir"], args.seed, where)

    # 19. E2-TTS: its features, CFG infill serving, frame-budget training
    # (the bf16 tensor-core forward and the non-causal backward), decode
    e2_launches, e2 = e2_slice(tmp.name, args.seed, where)

    # 20. the serving artifact: export, load with one CUDA graph a bucket,
    # replays against the eager programs, streaming, the fused VALL-E
    # program and the E2 artifact
    art_tc, art = artifact_slice(tmp.name, args.seed, where)

    # 21. mixed precision: FastSpeech2 (JSUT, JVS-latest), Matcha-TTS and
    # VITS steps in f32 and in bf16 compute side by side, the bf16 backward
    # kernels a flash step takes against their plain twins, a bf16 CLI run
    # with the intermediate hook and the event file
    mp_n, mp = mixed_precision_slice(tmp.name, align_paths, freqs, args.seed, where)
    tmp.cleanup()
    e2_tc = {"e2tts_serving": e2_launches["serve_tc"], "e2tts_training": e2_launches["train"]["k1.launches_tc"],
             "e2tts_decode": e2_launches["decode_tc"]}
    e2_times = e2["train"]["times"]
    # K2, K3, pair, fused path, fused bits: differing elements over every
    # case and the run's own lattice; K2, K3, fused: the largest |kernel -
    # twin| seen there
    mas_mismatches = [sum(counts[i] for counts, _, _ in mas_checks) for i in range(5)]
    mas_max_err = [max(errs[i] for _, errs, _ in mas_checks) for i in range(3)]
    mas_routes = sorted({r for _, _, routes in mas_checks for r in routes})

    mas_row = {"route": "cuda", "source": "jatts_torch/csrc/mas_viterbi.cu",
               "bound_by": "bytes", "library_ms": None}
    bwd_row = {"route": "cuda", "source": "jatts_torch/csrc/flash_attn_bwd.cu",
               "max_abs_err": bwd_err["scalar"], "plain_ms": bwd_times["plain_ms"],
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
        "launches": train["fwd_tc_f32"] + decode_tc_f32 + mp_n["tc_f32"],
        "launches_by_path": {"training": train["fwd_tc_f32"], "decode": decode_tc_f32,
                             "mixed_precision_f32_steps": mp_n["tc_f32"]},
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
        "launches": jvs["fwd_tc_f32"] + mp_n["tc_f32_relpos"],
        "launches_by_path": {"training": jvs["fwd_tc_f32"], "mixed_precision_f32_steps": mp_n["tc_f32_relpos"]},
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
        # the served programs' launches (phase 20) are their graphs' replays:
        # launches a replay times replays
        "launches": serve_tc + nar_launches["k1.launches_tc"] + sum(e2_tc.values()) + sum(art_tc.values())
        + mp_n["tc"],
        "launches_by_path": {"serving": serve_tc, "valle_nar_training": nar_launches["k1.launches_tc"], **e2_tc,
                             **art_tc, "mixed_precision_bf16_steps": mp_n["tc"]},
        "max_abs_err": max(max_err["bf16"], tc_err["k1"], e2["train"]["errs"]["fwd"], e2["serve"]["fwd"]["max_abs_err"],
                           e2["decode"]["fwd"]["max_abs_err"]),
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
        # the VALL-E NAR's training forward (d 64, a key mask), timed at its largest batch
        "valle_nar": {"shape": list(nar["times"]["shape"]), "ms": nar["times"]["fwd"],
                      "graph_ms": nar["times"]["fwd_graph"], "plain_ms": nar["times"]["plain_fwd_ms"],
                      "bound_ms": nar["times"]["bounds"]["fwd"][0], "bound_by": nar["times"]["bounds"]["fwd"][1],
                      "library_ms": nar["times"]["sdpa_fwd_ms"], "max_abs_err": nar["errs"]["fwd"]},
        # E2-TTS's forward (d 64, a key mask): its training forward at the
        # run's largest batch (lse written, every key valid), its served CFG
        # batch and a decode row at the capacity of 3001 (no lse, the keys of
        # each row's duration valid: the kernel skips a key tile with none)
        "e2tts": {
            "training": {"shape": list(e2_times["shape"]), "ms": e2_times["fwd"], "graph_ms": e2_times["fwd_graph"],
                         "plain_ms": e2_times["plain_fwd_ms"], "bound_ms": e2_times["bounds"]["fwd"][0],
                         "bound_by": e2_times["bounds"]["fwd"][1], "library_ms": e2_times["sdpa_fwd_ms"],
                         "max_abs_err": e2["train"]["errs"]["fwd"]},
            **{path: {"shape": t_["shape"], "valid_keys": t_["valid"], "ms": t_["ms"], "graph_ms": t_["graph_ms"],
                      "plain_ms": t_["plain_ms"], "bound_ms": t_["bound"][0], "bound_by": t_["bound"][1],
                      "library_ms": t_["library_ms"], "library_backend": t_["library_backend"],
                      "max_abs_err": t_["max_abs_err"]}
               for path, t_ in (("serving", e2["serve"]["fwd"]), ("decode", e2["decode"]["fwd"]))},
        },
    }, {
        "name": f"{k1.KERNEL_TC}_relpos",
        "route": "cuda",
        "source": "jatts_torch/csrc/flash_attn_fwd_tc.cu",
        "replaces": "jatts_tpu/modules/attention.py:372",
        "launches": jvs_serve_launches + mp_n["tc_relpos"],
        "launches_by_path": {"serving": jvs_serve_launches, "mixed_precision_bf16_steps": mp_n["tc_relpos"]},
        "max_abs_err": max(k1r_fwd_err["bf16"], tc_err["k1r"]),
        "ms": k1r_times["serve"]["fwd"],
        "plain_ms": k1r_times["serve"]["plain_fwd_ms"],
        "bound_ms": k1r_times["serve"]["bound"][0],
        "bound_by": k1r_times["serve"]["bound"][1],
        "library_ms": k1r_times["serve"]["sdpa_fwd_ms"],
        "graph_ms": k1r_times["serve"]["graph_ms"],
        "library_graph_ms": k1r_times["serve"]["sdpa_graph_ms"],
    }] + [{
        # K1-bwd's scalar kernels: the JSUT training form (f32, d 192, a bias)
        # is the 3xTF32 kernels'; timed beside them on the same inputs
        "name": f"flash_attn_bwd_{key}",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": n - n_tc + n_mp, "launches_by_path": {"training": n - n_tc, "mixed_precision_bf16_steps": n_mp},
        "ms": bwd_times[f"{key}_scalar"], "bound_ms": bwd_times["bounds"][key][0],
        "bound_by": bwd_times["bounds"][key][1], "cuda_core_bound_ms": cuda_core_ms(bwd_times["bounds"][key][3]),
        **bwd_row,
        # the bf16 form with the matrix_bd bias that a bf16 flash step took before its tensor-core kernels
        # (phase 21), timed beside them at the step's shape
        "bf16_step": mp_bwd_entry(mp["bwd"]["k1"], key, scalar=True),
    } for key, line, n, n_tc, n_mp in (
        ("dkv", 1121, train_launches[1], train["bwd_tc_f32"][0], mp_n["bwd_scalar"][0]),
        ("dq", 1456, train_launches[2], train["bwd_tc_f32"][1], mp_n["bwd_scalar"][1]))] + [{
        # K1-bwd's f32 dk/dv and dq (d 192, a bias, d(ab)) on the tensor cores
        # (3xTF32), JSUT training
        "name": f"{k1.KERNEL_BWD_TC_F32}_{key}_bias", "route": "cuda",
        "source": f"jatts_torch/csrc/{k1.KERNEL_BWD_TC_F32}.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": n + n_mp, "launches_by_path": {"training": n, "mixed_precision_f32_steps": n_mp},
        "max_abs_err": bwd_err["tc_f32"],
        "ms": bwd_times[key], "graph_ms": bwd_times[f"{key}_graph"], "scalar_ms": bwd_times[f"{key}_scalar"],
        "plain_ms": bwd_times["plain_ms"], "bound_ms": bwd_times["bounds"][key][0],
        "bound_by": bwd_times["bounds"][key][1], "cuda_core_bound_ms": cuda_core_ms(bwd_times["bounds"][key][3]),
        "library_ms": bwd_times["library_ms"],
    } for key, line, n, n_mp in (("dkv", 1121, train["bwd_tc_f32"][0], mp_n["bwd_tc_f32"][0]),
                                 ("dq", 1456, train["bwd_tc_f32"][1], mp_n["bwd_tc_f32"][1]))] + [{
        # off the main path since the fused search; timed at 16x1024x128
        "name": "mas_fwd", "replaces": "jatts_tpu/ops/mas_pallas.py:139", "launches": mas_launches[1],
        "mismatches": mas_mismatches[0] + mas_mismatches[2], "max_abs_err": mas_max_err[0],
        "ms": mas_times["k2_ms"], "plain_ms": mas_times["k2_plain"], "bound_ms": mas_times["k2_bound"], **mas_row,
    }, {
        "name": "mas_backtrace", "replaces": "jatts_tpu/ops/mas_pallas.py:161", "launches": mas_launches[2],
        "mismatches": mas_mismatches[1] + mas_mismatches[2], "max_abs_err": mas_max_err[1],
        "ms": mas_times["k3_ms"], "plain_ms": mas_times["k3_plain"], "bound_ms": mas_times["k3_bound"], **mas_row,
    }, {
        # K2 and K3 in one launch, the aligner's and Matcha-MAS training's
        # search; timed at 16x1024x128 (``aligner``: at the aligner run's
        # largest batch; ``matcha_mas_training``: at that run's largest)
        "name": "mas_path", "route": "cuda", "source": "jatts_torch/csrc/mas_path.cu",
        "replaces": "jatts_tpu/ops/mas_pallas.py:139", "replaces_also": "jatts_tpu/ops/mas_pallas.py:161",
        "launches": mas_launches[0] + matcha_tts2["launches"] + vits_train["launches"] + mp_n["mas_path"],
        "launches_by_path": {"aligner": mas_launches[0], "matcha_mas_training": matcha_tts2["launches"],
                             "vits_training": vits_train["launches"], "mixed_precision_vits_steps": mp_n["mas_path"]},
        "mismatches": mas_mismatches[3] + mas_mismatches[4], "max_abs_err": mas_max_err[2], "routes": mas_routes,
        "ms": mas_times["ms"], "graph_ms": mas_times["graph_ms"], "pair_ms": mas_times["pair_ms"],
        "pair_graph_ms": mas_times["pair_graph_ms"], "plain_ms": mas_times["plain_ms"],
        "bound_ms": mas_times["bound_ms"], "bound_by": "bytes", "chain_floor_ms": mas_times["chain_floor_ms"],
        "library_ms": None,
        "aligner": {k: mas_align_times[k] for k in ("ms", "graph_ms", "pair_ms", "pair_graph_ms", "plain_ms",
                                                     "bound_ms", "chain_floor_ms")},
        "matcha_mas_training": {"ms": matcha_tts2["mas_ms"], "step_device_ms": matcha_tts2["mas_dev_ms"],
                                "step_ms": matcha_tts2["step_ms"]},
        "vits_training": {"ms": vits_train["mas_ms"], "step_device_ms": vits_train["mas_dev_ms"],
                          "micro_step_ms": vits_train["step_late_ms"], "share": vits_train["mas_share"],
                          "shape": list(vits_train["shape"]), "micro_steps_checked": vits_train["searched"]["calls"],
                          "frames_differing": vits_train["searched"]["differ"]},
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
        "launches": n_serve + n_train + n_mp,
        "launches_by_path": {"serving": n_serve, "training": n_train, "mixed_precision_bf16_steps": n_mp},
        "max_abs_err": err, "ms": k1r_times[f"{key}_scalar"],
        "plain_ms": k1r_times["plain_fwd_ms" if key == "fwd" else "plain_bwd_ms"],
        "bound_ms": k1r_times["bounds"][key][0], "bound_by": k1r_times["bounds"][key][1],
        "cuda_core_bound_ms": cuda_core_ms(k1r_times["bounds"][key][3]),
        "library_ms": k1r_times["sdpa_fwd_ms" if key == "fwd" else "sdpa_ms"],
        **({} if key == "fwd" else {"bf16_step": mp_bwd_entry(mp["bwd"]["k1r"], key, scalar=True)}),
    } for name, src, line, key, n_serve, n_train, err, n_mp in (
        # the scalar K1r forward, dk/dv and dq no longer run on the main path:
        # the bf16 forward is the tensor-core kernel's, the bf16 backward the
        # bf16 tensor-core kernels', f32 the 3xTF32 kernels'; timed beside
        # them on the same inputs
        ("flash_attn_fwd", "flash_attn_fwd.cu", 758, "fwd", 0, jvs_launches[0] - jvs["fwd_tc_f32"],
         tc_f32_err["scalar_k1r"], 0),
        ("flash_attn_bwd_dkv", "flash_attn_bwd.cu", 1121, "dkv", 0, jvs_launches[1] - jvs["bwd_tc_f32"][0],
         k1r_bwd_err["scalar"], mp_n["bwd_scalar_relpos"][0]),
        ("flash_attn_bwd_dq", "flash_attn_bwd.cu", 1456, "dq", 0, jvs_launches[2] - jvs["bwd_tc_f32"][1],
         k1r_bwd_err["scalar"], mp_n["bwd_scalar_relpos"][1]),
    )] + [{
        # K1r's f32 dk/dv and dq on the tensor cores (3xTF32), JVS-latest training
        "name": f"{k1.KERNEL_BWD_TC_F32}_{key}", "route": "cuda",
        "source": f"jatts_torch/csrc/{k1.KERNEL_BWD_TC_F32}.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": n + n_mp, "launches_by_path": {"training": n, "mixed_precision_f32_steps": n_mp},
        "max_abs_err": k1r_bwd_err["tc_f32"],
        "ms": k1r_times[key], "graph_ms": k1r_times[f"{key}_graph"], "scalar_ms": k1r_times[f"{key}_scalar"],
        "plain_ms": k1r_times["plain_bwd_ms"], "bound_ms": k1r_times["bounds"][key][0],
        "bound_by": k1r_times["bounds"][key][1], "cuda_core_bound_ms": cuda_core_ms(k1r_times["bounds"][key][3]),
        "library_ms": k1r_times["sdpa_ms"], "library_backend": k1r_times["sdpa_backend"],
    } for key, line, n, n_mp in (("dkv", 1121, jvs["bwd_tc_f32"][0], mp_n["bwd_tc_f32_relpos"][0]),
                                 ("dq", 1456, jvs["bwd_tc_f32"][1], mp_n["bwd_tc_f32_relpos"][1]))] + [{
        # K1r's bf16 dk/dv and dq on the tensor cores, the bf16-compute
        # JVS-latest flash step's (phase 21); timed at its shape with every
        # key valid, the scalar kernels (the form's before) on the same inputs
        "name": f"{k1.KERNEL_BWD_TC_RELPOS}_{key}", "route": "cuda",
        "source": f"jatts_torch/csrc/{k1.KERNEL_BWD_TC_RELPOS}.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": n_mp, "launches_by_path": {"mixed_precision_bf16_steps": n_mp},
        "max_abs_err": max(k1r_bwd_err["tc_relpos"], r_mp["max_abs_err"]), "ms": r_mp[key],
        "graph_ms": r_mp[f"{key}_graph"], "scalar_ms": r_mp[f"{key}_scalar"],
        "scalar_max_abs_err": r_mp["scalar_max_abs_err"], "plain_ms": r_mp["plain_ms"],
        "bound_ms": r_mp["bounds"][key][0], "bound_by": r_mp["bounds"][key][1], "library_ms": r_mp["library_ms"],
        "shape": r_mp["shape"],
    } for key, line, n_mp, r_mp in (("dkv", 1121, mp_n["bwd_tc_relpos"][0], mp["bwd"]["k1r"]),
                                    ("dq", 1456, mp_n["bwd_tc_relpos"][1], mp["bwd"]["k1r"]))] + [{
        # K1-bwd's bf16 dk/dv and dq/d(ab) with the matrix_bd bias at d 192 on
        # the tensor cores, the bf16-compute JSUT flash step's (phase 21);
        # timed at its decoder shape with every key valid, the scalar kernels
        # (the form's before) on the same inputs beside
        "name": f"{k1.KERNEL_BWD_TC_BIAS}_{key}", "route": "cuda",
        "source": f"jatts_torch/csrc/{k1.KERNEL_BWD_TC_BIAS}.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": n_mp + n_cli,
        "launches_by_path": {"mixed_precision_bf16_steps": n_mp, "mixed_precision_cli": n_cli},
        "max_abs_err": max(bwd_err["tc_bias"], r_mp["max_abs_err"]), "ms": r_mp[key],
        "graph_ms": r_mp[f"{key}_graph"], "scalar_ms": r_mp[f"{key}_scalar"],
        "scalar_max_abs_err": r_mp["scalar_max_abs_err"], "plain_ms": r_mp["plain_ms"],
        "bound_ms": r_mp["bounds"][key][0], "bound_by": r_mp["bounds"][key][1], "library_ms": r_mp["library_ms"],
        "shape": r_mp["shape"],
    } for key, line, n_mp, n_cli, r_mp in (
        ("dkv", 1121, mp_n["bwd_tc_bias"][0], mp_n["bwd_tc_bias_cli"][0], mp["bwd"]["k1"]),
        ("dq", 1456, mp_n["bwd_tc_bias"][1], mp_n["bwd_tc_bias_cli"][1], mp["bwd"]["k1"]))] + [{
        # the VALL-E NAR's bf16 non-causal dk/dv and dq (d 64, a key mask) on
        # the tensor cores; timed at its largest batch with every key valid,
        # the scalar kernels (the form's before) on the same inputs beside
        "name": f"flash_attn_bwd_{key}_tc_noncausal", "route": "cuda",
        "source": "jatts_torch/csrc/flash_attn_bwd_tc.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
        "launches": nar_launches[f"k1.launches_bwd_{key}_tc_noncausal"]
        + e2_launches["train"][f"k1.launches_bwd_{key}_tc_noncausal"],
        "launches_by_path": {"valle_nar_training": nar_launches[f"k1.launches_bwd_{key}_tc_noncausal"],
                             "e2tts_training": e2_launches["train"][f"k1.launches_bwd_{key}_tc_noncausal"]},
        "max_abs_err": max(nar["errs"][key], e2["train"]["errs"][key]), "ms": nar["times"][key],
        "graph_ms": nar["times"][f"{key}_graph"],
        "scalar_ms": nar["times"][f"{key}_scalar"], "scalar_max_abs_err": nar["errs"]["scalar"],
        "plain_ms": nar["times"]["plain_bwd_ms"], "bound_ms": nar["times"]["bounds"][key][0],
        "bound_by": nar["times"]["bounds"][key][1], "library_ms": nar["times"]["sdpa_ms"],
        "library_backend": nar["times"]["sdpa_backend"], "shape": list(nar["times"]["shape"]),
        # E2-TTS's training backward at its largest batch, every key valid
        "e2tts": {"shape": list(e2_times["shape"]), "ms": e2_times[key], "graph_ms": e2_times[f"{key}_graph"],
                  "scalar_ms": e2_times[f"{key}_scalar"], "plain_ms": e2_times["plain_bwd_ms"],
                  "bound_ms": e2_times["bounds"][key][0], "bound_by": e2_times["bounds"][key][1],
                  "library_ms": e2_times["sdpa_ms"], "library_backend": e2_times["sdpa_backend"],
                  "max_abs_err": e2["train"]["errs"][key]},
    } for key, line in (("dkv", 1121), ("dq", 1456))]}
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
