"""Time variants of K1r's f32 tensor-core backward (``csrc/flash_attn_bwd_tc_f32.cu``)
on the card, in turns, at the JVS-latest training decoder's shape (B, H, T =
32, 2, 1024, d_qk 576, d_v 192, every key valid):

    python -m jatts_torch.bin.study_bwd_tc_f32 [--variants final,stamps,...] [--grads]

Each variant is the source (with the shared header ``csrc/tc_f32_common.cuh``)
with one change, built by ``nvcc`` (all at once) into its own library under the
git-ignored ``build/study_bwd/`` (``bin/study_fwd_tc_f32.py``'s machinery):

- ``final``: the source as it stands;
- ``hi_hi_only``: one TF32 product of the three, a third of the tensor-core
  work;
- ``no_split``: the split warps do no work, so the products read stale
  buffers;
- ``no_frag_split``: the fragments split on the consumers (X's and the output
  product's A) not split (hi = x, lo = 0);
- ``ring<R>_split<N>``: R raw ring slabs and N split buffers instead of the
  source's (the same bits);
- ``stamps``: consumer thread 0 reads ``%clock`` at the phase boundaries of
  every tile and sums each phase's cycles; the blocks of the first cluster
  of (b, h) 0 write the sums over their own output at row 0, columns 8i,
  and the script prints them per tile: the wait for the resident X (once),
  the partial product, the push, the wait for the peers' partials, the
  sums and p / ds, the output product.

With ``--grads`` it also measures what the kernels do to a training
gradient: a 4-block conformer with the latest rel-pos attention at the JVS
width (adim 384, 2 heads, seed-made weights and inputs, batch 24 x 896 with
ragged key masks), its parameter gradients under ``attn_backend`` flash with
the 3xTF32 backward and with the scalar backward, each against ``xla`` (the
eager path), as ``chip_smoke.py``'s flash-vs-xla step measures them.

``hi_hi_only``, ``no_split``, ``no_frag_split`` and ``stamps`` are wrong by design: they say where the time goes, and the
script checks nothing but that every variant launches. It prints the card's
name and power limit, each variant's ms for the dk/dv and the dq kernel (the
least of 3 rounds of 10 launches, variants in turns) and whether its outputs
have the bits of ``final``'s.
"""

from __future__ import annotations

import re
import subprocess

from jatts_torch.bin.study_fwd_tc_f32 import HEADER, _on, _sub, build_variants, sources

SOURCE = "flash_attn_bwd_tc_f32.cu"
SHAPE = (32, 2, 1024)
DIMS = (576, 192)
SYMBOLS = ("jatts_flash_attn_bwd_dkv_tc_f32", "jatts_flash_attn_bwd_dq_tc_f32")


def _hi_hi_only(src):
    src = _sub(src, "        wgmma_tf32(tmp, xa[kk][0], xa[kk][1], xa[kk][2], xa[kk][3], b_lo + 2 * kk, kk != 0);\n"
                    "        wgmma_tf32(tmp, xa[kk][4], xa[kk][5], xa[kk][6], xa[kk][7], b_hi + 2 * kk, 1);\n", "")
    return _sub(src, "wgmma_tf32(tmp, xa[kk][0], xa[kk][1], xa[kk][2], xa[kk][3], b_hi + 2 * kk, 1);",
                "wgmma_tf32(tmp, xa[kk][0], xa[kk][1], xa[kk][2], xa[kk][3], b_hi + 2 * kk, kk != 0);")


def _hi_hi_only_header(src):
    return _sub(src, "  wgmma_tf32(d, a[0], a[1], a[2], a[3], b_lo, accumulate);\n"
                     "  wgmma_tf32(d, a[4], a[5], a[6], a[7], b_hi, 1);\n"
                     "  wgmma_tf32(d, a[0], a[1], a[2], a[3], b_hi, 1);",
                "  wgmma_tf32(d, a[0], a[1], a[2], a[3], b_hi, accumulate);")


def _no_split(src):
    src = _sub(src, "for (int f = st; f < FSLAB / 16; f += NSPLITTERS) {", "for (int f = st; f < 0; f += NSPLITTERS) {")
    return _sub(src, "for (int c = st; c < FSLAB / 16; c += NSPLITTERS) {", "for (int c = st; c < 0; c += NSPLITTERS) {")


def _no_frag_split(src):
    src = _sub(src, "split_tf32(*reinterpret_cast<const float*>(xs + o0), xa[kk][0], xa[kk][4]);",
               "xa[kk][0] = __float_as_uint(*reinterpret_cast<const float*>(xs + o0)), xa[kk][4] = 0u;")
    src = _sub(src, "split_tf32(*reinterpret_cast<const float*>(xs + 1024 + o0), xa[kk][1], xa[kk][5]);",
               "xa[kk][1] = __float_as_uint(*reinterpret_cast<const float*>(xs + 1024 + o0)), xa[kk][5] = 0u;")
    src = _sub(src, "split_tf32(*reinterpret_cast<const float*>(xs + o1), xa[kk][2], xa[kk][6]);",
               "xa[kk][2] = __float_as_uint(*reinterpret_cast<const float*>(xs + o1)), xa[kk][6] = 0u;")
    src = _sub(src, "split_tf32(*reinterpret_cast<const float*>(xs + 1024 + o1), xa[kk][3], xa[kk][7]);",
               "xa[kk][3] = __float_as_uint(*reinterpret_cast<const float*>(xs + 1024 + o1)), xa[kk][7] = 0u;")
    for j, (hi, lo) in zip((0, 2, 1, 3), ((0, 4), (1, 5), (2, 6), (3, 7))):
        src = _sub(src, f"split_tf32(a[i + {j}], pa[kk][{hi}], pa[kk][{lo}]);",
                   f"pa[kk][{hi}] = __float_as_uint(a[i + {j}]), pa[kk][{lo}] = 0u;")
    return src


def _depths(ring, nsb):
    def change(src):
        src = re.sub(r"constexpr int R_B = \d+;", f"constexpr int R_B = {ring};", src)
        return re.sub(r"constexpr int NSB_B = \d+;", f"constexpr int NSB_B = {nsb};", src)

    return _on(SOURCE, change)


STAMPED = ("x wait", "partial", "push", "peer wait", "sum p ds", "output")


def _stamps(src):
    """%clock stamps between the consumer's phases (``STAMPED``)."""
    stamp = ("{ if (threadIdx.x == 0) { uint32_t c_; asm volatile(\"mov.u32 %0, %%clock;\" : \"=r\"(c_)); "
             "st_[@] += c_ - st_[7]; st_[7] = c_; } }\n")
    src = _sub(src, "  uint8_t* sX = base;", "  __shared__ uint32_t st_[8];\n  uint8_t* sX = base;")
    src = _sub(src, "    mbar_wait(&ctl.x_full, 0);\n",
               "    if (threadIdx.x == 0) { for (int i_ = 0; i_ < 7; ++i_) st_[i_] = 0; "
               "asm volatile(\"mov.u32 %0, %%clock;\" : \"=r\"(st_[7])); }\n"
               "    mbar_wait(&ctl.x_full, 0);\n    " + stamp.replace("@", "0"))
    src = _sub(src, "      mbar_arrive(&ctl.freed[held]);\n\n      // push",
               "      mbar_arrive(&ctl.freed[held]);\n      " + stamp.replace("@", "1") + "\n      // push")
    src = _sub(src, "      if constexpr (OUT) {", "      " + stamp.replace("@", "2") + "      if constexpr (OUT) {")
    src = _sub(src, "        mbar_wait_cluster(&ctl.xfull, tx & 1);\n",
               "        mbar_wait_cluster(&ctl.xfull, tx & 1);\n        " + stamp.replace("@", "3"))
    src = _sub(src, "        // the output product, one 32-row half", "        " + stamp.replace("@", "4")
               + "        // the output product, one 32-row half")
    src = _sub(src, "      ++tx;\n    }\n", "      " + stamp.replace("@", "5") + "      ++tx;\n    }\n")
    return _sub(src, "            make_float2(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);\n  }\n}\n",
                "            make_float2(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);\n  }\n"
                "  if (threadIdx.x == 0 && bh == 0 && tile == 0 && row_any)\n"
                "    for (int i_ = 0; i_ < 6; ++i_) out[col0 + 8 * i_] = (float)st_[i_];\n}\n")


DEPTHS = ((2, 4), (4, 3), (6, 4), (8, 3), (8, 4))
VARIANTS = {"final": lambda f: f,
            "hi_hi_only": lambda f: _on(HEADER, _hi_hi_only_header)(_on(SOURCE, _hi_hi_only)(f)),
            "no_split": _on(SOURCE, _no_split), "no_frag_split": _on(SOURCE, _no_frag_split),
            **{f"ring{r}_split{n}": _depths(r, n) for r, n in DEPTHS}, "stamps": _on(SOURCE, _stamps)}


def flash_vs_xla_grads():
    """|g_flash - g_xla| / |g_xla| over a conformer's parameter gradients,
    the flash backward on the 3xTF32 kernels and on the scalar ones."""
    import math

    import torch

    from jatts_torch.modules.conformer import ConformerEncoder
    from jatts_torch.ops import flash_attention as k1
    from jatts_torch.ops.masks import attn_mask

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    cfg = dict(attention_dim=384, attention_heads=2, linear_units=1536, num_blocks=4, input_layer=None,
               pos_enc_layer_type="rel_pos", selfattention_layer_type="rel_selfattn", cnn_module_kernel=31,
               dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0)
    mods = {backend: ConformerEncoder(attn_backend=backend, **cfg).cuda() for backend in ("flash", "xla")}
    mods["xla"].load_state_dict(mods["flash"].state_dict())
    b, t = 24, 896
    g = torch.Generator(device="cuda").manual_seed(1)
    xs = torch.randn(b, t, 384, device="cuda", generator=g)
    r = torch.randn(b, t, 384, device="cuda", generator=g)
    lens = torch.randint(400, t + 1, (b,), device="cuda", generator=g)
    lens[0] = t
    mask = attn_mask(lens, t)

    def grads(backend, lib=None):
        rule = (k1.dkv_kernel, k1.dq_kernel)
        if lib is not None:  # the study's comparison only: the port has no such switch
            k1.dkv_kernel = k1.dq_kernel = lambda *a: lib
        try:
            k1.reset_launches()
            m = mods[backend]
            gs = torch.autograd.grad((m(xs, mask) * r).sum(), list(m.parameters()))
            torch.cuda.synchronize()
            return gs, (k1.launches_bwd_dkv_tc_f32, k1.launches_bwd_dkv_relpos)
        finally:
            k1.dkv_kernel, k1.dq_kernel = rule

    gx, _ = grads("xla")
    norm = math.sqrt(sum(float(x.double().pow(2).sum()) for x in gx))
    for name, lib in (("3xTF32", None), ("scalar", k1.KERNEL_BWD)):
        gf, n = grads("flash", lib)
        diff = math.sqrt(sum(float((a - c).double().pow(2).sum()) for a, c in zip(gf, gx)))
        print(f"conformer 4 x latest rel-pos, adim 384, batch {b} x {t}: flash ({name} backward; dk/dv launches on "
              f"the 3xTF32 kernel, K1r in all {n}) vs xla: |g_flash - g_xla| / |g_xla| {diff / norm:.2e}", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    from jatts_torch.ops import flash_attention as k1

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names (final is always run)")
    ap.add_argument("--grads", action="store_true", help="also flash against xla on a conformer's gradients")
    args = ap.parse_args(argv)
    names = ["final"] + [n for n in args.variants.split(",") if n != "final"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"study_bwd_tc_f32: unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("study_bwd_tc_f32: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build_variants({n: VARIANTS[n] for n in names}, SOURCE, sources((SOURCE, HEADER)), SYMBOLS, n_pointers=10, study="study_bwd")
    b, h, t = SHAPE
    d_qk, d_v = DIMS
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k = (torch.randn(b, h, t, d_qk, device="cuda", generator=g) for _ in range(2))
    v, do = (torch.randn(b, h, t, d_v, device="cuda", generator=g) for _ in range(2))
    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
    scale = d_v ** -0.5
    o, lse = k1.flash_attention_fwd(q, k, v, None, mask, scale)
    di = (o * do).sum(-1)
    outs = {"dkv": (torch.empty_like(k), torch.empty_like(v)), "dq": (torch.empty_like(q), None)}
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, kind):
        a, b_ = outs[kind]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, mask.data_ptr(), lse.data_ptr(), di.data_ptr(),
                do.data_ptr(), a.data_ptr(), None if b_ is None else b_.data_ptr(), b, h, t, t, d_qk, d_v, 0, 0,
                scale, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    for kind, symbol in zip(("dkv", "dq"), SYMBOLS):
        bits = {}
        for name, f in fns.items():
            call(f[symbol], kind)
            torch.cuda.synchronize()
            bits[name] = torch.cat([x.flatten() for x in outs[kind] if x is not None]).clone()
        times = {name: [] for name in fns}
        for _ in range(3):
            for name, f in fns.items():
                call(f[symbol], kind)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(f[symbol], kind)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 10)
        print(f"K1r {kind} f32 {b},{h},{t} {d_qk}/{d_v}: " + "; ".join(
            f"{name} {min(ms):.4f} ms ({', '.join(f'{x:.4f}' for x in ms)}; bits of final: "
            f"{bool(torch.equal(bits[name], bits['final']))})" for name, ms in times.items()), flush=True)
        if "stamps" not in fns:
            continue
        call(fns["stamps"][symbol], kind)
        torch.cuda.synchronize()
        tiles = t // 64
        rows = [(f"score block {r}", outs[kind][0][0, 0, 0, 192 * r:192 * r + 48:8]) for r in range(d_qk // 192)]
        if kind == "dkv":
            rows.append(("dp block", outs[kind][1][0, 0, 0, 0:48:8]))
        for label, cyc in rows:
            print(f"  stamps {kind} {label}, cycles a tile (of {tiles}): " + ", ".join(
                f"{n} {c / (1 if n == 'x wait' else tiles):.0f}" for n, c in zip(STAMPED, cyc.tolist())), flush=True)
    if args.grads:
        flash_vs_xla_grads()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
