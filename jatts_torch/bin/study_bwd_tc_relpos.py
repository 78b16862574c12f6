"""Time variants of K1r's bf16 backward on the tensor cores
(``csrc/flash_attn_bwd_tc_relpos.cu``) on the card, in turns, at a bf16-compute
JVS-latest training step's attention (B, H, T = 24, 2, 896, every key valid):

    python -m jatts_torch.bin.study_bwd_tc_relpos [--variants final,stamps,...] [--forms k1r,small]

Each variant is the source with one change, built by ``nvcc`` (all at once)
into its own library under the git-ignored ``build/study_bwd_relpos/``
(``bin/study_fwd_tc_f32.py``'s machinery):

- ``final``: the source as it stands;
- ``ring1``: one ring stage instead of the source's two (the same bits;
  three do not fit in shared memory);
- ``ack_late``: each block acknowledges its peers' partials after its output
  products, as the f32 kernel does, not before them (the same bits);
- ``stamps``: the source with ``RELPOS_STAMPS`` defined: consumer thread 0
  of every block reads ``%clock`` at the phase boundaries of every tile and
  sums each phase's cycles; the blocks of the first cluster of (b, h) 0
  write the sums over their own output at row 0, columns 8i (in bf16: three
  significant digits), and the script prints them per tile: the wait for the
  resident X (once), the wait for the tile's stage, the partial product, the
  push (with the wait for the previous tile's acknowledgements; dp's product
  runs meanwhile), the wait for the peers' partials, the sums and the
  acknowledgements, p and ds (with the wait for dp, and dk/dv's issue of
  dV's product), the output products, the stage's release and the loop.

``stamps`` is wrong by design (its stamps overwrite outputs). The script checks
nothing but that every variant launches. It prints the card's name and power
limit, each variant's ms for the dk/dv and the dq kernel (the least of 3 rounds
of 10 launches, variants in turns) and whether its outputs have the bits of
``final``'s.
"""

from __future__ import annotations

import re
import subprocess

from jatts_torch.bin.study_fwd_tc_f32 import _on, _sub, build_variants, sources

SOURCE = "flash_attn_bwd_tc_relpos.cu"
SHAPE = (24, 2, 896)
FORMS = {"k1r": (576, 192), "small": (192, 64)}  # name -> (d_qk, d_v)
SYMBOLS = ("jatts_flash_attn_bwd_dkv_tc_relpos", "jatts_flash_attn_bwd_dq_tc_relpos")
STAMPED = ("x wait", "stage wait", "partial", "push", "peer wait", "sums ack", "p ds", "output", "release")

ACK = """        consumer_sync();
        if (tid == 0)
          for (int j = 0; j < NQ; ++j)
            if (j != role) st_async_ack(peer_addr(smem_u32(&ctl.ack), j), peer_addr(smem_u32(&ctl.xempty), j));
"""


def _ring(n):
    return _on(SOURCE, lambda src: re.sub(r"constexpr int R_S = \d+;", f"constexpr int R_S = {n};", src))


def _ack_late(src):
    src = _sub(src, ACK, "")
    return _sub(src, "      fence_frag(da);\n", "      fence_frag(da);\n      if constexpr (NQ > 1) {\n" + ACK + "      }\n")


def _stamps(src):
    return _sub(src, '#include "tc_cluster.cuh"\n', '#define RELPOS_STAMPS\n#include "tc_cluster.cuh"\n')


VARIANTS = {"final": lambda f: f, "ring1": _ring(1), "ack_late": _on(SOURCE, _ack_late),
            "stamps": _on(SOURCE, _stamps)}


def study_form(fns, form):
    """Every variant of ``fns`` at one form of ``FORMS``: dk/dv, then dq."""
    import torch

    from jatts_torch.ops import flash_attention as k1

    d_qk, d_v = FORMS[form]
    b, h, t = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k = (torch.randn(b, h, t, d_qk, device="cuda", generator=g).bfloat16() for _ in range(2))
    v, do = (torch.randn(b, h, t, d_v, device="cuda", generator=g).bfloat16() for _ in range(2))
    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
    scale = d_v ** -0.5
    o, lse = k1.flash_attention_fwd(q, k, v, None, mask, scale)
    di = (o.float() * do.float()).sum(-1)
    outs = {"dkv": (torch.empty_like(k), torch.empty_like(v)), "dq": (torch.empty_like(q), None)}
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, kind):
        a, b_ = outs[kind]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, mask.data_ptr(), lse.data_ptr(), di.data_ptr(),
                do.data_ptr(), a.data_ptr(), k1._ptr(b_), b, h, t, t, d_qk, d_v, 1, 0, scale, stream)
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
        print(f"{form} {kind} bf16 {b},{h},{t} {d_qk}/{d_v}: " + "; ".join(
            f"{name} {min(ms):.4f} ms ({', '.join(f'{x:.4f}' for x in ms)}; bits of final: "
            f"{bool(torch.equal(bits[name], bits['final']))})" for name, ms in times.items()), flush=True)
        if "stamps" not in fns:
            continue
        call(fns["stamps"][symbol], kind)
        torch.cuda.synchronize()
        tiles = t // 64
        n = 8 * len(STAMPED)
        rows = [(f"block {r}", outs[kind][0][0, 0, 0, 192 * r:192 * r + n:8]) for r in range(d_qk // 192)]
        for block, cyc in rows:
            cyc = cyc.float().tolist()
            print(f"  stamps {form} {kind} {block}, cycles a tile (of {tiles}): " + ", ".join(
                f"{n} {c / (1 if n == 'x wait' else tiles):.0f}" for n, c in zip(STAMPED, cyc))
                + f"; a tile in all {sum(cyc[1:]) / tiles:.0f}", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names (final is always run)")
    ap.add_argument("--forms", default="k1r", help=f"comma-separated forms of {list(FORMS)}")
    args = ap.parse_args(argv)
    names = ["final"] + [n for n in args.variants.split(",") if n != "final"]
    forms = args.forms.split(",")
    unknown = [n for n in names if n not in VARIANTS] + [f for f in forms if f not in FORMS]
    if unknown:
        raise SystemExit(f"study_bwd_tc_relpos: unknown variants or forms {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("study_bwd_tc_relpos: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}", flush=True)
    fns = build_variants({n: VARIANTS[n] for n in names}, SOURCE, sources((SOURCE,)), SYMBOLS, n_pointers=10,
                         study="study_bwd_relpos")
    for form in forms:
        study_form(fns, form)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
