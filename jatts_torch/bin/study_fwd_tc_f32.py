"""Time variants of the f32 tensor-core forward (``csrc/flash_attn_fwd_tc_f32.cu``)
on the card, in turns, at the FastSpeech2 training decoders' shapes:

    python -m jatts_torch.bin.study_fwd_tc_f32

Each variant is the source (with the shared header ``csrc/tc_f32_common.cuh``)
with one change, built by ``nvcc`` (all at once) into its own library under the
git-ignored ``build/study/``:

- ``final``: the source as it stands;
- ``cvt_rna``: hi and lo rounded by ``cvt.rna.tf32.f32`` instead of the two
  integer operations (the same bits);
- ``split_unroll1``: the split warps' loops not unrolled (the same bits);
- ``hi_hi_only``: one TF32 product of the three, a third of the tensor-core
  work;
- ``no_split``: the split warps do no work, so the products read stale
  buffers;
- ``no_frag_split``: Q's and P's fragments on the consumers not split (hi =
  x, lo = 0).

The last three are wrong by design: they say where the time goes, and the
script checks nothing but that every variant launches. It prints the card's
name and power limit, each variant's ms (the least of 3 rounds of 10
launches, variants in turns) and whether its output has the bits of
``final``'s.
"""

from __future__ import annotations

import ctypes
import math
import re
import shutil
import subprocess

SHAPES = (
    ("K1 f32 32,2,1024,192 bias lse", (32, 2, 1024), (192, 192), True),
    ("K1r f32 32,2,1024,576/192 lse", (32, 2, 1024), (576, 192), False),
)


SOURCE = "flash_attn_fwd_tc_f32.cu"
HEADER = "tc_f32_common.cuh"


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f"the source no longer has {count} of {old!r}")
    return src.replace(old, new)


def _on(name, change):
    """A variant that changes the file ``name`` of the sources by ``change``."""
    return lambda files: {**files, name: change(files[name])}


def sources(names=(SOURCE, HEADER)):
    """name -> text of the csrc files a study's variants change."""
    from jatts_torch.ops import build

    return {name: (build.CSRC_DIR / name).read_text() for name in names}


def _cvt_rna(src):
    return _sub(src, "{ return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }",
                '{\n  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;\n}')


def _split_unroll1(src):
    return _sub(src, "#pragma unroll 3\n", "#pragma unroll 1\n", count=2)


def _hi_hi_only_header(src):
    return _sub(src, "  wgmma_tf32(d, a[0], a[1], a[2], a[3], b_lo, accumulate);\n"
                     "  wgmma_tf32(d, a[4], a[5], a[6], a[7], b_hi, 1);\n"
                     "  wgmma_tf32(d, a[0], a[1], a[2], a[3], b_hi, 1);",
                "  wgmma_tf32(d, a[0], a[1], a[2], a[3], b_hi, accumulate);")


def _hi_hi_only(src):
    src = _sub(src, "      wgmma_tf32(tmp, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b_lo + 2 * kk, kk != 0);\n"
                    "      wgmma_tf32(tmp, qa[kk][4], qa[kk][5], qa[kk][6], qa[kk][7], b_hi + 2 * kk, 1);\n", "")
    return _sub(src, "wgmma_tf32(tmp, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b_hi + 2 * kk, 1);",
                "wgmma_tf32(tmp, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b_hi + 2 * kk, kk != 0);")


def _no_split(src):
    src = _sub(src, "for (int f = st; f < FSLAB / 16; f += NSPLITTERS) {", "for (int f = st; f < 0; f += NSPLITTERS) {")
    return _sub(src, "for (int c = st; c < FSLAB / 16; c += NSPLITTERS) {", "for (int c = st; c < 0; c += NSPLITTERS) {")


def _no_frag_split(src):
    for i, (hi, lo) in enumerate(((0, 4), (1, 5), (2, 6), (3, 7))):
        x = ("x00", "x10", "x01", "x11")[i]
        src = _sub(src, f"split_tf32({x}, qa[kk][{hi}], qa[kk][{lo}]);",
                   f"qa[kk][{hi}] = __float_as_uint({x}), qa[kk][{lo}] = 0u;")
    for j, (hi, lo) in zip((0, 2, 1, 3), ((0, 4), (1, 5), (2, 6), (3, 7))):
        src = _sub(src, f"split_tf32(s[i + {j}], pa[kk][{hi}], pa[kk][{lo}]);",
                   f"pa[kk][{hi}] = __float_as_uint(s[i + {j}]), pa[kk][{lo}] = 0u;")
    return src


VARIANTS = {"final": lambda f: f, "cvt_rna": _on(HEADER, _cvt_rna), "split_unroll1": _on(SOURCE, _split_unroll1),
            "hi_hi_only": lambda f: _on(HEADER, _hi_hi_only_header)(_on(SOURCE, _hi_hi_only)(f)),
            "no_split": _on(SOURCE, _no_split), "no_frag_split": _on(SOURCE, _no_frag_split)}


def build_variants(variants=None, source=SOURCE, files=None, symbols=("jatts_flash_attn_fwd_tc_f32",),
                   n_pointers=7, study="study"):
    """name -> {symbol: the loaded entry point} of each variant's library:
    ``variants`` (name -> change of ``files``, name -> text) applied to a
    copy of ``csrc/`` under ``build/<study>/<name>``, ``source`` compiled.
    Each entry point takes ``n_pointers`` pointers, 8 ints, the scale and the
    stream."""
    from jatts_torch.ops import build

    variants = VARIANTS if variants is None else variants
    files = sources() if files is None else files
    root = build.BUILD_DIR.parent / study
    procs = {}
    for name, change in variants.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, d)
        for fname, text in change(files).items():
            (d / fname).write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    fns = {}
    for name, (proc, d) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{report}")
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", report))
        regs = sorted(int(n) for n in re.findall(r"Used (\d+) registers", report))
        # each instantiation's template arguments (mangled), registers and spill stores
        forms = re.findall(r"_kernelI(\w+?)EEv.*?(\d+) bytes spill stores.*?Used (\d+) registers", report, re.S)
        print(f"built {name}: registers {regs[0]}-{regs[-1]}, spill stores {spills} bytes ("
              + ", ".join(f"{f} {r} regs, {sp} B spilled" for f, sp, r in forms) + ")", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fns[name] = {}
        for symbol in symbols:
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
            fns[name][symbol] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("study_fwd_tc_f32: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}", flush=True)
    fns = {name: f["jatts_flash_attn_fwd_tc_f32"] for name, f in build_variants().items()}
    for label, (b, h, t), (d_qk, d_v), bias in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(b, h, t, d_qk, device="cuda", generator=g)
        k = torch.randn(b, h, t, d_qk, device="cuda", generator=g)
        v = torch.randn(b, h, t, d_v, device="cuda", generator=g)
        ab = torch.randn(b, h, t, t, device="cuda", generator=g) * math.sqrt(d_qk) if bias else None
        mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
        out = torch.empty(b, h, t, d_v, device="cuda")
        lse = torch.empty(b, h, t, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if ab is None else ab.data_ptr(),
                    mask.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, t, t, d_qk, d_v, 0, 0,
                    d_v ** -0.5, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed with CUDA error {rc}")

        bits = {}
        for name, fn in fns.items():
            call(fn)
            torch.cuda.synchronize()
            bits[name] = out.clone()
        times = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                call(fn)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(fn)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 10)
        print(f"{label}: " + "; ".join(
            f"{name} {min(ms):.4f} ms ({', '.join(f'{x:.4f}' for x in ms)}; bits of final: "
            f"{bool(torch.equal(bits[name], bits['final']))})" for name, ms in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
