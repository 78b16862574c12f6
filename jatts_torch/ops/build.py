"""Build and load the port's hand-written CUDA kernels.

Each ``jatts_torch/csrc/<name>.cu`` has a plain C interface and is compiled
by ``nvcc`` for Hopper (``sm_90a``) into its own shared library, which is
loaded with ``ctypes``. Libraries go to ``build/kernels/`` beside the
package (git-ignored), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
an unchanged one is reused. Nothing is built when a
module is imported: the first launch builds, or a caller that wants every
kernel up front (``chip_smoke.py``) calls :func:`build` with all the names,
which starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> loaded library; one load per process (a ctypes handle is a
# process-wide resource, like the CUDA context it launches into)
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH")


def library_path(name: str) -> Path:
    """``build/kernels/lib<name>_<hash>.so``; the hash covers the source,
    every header of ``csrc/`` (a source may include any of them) and the
    flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def build(names: Iterable[str], seconds: Optional[Dict[str, float]] = None) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all ``nvcc`` runs
    in parallel. Returns name -> the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills; empty when the library was cached);
    ``seconds``, when given, gets name -> the wall seconds of its ``nvcc``.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    reports = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            reports[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = tempfile.TemporaryFile(mode="w+")  # a pipe could fill and stall nvcc
        proc = subprocess.Popen(nvcc_command(name, tmp), stdout=log, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, log, time.perf_counter())
    failed = []
    while running:
        for name, (proc, tmp, out, log, t0) in list(running.items()):
            if proc.poll() is None:
                continue
            del running[name]
            if seconds is not None:
                seconds[name] = time.perf_counter() - t0
            log.seek(0)
            reports[name] = log.read()
            log.close()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{reports[name]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
