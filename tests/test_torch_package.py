"""jatts_torch package checks: no JAX anywhere in the port, the K1 wrapper's
CPU route and input checks, the default device, the kernel build command,
and (marked ``cuda``, skipped without a card) K1 against its plain twin."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.device import resolve_device  # noqa: E402
from jatts_torch.ops import build  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "jatts_tpu"}


def _port_sources():
    return sorted((ROOT / "jatts_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out_of_sys_modules():
    """In a fresh interpreter: conftest imports jax in this process, so an
    in-process check would prove nothing."""
    code = (
        "import sys, jatts_torch, jatts_torch.models.fastspeech2, "
        "jatts_torch.vocoder.hifigan, jatts_torch.serving, jatts_torch.utils.convert, "
        "jatts_torch.ops.flash_attention\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad); sys.exit(1 if bad else 0)" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_port_sources(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN.intersection(roots), f"{path}:{node.lineno} imports {roots}"


def _k1_inputs(seed=0, b=2, h=2, t_q=7, t_k=9, d=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, t_q, d, generator=g).to(dtype)
    k = torch.randn(b, h, t_k, d, generator=g).to(dtype)
    v = torch.randn(b, h, t_k, d, generator=g).to(dtype)
    ab = torch.randn(b, h, t_q, t_k, generator=g).to(dtype)
    lens = torch.tensor(([t_k, 4] + [1] * b)[:b])
    key_mask = torch.arange(t_k)[None, :] < lens[:, None]
    return q, k, v, ab, key_mask


def test_k1_wrapper_on_cpu_is_the_plain_version():
    q, k, v, ab, key_mask = _k1_inputs()
    before = k1.launches
    got = k1.flash_attention(q, k, v, ab, key_mask, 0.125)
    want = k1.flash_attention_ref(q, k, v, ab, key_mask, 0.125)
    assert torch.equal(got, want)
    assert k1.launches == before  # the plain route is not a launch
    # default scale is 1/sqrt(d)
    torch.testing.assert_close(
        k1.flash_attention(q, k, v), k1.flash_attention_ref(q, k, v, sm_scale=64 ** -0.5)
    )


@pytest.mark.parametrize("bad", ["k_shape", "ab_shape", "mask_dtype", "rank"])
def test_k1_wrapper_rejects_bad_shapes(bad):
    q, k, v, ab, key_mask = _k1_inputs()
    if bad == "k_shape":
        k = k[..., :32]
    elif bad == "ab_shape":
        ab = ab[..., :3]
    elif bad == "mask_dtype":
        key_mask = key_mask.float()
    else:
        q = q[0]
    with pytest.raises(ValueError):
        k1.flash_attention(q, k, v, ab, key_mask)


def test_resolve_device_defaults_to_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda:0")


def test_kernel_build_command_targets_hopper(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    out = build.library_path(k1.KERNEL)
    cmd = build.nvcc_command(k1.KERNEL, out)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert Path(cmd[-1]).exists() and cmd[-1].endswith("csrc/flash_attn_fwd.cu")
    # built into the git-ignored build/ directory, named by the source's hash
    assert out.parent == ROOT / "build" / "kernels"
    assert out == build.library_path(k1.KERNEL)
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, chip_smoke.py must fail and print no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""),
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k1_matches_plain_on_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, ab, key_mask = (
        t.cuda() for t in _k1_inputs(1, b=3, h=2, t_q=130, t_k=130, d=192, dtype=dtype)
    )
    key_mask[1] = False  # a row of the batch with no valid key -> 0
    before = k1.launches
    got = k1.flash_attention(q, k, v, ab, key_mask)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    # the plain version in f32 (matmul TF32 is off by default): the bf16
    # kernel output differs from it by one rounding to bf16
    want = k1.flash_attention_ref(q.float(), k.float(), v.float(), ab.float(), key_mask)
    err = (got.float() - want).abs().max().item()
    assert np.isfinite(err) and err <= tol
    assert torch.all(got[1] == 0)
