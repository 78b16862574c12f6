"""jatts_torch package checks: no JAX anywhere in the port, the K1 wrapper's
CPU route and input checks, the default device, the kernel build commands,
and (marked ``cuda``, skipped without a card) K1, K2 and K3 against their
plain twins."""

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
from jatts_torch.ops import mas  # noqa: E402

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
        "jatts_torch.ops.flash_attention, jatts_torch.ops.mas, jatts_torch.ops.dsp, "
        "jatts_torch.losses.align, jatts_torch.modules.alignment, jatts_torch.aligner, "
        "jatts_torch.features.extractors, jatts_torch.utils.io, jatts_torch.bin.align\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "bad += [m for m in ('h5py', 'yaml', 'triton') if m in sys.modules]\n"
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


@pytest.mark.parametrize("kernel", [k1.KERNEL, mas.KERNEL])
def test_kernel_build_command_targets_hopper(monkeypatch, kernel):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    out = build.library_path(kernel)
    cmd = build.nvcc_command(kernel, out)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert Path(cmd[-1]).exists() and cmd[-1].endswith(f"csrc/{kernel}.cu")
    # built into the git-ignored build/ directory, named by the source's hash
    assert out.parent == ROOT / "build" / "kernels"
    assert out == build.library_path(kernel)
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_mas_source_holds_two_global_kernels_and_a_plain_c_interface():
    src = (ROOT / "jatts_torch" / "csrc" / "mas_viterbi.cu").read_text()
    assert src.count("__global__") == 2
    assert 'extern "C" int jatts_mas_fwd(' in src and 'extern "C" int jatts_mas_backtrace(' in src
    assert "torch/" not in src and "#include <ATen" not in src


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


def _mas_inputs(case):
    """(log_p_attn, text_lengths, feats_lengths) on the CPU."""
    rng = np.random.default_rng(3)
    if case == "ragged":
        b, t_feats, t_text = 5, 200, 77
        tl, fl = [77, 33, 32, 31, 1], [200, 199, 100, 40, 77]
    elif case == "edges":  # text_len 1, feats_len 1, feats_len < text_len, zero-length rows
        b, t_feats, t_text = 5, 24, 8
        tl, fl = [1, 8, 8, 0, 5], [24, 1, 5, 0, 0]
    else:  # ties: quantised to multiples of 0.25
        b, t_feats, t_text = 4, 300, 200
        tl, fl = [200, 150, 5, 200], [300, 300, 100, 200]
    x = rng.normal(size=(b, t_feats, t_text)).astype(np.float32)
    lp = torch.log_softmax(torch.from_numpy(x), -1)
    if case == "ties":
        lp = (lp * 4).round() / 4
    return lp, torch.tensor(tl), torch.tensor(fl)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "edges", "ties"])
def test_k2_k3_match_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lp, tl, fl = (t.cuda() for t in _mas_inputs(case))
    t_text = lp.shape[2]
    mas.reset_launches()
    bits = mas.mas_decisions(lp, tl)
    torch.cuda.synchronize()
    d_ref = mas.mas_decisions_ref(lp, tl)
    assert torch.equal(bits, mas.pack_bits(d_ref))  # K2, padding bits of the last word included
    path = mas.mas_backtrace(mas.pack_bits(d_ref), tl, fl, t_text)
    torch.cuda.synchronize()
    assert torch.equal(path, mas.mas_backtrace_ref(d_ref, tl, fl))  # K3
    pair = mas.mas_path_cuda(lp, tl, fl)
    torch.cuda.synchronize()
    assert torch.equal(pair, mas.mas_path_ref(lp, tl, fl))
    assert (mas.fwd_launches, mas.backtrace_launches) == (2, 2)
    # bf16 input is cast by the wrapper, as the plain version casts
    assert torch.equal(mas.mas_path_cuda(lp.bfloat16(), tl, fl), mas.mas_path_ref(lp.bfloat16(), tl, fl))
    with pytest.raises(ValueError, match="contiguous"):
        mas.mas_decisions(lp.transpose(1, 2).contiguous().transpose(1, 2), tl)
    with pytest.raises(TypeError):
        mas.mas_decisions(lp.double(), tl)
