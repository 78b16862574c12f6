"""jatts_torch package checks: no JAX anywhere in the port, the K1 wrapper's
CPU route and input checks, the default device of the entry points, the
kernel build commands, and (marked ``cuda``, skipped without a card) K1,
K1-bwd, K1b (their causal form), K1r (their fused rel-pos form, d_qk !=
d_v), K2 and K3 against their plain twins."""

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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "jatts_tpu", "egs", "data_prep"}  # egs/*/local too


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
        "jatts_torch.features.extractors, jatts_torch.utils.io, jatts_torch.bin.align, "
        "jatts_torch.bin.tts_train, jatts_torch.train.trainer, jatts_torch.train.steps, "
        "jatts_torch.train.schedulers, jatts_torch.losses.basic, jatts_torch.data.dataset, "
        "jatts_torch.data.batcher, jatts_torch.utils.checkpoint, jatts_torch.utils.initialize, "
        "jatts_torch.utils.config, jatts_torch.models.valle, jatts_torch.modules.valle_modules, "
        "jatts_torch.train.steps_valle, jatts_torch.modules.attention, jatts_torch.modules.conformer, "
        "jatts_torch.modules.positional, jatts_torch.serving.bundle, jatts_torch.serving.server, "
        "jatts_torch.models.vits, jatts_torch.modules.flows, jatts_torch.modules.wavenet, "
        "jatts_torch.modules.vits_modules, jatts_torch.modules.noise, jatts_torch.losses.kl, "
        "jatts_torch.train.steps_vits, jatts_torch.bin.ttslm_decode, jatts_torch.models.e2tts, "
        "jatts_torch.modules.e2tts_backbone, jatts_torch.train.steps_e2tts, jatts_torch.bin.e2tts_decode, "
        "jatts_torch.bin.e2tts_train, jatts_torch.modules.remat, jatts_torch.bin.run_recipe, "
        "jatts_torch.egs.jsut.tts1.local.data_prep, jatts_torch.egs.jsut.tts2.local.data_prep, "
        "jatts_torch.egs.jvs.tts1.local.data_prep, jatts_torch.egs.jvs.tts2.local.data_prep, "
        "jatts_torch.egs.jvs.tts1.local.prepare_f0_range, "
        "jatts_torch.egs.hificaptain_jp_female.tts1.local.data_prep, "
        "jatts_torch.egs.hificaptain_jp_female.tts2.local.data_prep, "
        "jatts_torch.egs.hificaptain_jp_female.tts3.local.data_prep\n"
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


def test_tts_train_defaults_to_cuda():
    """The training entry point runs on the card unless asked: without one
    it raises before it reads anything."""
    from jatts_torch.bin import tts_train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts_train.run("train.csv", "dev.csv", "stats.npz", "tokens.txt", {}, "exp")


def test_valle_defaults_to_cuda():
    from jatts_torch.models.valle import VALLEAR

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VALLEAR(n_tokens=8, d_model=16, n_heads=2, n_layers=1)


def test_resolve_device_defaults_to_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda:0")


@pytest.mark.parametrize("kernel", [k1.KERNEL, k1.KERNEL_TC, k1.KERNEL_BWD, k1.KERNEL_BWD_TC, k1.KERNEL_BWD_TC_RELPOS,
                                    k1.KERNEL_BWD_TC_BIAS, mas.KERNEL])
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


def test_flash_bwd_source_holds_two_global_kernels_and_a_plain_c_interface():
    src = (ROOT / "jatts_torch" / "csrc" / "flash_attn_bwd.cu").read_text()
    # the dk/dv and dq kernels, and their K1r (d_qk != d_v) forms
    assert src.count("__global__") == 4
    assert "flash_attn_bwd_dkv_relpos_kernel" in src and "flash_attn_bwd_dq_relpos_kernel" in src
    assert 'extern "C" int jatts_flash_attn_bwd_dkv(' in src
    assert 'extern "C" int jatts_flash_attn_bwd_dq(' in src
    assert "torch/" not in src and "#include <ATen" not in src and "atomicAdd" not in src


def test_flash_sources_take_the_causal_form_as_a_compile_time_flag():
    for name in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        src = (ROOT / "jatts_torch" / "csrc" / name).read_text()
        assert "bool CAUSAL" in src and "int causal" in src, name


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,with_bias", [(64, True), (192, True), (192, False), (256, True)])
def test_k1_bwd_matches_plain_on_card(dtype, tol, d, with_bias):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(2)
    b, h, t = 3, 2, 100
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32)).cuda().to(dtype)
                   for _ in range(4))
    ab = None
    if with_bias:
        ab = torch.from_numpy((rng.normal(size=(b, h, t, t)) * np.sqrt(d)).astype(np.float32))
        ab = ab.cuda().to(dtype)
    mask = (torch.arange(t)[None, :] < torch.tensor([t, 37, 0])[:, None]).cuda()
    scale = d ** -0.5
    o, lse = k1.flash_attention_ref(q, k, v, ab, mask, scale, return_lse=True)
    k1.reset_launches()
    got = k1.flash_attention_bwd(q, k, v, ab, mask, scale, o, lse, do)
    torch.cuda.synchronize()
    assert (k1.launches_bwd_dkv, k1.launches_bwd_dq) == (1, 1)
    want = k1.flash_attention_bwd_ref(
        q.float(), k.float(), v.float(), None if ab is None else ab.float(), mask, scale,
        o.float(), lse, do.float(),
    )
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        err = (g.float() - w).abs().max().item()
        assert np.isfinite(err) and err <= tol
    assert torch.all(got[0][2] == 0) and not torch.isnan(got[0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t,d,with_bias", [(100, 64, False), (1000, 64, False), (1, 64, False), (130, 192, True)])
def test_k1b_causal_kernels_match_plain_on_card(dtype, tol, t, d, with_bias):
    """The causal forward, dk/dv and dq kernels against
    flash_attention_ref / flash_attention_bwd_ref(causal=True); errors
    relative to max(1, max |plain|). Key masks: full, ragged, and one whose
    valid keys start at 3, so its rows 0..2 see no key (0, not NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(4)
    b, h = 3, 2
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32)).cuda().to(dtype)
                   for _ in range(4))
    ab = None
    if with_bias:
        ab = torch.from_numpy((rng.normal(size=(b, h, t, t)) * np.sqrt(d)).astype(np.float32)).cuda().to(dtype)
    pos = torch.arange(t)
    mask = torch.stack([pos < t, pos < max(1, (2 * t) // 3), pos >= min(3, t - 1)]).cuda()
    scale = d ** -0.5

    def f32(x):
        return None if x is None else x.float()

    k1.reset_launches()
    out, lse_k = k1.flash_attention_fwd(q, k, v, ab, mask, scale, causal=True)
    o, lse = k1.flash_attention_ref(f32(q), f32(k), f32(v), f32(ab), mask, scale, return_lse=True, causal=True)
    got = k1.flash_attention_bwd(q, k, v, ab, mask, scale, o.to(dtype), lse, do, causal=True)
    torch.cuda.synchronize()
    assert (k1.launches_causal, k1.launches_bwd_dkv_causal, k1.launches_bwd_dq_causal) == (1, 1, 1)
    assert (k1.launches, k1.launches_bwd_dkv, k1.launches_bwd_dq) == (0, 0, 0)
    want = k1.flash_attention_bwd_ref(f32(q), f32(k), f32(v), f32(ab), mask, scale, o, lse, f32(do), causal=True)
    for g, w in [(out, o)] + list(zip(got, want)):
        if w is None:
            assert g is None
            continue
        err = (g.float() - w).abs().max().item()
        assert np.isfinite(err) and err <= tol * max(1.0, w.abs().max().item())
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_k))
    none = torch.isinf(lse)[..., None].expand_as(out)
    assert torch.all(out[none] == 0) and torch.all(got[0][none] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t,dims", [(100, (192, 64)), (130, (576, 192)), (1, (576, 192))])
def test_k1r_relpos_kernels_match_plain_on_card(dtype, tol, t, dims):
    """K1r's forward, dk/dv and dq kernels against flash_attention_ref /
    flash_attention_bwd_ref at the small pair and the JVS/JSUT width's pair;
    errors relative to max(1, max |plain|). Key masks: full, ragged, and
    none valid (that item's output and gradients exactly 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    b, h = 3, 2
    d_qk, d_v = dims

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)

    q, k = randn(b, h, t, d_qk), randn(b, h, t, d_qk)
    v, do = randn(b, h, t, d_v), randn(b, h, t, d_v)
    pos = torch.arange(t)
    mask = torch.stack([pos < t, pos < max(1, (2 * t) // 3), pos < 0]).cuda()
    scale = d_v ** -0.5
    k1.reset_launches()
    out, lse_k = k1.flash_attention_fwd(q, k, v, None, mask, scale)
    o, lse = k1.flash_attention_ref(q.float(), k.float(), v.float(), None, mask, scale, return_lse=True)
    got = k1.flash_attention_bwd(q, k, v, None, mask, scale, o.to(dtype), lse, do)
    torch.cuda.synchronize()
    assert (k1.launches_relpos, k1.launches_bwd_dkv_relpos, k1.launches_bwd_dq_relpos) == (1, 1, 1)
    assert (k1.launches, k1.launches_bwd_dkv, k1.launches_bwd_dq) == (0, 0, 0)
    want = k1.flash_attention_bwd_ref(q.float(), k.float(), v.float(), None, mask, scale, o, lse, do.float())
    assert got[3] is None and out.shape == (b, h, t, d_v)
    for g, w in [(out, o)] + list(zip(got[:3], want[:3])):
        assert g.shape == w.shape
        err = (g.float() - w).abs().max().item()
        assert np.isfinite(err) and err <= tol * max(1.0, w.abs().max().item())
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_k))
    assert torch.all(out[2] == 0) and all(torch.all(g[2] == 0) for g in got[:3])
    with pytest.raises(ValueError, match="d_qk, d_v"):
        k1.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(), v[..., :32].contiguous(), None, mask)
