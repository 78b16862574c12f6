"""The tensor-core flash-attention forward (``csrc/flash_attn_fwd_tc.cu``):
which calls take it (on the CPU), and (marked ``cuda``, skipped without a
card) the kernel against ``flash_attention_ref`` at every (d_qk, d_v) it is
built for, non-causal (its causal forms: ``test_torch_flash_tc_causal.py``). Imports no flax, so the card's machine runs it:
``python -m pytest tests/test_torch_flash_tc.py -m cuda``.

Tolerances are ``chip_smoke.py``'s for bf16: 1e-2 absolute on the output
for K1's forms (d_qk == d_v; |out| < 4 on these inputs, so one bf16
rounding is < 2^-7, and P is rounded to bf16 before the P.V product), 1e-2
relative to max(1, max|plain|) for K1r's; the log-sum-exp within 1e-4
relative, since it is summed in f32 from f32 scores."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.ops import flash_attention as k1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(d, d) for d in k1.HEAD_DIMS] + list(k1.RELPOS_PAIRS)


@pytest.mark.parametrize(
    "dtype,causal,d_qk,d_v",
    [(dt, c, d_qk, d_v) for dt in (torch.float32, torch.bfloat16) for c in (False, True)
     for d_qk, d_v in PAIRS if not (c and d_qk != d_v)],  # no causal d_qk != d_v form
)
def test_forward_dispatch_rule(dtype, causal, d_qk, d_v):
    """bf16, causal or not -> the tensor-core kernel at every admitted
    width; f32 non-causal at every width but 256 -> the 3xTF32 tensor-core
    kernel; f32 causal and f32 at d 256 -> the scalar kernel."""
    if dtype == torch.bfloat16:
        want = k1.KERNEL_TC
    elif not causal and d_qk != 256:
        want = k1.KERNEL_TC_F32
    else:
        want = k1.KERNEL
    assert k1.fwd_kernel(dtype, causal, d_qk, d_v) == want


def test_tc_source_has_every_form_and_a_plain_c_interface():
    src = (ROOT / "jatts_torch" / "csrc" / f"{k1.KERNEL_TC}.cu").read_text()
    assert 'extern "C" int jatts_flash_attn_fwd_tc(' in src
    assert "wgmma.mma_async" in src and "cp.async.bulk.tensor" in src and "mbarrier" in src
    assert "torch/" not in src and "#include <ATen" not in src and "atomicAdd" not in src
    for d in k1.HEAD_DIMS:
        assert f"case {d}: return (int)launch_d<{d}>" in src
    for d_qk, d_v in k1.RELPOS_PAIRS:
        assert f"launch<{d_qk}, {d_v}, false>" in src
    # the scalar file no longer runs a bf16 non-causal form
    scalar = (ROOT / "jatts_torch" / "csrc" / f"{k1.KERNEL}.cu").read_text()
    assert "dispatch_relpos<__nv_bfloat16>" not in scalar and "dispatch_t<false>" not in scalar


def test_cpu_call_counts_no_tensor_core_launch():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 9, 64, generator=g).bfloat16() for _ in range(3))
    k1.reset_launches()
    out = k1.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and (k1.launches, k1.launches_tc) == (0, 0)


def _inputs(rng, b, h, tq, tk, d_qk, d_v, bias, rows):
    """bf16 card tensors from numpy; ``rows``: (first valid key, count) per
    batch item."""

    def randn(*shape, scale=1.0):
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(x).cuda().bfloat16()

    q, k = randn(b, h, tq, d_qk), randn(b, h, tk, d_qk)
    v = randn(b, h, tk, d_v)
    ab = randn(b, h, tq, tk, scale=np.sqrt(d_qk)) if bias else None
    pos = torch.arange(tk)
    mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in rows]).cuda()
    return q, k, v, ab, mask


CASES = [
    # (B, H, Tq, Tk), key rows per item: full, ragged, none valid
    ((3, 2, 130, 130), [(0, 130), (0, 77), (0, 0)]),
    ((2, 2, 1000, 1000), [(0, 1000), (5, 611)]),   # T ends inside a tile
    ((2, 2, 1, 1), [(0, 1), (0, 0)]),
    ((2, 2, 70, 203), [(0, 203), (64, 65)]),       # Tq != Tk, odd Tk, a masked leading tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", CASES)
@pytest.mark.parametrize("d_qk,d_v,bias", [(d, d, b) for d in k1.HEAD_DIMS for b in (False, True)]
                         + [(d_qk, d_v, False) for d_qk, d_v in k1.RELPOS_PAIRS])
def test_tc_forward_matches_plain_on_card(shape, rows, d_qk, d_v, bias):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, tq, tk = shape
    rng = np.random.default_rng(11)
    q, k, v, ab, mask = _inputs(rng, b, h, tq, tk, d_qk, d_v, bias, rows)
    scale = d_v ** -0.5 if d_qk != d_v else None
    k1.reset_launches()
    out, lse_k = k1.flash_attention_fwd(q, k, v, ab, mask, scale)
    out_nolse = k1.flash_attention(q, k, v, ab, mask, scale)
    torch.cuda.synchronize()
    assert k1.launches_tc == 2
    assert (k1.launches_relpos if d_qk != d_v else k1.launches) == 2
    want, lse = k1.flash_attention_ref(
        q.float(), k.float(), v.float(), None if ab is None else ab.float(), mask, scale, return_lse=True)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert torch.equal(out, out_nolse)
    err = (out.float() - want).abs().max().item()
    tol = 1e-2 if d_qk == d_v else 1e-2 * max(1.0, want.abs().max().item())
    assert np.isfinite(err) and err <= tol, err
    none = torch.isinf(lse)
    assert torch.equal(none, torch.isinf(lse_k)) and bool((lse_k[none] > 0).all())
    lse_err = (lse_k - lse).masked_fill(none, 0.0).abs().max().item()
    assert lse_err <= 1e-4 * max(1.0, lse.masked_fill(none, 0.0).abs().max().item())
    for i, (_, n) in enumerate(rows):
        if n == 0:
            assert torch.all(out[i] == 0)


@pytest.mark.cuda
def test_tc_forward_row_does_not_depend_on_its_batch():
    """An item alone and inside a batch of others gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(12)
    q, k, v, ab, mask = _inputs(rng, 4, 2, 300, 300, 192, 192, True, [(0, 300), (0, 120), (0, 7), (0, 0)])
    both = k1.flash_attention(q, k, v, ab, mask)
    alone = k1.flash_attention(q[1:2].contiguous(), k[1:2].contiguous(), v[1:2].contiguous(),
                               ab[1:2].contiguous(), mask[1:2].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(both[1:2], alone)
