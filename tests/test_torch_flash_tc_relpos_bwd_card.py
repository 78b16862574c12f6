"""K1r's bf16 backward on the tensor cores (``csrc/flash_attn_bwd_tc_relpos.cu``)
on the card. Every test is marked ``cuda`` and decides in its body whether a
card is present (skipped here; the card's machine runs them with
``python -m pytest tests/test_torch_flash_tc_relpos_bwd_card.py -m cuda``).
Imports neither jax nor flax.

Both kernels at both (d_qk, d_v) pairs against the plain version per batch
item within ``chip_smoke.py``'s K1r bf16 tolerance (ragged T, T = 1, Tq !=
Tk both ways, a masked leading key tile, an item with no valid key): dq
exactly 0 on rows that see no key, dk and dv exactly 0 on keys no row sees;
the same bits from run to run and for an item alone as in its batch; the C
entries refusing a bias, a causal call, f32, another pair and a d(ab)
output; the autograd chain through ``FlashAttention``."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.ops import build  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL = chip_smoke.TOL_K1R["bf16"]
item_err = chip_smoke.item_err
PAIRS = [(192, 64), (576, 192)]
CASES = [
    # (B, H, Tq, Tk), key rows per item: (first valid key, count)
    ((3, 2, 130, 130), [(0, 130), (0, 77), (0, 0)]),
    ((3, 2, 1000, 1000), [(0, 1000), (5, 611), (64, 65)]),  # T ends inside a tile; a masked leading tile
    ((2, 2, 1, 1), [(0, 1), (0, 0)]),
    ((2, 2, 70, 203), [(0, 203), (64, 65)]),
    ((2, 2, 203, 70), [(0, 70), (5, 40)]),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(seed, shape, d_qk, d_v, rows):
    """bf16 q, k, v, do made with numpy on the card, do zero on padded query
    rows; the key mask."""
    b, h, tq, tk = shape
    rng = np.random.default_rng(seed)

    def randn(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(torch.bfloat16)

    q, k, v, do = randn(b, h, tq, d_qk), randn(b, h, tk, d_qk), randn(b, h, tk, d_v), randn(b, h, tq, d_v)
    pos = torch.arange(tk, device="cuda")
    mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in rows])
    if tq == tk:
        do = do * mask[:, None, :, None]
    return q, k, v, do, mask


def _plain(q, k, v, do, mask, scale):
    o, lse = k1.flash_attention_ref(q, k, v, None, mask, scale, return_lse=True)
    di = (o.float() * do.float()).sum(-1)
    dq, dk, dv, _ = k1.flash_attention_bwd_ref(q, k, v, None, mask, scale, o, lse, do)
    return lse, di, {"dq": dq, "dk": dk, "dv": dv}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", CASES, ids=["T130", "T1000", "T1", "Tq70_Tk203", "Tq203_Tk70"])
@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_tc_relpos_bwd_matches_plain_on_card(shape, rows, d_qk, d_v):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask = _inputs(6, shape, d_qk, d_v, rows)
    scale = d_v ** -0.5
    lse, di, want = _plain(q, k, v, do, mask, scale)
    k1.reset_launches()
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do)
    dq, dab = k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do)
    torch.cuda.synchronize()
    assert (k1.launches_bwd_dkv_tc_relpos, k1.launches_bwd_dq_tc_relpos) == (1, 1)
    assert (k1.launches_bwd_dkv_relpos, k1.launches_bwd_dq_relpos) == (1, 1) and dab is None
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        err = item_err(got, want[name])
        assert math.isfinite(err) and err <= TOL, (name, err)
    unseen = ~mask[:, None, :, None]
    assert torch.all(dk.masked_select(unseen) == 0) and torch.all(dv.masked_select(unseen) == 0)
    assert torch.all(dq.masked_select(torch.isinf(lse)[..., None]) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_tc_relpos_bwd_same_bits_each_run_and_alone_on_card(d_qk, d_v):
    """No atomics: three runs give the same bits, and an item alone gives
    the bits it has inside its batch."""
    _card()
    q, k, v, do, mask = _inputs(7, (4, 2, 300, 300), d_qk, d_v, [(0, 300), (0, 120), (5, 77), (0, 0)])
    scale = d_v ** -0.5
    lse, di, _ = _plain(q, k, v, do, mask, scale)

    def run(*xs):
        q, k, v, do, mask, lse, di = xs
        return (*k1.flash_attention_bwd_dkv(q, k, v, None, mask, scale, lse, di, do),
                k1.flash_attention_bwd_dq(q, k, v, None, mask, scale, lse, di, do)[0])

    xs = (q, k, v, do, mask, lse, di)
    runs = [run(*xs) for _ in range(3)]
    alone = run(*(x[1:2].contiguous() for x in xs))
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other, runs[0]))
    assert all(torch.equal(a, b[1:2]) for a, b in zip(alone, runs[0]))


@pytest.mark.cuda
def test_tc_relpos_bwd_c_entries_refuse_other_forms_on_card():
    """A bias, a causal call, f32, a pair that is not K1r's and (dq) a d(ab)
    output are not these kernels'."""
    _card()
    lib = build.load(k1.KERNEL_BWD_TC_RELPOS)
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.zeros(2, 2, 64, 576, device="cuda", dtype=torch.bfloat16)
    ab = torch.zeros(2, 2, 64, 64, device="cuda", dtype=torch.bfloat16).data_ptr()
    rows = torch.zeros(2, 2, 64, device="cuda")
    out = torch.empty(2, 2, 64, 576, device="cuda", dtype=torch.bfloat16)
    for name in ("dkv", "dq"):
        assert getattr(lib, f"jatts_flash_attn_bwd_{name}_tc_relpos") is not None
        fn = k1._bwd_kernel_fn(k1.KERNEL_BWD_TC_RELPOS, f"jatts_flash_attn_bwd_{name}_tc_relpos")
        p = [x.data_ptr()] * 3
        for ab_ptr, d_qk, d_v, is_bf16, causal in ((ab, 576, 192, 1, 0), (None, 576, 192, 1, 1), (None, 576, 192, 0, 0),
                                                   (ab, 192, 64, 1, 0), (None, 192, 192, 1, 0), (None, 64, 64, 1, 0)):
            assert fn(*p, ab_ptr, None, rows.data_ptr(), rows.data_ptr(), x.data_ptr(), out.data_ptr(),
                      out.data_ptr() if name == "dkv" else None, 2, 2, 64, 64, d_qk, d_v, is_bf16, causal, 0.1,
                      stream) != 0, (name, ab_ptr is not None, d_qk, d_v, is_bf16, causal)
    fn = k1._bwd_kernel_fn(k1.KERNEL_BWD_TC_RELPOS, "jatts_flash_attn_bwd_dq_tc_relpos")
    assert fn(*[x.data_ptr()] * 3, None, None, rows.data_ptr(), rows.data_ptr(), x.data_ptr(), out.data_ptr(),
              out.data_ptr(), 2, 2, 64, 64, 576, 192, 1, 0, 0.1, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d_qk,d_v", PAIRS)
def test_tc_relpos_bwd_autograd_chain_matches_plain_on_card(d_qk, d_v):
    """FlashAttention in bf16 at a K1r pair (the tensor-core forward's output
    and lse feeding the new dk/dv and dq) against autograd through the plain
    forward, each gradient per item within K1r's bf16 tolerance."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, mask = _inputs(8, (3, 2, 200, 200), d_qk, d_v, [(0, 200), (0, 131), (37, 100)])
    scale = d_v ** -0.5
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, None, mask, scale)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k1.launches_tc, k1.launches_bwd_dkv_tc_relpos, k1.launches_bwd_dq_tc_relpos) == (1, 1, 1)
    ref_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(k1.flash_attention_ref(*ref_leaves, None, mask, scale), ref_leaves, do)
    for g, w in zip(got, want):
        assert item_err(g, w) <= TOL
