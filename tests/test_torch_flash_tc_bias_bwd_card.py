"""K1-bwd's bf16 backward with a bias on the tensor cores
(``csrc/flash_attn_bwd_tc_bias.cu``) on the card. Every test is marked
``cuda`` and decides in its body whether a card is present (skipped here; the
card's machine runs them with
``python -m pytest tests/test_torch_flash_tc_bias_bwd_card.py -m cuda``).
Imports neither jax nor flax.

Both kernels against the plain version per batch item within
``chip_smoke.py``'s K1-bwd bf16 tolerance (T 130, 1000, 1 and Tq != Tk both
ways, ragged masks, a masked leading key tile, an item with no valid key):
dq and d(ab) exactly 0 on rows that see no key, d(ab) exactly 0 on masked
keys, dk and dv exactly 0 on keys no row sees; the same bits from run to run
and for an item alone as in its batch; the C entries refusing f32, a causal
call, no bias and another width; the autograd chain through
``FlashAttention`` (the tensor-core forward, both backward kernels on the
new route)."""

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
TOL = chip_smoke.TOL_BWD["bf16"]
item_err = chip_smoke.item_err
D = 192
NAMES = ("dq", "dk", "dv", "dab")
CASES = [
    # (B, H, Tq, Tk), key rows per item: (first valid key, count)
    ((3, 2, 130, 130), [(0, 130), (0, 77), (0, 0)]),
    ((3, 2, 1000, 1000), [(0, 1000), (5, 611), (64, 65)]),  # T ends inside a tile; a masked leading tile
    ((2, 2, 1, 1), [(0, 1), (0, 0)]),
    ((2, 2, 70, 203), [(0, 203), (64, 65)]),
    ((2, 2, 203, 70), [(0, 70), (5, 40)]),
    # Tk % 8 == 0: the bias by TMA, rows past Tq and keys past Tk filled with zeros
    ((2, 2, 70, 200), [(0, 200), (64, 65)]),
    ((2, 2, 203, 64), [(0, 64), (5, 40)]),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(seed, shape, rows):
    """bf16 q, k, v, do and a bias at the scale of q.k^T made with numpy on
    the card, do zero on padded query rows; the key mask."""
    b, h, tq, tk = shape
    rng = np.random.default_rng(seed)

    def randn(*s, scale=1.0):
        return torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32)).cuda().to(torch.bfloat16)

    q, k, v, do = randn(b, h, tq, D), randn(b, h, tk, D), randn(b, h, tk, D), randn(b, h, tq, D)
    ab = randn(b, h, tq, tk, scale=math.sqrt(D))
    pos = torch.arange(tk, device="cuda")
    mask = torch.stack([(pos >= a) & (pos < a + n) for a, n in rows])
    if tq == tk:
        do = do * mask[:, None, :, None]
    return q, k, v, ab, do, mask


def _plain(q, k, v, ab, do, mask, scale):
    o, lse = k1.flash_attention_ref(q, k, v, ab, mask, scale, return_lse=True)
    di = (o.float() * do.float()).sum(-1)
    f = [x.float() for x in (q, k, v, ab, o, do)]
    want = k1.flash_attention_bwd_ref(*f[:4], mask, scale, f[4], lse, f[5])
    return lse, di, dict(zip(NAMES, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", CASES, ids=["T130", "T1000", "T1", "Tq70_Tk203", "Tq203_Tk70", "Tq70_Tk200", "Tq203_Tk64"])
def test_tc_bias_bwd_matches_plain_on_card(shape, rows):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, ab, do, mask = _inputs(6, shape, rows)
    scale = D ** -0.5
    lse, di, want = _plain(q, k, v, ab, do, mask, scale)
    k1.reset_launches()
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, ab, mask, scale, lse, di, do)
    dq, dab = k1.flash_attention_bwd_dq(q, k, v, ab, mask, scale, lse, di, do)
    torch.cuda.synchronize()
    assert (k1.launches_bwd_dkv_tc_bias, k1.launches_bwd_dq_tc_bias) == (1, 1)
    assert (k1.launches_bwd_dkv, k1.launches_bwd_dq) == (1, 1)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv), ("dab", dab)):
        err = item_err(got, want[name])
        assert math.isfinite(err) and err <= TOL, (name, err)
    unseen = ~mask[:, None, None, :]
    rows_none = torch.isinf(lse)[..., None]
    assert torch.all(dk.masked_select(unseen.transpose(-1, -2)) == 0)
    assert torch.all(dv.masked_select(unseen.transpose(-1, -2)) == 0)
    assert torch.all(dq.masked_select(rows_none) == 0) and torch.all(dab.masked_select(rows_none) == 0)
    assert torch.all(dab.masked_select(unseen) == 0)


@pytest.mark.cuda
def test_tc_bias_bwd_same_bits_each_run_and_alone_on_card():
    """No atomics: three runs give the same bits, and an item alone gives
    the bits it has inside its batch."""
    _card()
    q, k, v, ab, do, mask = _inputs(7, (4, 2, 300, 300), [(0, 300), (0, 120), (5, 77), (0, 0)])
    scale = D ** -0.5
    lse, di, _ = _plain(q, k, v, ab, do, mask, scale)

    def run(*xs):
        q, k, v, ab, do, mask, lse, di = xs
        return (*k1.flash_attention_bwd_dkv(q, k, v, ab, mask, scale, lse, di, do),
                *k1.flash_attention_bwd_dq(q, k, v, ab, mask, scale, lse, di, do))

    xs = (q, k, v, ab, do, mask, lse, di)
    runs = [run(*xs) for _ in range(3)]
    alone = run(*(x[1:2].contiguous() for x in xs))
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other, runs[0]))
    assert all(torch.equal(a, b[1:2]) for a, b in zip(alone, runs[0]))


@pytest.mark.cuda
def test_tc_bias_bwd_c_entries_refuse_other_forms_on_card():
    """f32, a causal call, no bias and a width other than 192 are not these
    kernels'."""
    _card()
    lib = build.load(k1.KERNEL_BWD_TC_BIAS)
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.zeros(2, 2, 64, D, device="cuda", dtype=torch.bfloat16)
    ab = torch.zeros(2, 2, 64, 64, device="cuda", dtype=torch.bfloat16).data_ptr()
    rows = torch.zeros(2, 2, 64, device="cuda")
    out = torch.empty(2, 2, 64, D, device="cuda", dtype=torch.bfloat16)
    for name in ("dkv", "dq"):
        assert getattr(lib, f"jatts_flash_attn_bwd_{name}_tc_bias") is not None
        fn = k1._bwd_kernel_fn(k1.KERNEL_BWD_TC_BIAS, f"jatts_flash_attn_bwd_{name}_tc_bias")
        p = [x.data_ptr()] * 3
        for ab_ptr, d_qk, d_v, is_bf16, causal in ((ab, D, D, 0, 0), (ab, D, D, 1, 1), (None, D, D, 1, 0),
                                                   (ab, 128, 128, 1, 0), (ab, 576, 192, 1, 0), (ab, 64, 64, 1, 0)):
            assert fn(*p, ab_ptr, None, rows.data_ptr(), rows.data_ptr(), x.data_ptr(), out.data_ptr(),
                      out.data_ptr(), 2, 2, 64, 64, d_qk, d_v, is_bf16, causal, 0.1,
                      stream) != 0, (name, ab_ptr is not None, d_qk, d_v, is_bf16, causal)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tc_bias_bwd_autograd_chain_matches_plain_on_card():
    """FlashAttention in bf16 at d 192 with a bias (the tensor-core forward's
    output and lse feeding the new dk/dv and dq) against autograd through
    the plain forward, each gradient (d(ab) among them) per item within
    K1-bwd's bf16 tolerance."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, ab, do, mask = _inputs(8, (3, 2, 200, 200), [(0, 200), (0, 131), (37, 100)])
    scale = D ** -0.5
    leaves = [x.detach().requires_grad_() for x in (q, k, v, ab)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, mask, scale)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k1.launches_tc, k1.launches_bwd_dkv_tc_bias, k1.launches_bwd_dq_tc_bias) == (1, 1, 1)
    ref_leaves = [x.detach().float().requires_grad_() for x in (q, k, v, ab)]
    want = torch.autograd.grad(k1.flash_attention_ref(*ref_leaves, mask, scale), ref_leaves, do.float())
    for g, w in zip(got, want):
        assert item_err(g, w) <= TOL
