"""The fused MAS search (``jatts_torch/csrc/mas_path.cu``) on the card,
against the plain versions (marked ``cuda``: they skip without a card).
This file imports no jax and no flax, so it runs where the card is:

    python -m pytest tests/test_torch_mas_path_card.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.ops import mas  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(case):
    """(log_p_attn, text_lengths, feats_lengths) on the card."""
    rng = np.random.default_rng(8)
    b, t_feats, t_text, tl, fl = {
        "ragged": (5, 200, 77, [77, 33, 32, 31, 1], [200, 199, 100, 40, 77]),
        # text_len 1, feats_len 1, feats_len < text_len, zero-length rows, a row with no token
        "edges": (6, 24, 8, [1, 8, 8, 0, 5, 0], [24, 1, 5, 0, 0, 9]),
        "ties": (4, 300, 200, [200, 150, 5, 200], [300, 300, 100, 200]),
        "one_frame": (3, 1, 4, [1, 4, 0], [1, 1, 0]),
        # three warps with halos, refreshed 9 times
        "wide": (3, 300, 300, [300, 161, 129], [300, 297, 64]),
        # the widest block: 8 warps of 4 slots
        "widest": (2, 200, 1024, [1024, 700], [200, 150]),
        "aligner": (16, 1210, 102, list(rng.integers(20, 103, 16)), list(rng.integers(600, 1211, 16))),
    }[case]
    x = rng.normal(size=(b, t_feats, t_text)).astype(np.float32)
    lp = torch.log_softmax(torch.from_numpy(x), -1)
    if case == "ties":
        lp = (lp * 4).round() / 4
    return lp.cuda(), torch.tensor(tl).cuda(), torch.tensor(fl).cuda()


CASES = ["ragged", "edges", "ties", "one_frame", "wide", "widest", "aligner"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["smem", "global"])
@pytest.mark.parametrize("case", CASES)
def test_fused_path_and_bits_match_plain_on_card(case, route):
    _card()
    lp, tl, fl = _inputs(case)
    n_words = (lp.shape[2] + 31) // 32
    # "global": room for 3 frames' words, so the bits are staged back 3 frames at a time
    capacity = mas.SMEM_BITS_BYTES if route == "smem" else 3 * 4 * n_words
    want = mas.mas_path_ref(lp, tl, fl)
    mas.reset_launches()
    path = mas.mas_path_fused(lp, tl, fl, smem_bits_bytes=capacity)
    got, bits = mas.mas_path_fused(lp, tl, fl, return_bits=True, smem_bits_bytes=capacity)
    torch.cuda.synchronize()
    went = "smem" if lp.shape[1] * n_words * 4 <= capacity else "global"
    assert mas.path_launches == 2 and mas.path_routes[went] == 2
    assert path.dtype == torch.int32 and torch.equal(path, want)
    assert torch.equal(got, want)
    assert torch.equal(bits, mas.pack_bits(mas.mas_decisions_ref(lp, tl)))  # padding bits and frame 0 too


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edges", "ragged"])
def test_fused_path_writes_every_frame(case):
    """Through the entry point, into a path buffer pre-filled with a
    sentinel: pinned frames, walked frames and the frames of rows with no
    walk all come back written, on both storage routes."""
    _card()
    lp, tl, fl = _inputs(case)
    b, t_feats, t_text = lp.shape
    n_words = (t_text + 31) // 32
    want = mas.mas_path_ref(lp, tl, fl)
    tl32, fl32 = tl.int(), fl.int()
    for capacity in (mas.SMEM_BITS_BYTES, 4 * n_words):
        path = torch.full((b, t_feats), -7, dtype=torch.int32, device="cuda")
        scratch = torch.empty(b, t_feats, n_words, dtype=torch.int32, device="cuda")
        rc = mas._path_fn()(lp.data_ptr(), tl32.data_ptr(), fl32.data_ptr(), path.data_ptr(), None,
                            scratch.data_ptr(), b, t_feats, t_text, capacity,
                            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert not bool((path == -7).any()) and torch.equal(path, want)


@pytest.mark.cuda
def test_backends_take_the_fused_search_once_a_call():
    _card()
    lp, tl, fl = _inputs("ragged")
    want = mas.mas_path_ref(lp, tl, fl)
    for backend in ("cuda", "auto"):
        mas.reset_launches()
        path = mas.select_mas(backend)(lp, tl, fl)
        torch.cuda.synchronize()
        assert torch.equal(path, want)
        assert (mas.path_launches, mas.fwd_launches, mas.backtrace_launches) == (1, 0, 0)
    mas.reset_launches()
    ds, _ = mas.viterbi_decode(lp, tl, fl)
    ds_scan, _ = mas.viterbi_decode(lp, tl, fl, backend="scan")
    assert torch.equal(ds, ds_scan) and mas.path_launches == 1
    # bf16 input is cast by the wrapper, as the plain version casts
    assert torch.equal(mas.mas_path_fused(lp.bfloat16(), tl, fl), mas.mas_path_ref(lp.bfloat16(), tl, fl))


@pytest.mark.cuda
def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    _card()
    lp, tl, fl = _inputs("ragged")
    mas.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        mas.mas_path_fused(lp.transpose(1, 2).contiguous().transpose(1, 2), tl, fl)
    with pytest.raises(TypeError):
        mas.mas_path_fused(lp.double(), tl, fl)
    with pytest.raises(ValueError, match="unsupported sizes"):
        mas.mas_path_fused(torch.zeros(1, 4, 1025, device="cuda"), tl[:1], fl[:1])
    with pytest.raises(ValueError, match="smem_bits_bytes"):
        mas.mas_path_fused(lp, tl, fl, smem_bits_bytes=4)
    assert mas.path_launches == 0
