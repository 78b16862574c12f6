"""jatts_torch.ops.mas against jatts_tpu.ops.mas / mas_pallas on the CPU.

The port's plain MAS versions (the twins of kernels K2 and K3, and the whole
search) must give the JAX package's path integer for integer, against both
the ``lax.scan`` version and the Pallas pair in interpret mode, including
ties, ragged widths and zero-length rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_tpu.ops.mas import mas_path as jax_mas_path  # noqa: E402
from jatts_tpu.ops.mas import viterbi_decode as jax_viterbi_decode  # noqa: E402
from jatts_tpu.ops.mas_pallas import mas_path_pallas  # noqa: E402
from jatts_torch.ops import mas  # noqa: E402


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _case(name):
    """(log_p_attn, text_lengths, feats_lengths) as numpy, by case name."""
    if name == "pallas_test_small":  # tests/test_ops_mas_pallas.py, first shape
        rng = np.random.default_rng(0)
        lp = _log_softmax(rng.normal(size=(2, 64, 16)).astype(np.float32))
        return lp, np.array([16, 9]), np.array([64, 40])
    if name == "pallas_test_batched":  # its second shape, non-power-of-two frames
        rng = np.random.default_rng(1)
        b, t_feats, t_text = 8, 96, 128
        lp = _log_softmax(rng.normal(size=(b, t_feats, t_text)).astype(np.float32))
        tl = rng.integers(2, t_text + 1, (b,))
        fl = np.minimum([max(int(t), 96 - 7 * i) for i, t in enumerate(tl)], t_feats)
        return lp, tl, fl
    if name == "ties":  # quantised to multiples of 0.25: equal cells abound
        rng = np.random.default_rng(2)
        lp = (np.round(rng.normal(size=(4, 48, 24)) * 2.0) / 4.0).astype(np.float32)
        return lp, np.array([24, 17, 5, 24]), np.array([48, 48, 31, 24])
    if name == "ragged":  # T_text not a multiple of 32: a ragged last ballot word
        rng = np.random.default_rng(3)
        lp = _log_softmax(rng.normal(size=(5, 40, 77)).astype(np.float32))
        return lp, np.array([77, 33, 32, 31, 1]), np.array([80, 40, 39, 33, 40]).clip(max=40)
    if name == "edges":  # text_len 1, feats_len 1, feats_len < text_len, zero-length rows
        rng = np.random.default_rng(4)
        lp = _log_softmax(rng.normal(size=(5, 24, 8)).astype(np.float32))
        return lp, np.array([1, 8, 8, 0, 5]), np.array([24, 1, 5, 0, 0])
    if name == "one_frame":
        rng = np.random.default_rng(5)
        lp = _log_softmax(rng.normal(size=(3, 1, 4)).astype(np.float32))
        return lp, np.array([1, 4, 0]), np.array([1, 1, 0])
    raise KeyError(name)


CASES = ["pallas_test_small", "pallas_test_batched", "ties", "ragged", "edges", "one_frame"]


def _torch_args(lp, tl, fl):
    return torch.from_numpy(lp), torch.from_numpy(np.asarray(tl)), torch.from_numpy(np.asarray(fl))


@pytest.mark.parametrize("name", CASES)
def test_plain_path_equals_jax_scan_and_pallas(name):
    lp, tl, fl = _case(name)
    want_scan = np.asarray(jax_mas_path(jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl)))
    want_pallas = np.asarray(
        mas_path_pallas(jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl), interpret=True)
    )
    np.testing.assert_array_equal(want_scan, want_pallas)  # the JAX pair agrees with itself
    got = mas.mas_path_ref(*_torch_args(lp, tl, fl))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_scan)


@pytest.mark.parametrize("name", CASES)
def test_kernel_twins_equal_jax(name):
    """K2's twin then K3's twin, through the packed-bit layout the kernels
    exchange, is the same path."""
    lp, tl, fl = _case(name)
    want = np.asarray(jax_mas_path(jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl)))
    lp_t, tl_t, fl_t = _torch_args(lp, tl, fl)
    d = mas.mas_decisions_ref(lp_t, tl_t)
    assert d.dtype == torch.bool and d.shape == lp_t.shape and not d[:, 0].any()
    np.testing.assert_array_equal(mas.mas_backtrace_ref(d, tl_t, fl_t).numpy(), want)
    # the CPU route of the wrappers: packed bits in between
    bits = mas.mas_decisions(lp_t, tl_t)
    assert bits.dtype == torch.int32 and bits.shape == (*lp.shape[:2], (lp.shape[2] + 31) // 32)
    assert torch.equal(mas.unpack_bits(bits, lp.shape[2]), d)
    got = mas.mas_backtrace(bits, tl_t, fl_t, lp.shape[2])
    np.testing.assert_array_equal(got.numpy(), want)


def test_no_token_but_frames_follows_the_scan_version():
    """text_len 0 with feats_len > 0 is no input of the aligner (batch padding
    zeroes both). There the JAX pair disagrees with itself on the last valid
    frame: the scan gives -1, the Pallas wrapper's argmax of an all-zero
    one-hot gives 0. The port follows the scan version."""
    rng = np.random.default_rng(7)
    lp = _log_softmax(rng.normal(size=(1, 12, 8)).astype(np.float32))
    tl, fl = np.array([0]), np.array([9])
    want = np.asarray(jax_mas_path(jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl)))
    lp_t, tl_t, fl_t = _torch_args(lp, tl, fl)
    np.testing.assert_array_equal(mas.mas_path_ref(lp_t, tl_t, fl_t).numpy(), want)
    got = mas.mas_backtrace_ref(mas.mas_decisions_ref(lp_t, tl_t), tl_t, fl_t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].tolist() == [0] * 8 + [-1] * 4


def test_pack_bits_round_trip_and_layout():
    rng = np.random.default_rng(6)
    d = torch.from_numpy(rng.random((2, 3, 77)) < 0.5)
    bits = mas.pack_bits(d)
    assert bits.shape == (2, 3, 3) and bits.dtype == torch.int32
    assert torch.equal(mas.unpack_bits(bits, 77), d)
    one = torch.zeros(1, 1, 64, dtype=torch.bool)
    one[0, 0, 31] = one[0, 0, 33] = True
    assert mas.pack_bits(one).tolist() == [[[-(2 ** 31), 2]]]


@pytest.mark.parametrize("name", ["pallas_test_small", "ties", "edges"])
def test_viterbi_decode_matches_jax(name):
    """ds equal; bin_loss and its gradient within 1e-6 (a sum of at most 64
    f32 terms per row, taken in another order)."""
    lp, tl, fl = _case(name)
    ds_want, loss_want = jax_viterbi_decode(
        jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl), backend="scan"
    )
    grad_want = jax.grad(
        lambda x: jax_viterbi_decode(x, jnp.asarray(tl), jnp.asarray(fl), backend="scan")[1]
    )(jnp.asarray(lp))
    lp_t, tl_t, fl_t = _torch_args(lp, tl, fl)
    lp_t.requires_grad_(True)
    for backend in ("auto", "scan"):
        lp_t.grad = None
        ds, loss = mas.viterbi_decode(lp_t, tl_t, fl_t, backend=backend)
        assert ds.dtype == torch.float32 and not ds.requires_grad
        np.testing.assert_array_equal(ds.numpy(), np.asarray(ds_want))
        np.testing.assert_allclose(loss.item(), float(loss_want), rtol=1e-6, atol=1e-6)
        loss.backward()
        np.testing.assert_allclose(lp_t.grad.numpy(), np.asarray(grad_want), rtol=1e-6, atol=1e-7)


def test_cuda_backend_on_cpu_tensors_raises():
    lp, tl, fl = _torch_args(*_case("pallas_test_small"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mas.viterbi_decode(lp, tl, fl, backend="cuda")
    with pytest.raises(ValueError, match="unknown MAS backend"):
        mas.viterbi_decode(lp, tl, fl, backend="pallas")


def test_cpu_route_counts_no_launch():
    lp, tl, fl = _torch_args(*_case("pallas_test_small"))
    mas.reset_launches()
    mas.viterbi_decode(lp, tl, fl)
    mas.mas_backtrace(mas.mas_decisions(lp, tl), tl, fl, lp.shape[2])
    assert mas.fwd_launches == 0 and mas.backtrace_launches == 0


@pytest.mark.parametrize("bad", ["rank", "lengths_shape", "lengths_float", "bits_dtype", "bits_words"])
def test_wrappers_reject_bad_shapes(bad):
    lp, tl, fl = _torch_args(*_case("pallas_test_small"))
    bits = mas.mas_decisions(lp, tl)
    with pytest.raises(ValueError):
        if bad == "rank":
            mas.mas_decisions(lp[0], tl)
        elif bad == "lengths_shape":
            mas.mas_decisions(lp, tl[:1])
        elif bad == "lengths_float":
            mas.mas_backtrace(bits, tl, fl.float(), lp.shape[2])
        elif bad == "bits_dtype":
            mas.mas_backtrace(bits.long(), tl, fl, lp.shape[2])
        else:
            mas.mas_backtrace(bits, tl, fl, 64)
