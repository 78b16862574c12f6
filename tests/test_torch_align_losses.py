"""jatts_torch.losses.align against jatts_tpu.losses.align on the CPU: the
beta-binomial prior, the CTC forward sum and ForwardSumLoss with its
gradient, including a zero-length and an infeasible row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_tpu.losses import align as jalign  # noqa: E402
from jatts_torch.losses import align as talign  # noqa: E402

NEG = -1e9


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _lattice(seed, b, t_feats, t_text, ilens):
    """log_p_attn as the alignment module gives it: masked tokens at -1e9
    before the softmax."""
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(b, t_feats, t_text)).astype(np.float32) * 2.0
    mask = np.arange(t_text)[None, None, :] < np.asarray(ilens)[:, None, None]
    return _log_softmax(np.where(mask, score, NEG))


# (ilens, olens, t_text, t_feats): full rows; ragged rows; a zero-length row
# (batch padding) and an infeasible row (olens < ilens)
LENGTHS = {
    "full": ([12, 12], [40, 40], 12, 40),
    "ragged": ([12, 7, 1, 3], [40, 33, 5, 3], 12, 40),
    "pad_and_infeasible": ([9, 0, 8, 5], [30, 0, 4, 30], 12, 32),
}


@pytest.mark.parametrize("name", list(LENGTHS))
def test_beta_binomial_prior_matches_jax(name):
    """Valid cells agree to 5e-5 at these sizes (T_feats <= 40; measured
    3.1e-5): both sides subtract f32 lgamma values of size up to ~110 whose
    roundings differ, and the difference grows with the lengths (3e-4 at
    30 x 200, 2e-3 at 100 x 1000, where each side is as far from a float64
    evaluation as from the other). Invalid cells are exactly -1e9."""
    ilens, olens, t_text, t_feats = LENGTHS[name]
    want = np.asarray(jalign.beta_binomial_prior(jnp.asarray(ilens), jnp.asarray(olens), t_text, t_feats))
    got = talign.beta_binomial_prior(torch.tensor(ilens), torch.tensor(olens), t_text, t_feats).numpy()
    assert got.shape == want.shape == (len(ilens), t_feats, t_text)
    np.testing.assert_array_equal(got == NEG, want == NEG)
    valid = want != NEG
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=5e-5)


@pytest.mark.parametrize("name", list(LENGTHS))
def test_ctc_forward_sum_matches_jax(name):
    """NLLs of size 50-200 agree to 1e-5 relative (f32 logsumexp chains of
    up to 40 frames)."""
    ilens, olens, t_text, t_feats = LENGTHS[name]
    rng = np.random.default_rng(1)
    lp = _log_softmax(rng.normal(size=(len(ilens), t_feats, t_text + 1)).astype(np.float32))
    want = np.asarray(jalign.ctc_forward_sum(jnp.asarray(lp), jnp.asarray(ilens), jnp.asarray(olens)))
    got = talign.ctc_forward_sum(torch.from_numpy(lp), torch.tensor(ilens), torch.tensor(olens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", list(LENGTHS))
def test_forward_sum_loss_value_and_gradient_match_jax(name):
    """Loss to 1e-5 relative; gradient to 1e-5 of its largest entry."""
    ilens, olens, t_text, t_feats = LENGTHS[name]
    lp = _lattice(2, len(ilens), t_feats, t_text, ilens)
    j_il, j_ol = jnp.asarray(ilens), jnp.asarray(olens)
    want, grad_want = jax.value_and_grad(lambda x: jalign.ForwardSumLoss()(x, j_il, j_ol))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_(True)
    got = talign.ForwardSumLoss()(x, torch.tensor(ilens), torch.tensor(olens))
    got.backward()
    assert np.isfinite(got.item()) and torch.isfinite(x.grad).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    grad_want = np.asarray(grad_want)
    np.testing.assert_allclose(x.grad.numpy(), grad_want, rtol=0, atol=1e-5 * max(np.abs(grad_want).max(), 1e-3))
    if name == "pad_and_infeasible":
        # the zero-length row and the infeasible row are inert
        assert not x.grad[1].any() and not x.grad[2].any()


def test_bin_loss_is_a_placeholder():
    assert talign.BinLoss()(1, 2) is None
