"""jatts_torch attention, positional encodings, masks and length regulation
against their jatts_tpu counterparts on the CPU, in f32.

The JAX side runs its XLA path (``_flash_ok`` is False off the TPU), which
is K1's reference semantics; the port runs its eager path (``xla``) and
its ``flash`` path, which on CPU tensors is K1's plain twin."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.modules import attention as jattn  # noqa: E402
from jatts_tpu.modules import positional as jpos  # noqa: E402
from jatts_tpu.ops import masks as jmasks  # noqa: E402
from jatts_tpu.ops import upsample as jup  # noqa: E402
from jatts_torch.modules import attention as tattn  # noqa: E402
from jatts_torch.modules import positional as tpos  # noqa: E402
from jatts_torch.ops import masks as tmasks  # noqa: E402
from jatts_torch.ops import upsample as tup  # noqa: E402
from jatts_torch.ops.flash_attention import flash_attention_ref  # noqa: E402
from jatts_torch.utils.convert import flax_to_state_dict  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N_FEAT, N_HEAD, T = 32, 2, 11
LENS = np.array([T, 5, 1, 0])  # full, ragged, a single key, no valid key


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(LENS), T, N_FEAT)).astype(np.float32)
    mask = (np.arange(T)[None, :] < LENS[:, None])[:, None, :]
    return x, mask


def _port(cls, variables, backend):
    mod = cls(N_HEAD, N_FEAT, attn_backend=backend)
    mod.load_state_dict(flax_to_state_dict(variables), strict=True)
    return mod.eval()


@pytest.mark.parametrize("backend", ["xla", "flash", "auto"])
def test_legacy_rel_pos_mha_parity(backend):
    x, mask = _inputs()
    pe = np.array(jpos.LegacyRelPositionalEncoding(N_FEAT).apply({}, jnp.asarray(x))[1])
    jmod = jattn.LegacyRelPositionMultiHeadedAttention(N_HEAD, N_FEAT)
    xj = jnp.asarray(x)
    variables = randomize(
        jmod.init(jax.random.key(0), xj, xj, xj, jnp.asarray(pe), jnp.asarray(mask)), 1
    )
    want = np.asarray(jmod.apply(variables, xj, xj, xj, jnp.asarray(pe), jnp.asarray(mask)))
    port = _port(tattn.LegacyRelPositionMultiHeadedAttention, variables, backend)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = port(xt, xt, xt, torch.from_numpy(pe), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_mha_parity(backend):
    x, mask = _inputs(1)
    xj = jnp.asarray(x)
    jmod = jattn.MultiHeadedAttention(N_HEAD, N_FEAT)
    variables = randomize(jmod.init(jax.random.key(0), xj, xj, xj, jnp.asarray(mask)), 2)
    want = np.asarray(jmod.apply(variables, xj, xj, xj, jnp.asarray(mask)))
    port = _port(tattn.MultiHeadedAttention, variables, backend)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = port(xt, xt, xt, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_legacy_rel_shift_parity():
    x = np.random.default_rng(3).normal(size=(2, 3, 7, 7)).astype(np.float32)
    want = np.asarray(jattn.legacy_rel_shift(jnp.asarray(x)))
    np.testing.assert_array_equal(tattn.legacy_rel_shift(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("t_q,t_k", [(9, 9), (5, 13)])
def test_flash_attention_ref_matches_jax_attend(with_bias, t_q, t_k):
    """K1's plain twin equals the JAX eager core ``_attend`` on
    (q kᵀ + ab)·scale, a row with no valid key included (-> 0)."""
    rng = np.random.default_rng(4)
    b, h, d = 3, 2, 16
    q = rng.normal(size=(b, h, t_q, d)).astype(np.float32)
    k = rng.normal(size=(b, h, t_k, d)).astype(np.float32)
    v = rng.normal(size=(b, h, t_k, d)).astype(np.float32)
    ab = rng.normal(size=(b, h, t_q, t_k)).astype(np.float32) if with_bias else None
    key_mask = np.arange(t_k)[None, :] < np.array([t_k, 3, 0])[:, None]
    scale = d ** -0.5
    scores = np.einsum("bhqd,bhkd->bhqk", q, k)
    if ab is not None:
        scores = scores + ab
    want = np.asarray(jattn._attend(
        jnp.asarray(scores * scale), jnp.asarray(v), jnp.asarray(key_mask[:, None, :]),
        0.0, True,
    ))
    got = flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if ab is None else torch.from_numpy(ab), torch.from_numpy(key_mask), scale,
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("name", [
    "PositionalEncoding", "ScaledPositionalEncoding",
    "LegacyRelPositionalEncoding", "RelPositionalEncoding",
])
def test_positional_encoding_parity(name):
    x = np.random.default_rng(5).normal(size=(2, 13, N_FEAT)).astype(np.float32)
    jmod = getattr(jpos, name)(N_FEAT)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = getattr(tpos, name)(N_FEAT)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_masks_parity():
    lens = np.array([5, 0, 3])
    np.testing.assert_array_equal(
        tmasks.sequence_mask(torch.from_numpy(lens), 6).numpy(),
        np.asarray(jmasks.sequence_mask(jnp.asarray(lens), 6)),
    )
    np.testing.assert_array_equal(
        tmasks.attn_mask(torch.from_numpy(lens), 6).numpy(),
        np.asarray(jmasks.attn_mask(jnp.asarray(lens), 6)),
    )


@pytest.mark.parametrize("t_feats", [12, 30])
def test_regulate_length_parity(t_feats):
    rng = np.random.default_rng(6)
    ds = rng.integers(0, 5, size=(3, 7)).astype(np.int32)
    d_masks = np.arange(7)[None, :] < np.array([7, 4, 2])[:, None]
    hs = rng.normal(size=(3, 7, 5)).astype(np.float32)
    want_r = np.asarray(jup.duration_assignment(jnp.asarray(ds), t_feats, jnp.asarray(d_masks)))
    got_r = tup.duration_assignment(torch.from_numpy(ds), t_feats, torch.from_numpy(d_masks))
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    want = np.asarray(jup.regulate_length(jnp.asarray(hs), jnp.asarray(ds), t_feats, jnp.asarray(d_masks)))
    got = tup.regulate_length(torch.from_numpy(hs), torch.from_numpy(ds), t_feats, torch.from_numpy(d_masks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("alpha", [1.0, 1.3])
def test_predicted_durations_to_int_parity(alpha):
    # values at and near .5 after exp(d) - 1: both sides round half to even
    d = np.concatenate([
        np.random.default_rng(7).normal(1.0, 1.0, size=64),
        np.log([1.5, 2.5, 3.5, 0.2]),
    ]).astype(np.float32)[None]
    want = np.asarray(jup.predicted_durations_to_int(jnp.asarray(d), alpha))
    got = tup.predicted_durations_to_int(torch.from_numpy(d), alpha)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_gate():
    m = torch.ones(2, 1, 8, dtype=torch.bool)
    assert not tattn._flash_ok("xla", m, 4096)
    assert tattn._flash_ok("flash", m, 8)
    assert tattn._flash_ok("flash", None, 8)
    assert not tattn._flash_ok("flash", torch.ones(2, 8, 8, dtype=torch.bool), 8)
    assert not tattn._flash_ok("auto", m, tattn.FLASH_AUTO_MIN_LEN)
    assert tattn._flash_ok("auto", m, tattn.FLASH_AUTO_MIN_LEN + 1)
    with pytest.raises(ValueError):
        tattn._flash_ok("pallas", m, 8)
