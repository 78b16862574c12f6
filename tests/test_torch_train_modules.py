"""jatts_torch's training mode against jatts_tpu's on the CPU, in f32.

Train-mode conformer encoder and postnet against flax applied with
``deterministic=False, mutable=["batch_stats"]``: the outputs and the updated
BatchNorm running mean and variance (flax's biased variance and momentum
0.9, which torch's own BatchNorm1d does not give). The FastSpeech2 training
forward against the JAX ``__call__`` with every dropout rate 0, and the five
losses against ``jatts_tpu/losses/basic.py``. Weights are made with numpy
from a seed and carried by ``utils/convert.py``.

Tolerances: outputs rtol = atol = 1e-5 (f32, summation order only), running
statistics 1e-6, losses rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.losses import basic as jbasic  # noqa: E402
from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.modules.conformer import ConformerEncoder as JConformer  # noqa: E402
from jatts_tpu.modules.prenet_postnet import Postnet as JPostnet  # noqa: E402
from jatts_tpu.ops.masks import attn_mask as jattn_mask  # noqa: E402
from jatts_torch.losses import basic  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.modules.batchnorm import BatchNorm1d  # noqa: E402
from jatts_torch.modules.conformer import ConformerEncoder  # noqa: E402
from jatts_torch.modules.dropout import Dropout, set_dropout_generator  # noqa: E402
from jatts_torch.modules.prenet_postnet import Postnet  # noqa: E402
from jatts_torch.ops.masks import attn_mask  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-6, atol=1e-6)
NO_DROPOUT = dict(
    duration_predictor_dropout_rate=0.0, pitch_predictor_dropout=0.0,
    energy_predictor_dropout=0.0, postnet_dropout_rate=0.0,
    transformer_enc_dropout_rate=0.0, transformer_enc_positional_dropout_rate=0.0,
    transformer_enc_attn_dropout_rate=0.0, transformer_dec_dropout_rate=0.0,
    transformer_dec_positional_dropout_rate=0.0, transformer_dec_attn_dropout_rate=0.0,
)


def _sub_state_dict(variables, prefix):
    """A sub-module's flax variables as the port's state_dict of that module."""
    wrapped = {c: {prefix: t} for c, t in variables.items()}
    return {
        k[len(prefix) + 1:]: v
        for k, v in fastspeech2_state_dict_from_jax(wrapped).items()
    }


def _assert_running_stats(port, new_stats, prefix):
    want = _sub_state_dict({"batch_stats": new_stats}, prefix)
    got = port.state_dict()
    assert want and all(k.endswith(("running_mean", "running_var", "num_batches_tracked")) for k in want)
    for key, val in want.items():
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == 1, key  # one training call
            continue
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), err_msg=key, **STATS_TOL)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_train_mode_conformer_matches_flax(backend):
    adim, t, lens = 32, 13, np.array([13, 9, 4])
    cfg = dict(
        attention_dim=adim, attention_heads=2, linear_units=48, num_blocks=1,
        input_layer=None, pos_enc_layer_type="legacy_rel_pos",
        selfattention_layer_type="legacy_rel_selfattn", cnn_module_kernel=7,
        dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0,
    )
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(len(lens), t, adim)).astype(np.float32)
    jmod = JConformer(**cfg)
    mask_j = jattn_mask(jnp.asarray(lens), t)
    variables = randomize(jmod.init(jax.random.key(0), jnp.asarray(xs), mask_j), 1)
    want, new_vars = jmod.apply(
        variables, jnp.asarray(xs), mask_j, deterministic=False,
        mutable=["batch_stats"], rngs={"dropout": jax.random.key(1)},
    )
    port = ConformerEncoder(attn_backend=backend, **cfg)
    port.load_state_dict(_sub_state_dict(variables, "encoder"), strict=True)
    port.train()
    got = port(torch.from_numpy(xs), attn_mask(torch.from_numpy(lens), t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _assert_running_stats(port, new_vars["batch_stats"], "encoder")


def test_train_mode_postnet_matches_flax():
    odim, t = 8, 24
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(3, t, odim)).astype(np.float32) * 2.0 + 0.5
    jmod = JPostnet(odim=odim, n_layers=3, n_chans=16, n_filts=5, dropout_rate=0.0)
    variables = randomize(jmod.init(jax.random.key(0), jnp.asarray(xs)), 3)
    want, new_vars = jmod.apply(
        variables, jnp.asarray(xs), deterministic=False, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(1)},
    )
    port = Postnet(odim, 3, 16, 5, True, dropout_rate=0.0)
    port.load_state_dict(_sub_state_dict(variables, "postnet"), strict=True)
    port.train()
    got = port(torch.from_numpy(xs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _assert_running_stats(port, new_vars["batch_stats"], "postnet")


def test_batchnorm_running_variance_is_biased_not_torchs():
    """The trap the flax rule avoids: torch's BatchNorm1d would move its
    running variance with the unbiased batch variance and momentum 0.1."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, 5)).astype(np.float32))
    bn = BatchNorm1d(3).train()
    bn(x)
    biased = x.var(dim=(0, 2), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2)))
    ref = torch.nn.BatchNorm1d(3).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var)


def test_dropout_follows_mode_and_generator():
    x = torch.ones(4000)
    drop = Dropout(0.25)
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    a = drop(x)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.03 and torch.all((a == 0) | (a == 1 / 0.75))
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    assert torch.equal(drop(x), a)  # the generator decides the masks
    assert torch.equal(drop.eval()(x), x)


IDIM = 12
FS2_CONFIG = dict(
    idim=IDIM, odim=8, adim=32, aheads=2, elayers=1, eunits=48, dlayers=1,
    dunits=48, postnet_layers=2, postnet_chans=16, duration_predictor_chans=16,
    pitch_predictor_layers=2, pitch_predictor_chans=16, energy_predictor_chans=16,
    conformer_dec_kernel_size=7, **NO_DROPOUT,
)


def fs2_batch(seed=0, b=3, t_text=16, odim=8):
    """A padded FastSpeech2 batch as the collater makes one (numpy)."""
    rng = np.random.default_rng(seed)
    ilens = np.array([t_text, t_text - 5, 4][:b], np.int32)
    text_mask = np.arange(t_text)[None, :] < ilens[:, None]
    ds = rng.integers(1, 5, (b, t_text)).astype(np.int32) * text_mask
    olens = ds.sum(-1).astype(np.int32)
    t_feats = -(-int(olens.max()) // 16) * 16
    feats_mask = np.arange(t_feats)[None, :, None] < olens[:, None, None]
    return {
        "xs": (rng.integers(1, IDIM, (b, t_text)) * text_mask).astype(np.int32),
        "ilens": ilens,
        "ys": (rng.normal(size=(b, t_feats, odim)) * feats_mask).astype(np.float32),
        "olens": olens,
        "ds": ds,
        "ps": (rng.normal(size=(b, t_text, 1)) * text_mask[..., None]).astype(np.float32),
        "es": (rng.normal(size=(b, t_text, 1)) * text_mask[..., None]).astype(np.float32),
    }


def _torch_batch(batch):
    return {
        k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
        for k, v in batch.items()
    }


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_fastspeech2_training_forward_matches_jax_call(backend):
    batch = fs2_batch()
    jmodel = JFastSpeech2(**FS2_CONFIG)
    jargs = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = randomize(jmodel.init(jax.random.key(0), **jargs), 5)
    want, new_vars = jmodel.apply(
        variables, **jargs, deterministic=False, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(1)},
    )
    port = FastSpeech2(**FS2_CONFIG, attn_backend=backend, device="cpu")
    port.load_state_dict(fastspeech2_state_dict_from_jax(variables), strict=True)
    assert port.training  # a fresh model is in training mode, like the JAX call's default
    got = port(**_torch_batch(batch))
    assert set(got) == set(want)
    for key in ("before_outs", "after_outs", "d_outs", "p_outs", "e_outs"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    want_sd = fastspeech2_state_dict_from_jax({"batch_stats": new_vars["batch_stats"]})
    got_sd = port.state_dict()
    for key, val in want_sd.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got_sd[key].numpy(), val.numpy(), err_msg=key, **STATS_TOL)


def test_fastspeech2_stop_gradient_to_pitch_predictor_input():
    """``stop_gradient_from_pitch_predictor`` (the JSUT conf's setting): the
    pitch loss reaches the pitch predictor and not the encoder."""
    port = FastSpeech2(**FS2_CONFIG, device="cpu")
    out = port(**_torch_batch(fs2_batch()))
    enc = [p for p in port.encoder.parameters()]
    grads = torch.autograd.grad(out["p_outs"].sum(), enc + list(port.pitch_predictor.parameters()),
                                allow_unused=True)
    assert all(g is None for g in grads[: len(enc)])
    assert all(g is not None for g in grads[len(enc):])


@pytest.mark.parametrize("use_masking", [True, False])
def test_losses_match_jax(use_masking):
    rng = np.random.default_rng(6)
    b, tx, ty, odim = 3, 16, 40, 8
    ilens, olens = np.array([16, 9, 3]), np.array([40, 22, 7])
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    after, before, ys = arr(b, ty, odim), arr(b, ty, odim), arr(b, ty, odim)
    d_outs, ds = arr(b, tx), rng.integers(0, 6, (b, tx)).astype(np.int32)
    p_outs, ps, e_outs, es = arr(b, tx, 1), arr(b, tx, 1), arr(b, tx, 1), arr(b, tx, 1)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    j = jnp.asarray
    kw = dict(use_masking=use_masking)
    cases = [
        (basic.MelLoss(params=kw)(t(after), t(before), t(ys), t(olens)),
         jbasic.MelLoss(params=kw)(j(after), j(before), j(ys), j(olens))),
        (basic.L1Loss(**kw)(None, t(before), t(ys), t(olens)),
         jbasic.L1Loss(**kw)(None, j(before), j(ys), j(olens))),
        (basic.DurationPredictorLoss(**kw)(t(d_outs), t(ds), t(ilens)),
         jbasic.DurationPredictorLoss(**kw)(j(d_outs), j(ds), j(ilens))),
        (basic.PitchLoss(**kw)(t(p_outs), t(ps), t(ilens)),
         jbasic.PitchLoss(**kw)(j(p_outs), j(ps), j(ilens))),
        (basic.EnergyLoss(**kw)(t(e_outs), t(es), t(ilens)),
         jbasic.EnergyLoss(**kw)(j(e_outs), j(es), j(ilens))),
    ]
    for got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(basic.LOSS_REGISTRY) >= {"MelLoss", "DurationPredictorLoss", "PitchLoss", "EnergyLoss"}
