"""``dtype: bfloat16`` as a compute dtype (flax's meaning) in the port's
FastSpeech2, Matcha-TTS, Matcha-TTS+MAS, mel-VITS and aligner, against
jatts_tpu's models built with ``dtype=jnp.bfloat16`` on the CPU.

Both packages start from the same float32 weights (numpy-made, carried by
``utils/convert.py``) and see the same batch and the same injected noise
(the CFM's t and z, VITS's posterior eps) with every dropout rate 0. The
forwards are teacher-forced where the model takes durations; the MAS
models search theirs in both packages on lattices that agree to bf16
rounding (held equal below). Held to each other: the output dtypes, the
training outputs and the loss of one step within relative L2 error 2e-2,
and each parameter's gradient within 3e-2 or, where this is larger,
2.5 times JAX's own bf16 noise for that gradient, never above 0.5. That
noise is measured on JAX alone: the larger of JAX's bf16-vs-float32
distance and the largest move of JAX's bf16 gradient over 3 draws of the
weights each scaled by 1 + 2^-9 N(0, 1) (half a bf16 ulp). The port's own
bf16-vs-float32 distance is held to 3e-2 or 6 times that noise (never
above 0.5), and the float32 gradients of the two packages to 1e-4. A
gradient zeroed at the first, middle or last parameter is planted and must
fail. The port's parameters and gradients stay float32. The two gradients
that are 0 in exact arithmetic (the key projection's bias, the depthwise
convolution's bias before a train-mode BatchNorm) are held to 3e-2 of the
largest gradient's norm instead. Also: a FastSpeech2 conf with ``dtype:
bfloat16`` through ``bin/tts_train.py`` for 4 steps and a bitwise resume.

Why a noise clause: these tiny models' gradients are ill-conditioned (a
masked L1 loss sums signs; the durations are hard). Under a half-ulp
scaling of the weights JAX's own bf16 gradients move by up to 24%
(FastSpeech2), 26% (Matcha-TTS+MAS) and over 100% (Matcha-TTS's encoder).
The port's own bf16 gradients are noisier in places: on VITS's first
coupling the same scaling moves them by 3% where it moves JAX's by 0.7%,
and their distance from the port's float32 ones is up to 4.3 times JAX's
noise there; hence the separate factor for that distance.
Measured (``-s`` prints them): outputs <= 1.5e-2, losses <= 6.4e-3;
gradients <= 2.2e-1 (FastSpeech2), 2.6e-1 (Matcha-TTS), 1.5e-1
(Matcha-TTS+MAS), 4.7e-2 (VITS), 1.9e-2 (aligner); where over 3e-2, at
most 1.8 times JAX's noise.
"""

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu import aligner as jaligner  # noqa: E402
from jatts_tpu.losses import LOSS_REGISTRY as JLOSS  # noqa: E402
from jatts_tpu.losses.align import ForwardSumLoss as JForwardSumLoss  # noqa: E402
from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.models.matchatts import MatchaTTS as JMatchaTTS  # noqa: E402
from jatts_tpu.models.matchatts_mas import MatchaTTS_MAS as JMatchaTTS_MAS  # noqa: E402
from jatts_tpu.train.steps import fastspeech2_loss as jfastspeech2_loss  # noqa: E402
from jatts_tpu.train.steps_matcha import matchatts_loss as jmatchatts_loss  # noqa: E402
from jatts_tpu.train.steps_vits import vits_loss as jvits_loss  # noqa: E402
from jatts_torch import aligner as taligner  # noqa: E402
from jatts_torch.bin import tts_train  # noqa: E402
from jatts_torch.losses.align import ForwardSumLoss  # noqa: E402
from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.models.matchatts import MatchaTTS  # noqa: E402
from jatts_torch.models.matchatts_mas import MatchaTTS_MAS  # noqa: E402
from jatts_torch.train.steps import get_loss_fn  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint  # noqa: E402
from jatts_torch.utils.convert import (  # noqa: E402
    aligner_state_dict_from_jax, fastspeech2_state_dict_from_jax, matchatts_state_dict_from_jax,
    vits_state_dict_from_jax,
)
from tests.test_torch_data import FEATS, ODIM, write_corpus  # noqa: E402
from tests.test_torch_aligner import _batches, _jax_args, _jax_init, one_thread  # noqa: E402,F401
from tests.test_torch_matcha import inject_cfm_noise, jax_model_and_vars, make_batch, port_of  # noqa: E402
from tests.test_torch_train_modules import FS2_CONFIG, fs2_batch  # noqa: E402
from tests.test_torch_vits import inject_normal, jax_vits, port_vits  # noqa: E402
from tests.test_torch_vits import make_batch as vits_batch  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

OUT_TOL, GRAD_TOL, F32_TOL = 2e-2, 3e-2, 1e-4
NOISE_FACTOR, OWN_FACTOR, BOUND_CAP = 2.5, 6.0, 0.5
PERTURBED, HALF_ULP = 3, 2.0 ** -9
ZERO_GRADIENT = ("self_attn.linear_k.bias", "conv_module.depthwise_conv.bias")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def np_of(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def tensors(batch, keys):
    return {k: torch.from_numpy(batch[k].astype(np.int64 if batch[k].dtype.kind == "i" else np.float32))
            for k in keys}


def check_outputs(family, got, want, keys):
    """Output dtypes equal, each output within OUT_TOL; returns the largest error."""
    worst = 0.0
    for k in keys:
        g, w = got[k], want[k]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (family, k, g.dtype, w.dtype)
        e = rel(np_of(g), np.asarray(w, np.float32))
        assert e <= OUT_TOL, (family, k, e)
        worst = max(worst, e)
    return worst


def check_grads(family, model, grads, ref, port_f32):
    """The port's bf16 gradients against JAX's, each bound set by JAX
    alone (``ref``: :func:`jax_grads`) from JAX's own bf16 noise for that
    gradient: the larger of JAX's bf16-vs-float32 distance and the largest
    move of JAX's bf16 gradient when the weights are scaled by half a bf16
    ulp. The port's gradient is held to JAX's within GRAD_TOL or
    NOISE_FACTOR times that noise, and its own bf16-vs-float32 distance
    within GRAD_TOL or OWN_FACTOR times it; neither bound exceeds
    BOUND_CAP, so a zero gradient (one cut at a cast) fails anywhere. The
    float32 gradients of the two packages agree within F32_TOL. Returns
    the largest error, the share within GRAD_TOL, and the largest ratios
    of error and own distance to JAX's noise where they exceed GRAD_TOL."""
    want_sd, jax_f32, moved = ref["bf16"], ref["f32"], ref["moved"]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    names = [n for n, _ in model.named_parameters()]
    top = max(np.linalg.norm(want_sd[n].numpy()) for n in names)
    worst, flat, count, ratios = 0.0, 0, 0, [0.0, 0.0]
    for n, g in zip(names, grads):
        got = np.zeros(want_sd[n].shape, np.float32) if g is None else np_of(g)
        want = want_sd[n].numpy()
        assert g is None or g.dtype == torch.float32, (family, n, g.dtype)
        if n.endswith(ZERO_GRADIENT):
            assert np.linalg.norm(got - want) <= GRAD_TOL * top, (family, n)
            continue
        assert rel(port_f32[n], jax_f32[n].numpy()) <= F32_TOL, (family, n)
        noise = max(rel(want, jax_f32[n].numpy()), *(rel(m[n].numpy(), want) for m in moved))
        e, own = rel(got, want), rel(got, port_f32[n])
        assert e <= min(BOUND_CAP, max(GRAD_TOL, NOISE_FACTOR * noise)), (family, n, e, noise)
        assert own <= min(BOUND_CAP, max(GRAD_TOL, OWN_FACTOR * noise)), (family, n, own, noise)
        for i, v in enumerate((e, own)):
            if v > GRAD_TOL:
                ratios[i] = max(ratios[i], v / noise)
        worst, flat, count = max(worst, e), flat + (e <= GRAD_TOL), count + 1
    return worst, flat / count, ratios


def check_grads_catch_a_cut(family, model, grads, ref, port_f32):
    """A planted fault fails :func:`check_grads`: each in turn of the
    first, middle and last gradient zeroed, as when the flow through a
    cast is cut."""
    names = [n for n, _ in model.named_parameters() if not n.endswith(ZERO_GRADIENT)]
    for cut_name in (names[0], names[len(names) // 2], names[-1]):
        cut = [None if n == cut_name else g for (n, _), g in zip(model.named_parameters(), grads)]
        with pytest.raises(AssertionError):
            check_grads(family, model, cut, ref, port_f32)


def port_grads_f32(model, state_dict, loss_fn):
    """The port's float32 gradients on the same weights, by name."""
    model.load_state_dict(state_dict, strict=True)
    loss = loss_fn(model)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: np.zeros(tuple(p.shape), np.float32) if g is None else np_of(g)
            for n, p, g in zip(names, params, grads)}


def report(family, outs, loss, grads):
    worst, share, (e_ratio, own_ratio) = grads
    print(f"{family}: outputs {outs:.2e}, loss {loss:.2e}, gradients {worst:.2e} "
          f"({share:.0%} within {GRAD_TOL:g}; over it, at most {e_ratio:.2f}x JAX's noise from JAX's, "
          f"{own_ratio:.2f}x from the port's float32)")


def jax_grads(f, f32, params, to_sd):
    """JAX's side of a gradient check, for ``f(params) -> (loss, aux)`` in
    bf16 and ``f32`` in float32, each under one jit: the bf16 loss, and by
    state_dict name (``to_sd``) the bf16 gradients, the float32 ones, and
    the bf16 ones at PERTURBED draws of the weights each scaled by
    1 + 2^-9 N(0, 1) (half a bf16 ulp)."""
    step, step32 = (jax.jit(jax.value_and_grad(fn, has_aux=True)) for fn in (f, f32))

    def grads(fn, p):
        (loss, _), g = fn(p)
        return float(loss), to_sd({"params": jax.device_get(g)})

    loss, bf16 = grads(step, params)
    leaves, tree = jax.tree_util.tree_flatten(params)
    moved = []
    for seed in range(PERTURBED):
        rng = np.random.default_rng(seed)
        scaled = [np.asarray(x) * (1.0 + HALF_ULP * rng.standard_normal(np.shape(x))).astype(np.float32)
                  for x in leaves]
        moved.append(grads(step, jax.tree_util.tree_unflatten(tree, scaled))[1])
    return loss, {"bf16": bf16, "f32": grads(step32, params)[1], "moved": moved}


FS2_CRITS = ("MelLoss", "DurationPredictorLoss", "PitchLoss", "EnergyLoss")


def test_fastspeech2_bf16_compute_matches_jax(one_thread):
    batch = fs2_batch(seed=4)
    keys = ("xs", "ilens", "ys", "olens", "ds", "ps", "es")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodels = {dt: JFastSpeech2(**FS2_CONFIG, dtype=dt) for dt in (jnp.bfloat16, jnp.float32)}
    variables = randomize(jax.jit(lambda: jmodels[jnp.float32].init(jax.random.key(0), **jbatch))(), 5)

    def f(jmodel):
        def loss(params):
            out, (stats, _) = jfastspeech2_loss(jmodel, params, variables["batch_stats"], jbatch, jax.random.key(1),
                                                {n: JLOSS[n]() for n in FS2_CRITS}, {}, 0, False)
            return out, stats
        return loss

    jmodel = jmodels[jnp.bfloat16]
    want_out, _ = jax.jit(lambda v: jmodel.apply(v, **jbatch, deterministic=False, mutable=["batch_stats"]))(variables)
    jl, ref = jax_grads(f(jmodel), f(jmodels[jnp.float32]), variables["params"], fastspeech2_state_dict_from_jax)
    sd = fastspeech2_state_dict_from_jax(variables)
    port = FastSpeech2(**FS2_CONFIG, device="cpu", dtype=torch.bfloat16)
    port.load_state_dict(sd, strict=True)
    tb = tensors(batch, keys)
    got = port(**tb)
    outs = check_outputs("fastspeech2", got, want_out, ("before_outs", "after_outs", "d_outs", "p_outs", "e_outs"))

    def loss_of(model):
        return get_loss_fn("FastSpeech2Trainer")(model, tb, {n: LOSS_REGISTRY[n]() for n in FS2_CRITS}, {}, 0)[0]

    loss = loss_of(port)
    assert loss.dtype == torch.float32
    el = rel(float(loss.detach()), jl)
    assert el <= OUT_TOL
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    p32 = port_grads_f32(FastSpeech2(**FS2_CONFIG, device="cpu"), sd, loss_of)
    eg = check_grads("fastspeech2", port, grads, ref, p32)
    check_grads_catch_a_cut("fastspeech2", port, grads, ref, p32)
    report("fastspeech2", outs, el, eg)


MATCHA_CRITS = ("CFMLoss", "EncoderPriorLoss", "DurationPredictorLoss")


@pytest.mark.parametrize("mas", [False, True], ids=["matchatts", "matchatts_mas"])
def test_matcha_bf16_compute_matches_jax(one_thread, mas):
    jcls, cls = (JMatchaTTS_MAS, MatchaTTS_MAS) if mas else (JMatchaTTS, MatchaTTS)
    crit_names = MATCHA_CRITS + (("ForwardSumLoss",) if mas else ())
    config = {"dp_train_start_steps": 2, "bin_loss_start_steps": 1} if mas else {}
    step = 1
    model, variables = jax_model_and_vars(jcls, seed=6, dtype=jnp.bfloat16)
    model32, _ = jax_model_and_vars(jcls, seed=6)
    b = make_batch(6)
    keys = ("xs", "ilens", "ys", "olens", "ds")
    n_args = 4 if mas else 5
    jbatch = {k: jnp.asarray(b[k]) for k in keys}

    def f(jmodel):
        def loss(params):
            with inject_cfm_noise(b["t"], b["z"]):
                out, (stats, _) = jmatchatts_loss(jmodel, params, variables["batch_stats"], jbatch,
                                                  jax.random.key(0), {n: JLOSS[n]() for n in crit_names},
                                                  config, step, False)
            return out, stats
        return loss

    with inject_cfm_noise(b["t"], b["z"]):
        want_out, _ = jax.jit(lambda v: model.apply(v, *[jbatch[k] for k in keys[:n_args]], deterministic=False,
                                                    mutable=["batch_stats"],
                                                    rngs={"dropout": jax.random.key(0)}))(variables)
    jl, ref = jax_grads(f(model), f(model32), variables["params"], matchatts_state_dict_from_jax)
    tb = tensors(b, keys)
    noise = dict(noise_t=torch.from_numpy(b["t"]), noise_z=torch.from_numpy(b["z"]))

    def with_noise(port):
        real_forward = port.decoder.forward
        port.decoder.forward = lambda x1, mask, mu, t=None, z=None: real_forward(
            x1, mask, mu, t=noise["noise_t"], z=noise["noise_z"])
        return port

    port = port_of(cls, variables, dtype=torch.bfloat16).train()
    got = port(*[tb[k] for k in keys[:n_args]], **noise)
    if mas:
        np.testing.assert_array_equal(np_of(got["ds"]), np.asarray(want_out["ds"]))
    outs = check_outputs(cls.__name__, got, want_out,
                         ("d_outs", "hs", "cfm_loss") + (("bin_loss", "log_p_attn") if mas else ()))

    def loss_of(m):
        return get_loss_fn("MatchaTTSTrainer")(with_noise(m), tb, {n: LOSS_REGISTRY[n]() for n in crit_names},
                                                config, step)[0]

    loss = loss_of(port)
    el = rel(float(loss.detach()), jl)
    assert el <= OUT_TOL
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    p32 = port_grads_f32(port_of(cls, variables).train(), matchatts_state_dict_from_jax(variables), loss_of)
    eg = check_grads(cls.__name__, port, grads, ref, p32)
    check_grads_catch_a_cut(cls.__name__, port, grads, ref, p32)
    report(cls.__name__, outs, el, eg)


VITS_CRITS = ("MelLoss", "KLDivergenceLoss", "ForwardSumLoss", "DurationPredictorLoss")


def test_vits_bf16_compute_matches_jax(one_thread):
    config = {"dp_train_start_steps": 2, "bin_loss_start_steps": 1, "lambda_mel": 10.0}
    step = 1
    model, variables = jax_vits(seed=6, dtype=jnp.bfloat16)
    model32, _ = jax_vits(seed=6)
    b = vits_batch(6)
    keys = ("xs", "ilens", "ys", "olens")
    jbatch = {k: jnp.asarray(b[k]) for k in keys}

    def f(jmodel):
        def loss(params):
            with inject_normal(b["eps"]):
                out, (stats, _) = jvits_loss(jmodel, params, variables["batch_stats"], jbatch, jax.random.key(0),
                                             {n: JLOSS[n]() for n in VITS_CRITS}, config, step, False)
            return out, stats
        return loss

    with inject_normal(b["eps"]):
        want_out, _ = jax.jit(lambda v: model.apply(
            v, *[jbatch[k] for k in keys], deterministic=False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0), "noise": jax.random.key(1)}))(variables)
    jl, ref = jax_grads(f(model), f(model32), variables["params"], vits_state_dict_from_jax)
    tb = tensors(b, keys)
    eps = torch.from_numpy(b["eps"])
    port = port_vits(variables, mas_backend="scan", dtype=torch.bfloat16).train()
    got = port(*[tb[k] for k in keys], noise_eps=eps)
    np.testing.assert_array_equal(np_of(got["ds"]), np.asarray(want_out["ds"]))
    outs = check_outputs("vits", got, want_out,
                         ("outs", "d_outs", "bin_loss", "log_p_attn", "m_p", "logs_p", "m_q", "logs_q", "z", "z_p"))

    def loss_of(m):
        real_forward = m.forward
        m.forward = lambda *a, **kw: real_forward(*a, **kw, noise_eps=eps)
        return get_loss_fn("VITSTrainer")(m, tb, {n: LOSS_REGISTRY[n]() for n in VITS_CRITS}, config, step)[0]

    loss = loss_of(port)
    el = rel(float(loss.detach()), jl)
    assert el <= OUT_TOL
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    p32 = port_grads_f32(port_vits(variables, mas_backend="scan").train(), vits_state_dict_from_jax(variables),
                         loss_of)
    eg = check_grads("vits", port, grads, ref, p32)
    check_grads_catch_a_cut("vits", port, grads, ref, p32)
    report("vits", outs, el, eg)


def test_aligner_bf16_compute_matches_jax(one_thread):
    """The aligner's step loss (forward sum + bin loss) and gradients; its
    ``ln{i}`` take no ``dtype`` in JAX and return float32 in both."""
    _, _, batches = _batches()
    b0 = batches[-1]
    kw = dict(idim=7, odim=20, adim=32, elayers=2)
    jmodels = {dt: jaligner.Aligner(**kw, mas_backend="scan", dtype=dt) for dt in (jnp.bfloat16, jnp.float32)}
    params = _jax_init(jmodels[jnp.float32], b0, seed=3)
    args = _jax_args(b0)
    fsum = JForwardSumLoss()

    def f(jmodel):
        def loss(p):
            out = jmodel.apply({"params": p}, *args, deterministic=True)
            return fsum(out["log_p_attn"], args[1], args[3]) + out["bin_loss"], out
        return loss

    want = jax.jit(lambda p: f(jmodels[jnp.bfloat16])(p)[1])(params)
    jl, ref = jax_grads(f(jmodels[jnp.bfloat16]), f(jmodels[jnp.float32]), params, aligner_state_dict_from_jax)
    sd = aligner_state_dict_from_jax(jax.device_get(params))
    port = taligner.Aligner(**kw, device="cpu", dtype=torch.bfloat16).eval()
    port.load_state_dict(sd)
    xs, ilens, ys, olens = taligner._batch_tensors(b0, torch.device("cpu"))
    got = port(xs, ilens, ys, olens)
    np.testing.assert_array_equal(np_of(got["ds"]), np.asarray(want["ds"]))
    valid = np.broadcast_to(np.arange(b0["xs"].shape[1])[None, None, :] < b0["ilens"][:, None, None],
                            got["log_p_attn"].shape)
    assert got["log_p_attn"].dtype == torch.float32 and want["log_p_attn"].dtype == jnp.float32
    outs = rel(np_of(got["log_p_attn"])[valid], np.asarray(want["log_p_attn"])[valid])
    assert outs <= OUT_TOL

    def loss_of(m):
        out = m(xs, ilens, ys, olens)
        return ForwardSumLoss()(out["log_p_attn"], ilens, olens) + out["bin_loss"]

    loss = loss_of(port)
    el = rel(float(loss.detach()), jl)
    assert el <= OUT_TOL
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    p32 = port_grads_f32(taligner.Aligner(**kw, device="cpu").eval(), sd, loss_of)
    eg = check_grads("aligner", port, grads, ref, p32)
    check_grads_catch_a_cut("aligner", port, grads, ref, p32)
    report("aligner", outs, el, eg)


def fs2_cli_conf(**extra):
    """A tiny FastSpeech2 recipe conf for ``bin/tts_train.py`` on the CPU."""
    conf = {
        "sampling_rate": 24000, "hop_size": 300, "feat_list": FEATS, "out_feat_type": "mel",
        "model_type": "FastSpeech2", "trainer_type": "FastSpeech2Trainer",
        "collater_type": "FastSpeech2Collater",
        "model_params": dict(
            odim=ODIM, adim=16, aheads=2, elayers=1, eunits=32, dlayers=1, dunits=32,
            postnet_layers=2, postnet_chans=8, duration_predictor_chans=8,
            pitch_predictor_layers=2, pitch_predictor_chans=8, energy_predictor_chans=8,
            conformer_dec_kernel_size=7,
        ),
        "criterions": {"MelLoss": {"_type": "L1Loss"}, "DurationPredictorLoss": {},
                       "PitchLoss": {}, "EnergyLoss": {}},
        "batch_size": 3, "optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3},
        "grad_norm": 1.0, "scheduler": "warmuplr", "scheduler_params": {"warmup_steps": 4},
        "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 100,
        "log_interval_steps": 100,
    }
    for k, v in extra.items():
        if k == "model_params":
            conf[k] = {**conf[k], **v}
        else:
            conf[k] = v
    return conf


def test_training_cli_trains_bf16_compute_and_resumes_bitwise(tmp_path, monkeypatch, one_thread):
    """``dtype: bfloat16`` in a FastSpeech2 conf: 4 steps through
    ``bin/tts_train.py`` with float32 parameters (the trainer refuses
    others), then steps 2-3 replayed bit for bit from ``checkpoint-2steps``."""
    csv, stats, tokens = write_corpus(str(tmp_path / "corpus"), "npz")
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(fs2_cli_conf(model_params={"dtype": "bfloat16"})))
    outdir = tmp_path / "exp"
    trainers = []
    real_run = tts_train.run
    monkeypatch.setattr(tts_train, "run", lambda *a, **kw: trainers.append(real_run(*a, **kw)))
    tts_train.main(["--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
                    "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu", "--verbose", "0"])
    trainer = trainers[0]
    assert trainer.steps == 4 and trainer.model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert all(np.isfinite(v) for h in trainer.history for v in h.values())
    final = restore_checkpoint(find_latest_checkpoint(str(outdir)))
    assert final["steps"] == 4 and {v.dtype for v in final["model"].values() if v.is_floating_point()} == {
        torch.float32}

    config = trainer.config
    params = {k: v for k, v in config["model_params"].items() if k != "dtype"}
    model = FastSpeech2(**params, device="cpu", dtype=torch.bfloat16)
    resumed = Trainer(config, model, trainer.criterions, trainer.loss_fn, trainer.train_loader,
                      outdir=str(tmp_path / "resumed"), seed=0)
    resumed.init_state()
    resumed.load_checkpoint(str(outdir / "checkpoint-2steps"))
    trainer.train_loader.sampler.set_epoch(1)
    for batch, want in zip(trainer.train_loader, trainer.history[2:]):
        assert resumed.train_step(batch) == want
    assert resumed.steps == 4
    for k, v in final["model"].items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
