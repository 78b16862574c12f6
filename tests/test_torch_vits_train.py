"""mel-VITS training and its entry points on the CPU: ``vits_loss`` and its
gradients against the JAX package's (autograd against ``jax.grad``) on
either side of each gate of the schedule, for the deterministic and the
stochastic duration predictor; the trainer's noise generator reaching every
module that draws noise; the tts2 training CLI for 4 steps under gradient
accumulation with a bitwise resume; the decode CLI with Griffin-Lim; the
serving bundle's seed; the refusal of ``attn_backend``."""

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.losses import LOSS_REGISTRY as JLOSS  # noqa: E402
from jatts_tpu.train.steps_vits import vits_loss as jvits_loss  # noqa: E402
from jatts_torch.bin import tts_decode, tts_train  # noqa: E402
from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.vits import VITS  # noqa: E402
from jatts_torch.serving import BatchingServer, ServingBundle  # noqa: E402
from jatts_torch.serving.bundle import inference_kwargs  # noqa: E402
from jatts_torch.train.steps import get_loss_fn  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint, save_checkpoint  # noqa: E402
from jatts_torch.utils.convert import vits_state_dict_from_jax  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from tests.test_torch_matcha_train import PHONES, write_mel_corpus  # noqa: E402
from tests.test_torch_vits import (  # noqa: E402
    CONFIG, DUR_BIAS, ODIM, TINY, as_np, inject_normal, jax_vits, make_batch, port_vits, t,
)

CRITS = ("MelLoss", "KLDivergenceLoss", "ForwardSumLoss", "DurationPredictorLoss")
SCHEDULE = {"dp_train_start_steps": 2, "bin_loss_start_steps": 4, "lambda_align": 2.0, "lambda_mel": 10.0}
GATED = ("train/forward_sum_loss", "train/duration_loss", "train/binary_loss")
# gradients that are 0 in exact arithmetic: the key projection's bias
# (softmax ignores a shift of every score) and the depthwise convolution's
# bias (the training-mode BatchNorm after it subtracts the batch mean)
ZERO_GRADIENT = ("self_attn.linear_k.bias", "conv_module.depthwise_conv.bias")


def _both_steps(steps, **extra):
    """The JAX loss, stats and gradients (one jitted program, the step
    traced) and the port's, on the same weights, batch and noise."""
    model, variables = jax_vits(seed=6, **extra)
    stochastic = extra.get("duration_predictor_type") == "stochastic"
    b = make_batch(6, extra=(("e_q", (2, 6, 2)),))
    keys = ("xs", "ilens", "ys", "olens")
    jbatch = {k: jnp.asarray(b[k]) for k in keys}
    jcrits = {n: JLOSS[n]() for n in CRITS}
    noise = (b["eps"], b["e_q"]) if stochastic else (b["eps"],)

    def f(params, step):
        with inject_normal(*noise):
            loss, (stats, _) = jvits_loss(model, params, variables["batch_stats"], jbatch,
                                          jax.random.key(0), jcrits, SCHEDULE, step, False)
        return loss, stats

    jfn = jax.jit(jax.value_and_grad(f, has_aux=True))
    port = port_vits(variables, mas_backend="scan", **extra).train()
    real_forward = port.forward
    port.forward = lambda *a, **kw: real_forward(
        *a, **kw, noise_eps=t(b["eps"]), noise_e_q=t(b["e_q"]) if stochastic else None)
    tbatch = {k: torch.from_numpy(b[k].astype(np.int64 if b[k].dtype.kind == "i" else np.float32)) for k in keys}
    crits = {n: LOSS_REGISTRY[n]() for n in CRITS}
    names, params = zip(*port.named_parameters())
    for step in steps:
        (jl, jstats), jgrads = jfn(variables["params"], step)
        want = vits_state_dict_from_jax(jax.device_get({"params": jgrads}))
        loss, stats = get_loss_fn("VITSTrainer")(port, tbatch, crits, SCHEDULE, step)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        yield step, (float(jl), {k: float(v) for k, v in jstats.items()}), (
            float(loss.detach()), {k: float(v.detach()) for k, v in stats.items()}), {
            n: (np.zeros(tuple(p.shape), np.float32) if g is None else as_np(g), want[n].numpy())
            for n, p, g in zip(names, params, grads)}


def _check_step(step, jax_out, port_out, grads):
    """Loss and stats within 1e-5 of their scale; each gradient leaf within
    1e-4 of its own scale (the two leaves that are 0 in exact arithmetic
    within 1e-5 of the largest gradient)."""
    (jl, jstats), (pl, pstats) = jax_out, port_out
    assert abs(pl - jl) <= 1e-5 * max(1.0, abs(jl)), (step, pl, jl)
    assert set(pstats) == set(jstats)
    for k, v in jstats.items():
        assert abs(pstats[k] - v) <= 1e-5 * max(1.0, abs(v)), (step, k, pstats[k], v)
    top = max(np.abs(want).max() for _, want in grads.values())
    for name, (got, want) in grads.items():
        err = np.abs(got - want).max()
        if name.endswith(ZERO_GRADIENT):
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-5 * top, (step, name)
        else:
            assert err <= 1e-4 * np.abs(want).max(), (step, name, err, np.abs(want).max())
    return {k for k in GATED if pstats.get(k, 0.0) != 0.0}


def test_vits_loss_and_gradients_match_jax_across_the_gates():
    """Forward-sum while step < 2, duration loss when step > 2, bin loss
    when step > 4; steps 1, 2, 3 and 5 sit on either side of each."""
    on = {step: _check_step(step, j, p, g) for step, j, p, g in _both_steps((1, 2, 3, 5))}
    assert on == {1: {"train/forward_sum_loss"}, 2: set(), 3: {"train/duration_loss"},
                  5: {"train/duration_loss", "train/binary_loss"}}


def test_vits_stochastic_loss_and_gradients_match_jax():
    """The stochastic branch: gate · mean(dur_nll) (e_q injected), closed
    at step 2 and open at step 3."""
    on = {step: _check_step(step, j, p, g)
          for step, j, p, g in _both_steps((2, 3), duration_predictor_type="stochastic")}
    assert on == {2: set(), 3: {"train/duration_loss"}}


def test_trainer_noise_generator_reaches_every_noise_module(tmp_path):
    """The trainer's noise generator (re-seeded every step) is the one
    the posterior encoder and the stochastic duration predictor draw from:
    a step's eps and e_q depend on (seed, step) only."""
    model = VITS(**CONFIG, duration_predictor_type="stochastic", device="cpu")
    trainer = Trainer({"optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3}}, model, {}, None, None,
                      outdir=str(tmp_path), seed=3)
    holders = [m for m in model.modules() if hasattr(m, "noise_generator")]
    assert {type(m).__name__ for m in holders} == {"PosteriorEncoder", "StochasticDurationPredictor"}
    assert all(m.noise_generator is trainer.noise_generator for m in holders)
    b = make_batch(7)
    args = [torch.from_numpy(b[k].astype(np.int64 if b[k].dtype.kind == "i" else np.float32))
            for k in ("xs", "ilens", "ys", "olens")]
    draws = []
    for _ in range(2):
        trainer.noise_generator.manual_seed(11)
        with torch.no_grad():
            out = model.eval()(*args)
        draws.append((out["z"], out["dur_nll"]))
    assert torch.equal(draws[0][0], draws[1][0]) and torch.equal(draws[0][1], draws[1][1])


# ---------------------------------------------------------------------------
# the CLIs and serving
# ---------------------------------------------------------------------------

def _conf(**extra):
    conf = {
        "sampling_rate": 24000, "hop_size": 300, "fft_size": 512, "num_mels": ODIM,
        "feat_list": ["mel"], "out_feat_type": "mel",
        "model_type": "VITS", "trainer_type": "VITSTrainer", "collater_type": "FastSpeech2Collater",
        "model_params": {k: v for k, v in TINY.items() if k != "idim"},
        "criterions": {"MelLoss": {"_type": "L1Loss"}, "KLDivergenceLoss": {}, "ForwardSumLoss": {},
                       "DurationPredictorLoss": {}},
        "lambda_align": 2.0, "lambda_mel": 10.0, "noise_scale": 0.667, "batch_size": 3,
        "gradient_accumulate_steps": 2,
        "optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3}, "grad_norm": 1.0,
        "scheduler_type": "StepLR", "scheduler_params": {"step_size": 2, "gamma": 0.5},
        "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 2, "log_interval_steps": 2,
        # every gate's branch in 4 steps: forward-sum at step 0, duration
        # loss from step 2, bin loss at step 3
        "dp_train_start_steps": 1, "bin_loss_start_steps": 2,
        "rng_impl": "rbg", "steps_per_execution": 10,
    }
    conf.update(extra)
    return conf


def test_training_cli_four_steps_and_bitwise_resume(tmp_path, monkeypatch):
    """The conf's dropout rates (TINY keeps the model's 0.2 and 0.1) and
    accumulation 2: steps 2 and 3 replayed from checkpoint-2steps give the
    same stats and weights bit for bit."""
    csv, stats, tokens = write_mel_corpus(str(tmp_path / "corpus"))
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(_conf()))
    outdir = tmp_path / "exp"
    trainers = []
    real_run = tts_train.run
    monkeypatch.setattr(tts_train, "run", lambda *a, **kw: trainers.append(real_run(*a, **kw)))
    argv = ["--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
            "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu", "--verbose", "0"]
    tts_train.main(argv)
    trainer = trainers[0]
    assert type(trainer.model).__name__ == "VITS" and trainer.steps == 4 and trainer.updates == 2
    assert all(np.isfinite(v) for h in trainer.history for v in h.values())
    on = [{k for k in GATED if h[k] != 0.0} for h in trainer.history]
    assert on == [{"train/forward_sum_loss"}, set(), {"train/duration_loss"},
                  {"train/duration_loss", "train/binary_loss"}]
    assert all(h["train/kl_loss"] != 0.0 and h["train/mel_loss"] > 0.0 for h in trainer.history)
    final = restore_checkpoint(find_latest_checkpoint(str(outdir)))
    assert final["steps"] == 4

    config = trainer.config
    model = tts_train.MODELS["VITS"](**config["model_params"], device="cpu")
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

    with pytest.raises(ValueError, match="no attn_backend"):
        tts_train.main(argv + ["--attn-backend", "flash"])


def _seeded_model(idim=TINY["idim"]):
    torch.manual_seed(0)
    model = VITS(**{**CONFIG, "idim": idim}, device="cpu")
    with torch.no_grad():
        model.duration_predictor.linear.bias.fill_(float(DUR_BIAS))
    return model.eval()


def test_decode_cli_with_vits_and_griffin_lim(tmp_path):
    """Per batch the prior's noise is drawn from a generator seeded by the
    batch's first row index, scaled by the config's noise_scale."""
    csv, stats, tokens = write_mel_corpus(str(tmp_path / "corpus"), n_utts=5)
    model = _seeded_model(idim=len(PHONES) + 3)
    expdir = str(tmp_path / "exp")
    save_checkpoint(expdir, 1, {"model": model.state_dict()})
    config = _conf(noise_scale=0.5)
    assert inference_kwargs(config) == {"noise_scale": 0.5}
    out = tts_decode.run(csv, stats, tokens, config, str(tmp_path / "dec"), expdir=expdir,
                         batch_size=3, max_frames=48, vocoder="griffin_lim", device="cpu")
    assert out["vocoder"] == "GriffinLimVocoder" and len(out["olens"]) == 5
    from jatts_torch.data.dataset import TTSDataset

    items = [TTSDataset(csv, stats, ["mel"], tokens, is_inference=True)[i] for i in range(5)]
    for start in (0, 3):
        chunk = items[start:start + 3]
        xs = torch.zeros(len(chunk), 16, dtype=torch.long)
        for j, it in enumerate(chunk):
            xs[j, : len(it["x"])] = torch.from_numpy(it["x"])
        ilens = torch.tensor([len(it["x"]) for it in chunk])
        want = model.inference(xs, ilens, 48, noise_scale=0.5, generator=torch.Generator().manual_seed(start))
        for j, it in enumerate(chunk):
            n = int(want["olens"][j])
            assert n > 0 and out["olens"][it["utt_id"]] == n
            mel = np.load(tmp_path / "dec" / "wav" / f"{it['utt_id']}_mel.npy")
            np.testing.assert_array_equal(mel, as_np(want["feat_gen"][j, :n]))
            assert (tmp_path / "dec" / "wav" / f"{it['utt_id']}.wav").exists()


def test_bundle_seed_reaches_the_vits_noise():
    """The same seed gives the same bits and another seed another mel; the
    served mel is VITS.inference on a generator of that seed; the server
    keeps each request's seed."""
    model = _seeded_model()
    voc = HiFiGANGenerator(in_channels=ODIM, channels=16, upsample_scales=(3, 2), upsample_kernel_sizes=(6, 4),
                           resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), device="cpu")
    rng = np.random.default_rng(0)
    mean, scale = rng.normal(size=ODIM).astype(np.float32), rng.uniform(0.5, 2, ODIM).astype(np.float32)
    kw = inference_kwargs(_conf())
    bundle = ServingBundle(model, voc, mean, scale, batch_size=2, buckets=[16], max_frames=32,
                           wav_format="f32", infer_kwargs=kw)
    ids = [[2, 3, 4, 5], [3, 4, 5]]
    a, b, c = (bundle.synthesize(ids, seed=s) for s in (1, 1, 2))
    np.testing.assert_array_equal(a[0]["wav"], b[0]["wav"])
    assert np.abs(a[0]["mel"] - c[0]["mel"]).max() > 1e-6
    xs, ilens = bundle.prepare(ids)
    want = model.inference(xs, ilens, 32, **kw, generator=torch.Generator().manual_seed(1))
    for i in range(2):
        n = int(want["olens"][i])
        assert n > 0
        np.testing.assert_array_equal(a[i]["mel"], as_np(want["feat_gen"][i, :n]) * scale + mean)
    with BatchingServer(bundle, max_delay_ms=50) as server:
        futs = [server.submit(token_ids=ids[0], seed=1), server.submit(token_ids=ids[0], seed=2)]
        got = [f.result(timeout=60) for f in futs]
    np.testing.assert_array_equal(got[0]["wav"], a[0]["wav"])
    np.testing.assert_array_equal(got[1]["wav"], c[0]["wav"])
