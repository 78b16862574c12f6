"""Matcha training and its entry points on the CPU: ``matchatts_loss`` and
its gradients against the JAX package's (autograd against ``jax.grad``) on
either side of each gate of the schedule, the tts1 and tts2 training CLIs
for 4 steps on an ``.npz`` corpus with bitwise resume, the decode CLI with
Griffin-Lim, and the serving bundle's seed."""

import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.losses import LOSS_REGISTRY as JLOSS  # noqa: E402
from jatts_tpu.models.matchatts import MatchaTTS as JMatchaTTS  # noqa: E402
from jatts_tpu.models.matchatts_mas import MatchaTTS_MAS as JMatchaTTS_MAS  # noqa: E402
from jatts_tpu.train.steps_matcha import matchatts_loss as jmatchatts_loss  # noqa: E402
from jatts_tpu.utils.io import write_csv  # noqa: E402
from jatts_torch.bin import tts_decode, tts_train  # noqa: E402
from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.matchatts import MatchaTTS  # noqa: E402
from jatts_torch.models.matchatts_mas import MatchaTTS_MAS  # noqa: E402
from jatts_torch.serving import BatchingServer, ServingBundle  # noqa: E402
from jatts_torch.train.steps import get_loss_fn  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint, save_checkpoint  # noqa: E402
from jatts_torch.utils.convert import matchatts_state_dict_from_jax  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from tests.test_torch_matcha import (  # noqa: E402
    CONFIG, DUR_BIAS, ODIM, TINY, as_np, inject_cfm_noise, jax_model_and_vars, make_batch, port_of,
)

CRITS = ("CFMLoss", "EncoderPriorLoss", "DurationPredictorLoss")
MAS_CRITS = CRITS + ("ForwardSumLoss",)
SCHEDULE = {"dp_train_start_steps": 2, "bin_loss_start_steps": 4, "lambda_align": 2.0}
# gradients that are 0 in exact arithmetic: the key projection's bias
# (softmax ignores a shift of every score) and the depthwise convolution's
# bias (the training-mode BatchNorm after it subtracts the batch mean)
ZERO_GRADIENT = ("self_attn.linear_k.bias", "conv_module.depthwise_conv.bias")


def _both_steps(jcls, cls, crit_names, config, steps):
    """The JAX loss, stats and gradients (one jitted program, the step
    traced) and the port's, on the same weights, batch and CFM noise."""
    model, variables = jax_model_and_vars(jcls, seed=6)
    b = make_batch(6)
    keys = ("xs", "ilens", "ys", "olens", "ds")
    jbatch = {k: jnp.asarray(b[k]) for k in keys}
    jcrits = {n: JLOSS[n]() for n in crit_names}

    def f(params, step):
        with inject_cfm_noise(b["t"], b["z"]):
            loss, (stats, _) = jmatchatts_loss(model, params, variables["batch_stats"], jbatch,
                                               jax.random.key(0), jcrits, config, step, False)
        return loss, stats

    jfn = jax.jit(jax.value_and_grad(f, has_aux=True))
    port = port_of(cls, variables).train()
    real_forward = port.decoder.forward
    port.decoder.forward = lambda x1, mask, mu, t=None, z=None: real_forward(
        x1, mask, mu, t=torch.from_numpy(b["t"]), z=torch.from_numpy(b["z"]))
    tbatch = {k: torch.from_numpy(b[k].astype(np.int64 if b[k].dtype.kind == "i" else np.float32)) for k in keys}
    crits = {n: LOSS_REGISTRY[n]() for n in crit_names}
    names, params = zip(*port.named_parameters())
    for step in steps:
        (jl, jstats), jgrads = jfn(variables["params"], step)
        want = matchatts_state_dict_from_jax(jax.device_get({"params": jgrads}))
        loss, stats = get_loss_fn("MatchaTTSTrainer")(port, tbatch, crits, config, step)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        yield step, (float(jl), {k: float(v) for k, v in jstats.items()}), (
            float(loss.detach()), {k: float(v.detach()) for k, v in stats.items()}), {
            n: (np.zeros(tuple(p.shape), np.float32) if g is None else as_np(g), want[n].numpy())
            for n, p, g in zip(names, params, grads)}


def _check_step(step, jax_out, port_out, grads):
    (jl, jstats), (pl, pstats) = jax_out, port_out
    assert abs(pl - jl) <= 1e-5 * max(1.0, abs(jl)), (step, pl, jl)
    assert set(pstats) == set(jstats)
    for k, v in jstats.items():
        assert abs(pstats[k] - v) <= 1e-5 * max(1.0, abs(v)), (step, k, pstats[k], v)
    top = max(np.abs(want).max() for _, want in grads.values())
    for name, (got, want) in grads.items():
        err = np.abs(got - want).max()
        if name.endswith(ZERO_GRADIENT):
            # both sides hold rounding noise: small against the model's gradients
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-5 * top, (step, name)
        else:
            assert err <= 1e-4 * np.abs(want).max(), (step, name, err, np.abs(want).max())
    return jstats


def test_matchatts_loss_and_gradients_match_jax():
    """tts1: the duration loss is gated on step > dp_train_start_steps (0 by
    default: off at step 0 only)."""
    seen = {}
    for step, j, p, g in _both_steps(JMatchaTTS, MatchaTTS, CRITS, {}, (0, 1)):
        seen[step] = _check_step(step, j, p, g)
    assert seen[0]["train/duration_loss"] == 0.0 and seen[1]["train/duration_loss"] > 0.0


def test_matchatts_mas_loss_and_gradients_match_jax_across_the_gates():
    """tts2: forward-sum while step < 2, duration loss when step > 2, bin
    loss when step > 4; steps 1, 2, 3 and 5 sit on either side of each."""
    seen = {}
    for step, j, p, g in _both_steps(JMatchaTTS_MAS, MatchaTTS_MAS, MAS_CRITS, SCHEDULE, (1, 2, 3, 5)):
        seen[step] = _check_step(step, j, p, g)
    on = {s: {k for k, v in st.items() if v != 0.0} for s, st in seen.items()}
    gated = {"train/forward_sum_loss", "train/duration_loss", "train/binary_loss"}
    assert on[1] & gated == {"train/forward_sum_loss"}
    assert on[2] & gated == set()
    assert on[3] & gated == {"train/duration_loss"}
    assert on[5] & gated == {"train/duration_loss", "train/binary_loss"}


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

PHONES = ["a", "i", "u", "e", "o", "k", "s", "t"]


def write_mel_corpus(root, n_utts=6, seed=0):
    """Mel-only ``.npz`` dumps with csv durations (the frames' sum), the
    mel statistics and tokens.txt. Returns (csv, stats, tokens)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "dump"), exist_ok=True)
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank>", "<unk>", *PHONES, "<sos/eos>"]) + "\n")
    rows, mels = [], []
    for i in range(n_utts):
        n = int(rng.integers(3, 9))
        durs = rng.integers(1, 6, n)
        mel = rng.normal(-4.0, 2.0, (int(durs.sum()), ODIM)).astype(np.float32)
        path = os.path.join(root, "dump", f"U{i}.npz")
        np.savez(path, mel=mel)
        rows.append({"sample_id": f"U{i}", "spk": "s", "phonemes": " ".join(rng.choice(PHONES, n)),
                     "durations": " ".join(map(str, durs)), "feat_path": path})
        mels.append(mel)
    cat = np.concatenate(mels)
    stats = os.path.join(root, "stats.npz")
    np.savez(stats, mel_mean=cat.mean(0).astype(np.float32), mel_scale=cat.std(0).astype(np.float32))
    csv = os.path.join(root, "train.csv")
    write_csv(rows, csv)
    return csv, stats, tokens


def _conf(model_type, **extra):
    crits = MAS_CRITS if model_type == "MatchaTTS_MAS" else CRITS
    conf = {
        "sampling_rate": 24000, "hop_size": 300, "fft_size": 512, "num_mels": ODIM,
        "feat_list": ["mel"], "out_feat_type": "mel",
        "model_type": model_type, "trainer_type": "MatchaTTSTrainer", "collater_type": "FastSpeech2Collater",
        "model_params": {k: (list(v) if isinstance(v, tuple) else v) for k, v in TINY.items() if k != "idim"},
        "criterions": {n: {} for n in crits}, "batch_size": 3,
        "optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3}, "grad_norm": 1.0,
        "scheduler_type": "StepLR", "scheduler_params": {"step_size": 2, "gamma": 0.5},
        "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 2, "log_interval_steps": 2,
        "temperature": 0.667, "ode_steps": 2, "rng_impl": "rbg", "steps_per_execution": 10,
    }
    conf.update(extra)
    return conf


@pytest.mark.parametrize("model_type,extra", [
    ("MatchaTTS", {}),
    # every gate's branch in 4 steps: forward-sum at step 0, duration loss
    # from step 2, bin loss at step 3
    ("MatchaTTS_MAS", {"dp_train_start_steps": 1, "bin_loss_start_steps": 2, "lambda_align": 2.0}),
])
def test_training_cli_four_steps_and_bitwise_resume(tmp_path, monkeypatch, model_type, extra):
    csv, stats, tokens = write_mel_corpus(str(tmp_path / "corpus"))
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(_conf(model_type, **extra)))
    outdir = tmp_path / "exp"
    trainers = []
    real_run = tts_train.run
    monkeypatch.setattr(tts_train, "run", lambda *a, **kw: trainers.append(real_run(*a, **kw)))
    argv = ["--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
            "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu", "--verbose", "0"]
    tts_train.main(argv)
    trainer = trainers[0]
    assert type(trainer.model).__name__ == model_type and trainer.steps == 4
    assert all(np.isfinite(v) for h in trainer.history for v in h.values())
    if model_type == "MatchaTTS_MAS":
        on = [{k for k in ("train/forward_sum_loss", "train/duration_loss", "train/binary_loss") if h[k] != 0.0}
              for h in trainer.history]
        assert on == [{"train/forward_sum_loss"}, set(), {"train/duration_loss"},
                      {"train/duration_loss", "train/binary_loss"}]
    else:
        assert "train/forward_sum_loss" not in trainer.history[0]
    final = restore_checkpoint(find_latest_checkpoint(str(outdir)))
    assert final["steps"] == 4

    # resume from step 2 and take steps 2 and 3 on their batches (epoch 1):
    # the dropout masks and the CFM noise of a step come from the step
    config = trainer.config
    model = tts_train.MODELS[model_type](**config["model_params"], device="cpu")
    resumed = Trainer(config, model, trainer.criterions, trainer.loss_fn, trainer.train_loader,
                      outdir=str(tmp_path / "resumed"), seed=0)
    resumed.init_state()
    resumed.load_checkpoint(str(outdir / "checkpoint-2steps"))
    trainer.train_loader.sampler.set_epoch(1)
    for batch, want in zip(trainer.train_loader, trainer.history[2:]):
        got = resumed.train_step(batch)
        assert got == want
    assert resumed.steps == 4
    for k, v in final["model"].items():
        assert torch.equal(resumed.model.state_dict()[k], v), k

    with pytest.raises(ValueError, match="no attn_backend"):
        tts_train.main(argv + ["--attn-backend", "flash"])


def test_refusals_name_what_is_left(tmp_path):
    """Every model and trainer type is ported: an unknown one is refused
    with the list of those the port trains; the tts1 decode CLI names the
    CLI that decodes E2TTS."""
    csv, stats, tokens = write_mel_corpus(str(tmp_path / "corpus"))
    with pytest.raises(ValueError, match="unknown model_type 'E2'.*MatchaTTS_MAS.*E2TTS"):
        tts_train.run(csv, csv, stats, tokens, _conf("E2"), str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError, match="this CLI: it decodes FastSpeech2, MatchaTTS, MatchaTTS_MAS, VITS .E2TTS: "
                                         "bin/e2tts_decode.py"):
        tts_decode.run(csv, stats, tokens, _conf("E2TTS"), str(tmp_path / "b"), device="cpu")
    with pytest.raises(ValueError, match="unknown trainer_type 'E2'.*E2TTSTrainer"):
        get_loss_fn("E2")
    assert get_loss_fn("E2TTSTrainer").__name__ == "e2tts_loss"


def _seeded_model(cls=MatchaTTS, idim=TINY["idim"]):
    torch.manual_seed(0)
    model = cls(**{**CONFIG, "idim": idim}, device="cpu")
    with torch.no_grad():
        model.duration_predictor.linear.bias.fill_(float(DUR_BIAS))
    return model.eval()


def test_decode_cli_with_matcha_and_griffin_lim(tmp_path):
    """Per batch the ODE noise is drawn from a generator seeded by the
    batch's first row index (the JAX CLI's jax.random.key(i))."""
    csv, stats, tokens = write_mel_corpus(str(tmp_path / "corpus"), n_utts=5)
    model = _seeded_model(idim=len(PHONES) + 3)
    expdir = str(tmp_path / "exp")
    save_checkpoint(expdir, 1, {"model": model.state_dict()})
    config = _conf("MatchaTTS")
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
        want = model.inference(xs, ilens, 48, n_timesteps=2, temperature=0.667,
                               generator=torch.Generator().manual_seed(start))
        for j, it in enumerate(chunk):
            n = int(want["olens"][j])
            assert n > 0 and out["olens"][it["utt_id"]] == n
            mel = np.load(tmp_path / "dec" / "wav" / f"{it['utt_id']}_mel.npy")
            np.testing.assert_array_equal(mel, as_np(want["feat_gen"][j, :n]))
            assert (tmp_path / "dec" / "wav" / f"{it['utt_id']}.wav").exists()


def test_bundle_seed_reaches_the_ode_noise():
    """The same seed gives the same bits and another seed other audio; the
    served mel is MatchaTTS.inference on a generator of that seed; the
    server keeps each request's seed."""
    model = _seeded_model(MatchaTTS_MAS)
    voc = HiFiGANGenerator(in_channels=ODIM, channels=16, upsample_scales=(3, 2), upsample_kernel_sizes=(6, 4),
                           resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), device="cpu")
    rng = np.random.default_rng(0)
    mean, scale = rng.normal(size=ODIM).astype(np.float32), rng.uniform(0.5, 2, ODIM).astype(np.float32)
    bundle = ServingBundle(model, voc, mean, scale, batch_size=2, buckets=[16], max_frames=32,
                           wav_format="f32", infer_kwargs={"n_timesteps": 2, "temperature": 0.667})
    ids = [[2, 3, 4, 5], [3, 4, 5]]
    a, b, c = (bundle.synthesize(ids, seed=s) for s in (1, 1, 2))
    np.testing.assert_array_equal(a[0]["wav"], b[0]["wav"])
    assert np.abs(a[0]["mel"] - c[0]["mel"]).max() > 1e-6
    xs, ilens = bundle.prepare(ids)
    want = model.inference(xs, ilens, 32, n_timesteps=2, temperature=0.667, generator=torch.Generator().manual_seed(1))
    for i in range(2):
        n = int(want["olens"][i])
        assert n > 0
        np.testing.assert_array_equal(a[i]["mel"], as_np(want["feat_gen"][i, :n]) * scale + mean)
    with BatchingServer(bundle, max_delay_ms=50) as server:
        futs = [server.submit(token_ids=ids[0], seed=1), server.submit(token_ids=ids[0], seed=2)]
        got = [f.result(timeout=60) for f in futs]
    np.testing.assert_array_equal(got[0]["wav"], a[0]["wav"])
    np.testing.assert_array_equal(got[1]["wav"], c[0]["wav"])
