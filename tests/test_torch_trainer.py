"""jatts_torch's Trainer against jatts_tpu's Trainer (``mesh=None``) on the
CPU, in f32: both start from the same weights (the JAX trainer's
initialization, carried by ``utils/convert.py``), see the same batches with
every dropout rate 0, and run Adam under ``warmuplr`` (warmup 4) with
``grad_norm: 1.0``. Held to each other: the per-step loss and grad norm, the
final weights, BatchNorm running statistics and EMA weights; the same with
gradient accumulation over 2 steps. Also: the schedules against optax's,
the clip below, at and above ``max_norm`` against
``optax.clip_by_global_norm``, and a save/resume round trip. VALL-E AR: a
3-step trajectory against the JAX Trainer (AdamW with weight decay,
gradient accumulation over 2 steps, dropout 0, f32), and the training CLI
for 4 steps on the CPU (bf16 compute, ``attn_backend: flash``).

Tolerances: losses and grad norms rtol 1e-5; weights and running
statistics atol 2e-5 (Adam's m/sqrt(v) passes f32 gradient noise on
through a few steps at lr <= 7.5e-4). The one exception is the bias of each
conformer depthwise convolution: the train-mode BatchNorm right after it
removes it, so its true gradient is 0 and Adam turns the two frameworks'
rounding noise into steps of either sign; it is held to the sum of the
learning rates, which bounds any Adam update, and it changes no output.
That BatchNorm's running mean takes the bias in, so it is held to the same
bound.
"""

import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

from jatts_tpu.losses import LOSS_REGISTRY as JLOSS  # noqa: E402
from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.train import schedulers as jsched  # noqa: E402
from jatts_tpu.train.steps import fastspeech2_loss as jfastspeech2_loss  # noqa: E402
from jatts_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.train import schedulers  # noqa: E402
from jatts_torch.train.steps import fastspeech2_loss  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_tpu.models.valle import VALLEAR as JVALLEAR  # noqa: E402
from jatts_tpu.train.steps_valle import valle_loss as jvalle_loss  # noqa: E402
from jatts_torch.bin import tts_train  # noqa: E402
from jatts_torch.models.valle import VALLEAR  # noqa: E402
from jatts_torch.train.steps_valle import valle_loss  # noqa: E402
from jatts_torch.utils.checkpoint import find_latest_checkpoint  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax, valle_state_dict_from_jax  # noqa: E402
from tests.test_torch_data import write_codec_corpus  # noqa: E402
from tests.test_torch_train_modules import FS2_CONFIG, fs2_batch  # noqa: E402
from tests.test_torch_valle import CFG as VALLE_CONFIG  # noqa: E402
from tests.test_torch_valle import make_batch as valle_batch  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 2e-5
LOSSES = ("MelLoss", "DurationPredictorLoss", "PitchLoss", "EnergyLoss")


class FakeLoader:
    def __init__(self, batches):
        self.batches = batches
        self.sampler = self

    def set_epoch(self, e):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _config(**extra):
    cfg = {
        "train_max_steps": 3, "log_interval_steps": 100, "save_interval_steps": 1000,
        "eval_interval_steps": 0, "optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3},
        "grad_norm": 1.0, "scheduler": "warmuplr", "scheduler_params": {"warmup_steps": 4},
    }
    cfg.update(extra)
    return cfg


def _run_both(tmp_path, config, batches):
    """Run the JAX trainer and the port's over ``batches`` from the same
    initial weights; returns both trainers and the JAX per-step stats."""
    jmodel = JFastSpeech2(**FS2_CONFIG)
    jt = JTrainer(config, jmodel, {n: JLOSS[n]() for n in LOSSES}, jfastspeech2_loss,
                  FakeLoader(batches), outdir=str(tmp_path / "jax"), mesh=None, seed=0)
    jt.init_state(jt._prep(batches[0], 1))
    init_sd = fastspeech2_state_dict_from_jax(
        jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    )
    model = FastSpeech2(**{**FS2_CONFIG, "init_type": "none"}, device="cpu")
    model.load_state_dict(init_sd, strict=True)
    pt = Trainer(config, model, {n: LOSS_REGISTRY[n]() for n in LOSSES}, fastspeech2_loss,
                 FakeLoader(batches), outdir=str(tmp_path / "port"), seed=0)
    pt.init_state()
    jstats = []
    for i, b in enumerate(batches):
        jt.state, s = jt.train_step(jt.state, jt._prep(b, 1), jax.random.fold_in(jt.rng, i))
        jstats.append({k: float(v) for k, v in s.items()})
        pt.train_step(b)
    return jt, pt, jstats


def _assert_weights(got_sd, want_sd, total_lr):
    for key, want in want_sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        got = got_sd[key].detach().numpy()
        degenerate = key.endswith(("depthwise_conv.bias", "conv_module.norm.running_mean"))
        atol = total_lr * 1.01 if degenerate else PARAM_ATOL
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=atol, err_msg=key)


def test_three_step_trajectory_matches_jax_trainer(tmp_path):
    batches = [fs2_batch(seed=s) for s in range(3)]
    jt, pt, jstats = _run_both(tmp_path, _config(ema_decay=0.9), batches)
    for want, got in zip(jstats, pt.history):
        for key in ("train/loss", "train/grad_norm", "train/mel_loss", "train/duration_loss"):
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **LOSS_TOL)
    assert pt.steps == 3 and pt.updates == 3
    assert pt.history[0]["train/grad_norm"] > 1.0  # the clip acted
    total_lr = sum(schedulers.warmuplr(1e-3, 4)(i) for i in range(3))
    final = fastspeech2_state_dict_from_jax(
        jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    )
    _assert_weights(pt.model.state_dict(), final, total_lr)
    ema = fastspeech2_state_dict_from_jax({"params": jax.device_get(jt.state.ema_params)})
    _assert_weights(dict(zip(pt.names, pt.ema)), ema, total_lr)

    # save / resume: the same step count, bitwise-equal weights, and the
    # next step equal to the uninterrupted run's
    path = pt.save_checkpoint()
    assert path.endswith("checkpoint-3steps")
    model2 = FastSpeech2(**{**FS2_CONFIG, "init_type": "none"}, device="cpu")
    pt2 = Trainer(_config(ema_decay=0.9), model2, pt.criterions, fastspeech2_loss,
                  FakeLoader(batches), outdir=str(tmp_path / "port"), seed=0)
    pt2.init_state()
    pt2.load_checkpoint()
    assert (pt2.steps, pt2.updates) == (3, 3)
    for key, val in pt.model.state_dict().items():
        assert torch.equal(model2.state_dict()[key], val), key
    assert all(torch.equal(a, b) for a, b in zip(pt2.ema, pt.ema))
    s1, s2 = pt.train_step(batches[0]), pt2.train_step(batches[0])
    assert s1 == s2


def test_gradient_accumulation_matches_optax_multisteps(tmp_path):
    batches = [fs2_batch(seed=s) for s in range(4)]
    jt, pt, jstats = _run_both(tmp_path, _config(train_max_steps=4, gradient_accumulate_steps=2), batches)
    for want, got in zip(jstats, pt.history):
        np.testing.assert_allclose(got["train/loss"], want["train/loss"], **LOSS_TOL)
    assert pt.updates == 2 and pt.mini_step == 0
    total_lr = sum(schedulers.warmuplr(1e-3, 4)(i) for i in range(2))
    final = fastspeech2_state_dict_from_jax(
        jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    )
    _assert_weights(pt.model.state_dict(), final, total_lr)


@pytest.mark.parametrize("name,config", [
    ("warmuplr", {"scheduler": "warmuplr", "scheduler_params": {"warmup_steps": 4}}),
    ("steplr", {"scheduler": "steplr", "scheduler_params": {"step_size": 3, "gamma": 0.5}}),
    ("exponentiallr", {"scheduler": "exponentiallr", "scheduler_params": {"gamma": 0.9}}),
    ("e2tts_sequentiallr", {"scheduler": "e2tts_sequentiallr", "scheduler_params": {"warmup_steps": 4},
                            "train_max_steps": 10}),
    ("constant", {}),
])
def test_schedules_match_optax(name, config):
    config = {"optimizer_params": {"lr": 8e-4}, **config}
    got, want = schedulers.build_schedule(config), jsched.build_schedule(config)
    for step in range(11):
        # optax computes in f32: at 1e-8 (e2tts's first step) its rounding
        # error at the base rate's scale is a relative 0.5%
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-6 * 8e-4,
                                   err_msg=f"{name}@{step}")
    if name == "warmuplr":
        assert got(0) == got(1)  # the first update's step 0 clamps to 1


@pytest.mark.parametrize("ratio", [0.5, 1.0, 2.0])
def test_clip_matches_optax_below_at_and_above(ratio):
    rng = np.random.default_rng(7)
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    grads = [torch.from_numpy(a.copy()) for a in arrays]
    norm = float(schedulers.global_norm(grads))
    max_norm = norm if ratio == 1.0 else norm / ratio
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update([jax.numpy.asarray(a) for a in arrays], tx.init(arrays))
    got_norm = schedulers.clip_by_global_norm(grads, max_norm)
    np.testing.assert_allclose(float(got_norm), norm, rtol=0)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    if ratio == 0.5:  # below max_norm: untouched, not rescaled by ~1
        assert all(np.array_equal(g.numpy(), a) for g, a in zip(grads, arrays))


def test_trainer_refuses_other_dtypes_and_stops_on_request(tmp_path):
    bf16 = FastSpeech2(**FS2_CONFIG, device="cpu").to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        Trainer(_config(), bf16, {}, fastspeech2_loss, FakeLoader([]), outdir=str(tmp_path))
    model = FastSpeech2(**FS2_CONFIG, device="cpu")
    t = Trainer(_config(), model, {n: LOSS_REGISTRY[n]() for n in LOSSES}, fastspeech2_loss,
                FakeLoader([fs2_batch()]), outdir=str(tmp_path), seed=0)
    t.request_stop = True  # what the CLI's SIGTERM handler sets
    with pytest.raises(SystemExit) as e:
        t.run()
    assert e.value.code == 143 and t.steps == 1


def test_valle_ar_three_step_trajectory_matches_jax_trainer(tmp_path):
    """AdamW (weight decay 0.01) under warmuplr, clip at 1.0, gradients
    averaged over 2 steps: the per-step losses and grad norms, and the
    weights after one update plus one accumulated step."""
    config = _config(optimizer_type="AdamW", optimizer_params={"lr": 1e-3, "weight_decay": 0.01},
                     gradient_accumulate_steps=2, trainer_type="VALLETrainer")
    batches = [valle_batch(seed=s) for s in range(3)]
    jt = JTrainer(config, JVALLEAR(**VALLE_CONFIG), {}, jvalle_loss, FakeLoader(batches),
                  outdir=str(tmp_path / "jax"), mesh=None, seed=0)
    jt.init_state(jt._prep(batches[0], 1))
    n_layers = VALLE_CONFIG["n_layers"]
    model = VALLEAR(**VALLE_CONFIG, device="cpu")
    model.load_state_dict(valle_state_dict_from_jax({"params": jax.device_get(jt.state.params)}, n_layers))
    pt = Trainer(config, model, {}, valle_loss, FakeLoader(batches), outdir=str(tmp_path / "port"), seed=0)
    pt.init_state()
    for i, b in enumerate(batches):
        jt.state, js = jt.train_step(jt.state, jt._prep(b, 1), jax.random.fold_in(jt.rng, i))
        got = pt.train_step(b)
        for key in ("train/loss", "train/loss_ce", "train/grad_norm"):
            np.testing.assert_allclose(got[key], float(js[key]), err_msg=key, **LOSS_TOL)
    assert pt.updates == 1 and pt.mini_step == 1
    final = valle_state_dict_from_jax({"params": jax.device_get(jt.state.params)}, n_layers)
    _assert_weights(pt.model.state_dict(), final, 0.0)


def test_valle_ar_cli_runs_four_steps_on_cpu(tmp_path, monkeypatch):
    """The tts3 AR conf's keys at a small width: bf16 compute (float32
    parameters), flash attention (the plain causal version on the CPU),
    the prompt crop taken from model_params, rng_impl and
    steps_per_execution accepted."""
    csv, stats, tokens = write_codec_corpus(str(tmp_path / "corpus"), "npz")
    conf = {
        "sampling_rate": 24000, "feat_list": ["encodec"], "out_feat_type": "encodec",
        "model_type": "VALLEAR", "trainer_type": "VALLETrainer", "collater_type": "VALLECollater",
        "model_params": {**{k: v for k, v in VALLE_CONFIG.items() if k != "idim"},
                         "n_tokens": 1024, "prompt_max_frame_length": 24, "dtype": "bfloat16"},
        "criterions": {}, "batch_size": 3, "gradient_accumulate_steps": 2,
        "optimizer_type": "AdamW", "optimizer_params": {"lr": 1e-4, "weight_decay": 0.01},
        "grad_norm": 1.0, "scheduler": "warmuplr", "scheduler_params": {"warmup_steps": 4},
        "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 2,
        "log_interval_steps": 2, "rng_impl": "rbg", "steps_per_execution": 5,
    }
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    outdir = tmp_path / "exp"
    trainers = []
    real_run = tts_train.run
    monkeypatch.setattr(tts_train, "run", lambda *a, **kw: trainers.append(real_run(*a, **kw)))
    tts_train.main([
        "--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
        "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu",
        "--attn-backend", "flash", "--verbose", "0",
    ])
    trainer = trainers[0]
    assert trainer.model.dtype == torch.bfloat16
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert trainer.train_loader.collater.prompt_max == 24
    assert trainer.steps == 4 and trainer.updates == 2
    assert all(np.isfinite(h["train/loss_ce"]) for h in trainer.history)
    latest = find_latest_checkpoint(str(outdir))
    assert latest.endswith("checkpoint-4steps")
    state = torch.load(os.path.join(latest, "state.pt"), weights_only=True)
    assert "blocks.0.attn.block.to_qkv.weight" in state["model"] and state["steps"] == 4
