"""jatts_torch's multi-process training (``parallel/mesh.py``, the Trainer
with a mesh, ``bin/tts_train.py --multihost``) on the CPU over gloo.

Ranks are separate interpreters (``tests/torch_parallel_worker.py``, no
jax import), each on a free port with a 45 s collective timeout (a hang in
a collective fails in under a minute), joined with a deadline. One module fixture
starts them all at once (a 2-rank FastSpeech2 world, a 4-rank VALL-E and
E2-TTS world, a 2-rank CLI run) and computes the references while they
run:

- the port's one-process run on the same global batches: a step over the
  mesh must equal it with dropout and the training noise on, BatchNorm in
  training mode and ranks holding unequal valid counts: dp2 FastSpeech2,
  dp2 x tp2 VALL-E AR (gradient accumulation over 2, EMA, the clip acting:
  a sharded parameter counts once in its norm), dp2 x sp2 E2-TTS (the time
  axis cut over "model", the text too, the halo of the position
  convolution partial at N/2 = 32);
- the JAX Trainer on a 4-device ``get_mesh(n_data=2, n_model=2)`` with
  dropout off and E2-TTS's draws injected on both sides
  (tests/test_torch_e2tts.py:inject_draws); FastSpeech2 on JAX's
  ``(4, 1)`` mesh, since on ``(2, 2)`` JAX's own gradient of the
  depthwise convolution kernel leaves its one-process value;
- a dp2 x tp2 checkpoint resumed at one rank and that one back at dp2 x
  tp2, against the uninterrupted one-process run; a stop asked on one rank
  ends every rank at the same step; ``bin/tts_train.py --multihost`` with
  ``valle_ar.given.bs128.dp4tp2.yaml`` at small widths on 2 ranks for 4
  steps against the one-process CLI; dp2 mel-VITS, Matcha-TTS+MAS and the
  VALL-E NAR against their one-process runs; tp2 VALL-E AR with
  ``use_remat`` (each block recomputed in the backward, its gathers
  repeated) and sp2 E2-TTS with ``use_remat`` and ``dots_saveable`` against
  the plain one-process runs.

Tolerances: losses and grad norms rtol 1e-5, weights atol 2e-5
(tests/test_torch_trainer.py), the JAX runs' with its exceptions.
"""

import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import jatts_tpu.train.steps_e2tts as jsteps_e2tts  # noqa: E402
from jatts_tpu.losses import LOSS_REGISTRY as JLOSS  # noqa: E402
from jatts_tpu.models import e2tts as je2  # noqa: E402
from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.models.valle import VALLEAR as JVALLEAR  # noqa: E402
from jatts_tpu.parallel import mesh as jmesh  # noqa: E402
from jatts_tpu.train.steps import fastspeech2_loss as jfastspeech2_loss  # noqa: E402
from jatts_tpu.train.steps_valle import valle_kwargs as jvalle_kwargs  # noqa: E402
from jatts_tpu.train.steps_valle import valle_loss as jvalle_loss  # noqa: E402
from jatts_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from jatts_tpu.utils.torch_import import convert_valle  # noqa: E402
from jatts_torch.bin import tts_train  # noqa: E402
from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.e2tts import E2TTS  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.models.valle import VALLEAR  # noqa: E402
from jatts_torch.modules.dropout import set_dropout_rate  # noqa: E402
from jatts_torch.parallel import mesh  # noqa: E402
from jatts_torch.train import schedulers  # noqa: E402
from jatts_torch.train.steps import get_loss_fn  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.checkpoint import restore_checkpoint  # noqa: E402
from jatts_torch.utils.convert import (  # noqa: E402
    e2tts_state_dict_from_jax, fastspeech2_state_dict_from_jax, valle_state_dict_from_jax,
)
from tests.test_torch_data import write_codec_corpus  # noqa: E402
from tests.test_torch_trainer import LOSS_TOL, LOSSES, PARAM_ATOL, FakeLoader, _config  # noqa: E402
from tests.test_torch_train_modules import FS2_CONFIG, IDIM  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
# a rank stuck in a collective fails at the workers' 45 s timeout; the join's
# deadline is the backstop, with room for the suite's load (~20 s alone)
DEADLINE = 120.0
DROPOUT = 0.1
VALLE = dict(idim=10, n_tokens=64, d_model=160, n_heads=2, n_layers=2, p_dropout=0.0, n_resp_levels=1)
E2 = dict(idim=20, odim=8, dim=256, depth=2, heads=2, ff_mult=2, pe_attn_head=1)
FS2 = {**FS2_CONFIG, "init_type": "none"}  # the port starts from the JAX trainer's weights
B = 4  # rows; the ranks of the data axis get unequal valid counts


def fs2_batch(seed):
    rng = np.random.default_rng(seed)
    t_text = 16
    ilens = np.array([16, 13, 6, 4], np.int32)
    text_mask = np.arange(t_text)[None, :] < ilens[:, None]
    ds = rng.integers(1, 5, (B, t_text)).astype(np.int32) * text_mask
    olens = ds.sum(-1).astype(np.int32)
    t_feats = -(-int(olens.max()) // 16) * 16
    feats_mask = np.arange(t_feats)[None, :, None] < olens[:, None, None]
    return {
        "xs": (rng.integers(1, IDIM, (B, t_text)) * text_mask).astype(np.int32), "ilens": ilens,
        "ys": (rng.normal(size=(B, t_feats, 8)) * feats_mask).astype(np.float32), "olens": olens, "ds": ds,
        "ps": (rng.normal(size=(B, t_text, 1)) * text_mask[..., None]).astype(np.float32),
        "es": (rng.normal(size=(B, t_text, 1)) * text_mask[..., None]).astype(np.float32),
    }


def valle_batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        text=rng.integers(0, 64, (B, 16)).astype(np.int32), text_lens=np.array([16, 12, 5, 4], np.int32),
        proms=rng.integers(0, 64, (B, 24, 8)).astype(np.int32), prom_lens=np.array([20, 24, 9, 7], np.int32),
        resps=rng.integers(0, 64, (B, 24)).astype(np.int32), resp_lens=np.array([24, 19, 11, 6], np.int32),
    )


# the other families at dp2 against the one-process run only: their
# widths as tests/test_torch_{vits,matcha}_card.py and test_torch_valle_nar.py
MEL_SMALL = dict(idim=25, odim=8, adim=16, aheads=2)
OTHERS = {
    "vits": ("jatts_torch.models.vits.VITS", dict(
        MEL_SMALL, text_encoder_blocks=1, text_encoder_ffn_expand=2, dlayers=1, dunits=32, duration_predictor_chans=8,
        posterior_encoder_layers=2, flow_flows=2, flow_layers=2, conformer_dec_kernel_size=7,
        duration_predictor_type="stochastic"), "VITSTrainer", ("MelLoss", "KLDivergenceLoss", "ForwardSumLoss")),
    "matcha_mas": ("jatts_torch.models.matchatts_mas.MatchaTTS_MAS", dict(
        MEL_SMALL, elayers=1, eunits=32, duration_predictor_chans=8, decoder_channels=(16, 16),
        decoder_attention_head_dim=8, decoder_num_heads=2), "MatchaTTSTrainer",
        ("CFMLoss", "EncoderPriorLoss", "DurationPredictorLoss", "ForwardSumLoss")),
    "valle_nar": ("jatts_torch.models.valle.VALLENAR", dict(
        idim=10, n_tokens=64, d_model=64, n_heads=4, n_layers=2, p_dropout=0.0, n_resp_levels=7), "VALLETrainer", ()),
}


def mel_batch(seed):
    rng = np.random.default_rng(seed)
    ilens = np.array([24, 17, 9, 3], np.int32)
    olens = np.array([96, 75, 40, 8], np.int32)
    return {"xs": (rng.integers(1, 25, (B, 24)) * (np.arange(24)[None] < ilens[:, None])).astype(np.int32),
            "ilens": ilens, "ys": rng.normal(size=(B, 96, 8)).astype(np.float32), "olens": olens}


def nar_batch(seed):
    b = valle_batch(seed)
    rng = np.random.default_rng(seed + 100)
    b["resps"] = rng.integers(0, 64, (B, 24, 8)).astype(np.int32)
    return b


N_E2 = 64


def e2_batch(seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, E2["idim"], (B, 16)).astype(np.int32)
    text[2, 9:] = -1
    text[3, 5:] = -1
    return {"xs": text, "ilens": (text >= 0).sum(1).astype(np.int32),
            "ys": rng.normal(size=(B, N_E2, E2["odim"])).astype(np.float32),
            "olens": np.array([64, 50, 23, 9], np.int32)}


def e2_draws(seed):
    """E2-TTS's five draws of a step at the global batch's shape, in the
    JAX model's order (row 0 drops the audio, row 1 both)."""
    rng = np.random.default_rng(seed)
    return dict(
        uniform=[rng.uniform(0.7, 1.0, B).astype(np.float32), rng.uniform(0, 1, B).astype(np.float32),
                 rng.uniform(0, 1, B).astype(np.float32), np.array([0.1, 0.9, 0.8, 0.6], np.float32),
                 np.array([0.9, 0.05, 0.7, 0.5], np.float32)],
        normal=[rng.normal(size=(B, N_E2, E2["odim"])).astype(np.float32)],
    )


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(cmd_for_rank, world, log, env_for_rank=lambda r: {}):
    """Start ``world`` ranks, each writing its output to ``log.rank{R}``."""
    procs = []
    for r in range(world):
        env = {**os.environ, "OMP_NUM_THREADS": "1", **env_for_rank(r)}
        env.pop("JAX_PLATFORMS", None)
        with open(f"{log}.rank{r}", "w") as out:
            procs.append((subprocess.Popen(cmd_for_rank(r), env=env, cwd=REPO, stdout=out,
                                           stderr=subprocess.STDOUT), f"{log}.rank{r}"))
    return procs


def _join(procs, t_end):
    """Wait for every rank until ``t_end``; kill them all and fail on a
    hang or a rank's error."""
    for p, _ in procs:
        try:
            p.wait(timeout=max(t_end - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            pytest.fail(f"a rank did not end within {DEADLINE} s")
    for p, log in procs:
        with open(log) as f:
            assert p.returncode == 0, f.read()[-4000:]


def _launch_jobs(jobs, path, world):
    torch.save(jobs, path)
    port = _free_port()
    return _spawn(lambda r: [sys.executable, WORKER, "--jobs", path, "--rank", str(r), "--world", str(world),
                             "--port", str(port)], world, path)


def _one_process(model, config, batches, crits, steps, outdir):
    """The port's one-process run; returns its history and, after every
    step, copies of the model's state and the EMA."""
    t = Trainer(config, model, crits, get_loss_fn(config["trainer_type"]), FakeLoader(batches),
                outdir=outdir, seed=0)
    t.init_state()
    ref = {"state": {}, "ema": {}}
    for i in range(steps):
        t.train_step(batches[i % len(batches)])
        ref["state"][i + 1] = {k: v.clone() for k, v in t._model_state().items()}
        ref["ema"][i + 1] = dict(zip(t.names, [e.clone() for e in t.ema or ()]))
    ref["history"] = [dict(h) for h in t.history]
    return ref


def _jax_run(config, jmodel, crits, loss_fn, batches, outdir, kwargs_fn=None, shape=(2, 2)):
    jm = jmesh.get_mesh(*shape, devices=jax.devices()[:4])
    jt = JTrainer(config, jmodel, crits, loss_fn, FakeLoader(batches), outdir=outdir, mesh=jm, seed=0,
                  kwargs_fn=kwargs_fn)
    jt.init_state(jt._prep(batches[0], 4))
    return jt


def _jax_steps(jt, batches):
    stats = []
    for b in batches:
        _, s = jt._run_single(jt._prep(b, 4))
        stats.append({k: float(v) for k, v in s.items()})
    return stats


TP_CONF = os.path.join(REPO, "egs", "hificaptain_jp_female", "tts3", "conf", "valle_ar.given.bs128.dp4tp2.yaml")


def _cli_conf(tmp, mesh):
    """``valle_ar.given.bs128.dp4tp2.yaml`` (``mesh: {model: 2}``,
    ``n_data_devices``, bf16, dropout 0.1, accumulation 2, ``rng_impl``,
    ``steps_per_execution``) at small widths for 4 steps; without ``mesh``
    its one-process form."""
    with open(TP_CONF) as f:
        conf = yaml.safe_load(f)
    conf["model_params"].update(d_model=160, n_heads=2, n_layers=2, prompt_max_frame_length=24)
    conf.update(batch_size=4, scheduler_params={"warmup_steps": 4}, train_max_steps=4, save_interval_steps=2,
                eval_interval_steps=2, log_interval_steps=2)
    if not mesh:
        del conf["mesh"]
    path = os.path.join(tmp, f"conf{'_mesh' if mesh else ''}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel"))
    t0 = time.time()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the spawned ranks take the other cores
    try:
        return _runs(tmp, t0)
    finally:
        torch.set_num_threads(threads)


def _runs(tmp, t0):
    n = {"fs2": 3, "valle": 3, "e2": 3}
    fs2_b = [fs2_batch(s) for s in range(3)]
    valle_b = [valle_batch(10 + s) for s in range(3)]
    e2_b = [e2_batch(20 + s) for s in range(3)]
    draws = [e2_draws(30)]

    # the JAX trainers on a 4-device (2, 2) mesh: their initial weights start every run
    fs2_cfg = _config(ema_decay=0.9, trainer_type="FastSpeech2Trainer")
    # FastSpeech2 on JAX's data mesh (4, 1): on (2, 2), with the batch
    # replicated over "model", XLA's gradient of the conformer's depthwise
    # convolution kernel is up to 0.6 off JAX's own one-process gradient
    # (grad norm 27.2372 against 26.9663 at step 1), while (4, 1) and the
    # port's dp2 agree with the one-process step
    jfs2 = _jax_run(fs2_cfg, JFastSpeech2(**FS2_CONFIG), {k: JLOSS[k]() for k in LOSSES}, jfastspeech2_loss,
                    fs2_b, os.path.join(tmp, "jfs2"), shape=(4, 1))
    fs2_sd = fastspeech2_state_dict_from_jax(
        jax.device_get({"params": jfs2.state.params, "batch_stats": jfs2.state.batch_stats}))
    valle_cfg = _config(optimizer_type="AdamW", optimizer_params={"lr": 1e-3, "weight_decay": 0.01},
                        gradient_accumulate_steps=2, ema_decay=0.9, trainer_type="VALLETrainer",
                        mesh={"model": 2})
    jvalle = _jax_run(valle_cfg, JVALLEAR(**VALLE), {}, jvalle_loss, valle_b, os.path.join(tmp, "jvalle"),
                      kwargs_fn=jvalle_kwargs)
    valle_sd = valle_state_dict_from_jax({"params": jax.device_get(jvalle.state.params)}, VALLE["n_layers"])
    e2_cfg = _config(optimizer_type="AdamW", optimizer_params={"lr": 1e-3, "weight_decay": 0.01},
                     scheduler="e2tts_sequentiallr", scheduler_params={"warmup_steps": 2}, ema_decay=0.9,
                     trainer_type="E2TTSTrainer", mesh={"model": 2, "sequence_parallel": True})
    je2_model = je2.E2TTS(**E2)
    jdraws = {k: [jax.numpy.asarray(a) for a in v] for k, v in draws[0].items()}
    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_draws(mp, jdraws)
        je = _jax_run(e2_cfg, je2_model, {}, jsteps_e2tts.e2tts_loss, e2_b, os.path.join(tmp, "je2"),
                      kwargs_fn=jsteps_e2tts.e2tts_kwargs)
    e2_sd = e2tts_state_dict_from_jax({"params": jax.device_get(je.state.params)}, E2["depth"])

    def job(name, kind, model, kwargs, sd, cfg, batches, mesh_shape, dropout, steps, **extra):
        return dict(outdir=os.path.join(tmp, name), kind=kind, model=model, kwargs=kwargs, state_dict=sd,
                    config=dict(cfg), batches=batches, mesh=mesh_shape, dropout=dropout, steps=steps, **extra)

    fs2_model = "jatts_torch.models.fastspeech2.FastSpeech2"
    valle_model = "jatts_torch.models.valle.VALLEAR"
    e2_model = "jatts_torch.models.e2tts.E2TTS"
    tdraws = {k: [torch.from_numpy(a) for a in v] for k, v in draws[0].items()}
    two = [
        job("fs2_on", "trajectory", fs2_model, FS2, fs2_sd, fs2_cfg, fs2_b, (2, 1), DROPOUT, n["fs2"],
            criterions=LOSSES),
        job("fs2_off", "trajectory", fs2_model, FS2, fs2_sd, fs2_cfg, fs2_b, (2, 1), 0.0, n["fs2"],
            criterions=LOSSES),
    ]
    four = [
        job("valle_on", "trajectory", valle_model, VALLE, valle_sd, valle_cfg, valle_b, (2, 2), DROPOUT, 3),
        job("valle_off", "trajectory", valle_model, VALLE, valle_sd, valle_cfg, valle_b, (2, 2), 0.0, 3),
        job("valle_resume", "resume", valle_model, VALLE, valle_sd, valle_cfg, valle_b, (2, 2), DROPOUT, 2),
        job("valle_stop", "stop", valle_model, VALLE, valle_sd, valle_cfg, valle_b, (2, 2), DROPOUT, 3,
            stop_rank=1, stop_after=1),
        job("e2_on", "trajectory", e2_model, E2, e2_sd, e2_cfg, e2_b, (2, 2), None, 3),
        job("e2_off", "trajectory", e2_model, E2, e2_sd, e2_cfg, e2_b, (2, 2), 0.0, 3, draws=tdraws),
    ]
    # VALL-E AR tp2 with every block recomputed in the backward: the
    # recomputation repeats the tensor-parallel gathers, on both ranks in
    # one order
    two.append(job("valle_tp2_remat", "trajectory", valle_model, {**VALLE, "use_remat": True}, valle_sd, valle_cfg,
                   valle_b, (1, 2), DROPOUT, 3))
    # E2-TTS sp2 with each attention and feed-forward recomputed: the
    # recomputed attention gathers its keys and values again
    two.append(job("e2_sp2_remat", "trajectory", e2_model, {**E2, "use_remat": True, "remat_policy": "dots_saveable"},
                   e2_sd, e2_cfg, e2_b, (1, 2), None, 3))
    others = {}
    for name, (path, kw, trainer_type, crits) in OTHERS.items():
        mod, cls = path.rsplit(".", 1)
        torch.manual_seed(0)
        model = getattr(__import__(mod, fromlist=[cls]), cls)(**kw, device="cpu")
        # SGD: Adam would turn the reduction order's noise on a ~0 gradient
        # into steps of either sign (the other runs hold Adam)
        cfg = _config(trainer_type=trainer_type, dp_train_start_steps=1, bin_loss_start_steps=1,
                      optimizer_type="SGD", optimizer_params={"lr": 1e-2})
        batches = [(nar_batch if name == "valle_nar" else mel_batch)(40 + s) for s in range(3)]
        others[name] = (model, cfg, batches, crits)
        two.append(job(name, "trajectory", path, kw, model.state_dict(), cfg, batches, (2, 1), DROPOUT, 3,
                       criterions=crits))
    procs = _launch_jobs(two, os.path.join(tmp, "two.pt"), 2)
    procs += _launch_jobs(four, os.path.join(tmp, "four.pt"), 4)

    # the CLI: tts3 with mesh {model: 2} on 2 ranks
    csv, stats, tokens = write_codec_corpus(os.path.join(tmp, "corpus"), "npz", n_utts=8)
    cli_args = ["--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
                "--device", "cpu", "--attn-backend", "flash", "--verbose", "0"]
    port = _free_port()
    procs += _spawn(
        lambda r: [sys.executable, "-m", "jatts_torch.bin.tts_train", "--multihost", "--dist-backend", "gloo",
                   "--config", _cli_conf(tmp, True), "--outdir", os.path.join(tmp, "cli_mesh"), *cli_args],
        2, os.path.join(tmp, "cli"), lambda r: {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                                                "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    t_end = time.time() + DEADLINE
    print(f"spawned at {time.time() - t0:.1f} s")

    # meanwhile: the one-process port runs and the JAX steps
    out = {"tmp": tmp}
    for name, cls, kw, sd, cfg, batches, crits, steps in (
        ("fs2", FastSpeech2, FS2, fs2_sd, fs2_cfg, fs2_b, LOSSES, n["fs2"]),
        ("valle", VALLEAR, VALLE, valle_sd, valle_cfg, valle_b, (), 4),
        ("e2", E2TTS, E2, e2_sd, e2_cfg, e2_b, (), n["e2"]),
    ):
        model = cls(**kw, device="cpu")
        model.load_state_dict(sd)
        if name != "e2":
            set_dropout_rate(model, DROPOUT)
        out[name] = _one_process(model, cfg, batches, {k: LOSS_REGISTRY[k]() for k in crits}, steps,
                                 os.path.join(tmp, f"one_{name}"))
    for name, (model, cfg, batches, crits) in others.items():
        set_dropout_rate(model, DROPOUT)
        out[name] = _one_process(model, cfg, batches, {k: LOSS_REGISTRY[k]() for k in crits}, 3,
                                 os.path.join(tmp, f"one_{name}"))
    print(f"one-process runs at {time.time() - t0:.1f} s")
    out["jax_fs2"] = (_jax_steps(jfs2, fs2_b), jfs2)
    out["jax_valle"] = (_jax_steps(jvalle, valle_b), jvalle)
    real_apply = jsteps_e2tts._apply
    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_draws(mp, jdraws)
        mp.setattr(jsteps_e2tts, "_apply", lambda model, params, bs, rng, deterministic, **kw: real_apply(
            model, params, bs, rng, True, **kw))
        out["jax_e2"] = (_jax_steps(je, e2_b), je)
    print(f"jax runs at {time.time() - t0:.1f} s")
    # the one-process CLI on the same conf without the mesh
    tts_train.main(["--config", _cli_conf(tmp, False), "--outdir", os.path.join(tmp, "cli_one"), *cli_args])
    print(f"cli at {time.time() - t0:.1f} s")
    _join(procs, t_end)
    print(f"parallel fixture: {time.time() - t0:.1f} s")
    return out


def _patch_jax_draws(mp, draws):
    seen = {"uniform": 0, "normal": 0}

    def take(kind, shape):
        want = draws[kind][seen[kind] % len(draws[kind])]
        seen[kind] += 1
        assert tuple(shape) == want.shape, (kind, shape, want.shape)
        return want

    mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=None, minval=0.0, maxval=1.0: take("uniform", shape))
    mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=None: take("normal", shape))


def _saved(runs, name, sub=""):
    d = os.path.join(runs["tmp"], name, sub)
    latest = max((x for x in os.listdir(d) if x.startswith("checkpoint-")), key=lambda x: int(x[11:-5]))
    return restore_checkpoint(os.path.join(d, latest)), torch.load(os.path.join(d, "history.pt"))


def _close(got_hist, want_hist, keys):
    assert len(got_hist) == len(want_hist)
    for got, want in zip(got_hist, want_hist):
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)


def _close_state(got, want, total_lr=0.0, counts=True):
    """Held at atol 2e-5, but where the true gradient is 0: the conformer's
    depthwise-conv bias (the train-mode BatchNorm after it removes it) and
    that BatchNorm's running mean, and an attention's key bias (a constant
    a query adds to all its scores, which the softmax removes; E2-TTS's
    heads without rope). Adam turns
    rounding noise there into steps of either sign, bounded by the sum of
    the learning rates (tests/test_torch_trainer.py:_assert_weights).
    ``counts``: BatchNorm's step counts too (the JAX trainer keeps none)."""
    assert set(got) == set(want)
    for k in want:
        if k.endswith("num_batches_tracked"):
            assert not counts or int(got[k]) == int(want[k]), k
            continue
        degenerate = k.endswith(("depthwise_conv.bias", "conv_module.norm.running_mean", "self_attn.linear_k.bias",
                                 ".to_k.bias"))
        atol = max(total_lr * 1.01, PARAM_ATOL) if degenerate else PARAM_ATOL
        np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(), rtol=0, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# layout helpers against jatts_tpu.parallel.mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_pad_batch_to_devices_matches_jax(n):
    batch = {"xs": np.arange(15).reshape(5, 3), "olens": np.array([3, 2, 5, 1, 4]), "prom_lens": np.arange(5),
             "utt_ids": [f"u{i}" for i in range(5)], "scale": 1.5}
    got, want = mesh.pad_batch_to_devices(batch, n), jmesh.pad_batch_to_devices(batch, n)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]


@pytest.mark.parametrize("shape,key,n_model", [((4, 8, 3), "ys", 2), ((4, 9), "xs", 2), ((4,), "olens", 2),
                                               ((4, 8), "ilens", 2), ((4, 8), "xs", 1), ((4, 12, 2), "ys", 3)])
def test_seq_shardable_matches_jax(shape, key, n_model):
    v = np.zeros(shape)
    assert mesh._seq_shardable(key, v, 1, n_model) == jmesh._seq_shardable(key, v, 1, n_model)


def test_shard_batch_cuts_rows_and_time():
    """Data rank 1 of 2, model rank 1 of 2: rows 2-3; under SP the second
    half of every divisible time axis, ``*lens`` and odd T whole."""
    batch = {"ys": np.arange(4 * 8).reshape(4, 8), "xs": np.arange(4 * 5).reshape(4, 5),
             "olens": np.arange(4), "utt_ids": list("abcd")}
    m = types.SimpleNamespace(n_data=2, n_model=2, data_rank=1, model_rank=1, seq_keys=frozenset())
    got = mesh.shard_batch(batch, m, seq_parallel=True)
    np.testing.assert_array_equal(got["ys"], batch["ys"][2:, 4:])
    np.testing.assert_array_equal(got["xs"], batch["xs"][2:])
    np.testing.assert_array_equal(got["olens"], batch["olens"][2:])
    assert got["utt_ids"] == ["c", "d"] and m.seq_keys == {"ys"}
    plain = mesh.shard_batch(batch, m)
    np.testing.assert_array_equal(plain["ys"], batch["ys"][2:])
    assert m.seq_keys == frozenset()


def test_tp_plan_is_the_jax_rule_through_convert_valle():
    """The set of sharded VALL-E parameters and their dimension equal
    ``shard_params_tp``'s on the flax tree ``convert_valle`` makes of the
    port's state_dict: each port tensor tagged by its index, the flax leaf
    found by its value."""
    model = VALLEAR(**{**VALLE, "n_tokens": 1024}, device="cpu")
    plan = mesh.tp_plan(model, 2)
    names = [n for n, _ in model.named_parameters()]
    sd = {k: np.full(tuple(v.shape), float(i), np.float32) for i, (k, v) in enumerate(model.state_dict().items())}
    tree = convert_valle(sd, types.SimpleNamespace(n_layers=VALLE["n_layers"]))
    jm = jmesh.get_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    sharded = jmesh.shard_params_tp(tree["params"], jm)
    keys = list(sd)
    want = {}
    for leaf, placed in zip(jax.tree_util.tree_leaves(tree["params"]), jax.tree_util.tree_leaves(sharded)):
        spec = tuple(placed.sharding.spec)
        if "model" in spec:
            name = keys[int(np.asarray(leaf).flat[0])]
            flax_dim = spec.index("model")
            torch_shape = tuple(model.state_dict()[name].shape)
            # the flax leaf is the port tensor, or its transpose (kernels)
            want[name] = flax_dim if np.asarray(leaf).shape == torch_shape else len(torch_shape) - 1 - flax_dim
    assert plan == want and set(plan) <= set(names)
    assert {"classifier.weight", "blocks.0.attn.block.to_qkv.weight"} <= set(plan)
    assert plan["classifier.weight"] == 1 and plan["blocks.0.attn.block.to_qkv.weight"] == 0


# ---------------------------------------------------------------------------
# a step over the mesh is the one-process step
# ---------------------------------------------------------------------------

FS2_KEYS = ("train/loss", "train/grad_norm", "train/mel_loss", "train/duration_loss", "train/pitch_loss")


def test_fs2_dp2_matches_one_process(runs):
    state, hist = _saved(runs, "fs2_on")
    ref = runs["fs2"]
    _close(hist, ref["history"], FS2_KEYS)
    assert hist[0]["train/grad_norm"] > 1.0  # the clip acted
    total_lr = sum(schedulers.warmuplr(1e-3, 4)(i) for i in range(3))
    _close_state(state["model"], ref["state"][3], total_lr)
    _close_state(state["ema"], ref["ema"][3], total_lr)


def test_valle_dp2_tp2_matches_one_process(runs):
    state, hist = _saved(runs, "valle_on")
    ref = runs["valle"]
    _close(hist, ref["history"][:3], ("train/loss", "train/grad_norm", "train/loss_ce"))
    assert hist[0]["train/grad_norm"] > 1.0
    _close_state(state["model"], ref["state"][3])
    _close_state(state["ema"], ref["ema"][3])
    assert state["steps"] == 3 and state["optimizer"]["mini_step"] == 1
    assert state["model"]["blocks.0.attn.block.to_qkv.weight"].shape == (480, 160)  # saved whole


def test_valle_tp2_with_remat_matches_one_process(runs):
    """``use_remat`` at tp2 on two ranks (dropout on) against the plain
    one-process run."""
    state, hist = _saved(runs, "valle_tp2_remat")
    ref = runs["valle"]
    _close(hist, ref["history"][:3], ("train/loss", "train/grad_norm", "train/loss_ce"))
    _close_state(state["model"], ref["state"][3])
    _close_state(state["ema"], ref["ema"][3])


def test_e2_sp2_with_remat_matches_one_process(runs):
    """``use_remat`` with ``dots_saveable`` at sp2 on two ranks (dropout
    and the training draws on) against the plain one-process run."""
    state, hist = _saved(runs, "e2_sp2_remat")
    ref = runs["e2"]
    _close(hist, ref["history"], ("train/loss", "train/grad_norm", "train/cfm_loss"))
    total_lr = sum(schedulers.e2tts_sequentiallr(1e-3, 2, 3)(i) for i in range(3))
    _close_state(state["model"], ref["state"][3], total_lr)


def test_e2_dp2_sp2_matches_one_process(runs):
    state, hist = _saved(runs, "e2_on")
    ref = runs["e2"]
    _close(hist, ref["history"], ("train/loss", "train/grad_norm", "train/cfm_loss"))
    total_lr = sum(schedulers.e2tts_sequentiallr(1e-3, 2, 3)(i) for i in range(3))
    _close_state(state["model"], ref["state"][3], total_lr)
    _close_state(state["ema"], ref["ema"][3], total_lr)


@pytest.mark.parametrize("family", list(OTHERS))
def test_other_families_dp2_match_one_process(runs, family):
    """mel-VITS (the stochastic duration predictor: its e_q, the posterior's
    eps, the search, the KL and the forward-sum loss), Matcha-TTS+MAS (the
    CFM's t and z, the prior loss) and the VALL-E NAR (its drawn levels) at
    dp2 with dropout on, under SGD."""
    state, hist = _saved(runs, family)
    ref = runs[family]
    keys = [k for k in ref["history"][0] if k.startswith("train/")]
    _close(hist, ref["history"], keys)
    _close_state(state["model"], ref["state"][3])


# ---------------------------------------------------------------------------
# the same runs against the JAX Trainer on a (2, 2) mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["fs2", "valle", "e2"])
def test_mesh_run_matches_jax_trainer_on_a_mesh(runs, family):
    state, hist = _saved(runs, f"{family}_off")
    jstats, jt = runs[f"jax_{family}"]
    keys = {"fs2": FS2_KEYS, "valle": ("train/loss", "train/grad_norm"),
            "e2": ("train/loss", "train/grad_norm", "train/cfm_loss")}[family]
    _close(hist, jstats, keys)
    params = jax.device_get(jt.state.params)
    if family == "fs2":
        want = fastspeech2_state_dict_from_jax({"params": params, "batch_stats": jax.device_get(jt.state.batch_stats)})
        _close_state(state["model"], want, sum(schedulers.warmuplr(1e-3, 4)(i) for i in range(3)), counts=False)
    elif family == "valle":
        _close_state(state["model"], valle_state_dict_from_jax({"params": params}, VALLE["n_layers"]))
    else:
        _close_state(state["model"], e2tts_state_dict_from_jax({"params": params}, E2["depth"]))


# ---------------------------------------------------------------------------
# checkpoints, stops and the CLI
# ---------------------------------------------------------------------------


def test_checkpoint_moves_between_world_sizes(runs):
    """dp2 x tp2 saves at step 2, one rank resumes it and saves at 3, the
    mesh resumes that and saves at 4: each equal to the uninterrupted
    one-process run."""
    one_state, one_hist = _saved(runs, "valle_resume", "one")
    back_state, back_hist = _saved(runs, "valle_resume", "back")
    ref = runs["valle"]
    _close(one_hist[-1:], ref["history"][2:3], ("train/loss", "train/grad_norm"))
    _close(back_hist[-1:], ref["history"][3:4], ("train/loss", "train/grad_norm"))
    _close_state(one_state["model"], ref["state"][3])
    _close_state(back_state["model"], ref["state"][4])
    _close_state(back_state["ema"], ref["ema"][4])
    assert back_state["steps"] == 4 and back_state["optimizer"]["updates"] == 2


def test_stop_on_one_rank_stops_every_rank_at_one_step(runs):
    d = os.path.join(runs["tmp"], "valle_stop")
    got = [torch.load(os.path.join(d, f"stopped.rank{r}.pt")) for r in range(4)]
    assert all(g == {"steps": 2, "code": 143} for g in got), got


def test_cli_multihost_two_ranks_matches_one_process(runs):
    """``bin/tts_train.py --multihost`` over gloo on 2 ranks with the
    dp4tp2 VALL-E conf at small widths (dp1 x tp2 here), 4 steps with evals
    and saves: the final checkpoint equals the one-process CLI's."""
    tmp = runs["tmp"]
    got = restore_checkpoint(os.path.join(tmp, "cli_mesh", "checkpoint-4steps"))
    want = restore_checkpoint(os.path.join(tmp, "cli_one", "checkpoint-4steps"))
    assert got["steps"] == want["steps"] == 4
    _close_state(got["model"], want["model"])
    for i, st in want["optimizer"]["state_dict"]["state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(np.asarray(got["optimizer"]["state_dict"]["state"][i][k]), np.asarray(v),
                                       rtol=1e-5, atol=1e-9, err_msg=f"{i}.{k}")
    assert os.path.exists(os.path.join(tmp, "cli_mesh", "config.yml"))
