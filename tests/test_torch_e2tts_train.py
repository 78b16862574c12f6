"""E2-TTS training, serving and its entry points on the CPU:
``DynamicBatchSampler`` against the JAX package's (drops, ``max_samples``,
two epochs), a 3-step trajectory against the JAX Trainer (AdamW under
``e2tts_sequentiallr``, clip 1.0, accumulation 2, EMA, the draws injected on
both sides, dropout off), the tts2 training CLI through ``e2tts_train`` for 4
steps with ``batch_size_per_gpu`` and a bitwise resume, the refusal of the
4-chip confs, the stage-4 decode CLI (the EMA weights chosen, the prompt
clamp, Griffin-Lim) and the serving bundle's seed and crops behind
BatchingServer.

Small size as tests/test_torch_e2tts.py. Tolerances: the trajectory's
losses and grad norms rtol 1e-5, its weights and EMA weights atol 2e-5
(tests/test_torch_trainer.py's); the CLI's resume, the decode CLI and the
bundle: bit for bit.
"""

import logging
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import jatts_tpu.train.steps_e2tts as jsteps_e2tts  # noqa: E402
from jatts_tpu.data.batcher import DynamicBatchSampler as JDynamicBatchSampler  # noqa: E402
from jatts_tpu.models import e2tts as je2  # noqa: E402
from jatts_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from jatts_torch.bin import e2tts_decode, e2tts_train, tts_decode, tts_train  # noqa: E402
from jatts_torch.data.batcher import DynamicBatchSampler  # noqa: E402
from jatts_torch.models import e2tts  # noqa: E402
from jatts_torch.modules.dropout import set_dropout_rate  # noqa: E402
from jatts_torch.serving import BatchingServer, E2ttsServingBundle  # noqa: E402
from jatts_torch.serving.bundle import inference_kwargs  # noqa: E402
from jatts_torch.train import schedulers  # noqa: E402
from jatts_torch.train import steps as tsteps  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint, save_checkpoint  # noqa: E402
from jatts_torch.utils.config import dump_config  # noqa: E402
from jatts_torch.utils.convert import e2tts_state_dict_from_jax  # noqa: E402
from jatts_torch.utils.io import write_audio, write_csv  # noqa: E402
from tests.test_torch_e2tts import TINY, inject_draws, make_batch, make_draws  # noqa: E402
from tests.test_torch_trainer import LOSS_TOL, FakeLoader, _assert_weights, _config  # noqa: E402

ODIM = TINY["odim"]
PHONES = ["a", "i", "u", "e", "o", "k", "s", "t"]
E2_CONF = os.path.join("egs", "hificaptain_jp_female", "tts2", "conf")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# frame-budget batching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold,max_samples,seed", [(400, 0, 666), (400, 5, 0), (1000, 3, 7), (250, 0, 1)])
def test_dynamic_batch_sampler_matches_jax(threshold, max_samples, seed, caplog):
    """The batches integer for integer (ties kept in order by the stable
    sort), the drops over the threshold counted and logged, and the
    shuffled order of two epochs."""
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(20, 320, 60)] + [300] * 4 + [1200]
    want = JDynamicBatchSampler(lengths, threshold, max_samples=max_samples, seed=seed)
    with caplog.at_level(logging.WARNING):
        got = DynamicBatchSampler(lengths, threshold, max_samples=max_samples, seed=seed)
    assert got.batches == want.batches and got.n_dropped == want.n_dropped
    assert got.n_dropped == sum(n > threshold for n in lengths) > 0
    assert f"dropped {got.n_dropped}/{len(lengths)}" in caplog.text
    for b in got.batches:
        assert sum(lengths[i] for i in b) <= threshold and (not max_samples or len(b) <= max_samples)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert list(got) == list(want)
    got.set_epoch(0)
    first = list(got)
    got.set_epoch(1)
    assert list(got) != first


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _batches(n):
    out = []
    for s in range(n):
        b = make_batch(40 + s)
        out.append({"xs": b["text"], "ilens": (b["text"] >= 0).sum(1).astype(np.int32), "ys": b["feats"],
                    "olens": b["lens"]})
    return out


def test_three_step_trajectory_matches_jax_trainer(tmp_path, monkeypatch):
    """AdamW (weight decay 0.01) under e2tts_sequentiallr (warm-up 2), clip
    at 1.0, gradients averaged over 2 steps, EMA 0.9; the JAX loss applied
    without dropout and the port's dropout at 0; the five draws injected on
    both sides (the same every step): per-step losses and grad norms, the
    weights and the EMA weights after one update plus one accumulated step."""
    real_apply = jsteps_e2tts._apply
    monkeypatch.setattr(jsteps_e2tts, "_apply", lambda model, params, bs, rng, deterministic, **kw: real_apply(
        model, params, bs, rng, True, **kw))
    config = _config(optimizer_type="AdamW", optimizer_params={"lr": 1e-3, "weight_decay": 0.01},
                     scheduler="e2tts_sequentiallr", scheduler_params={"warmup_steps": 2},
                     gradient_accumulate_steps=2, trainer_type="E2TTSTrainer", ema_decay=0.9)
    batches = _batches(3)
    with inject_draws(monkeypatch, make_draws(50)):
        jt = JTrainer(config, je2.E2TTS(**TINY), {}, jsteps_e2tts.e2tts_loss, FakeLoader(batches),
                      outdir=str(tmp_path / "jax"), mesh=None, seed=0, kwargs_fn=jsteps_e2tts.e2tts_kwargs)
        jt.init_state(jt._prep(batches[0], 1))
        depth = TINY["depth"]
        model = e2tts.E2TTS(**TINY, device="cpu")
        model.load_state_dict(e2tts_state_dict_from_jax({"params": jax.device_get(jt.state.params)}, depth))
        set_dropout_rate(model, 0.0)
        pt = Trainer(config, model, {}, tsteps.get_loss_fn("E2TTSTrainer"), FakeLoader(batches),
                     outdir=str(tmp_path / "port"), seed=0)
        pt.init_state()
        for i, b in enumerate(batches):
            jt.state, js = jt.train_step(jt.state, jt._prep(b, 1), jax.random.fold_in(jt.rng, i))
            got = pt.train_step(b)
            for key in ("train/loss", "train/cfm_loss", "train/grad_norm"):
                np.testing.assert_allclose(got[key], float(js[key]), err_msg=key, **LOSS_TOL)
    assert pt.updates == 1 and pt.mini_step == 1
    total_lr = sum(schedulers.e2tts_sequentiallr(1e-3, 2, 3)(i) for i in range(2))
    _assert_weights(pt.model.state_dict(),
                    e2tts_state_dict_from_jax({"params": jax.device_get(jt.state.params)}, depth), total_lr)
    _assert_weights(dict(zip(pt.names, pt.ema)),
                    e2tts_state_dict_from_jax({"params": jax.device_get(jt.state.ema_params)}, depth), total_lr)


def write_e2_corpus(root, n_utts=8, seed=0, sr=16000, hop=128):
    """Mel-only ``.npz`` dumps of 20-90 frames (the csv's start and end
    give the frame counts the batcher sorts by), the statistics, tokens.txt
    and, per row, a prompt wav with its phonemes. Returns (csv, stats,
    tokens)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "dump"), exist_ok=True)
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank>", "<unk>", *PHONES, "<sos/eos>"]) + "\n")
    rows, mels = [], []
    for i in range(n_utts):
        n = int(rng.integers(20, 90))
        mel = rng.normal(-4.0, 2.0, (n, ODIM)).astype(np.float32)
        path = os.path.join(root, "dump", f"U{i}.npz")
        np.savez(path, mel=mel)
        wav = os.path.join(root, "wav", f"P{i}.wav")
        secs = [0.3, 2.0, 0.5][i % 3]  # row 1's prompt is too long for the decode's capacity
        tone = np.sin(2 * np.pi * (200 + 40 * i) * np.arange(int(sr * secs)) / sr) * 0.3
        write_audio(wav, tone.astype(np.float32), sr)
        rows.append({"sample_id": f"U{i}", "spk": "s", "start": "0", "end": f"{(n + 0.5) * hop / sr}",
                     "phonemes": " ".join(rng.choice(PHONES, int(rng.integers(2, 6)))),
                     "feat_path": path, "prompt_wav_path": wav, "prompt_phonemes": " ".join(rng.choice(PHONES, 3))})
        mels.append(mel)
    cat = np.concatenate(mels)
    stats = os.path.join(root, "stats.npz")
    np.savez(stats, mel_mean=cat.mean(0).astype(np.float32), mel_scale=cat.std(0).astype(np.float32))
    csv = os.path.join(root, "train.csv")
    write_csv(rows, csv)
    return csv, stats, tokens


def _e2_conf(**extra):
    conf = {
        "sampling_rate": 16000, "fft_size": 512, "hop_size": 128, "num_mels": ODIM, "fmin": 0, "fmax": None,
        "feat_list": ["mel"], "out_feat_type": "mel", "model_type": "E2TTS", "trainer_type": "E2TTSTrainer",
        "collater_type": "FastSpeech2Collater", "criterions": {},
        "model_params": {**{k: v for k, v in TINY.items() if k != "idim"}, "dtype": "bfloat16"},
        "vocoder": {"checkpoint": "./downloads/none/checkpoint.pkl", "config": "none.yml"},
        "nfe_step": 2, "cfg_strength": 2.0, "sway_sampling_coef": -1.0, "max_duration": 96,
        "sampler_random_seed": 666, "batch_size_per_gpu": 200, "max_samples": 3, "gradient_accumulate_steps": 2,
        "optimizer_type": "AdamW", "optimizer_params": {"lr": 7.5e-5, "weight_decay": 0.01}, "grad_norm": 1.0,
        "scheduler": "e2tts_sequentiallr", "scheduler_params": {"warmup_steps": 2}, "ema_decay": 0.9999,
        "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 2, "log_interval_steps": 2,
        "rng_impl": "rbg", "steps_per_execution": 5, "allow_cache": True,
    }
    conf.update(extra)
    return conf


def test_tts2_cli_four_steps_with_frame_budget_and_bitwise_resume(tmp_path, monkeypatch):
    """e2tts_train (the alias of tts_train's main) on the conf's keys at a
    small width: frame-budget batches of <= 200 frames and <= 3 utterances,
    bf16 compute with float32 parameters, flash attention (the plain
    version on the CPU), dropout 0.1, accumulation 2, EMA; steps 2 and 3
    replayed from checkpoint-2steps give the same stats, weights and EMA
    bit for bit (the same draws from the noise generator)."""
    assert tts_train.NOT_PORTED == () and tsteps.NOT_PORTED == ()
    assert e2tts_train.main is tts_train.main
    csv, stats, tokens = write_e2_corpus(str(tmp_path / "corpus"))
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(_e2_conf()))
    outdir = tmp_path / "exp"
    trainers = []
    real_run = tts_train.run
    monkeypatch.setattr(tts_train, "run", lambda *a, **kw: trainers.append(real_run(*a, **kw)))
    e2tts_train.main([
        "--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
        "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu",
        "--attn-backend", "flash", "--verbose", "0",
    ])
    trainer = trainers[0]
    loader = trainer.train_loader
    assert isinstance(loader.sampler, DynamicBatchSampler) and loader.sampler.seed == 666
    lengths = [loader.dataset.get_frame_len(i) for i in range(len(loader.dataset))]
    assert sorted(lengths) == sorted(np.load(r["feat_path"])["mel"].shape[0] for r in loader.dataset.data)
    assert loader.sampler.batches == JDynamicBatchSampler(lengths, 200, max_samples=3, seed=666).batches
    assert type(trainer.model).__name__ == "E2TTS" and trainer.model.dtype == torch.bfloat16
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert trainer.steps == 4 and trainer.updates == 2
    assert all(np.isfinite(v) for h in trainer.history for v in h.values())
    assert trainer.model.noise_generator is trainer.noise_generator
    final = restore_checkpoint(find_latest_checkpoint(str(outdir)))
    assert final["steps"] == 4 and final["ema"] is not None

    config = trainer.config
    mp = dict(config["model_params"])
    dtype = tts_train.DTYPES[mp.pop("dtype")]
    resumed = Trainer(config, e2tts.E2TTS(**mp, device="cpu", dtype=dtype), trainer.criterions,
                      trainer.loss_fn, loader, outdir=str(tmp_path / "resumed"), seed=0)
    resumed.init_state()
    resumed.load_checkpoint(str(outdir / "checkpoint-2steps"))
    n = len(loader.sampler)
    for step, want in zip(range(2, 4), trainer.history[2:]):
        loader.sampler.set_epoch(step // n)
        assert resumed.train_step(loader._make(list(loader.sampler)[step % n])) == want
    for k, v in final["model"].items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert all(torch.equal(e, final["ema"][name]) for e, name in zip(resumed.ema, resumed.names))


@pytest.mark.parametrize("conf", ["e2tts.v1.4chips.bs138240.yaml", "e2tts.v1.4chips.dp2sp2.yaml"])
def test_four_chip_confs_raise_naming_the_multi_gpu_item(tmp_path, conf):
    """Multi-GPU training is ported (``--multihost``, tests/test_torch_parallel.py):
    without it a conf whose ``mesh`` needs several ranks raises naming the
    launch, and the dp-only conf (``n_data_devices``, read nowhere, as in the
    JAX CLI) passes that gate and goes on to read its files."""
    config = yaml.safe_load(open(os.path.join(E2_CONF, conf)))
    if config.get("mesh"):
        with pytest.raises(ValueError, match="torchrun and --multihost"):
            tts_train.run("train.csv", "dev.csv", "stats.npz", "tokens.txt", config, str(tmp_path), device="cpu")
    else:
        with pytest.raises(FileNotFoundError, match="tokens.txt"):
            tts_train.run("train.csv", "dev.csv", "stats.npz", str(tmp_path / "tokens.txt"), config,
                          str(tmp_path), device="cpu")


def test_refusals(tmp_path):
    """An unknown model or trainer type names what the port trains; the
    tts1 decode CLI points E2TTS to its own CLI."""
    with pytest.raises(ValueError, match="the port trains .*E2TTS"):
        tts_train.run("t.csv", "d.csv", "s.npz", "k.txt", {"model_type": "Nope"}, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="unknown trainer_type 'Nope'"):
        tsteps.get_loss_fn("Nope")
    with pytest.raises(ValueError, match="E2TTS: bin/e2tts_decode.py"):
        tts_decode.run("e.csv", "s.npz", "k.txt", {"model_type": "E2TTS"}, str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# decode and serving
# ---------------------------------------------------------------------------


def _seeded_model(seed=0, dtype=torch.float32):
    torch.manual_seed(seed)
    model = e2tts.E2TTS(**{**TINY, "idim": len(PHONES) + 3}, device="cpu", dtype=dtype)
    return model.eval()


def test_decode_cli_takes_the_ema_weights_clamps_the_prompt_and_vocodes(tmp_path, capsys):
    """bin/e2tts_decode.py with a checkpoint whose EMA weights differ from
    its weights: each row's mel equals ``E2TTS.inference`` of the EMA
    weights on the CLI's inputs with a generator seeded by the row index;
    the over-long prompt is cut to ``max_frames - n_gen`` with a warning;
    the missing vocoder checkpoint falls back to Griffin-Lim; the wav is
    ``frames x hop`` samples."""
    csv, stats, tokens = write_e2_corpus(str(tmp_path / "corpus"), n_utts=3)
    conf = _e2_conf()
    model = _seeded_model(1)
    ema = _seeded_model(2)
    expdir = str(tmp_path / "exp")
    save_checkpoint(expdir, 7, {"model": model.state_dict(), "ema": dict(ema.named_parameters())})
    dump_config(conf, os.path.join(expdir, "config.yml"))
    outdir = tmp_path / "decode"
    out = e2tts_decode.main(["--csv", csv, "--stats", stats, "--token-list", tokens, "--expdir", expdir,
                             "--config", os.path.join(expdir, "config.yml"), "--outdir", str(outdir),
                             "--max-frames", "96", "--device", "cpu", "--verbose", "0"])
    log = capsys.readouterr().err  # the CLI's own handler writes the warnings to stderr
    assert out["vocoder"] == "GriffinLimVocoder" and "falling back to Griffin-Lim" in log
    assert "U1: prompt truncated" in log
    loaded = e2tts_decode.load_model(conf, len(PHONES) + 3, None, expdir, "cpu")
    for (name, p), (_, q) in zip(loaded.named_parameters(), ema.named_parameters()):
        assert torch.equal(p, q), name
    rows = list(__import__("csv").DictReader(open(csv, encoding="utf-8")))
    conv = e2tts_decode.TokenIDConverter(tokens)
    ex = e2tts_decode.LogMelExtractor(16000, 512, 128, num_mels=ODIM, fmin=0, fmax=None, device="cpu")
    mean, scale = np.load(stats)["mel_mean"], np.load(stats)["mel_scale"]
    for i, (row, res) in enumerate(zip(rows, out["rows"])):
        n_gen = len(row["phonemes"].split(" ")) * 12
        prompt = (ex(e2tts_decode.read_audio(row["prompt_wav_path"], 16000)[0]) - mean) / scale
        assert res["n_prompt"] == min(len(prompt), 96 - n_gen) and res["gen"] == n_gen
        assert (res["n_prompt"] < len(prompt)) == (i == 1)
        cond = torch.zeros(1, 96, ODIM)
        cond[0, :res["n_prompt"]] = torch.from_numpy(prompt[:res["n_prompt"]].astype(np.float32))
        ids = conv.tokens2ids(row["prompt_phonemes"].split(" ") + ["<blank>"] + row["phonemes"].split(" "))
        want = loaded.inference(cond, torch.tensor([ids]), torch.tensor([res["n_prompt"]]),
                                torch.tensor([res["duration"]]), generator=torch.Generator().manual_seed(i),
                                **inference_kwargs(conf))["feat_gen"][0, res["n_prompt"]:res["duration"]]
        mel = np.load(str(outdir / "wav" / f"{row['sample_id']}_mel.npy"))
        np.testing.assert_array_equal(mel, want.numpy())
        wav, _ = e2tts_decode.read_audio(str(outdir / "wav" / f"{row['sample_id']}.wav"))
        assert len(wav) == n_gen * 128


def test_bundle_seed_crops_and_server():
    """The same seed gives the same bits and another seed another mel; each
    row is ``E2TTS.inference`` on the bundle's padded inputs with a
    generator of that seed, denormalised and cropped to ``[ref_len,
    duration)``; an over-long prompt is clamped to leave its frames; the
    server gives each request what the bundle gives it and keeps its seed."""
    model = _seeded_model(3, torch.bfloat16)
    rng = np.random.default_rng(0)
    mean, scale = rng.normal(size=ODIM).astype(np.float32), rng.uniform(0.5, 2, ODIM).astype(np.float32)
    kw = {"steps": 2, "cfg_strength": 2.0, "sway_sampling_coef": -1.0}
    bundle = E2ttsServingBundle(model, mean, scale, batch_size=3, buckets=[8, 16], max_frames=64, infer_kwargs=kw)
    ids = [[2, 3, 0, 4, 5, 6], [3, 4, 0, 5], [2, 2, 0, 7, 7, 7, 7, 7, 7, 3]]
    prompts = [rng.normal(-4, 2, (n, ODIM)).astype(np.float32) for n in (10, 60, 5)]
    gen = [24, 20, 30]
    a, b, c = (bundle.synthesize(ids, prompts, gen, seed=s) for s in (1, 1, 2))
    assert [len(m) for m in a] == gen  # row 1's prompt clamped to 64 - 20 frames
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert np.abs(a[0] - c[0]).max() > 1e-3
    cond, text, ref_lens, duration = bundle.prepare(ids, prompts, gen)
    assert text.shape == (3, 16) and int(text[1, 4]) == -1
    assert ref_lens.tolist() == [10, 44, 5] and duration.tolist() == [34, 64, 35]
    want = model.inference((cond - torch.from_numpy(mean)) / torch.from_numpy(scale), text, ref_lens, duration,
                           generator=torch.Generator().manual_seed(1), **kw)["feat_gen"]
    for i in range(3):
        want_i = want[i, ref_lens[i]:duration[i]].float() * torch.from_numpy(scale) + torch.from_numpy(mean)
        np.testing.assert_array_equal(a[i], want_i.numpy())
    with BatchingServer(bundle, max_delay_ms=50) as server:
        with pytest.raises(TypeError, match="missing request fields"):
            server.submit(token_ids=ids[0], seed=1)
        futs = [server.submit(token_ids=ids[0], prompt_mels=prompts[0], gen_frames=gen[0], seed=1),
                server.submit(token_ids=ids[0], prompt_mels=prompts[0], gen_frames=gen[0], seed=2)]
        got = [f.result(timeout=120) for f in futs]
    solo = bundle.synthesize(ids[:1], prompts[:1], gen[:1], seed=2)
    np.testing.assert_array_equal(got[1], solo[0])
    np.testing.assert_array_equal(got[0], bundle.synthesize(ids[:1], prompts[:1], gen[:1], seed=1)[0])


def test_e2tts_defaults_to_cuda():
    """E2TTS and stage 4 run on the card unless asked: without one they
    raise before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2tts.E2TTS(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2tts_decode.run("eval.csv", "stats.npz", "tokens.txt", {}, "out")
