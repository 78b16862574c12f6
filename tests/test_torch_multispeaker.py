"""Multi-speaker FastSpeech2 with the latest rel-pos attention (the JVS
tts1 conf's model with ``conformer_rel_pos_type: latest``) against the JAX
package on the CPU, in f32.

Speaker inputs: an utterance embedding ``spembs`` (``spk_embed_dim``,
integrated by ``add`` or ``concat``) and speaker ids ``sids`` (``spks``).
Held to the JAX package: ``inference`` and the training forward on weights
carried by ``utils/convert.py``, under ``xla`` and ``flash`` (the fused
rel-pos features through the plain K1r on CPU tensors); the layout round
trip through ``convert_fastspeech2``; a 3-step trajectory against the JAX
Trainer; ``ServingBundle``/``BatchingServer`` with a ``spemb`` per request
against ``build_infer_fn(use_spembs=True)``; the dataset and collater on a
corpus with ``spkemb`` dumps (the scaler normalises them, in both packages);
and the training CLI for 4 steps.

Tolerances: outputs rtol = atol = 1e-4 (the JAX package's fused-path
tolerance), integer durations and olens equal; the trajectory as
``tests/test_torch_trainer.py`` holds it (losses and grad norms rtol 1e-5,
weights atol 2e-5, the degenerate depthwise-conv bias to the sum of the
learning rates); data batches equal.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.data.batcher import BatchSampler as JBatchSampler  # noqa: E402
from jatts_tpu.data.batcher import FastSpeech2Collater as JCollater  # noqa: E402
from jatts_tpu.data.dataset import TTSDataset as JTTSDataset  # noqa: E402
from jatts_tpu.losses import LOSS_REGISTRY as JLOSS  # noqa: E402
from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.serving.export import build_infer_fn  # noqa: E402
from jatts_tpu.train.steps import fastspeech2_loss as jfastspeech2_loss  # noqa: E402
from jatts_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from jatts_tpu.utils.io import write_csv, write_hdf5  # noqa: E402
from jatts_tpu.utils.torch_import import convert_fastspeech2  # noqa: E402
from jatts_tpu.vocoder.hifigan import HiFiGANGenerator as JHiFiGAN  # noqa: E402
from jatts_torch.bin import tts_train  # noqa: E402
from jatts_torch.data.batcher import BatchSampler, DataLoader, FastSpeech2Collater  # noqa: E402
from jatts_torch.data.dataset import TTSDataset  # noqa: E402
from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.serving import BatchingServer, ServingBundle  # noqa: E402
from jatts_torch.train import schedulers  # noqa: E402
from jatts_torch.train.steps import fastspeech2_loss  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.checkpoint import find_latest_checkpoint  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax, hifigan_state_dict_from_jax  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from tests.test_torch_train_modules import NO_DROPOUT, fs2_batch  # noqa: E402
from tests.test_torch_trainer import FakeLoader, _assert_weights, _config  # noqa: E402
from tests.torch_parity import assert_trees_equal, randomize, state_dict_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
IDIM, ODIM, SPK_DIM, SPKS = 12, 8, 6, 3
LATEST = dict(conformer_rel_pos_type="latest")
FS2 = dict(
    idim=IDIM, odim=ODIM, adim=32, aheads=2, elayers=1, eunits=48, dlayers=1,
    dunits=48, postnet_layers=2, postnet_chans=16, duration_predictor_chans=16,
    pitch_predictor_layers=2, pitch_predictor_chans=16, energy_predictor_chans=16,
    conformer_dec_kernel_size=7, spk_embed_dim=SPK_DIM, **LATEST,
)
LENS = np.array([10, 7, 3])
SPEAKER_CASES = {
    "add": dict(spk_embed_integration_type="add"),
    "concat": dict(spk_embed_integration_type="concat"),
    "add+sids": dict(spk_embed_integration_type="add", spks=SPKS),
}


def _speakers(b, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, SPK_DIM)).astype(np.float32), rng.integers(0, SPKS, b).astype(np.int32)


def _jax_model_and_vars(cfg, seed=0):
    model = JFastSpeech2(**cfg)
    spembs, sids = _speakers(len(LENS), 0)
    variables = model.init(
        jax.random.key(0), jnp.ones((len(LENS), LENS.max()), jnp.int32), jnp.asarray(LENS), 16,
        jnp.asarray(spembs), jnp.asarray(sids), method=JFastSpeech2.inference,
    )
    variables = randomize(variables, seed)
    # durations ~ round(exp(log 3 + noise) - 1) ~ 2 per token
    variables["params"]["duration_predictor"]["linear"]["bias"][:] = np.log(3.0)
    return model, variables


def _port(cfg, variables, backend):
    port = FastSpeech2(**cfg, attn_backend=backend, device="cpu")
    port.load_state_dict(fastspeech2_state_dict_from_jax(variables), strict=True)
    return port


def _tokens():
    xs = np.random.default_rng(1).integers(1, IDIM, size=(len(LENS), LENS.max()))
    return (xs * (np.arange(LENS.max())[None] < LENS[:, None])).astype(np.int32)


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("case", list(SPEAKER_CASES))
def test_latest_multispeaker_inference_matches_jax(case, backend):
    cfg = {**FS2, **SPEAKER_CASES[case]}
    model, variables = _jax_model_and_vars(cfg)
    xs = _tokens()
    spembs, sids = _speakers(len(LENS), 2)
    want = model.apply(variables, jnp.asarray(xs), jnp.asarray(LENS), 40, jnp.asarray(spembs),
                       jnp.asarray(sids), method=JFastSpeech2.inference)
    port = _port(cfg, variables, backend)
    with torch.no_grad():
        got = port.inference(torch.from_numpy(xs.astype(np.int64)), torch.from_numpy(LENS), 40,
                             torch.from_numpy(spembs), torch.from_numpy(sids.astype(np.int64)))
    np.testing.assert_array_equal(got["duration"].numpy(), np.asarray(want["duration"]))
    np.testing.assert_array_equal(got["olens"].numpy(), np.asarray(want["olens"]))
    assert got["duration"].numpy().sum() > 0
    for key in ("pitch", "energy", "feat_gen"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    # the speaker inputs change the output
    with torch.no_grad():
        other = port.inference(torch.from_numpy(xs.astype(np.int64)), torch.from_numpy(LENS), 40,
                               torch.from_numpy(spembs[::-1].copy()), torch.from_numpy(sids.astype(np.int64)))
    assert not torch.allclose(other["pitch"], got["pitch"])


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("case", ["add", "add+sids"])
def test_latest_multispeaker_training_forward_matches_jax(case, backend):
    cfg = {**FS2, **SPEAKER_CASES[case], **NO_DROPOUT}
    batch = fs2_batch(seed=4, odim=ODIM)
    batch["spembs"], batch["sids"] = _speakers(3, 5)
    jmodel = JFastSpeech2(**cfg)
    jargs = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = randomize(jmodel.init(jax.random.key(0), **jargs), 6)
    want, _ = jmodel.apply(variables, **jargs, deterministic=False, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.key(1)})
    port = _port(cfg, variables, backend)
    got = port(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v) for k, v in batch.items()})
    for key in ("before_outs", "after_outs", "d_outs", "p_outs", "e_outs"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("case", list(SPEAKER_CASES))
def test_latest_multispeaker_layout_round_trip(case):
    """convert_fastspeech2 reads the port's state_dict (with ``projection``
    and ``sid_emb``, and the latest attention's parameters) back into the
    same variables."""
    cfg = {**FS2, **SPEAKER_CASES[case]}
    model, variables = _jax_model_and_vars(cfg, seed=3)
    port = _port(cfg, variables, "xla")
    sd = state_dict_numpy(port)
    assert "projection.weight" in sd and sd["projection.weight"].shape[1] == (
        SPK_DIM if cfg["spk_embed_integration_type"] == "add" else 32 + SPK_DIM)
    assert ("sid_emb.weight" in sd) == ("spks" in cfg)
    assert_trees_equal(convert_fastspeech2(sd, model), variables)


def test_trainer_keeps_the_speaker_table_as_jax_does():
    """``init_type`` redraws weights but leaves embedding tables (flax's
    ``embedding`` leaves), ``sid_emb`` included, as the JAX initializer does."""
    from jatts_torch.utils.initialize import initialize

    port = FastSpeech2(**FS2, spks=SPKS, device="cpu")
    before = port.sid_emb.weight.detach().clone()
    proj = port.projection.weight.detach().clone()
    initialize(port, "xavier_uniform", seed=1)
    assert torch.equal(port.sid_emb.weight, before)
    assert not torch.equal(port.projection.weight, proj)


def _ms_batch(seed):
    batch = fs2_batch(seed=seed, odim=ODIM)
    batch["spembs"], batch["sids"] = _speakers(3, 10 + seed)
    return batch


def test_three_step_multispeaker_trajectory_matches_jax_trainer(tmp_path):
    """The JVS-like model (latest rel-pos, ``spk_embed_dim`` add, and speaker
    ids) trains 3 steps in both trainers from the same weights; the port
    under ``flash`` (the fused branch, plain K1r on the CPU), the JAX package
    on its eager path (its flash branch needs a TPU; the two are exact)."""
    cfg = {**FS2, **NO_DROPOUT, "spks": SPKS}
    batches = [_ms_batch(s) for s in range(3)]
    config = _config(ema_decay=0.9)
    jmodel = JFastSpeech2(**cfg)
    losses = ("MelLoss", "DurationPredictorLoss", "PitchLoss", "EnergyLoss")
    jt = JTrainer(config, jmodel, {n: JLOSS[n]() for n in losses}, jfastspeech2_loss,
                  FakeLoader(batches), outdir=str(tmp_path / "jax"), mesh=None, seed=0)
    jt.init_state(jt._prep(batches[0], 1))
    init_sd = fastspeech2_state_dict_from_jax(
        jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    assert "projection.weight" in init_sd and "sid_emb.weight" in init_sd
    model = FastSpeech2(**{**cfg, "init_type": "none"}, attn_backend="flash", device="cpu")
    model.load_state_dict(init_sd, strict=True)
    pt = Trainer(config, model, {n: LOSS_REGISTRY[n]() for n in losses}, fastspeech2_loss,
                 FakeLoader(batches), outdir=str(tmp_path / "port"), seed=0)
    pt.init_state()
    for i, b in enumerate(batches):
        jt.state, s = jt.train_step(jt.state, jt._prep(b, 1), jax.random.fold_in(jt.rng, i))
        want = {k: float(v) for k, v in s.items()}
        got = pt.train_step(b)
        for key in ("train/loss", "train/grad_norm", "train/mel_loss", "train/duration_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    total_lr = sum(schedulers.warmuplr(1e-3, 4)(i) for i in range(3))
    final = fastspeech2_state_dict_from_jax(
        jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    _assert_weights(pt.model.state_dict(), final, total_lr)


NMELS, MAX_FRAMES, BATCH, BUCKET = ODIM, 48, 4, 16
VOC = dict(
    in_channels=NMELS, channels=16, upsample_scales=(3, 2), upsample_kernel_sizes=(6, 4),
    resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),),
)
REQUESTS = [[3, 4, 5, 6, 7, 8, 9, 10, 11, 2, 3], [1, 2, 3], [5, 5, 5, 5, 5, 5]]


@pytest.fixture(scope="module")
def serving():
    rng = np.random.default_rng(0)
    stats = {k: rng.normal(size=NMELS).astype(np.float32) if "mean" in k
             else rng.uniform(0.5, 2.0, size=NMELS).astype(np.float32)
             for k in ("mel_mean", "mel_scale")}
    jfs2, fvars = _jax_model_and_vars(FS2, seed=1)
    jvoc = JHiFiGAN(**VOC)
    vvars = randomize(jvoc.init(jax.random.key(1), jnp.zeros((1, 4, NMELS))), 2)
    fs2 = _port(FS2, fvars, "flash")
    voc = HiFiGANGenerator(**VOC, device="cpu")
    voc.load_state_dict(hifigan_state_dict_from_jax(vvars), strict=True)
    bundle = ServingBundle(fs2, voc, stats["mel_mean"], stats["mel_scale"], batch_size=BATCH,
                           buckets=[BUCKET], max_frames=MAX_FRAMES, wav_format="f32")
    return SimpleNamespace(jfs2=jfs2, fvars=fvars, jvoc=jvoc, vvars=vvars, stats=stats, bundle=bundle)


def test_bundle_with_spembs_matches_build_infer_fn(serving):
    """Three requests with their speaker embeddings, padded to the batch
    with zero rows on both sides."""
    s = serving
    fn, weights = build_infer_fn(
        {"model_type": "FastSpeech2"}, s.jfs2, s.fvars, s.stats["mel_mean"], s.stats["mel_scale"],
        MAX_FRAMES, vocoder=SimpleNamespace(model=s.jvoc, variables=s.vvars, mean=None, scale=None),
        use_spembs=True, wav_format="f32",
    )
    spembs, _ = _speakers(len(REQUESTS), 7)
    xs = np.zeros((BATCH, BUCKET), np.int32)
    ilens = np.zeros((BATCH,), np.int32)
    for i, ids in enumerate(REQUESTS):
        xs[i, : len(ids)] = ids
        ilens[i] = len(ids)
    se = np.zeros((BATCH, SPK_DIM), np.float32)
    se[: len(spembs)] = spembs
    want = jax.jit(fn)(weights, xs, ilens, np.uint32(0), se)
    olens = np.asarray(want["olens"])
    assert s.bundle.spk_dim == SPK_DIM
    got = s.bundle.synthesize(REQUESTS, spembs=spembs)
    hop = s.bundle.hop_size
    for i, r in enumerate(got):
        assert olens[i] > 0 and r["mel"].shape == (olens[i], NMELS)
        np.testing.assert_allclose(r["mel"], np.asarray(want["mel"])[i, : olens[i]], **TOL)
        np.testing.assert_allclose(r["wav"], np.asarray(want["wav"])[i, : olens[i] * hop], **TOL)
    with pytest.raises(ValueError, match="spembs"):
        s.bundle.synthesize(REQUESTS, spembs=spembs[:, :2])


def test_batching_server_stacks_spembs(serving):
    """Each request's ``spemb`` reaches its own row: served results equal
    the bundle's for that request alone; a request without one gets the
    zero embedding, as the JAX server gives it."""
    bundle = serving.bundle
    spembs, _ = _speakers(len(REQUESTS), 8)
    alone = [bundle.synthesize([ids], spembs=se[None]) for ids, se in zip(REQUESTS, spembs)]
    no_spemb = bundle.synthesize([REQUESTS[0]], spembs=np.zeros((1, SPK_DIM), np.float32))[0]
    with BatchingServer(bundle, max_delay_ms=50) as server:
        futures = [server.submit(token_ids=ids, spemb=se) for ids, se in zip(REQUESTS, spembs)]
        futures.append(server.submit(token_ids=REQUESTS[0]))
        results = [f.result(timeout=60) for f in futures]
    for r, a in zip(results, alone):
        np.testing.assert_allclose(r["wav"], a[0]["wav"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(results[-1]["wav"], no_spemb["wav"], rtol=1e-5, atol=1e-5)
    a, b = results[0]["mel"], results[-1]["mel"]  # the same text, two speakers
    assert a.shape != b.shape or not np.allclose(a, b)


FEATS = ["mel", "pitch", "energy", "spkemb"]
PHONES = ["a", "i", "u", "e", "o", "k", "s", "t"]


def write_spk_corpus(root, fmt, n_utts=6, seed=0):
    """csv, dumps with a ``spkemb`` per utterance (3 speakers), stats over
    every feature of ``FEATS`` (``spkemb_mean``/``_scale`` included, as
    jatts_tpu/bin/compute_statistics.py writes them) and tokens.txt."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "dump"), exist_ok=True)
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank>", "<unk>", *PHONES, "<sos/eos>"]) + "\n")
    speakers = rng.normal(size=(3, SPK_DIM)).astype(np.float32)
    rows, feats = [], {f: [] for f in FEATS}
    for i in range(n_utts):
        n = int(rng.integers(3, 12))
        durs = rng.integers(1, 6, n)
        arrays = {
            "mel": rng.normal(-4.0, 2.0, (int(durs.sum()), ODIM)).astype(np.float32),
            "pitch": rng.normal(5.0, 0.3, n).astype(np.float32),
            "energy": rng.uniform(0.1, 3.0, n).astype(np.float32),
            "spkemb": speakers[i % 3] + 0.1 * rng.normal(size=SPK_DIM).astype(np.float32),
        }
        path = os.path.join(root, "dump", f"U{i}.{fmt}")
        if fmt == "h5":
            for k, v in arrays.items():
                write_hdf5(path, k, v)
        else:
            np.savez(path, **arrays)
        rows.append({"sample_id": f"U{i}", "spk": f"s{i % 3}", "phonemes": " ".join(rng.choice(PHONES, n)),
                     "durations": " ".join(map(str, durs)), "feat_path": path})
        for f in FEATS:
            feats[f].append(arrays[f] if arrays[f].ndim > 1 else arrays[f][:, None])
    stats = {}
    for f, xs in feats.items():  # 1-d dumps as columns, as compute_statistics reads them
        cat = np.concatenate(xs)
        stats[f"{f}_mean"] = cat.mean(0).astype(np.float32)
        stats[f"{f}_scale"] = cat.std(0).astype(np.float32)
    stats_path = os.path.join(root, f"stats.{fmt}")
    if fmt == "h5":
        for k, v in stats.items():
            write_hdf5(stats_path, k, v)
    else:
        np.savez(stats_path, **stats)
    csv_path = os.path.join(root, "train.csv")
    write_csv(rows, csv_path)
    return csv_path, stats_path, tokens


def test_spkemb_dumps_batch_as_jax_does(tmp_path):
    """``spkemb`` is read, normalised by the scaler and stacked into
    ``spembs`` [B, spk_dim] exactly as the JAX dataset and collater do."""
    csv, stats, tokens = write_spk_corpus(str(tmp_path), "h5")
    jds, ds = JTTSDataset(csv, stats, FEATS, tokens), TTSDataset(csv, stats, FEATS, tokens)
    lengths = [ds.get_frame_len(i) for i in range(len(ds))]
    want = [JCollater()([jds[i] for i in idx]) for idx in JBatchSampler(lengths, 2, seed=3)]
    got = list(DataLoader(ds, BatchSampler(lengths, 2, seed=3), FastSpeech2Collater(), prefetch=0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["spembs"].shape == (len(g["utt_ids"]), SPK_DIM)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the scaler touched spkemb: over the corpus the normalised entries have
    # mean 0 and variance 1 (one scalar mean and scale for a 1-d dump)
    allsp = np.concatenate([g["spembs"] for g in got[:3]])
    assert abs(allsp.mean()) < 1e-5 and abs(allsp.std() - 1.0) < 1e-4


def test_tts_train_cli_trains_the_latest_multispeaker_model(tmp_path):
    """The JVS conf's shape (``spkemb`` in ``feat_list``, ``spk_embed_dim``
    add) with ``conformer_rel_pos_type: latest`` under ``--attn-backend
    flash``, 4 steps on the CPU."""
    csv, stats, tokens = write_spk_corpus(str(tmp_path / "corpus"), "npz")
    conf = {
        "sampling_rate": 24000, "hop_size": 300, "feat_list": FEATS, "out_feat_type": "mel",
        "model_type": "FastSpeech2", "trainer_type": "FastSpeech2Trainer",
        "collater_type": "FastSpeech2Collater",
        "model_params": dict(
            odim=ODIM, adim=16, aheads=2, elayers=1, eunits=32, dlayers=1, dunits=32,
            postnet_layers=2, postnet_chans=8, duration_predictor_chans=8,
            pitch_predictor_layers=2, pitch_predictor_chans=8, energy_predictor_chans=8,
            conformer_dec_kernel_size=7, spk_embed_dim=SPK_DIM, spk_embed_integration_type="add",
            conformer_rel_pos_type="latest",
        ),
        "criterions": {"MelLoss": {"_type": "L1Loss"}, "DurationPredictorLoss": {},
                       "PitchLoss": {}, "EnergyLoss": {}},
        "batch_size": 3, "optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3},
        "grad_norm": 1.0, "scheduler": "warmuplr", "scheduler_params": {"warmup_steps": 4},
        "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 2,
        "log_interval_steps": 2,
    }
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    outdir = tmp_path / "exp"
    tts_train.main([
        "--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
        "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu",
        "--attn-backend", "flash", "--verbose", "0",
    ])
    latest = find_latest_checkpoint(str(outdir))
    assert latest.endswith("checkpoint-4steps")
    state = torch.load(os.path.join(latest, "state.pt"), weights_only=True)
    assert state["steps"] == 4 and "projection.weight" in state["model"]
    assert "decoder.encoders.0.self_attn.pos_bias_u" in state["model"]
    assert all(torch.isfinite(v).all() for v in state["model"].values() if v.is_floating_point())
