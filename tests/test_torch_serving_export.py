"""The port's serving artifact (jatts_torch/serving/export.py) on the CPU.

The exported FastSpeech2 program against jatts_tpu's ``build_infer_fn``
jitted on the CPU on the same numpy-made weights (single- and
multi-speaker, wav pcm16 and mel): olens exact, the mel within 1e-4, pcm16
within 1 LSB. Matcha, VITS and E2-TTS loaded from their artifacts against
the in-process bundles bit for bit, on the same seed; the fused VALL-E
program against ``ar_generate`` then ``nar_generate`` on one generator,
code for code; the artifact's meta and bf16 weights; the bundles' errors;
the export CLI end to end on checkpoints the port's Trainer writes."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.serving.export import build_infer_fn as jbuild_infer_fn  # noqa: E402
from jatts_tpu.vocoder.hifigan import HiFiGANGenerator as JHiFiGAN  # noqa: E402
from jatts_torch.bin import export_serving  # noqa: E402
from jatts_torch.models import valle  # noqa: E402
from jatts_torch.models.e2tts import E2TTS  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.models.matchatts import MatchaTTS  # noqa: E402
from jatts_torch.models.vits import VITS  # noqa: E402
from jatts_torch.serving import (  # noqa: E402
    E2ttsServingBundle,
    ServingBundle,
    ValleServingBundle,
    build_infer_fn,
    build_valle_fn,
    export_bundle,
    export_valle_bundle,
    load_bundle,
)
from jatts_torch.serving.bundle import StreamStep, inference_kwargs  # noqa: E402
from jatts_torch.serving.export import _weights_from_npz, build_e2tts_bundle_cli, read_meta  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax, hifigan_state_dict_from_jax  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

NMELS, IDIM, MAX_FRAMES, BATCH, BUCKETS, SPK = 8, 12, 48, 4, (8, 16), 6
FS2 = dict(
    idim=IDIM, odim=NMELS, adim=32, aheads=2, elayers=1, eunits=48, dlayers=1,
    dunits=48, postnet_layers=2, postnet_chans=16, duration_predictor_chans=16,
    pitch_predictor_layers=2, pitch_predictor_chans=16, energy_predictor_chans=16,
    conformer_dec_kernel_size=7,
)
VOC = dict(in_channels=NMELS, channels=16, upsample_scales=(3, 2), upsample_kernel_sizes=(6, 4),
           resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))
REQUESTS = [[3, 4, 5, 6, 7, 8, 9, 10, 11, 2, 3], [1, 2, 3], [5, 5, 5, 5, 5, 5]]
MATCHA = dict(idim=IDIM, odim=NMELS, adim=16, aheads=2, elayers=1, eunits=32, duration_predictor_chans=8,
              decoder_channels=(16, 16), decoder_attention_head_dim=8, decoder_num_heads=2,
              conformer_enc_kernel_size=7)
VITS_P = dict(idim=IDIM, odim=NMELS, adim=16, aheads=2, text_encoder_blocks=1, text_encoder_ffn_expand=2,
              dlayers=1, dunits=32, duration_predictor_chans=8, posterior_encoder_layers=2, flow_flows=2,
              flow_layers=2, conformer_dec_kernel_size=7)
E2 = dict(idim=20, odim=NMELS, dim=32, depth=4, heads=2, ff_mult=2, pe_attn_head=1)
AR = dict(idim=IDIM, n_tokens=64, d_model=64, n_heads=2, n_layers=2, p_dropout=0.0, prompt_max_frame_length=16)
NAR = dict(idim=IDIM, n_tokens=64, d_model=64, n_heads=4, n_layers=2, p_dropout=0.0, n_resp_levels=7,
           prompt_max_frame_length=16)
META_FIELDS = ("model_type", "num_mels", "sampling_rate", "hop_size", "max_frames", "output", "wav_format",
               "batch_size", "text_buckets", "spk_dim", "platforms", "weights_as_args", "weight_dtypes",
               "streaming", "stream_weight_dtypes")


@pytest.fixture(autouse=True)
def one_thread():
    """torch's intra-op threads capped at 1 for each test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _stats(seed=0, n=NMELS):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=n).astype(np.float32) if "mean" in k else rng.uniform(0.5, 2.0, n).astype(np.float32)
            for k in ("mel_mean", "mel_scale", "voc_mean", "voc_scale")}


def _bits_equal(a, b):
    """Same dtype and the same bits (bf16 compared as int16)."""
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def _centre_durations(model, bias=np.log(3.0)):
    with torch.no_grad():
        model.duration_predictor.linear.bias.fill_(float(bias))
    return model


@pytest.fixture(scope="module", params=[0, SPK], ids=["single", "multi"])
def fs2_pair(request):
    """JAX FastSpeech2 + HiFi-GAN on numpy-made weights, and the port's on
    the same weights; ``spk`` the speaker-embedding width (0: none)."""
    spk = request.param
    cfg = dict(FS2, spk_embed_dim=spk, spk_embed_integration_type="add") if spk else dict(FS2)
    jfs2 = JFastSpeech2(**cfg)
    init_args = [jnp.ones((2, 8), jnp.int32), jnp.array([8, 5]), 16] + ([jnp.ones((2, spk))] if spk else [])
    fvars = randomize(jfs2.init(jax.random.key(0), *init_args, method=JFastSpeech2.inference), 1)
    fvars["params"]["duration_predictor"]["linear"]["bias"][:] = np.log(3.0)
    jvoc = JHiFiGAN(**VOC)
    vvars = randomize(jvoc.init(jax.random.key(1), jnp.zeros((1, 4, NMELS))), 2)
    fs2 = FastSpeech2(**cfg, attn_backend="flash", device="cpu")
    fs2.load_state_dict(fastspeech2_state_dict_from_jax(fvars), strict=True)
    voc = HiFiGANGenerator(**VOC, device="cpu")
    voc.load_state_dict(hifigan_state_dict_from_jax(vvars), strict=True)
    return SimpleNamespace(spk=spk, cfg=cfg, jfs2=jfs2, fvars=fvars, jvoc=jvoc, vvars=vvars, fs2=fs2, voc=voc,
                           stats=_stats())


def _voc_ns(voc, stats):
    return SimpleNamespace(model=voc, mean=stats["voc_mean"], scale=stats["voc_scale"])


def _export_mel(path, model, model_params, voc, stats, output, stream=None, wav_format="pcm16",
                config_extra=None, spk=0):
    """The artifact of ``model`` (+ ``voc`` for a wav bundle) through
    ``build_infer_fn`` and ``export_bundle``."""
    config = {"model_type": type(model).__name__, "model_params": model_params, **(config_extra or {})}
    vocoder = _voc_ns(voc, stats) if output == "wav" else None
    fn, weights = build_infer_fn(config, model, stats["mel_mean"], stats["mel_scale"], MAX_FRAMES,
                                 vocoder=vocoder, wav_format=wav_format)
    meta = {"model_type": config["model_type"], "model_params": model_params, "num_mels": NMELS,
            "sampling_rate": 24000, "hop_size": voc.hop_size, "max_frames": MAX_FRAMES, "output": output,
            "wav_format": wav_format if output == "wav" else None, "checkpoint": "checkpoint-1steps"}
    return export_bundle(str(path), fn, BATCH, BUCKETS, meta, spk_dim=spk, weights=weights, stream=stream)


def _padded(requests, bucket):
    xs = np.zeros((BATCH, bucket), np.int32)
    ilens = np.zeros((BATCH,), np.int32)
    for i, ids in enumerate(requests):
        xs[i, : len(ids)] = ids
        ilens[i] = len(ids)
    return xs, ilens


@pytest.mark.parametrize("output", ["wav", "mel"])
@pytest.mark.parametrize("requests", [REQUESTS, REQUESTS[1:]], ids=["bucket16", "bucket8"])
def test_exported_fastspeech2_matches_jax_build_infer_fn(fs2_pair, tmp_path, output, requests):
    p = fs2_pair
    path = _export_mel(tmp_path / "fs2.npz", p.fs2, p.cfg, p.voc, p.stats, output, spk=p.spk)
    bundle = load_bundle(path, device="cpu")
    assert isinstance(bundle, ServingBundle) and bundle.graphs == {}
    spembs = np.random.default_rng(3).normal(size=(len(requests), p.spk)).astype(np.float32) if p.spk else None
    got = bundle.synthesize(requests, seed=0, spembs=spembs)

    jvoc = SimpleNamespace(model=p.jvoc, variables=p.vvars, mean=p.stats["voc_mean"], scale=p.stats["voc_scale"])
    fn, weights = jbuild_infer_fn({"model_type": "FastSpeech2"}, p.jfs2, p.fvars, p.stats["mel_mean"],
                                  p.stats["mel_scale"], MAX_FRAMES, vocoder=jvoc if output == "wav" else None,
                                  use_spembs=bool(p.spk), wav_format="pcm16")
    bucket = min(b for b in BUCKETS if b >= max(map(len, requests)))
    args = [weights, *_padded(requests, bucket), np.uint32(0)]
    if p.spk:
        se = np.zeros((BATCH, p.spk), np.float32)
        se[: len(requests)] = spembs
        args.append(se)
    want = {k: np.asarray(v) for k, v in jax.jit(fn)(*args).items()}
    hop = p.voc.hop_size
    assert (want["olens"][: len(requests)] > 0).sum() >= 2
    for i, r in enumerate(got):
        n = int(want["olens"][i])
        if output == "wav":
            assert set(r) == {"wav"} and r["wav"].dtype == np.int16 and r["wav"].shape == (n * hop,)
            assert np.abs(r["wav"].astype(np.int32) - want["wav"][i, : n * hop].astype(np.int32)).max(initial=0) <= 1
        else:
            assert set(r) == {"mel"} and r["mel"].dtype == np.float32 and r["mel"].shape == (n, NMELS)
            np.testing.assert_allclose(r["mel"], want["mel"][i, :n], rtol=0, atol=1e-4)


def test_artifact_round_trip_keeps_meta_and_bf16_bits(tmp_path):
    torch.manual_seed(0)
    fs2 = _centre_durations(FastSpeech2(**FS2, device="cpu", dtype=torch.bfloat16).to(torch.bfloat16))
    voc = HiFiGANGenerator(**VOC, device="cpu", dtype=torch.bfloat16)
    stats = _stats(1)
    chunk_voc = HiFiGANGenerator(**VOC, device="cpu")
    stream = StreamStep(chunk_voc, MAX_FRAMES, NMELS, chunk=16, voc_mean=stats["voc_mean"],
                        voc_scale=stats["voc_scale"])
    for output in ("wav", "mel"):
        path = _export_mel(tmp_path / f"{output}.npz", fs2, dict(FS2, dtype="bfloat16"), voc, stats, output,
                           stream=stream if output == "mel" else None)
        meta = read_meta(path)
        assert set(META_FIELDS) <= set(meta)
        assert meta["output"] == output and meta["text_buckets"] == list(BUCKETS) and meta["batch_size"] == BATCH
        assert meta["modules"]["w/model"] == {"class": "FastSpeech2", "params": FS2, "dtype": "bfloat16",
                                              "param_dtype": "bfloat16"}
        assert meta["weight_dtypes"] and set(meta["weight_dtypes"].values()) == {"bfloat16"}
        with np.load(path) as z:
            w = _weights_from_npz(z, meta)
            sw = _weights_from_npz(z, meta, "sw", "stream_weight_dtypes")
        sd = fs2.state_dict()
        assert set(w["model"]) == set(sd)
        assert all(_bits_equal(w["model"][k], v) for k, v in sd.items())
        np.testing.assert_array_equal(w["mel_mean"].numpy(), stats["mel_mean"])
        if output == "wav":
            assert meta["modules"]["w/voc"]["params"] == json.loads(json.dumps(voc.hparams()))
            assert all(torch.equal(w["voc"][k], v) for k, v in voc.state_dict().items())
            assert sw is None and meta["streaming"] is None
        else:
            assert "voc" not in w and meta["streaming"] == {"chunk": 16, "context": stream.context,
                                                            "hop": voc.hop_size, "max_frames": MAX_FRAMES,
                                                            "num_mels": NMELS}
            assert all(torch.equal(sw["voc"][k], v) for k, v in chunk_voc.state_dict().items())
        bundle = load_bundle(path, device="cpu")
        assert all(_bits_equal(bundle.model.state_dict()[k], v) for k, v in sd.items())
        assert (bundle.vocoder is None) == (output == "mel") and (bundle.stream is None) == (output == "wav")


@pytest.mark.parametrize("family", ["MatchaTTS", "VITS"])
def test_exported_noise_models_equal_the_in_process_bundle(tmp_path, family):
    torch.manual_seed(1)
    params, cls = (MATCHA, MatchaTTS) if family == "MatchaTTS" else (VITS_P, VITS)
    model = _centre_durations(cls(**params, device="cpu")).eval()
    voc = HiFiGANGenerator(**VOC, device="cpu")
    stats = _stats(2)
    extra = {"ode_steps": 3, "temperature": 0.5} if family == "MatchaTTS" else {"noise_scale": 0.5}
    path = _export_mel(tmp_path / "m.npz", model, params, voc, stats, "wav", wav_format="f32", config_extra=extra)
    loaded = load_bundle(path, device="cpu")
    assert loaded.program.infer_kwargs == inference_kwargs({"model_type": family, **extra})
    inproc = ServingBundle(model, voc, stats["mel_mean"], stats["mel_scale"], batch_size=BATCH, buckets=BUCKETS,
                           max_frames=MAX_FRAMES, voc_mean=stats["voc_mean"], voc_scale=stats["voc_scale"],
                           wav_format="f32", infer_kwargs=inference_kwargs({"model_type": family, **extra}))
    a, b, c = (loaded.synthesize(REQUESTS, seed=s) for s in (1, 1, 2))
    want = inproc.synthesize(REQUESTS, seed=1)
    for x, y, w in zip(a, b, want):
        assert x["mel"].shape[0] > 0
        for k in ("mel", "wav"):
            np.testing.assert_array_equal(x[k], y[k])
            np.testing.assert_array_equal(x[k], w[k])
    assert max(np.abs(x["mel"] - z["mel"]).max() for x, z in zip(a, c) if x["mel"].shape == z["mel"].shape) > 1e-6


def _e2_requests(rng, n, vocab=E2["idim"]):
    return [dict(token_ids=rng.integers(0, vocab, size=int(rng.integers(4, 15))).tolist(),
                 prompt_mels=rng.normal(size=(int(rng.integers(3, 9)), NMELS)).astype(np.float32),
                 gen_frames=int(rng.integers(5, 12))) for _ in range(n)]


def test_exported_e2tts_equals_the_in_process_bundle(tmp_path):
    torch.manual_seed(2)
    model = E2TTS(**E2, device="cpu").eval()
    stats = _stats(3)
    config = {"model_type": "E2TTS", "model_params": dict(E2), "nfe_step": 3, "cfg_strength": 2.0,
              "sway_sampling_coef": -1.0, "num_mels": NMELS}
    path = build_e2tts_bundle_cli(str(tmp_path / "e2"), config, model, stats["mel_mean"], stats["mel_scale"], 2,
                                  [8, 16], 32, ["cuda"])
    assert path.endswith(".npz")
    meta = read_meta(path)
    assert meta["family"] == "E2TTS" and meta["output"] == "mel" and meta["nfe_step"] == 3
    loaded = load_bundle(path, device="cpu")
    assert isinstance(loaded, E2ttsServingBundle)
    inproc = E2ttsServingBundle(model, stats["mel_mean"], stats["mel_scale"], batch_size=2, buckets=[8, 16],
                                max_frames=32, infer_kwargs=inference_kwargs(config))
    reqs = _e2_requests(np.random.default_rng(4), 2)
    fields = [[r[f] for r in reqs] for f in ("token_ids", "prompt_mels", "gen_frames")]
    got, again, other = (loaded.synthesize(*fields, seed=s) for s in (7, 7, 8))
    want = inproc.synthesize(*fields, seed=7)
    for g, a, w, r in zip(got, again, want, reqs):
        assert g.shape == (r["gen_frames"], NMELS)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, a)
    assert max(np.abs(g - o).max() for g, o in zip(got, other)) > 1e-6
    with pytest.raises(ValueError, match="batch"):
        loaded.synthesize(*[f * 2 for f in fields])
    with pytest.raises(ValueError, match="bucket"):
        loaded.synthesize([list(range(17))], fields[1][:1], fields[2][:1])


def _valle_models(seed=3):
    torch.manual_seed(seed)
    return valle.VALLEAR(**AR, device="cpu").eval(), valle.VALLENAR(**NAR, device="cpu").eval()


def _valle_requests(rng, n):
    return ([rng.integers(0, 64, size=int(rng.integers(3, 15))).tolist() for _ in range(n)],
            [rng.integers(0, 64, size=(int(rng.integers(4, 20)), 8)) for _ in range(n)])


@pytest.mark.parametrize("seed", [5, 6])
def test_fused_valle_program_equals_ar_then_nar_generate(tmp_path, seed):
    ar, nar = _valle_models()
    fn, weights = build_valle_fn(ar, nar, max_steps=12, ar_temperature=1.0, nar_temperature=0.7)
    path = export_valle_bundle(str(tmp_path / "valle.npz"), fn, 3, [8, 16], prompt_frames=ar.prompt_max_frame_length,
                               n_prom_levels=ar.n_prom_levels, meta={"model_type": "VALLE", "sampling_rate": 24000,
                                                                     "max_steps": 12, "ar_params": AR,
                                                                     "nar_params": NAR}, weights=weights)
    meta = read_meta(path)
    assert meta["output"] == "codes" and meta["prompt_frames"] == 16 and meta["n_prom_levels"] == 8
    bundle = load_bundle(path, device="cpu")
    assert isinstance(bundle, ValleServingBundle) and bundle.max_steps == 12
    token_ids, prompts = _valle_requests(np.random.default_rng(seed), 3)
    got = bundle.synthesize(token_ids, prompts, seed=seed)

    args = bundle.prepare(token_ids, prompts)
    g = torch.Generator().manual_seed(seed)
    ar_out = valle.ar_generate(ar, *args, max_steps=12, sampling_temperature=1.0, generator=g)
    codes = valle.nar_generate(nar, *args, ar_out["codes"], ar_out["resp_lens"], sampling_temperature=0.7,
                               generator=g)
    lens = ar_out["resp_lens"].numpy()
    for i, c in enumerate(got):
        assert c.dtype == np.int32 and c.shape == (lens[i], 8)
        np.testing.assert_array_equal(c, codes[i, : lens[i]].numpy())
        assert c.size == 0 or (c.min() >= 0 and c.max() < 64)
    # the fused program and the composition on the same device tensors
    direct = bundle.run(*args, seed=seed)
    g = torch.Generator().manual_seed(seed)
    assert torch.equal(direct["codes"], fn(*args, generator=g)["codes"])


def test_bundles_refuse_what_the_jax_bundles_refuse(tmp_path):
    torch.manual_seed(7)
    p = SimpleNamespace(fs2=_centre_durations(FastSpeech2(**FS2, device="cpu")), cfg=FS2,
                        voc=HiFiGANGenerator(**VOC, device="cpu"), stats=_stats(6))
    wav = load_bundle(_export_mel(tmp_path / "w.npz", p.fs2, p.cfg, p.voc, p.stats, "wav"), device="cpu")
    with pytest.raises(ValueError, match="batch"):
        wav.synthesize([[1]] * (BATCH + 1))
    with pytest.raises(ValueError, match="bucket"):
        wav.synthesize([[1] * (BUCKETS[-1] + 1)])
    with pytest.raises(ValueError, match="without stream"):
        next(wav.synthesize_streaming(REQUESTS))
    with pytest.raises(ValueError, match="wav_format"):
        build_infer_fn({"model_type": "FastSpeech2"}, p.fs2, p.stats["mel_mean"], p.stats["mel_scale"], MAX_FRAMES,
                       vocoder=_voc_ns(p.voc, p.stats), wav_format="wav")
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        StreamStep(p.voc, MAX_FRAMES, NMELS, chunk=20)
    with pytest.raises(ValueError, match="receptive field"):
        StreamStep(p.voc, MAX_FRAMES, NMELS, chunk=2)
    with pytest.raises(ValueError, match="model_params"):
        fn, _ = build_infer_fn({"model_type": "FastSpeech2"}, p.fs2, p.stats["mel_mean"], p.stats["mel_scale"],
                               MAX_FRAMES)
        export_bundle(str(tmp_path / "x.npz"), fn, BATCH, BUCKETS, {"model_type": "FastSpeech2"})
    # a wav bundle with a stream step still refuses: its program returns no mel
    both = ServingBundle(p.fs2, p.voc, p.stats["mel_mean"], p.stats["mel_scale"], batch_size=BATCH, buckets=BUCKETS,
                         max_frames=MAX_FRAMES, stream=StreamStep(p.voc, MAX_FRAMES, NMELS, chunk=16))
    with pytest.raises(ValueError, match="mel bundle"):
        next(both.synthesize_streaming(REQUESTS))
    ar, nar = _valle_models()
    vb = ValleServingBundle(ar, nar, batch_size=2, buckets=[8], max_steps=4)
    tok, prom = _valle_requests(np.random.default_rng(0), 3)
    with pytest.raises(ValueError, match="batch"):
        vb.synthesize(tok, prom)
    with pytest.raises(ValueError, match="bucket"):
        vb.synthesize([list(range(9))], prom[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        wav.capture()


# ---------------------------------------------------------------------------
# the export CLI on checkpoints the port's Trainer writes
# ---------------------------------------------------------------------------


def _write_exp(tmp_path, name, config, model, ema=None):
    """``config.yml`` and a checkpoint written by the port's Trainer for
    ``model`` as it stands (``ema``: a state_dict for the EMA copy)."""
    expdir = tmp_path / name
    trainer = Trainer({"optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3},
                       "ema_decay": 0.999 if ema is not None else 0.0}, model, {}, None, [], outdir=str(expdir))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.init_state()
    model.load_state_dict(weights)  # init_state re-initialises by init_type: keep the given weights
    if ema is not None:
        trainer.ema = [ema[n].clone() for n in trainer.names]
    trainer.save_checkpoint()
    (expdir / "config.yml").write_text(yaml.safe_dump(config))
    return expdir


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A FastSpeech2 experiment with a HiFi-GAN checkpoint in
    parallel_wavegan's layout and its stats, and the stats and tokens."""
    root = tmp_path_factory.mktemp("cli")
    torch.manual_seed(4)
    fs2 = _centre_durations(FastSpeech2(**FS2, device="cpu"))
    voc = HiFiGANGenerator(**VOC, device="cpu")
    stats = _stats(5)
    torch.save({"model": {"generator": voc.state_dict()}}, root / "voc.pkl")
    (root / "voc.yml").write_text(yaml.safe_dump({"generator_params": json.loads(json.dumps(VOC)),
                                                  "sampling_rate": 24000}))
    np.savez(root / "voc_stats.npz", mean=stats["voc_mean"], scale=stats["voc_scale"])
    np.savez(root / "stats.npz", mel_mean=stats["mel_mean"], mel_scale=stats["mel_scale"])
    (root / "tokens.txt").write_text("\n".join(f"t{i}" for i in range(IDIM)) + "\n")
    config = {"model_type": "FastSpeech2", "model_params": {k: v for k, v in FS2.items() if k != "idim"},
              "num_mels": NMELS, "sampling_rate": 24000, "hop_size": voc.hop_size,
              "vocoder": {"checkpoint": str(root / "voc.pkl"), "config": str(root / "voc.yml"),
                          "stats": str(root / "voc_stats.npz")}}
    expdir = _write_exp(root, "fs2", config, fs2)
    return SimpleNamespace(root=root, fs2=fs2, voc=voc, stats=stats, expdir=expdir)


def _cli(files, out, *extra):
    return export_serving.main([
        "--config", str(files.expdir / "config.yml"), "--stats", str(files.root / "stats.npz"),
        "--token-list", str(files.root / "tokens.txt"), "--expdir", str(files.expdir), "--out", str(out),
        "--text-buckets", "8,16", "--batch-size", str(BATCH), "--max-frames", str(MAX_FRAMES),
        "--device", "cpu", "--verbose", "0", *extra,
    ])


@pytest.mark.parametrize("vocoder", ["auto", "none", "stream"])
def test_export_cli_mel_models(cli_files, tmp_path, vocoder):
    f = cli_files
    out = _cli(f, tmp_path / "a.npz", "--vocoder", vocoder, "--stream-chunk", "16", "--platforms", "cuda,cpu")
    meta = read_meta(out)
    assert meta["output"] == ("wav" if vocoder == "auto" else "mel")
    assert meta["platforms"] == ["cuda", "cpu"] and meta["checkpoint"] == "checkpoint-0steps"
    assert (meta["streaming"] is not None) == (vocoder == "stream")
    bundle = load_bundle(out, device="cpu")
    want = ServingBundle(f.fs2, f.voc if vocoder == "auto" else None, f.stats["mel_mean"], f.stats["mel_scale"],
                         batch_size=BATCH, buckets=BUCKETS, max_frames=MAX_FRAMES, voc_mean=f.stats["voc_mean"],
                         voc_scale=f.stats["voc_scale"], hop_size=f.voc.hop_size).synthesize(REQUESTS)
    for g, w in zip(bundle.synthesize(REQUESTS), want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_export_cli_stream_needs_the_vocoder(cli_files, tmp_path):
    f = cli_files
    config = yaml.safe_load((f.expdir / "config.yml").read_text())
    config["vocoder"]["checkpoint"] = str(f.root / "missing.pkl")
    (f.root / "novoc").mkdir(exist_ok=True)
    (f.root / "novoc" / "config.yml").write_text(yaml.safe_dump(config))
    with pytest.raises(SystemExit, match="vocoder stream"):
        export_serving.main(["--config", str(f.root / "novoc" / "config.yml"), "--stats", str(f.root / "stats.npz"),
                             "--token-list", str(f.root / "tokens.txt"), "--expdir", str(f.expdir),
                             "--out", str(tmp_path / "x.npz"), "--vocoder", "stream", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--config and --stats"):
        export_serving.main(["--token-list", str(f.root / "tokens.txt"), "--out", str(tmp_path / "y.npz"),
                             "--device", "cpu"])


def test_export_cli_e2tts_takes_the_ema_weights(cli_files, tmp_path):
    f = cli_files
    torch.manual_seed(6)
    model = E2TTS(**dict(E2, idim=IDIM), device="cpu").eval()
    ema_model = E2TTS(**dict(E2, idim=IDIM), device="cpu").eval()
    config = {"model_type": "E2TTS", "model_params": {k: v for k, v in E2.items() if k != "idim"},
              "num_mels": NMELS, "nfe_step": 2, "cfg_strength": 2.0}
    expdir = _write_exp(tmp_path, "e2", config, model, ema=ema_model.state_dict())
    out = export_serving.main(["--config", str(expdir / "config.yml"), "--stats", str(f.root / "stats.npz"),
                               "--token-list", str(f.root / "tokens.txt"), "--expdir", str(expdir),
                               "--out", str(tmp_path / "e2.npz"), "--text-buckets", "16", "--batch-size", "2",
                               "--max-frames", "24", "--device", "cpu", "--verbose", "0"])
    bundle = load_bundle(out, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(bundle.model.state_dict().values(), ema_model.state_dict().values()))
    reqs = _e2_requests(np.random.default_rng(7), 2, vocab=IDIM)
    fields = [[r[k] for r in reqs] for k in ("token_ids", "prompt_mels", "gen_frames")]
    want = E2ttsServingBundle(ema_model, f.stats["mel_mean"], f.stats["mel_scale"], batch_size=2, buckets=[16],
                              max_frames=24, infer_kwargs=inference_kwargs(config)).synthesize(*fields, seed=3)
    for g, w in zip(bundle.synthesize(*fields, seed=3), want):
        np.testing.assert_array_equal(g, w)


def test_export_cli_valle_pair(cli_files, tmp_path):
    f = cli_files
    ar, nar = _valle_models(8)
    ar_exp = _write_exp(tmp_path, "ar", {"model_params": {k: v for k, v in AR.items() if k != "idim"},
                                         "sampling_temperature": 1.0, "nar_sampling_temperature": 0.5}, ar)
    nar_exp = _write_exp(tmp_path, "nar", {"model_params": {k: v for k, v in NAR.items() if k != "idim"}}, nar)
    out = export_serving.main(["--ar-config", str(ar_exp / "config.yml"), "--ar-expdir", str(ar_exp),
                               "--nar-config", str(nar_exp / "config.yml"), "--nar-expdir", str(nar_exp),
                               "--token-list", str(f.root / "tokens.txt"), "--out", str(tmp_path / "v.npz"),
                               "--text-buckets", "16", "--batch-size", "2", "--max-steps", "6",
                               "--device", "cpu", "--verbose", "0"])
    meta = read_meta(out)
    assert meta["model_type"] == "VALLE" and meta["output"] == "codes" and meta["max_steps"] == 6
    assert meta["nar_temperature"] == 0.5 and meta["modules"]["w/ar"]["param_dtype"] == "bfloat16"
    assert set(meta["weight_dtypes"].values()) == {"bfloat16"}
    bundle = load_bundle(out, device="cpu")
    # bf16 compute and parameters, as bin/ttslm_decode.py:load_model makes them
    ar16, nar16 = (type(m)(**kw, device="cpu", dtype=torch.bfloat16) for m, kw in ((ar, AR), (nar, NAR)))
    for m16, m in ((ar16, ar), (nar16, nar)):
        m16.load_state_dict(m.state_dict())
        m16.to(torch.bfloat16).eval()
    assert all(_bits_equal(bundle.program.ar.state_dict()[k], v) for k, v in ar16.state_dict().items())
    tok, prom = _valle_requests(np.random.default_rng(9), 2)
    want = ValleServingBundle(ar16, nar16, batch_size=2, buckets=[16], max_steps=6,
                              nar_temperature=0.5).synthesize(tok, prom, seed=1)
    for g, w in zip(bundle.synthesize(tok, prom, seed=1), want):
        np.testing.assert_array_equal(g, w)
