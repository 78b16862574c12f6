"""The port's import_checkpoint CLI (jatts_torch/bin/import_checkpoint.py)
on the CPU: a reference-layout .pkl of a small FastSpeech2 becomes a port
checkpoint that decodes as the original and that the JAX package's importer
reads to the same outputs; the E2-TTS EMA rules against the JAX package's;
--kind hifigan into the port's Vocoder; the refusals."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.utils import torch_import as jimport  # noqa: E402
from jatts_tpu.vocoder import convert as jconvert  # noqa: E402
from jatts_torch.bin import import_checkpoint as timport  # noqa: E402
from jatts_torch.models.e2tts import E2TTS  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.utils.checkpoint import restore_checkpoint  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from jatts_torch.vocoder.vocoder import Vocoder  # noqa: E402

N_VOCAB = 12
MODEL = dict(odim=10, adim=16, aheads=2, elayers=1, eunits=24, dlayers=1, dunits=24, postnet_layers=2,
             postnet_chans=8, duration_predictor_chans=8, pitch_predictor_layers=2, pitch_predictor_chans=8,
             energy_predictor_chans=8, conformer_dec_kernel_size=7)
E2 = dict(idim=20, odim=8, dim=32, depth=4, heads=2, ff_mult=2, pe_attn_head=1)
HIFIGAN = dict(in_channels=8, out_channels=1, channels=16, kernel_size=7, upsample_scales=[2, 2],
               upsample_kernel_sizes=[4, 4], resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
               use_additional_convs=True)


def _write_conf(path, **conf):
    with open(path, "w") as f:
        yaml.dump(conf, f)
    return str(path)


def _seeded(sd, seed):
    """Seed-made values for every float tensor (running variances positive)."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(v.shape, generator=g) + 0.5 if k.endswith("running_var")
                else 0.3 * torch.randn(v.shape, generator=g)) if v.dtype.is_floating_point else v
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def fs2(tmp_path_factory):
    """A small port FastSpeech2 with seed-made weights (the duration bias
    centred on 4 frames a token), saved as a reference training pickle."""
    root = tmp_path_factory.mktemp("import")
    torch.manual_seed(0)
    model = FastSpeech2(idim=N_VOCAB, **MODEL, device="cpu")
    sd = _seeded(model.state_dict(), 1)
    sd["duration_predictor.linear.bias"] = torch.full_like(sd["duration_predictor.linear.bias"], math.log(4.0))
    model.load_state_dict(sd)
    pkl = str(root / "checkpoint-100steps.pkl")
    torch.save({"model": sd, "optimizer": {"lr": 1e-3}, "steps": 100}, pkl)
    tokens = root / "tokens.txt"
    tokens.write_text("".join(f"t{i}\n" for i in range(N_VOCAB)))
    conf = _write_conf(root / "conf.yaml", model_type="FastSpeech2", model_params=dict(MODEL))
    return {"root": root, "model": model.eval(), "pkl": pkl, "conf": conf, "tokens": str(tokens)}


def _batch():
    rng = np.random.default_rng(2)
    xs = rng.integers(1, N_VOCAB, (2, 16)).astype(np.int64)
    xs[1, 9:] = 0
    return xs, np.array([16, 9])


def test_fastspeech2_import_decodes_as_the_original_and_as_jax(fs2):
    """The imported checkpoint (the path the decode CLI and --pretrain read)
    holds the same tensors and decodes bit for bit as the original; the JAX
    package's importer on the same .pkl gives the same mels at f32
    tolerance (1e-4, the decode CLI's parity tolerance) and durations."""
    out = fs2["root"] / "exp"
    path = timport.main(["--checkpoint", fs2["pkl"], "--config", fs2["conf"], "--token-list", fs2["tokens"],
                         "--out", str(out)])
    assert path.endswith("checkpoint-0steps")
    restored = restore_checkpoint(path)
    assert restored["steps"] == 0 and restored["optimizer"] is None and restored["ema"] is None
    model = FastSpeech2(idim=N_VOCAB, **MODEL, device="cpu")
    model.load_state_dict(restored["model"], strict=True)
    model.eval()
    xs, ilens = _batch()
    with torch.no_grad():
        got = model.inference(torch.from_numpy(xs), torch.from_numpy(ilens), 96)
        want = fs2["model"].inference(torch.from_numpy(xs), torch.from_numpy(ilens), 96)
    for k in ("feat_gen", "duration", "olens"):
        assert torch.equal(got[k], want[k]), k
    assert int(got["olens"].min()) > 8

    jm = JFastSpeech2(idim=N_VOCAB, **MODEL)
    variables = jimport.convert_fastspeech2(jimport.load_reference_checkpoint(fs2["pkl"]), jm)
    jout = jax.jit(lambda v, x, l: jm.apply(v, x, l, 96, method=JFastSpeech2.inference))(
        variables, jnp.asarray(xs, jnp.int32), jnp.asarray(ilens, jnp.int32))
    np.testing.assert_array_equal(got["duration"].numpy(), np.asarray(jout["duration"]))
    np.testing.assert_allclose(got["feat_gen"].numpy(), np.asarray(jout["feat_gen"]), rtol=1e-4, atol=1e-4)

    # a checkpoint-* --out is the directory itself; a bare state_dict pickle imports too
    bare = str(fs2["root"] / "bare.pkl")
    torch.save(restored["model"], bare)
    path = timport.main(["--checkpoint", bare, "--config", fs2["conf"], "--token-list", fs2["tokens"],
                         "--out", str(fs2["root"] / "exp2" / "checkpoint-7steps")])
    assert path == str(fs2["root"] / "exp2" / "checkpoint-0steps")
    for k, v in restore_checkpoint(path)["model"].items():
        assert torch.equal(v, restored["model"][k]), k


def test_e2tts_ema_rules_match_jax(tmp_path):
    """Full E2-TTS checkpoints import their EMA weights by default and the
    raw ones under --no-ema; an EMA-only checkpoint imports its EMA weights
    and refuses --no-ema; each state dict equals the JAX package's loader's."""
    torch.manual_seed(0)
    raw = _seeded(E2TTS(**E2, device="cpu").state_dict(), 3)
    ema = _seeded(raw, 4)
    ema_sd = {**{f"ema_model.{k}": v for k, v in ema.items()}, "initted": torch.tensor(True),
              "step": torch.tensor(9)}
    full, only = str(tmp_path / "full.pt"), str(tmp_path / "ema_only.pt")
    torch.save({"model_state_dict": raw, "ema_model_state_dict": ema_sd, "update": 9}, full)
    torch.save({"ema_model_state_dict": ema_sd}, only)
    conf = _write_conf(tmp_path / "e2.yaml", model_type="E2TTS", model_params=dict(E2))
    for pkl, no_ema, want in ((full, False, ema), (full, True, raw), (only, False, ema)):
        path = timport.main(["--checkpoint", pkl, "--config", conf, "--out", str(tmp_path / f"o{len(pkl)}{no_ema}")]
                            + (["--no-ema"] if no_ema else []))
        got = restore_checkpoint(path)["model"]
        jax_sd = jimport.load_reference_e2tts_state(pkl, use_ema=not no_ema)
        assert set(got) == set(want) == set(jax_sd)
        for k in want:
            assert torch.equal(got[k], want[k]), k
            np.testing.assert_array_equal(got[k].numpy(), jax_sd[k])
    with pytest.raises(ValueError, match="EMA-only"):
        timport.main(["--checkpoint", only, "--config", conf, "--out", str(tmp_path / "x"), "--no-ema"])


def test_hifigan_import_feeds_the_vocoder(tmp_path):
    """A parallel_wavegan pickle (weight_g/weight_v pairs) imports as folded
    weights equal to the JAX package's fold, and the port's Vocoder reads the
    imported checkpoint and vocodes as the generator on those weights."""
    torch.manual_seed(0)
    gen = HiFiGANGenerator(**HIFIGAN, device="cpu").eval()
    rng = np.random.default_rng(5)
    pairs = {}
    for k, w in gen.state_dict().items():
        if k.endswith(".weight") and w.dim() == 3:
            base = k[: -len("weight")]
            pairs[base + "weight_v"] = w * torch.from_numpy(rng.uniform(0.5, 2.0, (w.shape[0], 1, 1)).astype(np.float32))
            pairs[base + "weight_g"] = w.flatten(1).norm(dim=1).reshape(-1, 1, 1)
        else:
            pairs[k] = w
    pkl = str(tmp_path / "checkpoint-0steps.pkl")
    torch.save({"model": {"generator": pairs}, "steps": 0}, pkl)
    conf = _write_conf(tmp_path / "voc.yaml", sampling_rate=24000, generator_params=HIFIGAN)
    path = timport.main(["--checkpoint", pkl, "--config", conf, "--kind", "hifigan", "--out", str(tmp_path / "voc")])
    sd = restore_checkpoint(path)["model"]
    jax_fold = jconvert.fold_weight_norm(jconvert.load_torch_state_dict(pkl))
    assert set(sd) == set(jax_fold)
    for k, v in sd.items():
        np.testing.assert_allclose(v.numpy(), jax_fold[k], rtol=1e-6, atol=1e-7)
    gen.load_state_dict(sd, strict=True)
    mel = rng.standard_normal((64, 8)).astype(np.float32)
    voc = Vocoder(f"{path}/state.pt", conf, device="cpu")
    with torch.no_grad():
        want = gen(torch.from_numpy(mel)[None])[0, :, 0].numpy()
    np.testing.assert_array_equal(voc.decode(mel), want)


def test_refusals(fs2, tmp_path):
    """A stochastic duration predictor (keys the port's own), an unknown
    model type and a checkpoint missing a key are refused."""
    for model_type in ("VITS", "MatchaTTS_MAS"):
        conf = _write_conf(tmp_path / f"{model_type}.yaml", model_type=model_type,
                           model_params={"duration_predictor_type": "stochastic"})
        with pytest.raises(ValueError, match="stochastic"):
            timport.main(["--checkpoint", fs2["pkl"], "--config", conf, "--out", str(tmp_path / "s")])
    conf = _write_conf(tmp_path / "x.yaml", model_type="Tacotron2", model_params={})
    with pytest.raises(ValueError, match="unknown model_type"):
        timport.main(["--checkpoint", fs2["pkl"], "--config", conf, "--out", str(tmp_path / "t")])
    sd = dict(fs2["model"].state_dict())
    sd.pop("feat_out.weight")
    bad = str(tmp_path / "bad.pkl")
    torch.save({"model": sd}, bad)
    with pytest.raises(RuntimeError, match="feat_out.weight"):
        timport.main(["--checkpoint", bad, "--config", fs2["conf"], "--token-list", fs2["tokens"],
                      "--out", str(tmp_path / "b")])
