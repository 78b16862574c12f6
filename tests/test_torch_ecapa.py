"""The port's ECAPA-TDNN (jatts_torch/features/ecapa.py) against the JAX
package's on the CPU: the fbank, the model at small widths with weights
carried both ways (jatts_torch/utils/convert.py:ecapa_state_dict_from_jax
and the JAX package's convert_speechbrain_ecapa) and masked lengths, a
strict load of speechbrain's layout at its published widths, the extractor
on a 1.3 s wav, infer_ecapa_config, the stage-1 spkemb dump against the JAX
CLI's, stage 5's speaker similarity, and verify_ecapa on goldens written
from the JAX package's embeddings."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from jatts_tpu.bin import evaluate as jeval  # noqa: E402
from jatts_tpu.bin import preprocess as jpre  # noqa: E402
from jatts_tpu.bin import verify_ecapa as jverify  # noqa: E402
from jatts_tpu.features import ecapa as je  # noqa: E402
from jatts_torch.bin import evaluate as teval  # noqa: E402
from jatts_torch.bin import preprocess as tpre  # noqa: E402
from jatts_torch.bin import verify_ecapa as tverify  # noqa: E402
from jatts_torch.features import ecapa as te  # noqa: E402
from jatts_torch.utils.convert import ecapa_state_dict_from_jax  # noqa: E402
from jatts_torch.utils.io import read_csv, write_audio, write_csv  # noqa: E402
from tests.torch_replica import SBEcapaTdnn  # noqa: E402

SMALL = dict(channels=(32, 32, 32, 32, 96), kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
             attn_ch=16, res2net_scale=8, se_ch=16, lin_neurons=24)
# f32 against f32 in another order (convolutions, FFTs): the embeddings are
# O(1) here, and 1e-4 is the JAX package's own replica tolerance
# (tests/test_ecapa.py); the fbank's dB values differ by FFT rounding, which
# is relative to a frame's energy, so a bin 80 dB under the batch's peak (the
# top_db floor) can read ~1e-3 dB off
EMB = dict(rtol=1e-3, atol=1e-4)
FBANK_DB = 1e-2


def _randomized(sd, seed):
    """Seed-made values for every float tensor of a state dict (running
    variances in [0.5, 1.5))."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        elif v.dtype.is_floating_point:
            out[k] = torch.randn(v.shape, generator=g) * 0.1
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """A speechbrain-layout checkpoint at SMALL widths and 80 mels."""
    sd = _randomized(SBEcapaTdnn(n_mels=80, **SMALL).state_dict(), 5)
    path = str(tmp_path_factory.mktemp("ecapa") / "embedding_model.ckpt")
    torch.save(sd, path)
    return path


def test_fbank_matches_jax():
    rng = np.random.default_rng(0)
    t = np.arange(20000) / 16000
    wav = np.stack([0.1 * rng.standard_normal(20000), 0.3 * np.sin(2 * np.pi * 220 * t)]).astype(np.float32)
    wav[1, :8000] = 0.0  # silent frames: the top_db floor
    want = np.asarray(je.fbank(jnp.asarray(wav)))
    got = te.fbank(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 126, 80)
    assert np.abs(got - want).max() <= FBANK_DB
    # the floor is the whole batch's max - 80 dB, as in the JAX package
    assert got.min() == got[1].min() == np.float32(got.max() - 80.0)
    np.testing.assert_allclose(te.mel_filterbank_htk(80, 400, 16000), je.mel_filterbank_htk(80, 400, 16000))


def test_model_matches_jax_with_weights_carried_both_ways():
    """JAX variables -> the port (ecapa_state_dict_from_jax), and the port's
    state_dict -> JAX (convert_speechbrain_ecapa): the same embeddings of
    feats with masked lengths, at SMALL widths."""
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 40, 8)).astype(np.float32)
    lens = np.array([40, 25, 17])
    jm = je.EcapaTdnn(**SMALL)
    apply = jax.jit(jm.apply)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(feats), jnp.asarray(lens))
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    r = np.random.default_rng(2)
    vals = [np.abs(r.standard_normal(x.shape)) + 0.5 if "var" in jax.tree_util.keystr(path)
            else 0.2 * r.standard_normal(x.shape) for path, x in flat]
    v = jax.tree_util.tree_unflatten(tree, [np.asarray(x, np.float32) for x in vals])
    want = np.asarray(apply(v, jnp.asarray(feats), jnp.asarray(lens)))

    tm = te.EcapaTdnn(**SMALL, n_mels=8, device="cpu").eval()
    tm.load_state_dict(ecapa_state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, **EMB)

    tm.load_state_dict(_randomized(tm.state_dict(), 3))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(lens)).numpy()
    want = np.asarray(apply(je.convert_speechbrain_ecapa(tm.state_dict()), jnp.asarray(feats), jnp.asarray(lens)))
    np.testing.assert_allclose(got, want, **EMB)
    assert je.infer_ecapa_config(tm.state_dict()) == te.infer_ecapa_config(tm.state_dict()) == SMALL


def test_speechbrain_layout_loads_strict_at_published_widths():
    """speechbrain's embedding_model.ckpt layout (tests/torch_replica.py) at
    the published widths loads with strict=True, num_batches_tracked
    included, and gives the replica's embedding."""
    ref = SBEcapaTdnn().eval()
    sd = _randomized(ref.state_dict(), 4)
    ref.load_state_dict(sd)
    cfg = te.infer_ecapa_config(sd)
    assert cfg == je.infer_ecapa_config(sd) == dict(
        channels=(1024, 1024, 1024, 1024, 3072), kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
        attn_ch=128, res2net_scale=8, se_ch=128, lin_neurons=192)
    tm = te.EcapaTdnn(**cfg, device="cpu").eval()
    assert tm.load_state_dict(sd, strict=True)
    assert set(tm.state_dict()) == set(sd) and any(k.endswith("num_batches_tracked") for k in sd)
    feats = np.random.default_rng(5).standard_normal((2, 30, 80)).astype(np.float32)
    lens = torch.tensor([30, 21])
    with torch.no_grad():
        want = ref(torch.from_numpy(feats), lens).numpy()
        got = tm(torch.from_numpy(feats), lens).numpy()
    np.testing.assert_allclose(got, want, **EMB)


def test_extractor_matches_jax(small_ckpt):
    """A 1.3 s wav (padded to the 2 s bucket) through both extractors; the
    extractor defaults to the card and fails loudly without one."""
    rng = np.random.default_rng(6)
    wav = (0.1 * rng.standard_normal(20800)).astype(np.float32)
    jex = je.EcapaSpkEmbExtractor(small_ckpt)
    tex = te.EcapaSpkEmbExtractor(small_ckpt, device="cpu")
    got, want = tex(wav), np.asarray(jex(wav))
    assert got.shape == want.shape == (24,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **EMB)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            te.EcapaSpkEmbExtractor(small_ckpt)


def test_stage1_and_stage5_speaker_embeddings_match_jax(small_ckpt, tmp_path, monkeypatch):
    """Stage 1 with spkemb_model_path on 24 kHz wavs: the port's npz dumps
    hold the JAX CLI's spkemb (resampled to 16 kHz the same way); stage 5's
    spkemb similarity equals the JAX CLI's."""
    rng = np.random.default_rng(7)
    rows = []
    for i, n in enumerate((30000, 19000)):
        path = str(tmp_path / f"u{i}.wav")
        write_audio(path, (0.1 * rng.standard_normal(n)).astype(np.float32), 24000)
        rows.append({"sample_id": f"u{i}", "spk": "s", "wav_path": path})
    csv = str(tmp_path / "in.csv")
    write_csv(rows, csv)
    config = {"sampling_rate": 24000, "feat_list": ["spkemb"], "spkemb_model_path": small_ckpt}
    conf = str(tmp_path / "conf.yaml")
    with open(conf, "w") as f:
        yaml.dump(config, f)

    jpre._SPKEMB_CACHE.pop("native", None)
    monkeypatch.setattr(sys, "argv", ["preprocess", "--csv", csv, "--config", conf, "--dumpdir",
                                      str(tmp_path / "jax"), "--out-csv", str(tmp_path / "jax.csv"), "--verbose", "0"])
    try:
        jpre.main()
    finally:
        jpre._SPKEMB_CACHE.pop("native", None)
    tpre.run(csv, config, str(tmp_path / "port"), out_csv=str(tmp_path / "port.csv"), dump_format="npz",
             device="cpu")
    import h5py

    for jrow, trow in zip(read_csv(str(tmp_path / "jax.csv"), dict_reader=True)[0],
                          read_csv(str(tmp_path / "port.csv"), dict_reader=True)[0]):
        with h5py.File(jrow["feat_path"], "r") as f:
            want = f["spkemb"][()]
        with np.load(trow["feat_path"]) as f:
            assert sorted(f.files) == ["spkemb", "wave"]
            got = f["spkemb"]
        assert got.shape == want.shape == (24,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **EMB)

    tasks = [(r["sample_id"], r["wav_path"], rows[1 - i]["wav_path"], 24000) for i, r in enumerate(rows)]
    want = jeval._eval_spkemb(tasks, 24000, small_ckpt)
    got = teval._eval_spkemb(tasks, 24000, small_ckpt, device="cpu")
    assert abs(got - want) <= 1e-5


def test_verify_ecapa_on_goldens_from_the_jax_package(small_ckpt, tmp_path, capsys):
    """Goldens of the JAX package's embeddings pass the port's --golden
    check; --write-golden round-trips; a corrupted golden exits non-zero."""
    golden = str(tmp_path / "jax_golden.npz")
    np.savez(golden, **jverify.native_embeddings(small_ckpt))
    ours = tverify.main(["--ckpt", small_ckpt, "--golden", golden, "--atol", "1e-4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("golden check") == 3 and "all checks passed" in out
    assert set(ours) == set(tverify.probe_wavs()) == set(jverify.probe_wavs())
    for name, wav in tverify.probe_wavs().items():
        np.testing.assert_array_equal(wav, jverify.probe_wavs()[name])
    own = str(tmp_path / "own.npz")
    tverify.main(["--ckpt", small_ckpt, "--write-golden", own, "--device", "cpu"])
    tverify.main(["--ckpt", small_ckpt, "--golden", own, "--atol", "0", "--device", "cpu"])
    with np.load(golden) as z:
        bad = {k: z[k] + (1.0 if k == "chirp" else 0.0) for k in z.files}
    np.savez(golden, **bad)
    with pytest.raises(SystemExit, match="chirp"):
        tverify.main(["--ckpt", small_ckpt, "--golden", golden, "--device", "cpu"])
    assert os.path.exists(own)
