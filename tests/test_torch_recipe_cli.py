"""The port's tts1 stage CLIs against the JAX package's on the CPU, on a
4-utterance synthetic corpus: stage 1 (preprocess), 1b (statistics) and 2
(token list) through both packages' CLIs into ``.h5``; then stage 4
(tts_decode) on a FastSpeech2 whose weights are carried from JAX
parameters, against JAX ``FastSpeech2.inference``; the ``npz`` dump format,
the inference dataset's lenient load and the gates of the features that
need weights."""

import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from jatts_tpu.data.batcher import round_up  # noqa: E402
from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.utils.io import list_hdf5, read_hdf5  # noqa: E402
from jatts_torch.bin import compute_statistics as tstats  # noqa: E402
from jatts_torch.bin import generate_token_list as ttokens  # noqa: E402
from jatts_torch.bin import preprocess as tpre  # noqa: E402
from jatts_torch.bin import tts_decode as tdecode  # noqa: E402
from jatts_torch.data.dataset import TTSDataset  # noqa: E402
from jatts_torch.utils import io as tio  # noqa: E402
from jatts_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax  # noqa: E402
from tests.test_f0_accuracy import synth_speechlike  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

SR, HOP, N_MELS = 24000, 300, 20
PHONES = ["a", "i", "u", "e", "o", "k", "s", "t", "N", "cl"]
CONFIG = {
    "sampling_rate": SR, "fft_size": 2048, "hop_size": HOP, "win_length": None,
    "num_mels": N_MELS, "fmin": 80, "fmax": 7600, "global_gain_scale": 1.0,
    "feat_list": ["mel", "pitch", "energy"],
    "pitch_extract_f0min": 40, "pitch_extract_f0max": 400,
}
MODEL = dict(odim=N_MELS, adim=32, aheads=2, elayers=1, eunits=48, dlayers=1, dunits=48,
             postnet_layers=3, postnet_chans=16, duration_predictor_chans=16,
             pitch_predictor_layers=2, pitch_predictor_chans=16, energy_predictor_chans=16,
             conformer_dec_kernel_size=7)


def _make_corpus(root, n=4):
    """``n`` utterances of speech-like pulse trains (two speakers, f0
    gliding, an unvoiced stretch) with durations whose sum is the mel
    frame count; speaker spk1 gets its own f0 range from a yaml."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        ph = rng.choice(PHONES, int(rng.integers(5, 11))).tolist()
        durs = rng.integers(3, 9, len(ph))
        n_samples = (int(durs.sum()) - 1) * HOP + 100
        c = np.linspace(100.0 + 20 * i, 170.0, n_samples)
        c[n_samples // 3 : n_samples // 3 + 2 * HOP] = 0.0
        path = os.path.join(root, "wav", f"utt{i}.wav")
        tio.write_audio(path, synth_speechlike(c, seed=i), SR)
        rows.append({"sample_id": f"utt{i}", "spk": f"spk{i % 2}", "wav_path": path, "start": "",
                     "end": "", "original_text": "x", "phonemes": " ".join(ph),
                     "durations": " ".join(str(d) for d in durs)})
    csv = os.path.join(root, "data.csv")
    tio.write_csv(rows, csv)
    conf = os.path.join(root, "conf.yaml")
    with open(conf, "w") as f:
        yaml.dump(CONFIG, f)
    f0_conf = os.path.join(root, "f0.yaml")
    with open(f0_conf, "w") as f:
        yaml.dump({"spk1": {"f0min": 70, "f0max": 300}}, f)
    return csv, conf, f0_conf


def _jax_cli(module_main, argv):
    old = sys.argv
    sys.argv = argv
    try:
        module_main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """Stages 1, 1b and 2 through both packages' CLIs (the port's on the
    CPU, ``.h5``), each into its own directory."""
    from jatts_tpu.bin.compute_statistics import main as jstats_main
    from jatts_tpu.bin.generate_token_list import main as jtokens_main
    from jatts_tpu.bin.preprocess import main as jpre_main

    root = str(tmp_path_factory.mktemp("recipe"))
    csv, conf, f0_conf = _make_corpus(root)
    out = {"root": root, "conf": conf, "in_csv": csv}
    for side in ("jax", "port"):
        d = os.path.join(root, side)
        os.makedirs(d)
        args = ["--csv", csv, "--config", conf, "--dumpdir", os.path.join(d, "dump"),
                "--out-csv", os.path.join(d, "data.csv"), "--f0-config", f0_conf, "--verbose", "0"]
        stats_args = ["--csv", os.path.join(d, "data.csv"), "--config", conf,
                      "--out", os.path.join(d, "stats.h5"), "--verbose", "0"]
        tok_args = ["--csv", os.path.join(d, "data.csv"), "--out", os.path.join(d, "tokens.txt")]
        if side == "jax":
            _jax_cli(jpre_main, ["preprocess"] + args)
            _jax_cli(jstats_main, ["stats"] + stats_args)
            _jax_cli(jtokens_main, ["tokens"] + tok_args)
        else:
            tpre.main(args + ["--device", "cpu"])
            tstats.main(stats_args)
            ttokens.main(tok_args)
        out[side] = d
    return out


def test_preprocess_matches_jax(stages):
    """The same csv columns and dump keys; the waveform exact, the log-mel
    to 5e-5 (tests/test_torch_dsp.py), the token-averaged log-f0 to 1e-3 on
    the same voicing (tests/test_torch_extractors.py), the token-averaged
    energy to 1e-4 relative."""
    jrows, jnames = tio.read_csv(os.path.join(stages["jax"], "data.csv"), dict_reader=True)
    trows, tnames = tio.read_csv(os.path.join(stages["port"], "data.csv"), dict_reader=True)
    assert tnames == jnames and tnames[-1] == "feat_path" and len(trows) == len(jrows) == 4
    for jrow, trow in zip(jrows, trows):
        assert {k: v for k, v in trow.items() if k != "feat_path"} == \
            {k: v for k, v in jrow.items() if k != "feat_path"}
        jp, tp = jrow["feat_path"], trow["feat_path"]
        assert tp == os.path.join(stages["port"], "dump", f"{trow['sample_id']}.h5")
        assert sorted(tio.list_hdf5(tp)) == sorted(list_hdf5(jp)) == ["energy", "mel", "pitch", "wave"]
        np.testing.assert_array_equal(tio.read_hdf5(tp, "wave"), read_hdf5(jp, "wave"))
        n_tok = len(trow["phonemes"].split())
        mel = tio.read_hdf5(tp, "mel")
        assert mel.shape == read_hdf5(jp, "mel").shape == (sum(int(d) for d in trow["durations"].split()), N_MELS)
        np.testing.assert_allclose(mel, read_hdf5(jp, "mel"), rtol=0, atol=5e-5)
        pitch, jpitch = tio.read_hdf5(tp, "pitch"), read_hdf5(jp, "pitch")
        assert pitch.shape == jpitch.shape == (n_tok,) and pitch.dtype == np.float32
        np.testing.assert_array_equal(pitch > 0, jpitch > 0)
        np.testing.assert_allclose(pitch, jpitch, rtol=0, atol=1e-3)
        np.testing.assert_allclose(tio.read_hdf5(tp, "energy"), read_hdf5(jp, "energy"), rtol=1e-4, atol=1e-5)


def test_statistics_and_token_list_match_jax(stages):
    """Stats within 1e-5 relative (and exact when the port's CLI reads the
    JAX package's dumps); tokens.txt byte-identical."""
    for key in ("mel_mean", "mel_scale", "pitch_mean", "pitch_scale", "energy_mean", "energy_scale"):
        want = read_hdf5(os.path.join(stages["jax"], "stats.h5"), key)
        got = tio.read_hdf5(os.path.join(stages["port"], "stats.h5"), key)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    on_jax_dumps = tstats.run(os.path.join(stages["jax"], "data.csv"), CONFIG,
                              os.path.join(stages["root"], "stats_of_jax_dumps.npz"))
    for key, value in on_jax_dumps.items():
        np.testing.assert_array_equal(value, read_hdf5(os.path.join(stages["jax"], "stats.h5"), key))
    with open(os.path.join(stages["jax"], "tokens.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(stages["port"], "tokens.txt"), "rb") as f:
        assert f.read() == want
    assert ttokens.run([os.path.join(stages["port"], "data.csv")], os.path.join(stages["root"], "t2.txt"),
                       cutoff=100) == ["<blank>", "<unk>", "<sos/eos>"]


def test_npz_dump_format_and_stats(stages, tmp_path):
    """--dump-format npz writes {utt}.npz with the keys and values of the
    .h5 dumps; stats to .npz equal stats to .h5."""
    csv = str(tmp_path / "data.csv")
    tpre.main(["--csv", stages["in_csv"], "--config", stages["conf"], "--dumpdir", str(tmp_path / "dump"),
               "--out-csv", csv, "--f0-config", os.path.join(stages["root"], "f0.yaml"),
               "--dump-format", "npz", "--device", "cpu", "--verbose", "0"])
    rows, _ = tio.read_csv(csv, dict_reader=True)
    h5_rows, _ = tio.read_csv(os.path.join(stages["port"], "data.csv"), dict_reader=True)
    for row, h5_row in zip(rows, h5_rows):
        assert row["feat_path"] == str(tmp_path / "dump" / f"{row['sample_id']}.npz")
        with np.load(row["feat_path"]) as f:
            assert sorted(f.files) == sorted(tio.list_hdf5(h5_row["feat_path"]))
            for key in f.files:
                np.testing.assert_array_equal(f[key], tio.read_hdf5(h5_row["feat_path"], key))
    stats = tstats.run(csv, CONFIG, str(tmp_path / "stats.npz"))
    with np.load(str(tmp_path / "stats.npz")) as f:
        assert sorted(f.files) == sorted(stats)
        for key in f.files:
            np.testing.assert_array_equal(f[key], tio.read_hdf5(os.path.join(stages["port"], "stats.h5"), key))
    with pytest.raises(ValueError, match="dump_format"):
        tpre.run(stages["in_csv"], CONFIG, str(tmp_path / "d2"), out_csv=str(tmp_path / "x.csv"),
                 dump_format="wav", device="cpu")


def test_inference_dataset_loads_leniently(stages, tmp_path):
    """is_inference: a dump without a feature skips it, a row without a
    feat_path loads none; training mode still raises. Scaler.inverse
    undoes transform; return_utt_id False leaves out utt_id."""
    rows, _ = tio.read_csv(os.path.join(stages["port"], "data.csv"), dict_reader=True)
    np.savez(str(tmp_path / "partial.npz"), mel=tio.read_hdf5(rows[0]["feat_path"], "mel"))
    rows[0]["feat_path"] = str(tmp_path / "partial.npz")
    rows[1]["feat_path"] = ""
    csv = str(tmp_path / "mixed.csv")
    tio.write_csv(rows, csv)
    stats, tokens = os.path.join(stages["port"], "stats.h5"), os.path.join(stages["port"], "tokens.txt")
    feats = ["mel", "pitch", "energy"]
    ds = TTSDataset(csv, stats, feats, tokens, is_inference=True)
    assert set(ds[0]) >= {"utt_id", "x", "mel"} and "pitch" not in ds[0]
    assert not {"mel", "pitch", "energy"} & set(ds[1])
    assert {"mel", "pitch", "energy"} <= set(ds[2])
    with pytest.raises(KeyError):
        TTSDataset(csv, stats, feats, tokens)[0]
    assert "utt_id" not in TTSDataset(csv, stats, feats, tokens, is_inference=True, return_utt_id=False)[2]
    raw = tio.read_hdf5(rows[2]["feat_path"], "mel")
    np.testing.assert_allclose(ds.scaler.inverse("mel", ds.scaler.transform("mel", raw)), raw, rtol=1e-5, atol=1e-5)
    assert ds.scaler.inverse("encodec", raw) is raw


def test_feature_gates(stages, tmp_path, caplog):
    """spkemb and encodec need weights: without them the stage warns and
    the dump has no such key; with a spkemb model path (speechbrain's
    layout, here at small widths) every dump holds the ECAPA-TDNN's
    embedding, and a path to no file raises."""
    config = dict(CONFIG, feat_list=["mel", "spkemb", "encodec"])
    with caplog.at_level(logging.WARNING):
        tpre.run(stages["in_csv"], config, str(tmp_path / "dump"), out_csv=str(tmp_path / "a.csv"),
                 dump_format="npz", device="cpu")
    assert "skipping spkemb" in caplog.text and "skipping codes" in caplog.text
    rows, _ = tio.read_csv(str(tmp_path / "a.csv"), dict_reader=True)
    with np.load(rows[0]["feat_path"]) as f:
        assert sorted(f.files) == ["mel", "wave"]
    from jatts_torch.features.ecapa import EcapaTdnn

    small = dict(channels=(16, 16, 16, 16, 48), attn_ch=8, res2net_scale=8, se_ch=8, lin_neurons=12)
    ckpt = str(tmp_path / "embedding_model.ckpt")
    torch.save(EcapaTdnn(**small, device="cpu").state_dict(), ckpt)
    config = dict(config, feat_list=["spkemb"], spkemb_model_path=ckpt)
    tpre.run(stages["in_csv"], config, str(tmp_path / "d2"), out_csv=str(tmp_path / "b.csv"), dump_format="npz",
             device="cpu")
    for row in tio.read_csv(str(tmp_path / "b.csv"), dict_reader=True)[0]:
        with np.load(row["feat_path"]) as f:
            assert sorted(f.files) == ["spkemb", "wave"]
            assert f["spkemb"].shape == (12,) and f["spkemb"].dtype == np.float32
            assert np.isfinite(f["spkemb"]).all()
    with pytest.raises(FileNotFoundError):
        tpre.run(stages["in_csv"], dict(config, spkemb_model_path=str(tmp_path / "none.ckpt")),
                 str(tmp_path / "d3"), out_csv=str(tmp_path / "c.csv"), dump_format="npz", device="cpu")


@pytest.fixture(scope="module")
def experiment(stages):
    """A port checkpoint and exp config.yml of a 2-layer FastSpeech2 (one
    conformer block in the encoder, one in the decoder; adim 32) whose
    weights are numpy-made JAX parameters."""
    tokens = os.path.join(stages["port"], "tokens.txt")
    with open(tokens, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    model = JFastSpeech2(idim=n_vocab, **MODEL)
    variables = model.init(jax.random.key(0), jnp.ones((2, 16), jnp.int32), jnp.asarray([16, 9]), 16,
                           method=JFastSpeech2.inference)
    variables = randomize(variables, 0)
    variables["params"]["duration_predictor"]["linear"]["bias"][:] = np.log(4.0)
    expdir = os.path.join(stages["root"], "exp")
    save_checkpoint(expdir, 5, {"model": fastspeech2_state_dict_from_jax(variables), "optimizer": None,
                                "steps": 5, "epochs": 0, "ema": None})
    config = dict(CONFIG, model_type="FastSpeech2", model_params=dict(MODEL))
    with open(os.path.join(expdir, "config.yml"), "w") as f:
        yaml.dump(config, f)
    return {"model": model, "variables": variables, "expdir": expdir, "tokens": tokens, "config": config}


def _decode_args(stages, experiment, outdir, *extra):
    return ["--csv", os.path.join(stages["port"], "data.csv"), "--stats", os.path.join(stages["port"], "stats.h5"),
            "--token-list", experiment["tokens"], "--expdir", experiment["expdir"],
            "--config", os.path.join(experiment["expdir"], "config.yml"), "--outdir", outdir,
            "--batch-size", "2", "--max-frames", "96", "--device", "cpu", "--verbose", "0", *extra]


def test_tts_decode_matches_jax_inference(stages, experiment, tmp_path):
    """Stage 4 on the CPU: each <utt>_mel.npy equals JAX
    FastSpeech2.inference on the same weights and the same padded batch
    (text to a multiple of 16) at tests/test_torch_fastspeech2.py's
    tolerance (1e-4); olens exact; one Griffin-Lim wav per row, olens * hop
    samples; two batches of one shape, the second timed as steady state."""
    out = tdecode.main(_decode_args(stages, experiment, str(tmp_path)))
    assert out["vocoder"] == "GriffinLimVocoder" and len(out["batches"]) == 2
    assert [b["first_of_shape"] for b in out["batches"]] == [True, False] and out["rtf"] > 0
    ds = TTSDataset(os.path.join(stages["port"], "data.csv"), None, [], experiment["tokens"], is_inference=True)
    items = [ds[i] for i in range(len(ds))]
    for start in (0, 2):
        chunk = items[start : start + 2]
        t_text = round_up(max(len(it["x"]) for it in chunk), 16)
        xs = np.zeros((len(chunk), t_text), np.int32)
        for j, it in enumerate(chunk):
            xs[j, : len(it["x"])] = it["x"]
        ilens = np.asarray([len(it["x"]) for it in chunk], np.int32)
        want = experiment["model"].apply(experiment["variables"], jnp.asarray(xs), jnp.asarray(ilens), 96,
                                         method=JFastSpeech2.inference)
        for j, it in enumerate(chunk):
            olen = int(want["olens"][j])
            assert out["olens"][it["utt_id"]] == olen and olen >= 7
            mel = np.load(str(tmp_path / "wav" / f"{it['utt_id']}_mel.npy"))
            assert mel.shape == (olen, N_MELS)
            np.testing.assert_allclose(mel, np.asarray(want["feat_gen"][j, :olen]), rtol=1e-4, atol=1e-4)
            wav, sr = tio.read_audio(str(tmp_path / "wav" / f"{it['utt_id']}.wav"))
            assert sr == SR and len(wav) == olen * HOP


def test_tts_decode_vocoder_choice_and_refusals(stages, experiment, tmp_path, caplog):
    """--vocoder auto with a configured checkpoint that is missing falls
    back to Griffin-Lim with a warning; --save-anasyn vocodes the row's
    own mel too; a model type the CLI does not decode is refused; a missing
    checkpoint raises."""
    config = dict(experiment["config"], vocoder={"checkpoint": str(tmp_path / "none.pkl"), "config": "x.yml"})
    rows, _ = tio.read_csv(os.path.join(stages["port"], "data.csv"), dict_reader=True)
    csv = str(tmp_path / "one.csv")
    tio.write_csv(rows[:1], csv)
    args = (csv, os.path.join(stages["port"], "stats.h5"), experiment["tokens"])
    with caplog.at_level(logging.WARNING):
        out = tdecode.run(*args, config, str(tmp_path / "a"), expdir=experiment["expdir"], max_frames=96,
                          save_anasyn=True, device="cpu")
    assert out["vocoder"] == "GriffinLimVocoder" and "falling back to Griffin-Lim" in caplog.text
    wav, _ = tio.read_audio(str(tmp_path / "a" / "wav_anasyn" / f"{rows[0]['sample_id']}.wav"))
    assert len(wav) == sum(int(d) for d in rows[0]["durations"].split()) * HOP
    with pytest.raises(ValueError, match="not decoded by this CLI"):
        tdecode.run(*args, dict(config, model_type="E2TTS"), str(tmp_path / "b"), expdir=experiment["expdir"],
                    device="cpu")
    with pytest.raises(FileNotFoundError):
        tdecode.run(*args, config, str(tmp_path / "c"), expdir=str(tmp_path / "empty"), device="cpu")


def test_find_files(tmp_path):
    from jatts_tpu.utils.io import find_files as jfind

    for rel in ("a/x.wav", "a/b/y.wav", "c.wav", "a/z.txt"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    for kw in ({}, {"include_root_dir": False}, {"query": "*.txt"}):
        got = tio.find_files(str(tmp_path), **kw)
        assert sorted(got) == sorted(jfind(str(tmp_path), **kw)) and got
