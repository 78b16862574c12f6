"""Stage 5 of the port (jatts_torch/evaluate, jatts_torch/bin/evaluate.py)
against the JAX package on the CPU: the float64 WORLD-comparable parts on
the same f0, the DTW path index for index (ties included), the silence
trim, world_extract and calculate_mcd_f0 end to end on periodic signals,
the CER pieces, and the evaluate CLI's results.csv against the JAX CLI's
(and across --n-jobs, bit for bit)."""

import csv
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from jatts_tpu.bin import evaluate as jcli  # noqa: E402
from jatts_tpu.evaluate import dtw_based as jdtw  # noqa: E402
from jatts_tpu.evaluate import world as jworld  # noqa: E402
from jatts_torch.bin import evaluate as tcli  # noqa: E402
from jatts_torch.evaluate import dtw_based as tdtw  # noqa: E402
from jatts_torch.evaluate import world as tworld  # noqa: E402
from jatts_torch.utils.io import write_audio, write_csv  # noqa: E402
from tests.test_f0_accuracy import synth_speechlike  # noqa: E402

SR = 24000
# the float64 parts run the same numpy operations in both packages
F64 = dict(rtol=1e-12, atol=1e-12)
# f0 of the port's NCCF estimator against JAX's on periodic audio: rtol 1e-3
# (tests/test_torch_pitch.py). Measured here 5e-7, and with the same f0 the
# analyses agree bit for bit; so an f0 1e-3 off moves the 3*T0 window by
# under one sample of 240, and the envelope, the mcep (|mcep| <= ~11) and the
# metrics by well under 1e-2 of their scale: 1e-2 relative is the tolerance
# carried from f0's, with the same voicing
E2E = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pulses(seconds, lo, hi, seed, gap=True):
    n = int(seconds * SR)
    c = np.linspace(lo, hi, n)
    if gap:
        c[n // 3 : n // 3 + 2000] = 0.0  # an unvoiced stretch
    return 0.5 * synth_speechlike(c, SR, seed=seed)


def _tone(seconds, f):
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(2 * np.pi * 2 * f * t)).astype(np.float32)


def test_float64_parts_match_on_the_same_f0():
    """low_cut_filter, CheapTrick, sp2mc, freqt, spc2npow and extfrm on the
    JAX package's own f0 track: equal to 1e-12; sp2mc -> mc2sp round trip."""
    x = _pulses(0.5, 110, 170, seed=0)
    xf = np.asarray(x, np.float64) * np.iinfo(np.int16).max
    np.testing.assert_allclose(tworld.low_cut_filter(xf, SR), jworld.low_cut_filter(xf, SR), **F64)
    want = jworld.world_extract(x, SR)
    got = tworld.world_extract(x, SR, f0=want["f0"])
    for key in ("sp", "mcep", "npow"):
        np.testing.assert_allclose(got[key], want[key], **F64)
    pos = np.arange(len(want["f0"])) * 0.005
    np.testing.assert_allclose(tworld.cheaptrick(xf, want["f0"], pos, SR), jworld.cheaptrick(xf, want["f0"], pos, SR),
                               **F64)
    np.testing.assert_allclose(tworld.sp2mc(want["sp"]), jworld.sp2mc(want["sp"]), **F64)
    np.testing.assert_allclose(tworld.freqt(want["mcep"], 60, -0.3), jworld.freqt(want["mcep"], 60, -0.3), **F64)
    np.testing.assert_allclose(tworld.spc2npow(want["sp"]), jworld.spc2npow(want["sp"]), **F64)
    np.testing.assert_array_equal(tworld.extfrm(want["mcep"], want["npow"]), jworld.extfrm(want["mcep"], want["npow"]))
    # full-order sp2mc then mc2sp is the identity on a smooth spectrum
    rng = np.random.default_rng(1)
    c = np.zeros(129)
    c[:6] = rng.normal(size=6) * 0.3
    logsp = np.fft.fft(np.concatenate([c, c[-2:0:-1]])).real[:129]
    back = tworld.mc2sp(tworld.sp2mc(np.exp(logsp)[None], order=128, alpha=0.42), 0.42, 256)
    np.testing.assert_allclose(np.log(back), logsp[None], atol=1e-12)
    np.testing.assert_allclose(back, jworld.mc2sp(jworld.sp2mc(np.exp(logsp)[None], order=128, alpha=0.42), 0.42, 256),
                               **F64)


@pytest.mark.parametrize("kind", ["float", "ties"])
def test_dtw_path_is_index_equal(kind):
    """The same aligned pairs, also on a quantised input full of equal
    costs, where the first of equal costs (diagonal, up, left) decides."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((37, 5))
    y = rng.standard_normal((29, 5))
    if kind == "ties":
        x, y = np.round(x).clip(-1, 1), np.round(y).clip(-1, 1)
    for a, b in ((x, y), (y, x), (x[:1], y), (x, x)):
        got, want = tdtw.dtw_path(a, b), jdtw.dtw_path(a, b)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_trim_silence_samples_is_equal():
    rng = np.random.default_rng(3)
    sil = np.zeros(SR // 4)
    for x in (np.concatenate([sil, _tone(1.0, 150), sil]), _tone(0.3, 220), np.zeros(100), np.zeros(0),
              np.concatenate([0.01 * rng.standard_normal(SR // 3), _tone(0.5, 180)])):
        assert tdtw.trim_silence_samples(x) == jdtw.trim_silence_samples(x)


def test_world_extract_matches_on_periodic_signals(one_thread):
    """The port's f0 on the CPU against JAX's on glottal pulses (with an
    unvoiced stretch) and a tone: the same voicing, f0 and the analysis at
    the tolerance carried from f0's (E2E)."""
    for x in (_pulses(0.8, 110, 180, seed=0), _tone(0.6, 150)):
        want = jworld.world_extract(x, SR)
        got = tworld.world_extract(x, SR, device="cpu")
        assert got["f0"].dtype == want["f0"].dtype == np.float32
        np.testing.assert_array_equal(got["f0"] > 0, want["f0"] > 0)
        np.testing.assert_allclose(got["f0"], want["f0"], rtol=1e-3)
        np.testing.assert_allclose(got["mcep"], want["mcep"], **E2E)
        np.testing.assert_allclose(got["npow"], want["npow"], **E2E)
        np.testing.assert_array_equal(tworld.world_f0(x, SR, device="cpu"), got["f0"])


@pytest.mark.parametrize("method", ["world", "dct"])
def test_calculate_mcd_f0_matches(method, one_thread):
    """MCD, F0RMSE, F0CORR and DDUR of a pulse train against a delayed,
    scaled noisy copy and a tone; given the device features computed
    beforehand, the same numbers bit for bit."""
    x = _pulses(0.5, 110, 170, seed=4)
    noisy = (0.9 * x + 0.01 * np.random.default_rng(5).standard_normal(len(x))).astype(np.float32)
    for y in (np.concatenate([np.zeros(3000, np.float32), noisy]), _tone(0.4, 140)):
        want = jdtw.calculate_mcd_f0(x, y, SR, mcep_method=method)
        got = tdtw.calculate_mcd_f0(x, y, SR, mcep_method=method, device="cpu")
        assert set(got) == set(want) == set(tcli.METRIC_KEYS)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **E2E)
        pre = [tdtw.device_features(s, SR, 40.0, 800.0, method, "cpu") for s in (x, y)]
        assert tdtw.calculate_mcd_f0(x, y, SR, mcep_method=method, precomputed=pre) == got
    same = tdtw.calculate_mcd_f0(x, x.copy(), SR, mcep_method=method, device="cpu")
    assert same["mcd"] == 0.0 and same["f0rmse"] == 0.0 and same["ddur"] == 0.0
    with pytest.raises(ValueError, match="mcep_method"):
        tdtw.device_features(x, SR, mcep_method="harvest", device="cpu")


def test_cer_pieces_match():
    """levenshtein and edit_counts on a seeded list of strings (kana, ASCII,
    empty), and the normalization, equal to JAX's."""
    rng = np.random.default_rng(6)
    alphabet = list("あいうえおかきabc ")
    words = ["", "abc", "kitten", "sitting"] + [
        "".join(rng.choice(alphabet, int(rng.integers(0, 12)))) for _ in range(24)
    ]
    for a, b in zip(words, words[1:] + words[:1]):
        assert tcli.levenshtein(a, b) == jcli.levenshtein(a, b)
        assert tcli.edit_counts(a, b) == jcli.edit_counts(a, b)
        assert tcli.edit_counts(a.split(), b.split()) == jcli.edit_counts(a.split(), b.split())
    for s in ("Hello, World!", "あ。い、う", "ＡＢＣ！", ""):
        assert tcli.normalize_sentence(s) == jcli.normalize_sentence(s)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 utterances: references (pulse trains, a tone) and generated wavs
    (shifted, scaled, trimmed copies), two speakers with an f0 yaml."""
    root = tmp_path_factory.mktemp("eval")
    rows = []
    for i in range(4):
        # one length for the references and one for the generated wavs: the
        # JAX CLI compiles its f0 estimator once a length
        ref = _pulses(0.3, 100 + 15 * i, 160, seed=10 + i) if i != 3 else _tone(0.3, 130)
        gen = np.concatenate([np.zeros(300 * i, np.float32), 0.8 * ref[: 7000 - 300 * i]])
        ref_path = str(root / "ref" / f"u{i}.wav")
        write_audio(ref_path, ref, SR)
        write_audio(str(root / "gen" / f"u{i}.wav"), gen, SR)
        rows.append({"sample_id": f"u{i}", "spk": f"s{i % 2}", "wav_path": ref_path, "original_text": "x",
                     "phonemes": "a"})
    csv_path = str(root / "test.csv")
    write_csv(rows, csv_path)
    conf = str(root / "conf.yaml")
    with open(conf, "w") as f:
        yaml.dump({"sampling_rate": SR}, f)
    f0_conf = str(root / "f0.yaml")
    with open(f0_conf, "w") as f:
        yaml.dump({"s1": {"f0min": 60, "f0max": 400}}, f)
    return {"root": root, "csv": csv_path, "conf": conf, "f0": f0_conf}


def _args(corpus, out, *extra):
    return ["--csv", corpus["csv"], "--wavdir", str(corpus["root"] / "gen"), "--config", corpus["conf"],
            "--f0-config", corpus["f0"], "--out", out, "--verbose", "0", *extra]


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_evaluate_cli_matches_jax_and_is_the_same_across_n_jobs(corpus, monkeypatch, capsys, one_thread):
    """The port's CLI (--device cpu) against jatts_tpu.bin.evaluate.main,
    both in-process at --n-jobs 1: the same rows and table, each metric at
    E2E; then --n-jobs 2 (spawned workers) gives the same results.csv bit
    for bit."""
    want_csv, one_csv, two_csv = (str(corpus["root"] / n) for n in ("jax.csv", "one.csv", "two.csv"))
    monkeypatch.setattr(sys, "argv", ["evaluate"] + _args(corpus, want_csv, "--n-jobs", "1"))
    jcli.main()
    jax_out = capsys.readouterr().out
    out = tcli.main(_args(corpus, one_csv, "--n-jobs", "1", "--device", "cpu"))
    port_out = capsys.readouterr().out
    assert [ln.split()[0] for ln in port_out.splitlines()] == [ln.split()[0] for ln in jax_out.splitlines()]
    want, got = _read(want_csv), _read(one_csv)
    assert [r["utt_id"] for r in got] == [r["utt_id"] for r in want] == ["u0", "u1", "u2", "u3"]
    for g, w in zip(got, want):
        for k in tcli.METRIC_KEYS:
            np.testing.assert_allclose(float(g[k]), float(w[k]), **E2E, err_msg=f"{g['utt_id']} {k}")
    assert out["device_s"] > 0 and out["host_s"] > 0 and set(out["means"]) == set(tcli.METRIC_KEYS)
    tcli.main(_args(corpus, two_csv, "--n-jobs", "2", "--device", "cpu"))
    with open(one_csv, "rb") as a, open(two_csv, "rb") as b:
        assert a.read() == b.read()


def test_evaluate_cli_scores_the_corpus_against_itself_and_needs_a_device(corpus, tmp_path, monkeypatch):
    """References scored against themselves: MCD 0, F0RMSE 0, F0CORR 1,
    DDUR 0; the gated metrics skip, not fail, without their packages or
    weights (nothing is fetched: the ASR packages are hidden, SHEET is
    pointed at an empty local hub directory); without a card and without
    --device cpu the CLI fails loudly."""
    for name in ("nue_asr", "transformers", "speechbrain", "speechbrain.pretrained"):
        monkeypatch.setitem(sys.modules, name, None)
    out = str(tmp_path / "self.csv")
    args = ["--csv", corpus["csv"], "--wavdir", str(corpus["root"] / "ref"), "--config", corpus["conf"]]
    res = tcli.main(args + ["--metrics", "mcd", "spkemb", "asr", "sheet", "--sheet-source", str(tmp_path / "hub"),
                            "--n-jobs", "1", "--device", "cpu", "--out", out, "--verbose", "0"])
    assert res["spkemb"] is None  # no --spkemb-model and no speechbrain
    rows = _read(out)
    assert len(rows) == 4
    for r in rows:
        assert float(r["mcd"]) == 0.0 and float(r["f0rmse"]) == 0.0 and float(r["ddur"]) == 0.0
        assert abs(float(r["f0corr"]) - 1.0) <= 1e-5
    assert tcli._load_asr(type("A", (), {"asr_path": None})()) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(args)
