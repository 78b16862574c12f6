"""Stage 0 of the recipes in jatts_torch (``jatts_torch/egs``) and the
recipe runner (``jatts_torch/bin/run_recipe.py``) against the JAX
package's scripts on the CPU.

Each of the seven data preps and ``prepare_f0_range`` runs beside its
``egs/<corpus>/<tts>/local`` script, which runs in a subprocess (all of them
at once), on the same synthetic corpus of its layout (the corpus makers of
``tests/test_recipe_hfc.py`` and ``tests/test_jvs_data_prep.py``, copied
here, and a JSUT tree in the same manner): the csvs and the f0 yaml must be
equal byte for byte. (No script writes trimmed wavs: the trims are the
start/end columns, compared in the csvs.) Transcripts are kana, which
``g2p_phonemes`` reads without pyopenjtalk. The runner's ``jsut/tts1``
stages 0-2 are held against the JAX data prep and CLIs (csvs, ``.h5``
dumps, statistics, tokens, as ``tests/test_torch_recipe_cli.py`` holds
them), and each runner table's variables, stage numbers and calls against
the text of its script.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from jatts_tpu.utils.io import list_hdf5, read_hdf5  # noqa: E402
from jatts_torch.bin import run_recipe  # noqa: E402
from jatts_torch.utils.io import read_csv, write_audio, write_csv  # noqa: E402
from tests.test_f0_accuracy import synth_speechlike  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR24, SR48, HOP48 = 24000, 48000, 512
KANA = ["ありがとう", "こんにちは", "さようなら", "おはよう", "すみません"]


# ---------------------------------------------------------------------------
# the corpora
# ---------------------------------------------------------------------------


def _tone(n, sr, f0, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    wav = 0.3 * np.sin(2 * np.pi * f0 * t + 0.3 * np.sin(2 * np.pi * 5 * t))
    k = n // 10  # leading and trailing near-silence
    wav[:k] = 0.001 * rng.standard_normal(k)
    wav[n - k:] = 0.001 * rng.standard_normal(k)
    return wav.astype(np.float32)


def _lab(path, dur_s, phones, seed):
    """A Julius segmentation: silB, ``phones`` between 0.1 s and dur - 0.1 s, silE."""
    rng = np.random.default_rng(seed)
    a, b = 0.1, dur_s - 0.1
    cuts = [a, *np.sort(rng.uniform(a + 0.05, b - 0.05, len(phones) - 1)), b]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"0.0000 {a:.4f} silB\n")
        for p, s, e in zip(phones, cuts[:-1], cuts[1:]):
            f.write(f"{s:.4f} {e:.4f} {p}\n")
        f.write(f"{b:.4f} {dur_s:.4f} silE\n")


def make_jsut_corpus(root, labdir=None, n=6):
    """``basic5000/transcript_utf8.txt`` (kana) and ``basic5000/wav`` of
    speech-like signals (``tests/test_f0_accuracy.py:synth_speechlike``)
    with quiet ends; one transcript line has no wav, one wav no ``.lab``."""
    wavdir = os.path.join(root, "basic5000", "wav")
    os.makedirs(wavdir, exist_ok=True)
    rng = np.random.default_rng(1)
    with open(os.path.join(root, "basic5000", "transcript_utf8.txt"), "w", encoding="utf-8") as f:
        for i in range(n + 1):
            utt = f"BASIC5000_{i + 1:04d}"
            f.write(f"{utt}:{KANA[i % len(KANA)]}\n")
            if i == n:
                continue  # a transcript line without its wav
            dur = float(rng.uniform(0.6, 1.0))
            # a glottal pulse train through formants (broadband: no near-empty mel bin inside the crop)
            wav = synth_speechlike(np.linspace(110.0 + 10 * i, 160.0, int(dur * SR24)), seed=i)
            k = int(0.08 * SR24)
            wav[:k] *= 0.01
            wav[-k:] *= 0.01
            write_audio(os.path.join(wavdir, f"{utt}.wav"), wav, SR24)
            if labdir is not None and i != 1:  # one utterance without its .lab
                _lab(os.path.join(labdir, f"{utt}.lab"), dur, ["a", "r", "i"], i)


def make_jvs_corpus(root, labdir=None, n_spk=2, n_utt=9):
    for s in range(n_spk):
        spk = f"jvs{s + 1:03d}"
        d = os.path.join(root, spk, "parallel100")
        os.makedirs(os.path.join(d, "wav24kHz16bit"), exist_ok=True)
        with open(os.path.join(d, "transcripts_utf8.txt"), "w", encoding="utf-8") as f:
            for u in range(n_utt):
                utt = f"VOICEACTRESS100_{u + 1:03d}"
                f.write(f"{utt}:{KANA[(u + s) % len(KANA)]}\n")
                write_audio(os.path.join(d, "wav24kHz16bit", f"{utt}.wav"),
                            _tone(SR24 // 2, SR24, 120 + 40 * s + 3 * u, u), SR24)
                if labdir is not None:
                    _lab(os.path.join(labdir, f"{spk}_{utt}.lab"), 0.5, ["k", "o"], u)
    os.makedirs(os.path.join(root, "README_dir"), exist_ok=True)  # a directory that is no speaker


def make_hfc_corpus(root, labdir=None):
    os.makedirs(os.path.join(root, "text"), exist_ok=True)
    rng = np.random.default_rng(0)
    sets = {"train_parallel": 3, "train_non_parallel": 2, "dev": 1, "eval": 2}
    k = 0
    lines = []
    for _set, n in sets.items():
        wavdir = os.path.join(root, "wav", _set)
        os.makedirs(wavdir, exist_ok=True)
        with open(os.path.join(root, "text", f"{_set}.txt"), "w", encoding="utf-8") as f:
            for _ in range(n):
                utt = f"UTT_{k:04d}"
                dur = float(rng.uniform(0.8, 1.4))
                write_audio(os.path.join(wavdir, f"{utt}.wav"), _tone(int(dur * SR48), SR48, 150 + 7 * k, k), SR48)
                f.write(f"{utt} {KANA[k % len(KANA)]}\n")
                lines.append(f"{utt}:{KANA[k % len(KANA)]}")
                if labdir is not None:
                    _lab(os.path.join(labdir, f"{utt}.lab"), dur, ["a", "r", "i"], k)
                k += 1
    transcript = os.path.join(root, "transcript.txt")
    with open(transcript, "w", encoding="utf-8") as f:
        f.write("\n".join(lines + ["MISSING_0001:ありがとう", "no colon here"]) + "\n")
    return transcript


def make_f0_csv(root):
    """Two speakers, tones with vibrato around 120 and 230 Hz."""
    rows = []
    for s, f0 in enumerate((120.0, 230.0)):
        for u in range(3):
            path = os.path.join(root, "f0wav", f"s{s}_{u}.wav")
            write_audio(path, _tone(SR24 // 2, SR24, f0 + 5 * u, u), SR24)
            rows.append({"sample_id": f"s{s}_{u}", "spk": f"spk{s}", "wav_path": path})
    csv = os.path.join(root, "f0.csv")
    write_csv(rows, csv)
    return csv


# the seven data preps: (name, egs script, port module, corpus, flags)
PREPS = {
    "jsut_tts1": ("jsut/tts1", "jsut", ["--n-dev", "2", "--n-test", "1", "--labdir", "{jsut_lab}"]),
    "jsut_tts2": ("jsut/tts2", "jsut", ["--n-dev", "1", "--n-test", "2"]),
    "jvs_tts1": ("jvs/tts1", "jvs", ["--labdir", "{jvs_lab}", "--dev-per-spk", "2", "--test-per-spk", "2"]),
    "jvs_tts2": ("jvs/tts2", "jvs", []),
    "hfc_tts1": ("hificaptain_jp_female/tts1", "hfc", ["--labdir", "{hfc_lab}", "--hop-size", "512", "--fs", "48000"]),
    "hfc_tts2": ("hificaptain_jp_female/tts2", "hfc", ["--sampling-rate", "48000", "--seed", "3"]),
    "hfc_tts3": ("hificaptain_jp_female/tts3", "hfc", ["--transcript", "{transcript}", "--n-dev", "2", "--n-test",
                                                       "2", "--seed", "5"]),
}


def _argv(name, paths):
    recipe, corpus, flags = PREPS[name]
    return ["--db-root", paths[corpus], *[f.format(**paths) for f in flags]]


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """The corpora, and every egs script's outputs: the scripts run at once,
    each in its own interpreter (JAX on the CPU)."""
    root = str(tmp_path_factory.mktemp("prep"))
    paths = {"root": root, "jsut": os.path.join(root, "jsut"), "jvs": os.path.join(root, "jvs_ver1"),
             "hfc": os.path.join(root, "hfc"), "jsut_lab": os.path.join(root, "jsut_lab"),
             "jvs_lab": os.path.join(root, "jvs_lab"), "hfc_lab": os.path.join(root, "hfc_lab")}
    make_jsut_corpus(paths["jsut"], paths["jsut_lab"])
    make_jvs_corpus(paths["jvs"], paths["jvs_lab"])
    paths["transcript"] = make_hfc_corpus(paths["hfc"], paths["hfc_lab"])
    paths["f0_csv"] = make_f0_csv(root)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    for name in PREPS:
        script = os.path.join(REPO, "egs", PREPS[name][0], "local", "data_prep.py")
        out = os.path.join(root, "jax", name)
        procs.append(subprocess.Popen([sys.executable, script, *_argv(name, paths), "--outdir", out], cwd=REPO,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    script = os.path.join(REPO, "egs", "jvs", "tts1", "local", "prepare_f0_range.py")
    procs.append(subprocess.Popen([sys.executable, script, "--csv", paths["f0_csv"], "--out",
                                   os.path.join(root, "jax", "f0.yaml"), "--n-per-spk", "2"], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths["stdout"] = {}
    for name, p in zip(list(PREPS) + ["f0"], procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        paths["stdout"][name] = out
    return paths


def _same_files(got_dir, want_dir, names):
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as g, open(os.path.join(want_dir, name), "rb") as w:
            assert g.read() == w.read(), name


@pytest.mark.parametrize("name", list(PREPS))
def test_data_prep_writes_the_egs_script_s_csvs(name, jax_outputs, capsys):
    import importlib

    paths = jax_outputs
    mod = importlib.import_module(f"jatts_torch.egs.{PREPS[name][0].replace('/', '.')}.local.data_prep")
    out = os.path.join(paths["root"], "port", name)
    mod.main(_argv(name, paths) + ["--outdir", out])
    printed = capsys.readouterr().out
    assert printed.strip() == paths["stdout"][name].strip().splitlines()[-1]
    _same_files(out, os.path.join(paths["root"], "jax", name), ["train.csv", "dev.csv", "test.csv"])
    rows, fields = read_csv(os.path.join(out, "train.csv"), dict_reader=True)
    assert rows and all(r["phonemes"] for r in rows)
    if name in ("jsut_tts1", "jvs_tts1", "hfc_tts1"):  # the Julius durations reached the rows
        assert "durations" in fields and any(r["durations"] for r in rows)
    if name in ("jsut_tts2", "hfc_tts2"):
        assert all(0.0 <= float(r["start"]) < float(r["end"]) for r in rows)
    if name in ("hfc_tts2", "hfc_tts3"):  # the prompts drawn by the seeded generator
        test_rows, _ = read_csv(os.path.join(out, "test.csv"), dict_reader=True)
        assert all(r["prompt_wav_path"] for r in test_rows)


def test_prepare_f0_range_writes_the_egs_script_s_yaml(jax_outputs, capsys):
    from jatts_torch.egs.jvs.tts1.local import prepare_f0_range

    paths = jax_outputs
    out = os.path.join(paths["root"], "port", "f0.yaml")
    ranges = prepare_f0_range.main(["--csv", paths["f0_csv"], "--out", out, "--n-per-spk", "2", "--device", "cpu"])
    _same_files(os.path.dirname(out), os.path.join(paths["root"], "jax"), ["f0.yaml"])
    assert capsys.readouterr().out.strip() == paths["stdout"]["f0"].strip()
    for spk, f0 in (("spk0", 120), ("spk1", 230)):
        assert 40 <= ranges[spk]["f0min"] < f0 < ranges[spk]["f0max"] <= 800


def test_prepare_f0_range_defaults_to_the_card():
    from jatts_torch.egs.jvs.tts1.local import prepare_f0_range

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_f0_range.main(["--csv", "data/train.csv"])


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

CONFIG = {
    "sampling_rate": SR24, "fft_size": 1024, "hop_size": 300, "win_length": None, "num_mels": 20, "fmin": 80,
    "fmax": 7600, "global_gain_scale": 1.0, "feat_list": ["mel", "pitch", "energy"],
    "pitch_extract_f0min": 40, "pitch_extract_f0max": 400,
}


def _jax_cli(main_fn, argv):
    old = sys.argv
    sys.argv = ["cli", *argv]
    try:
        main_fn()
    finally:
        sys.argv = old


def test_runner_jsut_tts1_stages_0_to_2_match_the_jax_scripts(jax_outputs, tmp_path):
    """Stage 0 with ``--labdir`` (no aligner), then stages 1-2 with a small
    feature conf in the working directory: the stage-0 csvs are the egs
    script's byte for byte; the stage-1 csvs, ``.h5`` dumps, statistics and
    token list match the JAX CLIs' run on the same csvs (mel atol 5e-5,
    log-f0 1e-3 with the same voicing, energy rtol 1e-4, statistics rtol
    1e-5, tokens exact)."""
    from jatts_tpu.bin.compute_statistics import main as jstats
    from jatts_tpu.bin.generate_token_list import main as jtokens
    from jatts_tpu.bin.preprocess import main as jpre

    paths = jax_outputs
    work = tmp_path / "work"
    (work / "conf").mkdir(parents=True)
    with open(work / "conf" / "small.yaml", "w") as f:
        yaml.dump(CONFIG, f)
    shutil.copy(os.path.join(REPO, "egs", "jsut", "tts1", "conf", "f0.yaml"), work / "conf" / "f0.yaml")
    common = {"db_root": paths["jsut"], "labdir": paths["jsut_lab"], "n_dev": "2", "n_test": "1",
              "conf": "conf/small.yaml", "device": "cpu"}
    done = run_recipe.run("jsut/tts1", {**common, "stage": "0", "stop_stage": "0"}, str(work))
    assert [d["module"].rsplit(".", 1)[-1] for d in done] == ["data_prep"]
    _same_files(str(work / "data"), os.path.join(paths["root"], "jax", "jsut_tts1"),
                ["train.csv", "dev.csv", "test.csv"])

    jax_dir = tmp_path / "jax"
    shutil.copytree(work / "data", jax_dir / "data")
    shutil.copytree(work / "conf", jax_dir / "conf")
    done = run_recipe.run("jsut/tts1", {**common, "stage": "1", "stop_stage": "2"}, str(work))
    assert [d["module"].rsplit(".", 1)[-1] for d in done] == ["preprocess"] * 3 + [
        "compute_statistics", "generate_token_list"]
    assert done[0]["argv"][-2:] == ["--device", "cpu"] and "--device" not in done[3]["argv"]
    cwd = os.getcwd()
    os.chdir(jax_dir)
    try:
        for split in ("train", "dev", "test"):
            _jax_cli(jpre, ["--csv", f"data/{split}.csv", "--config", "conf/small.yaml", "--dumpdir",
                            f"dump/{split}", "--f0-config", "conf/f0.yaml", "--verbose", "0"])
        _jax_cli(jstats, ["--csv", "data/train.csv", "--config", "conf/small.yaml", "--out", "dump/stats.h5",
                          "--verbose", "0"])
        _jax_cli(jtokens, ["--csv", "data/train.csv", "data/dev.csv", "--out", "dump/tokens.txt"])
    finally:
        os.chdir(cwd)
    for split in ("train", "dev", "test"):
        got, gf = read_csv(str(work / "data" / f"{split}.csv"), dict_reader=True)
        want, wf = read_csv(str(jax_dir / "data" / f"{split}.csv"), dict_reader=True)
        assert gf == wf and gf[-1] == "feat_path" and len(got) == len(want)
        for g, w in zip(got, want):
            assert {k: v for k, v in g.items() if k != "feat_path"} == {k: v for k, v in w.items() if k != "feat_path"}
            assert g["feat_path"] == f"dump/{split}/{g['sample_id']}.h5"
            tp, jp = str(work / g["feat_path"]), str(jax_dir / w["feat_path"])
            assert sorted(list_hdf5(tp)) == sorted(list_hdf5(jp)) == ["energy", "mel", "pitch", "wave"]
            np.testing.assert_array_equal(read_hdf5(tp, "wave"), read_hdf5(jp, "wave"))
            np.testing.assert_allclose(read_hdf5(tp, "mel"), read_hdf5(jp, "mel"), rtol=0, atol=5e-5)
            pitch, jpitch = read_hdf5(tp, "pitch"), read_hdf5(jp, "pitch")
            np.testing.assert_array_equal(pitch > 0, jpitch > 0)
            np.testing.assert_allclose(pitch, jpitch, rtol=0, atol=1e-3)
            np.testing.assert_allclose(read_hdf5(tp, "energy"), read_hdf5(jp, "energy"), rtol=1e-4, atol=1e-5)
            if g.get("durations"):
                assert read_hdf5(tp, "mel").shape[0] == sum(int(d) for d in g["durations"].split())
    for key in list_hdf5(str(jax_dir / "dump" / "stats.h5")):
        np.testing.assert_allclose(read_hdf5(str(work / "dump" / "stats.h5"), key),
                                   read_hdf5(str(jax_dir / "dump" / "stats.h5"), key), rtol=1e-5, atol=0)
    _same_files(str(work / "dump"), str(jax_dir / "dump"), ["tokens.txt"])


def test_runner_refuses_unknown_options_and_recipes():
    with pytest.raises(ValueError, match="invalid option --n_jobz"):
        run_recipe.variables("jsut/tts1/run.sh", {"n-jobz": "3"})
    with pytest.raises(ValueError, match="no recipe"):
        run_recipe.script_key("jsut/tts9")
    v = run_recipe.variables("jsut/tts1/run.sh", {"conf": "conf/x.v2.yaml", "tag": "t", "dump-format": "npz"})
    assert v["expdir"] == "exp/x.v2_t"
    assert run_recipe.parse(["jsut/tts1", "--stage", "0", "--workdir", "w", "--db-root", "d"]) == (
        "jsut/tts1", {"stage": "0", "db-root": "d"}, "w")
    stages = dict(run_recipe.plan("jsut/tts1/run.sh", dict(v, stage="-1", stop_stage="6")))
    assert stages[-1] == ["Stage -1: Download JSUT corpus to downloads/jsut (manual; zero-egress images skip this)"]
    assert ("--dump-format", "npz") == tuple(stages[1][1][1][-2:]) and stages[6][1][1][-1].endswith("serving.npz")


def _script_table(path):
    """A run script's variables (name -> default, as the shell reads them)
    and, per stage, the programs its block calls (``${BIN}/x.py``,
    ``local/x.py``)."""
    with open(path) as f:
        text = f.read()
    head = text[: text.index(". ../../../utils/parse_options.sh")]
    defaults = {}
    for line in head.splitlines():
        m = re.match(r"^(\w+)=(\S*)", line)
        if m and m.group(1) != "set":
            defaults[m.group(1)] = m.group(2).strip('"')
    blocks = re.findall(r'^if \[ "\$\{stage\}" -le (-?\d+) \].*?\n(.*?)^fi$', text, re.S | re.M)
    calls = {int(n): sorted(set(re.findall(r"(?:\$\{BIN\}|local)/(\w+)\.py", body))) for n, body in blocks}
    return defaults, calls


SCRIPTS = sorted(run_recipe.RECIPES)


@pytest.mark.parametrize("key", SCRIPTS)
def test_runner_table_is_its_script(key):
    """The variables in the script's order with its defaults (stage 6's
    platforms ``cuda,cpu`` for ``tpu,cpu``), its stage numbers, and each
    stage's programs (stage 0's aligner as the script calls it without
    ``labdir``)."""
    defaults, calls = _script_table(os.path.join(REPO, "egs", key))
    table = run_recipe.RECIPES[key]["defaults"]
    want = {k: ("cuda,cpu" if k == "serving_platforms" else d) for k, d in defaults.items()}
    assert list(table) == list(want) and table == want
    v = run_recipe.variables(key, {"stage": "-1", "stop_stage": "6"})
    plan = dict(run_recipe.plan(key, v))
    assert sorted(plan) == sorted(calls)
    for n, steps in plan.items():
        got = sorted({s[0].rsplit(".", 1)[-1] for s in steps if not isinstance(s, str)})
        assert got == calls[n], (n, got, calls[n])
