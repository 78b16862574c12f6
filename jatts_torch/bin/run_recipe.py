"""The recipes' stage runner (counterpart of the eight ``egs/<corpus>/<tts>/run.sh``
and ``run_e2tts.sh`` scripts).

One table per script holds what the script holds: its variables with their
defaults, and for each of its stages the calls it makes, here to the port's
stage-0 modules (``jatts_torch/egs``) and CLIs (``jatts_torch/bin``) in this
process. The stages run from ``--stage`` to ``--stop_stage`` (the script's
defaults), in a working directory (``--workdir``, default ``.``) that takes
``data/``, ``dump/`` and ``exp/`` as the script's own directory does. A
relative conf path (``conf/...``) that is not under the working directory is
read, read-only, from ``egs/<corpus>/<tts>/`` of this repository:

    python -m jatts_torch.bin.run_recipe jsut/tts1 --stage 0 --stop_stage 4 \\
        --db_root downloads/jsut --labdir lab --n_dev 250 --device cuda

Any ``--<variable> <value>`` of the script overrides it, with ``-`` or ``_``
in the name (the scripts' ``utils/parse_options.sh``); an unknown one is an
error. Three options are the port's own: ``--device`` (default: the CUDA
card) goes to every call that computes on a device; ``--dump_format``
``h5`` (the default, the script's) or ``npz`` (a machine without h5py: the
dumps and the statistics as ``.npz``); ``--workdir``. Stage 6 exports for
``cuda,cpu`` where the JAX script says ``tpu,cpu``. Stage -1 prints the
script's message and downloads nothing.
"""

from __future__ import annotations

import importlib
import logging
import os
import shlex
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

REPO = Path(__file__).resolve().parents[2]
EGS = REPO / "egs"
BIN = "jatts_torch.bin"
# the port's own variables, beside the scripts'
PORT_DEFAULTS = {"device": "", "dump_format": "h5"}
# CLIs that take --device (the others compute on the host)
ON_DEVICE = {"preprocess", "align", "tts_train", "tts_decode", "evaluate", "export_serving", "e2tts_decode",
             "ttslm_decode"}

Call = Tuple[str, List[str]]  # (module, argv)


def _stem(path: str) -> str:
    """``$(basename "${path%.*}")``."""
    return os.path.basename(os.path.splitext(path)[0])


def _expname(conf: str, tag: str) -> str:
    return _stem(conf) + (f"_{tag}" if tag else "")


def _csvs(v) -> List[str]:
    return [v["train_csv"], v["dev_csv"], v["test_csv"]]


def _stats(v) -> str:
    return f"{v['dumpdir']}/stats.{'npz' if v['dump_format'] == 'npz' else 'h5'}"


def _local(v, script: str) -> str:
    return f"jatts_torch.egs.{v['_recipe'].replace('/', '.')}.local.{script}"


def _opt(flag: str, value: str) -> List[str]:
    """``${value:+flag "${value}"}``."""
    return [flag, value] if value else []


def _preprocess(v, conf: str, f0: bool) -> List[Call]:
    fmt = ["--dump-format", "npz"] if v["dump_format"] == "npz" else []
    return [(f"{BIN}.preprocess", ["--csv", csv, "--config", conf, "--dumpdir", f"{v['dumpdir']}/{_stem(csv)}",
                                   *(["--f0-config", "conf/f0.yaml"] if f0 else []), *fmt]) for csv in _csvs(v)]


def _statistics(v, conf: str) -> Call:
    return f"{BIN}.compute_statistics", ["--csv", v["train_csv"], "--config", conf, "--out", _stats(v)]


def _tokens(v) -> Call:
    return f"{BIN}.generate_token_list", ["--csv", v["train_csv"], v["dev_csv"], "--out",
                                          f"{v['dumpdir']}/tokens.txt"]


def _train(v, conf: str, outdir: str, multihost: bool = False) -> Call:
    return f"{BIN}.tts_train", ["--train-csv", v["train_csv"], "--dev-csv", v["dev_csv"], "--stats", _stats(v),
                                "--token-list", f"{v['dumpdir']}/tokens.txt", "--config", conf, "--outdir", outdir,
                                *(["--multihost"] if multihost else [])]


def _align(v) -> Call:
    return f"{BIN}.align", ["--csv", *_csvs(v), "--config", v["conf"], "--outdir", "exp/aligner", "--steps",
                            v["align_steps"]]


def _evaluate(v, f0: bool = True, n_jobs: bool = True) -> Call:
    expdir = v["expdir"]
    return f"{BIN}.evaluate", ["--csv", v["test_csv"], "--wavdir", f"{expdir}/results/wav", "--config", v["conf"],
                               *(["--f0-config", "conf/f0.yaml"] if f0 else []),
                               *(["--n-jobs", v["n_jobs"]] if n_jobs else []),
                               "--out", f"{expdir}/results/eval.csv"]


def _decode(v, vocoder: bool) -> Call:
    expdir = v["expdir"]
    return f"{BIN}.tts_decode", ["--csv", v["test_csv"], "--stats", _stats(v), "--token-list",
                                 f"{v['dumpdir']}/tokens.txt", "--expdir", expdir, "--config",
                                 f"{expdir}/config.yml", "--outdir", f"{expdir}/results",
                                 *(["--vocoder", v["vocoder"]] if vocoder else [])]


def _download(corpus: str) -> Callable:
    return lambda v: [f"Stage -1: Download {corpus} to {v['db_root']} (manual; zero-egress images skip this)"]


def _mel_stages(f0_eval: bool, vocoder: bool) -> Dict[int, Callable]:
    """Stages 1-5 of the mel recipes (tts1 and tts2 of JSUT, JVS and
    Hi-Fi-Captain)."""
    return {
        1: lambda v: ["Stage 1: Feature extraction + statistics", *_preprocess(v, v["conf"], True),
                      _statistics(v, v["conf"])],
        2: lambda v: ["Stage 2: Token list", _tokens(v)],
        3: lambda v: [f"Stage 3: Training -> {v['expdir']}", _train(v, v["conf"], v["expdir"])],
        4: lambda v: ["Stage 4: Decoding", _decode(v, vocoder)],
        5: lambda v: ["Stage 5: Objective evaluation", _evaluate(v, f0_eval)],
    }


def _prep_then_align(prep: Callable) -> Callable:
    """Stage 0 of the tts1 recipes: the data prep, then the native aligner
    when no ``labdir`` is given."""
    def stage(v):
        out = ["Stage 0: Data preparation", prep(v)]
        if not v["labdir"]:
            out += ["Stage 0b: Native forced alignment (no --labdir given)", _align(v)]
        return out
    return stage


def _export(v) -> List:
    expdir = v["expdir"]
    return [f"Stage 6: AOT serving export -> {expdir}/serving.npz",
            (f"{BIN}.export_serving", ["--config", f"{expdir}/config.yml", "--stats", _stats(v), "--token-list",
                                       f"{v['dumpdir']}/tokens.txt", "--expdir", expdir, "--text-buckets",
                                       v["serving_buckets"], "--platforms", v["serving_platforms"], "--out",
                                       f"{expdir}/serving.npz"])]


def _e2_stages() -> Dict[int, Callable]:
    def train(v):
        return [_train(v, v["conf"], v["expdir"], v["multihost"] == "true")]

    def decode(v):
        e = v["expdir"]
        return [(f"{BIN}.e2tts_decode", ["--csv", v["test_csv"], "--stats", _stats(v), "--token-list",
                                         f"{v['dumpdir']}/tokens.txt", "--expdir", e, "--config", f"{e}/config.yml",
                                         "--vocoder", v["vocoder"], "--max-frames", v["decode_max_frames"],
                                         "--outdir", f"{e}/results"])]

    return {
        0: lambda v: [(_local(v, "data_prep"), ["--db-root", v["db_root"], "--outdir", "data", "--sampling-rate",
                                                v["fs"]])],
        1: lambda v: [*_preprocess(v, v["conf"], False), _statistics(v, v["conf"])],
        2: lambda v: [_tokens(v)],
        3: train,
        4: decode,
        5: lambda v: [_evaluate(v, f0=False, n_jobs=False)],
    }


def _valle_stages() -> Dict[int, Callable]:
    def decode(v):
        return ["Stage 5: Two-stage decoding", (f"{BIN}.ttslm_decode", [
            "--csv", v["test_csv"], "--token-list", f"{v['dumpdir']}/tokens.txt", "--ar-expdir", v["ar_exp"],
            "--ar-config", f"{v['ar_exp']}/config.yml", "--nar-expdir", v["nar_exp"], "--nar-config",
            f"{v['nar_exp']}/config.yml", *_opt("--codec-path", v["codec_path"]), "--max-steps",
            v["decode_max_steps"], "--outdir", f"{v['ar_exp']}/results"])]

    return {
        0: lambda v: ["Stage 0: Data preparation (random train-utterance prompts)",
                      (_local(v, "data_prep"), ["--db-root", v["db_root"], "--transcript", v["transcript"],
                                                "--outdir", "data", "--n-dev", v["n_dev"], "--n-test", v["n_test"]])],
        1: lambda v: ["Stage 1: EnCodec feature extraction", *_preprocess(v, v["ar_conf"], False)],
        2: lambda v: ["Stage 2: Token list", _tokens(v)],
        3: lambda v: [f"Stage 3: AR training -> {v['ar_exp']}", _train(v, v["ar_conf"], v["ar_exp"])],
        4: lambda v: [f"Stage 4: NAR training -> {v['nar_exp']}", _train(v, v["nar_conf"], v["nar_exp"])],
        5: decode,
    }


_CSV = {"train_csv": "data/train.csv", "dev_csv": "data/dev.csv", "test_csv": "data/test.csv", "dumpdir": "dump"}

# each script's variables (its defaults, in its order) and stages
RECIPES: Dict[str, Dict] = {
    "jsut/tts1/run.sh": {
        "defaults": {"stage": "1", "stop_stage": "5", "conf": "conf/fastspeech2.v1.yaml", "tag": "",
                     "db_root": "downloads/jsut", "labdir": "", "align_steps": "2000", **_CSV, "n_jobs": "8",
                     "n_dev": "250", "n_test": "250", "vocoder": "auto", "serving_buckets": "32,64,128",
                     "serving_platforms": "cuda,cpu"},
        "stages": {
            -1: _download("JSUT corpus"),
            0: _prep_then_align(lambda v: (_local(v, "data_prep"), [
                "--db-root", v["db_root"], "--outdir", "data", "--n-dev", v["n_dev"], "--n-test", v["n_test"],
                *_opt("--labdir", v["labdir"])])),
            **_mel_stages(True, True),
            6: _export,
        },
    },
    "jsut/tts2/run.sh": {
        "defaults": {"stage": "1", "stop_stage": "5", "conf": "conf/matcha_tts.mas.v1.yaml", "tag": "",
                     "db_root": "downloads/jsut", "n_dev": "250", "n_test": "250", "vocoder": "auto", **_CSV,
                     "n_jobs": "8"},
        "stages": {
            -1: _download("JSUT corpus"),
            0: lambda v: ["Stage 0: Data preparation", (_local(v, "data_prep"), [
                "--db-root", v["db_root"], "--outdir", "data", "--n-dev", v["n_dev"], "--n-test", v["n_test"]])],
            **_mel_stages(True, True),
        },
    },
    "jvs/tts1/run.sh": {
        "defaults": {"stage": "1", "stop_stage": "5", "conf": "conf/fastspeech2.v1.yaml", "tag": "",
                     "db_root": "downloads/jvs_ver1", "labdir": "", "align_steps": "2000", "dev_per_spk": "3",
                     "test_per_spk": "3", "vocoder": "auto", **_CSV, "n_jobs": "8"},
        "stages": {
            -1: _download("JVS corpus"),
            0: _prep_then_align(lambda v: (_local(v, "data_prep"), [
                "--db-root", v["db_root"], "--outdir", "data", *_opt("--labdir", v["labdir"]), "--dev-per-spk",
                v["dev_per_spk"], "--test-per-spk", v["test_per_spk"]])),
            **_mel_stages(True, True),
        },
    },
    "jvs/tts2/run.sh": {
        "defaults": {"stage": "1", "stop_stage": "5", "conf": "conf/matcha_tts.mas.v1.yaml", "tag": "",
                     "db_root": "downloads/jvs_ver1", **_CSV, "n_jobs": "8"},
        "stages": {
            -1: _download("JVS corpus"),
            0: lambda v: ["Stage 0: Data preparation", (_local(v, "data_prep"), [
                "--db-root", v["db_root"], "--outdir", "data"])],
            **_mel_stages(True, False),
        },
    },
    "hificaptain_jp_female/tts1/run.sh": {
        "defaults": {"stage": "1", "stop_stage": "5", "conf": "conf/fastspeech2.v1.yaml", "tag": "",
                     "db_root": "downloads/hi-fi-captain/ja-JP/female", "labdir": "", "align_steps": "2000", **_CSV,
                     "n_jobs": "8"},
        "stages": {
            -1: _download("Hi-Fi-Captain"),
            0: _prep_then_align(lambda v: (_local(v, "data_prep"), [
                "--db-root", v["db_root"], "--outdir", "data", *_opt("--labdir", v["labdir"]), "--hop-size", "512",
                "--fs", "48000"])),
            **_mel_stages(True, False),
        },
    },
    "hificaptain_jp_female/tts2/run.sh": {
        "defaults": {"stage": "1", "stop_stage": "5", "conf": "conf/matcha_tts.mas.v1.yaml", "tag": "",
                     "db_root": "downloads/hi-fi-captain/ja-JP/female", **_CSV, "n_jobs": "8"},
        "stages": {
            -1: _download("JSUT corpus"),  # the script's own message
            0: lambda v: ["Stage 0: Data preparation", (_local(v, "data_prep"), [
                "--db-root", v["db_root"], "--outdir", "data", "--sampling-rate", "48000"])],
            **_mel_stages(True, False),
        },
    },
    "hificaptain_jp_female/tts2/run_e2tts.sh": {
        "defaults": {"stage": "0", "stop_stage": "5", "conf": "conf/e2tts.v1.yaml", "tag": "",
                     "db_root": "downloads/hi-fi-captain/ja-JP/female", "fs": "48000", **_CSV, "multihost": "false",
                     "vocoder": "auto", "decode_max_frames": "3000"},
        "stages": _e2_stages(),
    },
    "hificaptain_jp_female/tts3/run.sh": {
        "defaults": {"stage": "1", "stop_stage": "5", "ar_conf": "conf/valle_ar.given.bs32.yaml",
                     "nar_conf": "conf/valle_nar.given.bs32.yaml", "tag": "",
                     "db_root": "downloads/hi-fi-captain/ja-JP/female", "transcript": "", "n_dev": "100",
                     "n_test": "100", **_CSV, "codec_path": "", "decode_max_steps": "1000"},
        "stages": _valle_stages(),
    },
}


def script_key(recipe: str) -> str:
    """``jsut/tts1`` -> ``jsut/tts1/run.sh``; a key with its script is kept."""
    key = recipe.strip("/")
    if not key.endswith(".sh"):
        key += "/run.sh"
    if key not in RECIPES:
        raise ValueError(f"no recipe {recipe!r}; the recipes are {sorted(RECIPES)}")
    return key


def variables(key: str, overrides: Dict[str, str]) -> Dict[str, str]:
    """The script's variables after ``overrides`` (parse_options.sh's rule:
    ``-`` read as ``_``, an unknown name refused), and the names it derives
    (``expname``, ``expdir``; tts3's ``ar_exp``, ``nar_exp``)."""
    v = {**RECIPES[key]["defaults"], **PORT_DEFAULTS}
    for name, value in overrides.items():
        name = name.replace("-", "_")
        if name not in v:
            raise ValueError(f"{key}: invalid option --{name}")
        v[name] = str(value)
    if v["dump_format"] not in ("h5", "npz"):
        raise ValueError(f"--dump_format {v['dump_format']!r}: h5 or npz")
    v["_recipe"] = key.rsplit("/", 1)[0]
    if "conf" in v:
        v["expname"] = _expname(v["conf"], v["tag"])
        v["expdir"] = f"exp/{v['expname']}"
    else:
        v["ar_exp"] = f"exp/{_expname(v['ar_conf'], v['tag'])}"
        v["nar_exp"] = f"exp/{_expname(v['nar_conf'], v['tag'])}"
    return v


def plan(key: str, v: Dict[str, str]) -> List[Tuple[int, List]]:
    """The stages from ``stage`` to ``stop_stage`` with what each prints
    (str) and calls ((module, argv)), the script's order."""
    lo, hi = int(v["stage"]), int(v["stop_stage"])
    return [(n, fn(v)) for n, fn in sorted(RECIPES[key]["stages"].items()) if lo <= n <= hi]


def _resolve(arg: str, recipe_dir: Path) -> str:
    """A relative ``conf/...`` path not under the working directory ->
    the recipe's own under ``egs/`` (read-only)."""
    if arg.startswith("conf/") and not os.path.exists(arg) and (recipe_dir / arg).exists():
        return str(recipe_dir / arg)
    return arg


def run(recipe: str, overrides: Optional[Dict[str, str]] = None, workdir: str = ".") -> List[Dict]:
    """Run the stages of ``recipe`` in ``workdir``; returns, per call, its
    stage, module, argv, seconds and what its ``main`` returned."""
    key = script_key(recipe)
    v = variables(key, overrides or {})
    recipe_dir = EGS / v["_recipe"]
    done = []
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for n, steps in plan(key, v):
            for step in steps:
                if isinstance(step, str):
                    print(step, flush=True)
                    continue
                module, argv = step
                argv = [_resolve(a, recipe_dir) for a in argv]
                if module.rsplit(".", 1)[-1] in ON_DEVICE | {"prepare_f0_range"} and v["device"]:
                    argv += ["--device", v["device"]]
                logging.info(f"stage {n}: python -m {module} {shlex.join(argv)}")
                t0 = time.perf_counter()
                out = importlib.import_module(module).main(argv)
                done.append({"stage": n, "module": module, "argv": argv, "seconds": time.perf_counter() - t0,
                             "result": out})
    finally:
        os.chdir(cwd)
    return done


def parse(argv: Sequence[str]) -> Tuple[str, Dict[str, str], str]:
    """``recipe [--workdir D] [--<variable> <value> ...]``."""
    argv = list(argv)
    if not argv or argv[0].startswith("--"):
        raise SystemExit(f"usage: run_recipe <recipe> [--<variable> <value> ...]; recipes: {sorted(RECIPES)}")
    recipe, rest, overrides, workdir = argv[0], argv[1:], {}, "."
    while rest:
        if len(rest) < 2 or not rest[0].startswith("--"):
            raise SystemExit(f"run_recipe: expected --<variable> <value>, got {rest[:2]}")
        name, value, rest = rest[0][2:], rest[1], rest[2:]
        if name == "workdir":
            workdir = value
        else:
            overrides[name] = value
    return recipe, overrides, workdir


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    recipe, overrides, workdir = parse(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    return run(recipe, overrides, workdir)


if __name__ == "__main__":
    main()
