"""The ``torch.export`` serving artifact (jatts_torch/serving/export.py) on
the CPU, at small widths.

Each family exported, saved and loaded: FastSpeech2 single-speaker (a
pcm16 wav artifact, and a mel artifact with its stream step) and
multi-speaker, Matcha-TTS, mel-VITS, E2-TTS (3 ODE steps, depth 2) and the
VALL-E pair. Every loaded bundle, its programs replayed as a call runs them
and run eagerly, equals the in-process eager program bit for bit on the same
seed (a generator seeded alike), and another seed moves the noise models'
output; a call leaves torch's random state as it found it. The FastSpeech2
mel artifact against the JAX package's ``build_infer_fn`` jitted, as
tests/test_torch_serving_export.py holds it. One program a bucket (three for
VALL-E and E2-TTS), each calling the kernels' ops; the weights stored once
(a three-bucket artifact is larger than a one-bucket one by its two extra
programs only); a fresh interpreter that cannot import
``jatts_torch.models``, ``modules`` or ``vocoder`` loads and runs every
artifact; an artifact of the format before ``torch.export`` (weights and
module specs, no programs) still loads, by the rebuild path.
"""

import json
import os
import subprocess
import sys
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_tpu.serving.export import build_infer_fn as jbuild_infer_fn  # noqa: E402
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
from jatts_torch.serving.bundle import StreamStep, inference_kwargs, seeded  # noqa: E402
from jatts_torch.serving.export import build_e2tts_bundle_cli, read_meta  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

NMELS, IDIM, MAX_FRAMES, BATCH, BUCKET, SPK = 8, 12, 32, 2, 12, 4
FS2 = dict(idim=IDIM, odim=NMELS, adim=16, aheads=2, elayers=1, eunits=32, dlayers=1, dunits=32, postnet_layers=0,
           duration_predictor_chans=8, pitch_predictor_layers=2, pitch_predictor_chans=8, energy_predictor_chans=8,
           conformer_enc_kernel_size=5, conformer_dec_kernel_size=5)
# the size check's model: its weights outweigh a program
FS2_WIDE = dict(FS2, adim=64, eunits=1024, dunits=1024)
VOC = dict(in_channels=NMELS, channels=8, upsample_scales=(2, 2), upsample_kernel_sizes=(4, 4),
           resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))
MATCHA = dict(idim=IDIM, odim=NMELS, adim=16, aheads=2, elayers=1, eunits=32, duration_predictor_chans=8,
              decoder_channels=(16, 16), decoder_attention_head_dim=8, decoder_num_heads=2,
              conformer_enc_kernel_size=5)
VITS_P = dict(idim=IDIM, odim=NMELS, adim=16, aheads=2, text_encoder_blocks=1, text_encoder_ffn_expand=2,
              dlayers=1, dunits=32, duration_predictor_chans=8, posterior_encoder_layers=1, flow_flows=2,
              flow_layers=1, conformer_dec_kernel_size=5)
E2 = dict(idim=20, odim=NMELS, dim=32, depth=2, heads=2, ff_mult=2, pe_attn_head=1)
AR = dict(idim=IDIM, n_tokens=32, d_model=32, n_heads=2, n_layers=1, p_dropout=0.0, prompt_max_frame_length=8)
NAR = dict(idim=IDIM, n_tokens=32, d_model=32, n_heads=2, n_layers=1, p_dropout=0.0, n_resp_levels=7,
           prompt_max_frame_length=8)
REQUESTS = [[3, 4, 5, 6, 7, 8, 9, 10, 11, 2, 3], [1, 2, 3]]
VALLE_STEPS = 6


@pytest.fixture(autouse=True)
def one_thread():
    """torch's intra-op threads capped at 1 for each test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _stats(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=NMELS).astype(np.float32), rng.uniform(0.5, 2.0, NMELS).astype(np.float32)


def _centred(model):
    with torch.no_grad():
        model.duration_predictor.linear.bias.fill_(float(np.log(2.0)))
    return model.eval()


def _export_mel(path, model, params, buckets=(BUCKET,), voc=None, stream=None, spk=0, extra=None):
    mean, scale = _stats()
    config = {"model_type": type(model).__name__, "model_params": params, **(extra or {})}
    vocoder = None if voc is None else SimpleNamespace(model=voc, mean=None, scale=None)
    fn, w = build_infer_fn(config, model, mean, scale, MAX_FRAMES, vocoder=vocoder)
    meta = {"model_type": config["model_type"], "model_params": params, "num_mels": NMELS, "hop_size": 4,
            "max_frames": MAX_FRAMES, "output": "mel" if voc is None else "wav",
            "wav_format": None if voc is None else "pcm16"}
    path = export_bundle(str(path), fn, BATCH, buckets, meta, spk_dim=spk, platforms=("cpu",), weights=w,
                         stream=stream)
    return path, fn


def _e2_fields(seed=4):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, E2["idim"], size=n).tolist() for n in (9, 5)],
            [rng.normal(size=(n, NMELS)).astype(np.float32) for n in (6, 3)], [7, 9])


def _valle_inputs(seed=5):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, 32, size=n).tolist() for n in (10, 4)],
            [rng.integers(0, 32, size=(n, 8)) for n in (7, 5)])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Every family's artifact on the CPU and its in-process program or
    bundle, on seed-made weights."""
    root = tmp_path_factory.mktemp("export_artifacts")
    torch.manual_seed(0)
    out = {}
    fs2 = _centred(FastSpeech2(**FS2, attn_backend="flash", device="cpu"))
    voc = HiFiGANGenerator(**VOC, device="cpu")
    out["fs2_wav"] = _export_mel(root / "fs2_wav.npz", fs2, FS2, voc=voc)
    stream = StreamStep(voc, MAX_FRAMES, NMELS, chunk=16)
    out["fs2_mel_stream"] = _export_mel(root / "fs2_mel.npz", fs2, FS2, stream=stream)
    multi = dict(FS2, spk_embed_dim=SPK, spk_embed_integration_type="add")
    out["fs2_multi"] = _export_mel(root / "fs2_multi.npz", _centred(FastSpeech2(**multi, device="cpu")), multi,
                                   spk=SPK)
    out["matcha"] = _export_mel(root / "matcha.npz", _centred(MatchaTTS(**MATCHA, device="cpu")), MATCHA,
                                extra={"ode_steps": 2, "temperature": 0.5})
    out["vits"] = _export_mel(root / "vits.npz", _centred(VITS(**VITS_P, device="cpu")), VITS_P,
                              extra={"noise_scale": 0.5})
    e2 = E2TTS(**E2, device="cpu").eval()
    mean, scale = _stats(1)
    config = {"model_type": "E2TTS", "model_params": dict(E2), "nfe_step": 3, "cfg_strength": 2.0,
              "sway_sampling_coef": -1.0, "num_mels": NMELS}
    out["e2"] = (build_e2tts_bundle_cli(str(root / "e2"), config, e2, mean, scale, 2, [BUCKET], 24, ["cpu"]),
                 E2ttsServingBundle(e2, mean, scale, batch_size=2, buckets=[BUCKET], max_frames=24,
                                    infer_kwargs=inference_kwargs(config)))
    ar, nar = valle.VALLEAR(**AR, device="cpu").eval(), valle.VALLENAR(**NAR, device="cpu").eval()
    fn, w = build_valle_fn(ar, nar, max_steps=VALLE_STEPS, nar_temperature=0.7)
    out["valle"] = (export_valle_bundle(str(root / "valle.npz"), fn, 2, [BUCKET], prompt_frames=8, n_prom_levels=8,
                                        meta={"model_type": "VALLE", "sampling_rate": 24000, "max_steps": VALLE_STEPS,
                                              "ar_params": AR, "nar_params": NAR}, platforms=("cpu",), weights=w), fn)
    return out


def _program_keys(path):
    with zipfile.ZipFile(path) as z:
        return sorted(i.filename[:-4] for i in z.infolist() if i.filename.startswith(("t", "stream_step")))


def test_one_program_a_bucket_each_calling_the_ops(artifacts):
    parts = {"valle": ["/fill", "/start", "/step"], "e2": ["/finish", "/start", "/step"]}
    for name, (path, _) in artifacts.items():
        meta = read_meta(path)
        assert meta["format"] == "torch.export" and meta["program_device"] == "cpu" and meta["platforms"] == ["cpu"]
        want = [f"t{BUCKET}{p}" for p in parts.get(name, [""])] + (["stream_step"] if name == "fs2_mel_stream" else [])
        assert _program_keys(path) == sorted(want), name
        assert set(meta["export_s"]) == set(want)
    bundle = load_bundle(artifacts["fs2_wav"][0], device="cpu")
    targets = {str(n.target) for n in bundle.program.programs[BUCKET].graph.nodes if n.op == "call_function"}
    assert "jatts.flash_attn_fwd.default" in targets


@pytest.mark.parametrize("name", ["fs2_wav", "fs2_mel_stream", "fs2_multi", "matcha", "vits"])
def test_mel_artifacts_equal_the_in_process_program(artifacts, name):
    path, fn = artifacts[name]
    loaded = load_bundle(path, device="cpu")
    assert isinstance(loaded, ServingBundle) and loaded.graphs == {} and loaded.generator is None
    spembs = np.random.default_rng(2).normal(size=(2, SPK)).astype(np.float32) if name == "fs2_multi" else None
    xs, ilens = loaded.prepare(REQUESTS)
    se = loaded.prepare_spembs(spembs)
    before = torch.get_rng_state()
    got = loaded.run(xs, ilens, se, seed=7)
    assert torch.equal(before, torch.get_rng_state())
    want = fn(xs, ilens, se, torch.Generator().manual_seed(7))
    with seeded(loaded.device, None, 7):
        eager = loaded.program(xs, ilens, se)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(eager[k], want[k]), k
    if name in ("matcha", "vits"):
        assert float((loaded.run(xs, ilens, se, seed=8)["mel"] - got["mel"]).abs().max()) > 1e-6
    if name == "fs2_mel_stream":
        chunks = [r for r in loaded.synthesize_streaming(REQUESTS)]
        assert len(chunks) >= 1 and loaded.stream.chunk == 16 and isinstance(loaded.stream.vocoder.state_dict(), dict)


def test_e2tts_artifact_equals_the_in_process_bundle(artifacts):
    path, inproc = artifacts["e2"]
    loaded = load_bundle(path, device="cpu")
    assert isinstance(loaded, E2ttsServingBundle) and loaded.program.steps == 3
    fields = _e2_fields()
    before = torch.get_rng_state()
    got = loaded.synthesize(*fields, seed=3)
    assert torch.equal(before, torch.get_rng_state())
    for g, w in zip(got, inproc.synthesize(*fields, seed=3)):
        np.testing.assert_array_equal(g, w)
    other = loaded.synthesize(*fields, seed=4)
    assert max(np.abs(g - o).max() for g, o in zip(got, other)) > 1e-6


def test_valle_artifact_equals_the_in_process_program(artifacts):
    path, fn = artifacts["valle"]
    loaded = load_bundle(path, device="cpu")
    assert isinstance(loaded, ValleServingBundle) and loaded.max_steps == VALLE_STEPS
    args = loaded.prepare(*_valle_inputs())
    got = loaded.run(*args, seed=9)
    want = fn(*args, generator=torch.Generator().manual_seed(9))
    assert torch.equal(got["codes"], want["codes"]) and torch.equal(got["resp_lens"], want["resp_lens"])
    # the step program advances the decode state in place
    with seeded(loaded.device, None, 9):
        state = loaded.program.start(*args)
        cache = state["ck"][0]
        loaded.program.step(state)
    assert state["ck"][0] is cache and int(state["slot"]) == 1 and bool(cache[:, 0].abs().sum() > 0)


def test_fastspeech2_artifact_matches_jax_build_infer_fn(tmp_path):
    jfs2 = JFastSpeech2(**FS2)
    fvars = randomize(jfs2.init(jax.random.key(0), jnp.ones((2, 8), jnp.int32), jnp.array([8, 5]), 16,
                                method=JFastSpeech2.inference), 1)
    fvars["params"]["duration_predictor"]["linear"]["bias"][:] = np.log(2.0)
    fs2 = FastSpeech2(**FS2, attn_backend="flash", device="cpu")
    fs2.load_state_dict(fastspeech2_state_dict_from_jax(fvars), strict=True)
    path, _ = _export_mel(tmp_path / "fs2.npz", fs2.eval(), FS2)
    got = load_bundle(path, device="cpu").synthesize(REQUESTS)
    mean, scale = _stats()
    fn, weights = jbuild_infer_fn({"model_type": "FastSpeech2"}, jfs2, fvars, mean, scale, MAX_FRAMES)
    xs = np.zeros((BATCH, BUCKET), np.int32)
    for i, r in enumerate(REQUESTS):
        xs[i, : len(r)] = r
    want = jax.jit(fn)(weights, xs, np.array([len(r) for r in REQUESTS], np.int32), np.uint32(0))
    for i, r in enumerate(got):
        n = int(want["olens"][i])
        assert r["mel"].shape == (n, NMELS) and n > 0
        np.testing.assert_allclose(r["mel"], np.asarray(want["mel"])[i, :n], rtol=0, atol=1e-4)


def test_the_weights_are_stored_once(tmp_path):
    torch.manual_seed(1)
    model = _centred(FastSpeech2(**FS2_WIDE, device="cpu"))
    one, _ = _export_mel(tmp_path / "one.npz", model, FS2_WIDE)
    three, _ = _export_mel(tmp_path / "three.npz", model, FS2_WIDE, buckets=(8, BUCKET, 16))
    with zipfile.ZipFile(three) as z:
        sizes = {i.filename[:-4]: i.file_size for i in z.infolist()}
    weights = sum(n for k, n in sizes.items() if k.startswith(("w/", "b/")))
    programs = [sizes[f"t{t}"] for t in (8, BUCKET, 16)]
    assert max(programs) < weights / 4
    extra = os.path.getsize(three) - os.path.getsize(one)
    # two more programs, a few more meta bytes and zip entries: no second copy of the weights
    assert extra < sum(programs) - min(programs) + 4096 < weights, (extra, programs, weights)


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[:2] in (["jatts_torch", "models"], ["jatts_torch", "modules"], ["jatts_torch", "vocoder"]):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import json, numpy as np, torch
from jatts_torch.serving import load_bundle
from jatts_torch.serving.bundle import ServingBundle, E2ttsServingBundle
out = {}
for name, (path, kind) in json.loads(sys.argv[1]).items():
    b = load_bundle(path, device="cpu")
    if kind == "mel":
        r = b.synthesize([[3, 4, 5], [1, 2]], seed=1, spembs=np.ones((2, b.spk_dim), np.float32) if b.spk_dim else None)
        out[name] = float(sum(np.abs(x.get("mel", x.get("wav"))).astype(np.float64).sum() for x in r))
    elif kind == "e2":
        r = b.synthesize([[1, 2, 3], [4, 5]], [np.zeros((3, b.num_mels), np.float32)] * 2, [4, 5], seed=1)
        out[name] = float(sum(np.abs(x).sum() for x in r))
    else:
        r = b.synthesize([[1, 2, 3], [4, 5]], [np.ones((4, 8), np.int64)] * 2, seed=1)
        out[name] = float(sum(x.sum() for x in r))
assert not any(m.startswith(("jatts_torch.models", "jatts_torch.modules", "jatts_torch.vocoder")) for m in sys.modules)
print(json.dumps(out))
"""


def test_artifacts_load_and_run_without_the_model_code(artifacts):
    kinds = {"e2": "e2", "valle": "valle"}
    jobs = {name: (path, kinds.get(name, "mel")) for name, (path, _) in artifacts.items()}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", BLOCKER, json.dumps(jobs)], capture_output=True, text=True, env=env,
                         cwd=root, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    sums = json.loads(run.stdout.strip().splitlines()[-1])
    assert set(sums) == set(jobs) and all(np.isfinite(v) for v in sums.values())


def test_an_artifact_of_the_format_before_torch_export_still_loads(artifacts, tmp_path):
    """The format written before ``torch.export``: weights and module specs,
    no programs and no ``format`` in the meta; its bundle is rebuilt from
    the modules, and it serves the same bits."""
    for name in ("fs2_mel_stream", "matcha"):
        path, fn = artifacts[name]
        with np.load(path) as z:
            entries = {k: z[k] for k in z.files if k.startswith(("w/", "sw/"))}
            meta = json.loads(bytes(z["__meta__"]))
        for key in ("format", "program_device", "inputs", "stream_inputs", "export_s", "buffer_dtypes"):
            meta.pop(key)
        entries["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        old = str(tmp_path / f"{name}_old.npz")
        np.savez(old, **entries)
        rebuilt = load_bundle(old, device="cpu")
        assert isinstance(rebuilt.model, torch.nn.Module) and rebuilt.generator is not None
        assert (rebuilt.stream is None) == (name != "fs2_mel_stream")
        new = load_bundle(path, device="cpu")
        for a, b in zip(rebuilt.synthesize(REQUESTS, seed=2), new.synthesize(REQUESTS, seed=2)):
            np.testing.assert_array_equal(a["mel"], b["mel"])
