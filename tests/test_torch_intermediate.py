"""``jatts_torch/train/intermediate.py`` and ``utils/plot.py`` against
jatts_tpu's: the FastSpeech2 hook, on the weights the JAX hook gets, writes
the same files under ``predictions/<steps>steps/`` and the same
``_dur.txt`` byte for byte, and with a vocoder ``<utt>.wav``; every PNG
the port writes is valid (signature,
IHDR size, each chunk's CRC, the pixels inflate to the IHDR's size); a
zero-length row renders; Matcha-TTS and VITS write the same bytes twice at
one step (their noise comes from ``trainer.steps``); the training CLI runs
the hook at its eval interval."""

import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2  # noqa: E402
from jatts_torch.bin import tts_train  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.models.matchatts import MatchaTTS  # noqa: E402
from jatts_torch.train.intermediate import make_mel_eval_hook  # noqa: E402
from jatts_torch.utils import plot  # noqa: E402
from jatts_torch.utils.convert import fastspeech2_state_dict_from_jax  # noqa: E402
from tests.test_torch_compute_dtype import fs2_cli_conf  # noqa: E402
from tests.test_torch_data import write_corpus  # noqa: E402
from tests.test_torch_matcha import CONFIG as MATCHA_CONFIG  # noqa: E402
from tests.test_torch_matcha import jax_model_and_vars, port_of  # noqa: E402
from tests.test_torch_train_modules import FS2_CONFIG, IDIM  # noqa: E402
from tests.test_torch_vits import CONFIG as VITS_CONFIG  # noqa: E402
from tests.test_torch_vits import jax_vits, port_vits  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402


def png_size(path):
    """(width, height) of a valid 8-bit RGB PNG; asserts the signature, each
    chunk's CRC and the inflated size."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", path
    i, chunks = 8, {}
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        (crc,) = struct.unpack(">I", data[i + 8 + n:i + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, (path, kind)
        chunks.setdefault(kind, b"")
        chunks[kind] += body
        i += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and colour == 2 and w > 0 and h > 0
    assert len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + 3 * w)
    assert b"IEND" in chunks
    return w, h


def dev_items(seed=0, n=3, odim=8):
    rng = np.random.default_rng(seed)
    items = []
    for j in range(n):
        t = int(rng.integers(3, 7))
        d = rng.integers(1, 4, t).astype(np.int64)
        items.append({"utt_id": f"dev{j}", "x": rng.integers(1, IDIM, t).astype(np.int64), "durations": d,
                      "mel": rng.normal(size=(int(d.sum()), odim)).astype(np.float32)})
    return items


def test_fastspeech2_hook_matches_the_jax_hook(tmp_path):
    pytest.importorskip("matplotlib")  # the JAX hook plots with it; the port's does not
    from jatts_tpu.train.intermediate import make_mel_eval_hook as jmake_hook  # noqa: PLC0415

    items = dev_items()
    jmodel = JFastSpeech2(**FS2_CONFIG)
    xs = jnp.ones((2, 8), jnp.int32)
    variables = randomize(jax.jit(lambda: jmodel.init(jax.random.key(0), xs, jnp.array([8, 5]), 32,
                                                      method=JFastSpeech2.inference))(), 3)
    # durations around 2 a token
    variables["params"]["duration_predictor"]["linear"]["bias"] = np.full((1,), np.log(3.0), np.float32)
    jtrainer = SimpleNamespace(model=jmodel, outdir=str(tmp_path / "jax"), steps=7,
                               state=SimpleNamespace(params=variables["params"],
                                                     batch_stats=variables.get("batch_stats")))
    jmake_hook(items, num_save=2, max_frames=64)(jtrainer)
    port = FastSpeech2(**FS2_CONFIG, device="cpu")
    port.load_state_dict(fastspeech2_state_dict_from_jax(variables), strict=True)
    ptrainer = SimpleNamespace(model=port, outdir=str(tmp_path / "port"), steps=7, device=torch.device("cpu"))
    make_mel_eval_hook(items, num_save=2, max_frames=64)(ptrainer)
    jdir, pdir = tmp_path / "jax" / "predictions" / "7steps", tmp_path / "port" / "predictions" / "7steps"
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) == sorted(
        f"dev{j}{s}" for j in range(2) for s in (".png", "_dur.txt", "_pitch.png"))
    for j in range(2):
        got, want = (d / f"dev{j}_dur.txt" for d in (pdir, jdir))
        assert got.read_bytes() == want.read_bytes()
        assert got.read_text().startswith("pred: ") and "0 0 0" not in got.read_text().split("\n")[0]
    for name in names:
        if name.endswith(".png"):
            png_size(pdir / name)
    assert port.training  # the hook restores the training mode

    # with a vocoder: the generated mel, de-normalised by the model's stats,
    # becomes <utt>.wav at the vocoder's rate
    class FakeVocoder:
        sampling_rate, hop = 24000, 300

        def decode(self, mel, mean, scale):
            self.seen = mel * scale + mean
            return np.zeros(len(mel) * self.hop, np.float32)

    voc = FakeVocoder()
    mean, scale = np.full(8, 0.5, np.float32), np.full(8, 2.0, np.float32)
    ptrainer.outdir = str(tmp_path / "voc")
    make_mel_eval_hook(items, num_save=1, max_frames=64, vocoder=voc, mel_stats=(mean, scale))(ptrainer)
    import scipy.io.wavfile

    sr, wav = scipy.io.wavfile.read(tmp_path / "voc" / "predictions" / "7steps" / "dev0.wav")
    assert sr == 24000 and len(wav) == len(voc.seen) * voc.hop > 0


def test_zero_length_rows_render(tmp_path):
    plot.plot_mel(np.zeros((0, 8), np.float32), str(tmp_path / "mel.png"), "empty")
    plot.plot_generated_and_ref(np.zeros((0, 8)), np.ones((5, 8)), str(tmp_path / "pair.png"))
    plot.plot_attention(np.zeros((4, 0)), str(tmp_path / "attn.png"))
    plot.plot_1d(np.zeros(0), str(tmp_path / "line.png"))
    assert png_size(tmp_path / "mel.png") == (plot.SCALE, 8 * plot.SCALE)
    assert png_size(tmp_path / "pair.png") == (5 * plot.SCALE, 2 * 8 * plot.SCALE + 2 * plot.SCALE)
    assert png_size(tmp_path / "attn.png") == (plot.SCALE, 4 * plot.SCALE)
    assert png_size(tmp_path / "line.png") == (plot.SCALE, plot.LINE_HEIGHT)
    # a matrix is drawn cell for cell through the colour map, row 0 at the bottom
    plot.plot_attention(np.arange(6.0).reshape(2, 3), str(tmp_path / "grid.png"))
    assert png_size(tmp_path / "grid.png") == (3 * plot.SCALE, 2 * plot.SCALE)
    np.testing.assert_array_equal(plot.colormap(np.array([[0.0, 1.0]])), [[[68, 1, 84], [253, 231, 37]]])


@pytest.mark.parametrize("family", ["MatchaTTS", "VITS"])
def test_noise_models_write_the_same_bytes_twice_at_one_step(tmp_path, family):
    if family == "MatchaTTS":
        _, variables = jax_model_and_vars(__import__("jatts_tpu.models.matchatts", fromlist=["MatchaTTS"]).MatchaTTS)
        model, odim = port_of(MatchaTTS, variables), MATCHA_CONFIG["odim"]
    else:
        _, variables = jax_vits()
        model, odim = port_vits(variables), VITS_CONFIG["odim"]
    items = [dict(it, mel=it["mel"][:, :odim].copy()) for it in dev_items(odim=odim)]
    hook = make_mel_eval_hook(items, num_save=2, max_frames=32)
    runs = []
    for run, steps in (("a", 5), ("b", 5), ("c", 6)):
        outdir = tmp_path / run
        hook(SimpleNamespace(model=model, outdir=str(outdir), steps=steps, device=torch.device("cpu")))
        d = outdir / "predictions" / f"{steps}steps"
        runs.append({n: (d / n).read_bytes() for n in sorted(os.listdir(d))})
    assert sorted(runs[0]) == sorted(f"dev{j}{s}" for j in range(2) for s in (".png", "_dur.txt"))
    assert runs[0] == runs[1]
    assert runs[0]["dev0.png"] != runs[2]["dev0.png"]  # another step, another draw
    for name in runs[0]:
        if name.endswith(".png"):
            png_size(tmp_path / "a" / "predictions" / "5steps" / name)


def test_training_cli_runs_the_hook_at_its_eval_interval(tmp_path):
    csv, stats, tokens = write_corpus(str(tmp_path / "corpus"), "npz")
    conf = fs2_cli_conf(eval_interval_steps=2, log_interval_steps=2, num_save_intermediate_results=2,
                        eval_max_frames=64)
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    outdir = tmp_path / "exp"
    tts_train.main(["--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
                    "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu", "--verbose", "0"])
    for steps in (2, 4):
        d = outdir / "predictions" / f"{steps}steps"
        assert sorted(os.listdir(d)) == sorted(f"U{j}{s}" for j in range(2) for s in (".png", "_dur.txt",
                                                                                       "_pitch.png"))
