"""Speaker embeddings and stage 5 on the card against the same calls on the
CPU (marked ``cuda``: they skip without a card), the f0 histograms, and a
fresh interpreter's imports of this slice's modules. This file imports no
jax and no flax, so it runs where the card is:

    python -m pytest tests/test_torch_ecapa_card.py -m cuda -q
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.bin import create_histogram  # noqa: E402
from jatts_torch.bin import evaluate as teval  # noqa: E402
from jatts_torch.bin.verify_ecapa import probe_wavs  # noqa: E402
from jatts_torch.evaluate import dtw_based, world  # noqa: E402
from jatts_torch.features import ecapa  # noqa: E402
from jatts_torch.ops.pitch import estimate_f0  # noqa: E402
from jatts_torch.utils.io import write_audio, write_csv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SR = 24000
# cuDNN's f32 convolutions (TF32 off) and cuFFT against the CPU's: the
# embeddings at the published widths are O(1)
EMB = dict(rtol=1e-3, atol=1e-4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _pulses(seconds, f0, seed):
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    c = np.full(int(seconds * SR), float(f0))
    onsets = np.where(np.diff(np.floor(np.cumsum(c / SR))) > 0)[0]
    x = np.zeros(len(c))
    x[onsets] = 1.0 + 0.05 * rng.standard_normal(len(onsets))
    x = lfilter([1.0], [1, -1.95, 0.9506], x)
    x = x / np.abs(x).max()
    return (0.5 * x + 0.01 * rng.standard_normal(len(x))).astype(np.float32)


def test_new_modules_import_no_jax_yaml_or_card():
    """In a fresh interpreter: the slice's modules import no jax, flax,
    jatts_tpu or yaml, and the numpy-side evaluation modules no torch (so a
    stage-5 worker process never touches the card)."""
    code = (
        "import sys, jatts_torch.evaluate.dtw_based, jatts_torch.evaluate.world, jatts_torch.bin.evaluate, "
        "jatts_torch.text, jatts_torch.text.julius\n"
        "torch_free = 'torch' not in sys.modules\n"
        "import jatts_torch.features.ecapa, jatts_torch.bin.verify_ecapa, jatts_torch.bin.create_histogram, "
        "jatts_torch.bin.import_checkpoint, jatts_torch.bin.preprocess, jatts_torch.utils.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'jatts_tpu'))\n"
        "bad += [m for m in ('yaml', 'triton') if m in sys.modules]\n"
        "print(bad, torch_free); sys.exit(1 if bad or not torch_free else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_create_histogram_writes_pngs_and_percentiles(tmp_path, capsys):
    """Two speakers' wavs: a PNG each, the 1st/99th percentiles printed, the
    voiced f0 the estimator's."""
    rows = []
    for i, (spk, f0) in enumerate((("a", 120), ("a", 140), ("b", 220))):
        path = str(tmp_path / f"u{i}.wav")
        write_audio(path, _pulses(0.5, f0, i), SR)
        rows.append({"sample_id": f"u{i}", "spk": spk, "wav_path": path})
    csv = str(tmp_path / "d.csv")
    write_csv(rows, csv)
    voiced = create_histogram.main(["--csv", csv, "--outdir", str(tmp_path / "h"), "--device", "cpu"])
    out = capsys.readouterr().out
    for spk in ("a", "b"):
        png = tmp_path / "h" / f"{spk}_f0_histogram.png"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert f"{spk}: p01=" in out
    assert 115 <= np.percentile(voiced["a"], 50) <= 145 and 210 <= np.percentile(voiced["b"], 50) <= 230
    from jatts_torch.utils.io import read_audio

    wav, _ = read_audio(rows[2]["wav_path"], SR)
    f0 = estimate_f0(torch.from_numpy(wav), SR, 300, f0min=40.0, f0max=800.0).numpy()
    np.testing.assert_array_equal(voiced["b"], f0[f0 > 0])


@pytest.mark.cuda
def test_extractor_on_the_card_matches_the_cpu(tmp_path):
    """The extractor at speechbrain's published widths (seed-made weights:
    torch's initialisation, BatchNorm statistics and affine drawn around
    identity; saved in speechbrain's layout) on the probe signals, card
    against CPU."""
    _card()
    torch.manual_seed(0)
    sd = {}
    for k, v in ecapa.EcapaTdnn(device="cpu").state_dict().items():
        if k.endswith(("running_mean", "norm.bias")):
            v = 0.1 * torch.randn_like(v)
        elif k.endswith("running_var"):
            v = torch.rand_like(v) + 0.5
        elif k.endswith("norm.weight"):
            v = 1.0 + 0.1 * torch.randn_like(v)
        sd[k] = v
    ckpt = str(tmp_path / "embedding_model.ckpt")
    torch.save(sd, ckpt)
    card = ecapa.EcapaSpkEmbExtractor(ckpt)
    cpu = ecapa.EcapaSpkEmbExtractor(ckpt, device="cpu")
    assert card.device.type == "cuda"
    for name, wav in probe_wavs().items():
        got, want = card(wav), cpu(wav)
        assert got.shape == (192,) and np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, **EMB, err_msg=name)


@pytest.mark.cuda
def test_world_f0_and_stage5_on_the_card_match_the_cpu(tmp_path):
    """world_extract's f0 on the card against the CPU (rtol 1e-3, the same
    voicing), and the stage-5 CLI on the card: --n-jobs 1 and 2 give the
    same results.csv bit for bit, each metric within 1e-2 of the CPU run."""
    _card()
    x = _pulses(0.8, 130, 1)
    want = world.world_f0(x, SR, device="cpu")
    got = world.world_f0(x, SR)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    y = np.concatenate([np.zeros(600, np.float32), 0.9 * x])
    m_card = dtw_based.calculate_mcd_f0(x, y, SR)
    m_cpu = dtw_based.calculate_mcd_f0(x, y, SR, device="cpu")
    for k in m_cpu:
        np.testing.assert_allclose(m_card[k], m_cpu[k], rtol=1e-2, atol=1e-2)

    rows = []
    for i in range(3):
        ref = str(tmp_path / "ref" / f"u{i}.wav")
        write_audio(ref, _pulses(0.5, 110 + 20 * i, i), SR)
        write_audio(str(tmp_path / "gen" / f"u{i}.wav"), 0.8 * _pulses(0.55, 115 + 20 * i, 10 + i), SR)
        rows.append({"sample_id": f"u{i}", "wav_path": ref})
    write_csv(rows, str(tmp_path / "t.csv"))
    (tmp_path / "c.yaml").write_text(f"sampling_rate: {SR}\n")
    args = ["--csv", str(tmp_path / "t.csv"), "--wavdir", str(tmp_path / "gen"), "--config", str(tmp_path / "c.yaml"),
            "--verbose", "0"]
    outs = {}
    for tag, extra in (("card1", ["--n-jobs", "1"]), ("card2", ["--n-jobs", "2"]),
                       ("cpu", ["--n-jobs", "1", "--device", "cpu"])):
        teval.main(args + extra + ["--out", str(tmp_path / f"{tag}.csv")])
        outs[tag] = (tmp_path / f"{tag}.csv").read_text()
    assert outs["card1"] == outs["card2"]
    import csv as _csv

    card_rows = list(_csv.DictReader(outs["card1"].splitlines()))
    cpu_rows = list(_csv.DictReader(outs["cpu"].splitlines()))
    for a, b in zip(card_rows, cpu_rows):
        for k in teval.METRIC_KEYS:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-2, atol=1e-2)
