"""jatts_torch.ops.dsp / features / utils.io against the JAX package on the
CPU, and the port's align entry point on a small tone corpus."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_tpu.features.extractors import LogMelExtractor as JLogMelExtractor  # noqa: E402
from jatts_tpu.ops import dsp as jdsp  # noqa: E402
from jatts_tpu.utils import io as jio  # noqa: E402
from jatts_torch.bin import align as talign_cli  # noqa: E402
from jatts_torch.features.extractors import LogMelExtractor  # noqa: E402
from jatts_torch.ops import dsp as tdsp  # noqa: E402
from jatts_torch.utils import io as tio  # noqa: E402

SR, HOP = 24000, 300
JSUT = dict(sampling_rate=SR, fft_size=2048, hop_size=HOP, num_mels=80, fmin=80, fmax=7600)


@pytest.fixture
def one_thread():
    """Torch's intra-op threads capped at 1 for the test (restored after):
    the test's many small ops gain nothing from a thread pool, and under the
    suite's parallel workers one pool a worker costs them most of their
    time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _wave(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * np.sin(2 * np.pi * 3000.0 * t)
    return (tone + 0.01 * rng.normal(size=n)).astype(np.float32)


def test_filterbank_and_window_equal_jax():
    np.testing.assert_array_equal(tdsp.periodic_hann(1200), jdsp.periodic_hann(1200))
    np.testing.assert_array_equal(
        tdsp.mel_filterbank(SR, 2048, 80, 80.0, 7600.0), jdsp.mel_filterbank(SR, 2048, 80, 80.0, 7600.0)
    )


@pytest.mark.parametrize("kw", [
    JSUT,
    dict(sampling_rate=SR, fft_size=1024, hop_size=256, win_length=800, num_mels=40, log_base=None),
    dict(sampling_rate=16000, fft_size=512, hop_size=128, num_mels=20, log_base=2.0),
], ids=["jsut", "short_window_ln", "log2"])
def test_logmelfilterbank_matches_jax(kw):
    """|STFT| to 2e-6 of its peak (measured 3e-7) and log-mel to 5e-5
    absolute (measured 6e-6): two f32 FFT implementations, a matmul of
    depth n_fft/2+1 and a log that magnifies relative error in quiet bins."""
    wav = _wave(0, 9000)
    spc_want = np.asarray(jdsp.stft_magnitude(jnp.asarray(wav), kw["fft_size"], kw["hop_size"], kw.get("win_length")))
    spc_got = tdsp.stft_magnitude(torch.from_numpy(wav), kw["fft_size"], kw["hop_size"], kw.get("win_length")).numpy()
    assert spc_got.shape == spc_want.shape == (1 + 9000 // kw["hop_size"], kw["fft_size"] // 2 + 1)
    np.testing.assert_allclose(spc_got, spc_want, rtol=0, atol=2e-6 * spc_want.max())
    want = np.asarray(jdsp.logmelfilterbank(jnp.asarray(wav), **kw))
    got = tdsp.logmelfilterbank(torch.from_numpy(wav), **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_energy_matches_jax():
    wav = _wave(3, 7 * HOP + 17)
    got = tdsp.energy(torch.from_numpy(wav), 2048, HOP).numpy()
    want = np.asarray(jdsp.energy(jnp.asarray(wav), 2048, HOP))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_frame_signal_equals_jax():
    wav = _wave(1, 1000)
    np.testing.assert_array_equal(
        tdsp.frame_signal(torch.from_numpy(wav), 256, 100).numpy(),
        np.asarray(jdsp.frame_signal(jnp.asarray(wav), 256, 100)),
    )


@pytest.mark.parametrize("x,n", [
    (np.arange(12, dtype=np.float32).reshape(6, 2), 9),
    (np.arange(12, dtype=np.float32).reshape(6, 2), 4),
    (np.arange(5, dtype=np.float64), 5),
    (np.arange(5, dtype=np.float64), 7),
])
def test_adjust_num_frames_exact(x, n):
    got, want = tdsp.adjust_num_frames(x, n), jdsp.adjust_num_frames(x, n)
    assert got.dtype == want.dtype and got.shape == (n,) + x.shape[1:]
    np.testing.assert_array_equal(got, want)


def test_stft_complex_and_istft_match_jax():
    """The complex STFT to 2e-6 of its peak (as |STFT| above); the inverse
    (irfft, then an overlap-add by F.fold that sums in another order than
    the JAX package's scatter-add) to 1e-6 absolute on a signal of peak
    0.4, measured 1.8e-7; and the round trip returns the signal."""
    wav = _wave(4, 9000)
    want = np.asarray(jdsp._stft_complex(jnp.asarray(wav), 2048, HOP))
    got = tdsp._stft_complex(torch.from_numpy(wav), 2048, HOP).numpy()
    assert got.shape == want.shape == (1 + 9000 // HOP, 1025) and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())
    inv_want = np.asarray(jdsp._istft(jnp.asarray(want), 2048, HOP, 9000))
    inv_got = tdsp._istft(torch.from_numpy(want.copy()), 2048, HOP, 9000).numpy()
    assert inv_got.shape == (9000,)
    np.testing.assert_allclose(inv_got, inv_want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(inv_got, wav, rtol=0, atol=1e-6)


def _np_hann(n):
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def _np_stft(x, n_fft, hop):
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    frames = xp[np.arange(1 + len(x) // hop)[:, None] * hop + np.arange(n_fft)[None]]
    return np.fft.rfft(frames * _np_hann(n_fft)[None], axis=-1)


def _np_istft(spec, n_fft, hop, length):
    w = _np_hann(n_fft)
    frames = np.fft.irfft(spec, n=n_fft, axis=-1) * w[None]
    total = n_fft + hop * (len(frames) - 1)
    out, wsum = np.zeros(total), np.zeros(total)
    for i, fr in enumerate(frames):
        out[i * hop : i * hop + n_fft] += fr
        wsum[i * hop : i * hop + n_fft] += w**2
    return (out / np.maximum(wsum, 1e-8))[n_fft // 2 : n_fft // 2 + length]


def _np_griffin_lim(log_mel, n_fft, hop, n_iter):
    """The same algorithm in float64 numpy (the pseudo-inverse of the f32
    basis, as both packages take it)."""
    basis = np.asarray(jdsp.mel_filterbank(SR, n_fft, log_mel.shape[1], 80.0, 7600.0), np.float32)
    mag = np.maximum((10.0 ** log_mel.astype(np.float64)) @ np.linalg.pinv(basis).T.astype(np.float64), 0.0)
    wav_len = (len(log_mel) - 1) * hop
    wav = _np_istft(mag.astype(complex), n_fft, hop, wav_len)
    for _ in range(n_iter):
        spec = _np_stft(wav, n_fft, hop)
        wav = _np_istft(mag * spec / np.maximum(np.abs(spec), 1e-8), n_fft, hop, wav_len)
    return np.concatenate([wav, np.zeros(hop)])


@pytest.mark.parametrize("n_iter", [1, 32])
def test_griffin_lim_matches_jax(n_iter):
    """After 1 iteration the port is within 1e-3 * max|wav| of the JAX
    package (measured 5.4e-4). Griffin-Lim feeds each iteration's f32
    rounding into the next phase estimate, so after 32 iterations the two
    f32 implementations drift apart (measured 9.6e-3 * max|wav|) as each
    drifts from exact arithmetic: there both are held to a float64 numpy
    Griffin-Lim of the same algorithm, within 2e-2 * max|wav| (measured:
    JAX 9.5e-3, the port 7.2e-3); after 1 iteration both are within 1e-3
    of it too (measured 4.2e-4, 4.0e-4)."""
    log_mel = np.array(jdsp.logmelfilterbank(jnp.asarray(_wave(5, 9000)), **JSUT))
    kw = dict(fft_size=2048, hop_size=HOP, num_mels=80, fmin=80.0, fmax=7600.0, n_iter=n_iter)
    want = np.asarray(jdsp.griffin_lim(jnp.asarray(log_mel), SR, **kw))
    got = tdsp.griffin_lim(torch.from_numpy(log_mel), SR, **kw).numpy()
    exact = _np_griffin_lim(log_mel, 2048, HOP, n_iter)
    assert got.shape == want.shape == exact.shape == (len(log_mel) * HOP,)
    scale = np.abs(exact).max()
    errs = {"port-jax": np.abs(got - want).max() / scale, "port-f64": np.abs(got - exact).max() / scale,
            "jax-f64": np.abs(want - exact).max() / scale}
    print(f"griffin_lim n_iter {n_iter}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    tol = 1e-3 if n_iter == 1 else 2e-2
    if n_iter == 1:
        assert errs["port-jax"] <= tol
    assert errs["port-f64"] <= tol and errs["jax-f64"] <= tol
    np.testing.assert_array_equal(got[(len(log_mel) - 1) * HOP :], 0.0)


@pytest.mark.parametrize("n", [HOP * 64 - 1, HOP * 64, 7777])
def test_logmel_extractor_matches_jax(n):
    """Same bucket padding and crop on both sides: same frame count, values
    to 5e-5 as above."""
    wav = _wave(2, n)
    want = JLogMelExtractor(**JSUT)(wav)
    got = LogMelExtractor(**JSUT, device="cpu")(wav)
    assert got.shape == want.shape == (1 + n // HOP, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_audio_round_trip_and_crop(tmp_path):
    wav = _wave(3, 5000)
    path = str(tmp_path / "a" / "x.wav")
    tio.write_audio(path, wav, SR)
    got, sr = tio.read_audio(path, SR)
    want, _ = jio.read_audio(path, SR)
    assert sr == SR and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, wav, atol=1.0 / 32768)
    # read -> write -> read is idempotent
    tio.write_audio(str(tmp_path / "y.wav"), got, SR)
    np.testing.assert_array_equal(tio.read_audio(str(tmp_path / "y.wav"))[0], got)
    # crop by seconds and resampling, as the JAX package's reader does them
    for kw in (dict(start="0.0500208", end="0.15"), dict(start=None, end=0.1), dict(sampling_rate=16000)):
        a, sr_a = tio.read_audio(path, **{"sampling_rate": SR, **kw})
        b, sr_b = jio.read_audio(path, **{"sampling_rate": SR, **kw})
        assert sr_a == sr_b
        np.testing.assert_array_equal(a, b)


def test_csv_round_trip(tmp_path):
    rows = [{"sample_id": "a", "phonemes": "a i", "durations": "3 4"}, {"sample_id": "b", "phonemes": "u"}]
    path = str(tmp_path / "d" / "x.csv")
    tio.write_csv(rows, path, fieldnames=["sample_id", "phonemes", "durations"])
    got, names = tio.read_csv(path, dict_reader=True)
    assert (got, names) == jio.read_csv(path, dict_reader=True)
    assert names == ["sample_id", "phonemes", "durations"] and got[1]["durations"] == ""
    assert tio.read_csv(path)[0][0] == names
    with pytest.raises(ValueError, match="no rows"):
        tio.write_csv([], path)


def _frame_accuracy(ds, durs):
    pred = np.repeat(np.arange(len(ds)), ds.astype(int))
    true = np.repeat(np.arange(len(durs)), durs.astype(int))
    n = min(len(pred), len(true))
    return float(np.mean(pred[:n] == true[:n]))


def test_align_run_on_a_tone_corpus(tmp_path, one_thread):
    """bin/align.py:run on the CPU: 6 utterances of pure tones, one tone a
    phone, with 60 ms of edge silence. The csvs gain durations and a crop
    that meet the stage-1 frame-count contract, and the alignment beats
    chance."""
    rng = np.random.default_rng(1)
    phones = ["a", "i", "u", "e", "o"]
    freqs = {p: 250.0 * (2.0 ** i) for i, p in enumerate(phones)}
    rows, truth = [], {}
    for i in range(6):
        utt = f"U{i:02d}"
        ph = list(rng.choice(phones, int(rng.integers(3, 7))))
        durs = rng.integers(6, 14, len(ph))
        sil = np.zeros(int(0.06 * SR), np.float32)
        segs = [sil] + [
            0.4 * np.sin(2 * np.pi * freqs[p] * np.arange(d * HOP) / SR).astype(np.float32)
            for p, d in zip(ph, durs)
        ] + [sil]
        wav_path = str(tmp_path / "wav" / f"{utt}.wav")
        tio.write_audio(wav_path, np.concatenate(segs), SR)
        rows.append({"sample_id": utt, "spk": "syn", "wav_path": wav_path, "start": "", "end": "",
                     "original_text": "x", "phonemes": " ".join(ph)})
        truth[utt] = (ph, durs)
    paths = [str(tmp_path / "train.csv"), str(tmp_path / "dev.csv")]
    tio.write_csv(rows[:4], paths[0])
    tio.write_csv(rows[4:], paths[1])
    config = {"sampling_rate": SR, "fft_size": 2048, "hop_size": HOP, "num_mels": 20,
              "fmin": 80, "fmax": 7600}
    out = talign_cli.run(paths, config, str(tmp_path / "exp"), steps=150, batch_size=4,
                         adim=32, elayers=1, device="cpu")
    assert out["n_skipped"] == 0 and len(out["history"]["fsum"]) == 150
    assert out["history"]["fsum"][-1] < out["history"]["fsum"][0]
    sd = torch.load(str(tmp_path / "exp" / "aligner.pt"), weights_only=True)
    assert set(sd) == set(out["model"].state_dict())
    with open(tmp_path / "exp" / "aligner.json") as f:
        meta = json.load(f)
    assert meta == {"vocab": out["vocab"], "adim": 32, "elayers": 1, "num_mels": 20}
    assert meta["vocab"]["<sil>"] == 0 and len(meta["vocab"]) == 6

    accs = []
    for path in paths:
        got_rows, names = tio.read_csv(path, dict_reader=True)
        assert names[-1] == "durations"
        for row in got_rows:
            ph, durs = truth[row["sample_id"]]
            got = np.asarray([int(d) for d in row["durations"].split()])
            assert len(got) == len(ph) and (got >= 1).all()
            assert float(row["start"]) >= 0.0
            # the crop, read back, has the frame count the durations sum to
            wav, _ = tio.read_audio(row["wav_path"], SR, row["start"], row["end"])
            assert got.sum() == 1 + len(wav) // HOP
            accs.append(_frame_accuracy(got, durs))
    assert float(np.mean(accs)) > 0.5, accs  # chance is ~1/n_ph


def test_align_main_parses_the_cli(tmp_path, monkeypatch):
    """main(argv) reads the yaml and hands run() the same arguments as the
    JAX package's CLI takes, plus --device."""
    seen = {}
    monkeypatch.setattr(talign_cli, "run", lambda *a, **kw: seen.update(args=a, kw=kw))
    conf = tmp_path / "c.yaml"
    conf.write_text("sampling_rate: 24000\nhop_size: 300\n")
    talign_cli.main(["--csv", "a.csv", "b.csv", "--config", str(conf), "--outdir", "exp",
                     "--steps", "7", "--device", "cpu", "--verbose", "0"])
    assert seen["args"] == (["a.csv", "b.csv"], {"sampling_rate": 24000, "hop_size": 300}, "exp")
    assert seen["kw"] == dict(steps=7, batch_size=16, adim=256, elayers=2, lr=1e-3, seed=0,
                              out_suffix="", device="cpu")
