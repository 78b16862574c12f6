"""jatts_torch's data pipeline against jatts_tpu's on a 6-utterance corpus
(csv + per-utterance dumps + stats + token list), and the port's training
CLI on the CPU.

The JAX package's TTSDataset, BatchSampler and FastSpeech2Collater read the
``.h5`` dumps; the port's must give the same items and batches (exactly:
integer and float32 arrays equal), in the same seeded order, with and
without the prefetch thread. The same corpus written as ``.npz`` (the
format a machine without h5py trains from) gives identical batches.
"""

import os
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from jatts_tpu.data.batcher import BatchSampler as JBatchSampler  # noqa: E402
from jatts_tpu.data.batcher import FastSpeech2Collater as JCollater  # noqa: E402
from jatts_tpu.data.dataset import TTSDataset as JTTSDataset  # noqa: E402
from jatts_tpu.utils.io import write_csv, write_hdf5  # noqa: E402
from jatts_torch.bin import tts_train  # noqa: E402
from jatts_torch.data.batcher import BatchSampler, DataLoader, FastSpeech2Collater  # noqa: E402
from jatts_torch.data.dataset import TTSDataset  # noqa: E402
from jatts_torch.utils import io as tio  # noqa: E402
from jatts_torch.utils.checkpoint import find_latest_checkpoint  # noqa: E402

ODIM = 8
PHONES = ["a", "i", "u", "e", "o", "k", "s", "t"]
FEATS = ["mel", "pitch", "energy"]


def write_corpus(root, fmt, n_utts=6, seed=0):
    """csv, dumps, stats and tokens.txt of ``n_utts`` utterances; ``fmt`` is
    "h5" or "npz". Returns (csv path, stats path, token list path)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank>", "<unk>", *PHONES, "<sos/eos>"]) + "\n")
    rows, mels, pitches, energies = [], [], [], []
    for i in range(n_utts):
        n = int(rng.integers(3, 12))
        ph = rng.choice(PHONES + ["x"], n).tolist()  # "x" is out of vocabulary -> <unk>
        durs = rng.integers(1, 6, n)
        arrays = {
            "mel": rng.normal(-4.0, 2.0, (int(durs.sum()), ODIM)).astype(np.float32),
            "pitch": rng.normal(5.0, 0.3, n).astype(np.float32),
            "energy": rng.uniform(0.1, 3.0, n).astype(np.float32),
        }
        path = os.path.join(root, "dump", f"U{i}.{fmt}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if fmt == "h5":
            for k, v in arrays.items():
                write_hdf5(path, k, v)
        else:
            np.savez(path, **arrays)
        rows.append({"sample_id": f"U{i}", "spk": "s", "phonemes": " ".join(ph),
                     "durations": " ".join(map(str, durs)), "feat_path": path})
        mels.append(arrays["mel"])
        pitches.append(arrays["pitch"])
        energies.append(arrays["energy"])
    stats = {}
    for feat, xs in (("mel", mels), ("pitch", pitches), ("energy", energies)):
        cat = np.concatenate(xs)
        stats[f"{feat}_mean"] = cat.mean(0).astype(np.float32)
        stats[f"{feat}_scale"] = cat.std(0).astype(np.float32)
    stats_path = os.path.join(root, f"stats.{fmt}")
    if fmt == "h5":
        for k, v in stats.items():
            write_hdf5(stats_path, k, v)
    else:
        np.savez(stats_path, **stats)
    csv_path = os.path.join(root, "train.csv")
    write_csv(rows, csv_path)
    return csv_path, stats_path, tokens


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def _batches(csv, stats, tokens, batch_size=2, epochs=(0, 1, 2, 3), prefetch=0, dataset=TTSDataset,
             sampler_cls=BatchSampler, collater_cls=FastSpeech2Collater):
    ds = dataset(csv, stats, FEATS, tokens)
    sampler = sampler_cls([ds.get_frame_len(i) for i in range(len(ds))], batch_size, seed=3)
    collater = collater_cls()
    out = []
    for e in epochs:
        sampler.set_epoch(e)
        if dataset is TTSDataset:
            out += list(DataLoader(ds, sampler, collater, prefetch=prefetch))
        else:
            out += [collater([ds[i] for i in idx]) for idx in sampler]
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return {fmt: write_corpus(str(root / fmt), fmt) for fmt in ("h5", "npz")}


def test_dataset_items_match_jax(corpora):
    csv, stats, tokens = corpora["h5"]
    want = JTTSDataset(csv, stats, FEATS, tokens)
    got = TTSDataset(csv, stats, FEATS, tokens)
    assert len(got) == len(want) == 6 and got.vocab_size == want.vocab_size
    for i in range(len(want)):
        assert got.get_frame_len(i) == want.get_frame_len(i)
        _assert_same(got[i], want[i])
    assert any((got[i]["x"] == 1).any() for i in range(len(got)))  # <unk> met


@pytest.mark.parametrize("prefetch", [0, 2])
def test_sampler_and_collater_match_jax(corpora, prefetch):
    csv, stats, tokens = corpora["h5"]
    want = _batches(csv, stats, tokens, dataset=JTTSDataset, sampler_cls=JBatchSampler,
                    collater_cls=JCollater)
    got = _batches(csv, stats, tokens, prefetch=prefetch)
    assert len(got) == len(want) == 12  # 3 batches an epoch, 4 epochs
    for g, w in zip(got, want):
        _assert_same(g, w)
        assert g["xs"].shape[1] % 16 == 0 and g["ys"].shape[1] % 64 == 0
    orders = {tuple(b["utt_ids"][0] for b in got[e : e + 3]) for e in range(0, 12, 3)}
    assert len(orders) > 1  # the batch order is reshuffled per epoch


def test_npz_corpus_gives_identical_batches(corpora):
    from_h5 = _batches(*corpora["h5"])
    from_npz = _batches(*corpora["npz"])
    for g, w in zip(from_npz, from_h5):
        _assert_same(g, w)


def test_h5_needs_h5py_and_never_becomes_npz(corpora, monkeypatch):
    csv, stats, _ = corpora["h5"]
    monkeypatch.setitem(sys.modules, "h5py", None)  # as on a machine without it
    with pytest.raises(ImportError, match="h5py"):
        tio.read_array(stats, "mel_mean")
    with pytest.raises(ImportError, match="h5py"):
        tio.read_hdf5(stats, "mel_mean")
    np.testing.assert_array_equal(
        tio.read_array(corpora["npz"][1], "mel_mean").shape, (ODIM,)
    )
    with pytest.raises(ValueError, match=".h5 or .npz"):
        tio.read_array(csv, "mel")
    with pytest.raises(KeyError):
        tio.read_array(corpora["npz"][1], "nope")


def test_tts_train_cli_runs_four_steps_on_cpu(tmp_path):
    csv, stats, tokens = write_corpus(str(tmp_path / "corpus"), "npz")
    conf = {
        "sampling_rate": 24000, "hop_size": 300, "feat_list": FEATS, "out_feat_type": "mel",
        "model_type": "FastSpeech2", "trainer_type": "FastSpeech2Trainer",
        "collater_type": "FastSpeech2Collater",
        "model_params": dict(
            odim=ODIM, adim=16, aheads=2, elayers=1, eunits=32, dlayers=1, dunits=32,
            postnet_layers=2, postnet_chans=8, duration_predictor_chans=8,
            pitch_predictor_layers=2, pitch_predictor_chans=8, energy_predictor_chans=8,
            conformer_dec_kernel_size=7,
        ),
        "criterions": {"MelLoss": {"_type": "L1Loss"}, "DurationPredictorLoss": {},
                       "PitchLoss": {}, "EnergyLoss": {}},
        "batch_size": 3, "optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3},
        "grad_norm": 1.0, "scheduler": "warmuplr", "scheduler_params": {"warmup_steps": 4},
        "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 2,
        "log_interval_steps": 2, "steps_per_execution": 10,
    }
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    outdir = tmp_path / "exp"
    tts_train.main([
        "--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
        "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu",
        "--attn-backend", "flash", "--verbose", "0",
    ])
    written = yaml.safe_load((outdir / "config.yml").read_text())
    assert written["model_params"]["attn_backend"] == "flash"
    assert written["model_params"]["idim"] == 11 and written["train_max_steps"] == 4
    assert (outdir / "checkpoint-2steps" / "state.pt").exists()
    latest = find_latest_checkpoint(str(outdir))
    assert latest.endswith("checkpoint-4steps")
    state = torch.load(os.path.join(latest, "state.pt"), weights_only=True)
    assert set(state) == {"model", "optimizer", "steps", "epochs", "ema"} and state["steps"] == 4
    assert all(torch.isfinite(v).all() for v in state["model"].values() if v.is_floating_point())
