"""jatts_torch.aligner / modules.alignment against the JAX package on the
CPU: forward parity on converted weights, a 6-step training trajectory from
the same initial weights, the corpus helpers, and recovery of a known
alignment by the port alone."""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_tpu import aligner as jaligner  # noqa: E402
from jatts_tpu.modules.alignment import AlignmentModule as JAlignmentModule  # noqa: E402
from jatts_torch import aligner as taligner  # noqa: E402
from jatts_torch.modules.alignment import AlignmentModule  # noqa: E402
from jatts_torch.utils.convert import aligner_state_dict_from_jax, flax_to_state_dict  # noqa: E402

HOP = 300


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


def _synthetic_items(rng, n_utts=12, n_vocab=6, odim=20):
    """Utterances whose mel is a per-token signature + noise; truth known
    (the corpus of tests/test_aligner.py)."""
    sigs = rng.normal(size=(n_vocab + 1, odim)).astype(np.float32) * 3.0
    items, truths = [], []
    for _ in range(n_utts):
        n_ph = int(rng.integers(4, 9))
        toks = rng.integers(1, n_vocab + 1, n_ph).astype(np.int32)
        durs = rng.integers(4, 13, n_ph)
        mel = np.concatenate(
            [np.tile(sigs[t], (d, 1)) for t, d in zip(toks, durs)]
        ) + 0.3 * rng.normal(size=(int(durs.sum()), odim)).astype(np.float32)
        items.append({
            "row": {}, "tokens": toks, "mel": mel.astype(np.float32),
            "n_frames": int(durs.sum()), "n_samples": int(durs.sum()) * HOP,
            "edge_sil": False,
        })
        truths.append(durs)
    return items, truths


def _frame_accuracy(ds, durs):
    pred = np.repeat(np.arange(len(ds)), ds.astype(int))
    true = np.repeat(np.arange(len(durs)), durs.astype(int))
    n = min(len(pred), len(true))
    return float(np.mean(pred[:n] == true[:n]))


def _batches(seed=0, **kw):
    items, truths = _synthetic_items(np.random.default_rng(seed), **kw)
    jaligner.normalize_mels(items)
    return items, truths, jaligner.make_batches(items, batch_size=4, tok_mult=4, frame_mult=16)


def _jax_args(b):
    return (jnp.asarray(b["xs"]), jnp.asarray(b["ilens"]), jnp.asarray(b["ys"]), jnp.asarray(b["olens"]))


def _jax_init(model, b0, seed):
    """The initial weights train_aligner draws for ``seed``."""
    return model.init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        *_jax_args(b0), deterministic=True,
    )["params"]


def test_alignment_module_matches_jax():
    """log_p_attn to 1e-4: f32 convolutions and one matmul of depth 32 in
    another summation order, through a sqrt that is steep near 0."""
    rng = np.random.default_rng(0)
    b, t_text, t_feats, adim, odim = 3, 10, 37, 32, 20
    text = rng.normal(size=(b, t_text, adim)).astype(np.float32)
    feats = rng.normal(size=(b, t_feats, odim)).astype(np.float32)
    masks = np.arange(t_text)[None, :] < np.array([10, 6, 1])[:, None]
    jmod = JAlignmentModule(adim, odim)
    variables = jmod.init(jax.random.key(0), jnp.asarray(text), jnp.asarray(feats), jnp.asarray(masks))
    want = np.asarray(jmod.apply(variables, jnp.asarray(text), jnp.asarray(feats), jnp.asarray(masks)))
    tmod = AlignmentModule(adim, odim)
    tmod.load_state_dict(flax_to_state_dict(jax.device_get(variables)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(text), torch.from_numpy(feats), torch.from_numpy(masks)).numpy()
    valid = np.broadcast_to(masks[:, None, :], got.shape)
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-4)
    assert (got[~valid] < -1e8).all() and (want[~valid] < -1e8).all()


def test_aligner_forward_matches_jax():
    items, _, batches = _batches()
    b0 = batches[-1]
    jmodel = jaligner.Aligner(idim=7, odim=20, adim=32, elayers=2, mas_backend="scan")
    params = _jax_init(jmodel, b0, seed=3)
    want = jmodel.apply({"params": params}, *_jax_args(b0), deterministic=True)
    tmodel = taligner.Aligner(idim=7, odim=20, adim=32, elayers=2, device="cpu")
    tmodel.load_state_dict(aligner_state_dict_from_jax(jax.device_get(params)))
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(*taligner._batch_tensors(b0, torch.device("cpu")))
    valid = np.arange(b0["xs"].shape[1])[None, None, :] < b0["ilens"][:, None, None]
    valid = np.broadcast_to(valid, got["log_p_attn"].shape)
    np.testing.assert_allclose(
        got["log_p_attn"].numpy()[valid], np.asarray(want["log_p_attn"])[valid], rtol=0, atol=1e-4
    )
    np.testing.assert_array_equal(got["ds"].numpy(), np.asarray(want["ds"]))
    np.testing.assert_allclose(got["bin_loss"].item(), float(want["bin_loss"]), rtol=1e-5)
    # the state_dict's keys are the flax names
    assert {"embed.weight", "conv0.weight", "ln1.bias", "alignment.f_conv3.weight"} <= set(
        tmodel.state_dict()
    )


def test_warmup_cosine_lr_matches_optax():
    import optax

    for steps in (6, 300, 2000):
        warm, decay = max(1, min(200, steps // 10)), max(2, steps)
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=warm, decay_steps=decay)
        for s in sorted({0, 1, warm - 1, warm, warm + 1, steps // 2, steps - 1}):
            if s < 0:
                continue
            np.testing.assert_allclose(
                taligner.warmup_cosine_lr(s, 1e-3, warm, decay), float(sched(s)), rtol=1e-5, atol=1e-9
            )  # atol: optax takes 1 + cos in f32, which cancels at the end of the decay


def test_train_trajectory_matches_jax(caplog):
    """Six steps, dropout off, bin loss gated in at step 3, same initial
    weights and batch order. The JAX loop only logs its losses, to four
    decimals, so the trajectory is held to 1e-4 (half a printed digit plus
    f32 drift; measured: equal to the printed digit at every step). The
    final weights are held to 1e-5 absolute (measured 3e-7; the peak
    learning rate is 1e-3, so a weight that took one Adam step in the other
    direction would be 2e-3 off)."""
    steps, seed, lr = 6, 0, 1e-3
    items, _, batches = _batches()
    jmodel = jaligner.Aligner(idim=7, odim=20, adim=32, elayers=1, dropout_rate=0.0, mas_backend="scan")
    init = _jax_init(jmodel, batches[0], seed)
    with caplog.at_level(logging.INFO):
        final = jaligner.train_aligner(
            jmodel, batches, steps=steps, lr=lr, bin_loss_start_frac=0.5, seed=seed, log_every=1
        )
    pat = re.compile(r"aligner step (\d+)/\d+: loss ([-\d.]+) \(fsum ([-\d.]+), bin ([-\d.]+)\)")
    logged = [tuple(map(float, m.groups())) for m in map(pat.search, caplog.messages) if m]
    # the last step matches both logging conditions once
    want = {int(s): (l, f, b) for s, l, f, b in logged}
    assert sorted(want) == list(range(steps))

    tmodel = taligner.Aligner(idim=7, odim=20, adim=32, elayers=1, dropout_rate=0.0, device="cpu")
    tmodel.load_state_dict(aligner_state_dict_from_jax(jax.device_get(init)))
    hist = taligner.train_aligner(
        tmodel, batches, steps=steps, lr=lr, bin_loss_start_frac=0.5, seed=seed, log_every=0
    )
    for s in range(steps):
        for key, w in zip(("loss", "fsum", "bin"), want[s]):
            assert abs(hist[key][s] - w) <= 1e-4, (s, key, hist[key][s], w)
        gated = hist["fsum"][s] + (hist["bin"][s] if s >= 3 else 0.0)
        assert abs(hist["loss"][s] - gated) < 1e-4
    assert hist["fsum"][-1] < hist["fsum"][0]
    want_sd = aligner_state_dict_from_jax(jax.device_get(final))
    got_sd = tmodel.state_dict()
    assert set(want_sd) == set(got_sd)
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_corpus_helpers_equal_jax():
    rng = np.random.default_rng(5)
    rows = [
        {"sample_id": "a", "phonemes": "k o N n i ch i w a", "start": "", "end": ""},
        {"sample_id": "b", "phonemes": "a r i g a t o", "start": "0.1", "end": "0.9"},
        {"sample_id": "c", "phonemes": "", "start": "", "end": ""},
        {"sample_id": "d", "phonemes": "a i u e o a i u e o", "start": "", "end": ""},
    ]
    vocab = taligner.build_vocab([rows[:2], rows[2:]])
    assert vocab == jaligner.build_vocab([rows[:2], rows[2:]]) and vocab["<sil>"] == 0
    t_items, j_items = [], []
    for row, n_frames in zip(rows, (50, 40, 30, 11)):
        mel = rng.normal(size=(n_frames + 2, 8)).astype(np.float32)
        n_samples = (n_frames - 1) * HOP + 17
        t_it = taligner.prepare_item(dict(row), mel, vocab, n_samples, HOP)
        j_it = jaligner.prepare_item(dict(row), mel, vocab, n_samples, HOP)
        assert (t_it is None) == (j_it is None)
        if t_it is None:
            continue
        assert t_it.keys() == j_it.keys()
        for k in ("tokens", "mel"):
            np.testing.assert_array_equal(t_it[k], j_it[k])
        assert all(t_it[k] == j_it[k] for k in ("n_frames", "n_samples", "edge_sil"))
        t_items.append(t_it)
        j_items.append(j_it)
    assert len(t_items) == 2  # no phonemes; more tokens (12 with sil) than frames (11)
    taligner.normalize_mels(t_items)
    jaligner.normalize_mels(j_items)
    tb = taligner.make_batches(t_items, 2, tok_mult=4, frame_mult=16)
    jb = jaligner.make_batches(j_items, 2, tok_mult=4, frame_mult=16)
    assert len(tb) == len(jb)
    for x, y in zip(tb, jb):
        assert x["items"] == y["items"]
        for k in ("xs", "ys", "ilens", "olens"):
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].dtype == y[k].dtype


@pytest.mark.parametrize("edge_sil", [True, False])
@pytest.mark.parametrize("ds", [[5, 20, 14, 2], [1, 1, 1, 38], [30, 1, 1, 9], [3, 3, 3, 3]])
def test_row_updates_equal_jax(edge_sil, ds):
    n = 40 * HOP + 123
    item = {"row": {}, "tokens": np.zeros(4, np.int32), "n_frames": 1 + n // HOP,
            "n_samples": n, "edge_sil": edge_sil}
    ds = np.asarray(ds, np.int64)
    got = taligner.row_updates_from_durations(item, ds.copy(), HOP, 24000)
    assert got == jaligner.row_updates_from_durations(item, ds.copy(), HOP, 24000)
    durs = [int(d) for d in got["durations"].split()]
    assert len(durs) == (2 if edge_sil else 4) and min(durs) >= 1


def test_port_recovers_synthetic_alignment(one_thread):
    """The recovery test of tests/test_aligner.py on the port alone."""
    items, truths = _synthetic_items(np.random.default_rng(0))
    taligner.normalize_mels(items)
    batches = taligner.make_batches(items, batch_size=4, tok_mult=4, frame_mult=16)
    model = taligner.Aligner(idim=7, odim=20, adim=32, elayers=1, device="cpu")
    hist = taligner.train_aligner(model, batches, steps=300, lr=2e-3, log_every=0)
    assert len(hist["loss"]) == 300 and not model.training
    durations = taligner.dump_durations(model, batches, items)
    accs = []
    for it, ds, durs in zip(items, durations, truths):
        assert int(ds.sum()) == it["n_frames"]  # the path covers every frame
        assert (ds >= 1).all()                  # every token visited
        accs.append(_frame_accuracy(ds, durs))
    assert float(np.mean(accs)) > 0.75, accs


def test_dropout_draws_from_the_seeded_generator():
    items, _, batches = _batches()
    args = taligner._batch_tensors(batches[0], torch.device("cpu"))
    model = taligner.Aligner(idim=7, odim=20, adim=32, elayers=1, dropout_rate=0.5, device="cpu")
    model.train()
    outs = []
    for seed in (1, 1, 2):
        model.generator = torch.Generator().manual_seed(seed)
        outs.append(model(*args)["log_p_attn"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    model.eval()
    assert torch.equal(model(*args)["log_p_attn"], model(*args)["log_p_attn"])
