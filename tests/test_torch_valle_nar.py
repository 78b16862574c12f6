"""The VALL-E NAR slice of jatts_torch against jatts_tpu on the CPU: AdaLN
(a non-zero level table) and its gradient (the stop-gradient shows), the
AdaLN block, the NAR's training loss, logits and gradient at given levels
under the eager and the flash backend (the plain non-causal version on the
CPU), the bf16 compute path, ``generate`` and ``nar_generate`` integer for
integer with sampling made greedy on both sides, the sanitising of the AR's
stop and pad codes, the padded-capacity rows' zeroed logits, the weights
through ``convert_valle``, a 3-step trajectory against the JAX Trainer, the
VALL-E prompt strategies against ``jatts_tpu/data/dataset.py``, the tts3 NAR
training CLI (4 steps, bf16, bitwise resume) and the tts3 decode CLI.

Small size: d_model 64, 4 heads of 16, 2 layers, 64 codec tokens, 7 levels,
B = 3 with ragged text, prompt and response lengths. Both sides run the same
numpy-made weights, carried by ``utils/convert.py:valle_state_dict_from_jax``.
The JAX side runs on the CPU, where its attention takes the XLA branch.
torch runs on one intra-op thread here (the ``one_thread`` fixture).

Tolerances (f32 unless stated): outputs, logits and losses to 1e-5 of
max(1, max|JAX's|) (only the summation order differs; AdaLN's exp(log_gamma)
lifts values to ~10); gradients relative 1e-3 per parameter in the norm, as
the AR's; bf16: see ``test_bf16_compute_path_matches_jax`` (bf16 has 8
significant bits and the two frameworks round at other places). Codes:
exact.
"""

import logging
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import jatts_tpu.train.steps_valle as jsteps_valle  # noqa: E402
from jatts_tpu.data.dataset import TTSDataset as JTTSDataset  # noqa: E402
from jatts_tpu.models import valle as jvalle  # noqa: E402
from jatts_tpu.modules import valle_modules as jvm  # noqa: E402
from jatts_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from jatts_tpu.utils.torch_import import convert_valle  # noqa: E402
from jatts_torch.bin import tts_train, ttslm_decode  # noqa: E402
from jatts_torch.data.batcher import round_up  # noqa: E402
from jatts_torch.data.dataset import TTSDataset  # noqa: E402
from jatts_torch.models import valle  # noqa: E402
from jatts_torch.modules.valle_modules import AdaLN  # noqa: E402
import jatts_torch.train.steps_valle as tsteps_valle  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint, save_checkpoint  # noqa: E402
from jatts_torch.utils.config import dump_config  # noqa: E402
from jatts_torch.utils.convert import valle_state_dict_from_jax  # noqa: E402
from jatts_torch.utils.io import write_csv, write_hdf5  # noqa: E402
from tests.test_torch_data import PHONES, write_codec_corpus  # noqa: E402
from tests.test_torch_trainer import LOSS_TOL, FakeLoader, _assert_weights, _config  # noqa: E402
from tests.torch_parity import assert_trees_equal, randomize  # noqa: E402

CFG = dict(idim=10, n_tokens=64, d_model=64, n_heads=4, n_layers=2, p_dropout=0.0, n_resp_levels=7)
ATOL = 1e-5
B, TX, TP, TR = 3, 16, 32, 32
ORDER = ("text", "text_lens", "proms", "prom_lens", "resps", "resp_lens")


@pytest.fixture(autouse=True)
def one_thread():
    """torch's intra-op threads capped at 1 for each test (restored after):
    the small models' many ops gain nothing from a pool, and under the
    suite's parallel workers a pool each costs them most of their time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        text=rng.integers(0, 64, (B, TX)).astype(np.int32),
        text_lens=np.array([16, 9, 4], np.int32),
        proms=rng.integers(0, 64, (B, TP, 8)).astype(np.int32),
        prom_lens=np.array([20, 32, 7], np.int32),
        resps=rng.integers(0, 64, (B, TR, 8)).astype(np.int32),
        resp_lens=np.array([32, 11, 25], np.int32),
        quant_levels=rng.integers(0, 7, B).astype(np.int32),
    )


def _jargs(batch):
    return [jnp.asarray(batch[k]) for k in ORDER]


def _targs(batch):
    return [torch.from_numpy(batch[k]).long() for k in ORDER]


@pytest.fixture(scope="module")
def weights():
    """JAX VALLENAR variables with numpy-made values (the AdaLN tables
    non-zero), and the port's state_dict of them."""
    jm = jvalle.VALLENAR(**CFG)
    b = make_batch()
    init = jax.jit(lambda k, *a: jm.init({"params": k, "noise": k}, *a, quant_levels=jnp.asarray(b["quant_levels"]),
                                         deterministic=True))
    v = {"params": randomize(init(jax.random.PRNGKey(0), *_jargs(b))["params"], 1)}
    return v, valle_state_dict_from_jax(v, CFG["n_layers"])


def port_model(sd, **kw):
    m = valle.VALLENAR(**{**CFG, **kw}, device="cpu")
    m.load_state_dict(sd, strict=True)
    return m.eval()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def assert_close(got, want, tol=ATOL):
    """max |got - want| <= tol x max(1, max|want|)."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# AdaLN and the block
# ---------------------------------------------------------------------------


def test_adaln_and_its_gradient_match_flax():
    """A non-zero level table; the gradient of a weighted sum against
    jax.grad, for the input and the table. The stop-gradient shows: the
    same gradient without it is far off."""
    d, n_levels = 64, 7
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 10, d)).astype(np.float32) * 2 + 0.5
    level = np.array([0, 6, 3], np.int32)
    w = rng.normal(size=(3, 10, d)).astype(np.float32)
    table = (0.5 * rng.normal(size=(n_levels, 2 * d))).astype(np.float32)
    jmod = jvm.AdaLN(d, n_levels)
    params = {"params": {"emb": {"embedding": jnp.asarray(table)}}}

    def jloss(p, xx):
        return jnp.sum(jmod.apply(p, xx, jnp.asarray(level)) * w)

    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(level)))
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    mod = AdaLN(d, n_levels, device="cpu")
    assert torch.equal(mod.emb.weight, torch.zeros(n_levels, 2 * d))  # zero-initialised, as flax's
    mod.emb.weight.data.copy_(torch.from_numpy(table))
    xt = torch.from_numpy(x).requires_grad_()
    got = mod(xt, torch.from_numpy(level))
    assert_close(got.detach().numpy(), want)
    gx, gt = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (xt, mod.emb.weight))
    assert _rel(gx.numpy(), np.asarray(jg_x)) <= 1e-5
    assert _rel(gt.numpy(), np.asarray(jg_p["params"]["emb"]["embedding"])) <= 1e-5

    # without the stop-gradient the input's gradient would be another one
    xt2 = torch.from_numpy(x).requires_grad_()
    h = torch.nn.functional.layer_norm(xt2, (d,), None, None, 1e-5)
    lg, beta = mod.emb.weight[torch.from_numpy(level).long()][:, None].chunk(2, dim=-1)
    undetached = torch.exp(lg) * (2.0 * (1.0 - 0.1 * h) * h) + beta
    (gx2,) = torch.autograd.grad((undetached * torch.from_numpy(w)).sum(), xt2)
    assert _rel(gx2.numpy(), np.asarray(jg_x)) > 1e-2


def test_adaln_block_matches(weights):
    v, sd = weights
    rng = np.random.default_rng(6)
    s = 40
    x = rng.normal(size=(B, s, CFG["d_model"])).astype(np.float32)
    m = (np.arange(s)[None, :] < np.array([40, 23, 7])[:, None]).astype(np.float32)[..., None]
    level = np.array([0, 5, 2], np.int32)
    jblock = jvalle.VALLENAR(**CFG).bind(v).blocks[0]
    want = np.asarray(jblock(jnp.asarray(x), jnp.asarray(m), jnp.asarray(level), deterministic=True))
    block = port_model(sd).blocks[0]
    assert block.norm_type == "adaln" and not block.attn.block.causal
    got = block(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(level))
    assert_close(got.detach().numpy(), want)


def test_state_dict_round_trips_through_convert_valle(weights):
    """valle_state_dict_from_jax inverts convert_valle for the NAR: the
    AdaLN tables under blocks.N.{attn,ffn}.norm.emb.weight, the 7-level
    response table without a stop row."""
    v, sd = weights
    assert sd["blocks.0.attn.norm.emb.weight"].shape == (7, 2 * CFG["d_model"])
    assert sd["resps_emb.weight"].shape == (7, CFG["n_tokens"], CFG["d_model"])
    m = port_model(sd)
    back = convert_valle({k: t.numpy() for k, t in m.state_dict().items()}, m)
    assert_trees_equal(back["params"], v["params"])


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------


def _jax_out(v, batch, **kw):
    """The JAX NAR's training forward at the batch's levels, jitted (eager
    flax is several times slower here)."""
    jm = jvalle.VALLENAR(**{**CFG, **kw})
    return jax.jit(lambda v_, args, q: jm.apply(v_, *args, quant_levels=q, deterministic=True))(
        v, _jargs(batch), jnp.asarray(batch["quant_levels"]))


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_nar_loss_and_logits_match(weights, backend):
    v, sd = weights
    batch = make_batch(1)
    want = _jax_out(v, batch)
    got = port_model(sd, attn_backend=backend)(*_targs(batch), quant_levels=torch.from_numpy(batch["quant_levels"]))
    assert_close(got["logits"].detach().numpy(), want["logits"])
    assert_close(float(got["loss"].detach()), float(want["loss"]))


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_nar_gradient_matches_jax_grad(weights, backend):
    v, sd = weights
    batch = make_batch(2)

    def loss_fn(params):
        return _jax_out({"params": params}, batch)["loss"]

    want = valle_state_dict_from_jax({"params": jax.device_get(jax.jit(jax.grad(loss_fn))(v["params"]))},
                                     CFG["n_layers"])
    m = port_model(sd, attn_backend=backend)
    loss = m(*_targs(batch), quant_levels=torch.from_numpy(batch["quant_levels"]))["loss"]
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert _rel(g.numpy(), want[name].numpy()) <= 1e-3, name


def test_bf16_compute_path_matches_jax(weights):
    """dtype bfloat16: parameters stay f32, the blocks compute in bf16, the
    logits are f32. AdaLN's exp(log_gamma) lifts single logits far enough
    that bf16 moves the largest ones by several percent on either side, so
    the logits are held in the mean square: the port's within 3% of JAX's
    (relative RMS), and no further from the f32 logits than JAX's own bf16
    ones (1.1x); the loss within 1%."""
    v, sd = weights
    batch = make_batch(3)
    want = np.asarray(_jax_out(v, batch, dtype=jnp.bfloat16)["logits"])
    want32 = np.asarray(_jax_out(v, batch)["logits"])
    m = port_model(sd, dtype=torch.bfloat16)
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    got = m(*_targs(batch), quant_levels=torch.from_numpy(batch["quant_levels"]))
    assert got["logits"].dtype == torch.float32
    logits = got["logits"].detach().numpy()
    assert _rel(logits, want) <= 0.03, _rel(logits, want)
    assert _rel(logits, want32) <= 1.1 * _rel(want, want32), (_rel(logits, want32), _rel(want, want32))
    want_loss = float(_jax_out(v, batch, dtype=jnp.bfloat16)["loss"])
    np.testing.assert_allclose(float(got["loss"].detach()), want_loss, rtol=1e-2)


def test_levels_come_from_the_noise_generator(weights):
    """Without given levels the NAR draws them from its noise generator:
    the same seed gives the same loss, and those levels given explicitly
    give it too."""
    _, sd = weights
    m = port_model(sd)
    batch = _targs(make_batch(4))
    g = torch.Generator()
    m.noise_generator = g
    losses = []
    for _ in range(2):
        g.manual_seed(11)
        losses.append(float(m(*batch)["loss"].detach()))
    levels = torch.randint(0, 7, (B,), generator=torch.Generator().manual_seed(11))
    assert losses[0] == losses[1] == float(m(*batch, quant_levels=levels)["loss"].detach())


# ---------------------------------------------------------------------------
# generate, nar_generate
# ---------------------------------------------------------------------------


@pytest.fixture
def greedy(monkeypatch):
    """Sampling made greedy on both sides: jax.random.categorical while JAX
    traces, and the port's ``categorical``."""
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis))
    monkeypatch.setattr(valle, "categorical", lambda logits, generator=None: logits.argmax(-1))


def _dirty_level0(batch, stop):
    """The AR's output as nar_generate gets it: level-0 codes, the stop
    token at each row's end and garbage (stop tokens, pad codes) past it."""
    level0 = batch["resps"][..., 0].copy()
    for b_, n in enumerate(batch["resp_lens"]):
        level0[b_, n:] = stop
        level0[b_, n + 1:] = np.arange(TR - n - 1) % 2 * stop
    return level0


def test_generate_and_nar_generate_are_integer_exact(weights, greedy):
    v, sd = weights
    batch = make_batch(5)
    jm = jvalle.VALLENAR(**CFG)
    text, tl, proms, pl, resps, rl = _jargs(batch)
    m = port_model(sd)
    targs = _targs(batch)
    level0 = batch["resps"][..., 0]
    want = jax.jit(lambda: jm.apply(v, text, tl, proms, pl, jnp.asarray(level0), rl, method=jvalle.VALLENAR.generate,
                                    rngs={"noise": jax.random.PRNGKey(0)}))()
    got = m.generate(targs[0], targs[1], targs[2], targs[3], torch.from_numpy(level0).long(), targs[5])
    assert got.shape == (B, TR, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dirty = _dirty_level0(batch, m.n_tokens)
    want = jax.jit(lambda: jvalle.nar_generate(jm, v, jax.random.PRNGKey(0), text, tl, proms, pl, jnp.asarray(dirty),
                                               rl))()
    got = valle.nar_generate(m, *targs[:4], torch.from_numpy(dirty).long(), targs[5])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want)[:, :, 1:])) > 10  # the codes say something


def test_nar_generate_sanitises_the_ar_stop_and_pad_codes(weights):
    """Level 0 clamped into the codebook and zeroed past resp_lens before
    the fill: the dirty level 0 and its clean form give the same codes,
    draw for draw."""
    _, sd = weights
    m = port_model(sd)
    batch = make_batch(6)
    targs = _targs(batch)
    dirty = torch.from_numpy(_dirty_level0(batch, m.n_tokens)).long()
    assert int(dirty.max()) == m.n_tokens  # out of the NAR's table
    clean = torch.where(torch.arange(TR)[None] < targs[5][:, None], dirty, 0)
    got = valle.nar_generate(m, *targs[:4], dirty, targs[5], generator=torch.Generator().manual_seed(3))
    want = m.generate(*targs[:4], clean, targs[5], generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, want) and torch.equal(got[..., 0], clean)


def test_padded_capacity_rows_draw_from_zeroed_logits(weights, monkeypatch):
    """The JAX package's quirk, kept: past each row's resp_lens the logits
    are exactly 0, so those rows draw from uniform logits."""
    _, sd = weights
    m = port_model(sd)
    batch = make_batch(7)
    targs = _targs(batch)
    seen = []

    def spy(logits, generator=None):
        seen.append(logits.clone())
        return logits.argmax(-1)

    monkeypatch.setattr(valle, "categorical", spy)
    valle.nar_generate(m, *targs[:4], targs[4][..., 0], targs[5])
    assert len(seen) == CFG["n_resp_levels"]
    pad = torch.arange(TR)[None] >= targs[5][:, None]
    for logits in seen:
        assert torch.all(logits[pad] == 0) and bool((logits[~pad] != 0).any(dim=-1).all())


# ---------------------------------------------------------------------------
# the trainer and the CLIs
# ---------------------------------------------------------------------------


def test_nar_three_step_trajectory_matches_jax_trainer(tmp_path, monkeypatch):
    """AdamW (weight decay 0.01) under warmuplr, clip at 1.0, gradients
    averaged over 2 steps, the levels of each step injected on both sides
    (both packages' valle_kwargs made to hand on the batch's quant_levels):
    the per-step losses and grad norms, and the weights after one update
    plus one accumulated step."""
    for steps in (jsteps_valle, tsteps_valle):
        real = steps.valle_kwargs
        monkeypatch.setattr(steps, "valle_kwargs", lambda batch, model=None, real=real: {
            **real(batch, model), "quant_levels": batch["quant_levels"]})
    config = _config(optimizer_type="AdamW", optimizer_params={"lr": 1e-3, "weight_decay": 0.01},
                     gradient_accumulate_steps=2, trainer_type="VALLETrainer")
    batches = [make_batch(seed=s) for s in range(3)]
    jt = JTrainer(config, jvalle.VALLENAR(**CFG), {}, jsteps_valle.valle_loss, FakeLoader(batches),
                  outdir=str(tmp_path / "jax"), mesh=None, seed=0)
    jt.init_state(jt._prep(batches[0], 1))
    n_layers = CFG["n_layers"]
    model = valle.VALLENAR(**CFG, device="cpu")
    model.load_state_dict(valle_state_dict_from_jax({"params": jax.device_get(jt.state.params)}, n_layers))
    pt = Trainer(config, model, {}, tsteps_valle.valle_loss, FakeLoader(batches), outdir=str(tmp_path / "port"),
                 seed=0)
    pt.init_state()
    for i, b in enumerate(batches):
        jt.state, js = jt.train_step(jt.state, jt._prep(b, 1), jax.random.fold_in(jt.rng, i))
        got = pt.train_step(b)
        for key in ("train/loss", "train/loss_ce", "train/grad_norm"):
            np.testing.assert_allclose(got[key], float(js[key]), err_msg=key, **LOSS_TOL)
    assert pt.updates == 1 and pt.mini_step == 1
    final = valle_state_dict_from_jax({"params": jax.device_get(jt.state.params)}, n_layers)
    _assert_weights(pt.model.state_dict(), final, 0.0)


def _prompt_corpus(root, fmt):
    """write_codec_corpus's rows plus, per row, a prompt file holding
    ``prompt_encodec`` (one row without it) and prompt phonemes."""
    csv, stats, tokens = write_codec_corpus(root, fmt)
    rows = list(__import__("csv").DictReader(open(csv, encoding="utf-8")))
    rng = np.random.default_rng(4)
    for i, row in enumerate(rows):
        path = os.path.join(root, "dump", f"P{i}.{fmt}")
        codes = rng.integers(0, 1024, (int(rng.integers(5, 30)), 8)).astype(np.int64)
        key = "prompt_encodec" if i != 1 else "other"
        if fmt == "h5":
            write_hdf5(path, key, codes)
        else:
            np.savez(path, **{key: codes})
        row["prompt_feat_path"] = path
        row["prompt_phonemes"] = " ".join(rng.choice(PHONES, 4).tolist())
    out = os.path.join(root, f"prompt_{fmt}.csv")
    write_csv(rows, out)
    return out, stats, tokens


@pytest.mark.parametrize("strategy", ["same", "given"])
def test_prompt_strategies_match_jax_dataset(tmp_path, strategy):
    """The port's items on an .h5 and on an .npz corpus against the JAX
    dataset's on the .h5 one (it reads .h5 only): prompt_encodec as stored,
    prompt_x; a prompt file without the key gives no prompt."""
    corpora = {fmt: _prompt_corpus(str(tmp_path / fmt), fmt) for fmt in ("h5", "npz")}
    jds = JTTSDataset(*corpora["h5"][:1], None, ["encodec"], corpora["h5"][2], prompt_strategy=strategy)
    for fmt, (csv, _, tokens) in corpora.items():
        ds = TTSDataset(csv, None, ["encodec"], tokens, prompt_strategy=strategy)
        assert len(ds) == len(jds)
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert set(got) == set(want), (fmt, i)
            for key in ("x", "encodec", "prompt_encodec", "prompt_x"):
                if key in want:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=f"{fmt} {i} {key}")
        assert ("prompt_encodec" in ds[1]) == (strategy == "same")


def _nar_conf(**extra):
    conf = {
        "sampling_rate": 24000, "feat_list": ["encodec"], "out_feat_type": "encodec",
        "model_type": "VALLENAR", "trainer_type": "VALLETrainer", "collater_type": "VALLECollater",
        "model_params": {**{k: v for k, v in CFG.items() if k != "idim"}, "n_tokens": 1024,
                         "prompt_max_frame_length": 64, "dtype": "bfloat16", "p_dropout": 0.1},
        "criterions": {}, "batch_size": 3, "gradient_accumulate_steps": 2,
        "optimizer_type": "AdamW", "optimizer_params": {"lr": 1e-4, "weight_decay": 0.01},
        "grad_norm": 1.0, "scheduler": "warmuplr", "scheduler_params": {"warmup_steps": 4},
        "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 2,
        "log_interval_steps": 2, "rng_impl": "rbg", "steps_per_execution": 5,
    }
    conf.update(extra)
    return conf


def test_tts3_nar_cli_four_steps_and_bitwise_resume(tmp_path, monkeypatch):
    """The NAR conf's keys at a small width: bf16 compute (float32
    parameters), flash attention (the plain version on the CPU), dropout
    0.1, accumulation 2, rng_impl and steps_per_execution accepted; steps 2
    and 3 replayed from checkpoint-2steps give the same stats and weights
    bit for bit (the same levels drawn). The prompt crop (64 frames) is past
    every utterance's length, so the collater draws nothing."""
    assert tts_train.NOT_PORTED == () and tts_train.MODELS["VALLENAR"] is valle.VALLENAR
    csv, stats, tokens = write_codec_corpus(str(tmp_path / "corpus"), "npz")
    conf_path = tmp_path / "conf.yaml"
    conf_path.write_text(yaml.safe_dump(_nar_conf()))
    outdir = tmp_path / "exp"
    trainers = []
    real_run = tts_train.run
    monkeypatch.setattr(tts_train, "run", lambda *a, **kw: trainers.append(real_run(*a, **kw)))
    tts_train.main([
        "--train-csv", csv, "--dev-csv", csv, "--stats", stats, "--token-list", tokens,
        "--config", str(conf_path), "--outdir", str(outdir), "--device", "cpu",
        "--attn-backend", "flash", "--verbose", "0",
    ])
    trainer = trainers[0]
    assert type(trainer.model).__name__ == "VALLENAR" and trainer.model.dtype == torch.bfloat16
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert trainer.steps == 4 and trainer.updates == 2
    assert all(np.isfinite(v) for h in trainer.history for v in h.values())
    assert trainer.model.noise_generator is trainer.noise_generator
    final = restore_checkpoint(find_latest_checkpoint(str(outdir)))
    assert final["steps"] == 4 and "blocks.0.attn.norm.emb.weight" in final["model"]

    config = trainer.config
    mp = dict(config["model_params"])
    dtype = tts_train.DTYPES[mp.pop("dtype")]
    resumed = Trainer(config, valle.VALLENAR(**mp, device="cpu", dtype=dtype), trainer.criterions,
                      trainer.loss_fn, trainer.train_loader, outdir=str(tmp_path / "resumed"), seed=0)
    resumed.init_state()
    resumed.load_checkpoint(str(outdir / "checkpoint-2steps"))
    loader = trainer.train_loader
    n = len(loader.sampler)
    for step, want in zip(range(2, 4), trainer.history[2:]):
        loader.sampler.set_epoch(step // n)
        batch = loader._make(list(loader.sampler)[step % n])
        assert resumed.train_step(batch) == want
    for k, v in final["model"].items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def _decode_setup(tmp_path):
    """Seed-made AR and NAR checkpoints and a decode csv of 3 rows whose
    prompts are their own codes; returns (rows, argv, checkpoint dirs,
    token list, vocabulary size)."""
    csv, _, tokens = write_codec_corpus(str(tmp_path / "corpus"), "npz", n_utts=3)
    rows = list(__import__("csv").DictReader(open(csv, encoding="utf-8")))
    for row in rows:
        row["prompt_feat_path"] = row["feat_path"]
    dec_csv = str(tmp_path / "decode.csv")
    write_csv(rows, dec_csv)
    n_vocab = len(PHONES) + 3
    dirs = {}
    for name, cls, levels in (("ar", valle.VALLEAR, 1), ("nar", valle.VALLENAR, 7)):
        mp = {**{k: v for k, v in CFG.items() if k != "idim"}, "n_tokens": 1024, "n_resp_levels": levels,
              "prompt_max_frame_length": 24, "dtype": "bfloat16"}
        torch.manual_seed(len(name))
        model = cls(**{k: v for k, v in mp.items() if k != "dtype"}, idim=n_vocab, device="cpu")
        dirs[name] = str(tmp_path / name)
        save_checkpoint(dirs[name], 3, {"model": model.state_dict()})
        dump_config({"model_params": mp}, os.path.join(dirs[name], "config.yml"))
    argv = ["--csv", dec_csv, "--token-list", tokens, "--ar-expdir", dirs["ar"],
            "--ar-config", os.path.join(dirs["ar"], "config.yml"), "--nar-expdir", dirs["nar"],
            "--nar-config", os.path.join(dirs["nar"], "config.yml"), "--outdir", str(tmp_path / "out"),
            "--max-steps", "12", "--device", "cpu", "--verbose", "0"]
    return rows, argv, dirs, tokens, n_vocab


def test_ttslm_decode_cli_from_codes(tmp_path, monkeypatch):
    """bin/ttslm_decode.py on the CPU with seed-made AR and NAR checkpoints,
    prompts from prompt_feat_path ([8, T] transposed): codes [T, 8] in the
    codebook; level 0 the AR's output; the fill equal to nar_generate called
    directly with the CLI's generator on the CLI's padded inputs; bf16
    parameters; a --codec-path that does not load logs a warning and
    leaves the code dumps, with no wavs, as the JAX CLI does."""
    rows, argv, dirs, tokens, n_vocab = _decode_setup(tmp_path)
    out = ttslm_decode.main(argv)
    assert len(out["rows"]) >= 1
    nar_conf = {"model_params": {**CFG, "n_tokens": 1024, "dtype": "bfloat16"}}
    nar = ttslm_decode.load_model(valle.VALLENAR, nar_conf, n_vocab, torch.bfloat16, None, dirs["nar"], "cpu")
    assert {p.dtype for p in nar.parameters()} == {torch.bfloat16}
    ids = {r["sample_id"]: r for r in rows}
    for res in out["rows"]:
        codes = np.load(str(tmp_path / "out" / "codes" / f"{res['utt']}.npy"))
        assert codes.shape == (res["n_gen"], 8) and codes.dtype == np.int32
        assert codes.min() >= 0 and codes.max() < 1024
        np.testing.assert_array_equal(codes[:, 0], res["level0"][:res["n_gen"]])
        row = ids[res["utt"]]
        x = [int(t) for t in ttslm_decode.TokenIDConverter(tokens).tokens2ids(row["phonemes"].split(" "))]
        prom = ttslm_decode.prompt_codes(row)[:24]
        xs = torch.zeros(1, round_up(len(x), 16), dtype=torch.long)
        xs[0, :len(x)] = torch.tensor(x)
        proms = torch.zeros(1, 24, 8, dtype=torch.long)
        proms[0, :len(prom)] = torch.from_numpy(prom)
        i_row = [r["sample_id"] for r in rows].index(res["utt"])
        fill = valle.nar_generate(nar, xs, torch.tensor([len(x)]), proms, torch.tensor([len(prom)]),
                                  torch.from_numpy(res["level0"])[None].long(), torch.tensor([res["n_gen"]]),
                                  generator=torch.Generator().manual_seed(1000 + i_row))
        np.testing.assert_array_equal(fill[0, :res["n_gen"]].numpy(), codes)
    (tmp_path / "encodec").mkdir()  # an empty directory: no weights to load
    warned = []
    monkeypatch.setattr(logging, "warning", lambda msg, *a, **kw: warned.append(msg))  # main resets the handlers
    again = ttslm_decode.main(argv[:-2] + ["--verbose", "1", "--outdir", str(tmp_path / "out2"),
                                           "--codec-path", str(tmp_path / "encodec")])
    assert any(m.startswith("codec unavailable") for m in warned), warned
    assert [r["utt"] for r in again["rows"]] == [r["utt"] for r in out["rows"]]
    for res in again["rows"]:
        np.testing.assert_array_equal(np.load(str(tmp_path / "out2" / "codes" / f"{res['utt']}.npy")),
                                      np.load(str(tmp_path / "out" / "codes" / f"{res['utt']}.npy")))
    assert not os.listdir(tmp_path / "out2" / "wav")


def test_ttslm_decode_cli_with_a_local_encodec(tmp_path):
    """``--codec-path`` with a tiny local EnCodec (tests/tiny_models.py,
    the real code layout): each prompt is encoded from its
    ``prompt_wav_path``, and the wavs written are ``EncodecModel.decode``
    of the dumped codes (all 8 levels; level 0 repeated; the prompt's own
    codes), to the 16-bit file's rounding."""
    pytest.importorskip("transformers")
    from transformers import EncodecModel

    from jatts_torch.utils.io import read_audio, write_audio
    from tests.tiny_models import make_tiny_encodec

    codec = make_tiny_encodec(str(tmp_path / "encodec"))
    rows, argv, dirs, tokens, n_vocab = _decode_setup(tmp_path)
    rng = np.random.default_rng(3)
    for i, row in enumerate(rows):
        row["prompt_wav_path"] = str(tmp_path / f"prompt{i}.wav")
        write_audio(row["prompt_wav_path"], 0.3 * rng.standard_normal(4800 + 960 * i).astype(np.float32), 24000)
        del row["prompt_feat_path"]
    write_csv(rows, argv[argv.index("--csv") + 1])
    out = ttslm_decode.main(argv + ["--codec-path", codec])
    assert len(out["rows"]) >= 1
    model = EncodecModel.from_pretrained(codec, local_files_only=True).eval()

    def decode(codes):
        with torch.no_grad():
            return model.decode(torch.from_numpy(codes.T.copy()).long()[None, None], [None]).audio_values[0, 0].numpy()

    by_id = {r["sample_id"]: r for r in rows}
    for res in out["rows"]:
        utt = res["utt"]
        codes = np.load(str(tmp_path / "out" / "codes" / f"{utt}.npy"))
        wav, _ = read_audio(by_id[utt]["prompt_wav_path"], 24000)
        with torch.no_grad():
            prom = model.encode(torch.from_numpy(wav)[None, None], bandwidth=6.0).audio_codes[0, 0].T.numpy()
        assert prom.shape[1] == 8
        for sub, want_codes in (("wav", codes), ("wav_ar", np.repeat(codes[:, :1], 8, axis=1)),
                                ("wav_prompt", prom[:24])):
            got, sr = read_audio(str(tmp_path / "out" / sub / f"{utt}.wav"))
            want = np.clip(decode(want_codes), -1, 1)
            assert sr == 24000 and got.shape == want.shape, (sub, got.shape, want.shape)
            assert np.abs(got - want).max() <= 1.0 / 32768 + 1e-7, sub


def test_nar_and_the_decode_cli_default_to_cuda():
    """The NAR and stage 5 run on the card unless asked: without one they
    raise before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        valle.VALLENAR(n_tokens=8, d_model=16, n_heads=2, n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttslm_decode.run("eval.csv", "tokens.txt", {}, {}, "out")
