"""Activation checkpointing in jatts_torch (``modules/remat.py``, ``use_remat``
and ``remat_policy`` in VALL-E and E2-TTS) on the CPU.

With dropout on, under the trainer's generators, a remat step gives the
plain step's loss and every gradient bit for bit, and leaves the
generators where the plain step leaves them; a 3-step Trainer trajectory
with remat is the plain one bit for bit. With dropout off, the port's remat
model matches the JAX model built with ``use_remat=True`` at the tolerances
of ``tests/test_torch_valle.py`` (VALL-E: gradients relative 1e-3 per
parameter, the loss 2e-5) and ``tests/test_torch_e2tts.py`` (E2-TTS:
gradients relative 1e-4, the loss 1e-5). Each ``jax.checkpoint_policies``
name is mapped or refused by name, and eval, ``no_grad`` and ``torch.export``
run the plain loop.

Small sizes: VALL-E d_model 32, 2 heads, 2 layers; E2-TTS dim 32, depth 4.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.models import e2tts as je2  # noqa: E402
from jatts_tpu.models import valle as jvalle  # noqa: E402
from jatts_torch.models import e2tts, valle  # noqa: E402
from jatts_torch.modules import remat  # noqa: E402
from jatts_torch.modules.dropout import set_dropout_generator, set_dropout_rate  # noqa: E402
from jatts_torch.modules.noise import set_noise_generator  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402
from jatts_torch.train import steps as tsteps  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402
from jatts_torch.utils.convert import e2tts_state_dict_from_jax, valle_state_dict_from_jax  # noqa: E402
from tests.test_torch_trainer import FakeLoader  # noqa: E402
from tests.torch_parity import randomize  # noqa: E402

AR = dict(idim=10, n_tokens=64, d_model=32, n_heads=2, n_layers=2, p_dropout=0.1, n_resp_levels=1)
NAR = dict(AR, n_resp_levels=7)
E2 = dict(idim=20, odim=8, dim=32, depth=4, heads=2, ff_mult=2, pe_attn_head=1)
B, TX, TP, TR, N, NT = 3, 16, 24, 24, 40, 12
POLICIES = [None, "dots_saveable"]
ORDER = ("text", "text_lens", "proms", "prom_lens", "resps", "resp_lens")


@pytest.fixture(autouse=True)
def one_thread():
    """torch's intra-op threads capped at 1 for each test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def valle_batch(seed, levels):
    rng = np.random.default_rng(seed)
    resps = rng.integers(0, 64, (B, TR) if levels == 1 else (B, TR, 8))
    return dict(
        text=rng.integers(0, 64, (B, TX)).astype(np.int32), text_lens=np.array([16, 9, 4], np.int32),
        proms=rng.integers(0, 64, (B, TP, 8)).astype(np.int32), prom_lens=np.array([20, 24, 7], np.int32),
        resps=resps.astype(np.int32), resp_lens=np.array([24, 11, 17], np.int32),
        quant_levels=rng.integers(0, 7, B).astype(np.int32),
    )


def e2_batch(seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, E2["idim"], (B, NT)).astype(np.int32)
    text[1, 7:] = -1
    return dict(text=text, feats=rng.normal(size=(B, N, E2["odim"])).astype(np.float32),
                lens=np.array([40, 29, 13], np.int32))


def build(kind, seed=0, **kw):
    """A port model with seed-made weights (the same for every ``kw``)."""
    torch.manual_seed(seed)
    if kind == "E2TTS":
        return e2tts.E2TTS(**E2, **kw, device="cpu")
    return getattr(valle, kind)(**(AR if kind == "VALLEAR" else NAR), **kw, device="cpu")


def forward(kind, model, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if kind == "E2TTS":
        return model(t["text"].long(), t["feats"], t["lens"].long())["loss"]
    args = [t[k].long() for k in ORDER]
    if kind == "VALLENAR":
        return model(*args, quant_levels=t["quant_levels"].long())["loss"]
    return model(*args)["loss"]


def batch_of(kind, seed):
    return e2_batch(seed) if kind == "E2TTS" else valle_batch(seed, 1 if kind == "VALLEAR" else 7)


# ---------------------------------------------------------------------------
# the policy names
# ---------------------------------------------------------------------------

# jax.checkpoint_policies entries that are policy factories: each takes
# names or other policies and returns a policy
TAKE_ARGUMENTS = ("offload_dot_with_no_batch_dims", "save_and_offload_only_these_names", "save_any_names_but_these",
                  "save_anything_except_these_names", "save_from_both_policies", "save_only_these_names")


def test_every_argument_free_jax_policy_is_mapped():
    names = {n for n in dir(jax.checkpoint_policies) if not n.startswith("_")}
    assert set(remat.POLICIES) == names - set(TAKE_ARGUMENTS)
    for n in remat.POLICIES:  # JAX's own: a policy of (prim, *args, **params)
        params = list(inspect.signature(getattr(jax.checkpoint_policies, n)).parameters.values())
        assert params and params[0].kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.VAR_POSITIONAL)


@pytest.mark.parametrize("name", ["save_only_these_names", "offload_dot_with_no_batch_dims", "dots_savable", ""])
def test_an_unknown_or_argument_taking_policy_is_refused_by_name(name):
    with pytest.raises(ValueError, match=repr(name)):
        remat.resolve_policy(name)
    with pytest.raises(ValueError, match=repr(name)):
        build("VALLEAR", use_remat=True, remat_policy=name)
    with pytest.raises(ValueError, match=repr(name)):
        build("E2TTS", use_remat=True, remat_policy=name)
    build("VALLEAR", use_remat=False, remat_policy=name)  # read only under use_remat, as in the JAX model


@pytest.mark.parametrize("name,saved", [
    (None, None), ("nothing_saveable", None), ("everything_saveable", "all"),
    ("dots_saveable", "dots"), ("checkpoint_dots", "dots"),
    ("dots_with_no_batch_dims_saveable", "no_batch"), ("checkpoint_dots_with_no_batch_dims", "no_batch"),
])
def test_policy_saves_what_jax_saves(name, saved):
    """Full remat has no policy; otherwise each aten op is kept or
    recomputed as the JAX policy treats its primitive: ``mm``/``addmm`` (a
    Dense) are dots with no batch dims, ``bmm``/``baddbmm`` dots with batch
    dims, ``convolution`` a dot for ``dots_saveable`` only; the flash
    forward op and elementwise ops are recomputed."""
    policy = remat.resolve_policy(name)
    if saved is None:
        assert policy is None
        return
    aten = torch.ops.aten
    ops = {"mm": aten.mm.default, "addmm": aten.addmm.default, "bmm": aten.bmm.default,
           "baddbmm": aten.baddbmm.default, "conv": aten.convolution.default, "flash": torch.ops.jatts.flash_attn_fwd.default,
           "add": aten.add.Tensor, "rand": aten.rand.generator, "softmax": aten._softmax.default}
    want = {"all": set(ops), "dots": {"mm", "addmm", "bmm", "baddbmm", "conv"}, "no_batch": {"mm", "addmm"}}[saved]
    for key, op in ops.items():
        got = policy(None, op)
        keep = got == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
        assert keep == (key in want), (name, key, got)


@pytest.mark.parametrize("name,runs", [(None, 2), ("dots_saveable", 2), ("dots_with_no_batch_dims_saveable", 2),
                                       ("everything_saveable", 1)])
def test_the_flash_forward_op_runs_again_unless_everything_is_saved(name, runs, monkeypatch):
    """``jatts::flash_attn_fwd`` under a checkpoint: its implementation runs
    once in the forward and once more in the recomputation, as JAX recomputes
    a ``pallas_call`` under ``dots_saveable``; under ``everything_saveable``
    the recomputation takes its saved outputs. The gradient is the plain
    call's bit for bit."""
    calls = []
    real = k1.flash_attention_ref
    monkeypatch.setattr(k1, "flash_attention_ref", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 9, 16)).astype(np.float32)).requires_grad_() for _ in range(3))
    w = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32)).requires_grad_()

    def fn(q, k, v):
        return (k1._fwd_op(q @ w, k, v, None, None, 0.25, True, True)[0].tanh() @ w).sum()

    plain = torch.autograd.grad(fn(q, k, v), (q, k, v, w))
    calls.clear()
    got = torch.autograd.grad(remat.checkpointed(fn, q, k, v, policy=remat.resolve_policy(name)), (q, k, v, w))
    assert len(calls) == runs
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# remat against the plain step, dropout on
# ---------------------------------------------------------------------------


def _step(kind, model, batch, seed):
    """One training forward and backward under seeded generators, as the
    trainer sets them: (loss, grads, dropout generator state, noise
    generator state)."""
    gen, noise = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1)
    set_dropout_generator(model, gen)
    set_noise_generator(model, noise)
    model.train()
    loss = forward(kind, model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, grads, gen.get_state(), noise.get_state()


@pytest.mark.parametrize("policy", POLICIES + ["everything_saveable"])
@pytest.mark.parametrize("kind", ["VALLEAR", "VALLENAR", "E2TTS"])
def test_remat_step_is_the_plain_step_bit_for_bit(kind, policy, monkeypatch):
    """Dropout on (0.1): the loss, every gradient and the generators after
    the step equal the plain model's bit for bit; each VALL-E block, each E2
    attention and each feed-forward call runs under one checkpoint, and,
    where the masks are recomputed (not under ``everything_saveable``), a
    recomputation without the generators' replay gives other gradients."""
    batch = batch_of(kind, 3)
    plain = build(kind)
    model = build(kind, use_remat=True, remat_policy=policy)
    model.load_state_dict(plain.state_dict())
    want = _step(kind, plain, batch, 7)
    wrapped = []
    real = remat.checkpoint
    monkeypatch.setattr(remat, "checkpoint", lambda fn, *a, **kw: wrapped.append(fn) or real(fn, *a, **kw))
    got = _step(kind, model, batch, 7)
    n = 2 * E2["depth"] if kind == "E2TTS" else AR["n_layers"]
    assert len(wrapped) == n
    assert torch.equal(got[0], want[0])
    for name, a, b in zip([n for n, _ in plain.named_parameters()], got[1], want[1]):
        assert torch.equal(a, b), name
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])

    if policy == "everything_saveable":
        return
    # without the replay the recomputed masks are new draws
    monkeypatch.setattr(remat, "_replay", lambda gens, states: remat.contextlib.nullcontext())
    broken = _step(kind, model, batch, 7)
    assert torch.equal(broken[0], want[0])
    assert any(not torch.equal(a, b) for a, b in zip(broken[1], want[1]))


def _trainer_config(kind):
    cfg = {"train_max_steps": 3, "log_interval_steps": 100, "save_interval_steps": 1000, "eval_interval_steps": 0,
           "optimizer_type": "AdamW", "optimizer_params": {"lr": 1e-3, "weight_decay": 0.01}, "grad_norm": 1.0,
           "scheduler": "warmuplr", "scheduler_params": {"warmup_steps": 4}, "gradient_accumulate_steps": 2}
    cfg["trainer_type"] = "E2TTSTrainer" if kind == "E2TTS" else "VALLETrainer"
    return cfg


def _trainer_batches(kind):
    if kind != "E2TTS":
        return [valle_batch(s, 1) for s in range(3)]
    out = []
    for s in range(3):
        b = e2_batch(40 + s)
        out.append({"xs": b["text"], "ilens": (b["text"] >= 0).sum(1).astype(np.int32), "ys": b["feats"],
                    "olens": b["lens"]})
    return out


@pytest.mark.parametrize("kind", ["VALLEAR", "E2TTS"])
def test_three_step_trajectory_with_remat_is_the_plain_one(kind, tmp_path):
    """The Trainer (AdamW, clip 1.0, accumulation 2, its per-step
    generators, dropout 0.1): every step's stats and the final weights with
    ``use_remat`` and ``dots_saveable`` equal the plain run's bit for bit."""
    runs = []
    for i, kw in enumerate(({}, {"use_remat": True, "remat_policy": "dots_saveable"})):
        model = build(kind, **kw)
        loss_fn = tsteps.get_loss_fn(_trainer_config(kind)["trainer_type"])
        batches = _trainer_batches(kind)
        tr = Trainer(_trainer_config(kind), model, {}, loss_fn, FakeLoader(batches), outdir=str(tmp_path / str(i)),
                     seed=0)
        tr.init_state()
        runs.append(([tr.train_step(b) for b in batches], tr))
    (plain, tp), (got, tg) = runs
    assert got == plain
    for (name, a), b in zip(tg.model.state_dict().items(), tp.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(tg.generator.get_state(), tp.generator.get_state())


# ---------------------------------------------------------------------------
# the port's remat against the JAX model's (dropout off)
# ---------------------------------------------------------------------------


def _jax_valle(kind, policy):
    cfg = dict(AR if kind == "VALLEAR" else NAR, p_dropout=0.0)
    return getattr(jvalle, kind)(**cfg, use_remat=True, remat_policy=policy)


@pytest.fixture(scope="module")
def jax_weights():
    """Numpy-made weights of the three JAX models (flax's init, then
    ``randomize``), with the port's state_dicts of them."""
    out = {}
    for kind in ("VALLEAR", "VALLENAR"):
        b = valle_batch(0, 1 if kind == "VALLEAR" else 7)
        jm = _jax_valle(kind, None)
        kw = {} if kind == "VALLEAR" else {"quant_levels": jnp.asarray(b["quant_levels"])}
        v = jax.jit(lambda key, *a: jm.init({"params": key, "noise": key}, *a, deterministic=True, **kw))(
            jax.random.PRNGKey(0), *[jnp.asarray(b[k]) for k in ORDER])
        v = {"params": randomize(v["params"], 1)}
        out[kind] = (v, valle_state_dict_from_jax(v, AR["n_layers"]))
    jm = je2.E2TTS(**E2)
    b = e2_batch(0)
    init = jax.jit(lambda key: jm.init({"params": key, "noise": key, "dropout": key}, jnp.asarray(b["text"]),
                                       jnp.asarray(b["feats"]), jnp.asarray(b["lens"]), deterministic=True))
    v = {"params": randomize(init(jax.random.PRNGKey(0))["params"], 1)}
    out["E2TTS"] = (v, e2tts_state_dict_from_jax(v, E2["depth"]))
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["VALLEAR", "VALLENAR"])
def test_valle_remat_matches_jax_remat(kind, policy, jax_weights):
    v, sd = jax_weights[kind]
    batch = valle_batch(5, 1 if kind == "VALLEAR" else 7)
    jm = _jax_valle(kind, policy)
    kw = {} if kind == "VALLEAR" else {"quant_levels": jnp.asarray(batch["quant_levels"])}

    def loss_fn(params):
        return jm.apply({"params": params}, *[jnp.asarray(batch[k]) for k in ORDER], deterministic=True, **kw)["loss"]

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    want = valle_state_dict_from_jax({"params": jax.device_get(jgrad)}, AR["n_layers"])
    model = build(kind, use_remat=True, remat_policy=policy, attn_backend="flash")
    model.load_state_dict(sd, strict=True)
    set_dropout_rate(model, 0.0)
    loss, grads, _, _ = _step(kind, model, batch, 0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6, atol=2e-5)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert rel(g.numpy(), want[name].numpy()) <= 1e-3, name


@pytest.mark.parametrize("policy", POLICIES)
def test_e2tts_remat_matches_jax_remat(policy, jax_weights, monkeypatch):
    """The five training draws injected on both sides
    (``tests/test_torch_e2tts.py:inject_draws``)."""
    from tests.test_torch_e2tts import inject_draws, make_draws

    v, sd = jax_weights["E2TTS"]
    batch = e2_batch(21)
    jm = je2.E2TTS(**E2, use_remat=True, remat_policy=policy)

    def loss_fn(params):
        return jm.apply({"params": params}, jnp.asarray(batch["text"]), jnp.asarray(batch["feats"]),
                        jnp.asarray(batch["lens"]), deterministic=True, rngs={"noise": jax.random.PRNGKey(1)})["loss"]

    with inject_draws(monkeypatch, make_draws(22)):
        jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
        model = build("E2TTS", use_remat=True, remat_policy=policy, attn_backend="flash")
        model.load_state_dict(sd, strict=True)
        set_dropout_rate(model, 0.0)
        loss, grads, _, _ = _step("E2TTS", model, batch, 0)
    want = e2tts_state_dict_from_jax({"params": jax.device_get(jgrad)}, E2["depth"])
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert rel(g.numpy(), want[name].numpy()) <= 1e-4, (name, rel(g.numpy(), want[name].numpy()))


# ---------------------------------------------------------------------------
# where remat does not act
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["VALLEAR", "E2TTS"])
def test_eval_no_grad_and_export_run_the_plain_loop(kind, monkeypatch):
    """A remat model in eval mode, or in training under ``no_grad``, takes
    no checkpoint and gives the plain model's output; ``torch.export`` of
    the eval model traces no checkpoint."""
    monkeypatch.setattr(remat, "checkpoint", lambda *a, **kw: pytest.fail("a checkpoint outside training"))
    batch = batch_of(kind, 4)
    plain = build(kind).eval()
    model = build(kind, use_remat=True, remat_policy="dots_saveable").eval()
    model.load_state_dict(plain.state_dict())
    with torch.no_grad():
        # E2's training forward draws its span, noise and time: the same seed for both
        outs = [torch.manual_seed(1) and forward(kind, m, batch) for m in (model, plain)]
        assert torch.equal(*outs)
        model.train()
        set_dropout_rate(model, 0.0)
        forward(kind, model, batch)
    model.eval()
    if kind == "E2TTS":
        net = model.backbone
        rng = np.random.default_rng(0)
        args = (torch.from_numpy(rng.normal(size=(1, 16, E2["odim"])).astype(np.float32)),
                torch.from_numpy(rng.normal(size=(1, 16, E2["odim"])).astype(np.float32)),
                torch.zeros(1, 6, dtype=torch.long), torch.tensor([0.5]), torch.tensor([False]), torch.tensor([False]))
        prog = torch.export.export(net, args)
    else:
        t = {k: torch.from_numpy(v).long() for k, v in batch.items()}

        class Logits(torch.nn.Module):
            def __init__(self, m):
                super().__init__()
                self.m = m

            def forward(self, text, text_lens, proms, prom_lens, resps, resp_lens):
                ones = torch.ones(B, dtype=torch.long)
                return self.m.trunk(text, text_lens, proms, prom_lens, resps[..., None], resp_lens, ones)[0]

        prog = torch.export.export(Logits(model), tuple(t[k] for k in ORDER))
    targets = {str(n.target) for n in prog.graph.nodes}
    assert not any("checkpoint" in s for s in targets), targets
