"""The VALL-E AR slice of jatts_torch against jatts_tpu on the CPU: packing,
a block, the training loss, logits and gradient, the bf16 compute path, the
KV-cached decode (prefix_forward + decode_one, teacher-forced), the decode
against the port's own trunk, ar_generate's stop bookkeeping, and the
flash backend (the plain causal version on the CPU) against the eager one.

Small size: d_model 128, 2 heads (head dim 64), 2 layers, 64 codec tokens,
B = 3 with ragged text, prompt and response lengths. Both sides run the same
numpy-made weights, carried by ``utils/convert.py:valle_state_dict_from_jax``.
The JAX side runs on the CPU, where its attention takes the XLA branch.

Tolerances (f32 unless stated): logits and losses atol 2e-5 (values <= ~10,
only the summation order differs); gradients relative 1e-3 per parameter in
the norm (as the FastSpeech2 training slice holds them); decode logits atol
5e-5 (the cached path sums the same terms in another grouping). bf16: see
``test_bf16_compute_path_matches_jax``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jatts_tpu.models import valle as jvalle  # noqa: E402
from jatts_tpu.utils.torch_import import convert_valle  # noqa: E402
from jatts_torch.models import valle  # noqa: E402
from jatts_torch.utils.convert import valle_state_dict_from_jax  # noqa: E402
from tests.torch_parity import assert_trees_equal, randomize  # noqa: E402

CFG = dict(idim=10, n_tokens=64, d_model=128, n_heads=2, n_layers=2, p_dropout=0.0, n_resp_levels=1)
ATOL = 2e-5
B, TX, TP, TR = 3, 16, 32, 32


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        text=rng.integers(0, 64, (B, TX)).astype(np.int32),
        text_lens=np.array([16, 9, 4], np.int32),
        proms=rng.integers(0, 64, (B, TP, 8)).astype(np.int32),
        prom_lens=np.array([20, 32, 7], np.int32),
        resps=rng.integers(0, 64, (B, TR)).astype(np.int32),
        resp_lens=np.array([32, 11, 25], np.int32),
    )


ORDER = ("text", "text_lens", "proms", "prom_lens", "resps", "resp_lens")


def _jargs(batch):
    return [jnp.asarray(batch[k]) for k in ORDER]


def _targs(batch):
    return [torch.from_numpy(batch[k]).long() for k in ORDER]


@pytest.fixture(scope="module")
def weights():
    """JAX VALLEAR variables with numpy-made values, and the port's
    state_dict of them."""
    jm = jvalle.VALLEAR(**CFG)
    v = jax.jit(lambda *a: jm.init(*a, deterministic=True))(jax.random.PRNGKey(0), *_jargs(make_batch()))
    v = {"params": randomize(v["params"], 1)}
    return v, valle_state_dict_from_jax(v, CFG["n_layers"])


def port_model(sd, **kw):
    m = valle.VALLEAR(**{**CFG, **kw}, device="cpu")
    m.load_state_dict(sd, strict=True)
    return m.eval()


def test_state_dict_round_trips_through_convert_valle(weights):
    """valle_state_dict_from_jax is convert_valle's inverse: the port's
    state_dict (the reference's keys) converts back to the same variables."""
    v, sd = weights
    m = port_model(sd)
    back = convert_valle({k: t.numpy() for k, t in m.state_dict().items()}, m)
    assert_trees_equal(back["params"], v["params"])


def test_pack_three_and_pack_ids_equal():
    rng = np.random.default_rng(5)
    b = make_batch(5)
    d = 8
    e_text, e_prom, e_resp = (rng.normal(size=(B, t, d)).astype(np.float32) for t in (TX, TP, TR))
    sep = rng.normal(size=(d,)).astype(np.float32)
    lens = [b["text_lens"], b["prom_lens"], b["resp_lens"]]
    want, want_total = jvalle.pack_three(
        jnp.asarray(e_text), jnp.asarray(lens[0]), jnp.asarray(e_prom), jnp.asarray(lens[1]),
        jnp.asarray(e_resp), jnp.asarray(lens[2]), jnp.asarray(sep),
    )
    tl = [torch.from_numpy(x).long() for x in lens]
    got, total = valle.pack_three(
        torch.from_numpy(e_text), tl[0], torch.from_numpy(e_prom), tl[1], torch.from_numpy(e_resp), tl[2],
        torch.from_numpy(sep),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(total.numpy(), np.asarray(want_total))
    want_ids = jvalle.pack_ids(jnp.asarray(b["text"]), jnp.asarray(lens[0]), TP, jnp.asarray(lens[1]),
                               jnp.asarray(b["resps"]), jnp.asarray(lens[2]))
    got_ids = valle.pack_ids(torch.from_numpy(b["text"]), tl[0], TP, tl[1], torch.from_numpy(b["resps"]), tl[2])
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


def test_block_matches(weights):
    v, sd = weights
    rng = np.random.default_rng(6)
    s = 40
    x = rng.normal(size=(B, s, CFG["d_model"])).astype(np.float32)
    m = (np.arange(s)[None, :] < np.array([40, 23, 7])[:, None]).astype(np.float32)[..., None]
    jblock = jvalle.VALLEAR(**CFG).bind(v).blocks[0]
    want = np.asarray(jblock(jnp.asarray(x), jnp.asarray(m), None, deterministic=True))
    got = port_model(sd).blocks[0](torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)


def _jax_out(v, batch, **kw):
    return jvalle.VALLEAR(**{**CFG, **kw}).apply(v, *_jargs(batch), deterministic=True)


def _valid_rows(total, s):
    return np.arange(s)[None, :] < np.asarray(total)[:, None]


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_ar_loss_and_logits_match(weights, backend):
    """The eager backend and the flash one (the plain causal version on the
    CPU) both match the JAX model."""
    v, sd = weights
    batch = make_batch(1)
    want = _jax_out(v, batch)
    got = port_model(sd, attn_backend=backend)(*_targs(batch))
    rows = _valid_rows(want["total"], want["logits"].shape[1])
    np.testing.assert_array_equal(got["total"].numpy(), np.asarray(want["total"]))
    np.testing.assert_allclose(got["logits"].detach().numpy()[rows], np.asarray(want["logits"])[rows],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(got["loss"].detach()), float(want["loss"]), rtol=1e-6, atol=ATOL)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_ar_gradient_matches_jax_grad(weights, backend):
    v, sd = weights
    batch = make_batch(2)

    def loss_fn(params):
        return jvalle.VALLEAR(**CFG).apply({"params": params}, *_jargs(batch), deterministic=True)["loss"]

    want = valle_state_dict_from_jax({"params": jax.device_get(jax.grad(loss_fn)(v["params"]))}, CFG["n_layers"])
    m = port_model(sd, attn_backend=backend)
    loss = m(*_targs(batch))["loss"]
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert _rel(g.numpy(), want[name].numpy()) <= 1e-3, name


def test_bf16_compute_path_matches_jax(weights):
    """dtype bfloat16: parameters stay f32, the blocks compute in bf16, the
    logits are f32. The two frameworks round at other places (bf16 has 8
    significant bits: 2^-8 = 0.4% a rounding), so the bound is looser:
    logits within 3% of their largest magnitude, loss within 1%."""
    v, sd = weights
    batch = make_batch(3)
    want = _jax_out(v, batch, dtype=jnp.bfloat16)
    m = port_model(sd, dtype=torch.bfloat16)
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    got = m(*_targs(batch))
    assert got["logits"].dtype == torch.float32
    rows = _valid_rows(want["total"], want["logits"].shape[1])
    wl = np.asarray(want["logits"])[rows]
    err = np.abs(got["logits"].detach().numpy()[rows] - wl).max()
    assert err <= 0.03 * np.abs(wl).max(), err
    np.testing.assert_allclose(float(got["loss"].detach()), float(want["loss"]), rtol=1e-2)


def _jax_teacher_forced(v, batch, toks):
    """JAX prefix_forward + decode_one over ``toks`` [B, n] (one cache chunk
    of n - 1 slots) -> logits [B, n, V]."""
    jm = jvalle.VALLEAR(**CFG)
    text, tl, proms, pl = _jargs(batch)[:4]
    last, prefix_len, pk, pv = jm.apply(v, text, tl, proms, pl, method=jvalle.VALLEAR.prefix_forward)
    n = toks.shape[1]
    _, _, h, dh = pk[0].shape
    ck = tuple(jnp.zeros((B, n - 1, h, dh)) for _ in pk)
    cv = tuple(jnp.zeros((B, n - 1, h, dh)) for _ in pk)
    empty = tuple(() for _ in pk)

    @jax.jit
    def decode_one(tok, pos, step, ck, cv):
        return jm.apply(v, tok, pos, step, prefix_len, pk, pv, empty, empty, ck, cv,
                        method=jvalle.VALLEAR.decode_one)

    out, pos = [np.asarray(last)], prefix_len
    for step in range(n - 1):
        logits, ck, cv = decode_one(jnp.asarray(toks[:, step]), pos, jnp.int32(step), ck, cv)
        out.append(np.asarray(logits))
        pos = pos + 1
    return np.stack(out, axis=1)


def test_decode_teacher_forced_matches_jax_and_the_trunk(weights):
    v, sd = weights
    batch = make_batch(4)
    n = 12
    toks = np.random.default_rng(4).integers(0, 64, (B, n)).astype(np.int32)
    want = _jax_teacher_forced(v, batch, toks)
    m = port_model(sd)
    targs = _targs(batch)
    got = valle.ar_generate(m, *targs[:4], max_steps=n, forced=torch.from_numpy(toks))
    np.testing.assert_allclose(got["logits"].numpy(), want, rtol=0, atol=5e-5)
    # the cache against the causal mask: the trunk over the same tokens as
    # the response gives, at position prefix_len - 1 + i, the logits that
    # the decode gave for code i (code n - 1 needs the trunk's position past
    # the response, so the response holds all n tokens)
    resps = torch.from_numpy(toks).long()
    lens = torch.full((B,), n)
    with torch.no_grad():
        logits, _ = m.trunk(targs[0], targs[1], targs[2], targs[3], resps[..., None], lens,
                            torch.ones(B, dtype=torch.long))
    start = (targs[1] + targs[3] + 1)[:, None] + torch.arange(n)[None, :]
    trunk = torch.gather(logits, 1, start[..., None].expand(B, n, logits.shape[-1]))
    np.testing.assert_allclose(got["logits"].numpy(), trunk.numpy(), rtol=0, atol=5e-5)


def test_ar_generate_stop_bookkeeping():
    """On a forced sequence: a row keeps the stop token once it has emitted
    it (whatever is forced after), ``resp_lens`` is the first stop's index,
    and a row that never stops gets ``max_steps``."""
    torch.manual_seed(0)
    m = valle.VALLEAR(**CFG, device="cpu").eval()
    stop, n = m.stop_token, 10
    forced = torch.randint(0, 64, (B, n))
    forced[0, 4] = stop  # row 0 stops at 4, then forced tokens are ignored
    forced[1, 0] = stop  # row 1 stops at once
    b = make_batch(0)
    out = valle.ar_generate(m, *_targs(b)[:4], max_steps=n, forced=forced)
    codes = out["codes"]
    assert codes.shape == (B, n)
    assert torch.equal(codes[0, :4], forced[0, :4]) and torch.all(codes[0, 4:] == stop)
    assert torch.all(codes[1] == stop)
    assert torch.equal(codes[2], forced[2])
    assert out["resp_lens"].tolist() == [4, 0, n]
    # drawn, not forced: in range, stops within max_steps, reproducible
    g = torch.Generator().manual_seed(1)
    drawn = valle.ar_generate(m, *_targs(b)[:4], max_steps=n, generator=g)
    again = valle.ar_generate(m, *_targs(b)[:4], max_steps=n, generator=torch.Generator().manual_seed(1))
    assert torch.equal(drawn["codes"], again["codes"])
    assert int(drawn["codes"].min()) >= 0 and int(drawn["codes"].max()) <= stop
    assert bool((drawn["resp_lens"] <= n).all())


def _sliced_decode_one(m, tok, pos, step, prefix_len, pk, pv, ck, cv):
    """The decode step before it took a fixed shape: the caches sliced to
    ``[:step + 1]`` by a Python ``step``, so each step had its own shapes."""
    e = m.resps_emb.weight[0][tok.long().clamp(0, m.n_resp_tokens - 1)]
    h = e[:, None] + m.sin_emb.table(pos)[:, None].to(e.dtype)
    pvalid = torch.arange(pk[0].shape[1])[None, :] < prefix_len[:, None]
    for i, block in enumerate(m.blocks):
        attn = block.attn.block
        q, k, v = attn._qkv(block.attn.norm(h))
        ck[i][:, step] = k[:, 0]
        cv[i][:, step] = v[:, 0]
        dk, dv = ck[i][:, : step + 1], cv[i][:, : step + 1]
        scale = q.shape[-1] ** -0.5
        ep = torch.einsum("bqhd,bjhd->bhqj", q, pk[i]) * scale
        ep = ep.masked_fill(~pvalid[:, None, None, :], -1e9)
        ed = torch.einsum("bqhd,bjhd->bhqj", q, dk) * scale
        a = torch.softmax(torch.cat([ep, ed], dim=-1), dim=-1)
        sp = pk[i].shape[1]
        o = torch.einsum("bhqj,bjhd->bqhd", a[..., :sp], pv[i]) + torch.einsum("bhqj,bjhd->bqhd", a[..., sp:], dv)
        h = h + attn.to_out(o.reshape(h.shape))
        h = h + block._ffn_deterministic(block.ffn.norm(h))
    return m.classifier(h)[:, 0].float()


def test_fixed_shape_step_gives_the_sliced_steps_logits(weights):
    """The AR step at a fixed shape (the slot a device tensor, K/V written by
    ``index_copy_``, every slot attended under ``slot <= step``) gives the
    teacher-forced logits of the sliced step it replaced, in f32, and the
    same cache contents (layer 0's bit for bit; later layers' K/V sum their
    inputs in another order)."""
    _, sd = weights
    m = port_model(sd)
    n = 10
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 64, (B, n)))
    args = _targs(make_batch(6))[:4]
    with torch.no_grad():
        state = valle.ar_start(m, *args, max_steps=n, forced=toks)
        ck = [torch.zeros_like(c) for c in state["ck"]]
        cv = [torch.zeros_like(c) for c in state["cv"]]
        pos = state["prefix_len"].clone()
        for step in range(n - 1):
            want = _sliced_decode_one(m, toks[:, step], pos, step, state["prefix_len"], state["pk"], state["pv"],
                                      ck, cv)
            got = valle.ar_step(m, state, forced=toks)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
            pos = pos + 1
            assert int(state["slot"]) == step + 1 and torch.equal(state["pos"], pos)
        assert torch.equal(state["ck"][0], ck[0]) and torch.equal(state["cv"][0], cv[0])
        for a, b in zip(state["ck"] + state["cv"], ck + cv):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(state["codes"], toks)


@pytest.mark.parametrize("cls", ["VALLEAR", "VALLENAR"])
def test_remat_keys_are_accepted_and_use_remat_is_refused_by_name(cls):
    """A conf's ``use_remat`` and ``remat_policy`` build the same model as
    without them (the JAX package accepts both keys), with remat on or off;
    under ``use_remat`` a ``remat_policy`` that is no argument-free
    ``jax.checkpoint_policies`` name is refused with an error naming it."""
    kw = {} if cls == "VALLEAR" else dict(n_resp_levels=3)
    torch.manual_seed(0)
    plain = getattr(valle, cls)(**{**CFG, **kw}, device="cpu")
    for use_remat in (False, True):
        torch.manual_seed(0)
        keyed = getattr(valle, cls)(**{**CFG, **kw}, use_remat=use_remat, remat_policy="dots_saveable", device="cpu")
        assert plain.state_dict().keys() == keyed.state_dict().keys()
        for k, v in plain.state_dict().items():
            assert torch.equal(v, keyed.state_dict()[k]), k
        assert keyed.remat.on == use_remat
    with pytest.raises(ValueError, match="'save_only_these_names'"):
        getattr(valle, cls)(**{**CFG, **kw}, use_remat=True, remat_policy="save_only_these_names", device="cpu")
