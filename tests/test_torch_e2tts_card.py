"""E2-TTS on the card (marked ``cuda``: they skip without one). This file
imports no jax and no flax, so it runs where the card is:

    python -m pytest tests/test_torch_e2tts_card.py -m cuda -q

In bf16 under ``attn_backend: flash`` every E2 attention forward runs on
the tensor-core kernel (``csrc/flash_attn_fwd_tc.cu``) and every dk/dv and
dq on the non-causal tensor-core forms (``csrc/flash_attn_bwd_tc.cu``), one
each a layer, and nothing else launches; the loss and gradients agree with
the eager path; CFG inference launches one forward a layer an ODE step and
no backward.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from jatts_torch.models.e2tts import E2TTS  # noqa: E402
from jatts_torch.modules.dropout import set_dropout_rate  # noqa: E402
from jatts_torch.modules.noise import set_noise_generator  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402

SMALL = dict(idim=20, odim=16, dim=128, depth=4, heads=4, ff_mult=2, pe_attn_head=1)
COUNTERS = ("launches", "launches_tc", "launches_bwd_dkv", "launches_bwd_dq", "launches_bwd_dkv_tc_noncausal",
            "launches_bwd_dq_tc_noncausal", "launches_causal", "launches_bwd_dkv_tc", "launches_bwd_dq_tc",
            "launches_tc_f32", "launches_relpos")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _counts():
    return {c: getattr(k1, c) for c in COUNTERS}


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    b, n = 3, 200  # S = 201 with the time token: ends inside a tile
    text = torch.randint(0, SMALL["idim"], (b, 40), generator=g)
    text[1, 25:] = -1
    return dict(text=text.cuda(), feats=torch.randn(b, n, SMALL["odim"], generator=g).cuda(),
                feats_lengths=torch.tensor([200, 131, 17]).cuda())


def _model(backend, dtype=torch.bfloat16):
    torch.manual_seed(0)
    m = E2TTS(**SMALL, attn_backend=backend, device="cuda", dtype=dtype)
    set_dropout_rate(m, 0.0)
    return m.train()


def _step(model, batch, seed=3):
    set_noise_generator(model, torch.Generator(device="cuda").manual_seed(seed))
    loss = model(**batch)["loss"]
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.cuda
def test_bf16_training_step_runs_on_the_tensor_core_kernels_and_matches_xla():
    _card()
    batch = _batch()
    k1.reset_launches()
    loss_f, g_f = _step(_model("flash"), batch)
    torch.cuda.synchronize()
    d = SMALL["depth"]
    want = {c: 0 for c in COUNTERS}
    want.update(launches=d, launches_tc=d, launches_bwd_dkv=d, launches_bwd_dq=d,
                launches_bwd_dkv_tc_noncausal=d, launches_bwd_dq_tc_noncausal=d)
    assert _counts() == want
    k1.reset_launches()
    loss_x, g_x = _step(_model("xla"), batch)
    assert all(v == 0 for v in _counts().values())
    assert abs(float(loss_f) - float(loss_x)) <= 1e-2 * abs(float(loss_x))
    diff = math.sqrt(sum(float((a - b).double().pow(2).sum()) for a, b in zip(g_f, g_x)))
    norm = math.sqrt(sum(float(b.double().pow(2).sum()) for b in g_x))
    assert diff / norm <= 5e-2, diff / norm


@pytest.mark.cuda
def test_f32_training_step_matches_xla():
    _card()
    batch = _batch(1)
    loss_f, g_f = _step(_model("flash", torch.float32), batch)
    loss_x, g_x = _step(_model("xla", torch.float32), batch)
    assert abs(float(loss_f) - float(loss_x)) <= 1e-4 * abs(float(loss_x))
    for a, b in zip(g_f, g_x):
        assert float((a - b).norm()) <= 1e-3 * max(float(b.norm()), 1e-6)


@pytest.mark.cuda
def test_cfg_inference_launches_one_forward_a_layer_a_step():
    _card()
    model = _model("flash").eval()
    b, t_max, steps = 2, 300, 3
    g = torch.Generator(device="cuda").manual_seed(0)
    cond = torch.randn(b, t_max, SMALL["odim"], device="cuda", generator=g)
    text = torch.randint(0, SMALL["idim"], (b, 30), device="cuda", generator=g)
    args = (cond, text, torch.tensor([50, 0], device="cuda"), torch.tensor([250, 300], device="cuda"))
    k1.reset_launches()
    out = model.inference(*args, steps=steps, cfg_strength=2.0, sway_sampling_coef=-1.0,
                          generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    d = SMALL["depth"]
    want = {c: 0 for c in COUNTERS}
    want.update(launches=d * steps, launches_tc=d * steps)
    assert _counts() == want
    again = model.inference(*args, steps=steps, cfg_strength=2.0, sway_sampling_coef=-1.0,
                            generator=torch.Generator(device="cuda").manual_seed(1))
    assert torch.equal(out["feat_gen"], again["feat_gen"])
    assert bool(torch.isfinite(out["feat_gen"]).all()) and bool((out["feat_gen"][0, 250:] == 0).all())
