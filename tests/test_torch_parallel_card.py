"""Multi-process training's pieces that need the card (marked ``cuda``: they
skip without one), and the world of one on the CPU. This file imports no
jax and no flax, so it runs where the card is:

    python -m pytest tests/test_torch_parallel_card.py -q

- E2-TTS's attention under sequence parallelism runs each rank's queries
  (Tq = N/M + 1) against the keys gathered over the model axis (Tk = N + 1):
  on the card the bf16 tensor-core forward and the non-causal dk/dv and dq
  at Tq != Tk, held to the plain versions per batch item within 1e-2 (the
  bf16 tolerance of tests/test_torch_flash_tc_noncausal.py);
- a world of one (NCCL on the card, gloo on the CPU) through the Trainer's
  mesh path computes the plain step bit for bit: E2-TTS (dropout and the
  training noise on) and FastSpeech2 (train-mode BatchNorm), 2 steps.
"""

import datetime
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from jatts_torch.losses.basic import LOSS_REGISTRY  # noqa: E402
from jatts_torch.models.e2tts import E2TTS  # noqa: E402
from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402
from jatts_torch.parallel.mesh import get_mesh  # noqa: E402
from jatts_torch.train.steps import get_loss_fn  # noqa: E402
from jatts_torch.train.trainer import Trainer  # noqa: E402

E2 = dict(idim=20, odim=16, dim=128, depth=2, heads=2, ff_mult=2, pe_attn_head=1)
FS2 = dict(idim=12, odim=8, adim=32, aheads=2, elayers=1, eunits=48, dlayers=1, dunits=48, postnet_layers=2,
           postnet_chans=16, duration_predictor_chans=16, pitch_predictor_layers=2, pitch_predictor_chans=16,
           energy_predictor_chans=16, conformer_dec_kernel_size=7)
CONFIG = {"train_max_steps": 2, "log_interval_steps": 100, "save_interval_steps": 1000, "eval_interval_steps": 0,
          "optimizer_type": "Adam", "optimizer_params": {"lr": 1e-3}, "grad_norm": 1.0, "scheduler": "warmuplr",
          "scheduler_params": {"warmup_steps": 4}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(129, 257), (128, 256)])
def test_flash_attention_at_the_sequence_parallel_shape(tq, tk):
    """The autograd chain on the tensor-core kernels at Tq != Tk, a key mask
    with a row of 60 valid keys, against autograd through the plain forward
    in f32: one forward, one dk/dv and one dq launch on the non-causal
    tensor-core counters."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, d = 2, 4, 64
    q, do = (torch.randn(b, h, tq, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h, tk, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    key_mask = torch.arange(tk, device="cuda")[None, :] < torch.tensor([tk, 60], device="cuda")[:, None]
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    k1.reset_launches()
    out = k1.flash_attention(*leaves, None, key_mask, d ** -0.5)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k1.launches_tc, k1.launches_bwd_dkv_tc_noncausal, k1.launches_bwd_dq_tc_noncausal) == (1, 1, 1)
    ref_leaves = [x.float().detach().requires_grad_() for x in (q, k, v)]
    ref = k1.flash_attention_ref(*ref_leaves, None, key_mask, d ** -0.5)
    want = torch.autograd.grad(ref, ref_leaves, do.float())
    for name, a, w in zip(("out", "dq", "dk", "dv"), (out, *got), (ref, *want)):
        err = (a.float() - w).flatten(1).abs().amax(1) / w.flatten(1).abs().amax(1).clamp_min(1.0)
        assert float(err.max()) <= 1e-2, (name, float(err.max()))
    assert bool((got[1][1, :, 60:] == 0).all()) and bool((got[2][1, :, 60:] == 0).all())


def _e2_batch():
    rng = np.random.default_rng(0)
    text = rng.integers(0, E2["idim"], (2, 24)).astype(np.int32)
    text[1, 15:] = -1
    return {"xs": text, "ilens": (text >= 0).sum(1).astype(np.int32),
            "ys": rng.normal(size=(2, 96, E2["odim"])).astype(np.float32), "olens": np.array([96, 61], np.int32)}


def _fs2_batch():
    rng = np.random.default_rng(1)
    ilens = np.array([16, 9], np.int32)
    mask = np.arange(16)[None] < ilens[:, None]
    ds = rng.integers(1, 5, (2, 16)) * mask
    olens = ds.sum(-1).astype(np.int32)
    t = -(-int(olens.max()) // 16) * 16
    return {"xs": (rng.integers(1, 12, (2, 16)) * mask).astype(np.int32), "ilens": ilens,
            "ys": (rng.normal(size=(2, t, 8)) * (np.arange(t)[None, :, None] < olens[:, None, None])).astype(
                np.float32), "olens": olens, "ds": ds.astype(np.int32),
            "ps": rng.normal(size=(2, 16, 1)).astype(np.float32), "es": rng.normal(size=(2, 16, 1)).astype(np.float32)}


def _run(make, trainer_type, crits, batch, mesh, device):
    torch.manual_seed(0)
    model = make(device)
    t = Trainer({**CONFIG, "trainer_type": trainer_type}, model, {n: LOSS_REGISTRY[n]() for n in crits},
                get_loss_fn(trainer_type), None, outdir="exp", seed=0, mesh=mesh)
    t.init_state()
    for _ in range(2):
        t.train_step(batch)
    return t.history, {k: v.clone() for k, v in t.model.state_dict().items()}


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda),
])
def test_a_world_of_one_is_the_plain_step_bit_for_bit(device, tmp_path, monkeypatch):
    if device == "cuda":
        _card()
    monkeypatch.chdir(tmp_path)
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = get_mesh(1, 1, device_type=device)
        for make, trainer_type, crits, batch in (
            (lambda dev: E2TTS(**E2, attn_backend="flash", device=dev,
                               dtype=torch.bfloat16 if dev == "cuda" else torch.float32), "E2TTSTrainer", (),
             _e2_batch()),
            (lambda dev: FastSpeech2(**FS2, device=dev), "FastSpeech2Trainer",
             ("MelLoss", "DurationPredictorLoss", "PitchLoss", "EnergyLoss"), _fs2_batch()),
        ):
            plain = _run(make, trainer_type, crits, batch, None, device)
            ranked = _run(make, trainer_type, crits, batch, mesh, device)
            assert plain[0] == ranked[0], trainer_type
            assert plain[1].keys() == ranked[1].keys()
            for k in plain[1]:
                assert torch.equal(plain[1][k], ranked[1][k]), (trainer_type, k)
    finally:
        dist.destroy_process_group()
