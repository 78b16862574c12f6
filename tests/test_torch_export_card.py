"""The kernels' ``torch.library`` ops and the ``torch.export`` serving
artifact on the card (marked ``cuda``: they skip without one). This file
imports no jax and no flax, so it runs where the card is:

    python -m pytest tests/test_torch_export_card.py -m cuda -q

``opcheck`` on the CUDA implementations of ``jatts::flash_attn_fwd`` (with
its gradient through ``jatts::flash_attn_bwd_dkv`` and
``jatts::flash_attn_bwd_dq``) at the JSUT bucket's shape and of the MAS ops
at an aligner shape; an artifact exported on the CPU loaded and replayed on
the card, within tolerance of the card's own export (whose replay equals
the in-process eager program bit for bit), and the card's export loaded on
the CPU; a seeded call that leaves torch's random state as it found it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.models.fastspeech2 import FastSpeech2  # noqa: E402
from jatts_torch.models.matchatts import MatchaTTS  # noqa: E402
from jatts_torch.ops import flash_attention as k1  # noqa: E402
from jatts_torch.ops import mas  # noqa: E402
from jatts_torch.serving import ServingBundle, build_infer_fn, export_bundle, load_bundle  # noqa: E402
from jatts_torch.serving.bundle import inference_kwargs  # noqa: E402

NMELS, MAX_FRAMES, BATCH, BUCKETS = 16, 64, 4, (16, 32)
# adim 128 over 2 heads: d 64, a width the kernels take
FS2 = dict(idim=20, odim=NMELS, adim=128, aheads=2, elayers=2, eunits=128, dlayers=2, dunits=128,
           postnet_layers=0, duration_predictor_chans=32, pitch_predictor_chans=32, energy_predictor_chans=32,
           conformer_enc_kernel_size=7, conformer_dec_kernel_size=7)
MATCHA = dict(idim=20, odim=NMELS, adim=128, aheads=2, elayers=1, eunits=128, duration_predictor_chans=32,
              decoder_channels=(32, 32), decoder_attention_head_dim=16, decoder_num_heads=2,
              conformer_enc_kernel_size=7)
REQUESTS = [[3, 4, 5, 6, 7, 8, 9, 10, 11, 2, 3], [1, 2, 3], [5] * 20]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _model(cls, params, device, seed=0):
    torch.manual_seed(seed)
    extra = {"attn_backend": "flash"} if cls is FastSpeech2 else {}  # Matcha's encoder has no flash branch
    model = cls(**params, **extra, device="cpu").eval()
    with torch.no_grad():
        model.duration_predictor.linear.bias.fill_(float(np.log(2.0)))
    return model.to(device)


def _stats(seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=NMELS).astype(np.float32), rng.uniform(0.5, 2.0, NMELS).astype(np.float32)


def _export(path, model, params, platforms=("cuda",)):
    mean, scale = _stats()
    config = {"model_type": type(model).__name__, "model_params": params, "ode_steps": 3}
    fn, w = build_infer_fn(config, model, mean, scale, MAX_FRAMES)
    meta = {"model_type": config["model_type"], "model_params": params, "num_mels": NMELS, "hop_size": 256,
            "max_frames": MAX_FRAMES, "output": "mel"}
    return export_bundle(str(path), fn, BATCH, BUCKETS, meta, platforms=platforms, weights=w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_ops_pass_opcheck_at_the_jsut_bucket_shape(dtype):
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, t, d = 8, 2, 128, 192  # the JSUT conf's heads at bucket 128
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    ab = torch.randn(b, h, t, t, device="cuda", generator=g).to(dtype)
    mask = torch.arange(t, device="cuda")[None, :] < torch.tensor([t, 100, 57, 1, t, 90, 64, 3], device="cuda")[:, None]
    for with_lse in (False, True):
        torch.library.opcheck(torch.ops.jatts.flash_attn_fwd.default, (q, k, v, ab, mask, d ** -0.5, False, with_lse))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, ab)]
    torch.library.opcheck(torch.ops.jatts.flash_attn_fwd.default, (*leaves, mask, d ** -0.5, False, True))
    out, lse = k1.flash_attention_fwd(q, k, v, ab, mask, d ** -0.5)
    do = torch.randn_like(out)
    di = (out.float() * do.float()).sum(-1)
    torch.library.opcheck(torch.ops.jatts.flash_attn_bwd_dkv.default, (q, k, v, ab, mask, d ** -0.5, lse, di, do, False))
    torch.library.opcheck(torch.ops.jatts.flash_attn_bwd_dq.default,
                          (q, k, v, ab, mask, d ** -0.5, lse, di, do, True, False))


@pytest.mark.cuda
def test_mas_ops_pass_opcheck_at_an_aligner_shape():
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    lp = torch.log_softmax(torch.randn(4, 400, 90, device="cuda", generator=g), -1)
    tl = torch.tensor([90, 61, 30, 7], device="cuda")
    fl = torch.tensor([400, 300, 151, 20], device="cuda")
    torch.library.opcheck(torch.ops.jatts.mas_decisions.default, (lp, tl))
    bits = mas.mas_decisions(lp, tl)
    torch.library.opcheck(torch.ops.jatts.mas_backtrace.default, (bits, tl, fl, 90))
    for return_bits in (False, True):
        torch.library.opcheck(torch.ops.jatts.mas_path.default, (lp, tl, fl, return_bits, mas.SMEM_BITS_BYTES))


@pytest.mark.cuda
def test_an_artifact_exported_on_the_cpu_runs_on_the_card(tmp_path):
    _card()
    cpu_path = _export(tmp_path / "cpu.npz", _model(FastSpeech2, FS2, "cpu"), FS2, platforms=("cuda", "cpu"))
    card_path = _export(tmp_path / "card.npz", _model(FastSpeech2, FS2, "cuda"), FS2)
    k1.reset_launches()
    from_cpu, own = load_bundle(cpu_path), load_bundle(card_path)
    assert from_cpu.device.type == own.device.type == "cuda" and sorted(from_cpu.graphs) == list(BUCKETS)
    # one K1 launch an attention layer, recorded by each capture
    assert all(c.launches.get("flash_attention.launches", 0) == FS2["elayers"] + FS2["dlayers"]
               for c in (*from_cpu.graphs.values(), *own.graphs.values()))
    got, want = from_cpu.synthesize(REQUESTS), own.synthesize(REQUESTS)
    mean, scale = _stats()
    inproc = ServingBundle(_model(FastSpeech2, FS2, "cuda"), None, mean, scale, batch_size=BATCH, buckets=BUCKETS,
                           max_frames=MAX_FRAMES, hop_size=256).synthesize(REQUESTS)
    for g, w, e in zip(got, want, inproc):
        np.testing.assert_array_equal(w["mel"], e["mel"])  # the card's replay is the eager program
        assert g["mel"].shape == w["mel"].shape
        np.testing.assert_allclose(g["mel"], w["mel"], rtol=0, atol=1e-3)  # f32 on the card, TF32 off
    # the other way round: the card's export on the CPU
    on_cpu = load_bundle(card_path, device="cpu")
    cpu_want = ServingBundle(_model(FastSpeech2, FS2, "cpu"), None, mean, scale, batch_size=BATCH, buckets=BUCKETS,
                             max_frames=MAX_FRAMES, hop_size=256).synthesize(REQUESTS)
    for g, w in zip(on_cpu.synthesize(REQUESTS), cpu_want):
        np.testing.assert_array_equal(g["mel"], w["mel"])


@pytest.mark.cuda
def test_a_seeded_replay_draws_the_eager_bits_and_keeps_the_callers_rng(tmp_path):
    _card()
    model = _model(MatchaTTS, MATCHA, "cuda")
    loaded = load_bundle(_export(tmp_path / "m.npz", model, MATCHA))
    mean, scale = _stats()
    inproc = ServingBundle(model, None, mean, scale, batch_size=BATCH, buckets=BUCKETS, max_frames=MAX_FRAMES,
                           hop_size=256, infer_kwargs=inference_kwargs({"model_type": "MatchaTTS", "ode_steps": 3}))
    torch.manual_seed(123)
    before = (torch.get_rng_state(), torch.cuda.get_rng_state())
    a, b, c = (loaded.synthesize(REQUESTS, seed=s) for s in (5, 5, 6))
    assert torch.equal(before[0], torch.get_rng_state()) and torch.equal(before[1], torch.cuda.get_rng_state())
    xs, ilens = loaded.prepare(REQUESTS)
    with torch.random.fork_rng(devices=[0]):
        torch.cuda.manual_seed(5)
        eager = loaded.program(xs, ilens)["mel"].cpu().numpy()
    for i, (x, y, w) in enumerate(zip(a, b, inproc.synthesize(REQUESTS, seed=5))):
        np.testing.assert_array_equal(x["mel"], y["mel"])
        np.testing.assert_array_equal(x["mel"], w["mel"])
        np.testing.assert_array_equal(x["mel"], eager[i, : len(x["mel"])])
    assert max(np.abs(x["mel"] - z["mel"]).max() for x, z in zip(a, c)) > 1e-3
