"""Matcha-TTS on the card (marked ``cuda``: they skip without one). This file
imports no jax and no flax, so it runs where the card is:

    python -m pytest tests/test_torch_matcha_card.py -m cuda -q

MatchaTTS_MAS's training forward takes the fused MAS search
(``csrc/mas_path.cu``) under ``mas_backend: auto``, and its durations and
losses equal the plain search's (``scan``); the serving bundle's seed fixes
the ODE noise on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jatts_torch.models.matchatts import MatchaTTS  # noqa: E402
from jatts_torch.models.matchatts_mas import MatchaTTS_MAS  # noqa: E402
from jatts_torch.modules.noise import set_noise_generator  # noqa: E402
from jatts_torch.ops import mas  # noqa: E402
from jatts_torch.serving import ServingBundle  # noqa: E402
from jatts_torch.vocoder.hifigan import HiFiGANGenerator  # noqa: E402

SMALL = dict(
    idim=25, odim=8, adim=16, aheads=2, elayers=1, eunits=32, duration_predictor_chans=8,
    decoder_channels=(16, 16), decoder_attention_head_dim=8, decoder_num_heads=2,
    transformer_enc_dropout_rate=0.0, transformer_enc_positional_dropout_rate=0.0,
    transformer_enc_attn_dropout_rate=0.0, duration_predictor_dropout_rate=0.0, decoder_dropout=0.0,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _batch(seed=0, b=4, t_text=24, t_feats=192):
    g = torch.Generator().manual_seed(seed)
    ilens = torch.tensor([24, 17, 9, 1][:b])
    olens = torch.tensor([192, 151, 40, 7][:b])
    xs = torch.randint(1, SMALL["idim"], (b, t_text), generator=g) * (torch.arange(t_text)[None] < ilens[:, None])
    ys = torch.randn(b, t_feats, SMALL["odim"], generator=g)
    return {k: v.cuda() for k, v in dict(xs=xs, ilens=ilens, ys=ys, olens=olens).items()}


@pytest.mark.cuda
def test_mas_forward_on_card_takes_the_fused_search_and_equals_scan():
    _card()
    torch.manual_seed(0)
    model = MatchaTTS_MAS(**SMALL, device="cuda").train()
    batch = _batch()
    outs = {}
    for backend in ("auto", "scan"):
        model.mas_backend = backend
        set_noise_generator(model, torch.Generator(device="cuda").manual_seed(3))
        mas.reset_launches()
        with torch.no_grad():
            outs[backend] = model(**batch)
        torch.cuda.synchronize()
        assert mas.path_launches == (1 if backend == "auto" else 0)
        assert mas.fwd_launches == mas.backtrace_launches == 0
    assert torch.equal(outs["auto"]["ds"], outs["scan"]["ds"])
    assert torch.equal(outs["auto"]["ds"].sum(1).long(), batch["olens"])
    for key in ("cfm_loss", "bin_loss", "hs"):
        assert torch.equal(outs["auto"][key], outs["scan"][key]), key


@pytest.mark.cuda
def test_bundle_seed_on_card():
    _card()
    torch.manual_seed(0)
    model = MatchaTTS(**SMALL, device="cuda")
    with torch.no_grad():
        model.duration_predictor.linear.bias.fill_(float(np.log(3.0)))
    voc = HiFiGANGenerator(in_channels=8, channels=16, upsample_scales=(3, 2), upsample_kernel_sizes=(6, 4),
                           resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), device="cuda")
    bundle = ServingBundle(model, voc, np.zeros(8, np.float32), np.ones(8, np.float32), batch_size=2,
                           buckets=[16], max_frames=64, wav_format="f32", infer_kwargs={"n_timesteps": 3})
    ids = [[2, 3, 4, 5], [3, 4, 5]]
    a, b, c = (bundle.synthesize(ids, seed=s) for s in (1, 1, 2))
    assert all(len(r["wav"]) > 0 for r in a)
    np.testing.assert_array_equal(a[0]["wav"], b[0]["wav"])
    assert np.abs(a[0]["mel"] - c[0]["mel"]).max() > 1e-6
