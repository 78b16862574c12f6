"""mel-VITS on the card (marked ``cuda``: they skip without one). This file
imports no jax and no flax, so it runs where the card is:

    python -m pytest tests/test_torch_vits_card.py -m cuda -q

VITS's training forward takes the fused MAS search (``csrc/mas_path.cu``)
under ``mas_backend: auto``, and its durations equal the plain search's
(``scan``); the residual coupling flow and the stochastic duration
predictor's conv flow invert on the card, with their zero-initialised
projections made non-zero.
"""

import pytest

torch = pytest.importorskip("torch")

from jatts_torch.models.vits import VITS  # noqa: E402
from jatts_torch.modules.flows import ConvFlow  # noqa: E402
from jatts_torch.modules.noise import set_noise_generator  # noqa: E402
from jatts_torch.modules.vits_modules import ResidualAffineCouplingBlock  # noqa: E402
from jatts_torch.ops import mas  # noqa: E402

SMALL = dict(
    idim=25, odim=8, adim=16, aheads=2, text_encoder_blocks=1, text_encoder_ffn_expand=2, dlayers=1, dunits=32,
    duration_predictor_chans=8, posterior_encoder_layers=2, flow_flows=2, flow_layers=2,
    conformer_dec_kernel_size=7, text_encoder_dropout_rate=0.0, text_encoder_positional_dropout_rate=0.0,
    text_encoder_attention_dropout_rate=0.0, transformer_dec_dropout_rate=0.0,
    transformer_dec_positional_dropout_rate=0.0, transformer_dec_attn_dropout_rate=0.0,
    duration_predictor_dropout_rate=0.0,
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


def _randomize_projections(module, seed):
    """The couplings' and conv flows' projections start at zero (every flow
    the identity): give them values, so the checks see the flow."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if ".proj." in f".{name}" and ("flows" in name):
                p.copy_((torch.randn(p.shape, generator=g) * 0.05).to(p.device))


@pytest.mark.cuda
@pytest.mark.parametrize("predictor", ["deterministic", "stochastic"])
def test_vits_forward_on_card_takes_the_fused_search_and_equals_scan(predictor):
    _card()
    torch.manual_seed(0)
    model = VITS(**SMALL, duration_predictor_type=predictor, device="cuda").train()
    _randomize_projections(model, 1)
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
    assert torch.equal(outs["auto"]["bin_loss"], outs["scan"]["bin_loss"])
    for key in ("z_p", "outs", "m_p"):
        a, s = outs["auto"][key], outs["scan"][key]
        assert float((a - s).abs().max()) <= 1e-5 * max(1.0, float(s.abs().max())), key


@pytest.mark.cuda
def test_flow_round_trips_on_card(monkeypatch):
    """inverse(forward(z)) == z on valid frames at the JSUT width (adim
    384, 4 couplings x 4 layers), and the conv flow's, to 1e-4 of the
    largest value either direction holds; in f32 (cuDNN's TF32 off, as the
    smoke runs it: the inverse recomputes each coupling's WaveNet, whose
    TF32 rounding would not cancel)."""
    _card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    flow = ResidualAffineCouplingBlock(384, 384, 4, 5, 1, 4).cuda()
    _randomize_projections(torch.nn.ModuleDict({"flows": flow}), 2)
    assert float(flow.flows[0].proj.weight.detach().abs().max()) > 0.1
    lens = torch.tensor([256, 180], device="cuda")
    mask = (torch.arange(256, device="cuda")[None] < lens[:, None]).float()[..., None]
    z = torch.randn(2, 256, 384, device="cuda") * mask
    with torch.no_grad():
        z_p = flow(z, mask)
        back = flow(z_p, mask, inverse=True)
    assert float((z_p - z).abs().max()) > 0.1
    scale = max(1.0, float(z.abs().max()), float(z_p.abs().max()))
    assert float((back - z).abs().max()) <= 1e-4 * scale

    cflow = ConvFlow(2, 384, 3, 3).cuda()
    with torch.no_grad():
        cflow.proj.weight.normal_(0.0, 0.3)
    mask_cf = mask.transpose(1, 2)
    x = torch.randn(2, 2, 256, device="cuda") * 2.0 * mask_cf
    g = torch.randn(2, 384, 256, device="cuda")
    with torch.no_grad():
        y, _ = cflow(x, mask_cf, g)
        back = cflow(y, mask_cf, g, inverse=True)
    assert float((y - x).abs().max()) > 0.1
    scale = max(1.0, float(x.abs().max()), float(y.abs().max()))
    assert float((back - x).abs().max()) <= 1e-4 * scale
