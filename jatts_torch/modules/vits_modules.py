"""VITS submodules: text encoder, posterior encoder, residual coupling flow
(counterpart of jatts_tpu/modules/vits_modules.py).

The text and posterior encoders and the flow block take and return
feature-last tensors ``[B, T, C]`` with masks ``[B, T, 1]`` and the global
vector ``g [B, 1, C_g]``, as the JAX modules do; the WaveNets inside run
channel-first, and so does a coupling layer (``[B, C, T]``, mask ``[B, 1,
T]``, ``g [B, C_g, 1]``). Keys as the reference: ``emb``, ``encoder``,
``proj``; ``input_conv``, ``encoder.conv_layers.{i}``, ``proj``; the flow's
couplings at ``flows.{0,2,4,6}``, parameter-free flips between them.

The posterior encoder's ``eps`` comes from its ``noise_generator`` (a
trainer sets it, ``modules/noise.py``) unless it is given; the draws are
not jax.random's bits, so a parity test injects them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from jatts_torch.modules.conformer import ConformerEncoder
from jatts_torch.modules.layers import Conv1d
from jatts_torch.modules.wavenet import WaveNet
from jatts_torch.ops.masks import attn_mask, sequence_mask
from jatts_torch.parallel.mesh import draw


def _cf(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Feature-last <-> channel-first."""
    return None if x is None else x.transpose(1, 2)


class TextEncoder(nn.Module):
    """Embed (· sqrt(d)) -> conformer -> 1x1 projection to (m, logs)."""

    def __init__(
        self,
        vocabs: int,
        attention_dim: int = 192,
        attention_heads: int = 2,
        linear_units: int = 768,
        blocks: int = 6,
        positionwise_conv_kernel_size: int = 3,
        use_macaron_style: bool = False,
        use_conformer_conv: bool = False,
        conformer_kernel_size: int = 7,
        dropout_rate: float = 0.1,
        positional_dropout_rate: float = 0.0,
        attention_dropout_rate: float = 0.0,
        pos_enc_layer_type: str = "rel_pos",
        selfattention_layer_type: str = "rel_selfattn",
    ):
        super().__init__()
        self.attention_dim = attention_dim
        self.emb = nn.Embedding(vocabs, attention_dim)
        nn.init.normal_(self.emb.weight, std=attention_dim ** -0.5)
        self.encoder = ConformerEncoder(
            attention_dim=attention_dim, attention_heads=attention_heads, linear_units=linear_units,
            num_blocks=blocks, input_layer=None,
            positionwise_conv_kernel_size=positionwise_conv_kernel_size,
            macaron_style=use_macaron_style, use_cnn_module=use_conformer_conv,
            cnn_module_kernel=conformer_kernel_size, pos_enc_layer_type=pos_enc_layer_type,
            selfattention_layer_type=selfattention_layer_type, dropout_rate=dropout_rate,
            positional_dropout_rate=positional_dropout_rate, attention_dropout_rate=attention_dropout_rate,
        )
        self.proj = Conv1d(attention_dim, attention_dim * 2, 1)

    def forward(self, xs: torch.Tensor, ilens: torch.Tensor):
        """xs [B, T_text] ids -> (h [B, T, d], m, logs [B, T, d], mask [B, T, 1]).
        The embedding is scaled by sqrt(d) here and again inside the
        rel-pos encoding, as in the JAX package and the reference."""
        t_text = xs.shape[1]
        emb = self.emb(xs) * math.sqrt(self.attention_dim)
        h = self.encoder(emb, attn_mask(ilens, t_text))
        mask = sequence_mask(ilens, t_text, h.dtype)[..., None]
        stats = self.proj.pointwise(h) * mask
        m, logs = stats.chunk(2, dim=-1)
        return h, m, logs, mask


class PosteriorEncoder(nn.Module):
    """1x1 conv -> WaveNet -> 1x1 projection -> z = (m + eps · exp(logs)) · mask."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int = 192,
        hidden_channels: int = 192,
        kernel_size: int = 5,
        layers: int = 16,
        stacks: int = 1,
        base_dilation: int = 1,
        global_channels: int = -1,
        dropout_rate: float = 0.0,
        use_weight_norm: bool = True,
    ):
        super().__init__()
        self.input_conv = Conv1d(in_channels, hidden_channels, 1)
        self.encoder = WaveNet(
            kernel_size=kernel_size, layers=layers, stacks=stacks, base_dilation=base_dilation,
            residual_channels=hidden_channels, gate_channels=hidden_channels * 2,
            skip_channels=hidden_channels, global_channels=global_channels,
            dropout_rate=dropout_rate, use_weight_norm=use_weight_norm,
        )
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)
        self.noise_generator: Optional[torch.Generator] = None

    def forward(
        self,
        ys: torch.Tensor,
        olens: torch.Tensor,
        g: Optional[torch.Tensor] = None,
        eps: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """ys [B, T, odim] -> (z, m, logs [B, T, out], mask [B, T, 1]);
        ``eps`` [B, T, out] ~ N(0, 1), drawn from ``noise_generator`` unless given."""
        mask = sequence_mask(olens, ys.shape[1], ys.dtype)[:, None, :]
        h = self.input_conv(_cf(ys)) * mask
        h = self.encoder(h, mask, _cf(g))
        stats = self.proj(h) * mask
        m, logs = stats.chunk(2, dim=1)
        if eps is None:
            eps = draw(lambda s: torch.randn(s, generator=self.noise_generator, device=m.device, dtype=m.dtype),
                       m.shape)
        else:
            eps = _cf(eps)
        z = (m + eps * torch.exp(logs)) * mask
        return _cf(z), _cf(m), _cf(logs), _cf(mask)


class ResidualAffineCouplingLayer(nn.Module):
    """Half-channel affine coupling conditioned by a WaveNet; channel-first.
    ``proj`` starts at zero, so a fresh layer is the identity."""

    def __init__(
        self,
        half_channels: int,
        hidden_channels: int = 192,
        kernel_size: int = 5,
        base_dilation: int = 1,
        layers: int = 4,
        global_channels: int = -1,
        dropout_rate: float = 0.0,
        use_weight_norm: bool = True,
        use_only_mean: bool = True,
    ):
        super().__init__()
        self.use_only_mean = use_only_mean
        self.input_conv = Conv1d(half_channels, hidden_channels, 1)
        self.encoder = WaveNet(
            kernel_size=kernel_size, layers=layers, stacks=1, base_dilation=base_dilation,
            residual_channels=hidden_channels, gate_channels=hidden_channels * 2,
            skip_channels=hidden_channels, global_channels=global_channels,
            dropout_rate=dropout_rate, use_weight_norm=use_weight_norm,
        )
        self.proj = Conv1d(hidden_channels, half_channels * (1 if use_only_mean else 2), 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(
        self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None, inverse: bool = False
    ):
        """Forward: (y, logdet [B]); inverse: x."""
        xa, xb = x.chunk(2, dim=1)
        h = self.input_conv(xa) * x_mask
        h = self.encoder(h, x_mask, g)
        stats = self.proj(h) * x_mask
        if self.use_only_mean:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats.chunk(2, dim=1)
        if not inverse:
            xb = m + xb * torch.exp(logs) * x_mask
            return torch.cat([xa, xb], dim=1), logs.sum(dim=(1, 2))
        xb = (xb - m) * torch.exp(-logs) * x_mask
        return torch.cat([xa, xb], dim=1)


class FlipFlow(nn.Module):
    """Reverses the channels; no parameters (the reference's odd ``flows``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flip(x, [1])


class ResidualAffineCouplingBlock(nn.Module):
    """``flows`` x (coupling, flip). Forward maps the posterior's z to z_p;
    the inverse flips before each coupling, in reverse order."""

    def __init__(
        self,
        in_channels: int = 192,
        hidden_channels: int = 192,
        flows: int = 4,
        kernel_size: int = 5,
        base_dilation: int = 1,
        layers: int = 4,
        global_channels: int = -1,
        dropout_rate: float = 0.0,
        use_weight_norm: bool = True,
        use_only_mean: bool = True,
    ):
        super().__init__()
        mods = []
        for _ in range(flows):
            mods.append(ResidualAffineCouplingLayer(
                in_channels // 2, hidden_channels, kernel_size, base_dilation, layers,
                global_channels, dropout_rate, use_weight_norm, use_only_mean,
            ))
            mods.append(FlipFlow())
        self.flows = nn.ModuleList(mods)

    def forward(
        self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None, inverse: bool = False
    ) -> torch.Tensor:
        """x [B, T, C], x_mask [B, T, 1], g [B, 1, C_g] -> [B, T, C]."""
        x, x_mask, g = _cf(x), _cf(x_mask), _cf(g)
        couplings, flips = self.flows[0::2], self.flows[1::2]
        if not inverse:
            for layer, flip in zip(couplings, flips):
                x, _ = layer(x, x_mask, g)
                x = flip(x)
        else:
            for layer, flip in zip(reversed(couplings), reversed(flips)):
                x = layer(flip(x), x_mask, g, inverse=True)
        return _cf(x)
