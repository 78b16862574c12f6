"""Non-causal WaveNet with global conditioning (counterpart of
jatts_tpu/modules/wavenet.py).

Channel-first ``[B, C, T]`` throughout, as torch's Conv1d; masks ``[B, 1,
T]``, the global vector ``g [B, C_g, 1]``. Weight normalization is the
explicit reparametrisation ``w = g · v / max(‖v‖, 1e-12)``, the norm per
output channel, with the reference's keys ``weight_g [out, 1, 1]`` and
``weight_v [out, in, k]``, which ``jatts_tpu/utils/torch_import.py:_wn_conv``
reads (``torch.nn.utils.parametrizations.weight_norm`` would name them
``parametrizations.weight.original0/1``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.modules.dropout import Dropout


class WNConv(nn.Module):
    """1-D convolution with optional weight normalization and ``SAME``
    padding ``(k - 1) // 2 · dilation`` on each side."""

    # for utils/initialize.py: v is a torch [out, in, k] weight; g is a
    # per-channel scale (flax's 1-dim ``g``), left as it is
    INIT_RULES = {"weight_v": "torch_layout", "weight_g": "keep", "weight": "torch_layout"}
    compute_dtype: Optional[torch.dtype] = None  # modules/layers.py; set by the model

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 1,
        dilation: int = 1,
        bias: bool = True,
        use_weight_norm: bool = True,
    ):
        super().__init__()
        self.dilation = dilation
        self.padding = (kernel_size - 1) // 2 * dilation
        v = torch.randn(out_channels, in_channels, kernel_size) * math.sqrt(2.0 / (in_channels * kernel_size))
        if use_weight_norm:
            self.weight_v = nn.Parameter(v)
            self.weight_g = nn.Parameter(v.flatten(1).norm(dim=1).reshape(-1, 1, 1))
        else:
            self.weight = nn.Parameter(v)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def kernel(self) -> torch.Tensor:
        if not hasattr(self, "weight_v"):
            return self.weight
        v = self.weight_v
        norm = v.flatten(1).norm(dim=1).clamp(min=1e-12).reshape(-1, 1, 1)
        return v * (self.weight_g / norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.conv1d(x, self.kernel(), self.bias, padding=self.padding, dilation=self.dilation)
        # the JAX module: the weight-normed kernel in float32, then the
        # convolution in the compute dtype and the bias added after it
        y = F.conv1d(x.to(dt), self.kernel().to(dt), None, padding=self.padding, dilation=self.dilation)
        return y if self.bias is None else y + self.bias.to(dt)[None, :, None]


class ResidualBlock(nn.Module):
    """Gated residual block: dropout -> dilated conv -> (+ global) ->
    tanh · sigmoid -> 1x1 to residual and skip, masked."""

    def __init__(
        self,
        kernel_size: int,
        residual_channels: int,
        gate_channels: int,
        skip_channels: int,
        dilation: int = 1,
        global_channels: int = -1,
        dropout_rate: float = 0.0,
        use_weight_norm: bool = True,
    ):
        super().__init__()
        self.residual_channels = residual_channels
        self.dropout = Dropout(dropout_rate)
        self.conv = WNConv(residual_channels, gate_channels, kernel_size, dilation,
                           use_weight_norm=use_weight_norm)
        if global_channels > 0:
            self.conv1x1_glo = WNConv(global_channels, gate_channels, 1, bias=False,
                                      use_weight_norm=use_weight_norm)
        self.conv1x1_out = WNConv(gate_channels // 2, residual_channels + skip_channels, 1,
                                  use_weight_norm=use_weight_norm)

    def forward(
        self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None, g: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.conv(self.dropout(x))
        xa, xb = h.chunk(2, dim=1)
        if g is not None:
            ga, gb = self.conv1x1_glo(g).chunk(2, dim=1)
            xa, xb = xa + ga, xb + gb
        h = self.conv1x1_out(torch.tanh(xa) * torch.sigmoid(xb))
        if x_mask is not None:
            h = h * x_mask
        xr, s = h.split([self.residual_channels, h.shape[1] - self.residual_channels], dim=1)
        return xr + x, s


class WaveNet(nn.Module):
    """Stacked residual blocks, the skip sum as output (scaled by
    ``sqrt(1 / layers)``); layer i has dilation ``base_dilation ** (i %
    layers_per_stack)``."""

    def __init__(
        self,
        kernel_size: int = 5,
        layers: int = 16,
        stacks: int = 1,
        base_dilation: int = 1,
        residual_channels: int = 192,
        gate_channels: int = 384,
        skip_channels: int = 192,
        global_channels: int = -1,
        dropout_rate: float = 0.0,
        use_weight_norm: bool = True,
        scale_skip_connect: bool = True,
    ):
        super().__init__()
        per_stack = layers // stacks
        self.scale = math.sqrt(1.0 / layers) if scale_skip_connect else 1.0
        self.conv_layers = nn.ModuleList(
            ResidualBlock(
                kernel_size, residual_channels, gate_channels, skip_channels,
                base_dilation ** (i % per_stack), global_channels, dropout_rate, use_weight_norm,
            )
            for i in range(layers)
        )

    def forward(
        self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None, g: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        skips = 0.0
        for layer in self.conv_layers:
            x, s = layer(x, x_mask, g)
            skips = skips + s
        return skips * self.scale
