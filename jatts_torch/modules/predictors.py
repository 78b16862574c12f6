"""Duration / variance predictors (counterpart of jatts_tpu/modules/predictors.py).

Keys as the reference: ``conv.{i}.0`` (Conv1d), ``conv.{i}.2`` (LayerNorm
over channels), ``linear``. Feature-last [B, T, C] in and out. In training
each layer ends in dropout (``conv.{i}.3``, no parameters), as in the JAX
modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.modules.dropout import Dropout


class ConvReluNormStack(nn.ModuleList):
    """conv -> relu -> LayerNorm -> dropout, ``n_layers`` times (the
    reference's Sequential(Conv1d, ReLU, LayerNorm, Dropout) per layer)."""

    def __init__(
        self, idim: int, n_layers: int, n_chans: int, kernel_size: int, dropout_rate: float = 0.0
    ):
        super().__init__(
            nn.Sequential(
                nn.Conv1d(idim if i == 0 else n_chans, n_chans, kernel_size, padding="same"),
                nn.ReLU(),
                nn.LayerNorm(n_chans, eps=1e-5),
                Dropout(dropout_rate),
            )
            for i in range(n_layers)
        )

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        for conv, _, norm, drop in self:
            xs = drop(norm(F.relu(conv(xs.transpose(1, 2)).transpose(1, 2))))
        return xs


class DurationPredictor(nn.Module):
    """Log-domain duration predictor, output [B, T]; use
    ``ops.upsample.predicted_durations_to_int`` at inference."""

    def __init__(
        self, idim: int, n_layers: int = 2, n_chans: int = 384, kernel_size: int = 3,
        dropout_rate: float = 0.1,
    ):
        super().__init__()
        self.conv = ConvReluNormStack(idim, n_layers, n_chans, kernel_size, dropout_rate)
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs, x_masks=None):
        xs = self.linear(self.conv(xs))[..., 0]
        return xs if x_masks is None else xs * x_masks.to(xs.dtype)


class VariancePredictor(nn.Module):
    """Pitch/energy predictor, output [B, T, 1]; x_masks: [B, T, 1]."""

    def __init__(
        self, idim: int, n_layers: int = 2, n_chans: int = 384, kernel_size: int = 3,
        dropout_rate: float = 0.5,
    ):
        super().__init__()
        self.conv = ConvReluNormStack(idim, n_layers, n_chans, kernel_size, dropout_rate)
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs, x_masks=None):
        xs = self.linear(self.conv(xs))
        return xs if x_masks is None else xs * x_masks.to(xs.dtype)
