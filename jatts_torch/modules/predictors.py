"""Duration / variance predictors (counterpart of jatts_tpu/modules/predictors.py).

Keys as the reference: ``conv.{i}.0`` (Conv1d), ``conv.{i}.2`` (LayerNorm
over channels), ``linear``. Feature-last [B, T, C] in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvReluNormStack(nn.ModuleList):
    """conv -> relu -> LayerNorm, ``n_layers`` times (the reference's
    Sequential(Conv1d, ReLU, LayerNorm, Dropout) per layer; dropout is a
    training concern)."""

    def __init__(self, idim: int, n_layers: int, n_chans: int, kernel_size: int):
        super().__init__(
            nn.Sequential(
                nn.Conv1d(idim if i == 0 else n_chans, n_chans, kernel_size, padding="same"),
                nn.ReLU(),
                nn.LayerNorm(n_chans, eps=1e-5),
            )
            for i in range(n_layers)
        )

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        for conv, _, norm in self:
            xs = norm(F.relu(conv(xs.transpose(1, 2)).transpose(1, 2)))
        return xs


class DurationPredictor(nn.Module):
    """Log-domain duration predictor, output [B, T]; use
    ``ops.upsample.predicted_durations_to_int`` at inference."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384, kernel_size: int = 3):
        super().__init__()
        self.conv = ConvReluNormStack(idim, n_layers, n_chans, kernel_size)
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs, x_masks=None):
        xs = self.linear(self.conv(xs))[..., 0]
        return xs if x_masks is None else xs * x_masks.to(xs.dtype)


class VariancePredictor(nn.Module):
    """Pitch/energy predictor, output [B, T, 1]; x_masks: [B, T, 1]."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384, kernel_size: int = 3):
        super().__init__()
        self.conv = ConvReluNormStack(idim, n_layers, n_chans, kernel_size)
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, xs, x_masks=None):
        xs = self.linear(self.conv(xs))
        return xs if x_masks is None else xs * x_masks.to(xs.dtype)
