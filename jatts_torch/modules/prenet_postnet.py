"""Tacotron2 Postnet (counterpart of jatts_tpu/modules/prenet_postnet.py).

Keys as the reference: ``postnet.{i}.0`` (Conv1d, no bias) and
``postnet.{i}.1`` (BatchNorm1d, eps 1e-5, running statistics).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Postnet(nn.Module):
    """conv-BN-tanh residual refiner, feature-last [B, T, odim] in and out;
    the last layer has no tanh."""

    def __init__(
        self,
        odim: int,
        n_layers: int = 5,
        n_chans: int = 512,
        n_filts: int = 5,
        use_batch_norm: bool = True,
    ):
        super().__init__()
        self.postnet = nn.ModuleList()
        for i in range(n_layers):
            ichans = odim if i == 0 else n_chans
            ochans = odim if i == n_layers - 1 else n_chans
            layer = [nn.Conv1d(ichans, ochans, n_filts, padding="same", bias=False)]
            if use_batch_norm:
                layer.append(nn.BatchNorm1d(ochans, eps=1e-5))
            self.postnet.append(nn.Sequential(*layer))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        xs = xs.transpose(1, 2)
        last = len(self.postnet) - 1
        for i, layer in enumerate(self.postnet):
            xs = layer[0](xs)
            if len(layer) > 1:
                n = layer[1]
                xs = F.batch_norm(
                    xs, n.running_mean, n.running_var, n.weight, n.bias,
                    training=False, eps=n.eps,
                )
            if i < last:
                xs = torch.tanh(xs)
        return xs.transpose(1, 2)
