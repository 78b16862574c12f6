"""Tacotron2 Postnet (counterpart of jatts_tpu/modules/prenet_postnet.py).

Keys as the reference: ``postnet.{i}.0`` (Conv1d, no bias) and
``postnet.{i}.1`` (BatchNorm1d, eps 1e-5). The mode follows
``self.training``: in training the BatchNorm uses batch statistics with
flax's update (``modules/batchnorm.py``) and every layer ends in dropout
(after the tanh, and after the last BatchNorm), as in the JAX module.
"""

from __future__ import annotations

import torch
from torch import nn

from jatts_torch.modules.batchnorm import BatchNorm1d
from jatts_torch.modules.dropout import Dropout


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
        dropout_rate: float = 0.5,
    ):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.postnet = nn.ModuleList()
        for i in range(n_layers):
            ichans = odim if i == 0 else n_chans
            ochans = odim if i == n_layers - 1 else n_chans
            layer = [nn.Conv1d(ichans, ochans, n_filts, padding="same", bias=False)]
            if use_batch_norm:
                layer.append(BatchNorm1d(ochans, eps=1e-5))
            self.postnet.append(nn.Sequential(*layer))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        xs = xs.transpose(1, 2)
        last = len(self.postnet) - 1
        for i, layer in enumerate(self.postnet):
            xs = layer(xs)  # conv, then BatchNorm when use_batch_norm
            if i < last:
                xs = torch.tanh(xs)
            xs = self.dropout(xs)
        return xs.transpose(1, 2)
