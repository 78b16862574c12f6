"""BatchNorm over channels-first ``[B, C, T]`` with flax's training rule
(counterpart of ``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` as the
JAX package's conformer and postnet use it).

A subclass of ``nn.BatchNorm1d`` only so that the state_dict keys stay the
reference's (``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``). In eval mode it is torch's batch norm on the
running statistics. In training it differs from torch's in two places:

- the statistics are flax's: the mean and the **biased** variance
  ``E[x²] - E[x]²`` (clipped at 0) over (B, T), padding frames included,
  computed in f32; torch updates its running variance with the unbiased one;
- the running update is flax's ``running = momentum·running +
  (1 - momentum)·batch`` with ``momentum = 0.9`` (torch's ``momentum=0.1``
  names the other factor).

Under a compute dtype (``modules/layers.py``, flax's ``dtype``) it
normalises in float32 in both modes and returns the compute dtype.

The training statistics are sums over a count (``sum x / n``, ``sum x² /
n``); under a mesh (``parallel/mesh.py``) the sums and the count are the
world's, with the gradient flowing back through the reduction, so every
rank normalises with, and updates its running statistics to, the global
batch's statistics (under sequence parallelism, its frames').
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.parallel.mesh import all_reduce_sum, global_sum


class BatchNorm1d(nn.BatchNorm1d):
    def __init__(self, num_features: int, eps: float = 1e-5, flax_momentum: float = 0.9):
        super().__init__(num_features, eps=eps)
        self.flax_momentum = flax_momentum
        self.compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if not self.training:
            if dt is None:
                return F.batch_norm(
                    x, self.running_mean, self.running_var, self.weight, self.bias,
                    training=False, eps=self.eps,
                )
            return F.batch_norm(
                x.float(), self.running_mean.float(), self.running_var.float(), self.weight.float(),
                self.bias.float(), training=False, eps=self.eps,
            ).to(dt)
        xf = x.float()
        sums = all_reduce_sum(torch.stack([xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))]))
        count = global_sum(torch.tensor(float(xf.shape[0] * xf.shape[2]), device=xf.device))
        mean = sums[0] / count
        var = (sums[1] / count - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean.to(self.running_mean.dtype), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.to(self.running_var.dtype), alpha=1.0 - m)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[None, :, None]) * mul[None, :, None] + self.bias.float()[None, :, None]
        return y.to(x.dtype if dt is None else dt)
