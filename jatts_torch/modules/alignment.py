"""Alignment learning module (counterpart of jatts_tpu/modules/alignment.py).

Text/feat conv embeddings -> negative L2 distance -> log-softmax attention.
The Viterbi search over the resulting lattice lives in jatts_torch.ops.mas.
Keys as the reference: ``t_conv1``, ``t_conv2``, ``f_conv1``..``f_conv3``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.modules.layers import Conv1d

_MASK_VAL = -1e9


class AlignmentModule(nn.Module):
    def __init__(self, adim: int, odim: int):
        super().__init__()
        self.t_conv1 = Conv1d(adim, adim, 3, padding=1)
        self.t_conv2 = Conv1d(adim, adim, 1)
        self.f_conv1 = Conv1d(odim, adim, 3, padding=1)
        self.f_conv2 = Conv1d(adim, adim, 3, padding=1)
        self.f_conv3 = Conv1d(adim, adim, 1)

    def forward(self, text, feats, x_masks=None):
        """text: [B, T_text, adim]; feats: [B, T_feats, odim];
        x_masks: [B, T_text] True on VALID tokens.
        Returns log_p_attn [B, T_feats, T_text], f32."""
        t = F.relu(self.t_conv1(text.transpose(1, 2)))
        t = self.t_conv2(t).transpose(1, 2)

        f = F.relu(self.f_conv1(feats.transpose(1, 2)))
        f = F.relu(self.f_conv2(f))
        f = self.f_conv3(f).transpose(1, 2)

        # -||f_i - t_j||_2 via the expanded quadratic form: one batched
        # matmul instead of a [B, T_feats, T_text, adim] broadcast. It
        # cancels near 0, so the product is taken in f32 (and wants TF32
        # off); the squared norms in the convolutions' dtype, as the JAX
        # module takes them.
        f2 = (f ** 2).sum(-1)[:, :, None]
        t2 = (t ** 2).sum(-1)[:, None, :]
        ft = torch.matmul(f.float(), t.float().transpose(1, 2))
        dist_sq = (f2 - 2.0 * ft + t2).clamp(min=0.0)
        score = -torch.sqrt(dist_sq + 1e-12)

        if x_masks is not None:
            score = score.masked_fill(~x_masks[:, None, :], _MASK_VAL)
        return F.log_softmax(score, dim=-1)
