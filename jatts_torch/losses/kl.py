"""VITS KL divergence losses (counterpart of jatts_tpu/losses/kl.py)."""

from __future__ import annotations

import torch

from jatts_torch.parallel.mesh import global_mean, global_sum


class KLDivergenceLoss:
    """KL of the posterior's flow image against the prior, summed over
    channels and valid frames and divided by the number of valid frames
    (``sum(z_mask)``), not frames x channels. Channel-first ``[B, H, T]``
    like the reference; ``z_mask`` ``[B, 1, T]``."""

    def __call__(self, z_p, logs_q, m_p, logs_p, z_mask):
        z_p, logs_q, m_p, logs_p = (t.float() for t in (z_p, logs_q, m_p, logs_p))
        z_mask = z_mask.float()
        kl = logs_p - logs_q - 0.5
        kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
        return (kl * z_mask).sum() / global_sum(z_mask.sum()).clamp(min=1.0)


class KLDivergenceLossWithoutFlow:
    """Gaussian-Gaussian KL, a plain mean over every element."""

    def __call__(self, m_q, logs_q, m_p, logs_p):
        v_q = torch.exp(2.0 * logs_q)
        v_p = torch.exp(2.0 * logs_p)
        kl = logs_p - logs_q + (v_q + (m_q - m_p) ** 2) / (2.0 * v_p) - 0.5
        return global_mean(kl)
