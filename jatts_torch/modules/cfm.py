"""Conditional flow matching (counterpart of jatts_tpu/modules/cfm.py).

OT-CFM training loss: y = (1 - (1 - sigma) t) z + t x1, u = x1 - (1 - sigma) z,
squared error of the U-Net's output against u. Inference: a fixed-step Euler
ODE from temperature-scaled noise, one estimator call a step (a Python loop
here; ``nn.scan`` there is packaging, not semantics). Feature-last: x1, mu
``[B, T, C]``, mask ``[B, T]`` float.

Noise (the loss's t and z, the sampler's z) comes from ``noise_generator``
(``None``: torch's default generator for the device), which a trainer sets
with ``modules/noise.py:set_noise_generator`` and re-seeds each step, or from the
``generator`` argument of :meth:`CFM.inference`; t and z may also be
injected. The draws are not jax.random's bits, so a parity test injects
them on both sides.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from jatts_torch.modules.matcha_decoder import MatchaDecoder
from jatts_torch.parallel.mesh import draw, global_sum


_GRIDS = {}


def euler_grid(n_timesteps: int) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """The Euler sampler's times and steps, Python floats: ``t_span[:-1]``
    and the differences of ``t_span = linspace(0, 1, n_timesteps + 1)`` in
    f32. Made once for each count, outside any trace: while ``torch.export``
    traces, the tensors are fake and hold no values, so the sampler must
    have run eagerly once with this count before it is exported."""
    if n_timesteps not in _GRIDS:
        if torch.compiler.is_exporting():
            raise RuntimeError(f"the Euler grid of {n_timesteps} steps was not made before the trace: run the "
                               "sampler once eagerly first")
        t_span = torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=torch.float32)
        _GRIDS[n_timesteps] = (tuple(t_span[:-1].tolist()), tuple((t_span[1:] - t_span[:-1]).tolist()))
    return _GRIDS[n_timesteps]


class CFM(nn.Module):
    def __init__(
        self,
        out_channels: int,
        channels: Sequence[int] = (256, 256),
        dropout_rate: float = 0.05,
        attention_head_dim: int = 64,
        n_blocks: int = 1,
        num_mid_blocks: int = 2,
        num_heads: int = 2,
        act_fn: str = "snakebeta",
        sigma_min: float = 1e-4,
    ):
        super().__init__()
        self.sigma_min = sigma_min
        self.estimator = MatchaDecoder(
            out_channels=out_channels, channels=channels, dropout_rate=dropout_rate,
            attention_head_dim=attention_head_dim, n_blocks=n_blocks,
            num_mid_blocks=num_mid_blocks, num_heads=num_heads, act_fn=act_fn,
        )
        self.noise_generator: Optional[torch.Generator] = None

    def forward(
        self,
        x1: torch.Tensor,
        mask: torch.Tensor,
        mu: torch.Tensor,
        t: Optional[torch.Tensor] = None,
        z: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training loss and the noisy sample y. ``t [B, 1, 1]`` ~ U(0, 1) and
        ``z`` ~ N(0, 1) are drawn from ``noise_generator`` unless given. The
        target u is not masked, as in the JAX package and the reference:
        padded frames add a constant (1 - sigma)^2 z^2 (the estimator masks
        its output, so no gradient flows there); the sum is divided by
        ``sum(mask) * C``."""
        b = x1.shape[0]
        if t is None:
            t = draw(lambda s: torch.rand(s, generator=self.noise_generator, device=x1.device, dtype=x1.dtype),
                     (b, 1, 1))
        if z is None:
            z = draw(lambda s: torch.randn(s, generator=self.noise_generator, device=x1.device, dtype=x1.dtype),
                     x1.shape)
        y = (1.0 - (1.0 - self.sigma_min) * t) * z + t * x1
        u = x1 - (1.0 - self.sigma_min) * z
        pred = self.estimator(y, mask, mu, t[:, 0, 0])
        loss = ((pred - u) ** 2).sum() / (global_sum(mask.sum()) * u.shape[-1]).clamp(min=1.0)
        return loss, y

    @torch.no_grad()
    def inference(
        self,
        mu: torch.Tensor,
        mask: torch.Tensor,
        n_timesteps: int,
        temperature: float = 1.0,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Euler sampler from ``z = N(0, 1) * temperature`` (drawn from
        ``generator``, else ``noise_generator``); an injected ``z`` is used
        as it is, as the JAX package uses it. The steps are the differences
        of ``linspace(0, 1, n_timesteps + 1)`` in f32."""
        if z is None:
            gen = generator if generator is not None else self.noise_generator
            z = torch.randn(mu.shape, generator=gen, device=mu.device, dtype=mu.dtype) * temperature
        x = z
        for t, dt in zip(*euler_grid(n_timesteps)):
            dphi = self.estimator(x, mask, mu, torch.full((x.shape[0],), t, device=x.device))
            x = x + dt * dphi
        return x

