"""Normalizing flows of the stochastic duration predictor (counterpart of
jatts_tpu/modules/flows.py).

The piecewise rational-quadratic spline is vectorised with masks: the bin
of each input is a count of the knots at or below it, gathered with
``torch.gather``, and the identity applies outside the tail bound. The
flows run channel-first (``[B, C, T]``, masks ``[B, 1, T]``);
:class:`StochasticDurationPredictor` takes feature-last tensors as the JAX
module does. Keys are the port's own (no importer of reference checkpoints
reads them): ``pre``, ``dds.{dw,norm1,pw,norm2}.{i}``, ``proj``,
``flows.{0..n}`` (0: the elementwise affine flow, then the conv flows; the
flips between them have no parameters) and their ``post_`` twins.

Training noise ``e_q`` comes from ``noise_generator`` (``modules/noise.py``)
and the inference draw from a ``generator`` argument, unless given.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.modules.dropout import Dropout
from jatts_torch.parallel.mesh import draw

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3
_LOG_2PI = math.log(2.0 * math.pi)
# the models' duration_predictor_type: the conv predictor or this module's flow
DURATION_PREDICTOR_TYPES = ("deterministic", "stochastic")


def _knots(unnorm: torch.Tensor, min_bin: float, lo: float, hi: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax bin sizes (at least ``min_bin`` of the range) -> knots
    ``[..., bins + 1]`` pinned to ``lo`` and ``hi``, and the bin sizes."""
    num_bins = unnorm.shape[-1]
    sizes = min_bin + (1 - min_bin * num_bins) * torch.softmax(unnorm, dim=-1)
    cum = (hi - lo) * F.pad(torch.cumsum(sizes, dim=-1), (1, 0)) + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1], torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnorm_widths: torch.Tensor,
    unnorm_heights: torch.Tensor,
    unnorm_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 5.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """'Linear-tails' monotone RQ spline of ``inputs [...]`` over the bins of
    the last axis of the parameters ``[..., bins]`` (derivatives ``[...,
    bins - 1]``, padded with the boundary constant). Returns the outputs
    and log |det|, both shaped as ``inputs``."""
    num_bins = unnorm_widths.shape[-1]
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    x = inputs.clamp(-tail_bound, tail_bound)

    constant = math.log(math.exp(1.0 - min_derivative) - 1.0)
    derivatives = min_derivative + F.softplus(F.pad(unnorm_derivatives, (1, 1), value=constant))
    cumwidths, widths = _knots(unnorm_widths, min_bin_width, -tail_bound, tail_bound)
    cumheights, heights = _knots(unnorm_heights, min_bin_height, -tail_bound, tail_bound)

    locs = cumheights if inverse else cumwidths
    locs = torch.cat([locs[..., :-1], locs[..., -1:] + 1e-6], dim=-1)
    bin_idx = ((x[..., None] >= locs).sum(dim=-1) - 1).clamp(0, num_bins - 1)[..., None]

    def gather(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    in_cumwidths, in_widths = gather(cumwidths), gather(widths)
    in_cumheights, in_heights = gather(cumheights), gather(heights)
    in_delta = gather(heights / widths)
    in_der, in_der_p1 = gather(derivatives[..., :-1]), gather(derivatives[..., 1:])
    slope = in_der + in_der_p1 - 2 * in_delta

    if inverse:
        dy = x - in_cumheights
        a = dy * slope + in_heights * (in_delta - in_der)
        b = in_heights * in_der - dy * slope
        c = -in_delta * dy
        disc = (b ** 2 - 4 * a * c).clamp(min=0.0)
        root = (2 * c) / (-b - torch.sqrt(disc) - 1e-12)
        outputs = root * in_widths + in_cumwidths
        tom = root * (1 - root)
        denom = in_delta + slope * tom
        dnum = in_delta ** 2 * (in_der_p1 * root ** 2 + 2 * in_delta * tom + in_der * (1 - root) ** 2)
        logabsdet = -(torch.log(dnum.clamp(min=1e-12)) - 2 * torch.log(denom.clamp(min=1e-12)))
    else:
        theta = (x - in_cumwidths) / in_widths.clamp(min=1e-12)
        tom = theta * (1 - theta)
        numer = in_heights * (in_delta * theta ** 2 + in_der * tom)
        denom = in_delta + slope * tom
        outputs = in_cumheights + numer / denom
        dnum = in_delta ** 2 * (in_der_p1 * theta ** 2 + 2 * in_delta * tom + in_der * (1 - theta) ** 2)
        logabsdet = torch.log(dnum.clamp(min=1e-12)) - 2 * torch.log(denom.clamp(min=1e-12))

    outputs = torch.where(inside, outputs, inputs)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return outputs, logabsdet


def _channel_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.transpose(1, 2)).transpose(1, 2)


class DilatedDepthSeparableConv(nn.Module):
    """``layers`` x (depthwise conv of dilation ``k**i``, LayerNorm, gelu,
    1x1 conv, LayerNorm, gelu, dropout) as residuals; channel-first."""

    def __init__(self, channels: int, kernel_size: int, layers: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dw = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, groups=channels, dilation=kernel_size ** i, padding="same")
            for i in range(layers)
        )
        self.norm1 = nn.ModuleList(nn.LayerNorm(channels, eps=1e-5) for _ in range(layers))
        self.pw = nn.ModuleList(nn.Conv1d(channels, channels, 1) for _ in range(layers))
        self.norm2 = nn.ModuleList(nn.LayerNorm(channels, eps=1e-5) for _ in range(layers))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for dw, n1, pw, n2 in zip(self.dw, self.norm1, self.pw, self.norm2):
            y = F.gelu(_channel_norm(n1, dw(x * x_mask)))
            y = F.gelu(_channel_norm(n2, pw(y)))
            x = x + self.dropout(y)
        return x * x_mask


class ConvFlow(nn.Module):
    """Half-channel RQ-spline coupling; ``proj`` starts at zero."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, layers: int,
                 bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.bins = bins
        self.tail_bound = tail_bound
        self.hidden_channels = hidden_channels
        self.input_conv = nn.Conv1d(self.half, hidden_channels, 1)
        self.dds_conv = DilatedDepthSeparableConv(hidden_channels, kernel_size, layers)
        self.proj = nn.Conv1d(hidden_channels, (in_channels - self.half) * (bins * 3 - 1), 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, g=None, inverse: bool = False):
        """Forward: (y, logdet [B]); inverse: x."""
        xa, xb = x.split([self.half, x.shape[1] - self.half], dim=1)
        h = self.dds_conv(self.input_conv(xa), x_mask, g)
        h = self.proj(h) * x_mask
        b, _, t = h.shape
        h = h.reshape(b, xb.shape[1], self.bins * 3 - 1, t).permute(0, 1, 3, 2)
        denom = math.sqrt(self.hidden_channels)
        yb, logabsdet = rational_quadratic_spline(
            xb, h[..., : self.bins] / denom, h[..., self.bins: 2 * self.bins] / denom, h[..., 2 * self.bins:],
            inverse=inverse, tail_bound=self.tail_bound,
        )
        y = torch.cat([xa, yb], dim=1) * x_mask
        if inverse:
            return y
        return y, (logabsdet * x_mask).sum(dim=(1, 2))


class ElementwiseAffineFlow(nn.Module):
    """y = (m + exp(logs) x) · mask, per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def forward(self, x, x_mask, inverse: bool = False):
        m, logs = self.m[None, :, None], self.logs[None, :, None]
        if not inverse:
            return (m + torch.exp(logs) * x) * x_mask, (logs * x_mask).sum(dim=(1, 2))
        return (x - m) * torch.exp(-logs) * x_mask


def log_flow(x, x_mask, inverse: bool = False, eps: float = 1e-5):
    """y = log(max(x, eps)) · mask, logdet = -sum(y); inverse exp(x) · mask."""
    if not inverse:
        y = torch.log(x.clamp(min=eps)) * x_mask
        return y, (-y).sum(dim=(1, 2))
    return torch.exp(x) * x_mask


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration predictor. Training returns the per-utterance NLL
    of the durations ``w`` ``[B]``; inference samples log-durations through
    the inverted flow (the first conv flow skipped, as upstream VITS does)
    and returns ``ceil(exp(.))`` ``[B, T]``. Feature-last: x ``[B, T, C]``,
    x_mask ``[B, T, 1]``, w ``[B, T, 1]``; x (and g) carry no gradient."""

    def __init__(self, channels: int = 192, kernel_size: int = 3, dropout_rate: float = 0.5, flows: int = 4,
                 dds_conv_layers: int = 3, global_channels: int = -1):
        super().__init__()
        self.pre = nn.Conv1d(channels, channels, 1)
        self.dds = DilatedDepthSeparableConv(channels, kernel_size, dds_conv_layers, dropout_rate)
        self.proj = nn.Conv1d(channels, channels, 1)
        self.flows = nn.ModuleList(
            [ElementwiseAffineFlow(2)]
            + [ConvFlow(2, channels, kernel_size, dds_conv_layers) for _ in range(flows)]
        )
        self.post_pre = nn.Conv1d(1, channels, 1)
        self.post_dds = DilatedDepthSeparableConv(channels, kernel_size, dds_conv_layers, dropout_rate)
        self.post_proj = nn.Conv1d(channels, channels, 1)
        self.post_flows = nn.ModuleList(
            [ElementwiseAffineFlow(2)]
            + [ConvFlow(2, channels, kernel_size, dds_conv_layers) for _ in range(flows)]
        )
        if global_channels > 0:
            self.global_conv = nn.Conv1d(global_channels, channels, 1)
        self.noise_generator: Optional[torch.Generator] = None

    def forward(
        self,
        x: torch.Tensor,
        x_mask: torch.Tensor,
        w: Optional[torch.Tensor] = None,
        g: Optional[torch.Tensor] = None,
        inverse: bool = False,
        noise_scale: float = 1.0,
        e_q: Optional[torch.Tensor] = None,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``e_q`` (training) and ``z`` (inference, before ``noise_scale``)
        are ``[B, T, 2]`` N(0, 1) draws, from ``noise_generator`` (training)
        or ``generator`` (inference, else ``noise_generator``) unless given."""
        # the JAX predictor takes no ``dtype``: its flax layers promote a
        # compute-dtype input to their float32 parameters; here it is cast once
        dt = self.pre.weight.dtype
        x, x_mask = x.detach().to(dt).transpose(1, 2), x_mask.to(dt).transpose(1, 2)
        x = self.pre(x)
        if g is not None:
            x = x + self.global_conv(g.detach().to(dt).transpose(1, 2))
        x = self.proj(self.dds(x, x_mask)) * x_mask
        shape = (x.shape[0], 2, x.shape[2])

        if not inverse:
            assert w is not None, "w must be provided"
            w = w.transpose(1, 2)
            h_w = self.post_pre(w)
            h_w = self.post_proj(self.post_dds(h_w, x_mask)) * x_mask
            if e_q is None:
                e_q = draw(lambda s: torch.randn(s, generator=self.noise_generator, device=x.device, dtype=x.dtype),
                           shape)
            else:
                e_q = e_q.transpose(1, 2)
            e_q = e_q * x_mask
            z_q, logdet_q = self.post_flows[0](e_q, x_mask)
            for flow in self.post_flows[1:]:
                z_q, ld = flow(z_q, x_mask, g=x + h_w)
                logdet_q = logdet_q + ld
                z_q = torch.flip(z_q, [1])
            z_u, z1 = z_q.split([1, 1], dim=1)
            u = torch.sigmoid(z_u) * x_mask
            z0 = (w - u) * x_mask
            logdet_q = logdet_q + ((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask).sum(dim=(1, 2))
            logq = (-0.5 * (_LOG_2PI + e_q ** 2) * x_mask).sum(dim=(1, 2)) - logdet_q

            z0, logdet = log_flow(z0, x_mask)
            z, ld = self.flows[0](torch.cat([z0, z1], dim=1), x_mask)
            logdet = logdet + ld
            for flow in self.flows[1:]:
                z, ld = flow(z, x_mask, g=x)
                logdet = logdet + ld
                z = torch.flip(z, [1])
            nll = (0.5 * (_LOG_2PI + z ** 2) * x_mask).sum(dim=(1, 2)) - logdet
            return nll + logq

        if z is None:
            gen = generator if generator is not None else self.noise_generator
            z = torch.randn(shape, generator=gen, device=x.device, dtype=x.dtype)
        else:
            z = z.transpose(1, 2)
        z = z * noise_scale
        for flow in list(reversed(self.flows[1:]))[:-1]:
            z = flow(torch.flip(z, [1]), x_mask, g=x, inverse=True)
        z = self.flows[0](torch.flip(z, [1]), x_mask, inverse=True)
        return torch.ceil(torch.exp(z[:, :1]) * x_mask)[:, 0]
