"""HiFi-GAN generator (counterpart of jatts_tpu/vocoder/hifigan.py).

The parallel_wavegan layout with weight norm folded: keys ``input_conv``,
``upsamples.{i}.1``, ``blocks.{k}.convs1.{j}.1``, ``blocks.{k}.convs2.{j}.1``
and ``output_conv.1``, which ``jatts_tpu.vocoder.convert.hifigan_torch_to_flax``
reads. The public call keeps the JAX package's feature-last layout,
``[B, T, in_channels] -> [B, T*prod(upsample_scales), out_channels]``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from jatts_torch.device import resolve_device


class HiFiGANResidualBlock(nn.Module):
    """leaky -> dilated conv -> leaky -> conv, residual, per dilation."""

    def __init__(
        self,
        kernel_size: int,
        channels: int,
        dilations: Sequence[int],
        use_additional_convs: bool = True,
        alpha: float = 0.1,
    ):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Sequential(
                nn.LeakyReLU(alpha),
                nn.Conv1d(channels, channels, kernel_size, dilation=d, padding="same"),
            )
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            nn.Sequential(
                nn.LeakyReLU(alpha),
                nn.Conv1d(channels, channels, kernel_size, padding="same"),
            )
            for _ in dilations
        ) if use_additional_convs else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        for i, c1 in enumerate(self.convs1):
            xt = c1(x)
            if self.convs2 is not None:
                xt = self.convs2[i](xt)
            x = x + xt
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(
        self,
        in_channels: int = 80,
        out_channels: int = 1,
        channels: int = 512,
        kernel_size: int = 7,
        upsample_scales: Sequence[int] = (5, 5, 4, 3),
        upsample_kernel_sizes: Sequence[int] = (10, 10, 8, 6),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        use_additional_convs: bool = True,
        alpha: float = 0.1,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        # the hyperparameters, as the JAX module's fields: the streaming
        # vocoder reads its receptive field from them, and a serving
        # artifact rebuilds the generator from them
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.channels = channels
        self.kernel_size = kernel_size
        self.upsample_scales = tuple(upsample_scales)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(d) for d in resblock_dilations)
        self.use_additional_convs = use_additional_convs
        self.alpha = alpha
        self.num_blocks = len(resblock_kernel_sizes)
        self.input_conv = nn.Conv1d(in_channels, channels, kernel_size, padding="same")
        self.upsamples = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for i, (s, k) in enumerate(zip(upsample_scales, upsample_kernel_sizes)):
            ch = channels // (2 ** (i + 1))
            # ConvTranspose1d(k, s, padding=s//2+s%2, output_padding=s%2)
            # gives exactly T*s output frames
            self.upsamples.append(nn.Sequential(
                nn.LeakyReLU(alpha),
                nn.ConvTranspose1d(
                    channels // (2 ** i), ch, k, s,
                    padding=s // 2 + s % 2, output_padding=s % 2,
                ),
            ))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations):
                self.blocks.append(
                    HiFiGANResidualBlock(rk, ch, rd, use_additional_convs, alpha)
                )
        self.output_conv = nn.Sequential(
            nn.LeakyReLU(alpha),
            nn.Conv1d(
                channels // (2 ** len(upsample_scales)), out_channels, kernel_size,
                padding="same",
            ),
            nn.Tanh(),
        )
        self.to(device=resolve_device(device), dtype=dtype)
        self.eval()

    @property
    def hop_size(self) -> int:
        return math.prod(self.upsample_scales)

    def hparams(self) -> dict:
        """The constructor's keywords (device and dtype aside), JSON-safe."""
        return dict(
            in_channels=self.in_channels, out_channels=self.out_channels, channels=self.channels,
            kernel_size=self.kernel_size, upsample_scales=list(self.upsample_scales),
            upsample_kernel_sizes=list(self.upsample_kernel_sizes),
            resblock_kernel_sizes=list(self.resblock_kernel_sizes),
            resblock_dilations=[list(d) for d in self.resblock_dilations],
            use_additional_convs=self.use_additional_convs, alpha=self.alpha,
        )

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """c: [B, T, in_channels] normalized log-mel -> [B, T*hop, out_channels]."""
        x = self.input_conv(c.transpose(1, 2))
        for i, up in enumerate(self.upsamples):
            x = up(x)
            blocks = self.blocks[i * self.num_blocks:(i + 1) * self.num_blocks]
            cs = blocks[0](x)
            for blk in blocks[1:]:
                cs = cs + blk(x)
            x = cs / self.num_blocks
        return self.output_conv(x).transpose(1, 2)
