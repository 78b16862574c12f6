"""Matcha-TTS 1-D U-Net flow estimator (counterpart of
jatts_tpu/modules/matcha_decoder.py).

Per scale: ResnetBlock1D (conv3 -> GroupNorm(8) -> mish, twice, with the
time embedding added between) -> ``n_blocks`` BasicTransformerBlocks
(self-attention + SnakeBeta feed-forward) -> a stride-2 down- or
up-sampling, with the down path's outputs concatenated into the up path.

The blocks run channel-first ``[B, C, T]`` with masks ``[B, 1, T]``, as the
reference does; the transformer blocks take ``[B, T, C]``. ``MatchaDecoder``
itself takes and returns feature-last tensors, as the JAX module does.
Parameters carry the reference state_dict keys
(``down_blocks.{i}.0`` resnet, ``.1.{j}`` transformer, ``.2[.conv]``
down/upsample; ``mlp.1``; ``block.0``/``block.1``; ``attn1.to_{q,k,v}``,
``attn1.to_out.0``; ``ff.net.0.{proj,alpha,beta}``, ``ff.net.2``), the
layout ``jatts_tpu.utils.torch_import.convert_matcha_estimator`` reads.

The attention is plain ``torch.matmul`` and softmax with the JAX package's
-1e9 key mask: the JAX package computes it as an einsum, outside any Pallas
kernel. GroupNorm's statistics include the padded frames, in both packages.
The U-Net halves the time axis and doubles it back, so T must be even.
Under a compute dtype (``modules/layers.py``, the JAX modules' ``dtype``)
the convolutions, projections and norms compute in it; SnakeBeta's
``alpha``/``beta`` and the masks stay float32, so a block's output is
float32 where the JAX one's is.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.modules.dropout import Dropout
from jatts_torch.modules.layers import Conv1d, ConvTranspose1d, GroupNorm, LayerNorm, Linear, in_dtype

_MASK_VAL = -1e9


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """``[B] -> [B, dim]``: sin and cos of ``scale * t`` at ``dim // 2``
    frequencies ``exp(-i log(10000) / (half - 1))``."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * -(math.log(10000.0) / (half - 1))
    )
    emb = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class Mish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


class Block1D(nn.Module):
    """conv3 -> GroupNorm(groups, eps 1e-5) -> mish on the masked input, the
    output masked (keys ``block.0``, ``block.1``)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(
            Conv1d(dim, dim_out, 3, padding=1), GroupNorm(groups, dim_out, eps=1e-5), Mish()
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.block(x * mask) * mask


class ResnetBlock1D(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), Linear(time_emb_dim, dim_out))
        self.block1 = Block1D(dim, dim_out, groups)
        self.block2 = Block1D(dim_out, dim_out, groups)
        self.res_conv = Conv1d(dim, dim_out, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        h = self.block1(x, mask)
        h = h + self.mlp(time_emb)[:, :, None]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask)


class SnakeBeta(nn.Module):
    """``proj`` then ``h + 1 / (exp(beta) + 1e-9) * sin(h * exp(alpha))**2``;
    ``alpha`` and ``beta`` are log-scale and start at 0."""

    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = Linear(dim, inner_dim)
        self.alpha = nn.Parameter(torch.zeros(inner_dim))
        self.beta = nn.Parameter(torch.zeros(inner_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj(x)
        a, b = torch.exp(self.alpha), torch.exp(self.beta)
        return h + (1.0 / (b + 1e-9)) * torch.sin(h * a) ** 2


class SnakeBetaFF(nn.Module):
    """SnakeBeta projection, dropout, linear out (``net.0``, ``net.2``)."""

    def __init__(self, dim: int, inner_dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(SnakeBeta(dim, inner_dim), Dropout(dropout_rate), Linear(inner_dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class _Attention(nn.Module):
    def __init__(self, dim: int, inner: int, dropout_rate: float):
        super().__init__()
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        # diffusers' to_out = [Linear, Dropout(p)]
        self.to_out = nn.ModuleList([Linear(inner, dim), Dropout(dropout_rate)])


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention and SnakeBeta feed-forward on ``[B, T, C]``;
    ``attn_mask [B, T]`` is True on valid keys (invalid ones score -1e9)."""

    def __init__(
        self, dim: int, num_heads: int, head_dim: int, dropout_rate: float = 0.0,
        act_fn: str = "snakebeta",
    ):
        super().__init__()
        if act_fn != "snakebeta":
            # the JAX package builds SnakeBeta whatever act_fn says
            raise ValueError(f"act_fn {act_fn!r}: only snakebeta is built")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.compute_dtype = None
        inner = num_heads * head_dim
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = _Attention(dim, inner, dropout_rate)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = SnakeBetaFF(dim, dim * 4, dropout_rate)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor = None) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.norm1(x)

        def heads(lin):
            return lin(h).reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.attn1.to_q), heads(self.attn1.to_k), heads(self.attn1.to_v)
        scores = torch.matmul(q, k.transpose(-1, -2)) / in_dtype(math.sqrt(self.head_dim), self.compute_dtype)
        if attn_mask is not None:
            scores = scores.masked_fill(~attn_mask[:, None, None, :], _MASK_VAL)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, t, self.num_heads * self.head_dim)
        linear, drop = self.attn1.to_out
        x = x + drop(linear(out))
        return x + self.ff(self.norm3(x))


class MatchaDecoder(nn.Module):
    """The U-Net: x, mu ``[B, T, out_channels]``, mask ``[B, T]`` (float or
    bool), t ``[B]`` -> ``[B, T, out_channels]``, zero on masked frames."""

    def __init__(
        self,
        out_channels: int,
        channels: Sequence[int] = (256, 256),
        dropout_rate: float = 0.05,
        attention_head_dim: int = 64,
        n_blocks: int = 1,
        num_mid_blocks: int = 2,
        num_heads: int = 4,
        act_fn: str = "snakebeta",
    ):
        super().__init__()
        chans = tuple(channels)
        self.out_channels = out_channels
        in_dim = 2 * out_channels
        temb = chans[0] * 4
        self.time_mlp = TimestepEmbedding(in_dim, temb)

        def tfs(ch):
            return nn.ModuleList(
                BasicTransformerBlock(ch, num_heads, attention_head_dim, dropout_rate, act_fn)
                for _ in range(n_blocks)
            )

        self.down_blocks = nn.ModuleList()
        prev = in_dim
        for i, ch in enumerate(chans):
            last = i == len(chans) - 1
            down = Conv1d(ch, ch, 3, padding=1) if last else _Resample(Conv1d(ch, ch, 3, 2, 1))
            self.down_blocks.append(nn.ModuleList([ResnetBlock1D(prev, ch, temb), tfs(ch), down]))
            prev = ch
        self.mid_blocks = nn.ModuleList(
            nn.ModuleList([ResnetBlock1D(chans[-1], chans[-1], temb), tfs(chans[-1])])
            for _ in range(num_mid_blocks)
        )
        up_chans = chans[::-1] + (chans[0],)
        self.up_blocks = nn.ModuleList()
        for i in range(len(up_chans) - 1):
            out_ch = up_chans[i + 1]
            last = i == len(up_chans) - 2
            # ConvTranspose1d(4, stride 2, padding 1) doubles T, as the JAX
            # package's ConvTranspose with padding (2, 2) and transpose_kernel
            up = (Conv1d(out_ch, out_ch, 3, padding=1) if last
                  else _Resample(ConvTranspose1d(out_ch, out_ch, 4, 2, 1)))
            self.up_blocks.append(nn.ModuleList([ResnetBlock1D(2 * up_chans[i], out_ch, temb), tfs(out_ch), up]))
        self.final_block = Block1D(up_chans[-1], up_chans[-1])
        self.final_proj = Conv1d(up_chans[-1], out_channels, 1)

    @staticmethod
    def _transformers(blocks, h, m):
        if not len(blocks):
            return h
        h = h.transpose(1, 2)
        valid = m[:, 0, :] > 0
        for block in blocks:
            h = block(h, valid)
        return h.transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2:
            raise ValueError(f"the U-Net needs an even number of frames, got {x.shape[1]}")
        temb = self.time_mlp(sinusoidal_pos_emb(t, 2 * self.out_channels).to(x.dtype))
        mask = mask.to(x.dtype)[:, None, :]
        h = torch.cat([x, mu], dim=-1).transpose(1, 2)
        masks = [mask]
        hiddens = []
        for i, (resnet, tfs, down) in enumerate(self.down_blocks):
            m = masks[-1]
            h = self._transformers(tfs, resnet(h, m, temb), m)
            hiddens.append(h)
            h = down(h * m)
            if i < len(self.down_blocks) - 1:
                masks.append(m[:, :, ::2])
        m = masks[-1]
        for resnet, tfs in self.mid_blocks:
            h = self._transformers(tfs, resnet(h, m, temb), m)
        for resnet, tfs, up in self.up_blocks:
            m = masks.pop()
            h = torch.cat([h, hiddens.pop()], dim=1)
            h = self._transformers(tfs, resnet(h, m, temb), m)
            h = up(h * m)
        h = self.final_block(h, mask)
        out = self.final_proj(h * mask) * mask
        return out.transpose(1, 2)


class _Resample(nn.Module):
    """The reference's Downsample1D / Upsample1D: a conv under ``.conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
