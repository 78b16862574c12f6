"""E2-TTS's flat U-Net transformer, UNetT (counterpart of
jatts_tpu/modules/e2tts_backbone.py).

Parameters carry the reference state_dict keys that
``jatts_tpu.utils.torch_import.convert_e2tts`` reads: ``time_embed.time_mlp.{0,2}``,
``text_embed.text_embed``, ``input_embed.proj``,
``input_embed.conv_pos_embed.conv1d.{0,2}``, per layer ``layers.{i}.{0 skip
projection (later half only), 1 attention norm, 2 attention (to_q, to_k,
to_v, to_out.0), 3 feed-forward norm, 4 feed-forward (ff.0.0, ff.2)}``,
``norm_out`` and ``proj_out``. Initialisation is flax's default for each
module, as the JAX model (which has no ``init_type``) keeps it.

Compute dtype as in ``modules/valle_modules.py``: the parameters stay
float32 and each layer computes in ``compute_dtype``; :class:`RMSNorm` takes
its mean square in float32; ``proj_out`` runs in float32 on a float32 input.

Attention: ``attn_backend`` ``flash`` runs the hand-written kernels
(``ops/flash_attention.py``: on the card the bf16 forward and the non-causal
bf16 dk/dv and dq on the tensor cores at d 64), ``xla`` the eager path below
(-1e9 on masked keys, the softmax in the compute dtype), ``auto`` the kernels
only beyond ``FLASH_AUTO_MIN_LEN`` keys. The JAX flash path pads the
``[time | mel]`` sequence to a multiple of 128 for its blocks; the kernels
here mask their own ragged edge, so the port pads nothing. On the TPU the
kernel takes segment ids for queries and keys alike, so a query row past its
utterance attends to the pad keys there and to the valid keys here; each
attention's output is multiplied by the mask, so the two agree.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.modules import layers
from jatts_torch.modules.attention import _flash_ok
from jatts_torch.modules.dropout import Dropout
from jatts_torch.modules.valle_modules import Dense, trunc_normal_
from jatts_torch.ops.flash_attention import flash_attention

_MASK_VAL = -1e9


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x·tanh(softplus(x))`` in x's dtype, as the JAX function writes it."""
    return x * torch.tanh(F.softplus(x))


def sinus_position_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """t [B] -> [B, dim] f32: ``[sin | cos]`` of ``scale·t·exp(-i·log(1e4)/(half - 1))``."""
    half = dim // 2
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -(math.log(10000.0) / (half - 1)))
    emb = scale * t.float()[:, None] * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def rotary_freqs(seq_len: int, dim_head: int, theta: float = 10000.0) -> np.ndarray:
    """[seq_len, dim_head // 2] rotation angles, float64."""
    inv = 1.0 / (theta ** (np.arange(0, dim_head, 2, dtype=np.float64) / dim_head))
    return np.outer(np.arange(seq_len, dtype=np.float64), inv)


@functools.lru_cache(maxsize=32)
def rope_tables(seq_len: int, dim_head: int, dtype: torch.dtype, device) -> tuple:
    """cos and sin of :func:`rotary_freqs` taken in float32, then cast to
    ``dtype``: [N, dim_head // 2] each; built once per shape (a table copied
    from pageable host memory on every call also breaks a CUDA graph
    capture), so callers must not write to them."""
    freqs = torch.from_numpy(rotary_freqs(seq_len, dim_head).astype(np.float32)).to(device)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, D] rotated in interleaved pairs (x[2i], x[2i+1])."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape)


class RMSNorm(nn.Module):
    """``x·rsqrt(mean(x²) + eps)·w``: the mean square and its reciprocal
    square root in float32, cast to x's dtype, the products in x's dtype."""

    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        return (x * torch.reciprocal(torch.sqrt(var + self.eps)).to(x.dtype)) * self.weight.to(x.dtype)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_embed_dim: int = 256, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        cd = dict(compute_dtype=compute_dtype, device=device)
        self.time_mlp = nn.Sequential(Dense(freq_embed_dim, dim, **cd), nn.SiLU(), Dense(dim, dim, **cd))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.time_mlp(sinus_position_embedding(t, self.freq_embed_dim))


class Conv1d(layers.Conv1d):
    """flax ``nn.Conv(padding="SAME", dtype=compute_dtype)`` on [B, C, T]
    (``modules/layers.py:Conv1d``); lecun-normal weight (fan-in
    ``k·C_in/groups``), zero bias."""

    def __init__(self, channels: int, kernel_size: int, groups: int, compute_dtype=torch.float32, device=None):
        super().__init__(channels, channels, kernel_size, padding=kernel_size // 2, groups=groups, device=device,
                         compute_dtype=compute_dtype)
        with torch.no_grad():
            trunc_normal_(self.weight, 1.0 / math.sqrt(kernel_size * channels // groups))
            self.bias.zero_()


class Mish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


class ConvPositionEmbedding(nn.Module):
    """Two grouped convolutions (kernel 31, 16 groups), each followed by
    :func:`mish`, over [B, T, dim], with no mask: the reference's input
    embedding runs it so (see :meth:`UNetT.forward`)."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16, compute_dtype=torch.float32, device=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype, device=device)
        self.conv1d = nn.Sequential(
            Conv1d(dim, kernel_size, groups, **cd), Mish(), Conv1d(dim, kernel_size, groups, **cd), Mish(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1d(x.transpose(1, 2)).transpose(1, 2)


class InputEmbedding(nn.Module):
    """``proj([x | cond | text_embed])`` plus its convolutional position
    embedding (the reference's ``input_embed``)."""

    def __init__(self, mel_dim: int, text_dim: int, dim: int, compute_dtype=torch.float32, device=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype, device=device)
        self.proj = Dense(2 * mel_dim + text_dim, dim, **cd)
        self.conv_pos_embed = ConvPositionEmbedding(dim, **cd)


class _TableLookup(torch.autograd.Function):
    """``weight[ids]`` whose gradient to the table is one product,
    one_hot(ids)^T . grad, summed in a fixed order. The embedding's own
    backward adds the rows with atomics on the card, so two identical steps
    gave the table's gradient different last bits (every padded frame sends
    its gradient to the filler row) and a run resumed from a checkpoint
    drifted from the run bit by bit."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        one_hot = F.one_hot(ids.reshape(-1), ctx.rows).to(grad.dtype)
        return one_hot.t() @ grad.reshape(-1, grad.shape[-1]), None


class TextEmbedding(nn.Module):
    """The filler-token text table, ``text_num_embeds + 1`` rows (row 0 the
    filler), flax's Embed init."""

    def __init__(self, text_num_embeds: int, text_dim: int, device=None):
        super().__init__()
        self.text_embed = nn.Embedding(text_num_embeds + 1, text_dim, device=device)
        with torch.no_grad():
            trunc_normal_(self.text_embed.weight, text_dim ** -0.5)


class E2Attention(nn.Module):
    """Multi-head attention with rotary embedding on the first
    ``pe_attn_head`` heads of q and k; the output dropped out and multiplied
    by the mask."""

    def __init__(
        self, dim: int, heads: int, dim_head: int, pe_attn_head: Optional[int] = None, dropout_rate: float = 0.1,
        attn_backend: str = "xla", compute_dtype=torch.float32, device=None,
    ):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.pe_attn_head = pe_attn_head
        self.attn_backend = attn_backend
        inner = heads * dim_head
        cd = dict(compute_dtype=compute_dtype, device=device)
        self.to_q = Dense(dim, inner, **cd)
        self.to_k = Dense(dim, inner, **cd)
        self.to_v = Dense(dim, inner, **cd)
        self.to_out = nn.ModuleList([Dense(inner, dim, **cd), Dropout(dropout_rate)])

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        b, n, _ = y.shape
        return y.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)  # [B, H, N, D]

    def forward(self, x: torch.Tensor, rope: tuple, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, N, dim]; rope: (cos, sin) [N, dim_head // 2] in x's dtype;
        mask [B, N] bool or None."""
        b, n, _ = x.shape
        q, k, v = self._heads(self.to_q(x)), self._heads(self.to_k(x)), self._heads(self.to_v(x))
        pn = self.pe_attn_head if self.pe_attn_head is not None else self.heads
        q = torch.cat([apply_rope(q[:, :pn], *rope), q[:, pn:]], dim=1)
        k = torch.cat([apply_rope(k[:, :pn], *rope), k[:, pn:]], dim=1)
        if _flash_ok(self.attn_backend, mask, n):
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), None,
                                  None if mask is None else mask.contiguous(), 1.0 / math.sqrt(self.dim_head))
        else:
            # the divisor made on the device: no host copy inside a CUDA graph capture
            scores = torch.matmul(q, k.transpose(-1, -2)) / torch.sqrt(
                torch.full((), float(self.dim_head), dtype=q.dtype, device=q.device))
            if mask is not None:
                scores = scores.masked_fill(~mask[:, None, None, :], _MASK_VAL)
            out = torch.matmul(torch.softmax(scores, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        dense, drop = self.to_out
        out = drop(dense(out))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out


class E2FeedForward(nn.Module):
    """``proj_in -> gelu (tanh) -> dropout -> proj_out`` (keys ``ff.0.0``,
    ``ff.2``)."""

    def __init__(self, dim: int, mult: int = 4, dropout_rate: float = 0.1, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype, device=device)
        self.ff = nn.Sequential(
            nn.Sequential(Dense(dim, dim * mult, **cd), nn.GELU(approximate="tanh")),
            Dropout(dropout_rate),
            Dense(dim * mult, dim, **cd),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(x)


class UNetT(nn.Module):
    """The flat U-Net transformer: ``depth`` pre-norm attention + feed-forward
    layers over ``[time token | frames]``; each layer of the first half
    pushes its input, each later layer pops one and projects ``[h | skip]``
    back to ``dim`` (the reference's ``concat`` skips, the only kind E2TTS
    builds). Dropout follows ``self.training``."""

    def __init__(
        self,
        text_num_embeds: int,
        mel_dim: int = 80,
        dim: int = 1024,
        depth: int = 24,
        heads: int = 16,
        dim_head: int = 64,
        dropout_rate: float = 0.1,
        ff_mult: int = 4,
        text_mask_padding: bool = False,
        pe_attn_head: Optional[int] = 1,
        attn_backend: str = "xla",
        compute_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.mel_dim = mel_dim
        self.depth = depth
        self.dim_head = dim_head
        self.text_mask_padding = text_mask_padding
        self.compute_dtype = compute_dtype
        cd = dict(compute_dtype=compute_dtype, device=device)
        self.time_embed = TimestepEmbedding(dim, **cd)
        self.text_embed = TextEmbedding(text_num_embeds, mel_dim, device=device)
        self.input_embed = InputEmbedding(mel_dim, mel_dim, dim, **cd)
        self.layers = nn.ModuleList()
        for idx in range(depth):
            later = idx + 1 > depth // 2
            self.layers.append(nn.ModuleList([
                Dense(2 * dim, dim, bias=False, **cd) if later else None,
                RMSNorm(dim, device=device),
                E2Attention(dim, heads, dim_head, pe_attn_head, dropout_rate, attn_backend, **cd),
                RMSNorm(dim, device=device),
                E2FeedForward(dim, ff_mult, dropout_rate, **cd),
            ]))
        self.norm_out = RMSNorm(dim, device=device)
        self.proj_out = Dense(dim, mel_dim, compute_dtype=torch.float32, device=device)

    def embed_text(self, text: torch.Tensor, n: int, drop_text: torch.Tensor) -> torch.Tensor:
        """Token ids [B, N_t] (pad -1) -> [B, n, mel_dim] in the compute
        dtype: ids shifted by +1 (the pad becomes the filler 0), padded with
        the filler or cut to ``n``, all filler on rows under ``drop_text``."""
        ids = text.long() + 1
        nt = ids.shape[1]
        ids = F.pad(ids, (0, n - nt)) if nt < n else ids[:, :n]
        ids = torch.where(drop_text[:, None], torch.zeros_like(ids), ids)
        emb = _TableLookup.apply(self.text_embed.text_embed.weight, ids).to(self.compute_dtype)
        if self.text_mask_padding:
            emb = emb.masked_fill((ids == 0)[..., None], 0.0)
        return emb

    def forward(
        self,
        x: torch.Tensor,
        cond: torch.Tensor,
        text: torch.Tensor,
        time: torch.Tensor,
        drop_audio_cond: torch.Tensor,
        drop_text: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        text_embed: Optional[torch.Tensor] = None,
        return_text_embed: bool = False,
    ) -> torch.Tensor:
        """x, cond [B, N, mel]; text [B, N_t] ids (pad -1); time [B];
        drop_audio_cond, drop_text [B] bool (per-sample CFG drops); mask
        [B, N] bool -> the flow [B, N, mel] f32. ``return_text_embed``
        returns :meth:`embed_text`'s output only, which a later call takes
        back as ``text_embed`` (inference computes it once for every ODE
        step)."""
        b, n, _ = x.shape
        if text_embed is None:
            text_embed = self.embed_text(text, n, drop_text)
        if return_text_embed:
            return text_embed
        dt = self.compute_dtype
        t = self.time_embed(time)
        cond = cond.masked_fill(drop_audio_cond[:, None, None], 0.0)
        h = self.input_embed.proj(torch.cat([x.to(dt), cond.to(dt), text_embed.to(dt)], dim=-1))
        # the reference's input embedding runs the position convolution
        # without the mask: padded frames hold noise, and the convolution
        # sees them near the utterance's end (kept for import parity)
        h = self.input_embed.conv_pos_embed(h) + h
        h = torch.cat([t[:, None, :].to(h.dtype), h], dim=1)  # [B, N + 1, dim]
        if mask is not None:
            mask = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=mask.device), mask.bool()], dim=1)
        rope = rope_tables(h.shape[1], self.dim_head, h.dtype, h.device)
        skips = []
        for idx, (skip_proj, attn_norm, attn, ff_norm, ff) in enumerate(self.layers):
            if skip_proj is None:
                skips.append(h)
            else:
                h = skip_proj(torch.cat([h, skips.pop()], dim=-1))
            h = attn(attn_norm(h), rope, mask) + h
            h = ff(ff_norm(h)) + h
        h = self.norm_out(h)[:, 1:]
        return self.proj_out(h.float())
