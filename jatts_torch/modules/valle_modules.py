"""VALL-E transformer blocks (counterpart of jatts_tpu/modules/valle_modules.py).

Parameters carry the reference state_dict keys that
``jatts_tpu.utils.torch_import.convert_valle`` reads: a block holds
``attn.norm`` / ``attn.block.{to_qkv,to_out}`` and ``ffn.norm`` /
``ffn.block.{0,3}`` (the reference's pre-norm residual wrappers).

Compute dtype, flax's meaning: ``compute_dtype`` (``model_params.dtype``)
keeps the parameters float32 and computes in that type, as the JAX modules
do with ``dtype=``. :class:`Dense` casts its input, weight and bias to it;
:class:`LayerNorm` takes its statistics in float32 and returns the compute
dtype. The casts are explicit, not ``torch.autocast``, whose per-op policy
is not flax's.

Attention: ``attn_backend`` ``flash`` runs the hand-written kernels
(``ops/flash_attention.py``: K1b, the causal form, for the AR; the
non-causal form for the NAR), ``xla`` the
eager path below (named after the JAX package's option), ``auto`` the
kernels only beyond ``FLASH_AUTO_MIN_LEN`` keys. The kernels mask their own
ragged edge, so the JAX path's padding to a multiple of 128 does not carry
over. ``prefill`` and ``decode_step`` are always eager, as in the JAX
package. The NAR's blocks (``norm_type: adaln``) normalise with
:class:`AdaLN`, conditioned on the codec level a sample predicts.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.modules.attention import _flash_ok
from jatts_torch.modules import layers
from jatts_torch.modules.dropout import Dropout
from jatts_torch.modules.layers import Linear
from jatts_torch.ops.flash_attention import flash_attention

_MASK_VAL = -1e9
# flax's lecun_normal / variance_scaling "normal": a normal truncated at two
# standard deviations, rescaled so the variance is the asked-for one
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(w: torch.Tensor, std: float) -> torch.Tensor:
    s = std / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=s, a=-2.0 * s, b=2.0 * s)


class Dense(Linear):
    """flax ``nn.Dense(dtype=compute_dtype)`` (``modules/layers.py:Linear``);
    lecun-normal weight, zero bias."""

    def __init__(self, in_features, out_features, bias=True, compute_dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device, compute_dtype=compute_dtype)
        with torch.no_grad():
            trunc_normal_(self.weight, 1.0 / math.sqrt(in_features))
            if self.bias is not None:
                self.bias.zero_()


class LayerNorm(layers.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=compute_dtype)``: statistics
    and affine in float32, output in the compute dtype."""

    def __init__(self, d: int, compute_dtype=torch.float32, device=None):
        super().__init__(d, eps=1e-5, device=device, compute_dtype=compute_dtype)


class AdaLN(nn.Module):
    """The NAR's level-conditioned norm (flax ``AdaLN``): a LayerNorm
    without scale or bias (float32 statistics, output in the compute dtype),
    then ``h = c·(1 − (k·h).detach())·h`` and ``exp(log_gamma)·h + beta``,
    where ``[log_gamma | beta]`` is row ``level[b]`` of ``emb``
    (``nn.Embedding(n_levels, 2·d)``, zero-initialised, key ``emb.weight``)."""

    eps, k, c = 1e-5, 0.1, 2.0

    def __init__(self, d_model: int, n_levels: int, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.d_model = d_model
        self.compute_dtype = compute_dtype
        self.emb = nn.Embedding(n_levels, 2 * d_model, device=device)
        with torch.no_grad():
            self.emb.weight.zero_()

    def forward(self, x: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
        """x [B, T, D]; level [B] int -> [B, T, D] in the compute dtype."""
        dt = self.compute_dtype
        log_gamma, beta = self.emb.weight.to(dt)[level.long()][:, None, :].chunk(2, dim=-1)
        h = F.layer_norm(x.float(), (self.d_model,), None, None, self.eps).to(dt)
        h = self.c * (1.0 - (self.k * h).detach()) * h
        return torch.exp(log_gamma) * h + beta


class SinusoidalEmbedding(nn.Module):
    """``x + table(arange(T))``; the table is ``[sin | cos]`` halves in f32."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def table(self, positions: torch.Tensor) -> torch.Tensor:
        """positions [...] -> [..., d_model] f32."""
        half = self.d_model // 2
        omega = torch.exp(
            -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=positions.device) / half
        )
        ang = positions.float()[..., None] * omega
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.table(pos)[None].to(x.dtype)


class VALLEAttention(nn.Module):
    """Fused-QKV multi-head attention with a causal option and a KV-cached
    single-step decode."""

    def __init__(
        self, d_model: int, n_heads: int, causal: bool, attn_backend: str = "xla",
        compute_dtype=torch.float32, device=None,
    ):
        super().__init__()
        self.d_model = d_model
        self.n_heads = n_heads
        self.causal = causal
        self.attn_backend = attn_backend
        self.to_qkv = Dense(d_model, 3 * d_model, bias=False, compute_dtype=compute_dtype, device=device)
        self.to_out = Dense(d_model, d_model, compute_dtype=compute_dtype, device=device)

    def _qkv(self, x: torch.Tensor):
        """x [B, T, D] -> q, k, v [B, T, H, Dh]."""
        b, t, _ = x.shape
        return (y.reshape(b, t, self.n_heads, -1) for y in self.to_qkv(x).chunk(3, dim=-1))

    def _eager(self, q, k, v, valid):
        """The JAX package's XLA branch: -1e9 on masked (query, key) pairs
        (both must be valid; causal: key <= query), softmax, values."""
        t = q.shape[1]
        e = torch.einsum("bihd,bjhd->bhij", q, k) * q.shape[-1] ** -0.5
        kpm = valid[:, None, :, None] & valid[:, None, None, :]
        if self.causal:
            kpm = kpm & torch.ones(t, t, dtype=torch.bool, device=q.device).tril()[None, None]
        a = torch.softmax(e.masked_fill(~kpm, _MASK_VAL), dim=-1)
        return torch.einsum("bhij,bjhd->bihd", a, v)

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """x: [B, T, D]; m: [B, T, 1] validity."""
        q, k, v = self._qkv(x)
        t = x.shape[1]
        valid = m[:, :, 0] > 0
        if _flash_ok(self.attn_backend, None, t):
            o = flash_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), None, valid.contiguous(), q.shape[-1] ** -0.5,
                causal=self.causal,
            ).transpose(1, 2)
        else:
            o = self._eager(q, k, v, valid)
        return self.to_out(o.reshape(x.shape)) * m

    def prefill(self, x: torch.Tensor, m: torch.Tensor):
        """``forward``'s eager branch, also returning k, v [B, T, H, Dh]
        for AR cache priming."""
        q, k, v = self._qkv(x)
        o = self._eager(q, k, v, m[:, :, 0] > 0)
        return self.to_out(o.reshape(x.shape)) * m, k, v

    def decode_step(self, x_t, pk, pv, ck, cv, slot: torch.Tensor, pvalid):
        """One causal token at a fixed shape: x_t [B, 1, D] at the decode
        cache slot ``slot`` (int64 [1] on the device, the same slot for every
        row, as in the JAX package). pk/pv: [B, Sp, H, Dh] prefix K/V, of
        which row b may attend the slots ``pvalid[b]`` ([B, Sp] bool); ck/cv:
        [B, S_max, H, Dh] decode caches, this token's K/V written IN PLACE at
        ``slot`` (``index_copy_``). Every slot is attended under the mask
        ``slot' <= slot``, so each step has the same shapes and one CUDA graph
        replays it. Returns out [B, 1, D]."""
        q, k, v = self._qkv(x_t)
        ck.index_copy_(1, slot, k)
        cv.index_copy_(1, slot, v)
        scale = q.shape[-1] ** -0.5
        ep = torch.einsum("bqhd,bjhd->bhqj", q, pk) * scale
        ep = ep.masked_fill(~pvalid[:, None, None, :], _MASK_VAL)
        dvalid = torch.arange(ck.shape[1], device=slot.device) <= slot
        ed = torch.einsum("bqhd,bjhd->bhqj", q, ck) * scale
        ed = ed.masked_fill(~dvalid, _MASK_VAL)
        a = torch.softmax(torch.cat([ep, ed], dim=-1), dim=-1)
        sp = pk.shape[1]
        o = torch.einsum("bhqj,bjhd->bqhd", a[..., :sp], pv) + torch.einsum(
            "bhqj,bjhd->bqhd", a[..., sp:], cv
        )
        return self.to_out(o.reshape(x_t.shape))


class PreNorm(nn.Module):
    """The reference's pre-norm residual wrapper, kept for its key layout
    (``norm``, ``block``); :class:`VALLEBlock` does the residual itself."""

    def __init__(self, norm: nn.Module, block: nn.Module):
        super().__init__()
        self.norm = norm
        self.block = block


class VALLEBlock(nn.Module):
    """Pre-norm attention + FFN block; ``norm_type`` ``ln`` (the AR) or
    ``adaln`` (the NAR: both norms :class:`AdaLN` over ``n_levels``
    levels, conditioned on ``forward``'s ``level``)."""

    def __init__(
        self, d_model: int, n_heads: int, p_dropout: float, causal: bool, norm_type: str = "ln",
        n_levels: Optional[int] = None, attn_backend: str = "xla", compute_dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.norm_type = norm_type
        cd = dict(compute_dtype=compute_dtype, device=device)

        def norm():
            return AdaLN(d_model, n_levels, **cd) if norm_type == "adaln" else LayerNorm(d_model, **cd)

        self.attn = PreNorm(
            norm(),
            VALLEAttention(d_model, n_heads, causal, attn_backend=attn_backend, **cd),
        )
        self.ffn = PreNorm(
            norm(),
            nn.Sequential(
                Dense(d_model, 4 * d_model, **cd), nn.GELU(), Dropout(p_dropout),
                Dense(4 * d_model, d_model, **cd),
            ),
        )
        self.drop = Dropout(p_dropout)

    def _norm(self, norm: nn.Module, x: torch.Tensor, level) -> torch.Tensor:
        return norm(x, level) if self.norm_type == "adaln" else norm(x)

    def forward(self, x: torch.Tensor, m: torch.Tensor, level=None) -> torch.Tensor:
        """Dropout follows ``self.training`` (the JAX call's
        ``deterministic``); ``level`` [B] is the AdaLN levels (``adaln``)."""
        h = self.attn.block(self._norm(self.attn.norm, x, level) * m, m)
        x = (x + self.drop(h)) * m
        h = self.ffn.block(self._norm(self.ffn.norm, x, level) * m)
        return (x + self.drop(h)) * m

    def _ffn_deterministic(self, h: torch.Tensor) -> torch.Tensor:
        dense_in, gelu, _, dense_out = self.ffn.block
        return dense_out(gelu(dense_in(h)))

    def prefill(self, x: torch.Tensor, m: torch.Tensor):
        """Deterministic ``forward`` that also returns the block's k, v."""
        h, k, v = self.attn.block.prefill(self.attn.norm(x) * m, m)
        x = (x + h) * m
        x = (x + self._ffn_deterministic(self.ffn.norm(x) * m)) * m
        return x, k, v

    def decode_step(self, x_t, pk, pv, ck, cv, slot: torch.Tensor, pvalid):
        """Deterministic; see :meth:`VALLEAttention.decode_step`."""
        x_t = x_t + self.attn.block.decode_step(self.attn.norm(x_t), pk, pv, ck, cv, slot, pvalid)
        return x_t + self._ffn_deterministic(self.ffn.norm(x_t))
