"""Multi-head attention with relative positions, legacy and latest
(counterpart of jatts_tpu/modules/attention.py).

Masking is additive with a finite -1e9, and probabilities at masked keys
are zeroed after the softmax, so a row with no valid key gives 0. In
training the eager path drops attention probabilities after the masked
softmax (``dropout_rate``); the flash path applies none, which is the JAX
package's own semantics for its fused kernel.

``attn_backend`` selects the attention core: ``xla`` is the eager path
(``_attend``, named after the JAX package's option), ``flash`` is K1
(``ops/flash_attention.py``, the CUDA kernel on CUDA tensors), and
``auto`` takes K1 only when the key length exceeds ``FLASH_AUTO_MIN_LEN``.
K1 masks its own ragged edge, so the TPU path's 128-multiple condition
does not carry over.

The latest rel-pos layer (``RelPositionMultiHeadedAttention``) under K1
takes the JAX package's fused form: the ``[B, H, T, T]`` positional bias
decomposes exactly into features concatenated onto q and k
(``relpos_fused_features``), so the kernel is K1r, the d_qk != d_v form,
with no bias. That branch reads no ``pos_emb``, so it applies no positional
dropout to the table, and no attention-probability dropout, as the JAX
package's fused branch does in training.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from jatts_torch.modules.dropout import Dropout
from jatts_torch.modules.layers import Linear, in_dtype, per_shape
from jatts_torch.ops.flash_attention import flash_attention

_MASK_VAL = -1e9

# the JAX package's crossover for 'auto'; not re-measured on the H100 yet
FLASH_AUTO_MIN_LEN = 2048


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)  # [B, H, T, d_k]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def _attend(
    scores: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    dropout: Optional[Dropout] = None,
):
    """Masked softmax + value contraction; masked keys get zero weight, then
    the probabilities go through ``dropout`` (a no-op in eval mode).
    mask: [B, 1, T_k] or [B, T_q, T_k], True on valid keys."""
    if mask is not None:
        m = mask[:, None]  # broadcast over heads
        attn = torch.softmax(scores.masked_fill(~m, _MASK_VAL), dim=-1)
        attn = attn.masked_fill(~m, 0.0)
    else:
        attn = torch.softmax(scores, dim=-1)
    if dropout is not None:
        attn = dropout(attn)
    return torch.matmul(attn.to(v.dtype), v)


def _flash_ok(backend: str, mask: Optional[torch.Tensor], t_k: int) -> bool:
    """Whether the attention core is K1: ``flash`` always, ``auto`` above
    ``FLASH_AUTO_MIN_LEN`` keys, ``xla`` never; and only for a per-key
    padding mask, [B, 1, T_k] or [B, T_k] as the JAX gate takes them (K1
    takes no [B, T_q, T_k] mask)."""
    if backend not in ("xla", "flash", "auto"):
        raise ValueError(f"unknown attn_backend {backend!r}")
    if backend == "xla" or (backend == "auto" and t_k <= FLASH_AUTO_MIN_LEN):
        return False
    return mask is None or mask.dim() == 2 or (mask.dim() == 3 and mask.shape[1] == 1)


def _key_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A per-key mask, [B, 1, T_k] or [B, T_k], as K1's [B, T_k]."""
    if mask is None:
        return None
    return (mask if mask.dim() == 2 else mask[:, 0]).contiguous()


class MultiHeadedAttention(nn.Module):
    """Vanilla MHA; parameters linear_q/k/v/out as in the reference.
    ``compute_dtype`` (``modules/layers.py``) is the JAX layer's ``dtype``:
    the projections, the position biases and the eager path's scale are
    taken in it."""

    def __init__(
        self, n_head: int, n_feat: int, attn_backend: str = "xla", dropout_rate: float = 0.0
    ):
        super().__init__()
        self.n_head = n_head
        self.d_k = n_feat // n_head
        self.attn_backend = attn_backend
        self.dropout = Dropout(dropout_rate)
        self.compute_dtype = None
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k = Linear(n_feat, n_feat)
        self.linear_v = Linear(n_feat, n_feat)
        self.linear_out = Linear(n_feat, n_feat)

    def _pos_biases(self):
        dt = self.compute_dtype
        u, v = self.pos_bias_u, self.pos_bias_v
        return (u, v) if dt is None else (u.to(dt), v.to(dt))

    def forward(self, query, key, value, mask=None):
        q = _split_heads(self.linear_q(query), self.n_head)
        k = _split_heads(self.linear_k(key), self.n_head)
        v = _split_heads(self.linear_v(value), self.n_head)
        sm_scale = 1.0 / math.sqrt(self.d_k)
        if _flash_ok(self.attn_backend, mask, k.shape[2]):
            x = flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), None,
                _key_mask(mask), sm_scale,
            )
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) * in_dtype(sm_scale, self.compute_dtype)
            x = _attend(scores, v, mask, self.dropout)
        return self.linear_out(_merge_heads(x))


def legacy_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Legacy Transformer-XL shift: pad a zero column, reshape
    [T1, T2+1] -> [T2+1, T1], drop the first row."""
    b, h, t1, t2 = x.shape
    x_padded = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1)
    x_padded = x_padded.view(b, h, t2 + 1, t1)
    return x_padded[:, :, 1:].reshape(b, h, t1, t2)


class LegacyRelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Legacy rel-pos MHA (the variant every published reference config
    runs). pos_emb has length T with reversed positions."""

    def __init__(
        self, n_head: int, n_feat: int, attn_backend: str = "xla", dropout_rate: float = 0.0
    ):
        super().__init__(n_head, n_feat, attn_backend, dropout_rate)
        self.linear_pos = Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    def forward(self, query, key, value, pos_emb, mask=None):
        q = _split_heads(self.linear_q(query), self.n_head)
        k = _split_heads(self.linear_k(key), self.n_head)
        v = _split_heads(self.linear_v(value), self.n_head)
        p = _split_heads(self.linear_pos(pos_emb), self.n_head)  # [1, H, T, d_k]

        pos_bias_u, pos_bias_v = self._pos_biases()
        q_u = q + pos_bias_u[None, :, None, :]
        q_v = q + pos_bias_v[None, :, None, :]
        matrix_bd = legacy_rel_shift(torch.matmul(q_v, p.transpose(-1, -2)))
        sm_scale = 1.0 / math.sqrt(self.d_k)

        if _flash_ok(self.attn_backend, mask, k.shape[2]):
            # K1 computes (q k^T + ab) * sm_scale: pass bd unscaled
            x = flash_attention(
                q_u.contiguous(), k.contiguous(), v.contiguous(),
                matrix_bd.to(q.dtype).contiguous(), _key_mask(mask), sm_scale,
            )
        else:
            matrix_ac = torch.matmul(q_u, k.transpose(-1, -2))
            x = _attend((matrix_ac + matrix_bd) * in_dtype(sm_scale, self.compute_dtype), v, mask, self.dropout)
        return self.linear_out(_merge_heads(x))


def rel_shift_gather(matrix_bd: torch.Tensor, t_k: int) -> torch.Tensor:
    """``[B, H, T_q, 2*T_q-1]`` scores over relative positions ->
    ``[B, H, T_q, T_k]`` aligned scores. ``pos_emb`` row ``p`` holds relative
    position ``T_q-1-p``; entry (i, j) needs ``i - j``, so ``p = T_q-1-i+j``:
    the pad/reshape trick (pad a zero column, view as [2T, T], drop the first
    row), then the first ``t_k`` columns."""
    b, h, t_q, p = matrix_bd.shape  # p == 2*t_q - 1
    x = torch.cat([matrix_bd.new_zeros(b, h, t_q, 1), matrix_bd], dim=-1)  # [B, H, T, 2T]
    x = x.view(b, h, 2 * t_q, t_q)[:, :, 1:].reshape(b, h, t_q, p)
    return x[..., :t_k]


def relpos_fused_features(
    q_v: torch.Tensor, w_pos: torch.Tensor, t: int, n_feat: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact low-rank form of the latest rel-pos bias: ``(u~ [B, H, T,
    n_feat], phi [T, n_feat])`` with

        u~ . phiᵀ == rel_shift_gather(q_v . (pos_emb @ w_pos)ᵀ, T)

    per head, ``pos_emb`` the signed sinusoid table. ``w_pos`` is the
    position projection in the flax layout ``[in, out]`` (the torch
    ``linear_pos.weight.t()``), its output columns split ``(H, d_k)``.
    u(i) = w_posᵀ q_v(i); the angle-addition identities split sin/cos of
    ω(i - j) into i-only and j-only factors: u~ interleaves
    (u_e sin + u_o cos, -u_e cos + u_o sin) of ω·i, phi interleaves
    (cos, sin) of ω·j. The trig tables are built in float64 with numpy and
    cast to the compute dtype (float32 sin/cos of large angles alone costs
    ~1e-3 in the output)."""
    h, dk = q_v.shape[1], q_v.shape[3]
    w = w_pos.reshape(n_feat, h, dk)
    u = torch.einsum("bhtd,fhd->bhtf", q_v, w)  # [B, H, T, n_feat]
    sin_i, cos_i, phi = _fused_tables(t, n_feat, q_v.device, q_v.dtype)
    u_e, u_o = u[..., 0::2], u[..., 1::2]
    ut = torch.stack([u_e * sin_i + u_o * cos_i, -u_e * cos_i + u_o * sin_i], dim=-1).reshape(u.shape)
    return ut.to(q_v.dtype), phi


@per_shape
def _fused_tables(t: int, n_feat: int, device: torch.device, dtype: torch.dtype):
    """sin and cos of ω·i ``[T, n_feat / 2]`` and phi ``[T, n_feat]``, built
    in float64 once per shape (the JAX package's trace-time constants);
    callers must not write to them."""
    om = np.exp(np.arange(0, n_feat, 2, dtype=np.float64) * -(np.log(10000.0) / n_feat))
    ang = om[None, :] * np.arange(t, dtype=np.float64)[:, None]  # [T, n_feat / 2]

    def table(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)

    phi = np.stack([np.cos(ang), np.sin(ang)], axis=-1).reshape(t, n_feat)
    return table(np.sin(ang)), table(np.cos(ang)), table(phi)


class RelPositionMultiHeadedAttention(LegacyRelPositionMultiHeadedAttention):
    """Transformer-XL rel-pos MHA, the latest variant: ``pos_emb`` is
    ``[1, 2T-1, d]`` over positions T-1 … -(T-1), aligned by
    :func:`rel_shift_gather`. The parameters are the legacy layer's
    (linear_q/k/v/out/pos, pos_bias_u/v). Under K1 the bias goes into the
    kernel as concatenated features (K1r, d_qk = d_k + n_feat, d_v = d_k)
    and ``pos_emb`` is not read."""

    def forward(self, query, key, value, pos_emb, mask=None):
        q = _split_heads(self.linear_q(query), self.n_head)
        k = _split_heads(self.linear_k(key), self.n_head)
        v = _split_heads(self.linear_v(value), self.n_head)
        pos_bias_u, pos_bias_v = self._pos_biases()
        q_u = q + pos_bias_u[None, :, None, :]
        q_v = q + pos_bias_v[None, :, None, :]
        sm_scale = 1.0 / math.sqrt(self.d_k)
        n_feat = self.n_head * self.d_k

        if _flash_ok(self.attn_backend, mask, k.shape[2]):
            # bd[i, j] = u~(i) . phi(j): one K1r call over [q_u, u~] and
            # [k, phi], no [B, H, T, T] tensor
            w_pos = self.linear_pos.weight.t()
            ut, phi = relpos_fused_features(
                q_v, w_pos if self.compute_dtype is None else w_pos.to(self.compute_dtype), q.shape[2], n_feat,
            )
            q_cat = torch.cat([q_u, ut], dim=-1)
            k_cat = torch.cat([k, phi[None, None].expand(*k.shape[:3], n_feat)], dim=-1)
            x = flash_attention(
                q_cat.contiguous(), k_cat.contiguous(), v.contiguous(), None,
                _key_mask(mask), sm_scale,
            )
        else:
            p = _split_heads(self.linear_pos(pos_emb), self.n_head)  # [1, H, 2T-1, d_k]
            matrix_bd = rel_shift_gather(torch.matmul(q_v, p.transpose(-1, -2)), k.shape[2])
            matrix_ac = torch.matmul(q_u, k.transpose(-1, -2))
            x = _attend((matrix_ac + matrix_bd) * in_dtype(sm_scale, self.compute_dtype), v, mask, self.dropout)
        return self.linear_out(_merge_heads(x))
