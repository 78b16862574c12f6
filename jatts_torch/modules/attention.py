"""Multi-head attention with legacy relative positions (counterpart of
jatts_tpu/modules/attention.py).

Masking is additive with a finite -1e9, and probabilities at masked keys
are zeroed after the softmax, so a row with no valid key gives 0.

``attn_backend`` selects the attention core: ``xla`` is the eager path
(``_attend``, named after the JAX package's option), ``flash`` is K1
(``ops/flash_attention.py``, the CUDA kernel on CUDA tensors), and
``auto`` takes K1 only when the key length exceeds ``FLASH_AUTO_MIN_LEN``.
K1 masks its own ragged edge, so the TPU path's 128-multiple condition
does not carry over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

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


def _attend(scores: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor]):
    """Masked softmax + value contraction; masked keys get zero weight.
    mask: [B, 1, T_k] or [B, T_q, T_k], True on valid keys."""
    if mask is not None:
        m = mask[:, None]  # broadcast over heads
        attn = torch.softmax(scores.masked_fill(~m, _MASK_VAL), dim=-1)
        attn = attn.masked_fill(~m, 0.0)
    else:
        attn = torch.softmax(scores, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def _flash_ok(backend: str, mask: Optional[torch.Tensor], t_k: int) -> bool:
    """Whether the attention core is K1: ``flash`` always, ``auto`` above
    ``FLASH_AUTO_MIN_LEN`` keys, ``xla`` never; and only for a per-key
    padding mask (K1 takes no [B, T_q, T_k] mask)."""
    if backend not in ("xla", "flash", "auto"):
        raise ValueError(f"unknown attn_backend {backend!r}")
    if backend == "xla" or (backend == "auto" and t_k <= FLASH_AUTO_MIN_LEN):
        return False
    return mask is None or (mask.dim() == 3 and mask.shape[1] == 1)


def _key_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else mask[:, 0].contiguous()


class MultiHeadedAttention(nn.Module):
    """Vanilla MHA; parameters linear_q/k/v/out as in the reference."""

    def __init__(self, n_head: int, n_feat: int, attn_backend: str = "xla"):
        super().__init__()
        self.n_head = n_head
        self.d_k = n_feat // n_head
        self.attn_backend = attn_backend
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

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
            scores = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
            x = _attend(scores, v, mask)
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

    def __init__(self, n_head: int, n_feat: int, attn_backend: str = "xla"):
        super().__init__(n_head, n_feat, attn_backend)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    def forward(self, query, key, value, pos_emb, mask=None):
        q = _split_heads(self.linear_q(query), self.n_head)
        k = _split_heads(self.linear_k(key), self.n_head)
        v = _split_heads(self.linear_v(value), self.n_head)
        p = _split_heads(self.linear_pos(pos_emb), self.n_head)  # [1, H, T, d_k]

        q_u = q + self.pos_bias_u[None, :, None, :]
        q_v = q + self.pos_bias_v[None, :, None, :]
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
            x = _attend((matrix_ac + matrix_bd) * sm_scale, v, mask)
        return self.linear_out(_merge_heads(x))
