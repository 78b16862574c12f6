"""Conformer encoder (counterpart of jatts_tpu/modules/conformer.py).

Feature-last [B, T, C] at every public call; convolutions transpose to
PyTorch's [B, C, T] inside. Layer order as the reference EncoderLayer:
macaron FFN -> rel-pos MHA -> conv module -> FFN -> final LayerNorm, all
pre-norm residual. Padded frames are zeroed after each sub-block
(``zero_pad``), so the k>1 convolutions never read them and padded query
rows never reach valid rows. The mode follows ``self.training``: in
training, dropout goes where the JAX modules put it (the FFN hidden layer,
each sub-block's output before its residual add, the positional encoding,
the attention probabilities on the eager path) and the conv module's
BatchNorm uses batch statistics with flax's update (``modules/batchnorm.py``).

Parameter names are the reference state_dict keys
(``encoders.{i}.self_attn.linear_pos``, ``conv_module.depthwise_conv``, …).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.modules.attention import (
    LegacyRelPositionMultiHeadedAttention,
    MultiHeadedAttention,
)
from jatts_torch.modules.batchnorm import BatchNorm1d
from jatts_torch.modules.dropout import Dropout
from jatts_torch.modules.positional import (
    LegacyRelPositionalEncoding,
    PositionalEncoding,
    ScaledPositionalEncoding,
)


def resolve_rel_pos_types(
    rel_pos_type: str, pos_enc_layer_type: str, selfattention_layer_type: str
):
    """Reference rel-pos remap: with rel_pos_type="legacy" (the default of
    every published recipe), "rel_pos"/"rel_selfattn" become the legacy
    variants."""
    if rel_pos_type == "legacy":
        if pos_enc_layer_type == "rel_pos":
            pos_enc_layer_type = "legacy_rel_pos"
        if selfattention_layer_type == "rel_selfattn":
            selfattention_layer_type = "legacy_rel_selfattn"
    elif rel_pos_type == "latest":
        if pos_enc_layer_type == "legacy_rel_pos" or selfattention_layer_type == "legacy_rel_selfattn":
            raise ValueError("rel_pos_type='latest' excludes the legacy layer types")
    else:
        raise ValueError(f"Unknown rel_pos_type: {rel_pos_type}")
    return pos_enc_layer_type, selfattention_layer_type


_ACTIVATIONS = {
    "swish": F.silu,
    "relu": F.relu,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
}


def _conv_t(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to feature-last ``[B, T, C]``."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def _masked(x: torch.Tensor, pad_mask_t: Optional[torch.Tensor]) -> torch.Tensor:
    return x if pad_mask_t is None else x * pad_mask_t[..., None].to(x.dtype)


class MultiLayeredConv1d(nn.Module):
    """Two-conv positionwise FFN (w_1, w_2)."""

    def __init__(
        self, in_chans: int, hidden_chans: int, kernel_size: int, dropout_rate: float = 0.0
    ):
        super().__init__()
        self.w_1 = nn.Conv1d(in_chans, hidden_chans, kernel_size, padding="same")
        self.w_2 = nn.Conv1d(hidden_chans, in_chans, kernel_size, padding="same")
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, pad_mask_t=None):
        # w_1's bias makes padded rows nonzero; w_2 (k>1) must not read them
        x = _masked(F.relu(_conv_t(self.w_1, x)), pad_mask_t)
        return _conv_t(self.w_2, self.dropout(x))


class PositionwiseFeedForward(nn.Module):
    """Linear FFN (w_1, w_2)."""

    def __init__(
        self, idim: int, hidden_units: int, activation: str = "relu", dropout_rate: float = 0.0
    ):
        super().__init__()
        self.w_1 = nn.Linear(idim, hidden_units)
        self.w_2 = nn.Linear(hidden_units, idim)
        self.activation = _ACTIVATIONS[activation]
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, pad_mask_t=None):
        return self.w_2(self.dropout(self.activation(self.w_1(x))))


class ConvolutionModule(nn.Module):
    """Pointwise-GLU -> depthwise -> BatchNorm -> act -> pointwise. In
    training the BatchNorm reduces over (B, T) including the zeroed padding
    frames, as the JAX package's and the reference's do."""

    def __init__(self, channels: int, kernel_size: int, activation: str = "swish"):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size, padding="same", groups=channels
        )
        self.norm = BatchNorm1d(channels, eps=1e-5)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, x, pad_mask_t=None):
        x = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)  # [B, C, T]
        if pad_mask_t is not None:
            x = x * pad_mask_t[:, None, :].to(x.dtype)
        x = self.norm(self.depthwise_conv(x))
        x = self.pointwise_conv2(self.activation(x))
        return x.transpose(1, 2)


class EncoderLayer(nn.Module):
    """One conformer block."""

    def __init__(
        self,
        size: int,
        attention_heads: int,
        linear_units: int,
        positionwise_layer_type: str = "conv1d",
        positionwise_conv_kernel_size: int = 3,
        macaron_style: bool = True,
        use_cnn_module: bool = True,
        cnn_module_kernel: int = 7,
        activation_type: str = "swish",
        normalize_before: bool = True,
        selfattention_layer_type: str = "legacy_rel_selfattn",
        attn_backend: str = "xla",
        dropout_rate: float = 0.0,
        attention_dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.macaron_style = macaron_style
        self.use_cnn_module = use_cnn_module
        self.normalize_before = normalize_before
        self.dropout = Dropout(dropout_rate)

        def ffn():
            if positionwise_layer_type == "conv1d":
                return MultiLayeredConv1d(
                    size, linear_units, positionwise_conv_kernel_size, dropout_rate
                )
            return PositionwiseFeedForward(size, linear_units, activation_type, dropout_rate)

        if selfattention_layer_type == "legacy_rel_selfattn":
            self.self_attn = LegacyRelPositionMultiHeadedAttention(
                attention_heads, size, attn_backend, attention_dropout_rate
            )
        elif selfattention_layer_type == "selfattn":
            self.self_attn = MultiHeadedAttention(
                attention_heads, size, attn_backend, attention_dropout_rate
            )
        else:
            raise ValueError(
                f"selfattention_layer_type {selfattention_layer_type!r} is not ported"
            )
        self.rel_pos = selfattention_layer_type == "legacy_rel_selfattn"
        self.feed_forward = ffn()
        self.norm_ff = nn.LayerNorm(size, eps=1e-5)
        self.norm_mha = nn.LayerNorm(size, eps=1e-5)
        if macaron_style:
            self.feed_forward_macaron = ffn()
            self.norm_ff_macaron = nn.LayerNorm(size, eps=1e-5)
        if use_cnn_module:
            self.conv_module = ConvolutionModule(size, cnn_module_kernel, activation_type)
            self.norm_conv = nn.LayerNorm(size, eps=1e-5)
            self.norm_final = nn.LayerNorm(size, eps=1e-5)

    def _sublayer(self, x, norm, fn, scale=1.0):
        """Residual sub-block with pre- or post-norm; dropout on its output."""
        h = fn(norm(x) if self.normalize_before else x)
        x = x + scale * self.dropout(h)
        return x if self.normalize_before else norm(x)

    def forward(self, x, pos_emb, mask, pad_mask_t=None):
        ff_scale = 0.5 if self.macaron_style else 1.0

        def zero_pad(t):
            return _masked(t, pad_mask_t)

        if self.macaron_style:
            # LN(0) = bias != 0 on padded rows: re-mask before the k>1 conv
            x = zero_pad(self._sublayer(
                x, self.norm_ff_macaron,
                lambda h: self.feed_forward_macaron(zero_pad(h), pad_mask_t), ff_scale,
            ))

        if self.rel_pos:
            attn = lambda h: self.self_attn(h, h, h, pos_emb, mask)
        else:
            attn = lambda h: self.self_attn(h, h, h, mask)
        x = zero_pad(self._sublayer(x, self.norm_mha, attn))

        if self.use_cnn_module:
            x = self._sublayer(
                x, self.norm_conv, lambda h: self.conv_module(h, pad_mask_t)
            )

        x = zero_pad(self._sublayer(
            x, self.norm_ff,
            lambda h: self.feed_forward(zero_pad(h), pad_mask_t), ff_scale,
        ))
        if self.use_cnn_module:
            x = self.norm_final(x)
        return zero_pad(x)


class ConformerEncoder(nn.Module):
    """Conformer stack. input_layer "embed" (token ids, ``embed.0``) or None
    (features of width attention_dim). The positional encoding is the last
    entry of ``embed``, as in the reference."""

    def __init__(
        self,
        attention_dim: int = 256,
        attention_heads: int = 4,
        linear_units: int = 2048,
        num_blocks: int = 6,
        input_layer: Optional[str] = "embed",
        idim: int = 0,
        normalize_before: bool = True,
        positionwise_layer_type: str = "conv1d",
        positionwise_conv_kernel_size: int = 3,
        macaron_style: bool = True,
        pos_enc_layer_type: str = "legacy_rel_pos",
        selfattention_layer_type: str = "legacy_rel_selfattn",
        activation_type: str = "swish",
        use_cnn_module: bool = True,
        cnn_module_kernel: int = 7,
        padding_idx: int = 0,
        attn_backend: str = "xla",
        dropout_rate: float = 0.1,
        positional_dropout_rate: float = 0.1,
        attention_dropout_rate: float = 0.0,
    ):
        super().__init__()
        if pos_enc_layer_type == "legacy_rel_pos":
            pos_enc = LegacyRelPositionalEncoding(attention_dim, dropout_rate=positional_dropout_rate)
        elif pos_enc_layer_type == "scaled_abs_pos":
            pos_enc = ScaledPositionalEncoding(attention_dim, dropout_rate=positional_dropout_rate)
        elif pos_enc_layer_type == "abs_pos":
            pos_enc = PositionalEncoding(attention_dim, dropout_rate=positional_dropout_rate)
        else:
            raise ValueError(f"pos_enc_layer_type {pos_enc_layer_type!r} is not ported")
        self.rel_pos = pos_enc_layer_type == "legacy_rel_pos"
        if input_layer == "embed":
            self.embed = nn.Sequential(
                nn.Embedding(idim, attention_dim, padding_idx=padding_idx), pos_enc
            )
        elif input_layer is None:
            self.embed = nn.Sequential(pos_enc)
        else:
            raise ValueError(f"input_layer {input_layer!r} is not ported")
        self.input_layer = input_layer
        self.normalize_before = normalize_before
        self.encoders = nn.ModuleList(
            EncoderLayer(
                attention_dim, attention_heads, linear_units,
                positionwise_layer_type, positionwise_conv_kernel_size,
                macaron_style, use_cnn_module, cnn_module_kernel,
                activation_type, normalize_before, selfattention_layer_type,
                attn_backend, dropout_rate, attention_dropout_rate,
            )
            for _ in range(num_blocks)
        )
        if normalize_before:
            self.after_norm = nn.LayerNorm(attention_dim, eps=1e-5)

    def forward(self, xs, mask=None, pad_mask_t=None):
        """xs: [B, T] token ids ("embed") or [B, T, C]; mask: [B, 1, T] key
        mask; pad_mask_t: [B, T] frame validity. Returns [B, T, C]."""
        h = self.embed[0](xs) if self.input_layer == "embed" else xs
        if self.rel_pos:
            h, pos_emb = self.embed[-1](h)
        else:
            h, pos_emb = self.embed[-1](h), None
        if pad_mask_t is None and mask is not None:
            pad_mask_t = mask[:, 0, :]
        h = _masked(h, pad_mask_t)
        for layer in self.encoders:
            h = layer(h, pos_emb, mask, pad_mask_t)
        if self.normalize_before:
            h = self.after_norm(h)
        return h
