"""FastSpeech2 (counterpart of jatts_tpu/models/fastspeech2.py).

Conformer encoder -> variance adaptor -> matmul length regulator ->
conformer decoder -> linear feat_out -> postnet residual. Parameters carry
the reference state_dict keys, so
``jatts_tpu.utils.torch_import.convert_fastspeech2`` reads ``state_dict()``
as it stands.

``forward`` is the training call (the JAX ``__call__``): teacher-forced
durations, pitch and energy; dropout and BatchNorm follow ``self.training``
(a fresh model is in training mode, like the JAX call's
``deterministic=False``). ``encode`` and ``inference`` always run
deterministic, as the JAX methods' default ``deterministic=True`` does,
batched at a static output capacity. Multi-speaker inputs (``spks``,
``spk_embed_dim``) come with a later slice. ``init_type`` is read by the
trainer (``utils/initialize.py``), not here.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import torch
from torch import nn

from jatts_torch.device import resolve_device
from jatts_torch.modules.conformer import ConformerEncoder, resolve_rel_pos_types
from jatts_torch.modules.predictors import DurationPredictor, VariancePredictor
from jatts_torch.modules.prenet_postnet import Postnet
from jatts_torch.ops.masks import attn_mask, sequence_mask
from jatts_torch.ops.upsample import predicted_durations_to_int, regulate_length


class FastSpeech2(nn.Module):
    def __init__(
        self,
        idim: int,
        odim: int = 80,
        adim: int = 384,
        aheads: int = 2,
        elayers: int = 4,
        eunits: int = 1536,
        dlayers: int = 4,
        dunits: int = 1536,
        positionwise_layer_type: str = "conv1d",
        positionwise_conv_kernel_size: int = 3,
        encoder_type: str = "conformer",
        decoder_type: str = "conformer",
        encoder_normalize_before: bool = True,
        decoder_normalize_before: bool = True,
        reduction_factor: int = 1,
        conformer_rel_pos_type: str = "legacy",
        conformer_pos_enc_layer_type: str = "rel_pos",
        conformer_self_attn_layer_type: str = "rel_selfattn",
        conformer_activation_type: str = "swish",
        use_macaron_style_in_conformer: bool = True,
        use_cnn_in_conformer: bool = True,
        conformer_enc_kernel_size: int = 7,
        conformer_dec_kernel_size: int = 31,
        duration_predictor_layers: int = 2,
        duration_predictor_chans: int = 256,
        duration_predictor_kernel_size: int = 3,
        duration_predictor_dropout_rate: float = 0.1,
        pitch_predictor_layers: int = 5,
        pitch_predictor_chans: int = 256,
        pitch_predictor_kernel_size: int = 5,
        pitch_predictor_dropout: float = 0.5,
        pitch_embed_kernel_size: int = 1,
        pitch_embed_dropout: float = 0.0,
        stop_gradient_from_pitch_predictor: bool = True,
        energy_predictor_layers: int = 2,
        energy_predictor_chans: int = 256,
        energy_predictor_kernel_size: int = 3,
        energy_predictor_dropout: float = 0.5,
        energy_embed_kernel_size: int = 1,
        energy_embed_dropout: float = 0.0,
        stop_gradient_from_energy_predictor: bool = False,
        postnet_layers: int = 5,
        postnet_chans: int = 256,
        postnet_filts: int = 5,
        postnet_dropout_rate: float = 0.5,
        transformer_enc_dropout_rate: float = 0.2,
        transformer_enc_positional_dropout_rate: float = 0.2,
        transformer_enc_attn_dropout_rate: float = 0.2,
        transformer_dec_dropout_rate: float = 0.2,
        transformer_dec_positional_dropout_rate: float = 0.2,
        transformer_dec_attn_dropout_rate: float = 0.2,
        spk_embed_dim: Optional[int] = None,
        spk_embed_integration_type: str = "add",
        spks: Optional[int] = None,
        use_masking: bool = True,
        use_batch_norm: bool = True,
        init_type: str = "xavier_uniform",
        attn_backend: str = "xla",
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if encoder_type != "conformer" or decoder_type != "conformer":
            raise ValueError("only conformer encoder/decoder are supported")
        if spk_embed_dim or (spks is not None and spks > 1):
            raise ValueError("multi-speaker FastSpeech2 is not ported yet")
        self.odim = odim
        self.postnet_layers = postnet_layers
        pos_enc_type, selfattn_type = resolve_rel_pos_types(
            conformer_rel_pos_type, conformer_pos_enc_layer_type,
            conformer_self_attn_layer_type,
        )
        common = dict(
            attention_dim=adim,
            attention_heads=aheads,
            positionwise_layer_type=positionwise_layer_type,
            positionwise_conv_kernel_size=positionwise_conv_kernel_size,
            macaron_style=use_macaron_style_in_conformer,
            pos_enc_layer_type=pos_enc_type,
            selfattention_layer_type=selfattn_type,
            activation_type=conformer_activation_type,
            use_cnn_module=use_cnn_in_conformer,
            attn_backend=attn_backend,
        )
        self.encoder = ConformerEncoder(
            linear_units=eunits, num_blocks=elayers, input_layer="embed", idim=idim,
            normalize_before=encoder_normalize_before,
            cnn_module_kernel=conformer_enc_kernel_size,
            dropout_rate=transformer_enc_dropout_rate,
            positional_dropout_rate=transformer_enc_positional_dropout_rate,
            attention_dropout_rate=transformer_enc_attn_dropout_rate, **common,
        )
        self.stop_gradient_from_pitch_predictor = stop_gradient_from_pitch_predictor
        self.stop_gradient_from_energy_predictor = stop_gradient_from_energy_predictor
        self.init_type = init_type
        self.duration_predictor = DurationPredictor(
            adim, duration_predictor_layers, duration_predictor_chans,
            duration_predictor_kernel_size, duration_predictor_dropout_rate,
        )
        self.pitch_predictor = VariancePredictor(
            adim, pitch_predictor_layers, pitch_predictor_chans,
            pitch_predictor_kernel_size, pitch_predictor_dropout,
        )
        self.pitch_embed = nn.Sequential(
            nn.Conv1d(1, adim, pitch_embed_kernel_size, padding="same")
        )
        self.energy_predictor = VariancePredictor(
            adim, energy_predictor_layers, energy_predictor_chans,
            energy_predictor_kernel_size, energy_predictor_dropout,
        )
        self.energy_embed = nn.Sequential(
            nn.Conv1d(1, adim, energy_embed_kernel_size, padding="same")
        )
        self.decoder = ConformerEncoder(
            linear_units=dunits, num_blocks=dlayers, input_layer=None,
            normalize_before=decoder_normalize_before,
            cnn_module_kernel=conformer_dec_kernel_size,
            dropout_rate=transformer_dec_dropout_rate,
            positional_dropout_rate=transformer_dec_positional_dropout_rate,
            attention_dropout_rate=transformer_dec_attn_dropout_rate, **common,
        )
        self.feat_out = nn.Linear(adim, odim * reduction_factor)
        if postnet_layers > 0:
            self.postnet = Postnet(
                odim, postnet_layers, postnet_chans, postnet_filts, use_batch_norm,
                postnet_dropout_rate,
            )
        self.to(device=resolve_device(device), dtype=dtype)

    @contextlib.contextmanager
    def _deterministic(self):
        """Eval mode for the duration of a call, the mode restored after."""
        was_training = self.training
        self.eval()
        try:
            yield
        finally:
            self.train(was_training)

    def _encode(self, xs: torch.Tensor, ilens: torch.Tensor):
        t_text = xs.shape[1]
        hs = self.encoder(xs, attn_mask(ilens, t_text))
        return hs, sequence_mask(ilens, t_text)

    def encode(self, xs: torch.Tensor, ilens: torch.Tensor):
        """Encoder trunk -> (hs [B, T_text, adim], d_masks [B, T_text]),
        deterministic."""
        with self._deterministic():
            return self._encode(xs, ilens)

    def forward(
        self,
        xs: torch.Tensor,      # [B, T_text] token ids
        ilens: torch.Tensor,   # [B]
        ys: torch.Tensor,      # [B, T_feats, odim]
        olens: torch.Tensor,   # [B]
        ds: torch.Tensor,      # [B, T_text] int durations
        ps: torch.Tensor,      # [B, T_text, 1] token-averaged pitch
        es: torch.Tensor,      # [B, T_text, 1] token-averaged energy
    ) -> Dict[str, torch.Tensor]:
        """Training forward (the JAX ``__call__``): the predictors see the
        encoder output (detached for pitch/energy per
        ``stop_gradient_from_*``), the decoder sees it plus the embedded
        teacher pitch and energy, expanded by the given durations to
        ``ys.shape[1]`` frames. Returns before/after-postnet outputs, the
        predictions and ``ys``/``olens``, under the JAX package's keys."""
        hs, d_masks = self._encode(xs, ilens)
        p_in = hs.detach() if self.stop_gradient_from_pitch_predictor else hs
        p_outs = self.pitch_predictor(p_in, d_masks[..., None])
        e_in = hs.detach() if self.stop_gradient_from_energy_predictor else hs
        e_outs = self.energy_predictor(e_in, d_masks[..., None])
        d_outs = self.duration_predictor(hs, d_masks)

        e_emb = self.energy_embed(es.to(hs.dtype).transpose(1, 2)).transpose(1, 2)
        p_emb = self.pitch_embed(ps.to(hs.dtype).transpose(1, 2)).transpose(1, 2)
        hs = hs + e_emb + p_emb
        t_feats = ys.shape[1]
        hs = regulate_length(hs, ds, t_feats, d_masks)

        zs = self.decoder(hs, attn_mask(olens, t_feats))
        before_outs = self.feat_out(zs).reshape(zs.shape[0], -1, self.odim)
        after_outs = None
        if self.postnet_layers > 0:
            after_outs = before_outs + self.postnet(before_outs)
        return {
            "before_outs": before_outs,
            "after_outs": after_outs,
            "d_outs": d_outs,
            "p_outs": p_outs,
            "e_outs": e_outs,
            "ys": ys,
            "olens": olens,
        }

    def inference(
        self,
        xs: torch.Tensor,      # [B, T_text] token ids
        ilens: torch.Tensor,   # [B]
        max_t_feats: int,
        alpha: float = 1.0,
    ) -> Dict[str, torch.Tensor]:
        """Batched inference at a static output capacity, deterministic.
        Returns feat_gen [B, max_t_feats, odim] (zero past olens), duration
        [B, T_text] int32, pitch/energy [B, T_text, 1] and olens [B]."""
        with self._deterministic():
            return self._inference(xs, ilens, max_t_feats, alpha)

    def _inference(self, xs, ilens, max_t_feats, alpha):
        hs, d_masks = self._encode(xs, ilens)
        p_outs = self.pitch_predictor(hs, d_masks[..., None])
        e_outs = self.energy_predictor(hs, d_masks[..., None])
        d_log = self.duration_predictor(hs, d_masks)
        d_outs = predicted_durations_to_int(d_log, alpha) * d_masks.to(torch.int32)

        e_emb = self.energy_embed(e_outs.transpose(1, 2)).transpose(1, 2)
        p_emb = self.pitch_embed(p_outs.transpose(1, 2)).transpose(1, 2)
        hs = hs + e_emb + p_emb
        hs = regulate_length(hs, d_outs, max_t_feats, d_masks)
        olens = torch.clamp(d_outs.sum(dim=-1), max=max_t_feats)

        zs = self.decoder(hs, attn_mask(olens, max_t_feats))
        outs = self.feat_out(zs).reshape(zs.shape[0], -1, self.odim)
        if self.postnet_layers > 0:
            outs = outs + self.postnet(outs)
        outs = outs * sequence_mask(olens, max_t_feats, outs.dtype)[..., None]
        return {
            "feat_gen": outs,
            "duration": d_outs,
            "pitch": p_outs,
            "energy": e_outs,
            "olens": olens,
        }
