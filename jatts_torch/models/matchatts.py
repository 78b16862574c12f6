"""Matcha-TTS with external durations (counterpart of
jatts_tpu/models/matchatts.py).

Conformer encoder -> duration predictor -> matmul length regulator ->
``encoder_proj`` to odim -> the CFM U-Net decoder. ``forward`` is the
training call (the JAX ``__call__``): it returns the CFM loss and the
tensors of the encoder prior loss; ``inference`` runs the fixed-step Euler
sampler at a static output capacity, deterministic. Parameters carry the
reference state_dict keys, so ``jatts_tpu.utils.torch_import.convert_matchatts``
reads ``state_dict()`` as it stands.

The encoder is the conformer of FastSpeech2 on its eager attention: the JAX
model has no ``attn_backend``, so its encoder never reaches the flash
kernel, and the port keeps it so. Speaker inputs as FastSpeech2's:
``sid_emb`` (``spks > 1``) and ``projection`` of the L2-normalised
``spembs`` (``spk_embed_dim``). The U-Net halves and doubles the time axis,
so training uses ``olens - olens % 2`` frames and inference an even
``olens``. The ODE noise comes from an explicit ``torch.Generator``
(``generator``) or the CFM's ``noise_generator``; ``samples_noise`` tells a
caller (the serving bundle, the decode CLI) to hand one in. ``dtype`` is
flax's compute dtype (``modules/layers.py``; ``None`` casts nothing), as in
``models/fastspeech2.py``; the sampler's mask, noise and output stay
float32 under it, as the JAX model's do.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.device import resolve_device
from jatts_torch.modules.cfm import CFM
from jatts_torch.modules.conformer import ConformerEncoder, resolve_rel_pos_types
from jatts_torch.modules.layers import Linear, set_compute_dtype
from jatts_torch.modules.predictors import DurationPredictor
from jatts_torch.ops.masks import attn_mask, sequence_mask
from jatts_torch.ops.upsample import predicted_durations_to_int, regulate_length


class MatchaTTS(nn.Module):
    samples_noise = True

    def __init__(
        self,
        idim: int,
        odim: int = 80,
        adim: int = 384,
        aheads: int = 2,
        elayers: int = 4,
        eunits: int = 1536,
        positionwise_layer_type: str = "conv1d",
        positionwise_conv_kernel_size: int = 3,
        encoder_normalize_before: bool = True,
        reduction_factor: int = 1,
        encoder_type: str = "conformer",
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
        transformer_enc_dropout_rate: float = 0.2,
        transformer_enc_positional_dropout_rate: float = 0.2,
        transformer_enc_attn_dropout_rate: float = 0.2,
        decoder_channels: Sequence[int] = (256, 256),
        decoder_dropout: float = 0.05,
        decoder_attention_head_dim: int = 64,
        decoder_n_blocks: int = 1,
        decoder_num_mid_blocks: int = 2,
        decoder_num_heads: int = 2,
        decoder_act_fn: str = "snakebeta",
        spk_embed_dim: Optional[int] = None,
        spk_embed_integration_type: str = "add",
        spks: Optional[int] = None,
        use_masking: bool = True,
        init_type: str = "xavier_uniform",
        device: Optional[Union[str, torch.device]] = None,
        dtype: Optional[torch.dtype] = torch.float32,
    ):
        super().__init__()
        if encoder_type != "conformer":
            raise ValueError("only the conformer encoder is supported")
        if spk_embed_integration_type not in ("add", "concat"):
            raise ValueError(f"spk_embed_integration_type {spk_embed_integration_type!r}")
        self.odim = odim
        self.init_type = init_type
        pos_enc_type, selfattn_type = resolve_rel_pos_types(
            conformer_rel_pos_type, conformer_pos_enc_layer_type, conformer_self_attn_layer_type,
        )
        self.encoder = ConformerEncoder(
            attention_dim=adim, attention_heads=aheads, linear_units=eunits, num_blocks=elayers,
            input_layer="embed", idim=idim, normalize_before=encoder_normalize_before,
            positionwise_layer_type=positionwise_layer_type,
            positionwise_conv_kernel_size=positionwise_conv_kernel_size,
            macaron_style=use_macaron_style_in_conformer, pos_enc_layer_type=pos_enc_type,
            selfattention_layer_type=selfattn_type, activation_type=conformer_activation_type,
            use_cnn_module=use_cnn_in_conformer, cnn_module_kernel=conformer_enc_kernel_size,
            dropout_rate=transformer_enc_dropout_rate,
            positional_dropout_rate=transformer_enc_positional_dropout_rate,
            attention_dropout_rate=transformer_enc_attn_dropout_rate,
        )
        self.spks = spks
        self.spk_embed_dim = spk_embed_dim
        self.spk_embed_integration_type = spk_embed_integration_type
        if spks is not None and spks > 1:
            self.sid_emb = nn.Embedding(spks, adim)
        if spk_embed_dim is not None and spk_embed_dim > 0:
            in_dim = spk_embed_dim if spk_embed_integration_type == "add" else adim + spk_embed_dim
            self.projection = Linear(in_dim, adim)
        self.duration_predictor = DurationPredictor(
            adim, duration_predictor_layers, duration_predictor_chans,
            duration_predictor_kernel_size, duration_predictor_dropout_rate,
        )
        self.encoder_proj = Linear(adim, odim * reduction_factor)
        self.decoder = CFM(
            out_channels=odim * reduction_factor, channels=tuple(decoder_channels),
            dropout_rate=decoder_dropout, attention_head_dim=decoder_attention_head_dim,
            n_blocks=decoder_n_blocks, num_mid_blocks=decoder_num_mid_blocks,
            num_heads=decoder_num_heads, act_fn=decoder_act_fn,
        )
        self.compute_dtype = None
        set_compute_dtype(self, dtype)
        self.to(device=resolve_device(device))

    @contextlib.contextmanager
    def _deterministic(self):
        """Eval mode for the duration of a call, the mode restored after."""
        was_training = self.training
        self.eval()
        try:
            yield
        finally:
            self.train(was_training)

    def _integrate_spembs(self, hs: torch.Tensor, spembs: torch.Tensor) -> torch.Tensor:
        spembs = F.normalize(spembs.float(), dim=-1, eps=1e-12).to(hs.dtype)
        if self.spk_embed_integration_type == "add":
            return hs + self.projection(spembs)[:, None, :]
        spembs = spembs[:, None, :].expand(-1, hs.shape[1], -1)
        return self.projection(torch.cat([hs, spembs], dim=-1))

    def encode(self, xs, ilens, spembs=None, sids=None):
        """Encoder trunk with the speaker inputs -> (hs [B, T_text, adim],
        d_masks [B, T_text]) in the model's current mode."""
        t_text = xs.shape[1]
        hs = self.encoder(xs, attn_mask(ilens, t_text))
        if self.spks is not None and self.spks > 1 and sids is not None:
            hs = hs + self.sid_emb(sids.reshape(-1))[:, None, :]
        if self.spk_embed_dim is not None and spembs is not None:
            hs = self._integrate_spembs(hs, spembs)
        return hs, sequence_mask(ilens, t_text)

    def _decode_loss(self, hs, ys, olens, noise_t, noise_z):
        """The CFM loss on the even part of each utterance."""
        t_feats = ys.shape[1]
        olens_in = olens - olens % 2
        h_masks = sequence_mask(olens_in, t_feats, ys.dtype)
        m = h_masks[..., None]
        cfm_loss, _ = self.decoder(ys * m, h_masks, hs * m, t=noise_t, z=noise_z)
        return olens_in, cfm_loss

    def forward(
        self,
        xs: torch.Tensor,      # [B, T_text] token ids
        ilens: torch.Tensor,   # [B]
        ys: torch.Tensor,      # [B, T_feats, odim], T_feats even
        olens: torch.Tensor,   # [B]
        ds: torch.Tensor,      # [B, T_text] int durations
        spembs: Optional[torch.Tensor] = None,
        sids: Optional[torch.Tensor] = None,
        noise_t: Optional[torch.Tensor] = None,  # [B, 1, 1], else drawn
        noise_z: Optional[torch.Tensor] = None,  # like ys, else drawn
    ) -> Dict[str, torch.Tensor]:
        """Training forward: d_outs (log durations), ys, hs (the projected,
        expanded encoder output), olens_in and cfm_loss, under the JAX
        package's keys."""
        hs, d_masks = self.encode(xs, ilens, spembs, sids)
        d_outs = self.duration_predictor(hs, d_masks)
        hs = self.encoder_proj(regulate_length(hs, ds, ys.shape[1], d_masks))
        olens_in, cfm_loss = self._decode_loss(hs, ys, olens, noise_t, noise_z)
        return {"d_outs": d_outs, "ys": ys, "hs": hs, "olens_in": olens_in, "cfm_loss": cfm_loss}

    def _durations(self, hs, d_masks, alpha):
        d_log = self.duration_predictor(hs, d_masks)
        return predicted_durations_to_int(d_log, alpha) * d_masks.to(torch.int32)

    @staticmethod
    def _even_olens(d_outs, max_t_feats):
        olens = torch.clamp(d_outs.sum(dim=-1), min=1, max=max_t_feats)
        return olens - olens % 2

    def _sample(self, hs, olens, max_t_feats, n_timesteps, temperature, generator, z):
        # a float32 mask under a compute dtype, as the JAX model's: mu, the
        # noise and the sample are float32 then
        h_masks = sequence_mask(olens, max_t_feats, hs.dtype if self.compute_dtype is None else torch.float32)
        m = h_masks[..., None]
        feat_gen = self.decoder.inference(hs * m, h_masks, n_timesteps, temperature, z=z, generator=generator)
        return feat_gen * m

    @torch.no_grad()
    def inference(
        self,
        xs: torch.Tensor,
        ilens: torch.Tensor,
        max_t_feats: int,
        spembs: Optional[torch.Tensor] = None,
        sids: Optional[torch.Tensor] = None,
        n_timesteps: int = 10,
        temperature: float = 0.667,
        alpha: float = 1.0,
        generator: Optional[torch.Generator] = None,
        z: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Batched inference at a static capacity ``max_t_feats`` (even),
        deterministic: feat_gen [B, max_t_feats, odim] (zero past olens),
        duration [B, T_text] int32, olens [B] (even, >= 0)."""
        with self._deterministic():
            hs, d_masks = self.encode(xs, ilens, spembs, sids)
            d_outs = self._durations(hs, d_masks, alpha)
            hs = self.encoder_proj(regulate_length(hs, d_outs, max_t_feats, d_masks))
            olens = self._even_olens(d_outs, max_t_feats)
            feat_gen = self._sample(hs, olens, max_t_feats, n_timesteps, temperature, generator, z)
        return {"feat_gen": feat_gen, "duration": d_outs, "olens": olens}
