"""mel-VITS: VAE + flow + MAS, no GAN (counterpart of jatts_tpu/models/vits.py).

Text encoder (conformer, prior m_p/logs_p) + posterior encoder (WaveNet
VAE over the mel) + residual affine coupling flow + monotonic alignment
search over the alignment module's lattice + Gaussian upsampling of the
prior + a conformer decoder over z -> mel. ``forward`` is the training
call (the JAX ``__call__``) and returns what the mel, KL and alignment
losses need; ``inference`` samples z_p from the upsampled prior, inverts
the flow and decodes, deterministic.

The search is ``ops/mas.py:viterbi_decode`` with ``mas_backend``: under
``auto`` the fused kernel ``csrc/mas_path.cu`` on CUDA tensors, the plain
search on CPU tensors. The conformers run on their eager attention: the
JAX model has no ``attn_backend``. ``duration_predictor_type: stochastic``
swaps the duration predictor for ``modules/flows.py``'s flow, trained on
the NLL of the searched durations. Noise: the posterior's eps and the
predictor's e_q from the modules' ``noise_generator`` (the trainer's),
the inference draws from the ``generator`` argument; ``samples_noise``
tells a caller (the serving bundle, the decode CLI) to hand one in. Keys
are the reference state_dict's, which
``jatts_tpu.utils.torch_import.convert_vits`` reads. ``dtype`` is flax's
compute dtype (``modules/layers.py``; ``None`` casts nothing): the text
and posterior encoders, the flow's WaveNets, the alignment module and the
decoder compute in it, as the JAX modules do; the stochastic predictor,
which takes no ``dtype`` there, stays float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.device import resolve_device
from jatts_torch.modules.alignment import AlignmentModule
from jatts_torch.modules.conformer import ConformerEncoder, resolve_rel_pos_types
from jatts_torch.modules.flows import DURATION_PREDICTOR_TYPES, StochasticDurationPredictor
from jatts_torch.modules.layers import Linear, set_compute_dtype
from jatts_torch.modules.predictors import DurationPredictor
from jatts_torch.modules.vits_modules import PosteriorEncoder, ResidualAffineCouplingBlock, TextEncoder
from jatts_torch.ops.mas import viterbi_decode
from jatts_torch.ops.masks import attn_mask, sequence_mask
from jatts_torch.parallel.mesh import global_sum
from jatts_torch.ops.upsample import gaussian_upsampling, predicted_durations_to_int


class VITS(nn.Module):
    samples_noise = True

    def __init__(
        self,
        idim: int,
        odim: int = 80,
        adim: int = 384,
        aheads: int = 2,
        text_encoder_ffn_expand: int = 4,
        text_encoder_blocks: int = 6,
        text_encoder_positionwise_conv_kernel_size: int = 3,
        use_macaron_style_in_text_encoder: bool = True,
        use_conformer_conv_in_text_encoder: bool = True,
        text_encoder_kernel_size: int = 7,
        text_encoder_dropout_rate: float = 0.2,
        text_encoder_positional_dropout_rate: float = 0.2,
        text_encoder_attention_dropout_rate: float = 0.2,
        dlayers: int = 4,
        dunits: int = 1536,
        decoder_positionwise_layer_type: str = "conv1d",
        decoder_positionwise_conv_kernel_size: int = 3,
        decoder_normalize_before: bool = True,
        use_macaron_style_in_conformer: bool = True,
        use_cnn_in_conformer: bool = True,
        conformer_dec_kernel_size: int = 31,
        transformer_dec_dropout_rate: float = 0.2,
        transformer_dec_positional_dropout_rate: float = 0.2,
        transformer_dec_attn_dropout_rate: float = 0.2,
        conformer_rel_pos_type: str = "legacy",
        conformer_pos_enc_layer_type: str = "rel_pos",
        conformer_self_attn_layer_type: str = "rel_selfattn",
        duration_predictor_type: str = "deterministic",
        mas_backend: str = "auto",
        duration_predictor_layers: int = 2,
        duration_predictor_chans: int = 256,
        duration_predictor_kernel_size: int = 3,
        duration_predictor_dropout_rate: float = 0.1,
        stochastic_duration_predictor_noise_scale: float = 0.8,
        posterior_encoder_kernel_size: int = 5,
        posterior_encoder_layers: int = 16,
        posterior_encoder_stacks: int = 1,
        posterior_encoder_base_dilation: int = 1,
        posterior_encoder_dropout_rate: float = 0.0,
        use_weight_norm_in_posterior_encoder: bool = True,
        flow_flows: int = 4,
        flow_kernel_size: int = 5,
        flow_base_dilation: int = 1,
        flow_layers: int = 4,
        flow_dropout_rate: float = 0.0,
        use_weight_norm_in_flow: bool = True,
        use_only_mean_in_flow: bool = True,
        reduction_factor: int = 1,
        spk_embed_dim: Optional[int] = None,
        spk_embed_integration_type: str = "add",
        spks: Optional[int] = None,
        use_masking: bool = True,
        init_type: str = "xavier_uniform",
        device: Optional[Union[str, torch.device]] = None,
        dtype: Optional[torch.dtype] = torch.float32,
    ):
        super().__init__()
        if duration_predictor_type not in DURATION_PREDICTOR_TYPES:
            raise ValueError(f"duration_predictor_type {duration_predictor_type!r}")
        if spk_embed_integration_type not in ("add", "concat"):
            raise ValueError(f"spk_embed_integration_type {spk_embed_integration_type!r}")
        self.odim = odim
        self.init_type = init_type
        self.duration_predictor_type = duration_predictor_type
        self.stochastic_duration_predictor_noise_scale = stochastic_duration_predictor_noise_scale
        self.mas_backend = mas_backend
        self.spk_embed_dim = spk_embed_dim
        self.spk_embed_integration_type = spk_embed_integration_type
        pos_enc_type, selfattn_type = resolve_rel_pos_types(
            conformer_rel_pos_type, conformer_pos_enc_layer_type, conformer_self_attn_layer_type,
        )
        self.text_encoder = TextEncoder(
            idim, adim, aheads, adim * text_encoder_ffn_expand, text_encoder_blocks,
            text_encoder_positionwise_conv_kernel_size, use_macaron_style_in_text_encoder,
            use_conformer_conv_in_text_encoder, text_encoder_kernel_size, text_encoder_dropout_rate,
            text_encoder_positional_dropout_rate, text_encoder_attention_dropout_rate,
            pos_enc_type, selfattn_type,
        )
        if spk_embed_dim is not None and spk_embed_dim > 0:
            in_dim = spk_embed_dim if spk_embed_integration_type == "add" else adim + spk_embed_dim
            self.projection = Linear(in_dim, adim)
        glob = spk_embed_dim if spk_embed_dim else -1
        self.posterior_encoder = PosteriorEncoder(
            odim, adim, adim, posterior_encoder_kernel_size, posterior_encoder_layers,
            posterior_encoder_stacks, posterior_encoder_base_dilation, glob,
            posterior_encoder_dropout_rate, use_weight_norm_in_posterior_encoder,
        )
        self.flow = ResidualAffineCouplingBlock(
            adim, adim, flow_flows, flow_kernel_size, flow_base_dilation, flow_layers, glob,
            flow_dropout_rate, use_weight_norm_in_flow, use_only_mean_in_flow,
        )
        if duration_predictor_type == "stochastic":
            self.duration_predictor = StochasticDurationPredictor(
                adim, duration_predictor_kernel_size, duration_predictor_dropout_rate,
            )
        else:
            self.duration_predictor = DurationPredictor(
                adim, duration_predictor_layers, duration_predictor_chans,
                duration_predictor_kernel_size, duration_predictor_dropout_rate,
            )
        self.alignment_module = AlignmentModule(adim, odim)
        self.decoder = ConformerEncoder(
            attention_dim=adim, attention_heads=aheads, linear_units=dunits, num_blocks=dlayers,
            input_layer=None, normalize_before=decoder_normalize_before,
            positionwise_layer_type=decoder_positionwise_layer_type,
            positionwise_conv_kernel_size=decoder_positionwise_conv_kernel_size,
            macaron_style=use_macaron_style_in_conformer, use_cnn_module=use_cnn_in_conformer,
            cnn_module_kernel=conformer_dec_kernel_size, pos_enc_layer_type=pos_enc_type,
            selfattention_layer_type=selfattn_type, dropout_rate=transformer_dec_dropout_rate,
            positional_dropout_rate=transformer_dec_positional_dropout_rate,
            attention_dropout_rate=transformer_dec_attn_dropout_rate,
        )
        self.feat_out = Linear(adim, odim * reduction_factor)
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

    def _encode(self, xs, ilens, spembs):
        """Text encoder and speaker inputs -> hs, m_p, logs_p, d_masks [B,
        T_text] and the WaveNets' global vector g [B, 1, spk_embed_dim]."""
        hs, m_p, logs_p, _ = self.text_encoder(xs, ilens)
        if self.spk_embed_dim is not None and spembs is not None:
            hs = self._integrate_spembs(hs, spembs)
        g = spembs[:, None, :] if spembs is not None else None
        return hs, m_p, logs_p, sequence_mask(ilens, xs.shape[1]), g

    def _decode(self, z, olens, t_feats):
        zs = self.decoder(z, attn_mask(olens, t_feats))
        return self.feat_out(zs).reshape(zs.shape[0], -1, self.odim)

    def forward(
        self,
        xs: torch.Tensor,      # [B, T_text] token ids
        ilens: torch.Tensor,   # [B]
        ys: torch.Tensor,      # [B, T_feats, odim]
        olens: torch.Tensor,   # [B]
        spembs: Optional[torch.Tensor] = None,
        sids: Optional[torch.Tensor] = None,
        noise_eps: Optional[torch.Tensor] = None,  # [B, T_feats, adim], else drawn
        noise_e_q: Optional[torch.Tensor] = None,  # [B, T_text, 2] (stochastic), else drawn
    ) -> Dict[str, torch.Tensor]:
        """Training forward in the model's current mode: the JAX package's
        dict (outs, dur_nll, d_outs, ys, olens_in, bin_loss, log_p_attn, ds
        [B, T_text] f32, the upsampled m_p and logs_p, m_q, logs_q, z, z_p,
        y_mask [B, T_feats, 1])."""
        t_feats = ys.shape[1]
        hs, m_p, logs_p, d_masks, g = self._encode(xs, ilens, spembs)
        z, m_q, logs_q, y_mask = self.posterior_encoder(ys, olens, g=g, eps=noise_eps)
        z_p = self.flow(z, y_mask, g=g)

        log_p_attn = self.alignment_module(hs, ys, d_masks)
        ds, bin_loss = viterbi_decode(log_p_attn, ilens, olens, backend=self.mas_backend)
        dur_nll = None
        if self.duration_predictor_type == "stochastic":
            dur_nll = self.duration_predictor(hs, d_masks[..., None], w=ds[..., None], e_q=noise_e_q)
            dur_nll = dur_nll / global_sum(d_masks.sum()).clamp(min=1).to(dur_nll.dtype)
            d_outs = torch.zeros_like(ds)
        else:
            d_outs = self.duration_predictor(hs, d_masks)

        frame_mask = sequence_mask(olens, t_feats, torch.float32)
        m_p = gaussian_upsampling(m_p, ds, frame_mask, d_masks)
        logs_p = gaussian_upsampling(logs_p, ds, frame_mask, d_masks)
        outs = self._decode(z, olens, t_feats)
        return {
            "outs": outs, "dur_nll": dur_nll, "d_outs": d_outs, "ys": ys, "olens_in": olens,
            "bin_loss": bin_loss, "log_p_attn": log_p_attn, "ds": ds, "m_p": m_p, "logs_p": logs_p,
            "m_q": m_q, "logs_q": logs_q, "z": z, "z_p": z_p, "y_mask": y_mask,
        }

    def _durations(self, hs, d_masks, alpha, generator, z_dur):
        if self.duration_predictor_type == "stochastic":
            d = self.duration_predictor(
                hs, d_masks[..., None], inverse=True,
                noise_scale=self.stochastic_duration_predictor_noise_scale, z=z_dur, generator=generator,
            )
            return d.to(torch.int32) * d_masks.to(torch.int32)
        d_log = self.duration_predictor(hs, d_masks)
        return predicted_durations_to_int(d_log, alpha) * d_masks.to(torch.int32)

    @torch.no_grad()
    def inference(
        self,
        xs: torch.Tensor,
        ilens: torch.Tensor,
        max_t_feats: int,
        spembs: Optional[torch.Tensor] = None,
        sids: Optional[torch.Tensor] = None,
        noise_scale: float = 0.667,
        alpha: float = 1.0,
        generator: Optional[torch.Generator] = None,
        eps: Optional[torch.Tensor] = None,
        z_dur: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Predicted durations -> olens = min(max(sum d, 1), max_t_feats) ->
        the Gaussian-upsampled prior -> z_p = m_p + eps · exp(logs_p) ·
        noise_scale -> the inverse flow -> the decoder, masked: feat_gen
        [B, max_t_feats, odim], duration [B, T_text] int32, olens [B]. eps
        [B, max_t_feats, adim] (and the stochastic predictor's z_dur [B,
        T_text, 2]) are N(0, 1) draws from ``generator`` unless given."""
        with self._deterministic():
            hs, m_p, logs_p, d_masks, g = self._encode(xs, ilens, spembs)
            d_outs = self._durations(hs, d_masks, alpha, generator, z_dur)
            olens = torch.clamp(d_outs.sum(dim=-1), min=1, max=max_t_feats)
            frame_mask = sequence_mask(olens, max_t_feats, torch.float32)
            m_p = gaussian_upsampling(m_p, d_outs.float(), frame_mask, d_masks)
            logs_p = gaussian_upsampling(logs_p, d_outs.float(), frame_mask, d_masks)
            if eps is None:
                eps = torch.randn(m_p.shape, generator=generator, device=m_p.device, dtype=m_p.dtype)
            z_p = m_p + eps * torch.exp(logs_p) * noise_scale
            y_mask = frame_mask[..., None].to(z_p.dtype)
            z = self.flow(z_p, y_mask, g=g, inverse=True)
            outs = self._decode(z, olens, max_t_feats) * y_mask
        return {"feat_gen": outs, "duration": d_outs, "olens": olens}
