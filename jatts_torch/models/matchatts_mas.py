"""Matcha-TTS with implicit alignment, MAS (counterpart of
jatts_tpu/models/matchatts_mas.py).

The trunk of MatchaTTS; the training durations come from the monotonic
alignment search over the alignment module's lattice (``ops/mas.py:
viterbi_decode`` with ``mas_backend``: under ``auto`` the fused search
``csrc/mas_path.cu`` on CUDA tensors, the plain search on CPU tensors), and
the expansion is Gaussian upsampling over ``olens`` frames while the U-Net
sees the even ``olens_in``. Inference uses the predicted durations, also
upsampled by the Gaussian. Under ``duration_predictor_type: stochastic``
the flow of ``modules/flows.py`` (``sdp``) learns the NLL of the searched
durations and samples them at inference, its noise from the trainer's
noise generator and the ``generator`` argument as the CFM's is.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from jatts_torch.models.matchatts import MatchaTTS
from jatts_torch.modules.alignment import AlignmentModule
from jatts_torch.modules.flows import DURATION_PREDICTOR_TYPES, StochasticDurationPredictor
from jatts_torch.modules.layers import set_compute_dtype
from jatts_torch.ops.mas import viterbi_decode
from jatts_torch.ops.masks import sequence_mask
from jatts_torch.parallel.mesh import global_sum
from jatts_torch.ops.upsample import gaussian_upsampling


class MatchaTTS_MAS(MatchaTTS):  # noqa: N801 - the JAX package's class name
    def __init__(
        self,
        *args,
        duration_predictor_type: str = "deterministic",
        stochastic_duration_predictor_noise_scale: float = 0.8,
        mas_backend: str = "auto",
        device=None,
        dtype: Optional[torch.dtype] = torch.float32,
        **kwargs,
    ):
        if duration_predictor_type not in DURATION_PREDICTOR_TYPES:
            raise ValueError(f"duration_predictor_type {duration_predictor_type!r}")
        super().__init__(*args, device=device, dtype=dtype, **kwargs)
        self.duration_predictor_type = duration_predictor_type
        self.stochastic_duration_predictor_noise_scale = stochastic_duration_predictor_noise_scale
        self.mas_backend = mas_backend
        w = self.encoder_proj.weight
        adim = w.shape[1]
        if duration_predictor_type == "stochastic":
            # the flow replaces the conv predictor, which JAX never calls (and so never creates) then
            del self.duration_predictor
            kernel = kwargs.get("duration_predictor_kernel_size", 3)
            self.sdp = StochasticDurationPredictor(adim, kernel).to(device=w.device)
        self.alignment_module = AlignmentModule(adim, self.odim).to(device=w.device)
        set_compute_dtype(self, dtype)

    def forward(
        self,
        xs: torch.Tensor,
        ilens: torch.Tensor,
        ys: torch.Tensor,
        olens: torch.Tensor,
        spembs: Optional[torch.Tensor] = None,
        sids: Optional[torch.Tensor] = None,
        noise_t: Optional[torch.Tensor] = None,
        noise_z: Optional[torch.Tensor] = None,
        noise_e_q: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Training forward: MatchaTTS's outputs plus bin_loss, log_p_attn
        [B, T_feats, T_text] and the searched durations ds [B, T_text]
        (float32); dur_nll [B] is the stochastic predictor's NLL of ds over
        the batch's valid tokens (its e_q [B, T_text, 2] drawn unless
        given), None for the deterministic one."""
        hs, d_masks = self.encode(xs, ilens, spembs, sids)
        log_p_attn = self.alignment_module(hs, ys, d_masks)
        ds, bin_loss = viterbi_decode(log_p_attn, ilens, olens, backend=self.mas_backend)
        dur_nll = None
        if self.duration_predictor_type == "stochastic":
            dur_nll = self.sdp(hs, d_masks[..., None], w=ds[..., None], e_q=noise_e_q)
            dur_nll = dur_nll / global_sum(d_masks.sum()).clamp(min=1).to(dur_nll.dtype)
            d_outs = torch.zeros_like(ds)
        else:
            d_outs = self.duration_predictor(hs, d_masks)
        h_masks_frames = sequence_mask(olens, ys.shape[1], torch.float32)
        hs = self.encoder_proj(gaussian_upsampling(hs, ds, h_masks_frames, d_masks))
        olens_in, cfm_loss = self._decode_loss(hs, ys, olens, noise_t, noise_z)
        return {
            "d_outs": d_outs, "dur_nll": dur_nll, "ys": ys, "hs": hs, "olens_in": olens_in,
            "cfm_loss": cfm_loss, "bin_loss": bin_loss, "log_p_attn": log_p_attn, "ds": ds,
        }

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
        z_dur: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Predicted durations (the stochastic predictor's from its draw
        ``z_dur`` [B, T_text, 2], taken from ``generator`` before the ODE's
        noise unless given), Gaussian upsampling over the even olens, the
        Euler sampler; the outputs of ``MatchaTTS.inference``."""
        with self._deterministic():
            hs, d_masks = self.encode(xs, ilens, spembs, sids)
            if self.duration_predictor_type == "stochastic":
                d_outs = self.sdp(
                    hs, d_masks[..., None], inverse=True,
                    noise_scale=self.stochastic_duration_predictor_noise_scale, z=z_dur, generator=generator,
                ).to(torch.int32) * d_masks.to(torch.int32)
            else:
                d_outs = self._durations(hs, d_masks, alpha)
            olens = self._even_olens(d_outs, max_t_feats)
            h_masks = sequence_mask(olens, max_t_feats, torch.float32)
            hs = self.encoder_proj(gaussian_upsampling(hs, d_outs.float(), h_masks, d_masks))
            feat_gen = self._sample(hs, olens, max_t_feats, n_timesteps, temperature, generator, z)
        return {"feat_gen": feat_gen, "duration": d_outs, "olens": olens}
