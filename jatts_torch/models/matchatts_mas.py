"""Matcha-TTS with implicit alignment, MAS (counterpart of
jatts_tpu/models/matchatts_mas.py).

The trunk of MatchaTTS; the training durations come from the monotonic
alignment search over the alignment module's lattice (``ops/mas.py:
viterbi_decode`` with ``mas_backend``: under ``auto`` the fused search
``csrc/mas_path.cu`` on CUDA tensors, the plain search on CPU tensors), and
the expansion is Gaussian upsampling over ``olens`` frames while the U-Net
sees the even ``olens_in``. Inference uses the predicted durations, also
upsampled by the Gaussian. The stochastic duration predictor
(``duration_predictor_type: stochastic``, ``modules/flows.py``) is not
ported: it lands with VITS.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from jatts_torch.models.matchatts import MatchaTTS
from jatts_torch.modules.alignment import AlignmentModule
from jatts_torch.ops.mas import viterbi_decode
from jatts_torch.ops.masks import sequence_mask
from jatts_torch.ops.upsample import gaussian_upsampling


class MatchaTTS_MAS(MatchaTTS):  # noqa: N801 - the JAX package's class name
    def __init__(
        self,
        *args,
        duration_predictor_type: str = "deterministic",
        stochastic_duration_predictor_noise_scale: float = 0.8,
        mas_backend: str = "auto",
        device=None,
        dtype: torch.dtype = torch.float32,
        **kwargs,
    ):
        if duration_predictor_type != "deterministic":
            raise ValueError(
                f"duration_predictor_type {duration_predictor_type!r} is not ported: the stochastic "
                "duration predictor (jatts_tpu/modules/flows.py) lands with VITS"
            )
        super().__init__(*args, device=device, dtype=dtype, **kwargs)
        self.duration_predictor_type = duration_predictor_type
        self.stochastic_duration_predictor_noise_scale = stochastic_duration_predictor_noise_scale
        self.mas_backend = mas_backend
        w = self.encoder_proj.weight
        self.alignment_module = AlignmentModule(w.shape[1], self.odim).to(device=w.device, dtype=dtype)

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
    ) -> Dict[str, torch.Tensor]:
        """Training forward: MatchaTTS's outputs plus bin_loss, log_p_attn
        [B, T_feats, T_text] and the searched durations ds [B, T_text]
        (float32); dur_nll is None (no stochastic predictor)."""
        hs, d_masks = self.encode(xs, ilens, spembs, sids)
        log_p_attn = self.alignment_module(hs, ys, d_masks)
        ds, bin_loss = viterbi_decode(log_p_attn, ilens, olens, backend=self.mas_backend)
        d_outs = self.duration_predictor(hs, d_masks)
        h_masks_frames = sequence_mask(olens, ys.shape[1], torch.float32)
        hs = self.encoder_proj(gaussian_upsampling(hs, ds, h_masks_frames, d_masks))
        olens_in, cfm_loss = self._decode_loss(hs, ys, olens, noise_t, noise_z)
        return {
            "d_outs": d_outs, "dur_nll": None, "ys": ys, "hs": hs, "olens_in": olens_in,
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
    ) -> Dict[str, torch.Tensor]:
        """Predicted durations, Gaussian upsampling over the even olens,
        the Euler sampler; the outputs of ``MatchaTTS.inference``."""
        with self._deterministic():
            hs, d_masks = self.encode(xs, ilens, spembs, sids)
            d_outs = self._durations(hs, d_masks, alpha)
            olens = self._even_olens(d_outs, max_t_feats)
            h_masks = sequence_mask(olens, max_t_feats, torch.float32)
            hs = self.encoder_proj(gaussian_upsampling(hs, d_outs.float(), h_masks, d_masks))
            feat_gen = self._sample(hs, olens, max_t_feats, n_timesteps, temperature, generator, z)
        return {"feat_gen": feat_gen, "duration": d_outs, "olens": olens}
