"""Vocoders for stage-4 decode (counterpart of jatts_tpu/vocoder/vocoder.py).

``Vocoder.decode``: denormalize a mel by the acoustic model's stats,
renormalize it by the vocoder's training stats, pad it to a multiple of 64
frames and run the HiFi-GAN generator on ``device``. The checkpoint is a
parallel_wavegan pickle (``{"model": {"generator": state_dict}}``, weight
norm as ``weight_g``/``weight_v`` pairs); the pairs are folded into plain
weights and the result loads straight into ``HiFiGANGenerator``, whose keys
are parallel_wavegan's. ``GriffinLimVocoder`` inverts the mel with
``ops/dsp.py:griffin_lim`` and needs no weights.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from jatts_torch.device import resolve_device
from jatts_torch.ops.dsp import griffin_lim
from jatts_torch.utils.io import read_array
from jatts_torch.vocoder.hifigan import HiFiGANGenerator


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The generator's state_dict of a parallel_wavegan checkpoint: the
    ``model`` entry, then its ``generator`` entry, where present. A
    parallel_wavegan pickle holds more than tensors, so it is unpickled in
    full: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "generator" in ckpt:
        ckpt = ckpt["generator"]
    return {k: torch.as_tensor(v) for k, v in ckpt.items()}


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold each ``weight_g``/``weight_v`` pair into ``weight = g * v /
    ||v||`` (the norm over every dimension but the first)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            g = sd[base + "weight_g"]
            norm = v.reshape(v.shape[0], -1).pow(2).sum(dim=1).sqrt()
            out[base + "weight"] = v * (g.reshape(-1) / norm.clamp(min=1e-12)).reshape(
                -1, *([1] * (v.dim() - 1))
            )
        elif not k.endswith("weight_g"):
            out[k] = v
    return out


class Vocoder:
    def __init__(
        self,
        checkpoint: str,
        config: Union[str, Dict[str, Any]],
        stats: Optional[str] = None,
        pad_multiple: int = 64,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if isinstance(config, str):
            import yaml

            with open(config) as f:
                config = yaml.load(f, Loader=yaml.SafeLoader)
        self.config = config
        self.device = resolve_device(device)
        gp = dict(config.get("generator_params", {}))
        scales = tuple(gp.get("upsample_scales", (5, 5, 4, 3)))
        self.model = HiFiGANGenerator(
            in_channels=gp.get("in_channels", config.get("num_mels", 80)),
            out_channels=gp.get("out_channels", 1),
            channels=gp.get("channels", 512),
            kernel_size=gp.get("kernel_size", 7),
            upsample_scales=scales,
            upsample_kernel_sizes=tuple(gp.get("upsample_kernel_sizes", [2 * s for s in scales])),
            resblock_kernel_sizes=tuple(gp.get("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilations=tuple(tuple(d) for d in gp.get("resblock_dilations", ((1, 3, 5),) * 3)),
            use_additional_convs=gp.get("use_additional_convs", True),
            device=self.device,
        )
        self.model.load_state_dict(fold_weight_norm(load_torch_state_dict(checkpoint)), strict=True)
        self.hop_size = self.model.hop_size
        self.sampling_rate = int(config.get("sampling_rate", 24000))
        self.mean = self.scale = None
        if stats is not None:
            self.mean = np.asarray(read_array(stats, "mean"))
            self.scale = np.asarray(read_array(stats, "scale"))
        self.pad_multiple = pad_multiple

    def decode(
        self,
        mel: np.ndarray,
        model_mean: Optional[np.ndarray] = None,
        model_scale: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """mel: [T, num_mels] normalized by the acoustic model's stats ->
        waveform [T * hop]."""
        start = time.time()
        if model_mean is not None:
            mel = mel * model_scale + model_mean  # denorm by the model's stats
        if self.mean is not None:
            mel = (mel - self.mean) / self.scale  # renorm by the vocoder's
        t = mel.shape[0]
        pad_t = -(-t // self.pad_multiple) * self.pad_multiple
        mel_p = np.pad(mel.astype(np.float32), ((0, pad_t - t), (0, 0)))
        with torch.no_grad():
            wav = self.model(torch.from_numpy(mel_p[None]).to(self.device))[0, :, 0]
        wav = wav[: t * self.hop_size].cpu().numpy()
        rtf = (time.time() - start) / (len(wav) / self.sampling_rate)
        logging.debug(f"vocoder RTF = {rtf:.6f}")
        return wav


class GriffinLimVocoder:
    """Weights-free mel inversion with the ``Vocoder.decode`` interface, for
    ``tts_decode --vocoder griffin_lim`` or when no vocoder checkpoint is
    found. Expects mels normalized by the acoustic model's stats."""

    def __init__(
        self,
        config: Dict[str, Any],
        n_iter: int = 32,
        pad_multiple: int = 64,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.sampling_rate = int(config.get("sampling_rate", 24000))
        self.fft_size = int(config.get("fft_size", 2048))
        self.hop_size = int(config.get("hop_size", 300))
        self.num_mels = int(config.get("num_mels", 80))
        self.fmin = config.get("fmin", 80)
        self.fmax = config.get("fmax", 7600)
        self.n_iter = n_iter
        self.pad_multiple = pad_multiple

    def decode(
        self,
        mel: np.ndarray,
        model_mean: Optional[np.ndarray] = None,
        model_scale: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        start = time.time()
        if model_mean is not None:
            mel = mel * model_scale + model_mean
        t = mel.shape[0]
        # the same edge padding to a multiple of pad_multiple frames as the
        # JAX package, so both invert the same frames
        t_pad = -(-t // self.pad_multiple) * self.pad_multiple
        mel_p = np.pad(mel, ((0, t_pad - t), (0, 0)), mode="edge")
        wav = griffin_lim(
            torch.as_tensor(mel_p, dtype=torch.float32, device=self.device), self.sampling_rate,
            fft_size=self.fft_size, hop_size=self.hop_size, num_mels=self.num_mels,
            fmin=None if self.fmin is None else float(self.fmin),
            fmax=None if self.fmax is None else float(self.fmax),
            n_iter=self.n_iter, length=t_pad * self.hop_size,
        )
        wav = wav[: t * self.hop_size].cpu().numpy()
        rtf = (time.time() - start) / max(len(wav) / self.sampling_rate, 1e-9)
        logging.info(f"griffin-lim: generated {len(wav)} samples (RTF {rtf:.3f})")
        return wav
