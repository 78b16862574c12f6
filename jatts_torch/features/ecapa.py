"""ECAPA-TDNN speaker-embedding extractor (counterpart of
jatts_tpu/features/ecapa.py).

The reference extracts speaker embeddings with speechbrain's pretrained
``spkrec-ecapa-voxceleb`` EncoderClassifier (reference
jatts/modules/feature_extract/spkemb_speechbrain.py:14-30). This module is
the whole pipeline without speechbrain:

  wav (16 kHz) -> log-mel fbank (25 ms / 10 ms, 80 mel, periodic Hamming)
      -> per-utterance mean norm -> ECAPA-TDNN -> 192-d embedding

at speechbrain's published widths: channels (1024, 1024, 1024, 1024,
3072), kernels (5, 3, 3, 3, 1), dilations (1, 2, 3, 4, 1), Res2Net scale
8, SE bottleneck 128, attentive statistics pooling with global context,
192-d output.

The modules are channels-first ``[B, C, T]`` (cuDNN's layout) and their
parameters carry speechbrain's keys (``blocks.0.conv.conv.weight``,
``asp_bn.norm.running_mean``, ...: speechbrain's Conv1d owns an inner
``.conv``, its BatchNorm1d an inner ``.norm``), so speechbrain's
``embedding_model.ckpt`` loads with ``load_state_dict(strict=True)``.

What follows the JAX package rather than speechbrain, on purpose: the
convolutions pad with zeros (flax ``padding="SAME"``; speechbrain pads by
reflection), audio is padded to a 1 s bucket (after the first BatchNorm the
padded frames are no longer zero and reach the valid ones through the
convolutions, so the bucket is part of the result), and the pooling's
masked ``-inf`` softmax and ``sqrt(max(var, 1e-12))``. BatchNorm always
reads the running statistics: the model is inference-only, as in the JAX
package. Convolutions run in full float32 (TF32 off), as the JAX package
computes them.
"""

from __future__ import annotations

import logging
import re
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Fbank front end (speechbrain's Fbank for the voxceleb recipe: 16 kHz,
# n_fft 400, a 25 ms Hamming window, 10 ms hop, 80 HTK-mel filters 0..8 kHz,
# power spectrum, 10*log10 dB with top_db 80)
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank_htk(
    n_mels: int, n_fft: int, sr: float, fmin: float = 0.0, fmax: Optional[float] = None
) -> np.ndarray:
    """Triangular HTK-mel filter matrix [n_fft//2+1, n_mels]."""
    fmax = fmax or sr / 2
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    lo, ctr, hi = pts[:-2], pts[1:-1], pts[2:]
    up = (freqs[:, None] - lo[None, :]) / (ctr - lo)[None, :]
    down = (hi[None, :] - freqs[:, None]) / (hi - ctr)[None, :]
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def fbank(
    wav: torch.Tensor, sr: int = 16000, n_fft: int = 400, hop: int = 160, n_mels: int = 80
) -> torch.Tensor:
    """Log-mel fbank ``[B, T, n_mels]`` of ``[B, S]`` 16 kHz audio, on the
    audio's device."""
    dev = wav.device
    # the PERIODIC Hamming window (torch.hamming_window's default, what
    # speechbrain's Fbank trains with): the symmetric window of N+1 without
    # its last sample
    win = torch.as_tensor(np.hamming(n_fft + 1)[:-1].astype(np.float32), device=dev)
    pad = n_fft // 2
    x = F.pad(wav.float(), (pad, pad))  # centred, constant
    n_frames = 1 + (x.shape[1] - n_fft) // hop
    frames = x.unfold(1, n_fft, hop)[:, :n_frames] * win  # [B, T, n_fft]
    power = torch.fft.rfft(frames, n=n_fft).abs() ** 2
    mel = power @ torch.as_tensor(mel_filterbank_htk(n_mels, n_fft, sr), device=dev)
    db = 10.0 * torch.log10(mel.clamp(min=1e-10))
    # top_db clamp against the max of the whole batch (speechbrain's Filterbank)
    return torch.maximum(db, db.max() - 80.0)


# ---------------------------------------------------------------------------
# ECAPA-TDNN, channels-first, speechbrain's keys
# ---------------------------------------------------------------------------


class Conv1d(nn.Module):
    """speechbrain's Conv1d wrapper (inner ``.conv``), zero 'same' padding."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, d: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, k, dilation=d, padding="same", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class BatchNorm1d(nn.Module):
    """speechbrain's BatchNorm1d wrapper (inner ``.norm``), always on the
    running statistics."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.norm = nn.BatchNorm1d(ch, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        return F.batch_norm(x, n.running_mean, n.running_var, n.weight, n.bias, training=False, eps=n.eps)


class TDNNBlock(nn.Module):
    """Conv1d -> ReLU -> BatchNorm (speechbrain's TDNNBlock order)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, d: int = 1, device=None):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, k, d, device=device)
        self.norm = BatchNorm1d(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(torch.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    def __init__(self, ch: int, scale: int = 8, k: int = 3, d: int = 1, device=None):
        super().__init__()
        hidden = ch // scale
        self.scale = scale
        self.blocks = nn.ModuleList(TDNNBlock(hidden, hidden, k, d, device=device) for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.scale, dim=1)
        ys = [chunks[0]]
        y = None
        for i in range(1, self.scale):
            y = self.blocks[i - 1](chunks[i] if i == 1 else chunks[i] + y)
            ys.append(y)
        return torch.cat(ys, dim=1)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum(2, keepdim=True) / mask.sum(2, keepdim=True).clamp(min=1.0)


class SEBlock(nn.Module):
    def __init__(self, ch: int, se_ch: int, device=None):
        super().__init__()
        self.conv1 = Conv1d(ch, se_ch, device=device)
        self.conv2 = Conv1d(se_ch, ch, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.conv1(_masked_mean(x, mask)))
        return x * torch.sigmoid(self.conv2(s))


class SERes2NetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, res2net_scale: int = 8, se_ch: int = 128, k: int = 3,
                 d: int = 1, device=None):
        super().__init__()
        self.tdnn1 = TDNNBlock(in_ch, out_ch, device=device)
        self.res2net_block = Res2NetBlock(out_ch, res2net_scale, k, d, device=device)
        self.tdnn2 = TDNNBlock(out_ch, out_ch, device=device)
        self.se_block = SEBlock(out_ch, se_ch, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return self.se_block(y, mask) + x


class AttentiveStatisticsPooling(nn.Module):
    def __init__(self, ch: int, attn_ch: int = 128, device=None):
        super().__init__()
        self.tdnn = TDNNBlock(3 * ch, attn_ch, device=device)
        self.conv = Conv1d(attn_ch, ch, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mean = _masked_mean(x, mask)
        var = _masked_mean((x - mean) ** 2, mask)
        std = var.clamp(min=1e-12).sqrt()
        attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        a = self.conv(torch.tanh(self.tdnn(attn_in)))
        a = torch.where(mask > 0, a, float("-inf")).softmax(dim=2)
        mean = (a * x).sum(2)
        std = ((a * x * x).sum(2) - mean**2).clamp(min=1e-12).sqrt()
        return torch.cat([mean, std], dim=1)[:, :, None]  # [B, 2C, 1]


class EcapaTdnn(nn.Module):
    """speechbrain's ECAPA_TDNN: ``[B, T, n_mels] -> [B, lin_neurons]``."""

    def __init__(
        self,
        channels: Sequence[int] = (1024, 1024, 1024, 1024, 3072),
        kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1),
        dilations: Sequence[int] = (1, 2, 3, 4, 1),
        attn_ch: int = 128,
        res2net_scale: int = 8,
        se_ch: int = 128,
        lin_neurons: int = 192,
        n_mels: int = 80,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        blocks = [TDNNBlock(n_mels, channels[0], kernel_sizes[0], dilations[0], device=dev)]
        for i in range(1, len(channels) - 1):
            blocks.append(SERes2NetBlock(channels[i - 1], channels[i], res2net_scale, se_ch, kernel_sizes[i],
                                         dilations[i], device=dev))
        self.blocks = nn.ModuleList(blocks)
        self.mfa = TDNNBlock(sum(channels[1:-1]), channels[-1], kernel_sizes[-1], dilations[-1], device=dev)
        self.asp = AttentiveStatisticsPooling(channels[-1], attn_ch, device=dev)
        self.asp_bn = BatchNorm1d(2 * channels[-1], device=dev)
        self.fc = Conv1d(2 * channels[-1], lin_neurons, device=dev)

    def forward(self, feats: torch.Tensor, lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = feats.shape[1]
        if lens is None:
            lens = torch.full((feats.shape[0],), t, device=feats.device)
        mask = (torch.arange(t, device=feats.device)[None, :] < lens[:, None]).to(feats.dtype)[:, None, :]
        x = self.blocks[0](feats.transpose(1, 2))
        skips = []
        for block in self.blocks[1:]:
            x = block(x, mask)
            skips.append(x)
        x = self.mfa(torch.cat(skips, dim=1))
        x = self.asp_bn(self.asp(x, mask))
        return self.fc(x)[:, :, 0]


def infer_ecapa_config(state_dict) -> dict:
    """``EcapaTdnn`` keywords from a speechbrain state dict's shapes
    (dilations are not in the shapes and keep the published (1, 2, 3, 4, 1)
    pattern)."""
    shp = {k: tuple(v.shape) for k, v in state_dict.items()}
    n_blocks = 1 + max(int(m.group(1)) for k in shp if (m := re.match(r"blocks\.(\d+)\.", k)))
    channels = [shp["blocks.0.conv.conv.weight"][0]]
    kernel_sizes = [shp["blocks.0.conv.conv.weight"][2]]
    for i in range(1, n_blocks):
        channels.append(shp[f"blocks.{i}.tdnn1.conv.conv.weight"][0])
        kernel_sizes.append(shp[f"blocks.{i}.res2net_block.blocks.0.conv.conv.weight"][2])
    channels.append(shp["mfa.conv.conv.weight"][0])
    kernel_sizes.append(shp["mfa.conv.conv.weight"][2])
    scale = channels[1] // shp["blocks.1.res2net_block.blocks.0.conv.conv.weight"][0]
    return dict(
        channels=tuple(channels),
        kernel_sizes=tuple(kernel_sizes),
        dilations=tuple([1] + list(range(2, n_blocks + 1)) + [1]),
        attn_ch=shp["asp.tdnn.conv.conv.weight"][0],
        res2net_scale=scale,
        se_ch=shp["blocks.1.se_block.conv1.conv.weight"][0],
        lin_neurons=shp["fc.conv.weight"][0],
    )


class EcapaSpkEmbExtractor:
    """The reference's SpeechBrainSpkEmbExtractor without speechbrain:
    wav -> 192-d numpy embedding, computed on ``device`` (default the card).

    ``model_path`` is speechbrain's ``embedding_model.ckpt`` (or any state
    dict in that layout); its widths are read from its shapes. Without a
    path the model has seed-made weights and the embeddings mean nothing
    (pipeline plumbing only). Audio is padded to a multiple of 1 s
    (``BUCKET_S``), as the JAX package pads it.
    """

    BUCKET_S = 16000

    def __init__(self, model_path: Optional[str] = None, sr: int = 16000, device=None):
        self.sr = sr
        self.device = resolve_device(device)
        if model_path:
            sd = torch.load(model_path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
            self.model = EcapaTdnn(**infer_ecapa_config(sd), device=self.device)
            self.model.load_state_dict(sd, strict=True)
        else:
            logging.warning(
                "EcapaSpkEmbExtractor: no model_path, seed-made weights "
                "(the embeddings are not speaker-discriminative)"
            )
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                self.model = EcapaTdnn(device="cpu").to(self.device)
        self.model.eval()

    def _feats(self, wav: torch.Tensor, n_samp: torch.Tensor):
        feats = fbank(wav, self.sr)
        n_frames = 1 + n_samp // 160
        mask = (torch.arange(feats.shape[1], device=feats.device)[None, :] < n_frames[:, None])[..., None]
        n = mask.sum(1, keepdim=True).clamp(min=1)
        # speechbrain's InputNormalization(norm_type='sentence',
        # std_norm=False) over the valid frames; the bucket's padding frames
        # zeroed, as the JAX package does
        feats = (feats - (feats * mask).sum(1, keepdim=True) / n) * mask
        return feats, n_frames

    def forward(self, wav: np.ndarray) -> np.ndarray:
        wav = np.asarray(wav, np.float32).reshape(-1)
        n = len(wav)
        bucket = max(self.BUCKET_S, -(-n // self.BUCKET_S) * self.BUCKET_S)
        padded = torch.from_numpy(np.pad(wav, (0, bucket - n)))[None].to(self.device)
        lens = torch.tensor([n], device=self.device)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                emb = self.model(*self._feats(padded, lens))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        return emb[0].cpu().numpy().astype(np.float32)

    __call__ = forward
