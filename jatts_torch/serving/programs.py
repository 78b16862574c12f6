"""The served programs built from modules (counterpart of ``build_infer_fn``,
``build_stream_step_fn``, ``build_e2tts_fn`` and ``build_valle_fn``'s
programs in jatts_tpu/serving/export.py).

:class:`MelProgram` is the text -> mel (-> wav) program at fixed shapes: an
acoustic model (FastSpeech2, MatchaTTS, MatchaTTS_MAS or VITS), its mel
statistics and, for a wav bundle, a HiFi-GAN vocoder (with its own
statistics), inference -> denormalise -> (renormalise) -> vocoder -> pcm16
(or f32 with the mel) in one pass; without a vocoder it returns the
denormalised mel. :class:`StreamStep` turns chunk ``k`` of such a mel into
pcm16 audio through a window of the vocoder's receptive field.
:class:`E2ttsProgram` is E2-TTS's prompt-conditioned infill and
:class:`ValleProgram` VALL-E's two-stage decode in three parts.

Each program is an ``nn.Module``: its models are submodules (named by
``GROUPS`` after the artifact's weight groups) and its statistics buffers,
so ``serving/export.py`` traces it with every weight as an input
(``torch.func.functional_call``). A program that samples draws from its
``generator`` argument, or from torch's default generator of the device
when that is None: the exported programs take no generator. This module
imports the models; loading an artifact does not import it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from jatts_torch.models import valle
from jatts_torch.serving.bundle import _stat, pcm16
from jatts_torch.vocoder.streaming import hop_size as voc_hop_size
from jatts_torch.vocoder.streaming import min_context_frames


class _Program(nn.Module):
    """A served program: ``GROUPS`` maps each artifact weight group to the
    submodule that holds it, ``STATS`` names its statistics buffers."""

    GROUPS: Dict[str, str] = {}
    STATS: tuple = ()

    def _stats(self, device, **stats) -> None:
        for name in self.STATS:
            self.register_buffer(name, _stat(stats.get(name), device))

    def weights(self) -> Dict[str, Any]:
        """The program's weights as the artifact stores them: each group's
        state_dict, then the statistics that are set."""
        w: Dict[str, Any] = {g: getattr(self, a).state_dict() for g, a in self.GROUPS.items()
                             if getattr(self, a) is not None}
        w.update({s: getattr(self, s) for s in self.STATS if getattr(self, s) is not None})
        return w


class MelProgram(_Program):
    """``program(xs, ilens, spembs, generator) -> {"olens", ...}`` on device
    tensors at fixed shapes: xs [B, bucket], ilens [B] (, spembs [B,
    spk_dim]). With a vocoder: ``wav`` (int16 for pcm16; float32 with the
    ``mel`` for f32); without: the denormalised ``mel`` [B, max_frames,
    n_mels] float32. A model that samples noise (Matcha, VITS) draws it from
    ``generator``."""

    GROUPS = {"model": "model", "voc": "vocoder"}
    STATS = ("mel_mean", "mel_scale", "voc_mean", "voc_scale")

    def __init__(self, model, vocoder, mel_mean, mel_scale, max_frames: int, *, voc_mean=None, voc_scale=None,
                 wav_format: str = "pcm16", infer_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        if wav_format not in ("pcm16", "f32"):
            raise ValueError(f"wav_format must be 'pcm16' or 'f32', not {wav_format!r}")
        self.model = model
        self.vocoder = vocoder
        self.device = next(model.parameters()).device
        self.max_frames = int(max_frames)
        self.wav_format = wav_format
        self.infer_kwargs = dict(infer_kwargs or {})
        self.samples_noise = bool(getattr(model, "samples_noise", False))
        self._stats(self.device, mel_mean=mel_mean, mel_scale=mel_scale, voc_mean=voc_mean, voc_scale=voc_scale)

    @torch.no_grad()
    def forward(self, xs, ilens, spembs=None, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        kwargs = dict(self.infer_kwargs)
        if self.samples_noise:
            kwargs["generator"] = generator
        out = self.model.inference(xs, ilens, self.max_frames, spembs, **kwargs)
        mel = out["feat_gen"].float() * self.mel_scale + self.mel_mean
        res = {"olens": out["olens"]}
        if self.vocoder is None:
            res["mel"] = mel
            return res
        v = mel if self.voc_mean is None else (mel - self.voc_mean) / self.voc_scale
        voc_dtype = next(self.vocoder.parameters()).dtype
        wav = self.vocoder(v.to(voc_dtype))[..., 0].float()
        if self.wav_format == "pcm16":
            res["wav"] = pcm16(wav)
        else:
            res["mel"] = mel
            res["wav"] = wav
        return res


class StreamStep(_Program):
    """The streaming companion of a mel bundle: ``step(mel, k) -> int16 [B,
    chunk*hop]``, chunk ``k`` (int64 [1] on the device) of the denormalised
    mel [B, max_frames, n_mels] through the vocoder. The window is
    ``min(max_frames, chunk + 2·context)`` frames from ``clamp(k·chunk -
    context, 0, max_frames - window)``, so an edge window ends at the mel's
    true boundary and the crop equals the whole-utterance vocoder's samples
    (``context``: by default the receptive field, ``min_context_frames``).
    On the card that holds to 1 LSB of pcm16 where the convolutions'
    arithmetic matches: an f32 generator with TF32 off
    (``torch.backends.cudnn.allow_tf32 = False``). cuDNN picks its algorithm
    by length, and bf16 or TF32 convolutions turn another summation order
    into whole-ulp differences (32 LSB on an H100 with a bf16 generator,
    PERF.md)."""

    GROUPS = {"voc": "vocoder"}
    STATS = ("voc_mean", "voc_scale")

    def __init__(self, vocoder, max_frames: int, num_mels: int, chunk: int = 128, context: Optional[int] = None,
                 voc_mean=None, voc_scale=None):
        super().__init__()
        if context is None:
            context = min_context_frames(vocoder)
        if max_frames % chunk:
            raise ValueError(f"max_frames {max_frames} not a multiple of chunk {chunk}")
        if chunk < context:
            raise ValueError(f"chunk {chunk} < vocoder receptive field {context}")
        self.vocoder = vocoder
        self.device = next(vocoder.parameters()).device
        self.max_frames, self.num_mels, self.chunk, self.context = int(max_frames), int(num_mels), int(chunk), int(context)
        self.hop = voc_hop_size(vocoder)
        self.window = min(self.max_frames, self.chunk + 2 * self.context)
        self._stats(self.device, voc_mean=voc_mean, voc_scale=voc_scale)

    @torch.no_grad()
    def forward(self, mel: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        v = mel if self.voc_mean is None else (mel - self.voc_mean) / self.voc_scale
        s = k * self.chunk
        start = torch.clamp(s - self.context, 0, self.max_frames - self.window)
        win = v.index_select(1, start + torch.arange(self.window, device=v.device))
        wav = self.vocoder(win.to(next(self.vocoder.parameters()).dtype))[..., 0].float()
        crop = wav.index_select(1, (s - start) * self.hop + torch.arange(self.chunk * self.hop, device=v.device))
        return pcm16(crop)

    def meta(self) -> Dict[str, int]:
        return {"chunk": self.chunk, "context": self.context, "hop": self.hop, "max_frames": self.max_frames,
                "num_mels": self.num_mels}


class E2ttsProgram(_Program):
    """``program(cond_raw, text, ref_lens, duration, generator) -> mel``:
    the raw prompt mel normalised by the model's statistics, the CFG Euler
    loop (``E2TTS.inference``, its noise from ``generator``), the mel
    denormalised: [B, max_frames, num_mels] float32 (``build_e2tts_fn``'s
    program). :meth:`start`, :meth:`step` and :meth:`finish` are its three
    parts, which the artifact exports (``serving/export.py`` says why the
    loop is not unrolled into one program)."""

    GROUPS = {"model": "model"}
    STATS = ("mel_mean", "mel_scale")
    samples_noise = True

    def __init__(self, model, mel_mean, mel_scale, infer_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.model = model
        self.device = next(model.parameters()).device
        self.infer_kwargs = dict(infer_kwargs or {})
        self._stats(self.device, mel_mean=mel_mean, mel_scale=mel_scale)

    @torch.no_grad()
    def forward(self, cond_raw, text, ref_lens, duration, generator: Optional[torch.Generator] = None):
        out = self.model.inference((cond_raw - self.mel_mean) / self.mel_scale, text, ref_lens, duration,
                                   generator=generator, **self.infer_kwargs)
        return out["feat_gen"].float() * self.mel_scale + self.mel_mean

    # the forward's three parts, which the artifact exports (the model in
    # eval mode): start, ``steps`` steps, finish

    @property
    def steps(self) -> int:
        return int(self.infer_kwargs.get("steps", 32))

    def start(self, cond_raw, text, ref_lens, duration, generator: Optional[torch.Generator] = None):
        kw = self.infer_kwargs
        return self.model.inference_start((cond_raw - self.mel_mean) / self.mel_scale, text, ref_lens, duration,
                                          self.steps, kw.get("cfg_strength", 1.0), kw.get("sway_sampling_coef"),
                                          generator)

    def step(self, state, i) -> torch.Tensor:
        return self.model.inference_step(state, i, self.infer_kwargs.get("cfg_strength", 1.0))

    def finish(self, state) -> torch.Tensor:
        return self.model.inference_finish(state)["feat_gen"].float() * self.mel_scale + self.mel_mean


class ValleProgram(_Program):
    """The VALL-E two-stage decode as one program (``build_valle_fn``'s):
    ``program(text, text_lens, proms, prom_lens, generator) -> {"codes"
    [B, max_steps, 8], "resp_lens" [B]}``: :func:`ar_generate` at
    ``max_steps`` (temperature ``ar_temperature``), then
    :func:`nar_generate`'s 7 levels (``nar_temperature``), both drawing from
    ``generator``. :meth:`start`, :meth:`step` and :meth:`fill` are its three
    parts at fixed shapes, which the bundle captures as CUDA graphs and the
    artifact exports: the prefix, one AR step (replayed ``max_steps - 1``
    times, its decode state advanced in place) and the NAR fill. The neural
    codec decode (EnCodec) stays outside, as in the JAX artifact."""

    GROUPS = {"ar": "ar", "nar": "nar"}
    samples_noise = True

    def __init__(self, ar, nar, max_steps: int, ar_temperature: float = 1.0, nar_temperature: float = 0.2):
        super().__init__()
        self.ar, self.nar = ar, nar
        self.device = next(ar.parameters()).device
        self.max_steps = int(max_steps)
        self.ar_temperature, self.nar_temperature = float(ar_temperature), float(nar_temperature)

    def start(self, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, Any]:
        return valle.ar_start(self.ar, text, text_lens, proms, prom_lens, self.max_steps, self.ar_temperature,
                              generator)

    def step(self, state, generator=None) -> torch.Tensor:
        return valle.ar_step(self.ar, state, self.ar_temperature, generator)

    @torch.no_grad()
    def fill(self, codes, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, torch.Tensor]:
        """The NAR fill on the AR's ``codes`` [B, max_steps]."""
        resp_lens = valle.ar_finish(self.ar, codes)
        codes = valle.nar_generate(self.nar, text, text_lens, proms, prom_lens, codes, resp_lens,
                                   self.nar_temperature, generator)
        return {"codes": codes, "resp_lens": resp_lens}

    def forward(self, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, torch.Tensor]:
        ar_out = valle.ar_generate(self.ar, text, text_lens, proms, prom_lens, max_steps=self.max_steps,
                                   sampling_temperature=self.ar_temperature, generator=generator)
        with torch.no_grad():
            codes = valle.nar_generate(self.nar, text, text_lens, proms, prom_lens, ar_out["codes"],
                                       ar_out["resp_lens"], self.nar_temperature, generator)
        return {"codes": codes, "resp_lens": ar_out["resp_lens"]}
