"""In-process serving bundle (counterpart of ``build_infer_fn`` plus
``ServingBundle`` in jatts_tpu/serving/export.py, without ``jax.export``).

The bundle holds an acoustic model (FastSpeech2, MatchaTTS,
MatchaTTS_MAS or VITS) and a HiFi-GAN vocoder on their device with the acoustic
model's mel statistics (and the vocoder's, when given). A call pads the
requests to the fixed ``batch_size`` and the smallest text bucket that
fits, runs inference -> denormalise -> (renormalise) -> vocoder -> pcm16
(or f32) in one pass, fetches each output once and crops every row by its
``olens``. A multi-speaker model (``spk_embed_dim``) takes one speaker
embedding a request, padded with zero rows to the batch size, as the JAX
bundle pads them; a request without one gets a zero row. Matcha's
inference keywords (``ode_steps``, ``temperature``) and VITS's
(``noise_scale``) come from :func:`inference_kwargs`, and their noise (the
ODE's, the prior's) from a generator seeded by the call's ``seed``.

:class:`E2ttsServingBundle` (counterpart of ``build_e2tts_fn`` plus
``E2ttsServingBundle`` there) serves E2-TTS's prompt-conditioned infill: a
raw prompt log-mel and token ids (prompt, separator, target) in, the
generated mel out, normalised by the model's statistics inside and
denormalised on the way out. It carries no vocoder, as the JAX artifact
does not.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def inference_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    """The per-family inference keywords of a recipe config, as the JAX
    package's ``build_infer_fn`` and decode CLI set them."""
    if config["model_type"].startswith("MatchaTTS"):
        return dict(
            n_timesteps=int(config.get("ode_steps", 10)),
            temperature=float(config.get("temperature", 0.667)),
        )
    if config["model_type"] == "VITS":
        return dict(noise_scale=float(config.get("noise_scale", 0.667)))
    if config["model_type"] == "E2TTS":
        sway = config.get("sway_sampling_coef")
        return dict(
            steps=int(config.get("nfe_step", 32)),
            cfg_strength=float(config.get("cfg_strength", 1.0)),
            sway_sampling_coef=None if sway is None else float(sway),
        )
    return {}


class ServingBundle:
    def __init__(
        self,
        model,
        vocoder,
        mel_mean: np.ndarray,
        mel_scale: np.ndarray,
        *,
        batch_size: int,
        buckets: Sequence[int],
        max_frames: int,
        voc_mean: Optional[np.ndarray] = None,
        voc_scale: Optional[np.ndarray] = None,
        wav_format: str = "pcm16",
        infer_kwargs: Optional[Dict[str, Any]] = None,
    ):
        if wav_format not in ("pcm16", "f32"):
            raise ValueError(f"wav_format must be 'pcm16' or 'f32', not {wav_format!r}")
        self.model = model
        self.vocoder = vocoder
        self.device = next(model.parameters()).device
        self.batch_size = int(batch_size)
        self.buckets = sorted(int(t) for t in buckets)
        self.max_frames = int(max_frames)
        self.hop_size = int(vocoder.hop_size)
        self.wav_format = wav_format
        self.spk_dim = int(getattr(model, "spk_embed_dim", None) or 0)
        self.infer_kwargs = dict(infer_kwargs or {})

        def stat(x):
            return None if x is None else torch.as_tensor(
                np.asarray(x, np.float32), device=self.device
            )

        self.mel_mean, self.mel_scale = stat(mel_mean), stat(mel_scale)
        self.voc_mean, self.voc_scale = stat(voc_mean), stat(voc_scale)

    def prepare(self, token_ids: Sequence[Sequence[int]]):
        """Pad <= batch_size requests to the smallest fitting bucket ->
        (xs [batch_size, bucket], ilens [batch_size]) on the device."""
        n = len(token_ids)
        if n > self.batch_size:
            raise ValueError(f"batch {n} > bundle batch {self.batch_size}")
        longest = max(len(t) for t in token_ids)
        fit = [b for b in self.buckets if b >= longest]
        if not fit:
            raise ValueError(
                f"text length {longest} exceeds largest bucket {self.buckets[-1]}"
            )
        xs = np.zeros((self.batch_size, fit[0]), np.int64)
        ilens = np.zeros((self.batch_size,), np.int64)
        for i, ids in enumerate(token_ids):
            xs[i, : len(ids)] = np.asarray(ids, np.int64)
            ilens[i] = len(ids)
        return torch.from_numpy(xs).to(self.device), torch.from_numpy(ilens).to(self.device)

    def prepare_spembs(self, spembs: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        """<= batch_size speaker embeddings -> [batch_size, spk_dim] float32
        on the device, zero rows past them (and all zeros for None); None
        for a single-speaker model."""
        if not self.spk_dim:
            return None
        se = np.zeros((self.batch_size, self.spk_dim), np.float32)
        if spembs is not None:
            spembs = np.asarray(spembs, np.float32)
            if spembs.ndim != 2 or spembs.shape[0] > self.batch_size or spembs.shape[1] != self.spk_dim:
                raise ValueError(f"spembs {spembs.shape} is not [<= {self.batch_size}, {self.spk_dim}]")
            se[: len(spembs)] = spembs
        return torch.from_numpy(se).to(self.device)

    @torch.no_grad()
    def run(
        self, xs: torch.Tensor, ilens: torch.Tensor, spembs: Optional[torch.Tensor] = None, seed: int = 0
    ) -> Dict[str, torch.Tensor]:
        """The fixed-shape program on device tensors: xs [batch_size, bucket],
        ilens [batch_size] (, spembs [batch_size, spk_dim]) -> {"olens",
        "wav"} (+ "mel" for f32). A model that samples noise (Matcha, VITS) draws
        it from a generator seeded by ``seed``."""
        kwargs = dict(self.infer_kwargs)
        if getattr(self.model, "samples_noise", False):
            kwargs["generator"] = torch.Generator(device=self.device).manual_seed(int(seed))
        out = self.model.inference(xs, ilens, self.max_frames, spembs, **kwargs)
        mel = out["feat_gen"].float() * self.mel_scale + self.mel_mean
        v = mel if self.voc_mean is None else (mel - self.voc_mean) / self.voc_scale
        voc_dtype = next(self.vocoder.parameters()).dtype
        wav = self.vocoder(v.to(voc_dtype))[..., 0].float()
        res = {"olens": out["olens"]}
        if self.wav_format == "pcm16":
            res["wav"] = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        else:
            res["mel"] = mel
            res["wav"] = wav
        return res

    def synthesize(
        self, token_ids: Sequence[Sequence[int]], seed: int = 0, spembs: Optional[np.ndarray] = None
    ) -> List[Dict[str, Any]]:
        """token_ids: <= batch_size sequences (and, for a multi-speaker
        model, ``spembs`` [len(token_ids), spk_dim]) -> per-utterance dicts
        with ``wav`` [olens*hop] (int16 or float32) and, for f32, ``mel``
        [olens, n_mels]. ``seed`` seeds Matcha's ODE noise and VITS's prior noise: the same seed
        gives the same bits, another seed other audio; FastSpeech2 is
        deterministic and ignores it."""
        xs, ilens = self.prepare(token_ids)
        out = self.run(xs, ilens, self.prepare_spembs(spembs), seed)
        # one device->host fetch per output, rows sliced on the host
        host = {k: v.cpu().numpy() for k, v in out.items()}
        results = []
        for i in range(len(token_ids)):
            n = int(host["olens"][i])
            r = {"wav": host["wav"][i, : n * self.hop_size]}
            if "mel" in host:
                r["mel"] = host["mel"][i, :n]
            results.append(r)
        return results


class E2ttsServingBundle:
    """E2-TTS at a fixed batch size, text buckets and frame capacity
    ``max_frames``. A call pads the token ids with -1 (the backbone's filler)
    to the smallest bucket that fits, clamps each prompt to
    ``max_frames - gen_frames`` frames so that generation keeps its room,
    pads the rows to ``batch_size``, runs ``E2TTS.inference`` with noise from
    a generator seeded by ``seed``, and crops each row to its generated
    frames ``[ref_len, duration)``."""

    def __init__(
        self,
        model,
        mel_mean: np.ndarray,
        mel_scale: np.ndarray,
        *,
        batch_size: int,
        buckets: Sequence[int],
        max_frames: int,
        infer_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.batch_size = int(batch_size)
        self.buckets = sorted(int(t) for t in buckets)
        self.max_frames = int(max_frames)
        self.num_mels = int(model.odim)
        self.infer_kwargs = dict(infer_kwargs or {})
        self.mel_mean = torch.as_tensor(np.asarray(mel_mean, np.float32), device=self.device)
        self.mel_scale = torch.as_tensor(np.asarray(mel_scale, np.float32), device=self.device)

    def prepare(
        self, token_ids: Sequence[Sequence[int]], prompt_mels: Sequence[np.ndarray], gen_frames: Sequence[int]
    ):
        """<= batch_size requests -> (cond_raw [batch_size, max_frames,
        num_mels] f32, text [batch_size, bucket] (pad -1), ref_lens,
        duration [batch_size]) on the device; padded rows have no prompt and
        one frame."""
        n = len(token_ids)
        if n > self.batch_size:
            raise ValueError(f"batch {n} > bundle batch {self.batch_size}")
        longest = max(len(t) for t in token_ids)
        fit = [b for b in self.buckets if b >= longest]
        if not fit:
            raise ValueError(f"text length {longest} exceeds largest bucket {self.buckets[-1]}")
        text = np.full((self.batch_size, fit[0]), -1, np.int64)
        cond = np.zeros((self.batch_size, self.max_frames, self.num_mels), np.float32)
        ref_lens = np.zeros((self.batch_size,), np.int64)
        duration = np.ones((self.batch_size,), np.int64)
        for i, (ids, pm, g) in enumerate(zip(token_ids, prompt_mels, gen_frames)):
            text[i, : len(ids)] = np.asarray(ids, np.int64)
            pm = np.asarray(pm, np.float32)
            n_prompt = min(len(pm), max(self.max_frames - int(g), 0))
            cond[i, :n_prompt] = pm[:n_prompt]
            ref_lens[i] = n_prompt
            duration[i] = min(n_prompt + int(g), self.max_frames)
        return tuple(torch.from_numpy(a).to(self.device) for a in (cond, text, ref_lens, duration))

    def synthesize(
        self,
        token_ids: Sequence[Sequence[int]],
        prompt_mels: Sequence[np.ndarray],
        gen_frames: Sequence[int],
        seed: int = 0,
    ) -> List[np.ndarray]:
        """token_ids (prompt + separator + target ids, composed by the caller
        as ``bin/e2tts_decode.py`` does), raw prompt log-mels [Tp_i,
        num_mels] and frames to generate -> each row's generated mel
        [frames, num_mels]. The same seed gives the same bits."""
        cond_raw, text, ref_lens, duration = self.prepare(token_ids, prompt_mels, gen_frames)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.no_grad():
            out = self.model.inference((cond_raw - self.mel_mean) / self.mel_scale, text, ref_lens, duration,
                                       generator=generator, **self.infer_kwargs)
        # one fetch, rows cropped on the host
        mel = (out["feat_gen"].float() * self.mel_scale + self.mel_mean).cpu().numpy()
        ref, dur = ref_lens.cpu().numpy(), duration.cpu().numpy()
        return [mel[i, ref[i]: dur[i]] for i in range(len(token_ids))]
