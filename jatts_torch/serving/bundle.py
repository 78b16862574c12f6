"""Serving bundles (counterpart of ``build_infer_fn``, ``build_stream_step_fn``,
``build_e2tts_fn`` and the loaded bundles of jatts_tpu/serving/export.py).

:class:`MelProgram` is the text -> mel (-> wav) program at fixed shapes: an
acoustic model (FastSpeech2, MatchaTTS, MatchaTTS_MAS or VITS), its mel
statistics and, for a wav bundle, a HiFi-GAN vocoder (with its own
statistics), inference -> denormalise -> (renormalise) -> vocoder -> pcm16
(or f32 with the mel) in one pass; without a vocoder it returns the
denormalised mel. :class:`StreamStep` turns chunk ``k`` of such a mel into
pcm16 audio through a window of the vocoder's receptive field.
:class:`ServingBundle` runs a ``MelProgram`` at a fixed ``batch_size``: a
call pads the requests to the batch and to the smallest text bucket that
fits, runs the program, fetches each output once and crops every row by its
``olens``. A multi-speaker model (``spk_embed_dim``) takes one speaker
embedding a request, zero rows past them, as the JAX bundle pads them.
Matcha's inference keywords (``ode_steps``, ``temperature``) and VITS's
(``noise_scale``) come from :func:`inference_kwargs`, and their noise (the
ODE's, the prior's) from the bundle's generator, seeded by the call's
``seed``.

:class:`E2ttsServingBundle` serves E2-TTS's prompt-conditioned infill: a raw
prompt log-mel and token ids (prompt, separator, target) in, the generated
mel out, normalised by the model's statistics inside and denormalised on
the way out. It carries no vocoder, as the JAX artifact does not.

The same bundles serve in process (built from modules) and from an
artifact (``serving/export.py:load_bundle``). :meth:`ServingBundle.capture`
(and the E2 bundle's) records one CUDA graph per text bucket, and one for
the stream step, in one memory pool; a call then copies its padded inputs
into the graph's buffers and replays it. On the CPU the programs run
eagerly. A bundle serves one call at a time (``BatchingServer`` has one
dispatcher thread): a replay overwrites the outputs of the call before it,
and ``synthesize_streaming`` keeps its mel in the stream graph's buffer
until its last chunk.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from jatts_torch.models import valle
from jatts_torch.serving.graphs import GraphedCall, replayed_launches
from jatts_torch.vocoder.streaming import hop_size as voc_hop_size
from jatts_torch.vocoder.streaming import min_context_frames


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


def _stat(x, device) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(np.asarray(x, np.float32), device=device)


def pcm16(wav: torch.Tensor) -> torch.Tensor:
    """float waveform -> int16 PCM, as the JAX program quantises it."""
    return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


class MelProgram:
    """``program(xs, ilens, spembs, generator) -> {"olens", ...}`` on device
    tensors at fixed shapes: xs [B, bucket], ilens [B] (, spembs [B,
    spk_dim]). With a vocoder: ``wav`` (int16 for pcm16; float32 with the
    ``mel`` for f32); without: the denormalised ``mel`` [B, max_frames,
    n_mels] float32. A model that samples noise (Matcha, VITS) draws it from
    ``generator``."""

    def __init__(self, model, vocoder, mel_mean, mel_scale, max_frames: int, *, voc_mean=None, voc_scale=None,
                 wav_format: str = "pcm16", infer_kwargs: Optional[Dict[str, Any]] = None):
        if wav_format not in ("pcm16", "f32"):
            raise ValueError(f"wav_format must be 'pcm16' or 'f32', not {wav_format!r}")
        self.model = model
        self.vocoder = vocoder
        self.device = next(model.parameters()).device
        self.max_frames = int(max_frames)
        self.wav_format = wav_format
        self.infer_kwargs = dict(infer_kwargs or {})
        self.samples_noise = bool(getattr(model, "samples_noise", False))
        self.mel_mean, self.mel_scale = _stat(mel_mean, self.device), _stat(mel_scale, self.device)
        self.voc_mean, self.voc_scale = _stat(voc_mean, self.device), _stat(voc_scale, self.device)

    @torch.no_grad()
    def __call__(self, xs, ilens, spembs=None, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
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

    def weights(self) -> Dict[str, Any]:
        """The program's weights as the artifact stores them: the model's and
        the vocoder's state_dicts and the statistics."""
        w: Dict[str, Any] = {"model": self.model.state_dict(), "mel_mean": self.mel_mean,
                             "mel_scale": self.mel_scale}
        if self.vocoder is not None:
            w["voc"] = self.vocoder.state_dict()
            if self.voc_mean is not None:
                w["voc_mean"], w["voc_scale"] = self.voc_mean, self.voc_scale
        return w


class StreamStep:
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

    def __init__(self, vocoder, max_frames: int, num_mels: int, chunk: int = 128, context: Optional[int] = None,
                 voc_mean=None, voc_scale=None):
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
        self.voc_mean, self.voc_scale = _stat(voc_mean, self.device), _stat(voc_scale, self.device)

    @torch.no_grad()
    def __call__(self, mel: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
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

    def weights(self) -> Dict[str, Any]:
        w: Dict[str, Any] = {"voc": self.vocoder.state_dict()}
        if self.voc_mean is not None:
            w["voc_mean"], w["voc_scale"] = self.voc_mean, self.voc_scale
        return w


def _fit(buckets: Sequence[int], lengths: Sequence[int], n: int, batch_size: int) -> int:
    """The smallest bucket that holds the longest request; raises on a batch
    over ``batch_size`` or a request over the largest bucket."""
    if n > batch_size:
        raise ValueError(f"batch {n} > bundle batch {batch_size}")
    longest = max(lengths)
    fit = [b for b in buckets if b >= longest]
    if not fit:
        raise ValueError(f"text length {longest} exceeds largest bucket {buckets[-1]}")
    return fit[0]


class ServingBundle:
    """A :class:`MelProgram` at ``batch_size`` rows and text ``buckets``.
    ``vocoder`` None makes a mel bundle (``hop_size`` then says the
    samples a frame, for the meta); ``stream`` (a :class:`StreamStep`) lets
    a mel bundle stream. ``meta`` is the artifact's meta when loaded."""

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
        hop_size: Optional[int] = None,
        stream: Optional[StreamStep] = None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.program = MelProgram(model, vocoder, mel_mean, mel_scale, max_frames, voc_mean=voc_mean,
                                  voc_scale=voc_scale, wav_format=wav_format, infer_kwargs=infer_kwargs)
        self.model = model
        self.vocoder = vocoder
        self.device = self.program.device
        self.mel_mean, self.mel_scale = self.program.mel_mean, self.program.mel_scale
        self.batch_size = int(batch_size)
        self.buckets = sorted(int(t) for t in buckets)
        self.max_frames = int(max_frames)
        self.hop_size = int(vocoder.hop_size if vocoder is not None else hop_size)
        self.wav_format = wav_format
        self.spk_dim = int(getattr(model, "spk_embed_dim", None) or 0)
        self.stream = stream
        self.meta = dict(meta or {})
        self.generator = torch.Generator(device=self.device)
        self.graphs: Dict[int, GraphedCall] = {}
        self.stream_graph: Optional[GraphedCall] = None

    def prepare(self, token_ids: Sequence[Sequence[int]]):
        """Pad <= batch_size requests to the smallest fitting bucket ->
        (xs [batch_size, bucket], ilens [batch_size]) on the device."""
        bucket = _fit(self.buckets, [len(t) for t in token_ids], len(token_ids), self.batch_size)
        xs = np.zeros((self.batch_size, bucket), np.int64)
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

    def capture(self) -> None:
        """Record one CUDA graph per text bucket (and one of the stream
        step) in one memory pool; later calls replay them. The stream graph
        is captured last, so its buffers lie outside every bucket graph's
        scratch. Raises on the CPU and when a capture fails."""
        if self.device.type != "cuda":
            raise RuntimeError("CUDA graphs need the bundle on a CUDA device")
        pool = torch.cuda.graph_pool_handle()
        gen = self.generator if self.program.samples_noise else None
        for bucket in self.buckets:
            xs = torch.ones(self.batch_size, bucket, dtype=torch.long, device=self.device)
            ilens = torch.full((self.batch_size,), bucket, dtype=torch.long, device=self.device)
            se = self.prepare_spembs(None)
            self.graphs[bucket] = GraphedCall(lambda x, il, s: self.program(x, il, s, self.generator),
                                              [xs, ilens, se], pool, gen)
        if self.stream is not None:
            mel = torch.zeros(self.batch_size, self.max_frames, self.stream.num_mels, device=self.device)
            k = torch.zeros(1, dtype=torch.long, device=self.device)
            self.stream_graph = GraphedCall(self.stream, [mel, k], pool)

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays since capture."""
        return replayed_launches([*self.graphs.values(), *([self.stream_graph] if self.stream_graph else [])])

    def run(
        self, xs: torch.Tensor, ilens: torch.Tensor, spembs: Optional[torch.Tensor] = None, seed: int = 0
    ) -> Dict[str, torch.Tensor]:
        """The program on device tensors xs [batch_size, bucket], ilens
        [batch_size] (, spembs [batch_size, spk_dim]): the bucket's graph
        when captured, else eagerly; the noise of Matcha and VITS from the
        bundle's generator seeded by ``seed``."""
        self.generator.manual_seed(int(seed))
        graph = self.graphs.get(xs.shape[1])
        if graph is not None:
            return graph(xs, ilens, spembs)
        return self.program(xs, ilens, spembs, self.generator)

    def synthesize(
        self, token_ids: Sequence[Sequence[int]], seed: int = 0, spembs: Optional[np.ndarray] = None
    ) -> List[Dict[str, Any]]:
        """token_ids: <= batch_size sequences (and, for a multi-speaker
        model, ``spembs`` [len(token_ids), spk_dim]) -> per-utterance dicts
        with ``wav`` [olens*hop] (int16 or float32) and ``mel`` [olens,
        n_mels] where the bundle returns them. ``seed`` seeds Matcha's ODE
        noise and VITS's prior noise: the same seed gives the same bits,
        another seed other audio; FastSpeech2 is deterministic and ignores
        it."""
        xs, ilens = self.prepare(token_ids)
        out = self.run(xs, ilens, self.prepare_spembs(spembs), seed)
        # one device->host fetch per output, rows sliced on the host
        host = {k: v.cpu().numpy() for k, v in out.items()}
        results = []
        for i in range(len(token_ids)):
            n = int(host["olens"][i])
            r = {}
            if "mel" in host:
                r["mel"] = host["mel"][i, :n]
            if "wav" in host:
                r["wav"] = host["wav"][i, : n * self.hop_size]
            results.append(r)
        return results

    def _stream_chunk(self, mel: torch.Tensor, k: int) -> torch.Tensor:
        """Chunk ``k`` of ``mel`` as int16 [B, chunk*hop]; the stream graph
        takes the mel into its buffer with chunk 0 and keeps it there."""
        if self.stream_graph is None:
            return self.stream(mel, torch.full((1,), k, dtype=torch.long, device=self.device))
        self.stream_graph.inputs[1].fill_(k)
        return self.stream_graph(mel if k == 0 else None, None)

    def synthesize_streaming(
        self, token_ids: Sequence[Sequence[int]], seed: int = 0, spembs: Optional[np.ndarray] = None
    ) -> Iterator[List[Dict[str, Any]]]:
        """Chunked synthesis: yields audio left to right as it is computed.

        Needs a mel bundle with a :class:`StreamStep`. The mel program runs
        once; its mel stays on the device and each item costs one window
        call and one fetch, so the first playable chunk arrives after two
        programs instead of after the whole waveform. Yields, per chunk k, a
        list over the requests of dicts ``wav`` (int16 [<= chunk*hop],
        cropped to the row's remaining samples, empty once the row is done)
        and ``start_sample``. A row's chunks concatenated equal the wav a
        pcm16 wav bundle of the same model and vocoder returns. Iteration
        stops after the longest row's last chunk."""
        if self.stream is None:
            raise ValueError("bundle was exported without stream= support")
        chunk, hop = self.stream.chunk, self.stream.hop
        xs, ilens = self.prepare(token_ids)
        n = len(token_ids)
        out = self.run(xs, ilens, self.prepare_spembs(spembs), seed)
        if "mel" not in out:
            raise ValueError("streaming needs a mel bundle (no baked vocoder)")
        olens = out["olens"].cpu().numpy()  # host fetch; the mel stays on the device
        n_chunks = max(1, -(-int(olens[:n].max()) // chunk))
        mel = out["mel"]
        for k in range(n_chunks):
            wav = self._stream_chunk(mel, k).cpu().numpy()
            s = k * chunk
            results = []
            for i in range(n):
                hi = min(int(olens[i]), s + chunk) * hop
                results.append({"wav": wav[i, : max(0, hi - s * hop)], "start_sample": s * hop})
            yield results


class E2ttsProgram:
    """``program(cond_raw, text, ref_lens, duration, generator) -> mel``:
    the raw prompt mel normalised by the model's statistics, the CFG Euler
    loop (``E2TTS.inference``, its noise from ``generator``), the mel
    denormalised: [B, max_frames, num_mels] float32 (``build_e2tts_fn``'s
    program)."""

    samples_noise = True

    def __init__(self, model, mel_mean, mel_scale, infer_kwargs: Optional[Dict[str, Any]] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.infer_kwargs = dict(infer_kwargs or {})
        self.mel_mean, self.mel_scale = _stat(mel_mean, self.device), _stat(mel_scale, self.device)

    @torch.no_grad()
    def __call__(self, cond_raw, text, ref_lens, duration, generator: Optional[torch.Generator] = None):
        out = self.model.inference((cond_raw - self.mel_mean) / self.mel_scale, text, ref_lens, duration,
                                   generator=generator, **self.infer_kwargs)
        return out["feat_gen"].float() * self.mel_scale + self.mel_mean

    def weights(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "mel_mean": self.mel_mean, "mel_scale": self.mel_scale}


class E2ttsServingBundle:
    """E2-TTS at a fixed batch size, text buckets and frame capacity
    ``max_frames``. A call pads the token ids with -1 (the backbone's filler)
    to the smallest bucket that fits, clamps each prompt to
    ``max_frames - gen_frames`` frames so that generation keeps its room,
    pads the rows to ``batch_size``, runs an :class:`E2ttsProgram` with noise
    from the bundle's generator seeded by ``seed`` and crops each row to its
    generated frames ``[ref_len, duration)``."""

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
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.program = E2ttsProgram(model, mel_mean, mel_scale, infer_kwargs)
        self.model = model
        self.device = self.program.device
        self.batch_size = int(batch_size)
        self.buckets = sorted(int(t) for t in buckets)
        self.max_frames = int(max_frames)
        self.num_mels = int(model.odim)
        self.mel_mean, self.mel_scale = self.program.mel_mean, self.program.mel_scale
        self.meta = dict(meta or {})
        self.generator = torch.Generator(device=self.device)
        self.graphs: Dict[int, GraphedCall] = {}

    def prepare(
        self, token_ids: Sequence[Sequence[int]], prompt_mels: Sequence[np.ndarray], gen_frames: Sequence[int]
    ):
        """<= batch_size requests -> (cond_raw [batch_size, max_frames,
        num_mels] f32, text [batch_size, bucket] (pad -1), ref_lens,
        duration [batch_size]) on the device; padded rows have no prompt and
        one frame."""
        bucket = _fit(self.buckets, [len(t) for t in token_ids], len(token_ids), self.batch_size)
        text = np.full((self.batch_size, bucket), -1, np.int64)
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

    def capture(self) -> None:
        """One CUDA graph of the whole CFG Euler loop per text bucket, at
        capacity, in one memory pool. Raises on the CPU and when a capture
        fails."""
        if self.device.type != "cuda":
            raise RuntimeError("CUDA graphs need the bundle on a CUDA device")
        pool = torch.cuda.graph_pool_handle()
        b, dev = self.batch_size, self.device
        for bucket in self.buckets:
            inputs = [torch.zeros(b, self.max_frames, self.num_mels, device=dev),
                      torch.ones(b, bucket, dtype=torch.long, device=dev),
                      torch.zeros(b, dtype=torch.long, device=dev),
                      torch.full((b,), self.max_frames, dtype=torch.long, device=dev)]
            self.graphs[bucket] = GraphedCall(lambda *a: self.program(*a, self.generator), inputs, pool,
                                              self.generator)

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays since capture."""
        return replayed_launches(self.graphs.values())

    def run(self, cond_raw, text, ref_lens, duration, seed: int = 0) -> torch.Tensor:
        """The program on device tensors, replayed from the bucket's graph
        when captured, with the generator seeded by ``seed``."""
        self.generator.manual_seed(int(seed))
        graph = self.graphs.get(text.shape[1])
        if graph is not None:
            return graph(cond_raw, text, ref_lens, duration)
        return self.program(cond_raw, text, ref_lens, duration, self.generator)

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
        mel = self.run(cond_raw, text, ref_lens, duration, seed=seed).cpu().numpy()
        # one fetch, rows cropped on the host
        ref, dur = ref_lens.cpu().numpy(), duration.cpu().numpy()
        return [mel[i, ref[i]: dur[i]] for i in range(len(token_ids))]


class ValleProgram:
    """The VALL-E two-stage decode as one program (``build_valle_fn``'s):
    ``program(text, text_lens, proms, prom_lens, generator) -> {"codes"
    [B, max_steps, 8], "resp_lens" [B]}``: :func:`ar_generate` at
    ``max_steps`` (temperature ``ar_temperature``), then
    :func:`nar_generate`'s 7 levels (``nar_temperature``), both drawing from
    ``generator``. :meth:`start`, :meth:`step` and :meth:`fill` are its three
    parts at fixed shapes, which the bundle captures as CUDA graphs: the
    prefix, one AR step (replayed ``max_steps - 1`` times) and the NAR fill.
    The neural codec decode (EnCodec) stays outside, as in the JAX
    artifact."""

    samples_noise = True

    def __init__(self, ar, nar, max_steps: int, ar_temperature: float = 1.0, nar_temperature: float = 0.2):
        self.ar, self.nar = ar, nar
        self.device = next(ar.parameters()).device
        self.max_steps = int(max_steps)
        self.ar_temperature, self.nar_temperature = float(ar_temperature), float(nar_temperature)

    def start(self, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, Any]:
        return valle.ar_start(self.ar, text, text_lens, proms, prom_lens, self.max_steps, self.ar_temperature,
                              generator)

    def step(self, state, generator=None) -> None:
        valle.ar_step(self.ar, state, self.ar_temperature, generator)

    @torch.no_grad()
    def fill(self, state, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, torch.Tensor]:
        resp_lens = valle.ar_finish(self.ar, state["codes"])
        codes = valle.nar_generate(self.nar, text, text_lens, proms, prom_lens, state["codes"], resp_lens,
                                   self.nar_temperature, generator)
        return {"codes": codes, "resp_lens": resp_lens}

    def __call__(self, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, torch.Tensor]:
        ar_out = valle.ar_generate(self.ar, text, text_lens, proms, prom_lens, max_steps=self.max_steps,
                                   sampling_temperature=self.ar_temperature, generator=generator)
        with torch.no_grad():
            codes = valle.nar_generate(self.nar, text, text_lens, proms, prom_lens, ar_out["codes"],
                                       ar_out["resp_lens"], self.nar_temperature, generator)
        return {"codes": codes, "resp_lens": ar_out["resp_lens"]}

    def weights(self) -> Dict[str, Any]:
        return {"ar": self.ar.state_dict(), "nar": self.nar.state_dict()}


class ValleServingBundle:
    """A :class:`ValleProgram` at ``batch_size`` rows, text ``buckets`` and
    a prompt capacity of ``prompt_frames`` frames of ``n_prom_levels``
    levels: text ids + prompt codes -> RVQ codes [T_i, 8] a request, cropped
    to the AR's length. :meth:`capture` records, per text bucket, graphs of
    the prefix, of one AR step and of the NAR fill in one memory pool."""

    def __init__(self, ar, nar, *, batch_size: int, buckets: Sequence[int], max_steps: int,
                 ar_temperature: float = 1.0, nar_temperature: float = 0.2, meta: Optional[Dict[str, Any]] = None):
        self.program = ValleProgram(ar, nar, max_steps, ar_temperature, nar_temperature)
        self.device = self.program.device
        self.batch_size = int(batch_size)
        self.buckets = sorted(int(t) for t in buckets)
        self.prompt_frames = int(ar.prompt_max_frame_length)
        self.n_prom_levels = int(ar.n_prom_levels)
        self.max_steps = int(max_steps)
        self.meta = dict(meta or {})
        self.generator = torch.Generator(device=self.device)
        self.graphs: Dict[int, tuple] = {}

    def prepare(self, token_ids: Sequence[Sequence[int]], prompt_codes: Sequence[np.ndarray]):
        """<= batch_size requests -> (text [batch_size, bucket], text_lens,
        proms [batch_size, prompt_frames, n_prom_levels], prom_lens) on the
        device; each prompt cut to ``prompt_frames``."""
        bucket = _fit(self.buckets, [len(t) for t in token_ids], len(token_ids), self.batch_size)
        xs = np.zeros((self.batch_size, bucket), np.int64)
        ilens = np.zeros((self.batch_size,), np.int64)
        proms = np.zeros((self.batch_size, self.prompt_frames, self.n_prom_levels), np.int64)
        plens = np.zeros((self.batch_size,), np.int64)
        for i, (ids, pc) in enumerate(zip(token_ids, prompt_codes)):
            xs[i, : len(ids)] = np.asarray(ids, np.int64)
            ilens[i] = len(ids)
            pc = np.asarray(pc, np.int64)[: self.prompt_frames]
            proms[i, : len(pc)] = pc
            plens[i] = len(pc)
        return tuple(torch.from_numpy(a).to(self.device) for a in (xs, ilens, proms, plens))

    def capture(self) -> None:
        """Per text bucket: graphs of the prefix, of one AR step on the
        prefix graph's state and of the NAR fill, in one memory pool, the
        generator registered with each. Raises on the CPU and when a
        capture fails."""
        if self.device.type != "cuda":
            raise RuntimeError("CUDA graphs need the bundle on a CUDA device")
        pool = torch.cuda.graph_pool_handle()
        p, gen, b, dev = self.program, self.generator, self.batch_size, self.device
        for bucket in self.buckets:
            inputs = [torch.ones(b, bucket, dtype=torch.long, device=dev),
                      torch.full((b,), bucket, dtype=torch.long, device=dev),
                      torch.zeros(b, self.prompt_frames, self.n_prom_levels, dtype=torch.long, device=dev),
                      torch.full((b,), self.prompt_frames, dtype=torch.long, device=dev)]
            start = GraphedCall(lambda *a: p.start(*a, gen), inputs, pool, gen)
            # a capture only records: the step's warm-up needs the state filled
            start.graph.replay()
            # one warm-up step keeps its slot inside the cache at max_steps 2
            step = GraphedCall(lambda st: p.step(st, gen), [start.outputs], pool, gen, warmup=1) \
                if self.max_steps > 1 else None
            fill = GraphedCall(lambda st, *a: p.fill(st, *a, gen), [start.outputs, *inputs], pool, gen)
            self.graphs[bucket] = (start, step, fill)

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays since capture."""
        return replayed_launches([c for calls in self.graphs.values() for c in calls if c is not None])

    def run(self, text, text_lens, proms, prom_lens, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The program on device tensors: the bucket's graphs replayed
        (prefix, ``max_steps - 1`` steps, fill) when captured, else eagerly;
        every draw from the generator seeded by ``seed``."""
        self.generator.manual_seed(int(seed))
        graphs = self.graphs.get(text.shape[1])
        if graphs is None:
            return self.program(text, text_lens, proms, prom_lens, self.generator)
        start, step, fill = graphs
        start(text, text_lens, proms, prom_lens)
        for _ in range(self.max_steps - 1):
            step()
        return fill()

    def synthesize(self, token_ids: Sequence[Sequence[int]], prompt_codes: Sequence[np.ndarray],
                   seed: int = 0) -> List[np.ndarray]:
        """token_ids: <= batch_size sequences, prompt_codes: [Tp_i, L] each
        -> RVQ codes [T_i, 8] int32 a request (T_i the AR's length)."""
        out = self.run(*self.prepare(token_ids, prompt_codes), seed=seed)
        lens = out["resp_lens"].cpu().numpy()
        codes = out["codes"].cpu().numpy().astype(np.int32)  # one fetch, rows sliced on the host
        return [codes[i, : lens[i]] for i in range(len(token_ids))]
