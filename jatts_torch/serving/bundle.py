"""Serving bundles (counterpart of the loaded bundles of
jatts_tpu/serving/export.py): a served program at a fixed batch size and
text buckets.

:class:`ServingBundle` runs a text -> mel (-> wav) program at a fixed
``batch_size``: a call pads the requests to the batch and to the smallest
text bucket that fits, runs the program, fetches each output once and crops
every row by its ``olens``. A multi-speaker model (``spk_embed_dim``) takes
one speaker embedding a request, zero rows past them, as the JAX bundle pads
them. Matcha's inference keywords (``ode_steps``, ``temperature``) and
VITS's (``noise_scale``) come from :func:`inference_kwargs`, and their noise
(the ODE's, the prior's) from draws seeded by the call's ``seed``.

:class:`E2ttsServingBundle` serves E2-TTS's prompt-conditioned infill: a raw
prompt log-mel and token ids (prompt, separator, target) in, the generated
mel out, normalised by the model's statistics inside and denormalised on
the way out. It carries no vocoder, as the JAX artifact does not.
:class:`ValleServingBundle` serves VALL-E's two-stage decode.

The same bundles serve in process, built from modules (the programs of
``serving/programs.py``, drawing from the bundle's ``generator``), and from
an artifact (``serving/export.py:load_bundle``: the deserialised
``torch.export`` programs, with no model code; they draw from torch's
default generator of the device, which a call seeds with its ``seed`` and
restores afterwards, so the caller's random state is left as it was). A
call with seed s gives the same bits either way. :meth:`ServingBundle.capture`
(and the E2 and VALL-E bundles') records one CUDA graph per text bucket, and
one for the stream step, in one memory pool; a call then copies its padded
inputs into the graph's buffers and replays it. On the CPU the programs run
eagerly. A bundle serves one call at a time (``BatchingServer`` has one
dispatcher thread): a replay overwrites the outputs of the call before it,
and ``synthesize_streaming`` keeps its mel in the stream graph's buffer
until its last chunk.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from jatts_torch.serving.graphs import GraphedCall, replayed_launches

# the programs built from modules live in serving/programs.py, which imports
# the models; they are read from there on first use
_PROGRAMS = ("MelProgram", "StreamStep", "E2ttsProgram", "ValleProgram")


def __getattr__(name: str):
    if name in _PROGRAMS:
        from jatts_torch.serving import programs

        return getattr(programs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


class Weights:
    """A loaded artifact's weights of one module, standing where the module
    stands in a bundle built in process: ``state_dict()`` gives them."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._tensors = dict(tensors)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self._tensors)


@contextlib.contextmanager
def kept_rng(device: torch.device):
    """Torch's random state of the CPU and of ``device`` as it was before,
    after the block."""
    devices = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices, device_type="cuda"):
        yield


@contextlib.contextmanager
def seeded(device: torch.device, generator: Optional[torch.Generator], seed: int):
    """Draws of the block seeded by ``seed``: ``generator`` seeded, or, when
    it is None (a loaded artifact's programs), torch's default generator of
    ``device``, its state restored after the block."""
    if generator is not None:
        generator.manual_seed(int(seed))
        yield
        return
    with kept_rng(device):
        if device.type == "cuda":
            index = device.index if device.index is not None else torch.cuda.current_device()
            torch.cuda.default_generators[index].manual_seed(int(seed))
        else:
            torch.default_generator.manual_seed(int(seed))
        yield


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


class _Bundle:
    """What every bundle shares: the program, its device, batch and buckets,
    the meta, the generator its draws come from (None for a loaded
    artifact: the device's default generator) and the graphs."""

    def _init(self, program, *, batch_size: int, buckets: Sequence[int], meta: Optional[Dict[str, Any]],
              loaded: bool) -> None:
        self.program = program
        self.device = program.device
        self.batch_size = int(batch_size)
        self.buckets = sorted(int(t) for t in buckets)
        self.meta = dict(meta or {})
        self.generator = None if loaded else torch.Generator(device=self.device)
        self.graphs: Dict[int, Any] = {}

    def _check_cuda(self) -> None:
        if self.device.type != "cuda":
            raise RuntimeError("CUDA graphs need the bundle on a CUDA device")


class ServingBundle(_Bundle):
    """A text -> mel (-> wav) program at ``batch_size`` rows and text
    ``buckets``. Built in process from ``model`` (and ``vocoder``: None makes
    a mel bundle, ``hop_size`` then says the samples a frame, for the meta);
    ``stream`` (a ``StreamStep``) lets a mel bundle stream. ``meta`` is the
    artifact's meta when loaded (:meth:`loaded`)."""

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
        stream=None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        from jatts_torch.serving.programs import MelProgram

        program = MelProgram(model, vocoder, mel_mean, mel_scale, max_frames, voc_mean=voc_mean,
                             voc_scale=voc_scale, wav_format=wav_format, infer_kwargs=infer_kwargs)
        self._setup(program, model, vocoder, batch_size=batch_size, buckets=buckets, max_frames=max_frames,
                    hop_size=int(vocoder.hop_size if vocoder is not None else hop_size), wav_format=wav_format,
                    spk_dim=int(getattr(model, "spk_embed_dim", None) or 0), stream=stream, meta=meta, loaded=False)

    @classmethod
    def loaded(cls, program, model: Weights, vocoder: Optional[Weights], *, batch_size: int,
               buckets: Sequence[int], max_frames: int, hop_size: int, wav_format: str, spk_dim: int,
               stream=None, meta: Optional[Dict[str, Any]] = None) -> "ServingBundle":
        """The bundle of an artifact's deserialised programs (``program`` and
        the ``stream`` step from ``serving/export.py``)."""
        self = cls.__new__(cls)
        self._setup(program, model, vocoder, batch_size=batch_size, buckets=buckets, max_frames=max_frames,
                    hop_size=hop_size, wav_format=wav_format, spk_dim=spk_dim, stream=stream, meta=meta, loaded=True)
        return self

    def _setup(self, program, model, vocoder, *, batch_size, buckets, max_frames, hop_size, wav_format, spk_dim,
               stream, meta, loaded) -> None:
        self._init(program, batch_size=batch_size, buckets=buckets, meta=meta, loaded=loaded)
        self.model = model
        self.vocoder = vocoder
        self.mel_mean, self.mel_scale = program.mel_mean, program.mel_scale
        self.max_frames = int(max_frames)
        self.hop_size = int(hop_size)
        self.wav_format = wav_format
        self.spk_dim = int(spk_dim)
        self.stream = stream
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
        self._check_cuda()
        pool = torch.cuda.graph_pool_handle()
        gen = self.generator if self.program.samples_noise else None
        with kept_rng(self.device):
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
        when captured, else eagerly; the noise of Matcha and VITS seeded by
        ``seed``."""
        with seeded(self.device, self.generator, seed):
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

        Needs a mel bundle with a stream step. The mel program runs
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


class E2ttsServingBundle(_Bundle):
    """E2-TTS at a fixed batch size, text buckets and frame capacity
    ``max_frames``. A call pads the token ids with -1 (the backbone's filler)
    to the smallest bucket that fits, clamps each prompt to
    ``max_frames - gen_frames`` frames so that generation keeps its room,
    pads the rows to ``batch_size``, runs an E2-TTS program with noise
    seeded by ``seed`` and crops each row to its generated frames
    ``[ref_len, duration)``."""

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
        from jatts_torch.serving.programs import E2ttsProgram

        self._setup(E2ttsProgram(model, mel_mean, mel_scale, infer_kwargs), model, batch_size=batch_size,
                    buckets=buckets, max_frames=max_frames, num_mels=int(model.odim), meta=meta, loaded=False)

    @classmethod
    def loaded(cls, program, model: Weights, *, batch_size: int, buckets: Sequence[int], max_frames: int,
               num_mels: int, meta: Optional[Dict[str, Any]] = None) -> "E2ttsServingBundle":
        """The bundle of an artifact's deserialised programs."""
        self = cls.__new__(cls)
        self._setup(program, model, batch_size=batch_size, buckets=buckets, max_frames=max_frames,
                    num_mels=num_mels, meta=meta, loaded=True)
        return self

    def _setup(self, program, model, *, batch_size, buckets, max_frames, num_mels, meta, loaded) -> None:
        self._init(program, batch_size=batch_size, buckets=buckets, meta=meta, loaded=loaded)
        self.model = model
        self.max_frames = int(max_frames)
        self.num_mels = int(num_mels)
        self.mel_mean, self.mel_scale = program.mel_mean, program.mel_scale

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
        self._check_cuda()
        pool = torch.cuda.graph_pool_handle()
        b, dev = self.batch_size, self.device
        with kept_rng(dev):
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
        when captured, its draws seeded by ``seed``."""
        with seeded(self.device, self.generator, seed):
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


class ValleServingBundle(_Bundle):
    """VALL-E's two-stage decode at ``batch_size`` rows, text ``buckets``
    and a prompt capacity of ``prompt_frames`` frames of ``n_prom_levels``
    levels: text ids + prompt codes -> RVQ codes [T_i, 8] a request, cropped
    to the AR's length. :meth:`capture` records, per text bucket, graphs of
    the prefix, of one AR step and of the NAR fill in one memory pool."""

    def __init__(self, ar, nar, *, batch_size: int, buckets: Sequence[int], max_steps: int,
                 ar_temperature: float = 1.0, nar_temperature: float = 0.2, meta: Optional[Dict[str, Any]] = None):
        from jatts_torch.serving.programs import ValleProgram

        self._setup(ValleProgram(ar, nar, max_steps, ar_temperature, nar_temperature), batch_size=batch_size,
                    buckets=buckets, prompt_frames=ar.prompt_max_frame_length, n_prom_levels=ar.n_prom_levels,
                    meta=meta, loaded=False)

    @classmethod
    def loaded(cls, program, *, batch_size: int, buckets: Sequence[int], prompt_frames: int, n_prom_levels: int,
               meta: Optional[Dict[str, Any]] = None) -> "ValleServingBundle":
        """The bundle of an artifact's deserialised programs."""
        self = cls.__new__(cls)
        self._setup(program, batch_size=batch_size, buckets=buckets, prompt_frames=prompt_frames,
                    n_prom_levels=n_prom_levels, meta=meta, loaded=True)
        return self

    def _setup(self, program, *, batch_size, buckets, prompt_frames, n_prom_levels, meta, loaded) -> None:
        self._init(program, batch_size=batch_size, buckets=buckets, meta=meta, loaded=loaded)
        self.prompt_frames = int(prompt_frames)
        self.n_prom_levels = int(n_prom_levels)
        self.max_steps = int(program.max_steps)

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
        self._check_cuda()
        pool = torch.cuda.graph_pool_handle()
        p, gen, b, dev = self.program, self.generator, self.batch_size, self.device
        with kept_rng(dev):
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
                fill = GraphedCall(lambda c, *a: p.fill(c, *a, gen), [start.outputs["codes"], *inputs], pool, gen)
                self.graphs[bucket] = (start, step, fill)

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays since capture."""
        return replayed_launches([c for calls in self.graphs.values() for c in calls if c is not None])

    def run(self, text, text_lens, proms, prom_lens, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The program on device tensors: the bucket's graphs replayed
        (prefix, ``max_steps - 1`` steps, fill) when captured, else eagerly;
        every draw seeded by ``seed``."""
        with seeded(self.device, self.generator, seed):
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
