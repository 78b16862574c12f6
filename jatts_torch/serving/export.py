"""Serving export: a self-contained inference artifact (counterpart of
jatts_tpu/serving/export.py).

As in the JAX package, the served programs are exported once, one a text
bucket, and a serving process deserialises and calls them with no model
Python code on the path: each program is traced by ``torch.export`` at its
fixed shapes and stored with ``torch.export.save``. The hand-written kernels
are ``torch.library`` ops (``jatts::flash_attn_fwd`` and the rest,
``ops/flash_attention.py`` and ``ops/mas.py``), so they stay in the graph as
calls of their ops, and :func:`load_bundle` needs only those registrations
and ``serving/``: it imports nothing of ``jatts_torch.models``, ``modules``
or ``vocoder``.

Weights travel once, as the programs' first inputs, not as constants of the
programs (the JAX artifact's rule, ``weights_as_args``): each program is an
``nn.Module`` of ``serving/programs.py`` traced through
``torch.func.functional_call`` with every parameter and buffer as an input,
so three buckets hold one copy of the weights. Buffers outside the
state_dicts (a model's non-persistent tables) travel once too, under
``b/``. Tables the models build per shape while tracing become constants of
a program.

Draws: a ``torch.Generator`` cannot be an input of an exported program, so
the programs draw from torch's default generator of their device. The
loaded bundle seeds it with the call's ``seed`` and restores the caller's
random state after the call (``serving/bundle.py:seeded``), so a call with
seed s gives the bits of the in-process program drawing from a generator
seeded s, and a CUDA graph's replay draws them too.

VALL-E: the JAX program is one scan of the AR steps plus the NAR fill.
``torch.export`` has no stable while loop, so each bucket keeps three
programs: the prefix, one AR step and the NAR fill, and the host loops the
step ``max_steps - 1`` times (one CUDA graph replay each on the card). The
exported step keeps its in-place updates of the decode state (the KV caches
above all), so a step writes one slot and copies no cache.

E2-TTS: the JAX program scans its CFG Euler loop. Unrolled by
``torch.export``, the conf's 32 steps of 24 layers are one graph of 768
backbone layers, whose tracing, saving and loading take minutes on the
card's host (PERF.md). So each bucket keeps three programs too: the start
(noise, times, text embedding), one step (its index a 0-d tensor input) and
the finish; the loaded bundle calls the step 32 times, and on the card all
of it is one CUDA graph, replayed as one.

Platforms: ``platforms`` lists the device types the artifact is for, the
first being where :func:`load_bundle` puts it when no device is given. A
program is traced on the exporting modules' device and moved at load, by
``torch.export.passes.move_to_device_pass``, to another device type: an
artifact exported on the CPU runs on the card and the other way round.

Artifact layout (one ``.npz``):
    __meta__          json: batch size, buckets, output kind, rates, ...; the
                      port's own fields: ``format`` ("torch.export"),
                      ``program_device``, ``inputs`` (the npz keys of a
                      program's weight inputs, in order; ``stream_inputs``
                      for the stream step), ``export_s`` (seconds to trace
                      and save each program), ``modules`` (per weight group
                      its class, constructor keywords and dtypes),
                      ``infer_kwargs`` and the temperatures
    t<bucket>         the bucket's program (``torch.export.save`` bytes);
                      VALL-E: ``t<bucket>/start``, ``/step`` and ``/fill``;
                      E2-TTS: ``t<bucket>/start``, ``/step``, ``/finish``
    stream_step       a streaming bundle's chunk program
    w/<group>/<key>   the weights: ``model`` (a state_dict),
                      ``mel_mean``/``mel_scale``, ``voc`` and its statistics
                      for a wav bundle, ``ar``/``nar`` for VALL-E; bf16 as
                      uint16 views, the dtype map in meta["weight_dtypes"]
    b/<group>/<key>   buffers outside the state_dicts (their bf16 keys in
                      meta["buffer_dtypes"], with the ``sb/`` ones)
    sw/, sb/          a streaming bundle's vocoder and statistics, and its
                      buffers outside the state_dict (meta["streaming"],
                      meta["stream_weight_dtypes"])

An artifact written before this format (no ``format`` in its meta: weights
and module specs only) still loads, its modules rebuilt from the meta's
class names and keywords, as JAX's loader still reads its constant-baked
artifacts. An artifact of this format never falls back to that path.

Outputs: a mel bundle ``mel`` (denormalised, f32) and ``olens``; a wav
bundle ``wav`` (int16 quantised in the program, or f32 with the ``mel``);
E2-TTS the generated mel; VALL-E RVQ codes and their lengths (the EnCodec
decode stays outside, as in the JAX artifact). The port reads its own
artifacts, not the JAX package's.
"""

from __future__ import annotations

import contextlib
import io
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from jatts_torch.device import resolve_device
from jatts_torch.serving.bundle import E2ttsServingBundle, ServingBundle, ValleServingBundle, Weights, inference_kwargs

FORMAT = "torch.export"

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[1]


def _flatten(tree: Dict[str, Any], path: str = "") -> Dict[str, torch.Tensor]:
    flat = {}
    for k, v in tree.items():
        key = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        elif v is not None:
            flat[key] = v
    return flat


def _weights_entries(weights: Dict[str, Any], prefix: str = "w") -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Flatten nested dicts of tensors (state_dicts, statistics) into
    npz-storable ``<prefix>/<path>`` arrays. numpy has no bf16: bf16 leaves
    are stored as uint16 views, their dtype in the returned map."""
    entries: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for k, v in _flatten(weights).items():
        t = torch.as_tensor(v).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            dtypes[k] = "bfloat16"
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        entries[f"{prefix}/{k}"] = arr
    return entries, dtypes


def _weights_from_npz(z, meta: Dict[str, Any], prefix: str = "w",
                      dtype_key: str = "weight_dtypes") -> Optional[Dict[str, Any]]:
    """The ``<prefix>/`` entries back as nested dicts of CPU tensors, bf16
    bit for bit."""
    dtypes = meta.get(dtype_key, {})
    tree: Dict[str, Any] = {}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        path = key[len(prefix) + 1:]
        arr = z[key]
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if dtypes.get(path) == "bfloat16" \
            else torch.from_numpy(arr)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree or None


def module_spec(module: torch.nn.Module, params: Dict[str, Any]) -> Dict[str, Any]:
    """How :func:`load_bundle` rebuilds ``module``: its class, constructor
    keywords (``params``), its constructor's dtype and its parameters'
    dtype. A model with a ``compute_dtype`` (FastSpeech2, the Matcha family,
    VITS) names its own, ``None`` where it casts nothing; for another module
    a ``dtype`` in ``params`` is the constructor's dtype, else the
    parameters' dtype is."""
    params = dict(params)
    param_dtype = _dtype_name(next(module.parameters()).dtype)
    dtype = params.pop("dtype", None) or param_dtype
    if hasattr(module, "compute_dtype"):
        dtype = None if module.compute_dtype is None else _dtype_name(module.compute_dtype)
    return {"class": type(module).__name__, "params": params, "dtype": dtype, "param_dtype": param_dtype}


def _rebuild(spec: Dict[str, Any], state_dict: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    from jatts_torch.models.e2tts import E2TTS
    from jatts_torch.models.fastspeech2 import FastSpeech2
    from jatts_torch.models.matchatts import MatchaTTS
    from jatts_torch.models.matchatts_mas import MatchaTTS_MAS
    from jatts_torch.models.valle import VALLEAR, VALLENAR
    from jatts_torch.models.vits import VITS
    from jatts_torch.vocoder.hifigan import HiFiGANGenerator

    classes = {c.__name__: c for c in (FastSpeech2, MatchaTTS, MatchaTTS_MAS, VITS, E2TTS, VALLEAR, VALLENAR,
                                       HiFiGANGenerator)}
    if spec["class"] not in classes:
        raise ValueError(f"the artifact names an unknown module class {spec['class']!r}")
    dtype = None if spec["dtype"] is None else DTYPES[spec["dtype"]]
    module = classes[spec["class"]](**spec["params"], device=device, dtype=dtype)
    module.to(DTYPES[spec["param_dtype"]])
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def _write(out_path: str, entries: Dict[str, np.ndarray], meta: Dict[str, Any]) -> str:
    entries["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)
    if not out_path.endswith(".npz"):
        out_path += ".npz"
    with open(out_path, "wb") as f:
        np.savez(f, **entries)
    return out_path


def read_meta(path: str) -> Dict[str, Any]:
    """An artifact's ``__meta__``."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]))


def _model_params(meta: Dict[str, Any], key: str = "model_params") -> Dict[str, Any]:
    if key not in meta:
        raise ValueError(f"meta needs {key!r} (the constructor keywords, idim included) to rebuild the model")
    return meta.pop(key)




def build_infer_fn(config: Dict[str, Any], model, mel_mean: np.ndarray, mel_scale: np.ndarray, max_frames: int,
                   vocoder=None, wav_format: str = "pcm16"):
    """Bind model + stats (+ a ``vocoder/vocoder.py:Vocoder``) into one
    ``MelProgram`` ``fn(xs, ilens, spembs, generator)`` plus its weights,
    with the per-family inference keywords of ``config``.

    ``wav_format`` (vocoder artifacts only): "pcm16" quantises the waveform
    to int16 in the program and drops the mel from the outputs; "f32" keeps
    the float waveform and the mel."""
    from jatts_torch.serving.programs import MelProgram

    fn = MelProgram(
        model, None if vocoder is None else vocoder.model, mel_mean, mel_scale, max_frames,
        voc_mean=None if vocoder is None else vocoder.mean, voc_scale=None if vocoder is None else vocoder.scale,
        wav_format=wav_format, infer_kwargs=inference_kwargs(config),
    )
    return fn, fn.weights()


def build_stream_step_fn(vocoder, max_frames: int, num_mels: int, chunk: int = 128, context: Optional[int] = None):
    """The streaming companion of a mel bundle (a ``StreamStep`` over a
    ``vocoder/vocoder.py:Vocoder``'s generator and statistics): chunk ``k``
    of the mel program's output into pcm16 through a window of ``context``
    frames (by default the receptive field) each side, clamped to the true
    mel boundaries, so the chunks concatenated equal a pcm16 wav bundle's
    output. Raises when ``max_frames`` is not a multiple of ``chunk`` or
    ``chunk`` is under the context."""
    from jatts_torch.serving.programs import StreamStep

    return StreamStep(vocoder.model, max_frames, num_mels, chunk=chunk, context=context,
                      voc_mean=vocoder.mean, voc_scale=vocoder.scale)


def build_e2tts_fn(config: Dict[str, Any], model, mel_mean: np.ndarray, mel_scale: np.ndarray):
    """E2-TTS prompt-conditioned infill as one program
    ``fn(cond_raw, text, ref_lens, duration, generator) -> mel``: the raw
    (denormalised) prompt log-mel zero-padded to the frame capacity in,
    normalised in the program, the output denormalised; text padded with -1
    (the backbone's filler). ``nfe_step``, ``cfg_strength`` and
    ``sway_sampling_coef`` from ``config``."""
    from jatts_torch.serving.programs import E2ttsProgram

    fn = E2ttsProgram(model, mel_mean, mel_scale, inference_kwargs(config))
    return fn, fn.weights()


def build_valle_fn(ar_model, nar_model, max_steps: int, ar_temperature: float = 1.0, nar_temperature: float = 0.2):
    """The VALL-E two-stage decode as one ``ValleProgram``: the AR at
    ``max_steps`` and the NAR's 7 level fills (level 0 sanitised,
    ``nar_generate``), one generator for both."""
    from jatts_torch.serving.programs import ValleProgram

    fn = ValleProgram(ar_model, nar_model, max_steps, ar_temperature, nar_temperature)
    return fn, fn.weights()


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

class _Method(nn.Module):
    """``program.<method>`` as a module's forward, for functional_call."""

    def __init__(self, program: nn.Module, method: str):
        super().__init__()
        self.program = program
        self.method = method

    def forward(self, *args):
        return getattr(self.program, self.method)(*args)


class _Traced(nn.Module):
    """What ``torch.export`` traces: ``forward(*weights, *inputs)`` calls
    the program's method with ``weights`` in place of its parameters and
    buffers. The program is held outside the module's registry, so the
    exported program owns no parameter."""

    def __init__(self, program: nn.Module, method: str, paths: Sequence[str]):
        super().__init__()
        self.__dict__["call"] = _Method(program, method)
        self.paths = [f"program.{p}" for p in paths]

    def forward(self, *args):
        n = len(self.paths)
        return torch.func.functional_call(self.call, dict(zip(self.paths, args[:n])), args[n:],
                                          tie_weights=False, strict=True)


def _program_inputs(program, prefix: str = "w", buffer_prefix: str = "b") -> List[Tuple[str, str, torch.Tensor]]:
    """A program's weight inputs in order, as ``(npz key, module path,
    tensor)``: each group's state_dict under ``<prefix>/<group>/``, its
    other buffers under ``<buffer_prefix>/<group>/``, the statistics under
    ``<prefix>/``."""
    out = []
    for group, attr in program.GROUPS.items():
        mod = getattr(program, attr)
        if mod is None:
            continue
        sd = mod.state_dict(keep_vars=True)
        out += [(f"{prefix}/{group}/{k}", f"{attr}.{k}", t) for k, t in sd.items()]
        out += [(f"{buffer_prefix}/{group}/{k}", f"{attr}.{k}", t)
                for k, t in mod.named_buffers(remove_duplicate=False) if k not in sd]
    out += [(f"{prefix}/{s}", s, getattr(program, s)) for s in program.STATS if getattr(program, s) is not None]
    return out


def _buffer_entries(inputs, prefix: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """The ``<prefix>/`` inputs (buffers outside the state_dicts) as npz
    entries, and their bf16 keys (whole npz keys)."""
    tree = {key[len(prefix) + 1:]: t for key, _, t in inputs if key.startswith(prefix + "/")}
    entries, dtypes = _weights_entries(tree, prefix=prefix)
    return entries, {f"{prefix}/{k}": v for k, v in dtypes.items()}


def _no_grad_enter(self) -> None:
    self.prev = torch.is_grad_enabled()
    if self.prev:
        torch.set_grad_enabled(False)


def _no_grad_exit(self, *exc) -> None:
    if self.prev:
        torch.set_grad_enabled(True)


@contextlib.contextmanager
def _tracing(program: nn.Module):
    """Eval mode, no grad (and no grad-mode calls that change nothing), no
    stack traces recorded, and no module's ``noise_generator`` (a generator
    cannot be an input of an exported program: every draw takes the default
    one); the modes and generators restored after."""
    held = [(m, m.noise_generator) for m in program.modules() if getattr(m, "noise_generator", None) is not None]
    for m, _ in held:
        m.noise_generator = None
    modes = [(m, m.training) for m in program.modules()]
    program.eval()
    # no stack trace on each node where torch can be told so: the artifact
    # keeps none (_lean)
    traces = getattr(torch.fx.config, "do_not_emit_stack_traces", None)
    if traces is not None:
        torch.fx.config.do_not_emit_stack_traces = True
    # a no_grad block entered with grad already off changes nothing, but
    # export records its set_grad_enabled calls and then splits the graph at
    # them (a third of a trace's time): such a block calls nothing meanwhile
    enter, leave = torch.no_grad.__enter__, torch.no_grad.__exit__
    torch.no_grad.__enter__, torch.no_grad.__exit__ = _no_grad_enter, _no_grad_exit
    try:
        with torch.no_grad():
            yield
    finally:
        torch.no_grad.__enter__, torch.no_grad.__exit__ = enter, leave
        if traces is not None:
            torch.fx.config.do_not_emit_stack_traces = traces
        for m, mode in modes:
            m.training = mode
        for m, g in held:
            m.noise_generator = g


def _export(program: nn.Module, method: str, inputs, args: Sequence[Any], seconds: Dict[str, float],
            name: str) -> np.ndarray:
    """Trace ``program.<method>(*args)`` with ``inputs``' tensors as its
    first inputs and return the ``torch.export.save`` bytes. The program
    runs once eagerly first, on copies of ``args``, so every table a model
    caches per shape is made outside the trace."""
    t0 = time.perf_counter()
    with _tracing(program):
        copies = [_clone(a) for a in args]
        getattr(program, method)(*copies)
        traced = _Traced(program, method, [p for _, p, _ in inputs])
        ep = torch.export.export(traced, (*[t.detach() for _, _, t in inputs], *args), strict=False)
    _lean(ep)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    seconds[name] = time.perf_counter() - t0
    return np.frombuffer(buf.getvalue(), np.uint8)


def _lean(ep) -> None:
    """What the artifact keeps of an exported program: no example inputs
    (they are the weights, which the artifact stores once), no stack traces,
    and no casts to the dtype a tensor already has (``.to`` then returns the
    tensor itself; the layers' casts to their compute dtype make half of
    an f32 model's nodes) nor their dtype asserts. An output keeps its node:
    the graph signature names it."""
    ep._example_inputs = None
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        node.meta.pop("stack_trace", None)
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2 and not node.kwargs
              and node.args[0].meta["val"].dtype == node.args[1]
              and all(user.op != "output" for user in node.users)):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    ep.graph_module.recompile()


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


def _mel_args(batch_size: int, bucket: int, spk_dim: int, device) -> List[torch.Tensor]:
    args = [torch.ones(batch_size, bucket, dtype=torch.long, device=device),
            torch.full((batch_size,), bucket, dtype=torch.long, device=device)]
    if spk_dim:
        args.append(torch.zeros(batch_size, spk_dim, device=device))
    return args


def _meta_fields(program, inputs, platforms, seconds) -> Dict[str, Any]:
    return dict(format=FORMAT, program_device=program.device.type, platforms=list(platforms),
                inputs=[k for k, _, _ in inputs], export_s=seconds, weights_as_args=True)


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------

def export_bundle(out_path: str, fn, batch_size: int, text_buckets: Sequence[int],
                  meta: Dict[str, Any], spk_dim: int = 0, platforms: Sequence[str] = ("cuda",),
                  weights: Optional[Dict[str, Any]] = None, stream=None) -> str:
    """Write the mel/wav artifact of ``fn`` (a ``MelProgram``): one
    exported program a text bucket at ``batch_size`` rows (and the stream
    step's).

    ``meta`` holds the JAX meta's fields (``model_type``, ``num_mels``,
    ``sampling_rate``, ``hop_size``, ``max_frames``, ``output``,
    ``wav_format``, ...) and the port's ``model_params``, the model's
    constructor keywords. ``platforms``: see the module's docstring.
    ``stream``: a ``StreamStep`` that lets the loaded mel bundle stream
    (``synthesize_streaming``)."""
    meta = dict(meta)
    modules = {"w/model": module_spec(fn.model, _model_params(meta))}
    if fn.vocoder is not None:
        modules["w/voc"] = module_spec(fn.vocoder, fn.vocoder.hparams())
    entries, w_dtypes = _weights_entries(fn.weights() if weights is None else weights)
    inputs = _program_inputs(fn)
    b_entries, b_dtypes = _buffer_entries(inputs, "b")
    entries.update(b_entries)
    seconds: Dict[str, float] = {}
    for t in text_buckets:
        entries[f"t{int(t)}"] = _export(fn, "forward", inputs, _mel_args(batch_size, int(t), spk_dim, fn.device),
                                        seconds, f"t{int(t)}")
    sw_dtypes: Dict[str, str] = {}
    stream_inputs: List[str] = []
    if stream is not None:
        sw_entries, sw_dtypes = _weights_entries(stream.weights(), prefix="sw")
        entries.update(sw_entries)
        s_inputs = _program_inputs(stream, "sw", "sb")
        sb_entries, sb_dtypes = _buffer_entries(s_inputs, "sb")
        entries.update(sb_entries)
        b_dtypes.update(sb_dtypes)
        stream_inputs = [k for k, _, _ in s_inputs]
        args = [torch.zeros(batch_size, stream.max_frames, stream.num_mels, device=stream.device),
                torch.zeros(1, dtype=torch.long, device=stream.device)]
        entries["stream_step"] = _export(stream, "forward", s_inputs, args, seconds, "stream_step")
        modules["sw/voc"] = module_spec(stream.vocoder, stream.vocoder.hparams())
    meta.update(
        batch_size=int(batch_size),
        text_buckets=[int(t) for t in text_buckets],
        spk_dim=int(spk_dim),
        weight_dtypes=w_dtypes,
        buffer_dtypes=b_dtypes,
        streaming=stream.meta() if stream is not None else None,
        stream_weight_dtypes=sw_dtypes,
        stream_inputs=stream_inputs,
        modules=modules,
        infer_kwargs=fn.infer_kwargs,
        **_meta_fields(fn, inputs, platforms, seconds),
    )
    return _write(out_path, entries, meta)


def export_e2tts_bundle(out_path: str, fn, batch_size: int, text_buckets: Sequence[int],
                        max_frames: int, num_mels: int, meta: Dict[str, Any],
                        platforms: Sequence[str] = ("cuda",), weights: Optional[Dict[str, Any]] = None) -> str:
    """Write the E2-TTS artifact of ``fn`` (an ``E2ttsProgram``): per text
    bucket the exported start, CFG Euler step and finish of its loop, at
    ``batch_size`` rows and ``max_frames`` frames; ``meta`` holds
    ``model_params`` besides the JAX meta's fields."""
    meta = dict(meta)
    modules = {"w/model": module_spec(fn.model, _model_params(meta))}
    entries, w_dtypes = _weights_entries(fn.weights() if weights is None else weights)
    inputs = _program_inputs(fn)
    b_entries, b_dtypes = _buffer_entries(inputs, "b")
    entries.update(b_entries)
    seconds: Dict[str, float] = {}
    dev = fn.device
    for t in text_buckets:
        args = [torch.zeros(batch_size, max_frames, num_mels, device=dev),
                torch.ones(batch_size, int(t), dtype=torch.long, device=dev),
                torch.zeros(batch_size, dtype=torch.long, device=dev),
                torch.full((batch_size,), max_frames, dtype=torch.long, device=dev)]
        with _tracing(fn):
            state = fn.start(*args)
        key = f"t{int(t)}"
        entries[f"{key}/start"] = _export(fn, "start", inputs, args, seconds, f"{key}/start")
        entries[f"{key}/step"] = _export(fn, "step", inputs, [state, torch.zeros((), dtype=torch.long, device=dev)],
                                         seconds, f"{key}/step")
        entries[f"{key}/finish"] = _export(fn, "finish", inputs, [state], seconds, f"{key}/finish")
    meta.update(
        output="mel", family="E2TTS", batch_size=int(batch_size), text_buckets=[int(t) for t in text_buckets],
        max_frames=int(max_frames), num_mels=int(num_mels), weight_dtypes=w_dtypes, buffer_dtypes=b_dtypes,
        modules=modules, infer_kwargs=fn.infer_kwargs, **_meta_fields(fn, inputs, platforms, seconds),
    )
    return _write(out_path, entries, meta)


def build_e2tts_bundle_cli(out_path: str, config: Dict[str, Any], model, mel_mean, mel_scale, batch_size: int,
                           text_buckets: Sequence[int], max_frames: int, platforms: Sequence[str]) -> str:
    """CLI glue: build and export the E2-TTS artifact in one call
    (``config["model_params"]`` must hold ``idim``)."""
    fn, weights = build_e2tts_fn(config, model, mel_mean, mel_scale)
    meta = {
        "model_type": "E2TTS",
        "sampling_rate": int(config.get("sampling_rate", 24000)),
        "hop_size": int(config.get("hop_size", 300)),
        "nfe_step": int(config.get("nfe_step", 32)),
        "model_params": dict(config["model_params"]),
    }
    return export_e2tts_bundle(out_path, fn, batch_size, text_buckets, max_frames,
                               int(config.get("num_mels", 80)), meta, platforms, weights=weights)


def export_valle_bundle(out_path: str, fn, batch_size: int, text_buckets: Sequence[int],
                        prompt_frames: int, n_prom_levels: int, meta: Dict[str, Any],
                        platforms: Sequence[str] = ("cuda",), weights: Optional[Dict[str, Any]] = None) -> str:
    """Write the VALL-E artifact of ``fn`` (a ``ValleProgram``): per text
    bucket the exported prefix, AR step and NAR fill; ``meta`` holds
    ``ar_params`` and ``nar_params``, the two models' constructor keywords,
    besides the JAX meta's fields."""
    meta = dict(meta)
    modules = {"w/ar": module_spec(fn.ar, _model_params(meta, "ar_params")),
               "w/nar": module_spec(fn.nar, _model_params(meta, "nar_params"))}
    entries, w_dtypes = _weights_entries(fn.weights() if weights is None else weights)
    inputs = _program_inputs(fn)
    b_entries, b_dtypes = _buffer_entries(inputs, "b")
    entries.update(b_entries)
    seconds: Dict[str, float] = {}
    dev, b = fn.device, int(batch_size)
    for t in text_buckets:
        args = [torch.ones(b, int(t), dtype=torch.long, device=dev),
                torch.full((b,), int(t), dtype=torch.long, device=dev),
                torch.zeros(b, prompt_frames, n_prom_levels, dtype=torch.long, device=dev),
                torch.full((b,), prompt_frames, dtype=torch.long, device=dev)]
        with _tracing(fn):
            state = fn.start(*args)
        key = f"t{int(t)}"
        entries[f"{key}/start"] = _export(fn, "start", inputs, args, seconds, f"{key}/start")
        entries[f"{key}/step"] = _export(fn, "step", inputs, [state], seconds, f"{key}/step")
        entries[f"{key}/fill"] = _export(fn, "fill", inputs, [state["codes"], *args], seconds, f"{key}/fill")
    meta.update(
        output="codes", batch_size=b, text_buckets=[int(t) for t in text_buckets],
        prompt_frames=int(prompt_frames), n_prom_levels=int(n_prom_levels), weight_dtypes=w_dtypes,
        buffer_dtypes=b_dtypes, modules=modules, max_steps=int(fn.max_steps),
        ar_temperature=fn.ar_temperature, nar_temperature=fn.nar_temperature,
        **_meta_fields(fn, inputs, platforms, seconds),
    )
    return _write(out_path, entries, meta)


# --------------------------------------------------------------------------
# the loaded programs
# --------------------------------------------------------------------------

def _no_generator(generator) -> None:
    if generator is not None:
        raise ValueError("an exported program draws from the device's default generator: the bundle seeds it")


class LoadedProgram:
    """An artifact's deserialised programs of one kind (by text bucket) and
    the weight tensors on the device that each takes first."""

    samples_noise = True

    def __init__(self, programs: Dict[Any, Any], weights: List[torch.Tensor], device: torch.device,
                 stats: Dict[str, Optional[torch.Tensor]]):
        self.programs = programs
        self.weights = weights
        self.device = device
        for name, t in stats.items():
            setattr(self, name, t)

    def _program(self, key):
        if key not in self.programs:
            raise ValueError(f"the artifact has no program for text bucket {key}")
        return self.programs[key]


class LoadedMelProgram(LoadedProgram):
    """``program(xs, ilens, spembs)``: the bucket's exported text -> mel
    (-> wav) program; ``infer_kwargs`` as exported."""

    def __init__(self, programs, weights, device, stats, infer_kwargs: Dict[str, Any], spk_dim: int):
        super().__init__(programs, weights, device, stats)
        self.infer_kwargs = dict(infer_kwargs)
        self.spk_dim = int(spk_dim)

    def __call__(self, xs, ilens, spembs=None, generator=None) -> Dict[str, torch.Tensor]:
        _no_generator(generator)
        extra = (spembs,) if self.spk_dim else ()
        return self._program(xs.shape[1])(*self.weights, xs, ilens, *extra)


class LoadedStreamStep(LoadedProgram):
    """``step(mel, k)``: the exported chunk program; the window's geometry
    from the meta (``streaming``)."""

    def __init__(self, program, weights, device, stats, vocoder: Weights, geometry: Dict[str, int]):
        super().__init__({None: program}, weights, device, stats)
        self.vocoder = vocoder
        self.chunk, self.context, self.hop = int(geometry["chunk"]), int(geometry["context"]), int(geometry["hop"])
        self.max_frames, self.num_mels = int(geometry["max_frames"]), int(geometry["num_mels"])
        self.window = min(self.max_frames, self.chunk + 2 * self.context)

    def __call__(self, mel, k) -> torch.Tensor:
        return self.programs[None](*self.weights, mel, k)


class LoadedE2ttsProgram(LoadedProgram):
    """``program(cond_raw, text, ref_lens, duration)``: the bucket's exported
    start, ``steps`` calls of its exported CFG Euler step (step ``i`` given
    as a 0-d tensor on the device) and its finish."""

    def __init__(self, programs, weights, device, stats, infer_kwargs: Dict[str, Any]):
        super().__init__(programs, weights, device, stats)
        self.infer_kwargs = dict(infer_kwargs)
        self.steps = int(self.infer_kwargs.get("steps", 32))
        self.step_index = torch.arange(self.steps, device=device)

    def __call__(self, cond_raw, text, ref_lens, duration, generator=None) -> torch.Tensor:
        _no_generator(generator)
        program = self._program(text.shape[1])
        state = program["start"](*self.weights, cond_raw, text, ref_lens, duration)
        for i in range(self.steps):
            state["y"] = program["step"](*self.weights, state, self.step_index[i])
        return program["finish"](*self.weights, state)


class LoadedValleProgram(LoadedProgram):
    """VALL-E's three exported programs a bucket: :meth:`start`,
    :meth:`step` (in place on the state) and :meth:`fill`; a call runs them
    with ``max_steps - 1`` steps."""

    def __init__(self, programs, weights, device, ar: Weights, nar: Weights, meta: Dict[str, Any]):
        super().__init__(programs, weights, device, {})
        self.ar, self.nar = ar, nar
        self.max_steps = int(meta["max_steps"])
        self.prompt_frames = int(meta["prompt_frames"])
        self.ar_temperature, self.nar_temperature = meta["ar_temperature"], meta["nar_temperature"]

    def start(self, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, Any]:
        _no_generator(generator)
        return self._program(text.shape[1])["start"](*self.weights, text, text_lens, proms, prom_lens)

    def step(self, state, generator=None) -> torch.Tensor:
        _no_generator(generator)
        # the prefix holds text, a separator, the prompt and a separator
        bucket = state["pk"][0].shape[1] - self.prompt_frames - 2
        return self._program(bucket)["step"](*self.weights, state)

    def fill(self, codes, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, torch.Tensor]:
        _no_generator(generator)
        return self._program(text.shape[1])["fill"](*self.weights, codes, text, text_lens, proms, prom_lens)

    def __call__(self, text, text_lens, proms, prom_lens, generator=None) -> Dict[str, torch.Tensor]:
        state = self.start(text, text_lens, proms, prom_lens, generator)
        for _ in range(self.max_steps - 1):
            self.step(state, generator)
        return self.fill(state["codes"], text, text_lens, proms, prom_lens, generator)


# --------------------------------------------------------------------------
# load
# --------------------------------------------------------------------------

def _tensor(z, key: str, dtype_name: Optional[str]) -> torch.Tensor:
    arr = z[key]
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _load_program(z, key: str, exported_on: str, dev: torch.device):
    """The deserialised program under ``key``, moved to ``dev``'s type when
    it was traced on another, as a callable module."""
    from torch.export.passes import move_to_device_pass

    ep = torch.export.load(io.BytesIO(z[key].tobytes()))
    if exported_on != dev.type:
        ep = move_to_device_pass(ep, dev)
    return ep.module()


def load_bundle(path: str, device=None) -> "ServingBundle | E2ttsServingBundle | ValleServingBundle":
    """The artifact's bundle on ``device`` (default: the first of the
    artifact's ``platforms``, ``cuda`` unless the export asked otherwise;
    the CPU only when asked). The programs are deserialised and their
    weights put on the device once; on ``cuda`` the CUDA graphs are captured
    before it returns, and a capture that fails raises. An artifact without
    ``format`` (written before ``torch.export``) is rebuilt from its
    modules' specs."""
    # the kernels' ops must be registered before a program that calls them loads
    import jatts_torch.ops.flash_attention  # noqa: F401
    import jatts_torch.ops.mas  # noqa: F401

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]))
        dev = resolve_device(device if device is not None else (meta.get("platforms") or ["cuda"])[0])
        if meta.get("format") is None:
            bundle = _load_rebuilt(z, meta, dev)
        elif meta["format"] != FORMAT:
            raise ValueError(f"unknown artifact format {meta['format']!r}")
        else:
            bundle = _load_exported(z, meta, dev)
    if dev.type == "cuda":
        bundle.capture()
    return bundle


def _load_exported(z, meta: Dict[str, Any], dev: torch.device):
    dtypes = {**{f"w/{k}": v for k, v in meta["weight_dtypes"].items()},
              **{f"sw/{k}": v for k, v in meta.get("stream_weight_dtypes", {}).items()}, **meta["buffer_dtypes"]}
    cache: Dict[str, torch.Tensor] = {}

    def inputs(keys: Sequence[str]) -> List[torch.Tensor]:
        for k in keys:
            if k not in cache:
                cache[k] = _tensor(z, k, dtypes.get(k)).to(dev)
        return [cache[k] for k in keys]

    def group(prefix: str) -> Dict[str, torch.Tensor]:
        return {k[len(prefix):]: t for k, t in cache.items() if k.startswith(prefix)}

    def stats(prefix: str, names: Sequence[str]) -> Dict[str, Optional[torch.Tensor]]:
        return {n: cache.get(f"{prefix}/{n}") for n in names}

    weights = inputs(meta["inputs"])
    on = meta["program_device"]
    batch = dict(batch_size=meta["batch_size"], buckets=meta["text_buckets"], meta=meta)
    buckets = [int(t) for t in meta["text_buckets"]]
    if meta.get("output") == "codes":
        programs = {t: {part: _load_program(z, f"t{t}/{part}", on, dev) for part in ("start", "step", "fill")}
                    for t in buckets}
        program = LoadedValleProgram(programs, weights, dev, Weights(group("w/ar/")), Weights(group("w/nar/")), meta)
        return ValleServingBundle.loaded(program, prompt_frames=meta["prompt_frames"],
                                         n_prom_levels=meta["n_prom_levels"], **batch)
    if meta.get("family") == "E2TTS":
        programs = {t: {part: _load_program(z, f"t{t}/{part}", on, dev) for part in ("start", "step", "finish")}
                    for t in buckets}
        program = LoadedE2ttsProgram(programs, weights, dev, stats("w", ("mel_mean", "mel_scale")),
                                     meta["infer_kwargs"])
        return E2ttsServingBundle.loaded(program, Weights(group("w/model/")), max_frames=meta["max_frames"],
                                         num_mels=meta["num_mels"], **batch)
    programs = {t: _load_program(z, f"t{t}", on, dev) for t in buckets}
    mel_stats = stats("w", ("mel_mean", "mel_scale", "voc_mean", "voc_scale"))
    program = LoadedMelProgram(programs, weights, dev, mel_stats, meta["infer_kwargs"], meta["spk_dim"])
    stream = None
    if meta.get("streaming"):
        s_weights = inputs(meta["stream_inputs"])
        stream = LoadedStreamStep(_load_program(z, "stream_step", on, dev), s_weights, dev,
                                  stats("sw", ("voc_mean", "voc_scale")), Weights(group("sw/voc/")),
                                  meta["streaming"])
    vocoder = Weights(group("w/voc/")) if any(k.startswith("w/voc/") for k in meta["inputs"]) else None
    return ServingBundle.loaded(program, Weights(group("w/model/")), vocoder, max_frames=meta["max_frames"],
                                hop_size=meta["hop_size"], wav_format=meta.get("wav_format") or "pcm16",
                                spk_dim=meta["spk_dim"], stream=stream, **batch)


def _load_rebuilt(z, meta: Dict[str, Any], dev: torch.device):
    """An artifact of the format before ``torch.export`` (weights and module
    specs): its bundle rebuilt from the modules, which this imports."""
    from jatts_torch.serving.programs import StreamStep

    weights = _weights_from_npz(z, meta)
    sweights = _weights_from_npz(z, meta, prefix="sw", dtype_key="stream_weight_dtypes")
    modules = meta["modules"]
    batch = dict(batch_size=meta["batch_size"], buckets=meta["text_buckets"], meta=meta)
    if meta.get("output") == "codes":
        return ValleServingBundle(
            _rebuild(modules["w/ar"], weights["ar"], dev), _rebuild(modules["w/nar"], weights["nar"], dev),
            max_steps=meta["max_steps"], ar_temperature=meta["ar_temperature"],
            nar_temperature=meta["nar_temperature"], **batch,
        )
    if meta.get("family") == "E2TTS":
        return E2ttsServingBundle(
            _rebuild(modules["w/model"], weights["model"], dev), weights["mel_mean"], weights["mel_scale"],
            max_frames=meta["max_frames"], infer_kwargs=meta["infer_kwargs"], **batch,
        )
    vocoder = _rebuild(modules["w/voc"], weights["voc"], dev) if "voc" in weights else None
    stream = None
    if meta.get("streaming"):
        st = meta["streaming"]
        stream = StreamStep(_rebuild(modules["sw/voc"], sweights["voc"], dev), st["max_frames"], st["num_mels"],
                            chunk=st["chunk"], context=st["context"], voc_mean=sweights.get("voc_mean"),
                            voc_scale=sweights.get("voc_scale"))
    return ServingBundle(
        _rebuild(modules["w/model"], weights["model"], dev), vocoder, weights["mel_mean"], weights["mel_scale"],
        max_frames=meta["max_frames"], voc_mean=weights.get("voc_mean"), voc_scale=weights.get("voc_scale"),
        wav_format=meta.get("wav_format") or "pcm16", infer_kwargs=meta["infer_kwargs"],
        hop_size=meta["hop_size"], stream=stream, **batch,
    )
