"""Serving export: a self-contained inference artifact (counterpart of
jatts_tpu/serving/export.py).

The JAX package serialises its jitted text -> mel (-> wav) programs with
``jax.export``, one per text bucket. The port keeps the artifact's layout
and weight encoding and rebuilds the programs at load instead: the meta
names each module's class and constructor keywords, so :func:`load_bundle`
needs no config file, checkpoint directory or training code. On ``cuda``
the load captures one CUDA graph per text bucket (and one of the stream
step; for VALL-E the prefix, one AR step and the NAR fill), all in one
memory pool (``serving/graphs.py``); on the CPU the same programs run
eagerly. ``torch.export`` is not used: the hand-written kernels launch
through ``ctypes`` (``ops/build.py``), where tracing cannot see them.

Artifact layout (one ``.npz``):
    __meta__          json: batch size, buckets, output kind, rates, ...; the
                      port's own fields: ``modules`` (per weight group its
                      class, constructor keywords, constructor dtype and
                      parameter dtype), ``infer_kwargs`` and the temperatures
    w/<group>/<key>   the program's weights: ``model`` (a state_dict),
                      ``mel_mean``/``mel_scale``, ``voc`` and its statistics
                      for a wav bundle, ``ar``/``nar`` for VALL-E; bf16 as
                      uint16 views, the dtype map in meta["weight_dtypes"]
    sw/<group>/<key>  a streaming bundle's vocoder and statistics
                      (meta["streaming"], meta["stream_weight_dtypes"])

Outputs: a mel bundle ``mel`` (denormalised, f32) and ``olens``; a wav
bundle ``wav`` (int16 quantised in the program, or f32 with the ``mel``);
E2-TTS the generated mel; VALL-E RVQ codes and their lengths (the EnCodec
decode stays outside, as in the JAX artifact). The port reads its own
artifacts, not the JAX package's.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from jatts_torch.device import resolve_device
from jatts_torch.serving.bundle import (
    E2ttsProgram,
    E2ttsServingBundle,
    MelProgram,
    ServingBundle,
    StreamStep,
    ValleProgram,
    ValleServingBundle,
    inference_kwargs,
)

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
                   vocoder=None, wav_format: str = "pcm16") -> Tuple[MelProgram, Dict[str, Any]]:
    """Bind model + stats (+ a ``vocoder/vocoder.py:Vocoder``) into one
    :class:`MelProgram` ``fn(xs, ilens, spembs, generator)`` plus its
    weights, with the per-family inference keywords of ``config``.

    ``wav_format`` (vocoder artifacts only): "pcm16" quantises the waveform
    to int16 in the program and drops the mel from the outputs; "f32" keeps
    the float waveform and the mel."""
    fn = MelProgram(
        model, None if vocoder is None else vocoder.model, mel_mean, mel_scale, max_frames,
        voc_mean=None if vocoder is None else vocoder.mean, voc_scale=None if vocoder is None else vocoder.scale,
        wav_format=wav_format, infer_kwargs=inference_kwargs(config),
    )
    return fn, fn.weights()


def build_stream_step_fn(vocoder, max_frames: int, num_mels: int, chunk: int = 128,
                         context: Optional[int] = None) -> StreamStep:
    """The streaming companion of a mel bundle (a :class:`StreamStep` over a
    ``vocoder/vocoder.py:Vocoder``'s generator and statistics): chunk ``k``
    of the mel program's output into pcm16 through a window of ``context``
    frames (by default the receptive field) each side, clamped to the true
    mel boundaries, so the chunks concatenated equal a pcm16 wav bundle's
    output. Raises when ``max_frames`` is not a multiple of ``chunk`` or
    ``chunk`` is under the context."""
    return StreamStep(vocoder.model, max_frames, num_mels, chunk=chunk, context=context,
                      voc_mean=vocoder.mean, voc_scale=vocoder.scale)


def build_e2tts_fn(config: Dict[str, Any], model, mel_mean: np.ndarray,
                   mel_scale: np.ndarray) -> Tuple[E2ttsProgram, Dict[str, Any]]:
    """E2-TTS prompt-conditioned infill as one program
    ``fn(cond_raw, text, ref_lens, duration, generator) -> mel``: the raw
    (denormalised) prompt log-mel zero-padded to the frame capacity in,
    normalised in the program, the output denormalised; text padded with -1
    (the backbone's filler). ``nfe_step``, ``cfg_strength`` and
    ``sway_sampling_coef`` from ``config``."""
    fn = E2ttsProgram(model, mel_mean, mel_scale, inference_kwargs(config))
    return fn, fn.weights()


def build_valle_fn(ar_model, nar_model, max_steps: int, ar_temperature: float = 1.0,
                   nar_temperature: float = 0.2) -> Tuple[ValleProgram, Dict[str, Any]]:
    """The VALL-E two-stage decode as one :class:`ValleProgram`: the AR at
    ``max_steps`` and the NAR's 7 level fills (level 0 sanitised,
    ``nar_generate``), one generator for both."""
    fn = ValleProgram(ar_model, nar_model, max_steps, ar_temperature, nar_temperature)
    return fn, fn.weights()


def export_bundle(out_path: str, fn: MelProgram, batch_size: int, text_buckets: Sequence[int],
                  meta: Dict[str, Any], spk_dim: int = 0, platforms: Sequence[str] = ("cuda",),
                  weights: Optional[Dict[str, Any]] = None, stream: Optional[StreamStep] = None) -> str:
    """Write the mel/wav artifact of ``fn`` (a :class:`MelProgram`).

    ``meta`` holds the JAX meta's fields (``model_type``, ``num_mels``,
    ``sampling_rate``, ``hop_size``, ``max_frames``, ``output``,
    ``wav_format``, ...) and the port's ``model_params``, the model's
    constructor keywords. ``platforms`` is recorded and has no effect.
    ``stream``: a :class:`StreamStep` that lets the loaded mel bundle
    stream (``synthesize_streaming``)."""
    meta = dict(meta)
    modules = {"w/model": module_spec(fn.model, _model_params(meta))}
    if fn.vocoder is not None:
        modules["w/voc"] = module_spec(fn.vocoder, fn.vocoder.hparams())
    entries, w_dtypes = _weights_entries(fn.weights() if weights is None else weights)
    sw_dtypes: Dict[str, str] = {}
    if stream is not None:
        sw_entries, sw_dtypes = _weights_entries(stream.weights(), prefix="sw")
        entries.update(sw_entries)
        modules["sw/voc"] = module_spec(stream.vocoder, stream.vocoder.hparams())
    meta.update(
        batch_size=int(batch_size),
        text_buckets=[int(t) for t in text_buckets],
        spk_dim=int(spk_dim),
        platforms=list(platforms),
        weights_as_args=True,
        weight_dtypes=w_dtypes,
        streaming=stream.meta() if stream is not None else None,
        stream_weight_dtypes=sw_dtypes,
        modules=modules,
        infer_kwargs=fn.infer_kwargs,
    )
    return _write(out_path, entries, meta)


def export_e2tts_bundle(out_path: str, fn: E2ttsProgram, batch_size: int, text_buckets: Sequence[int],
                        max_frames: int, num_mels: int, meta: Dict[str, Any],
                        platforms: Sequence[str] = ("cuda",), weights: Optional[Dict[str, Any]] = None) -> str:
    """Write the E2-TTS artifact of ``fn``; ``meta`` holds ``model_params``
    besides the JAX meta's fields."""
    meta = dict(meta)
    modules = {"w/model": module_spec(fn.model, _model_params(meta))}
    entries, w_dtypes = _weights_entries(fn.weights() if weights is None else weights)
    meta.update(
        output="mel", family="E2TTS", batch_size=int(batch_size), text_buckets=[int(t) for t in text_buckets],
        max_frames=int(max_frames), num_mels=int(num_mels), platforms=list(platforms), weights_as_args=True,
        weight_dtypes=w_dtypes, modules=modules, infer_kwargs=fn.infer_kwargs,
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


def export_valle_bundle(out_path: str, fn: ValleProgram, batch_size: int, text_buckets: Sequence[int],
                        prompt_frames: int, n_prom_levels: int, meta: Dict[str, Any],
                        platforms: Sequence[str] = ("cuda",), weights: Optional[Dict[str, Any]] = None) -> str:
    """Write the fused VALL-E artifact of ``fn``; ``meta`` holds
    ``ar_params`` and ``nar_params``, the two models' constructor keywords,
    besides the JAX meta's fields."""
    meta = dict(meta)
    modules = {"w/ar": module_spec(fn.ar, _model_params(meta, "ar_params")),
               "w/nar": module_spec(fn.nar, _model_params(meta, "nar_params"))}
    entries, w_dtypes = _weights_entries(fn.weights() if weights is None else weights)
    meta.update(
        output="codes", batch_size=int(batch_size), text_buckets=[int(t) for t in text_buckets],
        prompt_frames=int(prompt_frames), n_prom_levels=int(n_prom_levels), platforms=list(platforms),
        weights_as_args=True, weight_dtypes=w_dtypes, modules=modules, max_steps=int(fn.max_steps),
        ar_temperature=fn.ar_temperature, nar_temperature=fn.nar_temperature,
    )
    return _write(out_path, entries, meta)


def load_bundle(path: str, device=None) -> "ServingBundle | E2ttsServingBundle | ValleServingBundle":
    """Rebuild the artifact's bundle on ``device`` (default ``cuda``; the
    CPU only when asked). On ``cuda`` its CUDA graphs are captured before it
    returns; a capture that fails raises."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]))
        weights = _weights_from_npz(z, meta)
        sweights = _weights_from_npz(z, meta, prefix="sw", dtype_key="stream_weight_dtypes")
    modules = meta["modules"]
    batch = dict(batch_size=meta["batch_size"], buckets=meta["text_buckets"], meta=meta)
    if meta.get("output") == "codes":
        bundle = ValleServingBundle(
            _rebuild(modules["w/ar"], weights["ar"], dev), _rebuild(modules["w/nar"], weights["nar"], dev),
            max_steps=meta["max_steps"], ar_temperature=meta["ar_temperature"],
            nar_temperature=meta["nar_temperature"], **batch,
        )
    elif meta.get("family") == "E2TTS":
        bundle = E2ttsServingBundle(
            _rebuild(modules["w/model"], weights["model"], dev), weights["mel_mean"], weights["mel_scale"],
            max_frames=meta["max_frames"], infer_kwargs=meta["infer_kwargs"], **batch,
        )
    else:
        vocoder = _rebuild(modules["w/voc"], weights["voc"], dev) if "voc" in weights else None
        stream = None
        if meta.get("streaming"):
            st = meta["streaming"]
            stream = StreamStep(_rebuild(modules["sw/voc"], sweights["voc"], dev), st["max_frames"], st["num_mels"],
                                chunk=st["chunk"], context=st["context"], voc_mean=sweights.get("voc_mean"),
                                voc_scale=sweights.get("voc_scale"))
        bundle = ServingBundle(
            _rebuild(modules["w/model"], weights["model"], dev), vocoder, weights["mel_mean"], weights["mel_scale"],
            max_frames=meta["max_frames"], voc_mean=weights.get("voc_mean"), voc_scale=weights.get("voc_scale"),
            wav_format=meta.get("wav_format") or "pcm16", infer_kwargs=meta["infer_kwargs"],
            hop_size=meta["hop_size"], stream=stream, **batch,
        )
    if dev.type == "cuda":
        bundle.capture()
    return bundle
