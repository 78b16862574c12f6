"""Export a trained model (+ optional HiFi-GAN) as a serving artifact
(counterpart of jatts_tpu/bin/export_serving.py).

Reads the experiment's config, its latest checkpoint (or ``--checkpoint``)
and the stats, traces each served program with ``torch.export`` at its
fixed shapes and writes ONE ``.npz`` of the programs and their weights
(stored once) that ``jatts_torch.serving.load_bundle`` deserialises and
runs with no config file, checkpoint directory or model code
(``jatts_torch/serving/export.py``); on a CUDA card the load captures one
CUDA graph per text bucket:

    python -m jatts_torch.bin.export_serving \\
        --config exp/fs2/config.yml --stats dump/stats.npz \\
        --token-list dump/tokens.txt --expdir exp/fs2 \\
        --out exp/fs2/serving.npz --text-buckets 32,64,128

The mel models are FastSpeech2, MatchaTTS, MatchaTTS_MAS and VITS
(``--vocoder auto`` adds the config's HiFi-GAN when its checkpoint exists,
``none`` exports the mel, ``stream`` the mel plus a chunked-vocoder step for
``BatchingServer.submit_stream``) and E2TTS (its checkpoint's EMA weights
when it has them; the mel). ``--ar-config``/``--nar-config`` export the
fused VALL-E AR+NAR program instead (bf16 parameters; RVQ codes out, the
EnCodec decode outside). The modules are loaded, and the programs traced,
on ``--device`` (default the card; ``cpu`` when asked). ``--platforms``
lists the device types the artifact is for, the first being where
``load_bundle`` puts it by default; a program traced on another device type
is moved at load (``torch.export.passes.move_to_device_pass``), so an
artifact exported with ``--device cpu --platforms cuda`` serves on the card.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from jatts_torch.bin.tts_train import DTYPES, MODELS
from jatts_torch.device import resolve_device
from jatts_torch.serving.export import (
    build_e2tts_bundle_cli,
    build_infer_fn,
    build_stream_step_fn,
    build_valle_fn,
    export_bundle,
    export_valle_bundle,
)
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint
from jatts_torch.utils.config import load_config
from jatts_torch.utils.io import read_array
from jatts_torch.vocoder.vocoder import Vocoder


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(description="Export a trained model as a serving artifact.")
    parser.add_argument("--config", default=None, help="exp config.yml (mel models)")
    parser.add_argument("--stats", default=None)
    parser.add_argument("--token-list", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--expdir", default=None, help="locate latest checkpoint here")
    # VALL-E two-stage export (instead of --config/--stats):
    parser.add_argument("--ar-config", default=None)
    parser.add_argument("--ar-checkpoint", default=None)
    parser.add_argument("--ar-expdir", default=None)
    parser.add_argument("--nar-config", default=None)
    parser.add_argument("--nar-checkpoint", default=None)
    parser.add_argument("--nar-expdir", default=None)
    parser.add_argument("--max-steps", type=int, default=1000, help="VALL-E AR response capacity")
    parser.add_argument("--out", required=True, help="output .npz artifact path")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--text-buckets", default="32,64,128",
                        help="comma-separated text-length buckets (one CUDA graph each at load)")
    parser.add_argument("--max-frames", type=int, default=2048)
    parser.add_argument("--platforms", default="cuda",
                        help="comma-separated device types the artifact is for; the first is load_bundle's "
                        "default device (programs traced on another type are moved there at load)")
    parser.add_argument(
        "--vocoder", default="auto", choices=["auto", "none", "stream"],
        help="'auto' adds the config-declared HiFi-GAN (text->wav artifact) when its checkpoint exists; "
        "'none' exports mel only; 'stream' exports mel + a chunked-vocoder step for low "
        "time-to-first-audio serving (BatchingServer.submit_stream)",
    )
    parser.add_argument("--stream-chunk", type=int, default=128,
                        help="mel frames per streamed audio chunk (--vocoder stream)")
    parser.add_argument("--wav-format", default="pcm16", choices=["pcm16", "f32"],
                        help="waveform output of text->wav artifacts: int16 PCM quantised in the program, "
                        "or float32 (+ mel)")
    parser.add_argument("--device", default=None,
                        help="torch device the modules are loaded on (default: cuda; an error without a card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        force=True,
        level=logging.INFO if args.verbose > 0 else logging.WARNING,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    dev = resolve_device(args.device)
    with open(args.token_list, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    buckets = [int(t) for t in args.text_buckets.split(",") if t]
    platforms = [p for p in args.platforms.split(",") if p]

    if args.ar_config:
        return _export_valle(args, n_vocab, buckets, platforms, dev)
    if not args.config or not args.stats:
        raise SystemExit("--config and --stats are required (or --ar-config/--nar-config for a VALL-E bundle)")

    config = load_config(args.config)
    model_type = config["model_type"]
    model_params = dict(config["model_params"])
    model_params["idim"] = n_vocab
    config = dict(config, model_params=model_params)
    ckpt_path = args.checkpoint or (find_latest_checkpoint(args.expdir) if args.expdir else None)
    if ckpt_path is None:
        raise FileNotFoundError("no checkpoint found")
    restored = restore_checkpoint(ckpt_path, map_location=dev)
    state = dict(restored["model"])
    if model_type == "E2TTS" and restored.get("ema"):
        state.update(restored["ema"])  # the EMA weights, as bin/e2tts_decode.py takes them
    ctor = dict(model_params)
    model = MODELS[model_type](**ctor, device=dev, dtype=DTYPES[ctor.pop("dtype", "float32")])
    model.load_state_dict(state)
    model.eval()
    mel_mean = np.asarray(read_array(args.stats, "mel_mean"))
    mel_scale = np.asarray(read_array(args.stats, "mel_scale"))

    if model_type == "E2TTS":
        out = build_e2tts_bundle_cli(args.out, config, model, mel_mean, mel_scale, args.batch_size, buckets,
                                     args.max_frames, platforms)
        _log_written(out, "mel", buckets, args)
        return out

    vocoder = None
    voc_cfg = config.get("vocoder") or {}
    if args.vocoder in ("auto", "stream") and voc_cfg.get("checkpoint") and os.path.exists(voc_cfg["checkpoint"]):
        vocoder = Vocoder(voc_cfg["checkpoint"], voc_cfg["config"], voc_cfg.get("stats"), device=dev)
    stream = None
    num_mels = int(config.get("num_mels", 80))
    if args.vocoder == "stream":
        if vocoder is None:
            raise SystemExit("--vocoder stream needs the config-declared vocoder checkpoint on disk")
        stream = build_stream_step_fn(vocoder, args.max_frames, num_mels, chunk=args.stream_chunk)
        vocoder = None  # the mel program stays vocoder-free

    fn, weights = build_infer_fn(config, model, mel_mean, mel_scale, args.max_frames, vocoder=vocoder,
                                 wav_format=args.wav_format)
    meta = {
        "model_type": model_type,
        "model_params": model_params,
        "num_mels": num_mels,
        "sampling_rate": int(config.get("sampling_rate", 24000)),
        "hop_size": int(vocoder.hop_size if vocoder is not None else config.get("hop_size", 300)),
        "max_frames": int(args.max_frames),
        "output": "wav" if vocoder is not None else "mel",
        "wav_format": args.wav_format if vocoder is not None else None,
        "checkpoint": os.path.basename(str(ckpt_path)),
    }
    out = export_bundle(args.out, fn, args.batch_size, buckets, meta,
                        spk_dim=int(model_params.get("spk_embed_dim") or 0), platforms=platforms,
                        weights=weights, stream=stream)
    _log_written(out, meta["output"], buckets, args)
    return out


def _export_valle(args, n_vocab: int, buckets, platforms, dev) -> str:
    """The fused AR+NAR two-stage decode (text + prompt codes -> RVQ codes;
    the codec decode outside), bf16 parameters: the KV decode is bound by
    the bytes it reads."""
    from jatts_torch.bin.ttslm_decode import load_model
    from jatts_torch.models.valle import VALLEAR, VALLENAR

    if not args.nar_config:
        raise SystemExit("--nar-config is required with --ar-config")
    ar_config, nar_config = load_config(args.ar_config), load_config(args.nar_config)
    ar = load_model(VALLEAR, ar_config, n_vocab, torch.bfloat16, args.ar_checkpoint, args.ar_expdir, dev)
    nar = load_model(VALLENAR, nar_config, n_vocab, torch.bfloat16, args.nar_checkpoint, args.nar_expdir, dev)
    fn, weights = build_valle_fn(
        ar, nar, max_steps=args.max_steps,
        ar_temperature=float(ar_config.get("sampling_temperature", 1.0)),
        nar_temperature=float(ar_config.get("nar_sampling_temperature", 0.2)),
    )
    meta = {
        "model_type": "VALLE",
        "sampling_rate": int(ar_config.get("codec_sampling_rate", 24000)),
        "max_steps": int(args.max_steps),
        "ar_params": dict(ar_config["model_params"], idim=n_vocab),
        "nar_params": dict(nar_config["model_params"], idim=n_vocab),
    }
    out = export_valle_bundle(args.out, fn, args.batch_size, buckets, prompt_frames=ar.prompt_max_frame_length,
                              n_prom_levels=ar.n_prom_levels, meta=meta, platforms=platforms, weights=weights)
    _log_written(out, "codes", buckets, args)
    return out


def _log_written(out: str, output: str, buckets, args) -> None:
    size_mb = os.path.getsize(out) / 2**20
    logging.info(f"exported {output} bundle -> {out} ({size_mb:.1f} MiB, buckets {buckets}, "
                 f"B={args.batch_size}, platforms {args.platforms})")


if __name__ == "__main__":
    main()
