"""Decode with a trained model, tts1 stage 4 (counterpart of jatts_tpu/bin/tts_decode.py).

Reads the experiment's ``config.yml`` and its latest checkpoint (or
``--checkpoint``), decodes the csv's rows in batches (text padded to a
multiple of 16 tokens, ``--max-frames`` frames of output capacity), vocodes
each utterance and writes ``outdir/wav/<utt>.wav`` and ``<utt>_mel.npy``:

    python -m jatts_torch.bin.tts_decode --csv dump/eval.csv --stats dump/stats.npz \\
        --token-list data/tokens.txt --expdir exp/fastspeech2 \\
        --config exp/fastspeech2/config.yml --outdir exp/fastspeech2/decode

It runs on the CUDA card unless ``--device cpu`` is given. The models are
FastSpeech2 (multi-speaker too: with ``spk_embed_dim`` each batch carries
the rows' ``spkemb``) and Matcha-TTS (``MatchaTTS``, ``MatchaTTS_MAS``:
``ode_steps`` Euler steps from noise scaled by ``temperature``, drawn from a
generator seeded by the batch's first row index, where the JAX CLI takes
``jax.random.key(i)``) and mel-VITS (``VITS``: the prior's noise scaled by
``noise_scale``, from the same generator). ``--vocoder auto`` loads the config's ``vocoder``
checkpoint (a parallel_wavegan HiFi-GAN pickle) and falls back to
Griffin-Lim with a warning when that file is missing; ``--vocoder
griffin_lim`` always inverts with Griffin-Lim. The log's inference speed
counts the acoustic model only and leaves out the first batch of each
shape.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import logging
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from jatts_torch.bin.tts_train import DTYPES, MODELS
from jatts_torch.data.batcher import round_up
from jatts_torch.data.dataset import TTSDataset
from jatts_torch.device import resolve_device
from jatts_torch.serving.bundle import inference_kwargs
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint
from jatts_torch.utils.config import load_config
from jatts_torch.utils.io import read_array, write_audio
from jatts_torch.vocoder.vocoder import GriffinLimVocoder, Vocoder

DECODES = ("FastSpeech2", "MatchaTTS", "MatchaTTS_MAS", "VITS")  # the mel models of the JAX CLI


def select_vocoder(config: Dict[str, Any], vocoder: str, device) -> Any:
    """``auto``: the config's ``vocoder`` checkpoint when the file exists,
    else Griffin-Lim with a warning; ``griffin_lim``: always Griffin-Lim."""
    voc_cfg = config.get("vocoder") or {}
    if vocoder != "griffin_lim" and voc_cfg.get("checkpoint") and os.path.exists(voc_cfg["checkpoint"]):
        return Vocoder(voc_cfg["checkpoint"], voc_cfg["config"], voc_cfg.get("stats"), device=device)
    if vocoder != "griffin_lim" and voc_cfg.get("checkpoint"):
        logging.warning(f"vocoder checkpoint {voc_cfg['checkpoint']} not found; falling back to Griffin-Lim")
    return GriffinLimVocoder(config, device=device)


def run(
    csv: str,
    stats: str,
    token_list: str,
    config: Dict[str, Any],
    outdir: str,
    checkpoint: Optional[str] = None,
    expdir: Optional[str] = None,
    batch_size: int = 8,
    max_frames: int = 2048,
    save_anasyn: bool = False,
    vocoder: str = "auto",
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """Decode every row of ``csv`` with the model of ``config`` (the
    experiment's config.yml as a dict). Returns ``olens`` (frames per
    utterance), ``batches`` (per batch: shape, seconds of the acoustic
    model ending in the fetch to the host, frames, whether it was the
    first of its shape), ``vocoder`` (its class name), ``vocoder_s``
    (seconds per vocoded utterance) and ``rtf`` (steady state, None
    without a second batch of a shape)."""
    dev = resolve_device(device)
    model_type = config["model_type"]
    if model_type not in DECODES:
        raise ValueError(
            f"model_type {model_type!r} is not decoded by this CLI: it decodes {', '.join(DECODES)} (E2TTS: "
            "bin/e2tts_decode.py; VALL-E: bin/ttslm_decode.py)"
        )
    with open(token_list, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    model_params = dict(config["model_params"])
    model_params["idim"] = n_vocab
    # the compute dtype, on the float32 weights the checkpoint holds, as
    # the JAX decode computes
    dtype = DTYPES[model_params.pop("dtype", "float32")]
    model = MODELS[model_type](**model_params, device=dev, dtype=dtype)

    ckpt_path = checkpoint or (find_latest_checkpoint(expdir) if expdir else None)
    if ckpt_path is None:
        raise FileNotFoundError("no checkpoint found")
    model.load_state_dict(restore_checkpoint(ckpt_path, map_location=dev)["model"])
    model.eval()

    hop = int(config.get("hop_size", 300))
    sr = int(config.get("sampling_rate", 24000))
    dataset = TTSDataset(
        csv, stats, config.get("feat_list", ["mel"]), token_list,
        is_inference=True, hop_size=hop, sampling_rate=sr,
    )
    mel_mean = np.asarray(read_array(stats, "mel_mean"))
    mel_scale = np.asarray(read_array(stats, "mel_scale"))

    voc = select_vocoder(config, vocoder, dev)

    infer_kwargs = inference_kwargs(config)
    # multi-speaker: without spembs the model would decode every row with
    # no speaker identity
    use_spembs = bool((config.get("model_params") or {}).get("spk_embed_dim"))
    wav_dir = os.path.join(outdir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    min_frames = int(config.get("fft_size", 2048)) // hop + 1

    items = [dataset[i] for i in range(len(dataset))]
    olens_out: Dict[str, int] = {}
    batches = []
    voc_s = []
    seen_shapes = set()
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        t_text = round_up(max(len(it["x"]) for it in chunk), 16)
        xs = np.zeros((len(chunk), t_text), np.int64)
        ilens = np.zeros((len(chunk),), np.int64)
        for j, it in enumerate(chunk):
            xs[j, : len(it["x"])] = it["x"]
            ilens[j] = len(it["x"])
        spembs = None
        if use_spembs:
            missing = [it["utt_id"] for it in chunk if "spkemb" not in it]
            if missing:
                raise KeyError(
                    f"model has spk_embed_dim but no spkemb feature for {missing[:3]}: "
                    "add 'spkemb' to feat_list/preprocess"
                )
            spembs = torch.from_numpy(np.stack([
                np.asarray(it["spkemb"], np.float32).reshape(-1) for it in chunk
            ])).to(dev)
        kwargs = dict(infer_kwargs)
        if getattr(model, "samples_noise", False):
            kwargs["generator"] = torch.Generator(device=dev).manual_seed(i)
        start = time.time()
        with torch.no_grad():
            out = model.inference(torch.from_numpy(xs).to(dev), torch.from_numpy(ilens).to(dev),
                                  max_frames, spembs, **kwargs)
        feats = out["feat_gen"].float().cpu().numpy()
        olens = out["olens"].cpu().numpy()
        elapsed = time.time() - start
        shape_key = xs.shape
        batches.append({"shape": shape_key, "seconds": elapsed, "frames": int(olens.sum()),
                        "first_of_shape": shape_key not in seen_shapes})
        seen_shapes.add(shape_key)
        for j, it in enumerate(chunk):
            mel = feats[j, : olens[j]]
            olens_out[it["utt_id"]] = int(olens[j])
            if mel.shape[0] < min_frames:
                # a degenerate prediction (durations rounded to ~0, possible
                # early in training): a short silence instead of vocoding a
                # signal shorter than one window
                logging.warning(f"{it['utt_id']}: {mel.shape[0]}-frame prediction")
                wav = np.zeros(hop * 8, np.float32)
            else:
                t0 = time.time()
                wav = voc.decode(mel, mel_mean, mel_scale)
                voc_s.append(time.time() - t0)
            write_audio(os.path.join(wav_dir, f"{it['utt_id']}.wav"), wav, sr)
            if save_anasyn and "mel" in it:
                wav_gt = voc.decode(np.asarray(it["mel"]), mel_mean, mel_scale)
                write_audio(os.path.join(outdir, "wav_anasyn", f"{it['utt_id']}.wav"), wav_gt, sr)
            np.save(os.path.join(wav_dir, f"{it['utt_id']}_mel.npy"), mel)
    steady = [b for b in batches if not b["first_of_shape"]]
    total_frames = sum(b["frames"] for b in steady)
    total_time = sum(b["seconds"] for b in steady)
    rtf = None
    if total_time > 0:
        rtf = total_time / max(total_frames * hop / sr, 1e-9)
        logging.info(f"inference speed = {total_frames / total_time:.1f} frames/sec (RTF {rtf:.6f})")
    return {"olens": olens_out, "batches": batches, "vocoder": type(voc).__name__,
            "vocoder_s": voc_s, "rtf": rtf}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description="Decode with a trained model (stage 4).")
    parser.add_argument("--csv", required=True)
    parser.add_argument("--stats", required=True)
    parser.add_argument("--token-list", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--expdir", default=None, help="locate latest checkpoint here")
    parser.add_argument("--config", required=True, help="exp config.yml")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--max-frames", type=int, default=2048)
    parser.add_argument("--save-anasyn", action="store_true",
                        help="also vocode ground-truth mels (analysis-synthesis wavs)")
    parser.add_argument("--vocoder", default="auto", choices=["auto", "griffin_lim"],
                        help="'auto' = the config's HiFi-GAN checkpoint when present; "
                        "'griffin_lim' = weights-free mel inversion")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; an error without a card)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        force=True,
        level=logging.INFO if args.verbose > 0 else logging.WARNING,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    return run(
        args.csv, args.stats, args.token_list, load_config(args.config), args.outdir,
        checkpoint=args.checkpoint, expdir=args.expdir, batch_size=args.batch_size,
        max_frames=args.max_frames, save_anasyn=args.save_anasyn, vocoder=args.vocoder,
        device=args.device,
    )


if __name__ == "__main__":
    main()
