"""E2-TTS decode, tts2 stage 4 (counterpart of jatts_tpu/bin/e2tts_decode.py).

Each csv row gives a prompt (``prompt_wav_path``, ``prompt_phonemes``) and
the text to say (``phonemes``). The prompt's log-mel is computed from its
wav at the config's feature settings and normalised by the stats; the ids
are the prompt's phonemes, ``<blank>``, then the target's; the row asks for
``len(phonemes) · --frames-per-phone`` frames after the prompt, inside a
``--max-frames`` capacity (a prompt too long for that is cut, with a
warning). Row i's noise comes from a generator seeded ``i``, where the JAX
CLI takes ``jax.random.key(i)``. Writes ``outdir/wav/<utt>_mel.npy`` (the
generated frames, normalised) and ``<utt>.wav``:

    python -m jatts_torch.bin.e2tts_decode --csv data/eval.csv --stats dump/stats.npz \\
        --token-list data/tokens.txt --expdir exp/e2tts --config exp/e2tts/config.yml \\
        --outdir exp/e2tts/decode

It runs on the CUDA card unless ``--device cpu`` is given. The model takes
the checkpoint's EMA weights when it has them (the trainer saves them under
``ema``). ``--vocoder auto`` loads the config's ``vocoder`` checkpoint and
falls back to Griffin-Lim with a warning when that file is missing;
``--vocoder griffin_lim`` always inverts with Griffin-Lim. The stats may be
``.h5`` or ``.npz``.
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

from jatts_torch.bin.tts_decode import select_vocoder
from jatts_torch.bin.tts_train import DTYPES
from jatts_torch.data.token_id_converter import TokenIDConverter
from jatts_torch.device import resolve_device
from jatts_torch.features.extractors import LogMelExtractor
from jatts_torch.models.e2tts import E2TTS
from jatts_torch.serving.bundle import inference_kwargs
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint
from jatts_torch.utils.config import load_config
from jatts_torch.utils.io import read_array, read_audio, read_csv, write_audio


def load_model(config: Dict[str, Any], n_vocab: int, checkpoint: Optional[str], expdir: Optional[str],
               device) -> E2TTS:
    """E2TTS from ``config``'s model_params with the checkpoint's weights,
    its EMA copy over them when it has one; in eval mode."""
    mp = dict(config["model_params"])
    mp["idim"] = n_vocab
    dtype = DTYPES[mp.pop("dtype", "float32")]
    model = E2TTS(**mp, device=device, dtype=dtype)
    path = checkpoint or (find_latest_checkpoint(expdir) if expdir else None)
    if path is None:
        raise FileNotFoundError("no E2TTS checkpoint found")
    restored = restore_checkpoint(path, map_location=device)
    sd = dict(restored["model"])
    if restored.get("ema"):
        sd.update(restored["ema"])
        logging.info(f"{path}: decoding with the EMA weights")
    model.load_state_dict(sd)
    return model.eval()


def run(
    csv: str,
    stats: str,
    token_list: str,
    config: Dict[str, Any],
    outdir: str,
    checkpoint: Optional[str] = None,
    expdir: Optional[str] = None,
    vocoder: str = "auto",
    frames_per_phone: float = 12.0,
    max_frames: int = 3000,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """Decode every row of ``csv`` with the E2TTS of ``config`` (the
    experiment's config.yml as a dict). Returns ``rows`` (per row: ``utt``,
    ``n_prompt``, ``duration``, ``gen`` frames, ``seconds`` of the model
    ending in the fetch to the host) and ``vocoder`` (its class name)."""
    dev = resolve_device(device)
    with open(token_list, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    model = load_model(config, n_vocab, checkpoint, expdir, dev)
    sr = int(config["sampling_rate"])
    mel_ex = LogMelExtractor(
        sampling_rate=sr, fft_size=config["fft_size"], hop_size=int(config["hop_size"]),
        num_mels=config["num_mels"], fmin=config.get("fmin"), fmax=config.get("fmax"), device=dev,
    )
    mel_mean = np.asarray(read_array(stats, "mel_mean"))
    mel_scale = np.asarray(read_array(stats, "mel_scale"))
    conv = TokenIDConverter(token_list)
    voc = select_vocoder(config, vocoder, dev)
    infer_kwargs = inference_kwargs(config)
    num_mels = int(config["num_mels"])

    rows, _ = read_csv(csv, dict_reader=True)
    wav_dir = os.path.join(outdir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    done = []
    for i, row in enumerate(rows):
        utt = row["sample_id"]
        prompt_wav, _ = read_audio(row["prompt_wav_path"], sr)
        prompt_mel = (mel_ex(prompt_wav) - mel_mean) / mel_scale
        phonemes = row["phonemes"].split(" ")
        ids = conv.tokens2ids(row["prompt_phonemes"].split(" ") + ["<blank>"] + phonemes)
        n_gen = int(len(phonemes) * frames_per_phone)
        # clamp the prompt so that generation keeps its room: a prompt past
        # max_frames - n_gen would leave the generated slice empty
        n_prompt = min(len(prompt_mel), max(max_frames - n_gen, 0))
        if n_prompt < len(prompt_mel):
            logging.warning(f"{utt}: prompt truncated {len(prompt_mel)} -> {n_prompt} frames to fit --max-frames")
        duration = min(n_prompt + n_gen, max_frames)
        cond = torch.zeros(1, max_frames, num_mels, device=dev)
        cond[0, :n_prompt] = torch.from_numpy(prompt_mel[:n_prompt].astype(np.float32)).to(dev)
        text = torch.tensor([ids], dtype=torch.long, device=dev)
        start = time.time()
        out = model.inference(
            cond, text, torch.tensor([n_prompt], device=dev), torch.tensor([duration], device=dev),
            generator=torch.Generator(device=dev).manual_seed(i), **infer_kwargs,
        )
        mel = out["feat_gen"][0, n_prompt:duration].float().cpu().numpy()
        seconds = time.time() - start
        np.save(os.path.join(wav_dir, f"{utt}_mel.npy"), mel)
        write_audio(os.path.join(wav_dir, f"{utt}.wav"), voc.decode(mel, mel_mean, mel_scale), sr)
        done.append({"utt": utt, "n_prompt": n_prompt, "duration": duration, "gen": duration - n_prompt,
                     "seconds": seconds})
    logging.info(f"decoded {len(done)} utterances")
    return {"rows": done, "vocoder": type(voc).__name__}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description="E2-TTS decoding (stage 4).")
    parser.add_argument("--csv", required=True)
    parser.add_argument("--stats", required=True)
    parser.add_argument("--token-list", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--expdir", default=None, help="locate the latest checkpoint here")
    parser.add_argument("--config", required=True, help="exp config.yml")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--vocoder", default="auto", choices=["auto", "griffin_lim"],
                        help="'auto' = the config's HiFi-GAN checkpoint when present; "
                        "'griffin_lim' = weights-free mel inversion")
    parser.add_argument("--frames-per-phone", type=float, default=12.0)
    parser.add_argument("--max-frames", type=int, default=3000)
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
        checkpoint=args.checkpoint, expdir=args.expdir, vocoder=args.vocoder,
        frames_per_phone=args.frames_per_phone, max_frames=args.max_frames, device=args.device,
    )


if __name__ == "__main__":
    main()
