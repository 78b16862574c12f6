"""Convert a reference PyTorch checkpoint (.pkl) into a checkpoint of the
port that ``bin/tts_decode.py --checkpoint`` and ``bin/tts_train.py
--pretrain`` read (counterpart of jatts_tpu/bin/import_checkpoint.py).

    python -m jatts_torch.bin.import_checkpoint --checkpoint model.pkl \\
        --config conf/fastspeech2.v1.yaml --token-list tokens.txt --out exp/imported

The port's modules carry the reference state_dict keys, so a model is
imported by a strict ``load_state_dict`` into the model the config builds
(on the CPU) and saved as ``checkpoint-0steps/state.pt``. It covers every
model type the port trains. E2-TTS checkpoints default to the EMA weights
(what the reference's decode uses, bin/e2tts_decode.py:144-150); ``--no-ema``
takes the raw model weights and is refused on an EMA-only checkpoint.
``--kind hifigan`` imports a parallel_wavegan HiFi-GAN pickle: the weight-norm
pairs folded and saved in the same format, which ``vocoder/vocoder.py:Vocoder``
reads as its checkpoint. The stochastic duration predictor's keys are the
port's own, and no reference checkpoint carries them, so a config that asks
for it is refused. A reference pickle holds more than tensors and is
unpickled in full: import only checkpoints you trust.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import logging
import os
from typing import Any, Dict, Optional, Sequence

import torch


def _tensors(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference .pkl training checkpoint's model state_dict: its
    ``model`` entry, or the whole pickle when it is a bare state_dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return _tensors(sd)


def load_reference_e2tts_state(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference E2-TTS checkpoint's state_dict (trainers/e2tts.py:155-210):
    full checkpoints carry ``model_state_dict``, ``ema_model_state_dict`` and
    ``update``; EMA-only ones carry just ``ema_model_state_dict``, keys
    prefixed ``ema_model.`` beside EMA bookkeeping (initted, update, step)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not use_ema and "update" not in ckpt:
        # no raw model weights to honour use_ema=False with
        raise ValueError(
            f"{path} is an EMA-only reference checkpoint (no model_state_dict); "
            "cannot import raw weights with use_ema=False"
        )
    if use_ema or "update" not in ckpt:
        sd = {
            k.replace("ema_model.", ""): v
            for k, v in ckpt["ema_model_state_dict"].items()
            if k not in ("initted", "update", "step")
        }
    else:
        sd = ckpt["model_state_dict"]
    return _tensors(sd)


def import_model(checkpoint: str, config: Dict[str, Any], n_vocab: Optional[int] = None,
                 use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The reference model checkpoint as the state_dict of the port model
    that ``config`` builds (strict: every key present, none left over)."""
    from jatts_torch.bin.tts_train import DTYPES, MODELS

    model_type = config["model_type"]
    if model_type not in MODELS:
        raise ValueError(f"unknown model_type {model_type!r} (the port imports {', '.join(MODELS)})")
    mp = dict(config["model_params"])
    if n_vocab is not None:
        mp["idim"] = n_vocab
    if mp.get("duration_predictor_type") == "stochastic":
        raise ValueError(
            "duration_predictor_type: stochastic: the stochastic duration predictor's keys are the port's "
            "own and no reference checkpoint carries them"
        )
    dtype = DTYPES[mp.pop("dtype", "float32")]
    if model_type == "E2TTS":
        sd = load_reference_e2tts_state(checkpoint, use_ema=use_ema)
    else:
        sd = load_reference_checkpoint(checkpoint)
    model = MODELS[model_type](**mp, device="cpu", dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Import and save; returns the checkpoint directory."""
    parser = argparse.ArgumentParser(description="Import a reference checkpoint.")
    parser.add_argument("--checkpoint", required=True, help="reference .pkl")
    parser.add_argument("--config", required=True, help="experiment yaml")
    parser.add_argument("--token-list", default=None)
    parser.add_argument("--out", required=True, help="output checkpoint dir")
    parser.add_argument("--kind", default="model", choices=["model", "hifigan"])
    parser.add_argument("--no-ema", action="store_true",
                        help="E2TTS: import the raw model weights instead of the EMA weights")
    args = parser.parse_args(argv)
    logging.basicConfig(force=True, level=logging.INFO)

    from jatts_torch.utils.checkpoint import save_checkpoint
    from jatts_torch.utils.config import load_config

    if args.kind == "hifigan":
        from jatts_torch.vocoder.vocoder import fold_weight_norm, load_torch_state_dict

        sd = fold_weight_norm(load_torch_state_dict(args.checkpoint))
    else:
        n_vocab = None
        if args.token_list:
            with open(args.token_list, encoding="utf-8") as f:
                n_vocab = len([line for line in f if line.strip()])
        sd = import_model(args.checkpoint, load_config(args.config), n_vocab, use_ema=not args.no_ema)
    state = {"model": sd, "optimizer": None, "steps": 0, "epochs": 0, "ema": None}
    outdir, name = os.path.split(os.path.abspath(args.out))
    # saved under the checkpoint naming scheme
    path = save_checkpoint(outdir if name.startswith("checkpoint-") else args.out, 0, state)
    logging.info(f"imported -> {path}")
    return path


if __name__ == "__main__":
    main()
