"""VALL-E two-stage decode, tts3 stage 5 (counterpart of jatts_tpu/bin/ttslm_decode.py).

Loads an AR and a NAR from the port's checkpoints (``--{ar,nar}-checkpoint``,
else the latest under ``--{ar,nar}-expdir``; their models from
``--{ar,nar}-config``), generates codec level 0 of each csv row with the
KV-cached AR loop (``models/valle.py:ar_generate``), fills levels 1..7 with
the NAR (``nar_generate``) and writes ``outdir/codes/<utt>.npy`` ([T, 8]
int32 codes) and, with a codec, ``outdir/{wav,wav_ar,wav_prompt}/<utt>.wav``
(the 8 levels, level 0 repeated over the 8, and the prompt):

    python -m jatts_torch.bin.ttslm_decode --csv dump/eval.csv --token-list data/tokens.txt \\
        --ar-expdir exp/valle_ar --ar-config exp/valle_ar/config.yml \\
        --nar-expdir exp/valle_nar --nar-config exp/valle_nar/config.yml --outdir exp/decode

It runs on the CUDA card unless ``--device cpu`` is given. Each row's text
is padded to a multiple of 16 tokens and its prompt to the AR's
``prompt_max_frame_length`` frames; the NAR fills the AR's whole
``--max-steps`` capacity, as the JAX CLI's fixed shapes do. The prompt codes
come from the row's ``prompt_feat_path`` (``encodec``, ``.h5`` or ``.npz``;
``[8, T]`` is transposed). Row i draws from generators seeded ``i`` (AR) and
``1000 + i`` (NAR), where the JAX CLI takes ``jax.random.key(i)`` and
``key(1000 + i)``. ``--dtype bfloat16`` (the default) computes in bf16 with
the parameters cast to bf16, logits in f32.

``--codec-path`` names a local EnCodec directory, loaded as the JAX CLI
loads it (``transformers.EncodecModel``, bandwidth 6.0, codes ``[T, 8]``;
read with ``local_files_only``, so nothing is fetched): with it each row's
prompt is encoded from its ``prompt_wav_path`` at ``codec_sampling_rate``
(the AR conf's, default 24000) and the codes are decoded to wavs. When the
codec cannot be loaded (no ``transformers``, no weights there), a warning is
logged and the stage ends at code dumps, as the JAX CLI does; the AR and
NAR run on the device all the same.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import logging
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from jatts_torch.bin.tts_train import DTYPES
from jatts_torch.data.batcher import round_up
from jatts_torch.data.token_id_converter import TokenIDConverter
from jatts_torch.device import resolve_device
from jatts_torch.models.valle import VALLEAR, VALLENAR, ar_generate, nar_generate
from jatts_torch.utils.checkpoint import find_latest_checkpoint, restore_checkpoint
from jatts_torch.utils.config import load_config
from jatts_torch.utils.io import read_array, read_audio, read_csv, write_audio


def load_model(cls, config: Dict[str, Any], n_vocab: int, dtype: torch.dtype, checkpoint: Optional[str],
               expdir: Optional[str], device) -> torch.nn.Module:
    """``cls`` from ``config``'s model_params (its ``dtype`` wins over
    ``dtype`` as the compute dtype) with the checkpoint's weights, in eval
    mode; the parameters cast to bf16 when ``dtype`` is bf16."""
    mp = dict(config["model_params"])
    mp["idim"] = n_vocab
    compute = DTYPES[mp.pop("dtype")] if "dtype" in mp else dtype
    model = cls(**mp, device=device, dtype=compute)
    path = checkpoint or (find_latest_checkpoint(expdir) if expdir else None)
    if path is None:
        raise FileNotFoundError(f"no {cls.__name__} checkpoint found")
    model.load_state_dict(restore_checkpoint(path, map_location=device)["model"])
    if dtype == torch.bfloat16:
        model.to(torch.bfloat16)
    return model.eval()


def load_codec(codec_path: str, device) -> Tuple[Optional[Callable], Optional[Callable]]:
    """(encode, decode) of the local EnCodec at ``codec_path``: encode a
    float32 wav to [T, 8] codes at bandwidth 6.0, decode [T, 8] codes to a
    float32 wav. (None, None) and a warning when it cannot be loaded."""
    try:
        from transformers import EncodecModel

        model = EncodecModel.from_pretrained(codec_path, local_files_only=True).to(device).eval()

        def encode(wav: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                out = model.encode(torch.from_numpy(wav)[None, None].to(device), bandwidth=6.0)
            return out.audio_codes[0, 0].T.cpu().numpy()

        def decode(codes: np.ndarray) -> np.ndarray:
            # audio_codes: (nb_frames, batch, nq, frame_len)
            with torch.no_grad():
                wav = model.decode(torch.from_numpy(codes.T.copy()).long()[None, None].to(device), [None]).audio_values
            return wav[0, 0].cpu().numpy()

        return encode, decode
    except Exception as e:  # noqa: BLE001 - the package or the weights are unavailable
        logging.warning(f"codec unavailable ({e}); emitting code dumps only")
        return None, None


def prompt_codes(row: Dict[str, str]) -> np.ndarray:
    """The row's prompt as [T, 8] int codes from its ``prompt_feat_path``."""
    if not row.get("prompt_feat_path"):
        raise RuntimeError(f"{row.get('sample_id')}: no codec and no precomputed prompt codes (prompt_feat_path)")
    prom = np.asarray(read_array(row["prompt_feat_path"], "encodec")).astype(np.int64)
    return prom.T if prom.shape[0] == 8 else prom


def run(
    csv: str,
    token_list: str,
    ar_config: Dict[str, Any],
    nar_config: Dict[str, Any],
    outdir: str,
    ar_checkpoint: Optional[str] = None,
    ar_expdir: Optional[str] = None,
    nar_checkpoint: Optional[str] = None,
    nar_expdir: Optional[str] = None,
    codec_path: Optional[str] = None,
    dtype: str = "bfloat16",
    max_steps: int = 1000,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """Decode every row of ``csv`` to ``outdir/codes/<utt>.npy``. Returns
    ``rows``: per decoded row its ``utt``, ``n_gen`` (frames), ``level0``
    (the AR's codes over the whole capacity, stop tokens included), ``ar_s``
    and ``nar_s`` (seconds of each stage on the host clock, each ending in a
    fetch to the host)."""
    dev = resolve_device(device)
    with open(token_list, encoding="utf-8") as f:
        n_vocab = len([line for line in f if line.strip()])
    dt = DTYPES[dtype]
    ar = load_model(VALLEAR, ar_config, n_vocab, dt, ar_checkpoint, ar_expdir, dev)
    nar = load_model(VALLENAR, nar_config, n_vocab, dt, nar_checkpoint, nar_expdir, dev)
    sr = int(ar_config.get("codec_sampling_rate", 24000))
    encode, decode = load_codec(codec_path, dev) if codec_path else (None, None)
    conv = TokenIDConverter(token_list)
    tp_cap = ar.prompt_max_frame_length
    rows, _ = read_csv(csv, dict_reader=True)
    for sub in ("wav", "wav_ar", "wav_prompt", "codes"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)

    done = []
    for i, row in enumerate(rows):
        utt = row["sample_id"]
        ids = np.asarray(conv.tokens2ids(row["phonemes"].split(" ")), np.int64)
        if encode is not None:
            prom = encode(read_audio(row["prompt_wav_path"], sr)[0]).astype(np.int64)
        else:
            prom = prompt_codes(row)
        prom = prom[:tp_cap]
        xs = np.zeros((1, round_up(len(ids), 16)), np.int64)
        xs[0, : len(ids)] = ids
        proms = np.zeros((1, tp_cap, prom.shape[1]), np.int64)
        proms[0, : len(prom)] = prom
        args = (torch.from_numpy(xs).to(dev), torch.tensor([len(ids)], device=dev),
                torch.from_numpy(proms).to(dev), torch.tensor([len(prom)], device=dev))

        t0 = time.perf_counter()
        ar_out = ar_generate(ar, *args, max_steps=max_steps,
                             generator=torch.Generator(device=dev).manual_seed(i))
        n_gen = int(ar_out["resp_lens"][0])
        ar_s = time.perf_counter() - t0
        if n_gen == 0:
            logging.warning(f"{utt}: AR generated nothing")
            continue
        t0 = time.perf_counter()
        codes = nar_generate(nar, *args, ar_out["codes"], ar_out["resp_lens"],
                             generator=torch.Generator(device=dev).manual_seed(1000 + i))
        codes = codes[0, :n_gen].cpu().numpy().astype(np.int32)  # [T, 8]
        nar_s = time.perf_counter() - t0
        np.save(os.path.join(outdir, "codes", f"{utt}.npy"), codes)
        if decode is not None:
            write_audio(os.path.join(outdir, "wav", f"{utt}.wav"), decode(codes), sr)
            level0 = codes[:, :1]
            write_audio(os.path.join(outdir, "wav_ar", f"{utt}.wav"), decode(np.repeat(level0, 8, axis=1)), sr)
            write_audio(os.path.join(outdir, "wav_prompt", f"{utt}.wav"), decode(prom), sr)
        done.append({"utt": utt, "n_gen": n_gen, "level0": ar_out["codes"][0].cpu().numpy(), "ar_s": ar_s,
                     "nar_s": nar_s})
        logging.info(f"{utt}: {n_gen} frames (AR {ar_s:.2f} s, NAR {nar_s:.2f} s)")
    logging.info(f"decoded {len(done)} of {len(rows)} utterances")
    return {"rows": done}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description="VALL-E decoding (stage 5).")
    parser.add_argument("--csv", required=True)
    parser.add_argument("--token-list", required=True)
    parser.add_argument("--ar-checkpoint", default=None)
    parser.add_argument("--ar-expdir", default=None)
    parser.add_argument("--ar-config", required=True)
    parser.add_argument("--nar-checkpoint", default=None)
    parser.add_argument("--nar-expdir", default=None)
    parser.add_argument("--nar-config", required=True)
    parser.add_argument("--codec-path", default=None,
                        help="local EnCodec weights (transformers); without them, code dumps only")
    parser.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                        help="compute dtype for the LMs (bf16 also casts the parameters; f32 logits either way)")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--max-steps", type=int, default=1000)
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
        args.csv, args.token_list, load_config(args.ar_config), load_config(args.nar_config), args.outdir,
        ar_checkpoint=args.ar_checkpoint, ar_expdir=args.ar_expdir, nar_checkpoint=args.nar_checkpoint,
        nar_expdir=args.nar_expdir, codec_path=args.codec_path, dtype=args.dtype, max_steps=args.max_steps,
        device=args.device,
    )


if __name__ == "__main__":
    main()
