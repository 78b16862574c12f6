"""Stage-1 feature extraction, tts1 stage 1 (counterpart of jatts_tpu/bin/preprocess.py).

Reads a csv shard and writes one dump per utterance with the waveform and
the features of ``feat_list`` (log-mel, token-averaged log-f0 ``pitch``,
token-averaged ``energy``), crops the mel to the durations' sum (at most 3
frames apart), and writes the csv back with a ``feat_path`` column:

    python -m jatts_torch.bin.preprocess --csv data/train.csv \\
        --config conf/fastspeech2.v1.yaml --dumpdir dump/train --out-csv dump/train.csv

It runs on the CUDA card unless ``--device cpu`` is given. Dumps are
``{utt}.h5`` (the JAX package's format, needs h5py) or, with
``--dump-format npz``, ``{utt}.npz`` with the same keys, for a machine
without h5py. ``--f0-config`` is a yaml of per-speaker ``f0min``/``f0max``.
Speaker embeddings (``spkemb``) come from the port's ECAPA-TDNN
(``features/ecapa.py``) on speechbrain's ``embedding_model.ckpt`` named by
the config's ``spkemb_model_path``, on the audio resampled to 16 kHz; codec
codes (``encodec*``) need local weights. Without weights the stage warns and
skips the feature, as the JAX CLI does.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import logging
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from jatts_torch.device import resolve_device
from jatts_torch.features.extractors import Dio, Energy, LogMelExtractor
from jatts_torch.utils.config import load_config
from jatts_torch.utils.io import read_audio, read_csv, write_csv, write_hdf5

DUMP_FORMATS = ("h5", "npz")


def _write_dump(path: str, feats: Dict[str, np.ndarray], dump_format: str) -> None:
    if dump_format == "npz":
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **feats)
        return
    for key, value in feats.items():
        write_hdf5(path, key, value)


def run(
    csv: str,
    config: Dict[str, Any],
    dumpdir: str,
    out_csv: Optional[str] = None,
    f0_config: Optional[str] = None,
    dump_format: str = "h5",
    device: Optional[str] = None,
) -> float:
    """Extract the features of every row of ``csv`` into ``dumpdir`` and
    write the csv (``out_csv``, default ``csv``) with ``feat_path``.
    Returns the seconds of audio read."""
    if dump_format not in DUMP_FORMATS:
        raise ValueError(f"dump_format must be one of {DUMP_FORMATS}, got {dump_format!r}")
    dev = resolve_device(device)
    f0_ranges: Dict[str, Any] = {}
    if f0_config and os.path.exists(f0_config):
        f0_ranges = load_config(f0_config) or {}

    sr = int(config["sampling_rate"])
    feat_list = list(config.get("feat_list", ["mel"]))
    # STFT settings are needed only for spectral features
    hop = int(config.get("hop_size", 300))
    mel_ex = None if not ({"mel", "pitch", "energy"} & set(feat_list)) else LogMelExtractor(
        sampling_rate=sr,
        fft_size=config["fft_size"],
        hop_size=hop,
        win_length=config.get("win_length"),
        num_mels=config["num_mels"],
        fmin=config.get("fmin"),
        fmax=config.get("fmax"),
        device=dev,
    )

    spkemb = _spkemb_extractor(config.get("spkemb_model_path"), dev) if "spkemb" in feat_list else None

    rows, fieldnames = read_csv(csv, dict_reader=True)
    os.makedirs(dumpdir, exist_ok=True)
    seconds = 0.0
    for row in rows:
        utt = row["sample_id"]
        spk = row.get("spk", "")
        wav, _ = read_audio(
            row["wav_path"], sr, row.get("start"), row.get("end"),
            gain=float(config.get("global_gain_scale", 1.0)),
        )
        seconds += len(wav) / sr
        feat_path = os.path.join(dumpdir, f"{utt}.{dump_format}")
        mel = mel_ex(wav) if mel_ex is not None else None

        durations = None
        if row.get("durations") and mel is not None:
            durations = np.asarray([int(d) for d in row["durations"].split()])
            # mel frames must match the durations' sum; crop the overhang
            if abs(len(mel) - durations.sum()) > 3:
                raise ValueError(f"{utt}: mel frames {len(mel)} != sum durations {durations.sum()}")
            mel = mel[: durations.sum()]

        feats = {"wave": wav.astype(np.float32)}
        if "mel" in feat_list:
            feats["mel"] = mel.astype(np.float32)
        if "pitch" in feat_list:
            f0min = float(f0_ranges.get(spk, {}).get("f0min", config.get("pitch_extract_f0min", 40)))
            f0max = float(f0_ranges.get(spk, {}).get("f0max", config.get("pitch_extract_f0max", 400)))
            dio = Dio(
                fs=sr, n_fft=config["fft_size"], hop_length=hop, f0min=f0min, f0max=f0max,
                use_token_averaged_f0=durations is not None, device=dev,
            )
            feats["pitch"] = dio(wav, feat_length=len(mel), durations=durations)
        if "energy" in feat_list:
            en = Energy(
                fs=sr, n_fft=config["fft_size"], hop_length=hop,
                use_token_averaged_energy=durations is not None, device=dev,
            )
            feats["energy"] = en(wav, feat_length=len(mel), durations=durations)
        if spkemb is not None:
            feats["spkemb"] = _extract_spkemb(wav, sr, spkemb)
        if any(f.startswith("encodec") for f in feat_list):
            codes = _extract_encodec(wav, sr, config.get("codec_path"), dev)
            if codes is not None:
                feats["encodec"] = codes
                if row.get("prompt_wav_path"):
                    p_wav, _ = read_audio(row["prompt_wav_path"], sr)
                    p_codes = _extract_encodec(p_wav, sr, config.get("codec_path"), dev)
                    if p_codes is not None:
                        feats["prompt_encodec"] = p_codes
        _write_dump(feat_path, feats, dump_format)
        row["feat_path"] = feat_path

    write_csv(rows, out_csv or csv, fieldnames=list(fieldnames) + (
        [] if "feat_path" in fieldnames else ["feat_path"]
    ))
    logging.info(f"processed {len(rows)} utterances -> {dumpdir}")
    return seconds


_ENCODEC_CACHE: dict = {}


def _extract_encodec(wav, sr, codec_path, device):
    """EnCodec codes ``[T, 8]`` through transformers from local weights
    (``codec_path``, read with ``local_files_only``); without weights, the
    package or a usable checkpoint: a warning and None."""
    if not codec_path:
        logging.warning("encodec: no codec_path with local weights; skipping codes")
        return None
    try:
        import torch
        from transformers import EncodecModel

        if codec_path not in _ENCODEC_CACHE:
            _ENCODEC_CACHE[codec_path] = EncodecModel.from_pretrained(
                codec_path, local_files_only=True
            ).to(device).eval()
        model = _ENCODEC_CACHE[codec_path]
        with torch.no_grad():
            out = model.encode(torch.from_numpy(wav)[None, None].to(device), bandwidth=6.0)
        return out.audio_codes[0, 0].T.cpu().numpy().astype(np.int32)
    except Exception as e:  # noqa: BLE001 - package or weights unavailable
        logging.warning(f"encodec unavailable ({e}); skipping codes")
        return None


def _spkemb_extractor(model_path, device):
    """The speaker-embedding extractor of one stage-1 run, built once: the
    port's ECAPA-TDNN on ``device`` with speechbrain's
    ``embedding_model.ckpt`` from a local ``model_path``; without a path
    the speechbrain package when it is importable; else a warning and None
    (the feature is skipped)."""
    if model_path:
        from jatts_torch.features.ecapa import EcapaSpkEmbExtractor

        return EcapaSpkEmbExtractor(model_path, device=device)
    try:
        import torch
        from speechbrain.pretrained import EncoderClassifier

        clf = EncoderClassifier.from_hparams(
            source="speechbrain/spkrec-ecapa-voxceleb", run_opts={"device": str(device)}
        )

        def encode(wav):
            with torch.no_grad():
                return clf.encode_batch(torch.from_numpy(wav)[None]).squeeze().cpu().numpy()

        return encode
    except Exception:  # noqa: BLE001 - package or weights unavailable
        logging.warning("speechbrain unavailable; skipping spkemb")
        return None


def _extract_spkemb(wav, sr, extractor):
    """Speaker embedding of one utterance (the reference's extractor,
    feature_extract/spkemb_speechbrain.py:14-30). For the ECAPA-TDNN the
    audio is resampled to the 16 kHz the voxceleb model was trained on by
    ``resample_poly``, as the JAX CLI does; the speechbrain package is fed
    the corpus rate as it is, as the reference feeds it (a known quirk)."""
    from jatts_torch.features.ecapa import EcapaSpkEmbExtractor

    if sr != 16000 and isinstance(extractor, EcapaSpkEmbExtractor):
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(16000, int(sr))
        wav = resample_poly(wav, 16000 // g, int(sr) // g)
    return np.asarray(extractor(wav), np.float32)


def main(argv: Optional[Sequence[str]] = None) -> float:
    """The CLI; returns :func:`run`'s seconds of audio."""
    parser = argparse.ArgumentParser(description="Extract features (stage 1).")
    parser.add_argument("--csv", required=True, help="input csv")
    parser.add_argument("--config", required=True, help="yaml config")
    parser.add_argument("--dumpdir", required=True, help="output dump directory")
    parser.add_argument("--out-csv", default=None, help="output csv with feat_path")
    parser.add_argument("--f0-config", default=None, help="per-speaker f0 yaml")
    parser.add_argument("--dump-format", default="h5", choices=DUMP_FORMATS,
                        help="h5 (needs h5py) or npz with the same keys")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; an error without a card)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        force=True,
        level=logging.INFO if args.verbose > 0 else logging.WARNING,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    return run(args.csv, load_config(args.config), args.dumpdir, out_csv=args.out_csv,
               f0_config=args.f0_config, dump_format=args.dump_format, device=args.device)


if __name__ == "__main__":
    main()
