"""Check the port's ECAPA-TDNN (features/ecapa.py) against speechbrain's
published weights (counterpart of jatts_tpu/bin/verify_ecapa.py).

The extractor is held against speechbrain's key layout in the tests, but the
published ``spkrec-ecapa-voxceleb`` weights are not in the repository
(reference extractor: jatts/modules/feature_extract/spkemb_speechbrain.py:14-30).
Where they are available locally, this CLI closes the gap:

  # with speechbrain installed and the real ckpt: the extractor against
  # EncoderClassifier.encode_batch on seed-made probe signals, then
  # (optionally) the reference outputs frozen
  python -m jatts_torch.bin.verify_ecapa --ckpt embedding_model.ckpt \\
      --write-golden golden_ecapa.npz

  # anywhere (no speechbrain needed): the extractor against frozen goldens
  python -m jatts_torch.bin.verify_ecapa --ckpt embedding_model.ckpt \\
      --golden golden_ecapa.npz

The probe signals are seed-made (noise, chirp, tone+noise), so goldens
written anywhere verify everywhere; goldens written by the JAX package's CLI
verify here too. The extractor runs on the CUDA card unless ``--device cpu``
is given. Exit code 0 = within --atol.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

import numpy as np


def probe_wavs(sr: int = 16000) -> dict:
    """Deterministic 2 s probe signals spanning noise-like and tonal audio."""
    rng = np.random.default_rng(1234)
    t = np.arange(2 * sr, dtype=np.float32) / sr
    return {
        "noise": (rng.standard_normal(2 * sr) * 0.1).astype(np.float32),
        "chirp": (0.3 * np.sin(2 * np.pi * (80 + 200 * t) * t)).astype(np.float32),
        "tone_noise": (
            0.2 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(2 * sr)
        ).astype(np.float32),
    }


def native_embeddings(ckpt: str, device=None) -> dict:
    """The port's extractor on the probe signals, on ``device``."""
    from jatts_torch.features.ecapa import EcapaSpkEmbExtractor

    ex = EcapaSpkEmbExtractor(model_path=ckpt, device=device)
    return {name: np.asarray(ex(wav)) for name, wav in probe_wavs().items()}


def speechbrain_embeddings(ckpt: str, source: str | None) -> dict | None:
    """Reference embeddings from the REAL speechbrain package, if present."""
    try:
        import torch
        from speechbrain.inference.speaker import EncoderClassifier
    except Exception as e:  # noqa: BLE001 - package absent
        logging.info(f"speechbrain unavailable ({e}); skipping live cross-check")
        return None
    classifier = EncoderClassifier.from_hparams(
        source=source or "speechbrain/spkrec-ecapa-voxceleb"
    )
    if ckpt:
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        classifier.mods.embedding_model.load_state_dict(sd)
    out = {}
    for name, wav in probe_wavs().items():
        out[name] = (
            classifier.encode_batch(torch.from_numpy(wav)[None])
            .detach().numpy().reshape(-1)
        )
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the checks; returns the port's embeddings. Exits non-zero on a
    failed check."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="local speechbrain embedding_model.ckpt")
    ap.add_argument("--golden", default=None,
                    help="frozen reference embeddings (.npz) to verify against")
    ap.add_argument("--write-golden", default=None,
                    help="freeze reference embeddings to this .npz (requires "
                         "speechbrain; falls back to the native outputs with "
                         "a loud warning)")
    ap.add_argument("--source", default=None,
                    help="local EncoderClassifier.from_hparams source dir")
    ap.add_argument("--atol", type=float, default=1e-2,
                    help="tolerance (embeddings are O(10) scale; 1e-2 matches "
                         "the parity tests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error without a card)")
    args = ap.parse_args(argv)
    logging.basicConfig(force=True, level=logging.INFO)

    ours = native_embeddings(args.ckpt, args.device)
    for name, emb in ours.items():
        print(f"native  {name}: dim={emb.shape[0]} norm={np.linalg.norm(emb):.4f} "
              f"head={np.round(emb[:4], 4)}")

    ref = speechbrain_embeddings(args.ckpt, args.source)
    failures = []
    if ref is not None:
        for name in ours:
            err = float(np.max(np.abs(ours[name] - ref[name])))
            ok = err <= args.atol
            print(f"live cross-check {name}: max|Δ|={err:.2e} "
                  f"{'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(name)

    if args.golden:
        with np.load(args.golden) as z:
            golden = {name: z[name] for name in ours}
        for name in ours:
            err = float(np.max(np.abs(ours[name] - golden[name])))
            ok = err <= args.atol
            print(f"golden check {name}: max|Δ|={err:.2e} "
                  f"{'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(name)

    if args.write_golden:
        src = ref if ref is not None else ours
        if ref is None:
            logging.warning(
                "writing golden from the NATIVE extractor (speechbrain absent)"
                ": this freezes the extractor's own outputs, not parity with speechbrain"
            )
        np.savez(args.write_golden, **src)
        print(f"golden written: {args.write_golden}")

    if ref is None and not args.golden:
        print("no reference available (no speechbrain, no --golden): "
              "printed native embeddings only")
    if failures:
        sys.exit(f"ECAPA parity FAILED for: {sorted(set(failures))}")
    print("verify_ecapa: all checks passed")
    return ours


if __name__ == "__main__":
    main()
