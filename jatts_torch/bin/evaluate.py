"""Stage-5 objective evaluation, tts1 stage 5 (counterpart of
jatts_tpu/bin/evaluate.py; reference jatts/bin/evaluate.py:1-330).

    python -m jatts_torch.bin.evaluate --csv data/eval.csv --wavdir exp/decode/wav \\
        --config conf/fastspeech2.v1.yaml --metrics mcd spkemb \\
        --spkemb-model embedding_model.ckpt --out results.csv

Metrics: MCD / F0RMSE / F0CORR / DDUR (DTW-based, always available), CER
by a local Levenshtein (the ASR model is gated on nue-asr or transformers
weights), speaker cosine similarity (the port's ECAPA-TDNN with a local
speechbrain ``embedding_model.ckpt`` given by ``--spkemb-model``, else the
speechbrain package), SHEET MOS (gated on torch.hub). The results are
printed as an aligned table and written to ``--out``.

It runs on the CUDA card unless ``--device cpu`` is given. The MCD work
splits in two: this process computes every utterance's f0 track on the
device (``evaluate/dtw_based.py:device_features``), then ``--n-jobs``
spawned workers do the numpy part (CheapTrick, sp2mc, the DTW). The
workers import no torch and see no card, so N workers start no CUDA
context, and every ``--n-jobs`` gives the same ``results.csv`` bit for bit.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import logging
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Sequence

import numpy as np

from jatts_torch.evaluate.dtw_based import MCEP_METHODS, calculate_mcd_f0, device_features
from jatts_torch.utils.io import read_audio, read_csv

METRIC_KEYS = ("mcd", "f0rmse", "f0corr", "ddur")


def levenshtein(a: str, b: str) -> int:
    """Edit distance (replaces the jiwer dependency for CER)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def edit_counts(ref, hyp):
    """Alignment counts (hits, substitutions, deletions, insertions) of
    hyp vs ref token sequences: what jiwer's compute_measures returns and
    the reference's corpus-level error rate is built from
    (jatts/bin/evaluate.py:104-112)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, hits, sub, del, ins), compared cost first
    prev = [(j, 0, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i, 0)]
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                c, h, s, d, ins = prev[j - 1]
                cand = (c, h + 1, s, d, ins)
            else:
                c, h, s, d, ins = prev[j - 1]
                cand = (c + 1, h, s + 1, d, ins)
            c, h, s, d, ins = prev[j]
            cand = min(cand, (c + 1, h, s, d + 1, ins))
            c, h, s, d, ins = cur[j - 1]
            cand = min(cand, (c + 1, h, s, d, ins + 1))
            cur.append(cand)
        prev = cur
    _, h, s, d, ins = prev[-1]
    return {"hits": h, "substitutions": s, "deletions": d, "insertions": ins}


def normalize_sentence(sentence: str) -> str:
    """The reference's ASR-eval normalization (jatts/bin/evaluate.py:35-43):
    uppercase, strip punctuation, then pyopenjtalk's kana reading so CER
    compares pronunciations, not orthography. Without pyopenjtalk the
    punctuation-stripped text is compared directly (exact for kana and
    ASCII, a divergence for kanji)."""
    import unicodedata

    sentence = sentence.upper()
    sentence = "".join(ch for ch in sentence if not unicodedata.category(ch).startswith("P"))
    try:
        import pyopenjtalk  # noqa: PLC0415

        sentence = pyopenjtalk.g2p(sentence, kana=True)
    except ImportError:
        pass
    return sentence


def _worker_init():
    """A worker does the numpy part only: it is given no card, so anything
    that reached for one would fail loudly instead of starting a CUDA
    context a worker."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _eval_one(task):
    """The host part of one utterance's MCD/F0/DDUR, from the device
    features computed beforehand; imports no torch."""
    utt, gen_path, ref_path, sr, f0min, f0max, mcep_method, pre = task
    gen, _ = read_audio(gen_path, sr)
    ref, _ = read_audio(ref_path, sr)
    m = calculate_mcd_f0(gen, ref, sr, f0min, f0max, mcep_method=mcep_method, precomputed=pre)
    m["utt_id"] = utt
    return m


def _eval_mcd(tasks, n_jobs: int, device):
    """MCD/F0/DDUR of every task: the device features in this process,
    utterance by utterance, then the host part in ``n_jobs`` spawned
    workers (in this process for 1). Returns (results in task order, the
    device part's seconds, the host part's seconds)."""
    t0 = time.perf_counter()
    jobs = []
    for utt, gen_path, ref_path, sr, f0min, f0max, mcep_method in tasks:
        pre = tuple(
            device_features(read_audio(p, sr)[0], sr, f0min, f0max, mcep_method, device)
            for p in (gen_path, ref_path)
        )
        jobs.append((utt, gen_path, ref_path, sr, f0min, f0max, mcep_method, pre))
    t1 = time.perf_counter()
    if n_jobs > 1:
        import multiprocessing

        with ProcessPoolExecutor(
            max_workers=n_jobs, mp_context=multiprocessing.get_context("spawn"), initializer=_worker_init,
        ) as ex:
            results = list(ex.map(_eval_one, jobs))
    else:
        results = [_eval_one(j) for j in jobs]
    return results, t1 - t0, time.perf_counter() - t1


def _load_asr(args, device=None):
    """Reference-shaped ASR loader (jatts/bin/evaluate.py:25-49): when the
    ``nue_asr`` package is importable, load the model the way the
    reference does (nue_asr.load_model + load_tokenizer, transcription on
    audio centre-padded by 1 s: 8000 samples each side), so real
    rinna/nue-asr weights work unchanged. Else a generic ``transformers``
    ASR pipeline (any local CTC or seq2seq checkpoint via --asr-path) on
    ``device``. Returns transcribe(wav16k) -> text, or None."""
    name = getattr(args, "asr_path", None)
    try:
        import nue_asr  # noqa: PLC0415

        model = nue_asr.load_model(name or "rinna/nue-asr")
        tokenizer = nue_asr.load_tokenizer(name or "rinna/nue-asr")

        def transcribe(wav):
            audio = np.pad(np.asarray(wav, np.float32), (8000, 8000))
            return nue_asr.transcribe(model, tokenizer, audio).text

        return transcribe
    except ImportError:
        pass
    except Exception as e:  # noqa: BLE001 - weights missing or corrupt
        logging.warning(f"nue_asr present but failed to load ({e}); trying the generic pipeline")
    try:
        from transformers import pipeline  # noqa: PLC0415

        asr = pipeline("automatic-speech-recognition", model=name, device=device)
        # raw-array input: a filename would need ffmpeg; the reference also
        # feeds arrays (evaluate.py:95-99 via librosa)
        return lambda wav: asr({"raw": wav, "sampling_rate": 16000})["text"]
    except Exception as e:  # noqa: BLE001 - package or weights unavailable
        logging.warning(f"ASR unavailable ({e}); skipping CER")
        return None


def _eval_asr(tasks, rows, sr, args, device=None):
    """CER by a local ASR model (gated: the reference uses rinna/nue-asr
    with pyopenjtalk kana normalization, evaluate.py:35-112)."""
    transcribe = _load_asr(args, device)
    if transcribe is None:
        return None
    ref_by_utt = {r["sample_id"]: r.get("original_text", "") for r in rows}
    keys = ("hits", "substitutions", "deletions", "insertions")
    c_tot = {k: 0 for k in keys}
    w_tot = {k: 0 for k in keys}
    for utt, gen_path, *_ in tasks:
        wav, _ = read_audio(gen_path, 16000)
        hyp = normalize_sentence(transcribe(wav))
        ref = normalize_sentence(ref_by_utt.get(utt, ""))
        for tot, r, h in ((c_tot, ref, hyp), (w_tot, ref.split(), hyp.split())):
            for k, v in edit_counts(r, h).items():
                tot[k] += v

    # corpus-level rates over pooled counts (reference evaluate.py:104-112)
    def er(r):
        den = r["substitutions"] + r["deletions"] + r["hits"]
        return 100.0 * (r["substitutions"] + r["deletions"] + r["insertions"]) / max(den, 1)

    cer, wer = er(c_tot), er(w_tot)
    print(f"CER: {cer:.2f}%  WER: {wer:.2f}%")
    return cer


def _eval_spkemb(tasks, sr, model_path=None, device=None):
    """Speaker cosine similarity (reference evaluate.py:217-244): the port's
    ECAPA-TDNN (``features/ecapa.py``) on ``device`` with a local
    speechbrain ``embedding_model.ckpt`` when ``model_path`` is given; else
    the speechbrain package; else skipped."""
    encode = None
    if model_path:
        from jatts_torch.features.ecapa import EcapaSpkEmbExtractor  # noqa: PLC0415

        encode = EcapaSpkEmbExtractor(model_path, device=device)
    else:
        try:
            import torch  # noqa: PLC0415
            from speechbrain.pretrained import EncoderClassifier  # noqa: PLC0415

            clf = EncoderClassifier.from_hparams(
                "speechbrain/spkrec-ecapa-voxceleb", run_opts={"device": str(device)}
            )

            def encode(wav):
                with torch.no_grad():
                    return clf.encode_batch(torch.from_numpy(wav)[None]).cpu().numpy().reshape(-1)

        except Exception as e:  # noqa: BLE001 - package or weights unavailable
            logging.warning(f"speechbrain unavailable ({e}); skipping spkemb sim")
            return None

    sims = []
    for utt, gen_path, ref_path, *_ in tasks:
        e1, e2 = (encode(read_audio(p, 16000)[0]) for p in (gen_path, ref_path))
        sims.append(float(np.dot(e1, e2) / max(np.linalg.norm(e1) * np.linalg.norm(e2), 1e-9)))
    sim = float(np.mean(sims))
    print(f"spkemb cosine similarity: {sim:.4f}")
    return sim


def _eval_sheet(tasks, source=None):
    """SHEET MOS prediction (gated on torch.hub: the reference,
    evaluate.py:246-267, loads unilight/sheet:v0.1.0; a machine without
    network passes ``--sheet-source``, a local hubconf directory)."""
    try:
        import torch  # noqa: PLC0415

        predictor = torch.hub.load(
            source or "unilight/sheet:v0.1.0", "default", trust_repo=True,
            **({"source": "local"} if source else {"force_reload": True}),
        )
    except Exception as e:  # noqa: BLE001 - hub or weights unavailable
        logging.warning(f"SHEET unavailable ({e}); skipping MOS")
        return None
    scores = [float(predictor.predict(wav_path=gen)) for _, gen, *_ in tasks]
    mos = float(np.mean(scores))
    print(f"SHEET score: {mos:.3f}")
    return mos


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run stage 5. Returns ``{"results": [...], "means": {...}, "spkemb":
    ..., "device_s": ..., "host_s": ...}`` (seconds of the MCD's device and
    host parts)."""
    parser = argparse.ArgumentParser(description="Objective evaluation (stage 5).")
    parser.add_argument("--csv", required=True, help="test-set csv with wav_path refs")
    parser.add_argument("--wavdir", required=True, help="generated wav directory")
    parser.add_argument("--config", required=True)
    parser.add_argument("--f0-config", default=None)
    parser.add_argument("--metrics", nargs="+", default=["mcd"])
    parser.add_argument("--n-jobs", type=int, default=8)
    parser.add_argument("--asr-path", default=None, help="local ASR weights for CER")
    parser.add_argument("--sheet-source", default=None,
                        help="local torch.hub dir with the SHEET predictor (no network)")
    parser.add_argument("--spkemb-model", default=None,
                        help="local speechbrain embedding_model.ckpt for the ECAPA-TDNN spkemb similarity")
    parser.add_argument("--mcep-method", default="world", choices=MCEP_METHODS,
                        help="mcep extractor: 'world' = CheapTrick+sp2mc (tech-report scale), "
                             "'dct' = fast DCT-of-log-mel (NOT comparable to published MCDs)")
    parser.add_argument("--out", default=None, help="results csv")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; an error without a card)")
    args = parser.parse_args(argv)
    logging.basicConfig(force=True, level=logging.INFO if args.verbose > 0 else logging.WARNING)

    from jatts_torch.device import resolve_device
    from jatts_torch.utils.config import load_config

    dev = resolve_device(args.device)
    sr = int(load_config(args.config).get("sampling_rate", 24000))
    f0_ranges = {}
    if args.f0_config and os.path.exists(args.f0_config):
        f0_ranges = load_config(args.f0_config) or {}

    rows, _ = read_csv(args.csv, dict_reader=True)
    tasks = []
    for row in rows:
        utt = row["sample_id"]
        gen_path = os.path.join(args.wavdir, f"{utt}.wav")
        if not os.path.exists(gen_path):
            logging.warning(f"missing generated wav for {utt}")
            continue
        spk = row.get("spk", "")
        f0min = float(f0_ranges.get(spk, {}).get("f0min", 40))
        f0max = float(f0_ranges.get(spk, {}).get("f0max", 800))
        tasks.append((utt, gen_path, row["wav_path"], sr, f0min, f0max, args.mcep_method))

    out = {"results": [], "means": {}, "spkemb": None, "device_s": 0.0, "host_s": 0.0}
    if "asr" in args.metrics:
        _eval_asr(tasks, rows, sr, args, dev)
    if "spkemb" in args.metrics:
        out["spkemb"] = _eval_spkemb(tasks, sr, args.spkemb_model, dev)
    if "sheet" in args.metrics:
        _eval_sheet(tasks, source=args.sheet_source)

    results = []
    if "mcd" in args.metrics:
        # process-parallel like the reference's mp.Manager fan-out
        # (evaluate.py:277-299), the device part kept in this process
        results, out["device_s"], out["host_s"] = _eval_mcd(tasks, args.n_jobs, dev)
        logging.info(f"MCD/F0 of {len(tasks)} utterances: device part on {dev} {out['device_s']:.3f} s, "
                     f"host part ({args.n_jobs} jobs) {out['host_s']:.3f} s")
    out["results"] = results

    if results:
        keys = list(METRIC_KEYS)
        header = f"{'utt_id':<24}" + "".join(f"{k:>10}" for k in keys)
        print(header)
        print("-" * len(header))
        for m in sorted(results, key=lambda r: r["utt_id"]):
            print(f"{m['utt_id']:<24}" + "".join(f"{m[k]:>10.4f}" for k in keys))
        print("-" * len(header))
        means = {k: float(np.nanmean([m[k] for m in results])) for k in keys}
        out["means"] = means
        print(f"{'mean':<24}" + "".join(f"{means[k]:>10.4f}" for k in keys))
        if args.out:
            import csv as _csv

            with open(args.out, "w", newline="") as f:
                w = _csv.DictWriter(f, fieldnames=["utt_id", *keys])
                w.writeheader()
                for m in results:
                    w.writerow({k: m[k] for k in ["utt_id", *keys]})
    return out


if __name__ == "__main__":
    main()
