"""Intermediate results at eval intervals (counterpart of
jatts_tpu/train/intermediate.py): inference on a few dev utterances, the
generated-vs-reference mel plot, the predicted and reference durations, the
predicted token pitch and, with a vocoder, the waveform, under
``<outdir>/predictions/<steps>steps/``.

The noise of a model that samples it (Matcha-TTS's ODE start, VITS's
prior) comes from a generator seeded with ``trainer.steps``, where the JAX
hook passes ``jax.random.key(trainer.steps)``: the same step writes the
same files, and the trainer's own generators are not touched.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from jatts_torch.utils.io import write_audio
from jatts_torch.utils.plot import plot_1d, plot_generated_and_ref


def make_mel_eval_hook(
    dev_items,
    num_save: int = 4,
    max_frames: int = 2048,
    vocoder=None,
    mel_stats: Optional[tuple] = None,
    infer_kwargs: Optional[Dict[str, Any]] = None,
):
    """Returns ``hook(trainer)`` for the mel-output models (FastSpeech2,
    Matcha-TTS, Matcha-TTS+MAS, VITS). ``dev_items`` are dataset items
    (``x``, ``mel``, optionally ``durations``, ``utt_id``, ``spkemb``);
    ``vocoder`` has ``decode(mel, mean, scale)`` and ``sampling_rate``
    (``vocoder/vocoder.py``), ``mel_stats`` the model's mel mean and scale."""
    items = list(dev_items)[:num_save]
    infer_kwargs = infer_kwargs or {}

    @torch.no_grad()
    def hook(trainer):
        model = trainer.model
        if not items or not hasattr(type(model), "inference"):
            return
        outdir = os.path.join(trainer.outdir, "predictions", f"{trainer.steps}steps")
        os.makedirs(outdir, exist_ok=True)
        dev = trainer.device

        t_text = max(len(it["x"]) for it in items)
        xs = np.zeros((len(items), t_text), np.int64)
        ilens = np.zeros((len(items),), np.int64)
        for j, it in enumerate(items):
            xs[j, : len(it["x"])] = it["x"]
            ilens[j] = len(it["x"])
        # speaker conditioning: spembs when the model integrates them, or the
        # previews lose the speaker
        spembs = None
        if getattr(model, "spk_embed_dim", None) and all("spkemb" in it for it in items):
            spembs = torch.from_numpy(
                np.stack([np.asarray(it["spkemb"], np.float32).reshape(-1) for it in items])
            ).to(dev)
        kwargs = dict(infer_kwargs)
        if getattr(model, "samples_noise", False):
            kwargs["generator"] = torch.Generator(device=dev).manual_seed(int(trainer.steps))
        start = time.time()
        out = model.inference(torch.from_numpy(xs).to(dev), torch.from_numpy(ilens).to(dev), max_frames,
                              spembs, **kwargs)
        out = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
               for k, v in out.items() if isinstance(v, torch.Tensor)}
        feats, olens = out["feat_gen"], out["olens"]
        elapsed = time.time() - start
        logging.info(f"(steps {trainer.steps}) inference speed = {olens.sum() / max(elapsed, 1e-9):.1f} frames/sec")
        for j, it in enumerate(items):
            utt = it.get("utt_id", str(j))
            gen = feats[j, : olens[j]]
            ref = np.asarray(it.get("mel", gen))
            plot_generated_and_ref(gen, ref, os.path.join(outdir, f"{utt}.png"))
            if "duration" in out and "durations" in it:
                d_pred = out["duration"][j, : ilens[j]]
                with open(os.path.join(outdir, f"{utt}_dur.txt"), "w") as f:
                    f.write(f"pred: {' '.join(map(str, d_pred))}\n")
                    f.write(f"gt:   {' '.join(map(str, it['durations']))}\n")
            if vocoder is not None and mel_stats is not None:
                wav = vocoder.decode(gen, mel_stats[0], mel_stats[1])
                write_audio(os.path.join(outdir, f"{utt}.wav"), wav, vocoder.sampling_rate)
            if "pitch" in out:
                plot_1d(out["pitch"][j, : ilens[j], 0], os.path.join(outdir, f"{utt}_pitch.png"),
                        "predicted token pitch")

    return hook
