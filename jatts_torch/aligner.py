"""Native forced aligner: phoneme durations from scratch, no external tool
(counterpart of jatts_tpu/aligner.py).

The tts1 recipes need per-token frame durations for FastSpeech2/MatchaTTS
to train on. This module produces them with an in-framework aligner built
from components the MAS models also use:

    token embed + conv text encoder
      -> AlignmentModule (-L2 log-softmax lattice, modules/alignment.py)
      -> ForwardSum CTC loss + binarization loss  (losses/align.py)
      -> batched Viterbi (kernels K2 and K3, ops/mas.py)

Forced alignment is transductive: the aligner is trained on exactly the
corpus it aligns (train+dev+test csvs together), so "overfitting" is the
point. A few thousand steps of a tiny model suffice.

Edge silence: when a csv row has no start/end crop yet (raw corpus), a
``<sil>`` token is prepended/appended for alignment only; its aligned frames
become the row's start/end crop, and the inner durations then sum exactly to
the cropped waveform's mel frame count (1 + n_samples // hop), which is the
invariant the stage-1 preprocessing asserts.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.device import resolve_device
from jatts_torch.losses.align import ForwardSumLoss
from jatts_torch.modules.alignment import AlignmentModule
from jatts_torch.modules.layers import Conv1d, Embedding, set_compute_dtype
from jatts_torch.ops.mas import viterbi_decode
from jatts_torch.ops.masks import sequence_mask

SIL_TOKEN = "<sil>"


class Aligner(nn.Module):
    """Lightweight text encoder + alignment lattice.

    Small on purpose: the aligner only needs per-token acoustic templates
    discriminative enough for a monotonic DP, not a TTS-quality encoder.
    Keys follow the flax names: ``embed``, ``conv{i}``, ``ln{i}``,
    ``alignment.*``. Weights are drawn from ``seed`` with the flax
    initialisers' distributions (embedding N(0, 1/adim), convolutions
    truncated normal of variance 1/fan_in, biases 0). Dropout draws from
    ``self.generator`` (``None``: torch's global generator).

    ``dtype`` is a compute dtype, flax's meaning (``modules/layers.py``):
    the embedding, the convolutions and the alignment module compute in it
    on float32 parameters; the ``ln{i}``, which take no ``dtype`` in the JAX
    model, return float32, so the residual stream is float32 after the
    first layer, as there.
    """

    def __init__(
        self,
        idim: int,            # vocabulary size (incl. <sil> at id 0)
        odim: int,            # mel bins
        adim: int = 256,
        elayers: int = 2,
        dropout_rate: float = 0.1,
        mas_backend: str = "auto",
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.elayers = elayers
        self.dropout_rate = dropout_rate
        self.mas_backend = mas_backend
        self.generator: Optional[torch.Generator] = None
        self.embed = Embedding(idim, adim)
        for i in range(elayers):
            setattr(self, f"conv{i}", Conv1d(adim, adim, 3, padding=1))
            # torch's own layer: no compute dtype, as the JAX ``ln{i}`` take none
            setattr(self, f"ln{i}", nn.LayerNorm(adim, eps=1e-6))
        self.alignment = AlignmentModule(adim, odim)
        set_compute_dtype(self, dtype)
        self.reset_parameters(seed)
        self.to(resolve_device(device))

    def reset_parameters(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, self.embed.embedding_dim ** -0.5, generator=g)
            for m in self.modules():
                if isinstance(m, nn.Conv1d):
                    fan_in = m.in_channels * m.kernel_size[0]
                    # a normal cut at +-2 sigma has 0.8796 of its sigma
                    std = fan_in ** -0.5 / 0.87962566
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=g)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout_rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.dropout_rate
        return x * keep / (1.0 - self.dropout_rate)

    def forward(self, xs, ilens, ys, olens):
        """xs: [B, T_text] int ids; ys: [B, T_feats, odim] normalized mel.

        Returns dict(log_p_attn [B, T_feats, T_text], ds [B, T_text],
        bin_loss scalar). Dropout is on in ``train()`` mode only.
        """
        x_masks = sequence_mask(ilens, xs.shape[1])  # [B, T_text] bool
        keep = x_masks[..., None].to(self.embed.weight.dtype)
        h = self.embed(xs) * keep
        for i in range(self.elayers):
            r = getattr(self, f"conv{i}")(h.transpose(1, 2)).transpose(1, 2)
            ln = getattr(self, f"ln{i}")
            r = ln(F.relu(r).to(ln.weight.dtype))
            h = (h + self._dropout(r)) * keep
        log_p_attn = self.alignment(h, ys, x_masks)
        ds, bin_loss = viterbi_decode(log_p_attn, ilens, olens, backend=self.mas_backend)
        return {"log_p_attn": log_p_attn, "ds": ds, "bin_loss": bin_loss}


# --------------------------------------------------------------------------
# corpus preparation
# --------------------------------------------------------------------------

def build_vocab(rows_lists: Sequence[Sequence[dict]]) -> Dict[str, int]:
    """Internal token->id map over every csv's ``phonemes`` column.

    Id 0 is reserved for the edge-silence token; the mapping is private to
    the aligner (durations are id-agnostic), so no tokens.txt is needed:
    alignment runs at stage 0, before the recipe's token list exists.
    """
    toks = set()
    for rows in rows_lists:
        for row in rows:
            toks.update((row.get("phonemes") or "").split())
    vocab = {SIL_TOKEN: 0}
    for t in sorted(toks):
        vocab[t] = len(vocab)
    return vocab


def prepare_item(
    row: dict,
    mel: np.ndarray,
    vocab: Dict[str, int],
    n_samples: int,
    hop: int,
) -> Optional[dict]:
    """One csv row + its (un-normalized) mel -> aligner work item.

    ``n_samples`` is the sample count of the waveform the mel was computed
    from (after any existing start/end crop). Returns None when the row
    cannot be aligned (no phonemes, or more tokens than frames).
    """
    phonemes = (row.get("phonemes") or "").split()
    if not phonemes:
        return None
    edge_sil = not (row.get("start") or "").strip()
    ids = [vocab[p] for p in phonemes]
    if edge_sil:
        ids = [0, *ids, 0]
    n_frames = min(len(mel), 1 + n_samples // hop)
    if len(ids) > n_frames:
        return None
    return {
        "row": row,
        "tokens": np.asarray(ids, np.int32),
        "mel": np.asarray(mel[:n_frames], np.float32),
        "n_frames": n_frames,
        "n_samples": n_samples,
        "edge_sil": edge_sil,
    }


def normalize_mels(items: List[dict]) -> None:
    """In-place corpus mean/var normalization (stabilizes the -L2 lattice)."""
    tot = np.zeros(items[0]["mel"].shape[-1], np.float64)
    tot2 = np.zeros_like(tot)
    n = 0
    for it in items:
        m = it["mel"]
        tot += m.sum(axis=0)
        tot2 += (m.astype(np.float64) ** 2).sum(axis=0)
        n += len(m)
    mean = tot / max(n, 1)
    std = np.sqrt(np.maximum(tot2 / max(n, 1) - mean**2, 1e-8))
    for it in items:
        it["mel"] = ((it["mel"] - mean) / std).astype(np.float32)


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def make_batches(
    items: List[dict],
    batch_size: int,
    tok_mult: int = 8,
    frame_mult: int = 64,
) -> List[dict]:
    """Sort by frame length, chunk, pad to rounded shapes (the same batches,
    in the same order, as the JAX package makes, so that a training run
    visits the same data)."""
    order = sorted(range(len(items)), key=lambda i: items[i]["n_frames"])
    batches = []
    for c in range(0, len(order), batch_size):
        idx = order[c : c + batch_size]
        t_tok = _round_up(max(len(items[i]["tokens"]) for i in idx), tok_mult)
        t_frm = _round_up(max(items[i]["n_frames"] for i in idx), frame_mult)
        b = len(idx)
        xs = np.zeros((b, t_tok), np.int32)
        ys = np.zeros((b, t_frm, items[idx[0]]["mel"].shape[-1]), np.float32)
        ilens = np.zeros((b,), np.int32)
        olens = np.zeros((b,), np.int32)
        for j, i in enumerate(idx):
            it = items[i]
            xs[j, : len(it["tokens"])] = it["tokens"]
            ys[j, : it["n_frames"]] = it["mel"]
            ilens[j] = len(it["tokens"])
            olens[j] = it["n_frames"]
        batches.append(
            {"xs": xs, "ys": ys, "ilens": ilens, "olens": olens, "items": idx}
        )
    return batches


def _batch_tensors(batch: dict, device: torch.device):
    """(xs, ilens, ys, olens) of a padded batch as tensors on ``device``."""
    return (
        torch.from_numpy(batch["xs"]).to(device=device, dtype=torch.int64),
        torch.from_numpy(batch["ilens"]).to(device=device, dtype=torch.int64),
        torch.from_numpy(batch["ys"]).to(device),
        torch.from_numpy(batch["olens"]).to(device=device, dtype=torch.int64),
    )


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def warmup_cosine_lr(step: int, peak: float, warmup_steps: int, decay_steps: int) -> float:
    """Linear warm-up from 0 to ``peak`` over ``warmup_steps``, then a cosine
    to 0 that ends at ``decay_steps`` (counted from step 0)."""
    if step < warmup_steps:
        return peak * step / warmup_steps
    span = max(decay_steps - warmup_steps, 1)
    frac = min(step - warmup_steps, span) / span
    return peak * 0.5 * (1.0 + math.cos(math.pi * frac))


def train_aligner(
    model: Aligner,
    batches: List[dict],
    steps: int = 2000,
    lr: float = 1e-3,
    bin_loss_start_frac: float = 0.5,
    lambda_bin: float = 1.0,
    seed: int = 0,
    log_every: int = 200,
) -> Dict[str, List[float]]:
    """Train ``model`` in place on the padded batches, from the weights it
    holds, on the device it lies on. Returns the per-step history
    ``{"loss", "fsum", "bin"}``.

    Loss schedule as in the MAS trainers: ForwardSum CTC from step 0, the
    binarization loss gated in after ``bin_loss_start_frac`` of training so
    the soft lattice settles before Viterbi hardening. ``seed`` orders the
    batches (numpy) and seeds the dropout masks.
    """
    device = next(model.parameters()).device
    fsum = ForwardSumLoss()
    bin_start = int(steps * bin_loss_start_frac)
    warmup_steps = max(1, min(200, steps // 10))
    decay_steps = max(2, steps)
    opt = torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-6
    )
    model.generator = torch.Generator(device=device).manual_seed(seed + 2)
    model.train()

    rng = np.random.default_rng(seed)
    order = np.arange(len(batches))
    history = []
    i = 0
    for s in range(steps):
        if i == 0:
            rng.shuffle(order)
        xs, ilens, ys, olens = _batch_tensors(batches[order[i]], device)
        i = (i + 1) % len(batches)
        for group in opt.param_groups:
            group["lr"] = warmup_cosine_lr(s, lr, warmup_steps, decay_steps)
        out = model(xs, ilens, ys, olens)
        l_fsum = fsum(out["log_p_attn"], ilens, olens)
        loss = l_fsum + lambda_bin * float(s >= bin_start) * out["bin_loss"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        # kept on the device: one fetch at the end, none in the loop
        history.append(torch.stack([loss.detach(), l_fsum.detach(), out["bin_loss"].detach()]))
        if log_every and (s % log_every == 0 or s == steps - 1):
            l, l_f, l_b = history[-1].tolist()
            logging.info(
                "aligner step %d/%d: loss %.4f (fsum %.4f, bin %.4f)", s, steps, l, l_f, l_b
            )
    model.generator = None
    model.eval()
    table = torch.stack(history).cpu().tolist() if history else []
    return {
        "loss": [r[0] for r in table], "fsum": [r[1] for r in table], "bin": [r[2] for r in table]
    }


# --------------------------------------------------------------------------
# duration dump
# --------------------------------------------------------------------------

def dump_durations(
    model: Aligner, batches: List[dict], items: List[dict]
) -> List[Optional[np.ndarray]]:
    """Viterbi durations per item (aligned to ``items`` order; full token
    sequence incl. edge-sil)."""
    device = next(model.parameters()).device
    model.eval()
    result: List[Optional[np.ndarray]] = [None] * len(items)
    with torch.no_grad():
        for b in batches:
            ds = model(*_batch_tensors(b, device))["ds"].cpu().numpy()
            for j, i in enumerate(b["items"]):
                n_tok = len(items[i]["tokens"])
                result[i] = np.rint(ds[j, :n_tok]).astype(np.int64)
    return result


def row_updates_from_durations(
    item: dict, ds: np.ndarray, hop: int, fs: int
) -> dict:
    """Durations (+ start/end crop from edge-sil frames) for the csv row.

    Invariant: the returned durations sum to ``1 + n_cropped // hop``, the
    mel frame count the stage-1 preprocessing computes for the (re-)cropped
    waveform.
    """
    n = item["n_samples"]
    total = int(ds.sum())
    if item["edge_sil"]:
        s0, s1 = int(ds[0]), int(ds[-1])
        inner = ds[1:-1].copy()
        # keep >= 1 frame per real token even if MAS gave everything to sil
        a = min(s0 * hop, max(n - hop * len(inner), 0))
        b_samp = max(n - s1 * hop, a + hop * len(inner))
        b_samp = min(b_samp, n)
        expected = 1 + (b_samp - a) // hop
        # half-sample offset: read_audio crops via int(float(start) * fs)
        # (truncation), so land mid-sample to make the crop exact regardless
        # of decimal-repr rounding
        start, end = (a + 0.5) / fs, (b_samp + 0.5) / fs
        upd = {"start": f"{start:.9f}", "end": f"{end:.9f}"}
    else:
        inner = ds.copy()
        expected = 1 + n // hop
        upd = {}
    # distribute any rounding residual, largest-duration tokens first
    residual = int(expected - inner.sum())
    if residual != 0 and len(inner):
        order = np.argsort(-inner)
        step = 1 if residual > 0 else -1
        k = 0
        while residual != 0:
            j = order[k % len(inner)]
            if step < 0 and inner[j] <= 1:
                k += 1
                continue
            inner[j] += step
            residual -= step
            k += 1
    assert int(inner.sum()) == expected, (int(inner.sum()), expected, total)
    upd["durations"] = " ".join(str(int(d)) for d in inner)
    return upd
