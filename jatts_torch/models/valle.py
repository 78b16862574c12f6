"""VALL-E AR and NAR neural-codec LMs (counterpart of jatts_tpu/models/valle.py).

The reference's lists of variable-length tensors are packed padded arrays:
each sample's ``[text | sep | prompt | sep | response]`` sequence lies
contiguously from position 0 (:func:`pack_three`, :func:`pack_ids`).
:class:`VALLEAR` trains by next-token cross-entropy over the packed sequence
(``forward``, the JAX ``__call__``) and decodes codec level 0 with a KV cache
(:func:`ar_generate`: ``prefix_forward`` once, then ``decode_one`` a
token). :class:`VALLENAR` (AdaLN blocks, non-causal attention) trains on a
random level per sample and fills levels 1-7 from level 0 one level after
another (:func:`nar_generate`). Parameters carry the reference state_dict
keys that ``jatts_tpu.utils.torch_import.convert_valle`` reads; ``dtype`` is
the compute dtype in flax's sense (parameters stay float32, logits are
float32), see ``modules/valle_modules.py``. Dropout follows
``self.training``. ``use_remat`` recomputes each block of the trunk in the
backward (``modules/remat.py``; ``remat_policy`` a
``jax.checkpoint_policies`` name), as the JAX model wraps each block in
``nn.remat``; the KV-cached decode runs plain.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from jatts_torch.device import resolve_device
from jatts_torch.modules.remat import Remat, dropout_generators
from jatts_torch.modules.valle_modules import Dense, SinusoidalEmbedding, VALLEBlock, trunc_normal_
from jatts_torch.ops.masks import sequence_mask
from jatts_torch.parallel.mesh import draw, global_sum

IGNORE = -100


def pack_three(e_text, text_lens, e_prom, prom_lens, e_resp, resp_lens, sep):
    """Pack ``[text | sep | prom | sep | resp]`` contiguously per sample.

    e_*: [B, T_i, D] embeddings; sep: [D]. Returns packed [B, S, D]
    (S = Tx + 1 + Tp + 1 + Tr) and total lengths [B]. One gather from a
    ``[text | sep | prom | resp | zero]`` source by a per-position index;
    positions past a sample's total read the zero row."""
    b, tx, d = e_text.shape
    tp, tr = e_prom.shape[1], e_resp.shape[1]
    s = tx + 1 + tp + 1 + tr
    pos = torch.arange(s, device=e_text.device)[None, :]
    lx, lp, lr = text_lens[:, None], prom_lens[:, None], resp_lens[:, None]
    sep_row = sep.to(e_text.dtype).expand(b, 1, d)
    zero_row = e_text.new_zeros(b, 1, d)
    src = torch.cat([e_text, sep_row, e_prom.to(e_text.dtype), e_resp.to(e_text.dtype), zero_row], dim=1)
    sep_idx, zero_idx = tx, tx + 1 + tp + tr
    is_text = pos < lx
    is_sep = (pos == lx) | (pos == lx + 1 + lp)
    is_prom = (pos > lx) & (pos < lx + 1 + lp)
    is_resp = (pos > lx + 1 + lp) & (pos < lx + 2 + lp + lr)
    idx = torch.where(
        is_text, pos,
        torch.where(
            is_sep, sep_idx,
            torch.where(
                is_prom, pos - (lx + 1) + (tx + 1),
                torch.where(is_resp, pos - (lx + lp + 2) + (tx + 1 + tp), zero_idx),
            ),
        ),
    ).clamp(0, zero_idx)
    packed = torch.gather(src, 1, idx[..., None].expand(b, s, d))
    return packed, text_lens + prom_lens + resp_lens + 2


def pack_ids(vals_text, text_lens, tp: int, prom_lens, vals_resp, resp_lens, fill: int = IGNORE):
    """:func:`pack_three`'s layout for integer ids; prompt and sep rows get
    ``fill``. Returns [B, S] int64."""
    b, tx = vals_text.shape
    tr = vals_resp.shape[1]
    s = tx + 1 + tp + 1 + tr
    pos = torch.arange(s, device=vals_text.device)[None, :]
    lx, lp, lr = text_lens[:, None], prom_lens[:, None], resp_lens[:, None]
    g_text = torch.gather(vals_text.long(), 1, pos.clamp(0, tx - 1).expand(b, s))
    g_resp = torch.gather(vals_resp.long(), 1, (pos - (lx + lp + 2)).clamp(0, tr - 1))
    out = torch.full((b, s), fill, dtype=torch.long, device=vals_text.device)
    out = torch.where(pos < lx, g_text, out)
    return torch.where((pos > lx + 1 + lp) & (pos < lx + 2 + lp + lr), g_resp, out)


class MultiEmbedding(nn.Module):
    """Per-level embedding tables [L, V, D] (the reference's MultiEmbedding,
    key ``weight``), drawn from N(0, 1) as the JAX package draws them."""

    def __init__(self, n_levels: int, n_tokens: int, d_model: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(n_levels, n_tokens, d_model, device=device))


class VALLEBase(nn.Module):
    causal = True
    use_stop_token = True
    norm_type = "ln"

    def __init__(
        self,
        idim: Optional[int] = None,  # unused (the reference's signature)
        n_tokens: int = 1024,
        d_model: int = 512,
        n_heads: int = 8,
        n_layers: int = 12,
        p_dropout: float = 0.1,
        n_prom_levels: int = 8,
        n_resp_levels: int = 7,
        prompt_prefix_mode: int = 1,
        prompt_max_frame_length: int = 225,
        attn_backend: str = "xla",
        use_remat: bool = False,
        remat_policy: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.remat = Remat(use_remat, remat_policy)
        dev = resolve_device(device)
        self.n_tokens = n_tokens
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.n_prom_levels = n_prom_levels
        self.n_resp_levels = n_resp_levels
        self.prompt_max_frame_length = prompt_max_frame_length
        self.dtype = dtype
        self.text_emb = nn.Embedding(n_tokens, d_model, device=dev)
        with torch.no_grad():
            trunc_normal_(self.text_emb.weight, d_model ** -0.5)  # flax's Embed init
        self.proms_emb = MultiEmbedding(n_prom_levels, n_tokens, d_model, device=dev)
        self.resps_emb = MultiEmbedding(n_resp_levels, self.n_resp_tokens, d_model, device=dev)
        self.sep = nn.Parameter(torch.randn(d_model, device=dev))
        self.sin_emb = SinusoidalEmbedding(d_model)
        self.blocks = nn.ModuleList(
            VALLEBlock(
                d_model, n_heads, p_dropout, self.causal, self.norm_type, n_resp_levels,
                attn_backend=attn_backend, compute_dtype=dtype, device=dev,
            )
            for _ in range(n_layers)
        )
        self.classifier = Dense(d_model, self.n_resp_tokens, compute_dtype=dtype, device=dev)

    @property
    def stop_token(self) -> int:
        return self.n_tokens

    @property
    def n_resp_tokens(self) -> int:
        return self.n_tokens + (1 if self.use_stop_token else 0)

    def _multi_embed(self, weight, codes, n_active):
        """Sum of the embeddings of the first ``n_active[b]`` levels of
        ``codes`` [B, T, L] (levels past the table's count are dropped)."""
        n_lv = min(codes.shape[-1], weight.shape[0])
        v = weight.shape[1]
        flat = weight[:n_lv].reshape(n_lv * v, weight.shape[-1])
        offs = torch.arange(n_lv, device=codes.device) * v
        emb = F.embedding(codes[:, :, :n_lv].long() + offs, flat)  # [B, T, L, D]
        active = (torch.arange(n_lv, device=codes.device)[None, :] < n_active[:, None]).to(emb.dtype)
        return torch.einsum("btld,bl->btd", emb, active)

    def trunk(
        self, text, text_lens, proms, prom_lens, resps, resp_lens, resp_levels,
        quant_levels=None, return_hidden: bool = False,
    ):
        """Packed forward -> logits [B, S, n_resp_tokens] f32 (or, with
        ``return_hidden``, the hidden states [B, S, D]) and the totals [B].
        The residual stream is cast to the compute dtype once, after the f32
        embeddings, packing and sinusoids."""
        b = text.shape[0]
        e_text = self.text_emb(text.long())
        e_prom = self._multi_embed(
            self.proms_emb.weight, proms, torch.full((b,), proms.shape[-1], device=text.device)
        )
        e_resp = self._multi_embed(self.resps_emb.weight, resps, resp_levels)
        x, total = pack_three(e_text, text_lens, e_prom, prom_lens, e_resp, resp_lens, self.sep)
        x = self.sin_emb(x).to(self.dtype)
        m = sequence_mask(total, x.shape[1], x.dtype)[..., None]
        remat = self.remat.active(self)
        for block in self.blocks:
            if remat:
                x = self.remat(block, x, m, quant_levels, generators=dropout_generators(block))
            else:
                x = block(x, m, quant_levels)
        if return_hidden:
            return x, total
        return (self.classifier(x) * m).float(), total


class VALLEAR(VALLEBase):
    causal = True
    use_stop_token = True
    norm_type = "ln"

    def __init__(self, *args, n_resp_levels: int = 1, **kwargs):
        # the AR trains and decodes codec level 0 only
        super().__init__(*args, n_resp_levels=n_resp_levels, **kwargs)

    def forward(self, text, text_lens, proms, prom_lens, resps, resp_lens) -> Dict[str, torch.Tensor]:
        """Training: next-token cross-entropy over the packed sequence.
        text [B, Tx]; proms [B, Tp, Lp]; resps [B, Tr] level-0 codes.
        Targets: the text's next token, none across a segment boundary or on
        the prompt and the second sep, the response's next token and the
        stop token after its last one."""
        b = text.shape[0]
        tp = proms.shape[1]
        logits, total = self.trunk(
            text, text_lens, proms, prom_lens, resps[..., None], resp_lens,
            torch.ones(b, dtype=torch.long, device=text.device),
        )
        y = pack_ids(text, text_lens, tp, prom_lens, resps, resp_lens)
        pos = torch.arange(y.shape[1], device=y.device)[None, :]
        tgt = torch.cat([y[:, 1:], torch.full((b, 1), IGNORE, dtype=y.dtype, device=y.device)], dim=1)
        lx, lp, lr = text_lens[:, None], prom_lens[:, None], resp_lens[:, None]
        ignore = torch.full_like(tgt, IGNORE)
        tgt = torch.where(pos == lx - 1, ignore, tgt)
        tgt = torch.where(pos == lx + lp + 1 + lr, torch.full_like(tgt, self.stop_token), tgt)
        tgt = torch.where(pos >= total[:, None], ignore, tgt)
        tgt = torch.where(pos == lx + lp + 1, ignore, tgt)  # the second sep
        valid = tgt != IGNORE
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, tgt, 0)[..., None])[..., 0]
        loss = (nll * valid).sum() / global_sum(valid.sum()).clamp(min=1)
        return {"loss": loss, "logits": logits, "total": total}

    def prefix_forward(self, text, text_lens, proms, prom_lens):
        """The ``[text | sep | prom | sep]`` prefix once, deterministic:
        (last-position logits [B, V] f32, prefix lengths [B], per-layer
        prefix k and v [B, Sp, H, Dh]). The residual stays f32 here, as in
        the JAX package."""
        b, tx = text.shape
        tp = proms.shape[1]
        prefix_len = text_lens + prom_lens + 2
        e_text = self.text_emb(text.long())
        e_prom = self._multi_embed(
            self.proms_emb.weight, proms, torch.full((b,), proms.shape[-1], device=text.device)
        )
        empty = e_text.new_zeros(b, 1, self.d_model)
        x, _ = pack_three(e_text, text_lens, e_prom, prom_lens, empty, torch.zeros_like(text_lens), self.sep)
        x = self.sin_emb(x[:, : tx + 1 + tp + 1])
        m = sequence_mask(prefix_len, x.shape[1], x.dtype)[..., None]
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        h = x
        for block in self.blocks:
            h, k, v = block.prefill(h, m)
            ks.append(k)
            vs.append(v)
        last_h = h[torch.arange(b, device=h.device), prefix_len - 1][:, None]
        last = self.classifier(last_h).float()[:, 0]
        return last, prefix_len, ks, vs

    def decode_one(self, tok, pos, slot: torch.Tensor, prefix_len, prefix_k, prefix_v, caches_k, caches_v):
        """One KV-cached step, deterministic, at a fixed shape: token [B] at
        absolute positions ``pos`` [B] (the sinusoid's), cache slot ``slot``
        (int64 [1] on the device, the same for every row) -> logits [B, V]
        f32. ``caches_k/v``: per layer [B, S_max, H, Dh], written in place."""
        e = self.resps_emb.weight[0][tok.long().clamp(0, self.n_resp_tokens - 1)]
        h = e[:, None] + self.sin_emb.table(pos)[:, None].to(e.dtype)
        sp = prefix_k[0].shape[1]
        pvalid = torch.arange(sp, device=tok.device)[None, :] < prefix_len[:, None]
        for i, block in enumerate(self.blocks):
            h = block.decode_step(h, prefix_k[i], prefix_v[i], caches_k[i], caches_v[i], slot, pvalid)
        return self.classifier(h)[:, 0].float()


def _pick(logits, sampling_temperature, generator, forced, index):
    """The code a row takes: ``forced[:, index]`` when teacher forcing, else
    one draw from ``softmax(logits / sampling_temperature)``."""
    if forced is not None:
        return forced.index_select(1, index)[:, 0].long()
    probs = torch.softmax(logits / sampling_temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def ar_start(
    model: VALLEAR, text, text_lens, proms, prom_lens, max_steps: int,
    sampling_temperature: float = 1.0, generator: Optional[torch.Generator] = None,
    forced: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The AR decode's first part: the prefix once, its last position's code
    drawn, and the decode state :func:`ar_step` advances in place: the prefix
    K/V, a ``[B, max(max_steps - 1, 1), H, Dh]`` decode cache a layer,
    ``codes`` [B, max_steps] (column 0 set), the current token, its
    positions, the cache slot (int64 [1]) and the rows that have stopped;
    ``last`` holds the prefix's logits. No host synchronisation: a CUDA graph
    captures it. The model must be in eval mode."""
    last, prefix_len, pk, pv = model.prefix_forward(text, text_lens, proms, prom_lens)
    b = text.shape[0]
    slot = torch.zeros(1, dtype=torch.long, device=text.device)
    tok = _pick(last, sampling_temperature, generator, forced, slot)
    codes = torch.zeros(b, max_steps, dtype=torch.long, device=text.device)
    codes[:, 0] = tok
    steps = max(max_steps - 1, 1)
    return {
        "prefix_len": prefix_len, "pk": pk, "pv": pv,
        "ck": [k.new_zeros(b, steps, *k.shape[2:]) for k in pk],
        "cv": [v.new_zeros(b, steps, *v.shape[2:]) for v in pv],
        "codes": codes, "tok": tok, "pos": prefix_len.clone(), "slot": slot,
        "stopped": torch.zeros(b, dtype=torch.bool, device=text.device), "last": last,
    }


@torch.no_grad()
def ar_step(
    model: VALLEAR, state: Dict[str, torch.Tensor], sampling_temperature: float = 1.0,
    generator: Optional[torch.Generator] = None, forced: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step on :func:`ar_start`'s state, in place: the current
    token at its positions through the cache slot, the next code drawn (the
    stop token again once a row has emitted it) and written to ``codes``,
    positions and slot advanced. Returns the step's logits [B, V]. The
    shapes never change, so one CUDA graph replays every step."""
    slot, tok = state["slot"], state["tok"]
    logits = model.decode_one(tok, state["pos"], slot, state["prefix_len"], state["pk"], state["pv"],
                              state["ck"], state["cv"])
    stop = model.stop_token
    state["stopped"] |= tok == stop
    nxt = torch.where(state["stopped"], torch.full_like(tok, stop),
                      _pick(logits, sampling_temperature, generator, forced, slot + 1))
    state["codes"].index_copy_(1, slot + 1, nxt[:, None])
    tok.copy_(nxt)
    state["pos"] += 1
    slot += 1
    return logits


def ar_finish(model: VALLEAR, codes: torch.Tensor) -> torch.Tensor:
    """``resp_lens`` [B] of the AR's codes: the first stop's index, else
    ``max_steps``."""
    is_stop = codes == model.stop_token
    return torch.where(
        is_stop.any(dim=1), is_stop.int().argmax(dim=1), torch.full_like(codes[:, 0], codes.shape[1])
    )


@torch.no_grad()
def ar_generate(
    model: VALLEAR,
    text, text_lens, proms, prom_lens,
    max_steps: int = 1000,
    sampling_temperature: float = 1.0,
    n_chunks: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    forced: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """KV-cached AR decode: :func:`ar_start` (the prefix once), then
    ``max_steps - 1`` :func:`ar_step` calls of one token, each attending the
    prefix cache and every slot up to its own of a preallocated
    ``[B, max_steps - 1, H, Dh]`` decode cache per layer, written at the
    batch-uniform slot. Tokens are drawn from
    ``softmax(logits / sampling_temperature)`` with ``generator``; once a
    row has emitted the stop token it keeps emitting it. Returns ``codes``
    [B, max_steps] and ``resp_lens`` [B] (the first stop's index, else
    ``max_steps``).

    ``forced`` [B, max_steps] replaces the draws (teacher forcing); the
    result then also holds ``logits`` [B, max_steps, V], the distribution
    each code was taken from. ``n_chunks`` (the JAX package's decode-cache
    chunking, a scan-carry layout that it pins as sampling-exact) is
    accepted and has no effect. Runs in eval mode; the mode is restored."""
    del n_chunks
    was_training = model.training
    model.eval()
    try:
        state = ar_start(model, text, text_lens, proms, prom_lens, max_steps, sampling_temperature, generator,
                         forced)
        all_logits = [state["last"]]
        for _ in range(max_steps - 1):
            all_logits.append(ar_step(model, state, sampling_temperature, generator, forced))
        codes = state["codes"]
        out = {"codes": codes, "resp_lens": ar_finish(model, codes)}
        if forced is not None:
            out["logits"] = torch.stack(all_logits, dim=1)
        return out
    finally:
        model.train(was_training)


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw from ``softmax(logits)`` over the last axis for every row of
    ``logits`` [..., V], from ``generator``; int64 [...]."""
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])


class VALLENAR(VALLEBase):
    """The non-autoregressive stage: non-causal blocks normalised by AdaLN
    over ``n_resp_levels`` levels, no stop token. ``noise_generator`` (set
    by the trainer, ``modules/noise.py``) draws the training levels."""

    causal = False
    use_stop_token = False
    norm_type = "adaln"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.noise_generator: Optional[torch.Generator] = None

    def forward(
        self, text, text_lens, proms, prom_lens, resps, resp_lens, quant_levels=None,
    ) -> Dict[str, torch.Tensor]:
        """Training: each sample predicts codec level ``q + 1`` from levels
        0..q, ``q = quant_levels[b]`` in [0, n_resp_levels) (drawn uniformly
        from ``noise_generator`` when not given). text [B, Tx]; proms
        [B, Tp, 8]; resps [B, Tr, 8], all levels. The loss is the mean NLL of
        the level-q+1 codes at the response positions, on f32 logits."""
        b = text.shape[0]
        tp = proms.shape[1]
        if quant_levels is None:
            quant_levels = draw(lambda s: torch.randint(0, self.n_resp_levels, s, generator=self.noise_generator,
                                                        device=text.device), (b,))
        quant_levels = quant_levels.long()
        logits, total = self.trunk(
            text, text_lens, proms, prom_lens, resps, resp_lens, quant_levels + 1, quant_levels,
        )
        targ = torch.gather(resps.long(), 2, (quant_levels + 1)[:, None, None].expand(b, resps.shape[1], 1))[..., 0]
        y = pack_ids(torch.full_like(text, IGNORE), text_lens, tp, prom_lens, targ, resp_lens)
        pos = torch.arange(y.shape[1], device=y.device)[None, :]
        y = torch.where(pos >= total[:, None], torch.full_like(y, IGNORE), y)
        valid = y != IGNORE
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, y, 0)[..., None])[..., 0]
        loss = (nll * valid).sum() / global_sum(valid.sum()).clamp(min=1)
        return {"loss": loss, "logits": logits}

    @torch.no_grad()
    def generate(
        self, text, text_lens, proms, prom_lens, level0, resp_lens,
        sampling_temperature: float = 0.2, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Fill levels 1..n_resp_levels from ``level0`` [B, Tr] one level
        after another (level q + 1 sees every code <= q): per level the
        trunk's hidden rows of the response region (gathered at
        ``clip(arange(Tr) + lx + lp + 2, 0, S - 1)``), the classifier on
        them, the logits zeroed past ``resp_lens`` (so padded rows draw from
        uniform logits, as the JAX package's do) and one draw a row from
        ``softmax(logits / sampling_temperature)`` with ``generator``.
        Returns int64 [B, Tr, n_resp_levels + 1]. Runs in eval mode; the mode
        is restored."""
        was_training = self.training
        self.eval()
        try:
            b, tr = level0.shape
            dev = level0.device
            codes = torch.zeros(b, tr, self.n_resp_levels + 1, dtype=torch.long, device=dev)
            codes[:, :, 0] = level0
            start = (text_lens + prom_lens + 2)[:, None]
            valid = (torch.arange(tr, device=dev)[None, :] < resp_lens[:, None])[..., None]
            for level in range(self.n_resp_levels):
                q = torch.full((b,), level, dtype=torch.long, device=dev)
                hidden, _ = self.trunk(text, text_lens, proms, prom_lens, codes, resp_lens, q + 1, q,
                                       return_hidden=True)
                pos = (torch.arange(tr, device=dev)[None, :] + start).clamp(0, hidden.shape[1] - 1)
                resp_h = torch.gather(hidden, 1, pos[..., None].expand(b, tr, hidden.shape[-1]))
                logits = (self.classifier(resp_h) * valid.to(resp_h.dtype)).float()
                codes[:, :, level + 1] = categorical(logits / sampling_temperature, generator)
            return codes
        finally:
            self.train(was_training)


def nar_generate(
    model: VALLENAR,
    text, text_lens, proms, prom_lens,
    level0: torch.Tensor,
    resp_lens: torch.Tensor,
    sampling_temperature: float = 0.2,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The NAR fill at a fixed capacity (pairs with :func:`ar_generate`):
    ``level0`` [B, Tr] straight from the AR carries the stop token
    (``n_tokens``, out of the NAR's table) at and past each row's stop, so
    it is clamped into the codebook and zeroed past ``resp_lens`` first.
    Returns [B, Tr, n_resp_levels + 1] codes."""
    tr = level0.shape[1]
    valid = torch.arange(tr, device=level0.device)[None, :] < resp_lens[:, None]
    level0 = torch.where(valid, level0.long().clamp(0, model.n_tokens - 1), 0)
    return model.generate(text, text_lens, proms, prom_lens, level0, resp_lens, sampling_temperature, generator)
