"""Alignment losses: forward-sum (CTC) with a beta-binomial prior, bin loss
(counterpart of jatts_tpu/losses/align.py).

Both are batched tensor code with autograd. The prior is computed with
``torch.lgamma`` on the device; the CTC forward recursion is one Python loop
over frames for the whole batch (a ``lax.scan`` in the JAX package, no
kernel there either).

Because the CTC "vocabulary" is the text-position sequence 1..N (strictly
monotone, all labels distinct), the standard 3-way CTC transition rule
applies without same-label exclusions.
"""

from __future__ import annotations

import math

import torch

from jatts_torch.ops.masks import sequence_mask
from jatts_torch.parallel.mesh import global_sum

_NEG = -1e9  # -inf stand-in: keeps every sum and gradient finite


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def beta_binomial_prior(
    text_lengths: torch.Tensor,
    feats_lengths: torch.Tensor,
    t_text: int,
    t_feats: int,
    w: float = 1.0,
) -> torch.Tensor:
    """Batched beta-binomial alignment prior ``[B, T_feats, T_text]``.

    prior[b, t, k] = BetaBinom(k; n=N_b, a=w*(t+1), b=w*(T_b-t)) in log space,
    valid on t < T_b, k < N_b; ``-1e9`` elsewhere.
    """
    dev = text_lengths.device
    n = text_lengths.float()[:, None, None]
    tt = feats_lengths.float()[:, None, None]
    t = torch.arange(t_feats, dtype=torch.float32, device=dev)[None, :, None] + 1.0  # 1-indexed
    k = torch.arange(t_text, dtype=torch.float32, device=dev)[None, None, :]
    a = (w * t).expand(-1, -1, t_text)
    b = w * (tt - t + 1.0)
    # guard invalid regions before lgamma (negative arguments)
    valid = (t <= tt) & (k < n)
    one = torch.ones((), device=dev)
    a_ = torch.where(valid, a, one)
    b_ = torch.where(valid, b.clamp(min=1e-3), one)
    k_ = torch.where(valid, k, torch.zeros((), device=dev))
    logpmf = (
        torch.lgamma(n + 1.0)
        - torch.lgamma(k_ + 1.0)
        - torch.lgamma(n - k_ + 1.0)
        + _betaln(k_ + a_, n - k_ + b_)
        - _betaln(a_, b_)
    )
    return torch.where(valid, logpmf, torch.full((), _NEG, device=dev))


def ctc_forward_sum(
    log_probs: torch.Tensor,
    text_lengths: torch.Tensor,
    feats_lengths: torch.Tensor,
) -> torch.Tensor:
    """Batched CTC forward NLL for the monotone target sequence 1..N.

    Args:
        log_probs: ``[B, T_feats, T_text+1]``; column 0 is the blank symbol.
        text_lengths / feats_lengths: ``[B]``.

    Returns:
        ``[B]`` negative log likelihoods (not normalized by target length).
    """
    bsz, t_feats, _ = log_probs.shape
    t_text = log_probs.shape[2] - 1
    s_max = 2 * t_text + 1
    dev = log_probs.device
    text_lengths = text_lengths.to(torch.int64)

    # state s -> log prob column: even s = blank(0), odd s = token (s-1)/2 + 1
    s = torch.arange(s_max, device=dev)
    odd = (s % 2 == 1)[None, :]
    col = torch.where(s % 2 == 0, torch.zeros_like(s), (s - 1) // 2 + 1)
    lp_states = log_probs[:, :, col]  # [B, T_feats, S]

    # states beyond 2*N are invalid per utterance
    state_valid = s[None, :] < (2 * text_lengths[:, None] + 1)
    lp_states = lp_states.masked_fill(~state_valid[:, None, :], _NEG)

    alpha = torch.cat(
        [lp_states[:, 0, :2], lp_states.new_full((bsz, s_max - 2), _NEG)], dim=1
    )
    frame_valid = sequence_mask(feats_lengths, t_feats)
    neg = lp_states.new_full((), _NEG)
    # one view a frame from one op each, and few ops a frame below: the loop
    # is bound by its launches, not by its arithmetic
    lp_frames = lp_states.unbind(1)
    valid_frames = frame_valid[:, :, None].unbind(1)
    for t in range(1, t_feats):
        padded = torch.nn.functional.pad(alpha, (2, 0), value=_NEG)
        # the skip (s-2) transition goes only into label states (odd s)
        shift2 = torch.where(odd, padded[:, :-2], neg)
        stay_step_skip = torch.stack([alpha, padded[:, 1:-1], shift2])
        new = (torch.logsumexp(stay_step_skip, dim=0) + lp_frames[t]).clamp(min=_NEG)
        # padded frames leave alpha as it was
        alpha = torch.where(valid_frames[t], new, alpha)

    # final blank state 2N and final label state 2N-1; -1 (N = 0) wraps to
    # the last state, as numpy indexing does
    a1 = alpha.gather(1, (2 * text_lengths)[:, None])[:, 0]
    a2 = alpha.gather(1, ((2 * text_lengths - 1) % s_max)[:, None])[:, 0]
    return -torch.logaddexp(a1, a2)


class ForwardSumLoss:
    """CTC forward-sum loss over ``log_p_attn + prior`` with a constant blank."""

    def __call__(self, log_p_attn, ilens, olens, blank_prob: float = math.e ** -1):
        bsz, t_feats, t_text = log_p_attn.shape
        prior = beta_binomial_prior(ilens, olens, t_text, t_feats)
        lp = log_p_attn + prior
        blank = lp.new_full((bsz, t_feats, 1), math.log(blank_prob))
        nll = ctc_forward_sum(torch.cat([blank, lp], dim=-1), ilens, olens)
        # zero-length rows (batch padding with zeroed lengths) must be
        # exactly inert: excluded from numerator AND denominator.
        # Infeasible alignments (olens < ilens) are zeroed but stay in the
        # denominator (the zero_infinity=True rule of torch's ctc_loss), so
        # one over-cropped utterance cannot explode the loss.
        nonpad = (ilens > 0) & (olens > 0)
        feasible = olens >= ilens
        nll = torch.where(nonpad & feasible, nll, torch.zeros_like(nll))
        # ctc_loss(reduction='mean') divides by the target length
        per = nll / ilens.to(nll.dtype).clamp(min=1.0)
        return per.sum() / global_sum(nonpad.sum()).clamp(min=1).to(per.dtype)


class BinLoss:
    """Binarization loss: computed inside ops.mas.viterbi_decode; kept for
    registry parity."""

    def __call__(self, *args, **kwargs):
        return None
