"""K1 — flash-attention forward (``csrc/flash_attn_fwd.cu``), K1-bwd — its
backward (``csrc/flash_attn_bwd.cu``), and their plain twins.

Replaces the Pallas TPU flash-attention forward that
``jatts_tpu/modules/attention.py:_flash_attend`` drives. Function, per
(b, h): ``softmax((q·kᵀ + ab)·sm_scale)·v`` over the keys that
``key_mask`` marks valid, bias added before the scale, f32 accumulation.
A row with no valid key returns 0. Key-padding semantics: on valid query
rows this equals the TPU kernel (segment ids); on padded query rows it
equals the eager ``_attend`` instead, and the conformer discards those rows.

:func:`flash_attention` launches the CUDA kernel for CUDA tensors and takes
:func:`flash_attention_ref` only for CPU tensors. When autograd needs a
gradient it goes through :class:`FlashAttention`, whose forward is K1 with
the row log-sum-exp and whose backward launches K1-bwd's two kernels (dk/dv,
then dq and d(ab)), as the JAX package's flash path trains through the
Pallas custom VJP. ``launches``, ``launches_bwd_dkv`` and ``launches_bwd_dq``
count the kernel launches (and nothing else) so a run can show that it went
through the kernels. See the source notes in the ``.cu`` files for the bounds.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from jatts_torch.ops import build

KERNEL = "flash_attn_fwd"
KERNEL_BWD = "flash_attn_bwd"
HEAD_DIMS = (64, 128, 192, 256)
DTYPES = (torch.float32, torch.bfloat16)
_MASK_VAL = -1e9

# kernel launches since the last reset_launches(); plain ints, host side
launches = 0  # K1 (forward)
launches_bwd_dkv = 0  # K1-bwd, dk/dv kernel
launches_bwd_dq = 0  # K1-bwd, dq/d(ab) kernel


def reset_launches() -> None:
    global launches, launches_bwd_dkv, launches_bwd_dq
    launches = launches_bwd_dkv = launches_bwd_dq = 0


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain PyTorch version of K1, in f32, output in q's dtype.

    q: [B, H, Tq, D]; k, v: [B, H, Tk, D]; ab: [B, H, Tq, Tk] or None;
    key_mask: [B, Tk] bool (True = valid) or None. With ``return_lse`` also
    the row log-sum-exp of the scaled scores over the valid keys [B, H, Tq]
    f32, +inf on a row with no valid key (what K1 writes for K1-bwd)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _scores(q, k, ab, sm_scale)
    if key_mask is None:
        p = torch.softmax(s, dim=-1)
    else:
        m = key_mask[:, None, None, :]
        p = torch.softmax(s.masked_fill(~m, _MASK_VAL), dim=-1).masked_fill(~m, 0.0)
    out = torch.matmul(p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return out, lse.masked_fill(torch.isneginf(lse), float("inf"))


def _scores(q, k, ab, sm_scale):
    """(q·kᵀ + ab)·sm_scale in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if ab is not None:
        s = s + ab.float()
    return s * sm_scale


def flash_attention_bwd_ref(q, k, v, ab, key_mask, sm_scale, o, lse, do):
    """Plain PyTorch version of K1-bwd: the explicit f32 formulas, not
    autograd. Returns ``(dq, dk, dv, dab)`` in the inputs' dtypes, ``dab``
    None when ``ab`` is None.

    p = exp(s - lse) on valid keys (0 elsewhere), di = rowsum(o·do),
    dv = pᵀ·do, dp = do·vᵀ, ds = p·(dp - di)·sm_scale, dq = ds·k,
    dk = dsᵀ·q, d(ab) = ds (the bias is added before the scale)."""
    s = _scores(q, k, ab, sm_scale)
    p = torch.exp(s - lse.float()[..., None])
    if key_mask is not None:
        p = p.masked_fill(~key_mask[:, None, None, :], 0.0)
    dof = do.float()
    di = (o.float() * dof).sum(-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - di[..., None]) * sm_scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dab = None if ab is None else ds.to(ab.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dab


def _kernel_fn():
    fn = build.load(KERNEL).jatts_flash_attn_fwd
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: without argtypes ctypes would
    # pass them as 32-bit ints and cut them
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _bwd_kernel_fn(name: str):
    fn = getattr(build.load(KERNEL_BWD), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _check(q, k, v, ab, key_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != (b, h, tk, d):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    if ab is not None and ab.shape != (b, h, tq, tk):
        raise ValueError(f"ab {tuple(ab.shape)} is not [B, H, Tq, Tk] = {(b, h, tq, tk)}")
    if key_mask is not None and (key_mask.shape != (b, tk) or key_mask.dtype != torch.bool):
        raise ValueError(f"key_mask must be bool [B, Tk] = {(b, tk)}")


def _check_card(q, k, v, ab, key_mask) -> None:
    """What the kernels take on the card; raises on anything else."""
    tensors = [t for t in (q, k, v, ab, key_mask) if t is not None]
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("flash_attention: all inputs must be on one CUDA device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v)) or (
        ab is not None and ab.dtype != q.dtype
    ):
        raise TypeError(f"flash_attention: q, k, v, ab must share one dtype of {DTYPES}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: inputs must be contiguous")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if tq == 0 or tk == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: unsupported sizes B*H={b * h}, Tq={tq}, Tk={tk}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, ab, key_mask, sm_scale, with_lse: bool):
    """K1 on checked card tensors -> (out, lse or None)."""
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, device=q.device, dtype=torch.float32) if with_lse else None
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ab), _ptr(key_mask),
            out.data_ptr(), _ptr(lse), b, h, tq, k.shape[2], d,
            int(q.dtype == torch.bfloat16), float(sm_scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error {rc}")
    global launches
    launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, ab=None, key_mask=None, sm_scale=None):
    """K1 on CUDA tensors with the row log-sum-exp: ``(out, lse)``, lse
    [B, H, Tq] f32 (+inf on a row with no valid key), what
    ``flash_attention_ref(..., return_lse=True)`` computes."""
    _check(q, k, v, ab, key_mask)
    _check_card(q, k, v, ab, key_mask)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _launch_fwd(q, k, v, ab, key_mask, sm_scale, with_lse=True)


def _check_bwd(q, k, v, ab, key_mask, lse, di, do) -> None:
    _check(q, k, v, ab, key_mask)
    _check_card(q, k, v, ab, key_mask)
    b, h, tq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: do must be like q")
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, h, tq) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: {name} must be f32 {(b, h, tq)}")
    if any(t.device != q.device or not t.is_contiguous() for t in (lse, di, do)):
        raise ValueError("flash_attention_bwd: lse, di, do must be contiguous on q's device")


def _launch_bwd(name, q, k, v, ab, key_mask, sm_scale, lse, di, do, out_a, out_b):
    b, h, tq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_kernel_fn(f"jatts_flash_attn_bwd_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ab), _ptr(key_mask),
            lse.data_ptr(), di.data_ptr(), do.data_ptr(), out_a.data_ptr(), _ptr(out_b),
            b, h, tq, k.shape[2], d, int(q.dtype == torch.bfloat16), float(sm_scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd {name} launch failed with CUDA error {rc}")


def flash_attention_bwd_dkv(q, k, v, ab, key_mask, sm_scale, lse, di, do):
    """K1-bwd's dk/dv kernel on CUDA tensors -> ``(dk, dv)``; ``di`` is
    rowsum(o·do) [B, H, Tq] f32."""
    _check_bwd(q, k, v, ab, key_mask, lse, di, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, ab, key_mask, sm_scale, lse, di, do, dk, dv)
    global launches_bwd_dkv
    launches_bwd_dkv += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, ab, key_mask, sm_scale, lse, di, do, with_dab=True):
    """K1-bwd's dq/d(ab) kernel on CUDA tensors -> ``(dq, dab)``; ``dab`` is
    written when ``ab`` is given and ``with_dab``, else None."""
    _check_bwd(q, k, v, ab, key_mask, lse, di, do)
    dq = torch.empty_like(q)
    dab = torch.empty_like(ab) if ab is not None and with_dab else None
    _launch_bwd("dq", q, k, v, ab, key_mask, sm_scale, lse, di, do, dq, dab)
    global launches_bwd_dq
    launches_bwd_dq += 1
    return dq, dab


def flash_attention_bwd(q, k, v, ab, key_mask, sm_scale, o, lse, do, with_dab=True):
    """K1-bwd on CUDA tensors: ``(dq, dk, dv, dab)`` as
    :func:`flash_attention_bwd_ref` computes them (``dab`` None without a
    bias or without ``with_dab``). ``di = rowsum(o·do)`` is a PyTorch op, as
    in the JAX VJP; then the dk/dv kernel and the dq/d(ab) kernel launch on
    the current stream."""
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o must be like q")
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, ab, key_mask, sm_scale, lse, di, do)
    dq, dab = flash_attention_bwd_dq(q, k, v, ab, key_mask, sm_scale, lse, di, do, with_dab)
    return dq, dk, dv, dab


class FlashAttention(torch.autograd.Function):
    """K1 forward (with the row log-sum-exp) and K1-bwd backward on CUDA
    tensors. Gradients flow to q, k, v and ab; the mask and the scale take
    none."""

    @staticmethod
    def forward(ctx, q, k, v, ab, key_mask, sm_scale):
        out, lse = _launch_fwd(q, k, v, ab, key_mask, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, ab, key_mask, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, ab, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dab = flash_attention_bwd(
            q, k, v, ab, key_mask, ctx.sm_scale, out, lse, dout.contiguous(),
            with_dab=ctx.needs_input_grad[3],
        )
        return dq, dk, dv, dab, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """K1 on CUDA tensors, :func:`flash_attention_ref` on CPU tensors.

    On the card it takes contiguous q/k/v (and ab) of one dtype, f32 or
    bf16, head dim in ``HEAD_DIMS``, all on one device, and raises on
    anything else; it launches on the current stream and does not
    synchronise. When autograd records (grad mode on and an input that
    requires grad) it goes through :class:`FlashAttention`, so the backward
    is K1-bwd."""
    _check(q, k, v, ab, key_mask)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    tensors = [t for t in (q, k, v, ab, key_mask) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_ref(q, k, v, ab, key_mask, sm_scale)
    _check_card(q, k, v, ab, key_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return FlashAttention.apply(q, k, v, ab, key_mask, float(sm_scale))
    return _launch_fwd(q, k, v, ab, key_mask, sm_scale, with_lse=False)[0]
