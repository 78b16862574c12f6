"""K1 — flash-attention forward (``csrc/flash_attn_fwd.cu``) and its plain twin.

Replaces the Pallas TPU flash-attention forward that
``jatts_tpu/modules/attention.py:_flash_attend`` drives. Function, per
(b, h): ``softmax((q·kᵀ + ab)·sm_scale)·v`` over the keys that
``key_mask`` marks valid, bias added before the scale, f32 accumulation.
A row with no valid key returns 0. Key-padding semantics: on valid query
rows this equals the TPU kernel (segment ids); on padded query rows it
equals the eager ``_attend`` instead, and the conformer discards those rows.

:func:`flash_attention` launches the CUDA kernel for CUDA tensors and takes
:func:`flash_attention_ref` only for CPU tensors. ``launches`` counts the
kernel launches (and nothing else) so a run can show that it went through
the kernel. See the source note in the ``.cu`` file for the bound.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from jatts_torch.ops import build

KERNEL = "flash_attn_fwd"
HEAD_DIMS = (64, 128, 192, 256)
DTYPES = (torch.float32, torch.bfloat16)
_MASK_VAL = -1e9

# kernel launches since the last reset_launches(); plain int, host side
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1, in f32, output in q's dtype.

    q: [B, H, Tq, D]; k, v: [B, H, Tk, D]; ab: [B, H, Tq, Tk] or None;
    key_mask: [B, Tk] bool (True = valid) or None."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if ab is not None:
        s = s + ab.float()
    s = s * sm_scale
    if key_mask is None:
        p = torch.softmax(s, dim=-1)
    else:
        m = key_mask[:, None, None, :]
        p = torch.softmax(s.masked_fill(~m, _MASK_VAL), dim=-1).masked_fill(~m, 0.0)
    return torch.matmul(p, v.float()).to(q.dtype)


def _kernel_fn():
    fn = build.load(KERNEL).jatts_flash_attn_fwd
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: without argtypes ctypes would
    # pass them as 32-bit ints and cut them
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
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
    synchronise."""
    _check(q, k, v, ab, key_mask)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    tensors = [t for t in (q, k, v, ab, key_mask) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_ref(q, k, v, ab, key_mask, sm_scale)
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

    out = torch.empty_like(q)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ab.data_ptr() if ab is not None else None,
            key_mask.data_ptr() if key_mask is not None else None,
            out.data_ptr(), b, h, tq, tk, d, int(q.dtype == torch.bfloat16),
            float(sm_scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error {rc}")
    global launches
    launches += 1
    return out
