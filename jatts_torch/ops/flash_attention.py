"""K1 — flash-attention forward (``csrc/flash_attn_fwd.cu``; its bf16
forms on the tensor cores in ``csrc/flash_attn_fwd_tc.cu``, its f32
non-causal forms in 3xTF32 in ``csrc/flash_attn_fwd_tc_f32.cu``), K1-bwd — its
backward (``csrc/flash_attn_bwd.cu``; K1b's bf16 dk/dv and dq at d 64 on the
tensor cores in ``csrc/flash_attn_bwd_tc.cu``, K1r's and K1-bwd's f32 dk/dv
and dq in 3xTF32 in ``csrc/flash_attn_bwd_tc_f32.cu``), K1b — the causal form
of both, K1r — the fused rel-pos form of both (d_qk != d_v), and their plain
twins.

Replaces the Pallas TPU flash-attention forward that
``jatts_tpu/modules/attention.py:_flash_attend`` drives. Function, per
(b, h): ``softmax((q·kᵀ + ab)·sm_scale)·v`` over the keys that
``key_mask`` marks valid, bias added before the scale, f32 accumulation.
A row with no valid key returns 0. Key-padding semantics: on valid query
rows this equals the TPU kernel (segment ids); on padded query rows it
equals the eager ``_attend`` instead, and the conformer discards those rows.

``causal=True`` (K1b, the Pallas kernel's ``causal`` form, driven by
VALL-E's AR trunk) needs Tq == Tk and lets query row i see key j only when
j <= i, AND-ed with the key mask. Every function here takes it; the kernels
take it as a compile-time form, so the non-causal ones are unchanged.

q and k share one width d_qk, v (and the output) may be narrower, d_v (K1r:
the fused "latest" rel-pos attention, ``modules/attention.py:
RelPositionMultiHeadedAttention``, concatenates positional features onto q
and k only). On the card that form takes the (d_qk, d_v) pairs of
``RELPOS_PAIRS``, no bias and no causal mask; its kernels are their own
instantiations, so K1, K1-bwd and K1b are unchanged. dq and dk have width
d_qk, dv width d_v.

:func:`flash_attention` launches the CUDA kernel for CUDA tensors and takes
:func:`flash_attention_ref` only for CPU tensors. When autograd needs a
gradient it goes through :class:`FlashAttention`, whose forward is K1 with
the row log-sum-exp and whose backward launches K1-bwd's two kernels (dk/dv,
then dq and d(ab)), as the JAX package's flash path trains through the
Pallas custom VJP. ``launches``, ``launches_bwd_dkv`` and ``launches_bwd_dq``
count the non-causal kernel launches at d_qk == d_v, the ``*_causal``
counters the causal ones and the ``*_relpos`` counters K1r's (and nothing
else), whichever kernel ran, so a run can show that it went through the
kernels. Which forward kernel a call takes is :func:`fwd_kernel`'s one
rule over (dtype, causal, d_qk, d_v): bf16 goes to the tensor-core kernel
(``launches_tc`` counts it, besides ``launches``, ``launches_causal`` or
``launches_relpos``), f32 non-causal at the (d_qk, d_v) of
``TC_F32_PAIRS`` to the 3xTF32 tensor-core kernel (``launches_tc_f32``),
every other form (f32 causal, d 256) to the scalar one. Which dk/dv and dq
kernels are :func:`dkv_kernel`'s and :func:`dq_kernel`'s, one rule over
(dtype, causal, d_qk, d_v, bias): VALL-E's forms (bf16, d 64, no bias;
causal for the AR, non-causal for the NAR) go to the tensor-core kernels
(``launches_bwd_dkv_tc`` and ``launches_bwd_dq_tc`` count the causal ones,
besides ``launches_bwd_dkv_causal`` and ``launches_bwd_dq_causal``;
``launches_bwd_dkv_tc_noncausal`` and ``launches_bwd_dq_tc_noncausal`` the
non-causal ones, besides ``launches_bwd_dkv`` and ``launches_bwd_dq``), the
f32 non-causal forms of ``BWD_TC_F32_FORMS``
(K1r's pairs without a bias, K1-bwd's d 192 with or without one) to the
3xTF32 tensor-core kernels (``launches_bwd_dkv_tc_f32`` and
``launches_bwd_dq_tc_f32``, besides the ``*_relpos`` counters or
``launches_bwd_dkv`` and ``launches_bwd_dq``), every other form to the
scalar ones. See the source notes in the ``.cu`` files for the bounds.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from jatts_torch.ops import build

KERNEL = "flash_attn_fwd"
KERNEL_BWD = "flash_attn_bwd"
KERNEL_TC = "flash_attn_fwd_tc"
KERNEL_TC_F32 = "flash_attn_fwd_tc_f32"
KERNEL_BWD_TC = "flash_attn_bwd_tc"
KERNEL_BWD_TC_F32 = "flash_attn_bwd_tc_f32"
HEAD_DIMS = (64, 128, 192, 256)
# K1r's (d_qk, d_v) = (d_k + n_feat, d_k): 2 heads of 64 (adim 128) and of
# 192 (adim 384, the JSUT/JVS width)
RELPOS_PAIRS = ((192, 64), (576, 192))
# the f32 non-causal (d_qk, d_v) forms of the 3xTF32 forward; d 256 (its 128
# output accumulators a thread) and the f32 causal form stay scalar
TC_F32_PAIRS = ((64, 64), (128, 128), (192, 192)) + RELPOS_PAIRS
# the f32 non-causal (d_qk, d_v, bias) forms of the 3xTF32 backward: K1r's
# pairs without a bias, K1-bwd's d 192 (the JSUT width) with or without one;
# f32 d 64/128/256 and causal stay scalar
BWD_TC_F32_FORMS = tuple((*pair, False) for pair in RELPOS_PAIRS) + ((192, 192, False), (192, 192, True))
DTYPES = (torch.float32, torch.bfloat16)
_MASK_VAL = -1e9

# kernel launches since the last reset_launches(); plain ints, host side
launches = 0  # K1 (forward)
launches_bwd_dkv = 0  # K1-bwd, dk/dv kernel
launches_bwd_dq = 0  # K1-bwd, dq/d(ab) kernel
launches_causal = 0  # K1b, causal forward
launches_bwd_dkv_causal = 0  # K1b, causal dk/dv kernel
launches_bwd_dq_causal = 0  # K1b, causal dq/d(ab) kernel
launches_relpos = 0  # K1r, d_qk != d_v forward
launches_tc = 0  # forwards (K1, K1b or K1r) that ran on the tensor-core kernel
launches_tc_f32 = 0  # f32 forwards (K1 or K1r) that ran on the 3xTF32 tensor-core kernel
launches_bwd_dkv_tc = 0  # causal dk/dv calls (K1b) that ran on the tensor-core kernel
launches_bwd_dq_tc = 0  # causal dq calls (K1b) that ran on the tensor-core kernel
launches_bwd_dkv_tc_noncausal = 0  # non-causal bf16 dk/dv calls that ran on the tensor-core kernel
launches_bwd_dq_tc_noncausal = 0  # non-causal bf16 dq calls that ran on the tensor-core kernel
launches_bwd_dkv_relpos = 0  # K1r, dk/dv kernel
launches_bwd_dq_relpos = 0  # K1r, dq kernel
launches_bwd_dkv_tc_f32 = 0  # dk/dv calls (K1r or K1-bwd f32) that ran on the 3xTF32 tensor-core kernel
launches_bwd_dq_tc_f32 = 0  # dq calls (K1r or K1-bwd f32) that ran on the 3xTF32 tensor-core kernel


def reset_launches() -> None:
    global launches, launches_bwd_dkv, launches_bwd_dq
    global launches_causal, launches_bwd_dkv_causal, launches_bwd_dq_causal
    global launches_relpos, launches_bwd_dkv_relpos, launches_bwd_dq_relpos, launches_tc
    global launches_bwd_dkv_tc, launches_bwd_dq_tc, launches_tc_f32
    global launches_bwd_dkv_tc_f32, launches_bwd_dq_tc_f32
    global launches_bwd_dkv_tc_noncausal, launches_bwd_dq_tc_noncausal
    launches = launches_bwd_dkv = launches_bwd_dq = launches_tc = launches_tc_f32 = 0
    launches_bwd_dkv_tc = launches_bwd_dq_tc = launches_bwd_dkv_tc_f32 = launches_bwd_dq_tc_f32 = 0
    launches_bwd_dkv_tc_noncausal = launches_bwd_dq_tc_noncausal = 0
    launches_causal = launches_bwd_dkv_causal = launches_bwd_dq_causal = 0
    launches_relpos = launches_bwd_dkv_relpos = launches_bwd_dq_relpos = 0


def _count(kind: str, causal: bool, relpos: bool) -> None:
    name = {"fwd": "launches", "dkv": "launches_bwd_dkv", "dq": "launches_bwd_dq"}[kind]
    name += "_causal" if causal else "_relpos" if relpos else ""
    globals()[name] += 1


def _seen(key_mask, tq: int, tk: int, causal: bool, device):
    """Which keys each query row sees, broadcastable to [B, H, Tq, Tk]:
    the key mask AND (causal) j <= i; None when every key is seen."""
    seen = None if key_mask is None else key_mask[:, None, None, :]
    if causal:
        tril = torch.ones(tq, tk, dtype=torch.bool, device=device).tril()[None, None]
        seen = tril if seen is None else seen & tril
    return seen


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
    causal: bool = False,
):
    """Plain PyTorch version of K1 (K1b with ``causal``, K1r when v is
    narrower than q and k), in f32, output in q's dtype.

    q: [B, H, Tq, D_qk]; k: [B, H, Tk, D_qk]; v: [B, H, Tk, D_v]; ab:
    [B, H, Tq, Tk] or None; key_mask: [B, Tk] bool (True = valid) or None;
    out: [B, H, Tq, D_v]; ``sm_scale`` defaults to D_qk ** -0.5. A row with
    no key it may see returns 0. With ``return_lse`` also the row
    log-sum-exp of the scaled scores over the keys it sees [B, H, Tq] f32,
    +inf on a row that sees none (what K1 writes for K1-bwd)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_causal(q, k, causal)
    s = _scores(q, k, ab, sm_scale)
    m = _seen(key_mask, q.shape[2], k.shape[2], causal, q.device)
    if m is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.softmax(s.masked_fill(~m, _MASK_VAL), dim=-1).masked_fill(~m, 0.0)
    out = torch.matmul(p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    if m is not None:
        s = s.masked_fill(~m, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return out, lse.masked_fill(torch.isneginf(lse), float("inf"))


def _scores(q, k, ab, sm_scale):
    """(q·kᵀ + ab)·sm_scale in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if ab is not None:
        s = s + ab.float()
    return s * sm_scale


def _check_causal(q, k, causal: bool) -> None:
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(f"causal attention needs Tq == Tk, got {q.shape[2]} and {k.shape[2]}")


def flash_attention_bwd_ref(q, k, v, ab, key_mask, sm_scale, o, lse, do, causal=False):
    """Plain PyTorch version of K1-bwd (K1b's backward with ``causal``,
    K1r's when v is narrower): the explicit f32 formulas, not autograd.
    Returns ``(dq, dk, dv, dab)`` in the inputs' dtypes (dq, dk of width
    D_qk, dv of width D_v), ``dab`` None when ``ab`` is None.

    p = exp(s - lse) on the keys a row sees (0 elsewhere), di = rowsum(o·do),
    dv = pᵀ·do, dp = do·vᵀ, ds = p·(dp - di)·sm_scale, dq = ds·k,
    dk = dsᵀ·q, d(ab) = ds (the bias is added before the scale)."""
    _check_causal(q, k, causal)
    s = _scores(q, k, ab, sm_scale)
    p = torch.exp(s - lse.float()[..., None])
    m = _seen(key_mask, q.shape[2], k.shape[2], causal, q.device)
    if m is not None:
        p = p.masked_fill(~m, 0.0)
    dof = do.float()
    di = (o.float() * dof).sum(-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - di[..., None]) * sm_scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dab = None if ab is None else ds.to(ab.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dab


def fwd_kernel(dtype: torch.dtype, causal: bool, d_qk: int, d_v: int) -> str:
    """The library a forward on the card takes: ``KERNEL_TC`` (tensor
    cores) for bf16, causal or not, at every (d_qk, d_v) the wrapper admits;
    ``KERNEL_TC_F32`` (tensor cores, 3xTF32) for f32 non-causal at the
    (d_qk, d_v) of ``TC_F32_PAIRS``; else ``KERNEL`` (scalar: f32 causal, f32
    at d 256)."""
    if dtype == torch.bfloat16:
        return KERNEL_TC
    return KERNEL_TC_F32 if not causal and (d_qk, d_v) in TC_F32_PAIRS else KERNEL


def _bwd_kernel(dtype: torch.dtype, causal: bool, d_qk: int, d_v: int, has_bias: bool) -> str:
    """The backward's one rule: VALL-E's forms (bf16, d_qk = d_v = 64, no
    bias, causal or not) -> ``KERNEL_BWD_TC``; f32 non-causal at a (d_qk,
    d_v, bias) of ``BWD_TC_F32_FORMS`` (K1r's, and K1-bwd's at d 192) ->
    ``KERNEL_BWD_TC_F32``; every other form (K1-bwd at d 64/128/256, bf16 at
    d != 64 or with a bias, the bf16 K1r backward, f32 causal) ->
    ``KERNEL_BWD``."""
    if dtype == torch.bfloat16 and d_qk == d_v == 64 and not has_bias:
        return KERNEL_BWD_TC
    if dtype == torch.float32 and not causal and (d_qk, d_v, has_bias) in BWD_TC_F32_FORMS:
        return KERNEL_BWD_TC_F32
    return KERNEL_BWD


def dkv_kernel(dtype: torch.dtype, causal: bool, d_qk: int, d_v: int, has_bias: bool) -> str:
    """The library a dk/dv backward on the card takes: ``KERNEL_BWD_TC``
    (tensor cores) for VALL-E's forms (bf16, d 64, no bias; the AR's causal
    one, ``launch_dkv<true>``, and the NAR's non-causal one,
    ``launch_dkv<false>``), ``KERNEL_BWD_TC_F32`` (tensor cores, 3xTF32) for
    the f32 forms of ``BWD_TC_F32_FORMS``, else ``KERNEL_BWD`` (scalar; the
    bf16 K1r form and K1-bwd's other forms stay there)."""
    return _bwd_kernel(dtype, causal, d_qk, d_v, has_bias)


def dq_kernel(dtype: torch.dtype, causal: bool, d_qk: int, d_v: int, has_bias: bool) -> str:
    """The library a dq backward on the card takes, by :func:`dkv_kernel`'s
    rule: ``KERNEL_BWD_TC`` for VALL-E's forms (``launch_dq<true>`` causal,
    ``launch_dq<false>`` not), ``KERNEL_BWD_TC_F32`` for the f32 forms of
    ``BWD_TC_F32_FORMS``, else ``KERNEL_BWD`` (scalar). With a bias, the
    scalar kernel and the 3xTF32 one also write d(ab)."""
    return _bwd_kernel(dtype, causal, d_qk, d_v, has_bias)


def _kernel_fn(name: str):
    symbol = {KERNEL_TC: "jatts_flash_attn_fwd_tc", KERNEL_TC_F32: "jatts_flash_attn_fwd_tc_f32"}
    fn = getattr(build.load(name), symbol.get(name, "jatts_flash_attn_fwd"))
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: without argtypes ctypes would
    # pass them as 32-bit ints and cut them
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _bwd_kernel_fn(lib: str, name: str):
    fn = getattr(build.load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _check(q, k, v, ab, key_mask, causal=False) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape[:3] != (b, h, tk):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    if ab is not None and ab.shape != (b, h, tq, tk):
        raise ValueError(f"ab {tuple(ab.shape)} is not [B, H, Tq, Tk] = {(b, h, tq, tk)}")
    if key_mask is not None and (key_mask.shape != (b, tk) or key_mask.dtype != torch.bool):
        raise ValueError(f"key_mask must be bool [B, Tk] = {(b, tk)}")
    _check_causal(q, k, causal)


def _check_card(q, k, v, ab, key_mask, causal=False) -> None:
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
    tk, d_v = k.shape[2], v.shape[3]
    if d == d_v and d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if d != d_v and (d, d_v) not in RELPOS_PAIRS:
        raise ValueError(f"flash_attention: (d_qk, d_v) = {(d, d_v)} not in {RELPOS_PAIRS}")
    if d != d_v and (ab is not None or causal):
        raise ValueError("flash_attention: d_qk != d_v takes no bias and no causal mask")
    if tq == 0 or tk == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: unsupported sizes B*H={b * h}, Tq={tq}, Tk={tk}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, ab, key_mask, sm_scale, with_lse: bool, causal: bool, _kernel=None):
    """K1 (K1b with ``causal``, K1r when d_qk != d_v) on checked card
    tensors, on the kernel :func:`fwd_kernel` picks -> (out, lse or None).
    ``_kernel`` names another library that takes the form (``KERNEL``, the
    scalar one, for a timing beside the kernel the rule picks)."""
    global launches_tc, launches_tc_f32
    b, h, tq, d = q.shape
    out = q.new_empty(b, h, tq, v.shape[3])
    lse = torch.empty(b, h, tq, device=q.device, dtype=torch.float32) if with_lse else None
    name = _kernel or fwd_kernel(q.dtype, causal, d, v.shape[3])
    fn = _kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ab), _ptr(key_mask),
            out.data_ptr(), _ptr(lse), b, h, tq, k.shape[2], d, v.shape[3],
            int(q.dtype == torch.bfloat16), int(causal), float(sm_scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    _count("fwd", causal, d != v.shape[3])
    launches_tc += name == KERNEL_TC
    launches_tc_f32 += name == KERNEL_TC_F32
    return out, lse


def flash_attention_fwd(q, k, v, ab=None, key_mask=None, sm_scale=None, causal=False):
    """K1 (K1b with ``causal``, K1r when d_qk != d_v) on CUDA tensors with
    the row log-sum-exp: ``(out, lse)``, lse [B, H, Tq] f32 (+inf on a row
    that sees no key), what ``flash_attention_ref(..., return_lse=True)``
    computes."""
    _check(q, k, v, ab, key_mask, causal)
    _check_card(q, k, v, ab, key_mask, causal)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _launch_fwd(q, k, v, ab, key_mask, sm_scale, with_lse=True, causal=causal)


def _check_bwd(q, k, v, ab, key_mask, lse, di, do, causal) -> None:
    _check(q, k, v, ab, key_mask, causal)
    _check_card(q, k, v, ab, key_mask, causal)
    b, h, tq, _ = q.shape
    if do.shape != (b, h, tq, v.shape[3]) or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: do must be [B, H, Tq, D_v] in q's dtype")
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, h, tq) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: {name} must be f32 {(b, h, tq)}")
    if any(t.device != q.device or not t.is_contiguous() for t in (lse, di, do)):
        raise ValueError("flash_attention_bwd: lse, di, do must be contiguous on q's device")


_BWD_SUFFIX = {KERNEL_BWD: "", KERNEL_BWD_TC: "_tc", KERNEL_BWD_TC_F32: "_tc_f32"}


def _launch_bwd(name, q, k, v, ab, key_mask, sm_scale, lse, di, do, out_a, out_b, causal, _lib=None):
    """K1-bwd's ``name`` ("dkv" or "dq") kernel on checked card tensors, on
    the library :func:`dkv_kernel` or :func:`dq_kernel` picks. ``_lib``
    names another library that takes the form (``KERNEL_BWD``, the scalar
    one, for a timing beside the kernel the rule picks)."""
    b, h, tq, d = q.shape
    rule = dkv_kernel if name == "dkv" else dq_kernel
    lib = _lib or rule(q.dtype, causal, d, v.shape[3], ab is not None)
    symbol = f"jatts_flash_attn_bwd_{name}" + _BWD_SUFFIX[lib]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_kernel_fn(lib, symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ab), _ptr(key_mask),
            lse.data_ptr(), di.data_ptr(), do.data_ptr(), out_a.data_ptr(), _ptr(out_b),
            b, h, tq, k.shape[2], d, v.shape[3], int(q.dtype == torch.bfloat16), int(causal),
            float(sm_scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{lib} {name} launch failed with CUDA error {rc}")
    _count(name, causal, d != v.shape[3])
    if lib != KERNEL_BWD:
        noncausal = "_noncausal" if lib == KERNEL_BWD_TC and not causal else ""
        globals()[f"launches_bwd_{name}{_BWD_SUFFIX[lib]}{noncausal}"] += 1


def flash_attention_bwd_dkv(q, k, v, ab, key_mask, sm_scale, lse, di, do, causal=False):
    """K1-bwd's dk/dv kernel (K1b's with ``causal``, K1r's when d_qk !=
    d_v) on CUDA tensors ->
    ``(dk, dv)``; ``di`` is rowsum(o·do) [B, H, Tq] f32."""
    _check_bwd(q, k, v, ab, key_mask, lse, di, do, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, ab, key_mask, sm_scale, lse, di, do, dk, dv, causal)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, ab, key_mask, sm_scale, lse, di, do, with_dab=True, causal=False):
    """K1-bwd's dq/d(ab) kernel (K1b's with ``causal``, K1r's dq when
    d_qk != d_v) on CUDA tensors ->
    ``(dq, dab)``; ``dab`` is written when ``ab`` is given and ``with_dab``,
    else None."""
    _check_bwd(q, k, v, ab, key_mask, lse, di, do, causal)
    dq = torch.empty_like(q)
    dab = torch.empty_like(ab) if ab is not None and with_dab else None
    _launch_bwd("dq", q, k, v, ab, key_mask, sm_scale, lse, di, do, dq, dab, causal)
    return dq, dab


def flash_attention_bwd(q, k, v, ab, key_mask, sm_scale, o, lse, do, with_dab=True, causal=False):
    """K1-bwd (K1b's backward with ``causal``, K1r's when d_qk != d_v) on
    CUDA tensors:
    ``(dq, dk, dv, dab)`` as :func:`flash_attention_bwd_ref` computes them
    (``dab`` None without a bias or without ``with_dab``).
    ``di = rowsum(o·do)`` is a PyTorch op, as in the JAX VJP; then the dk/dv
    kernel and the dq/d(ab) kernel launch on the current stream."""
    if o.shape != do.shape or o.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o must be like do, in q's dtype")
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, ab, key_mask, sm_scale, lse, di, do, causal)
    dq, dab = flash_attention_bwd_dq(q, k, v, ab, key_mask, sm_scale, lse, di, do, with_dab, causal)
    return dq, dk, dv, dab


class FlashAttention(torch.autograd.Function):
    """K1 forward (with the row log-sum-exp) and K1-bwd backward on CUDA
    tensors, K1b's with ``causal``, K1r's when d_qk != d_v. Gradients flow
    to q, k, v and ab; the mask, the scale and the form take none."""

    @staticmethod
    def forward(ctx, q, k, v, ab, key_mask, sm_scale, causal=False):
        out, lse = _launch_fwd(q, k, v, ab, key_mask, sm_scale, with_lse=True, causal=causal)
        ctx.save_for_backward(q, k, v, ab, key_mask, out, lse)
        ctx.sm_scale = sm_scale
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, ab, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dab = flash_attention_bwd(
            q, k, v, ab, key_mask, ctx.sm_scale, out, lse, dout.contiguous(),
            with_dab=ctx.needs_input_grad[3], causal=ctx.causal,
        )
        return dq, dk, dv, dab, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ab: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """K1 (K1b with ``causal``, K1r when d_qk != d_v) on CUDA tensors,
    :func:`flash_attention_ref` on CPU tensors.

    On the card it takes contiguous q/k/v (and ab) of one dtype, f32 or
    bf16, head dim in ``HEAD_DIMS`` (or (d_qk, d_v) in ``RELPOS_PAIRS``,
    without bias or causal mask), all on one device, and raises on anything
    else; it launches on the current stream and does not
    synchronise. When autograd records (grad mode on and an input that
    requires grad) it goes through :class:`FlashAttention`, so the backward
    is K1-bwd."""
    _check(q, k, v, ab, key_mask, causal)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    tensors = [t for t in (q, k, v, ab, key_mask) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_ref(q, k, v, ab, key_mask, sm_scale, causal=causal)
    _check_card(q, k, v, ab, key_mask, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return FlashAttention.apply(q, k, v, ab, key_mask, float(sm_scale), bool(causal))
    return _launch_fwd(q, k, v, ab, key_mask, sm_scale, with_lse=False, causal=causal)[0]
