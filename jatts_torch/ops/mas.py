"""Monotonic Alignment Search: the fused search (``csrc/mas_path.cu``), K2
and K3 (``csrc/mas_viterbi.cu``), their plain twins, the backend selector
and ``viterbi_decode``.

Counterpart of ``jatts_tpu/ops/mas.py`` and ``jatts_tpu/ops/mas_pallas.py``.
The whole batch's Viterbi search over the alignment lattice runs on the
device, with no host round trip:

* K2, :func:`mas_decisions`: the forward DP over frames. It emits only the
  decision bits ``d[j, i] = (Q[j-1, i-1] >= Q[j-1, i])`` (the diagonal wins
  a tie), packed 32 tokens to an int32 word.
* K3, :func:`mas_backtrace`: walks those bits backward into the int32 path.
* The fused search, :func:`mas_path_fused`: K2's forward and K3's
  backtrace in one launch, the bits kept in shared memory between them
  (or, when they do not fit, in a device-memory scratch staged back). The
  backends ``auto`` and ``cuda`` send CUDA tensors here;
  :func:`mas_path_cuda` keeps the K2 then K3 pair.

Each kernel is a ``torch.library`` op (``jatts::mas_decisions``,
``jatts::mas_backtrace``, ``jatts::mas_path``), registered at import and
built at its first launch: the CUDA implementation launches, the CPU one is
the plain twin, the fake checks what the card takes, so the search can be
traced. On CUDA tensors each wrapper launches its kernel, counts the launch
(``fwd_launches``, ``backtrace_launches``, ``path_launches`` and the fused
search's storage route in ``path_routes``) and raises on what the kernel
does not take; it takes its plain twin only for CPU tensors. The twins
(:func:`mas_decisions_ref`, :func:`mas_backtrace_ref`, and the whole search
with the Q lattice kept, :func:`mas_path_ref`) are Python loops over
frames.

Masked tokens carry ``-1e9`` and not ``-inf``: sums of it stay finite in
f32 (about -1e12 after a thousand frames), so no NaN can arise.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from jatts_torch.ops import build
from jatts_torch.ops.masks import sequence_mask
from jatts_torch.parallel.mesh import global_mean

KERNEL = "mas_viterbi"
KERNEL_PATH = "mas_path"
MAX_T_TEXT = 1024  # one block per utterance, at most 32 words of bits a frame
# decision bits the fused search keeps in shared memory (T_feats x
# ceil(T_text / 32) words); more go through a device-memory scratch
SMEM_BITS_BYTES = 163840
# the most dynamic shared memory a block may ask for, less the largest
# mbarriers, lp ring and halo exchange of a block (csrc/mas_path.cu)
MAX_SMEM_BITS_BYTES = 232448 - 65600
_NEG = -1e9

# kernel launches since the last reset_launches(); plain ints, host side
fwd_launches = 0
backtrace_launches = 0
path_launches = 0
path_routes = {"smem": 0, "global": 0}  # the fused search's launches by where its bits lay


def reset_launches() -> None:
    global fwd_launches, backtrace_launches, path_launches
    fwd_launches = 0
    backtrace_launches = 0
    path_launches = 0
    path_routes["smem"] = path_routes["global"] = 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _masked_lattice(log_p_attn: torch.Tensor, text_lengths: torch.Tensor) -> torch.Tensor:
    lp = log_p_attn.float()
    tok_valid = sequence_mask(text_lengths, lp.shape[2])
    return torch.where(tok_valid[:, None, :], lp, lp.new_tensor(_NEG))


def _q_lattice(lp: torch.Tensor) -> torch.Tensor:
    """``Q [B, T_feats, T_text]`` of a masked lattice, in the kernel's order
    of operations: ``max(shifted, prev) + row``."""
    b, t_feats, t_text = lp.shape
    q_all = lp.new_empty(b, t_feats, t_text)
    q = lp.new_full((b, t_text), _NEG)
    q[:, 0] = lp[:, 0, 0]  # frame 0 reaches token 0 only
    q_all[:, 0] = q
    neg_col = lp.new_full((b, 1), _NEG)
    for j in range(1, t_feats):
        shifted = torch.cat([neg_col, q[:, :-1]], dim=1)
        q = torch.maximum(shifted, q) + lp[:, j]
        q_all[:, j] = q
    return q_all


def mas_decisions_ref(log_p_attn: torch.Tensor, text_lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: decision bits, unpacked, bool ``[B, T_feats, T_text]``."""
    prev = _q_lattice(_masked_lattice(log_p_attn, text_lengths))[:, :-1]
    shifted = torch.nn.functional.pad(prev[:, :, :-1], (1, 0), value=_NEG)
    return torch.nn.functional.pad(shifted >= prev, (0, 0, 1, 0))  # d[0] = 0


def mas_backtrace_ref(
    decisions: torch.Tensor, text_lengths: torch.Tensor, feats_lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3: int32 path ``[B, T_feats]`` from unpacked bits."""
    b, t_feats, _ = decisions.shape
    last_tok = text_lengths.to(torch.int64) - 1
    pin_from = feats_lengths.to(torch.int64) - 1
    path = torch.empty(b, t_feats, dtype=torch.int64, device=decisions.device)
    a = last_tok
    path[:, t_feats - 1] = a
    for j in range(t_feats - 2, -1, -1):
        # a = -1 (a row with no token) reads as a 0 bit and never indexes
        bit = decisions[:, j + 1].gather(1, a.clamp(min=0)[:, None])[:, 0] & (a >= 0)
        a = torch.where(j >= pin_from, last_tok, (a - bit.to(torch.int64)).clamp(min=0))
        path[:, j] = a
    return path.to(torch.int32)


def mas_path_ref(
    log_p_attn: torch.Tensor, text_lengths: torch.Tensor, feats_lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version of the whole search, keeping the Q lattice and
    comparing its cells in the backtrace. ``[B, T_feats]`` int32; frames
    ``>= feats_length`` clamp to ``text_length - 1``."""
    lp = _masked_lattice(log_p_attn, text_lengths)
    b, t_feats, t_text = lp.shape
    q_all = _q_lattice(lp)

    last_tok = text_lengths.to(torch.int64) - 1
    last_frame = feats_lengths.to(torch.int64) - 1
    path = torch.empty(b, t_feats, dtype=torch.int64, device=lp.device)
    a = last_tok
    path[:, t_feats - 1] = a
    for j in range(t_feats - 2, -1, -1):
        i_b = a
        i_a = (i_b - 1).clamp(min=0)
        q_j = q_all[:, j]
        q_ia = q_j.gather(1, i_a[:, None])[:, 0]
        q_ib = q_j.gather(1, (i_b % t_text)[:, None])[:, 0]  # -1 wraps, as numpy indexing does
        a = torch.where(i_b == 0, torch.zeros_like(a), torch.where(q_ia >= q_ib, i_a, i_b))
        a = torch.where(j >= last_frame, last_tok, a)
        path[:, j] = a
    frame_valid = sequence_mask(feats_lengths, t_feats)
    return torch.where(frame_valid, path, last_tok[:, None]).to(torch.int32)


# --------------------------------------------------------------------------
# packed bits
# --------------------------------------------------------------------------

def pack_bits(decisions: torch.Tensor) -> torch.Tensor:
    """bool ``[..., T_text]`` -> int32 ``[..., ceil(T_text / 32)]``, bit
    ``i & 31`` of word ``i >> 5`` for token i: K2's output layout."""
    t_text = decisions.shape[-1]
    n_words = (t_text + 31) // 32
    pad = n_words * 32 - t_text
    d = torch.nn.functional.pad(decisions.to(torch.int64), (0, pad))
    d = d.reshape(*decisions.shape[:-1], n_words, 32)
    weights = torch.ones(32, dtype=torch.int64, device=d.device) << torch.arange(32, device=d.device)
    words = (d * weights).sum(-1)
    # two's complement: bit 31 set means a negative int32
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(bits: torch.Tensor, t_text: int) -> torch.Tensor:
    """The inverse of :func:`pack_bits`: bool ``[..., t_text]``."""
    shifts = torch.arange(32, device=bits.device)
    d = (bits.to(torch.int64)[..., None] >> shifts) & 1
    return d.reshape(*bits.shape[:-1], -1)[..., :t_text].bool()


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _kernel_fns():
    lib = build.load(KERNEL)
    fwd, bwd = lib.jatts_mas_fwd, lib.jatts_mas_backtrace
    # pointers and the stream as c_void_p: without argtypes ctypes would
    # pass them as 32-bit ints and cut them
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fwd, bwd


def _path_fn():
    fn = build.load(KERNEL_PATH).jatts_mas_path
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _check_lengths(name: str, lengths: torch.Tensor, b: int) -> None:
    if lengths.shape != (b,) or lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise ValueError(f"{name} must be an integer tensor of shape [{b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU; raises unless they share one
    CPU or CUDA device."""
    first = tensors[0].device
    if any(t.device != first for t in tensors) or first.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: all inputs must be on one CPU or CUDA device")
    return first.type == "cpu"


def _lengths_i32(lengths: torch.Tensor) -> torch.Tensor:
    return lengths.to(torch.int32).contiguous()


def _launch(fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {rc}")


def _check_card_lattice(name: str, log_p_attn: torch.Tensor) -> None:
    """What K2 and the fused search take on the card; raises on anything else."""
    _, t_feats, t_text = log_p_attn.shape
    if log_p_attn.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: log_p_attn must be f32 or bf16, got {log_p_attn.dtype}")
    if not log_p_attn.is_contiguous():
        raise ValueError(f"{name}: log_p_attn must be contiguous")
    _check_sizes(name, t_feats, t_text)


def _check_sizes(name: str, t_feats: int, t_text: int) -> None:
    if t_feats < 1 or not 1 <= t_text <= MAX_T_TEXT:
        raise ValueError(f"{name}: unsupported sizes T_feats={t_feats}, T_text={t_text} "
                         f"(T_text <= {MAX_T_TEXT})")


def _check_path_args(log_p_attn, smem_bits_bytes: int) -> str:
    """The fused search's card checks -> its storage route."""
    _check_card_lattice("mas_path_fused", log_p_attn)
    _, t_feats, t_text = log_p_attn.shape
    n_words = (t_text + 31) // 32
    if not n_words * 4 <= smem_bits_bytes <= MAX_SMEM_BITS_BYTES:
        raise ValueError(f"mas_path_fused: smem_bits_bytes={smem_bits_bytes} must hold a frame's "
                         f"{n_words * 4} bytes and be at most {MAX_SMEM_BITS_BYTES}")
    return "smem" if t_feats * n_words * 4 <= smem_bits_bytes else "global"


# --------------------------------------------------------------------------
# the ops: ``jatts::mas_decisions`` (K2), ``jatts::mas_backtrace`` (K3) and
# ``jatts::mas_path`` (the fused search), registered at import; the CUDA
# implementation launches and counts, the CPU one is the plain version, the
# fake checks what the card takes for CUDA tensors
# --------------------------------------------------------------------------

@torch.library.custom_op("jatts::mas_decisions", mutates_args=(), device_types="cpu")
def _decisions_op(log_p_attn: torch.Tensor, text_lengths: torch.Tensor) -> torch.Tensor:
    return pack_bits(mas_decisions_ref(log_p_attn, text_lengths))


@_decisions_op.register_kernel("cuda")
def _decisions_op_cuda(log_p_attn, text_lengths):
    _check_card_lattice("mas_decisions", log_p_attn)
    b, t_feats, t_text = log_p_attn.shape
    bits = torch.empty(b, t_feats, (t_text + 31) // 32, dtype=torch.int32, device=log_p_attn.device)
    if b == 0:
        return bits
    lp = log_p_attn.float()
    tl = _lengths_i32(text_lengths)
    _launch(_kernel_fns()[0], lp.device, lp.data_ptr(), tl.data_ptr(), bits.data_ptr(),
            b, t_feats, t_text)
    global fwd_launches
    fwd_launches += 1
    return bits


@_decisions_op.register_fake
def _decisions_op_fake(log_p_attn, text_lengths):
    if log_p_attn.device.type == "cuda":
        _check_card_lattice("mas_decisions", log_p_attn)
    b, t_feats, t_text = log_p_attn.shape
    return log_p_attn.new_empty(b, t_feats, (t_text + 31) // 32, dtype=torch.int32)


@torch.library.custom_op("jatts::mas_backtrace", mutates_args=(), device_types="cpu")
def _backtrace_op(bits: torch.Tensor, text_lengths: torch.Tensor, feats_lengths: torch.Tensor,
                  t_text: int) -> torch.Tensor:
    return mas_backtrace_ref(unpack_bits(bits, t_text), text_lengths, feats_lengths)


@_backtrace_op.register_kernel("cuda")
def _backtrace_op_cuda(bits, text_lengths, feats_lengths, t_text):
    b, t_feats, _ = bits.shape
    if not bits.is_contiguous():
        raise ValueError("mas_backtrace: bits must be contiguous")
    _check_sizes("mas_backtrace", t_feats, t_text)
    path = torch.empty(b, t_feats, dtype=torch.int32, device=bits.device)
    if b == 0:
        return path
    tl = _lengths_i32(text_lengths)
    fl = _lengths_i32(feats_lengths)
    _launch(_kernel_fns()[1], bits.device, bits.data_ptr(), tl.data_ptr(), fl.data_ptr(),
            path.data_ptr(), b, t_feats, t_text)
    global backtrace_launches
    backtrace_launches += 1
    return path


@_backtrace_op.register_fake
def _backtrace_op_fake(bits, text_lengths, feats_lengths, t_text):
    b, t_feats, _ = bits.shape
    if bits.device.type == "cuda":
        _check_sizes("mas_backtrace", t_feats, t_text)
    return bits.new_empty(b, t_feats, dtype=torch.int32)


@torch.library.custom_op("jatts::mas_path", mutates_args=(), device_types="cpu")
def _path_op(log_p_attn: torch.Tensor, text_lengths: torch.Tensor, feats_lengths: torch.Tensor,
             return_bits: bool, smem_bits_bytes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    path = mas_path_ref(log_p_attn, text_lengths, feats_lengths)
    if return_bits:
        return path, pack_bits(mas_decisions_ref(log_p_attn, text_lengths))
    return path, path.new_empty(0)


@_path_op.register_kernel("cuda")
def _path_op_cuda(log_p_attn, text_lengths, feats_lengths, return_bits, smem_bits_bytes):
    route = _check_path_args(log_p_attn, smem_bits_bytes)
    b, t_feats, t_text = log_p_attn.shape
    n_words = (t_text + 31) // 32
    device = log_p_attn.device
    path = torch.empty(b, t_feats, dtype=torch.int32, device=device)
    bits = scratch = None
    if return_bits:
        bits = torch.empty(b, t_feats, n_words, dtype=torch.int32, device=device)
    elif route == "global":
        scratch = torch.empty(b, t_feats, n_words, dtype=torch.int32, device=device)
    if b > 0:
        lp = log_p_attn.float()
        tl = _lengths_i32(text_lengths)
        fl = _lengths_i32(feats_lengths)
        with torch.cuda.device(device):
            rc = _path_fn()(lp.data_ptr(), tl.data_ptr(), fl.data_ptr(), path.data_ptr(),
                            None if bits is None else bits.data_ptr(),
                            None if scratch is None else scratch.data_ptr(),
                            b, t_feats, t_text, smem_bits_bytes, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{KERNEL_PATH} launch failed with CUDA error {rc}")
        global path_launches
        path_launches += 1
        path_routes[route] += 1
    return path, path.new_empty(0) if bits is None else bits


@_path_op.register_fake
def _path_op_fake(log_p_attn, text_lengths, feats_lengths, return_bits, smem_bits_bytes):
    if log_p_attn.device.type == "cuda":
        _check_path_args(log_p_attn, smem_bits_bytes)
    b, t_feats, t_text = log_p_attn.shape
    path = log_p_attn.new_empty(b, t_feats, dtype=torch.int32)
    shape = (b, t_feats, (t_text + 31) // 32) if return_bits else (0,)
    return path, log_p_attn.new_empty(shape, dtype=torch.int32)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def mas_decisions(log_p_attn: torch.Tensor, text_lengths: torch.Tensor) -> torch.Tensor:
    """K2 (``jatts::mas_decisions``) on CUDA tensors,
    ``pack_bits(mas_decisions_ref(...))`` on CPU tensors: int32
    ``[B, T_feats, ceil(T_text / 32)]``.

    On the card it takes a contiguous f32 or bf16 ``[B, T_feats, T_text]``
    (bf16 is cast to f32 first) with ``1 <= T_text <= 1024`` and
    ``T_feats >= 1`` and raises on anything else; it launches on the current
    stream and does not synchronise."""
    if log_p_attn.dim() != 3:
        raise ValueError("log_p_attn must be [B, T_feats, T_text]")
    _check_lengths("text_lengths", text_lengths, log_p_attn.shape[0])
    _on_cpu("mas_decisions", log_p_attn, text_lengths)
    return _decisions_op(log_p_attn, text_lengths)


def mas_backtrace(
    bits: torch.Tensor, text_lengths: torch.Tensor, feats_lengths: torch.Tensor, t_text: int
) -> torch.Tensor:
    """K3 (``jatts::mas_backtrace``) on CUDA tensors,
    :func:`mas_backtrace_ref` on CPU tensors: the int32 path
    ``[B, T_feats]`` from K2's packed bits."""
    if bits.dim() != 3 or bits.dtype != torch.int32:
        raise ValueError("bits must be int32 [B, T_feats, ceil(T_text / 32)]")
    b, t_feats, n_words = bits.shape
    if n_words != (t_text + 31) // 32:
        raise ValueError(f"bits has {n_words} words a frame, T_text={t_text} needs "
                         f"{(t_text + 31) // 32}")
    _check_lengths("text_lengths", text_lengths, b)
    _check_lengths("feats_lengths", feats_lengths, b)
    _on_cpu("mas_backtrace", bits, text_lengths, feats_lengths)
    return _backtrace_op(bits, text_lengths, feats_lengths, int(t_text))


def mas_path_cuda(
    log_p_attn: torch.Tensor, text_lengths: torch.Tensor, feats_lengths: torch.Tensor
) -> torch.Tensor:
    """K2 then K3, two launches back to back on the current stream, the
    bits through device memory between them. CUDA tensors only. No backend
    takes it since the fused search (:func:`mas_path_fused`); it is kept to
    be held and timed beside that."""
    if log_p_attn.device.type != "cuda":
        raise ValueError("mas_path_cuda (K2 then K3) needs CUDA tensors")
    bits = mas_decisions(log_p_attn, text_lengths)
    return mas_backtrace(bits, text_lengths, feats_lengths, log_p_attn.shape[2])


def mas_path_fused(
    log_p_attn: torch.Tensor,
    text_lengths: torch.Tensor,
    feats_lengths: torch.Tensor,
    return_bits: bool = False,
    smem_bits_bytes: int = SMEM_BITS_BYTES,
):
    """The whole search in one launch (``csrc/mas_path.cu``, the op
    ``jatts::mas_path``) on CUDA tensors, :func:`mas_path_ref` on CPU
    tensors: the int32 path ``[B, T_feats]``.

    With ``return_bits`` it returns ``(path, bits)``, ``bits`` every frame's
    decisions as K2 packs them (``pack_bits(mas_decisions_ref(...))``).
    On the card it takes what :func:`mas_decisions` takes (bf16 is cast to
    f32 first) and raises on anything else; the bits stay in shared memory
    when ``T_feats * ceil(T_text / 32) * 4 <= smem_bits_bytes`` (route
    ``smem``) and otherwise go through device memory (``global``), which a
    smaller ``smem_bits_bytes`` forces. It launches on the current stream
    and does not synchronise."""
    if log_p_attn.dim() != 3:
        raise ValueError("log_p_attn must be [B, T_feats, T_text]")
    b = log_p_attn.shape[0]
    _check_lengths("text_lengths", text_lengths, b)
    _check_lengths("feats_lengths", feats_lengths, b)
    _on_cpu("mas_path_fused", log_p_attn, text_lengths, feats_lengths)
    path, bits = _path_op(log_p_attn, text_lengths, feats_lengths, bool(return_bits), int(smem_bits_bytes))
    return (path, bits) if return_bits else path


def _mas_path_kernel(log_p_attn, text_lengths, feats_lengths):
    if log_p_attn.device.type != "cuda":
        raise ValueError("mas_backend='cuda' needs CUDA tensors; use 'scan' or 'auto' on the CPU")
    return mas_path_fused(log_p_attn, text_lengths, feats_lengths)


def select_mas(backend: str) -> Callable[..., torch.Tensor]:
    """``auto``: the fused search for CUDA tensors, the plain version for CPU
    tensors. ``scan``: the plain version wherever the tensors lie. ``cuda``:
    the fused search, and an error on CPU tensors. (:func:`mas_path_cuda`,
    the K2 then K3 pair, is no backend: it is timed beside.)"""
    if backend == "auto":
        return mas_path_fused
    if backend == "scan":
        return mas_path_ref
    if backend == "cuda":
        return _mas_path_kernel
    raise ValueError(f"unknown MAS backend: {backend}")


def viterbi_decode(
    log_p_attn: torch.Tensor,
    text_lengths: torch.Tensor,
    feats_lengths: torch.Tensor,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Durations and binarization loss.

    Returns:
        ds: ``[B, T_text]`` float32, frames per token.
        bin_loss: scalar, the mean over the batch of
            ``-mean_j log_p_attn[b, j, path[b, j]]`` over valid frames
            (differentiable w.r.t. ``log_p_attn``; the path carries no
            gradient).
    """
    b, t_feats, t_text = log_p_attn.shape
    with torch.no_grad():
        path = select_mas(backend)(log_p_attn.detach(), text_lengths, feats_lengths).to(torch.int64)
        frame_valid = sequence_mask(feats_lengths, t_feats, torch.float32)
        # a path of -1 (a row with no token) selects nothing, as one_hot(-1)
        on_path = path >= 0
        index = path.clamp(min=0)
        ds = torch.zeros(b, t_text, dtype=torch.float32, device=log_p_attn.device)
        ds.scatter_add_(1, index, frame_valid * on_path)
    gathered = log_p_attn.float().gather(2, index[:, :, None])[:, :, 0] * on_path
    per_utt = -(gathered * frame_valid).sum(1) / feats_lengths.float().clamp(min=1.0)
    return ds, global_mean(per_utt)
