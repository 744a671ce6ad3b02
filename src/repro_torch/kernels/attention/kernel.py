"""Python entry point of the hand-written flash-attention kernels.

``flash_attention(q, k, v, causal=, window=, scale=, kv_len=)`` computes
what the JAX package's ``kernels/attention/kernel.py:flash_attention``
computes — online-softmax attention with causal masking, a sliding
window, GQA (query head h reads kv head h // (H // KV)) and a ``kv_len``
mask, accumulated in fp32 — with ``csrc/attention.cu`` (built by
:mod:`repro_torch.kernels.build`) on PyTorch's current stream. A tensor
on the CPU goes to the plain version (``ref.attention_ref``) instead; a
CUDA tensor launches a kernel or raises — a failed build or launch
never falls back.

Which kernel a CUDA call launches (:func:`takes_tensor_cores`):

* the tensor-core kernel (``flash_attention_tc_kernel``: wgmma, TMA)
  when q, k and v are bfloat16, d and dv are multiples of 8, d is at
  most 192 and dv at most 160 (``TC_MAX_D``, ``TC_MAX_DV``), and every
  operand starts on a 16-byte boundary — what TMA needs to load rows,
  and what fits a block's shared memory. Up to dv 128 it runs 128-key
  tiles (MLA's (192, 128) among them), above 128 its wide design,
  112-key tiles and a 160-column p·V (StableLM's (160, 160));
* the CUDA-core kernel (``flash_attention_kernel``, fp32 arithmetic)
  otherwise: every float32 call, and bf16 calls with d or dv not a
  multiple of 8, d above 192 or dv above 160 ((256, 256)), or an operand
  off a 16-byte boundary.

Both take d and dv up to ``MAX_HEAD_DIM`` (256); wider heads raise.

Both compute the same function (``csrc/attention.cu`` says how the
tensor-core kernel keeps p·V fp32-exact). Each call launches one kernel
and counts it in the plain integer ``flash_attention.launches``; a launch
of the tensor-core kernel also counts in ``flash_attention.launches_tc``.
Both are raised only where a kernel is launched, so a run can show which
design it went through.

The kernels have no backward: with grad enabled, a CUDA input that
requires grad raises instead of silently cutting the gradient path.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.build import COMMON, CudaLibrary

MAX_HEAD_DIM = 256    # the CUDA-core kernel's tiles hold 256 columns
TC_MAX_D = 192        # the tensor-core kernel: three 64-column q/k panels
TC_MAX_DV = 160       # and a 160-column p.V (csrc/attention.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.attention_launch.argtypes = ([ptr] * 4 + [i32] * 12
                                     + [ctypes.c_float, ptr])
    lib.attention_launch.restype = i32
    lib.attention_tc_launch.argtypes = ([ptr] * 4 + [i32] * 11
                                        + [ctypes.c_float, ptr])
    lib.attention_tc_launch.restype = i32
    lib.attention_error_string.argtypes = [i32]
    lib.attention_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("attention", Path(__file__).resolve().parent / "csrc",
                      _declare, include_dirs=(COMMON,))


def _check(q, k, v):
    """Raise unless the kernels take these operands (dtypes, devices,
    shapes, head widths up to MAX_HEAD_DIM); reads shapes only."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and "
                             f"{t.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    B, Sq, H, d = q.shape
    _, Skv, KV, dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != d
            or KV < 1 or H % KV):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if min(B, Sq, Skv, H, d, dv) < 1:
        raise ValueError(f"flash_attention: empty operand, q "
                         f"{tuple(q.shape)}, v {tuple(v.shape)}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims d {d}, dv {dv}; the "
                         f"kernel takes at most {MAX_HEAD_DIM}")


def takes_tensor_cores(q, k, v) -> bool:
    """The wrapper's rule: a CUDA call runs the tensor-core kernel iff
    q, k and v are bfloat16, d and dv are multiples of 8, d <= 192,
    dv <= 160 and each operand's data starts on a 16-byte boundary;
    otherwise the CUDA-core kernel."""
    d, dv = q.shape[-1], v.shape[-1]
    return (q.dtype == torch.bfloat16 and d % 8 == 0 and dv % 8 == 0
            and d <= TC_MAX_D and dv <= TC_MAX_DV
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    kv_len: int | None = None):
    """q: (B, Sq, H, d); k/v: (B, Skv, KV, d/dv), all float32 or all
    bfloat16, contiguous, H % KV == 0, d and dv at most 256 on a card.
    Keys at positions >= ``kv_len`` (default Skv) are masked. Returns
    (B, Sq, H, dv) in q's dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, kv_len=kv_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: an input requires grad and the "
                           "kernel has no backward; take the plain path "
                           "(use_kernel=False) to differentiate")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: expected CUDA or CPU tensors, "
                         f"got {q.device}")
    _check(q, k, v)
    B, Sq, H, d = q.shape
    _, Skv, KV, dv = v.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = Skv if kv_len is None else kv_len
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    masks = (int(causal), int(window is not None), int(window or 0),
             int(kv_len), float(scale))
    tc = takes_tensor_cores(q, k, v)
    if tc:
        rc = lib.attention_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KV, d, dv, *masks, stream)
    else:
        rc = lib.attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, H, KV, d, dv, *masks, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed ({rc}: "
                           f"{lib.attention_error_string(rc).decode()})")
    flash_attention.launches += 1
    flash_attention.launches_tc += int(tc)
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0

__all__ = ["MAX_HEAD_DIM", "LIBRARY", "TC_MAX_D", "TC_MAX_DV",
           "flash_attention", "takes_tensor_cores"]
