"""Python entry point of the hand-written SSD chunk-scan kernel.

``ssd_scan(x, dt, A, Bm, Cm, chunk=L)`` computes what the JAX package's
``kernels/ssd/kernel.py:ssd_pallas`` computes — the Mamba2 SSD chunked
dual form, returning y and the final state — with ``csrc/ssd.cu``
(built by :mod:`repro_torch.kernels.build`) on PyTorch's current stream.
A tensor on the CPU goes to the plain version (``ref.ssd_ref``) instead;
a CUDA tensor launches the kernel or raises — a failed build or launch
never falls back.

One call runs four CUDA kernels in order (per-chunk states, C·Bᵀ per
chunk, the pass over chunks, the outputs) and counts one launch in the
plain integer ``ssd_scan.launches``, raised only where the kernels are
launched, so a run can show that it went through them. The kernels have
no backward: with grad enabled, a CUDA input that requires grad raises
instead of silently cutting the gradient path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ssd.ref import ssd_ref

MAX_CHUNK = 2048      # the chunk's scan (2 floats a step) in shared memory


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.ssd_launch.restype = i32
    lib.ssd_error_string.argtypes = [i32]
    lib.ssd_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd", Path(__file__).resolve().parent / "csrc",
                      _declare)


def _check(x, dt, A, Bm, Cm, chunk):
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: expected CUDA or CPU tensors, got "
                         f"{x.device}")
    for name, t, dtype, nd in (("x", x, torch.bfloat16, 4),
                               ("dt", dt, torch.float32, 3),
                               ("A", A, torch.float32, 1),
                               ("Bm", Bm, torch.bfloat16, 3),
                               ("Cm", Cm, torch.bfloat16, 3)):
        if t.dtype != dtype:
            raise TypeError(f"ssd_scan: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: tensors on {x.device} and "
                             f"{t.device}")
        if t.dim() != nd:
            raise ValueError(f"ssd_scan: {name} must be {nd}-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, S, N) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not "
                         f"agree")
    if min(B, S, H, P, N) < 1:
        raise ValueError(f"ssd_scan: empty operand, x {tuple(x.shape)}, "
                         f"N {N}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} > {MAX_CHUNK}")


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """x: (B,S,H,P) bf16; dt: (B,S,H) f32; A: (H,) f32; Bm/Cm: (B,S,N)
    bf16, all contiguous, with ``S % chunk == 0``. Returns (y (B,S,H,P)
    f32, final_state (B,H,P,N) f32). All arithmetic is fp32."""
    S = x.shape[1]
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S = {S} is not a multiple of chunk = "
                         f"{chunk}")
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, Bm, Cm)):
        raise RuntimeError("ssd_scan: an input requires grad and the kernel "
                           "has no backward; take the plain path "
                           "(use_kernel=False) to differentiate")
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((B, S, H, P), **f32)
    final = torch.empty((B, H, P, N), **f32)
    states = torch.empty((B, nc, H, P, N), **f32)   # then the state before
    dec = torch.empty((B, nc, H), **f32)            # each chunk's decay
    cb = torch.empty((B, nc, chunk, chunk), **f32)  # C·Bᵀ per chunk
    lib = LIBRARY.load()
    rc = lib.ssd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), final.data_ptr(), states.data_ptr(),
        dec.data_ptr(), cb.data_ptr(), B, S, H, P, N, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed ({rc}: "
                           f"{lib.ssd_error_string(rc).decode()})")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0

__all__ = ["MAX_CHUNK", "LIBRARY", "ssd_scan"]
