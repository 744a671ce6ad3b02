"""Python entry point of the hand-written SSD chunk-scan kernels.

``ssd_scan(x, dt, A, Bm, Cm, chunk=L)`` computes what the JAX package's
``kernels/ssd/kernel.py:ssd_pallas`` computes — the Mamba2 SSD chunked
dual form, returning y and the final state — with ``csrc/ssd.cu``
(built by :mod:`repro_torch.kernels.build`) on PyTorch's current stream.
A tensor on the CPU goes to the plain version (``ref.ssd_ref``) instead;
a CUDA tensor launches the kernels or raises — a failed build or launch
never falls back, neither to the plain version nor from one route to the
other.

Which route a CUDA call takes (:func:`takes_tensor_cores`):

* the tensor-core route (``ssd_tc_launch``: per-chunk states, the pass
  over chunks, the outputs; ``wgmma``, TMA) when the chunk is a multiple
  of 64 up to 256, P a multiple of 8 up to 64, N 128, and x, Bm and Cm
  start on 16-byte boundaries — Mamba2-130m's shape (P 64, N 128, chunk
  256);
* the CUDA-core route (``ssd_launch``: per-chunk states, C·Bᵀ per chunk,
  the pass over chunks, the outputs, fp32 arithmetic) otherwise, e.g.
  the reduced config's P 8, N 16, chunk 8.

Both compute the same function (``csrc/ssd.cu`` says how the tensor-core
route keeps its products with an fp32 factor fp32-exact). Each call
counts one launch in the plain integer ``ssd_scan.launches``; a call on
the tensor-core route also counts in ``ssd_scan.launches_tc``. Both are
raised only where the kernels are launched, so a run can show which
route it went through. The kernels have no backward: with grad enabled,
a CUDA input that requires grad raises instead of silently cutting the
gradient path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import COMMON, CudaLibrary
from repro_torch.kernels.ssd.ref import ssd_ref

MAX_CHUNK = 2048      # the chunk's scan (12 bytes a step) in shared memory
TC_TILE = 64          # rows of the tensor-core route's tiles
TC_MAX_CHUNK = 256    # its output kernel holds a whole chunk in shared memory
TC_STATE = 128        # the state width N its kernels are built for


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.ssd_launch.restype = i32
    lib.ssd_tc_launch.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
    lib.ssd_tc_launch.restype = i32
    lib.ssd_error_string.argtypes = [i32]
    lib.ssd_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd", Path(__file__).resolve().parent / "csrc",
                      _declare, include_dirs=(COMMON,))


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


def takes_tensor_cores(x, Bm, Cm, chunk: int) -> bool:
    """The wrapper's rule: a CUDA call takes the tensor-core route iff the
    chunk is a multiple of 64 up to 256, P (x's last dim) is a multiple
    of 8 up to 64, N is 128 (every Mamba2 config's), and x, Bm and Cm
    start on 16-byte boundaries (what TMA needs to load their rows);
    otherwise the CUDA-core route."""
    P, N = x.shape[-1], Bm.shape[-1]
    return (chunk % TC_TILE == 0 and chunk <= TC_MAX_CHUNK
            and P % 8 == 0 and 8 <= P <= 64 and N == TC_STATE
            and all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm)))


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """x: (B,S,H,P) bf16; dt: (B,S,H) f32; A: (H,) f32; Bm/Cm: (B,S,N)
    bf16, all contiguous, with ``S % chunk == 0``. Returns (y (B,S,H,P)
    f32, final_state (B,H,P,N) f32). Every product is exact and every
    sum fp32."""
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
    states = torch.empty((B, nc, H, P, N), **f32)   # each chunk's own
    dec = torch.empty((B, nc, H), **f32)            # each chunk's decay
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in (x, dt, A, Bm, Cm, y, final, states)]
    tc = takes_tensor_cores(x, Bm, Cm, chunk)
    if tc:
        # the states before each chunk as bf16 hi and lo; the chunks'
        # scans (cums in float64, dt)
        st2 = torch.empty((B, nc, H, 2, P, N), dtype=torch.bfloat16,
                          device=x.device)
        cd = torch.empty((B, nc, H, 3, chunk), **f32)   # f64 cums, dt
        rc = lib.ssd_tc_launch(*ptrs, st2.data_ptr(), dec.data_ptr(),
                               cd.data_ptr(), B, S, H, P, N, chunk, stream)
    else:
        # states becomes the state before each chunk; C·Bᵀ per chunk
        cb = torch.empty((B, nc, chunk, chunk), **f32)
        rc = lib.ssd_launch(*ptrs, dec.data_ptr(), cb.data_ptr(), B, S, H,
                            P, N, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed ({rc}: "
                           f"{lib.ssd_error_string(rc).decode()})")
    ssd_scan.launches += 1
    ssd_scan.launches_tc += int(tc)
    return y, final


ssd_scan.launches = 0
ssd_scan.launches_tc = 0

__all__ = ["MAX_CHUNK", "LIBRARY", "TC_MAX_CHUNK", "TC_STATE", "TC_TILE",
           "ssd_scan", "takes_tensor_cores"]
