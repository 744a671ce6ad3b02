"""Compare the port's flash-attention library of this checkout with that
of another checkout, on one CUDA card: outputs bit for bit, and times in
turns.

    python3 scripts/torch_attention_ab.py --other DIR [--shapes ...]

``DIR`` is another checkout of the repository (say, the parent commit
unpacked with ``git archive``). Both ``csrc/attention.cu`` builds load
side by side (each under its own key in ``kernels/_build``). At each
shape — bf16, causal, random normal q, k, v from a seed — the script
calls each library's tensor-core launcher, or, where one refuses the
shape, that library's CUDA-core launcher (its route for the shape), and
reports whether the two outputs are bit-identical and their largest
difference, then the time of a call by CUDA events and the device time
of a launch by the profiler, in the order other, this, this, other.
Shapes (B, S, H, KV, d, dv), the full-width prefill calls of chip_smoke:

    llama     (4, 4096, 24, 8, 128, 128)   Llama-3.2-3B
    mla       (4, 4096, 16, 16, 192, 128)  DeepSeek-V2-Lite's MLA
    stablelm  (4, 4096, 32, 8, 160, 160)   StableLM-12B

The last line is one JSON object with every number; the card's name and
power limit (``nvidia-smi``) are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"llama": (4, 4096, 24, 8, 128, 128),
          "mla": (4, 4096, 16, 16, 192, 128),
          "stablelm": (4, 4096, 32, 8, 160, 160)}


def _launcher(lib, q, k, v, out):
    """A call of ``lib``'s tensor-core launcher on (q, k, v), or of its
    CUDA-core one if the tensor-core one refuses the shape; returns
    (the call, the route's name)."""
    import torch
    B, S, H, d = q.shape
    KV, dv = k.shape[2], v.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    masks = (1, 0, 0, S, 1.0 / math.sqrt(d), stream)

    def tc():
        return lib.attention_tc_launch(*ptrs, B, S, S, H, KV, d, dv, *masks)

    def cuda_core():
        return lib.attention_launch(*ptrs, 1, B, S, S, H, KV, d, dv, *masks)

    for call, route in ((tc, "tensor cores"), (cuda_core, "CUDA cores")):
        if call() == 0:
            torch.cuda.synchronize()
            return call, route
    raise RuntimeError(f"neither launcher of {lib} takes {tuple(q.shape)}, "
                       f"dv {dv}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated subset of " + ",".join(SHAPES))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _device_ms, time_ms
    from repro_torch.kernels.attention import kernel as K
    from repro_torch.kernels.build import CudaLibrary
    other_src = args.other.resolve() / "src" / "repro_torch" / "kernels"
    libs = {"other": CudaLibrary("attention", other_src / "attention" / "csrc",
                                 K._declare,
                                 include_dirs=(other_src / "common",)).load(),
            "this": K.LIBRARY.load()}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    res = {}
    for name in args.shapes.split(","):
        B, S, H, KV, d, dv = SHAPES[name]
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .bfloat16() for shape in ((B, S, H, d), (B, S, KV, d),
                                             (B, S, KV, dv)))
        outs, calls, routes = {}, {}, {}
        for side, lib in libs.items():
            outs[side] = torch.empty((B, S, H, dv), dtype=q.dtype,
                                     device=q.device)
            calls[side], routes[side] = _launcher(lib, q, k, v, outs[side])
        r = dict(routes=routes,
                 bit_identical=bool(torch.equal(outs["other"],
                                                outs["this"])),
                 max_abs_diff=float((outs["other"].float()
                                     - outs["this"].float()).abs().max()),
                 ms={"other": [], "this": []},
                 device_ms={"other": [], "this": []})
        for side in ("other", "this", "this", "other"):
            r["ms"][side].append(time_ms(calls[side], batch=5, reps=5,
                                         warmup=2))
            r["device_ms"][side].append(_device_ms(calls[side], n=20))
        print(f"{name} {SHAPES[name]}: {routes}; bit-identical "
              f"{r['bit_identical']}, max |diff| {r['max_abs_diff']:.3e}; "
              f"ms a call {r['ms']}; device ms a launch {r['device_ms']}",
              flush=True)
        res[name] = r
        del q, k, v, outs
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
