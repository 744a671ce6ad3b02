"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell
on a fake 256- or 512-rank mesh and record, for one device, the memory,
FLOPs and collective bytes it costs: the JAX package's
``launch/dryrun.py`` on DTensor.

Each cell builds the production mesh (``launch.mesh.production_mesh``),
the inputs placed by the JAX package's sharding plan
(``launch.inputs.input_specs``) and the step with the plan's activation
specs (``training.step``), then runs the step once on the plain path
(``use_kernel=False``; JAX's dry run lowers its plain attention and SSD
too) under ``FakeTensorMode``: no tensor holds memory on any device, and
the fake group's collectives move nothing. The port's layer and
microbatch loops are Python loops, so every layer and microbatch is
counted, which JAX calls ``--unroll`` (the flag is accepted and
recorded). Run one cell:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multi-pod] [--no-attn-dp] [--device cpu]

or the whole sweep (one subprocess a cell, as many at once as the host
has cores less one, the longest first):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Each cell writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(never JAX's ``artifacts/dryrun/``) with JAX's keys where the quantity
exists in the port, counted on rank 0 by :class:`DeviceCounter`, which
sees the local ops that rank runs below DTensor's dispatch:

- ``memory.argument_size_in_bytes``: the exact sum of the rank's local
  input bytes; ``memory.output_size_in_bytes``: its local output bytes.
- ``memory.temp_size_in_bytes``: the peak of the live local bytes the
  step allocated beyond its arguments, in the eager step's own order of
  allocation and release (outputs included while they are built; each
  allocation rounded up to the CUDA caching allocator's 512 bytes on a
  ``cuda`` mesh). This is the port's quantity, not XLA's buffer-assigned
  temp; ``peak_bytes`` is arguments + temp and ``fits_80gb`` compares it
  with one H100's 80 GB.
- ``cost.flops``: the FLOPs of the local matrix products one rank runs
  (``torch.utils.flop_counter``'s formulas for mm, bmm, convolutions and
  attention; elementwise work is not counted, where XLA's cost analysis
  counts it).
- ``collectives``: the count and per-device bytes of each kind, under
  JAX's names, from the functional collectives DTensor's redistributions
  issue, counting result bytes as JAX counts result shapes.

JAX's ``compile_s``, ``hlo_bytes`` and ``cost["bytes accessed"]`` have
no counterpart and are left out; ``parse_collective_bytes`` reads HLO,
which the port does not make. New keys: ``peak_bytes``, ``fits_80gb``,
``trace_s`` (the traced step's wall time) and ``device``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts"
                / "dryrun_torch")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# torch's functional collectives (what DTensor issues) under JAX's names
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all"}

HBM_BYTES = 80e9            # one H100
_ALLOC_ROUND = 512          # the CUDA caching allocator's granularity


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def _marking_propagation(counter):
    """While DTensor derives an op's output shape it runs the op once on
    global-shape fake tensors; those runs are not the rank's work, so
    the counter skips them (by wrapping a private method of DTensor's
    propagator, which torch 2.11 and 2.13 both have)."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    real = prop._propagate_tensor_meta_non_cached

    def marked(op_schema):
        counter.shadow += 1
        try:
            return real(op_schema)
        finally:
            counter.shadow -= 1

    prop._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached


class DeviceCounter(TorchDispatchMode):
    """Counts what one rank's local ops cost: FLOPs, collectives and live
    bytes. An op on DTensors is handed back to DTensor (``NotImplemented``),
    which runs it as local ops that come through here; DTensor's own
    shape propagation is skipped. A storage is counted when an op creates
    it (one no input of the op has) and released when it dies."""

    def __init__(self, round_to: int = 1):
        super().__init__()
        self.round_to = round_to
        self.flops = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.shadow = 0
        self._held: dict[int, weakref.ref] = {}

    def _release(self, key: int, nbytes: int):
        if self._held.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, out, seen: set[int]):
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._held:
                continue
            n = -(-st.nbytes() // self.round_to) * self.round_to
            self._held[key] = weakref.ref(
                st, lambda _, k=key, n=n: self._release(k, n))
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.shadow:
            return out
        seen = {t.untyped_storage()._cdata
                for t in torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        self._track(out, seen)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional":
            kind = _FUNCOL.get(packet.__name__)
            if kind is not None:
                c = self.collectives[kind]
                c["count"] += 1
                c["bytes"] += sum(
                    t.numel() * t.element_size()
                    for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor))
        return out

    def collective_totals(self) -> dict:
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        return out

    def __enter__(self):
        self._prop = _marking_propagation(self)
        self._prop.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._prop.__exit__(*exc)


def local_bytes(tree) -> int:
    """Bytes of the distinct local storages of a tree's DTensors (or
    tensors)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import flatten
    seen, total = set(), 0
    for t in flatten(tree):
        if not isinstance(t, torch.Tensor):
            continue
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


ARG_KEYS = {"train": ("params", "opt_state", "batch"),
            "prefill": ("params", "batch"),
            "decode": ("params", "caches", "token")}


def build_step(cfg, shape, mesh, *, mem_opt: bool = False,
               accum: int | None = None, attn_dp: bool = True):
    """The cell's step on the plain path, taking the inputs named by
    ``ARG_KEYS[shape.kind]``, and its ``OptConfig`` (None but for a
    train step)."""
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.step import (build_prefill_step,
                                           build_serve_step, build_train_step)
    if shape.kind == "train":
        oc = (OptConfig(state_dtype=torch.bfloat16) if mem_opt
              else OptConfig())
        step = build_train_step(
            cfg, oc, mesh=mesh, shape=shape, grad_accum=accum,
            accum_dtype=torch.bfloat16 if mem_opt else torch.float32,
            attn_dp=attn_dp)
        return step, oc
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh=mesh, shape=shape,
                                  use_kernel=False, attn_dp=attn_dp), None
    step = build_serve_step(cfg, pos=shape.seq_len - 1, use_kernel=False)
    return (lambda p, c, t: step(p, c, t, 0)), None


def trace_step(step, args, device: str):
    """Run ``step(*args)`` once under a :class:`DeviceCounter` (inside the
    caller's ``FakeTensorMode``), plain tensors counting as replicated.
    Returns (out, counter, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication
    counter = DeviceCounter(_ALLOC_ROUND if device == "cuda" else 1)
    t0 = time.time()
    with implicit_replication(), counter:
        out = step(*args)
    return out, counter, time.time() - t0


def measure(cfg, shape, mesh, *, mem_opt: bool = False,
            accum: int | None = None, attn_dp: bool = True) -> dict:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (fake tensors on the
    mesh's device), counted on rank 0: the record's ``memory``,
    ``peak_bytes``, ``fits_80gb``, ``cost``, ``collectives`` and
    ``trace_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.inputs import input_specs, opt_state_structs
    device = mesh.device_type
    with FakeTensorMode():
        specs = input_specs(cfg, shape, mesh)
        step, oc = build_step(cfg, shape, mesh, mem_opt=mem_opt, accum=accum,
                              attn_dp=attn_dp)
        if oc is not None:
            specs["opt_state"] = opt_state_structs(cfg, mesh, oc)
        args = tuple(specs[k] for k in ARG_KEYS[shape.kind])
        arg_bytes = local_bytes(args)
        out, counter, trace_s = trace_step(step, args, device)
        out_bytes = local_bytes(out)
    peak = arg_bytes + counter.peak
    return {"trace_s": round(trace_s, 2), "device": device,
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": counter.peak},
            "peak_bytes": peak, "fits_80gb": peak <= HBM_BYTES,
            "cost": {"flops": float(counter.flops)},
            "collectives": counter.collective_totals()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             unroll: bool = False, nblocks: int | None = None,
             mem_opt: bool = False, accum: int | None = None, *,
             device: str = "cuda", attn_dp: bool = True) -> dict:
    from repro_torch.configs.base import SHAPES, cell_is_skipped, get_config
    from repro_torch.distrib import sharding as SH
    from repro_torch.launch.mesh import production_mesh
    from repro_torch.models import model as M

    skip = cell_is_skipped(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": skip, "unroll": unroll}

    cfg = get_config(arch)
    if nblocks is not None:
        # depth-reduced variant for linear extrapolation of per-layer cost:
        # totals are affine in the number of scan blocks
        cfg = dataclasses.replace(
            cfg, num_layers=cfg.first_dense_layers
            + nblocks * cfg.block_period)
    shape = SHAPES[shape_name]
    with production_mesh(multi_pod, device) as mesh:
        notes = SH.check_divisibility(cfg, mesh, shape) + sharding_notes(cfg)
        got = measure(cfg, shape, mesh, mem_opt=mem_opt, accum=accum,
                      attn_dp=attn_dp)
        n_chips = mesh.size()
    full = get_config(arch)
    return {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "multi_pod": multi_pod, "status": "ok", "unroll": unroll,
        "mem_opt": mem_opt, "attn_dp": attn_dp, "n_chips": n_chips,
        "n_params": M.count_model_params(cfg),
        "n_active_params": M.active_params(cfg),
        "tokens_per_step": shape.global_batch * (1 if shape.is_decode
                                                 else shape.seq_len),
        "kind": shape.kind, "nblocks": nblocks,
        "n_scan_blocks_full": (full.num_layers - full.first_dense_layers)
        // full.block_period,
        **got, "sharding_notes": notes,
    }


def sharding_notes(cfg) -> list[str]:
    """Where the port leaves DTensor's own rules for a region of its own
    (``distrib.sharding``)."""
    notes = ["einsums run shard by shard (local_map; no DTensor rule)"]
    kinds = {cfg.layer_kind(l) for l in range(cfg.num_layers)}
    if kinds & {"attn", "cross"} or cfg.is_encoder_decoder:
        notes.append("prefill/train attention shard by shard over batch "
                     "and heads (local_map); K/V sequence gathered whole")
    if "ssm" in kinds:
        notes.append("SSD chunked scan shard by shard over batch, heads "
                     "and head dims (local_map); sequence gathered whole")
    if cfg.num_experts:
        notes.append("MoE routing on whole replicas of every token "
                     "(local_map: sorts, scatter-add); dispatch and combine "
                     "shard by shard on the expert-parallel layout where "
                     "the plan gives one, else on whole replicas too")
    notes.append("embedding lookup as a masked gather from the vocab-"
                 "sharded table, summed at once")
    return notes


def cell_path(arch: str, shape: str, multi_pod: bool,
              unroll: bool = False, nblocks: int | None = None,
              mem_opt: bool = False, accum: int | None = None,
              attn_dp: bool = True) -> Path:
    sfx = "__unrolled" if unroll else ""
    if nblocks is not None:
        sfx += f"__nb{nblocks}"
    if mem_opt:
        sfx += "__memopt"
    if accum is not None:
        sfx += f"__acc{accum}"
    if not attn_dp:
        sfx += "__noattndp"
    return ARTIFACT_DIR / f"{arch}__{shape}__{_mesh_name(multi_pod)}{sfx}.json"


def _sweep(args) -> int:
    """Every cell, one subprocess each, as many at once as the host has
    cores less one."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import count_model_params
    # the longest first: train, then prefill, then decode; larger models
    # first within each
    order = {"train": 0, "prefill": 1, "decode": 2}
    cells = sorted(((a, s, mp) for a in ARCH_NAMES for s in SHAPES
                    for mp in (False, True)),
                   key=lambda c: (order[SHAPES[c[1]].kind],
                                  -count_model_params(get_config(c[0]))))
    todo = []
    for a, s, mp in cells:
        out = cell_path(a, s, mp)
        if out.exists() and not args.force:
            print(f"[cached] {out.name}")
            continue
        todo.append((a, s, mp))
    env = {**os.environ,
           "PYTHONPATH": str(Path(__file__).resolve().parents[2])}
    jobs = max(1, (os.cpu_count() or 2) - 1)
    running, failures = [], []
    while todo or running:
        while todo and len(running) < jobs:
            a, s, mp = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--device", args.device] \
                + (["--multi-pod"] if mp else [])
            print(f"[run] {a} x {s} x {_mesh_name(mp)}", flush=True)
            running.append(((a, s, mp), time.time(), subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True, env=env)))
        time.sleep(0.2)
        for item in list(running):
            cell, t0, proc = item
            timed_out = time.time() - t0 > args.timeout
            if proc.poll() is None and not timed_out:
                continue
            if timed_out and proc.poll() is None:
                proc.kill()
            err = proc.communicate()[1]
            running.remove(item)
            if proc.returncode != 0:
                failures.append(cell)
                print(f"FAIL {cell}: {err[-2000:]}", flush=True)
    print(table(ARTIFACT_DIR))
    print(f"done; {len(failures)} failures")
    for f in failures:
        print("FAIL:", f)
    return 1 if failures else 0


def table(directory: Path) -> str:
    """One markdown row for each cell recorded in ``directory`` (the
    sweep's artifacts; skipped cells and variants left out): status,
    per-device GB of arguments, temp and peak, whether the peak fits
    80 GB, TFLOP, collective GB and trace seconds."""
    rows = ["| arch | shape | mesh | status | args GB | temp GB | peak GB "
            "| fits 80 GB | TFLOP | collectives GB | trace s |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for f in sorted(directory.glob("*.json")):
        if f.stem.count("__") != 2:
            continue
        d = json.loads(f.read_text())
        if d["status"] == "skipped":
            continue
        if d["status"] != "ok":
            rows.append(f"| {d['arch']} | {d['shape']} | "
                        f"{d.get('mesh', _mesh_name(d['multi_pod']))} | "
                        f"{d['status']} |" + " |" * 7)
            continue
        m = d["memory"]
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | ok | "
            f"{m['argument_size_in_bytes'] / 1e9:.3f} | "
            f"{m['temp_size_in_bytes'] / 1e9:.3f} | "
            f"{d['peak_bytes'] / 1e9:.3f} | "
            f"{'yes' if d['fits_80gb'] else 'no'} | "
            f"{d['cost']['flops'] / 1e12:.3f} | "
            f"{d['collectives']['total_bytes'] / 1e9:.3f} | "
            f"{d['trace_s']:.1f} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for JAX's interface: the port's loops "
                    "are unrolled already")
    ap.add_argument("--nblocks", type=int, default=None,
                    help="depth-reduced variant (for extrapolation)")
    ap.add_argument("--mem-opt", action="store_true",
                    help="bf16 optimizer states + bf16 grad accumulation")
    ap.add_argument("--accum", type=int, default=None,
                    help="override microbatch count")
    ap.add_argument("--no-attn-dp", action="store_true",
                    help="drop the plan's data-parallel attention region")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (nothing is allocated)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--timeout", type=int, default=3000)
    args = ap.parse_args()
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)

    if args.all:
        sys.exit(_sweep(args))

    attn_dp = not args.no_attn_dp
    try:
        res = run_cell(args.arch, args.shape, args.multi_pod, args.unroll,
                       args.nblocks, args.mem_opt, args.accum,
                       device=args.device, attn_dp=attn_dp)
    except Exception:  # noqa: BLE001 — the cell's record keeps the error
        res = {"arch": args.arch, "shape": args.shape,
               "multi_pod": args.multi_pod, "status": "error",
               "traceback": traceback.format_exc()}
    out = cell_path(args.arch, args.shape, args.multi_pod, args.unroll,
                    args.nblocks, args.mem_opt, args.accum, attn_dp)
    out.write_text(json.dumps(res, indent=2))
    if res["status"] == "ok":
        print(json.dumps({k: res[k] for k in
                          ("arch", "shape", "mesh", "trace_s", "cost",
                           "memory", "peak_bytes")}, indent=2))
        print("collective bytes/device:", res["collectives"]["total_bytes"])
    else:
        print(json.dumps(res, indent=2))
        if res["status"] == "error":
            sys.exit(1)


if __name__ == "__main__":
    main()
