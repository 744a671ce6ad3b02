#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero and prints no
result line:

1. card    the card's name and power limit (``nvidia-smi``), then the
           builds of ``kernels/arbiter/csrc/arbiter.cu``,
           ``kernels/ssd/csrc/ssd.cu`` and
           ``kernels/attention/csrc/attention.cu`` for sm_90a, started
           together, and their times; every instantiation of the
           tensor-core attention kernel must build with no spill and no
           serialized wgmma
2. kernels each hand-written kernel against its plain PyTorch version on
           the card — full-width shapes of the main path (and the
           arbiter's at the B = 12 staged sweep's 1728 rows), ragged
           shapes, empty rows, ties (across the one-pass top-K's threads
           and warps too), the arbiter's edge rows (negative values,
           eligible (BIG, BIG) entries, winners with seq BIG and above,
           rings starting off 16-byte boundaries) at every layout of the
           staged arbiter, M < K (with keys of NEG and below too), K at
           and past the one-pass cap (the rounds routine past 8, checked
           by its counter); the fused
           kernel at all 7 stage subsets, single and batched (B = 1, 4,
           12), and at B = 12 with every ring row empty — requiring exact
           equality; then each kernel's time beside the plain version's
           and the library call's (CUDA events, median of repeated
           batches), and its device time per launch from the profiler
           (for the top-K also ``torch.topk``'s and the stable
           ``torch.sort``'s device time per call); for the arbiter, at
           (144, 1024), (144, 512), (1728, 1024) and (1728, 512), every
           layout and the earlier scalar kernel in turns in one profiler
           window, with the launch floor (a ``zero_()`` of 144 int32)
           and ``torch.argmin`` of (prio, seq) packed into one int64 (the
           yardstick; the packing not counted); for the fused kernel its
           ring rows on the new routine and on the earlier scalar one, in
           turns
3. goldens ``tests/golden/fabric_disabled.json`` and ``fabric_enabled.json``
           replayed for all six protocols on the staged (``cuda``) and the
           fused kernel backend, bit-exact; the 24 replays run in the
           worker pool (seven spawned processes, kept for the whole script)
           at once with phase 4's three runs, which go first
4. full    the paper's 144-host, 9-rack full-bisection leaf-spine network,
           W3 at load 0.8 with 8000 messages, homa, 12000 slots (every
           message has arrived by slot 9186), on the
           staged kernel backend (launches counted, every top-K launch
           on the one-pass routine; its state kept at slot 5000), on
           the plain backend for the first 5000 slots (state identical
           key by key), and through ``simulate`` on the
           fused backend (one ``fused_slot`` launch per slot, nothing
           staged; integer outputs identical to the staged run); each run
           in a worker, counters set to 0 there just before it
5. window  a steady window of that run from phase 4's state at slot
           5000, brought back onto the card: no host sync inside the slot
           loop on either kernel backend, then a profiled stretch of 50
           slots of each from that one state —
           device busy share, kernels per slot and each kernel's device
           time per launch
6. sweep   (a) the committed ``benchmarks/baselines/sweep_speed.json``
           mega cell (6 protocols x 3 loads x 4 seeds, 8 hosts, W1,
           chunked and streaming) on the fused backend: pooled p99s and
           completions equal to the baseline; (b) 12 full-width runs
           (loads 0.5/0.7/0.8 x seeds 0-3) as one batch through
           ``run_sweep`` on the fused and the staged backend: every integer
           of the streaming statistics identical, one
           ``fused_slot_batch`` launch per slot; (c) profiled windows of
           that batch from slot 1000 on both backends (the staged one
           runs the arbiter on (1728, 1024) and (1728, 512)) beside phase
           5's single run; (a), (b) and (c)'s warm-up run in the worker
           pool at once, the windows here
7. model   Mamba2-130m inference at full width (24 layers, d_model 768,
           H 24, P 64, N 128, chunk 256; random weights from a seed):
           (a) the SSD chunk-scan kernels (``csrc/ssd.cu``) against their
           plain version ``ssd_ref`` on the inputs of layer 0 of a real
           4 x 4096 prefill, on synthetic inputs at that shape, and on
           edge cases (pad path, S < chunk on the CUDA-core route, B = 1,
           one head, strong decay), each case's route checked by the
           counters, with the tensor-core route's time beside the
           CUDA-core route's (the earlier design, launched directly at
           the same shape) and both bounds (fp32 CUDA cores; bf16 tensor
           cores with the split products counted twice); (b)
           ``forward_prefill`` of 4 x 4096 tokens on the kernels (24
           launches, all on the tensor-core route, counted and seen by
           the profiler, each kernel's device time) against the
           plain ``ssd_chunked`` path (no SSD launch), layer by layer on
           the same inputs and end to end; (c) prefill of 4095 tokens
           plus one ``forward_decode`` against the 4096-token prefill;
           (d) ``repro_torch.launch.serve.main`` at full width, whose
           statistics must equal the JAX package's (``SERVE_EXPECTED``)
8. llama   Llama-3.2-3B inference at full width (28 layers, d_model 3072,
           24 heads over 8 KV heads of 128, d_ff 8192; random weights
           from a seed): (a) the flash-attention kernel
           (``csrc/attention.cu``) against its plain version
           ``attention_ref`` on layer 0's q, k, v of a real 4 x 4096
           prefill, on synthetic inputs at that shape and on edge cases
           (fp32 and d 100 on the CUDA-core kernel; window, non-causal,
           KV = 1, Sq 4095, Sq < 8, d 64, kv_len < Skv and rows with no
           valid key on the tensor-core one, the counters showing
           which), with its time beside the CUDA-core kernel's,
           ``attention_ref``'s and one ``scaled_dot_product_attention``
           call's (the yardstick; the port never calls it), and its
           bound as three bf16 tensor-core products; (b)
           ``forward_prefill`` of 4 x 4096 tokens on the kernel (28
           launches, all on the tensor cores, counted and seen by the
           profiler) against the ``use_kernel=False`` path
           (``blockwise_attention``, no launch), layer by layer on the same
           inputs and end to end; (c) prefill of 4095 tokens plus one
           ``forward_decode`` against the 4096-token prefill; (d) the
           full-width serve, whose statistics must equal
           ``SERVE_EXPECTED``
9. faults  the lossy fabric (DESIGN.md §7): (a) four runs of
           ``tests/golden/faults_enabled.json``'s ``"small"`` part (8
           hosts; Bernoulli and Gilbert-Elliott loss under homa and
           pias, a failed uplink and TOR under adaptive and flowlet
           routing), two on ``cuda`` and two on ``fused``, bit-exact; (b) its ``"full"`` point — 144
           hosts, 9 racks, W3 at load 0.8, homa, flowlet routing, every
           kind of fault — 4000 slots on ``cuda``, ``fused`` and
           ``reference``: the state identical key by key at slot 4000
           and equal to the JAX package's (the golden's digests,
           completions and counters), chunks conserved, then a window
           from slot 1500 (a failed uplink and a failed TOR) with no
           host sync and a profiled stretch on both kernel backends;
           (c) four full-width runs (seeds 0-3) with those faults under
           adaptive routing, one ``run_sweep`` batch of 2000 slots on
           ``fused`` (one ``fused_slot_batch`` a slot) and ``cuda``:
           every integer of the statistics identical, ``f_lost`` and
           ``retx`` included. The runs of (a)-(c) go to the worker pool at
           once, the windows run here
10. host   the host/NIC stage and in-loop telemetry (DESIGN.md §10, §8):
           (a) the 13 runs of ``tests/golden/host_trace_enabled.json``'s
           ``"small"`` part (16 hosts; all six protocols behind
           ``kernel_stack`` with tracing, ``kernel_bypass`` and a
           backpressuring custom host, host and tracing on a lossy
           fabric, tracing alone), each once, on ``cuda`` and ``fused``
           in turns (the card tests replay each on both), every state
           array by digest, the ledger rows and the trace's scalars
           bit-exact; (b) its ``"full"`` point — 144 hosts, 9
           racks, W3 at load 0.4, homa behind ``kernel_stack`` with
           ``TraceConfig(stride=16, ledger_cap=4096)`` — 4000 slots on
           ``cuda``, ``fused`` and ``reference``: the state identical
           key by key and equal to the JAX package's (digests,
           completions, counters), chunks conserved through the RX ring,
           completions equal to an untraced run's; then a window from
           slot 2000 with no host sync and a profiled stretch of 50 slots
           on both
           kernel backends, and the capture's cost (the wall-clock plane,
           traced vs capture off, 500 slots, best of 2); (c) four
           full-width runs (seeds 0-3) of that point, one streaming
           ``run_sweep`` batch of 2000 slots on ``fused`` and ``cuda``:
           host and trace summaries identical. The runs of (a)-(c) go to
           the worker pool at once
11. train  Mamba2-130m training at full width (random bf16 weights from a
           seed), on the plain path autograd differentiates: (a) 5 steps
           of ``build_train_step`` with remat at 16 x 2048 tokens
           (``choose_grad_accum`` gives 2), after a warm-up: finite
           losses, no hand-written kernel launched (the counters and a
           profiled step; ROADMAP C2), ms/step, tokens/s, peak memory
           and the device's busy share; (b) its grad_accum 2 and remat-off
           variants against the plain step at 4 x 512 in fp32 (the bf16
           distances printed only); (c) the reduced config's step on the
           card against the CPU's, fp32 and bf16: loss, every gradient
           leaf, the update; (d) ``python -m repro_torch.launch.train`` at
           full width in subprocesses, 12 steps of 8 x 1024 with a
           checkpoint every 5: ``--crash-at 7`` exits 17, ``--resume``
           goes on from step 5 to 12, its losses against two
           uninterrupted runs'; (e) the data-parallel step
           (``distrib.homa_collectives``) on a NCCL world of one: homa
           (64 KiB chunks, K = 7) and naive against the plain step, int8
           with a non-zero error state; chunk collectives a step

12. deepseek DeepSeek-V2-Lite-16B inference at full width (27 layers,
           d_model 2048, MLA with 16 heads, q/k 192 and v 128 wide, kv
           latent 512; the first layer dense, 26 MoE layers of 64 experts
           top-6 plus 2 shared; random bf16 weights from a seed, the
           routers fp32; 31.4 GB on the card): (a) the flash-attention
           kernel against ``attention_ref`` at MLA's shape on synthetic
           inputs and on layer 0's q, k, v of a real 4 x 4096 prefill (the
           tensor-core kernel's three q/k panels), at StableLM-12B's
           shape at 4 x 4096 (32 heads over 8 of 160, on the tensor-core
           kernel's wide design) and on edge cases (d 192 with Sq < 8,
           kv_len < Skv, a window with GQA, fp32; d 160 with a window and
           with kv_len < Skv; d 256 / dv 256 in bf16 and fp32), the
           counters showing each call's design, both full-width shapes
           timed beside ``attention_ref``, one
           ``scaled_dot_product_attention`` call and the bound; (b)
           ``forward_prefill`` of 4 x 4096 tokens on the kernel (27
           launches, all on the tensor cores, counted and seen by the
           profiler; tokens/s, peak memory, busy share, device time by
           kind) against ``use_kernel=False``, layer by layer on the same
           inputs (MLA output, the absorbed decode step, tokens whose
           top-6 expert set differs) and end to end; (c) prefill of 4095
           tokens plus one ``forward_decode`` (MoE at T = 4, C = 1)
           against the 4096-token prefill with the last tokens routed as
           the decode step routes them (``_decode_reference``); a
           profiled window of 3 decode steps; (d) the full-width serve
           of 16 requests, whose statistics must equal the JAX package's
           (``DEEPSEEK_SERVE_EXPECTED``)

13. xattn the encoder-decoder and cross-attention architectures, their
           attention on the kernel non-causal at full width: (a) the
           flash-attention kernel against ``attention_ref`` at the five
           calls of their prefills (Whisper's encoder 4 x 1500 over
           itself, decoder self 4 x 448 causal, cross 448 over 1500
           frames; Vision's self 2 x 4096 causal and cross 4096 over 6400
           image tokens with 64 heads over 8), every call on the tensor
           cores, each timed beside ``attention_ref``, one
           ``scaled_dot_product_attention`` call and the bound; (b)
           Whisper-small whole (12 encoder and 12 decoder layers; random
           bf16 weights and frame embeddings from a seed):
           ``forward_prefill`` of 4 x 448 tokens over 4 x 1500 frames on
           the kernel (36 launches, counted by shape and seen by the
           profiler; tokens/s, peak memory, busy share, device time by
           kind) against ``use_kernel=False`` layer by layer on the same
           inputs (every attention output, the encoder's output) and end
           to end, prefill of 447 tokens plus one ``forward_decode``
           against the 448-token prefill, a profiled window of 3 decode
           steps; (c) the same for Llama-3.2-Vision-90B at full width cut
           to one block (5 layers, layer 4 cross), 2 x 4096 tokens over 2
           x 6400 image embeddings (5 launches a prefill)
14. dryrun the dry run (``repro_torch.launch.dryrun``; no kernel): (a)
           ``whisper-small x decode_32k`` on the fake 16 x 16 and 2 x 16
           x 16 meshes and ``llama3.2-3b x prefill_32k`` on 16 x 16,
           one subprocess each, each ``ok`` with the JAX package's test
           assertions, their per-device arguments, temp, peak, TFLOP and
           collective bytes printed; (b) its memory model against the
           card: Llama-3.2-3B's plain prefill of 4 x 4096 and Mamba2's
           train step of 16 x 2048 (grad_accum 2, remat) predicted on a
           (1, 1) fake mesh, then run on the card from random tensors of
           the same shapes and dtypes in a fresh process: the predicted
           argument bytes must equal the card's, and the predicted peak
           lie within 10% of ``max_memory_allocated`` after
           ``reset_peak_memory_stats``; (a)'s processes start before
           phase 12 (they run nothing on the card), (b)'s together
15. stablelm StableLM-12B whole at full width (40 layers, d_model 5120,
           32 heads over 8 KV heads of 160, d_ff 13824, vocab 100352;
           random bf16 weights from a seed, 24.3 GB on the card):
           ``forward_prefill`` of 2 x 4096 tokens on the kernel (40
           launches, all on the tensor cores' wide design, counted and
           seen by the profiler; tokens/s, peak memory, device time, busy
           share, attention's share of the device time) against the
           ``use_kernel=False`` path on the card (last-position logits and
           every layer's k/v cache, within ``STABLELM_TOL``); then
           ``repro_torch.launch.serve.main`` at full width, 8 requests,
           whose statistics must equal the JAX package's
           (``STABLELM_SERVE_EXPECTED``)

16. shard the sharded sweep (``SweepSpec(shard=True)``) over gloo worlds
           of spawned processes on the one card: (a) 6b's 12 full-width
           runs on a world of 2, every rank's streaming statistics
           identical to 6b's world of one and one ``fused_slot_batch``
           launch a slot on each rank; (b) 6a's mega cell on a world of 5
           (12 runs a protocol padded to 15, six protocols), pooled
           histograms and completions identical to 6a's; (c) 6b's runs on
           the world of 5 too, and runs*slots/s by world size (1, 2, 5)
           with the card's name and power limit. Then
           ``examples/torch_homa_network_sim.py``,
           ``examples/torch_fabric_incast.py`` and
           ``scripts/torch_export_trace.py`` on the card (staged ``cuda``
           backend, its launches counted) against the same calls on the
           CPU: identical printed tables and trace JSON; these six runs are
           queued on the worker pool before phase 9. It runs after phase
           10, while the pool is open

``--phases card,deepseek`` (any comma-separated subset of card, kernels,
goldens, full, window, sweep, model, llama, faults, host, train,
deepseek, xattn, dryrun, stablelm, shard) runs only those phases and
prints no result lines; with no arguments every phase runs.

Then one JSON line with each kernel's numbers, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PROTOCOLS = ("homa", "basic", "phost", "pias", "pfabric", "ndp")
FULL = dict(workload="W3", load=0.8, n_messages=8000, seed=0, n_hosts=144,
            racks=9, oversub=1.0, ring_cap=1024, up_cap=512,
            max_slots=12000)
PLAIN_SLOTS = 5000               # phase 4's plain run stops here
SWEEP_LOADS, SWEEP_SEEDS = (0.5, 0.7, 0.8), (0, 1, 2, 3)
SWEEP_SLOTS = 3000               # phase 6b's depth
# per run at the main path's shapes (K = 7 for W3's allocation)
MAIN_FUSED = dict(H=144, cap=1024, U=144, ucap=512, M=8000, K=7)
# phase 7's serve and its statistics, computed with the JAX package's
# ``repro.launch.serve.main`` on the CPU with ``["--arch", "mamba2-130m",
# "--smoke", *SERVE_ARGV]`` (they depend only on the scheduler:
# ``decode_fn`` answers from each request's remaining budget);
# tests/test_torch_serve.py checks both packages against them
SERVE_ARGV = ["--requests", "64", "--batch-size", "4"]
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
MODEL = dict(arch="mamba2-130m", batch=4, seq=4096, seed=0)
# SSD kernel vs ssd_ref, elementwise |got - want| <= atol + rtol |want|:
# fp32 throughout, the chunked and the sequential forms differ only in
# summation order (~1e-4 absolute at |y| ~ 90, measured on the CPU)
SSD_TOL = dict(atol=1e-3, rtol=1e-3)
# relative RMS error ||got - want|| / ||want|| of the full-width model.
# Layer by layer on the same bf16 input, kernel and plain SSD give
# mixer outputs within ~4e-4 (24 layers, d_model 256, on the CPU); end to
# end, each flipped bf16 rounding is carried and amplified through the 24
# residual layers of a random-weight model (8% on the last-token logits
# at d_model 256), so the end-to-end bounds only catch gross faults
MODEL_TOL = dict(layer=2e-3, logits=0.35, decode_layer=5e-2,
                 decode_logits=0.35)
LLAMA = dict(arch="llama3.2-3b", batch=4, seq=4096, seed=0)
TC_BF16_FLOP_PER_S = 989e12      # H100 SXM, dense bf16 tensor cores
# instantiations of flash_attention_tc_kernel in csrc/attention.cu: the
# narrow design's six (DP 1-3 x DVP 1-2), the wide design's three
TC_ATTN_INSTANCES = 9
# flash-attention kernel vs attention_ref, elementwise |got - want| <=
# tol + tol |want|: the JAX package's own tolerances for its kernel vs
# oracle (tests/test_kernels.py), fp32 arithmetic in both
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# and, per case, the relative RMS error ||got - want|| / ||want|| over the
# whole output ("rms") and over the worst query row ("row"): at 4 x 4096
# the later rows' outputs are small (RMS ~0.03), so the elementwise atol
# alone would pass a kernel that drops or double-counts a K tile there
# (a relative error of ~0.1 on those rows). Each is ~4x the largest
# value over this phase's cases on an H100 (NVIDIA H100 80GB HBM3,
# 700.00 W): bf16 rel RMS 7.0e-5, worst row 2.5e-3 (the output's own
# rounding to bf16 is 1.6e-3 rel RMS: kernel and attention_ref round the
# same fp32 values, so few roundings flip); fp32 4.6e-7 and 1.9e-6
ATTN_RMS_TOL = {"float32": dict(rms=2e-6, row=8e-6),
                "bfloat16": dict(rms=3e-4, row=1e-2)}
# relative RMS error of the kernel path against the plain path
# (blockwise_attention, which rounds p to bf16 before p.V), measured on
# the CPU with the kernel's plain version by ``python
# tests/test_torch_llama.py``: attention output 2.8e-3 layer by layer
# (reduced config, and 28 layers at d_model 256); one decode step
# against the prefill's last row 3.0e-3; last-token logits 1.8e-2 end to
# end and prefill + decode 1.7e-2 (28 layers, d_model 256, S 512)
LLAMA_TOL = dict(layer=1e-2, decode_layer=1e-2, logits=5e-2,
                 decode_logits=5e-2)
SERVE_EXPECTED = {"served": 64, "steps": 747,
                  "mean_slowdown": 1.3890566225810979,
                  "p99_slowdown": 4.0776315789473685}
DEEPSEEK = dict(arch="deepseek-v2-lite-16b", batch=4, seq=4096, seed=0)
# StableLM-12B's prefill attention at 4 x 4096 (32 heads over 8 KV heads
# of 160): the tensor-core kernel's wide design (dv above 128)
STABLELM_ATTN = dict(batch=4, seq=4096, heads=32, kv_heads=8, head_dim=160)
# relative RMS error of DeepSeek's kernel path against the plain path,
# measured on the CPU with the kernel's plain version by ``python
# tests/test_torch_mla.py --kernel-path`` (``deep_config``: the full
# depth, head widths and routing at d_model 256, 4 x 512 tokens, 6
# seeds): MLA output layer by layer 2.7e-3, the absorbed decode step
# against the prefill's last row 3.1e-3; last-token logits end to end
# 0.115, where a token's top-6 expert set differs between the two paths
# in ~0.6% of the routings (a flip a layer moves that token's output
# wholesale, and 26 MoE layers carry it on); prefill(S-1) + decode 0.128
# against the S-token prefill with the last tokens routed as the decode
# step routes them (``_decode_reference``) — against the plain S-token
# prefill 0.37, since the decode step's 4 tokens meet C = 1 (an expert
# two of them pick keeps only the first), where the prefill (C 240 there,
# 1920 on the card) keeps them all, exactly as the JAX package routes.
# Each bound ~4x its measurement.
DEEPSEEK_TOL = dict(layer=1e-2, decode_layer=1e-2, logits=0.45,
                    decode_logits=0.5)
# phase 12's serve: 16 requests, not 64 — a full-width DeepSeek decode
# step takes ~81 ms of device time (its fp32 expert weight casts and
# GEMVs), so 747 steps would not fit the phase's budget. Its statistics,
# computed with the JAX package's ``repro.launch.serve.main`` on the CPU
# with ``["--arch", "deepseek-v2-lite-16b", "--smoke",
# *DEEPSEEK_SERVE_ARGV]``; tests/test_torch_serve.py checks both packages
# against them
DEEPSEEK_SERVE_ARGV = ["--requests", "16", "--batch-size", "4"]
DEEPSEEK_SERVE_EXPECTED = {"served": 16, "steps": 273,
                           "mean_slowdown": 0.9924048920419063,
                           "p99_slowdown": 1.6403449502133713}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, *, batch: int = 100, reps: int = 15,
            warmup: int = 10) -> float:
    """Median over ``reps`` of the per-call time of ``batch`` back-to-back
    calls, between CUDA events on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


# ------------------------------------------------------------- phase 1 -----

def phase_card():
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.kernels.arbiter import build as arbiter_build
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(smi)
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the model's fp32 products must run in fp32")
    libs = (arbiter_build.LIBRARY, ssd_kernel.LIBRARY, attn_kernel.LIBRARY)

    def timed(lib):
        t0 = time.perf_counter()
        lib.load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per library
        secs = list(pool.map(timed, libs))
    for lib, dt in zip(libs, secs):
        say(f"[card] built {lib.library_path()} in {dt:.2f} s")
        for line in lib.build_log().splitlines():
            if "spill" in line or "ptxas" in line and (
                    "registers" in line or "Compiling" in line
                    or "Performance Loss" in line):
                say(f"[card]   {line.strip()}")
    # every instantiation of the tensor-core attention kernel: no spill,
    # and no wgmma serialized (C7512/C7514) for want of registers
    log = attn_kernel.LIBRARY.build_log()
    spills = {fn: sp for fn, sp in _ptxas_spills(log).items()
              if "flash_attention_tc_kernel" in fn}
    loss = [line for line in log.splitlines() if "Performance Loss" in line
            and "flash_attention_tc_kernel" in line]
    check(len(spills) == TC_ATTN_INSTANCES
          and all(sp == (0, 0) for sp in spills.values()) and not loss,
          f"flash_attention_tc_kernel: spills {spills} over "
          f"{TC_ATTN_INSTANCES} instantiations, ptxas notes {loss}")
    say(f"[card] flash_attention_tc_kernel: {len(spills)} instantiations, "
        f"no spill, no serialized wgmma")
    return smi


def _ptxas_spills(log: str) -> dict:
    """{function: (spill store bytes, spill load bytes)} from the
    ``-Xptxas=-v`` lines of a build log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            out[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return out


# ------------------------------------------------------------- phase 2 -----

def _arb_inputs(rng, H, cap, *, n_prios=8, p_elig=0.5, seq_hi=20000):
    import numpy as np
    import torch
    prio = rng.integers(0, n_prios, (H, cap)).astype(np.int32)
    seq = rng.integers(0, seq_hi, (H, cap)).astype(np.int32)
    elig = rng.random((H, cap)) < p_elig
    dev = DEVICE
    return (torch.from_numpy(prio).to(dev), torch.from_numpy(seq).to(dev),
            torch.from_numpy(elig).to(dev))


def _ring_inputs(rng, B, R, cap, n, *, p_valid=0.3, p_ok=0.9, hot=None):
    """Rings (B, R, cap) and items (B, n) as the fabric passes them to
    ``ring_insert``: not-ok items on the sentinel row R, ``seq`` one slot
    number expanded; ``hot`` draws the rows from the first ``hot``."""
    import numpy as np
    import torch

    def dev(a):
        return torch.from_numpy(a).to(DEVICE)
    rings = [dev(rng.integers(0, 1 << 20, (B, R, cap)).astype(np.int32))
             for _ in range(3)]
    valid = dev(rng.random((B, R, cap)) < p_valid)
    ok = rng.random((B, n)) < p_ok
    row = np.where(ok, rng.integers(0, hot or R, (B, n)), R)
    items = [dev(row.astype(np.int32)), dev(ok)] + [
        dev(rng.integers(0, 8000, (B, n)).astype(np.int32))
        for _ in range(2)]
    seq = torch.full((), 4321, dtype=torch.int32, device=DEVICE)
    return (*rings, valid, *items, seq.expand(B, n))


# (B, R, cap, n) of the benchmark cells' inserts: downlinks and uplinks
RING_SHAPES = ((320, 144, 1024, 144), (320, 144, 512, 144))


def _topk_keys(rng, H, M, *, p_pos=0.05, hi=1 << 30):
    """Grant-matrix-like keys: mostly 0 (ineligible), some positive keys
    with duplicates."""
    import numpy as np
    import torch
    keys = np.where(rng.random((H, M)) < p_pos,
                    rng.integers(1, hi, (H, M)), 0).astype(np.int32)
    return torch.from_numpy(keys).to(DEVICE)


def _arb_cases(rng):
    import torch
    from repro_torch.kernels.arbiter.ref import BIG
    cases = {}
    for name, (H, cap) in {"down 144x1024": (144, 1024),
                           "up 144x512": (144, 512),
                           "B=12 down 1728x1024": (1728, 1024),
                           "B=12 up 1728x512": (1728, 512),
                           "ragged 13x1000": (13, 1000),
                           "ragged 5x33": (5, 33)}.items():
        cases[name] = _arb_inputs(rng, H, cap)
    for H, cap in ((8, 1027), (144, 1024), (6, 1)):
        for offset in (0, 1, 3):
            cases[f"edge rows {H}x{cap} at +{offset} columns"] = \
                _arb_edge_inputs(rng, H, cap, offset)
    # the ring state as the simulator holds it: empty slots carry BIG
    p, s, e = _arb_inputs(rng, 144, 1024, p_elig=0.02)
    cases["sparse with BIG slots"] = (torch.where(e, p, BIG),
                                      torch.where(e, s, BIG), e)
    p, s, e = _arb_inputs(rng, 144, 1024)
    e[::3] = False                                   # all-ineligible rows
    cases["empty rows"] = (p, s, e)
    p, s, e = _arb_inputs(rng, 144, 1024, n_prios=1, seq_hi=2)
    cases["duplicate (prio, seq) ties"] = (p, s, e)
    p = torch.zeros((16, 700), dtype=torch.int32, device=DEVICE)
    cases["all equal, all eligible"] = (p, p.clone(),
                                        torch.ones_like(p, dtype=torch.bool))
    return cases


def _arb_edge_inputs(rng, H, cap, offset=0):
    """Rings that reach every branch of the row routine (H >= 6 rows):
    negative values and eligible (BIG, BIG) entries; row 0 empty; row 1 a
    tie at columns of different threads and warps; row 2 a winner with
    seq BIG (the plain version answers column 0); row 3 a winner with seq
    above BIG after an entry of its prio with a larger seq; row 4 every
    entry (INT_MAX, INT_MAX). Row 1's lowest tied column lies in a later
    warp than a higher one. Each operand starts ``offset`` columns past
    its 16-byte boundary (a scalar head and tail in every row)."""
    import numpy as np
    import torch
    from repro_torch.kernels.arbiter.ref import BIG
    prio = rng.integers(-3, 8, (H, cap)).astype(np.int64)
    seq = rng.integers(-50, 20000, (H, cap)).astype(np.int64)
    elig = rng.random((H, cap)) < 0.5
    prio[:, ::5], seq[:, ::5], elig[:, ::5] = BIG, BIG, True
    elig[0] = False
    cols = [c for c in (130, 200, 600, 1025, cap - 1) if c < cap]
    prio[1, cols], seq[1, cols], elig[1, cols] = -4, -60, True
    w = cap // 2
    prio[2] = np.maximum(prio[2], 0)
    prio[2, w], seq[2, w], elig[2, w] = -5, BIG, True
    prio[3, w], seq[3, w], elig[3, w] = -5, BIG + 7, True
    prio[3, 0], seq[3, 0], elig[3, 0] = -5, BIG + 9, True
    prio[4], seq[4], elig[4] = 2 ** 31 - 1, 2 ** 31 - 1, True
    out = []
    for a in (prio.astype(np.int32), seq.astype(np.int32), elig):
        t = torch.from_numpy(a).to(DEVICE)
        buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=DEVICE)
        v = buf[offset:offset + t.numel()].view(t.shape)
        v.copy_(t)
        out.append(v)
    return tuple(out)


def _arb_launch(lib, args, out, nt, g):
    """The staged arbiter's library entry at a layout (nt threads a row,
    g rows a block; nt 0: the earlier scalar kernel), uncounted."""
    import torch
    H, cap = args[0].shape
    rc = lib.arbiter_priority_launch(
        *(t.data_ptr() for t in (*args, *out)), H, cap, nt, g,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"arbiter layout {nt} x {g} launch failed ({rc})")


def _arb_name(nt, g) -> str:
    """The profiler's name of the staged arbiter at a layout, spaces
    removed."""
    return ("priority_arbiter_scalar_kernel" if nt == 0
            else f"priority_arbiter_kernel<{nt},{g}>")


def _fused_launch(lib, d, u, keys, K, B, scalar_rows):
    """One fused launch through the library (uncounted), on the arbiter's
    new row routine or (``scalar_rows``) the earlier scalar one: for
    timing the two."""
    import torch
    lead = (B,)
    bufs, args = [], []
    for st in (d, u):
        R = st[0].shape[-2]
        bp = torch.empty(lead + (R,), dtype=torch.int32, device=DEVICE)
        bi = torch.empty_like(bp)
        bufs += [bp, bi]
        args += [t.data_ptr() for t in (*st, bp, bi)] + list(st[0].shape[-2:])
    H2, M = keys.shape[-2:]
    vals = torch.empty(lead + (H2, K), dtype=torch.int32, device=DEVICE)
    idx = torch.empty_like(vals)
    args += [keys.data_ptr(), vals.data_ptr(), idx.data_ptr(), H2, M, K]

    outs = (*bufs, vals, idx)     # alive as long as the call

    def call():
        rc = lib.arbiter_fused_launch(
            *args, 8, B, int(scalar_rows),
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0 and len(outs) == 6, f"fused launch failed ({rc})")
    return call


def _topk_cases(rng):
    import torch
    from repro_torch.kernels.arbiter.ref import NEG
    cases = {}
    for K in (1, 7):
        cases[f"grant 144x8000 K={K}"] = (_topk_keys(rng, 144, 8000), K)
    cases["ties 144x8000 K=7"] = (_topk_keys(rng, 144, 8000, hi=3), 7)
    cases["dense 144x8000 K=7"] = (_topk_keys(rng, 144, 8000, p_pos=1.0), 7)
    cases["ragged 13x1000 K=7"] = (_topk_keys(rng, 13, 1000, p_pos=0.3), 7)
    cases["all zero 8x300 K=4"] = (
        torch.zeros((8, 300), dtype=torch.int32, device=DEVICE), 4)
    small = torch.tensor([[5, 0, 5], [0, 0, 0], [NEG, 3, 0], [NEG, NEG, NEG],
                          [1, 2, 3]], dtype=torch.int32, device=DEVICE)
    cases["M<K zeros and NEG 5x3 K=7"] = (small, 7)
    cases["M<K 4x1 K=2"] = (_topk_keys(rng, 4, 1, p_pos=0.5), 2)
    cases["ties across threads and warps 144x8000 K=7"] = (
        _boundary_ties(rng, 144, 8000), 7)
    cases["keys below NEG, M<K 6x5 K=7"] = (_below_neg_keys(rng, 6, 5), 7)
    for K in (8, 9):     # the one-pass cap, and past it
        cases[f"ties 16x1000 K={K}"] = (_topk_keys(rng, 16, 1000, p_pos=0.5,
                                                   hi=6), K)
    return cases


def _below_neg_keys(rng, H, M, lead=()):
    """Keys drawn from 0, 1, 5, NEG and the values below it: with K > M
    the padding ranks between the row's keys of NEG and those below."""
    import numpy as np
    import torch
    from repro_torch.kernels.arbiter.ref import NEG
    pool = np.array([-(1 << 31), -(1 << 31) + 1, NEG - 1, NEG, 0, 1, 5],
                    np.int32)
    keys = pool[rng.integers(0, len(pool), lead + (H, M))]
    return torch.from_numpy(keys).to(DEVICE)


def _boundary_ties(rng, H, M):
    """Grant-like keys whose 8 largest entries per row are equal and fall
    at columns read by different threads, warps and load batches of the
    one-pass routine: only the tie rule orders them."""
    keys = _topk_keys(rng, H, M, hi=1 << 20)
    cols = [4 * 31 + 3, 4 * 32, 4 * 255 + 3, 4 * 256, 4 * 257 + 1, 4000,
            M - 5, M - 1]
    keys[:, cols] = 1 << 21
    return keys


def _fused_bytes(H, cap, U, ucap, M, K) -> int:
    """Bytes one run's fused slot must move: both rings' prio, seq and
    elig (9 B a slot) and the keys read once, the winners and the top-K
    written once."""
    return 9 * (H * cap + U * ucap) + 4 * H * M + 8 * (H + U) + 8 * H * K


def _fused_inputs(rng, stages, B, H, cap, U, ucap, M, K):
    """Operands of the present stages (a leading run axis when ``B`` is
    given), as the loop gives them: BIG in empty ring slots, ring row 0
    of each run all-ineligible, grant keys mostly 0 with row 1 empty."""
    import numpy as np
    import torch
    from repro_torch.kernels.arbiter.ref import BIG
    lead = () if B is None else (B,)

    def ring(R, C):
        prio = rng.integers(0, 8, lead + (R, C)).astype(np.int32)
        seq = rng.integers(0, 20000, lead + (R, C)).astype(np.int32)
        elig = rng.random(lead + (R, C)) < 0.3
        elig[..., 0, :] = False
        prio = np.where(elig | (rng.random(elig.shape) < 0.5), prio, BIG)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                     for a in (prio.astype(np.int32), seq, elig))

    down = ring(H, cap) if "down" in stages else None
    up = ring(U, ucap) if "up" in stages else None
    keys = None
    if "topk" in stages:
        k = np.where(rng.random(lead + (H, M)) < 0.05,
                     rng.integers(1, 1 << 30, lead + (H, M)), 0)
        k[..., 1, :] = 0
        keys = torch.from_numpy(k.astype(np.int32)).to(DEVICE)
    return down, up, keys


def _fused_cases(rng):
    """name -> (wrapper name, (down, up, keys), K)."""
    import torch
    from repro_torch.kernels.arbiter.ref import NEG
    f = MAIN_FUSED
    subsets = ("down", "up", "topk", "down,up", "down,topk", "up,topk",
               "down,up,topk")
    cases = {}
    for stages in subsets:
        for B in (None, 1, 4, 12):
            fn = "fused_slot" if B is None else "fused_slot_batch"
            args = _fused_inputs(rng, stages, B, f["H"], f["cap"], f["U"],
                                 f["ucap"], f["M"], f["K"])
            cases[f"{stages} main shapes B={B or 1}"] = (fn, args, f["K"])
    for B in (None, 4):
        fn = "fused_slot" if B is None else "fused_slot_batch"
        cases[f"ragged 13x100, 9x1, 13x37 K=4 B={B or 1}"] = (
            fn, _fused_inputs(rng, "down,up,topk", B, 13, 100, 9, 1, 37, 4),
            4)
        # one host per rack: as many uplink rows as hosts, few eligible
        cases[f"single-host racks 8x256, 8x32 B={B or 1}"] = (
            fn, _fused_inputs(rng, "down,up", B, 8, 256, 8, 32, 300, 7), 7)
        d, u, keys = _fused_inputs(rng, "down,topk", B, 8, 64, 8, 8, 3, 7)
        keys[..., 2, 0] = NEG                 # M < K with NEG keys
        cases[f"M<K with NEG 8x3 K=7 B={B or 1}"] = (fn, (d, u, keys), 7)
        d, u, keys = _fused_inputs(rng, "topk", B, 6, 8, 4, 8, 40, 9)
        cases[f"K above eligible 6x40 K=9 B={B or 1}"] = (fn, (d, u, keys),
                                                          9)
        # K past the one-pass cap: the rounds routine
        cases[f"rounds route 16x256, 16x128, 16x1000 K=9 B={B or 1}"] = (
            fn, _fused_inputs(rng, "down,up,topk", B, 16, 256, 16, 128, 1000,
                              9), 9)
        lead = () if B is None else (B,)
        for K in (7, 9):     # both routines, raw
            cases[f"keys below NEG, M<K 6x5 K={K} B={B or 1}"] = (
                fn, (None, None, _below_neg_keys(rng, 6, 5, lead)), K)
    empty = torch.zeros((3, 16, 500), dtype=torch.int32, device=DEVICE)
    none = torch.zeros((3, 16, 500), dtype=torch.bool, device=DEVICE)
    cases["all-ineligible, empty grant sets B=3"] = (
        "fused_slot_batch", ((empty, empty, none), (empty, empty, none),
                             empty.clone()), 5)
    # only the top-K rows carry work: every ring row empty
    d, u, keys = _fused_inputs(rng, "down,up,topk", 12, f["H"], f["cap"],
                               f["U"], f["ucap"], f["M"], f["K"])
    cases["empty rings, main shapes B=12"] = (
        "fused_slot_batch", (tuple(t.zero_() if t.dtype == torch.bool else t
                                   for t in d),
                             tuple(t.zero_() if t.dtype == torch.bool else t
                                   for t in u), keys), f["K"])
    return cases


def _max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _route_of(wrapper, rounds_before, K) -> str:
    """The top-K routine the wrapper's last launch took, checked against
    its rule: the one-pass routine up to the largest cap, else rounds."""
    from repro_torch.kernels.arbiter import kernel
    took = wrapper.launches_rounds - rounds_before
    want = int(kernel.topk_cap(K) == 0)
    check(took == want, f"{wrapper.__name__} K={K}: {took} launches on the "
                        f"rounds routine, expected {want}")
    return "rounds" if took else f"one pass, cap {kernel.topk_cap(K)}"


def _device_ms(fn, name=None, n=50) -> float:
    """Device time per call of ``fn`` from the profiler, in ms: of the one
    kernel whose name holds ``name`` (launched once a call), or of every
    kernel the call runs. Every launch must be recorded. The trace is
    kept idle for a moment before the first launch and after the last:
    without that, some windows lost launches (and the window opens with
    its markers, :func:`_window`)."""
    for _ in range(5):
        fn()

    def calls():
        for _ in range(n):
            fn()
    _, _, prof = _window(calls)
    kern = _device_events(prof)
    if name is not None:
        kern = [e for e in kern if name in e[0]]
        check(len(kern) == 1 and kern[0][1] == n,
              f"profiler: {[e[:2] for e in kern]} for {name}, "
              f"expected one kernel launched {n} times")
    check(all(e[1] % n == 0 for e in kern),
          f"profiler: {[e[:2] for e in kern]}: a launch of "
          f"{name or fn} was not recorded")
    us = sum(e[2] for e in kern) / n
    check(us > 0, f"profiler shows no device time for {name or fn}")
    return us / 1e3


def _device_ms_each(calls: dict, n=50) -> dict:
    """Device time per call, in ms, of several calls timed in turns in
    one profiler window (:func:`_window`): ``calls`` maps a label to (fn,
    the name of the one kernel fn launches, spaces removed); each must be
    recorded n times."""
    for fn, _ in calls.values():
        for _ in range(5):
            fn()

    def turns():
        for _ in range(n):
            for fn, _ in calls.values():
                fn()
    _, _, prof = _window(turns)
    kern = _device_events(prof)
    out = {}
    for label, (_, name) in calls.items():
        hits = [e for e in kern if name in e[0].replace(" ", "")]
        check(len(hits) == 1 and hits[0][1] == n,
              f"profiler: {[(e[0][:80], e[1]) for e in kern]}: "
              f"expected {name} launched {n} times")
        out[label] = hits[0][2] / n / 1e3
    return out


ARB_SHAPES = ((144, 1024), (144, 512), (1728, 1024), (1728, 512))


def _arb_times(lib, rng) -> dict:
    """At each of ARB_SHAPES (B = 1's down and up rings, the B = 12
    staged sweep's), the staged arbiter's device time per launch at every
    layout and the earlier scalar kernel, in turns in one profiler window,
    with the
    launch floor (a ``zero_()`` of 144 int32) in the first; then
    ``torch.argmin`` of the packed key (the yardstick) and the byte
    bound."""
    import torch
    from repro_torch.kernels.arbiter import kernel
    from repro_torch.kernels.arbiter.ref import BIG
    zero = torch.zeros(144, dtype=torch.int32, device=DEVICE)
    out = {}
    for H, cap in ARB_SHAPES:
        args = _arb_inputs(rng, H, cap)
        res = tuple(torch.empty(H, dtype=torch.int32, device=DEVICE)
                    for _ in range(2))
        calls = {(f"{nt}x{g}" if nt else "scalar"):
                 (lambda nt=nt, g=g: _arb_launch(lib, args, res, nt, g),
                  _arb_name(nt, g))
                 for nt, g in ((0, 1),) + kernel.ARB_LAYOUTS}
        if not out:
            calls["floor"] = (zero.zero_, "FillFunctor")
        t = _device_ms_each(calls)
        p, s, e = args
        key = torch.where(e, (p.long() << 32) | s.long(), (BIG << 32) | BIG)
        t["argmin"] = _device_ms(lambda: torch.argmin(key, dim=1))
        t["bound_ms"] = (H * cap * 9 + 2 * H * 4) / HBM_BYTES_PER_S * 1e3
        t["rule"] = "{}x{}".format(*kernel.ARB_LAYOUT)
        out[f"{H}x{cap}"] = t
        say(f"[kernels] priority_arbiter {H}x{cap} device ms/launch: "
            + ", ".join(f"{k} {v!r}" for k, v in t.items()))
    return out


def phase_kernels():
    import numpy as np
    import torch
    from repro_torch.kernels.arbiter import build, kernel
    from repro_torch.kernels.arbiter.ref import (BIG, fused_slot_ref,
                                                 priority_arbiter_ref,
                                                 ring_insert_ref,
                                                 srpt_topk_ref)
    rng = np.random.default_rng(0)
    err = {"priority_arbiter": 0, "srpt_topk": 0}
    for name, (p, s, e) in _arb_cases(rng).items():
        got = kernel.priority_arbiter(p, s, e)
        want = priority_arbiter_ref(p, s, e)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"priority_arbiter differs: {name}")
            err["priority_arbiter"] = max(err["priority_arbiter"],
                                          _max_err(g, w))
        say(f"[kernels] priority_arbiter == plain: {name}")
    # every layout of the staged kernel, and the earlier scalar kernel on the
    # Pallas kernel's contract: the designs phase 2 times below
    lib = build.load_library()
    for H, cap in ARB_SHAPES + ((8, 1027),):
        ins = {"random": _arb_inputs(rng, H, cap)}
        if H >= 6:
            ins["edge rows"] = _arb_edge_inputs(rng, H, cap, 1)
        for what, args in ins.items():
            want = priority_arbiter_ref(*args)
            for nt, g in ((0, 1),) + kernel.ARB_LAYOUTS:
                if nt == 0 and what == "edge rows":
                    continue
                out = tuple(torch.empty(H, dtype=torch.int32, device=DEVICE)
                            for _ in range(2))
                _arb_launch(lib, args, out, nt, g)
                torch.cuda.synchronize()
                check(all(torch.equal(o, w) for o, w in zip(out, want)),
                      f"priority_arbiter layout {nt} x {g} differs: {what} "
                      f"{H}x{cap}")
        say(f"[kernels] priority_arbiter layouts {kernel.ARB_LAYOUTS} and "
            f"the earlier scalar kernel == plain: {H}x{cap}, random and edge "
            f"rows")
    for name, (keys, K) in _topk_cases(rng).items():
        rounds = kernel.srpt_topk.launches_rounds
        got = kernel.srpt_topk(keys, K)
        want = srpt_topk_ref(keys, K)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"srpt_topk differs: {name}")
            err["srpt_topk"] = max(err["srpt_topk"], _max_err(g, w))
        route = _route_of(kernel.srpt_topk, rounds, K)
        say(f"[kernels] srpt_topk == plain ({route}): {name}")

    # the ring insert, in place, at the cells' shapes and fills and at
    # edge shapes
    err["ring_insert"] = 0
    ring_cases = (RING_SHAPES[0] + (0.1, 0.3, None),
                  RING_SHAPES[1] + (0.5, 0.9, None),
                  (480, 144, 1024, 144, 0.99, 1.0, None),   # rows fill up
                  (3, 5, 100, 70, 0.3, 1.0, 2),     # rows off 16-byte marks
                  (2, 4, 1500, 90, 0.99, 1.0, 1))   # three passes a row
    for B, R, cap, n, p_valid, p_ok, hot in ring_cases:
        args = _ring_inputs(rng, B, R, cap, n, p_valid=p_valid, p_ok=p_ok,
                            hot=hot)
        want = ring_insert_ref(*args)
        got = kernel.ring_insert(*(t.clone() for t in args[:4]), *args[4:])
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"ring_insert differs: {B}x{R}x{cap}, "
                  f"{n} items, fill {p_valid}")
            err["ring_insert"] = max(err["ring_insert"], _max_err(g, w))
        say(f"[kernels] ring_insert == plain: ({B}, {R}, {cap}), {n} items, "
            f"fill {p_valid}, dropped {int(want[4].sum())}")

    err["fused_slot"] = err["fused_slot_batch"] = 0
    for name, (fn, args, K) in _fused_cases(rng).items():
        wrapper = getattr(kernel, fn)
        rounds = wrapper.launches_rounds
        got = wrapper(*args, K=K)
        want = fused_slot_ref(*args, K=K)
        torch.cuda.synchronize()
        check(len(got) == len(want), f"{fn} output count: {name}")
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"{fn} differs: {name}")
            err[fn] = max(err[fn], _max_err(g, w))
        route = (_route_of(wrapper, rounds, K) if args[2] is not None
                 else "no top-K")
        say(f"[kernels] {fn} == plain ({route}): {name}")

    # times at the main path's shapes (inputs stay in L2, as in the loop,
    # where the preceding operations have just written them)
    perf = {}
    p, s, e = _arb_inputs(rng, 144, 1024)
    up = _arb_inputs(rng, 144, 512)
    H, cap = p.shape
    # the library yardstick: argmin of (prio, seq) packed beforehand into
    # one int64 (the packing not counted); argmin's first minimum is the
    # tie rule, and it gives the same winner on these inputs
    key = torch.where(e, (p.long() << 32) | s.long(), (BIG << 32) | BIG)
    perf["priority_arbiter"] = dict(
        shape=f"({H}, {cap}) int32 x2 + bool",
        ms=time_ms(lambda: kernel.priority_arbiter(p, s, e)),
        plain_ms=time_ms(lambda: priority_arbiter_ref(p, s, e)),
        library_ms=time_ms(lambda: torch.argmin(key, dim=1)),
        bound_ms=(H * cap * 9 + 2 * H * 4) / HBM_BYTES_PER_S * 1e3,
        up_ms=time_ms(lambda: kernel.priority_arbiter(*up)),
        up_plain_ms=time_ms(lambda: priority_arbiter_ref(*up)),
        up_bound_ms=(144 * 512 * 9 + 2 * 144 * 4) / HBM_BYTES_PER_S * 1e3,
        by_shape=_arb_times(lib, rng))
    main = perf["priority_arbiter"]["by_shape"]["{}x{}".format(
        *ARB_SHAPES[0])]
    perf["priority_arbiter"].update(floor_ms=main["floor"],
                                    library_device_ms=main["argmin"])
    keys = _topk_keys(rng, 144, 8000, p_pos=0.01)
    K = 7
    H, M = keys.shape
    perf["srpt_topk"] = dict(
        shape=f"({H}, {M}) int32, K={K}",
        ms=time_ms(lambda: kernel.srpt_topk(keys, K)),
        plain_ms=time_ms(lambda: srpt_topk_ref(keys, K)),
        library_ms=time_ms(lambda: torch.topk(keys, K, dim=1)),
        bound_ms=(H * M * 4 + 2 * H * K * 4) / HBM_BYTES_PER_S * 1e3,
        device_ms=_device_ms(lambda: kernel.srpt_topk(keys, K),
                             "srpt_topk_kernel"),
        # another function (ties unspecified), and the plain version's
        # stable sort, both as device time per call
        library_device_ms=_device_ms(lambda: torch.topk(keys, K, dim=1)),
        sort_device_ms=_device_ms(lambda: torch.sort(keys, dim=1,
                                                     descending=True,
                                                     stable=True)))
    perf["priority_arbiter"]["device_ms"] = _device_ms(
        lambda: kernel.priority_arbiter(p, s, e), "priority_arbiter_kernel")
    perf["priority_arbiter"]["up_device_ms"] = _device_ms(
        lambda: kernel.priority_arbiter(*up), "priority_arbiter_kernel")
    f = MAIN_FUSED
    for fn, B in (("fused_slot", None), ("fused_slot_batch", 12)):
        d, u, keys = _fused_inputs(rng, "down,up,topk", B, f["H"], f["cap"],
                                   f["U"], f["ucap"], f["M"], f["K"])
        run = getattr(kernel, fn)
        nb = 1 if B is None else B
        perf[fn] = dict(
            shape=f"B={nb}: down ({f['H']}, {f['cap']}), up ({f['U']}, "
                  f"{f['ucap']}), keys ({f['H']}, {f['M']}), K={f['K']}",
            ms=time_ms(lambda: run(d, u, keys, K=f["K"])),
            plain_ms=time_ms(lambda: fused_slot_ref(d, u, keys, K=f["K"]),
                             batch=20),
            library_ms=None,
            bound_ms=nb * _fused_bytes(**f) / HBM_BYTES_PER_S * 1e3,
            device_ms=_device_ms(lambda: run(d, u, keys, K=f["K"]),
                                 "fused_slot_kernel"))
        # the ring rows on the new routine and on the earlier scalar one,
        # in turns
        rows = _device_ms_each({
            "new": (_fused_launch(lib, d, u, keys, f["K"], nb, False),
                    "fused_slot_kernel<8,false>"),
            "scalar": (_fused_launch(lib, d, u, keys, f["K"], nb, True),
                     "fused_slot_kernel<8,true>")})
        perf[fn].update(device_ms_rows_new=rows["new"],
                        device_ms_rows_scalar=rows["scalar"])
    # the ring insert at the cells' shapes, every item ok, rings filled
    # 10% and each measurement on fresh rings (its ~100 calls fill a row
    # by about as many slots more): the least bytes are each item's row of
    # free flags read and its 13 bytes written
    for B, R, cap, n in RING_SHAPES:
        d = perf[f"ring_insert {B}x{R}x{cap}"] = dict(
            shape=f"({B}, {R}, {cap}) rings, ({B}, {n}) items",
            bound_ms=B * n * (cap + 13) / HBM_BYTES_PER_S * 1e3)
        for key, fn, kw in (
                ("ms", kernel.ring_insert, dict(batch=20, reps=5, warmup=2)),
                ("plain_ms", ring_insert_ref, dict(batch=10, reps=5,
                                                   warmup=2)),
                ("device_ms", kernel.ring_insert, None)):
            args = _ring_inputs(rng, B, R, cap, n, p_valid=0.1, p_ok=1.0)
            d[key] = (time_ms(lambda: fn(*args), **kw) if kw else
                      _device_ms(lambda: fn(*args), "ring_insert_kernel"))
    for name, d in perf.items():
        say(f"[kernels] {name} {d['shape']}: "
            + ", ".join(f"{k}={v!r}" for k, v in d.items() if k != "shape"))
    return err, perf


# ------------------------------------------------------------- phase 3 -----

def _golden_run(meta, proto, fabric, backend):
    from repro_torch.core import SimConfig, make_messages, simulate
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    cfg = SimConfig(protocol=proto, n_hosts=meta["n_hosts"],
                    max_slots=meta["max_slots"], ring_cap=meta["ring_cap"],
                    fabric=fabric, backend=backend, device=DEVICE)
    return simulate(cfg, tbl)


GOLDEN_WORKERS = 7   # worker processes (8 host cores; the parent waits)
_POOL = None


def _in_workers(fn, jobs):
    """``[fn(*job) for job in jobs]``, run in the script's worker pool:
    GOLDEN_WORKERS spawned processes, started at its first use and kept
    until the script ends, so each imports torch and opens the card once.
    A replay is host-bound (one core each, device busy under 10%), so
    replays in parallel share the card well. Jobs start in the order
    given: list the longest first. A worker's exception re-raises
    here."""
    return _in_workers_each([(fn, job) for job in jobs])


def _in_workers_each(calls):
    """``[fn(*args) for fn, args in calls]`` in the worker pool."""
    return [f.result() for f in _submit_each(calls)]


def _submit_each(calls):
    """Futures of ``fn(*args)`` for ``calls``, queued on the worker pool
    (started here at its first use)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    global _POOL
    if _POOL is None:
        _POOL = ProcessPoolExecutor(GOLDEN_WORKERS,
                                    mp_context=mp.get_context("spawn"))
    return [_POOL.submit(_job, fn, args) for fn, args in calls]


def _job(fn, args):
    """One job in a worker; its memory goes back to the card after it,
    so that idle workers hold little beside the later phases."""
    try:
        return fn(*args)
    finally:
        import torch
        torch.cuda.empty_cache()


def _close_pool():
    """End the worker pool's processes (queued jobs are dropped)."""
    global _POOL
    if _POOL is not None:
        _POOL.shutdown(wait=True, cancel_futures=True)
        _POOL = None


def _golden_job(name, proto, backend):
    """One replay of a committed golden (in a worker process): the keys
    that differ, and the seconds it took."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import FabricConfig
    g = json.loads((ROOT / "tests" / "golden" / f"{name}.json").read_text())
    meta = g["meta"]
    fab = (FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                        up_cap=meta["up_cap"])
           if name == "fabric_enabled" else None)
    t0 = time.perf_counter()
    r = _golden_run(meta, proto, fab, backend)
    want = g["protocols"][proto]
    got = {"completion": [int(x) for x in r.completion],
           "lost_chunks": int(r.lost_chunks),
           "q_max_bytes": [int(x) for x in r.q_max_bytes],
           "prio_drained_bytes": [int(x) for x in r.prio_drained_bytes],
           "busy": [round(float(x), 8) for x in r.busy_frac]}
    if fab is not None:
        got["tor_up_q_max_bytes"] = [int(x) for x in r.tor_up_q_max_bytes]
        got["tor_up_lost_chunks"] = int(r.tor_up_lost_chunks)
    return [k for k in want if got[k] != want[k]], \
        time.perf_counter() - t0


def _golden_checks(jobs, results):
    for (name, proto, backend), (bad, secs) in zip(jobs, results):
        check(not bad, f"{name} {proto} {backend}: differs from the "
                       f"golden in {bad}")
        say(f"[goldens] {name} {proto} {backend}: bit-exact ({secs:.1f} s "
            f"in a worker)")


# ------------------------------------------------------------- phase 4 -----

def _full_config(backend):
    from repro_torch.core import (FabricConfig, SimConfig, make_messages)
    f = FULL
    tbl = make_messages(f["workload"], n_hosts=f["n_hosts"], load=f["load"],
                        n_messages=f["n_messages"], slot_bytes=256,
                        seed=f["seed"])
    cfg = SimConfig(protocol="homa", n_hosts=f["n_hosts"],
                    ring_cap=f["ring_cap"], max_slots=f["max_slots"],
                    fabric=FabricConfig(racks=f["racks"],
                                        oversub=f["oversub"],
                                        up_cap=f["up_cap"]),
                    backend=backend, device=DEVICE)
    return cfg, tbl


INT_FIELDS = ("completion", "q_max_bytes", "prio_drained_bytes",
              "tor_up_busy_frac", "tor_up_q_max_bytes", "busy_frac",
              "tor_up_q_mean_bytes", "q_mean_bytes", "wasted_frac")


def _full_job(backend):
    """One run of phase 4 in a worker process: on ``cuda`` the staged run,
    ``simulate`` split at PLAIN_SLOTS (the same prepare, loop and
    finalize) so that its state there can be held against the plain
    backend's; on ``reference`` that plain run to PLAIN_SLOTS; on
    ``fused`` ``simulate``. Returns the state at PLAIN_SLOTS (or None),
    the SimResult (or None), the launches, the top-K launches on the
    rounds routine and the seconds."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import simulate
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.sim import (_finalize, _init_state, host_state,
                                      prepare, run_slots, stack_static)
    from repro_torch.kernels.arbiter import kernel
    cfg, tbl = _full_config(backend)
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    snap = r = None
    if backend == "fused":
        r = simulate(cfg, tbl)       # ends in host copies: synchronized
    else:
        proto = get_protocol(cfg.protocol)
        S1, alloc = prepare(cfg, tbl)
        S, n_sched = stack_static([S1]), proto.n_sched(cfg, alloc)
        st = _init_state(cfg, proto, len(tbl.size))
        st = run_slots(cfg, proto, S, st, n_sched, 0, PLAIN_SLOTS)
        snap = host_state(st)
        if backend == "cuda":
            st = run_slots(cfg, proto, S, st, n_sched, PLAIN_SLOTS,
                           cfg.max_slots)
            r = _finalize(cfg, tbl, S1, alloc, host_state(st), 0, False)
    wall = time.perf_counter() - t0
    rounds = {fn.__name__: fn.launches_rounds for fn in kernel.TOPK_WRAPPERS}
    return snap, r, kernel.launch_counts(), rounds, wall


def phase_goldens_full(phases):
    """Phases 3 and 4 in one pass of the worker pool, phase 4's three runs
    (the longest) first; phase 4's results, or None."""
    import numpy as np
    full_jobs = ([(b,) for b in ("cuda", "fused", "reference")]
                 if "full" in phases else [])
    golden_jobs = ([(name, proto, backend) for backend in ("cuda", "fused")
                    for name in ("fabric_disabled", "fabric_enabled")
                    for proto in PROTOCOLS]
                   if "goldens" in phases else [])
    res = _in_workers_each([(_full_job, j) for j in full_jobs]
                           + [(_golden_job, j) for j in golden_jobs])
    _golden_checks(golden_jobs, res[len(full_jobs):])
    if not full_jobs:
        return None
    (snap, r_k, n_k, rounds_k, wall_k), (_, r_f, n_f, rounds_f, wall_f), \
        (plain, _, n_p, _, wall_p) = res[:3]
    slots = FULL["max_slots"]
    launches = {"cuda": n_k, "fused": n_f}
    check(n_k == {"priority_arbiter": 2 * slots, "srpt_topk": slots,
                  "fused_slot": 0, "fused_slot_batch": 0,
                  "ring_insert": 3 * slots},
          f"staged run launches {n_k}, expected 2 arbiter, 1 top-K and 3 "
          f"ring inserts per slot over {slots} slots")
    check(n_f == {"priority_arbiter": 0, "srpt_topk": 0,
                  "fused_slot": slots, "fused_slot_batch": 0,
                  "ring_insert": 3 * slots},
          f"fused run launches {n_f}, expected one fused_slot and 3 ring "
          f"inserts per slot over {slots} slots and nothing staged")
    check(set(n_p.values()) == {0}, "the reference backend launched a kernel")
    rounds = {"srpt_topk": rounds_k["srpt_topk"],
              "fused_slot": rounds_f["fused_slot"]}
    check(rounds == {"srpt_topk": 0, "fused_slot": 0},
          f"full run: top-K launches on the rounds routine {rounds}; the "
          f"main path's K = 7 must take the one-pass routine")
    check(set(plain) == set(snap), "plain and kernel state keys differ")
    for k in snap:
        check(plain[k].dtype == snap[k].dtype
              and np.array_equal(plain[k], snap[k]),
              f"slot {PLAIN_SLOTS}: plain and kernel backends differ in "
              f"state {k}")
    for field in INT_FIELDS:
        check(np.array_equal(getattr(r_k, field), getattr(r_f, field)),
              f"full run: fused and staged backends differ in {field}")
    for field in ("lost_chunks", "tor_up_lost_chunks", "n_complete"):
        check(getattr(r_k, field) == getattr(r_f, field),
              f"full run: fused and staged backends differ in {field}")
    check(r_k.n_complete > 0 and np.isfinite(r_k.slowdown[r_k.done]).all()
          and (r_k.slowdown[r_k.done] > 0).all(),
          "full run: completions missing or slowdowns not positive")
    s = r_k.summary()
    tbl = _full_config("cuda")[1]
    say(f"[full] 144 hosts, 9 racks x 16 uplinks, W3 load 0.8, 8000 msgs "
        f"(arrival horizon {int(tbl.arrival_slot.max())} slots), "
        f"{slots} slots; each run in a worker beside the goldens")
    say(f"[full] cuda backend: {wall_k:.2f} s wall, "
        f"{slots / wall_k:.1f} slots/s; launches {n_k}")
    say(f"[full] reference backend, first {PLAIN_SLOTS} slots: "
        f"{wall_p:.2f} s wall, {PLAIN_SLOTS / wall_p:.1f} slots/s; state "
        f"identical to the cuda run's at slot {PLAIN_SLOTS}, key by key")
    say(f"[full] fused backend: {wall_f:.2f} s wall, "
        f"{slots / wall_f:.1f} slots/s; launches {n_f}")
    say(f"[full] top-K launches on the rounds routine: {rounds} (all on "
        f"the one-pass routine)")
    say(f"[full] identical integer outputs; completed "
        f"{r_k.n_complete}/{r_k.n_messages} "
        f"({r_k.completion_rate:.4f}); p99_small {s['p99_small']}; "
        f"p99_all {s['p99_all']}; lost {r_k.lost_chunks}")
    launches["rounds"] = rounds
    return launches, slots / wall_k, snap


# ------------------------------------------------------------- phase 5 -----

WINDOW_SLOTS = 50                # a profiled stretch (the profiler's post-
                                 # processing costs ~0.2 s a slot)
SWEEP_WINDOW_START = 1000        # phase 6c's window: its warm-up's depth


def _windows(cfgs: dict, S, st, n_sched, t, n, tag):
    """From one state at slot ``t``: 20 slots per backend in which any
    host sync raises, then ``n`` profiled slots per backend — wall time
    per slot, device busy share, kernels per slot and the device time per
    launch of each hand-written kernel seen."""
    import torch
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.sim import run_slots
    out = {}
    for backend, cfg in cfgs.items():
        proto = get_protocol(cfg.protocol)
        # each backend from its own copy: the kernel backends update the
        # rings in place
        st0 = {k: v.clone() for k, v in st.items()}
        torch.cuda.synchronize()
        t_dbg = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")   # a host sync now raises
        try:
            st1 = run_slots(cfg, proto, S, st0, n_sched, t, t + 20)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        say(f"[{tag}] {backend}: slots {t}..{t + 19}: no host sync in the "
            f"loop ({time.perf_counter() - t_dbg:.1f} s)")
        t_prof = time.perf_counter()
        _, wall, prof = _window(lambda: run_slots(
            cfg, proto, S, st1, n_sched, t + 20, t + 20 + n), idle=0)
        kern = sorted(((us, cnt, key) for key, cnt, us
                       in _device_events(prof)), reverse=True)
        t_prof = time.perf_counter() - t_prof - wall
        busy_us = sum(k[0] for k in kern)
        row = dict(ms_per_slot=wall / n * 1e3, busy=busy_us / 1e6 / wall,
                   kernels_per_slot=sum(k[1] for k in kern) / n,
                   device_us_per_slot=busy_us / n, per_launch_ms={})
        say(f"[{tag}] {backend}: {n} slots from {t + 20}: "
            f"{row['ms_per_slot']:.3f} ms/slot wall, device busy "
            f"{row['busy']:.4f}, {row['kernels_per_slot']:.1f} kernels/slot, "
            f"{row['device_us_per_slot']:.1f} us/slot of device time; the "
            f"profiler's set-up and post-processing {t_prof:.1f} s")
        for us, cnt, key in kern[:8]:
            say(f"[{tag}]   {us / n:8.2f} us/slot {cnt / n:6.1f}/slot "
                f"{key[:90]}")
        for name in ("priority_arbiter", "srpt_topk", "fused_slot"):
            hits = [k for k in kern if f"{name}_kernel" in k[2]]
            if not hits:
                continue
            check(len(hits) == 1, f"profiler shows several {name} kernels")
            us, cnt, _ = hits[0]
            row["per_launch_ms"][name] = us / cnt / 1e3
            say(f"[{tag}] {backend}: {name}: {cnt / n:.0f} launches/slot, "
                f"{us / cnt:.2f} us device time per launch")
        out[backend] = row
    return out


def phase_window(handoff):
    """A steady window of the full run from phase 4's staged state at
    slot PLAIN_SLOTS (identical on every backend, phase 4 checks it),
    brought back onto the card: each kernel backend's window from that
    one state."""
    import torch
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.sim import prepare, stack_static
    cfg, tbl = _full_config("cuda")
    proto = get_protocol(cfg.protocol)
    S1, alloc = prepare(cfg, tbl)
    S, n_sched = stack_static([S1]), proto.n_sched(cfg, alloc)
    st = {k: torch.from_numpy(v).to(DEVICE) for k, v in handoff.items()}
    cfgs = {b: _full_config(b)[0] for b in ("cuda", "fused")}
    w = _windows(cfgs, S, st, n_sched, PLAIN_SLOTS, WINDOW_SLOTS, "window")
    check("priority_arbiter" in w["cuda"]["per_launch_ms"]
          and "srpt_topk" in w["cuda"]["per_launch_ms"]
          and "fused_slot" in w["fused"]["per_launch_ms"],
          "profiler shows no device time for a kernel of the main path")
    return w


# ------------------------------------------------------------- phase 6 -----

def _sweep_mega():
    """The committed mega cell: 6 protocols x 3 loads x 4 seeds of W1 at 8
    hosts, each protocol one batch of 12 (split over the ranks of a
    process group when there is one), chunked and streaming, on the
    fused backend: the pooled p99 per protocol, the completions, the
    runs, the horizon, the seconds (phase 6 holds them to the
    baseline's) and the pooled histogram per protocol (phase 16)."""
    from repro_torch.core import (SimConfig, SweepSpec, make_messages,
                                  run_sweep)
    from repro_torch.core.sweep import percentile_from_hist
    mega = _mega_baseline()
    tables = [make_messages(mega["workload"], n_hosts=8, load=ld,
                            n_messages=mega["n_messages"], slot_bytes=256,
                            seed=s)
              for ld in (0.5, 0.7, 0.9) for s in range(mega["n_seeds"])]
    horizon = max(int(t.arrival_slot.max()) for t in tables) + 600
    spec = SweepSpec(tables=tables, shared_alloc=True, shard=True,
                     chunk_slots=512, streaming=True)
    t0 = time.perf_counter()
    done, p99, pooled = 0, {}, {}
    for proto in PROTOCOLS:
        cfg = SimConfig(n_hosts=8, protocol=proto, ring_cap=256,
                        max_slots=horizon, backend="fused", device=DEVICE)
        stats = run_sweep(cfg, spec)
        done += sum(s.n_complete for s in stats)
        pooled[proto] = sum(s.hist for s in stats)
        p99[proto] = round(percentile_from_hist(
            pooled[proto].sum(axis=0), stats[0].stream, 99.0), 4)
    return (p99, done, len(tables), horizon, time.perf_counter() - t0,
            pooled)


def _mega_baseline():
    base = json.loads((ROOT / "benchmarks" / "baselines" / "sweep_speed.json")
                      .read_text())
    return next(r for r in base if r["kind"] == "mega")


def _sweep_tables():
    from repro_torch.core import make_messages
    f = FULL
    return [make_messages(f["workload"], n_hosts=f["n_hosts"], load=ld,
                          n_messages=f["n_messages"], slot_bytes=256, seed=s)
            for ld in SWEEP_LOADS for s in SWEEP_SEEDS]


def _sweep_config(backend):
    import dataclasses
    cfg, _ = _full_config(backend)
    return dataclasses.replace(cfg, max_slots=SWEEP_SLOTS)


def _sweep_spec(tables, shard=False):
    """6b's sweep of ``tables`` (16a splits it over a world's ranks)."""
    from repro_torch.core import SweepSpec
    return SweepSpec(tables=tables, shared_alloc=True, chunk_slots=1000,
                     streaming=True, shard=shard)


def _sweep_job(kind, backend):
    """One run of phase 6 in a worker process:

      ("mega", None)      the mega cell (:func:`_sweep_mega`)
      ("sweep", backend)  6b's batch of 12 through ``run_sweep``: its
                          SweepStats, launches, top-K launches on the
                          rounds routine, seconds
      ("warm", None)      6c's batch on ``fused`` to SWEEP_WINDOW_START
                          (the priorities shared as ``run_sweep`` shares
                          them): the state there
    """
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.core import run_sweep
    from repro_torch.core.priorities import allocate_priorities
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.sim import (_init_state, host_state, prepare,
                                      run_slots, stack_static)
    from repro_torch.kernels.arbiter import kernel
    if kind == "mega":
        return _sweep_mega()
    tables = _sweep_tables()
    if kind == "warm":
        cfg = _sweep_config("fused")
        proto = get_protocol(cfg.protocol)
        alloc = allocate_priorities(np.concatenate([t.size for t in tables]),
                                    unsched_limit=cfg.rtt_bytes,
                                    n_prios=cfg.n_prios)
        S = stack_static([prepare(cfg, t, alloc)[0] for t in tables])
        st = _init_state(cfg, proto, S["size"].shape[1], len(tables))
        return host_state(run_slots(cfg, proto, S, st,
                                    proto.n_sched(cfg, alloc), 0,
                                    SWEEP_WINDOW_START))
    spec = _sweep_spec(tables)
    kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run_sweep(_sweep_config(backend), spec)
    wall = time.perf_counter() - t0
    return (stats, kernel.launch_counts(),
            {fn.__name__: fn.launches_rounds for fn in kernel.TOPK_WRAPPERS},
            wall)


def phase_sweep():
    """6a-6b and 6c's warm-up in the worker pool at once, then 6c's
    windows here."""
    import numpy as np
    import torch
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.sim import prepare, stack_static
    backends = ("fused", "cuda")
    res = _in_workers(_sweep_job, [("sweep", b) for b in backends]
                      + [("mega", None), ("warm", None)])
    (p99, done, n_runs, horizon, wall_m, pooled), warm = res[2:]
    mega = _mega_baseline()
    for proto in PROTOCOLS:
        check(p99[proto] == mega[f"p99_{proto}"],
              f"mega cell {proto}: pooled p99 {p99[proto]} != baseline "
              f"{mega[f'p99_{proto}']}")
    check(done == mega["completions"],
          f"mega cell: {done} completions != baseline {mega['completions']}")
    say(f"[sweep] mega cell ({len(PROTOCOLS)} protocols x {n_runs} "
        f"runs, {horizon} slots, fused): pooled p99s and {done} completions "
        f"equal the baseline; {wall_m:.2f} s wall in a worker, "
        f"{len(PROTOCOLS) * n_runs / wall_m:.2f} runs/s")

    tables = _sweep_tables()
    B = len(tables)
    stats, launches, wall, rounds = {}, {}, {}, {}
    for backend, (stats[backend], launches[backend], rounds[backend],
                  wall[backend]) in zip(backends, res[:2]):
        say(f"[sweep] {B} full-width runs (W3, loads {SWEEP_LOADS} x seeds "
            f"{SWEEP_SEEDS}), {SWEEP_SLOTS} slots, {backend}: "
            f"{wall[backend]:.2f} s wall in a worker, "
            f"{B * SWEEP_SLOTS / wall[backend]:.1f} runs*slots/s; launches "
            f"{launches[backend]}")
    check(launches["fused"] == {"priority_arbiter": 0, "srpt_topk": 0,
                                "fused_slot": 0,
                                "fused_slot_batch": SWEEP_SLOTS,
                                "ring_insert": 3 * SWEEP_SLOTS},
          f"sweep launches {launches['fused']}, expected one "
          f"fused_slot_batch per slot for the whole batch")
    check(launches["cuda"]["priority_arbiter"] == 2 * SWEEP_SLOTS
          and launches["cuda"]["srpt_topk"] == SWEEP_SLOTS,
          f"staged sweep launches {launches['cuda']}")
    check(all(n == 0 for r in rounds.values() for n in r.values()),
          f"sweep: top-K launches on the rounds routine {rounds}; the main "
          f"path's K = 7 must take the one-pass routine")
    for i, (a, b) in enumerate(zip(stats["fused"], stats["cuda"])):
        check(np.array_equal(a.hist, b.hist)
              and np.array_equal(a.prio_drained_bytes, b.prio_drained_bytes),
              f"sweep run {i}: fused and staged histograms differ")
        for f in ("n_complete", "busy_frac", "wasted_frac",
                  "uplink_busy_frac", "q_mean_bytes", "q_max_bytes",
                  "lost_chunks", "tor_up_busy_frac"):
            check(getattr(a, f) == getattr(b, f),
                  f"sweep run {i}: fused and staged differ in {f}")
    check(all(s.n_counted > 0 for s in stats["fused"]),
          "sweep: a run completed nothing")
    say(f"[sweep] every integer of the {B} runs' streaming statistics is "
        f"identical on both backends; completed "
        f"{[s.n_complete for s in stats['fused']]}; p99_all "
        f"{[round(s.percentile(99.0), 4) for s in stats['fused']]}")

    # the batch's profiled window, beside phase 5's single run, from the
    # warm-up's state brought back onto the card
    cfg = _sweep_config("fused")
    proto = get_protocol(cfg.protocol)
    alloc = stats["fused"][0].alloc
    S = stack_static([prepare(cfg, t, alloc)[0] for t in tables])
    n_sched = proto.n_sched(cfg, alloc)
    st = {k: torch.from_numpy(v).to(DEVICE) for k, v in warm.items()}
    ws = _windows({"fused": cfg, "cuda": _sweep_config("cuda")}, S, st,
                  n_sched, SWEEP_WINDOW_START, WINDOW_SLOTS, f"sweep B={B}")
    w = ws["fused"]
    # fused_slot_batch launches the same fused_slot_kernel
    check("fused_slot" in w["per_launch_ms"],
          "profiler shows no device time for the batched fused kernel")
    w["per_launch_ms"]["fused_slot_batch"] = \
        w["per_launch_ms"].pop("fused_slot")
    # the staged kernels on the whole batch: the arbiter at (1728, 1024)
    # and (1728, 512), two launches a slot
    check("priority_arbiter" in ws["cuda"]["per_launch_ms"],
          "profiler shows no device time for the staged arbiter at B = 12")
    w["cuda"] = ws["cuda"]
    return (dict(launches["fused"], rounds=rounds["fused"]), w,
            {b: B * SWEEP_SLOTS / wall[b] for b in wall},
            {"sweep": stats["fused"], "mega": (pooled, done, horizon),
             "rate": B * SWEEP_SLOTS / wall["fused"]})


# ------------------------------------------------------------- phase 7 -----

# the tensor-core route's kernels, which the main path runs
SSD_KERNELS = ("ssd_chunk_state_tc_kernel", "ssd_state_pass_tc_kernel",
               "ssd_output_tc_kernel")


def _rel(got, want) -> float:
    """Relative RMS error ||got - want|| / ||want||, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def _ssd_work(B, S, H, P, N, L):
    """Bytes the SSD must move (inputs read once, outputs written once)
    and the multiply-adds it needs at these shapes: per (b, chunk, h) the
    causal att.x (L(L+1)/2 x P), x^T.B (L x P x N) and, past the first
    chunk, C.state (L x N x P); per (b, chunk) the causal C.B^T
    (L(L+1)/2 x N). Returns (bytes, multiply-adds, multiply-adds on the
    bf16 tensor cores): there, each of the three products with an fp32
    factor runs twice (its hi and lo halves), as p.V does in row 6."""
    nc = S // L
    nbytes = (B * S * H * P * 2 + B * S * H * 4 + H * 4 + 2 * B * S * N * 2
              + B * S * H * P * 4 + B * H * P * N * 4)
    tri = L * (L + 1) // 2
    split = (B * nc * H * (tri * P + L * P * N)
             + B * (nc - 1) * H * L * N * P)
    cb = B * nc * tri * N
    return nbytes, split + cb, 2 * split + cb


def _ssd_check(name, args, chunk, tc=True):
    """The kernels (through ``ops.ssd``, padding included) against
    ``ssd_ref`` on the same inputs: y and the final state elementwise
    within SSD_TOL; one launch, on the tensor-core route iff ``tc`` (the
    counters say which). Returns the max abs error of y."""
    import torch
    from repro_torch.kernels.ssd import kernel as ssd_kernel, ops
    from repro_torch.kernels.ssd.ref import ssd_ref
    scan = ssd_kernel.ssd_scan
    n, n_tc = scan.launches, scan.launches_tc
    y, fs = ops.ssd(*args, chunk=chunk)
    yr, fr = ssd_ref(*args)
    torch.cuda.synchronize()
    check((scan.launches - n, scan.launches_tc - n_tc) == (1, int(tc)),
          f"ssd {name}: {scan.launches - n} launches, "
          f"{scan.launches_tc - n_tc} on the tensor cores; expected 1, "
          f"{int(tc)}")
    atol, rtol = SSD_TOL["atol"], SSD_TOL["rtol"]
    shape = tuple(args[0].shape)
    msg = [f"[model] ssd kernel == ssd_ref: {name} {shape}, chunk {chunk}, "
           f"{'tensor' if tc else 'CUDA'} cores:"]
    for what, g, w in (("y", y, yr), ("state", fs, fr)):
        check(g.shape == w.shape and g.dtype == torch.float32,
              f"ssd {name}: {what} shape {tuple(g.shape)} / dtype {g.dtype}")
        check(bool(torch.isfinite(g).all()), f"ssd {name}: {what} not finite")
        d = (g - w).abs()
        used = float((d / (atol + rtol * w.abs())).max())
        big = w.abs() >= atol / rtol          # where rtol dominates
        mrel = float((d[big] / w.abs()[big]).max()) if big.any() else 0.0
        msg.append(f"{what} max abs {float(d.max()):.3e}, max rel "
                   f"{mrel:.3e} (|want| >= 1), tolerance {atol} + {rtol} "
                   f"|want| ({used:.3f} of it used)")
        check(used <= 1.0, f"ssd {name}: {what} outside the tolerance "
                           f"({used:.3f} of it)")
        if what == "y":
            err = float(d.max())
    say(" ".join(msg))
    return err


def _ssd_synthetic(gen, B, S, H, P, N):
    """As tests/test_kernels.py draws them: x normal, dt = softplus(normal),
    A = -exp(0.3 normal), B and C 0.5 normal; x/B/C bf16."""
    import torch
    import torch.nn.functional as F
    kw = dict(generator=gen, device=DEVICE)
    x = torch.randn((B, S, H, P), **kw).bfloat16()
    dt = F.softplus(torch.randn((B, S, H), **kw))
    A = -torch.exp(0.3 * torch.randn((H,), **kw))
    Bm = (0.5 * torch.randn((B, S, N), **kw)).bfloat16()
    Cm = (0.5 * torch.randn((B, S, N), **kw)).bfloat16()
    return x, dt, A, Bm, Cm


def _ssd_cuda_core_ms(args, chunk):
    """Time of the CUDA-core route (the earlier design) on the main
    path's inputs, launched through the library directly so that the
    wrapper's rule, which sends such a call to the tensor cores, is
    bypassed and nothing is counted: the earlier design's time, taken in
    the same run as the new one's."""
    import torch
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    lib = ssd_kernel.LIBRARY.load()
    x, dt, A, Bm, Cm = args
    B, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    bufs = [torch.empty(shape, **f32) for shape in
            ((B, S, H, P), (B, H, P, N), (B, nc, H, P, N), (B, nc, H),
             (B, nc, chunk, chunk))]
    ptrs = [t.data_ptr() for t in (x, dt, A, Bm, Cm, *bufs)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.ssd_launch(*ptrs, B, S, H, P, N, chunk, stream)
        check(rc == 0, f"CUDA-core SSD launch failed ({rc})")
    return time_ms(call, batch=5, reps=3, warmup=1)


def _window(fn, cpu: bool = True, idle: float = 0.05,
            marker: bool = True):
    """Run ``fn`` under the profiler; returns (its result, wall seconds,
    the profiler). ``cpu=False`` records device activity only; ``idle``
    seconds of idle trace go either side. The window opens with
    ``MARKERS`` launches of a spin kernel (``marker=False``: without
    them), synchronized before the idle trace: in some processes the
    profiler drops the first kernel records of every session after the
    first (one, two, 59 or all 64 of an earlier 64 markers seen;
    ROADMAP C6), and the markers take that loss."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if cpu else [])) as prof:
        if marker:
            for _ in range(MARKERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        time.sleep(idle)     # idle trace around the launches, as in
        t0 = time.perf_counter()    # _device_ms: windows lost launches
        r = fn()                    # without it (phase 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(idle)
    return r, wall, prof


MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
MARKERS = 256                   # a window's first launches (~1 ms)


def _device_events(prof):
    """[(kernel name, launches, device us)] of a profiler window, the
    marker left out."""
    import torch
    return [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and MARKER not in e.key]


def _profiled(fn, cpu: bool = True, idle: float = 0.05):
    """:func:`_window`, returning (its result, wall seconds,
    :func:`_device_events`)."""
    r, wall, prof = _window(fn, cpu, idle)
    return r, wall, _device_events(prof)


@contextlib.contextmanager
def _attention_calls():
    """The attention call sites' (q shape, k shape, causal), in the order
    of the calls made inside the block."""
    from repro_torch.kernels.attention import ops as attn_ops
    calls, site = [], attn_ops.attention

    def logged(q, k, v, *, causal=True, **a):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return site(q, k, v, causal=causal, **a)
    attn_ops.attention = logged
    try:
        yield calls
    finally:
        attn_ops.attention = site


def _launch_records(prof, kernel: str, calls: list, tag: str) -> dict:
    """How many records of the kernels whose name holds ``kernel`` each
    view of a profiler window holds — ``key_averages()``, ``events()``
    and kineto's raw events — beside the ``calls`` made in it. On a
    shortfall in any view the window's trace goes to
    ``chiprun_out/c6_<tag>.json`` and the missing launches are named by
    their index in the call order and their shape."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    rec = {"calls": len(calls),
           "key_averages": sum(e.count for e in prof.key_averages()
                               if e.device_type == cuda and kernel in e.key),
           "events": sum(1 for e in prof.events()
                         if e.device_type == cuda and kernel in e.name),
           "kineto": sum(1 for e in prof.profiler.kineto_results.events()
                         if e.device_type() == cuda and kernel in e.name()),
           "markers": sum(1 for e in prof.profiler.kineto_results.events()
                          if MARKER in e.name())}
    if all(rec[v] == len(calls) for v in ("key_averages", "events",
                                          "kineto")):
        return rec
    path = ROOT / "chiprun_out" / f"c6_{tag}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    kern = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "kernel" and kernel in e["name"]),
                  key=lambda e: e["ts"])
    rec["trace"] = len(kern)
    rec["missing"] = _missing_launches(calls, kern)
    say(f"[c6 {tag}] {kernel}: {len(calls)} calls; records in "
        f"key_averages {rec['key_averages']}, events {rec['events']}, "
        f"kineto {rec['kineto']}, the exported trace {rec['trace']} "
        f"({path.relative_to(ROOT)}); missing: {rec['missing']}")
    return rec


def _counted_window(fn, calls: int, tag: str):
    """A prefill window of phases 13 and 15 (device activity only, 0.5 s
    of idle trace either side, the marker first): (the tensor-core
    attention kernel's device events, its records, wall seconds, every
    device event). A window that recorded fewer than the ``calls`` the
    counters saw, or than the attention calls it made, keeps its trace
    and names the missing launch (:func:`_launch_records`)."""
    kernel = "flash_attention_tc_kernel"
    with _attention_calls() as made:
        _, wall, prof = _window(fn, cpu=False, idle=0.5)
    ev = _device_events(prof)
    hits = [e for e in ev if kernel in e[0]]
    seen = sum(h[1] for h in hits)
    rec = _launch_records(prof, kernel, made, tag)
    if seen != calls or len(made) != calls:
        say(f"[{tag}] profiler window recorded {seen} of the {calls} "
            f"attention launches the counters saw ({len(made)} calls made "
            f"in it; {rec})")
    if rec["markers"] != MARKERS:
        say(f"[{tag}] the profiler lost {MARKERS - rec['markers']} of the "
            f"window's {MARKERS} opening marker records (ROADMAP C6)")
    return hits, seen, wall, ev


def _missing_launches(calls: list, kern: list) -> dict:
    """Which of ``calls`` has no record among ``kern`` (the window's
    trace records of the kernel, in time order), when one is missing:
    the indices whose removal lets every record answer its call (one
    grid for each call shape), and of those the one whose neighbours'
    records lie furthest apart (the lost launch leaves its time idle).
    With more than one missing, the records' grids are counted."""
    grids = [tuple(e["args"].get("grid", ())) for e in kern]
    if len(calls) - len(kern) != 1:
        return {"missing": len(calls) - len(kern),
                "records_by_grid": {str(g): grids.count(g)
                                    for g in sorted(set(grids))}}

    def answers(rest):
        shape_grid = {}
        return all(shape_grid.setdefault(s, g) == g
                   for s, g in zip(rest, grids))

    cands = [j for j in range(len(calls))
             if answers(calls[:j] + calls[j + 1:])]

    def gap(j):          # idle time between the records around call j
        if 0 < j < len(kern):
            return kern[j]["ts"] - kern[j - 1]["ts"] - kern[j - 1]["dur"]
        return -1.0
    inner = [gap(c) for c in cands if gap(c) >= 0]
    j = max(cands, key=gap) if inner else None
    if len(cands) == 1:
        j = cands[0]
    elif j is not None and gap(j) <= 1.6 * statistics.median(inner):
        j = None         # even gaps: it was the first or the last
    ends = [c for c in (cands[:1] + cands[-1:]) if j is None]
    return {"missing": 1, "candidates": cands, "index": j,
            "of": len(calls),
            "shape": [calls[c] for c in ([j] if j is not None else ends)],
            "position": [("first" if c == 0 else "last"
                          if c == len(calls) - 1 else "middle")
                         for c in ([j] if j is not None else ends)],
            "gaps_us": [gap(c) for c in cands]}


def phase_model():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.arbiter import kernel as arb_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.params import init_params
    dev = torch.device(DEVICE)
    cfg = get_config(MODEL["arch"])
    Bsz, Slen = MODEL["batch"], MODEL["seq"]
    H, P, N, L = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim,
                  cfg.ssm_chunk)
    V = cfg.vocab_size
    gen = torch.Generator(dev).manual_seed(MODEL["seed"])
    t0 = time.perf_counter()
    params = init_params(M.model_defs(cfg), gen, dev)
    tokens = torch.randint(0, V, (Bsz, Slen), generator=gen, device=dev)
    torch.cuda.synchronize()
    say(f"[model] {cfg.name}: {M.count_model_params(cfg)} bf16 parameters, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, H {H}, P {P}, "
        f"N {N}, chunk {L}, vocab {V} (padded {cfg.padded_vocab()}); "
        f"random weights, seed {MODEL['seed']}; init "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}
    with torch.inference_mode():
        # (a) the kernel against its plain version
        x = M._embed(cfg, params, tokens)
        lp0 = M._index(params["blocks"], 0)["s0"]
        _, xin, dt, A, Bv, Cv, _ = S.ssd_inputs(
            cfg, lp0["mixer"], apply_norm(cfg, lp0["norm1"], x))
        main_args = (xin, dt, A, Bv, Cv)
        check(ssd_kernel.takes_tensor_cores(xin, Bv, Cv, L),
              "the prefill's SSD inputs do not take the tensor-core route")
        out["max_abs_err"] = _ssd_check("layer 0 of the prefill", main_args,
                                        L)
        sgen = torch.Generator(dev).manual_seed(7)
        _ssd_check("synthetic", _ssd_synthetic(sgen, Bsz, Slen, H, P, N), L)
        for name, (b, s_, h, c, tc) in {
                "pad path (S % chunk != 0)": (Bsz, 1000, H, L, True),
                "S < chunk": (Bsz, 100, H, L, False),
                "B = 1": (1, 2048, H, L, True),
                "one head": (Bsz, 1024, 1, L, True)}.items():
            _ssd_check(name, _ssd_synthetic(sgen, b, s_, h, P, N), c, tc)
        x_, dt_, A_, B_, C_ = _ssd_synthetic(sgen, 2, 2048, H, P, N)
        _ssd_check("strong decay (dt x 20, A x e^2)",
                   (x_, dt_ * 20.0, A_ * 7.389056, B_, C_), L)
        del x_, dt_, A_, B_, C_
        nbytes, macs, macs_tc = _ssd_work(Bsz, Slen, H, P, N, L)
        out["bytes"], out["macs"], out["macs_tc"] = nbytes, macs, macs_tc
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        fp32_ops = 2 * macs / FP32_FLOP_PER_S * 1e3
        tc_ops = 2 * macs_tc / TC_BF16_FLOP_PER_S * 1e3
        # the bound of the route the path runs: bf16 tensor cores
        out["bound_ms"] = max(by_bytes, tc_ops)
        out["bound_by"] = "operations" if tc_ops > by_bytes else "bytes"
        out["bound_fp32_ms"] = max(by_bytes, fp32_ops)
        out["ms"] = time_ms(lambda: ssd_kernel.ssd_scan(*main_args, chunk=L),
                            batch=10, reps=5)
        out["cuda_core_ms"] = _ssd_cuda_core_ms(main_args, L)
        out["ms_again"] = time_ms(
            lambda: ssd_kernel.ssd_scan(*main_args, chunk=L), batch=10,
            reps=5)
        out["plain_ms"] = time_ms(lambda: ssd_ref(*main_args), batch=1,
                                  reps=3, warmup=1)
        out["chunked_ms"] = time_ms(lambda: S.ssd_chunked(*main_args, L),
                                    batch=2, reps=3, warmup=1)
        say(f"[model] ssd kernels at ({Bsz}, {Slen}, {H}, {P}), N {N}, "
            f"chunk {L}: tensor-core route {out['ms']:.4f} / "
            f"{out['ms_again']:.4f} ms a call; CUDA-core route (the earlier "
            f"design) {out['cuda_core_ms']:.4f} ms; plain ssd_ref "
            f"{out['plain_ms']:.2f} ms; plain ssd_chunked "
            f"{out['chunked_ms']:.3f} ms")
        notes = [ln for ln in ssd_kernel.LIBRARY.build_log().splitlines()
                 if "Performance Loss" in ln]
        out["ptxas_serialization_notes"] = len(notes)
        say(f"[model] ssd library: {len(notes)} ptxas notes of serialized "
            f"wgmma (C7512/C7514; listed in phase 1)")
        say(f"[model] ssd bound: {out['bound_ms']:.4f} ms on the bf16 tensor "
            f"cores ({out['bound_by']}: {nbytes / 1e6:.1f} MB -> "
            f"{by_bytes:.4f} ms, {2 * macs_tc / 1e9:.2f} GFLOP with the "
            f"split products counted twice -> {tc_ops:.4f} ms); "
            f"{out['bound_fp32_ms']:.4f} ms on the fp32 CUDA cores "
            f"({2 * macs / 1e9:.2f} GFLOP -> {fp32_ops:.4f} ms)")
        del x, xin, dt, A, Bv, Cv, main_args

        # (b) the main path: one prefill of Bsz x Slen tokens on the kernel
        M.forward_prefill(cfg, params, tokens)        # warm-up, not counted
        torch.cuda.synchronize()
        ssd_kernel.ssd_scan.launches = 0
        ssd_kernel.ssd_scan.launches_tc = 0
        arb_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = M.forward_prefill(cfg, params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"] = ssd_kernel.ssd_scan.launches
        out["launches_tc"] = ssd_kernel.ssd_scan.launches_tc
        check(out["launches"] == cfg.num_layers,
              f"prefill launched the SSD kernel {out['launches']} times, "
              f"expected one per layer ({cfg.num_layers})")
        check(out["launches_tc"] == out["launches"],
              f"only {out['launches_tc']} of the prefill's {out['launches']} "
              f"SSD launches took the tensor-core route")
        check(not any(arb_kernel.launch_counts().values()),
              "the prefill launched an arbitration kernel")
        check(logits.shape == (Bsz, cfg.padded_vocab())
              and bool(torch.isfinite(logits).all())
              and bool((logits[:, V:] == -1e9).all()),
              "prefill logits: wrong shape, not finite or padding unmasked")
        out["tokens_per_s"] = Bsz * Slen / wall
        say(f"[model] prefill {Bsz} x {Slen} tokens on the kernel: "
            f"{wall * 1e3:.1f} ms, {out['tokens_per_s']:.0f} tokens/s; "
            f"ssd_scan launches {out['launches']}, {out['launches_tc']} on the "
            f"tensor cores")
        _, pwall, ev = _profiled(lambda: M.forward_prefill(cfg, params,
                                                           tokens))
        busy = sum(e[2] for e in ev)
        dev_us = 0.0
        out["device_us_per_kernel"] = {}
        for name in SSD_KERNELS:
            hits = [e for e in ev if name in e[0]]
            check(len(hits) == 1 and hits[0][1] == cfg.num_layers,
                  f"profiler: {name} launched "
                  f"{[h[1] for h in hits]} times, expected "
                  f"{cfg.num_layers}")
            dev_us += hits[0][2]
            out["device_us_per_kernel"][name] = hits[0][2] / hits[0][1]
            say(f"[model]   {name}: {hits[0][1]} launches, "
                f"{hits[0][2] / hits[0][1]:.1f} us each")
        check(not any(("ssd_" in e[0] and "_kernel" in e[0]
                       and not any(k in e[0] for k in SSD_KERNELS))
                      for e in ev),
              "the prefill launched a CUDA-core SSD kernel")
        out["device_ms_per_launch"] = dev_us / cfg.num_layers / 1e3
        say(f"[model] profiled prefill: {pwall * 1e3:.1f} ms wall, device "
            f"busy {busy / 1e6 / pwall:.4f}, SSD {dev_us / 1e3:.2f} ms of "
            f"{busy / 1e3:.2f} ms device time; "
            f"{out['device_ms_per_launch']:.4f} ms device time per "
            f"ssd_scan launch ({out['device_ms_per_launch'] / out['bound_ms']:.2f}"
            f"x the tensor-core bound)")
        for us, cnt, key in sorted(((e[2], e[1], e[0]) for e in ev),
                                   reverse=True)[:6]:
            say(f"[model]   {us / 1e3:8.2f} ms {cnt:5d}x {key[:80]}")

        (plain, _), pwall, ev = _profiled(
            lambda: M.forward_prefill(cfg, params, tokens, use_kernel=False))
        check(not any("ssd_" in e[0] and "_kernel" in e[0] for e in ev),
              "the plain prefill launched an SSD kernel")
        err = _rel(logits[:, :V], plain[:, :V])
        agree = float((logits[:, :V].argmax(-1)
                       == plain[:, :V].argmax(-1)).float().mean())
        say(f"[model] plain prefill (ssd_chunked, no SSD launch): "
            f"{pwall * 1e3:.1f} ms wall; last-token logits rel RMS "
            f"{err:.4f} (tolerance {MODEL_TOL['logits']}), argmax agrees "
            f"on {agree:.2f} of rows")
        check(err <= MODEL_TOL["logits"], "kernel and plain prefill logits "
                                          "differ beyond the tolerance")
        del plain

        # layer by layer on the same inputs: kernel vs plain mixer, and
        # prefill(S-1) + one decode step vs the S-token mixer
        x = M._embed(cfg, params, tokens)
        worst = dict(layer=0.0, decode_layer=0.0)
        for l in range(cfg.num_layers):
            lp = M._index(params["blocks"], l)["s0"]
            h = apply_norm(cfg, lp["norm1"], x)
            yk, (fk, _) = S.mamba_block(cfg, lp["mixer"], h)
            yp, (fp, _) = S.mamba_block(cfg, lp["mixer"], h,
                                        use_kernel=False)
            worst["layer"] = max(worst["layer"], _rel(yk, yp))
            check(bool(((fk - fp).abs() <= SSD_TOL["atol"]
                        + SSD_TOL["rtol"] * fp.abs()).all()),
                  f"layer {l}: kernel and plain final states differ")
            _, (f1, t1) = S.mamba_block(cfg, lp["mixer"], h[:, :-1])
            yd, _ = S.mamba_block_decode(
                cfg, lp["mixer"], h[:, -1:],
                {"state": f1.to(h.dtype), "conv": t1.to(h.dtype)})
            worst["decode_layer"] = max(worst["decode_layer"],
                                        _rel(yd, yk[:, -1:]))
            x = x + yk
        say(f"[model] layer by layer, same inputs: kernel vs plain mixer "
            f"rel RMS <= {worst['layer']:.2e} (tolerance "
            f"{MODEL_TOL['layer']}), final states within {SSD_TOL}; "
            f"prefill({Slen - 1}) + decode vs prefill({Slen}) mixer rel RMS "
            f"<= {worst['decode_layer']:.2e} (tolerance "
            f"{MODEL_TOL['decode_layer']})")
        for k in ("layer", "decode_layer"):
            check(worst[k] <= MODEL_TOL[k], f"layer by layer: {k} beyond the "
                                            f"tolerance")
        del x, h, yk, yp

        # (c) prefill(S-1) + one decode step vs the S-token prefill
        _, caches = M.forward_prefill(cfg, params, tokens[:, :-1])
        step, _ = M.forward_decode(cfg, params, tokens[:, -1:], Slen - 1,
                                   caches)
        err = _rel(step[:, :V], logits[:, :V])
        say(f"[model] prefill({Slen - 1}) + forward_decode at {Slen - 1} vs "
            f"prefill({Slen}): logits rel RMS {err:.4f} (tolerance "
            f"{MODEL_TOL['decode_logits']})")
        check(bool(torch.isfinite(step).all())
              and err <= MODEL_TOL["decode_logits"],
              "prefill + decode differs from the prefill")
        del caches, step, logits

    # (d) the serving loop at full width
    torch.cuda.synchronize()
    ssd_kernel.ssd_scan.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", MODEL["arch"], *SERVE_ARGV,
                      "--device", DEVICE])
    wall = time.perf_counter() - t0
    got = {k: res[k] for k in SERVE_EXPECTED}
    check(got == SERVE_EXPECTED, f"serve statistics {got} != the JAX "
                                 f"package's {SERVE_EXPECTED}")
    out["decode_steps_per_s"] = res["steps"] / wall
    say(f"[model] serve {MODEL['arch']} {' '.join(SERVE_ARGV)}: {got} == "
        f"the JAX package's; {wall:.2f} s wall (parameter init included), "
        f"{out['decode_steps_per_s']:.1f} decode steps/s at batch "
        f"{SERVE_ARGV[-1]}; ssd_scan launches {ssd_kernel.ssd_scan.launches}"
        f" (decode runs the recurrence step, not the chunk scan)")

    out["decode"] = _decode_window(cfg, params, dev, "model")
    return out


def _decode_window(cfg, params, dev, tag, n=10):
    """A profiled window of ``n`` of the serve's decode steps (batch 4,
    eager, on the serve's caches); returns its wall ms per step and
    device busy."""
    import torch
    from repro_torch.models import model as M
    C = int(SERVE_ARGV[-1])
    with torch.inference_mode():
        caches = M.zeros_caches(M.cache_shapes(cfg, C, 8), torch.bfloat16,
                                dev)
        tok = torch.zeros((C, 1), dtype=torch.int32, device=dev)
        for _ in range(3):
            M.forward_decode(cfg, params, tok, 4, caches)

        def steps():
            c, t = caches, tok
            for _ in range(n):
                lg, c = M.forward_decode(cfg, params, t, 4, c)
                t = lg.argmax(-1).to(torch.int32)[:, None]

        _, wall, ev = _profiled(steps)
    busy = sum(e[2] for e in ev)
    say(f"[{tag}] decode window, batch {C}, {n} steps: "
        f"{wall / n * 1e3:.2f} ms/step wall, device busy "
        f"{busy / 1e6 / wall:.4f}, {sum(e[1] for e in ev) / n:.0f} "
        f"kernels/step, {busy / n / 1e3:.3f} ms/step of device time")
    for us, cnt, key in sorted(((e[2], e[1], e[0]) for e in ev),
                               reverse=True)[:5]:
        say(f"[{tag}]   {us / n / 1e3:8.3f} ms/step {cnt / n:6.1f}/step "
            f"{key[:80]}")
    return dict(ms_per_step=wall / n * 1e3, busy=busy / 1e6 / wall)


# ------------------------------------------------------------- phase 8 -----

def _attn_work(q, k, v, causal):
    """Bytes the attention must move (q, k, v read once, the output
    written once) and the operations it needs over every query-key pair
    it keeps (the causal half when causal): those of q.k and those of
    p.v, separately."""
    B, Sq, H, d = q.shape
    Skv, dv = k.shape[1], v.shape[-1]
    pairs = (sum(min(i + 1, Skv) for i in range(Sq)) if causal
             else Sq * Skv) * B * H
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + B * Sq * H * dv * q.element_size()
    return nbytes, 2 * pairs * d, 2 * pairs * dv


def _attn_check(name, q, k, v, *, causal=True, window=None, kv_len=None,
                tc=True, tag="llama"):
    """The kernel against ``attention_ref`` on the same inputs,
    elementwise within ATTN_TOL and in relative RMS within ATTN_RMS_TOL;
    one launch, of the tensor-core kernel iff ``tc`` (the counters say
    which). Without ``kv_len`` the call goes through ``ops.attention``
    (padding included: every such case has a valid key in every row, so
    the padding does not change the function); with it, straight to
    ``kernel.flash_attention`` at the unpadded shape. Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.attention import kernel as attn_kernel, ops
    from repro_torch.kernels.attention.ref import attention_ref
    fa = attn_kernel.flash_attention
    n, n_tc = fa.launches, fa.launches_tc
    if kv_len is None:
        got = ops.attention(q, k, v, causal=causal, window=window)
    else:
        got = fa(q, k, v, causal=causal, window=window, kv_len=kv_len)
    want = attention_ref(q, k, v, causal=causal, window=window,
                         kv_len=kv_len)
    torch.cuda.synchronize()
    check((fa.launches - n, fa.launches_tc - n_tc) == (1, int(tc)),
          f"attention {name}: {fa.launches - n} launches, "
          f"{fa.launches_tc - n_tc} on the tensor cores; expected 1, "
          f"{int(tc)}")
    tol = ATTN_TOL[str(q.dtype).removeprefix("torch.")]
    check(got.shape == want.shape and got.dtype == q.dtype,
          f"attention {name}: shape {tuple(got.shape)} / dtype {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"attention {name}: not finite")
    d = (got.float() - want.float()).abs()
    used = float((d / (tol + tol * want.float().abs())).max())
    err = float(d.max())
    rtol = ATTN_RMS_TOL[str(q.dtype).removeprefix("torch.")]
    diff = got.float() - want.float()
    rms = float(diff.norm() / want.float().norm())
    row = float((diff.norm(dim=-1)
                 / want.float().norm(dim=-1).clamp_min(1e-30)).max())
    # the size of the output's own rounding to q's dtype, for scale
    exact = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                          window=window, kv_len=kv_len)
    rounding = _rel(want, exact)
    del exact
    say(f"[{tag}] attention kernel == attention_ref: {name} q "
        f"{tuple(q.shape)} kv {tuple(k.shape)} {str(q.dtype)[6:]}, causal "
        f"{causal}, window {window}, kv_len {kv_len}, "
        f"{'tensor' if tc else 'CUDA'} cores: max abs {err:.3e}, tolerance "
        f"{tol} + {tol} |want| ({used:.3f} of it used); rel RMS {rms:.3e} "
        f"(tolerance {rtol['rms']}), worst row {row:.3e} (tolerance "
        f"{rtol['row']}); the output's rounding to {str(q.dtype)[6:]} "
        f"alone: rel RMS {rounding:.3e}")
    check(used <= 1.0, f"attention {name}: outside the tolerance "
                       f"({used:.3f} of it)")
    check(rms <= rtol["rms"] and row <= rtol["row"],
          f"attention {name}: rel RMS {rms:.3e} / worst row {row:.3e} "
          f"outside {rtol}")
    return err


def _cuda_core_ms(q, k, v):
    """Time of the CUDA-core kernel (the earlier design) on a bf16 causal
    call, launched through the library directly so that the wrapper's
    rule, which sends such a call to the tensor cores, is bypassed and
    nothing is counted: the earlier design's time, taken in the same run
    as the new one's."""
    import math
    import torch
    from repro_torch.kernels.attention import kernel as attn_kernel
    lib = attn_kernel.LIBRARY.load()
    B, Sq, H, d = q.shape
    _, Skv, KV, dv = v.shape
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), 1, B, Sq, Skv, H, KV, d,
                                  dv, 1, 0, 0, Skv, 1.0 / math.sqrt(d),
                                  stream)
        check(rc == 0, f"CUDA-core attention launch failed ({rc})")
    return time_ms(call, batch=3, reps=3, warmup=1)


def phase_llama():
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.arbiter import kernel as arb_kernel
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    dev = torch.device(DEVICE)
    cfg = get_config(LLAMA["arch"])
    Bsz, Slen = LLAMA["batch"], LLAMA["seq"]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    V = cfg.vocab_size
    gen = torch.Generator(dev).manual_seed(LLAMA["seed"])
    t0 = time.perf_counter()
    params = init_params(M.model_defs(cfg), gen, dev)
    tokens = torch.randint(0, V, (Bsz, Slen), generator=gen, device=dev)
    torch.cuda.synchronize()
    say(f"[llama] {cfg.name}: {M.count_model_params(cfg)} bf16 parameters, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {H} heads over "
        f"{KV} KV heads of {hd}, d_ff {cfg.d_ff}, vocab {V} (padded "
        f"{cfg.padded_vocab()}); random weights, seed {LLAMA['seed']}; "
        f"init {time.perf_counter() - t0:.2f} s")
    out = {}
    pos = torch.arange(Slen, device=dev)
    with torch.inference_mode():
        # (a) the kernel against its plain version
        x = M._embed(cfg, params, tokens)
        lp0 = M._index(params["blocks"], 0)["s0"]
        q, k, v = L._qkv(cfg, lp0["mixer"], L.apply_norm(cfg, lp0["norm1"],
                                                         x))
        cos, sin = L.rope_cos_sin(pos, hd, cfg.rope_theta)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
        out["max_abs_err"] = _attn_check("layer 0 of the prefill", q, k, v)
        sgen = torch.Generator(dev).manual_seed(7)

        def synth(b, s, h, kv, dtype=torch.bfloat16, d=hd):
            return [torch.randn(shape, generator=sgen, device=dev)
                    .to(dtype) for shape in ((b, s, h, d), (b, s, kv, d),
                                             (b, s, kv, d))]

        _attn_check("synthetic", *synth(Bsz, Slen, H, KV))
        _attn_check("fp32", *synth(2, 2048, H, KV, torch.float32), tc=False)
        _attn_check("window 256", *synth(Bsz, Slen, H, KV), window=256)
        _attn_check("non-causal", *synth(2, 2048, H, KV), causal=False)
        _attn_check("KV = 1", *synth(2, 2048, H, 1))
        _attn_check("Sq 4095 (pad path)", *synth(Bsz, Slen - 1, H, KV))
        _attn_check("Sq < 8", *synth(Bsz, 5, H, KV))
        _attn_check("d 64", *synth(2, 2048, H, KV, d=64))
        _attn_check("d 100 (not a multiple of 8: CUDA cores)",
                    *synth(2, 1000, H, KV, d=100), tc=False)
        _attn_check("kv_len 3000 of 4095", *synth(2, Slen - 1, H, KV),
                    kv_len=3000)
        _attn_check("rows with no valid key (window 2, kv_len 8)",
                    *synth(2, 1000, H, KV), window=2, kv_len=8)
        _attn_check("non-causal, rows with no valid key",
                    *synth(2, 1000, H, KV), causal=False, window=2,
                    kv_len=8)

        nbytes, qk_flops, pv_flops = _attn_work(q, k, v, True)
        flops = qk_flops + pv_flops
        # The function's bound: q.k of bf16 operands is exact on the bf16
        # tensor cores; p.v with fp32 p is p_hi.v + p_lo.v, two more bf16
        # products with exact products and fp32 sums (csrc/attention.cu).
        ops_s = (qk_flops + 2 * pv_flops) / TC_BF16_FLOP_PER_S
        bounds = {"q.k, p_hi.v and p_lo.v on bf16 tensor cores": ops_s,
                  "both products on fp32 CUDA cores (the CUDA-core "
                  "kernel's design)": flops / FP32_FLOP_PER_S,
                  "bytes": nbytes / HBM_BYTES_PER_S}
        out["bound_ms"] = max(ops_s, nbytes / HBM_BYTES_PER_S) * 1e3
        out["bound_by"] = ("operations" if ops_s > nbytes / HBM_BYTES_PER_S
                           else "bytes")
        fa = attn_kernel.flash_attention
        n_tc = fa.launches_tc
        out["ms"] = time_ms(lambda: fa(q, k, v), batch=5, reps=5, warmup=2)
        check(fa.launches_tc > n_tc, "the prefill-shape call did not run "
                                     "on the tensor cores")
        out["cuda_core_ms"] = _cuda_core_ms(q, k, v)
        out["plain_ms"] = time_ms(lambda: attention_ref(q, k, v), batch=1,
                                  reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True,
                                                   enable_gqa=True),
            batch=10, reps=5, warmup=3)
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
        check(_rel(sdpa.transpose(1, 2), attention_ref(q, k, v)) < 1e-2,
              "scaled_dot_product_attention computes another function")
        say(f"[llama] attention kernel at q {tuple(q.shape)}, kv "
            f"{tuple(k.shape)} bf16, causal: tensor cores {out['ms']:.4f} "
            f"ms a call ({out['bound_ms'] / out['ms']:.3f} of the bound); "
            f"CUDA cores (the earlier design) {out['cuda_core_ms']:.4f} ms; "
            f"scaled_dot_product_attention {out['library_ms']:.4f} ms "
            f"({out['bound_ms'] / out['library_ms']:.3f} of the bound, "
            f"with p rounded to bf16); plain attention_ref "
            f"{out['plain_ms']:.3f} ms; {flops / 1e9:.1f} GFLOP of q.k and "
            f"p.v, {nbytes / 1e6:.1f} MB: bounds "
            + ", ".join(f"{n} {b * 1e3:.4f} ms" for n, b in bounds.items())
            + f"; the function's bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']})")
        del x, q, k, v, qt, kt, vt, sdpa

        # (b) the main path: one prefill of Bsz x Slen tokens on the kernel
        M.forward_prefill(cfg, params, tokens)        # warm-up, not counted
        torch.cuda.synchronize()
        attn_kernel.flash_attention.launches = 0
        attn_kernel.flash_attention.launches_tc = 0
        ssd_kernel.ssd_scan.launches = 0
        arb_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = M.forward_prefill(cfg, params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"] = attn_kernel.flash_attention.launches
        out["launches_tc"] = attn_kernel.flash_attention.launches_tc
        check(out["launches"] == out["launches_tc"] == cfg.num_layers,
              f"prefill launched the attention kernel {out['launches']} "
              f"times, {out['launches_tc']} of them on the tensor cores; "
              f"expected one per layer ({cfg.num_layers}), all on them")
        check(ssd_kernel.ssd_scan.launches == 0
              and not any(arb_kernel.launch_counts().values()),
              "the prefill launched an SSD or arbitration kernel")
        check(logits.shape == (Bsz, cfg.padded_vocab())
              and bool(torch.isfinite(logits).all())
              and bool((logits[:, V:] == -1e9).all()),
              "prefill logits: wrong shape, not finite or padding unmasked")
        out["tokens_per_s"] = Bsz * Slen / wall
        say(f"[llama] prefill {Bsz} x {Slen} tokens on the kernel: "
            f"{wall * 1e3:.1f} ms, {out['tokens_per_s']:.0f} tokens/s; "
            f"flash_attention launches {out['launches']}, on the tensor "
            f"cores {out['launches_tc']}")
        _, pwall, ev = _profiled(lambda: M.forward_prefill(cfg, params,
                                                           tokens))
        busy = sum(e[2] for e in ev)
        hits = [e for e in ev if "flash_attention_tc_kernel" in e[0]]
        check(len(hits) == 1 and hits[0][1] == cfg.num_layers
              and not any("flash_attention_kernel" in e[0] for e in ev),
              f"profiler: flash_attention_tc_kernel launched "
              f"{[h[1] for h in hits]} times, expected {cfg.num_layers} "
              f"and no CUDA-core attention kernel")
        attn_us = hits[0][2]
        gemm_us = sum(e[2] for e in ev if "gemm" in e[0].lower())
        out["device_ms_per_launch"] = attn_us / cfg.num_layers / 1e3
        say(f"[llama] profiled prefill: {pwall * 1e3:.1f} ms wall, device "
            f"busy {busy / 1e6 / pwall:.4f}, {busy / 1e3:.2f} ms device "
            f"time: attention kernel {attn_us / 1e3:.2f} ms "
            f"({attn_us / busy:.3f}), GEMM {gemm_us / 1e3:.2f} ms "
            f"({gemm_us / busy:.3f}); {out['device_ms_per_launch']:.4f} ms "
            f"device time per flash_attention launch")
        for us, cnt, key in sorted(((e[2], e[1], e[0]) for e in ev),
                                   reverse=True)[:6]:
            say(f"[llama]   {us / 1e3:8.2f} ms {cnt:5d}x {key[:80]}")

        attn_kernel.flash_attention.launches = 0
        (plain, _), pwall, ev = _profiled(
            lambda: M.forward_prefill(cfg, params, tokens, use_kernel=False))
        check(attn_kernel.flash_attention.launches == 0
              and not any("flash_attention" in e[0] for e in ev),
              "the plain prefill launched the attention kernel")
        err = _rel(logits[:, :V], plain[:, :V])
        agree = float((logits[:, :V].argmax(-1)
                       == plain[:, :V].argmax(-1)).float().mean())
        out["plain_prefill_ms"] = pwall * 1e3
        say(f"[llama] plain prefill (blockwise_attention, no attention "
            f"launch): {pwall * 1e3:.1f} ms wall; last-token logits rel RMS "
            f"{err:.4f} (tolerance {LLAMA_TOL['logits']}), argmax agrees "
            f"on {agree:.2f} of rows")
        check(err <= LLAMA_TOL["logits"], "kernel and plain prefill logits "
                                          "differ beyond the tolerance")
        del plain

        # layer by layer on the same inputs: kernel vs plain attention, and
        # one decode step on the first S-1 keys vs the last prefill row
        x = M._embed(cfg, params, tokens)
        worst = dict(layer=0.0, decode_layer=0.0)
        for l in range(cfg.num_layers):
            lp = M._index(params["blocks"], l)["s0"]
            h = L.apply_norm(cfg, lp["norm1"], x)
            yk, (k, v) = L.self_attention(cfg, lp["mixer"], h, pos)
            yp, _ = L.self_attention(cfg, lp["mixer"], h, pos,
                                     use_kernel=False)
            worst["layer"] = max(worst["layer"], _rel(yk, yp))
            yd, _ = L.self_attention_decode(
                cfg, lp["mixer"], h[:, -1:], Slen - 1,
                {"k": k[:, :-1], "v": v[:, :-1]})
            worst["decode_layer"] = max(worst["decode_layer"],
                                        _rel(yd, yk[:, -1:]))
            x, _ = M._ffn(cfg, lp, x + yk)
        say(f"[llama] layer by layer, same inputs: kernel vs plain "
            f"attention rel RMS <= {worst['layer']:.2e} (tolerance "
            f"{LLAMA_TOL['layer']}); decode at {Slen - 1} on the first "
            f"{Slen - 1} keys vs the prefill's last row rel RMS <= "
            f"{worst['decode_layer']:.2e} (tolerance "
            f"{LLAMA_TOL['decode_layer']})")
        for key in ("layer", "decode_layer"):
            check(worst[key] <= LLAMA_TOL[key],
                  f"layer by layer: {key} beyond the tolerance")
        del x, h, yk, yp, k, v

        # (c) prefill(S-1) + one decode step vs the S-token prefill
        _, caches = M.forward_prefill(cfg, params, tokens[:, :-1])
        step, _ = M.forward_decode(cfg, params, tokens[:, -1:], Slen - 1,
                                   caches)
        err = _rel(step[:, :V], logits[:, :V])
        say(f"[llama] prefill({Slen - 1}) + forward_decode at {Slen - 1} vs "
            f"prefill({Slen}): logits rel RMS {err:.4f} (tolerance "
            f"{LLAMA_TOL['decode_logits']})")
        check(bool(torch.isfinite(step).all())
              and err <= LLAMA_TOL["decode_logits"],
              "prefill + decode differs from the prefill")
        del caches, step, logits
    torch.cuda.empty_cache()

    # (d) the serving loop at full width
    torch.cuda.synchronize()
    attn_kernel.flash_attention.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", LLAMA["arch"], *SERVE_ARGV, "--device",
                      DEVICE])
    wall = time.perf_counter() - t0
    got = {k: res[k] for k in SERVE_EXPECTED}
    check(got == SERVE_EXPECTED, f"serve statistics {got} != the JAX "
                                 f"package's {SERVE_EXPECTED}")
    out["decode_steps_per_s"] = res["steps"] / wall
    say(f"[llama] serve {LLAMA['arch']} {' '.join(SERVE_ARGV)}: {got} == "
        f"the JAX package's; {wall:.2f} s wall (parameter init included), "
        f"{out['decode_steps_per_s']:.1f} decode steps/s at batch "
        f"{SERVE_ARGV[-1]}; flash_attention launches "
        f"{attn_kernel.flash_attention.launches} (decode attends one "
        f"token: decode_attention)")
    out["decode"] = _decode_window(cfg, params, dev, "llama")
    return out


# ------------------------------------------------------------- phase 9 -----

FAULT_GOLDEN = ROOT / "tests" / "golden" / "faults_enabled.json"
# the "small" golden runs phase 9a replays on each kernel backend, at
# once in worker processes (all of them replay on the CPU,
# tests/test_torch_golden_faults.py, and the windows runs on every
# backend in the card tests)
FAULT_REPLAYS = {"cuda": ("homa-lossy-ecmp", "homa-windows-adaptive"),
                 "fused": ("pias-lossy-ecmp", "homa-windows-flowlet")}
FAULT_HANDOFF = 1500             # 9b's window starts here: both failure
                                 # windows of the golden's "full" are open
FAULT_SWEEP_SEEDS = (0, 1, 2, 3)
FAULT_SWEEP_SLOTS = 2000         # phase 9c's depth


def _fault_golden():
    return json.loads(FAULT_GOLDEN.read_text())


def _fault_replay_job(name, backend):
    """One run of the fault golden's "small" part (in a worker process):
    the keys that differ, the launches, f_lost, retx and the seconds."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (FabricConfig, SimConfig, make_messages,
                                  simulate)
    from repro_torch.kernels.arbiter import kernel
    small = _fault_golden()["small"]
    meta, run = small["meta"], {r["name"]: r for r in small["runs"]}[name]
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    fab = FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                       up_cap=meta["up_cap"], routing=run["routing"],
                       faults=run["faults"])
    r = simulate(SimConfig(protocol=run["protocol"], n_hosts=meta["n_hosts"],
                           max_slots=meta["max_slots"],
                           ring_cap=meta["ring_cap"], fabric=fab,
                           backend=backend, device=DEVICE), tbl)
    got = {"completion": [int(x) for x in r.completion],
           "retx_chunks": [int(x) for x in r.retx_chunks],
           "msg_lost_chunks": [int(x) for x in r.msg_lost_chunks],
           "fault_lost_chunks": int(r.fault_lost_chunks),
           "lost_chunks": int(r.lost_chunks),
           "tor_up_lost_chunks": int(r.tor_up_lost_chunks),
           "busy": [round(float(x), 8) for x in r.busy_frac]}
    return ([k for k in got if got[k] != run[k]], kernel.launch_counts(),
            got["fault_lost_chunks"], sum(got["retx_chunks"]),
            time.perf_counter() - t0)


def _fault_full_config(backend, routing=None, max_slots=None, seed=None):
    """The golden's "full" point: 144 hosts, 9 racks, W3 at load 0.8,
    homa, every kind of fault at once; ``routing`` / ``max_slots`` /
    ``seed`` (the table's) override it for phase 9c."""
    from repro_torch.core import (FabricConfig, SimConfig, make_messages)
    g = _fault_golden()["full"]
    m = g["meta"]
    tbl = make_messages(m["workload"], n_hosts=m["n_hosts"], load=m["load"],
                        n_messages=m["n_messages"],
                        slot_bytes=m["slot_bytes"],
                        seed=m["seed"] if seed is None else seed)
    cfg = SimConfig(protocol=m["protocol"], n_hosts=m["n_hosts"],
                    ring_cap=m["ring_cap"],
                    max_slots=max_slots or m["slots"],
                    fabric=FabricConfig(racks=m["racks"],
                                        oversub=m["oversub"],
                                        up_cap=m["up_cap"],
                                        routing=routing or m["routing"],
                                        faults=g["faults"]),
                    backend=backend, device=DEVICE)
    return cfg, tbl


def _fault_job(kind, backend):
    """One run of phase 9b/9c in a worker process:

      ("full", backend)   9b's point to the golden's depth: the final
                          state, the state at FAULT_HANDOFF (cuda only),
                          launches, seconds
      ("sweep", backend)  9c's B = 4 batch under adaptive routing: its
                          SweepStats, launches, seconds
    """
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import SweepSpec, run_sweep
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.sim import (_init_state, host_state, prepare,
                                      run_slots, stack_static)
    from repro_torch.kernels.arbiter import kernel
    kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "full":
        cfg, tbl = _fault_full_config(backend)
        proto = get_protocol(cfg.protocol)
        S1, alloc = prepare(cfg, tbl)
        S, n_sched = stack_static([S1]), proto.n_sched(cfg, alloc)
        st = _init_state(cfg, proto, len(tbl.size))
        st = run_slots(cfg, proto, S, st, n_sched, 0, FAULT_HANDOFF)
        handoff = host_state(st) if backend == "cuda" else None
        st = run_slots(cfg, proto, S, st, n_sched, FAULT_HANDOFF,
                       cfg.max_slots)
        out = (host_state(st), handoff)
    else:
        tables = [_fault_full_config("fused", seed=sd)[1]
                  for sd in FAULT_SWEEP_SEEDS]
        cfg = _fault_full_config(backend, routing="adaptive",
                                 max_slots=FAULT_SWEEP_SLOTS)[0]
        out = run_sweep(cfg, SweepSpec(tables=tables, shared_alloc=True,
                                       chunk_slots=1000, streaming=True))
    torch.cuda.synchronize()
    return out, kernel.launch_counts(), time.perf_counter() - t0


def _conserved(st: dict) -> bool:
    """Chunk conservation of run 0 (``tests/test_faults.py``): sent +
    retx == recv + buffered (both tiers) + lost (both rings) + f_lost."""
    def tot(k):
        return int(st[k][0].sum())
    return (tot("sent") + tot("retx") == tot("recv") + tot("r_valid")
            + tot("u_valid") + tot("lost") + tot("u_lost") + tot("f_lost"))


def phase_faults():
    """9a: golden replays on both kernel backends; 9b: the full-width
    lossy run on every backend, state identical key by key at the
    golden's depth and equal to the JAX package's there; its profiled
    window under failure, with no host sync; 9c: a fault sweep of four
    full-width runs on both kernel backends. The runs of 9a-9c go to the
    worker pool at once, longest first; the windows run here."""
    import numpy as np
    import torch
    from repro_torch.core.faults import REWIND_KEYS
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.results import state_digests
    from repro_torch.core.sim import prepare, stack_static
    golden = _fault_golden()
    out = {"launches": {}, "rate": {}}
    backends = ("cuda", "fused", "reference")
    replays = [(name, backend) for backend, names in FAULT_REPLAYS.items()
               for name in names]
    res = _in_workers_each(
        [(_fault_job, ("full", b)) for b in backends]
        + [(_fault_job, ("sweep", b)) for b in ("fused", "cuda")]
        + [(_fault_replay_job, job) for job in replays])

    # ---- 9a
    slots = golden["small"]["meta"]["max_slots"]
    for (name, backend), (bad, n, f_lost, retx, secs) in zip(replays,
                                                             res[5:]):
        check(not bad, f"fault golden {name} {backend}: differs in {bad}")
        want = ({"priority_arbiter": 2 * slots, "srpt_topk": slots}
                if backend == "cuda" else {"fused_slot": slots})
        want["ring_insert"] = 3 * slots
        check(all(n[k] == want.get(k, 0) for k in n),
              f"fault golden {name} {backend}: launches {n}")
        say(f"[faults] golden {name} {backend}: bit-exact, f_lost {f_lost}, "
            f"retx {retx}, launches {n} ({secs:.1f} s in a worker)")

    # ---- 9b
    full = golden["full"]
    slots = full["meta"]["slots"]
    out["label"] = f"{full['meta']['n_hosts']} hosts, {slots} slots"
    states, handoff = {}, None
    for backend, ((st, snap), n, secs) in zip(backends, res[:3]):
        states[backend] = st
        if snap is not None:
            handoff = snap
        out["launches"][backend] = n
        out["rate"][backend] = slots / secs
        say(f"[faults] full width, {slots} slots, {backend}: {secs:.2f} s "
            f"in a worker, {slots / secs:.1f} slots/s; launches {n}")
    check(out["launches"]["cuda"] == {"priority_arbiter": 2 * slots,
                                      "srpt_topk": slots, "fused_slot": 0,
                                      "fused_slot_batch": 0,
                                      "ring_insert": 3 * slots},
          f"fault run launches {out['launches']['cuda']} on cuda")
    check(out["launches"]["fused"] == {"priority_arbiter": 0,
                                       "srpt_topk": 0, "fused_slot": slots,
                                       "fused_slot_batch": 0,
                                       "ring_insert": 3 * slots},
          f"fault run launches {out['launches']['fused']} on fused")
    check(set(out["launches"]["reference"].values()) == {0},
          "the reference backend launched a kernel")
    ref = states["reference"]
    for backend in ("cuda", "fused"):
        st = states[backend]
        check(set(st) == set(ref), f"{backend}: state keys differ")
        for k in ref:
            check(st[k].dtype == ref[k].dtype
                  and np.array_equal(st[k], ref[k]),
                  f"slot {slots}: {backend} and reference differ in {k}")
    # the JAX package's state has no per-run rewind counters
    digests = state_digests({k: v[0] for k, v in ref.items()
                             if k not in REWIND_KEYS})
    check(digests == full["digests"],
          f"slot {slots}: state differs from the JAX package's in "
          f"{sorted(k for k in digests if digests[k] != full['digests'].get(k))}")
    check([int(x) for x in ref["completion"][0]] == full["completion"],
          "completions differ from the JAX package's")
    counters = {k: int(ref[k][0].sum()) for k in full["counters"]}
    check(counters == full["counters"],
          f"counters {counters} != the JAX package's {full['counters']}")
    check(_conserved(ref), f"chunk conservation fails: {counters}")
    check(counters["f_lost"] > 0 and counters["retx"] >= counters["f_lost"],
          f"no fault loss or too few retransmissions: {counters}")
    done = int((ref["completion"][0] >= 0).sum())
    say(f"[faults] every state key identical on cuda, fused and reference "
        f"at slot {slots}, and equal to the JAX package's (digests, "
        f"completions, counters); {counters}; {done} of "
        f"{len(full['completion'])} messages complete")
    out["counters"] = counters

    # the window: from the staged run's state at FAULT_HANDOFF, inside
    # both failure windows, brought back onto the card; 20 slots each
    # under sync debug mode "error"
    cfg, tbl = _fault_full_config("cuda")
    proto = get_protocol(cfg.protocol)
    S1, alloc = prepare(cfg, tbl)
    S, n_sched = stack_static([S1]), proto.n_sched(cfg, alloc)
    st = {k: torch.from_numpy(v).to(DEVICE) for k, v in handoff.items()}
    cfgs = {b: _fault_full_config(b)[0] for b in ("cuda", "fused")}
    out["window"] = _windows(cfgs, S, st, n_sched, FAULT_HANDOFF,
                             WINDOW_SLOTS, "faults")

    # ---- 9c
    stats = {}
    n_runs = len(FAULT_SWEEP_SEEDS)
    for backend, (stats[backend], n, secs) in zip(("fused", "cuda"),
                                                  res[3:5]):
        out["launches"][f"sweep_{backend}"] = n
        out["rate"][f"sweep_{backend}"] = n_runs * FAULT_SWEEP_SLOTS / secs
        say(f"[faults] sweep: {n_runs} full-width runs (seeds "
            f"{FAULT_SWEEP_SEEDS}), adaptive routing, {FAULT_SWEEP_SLOTS} "
            f"slots, {backend}: {secs:.2f} s in a worker, "
            f"{n_runs * FAULT_SWEEP_SLOTS / secs:.1f} runs*slots/s; "
            f"launches {n}")
    check(out["launches"]["sweep_fused"]["fused_slot_batch"]
          == FAULT_SWEEP_SLOTS
          and out["launches"]["sweep_fused"]["fused_slot"] == 0,
          "fault sweep: expected one fused_slot_batch launch a slot")
    check(out["launches"]["sweep_cuda"]["priority_arbiter"]
          == 2 * FAULT_SWEEP_SLOTS
          and out["launches"]["sweep_cuda"]["srpt_topk"]
          == FAULT_SWEEP_SLOTS, "fault sweep: staged launches")
    for i, (a, b) in enumerate(zip(stats["fused"], stats["cuda"])):
        check(np.array_equal(a.hist, b.hist)
              and np.array_equal(a.prio_drained_bytes, b.prio_drained_bytes),
              f"fault sweep run {i}: histograms differ")
        for f in ("n_complete", "busy_frac", "wasted_frac",
                  "uplink_busy_frac", "q_mean_bytes", "q_max_bytes",
                  "lost_chunks", "tor_up_busy_frac", "fault_lost_chunks",
                  "retx_chunks"):
            check(getattr(a, f) == getattr(b, f),
                  f"fault sweep run {i}: fused and cuda differ in {f}")
    check(all(s.fault_lost_chunks > 0 and s.n_counted > 0
              for s in stats["fused"]),
          "fault sweep: a run lost nothing or completed nothing")
    say(f"[faults] sweep statistics identical on fused and cuda, f_lost "
        f"and retx included: f_lost "
        f"{[s.fault_lost_chunks for s in stats['fused']]}, retx "
        f"{[s.retx_chunks for s in stats['fused']]}, completed "
        f"{[s.n_complete for s in stats['fused']]}")
    return out


# ------------------------------------------------------------ phase 10 -----

HOST_GOLDEN = ROOT / "tests" / "golden" / "host_trace_enabled.json"
HOST_HANDOFF = 2000              # 10b's window starts here (steady state)
HOST_SWEEP_SEEDS = (0, 1, 2, 3)
HOST_SWEEP_SLOTS = 2000          # phase 10c's depth
CAPTURE_SLOTS = 500              # the capture-cost runs' depth and repeats
CAPTURE_REPEATS = 2


def _host_golden():
    return json.loads(HOST_GOLDEN.read_text())


def _golden_script():
    """``scripts/make_torch_host_trace_golden.py`` as a module: its
    ``record``/``differences`` (JAX is imported only where it writes
    the golden)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_host_trace_golden",
        ROOT / "scripts" / "make_torch_host_trace_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_full_config(backend, traced=True, max_slots=None, seed=None):
    """The golden's "full" point: 144 hosts, 9 racks, W3 at load 0.4,
    homa behind ``kernel_stack`` with ``TraceConfig(stride=16,
    ledger_cap=4096)``; ``traced=False`` drops the trace, ``max_slots`` /
    ``seed`` (the table's) override the depth and table for 10c."""
    from repro_torch.core import (FabricConfig, SimConfig, TraceConfig,
                                  make_messages)
    g = _host_golden()["full"]
    m = g["meta"]
    tbl = make_messages(m["workload"], n_hosts=m["n_hosts"], load=m["load"],
                        n_messages=m["n_messages"],
                        slot_bytes=m["slot_bytes"],
                        seed=m["seed"] if seed is None else seed)
    cfg = SimConfig(protocol=m["protocol"], n_hosts=m["n_hosts"],
                    ring_cap=m["ring_cap"],
                    max_slots=max_slots or m["slots"],
                    fabric=FabricConfig(racks=m["racks"],
                                        oversub=m["oversub"],
                                        up_cap=m["up_cap"]),
                    host=m["host"],
                    trace=TraceConfig(**g["trace"]) if traced else None,
                    backend=backend, device=DEVICE)
    return cfg, tbl


def _host_job(kind, arg, backend):
    """One run of phase 10 in a worker process:

      ("replay", name, backend)   a run of the golden's "small" part:
                                  the fields that differ, launches, s
      ("full", traced, backend)   10b's point, 4000 slots: final state,
                                  the state at HOST_HANDOFF (traced
                                  cuda run only), launches, s
      ("sweep", None, backend)    10c's B = 4 streaming sweep: its
                                  SweepStats, launches, s
    """
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels.arbiter import kernel
    kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "replay":
        from repro_torch.core import (FabricConfig, SimConfig, TraceConfig,
                                      make_messages, simulate)
        gs = _golden_script()
        small = _host_golden()["small"]
        meta, run = small["meta"], {r["name"]: r
                                    for r in small["runs"]}[arg]
        tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                            load=meta["load"],
                            n_messages=meta["n_messages"],
                            slot_bytes=meta["slot_bytes"], seed=meta["seed"])
        fab = gs.small_fabric(meta, run["topology"])
        r = simulate(SimConfig(
            protocol=run["protocol"], n_hosts=meta["n_hosts"],
            max_slots=meta["max_slots"], ring_cap=meta["ring_cap"],
            fabric=None if fab is None else FabricConfig(**fab),
            host=run["host_cfg"],
            trace=None if run["trace_cfg"] is None
            else TraceConfig(**run["trace_cfg"]),
            backend=backend, device=DEVICE), tbl, return_state=True)
        out = gs.differences(run, gs.record(r, r.state))
    elif kind == "full":
        from repro_torch.core.protocols import get_protocol
        from repro_torch.core.sim import (_init_state, host_state, prepare,
                                          run_slots, stack_static)
        cfg, tbl = _host_full_config(backend, traced=arg)
        proto = get_protocol(cfg.protocol)
        S1, alloc = prepare(cfg, tbl)
        S, n_sched = stack_static([S1]), proto.n_sched(cfg, alloc)
        st = _init_state(cfg, proto, len(tbl.size))
        st = run_slots(cfg, proto, S, st, n_sched, 0, HOST_HANDOFF)
        handoff = host_state(st) if arg and backend == "cuda" else None
        st = run_slots(cfg, proto, S, st, n_sched, HOST_HANDOFF,
                       cfg.max_slots)
        out = (host_state(st), handoff)
    else:
        from repro_torch.core import SweepSpec, run_sweep
        tables = [_host_full_config("fused", seed=sd)[1]
                  for sd in HOST_SWEEP_SEEDS]
        cfg = _host_full_config(backend, max_slots=HOST_SWEEP_SLOTS)[0]
        out = run_sweep(cfg, SweepSpec(tables=tables, shared_alloc=True,
                                       chunk_slots=1000, streaming=True))
    torch.cuda.synchronize()
    return out, kernel.launch_counts(), time.perf_counter() - t0


def _host_conserved(st: dict) -> bool:
    """Chunk conservation of run 0 through the RX ring: sent == recv +
    buffered (both tiers) + lost (both rings) + held in the RX ring."""
    def tot(k):
        return int(st[k][0].sum())
    return tot("sent") == (tot("recv") + tot("r_valid") + tot("u_valid")
                           + tot("lost") + tot("u_lost")
                           + int((st["h_rx_tail"][0]
                                  - st["h_rx_head"][0]).sum()))


def phase_host():
    """10a: the host/trace golden's small runs on both kernel backends;
    10b: the full-width point with the kernel_stack host and tracing on
    every backend (and untraced), state identical key by key at slot 4000
    and equal to the JAX package's, a window from slot 2000 with no host
    sync and profiled, and the capture's cost; 10c: a B = 4 streaming
    sweep on both kernel backends, host and trace summaries identical.
    The runs of 10a-10c go to worker processes at once, longest first."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import ReceiverPolicy, simulate
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.results import state_digests
    from repro_torch.core.sim import prepare, stack_static
    from repro_torch.core.telemetry import TraceConfig
    golden = _host_golden()
    full = golden["full"]
    slots = full["meta"]["slots"]
    small = golden["small"]
    out = {"launches": {}, "rate": {}}

    # 10a replays each small run once, on cuda and fused in turns (the
    # card tests replay every run on both)
    jobs = ([("full", True, b) for b in ("cuda", "fused", "reference")]
            + [("full", False, "cuda")]
            + [("sweep", None, b) for b in ("fused", "cuda")]
            + [("replay", r["name"], ("cuda", "fused")[i % 2])
               for i, r in enumerate(small["runs"])])
    t0 = time.perf_counter()
    res = dict(zip(jobs, _in_workers(_host_job, jobs)))
    say(f"[host] {len(jobs)} runs of 10a-10c in {GOLDEN_WORKERS} worker "
        f"processes: {time.perf_counter() - t0:.1f} s")

    # ---- 10a
    n_small = small["meta"]["max_slots"]
    runs = {r["name"]: r for r in small["runs"]}
    for (kind, name, backend), (bad, n, secs) in res.items():
        if kind != "replay":
            continue
        check(not bad, f"host golden {name} {backend}: differs in {bad}")
        run = runs[name]
        if backend == "cuda":
            # one arbiter launch a tier a slot; a top-K a slot where the
            # receiver selects a grant set
            recv = type(get_protocol(run["protocol"]).receiver)
            want = {"priority_arbiter": n_small
                    * (1 if run["topology"] == "switch" else 2),
                    "srpt_topk": n_small if recv.grant_problem
                    is not ReceiverPolicy.grant_problem else 0}
        else:
            want = {"fused_slot": n_small}
        # one ring insert a slot on a switch, three on the fabric
        want["ring_insert"] = n_small * (1 if run["topology"] == "switch"
                                         else 3)
        check(all(n[k] == want.get(k, 0) for k in n),
              f"host golden {name} {backend}: launches {n}, want {want}")
    say(f"[host] 10a: the {len(small['runs'])} runs of the host/trace "
        f"golden's small part bit-exact, on cuda and fused in turns (every "
        f"state array by digest, ledger rows, trace scalars, host summary)")

    # ---- 10b
    states = {}
    for backend in ("cuda", "fused", "reference"):
        (st, handoff), n, secs = res[("full", True, backend)]
        states[backend] = st
        if handoff is not None:
            out["handoff"] = handoff
        out["launches"][backend] = n
        out["rate"][backend] = slots / secs
        say(f"[host] 10b full width, {slots} slots, {backend}: {secs:.2f} s "
            f"in a worker, {slots / secs:.1f} slots/s; launches {n}")
    check(out["launches"]["cuda"] == {"priority_arbiter": 2 * slots,
                                      "srpt_topk": slots, "fused_slot": 0,
                                      "fused_slot_batch": 0,
                                      "ring_insert": 3 * slots},
          f"host run launches {out['launches']['cuda']} on cuda")
    check(out["launches"]["fused"] == {"priority_arbiter": 0,
                                       "srpt_topk": 0, "fused_slot": slots,
                                       "fused_slot_batch": 0,
                                       "ring_insert": 3 * slots},
          f"host run launches {out['launches']['fused']} on fused")
    check(set(out["launches"]["reference"].values()) == {0},
          "the reference backend launched a kernel")
    ref = states["reference"]
    for backend in ("cuda", "fused"):
        st = states[backend]
        check(set(st) == set(ref), f"{backend}: state keys differ")
        for k in ref:
            check(st[k].dtype == ref[k].dtype
                  and np.array_equal(st[k], ref[k]),
                  f"slot {slots}: {backend} and reference differ in {k}")
    digests = state_digests({k: v[0] for k, v in ref.items()})
    check(digests == full["digests"],
          f"slot {slots}: state differs from the JAX package's in "
          f"{sorted(k for k in digests if digests[k] != full['digests'].get(k))}")
    check([int(x) for x in ref["completion"][0]] == full["completion"],
          "completions differ from the JAX package's")
    gs = _golden_script()
    counters = gs.full_counters({k: v[0] for k, v in ref.items()})
    check(counters == full["counters"],
          f"counters {counters} != the JAX package's {full['counters']}")
    check(_host_conserved(ref), f"chunk conservation fails: {counters}")
    check(counters["rx_ring"] > 0 and counters["h_tx_defer"] > 0,
          f"the host stage held nothing back: {counters}")
    (plain_st, _), _, secs = res[("full", False, "cuda")]
    check(np.array_equal(plain_st["completion"], ref["completion"]),
          "tracing changed the completions of the full-width host run")
    check(not any(k.startswith("tr_") for k in plain_st),
          "the untraced run carries trace state")
    done = int((ref["completion"][0] >= 0).sum())
    say(f"[host] 10b: every state key identical on cuda, fused and "
        f"reference at slot {slots}, equal to the JAX package's (digests, "
        f"completions, counters {counters}); chunks conserved through the "
        f"RX ring; {done} of {len(full['completion'])} messages complete; "
        f"completions equal to the untraced run's ({secs:.2f} s in a worker)")

    # the window: from the staged run's state at HOST_HANDOFF
    cfg, tbl = _host_full_config("cuda")
    proto = get_protocol(cfg.protocol)
    S1, alloc = prepare(cfg, tbl)
    S, n_sched = stack_static([S1]), proto.n_sched(cfg, alloc)
    st = {k: torch.from_numpy(v).to(DEVICE)
          for k, v in out.pop("handoff").items()}
    cfgs = {b: _host_full_config(b)[0] for b in ("cuda", "fused")}
    t0 = time.perf_counter()
    out["window"] = _windows(cfgs, S, st, n_sched, HOST_HANDOFF,
                             WINDOW_SLOTS, "host")
    say(f"[host] the windows: {time.perf_counter() - t0:.1f} s")

    # the capture's cost: the wall-clock plane, traced vs capture off
    t0 = time.perf_counter()
    cost = {}
    for name, trace in (("traced", TraceConfig(
            stride=16, ledger_cap=4096, wallclock=True,
            wallclock_repeats=CAPTURE_REPEATS)),
            ("off", TraceConfig(enabled=False, wallclock=True,
                                wallclock_repeats=CAPTURE_REPEATS))):
        c = dataclasses.replace(_host_full_config("cuda")[0],
                                max_slots=CAPTURE_SLOTS, trace=trace)
        r = simulate(c, tbl)
        t = r.trace.timings if r.trace is not None \
            else r.trace_summary["timings"]
        check(set(t) == {"trace_s", "compile_s", "execute_s",
                         "execute_repeats"}, f"wallclock keys {sorted(t)}")
        cost[name] = t
    out["capture"] = cost
    out["capture_pct"] = (cost["traced"]["execute_s"]
                          / cost["off"]["execute_s"] - 1) * 100
    say(f"[host] capture cost, cuda, {CAPTURE_SLOTS} slots, best of "
        f"{CAPTURE_REPEATS}: traced {cost['traced']}, capture off "
        f"{cost['off']}: {out['capture_pct']:+.1f}% execute time "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- 10c
    stats = {}
    for backend in ("fused", "cuda"):
        stats[backend], n, secs = res[("sweep", None, backend)]
        out["launches"][f"sweep_{backend}"] = n
        out["rate"][f"sweep_{backend}"] = \
            len(HOST_SWEEP_SEEDS) * HOST_SWEEP_SLOTS / secs
        say(f"[host] 10c sweep: {len(HOST_SWEEP_SEEDS)} full-width runs "
            f"(seeds {HOST_SWEEP_SEEDS}), {HOST_SWEEP_SLOTS} slots, "
            f"{backend}: {secs:.2f} s in a worker, "
            f"{out['rate'][f'sweep_{backend}']:.1f} runs*slots/s; "
            f"launches {n}")
    check(out["launches"]["sweep_fused"]["fused_slot_batch"]
          == HOST_SWEEP_SLOTS
          and out["launches"]["sweep_fused"]["fused_slot"] == 0,
          "host sweep: expected one fused_slot_batch launch a slot")
    check(out["launches"]["sweep_cuda"]["priority_arbiter"]
          == 2 * HOST_SWEEP_SLOTS
          and out["launches"]["sweep_cuda"]["srpt_topk"]
          == HOST_SWEEP_SLOTS, "host sweep: staged launches")
    for i, (a, b) in enumerate(zip(stats["fused"], stats["cuda"])):
        check(np.array_equal(a.hist, b.hist)
              and a.summary() == b.summary(),
              f"host sweep run {i}: fused and cuda summaries differ")
    check(all(s.summary()["host"] and s.summary()["trace"]
              and s.n_counted > 0 for s in stats["fused"]),
          "host sweep: a run has no host or trace summary, or completed "
          "nothing")
    say(f"[host] 10c: host and trace summaries identical on fused and "
        f"cuda: host {[s.summary()['host'] for s in stats['fused']][:1]}, "
        f"events seen "
        f"{[s.trace_summary['n_events_seen'] for s in stats['fused']]}, "
        f"completed {[s.n_complete for s in stats['fused']]}")
    return out


# ------------------------------------------------------------ phase 11 -----

TRAIN = dict(arch="mamba2-130m", seed=0)
TRAIN_FULL = dict(seq=2048, batch=16, steps=5)   # 11a: grad_accum 2
TRAIN_SMALL = dict(seq=512, batch=4)             # 11b, 11e
TRAIN_CKPT = dict(steps=12, seq=1024, batch=8, every=5, crash=7)   # 11d
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, total_steps=100, weight_decay=0.01)
# names of the port's hand-written kernels: the train step launches none
OUR_KERNELS = ("ssd_cb_kernel", "ssd_chunk_state", "ssd_state_pass",
               "ssd_output", "flash_attention", "priority_arbiter",
               "srpt_topk", "fused_slot")
# 11b/11e: a variant's step against the plain step (grad_accum 1, remat),
# from one state on one batch at full width: the loss (relative) and the
# gradient, as AdamW's first m ((1 - b1) x the clipped gradient), in
# relative RMS over the whole tree. 11b runs in fp32: with bf16 weights
# and activations the full-width gradient is mostly rounding noise (one
# H100: grad_accum 2 vs 1 at rel RMS 1.12 in bf16, and 11b prints the
# bf16 plain step against the fp32 one), so no bound below 1 holds
# there. 11e's world of one computes the plain step's
# bf16 function exactly (the sync of one rank is the identity). Each
# bound ~4x the largest value measured on one H100 (NVIDIA H100 80GB
# HBM3, 700.00 W): 11b fp32 grad_accum 2 loss 8.7e-8, gradient 2.2e-3;
# remat off and 11e's homa and naive steps 0 (the card computes the
# step deterministically: a repeated plain step gives the same bits)
TRAIN_TOL = dict(loss=4e-7, grad=1e-2)
# 11c: the card's step against the CPU's, reduced config, fp32 and bf16:
# loss (relative), gradient leaves (worst leaf's relative RMS), the
# update (p_new - p, relative RMS over the tree); ~4x the values
# measured on that card: fp32 8.5e-8, 6.9e-6, 1.2e-4 (an Adam update
# flips sign where a gradient element is near 0); bf16 8.5e-7, 3.2e-3,
# 2.3e-2 (rounding noise, which two layers of width 64 amplify little)
TRAIN_CPU_TOL = {"float32": dict(loss=4e-7, grad=3e-5, update=5e-4),
                 "bfloat16": dict(loss=4e-6, grad=1.3e-2, update=0.1)}
# 11d: |resumed loss - uninterrupted loss| at steps 6-12, as the
# launcher prints them (6 decimals). Two uninterrupted runs and the
# resumed one printed identical losses on that card, so 4x their spread
# is 0: the bound is the print's resolution
TRAIN_RESUME_TOL = 1e-6


def _tree_rel(got, want) -> float:
    """Relative RMS error over a whole tree (every leaf's elements)."""
    from repro_torch.tree import flatten
    num = den = 0.0
    for g, w in zip(flatten(got), flatten(want)):
        num += float(((g.float() - w.float()) ** 2).sum())
        den += float((w.float() ** 2).sum())
    return (num / den) ** 0.5


def _train_losses(text: str) -> dict:
    import re
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[train\] step (\d+) loss ([-0-9.eE+na]+)", text)}


def phase_train():
    """11a: the full-width train step (remat, grad_accum 2) 5 steps, no
    kernel launched; 11b: its grad_accum and remat variants against the
    plain step; 11c: the card's step against the CPU's; 11d: crash and
    resume of ``launch.train`` in subprocesses; 11e: the data-parallel
    step on a NCCL world of one (homa, naive, int8)."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distrib import homa_collectives as HC
    from repro_torch.kernels.arbiter import kernel as arb_kernel
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch.mesh import host_group
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.training.step import (build_train_step,
                                           choose_grad_accum,
                                           value_and_grad)
    from repro_torch.tree import flatten, tree_map
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device(DEVICE)
    cfg = get_config(TRAIN["arch"])
    oc = OptConfig(**TRAIN_OPT)
    params0 = init_params(M.model_defs(cfg), torch.Generator(dev)
                          .manual_seed(TRAIN["seed"]), dev)
    opt0 = init_opt_state(params0, oc)
    out = {}

    def batches(seq, batch, n, seed, device=dev, c=cfg):
        src = SyntheticLM(DataConfig(seq_len=seq, global_batch=batch,
                                     vocab_size=c.vocab_size, seed=seed))
        return [{k: torch.from_numpy(v).to(device)
                 for k, v in src.batch(i).items()} for i in range(n)]

    def counts():
        return (ssd_kernel.ssd_scan.launches,
                attn_kernel.flash_attention.launches,
                sum(arb_kernel.launch_counts().values()))

    def reset_counts():
        ssd_kernel.ssd_scan.launches = ssd_kernel.ssd_scan.launches_tc = 0
        attn_kernel.flash_attention.launches = 0
        attn_kernel.flash_attention.launches_tc = 0
        arb_kernel.reset_launch_counts()

    # (a) the full-width step: 1 warm-up + TRAIN_FULL["steps"] timed
    S, B, n = TRAIN_FULL["seq"], TRAIN_FULL["batch"], TRAIN_FULL["steps"]
    shape = ShapeConfig("cli", S, B, "train")
    ga = choose_grad_accum(cfg, shape, {"data": 1})
    check(ga == 2, f"choose_grad_accum gave {ga} for {shape}, expected 2")
    step = build_train_step(cfg, oc, shape=shape, remat=True)
    data = batches(S, B, n + 1, TRAIN["seed"])
    reset_counts()
    params, opt, _ = step(params0, opt0, data[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for b in data[1:]:
        params, opt, met = step(params, opt, b)
        losses.append(met["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    check(all(map(lambda x: x == x and abs(x) < float("inf"), losses)),
          f"train losses not finite: {losses}")
    _, pwall, ev = _profiled(lambda: step(params, opt, data[0]))
    check(counts() == (0, 0, 0), f"the train step launched a kernel: "
                                 f"counters {counts()} (C2)")
    ours = [e for e in ev if any(k in e[0] for k in OUR_KERNELS)]
    check(not ours, f"the profiled train step ran {ours[:3]} (C2)")
    ms = wall / n * 1e3
    device_ms = sum(e[2] for e in ev) / 1e3
    # busy against the timed (unprofiled) step: the profiler slows the
    # host, not the device
    out.update(ms_per_step=ms, tokens_per_s=n * B * S / wall,
               peak_gb=peak / 1e9, device_ms=device_ms,
               busy=device_ms / ms, losses=losses, profiled_ms=pwall * 1e3,
               kernels=sum(e[1] for e in ev))
    say(f"[train] {cfg.name} full width ({M.count_model_params(cfg)} bf16 "
        f"parameters, random, seed {TRAIN['seed']}), {B} x {S} tokens a "
        f"step, grad_accum {ga}, remat: {ms:.1f} ms/step, "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{out['peak_gb']:.2f} GB; device time {device_ms:.1f} ms a step "
        f"({out['kernels']} kernels; the profiled step {pwall * 1e3:.1f} "
        f"ms of wall time), busy {out['busy']:.4f} of the timed step; {smi}")
    say(f"[train] losses {[round(x, 6) for x in losses]}; kernel launches "
        f"{counts()} (ssd_scan, flash_attention, arbiters)")
    for us, cnt, key in sorted(((e[2], e[1], e[0]) for e in ev),
                               reverse=True)[:6]:
        say(f"[train]   {us / 1e3:8.2f} ms {cnt:5d}x {key[:80]}")
    del params, opt, data, step

    # (b) the step's variants against the plain step, in fp32: at full
    # width the bf16 gradient is dominated by rounding noise (see
    # TRAIN_TOL), so the variants are held to the plain step on the same
    # weights cast to fp32, and their bf16 distance is only printed
    small = batches(TRAIN_SMALL["seq"], TRAIN_SMALL["batch"], 1, 1)[0]
    params32 = tree_map(lambda p: p.float(), params0)
    opt32 = init_opt_state(params32, oc)

    def one(p, s, **kw):
        return build_train_step(cfg, oc, **kw)(p, s, small)

    def distance(name, got, plain):
        errs = dict(loss=abs(float(got[2]["loss"]) - float(plain[2]["loss"]))
                    / abs(float(plain[2]["loss"])),
                    grad=_tree_rel(got[1]["m"], plain[1]["m"]))
        say(f"[train] {name}: loss {errs['loss']:.3e}, gradient rel RMS "
            f"{errs['grad']:.3e}")
        return errs

    def held(name, got, plain):
        errs = distance(name, got, plain)
        for k in errs:
            check(errs[k] <= TRAIN_TOL[k], f"{name}: {k} beyond {TRAIN_TOL}")
        return errs

    plain32 = one(params32, opt32, grad_accum=1, remat=True)
    out["variants"] = {name: held(f"fp32 {name} vs the plain step",
                                  one(params32, opt32, **kw), plain32)
                       for name, kw in (
        ("plain again", dict(grad_accum=1, remat=True)),
        ("grad_accum 2", dict(grad_accum=2, remat=True)),
        ("remat off", dict(grad_accum=1, remat=False)))}
    say(f"[train] tolerance {TRAIN_TOL}")
    plain = one(params0, opt0, grad_accum=1, remat=True)
    out["variants_bf16"] = {name: distance(
        f"{name} vs the bf16 plain step (not bounded)", got, plain)
                            for name, got in (
        ("bf16 plain again", one(params0, opt0, grad_accum=1, remat=True)),
        ("bf16 grad_accum 2", one(params0, opt0, grad_accum=2, remat=True)),
        ("fp32 plain", plain32))}
    del plain32, params32, opt32

    # (c) the card's step against the CPU's, reduced config
    rcfg = reduced_config(TRAIN["arch"])
    rp = init_params(M.model_defs(rcfg), torch.Generator().manual_seed(1),
                     "cpu")
    rb = batches(64, 4, 1, 2, "cpu", rcfg)[0]
    out["cpu"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        pc = tree_map(lambda p: p.to(dtype), rp)
        pd = tree_map(lambda p: p.to(dev), pc)
        bd = {k: v.to(dev) for k, v in rb.items()}
        loss_f = lambda p, b: M.loss_fn(rcfg, p, b)[0]
        lc, _, gc = value_and_grad(loss_f, pc, rb)
        ld, _, gd = value_and_grad(loss_f, pd, bd)
        st = build_train_step(rcfg, oc, grad_accum=1)
        nc, _, _ = st(pc, init_opt_state(pc, oc), rb)
        nd, _, _ = st(pd, init_opt_state(pd, oc), bd)
        name = str(dtype).split(".")[1]
        errs = dict(
            loss=abs(float(ld) - float(lc)) / abs(float(lc)),
            grad=max(_rel(a.cpu(), b) for a, b in zip(flatten(gd),
                                                     flatten(gc))),
            update=_tree_rel(tree_map(lambda a, b: a.cpu().float()
                                      - b.float(), nd, pc),
                             tree_map(lambda a, b: a.float() - b.float(),
                                      nc, pc)))
        tol = TRAIN_CPU_TOL[name]
        say(f"[train] {rcfg.name} {name}, card vs CPU: loss {errs['loss']:.3e}"
            f", worst gradient leaf rel RMS {errs['grad']:.3e}, update rel "
            f"RMS {errs['update']:.3e} (tolerance {tol})")
        for k in errs:
            check(errs[k] <= tol[k], f"card vs CPU {name}: {k} beyond the "
                                     f"bound")
        out["cpu"][name] = errs

    # (d) crash and resume of the launcher at full width
    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN["arch"], "--steps", str(TRAIN_CKPT["steps"]), "--seq-len",
           str(TRAIN_CKPT["seq"]), "--batch", str(TRAIN_CKPT["batch"]),
           "--log-every", "1", "--seed", str(TRAIN["seed"]), "--device",
           DEVICE]
    ckpt = ["--ckpt-dir", ck, "--ckpt-every", str(TRAIN_CKPT["every"])]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    try:
        t0 = time.perf_counter()
        for extra in ([], [], ckpt + ["--crash-at", str(TRAIN_CKPT["crash"])]):
            procs.append(subprocess.Popen(cmd + extra, env=env, cwd=ROOT,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        # the resume starts once the crashed run has exited, beside the
        # uninterrupted runs
        crashed = procs[2].communicate(timeout=300)
        check(procs[2].returncode == 17, f"the crashed run exited "
                                         f"{procs[2].returncode}, not 17: "
                                         f"{crashed[1][-2000:]}")
        check("simulated preemption" in crashed[0], "no simulated preemption")
        procs.append(subprocess.Popen(cmd + ckpt + ["--resume"], env=env,
                                      cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        runs = [p.communicate(timeout=300) for p in procs[:2]]
        runs.append(crashed)
        resumed = procs[3].communicate(timeout=300)
        codes = [p.returncode for p in procs]
        check(codes == [0, 0, 17, 0], f"launcher exit codes {codes} (want 0, "
                                      f"0, 17, 0): {resumed[1][-2000:]}"
                                      f"{runs[0][1][-2000:]}")
        check(f"resumed from step {TRAIN_CKPT['every']}" in resumed[0],
              "the resumed run did not start from the checkpoint")
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(ck, ignore_errors=True)
    a, b = _train_losses(runs[0][0]), _train_losses(runs[1][0])
    c, d = _train_losses(runs[2][0]), _train_losses(resumed[0])
    last = TRAIN_CKPT["steps"]
    check(sorted(d) == list(range(TRAIN_CKPT["every"] + 1, last + 1)),
          f"the resumed run logged steps {sorted(d)}")
    spread = max(abs(a[s] - b[s]) for s in range(1, last + 1))
    crash = max(abs(c[s] - a[s]) for s in c)
    resume = max(abs(d[s] - a[s]) for s in d)
    out["resume"] = dict(spread=spread, crash=crash, resume=resume,
                         wall_s=wall, losses=[a[s] for s in sorted(a)])
    say(f"[train] launcher at full width, {TRAIN_CKPT['batch']} x "
        f"{TRAIN_CKPT['seq']}, {last} steps, checkpoints every "
        f"{TRAIN_CKPT['every']}: --crash-at {TRAIN_CKPT['crash']} exited 17,"
        f" --resume went on from step {TRAIN_CKPT['every']} to {last}; "
        f"|loss - uninterrupted|: resumed <= {resume:.3e}, crashed run <= "
        f"{crash:.3e}, a second uninterrupted run <= {spread:.3e} "
        f"(tolerance {TRAIN_RESUME_TOL}); {wall:.1f} s")
    check(resume <= TRAIN_RESUME_TOL and crash <= TRAIN_RESUME_TOL,
          "resumed losses differ from the uninterrupted run's")

    # (e) the data-parallel step on a NCCL world of one
    out["dp"] = {}
    with host_group(dev) as group:
        for name, scfg in (
                ("homa", HC.SyncConfig(chunk_bytes=1 << 16, overcommit=7)),
                ("naive", HC.SyncConfig(chunk_bytes=1 << 16, srpt=False,
                                        overcommit=1)),
                ("int8", HC.SyncConfig(chunk_bytes=1 << 16, overcommit=7,
                                       compress="int8"))):
            dp = HC.build_dp_train_step(
                lambda p, b: M.loss_fn(cfg, p, b)[0],
                lambda p, g, s: adamw_update(p, g, s, oc), group, scfg)
            before = HC.homa_allreduce.collectives
            HC.homa_allreduce.max_in_flight = 0
            t0 = time.perf_counter()
            got = dp(params0, opt0, small, HC.init_err_state(params0, scfg))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            chunks = HC.homa_allreduce.collectives - before
            say(f"[train] data-parallel step, NCCL world of "
                f"{group.size()}, {name}: {chunks} chunk collectives, at "
                f"most {HC.homa_allreduce.max_in_flight} in flight, "
                f"{ms:.1f} ms")
            errs = {"chunks": chunks, "ms": ms}
            if name == "int8":
                check(bool(torch.isfinite(got[2]["loss"]))
                      and any(bool(e.abs().max() > 0)
                              for e in flatten(got[3])),
                      "int8 step: loss not finite or error state zero")
            else:
                errs.update(held(f"data-parallel {name} vs the bf16 plain "
                                 f"step", got[:3], plain))
            out["dp"][name] = errs
    return out


# ------------------------------------------------------------ phase 12 -----

def _attn_bound(q, k, v, causal=True):
    """The attention's bound (``_attn_work``: over the causal half when
    causal): q.k, p_hi.v and p_lo.v on the bf16 tensor cores against the
    bytes."""
    nbytes, qk, pv = _attn_work(q, k, v, causal)
    ops_s = (qk + 2 * pv) / TC_BF16_FLOP_PER_S
    by_s = nbytes / HBM_BYTES_PER_S
    return (max(ops_s, by_s) * 1e3, "operations" if ops_s > by_s
            else "bytes", qk + pv, nbytes)


def _attn_times(tag, name, q, k, v, tc, causal=True):
    """One call's times by CUDA events: the kernel (its design checked by
    the counters), its plain version ``attention_ref`` and one
    ``scaled_dot_product_attention`` call (the yardstick; the port never
    calls it), beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention.ref import attention_ref
    fa = attn_kernel.flash_attention
    n, n_tc = fa.launches, fa.launches_tc
    out = dict(ms=time_ms(lambda: fa(q, k, v, causal=causal), batch=5,
                          reps=5, warmup=2))
    check(fa.launches_tc - n_tc == (fa.launches - n) * int(tc),
          f"{name}: the timed calls ran on the "
          f"{'CUDA' if tc else 'tensor'} cores")
    out["plain_ms"] = time_ms(lambda: attention_ref(q, k, v, causal=causal),
                              batch=1, reps=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
    try:
        lib_out = sdpa()
    except RuntimeError as e:     # no backend takes the shape
        say(f"[{tag}] scaled_dot_product_attention refused {name}: {e}")
        out["library_ms"] = None
    else:
        check(_rel(lib_out.transpose(1, 2),
                   attention_ref(q, k, v, causal=causal)) < 1e-2,
              "scaled_dot_product_attention computes another function")
        del lib_out
        out["library_ms"] = time_ms(sdpa, batch=5, reps=5, warmup=2)
    out["bound_ms"], out["bound_by"], flops, nbytes = _attn_bound(q, k, v,
                                                                  causal)
    lib = (f"{out['library_ms']:.4f} ms" if out["library_ms"] is not None
           else "refused")
    say(f"[{tag}] attention {name} q {tuple(q.shape)}, k {tuple(k.shape)}, "
        f"v {tuple(v.shape)} bf16, {'causal' if causal else 'non-causal'}, "
        f"{'tensor' if tc else 'CUDA'} "
        f"cores: {out['ms']:.4f} ms a call ({out['bound_ms'] / out['ms']:.3f}"
        f" of the bound); scaled_dot_product_attention {lib}; plain "
        f"attention_ref {out['plain_ms']:.3f} ms; {flops / 1e9:.1f} GFLOP "
        f"of q.k and p.v, {nbytes / 1e6:.1f} MB; bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}: q.k, p_hi.v and "
        f"p_lo.v on the bf16 tensor cores)")
    return out


def _kernel_shares(ev, busy, tag, n=8):
    """Print the top kernels of a profiled window and the device time by
    kind: GEMMs, the attention kernel, dispatch (index, scatter, gather,
    sort) and casts/copies."""
    kinds = {"GEMM": ("gemm",), "attention": ("flash_attention",),
             "dispatch": ("index", "scatter", "gather", "sort", "radix",
                          "bincount", "cumsum", "scan"),
             "casts and copies": ("copy", "convert", "cast")}
    shares = {}
    for kind, keys in kinds.items():
        us = sum(e[2] for e in ev if any(k in e[0].lower() for k in keys))
        shares[kind] = us / busy
    say(f"[{tag}]   device time by kind: " + ", ".join(
        f"{k} {v:.3f}" for k, v in shares.items()))
    for us, cnt, key in sorted(((e[2], e[1], e[0]) for e in ev),
                               reverse=True)[:n]:
        say(f"[{tag}]   {us / 1e3:8.2f} ms {cnt:5d}x {key[:80]}")
    return shares


def _layer_params(cfg, params, l):
    """Layer ``l``'s parameters out of the stacked tree."""
    from repro_torch.models import model as M
    npfx, period = cfg.first_dense_layers, cfg.block_period
    if l < npfx:
        return params["prefix"][f"p{l}"]
    bi, i = divmod(l - npfx, period)
    return M._index(params["blocks"], bi)[f"s{i}"]


def _decode_reference(cfg, params, tokens, use_kernel=None):
    """The last token's logits as a prefill of the first S-1 tokens plus
    ``forward_decode`` of the last one compute them, but with prefill
    attention (an MLA model): every layer attends over all S tokens
    (causally, so the first S-1 rows are the (S-1)-token prefill's), and
    its FFN runs the first S-1 rows as that prefill does and the last
    rows of the B sequences as one batch of B tokens, as the decode step
    does — the decode's MoE routing, capacity (C = 1 for B = 4 at
    DeepSeek's 64 experts, top-6) and drops. Returns (B, Vp) logits."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    x = M._embed(cfg, params, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for l in range(cfg.num_layers):
        lp = _layer_params(cfg, params, l)
        y, _ = L.mla_attention(cfg, lp["mixer"],
                               L.apply_norm(cfg, lp["norm1"], x), pos,
                               use_kernel=use_kernel)
        x = x + y
        moe = cfg.is_moe_layer(l)
        x = torch.cat([M._ffn(cfg, lp, x[:, :-1], moe)[0],
                       M._ffn(cfg, lp, x[:, -1:], moe)[0]], 1)
    return M._logits(cfg, params, x[:, -1:])[:, 0]


def phase_deepseek():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.arbiter import kernel as arb_kernel
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    cfg = get_config(DEEPSEEK["arch"])
    Bsz, Slen = DEEPSEEK["batch"], DEEPSEEK["seq"]
    H, V, E, K = (cfg.num_heads, cfg.vocab_size, cfg.num_experts,
                  cfg.experts_per_token)
    d, dv = cfg.head_dim + cfg.rope_head_dim, cfg.v_hd
    fa = attn_kernel.flash_attention
    out = {}
    sgen = torch.Generator(dev).manual_seed(12)
    t_phase = time.perf_counter()

    def mark(what):
        say(f"[deepseek] {what} at +{time.perf_counter() - t_phase:.1f} s")

    def synth(b, s, h, kv, dq, dvv, dtype=torch.bfloat16):
        return [torch.randn(shape, generator=sgen, device=dev).to(dtype)
                for shape in ((b, s, h, dq), (b, s, kv, dq), (b, s, kv, dvv))]

    with torch.inference_mode():
        # (a) the kernel against its plain version, before the weights
        # take 31 GB: MLA's shape, StableLM's, and edge cases
        _attn_check("synthetic, MLA's shape", *synth(Bsz, Slen, H, H, d, dv),
                    tag="deepseek")
        st = STABLELM_ATTN
        sq, sk, sv = synth(st["batch"], st["seq"], st["heads"],
                           st["kv_heads"], st["head_dim"], st["head_dim"])
        out["stablelm_max_abs_err"] = _attn_check(
            "StableLM-12B's full-width shape (dv 160: the tensor cores' wide "
            "design)", sq, sk, sv, tag="deepseek")
        out["stablelm"] = _attn_times("deepseek", "StableLM-12B's shape", sq,
                                      sk, sv, tc=True)
        del sq, sk, sv
        _attn_check("d 192, Sq < 8", *synth(Bsz, 5, H, H, d, dv),
                    tag="deepseek")
        _attn_check("d 192, kv_len 3000 of 4095",
                    *synth(2, Slen - 1, H, H, d, dv), kv_len=3000,
                    tag="deepseek")
        _attn_check(f"d 192, window 256, GQA {H} over {max(1, H // 4)}",
                    *synth(2, 2048, H, max(1, H // 4), d, dv), window=256,
                    tag="deepseek")
        _attn_check("d 160, window 256, GQA 4 (wide design)",
                    *synth(2, 2048, 32, 8, 160, 160), window=256,
                    tag="deepseek")
        _attn_check("d 160, kv_len 3000 of 4095 (wide design)",
                    *synth(1, Slen - 1, 32, 8, 160, 160), kv_len=3000,
                    tag="deepseek")
        _attn_check("d 192, fp32 (CUDA cores)",
                    *synth(2, 1024, H, H, d, dv, torch.float32), tc=False,
                    tag="deepseek")
        _attn_check("d 256, dv 256 (CUDA cores)",
                    *synth(2, 1024, 8, 2, 256, 256), tc=False,
                    tag="deepseek")
        _attn_check("d 256, dv 256, fp32, rows with no valid key (window 2,"
                    " kv_len 8)", *synth(1, 600, 4, 2, 256, 256,
                                         torch.float32),
                    window=2, kv_len=8, tc=False, tag="deepseek")

        mark("(a) synthetic and edge cases done")
        gen = torch.Generator(dev).manual_seed(DEEPSEEK["seed"])
        t0 = time.perf_counter()
        params = init_params(M.model_defs(cfg), gen, dev)
        tokens = torch.randint(0, V, (Bsz, Slen), generator=gen, device=dev)
        torch.cuda.synchronize()
        say(f"[deepseek] {cfg.name}: {M.count_model_params(cfg)} parameters "
            f"(bf16, the routers fp32; {M.active_params(cfg)} active a "
            f"token), {cfg.num_layers} layers (the first dense, d_ff "
            f"{cfg.d_ff}), d_model {cfg.d_model}, MLA {H} heads, q/k {d} "
            f"wide, v {dv}, kv latent {cfg.kv_lora_rank}; MoE {E} experts "
            f"of {cfg.moe_d_ff} top-{K} + {cfg.num_shared_experts} shared, "
            f"capacity {cfg.capacity_factor}; vocab {V}; random weights, "
            f"seed {DEEPSEEK['seed']}; init {time.perf_counter() - t0:.2f} "
            f"s, {torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")
        pos = torch.arange(Slen, device=dev)
        x = M._embed(cfg, params, tokens)
        lp0 = params["prefix"]["p0"]
        q, k, v, _ = L.mla_qkv(cfg, lp0["mixer"],
                               L.apply_norm(cfg, lp0["norm1"], x), pos)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out["max_abs_err"] = _attn_check("layer 0 of the prefill", q, k, v,
                                         tag="deepseek")
        out["mla"] = _attn_times("deepseek", "layer 0 of the prefill", q, k,
                                 v, tc=True)
        del x, q, k, v

        mark("(a) done")
        # (b) the main path: one prefill of Bsz x Slen tokens on the kernel
        M.forward_prefill(cfg, params, tokens)        # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.launches_tc = 0
        ssd_kernel.ssd_scan.launches = 0
        arb_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = M.forward_prefill(cfg, params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"], out["launches_tc"] = fa.launches, fa.launches_tc
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(out["launches"] == out["launches_tc"] == cfg.num_layers,
              f"prefill launched the attention kernel {out['launches']} "
              f"times, {out['launches_tc']} of them on the tensor cores; "
              f"expected one per layer ({cfg.num_layers}), all on them")
        check(ssd_kernel.ssd_scan.launches == 0
              and not any(arb_kernel.launch_counts().values()),
              "the prefill launched an SSD or arbitration kernel")
        check(logits.shape == (Bsz, cfg.padded_vocab())
              and bool(torch.isfinite(logits).all())
              and bool((logits[:, V:] == -1e9).all()),
              "prefill logits: wrong shape, not finite or padding unmasked")
        out["tokens_per_s"] = Bsz * Slen / wall
        say(f"[deepseek] prefill {Bsz} x {Slen} tokens on the kernel: "
            f"{wall * 1e3:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, peak "
            f"memory {out['peak_gb']:.2f} GB; flash_attention launches "
            f"{out['launches']}, on the tensor cores {out['launches_tc']}")
        _, pwall, ev = _profiled(lambda: M.forward_prefill(cfg, params,
                                                           tokens))
        busy = sum(e[2] for e in ev)
        hits = [e for e in ev if "flash_attention_tc_kernel" in e[0]]
        check(len(hits) == 1 and hits[0][1] == cfg.num_layers
              and not any("flash_attention_kernel" in e[0] for e in ev),
              f"profiler: flash_attention_tc_kernel launched "
              f"{[h[1] for h in hits]} times, expected {cfg.num_layers} "
              f"and no CUDA-core attention kernel")
        out["device_ms_per_launch"] = hits[0][2] / cfg.num_layers / 1e3
        out["busy"] = busy / 1e6 / pwall
        say(f"[deepseek] profiled prefill: {pwall * 1e3:.1f} ms wall, device "
            f"busy {out['busy']:.4f}, {busy / 1e3:.2f} ms device time, "
            f"{sum(e[1] for e in ev)} kernels; attention "
            f"{out['device_ms_per_launch']:.4f} ms device time per launch")
        out["shares"] = _kernel_shares(ev, busy, "deepseek")

        mark("(b) prefill and its profile done")
        fa.launches = 0
        t0 = time.perf_counter()
        plain, _ = M.forward_prefill(cfg, params, tokens, use_kernel=False)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
        check(fa.launches == 0, "the plain prefill launched the attention "
                                "kernel")
        err = _rel(logits[:, :V], plain[:, :V])
        agree = float((logits[:, :V].argmax(-1)
                       == plain[:, :V].argmax(-1)).float().mean())
        out["plain_prefill_ms"] = pwall * 1e3
        say(f"[deepseek] plain prefill (blockwise_attention, no attention "
            f"launch): {pwall * 1e3:.1f} ms wall; last-token logits rel RMS "
            f"{err:.4f} (tolerance {DEEPSEEK_TOL['logits']}), argmax "
            f"agrees on {agree:.2f} of rows")
        check(err <= DEEPSEEK_TOL["logits"], "kernel and plain prefill "
                                             "logits differ beyond the "
                                             "tolerance")
        del plain

        # layer by layer on the same inputs: kernel vs plain MLA, one
        # absorbed decode step on the first S-1 latents vs the last
        # prefill row, and the tokens whose top-K set the two paths'
        # attention outputs change
        x = M._embed(cfg, params, tokens)
        worst = dict(layer=0.0, decode_layer=0.0)
        flips = 0
        for l in range(cfg.num_layers):
            lp = _layer_params(cfg, params, l)
            h = L.apply_norm(cfg, lp["norm1"], x)
            yk, (ckv, kr) = L.mla_attention(cfg, lp["mixer"], h, pos)
            yp, _ = L.mla_attention(cfg, lp["mixer"], h, pos,
                                    use_kernel=False)
            worst["layer"] = max(worst["layer"], _rel(yk, yp))
            yd, _ = L.mla_attention_decode(
                cfg, lp["mixer"], h[:, -1:], Slen - 1,
                {"ckv": ckv[:, :-1], "kr": kr[:, :-1]})
            worst["decode_layer"] = max(worst["decode_layer"],
                                        _rel(yd, yk[:, -1:]))
            if cfg.is_moe_layer(l):
                sets = [L.moe_route(cfg, lp["ffn"]["router"],
                                    L.apply_norm(cfg, lp["norm2"], x + y)
                                    .reshape(-1, cfg.d_model))["idx"]
                        .sort(-1).values for y in (yk, yp)]
                flips += int((sets[0] != sets[1]).any(-1).sum())
            x, _ = M._ffn(cfg, lp, x + yk, cfg.is_moe_layer(l))
        out["flips"] = flips
        del lp, lp0   # views of the stacked weights keep them alive
        n_moe = sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers))
        say(f"[deepseek] layer by layer, same inputs: kernel vs plain MLA "
            f"rel RMS <= {worst['layer']:.2e} (tolerance "
            f"{DEEPSEEK_TOL['layer']}); absorbed decode at {Slen - 1} on the "
            f"first {Slen - 1} latents vs the prefill's last row rel RMS <= "
            f"{worst['decode_layer']:.2e} (tolerance "
            f"{DEEPSEEK_TOL['decode_layer']}); top-{K} expert sets that "
            f"differ between the two paths: {flips} of {n_moe} x "
            f"{Bsz * Slen} token routings")
        for key in ("layer", "decode_layer"):
            check(worst[key] <= DEEPSEEK_TOL[key],
                  f"layer by layer: {key} beyond the tolerance")
        del x, h, yk, yp, yd, ckv, kr

        mark("(b) done")
        # (c) prefill(S-1) + one decode step, against the S-token prefill
        # computed with the decode step's routing of the last tokens
        # (_decode_reference: the same drops at C = 1)
        _, caches = M.forward_prefill(cfg, params, tokens[:, :-1])
        step, _ = M.forward_decode(cfg, params, tokens[:, -1:], Slen - 1,
                                   caches)
        del caches
        ref = _decode_reference(cfg, params, tokens)
        err = _rel(step[:, :V], ref[:, :V])
        err_full = _rel(step[:, :V], logits[:, :V])
        say(f"[deepseek] prefill({Slen - 1}) + forward_decode at {Slen - 1} "
            f"(MoE at T = {Bsz}, C = {L.moe_capacity(cfg, Bsz)}) vs the "
            f"{Slen}-token prefill with the last tokens routed as the "
            f"decode step routes them: logits rel RMS {err:.4f} (tolerance "
            f"{DEEPSEEK_TOL['decode_logits']}); vs the plain "
            f"prefill({Slen}) (C = {L.moe_capacity(cfg, Bsz * Slen)}, no "
            f"drop of those tokens): {err_full:.4f}")
        check(bool(torch.isfinite(step).all())
              and err <= DEEPSEEK_TOL["decode_logits"],
              "prefill + decode differs from the prefill")
        out["decode_vs_prefill"] = err_full
        del step, logits, ref
    mark("(c) done")
    # 3 steps: the profiler's post-processing grows with the ~5600
    # kernels a step (10 steps took 47 s of the phase)
    out["decode"] = _decode_window(cfg, params, dev, "deepseek", n=3)
    mark("the decode window done")
    del params, tokens
    torch.cuda.empty_cache()

    # (d) the serving loop at full width (it draws its own weights)
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", DEEPSEEK["arch"], *DEEPSEEK_SERVE_ARGV,
                      "--device", DEVICE])
    wall = time.perf_counter() - t0
    got = {k: res[k] for k in DEEPSEEK_SERVE_EXPECTED}
    check(got == DEEPSEEK_SERVE_EXPECTED,
          f"serve statistics {got} != the JAX package's "
          f"{DEEPSEEK_SERVE_EXPECTED}")
    out["decode_steps_per_s"] = res["steps"] / wall
    say(f"[deepseek] serve {DEEPSEEK['arch']} {' '.join(DEEPSEEK_SERVE_ARGV)}"
        f": {got} == the JAX package's; {wall:.2f} s wall (parameter init "
        f"included), {out['decode_steps_per_s']:.1f} decode steps/s at "
        f"batch {DEEPSEEK_SERVE_ARGV[-1]}; flash_attention launches "
        f"{fa.launches} (decode attends in the latent space: "
        f"mla_attention_decode)")
    torch.cuda.empty_cache()
    mark("(d) done")
    return out


# ------------------------------------------------------------ phase 13 -----

# (a)'s five calls: (name, q shape, k/v shape, causal, launches of the
# call in one prefill of 13b or 13c)
XATTN_SHAPES = (
    ("Whisper encoder", (4, 1500, 12, 64), (4, 1500, 12, 64), False, 12),
    ("Whisper decoder self", (4, 448, 12, 64), (4, 448, 12, 64), True, 12),
    ("Whisper cross", (4, 448, 12, 64), (4, 1500, 12, 64), False, 12),
    ("Vision self", (2, 4096, 64, 128), (2, 4096, 8, 128), True, 4),
    ("Vision cross", (2, 4096, 64, 128), (2, 6400, 8, 128), False, 1),
)
WHISPER = dict(arch="whisper-small", batch=4, seq=448, seed=0)
# Llama-3.2-Vision cut to one scan block (layers 0-3 self, layer 4
# cross): the 100 layers' 175 GB do not fit a card
VISION = dict(arch="llama-3.2-vision-90b", batch=2, seq=4096, seed=0,
              layers=5)
# relative RMS of the kernel path against the plain path (which rounds p
# to bf16 before p.V), measured on the CPU with the kernel's plain
# version by ``python tests/test_torch_encdec.py --deep``
# (``deep_config``: each model's chip depth, heads and sequence lengths
# at d_model 256; 2 x 448 tokens over 1500 frames, 2 x 512 over 6400
# image tokens; 3 seeds): Whisper's attention outputs layer by layer
# 2.85e-3, the encoder's output 9.0e-3, last-token logits 9.5e-3,
# prefill(447) + decode against the 448-token prefill 8.9e-3;
# Vision's 2.8e-3, 1.38e-2 and 1.28e-2. Each bound ~4x its measurement
WHISPER_TOL = dict(layer=1e-2, encoder=4e-2, logits=4e-2, decode_logits=4e-2)
VISION_TOL = dict(layer=1e-2, encoder=None, logits=6e-2, decode_logits=6e-2)


def _xattn_layers(cfg, params, tokens, emb, use_kernel=None):
    """The kernel path (``use_kernel``) against the plain path of an
    encoder-decoder or cross-attention model, layer by layer on the same
    inputs (each layer's input from the kernel path): the relative RMS
    distance of every attention output — the encoder's self-attention,
    the decoder's self-attention, every cross-attention — their maximum
    ("layer") and that over the cross-attentions ("cross"), and, for an
    encoder-decoder, of the whole encoder's output ("encoder")."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    worst = dict(layer=0.0, cross=0.0)

    def note(yk, yp, cross=False):
        e = _rel(yk, yp)
        worst["layer"] = max(worst["layer"], e)
        if cross:
            worst["cross"] = max(worst["cross"], e)

    enc = None
    if cfg.is_encoder_decoder:
        x = emb
        pos = torch.arange(x.shape[1], device=x.device)
        cos, sin = L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        for i in range(cfg.encoder_layers):
            bp = M._index(params["encoder"]["blocks"], i)
            h = L.apply_norm(cfg, bp["norm1"], x)
            q, k, v = L._qkv(cfg, bp["mixer"], h)
            q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
            yk = L.full_attention(q, k, v, use_kernel=use_kernel)
            note(yk, L.full_attention(q, k, v, use_kernel=False))
            x = x + L._proj("bshk,hkd->bsd", yk,
                            bp["mixer"]["wo"]).to(x.dtype)
            x = x + L.mlp(cfg, bp["ffn"], L.apply_norm(cfg, bp["norm2"], x))
        enc = L.apply_norm(cfg, params["encoder"]["final_norm"], x)
        worst["encoder"] = _rel(enc, M.encoder_forward(cfg, params, emb,
                                                       use_kernel=False))
    x = M._embed(cfg, params, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for l in range(cfg.num_layers):
        lp = _layer_params(cfg, params, l)
        h = L.apply_norm(cfg, lp["norm1"], x)
        if cfg.layer_kind(l) == "cross":
            kv = L.cross_kv(cfg, lp["mixer"], emb)
            yk = L.cross_attention(cfg, lp["mixer"], h, kv,
                                   use_kernel=use_kernel)
            note(yk, L.cross_attention(cfg, lp["mixer"], h, kv,
                                       use_kernel=False), cross=True)
        else:
            yk, _ = L.self_attention(cfg, lp["mixer"], h, pos,
                                     use_kernel=use_kernel)
            note(yk, L.self_attention(cfg, lp["mixer"], h, pos,
                                      use_kernel=False)[0])
        x = x + yk
        if cfg.is_encoder_decoder:
            hx = L.apply_norm(cfg, lp["norm_x"], x)
            kv = L.cross_kv(cfg, lp["xattn"], enc)
            yk = L.cross_attention(cfg, lp["xattn"], hx, kv,
                                   use_kernel=use_kernel)
            note(yk, L.cross_attention(cfg, lp["xattn"], hx, kv,
                                       use_kernel=False), cross=True)
            x = x + yk
        x, _ = M._ffn(cfg, lp, x)
    return worst


def _xattn_model(tag, cfg, run, tol):
    """13b / 13c: ``cfg`` at full width on the card (random bf16 weights
    and embeddings from ``run["seed"]``): the prefill on the kernel
    (launches counted by shape and by design, seen by the profiler;
    tokens/s, peak memory, busy share, device time by kind), against
    the plain path layer by layer and end to end, prefill + decode
    against the prefill, and a profiled window of 3 decode steps."""
    import torch
    from repro_torch.kernels.arbiter import kernel as arb_kernel
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    dev = torch.device(DEVICE)
    fa = attn_kernel.flash_attention
    Bsz, Slen, V = run["batch"], run["seq"], cfg.vocab_size
    key, n_emb = (("enc_embeds", cfg.encoder_seq) if cfg.is_encoder_decoder
                  else ("img_embeds", cfg.num_image_tokens))
    calls = (cfg.encoder_layers + 2 * cfg.num_layers
             if cfg.is_encoder_decoder else cfg.num_layers)
    out = {}
    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(run["seed"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(M.model_defs(cfg), gen, dev)
    tokens = torch.randint(0, V, (Bsz, Slen), generator=gen, device=dev)
    kw = {key: torch.randn((Bsz, n_emb, cfg.d_model), generator=gen,
                           device=dev).bfloat16()}
    torch.cuda.synchronize()
    out["weights_gb"] = torch.cuda.memory_allocated() / 1e9
    say(f"[{tag}] {cfg.name}: {M.count_model_params(cfg)} parameters "
        f"(bf16), {cfg.num_layers} decoder layers"
        + (f" + {cfg.encoder_layers} encoder layers over {n_emb} frames"
           if cfg.is_encoder_decoder else
           f" (cross at {[l for l in range(cfg.num_layers) if cfg.layer_kind(l) == 'cross']}) over {n_emb} image embeddings")
        + f", d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{V} ({cfg.padded_vocab()} padded); random weights and {key}, "
        f"seed {run['seed']}; init {time.perf_counter() - t0:.2f} s, "
        f"{out['weights_gb']:.2f} GB on the card")
    with torch.inference_mode():
        M.forward_prefill(cfg, params, tokens, **kw)    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.launches_tc = 0
        ssd_kernel.ssd_scan.launches = 0
        arb_kernel.reset_launch_counts()
        # the call sites' shapes, tallied around the counted prefill
        with _attention_calls() as logged:
            t0 = time.perf_counter()
            logits, _ = M.forward_prefill(cfg, params, tokens, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        tally = {s: logged.count(s) for s in dict.fromkeys(logged)}
        out["launches"], out["launches_tc"] = fa.launches, fa.launches_tc
        out["by_shape"] = {f"q {s[0]} kv {s[1]} "
                           f"{'causal' if s[2] else 'non-causal'}": n
                           for s, n in tally.items()}
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(out["launches"] == out["launches_tc"] == calls
              == sum(tally.values()),
              f"prefill launched the attention kernel {out['launches']} "
              f"times, {out['launches_tc']} of them on the tensor cores, "
              f"from {sum(tally.values())} calls; expected {calls}, all on "
              f"them")
        check(ssd_kernel.ssd_scan.launches == 0
              and not any(arb_kernel.launch_counts().values()),
              "the prefill launched an SSD or arbitration kernel")
        check(logits.shape == (Bsz, cfg.padded_vocab())
              and bool(torch.isfinite(logits).all())
              and bool((logits[:, V:] == -1e9).all()),
              "prefill logits: wrong shape, not finite or padding unmasked")
        out["tokens_per_s"] = Bsz * Slen / wall
        out["prefill_ms"] = wall * 1e3
        say(f"[{tag}] prefill {Bsz} x {Slen} tokens over {Bsz} x {n_emb} "
            f"{key} on the kernel: {wall * 1e3:.1f} ms, "
            f"{out['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{out['peak_gb']:.2f} GB; flash_attention launches "
            f"{out['launches']}, on the tensor cores {out['launches_tc']}; "
            f"by call: {out['by_shape']}")
        # a window must record every launch the counters saw: it opens
        # with the marker (ROADMAP C6), records device activity only with
        # 0.5 s of idle trace either side, and one that lost a record
        # (its trace kept, the launch named) is taken again, at most twice
        for attempt in range(3):
            hits, seen, pwall, ev = _counted_window(
                lambda: M.forward_prefill(cfg, params, tokens, **kw), calls,
                f"{tag.replace(' ', '_')}_{attempt}")
            if seen == calls:
                break
        busy = sum(e[2] for e in ev)
        check(seen == calls
              and not any("flash_attention_kernel" in e[0] for e in ev),
              f"profiler: flash_attention_tc_kernel launched "
              f"{[h[1] for h in hits]} times, expected {calls} and no "
              f"CUDA-core attention kernel")
        out["device_ms_per_launch"] = sum(h[2] for h in hits) / calls / 1e3
        out["busy"] = busy / 1e6 / pwall
        out["device_ms"] = busy / 1e3
        say(f"[{tag}] profiled prefill: {pwall * 1e3:.1f} ms wall, device "
            f"busy {out['busy']:.4f}, {busy / 1e3:.2f} ms device time, "
            f"{sum(e[1] for e in ev)} kernels; attention "
            f"{out['device_ms_per_launch']:.4f} ms device time per launch")
        out["shares"] = _kernel_shares(ev, busy, tag)
        say(f"[{tag}] (b) prefill and its profile done at "
            f"+{time.perf_counter() - t_phase:.1f} s")

        # against the plain path: layer by layer on the same inputs, then
        # end to end and across prefill + decode
        fa.launches = 0
        t0 = time.perf_counter()
        plain, _ = M.forward_prefill(cfg, params, tokens, use_kernel=False,
                                     **kw)
        torch.cuda.synchronize()
        out["plain_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        check(fa.launches == 0, "the plain prefill launched the attention "
                                "kernel")
        err = _rel(logits[:, :V], plain[:, :V])
        agree = float((logits[:, :V].argmax(-1)
                       == plain[:, :V].argmax(-1)).float().mean())
        say(f"[{tag}] plain prefill (blockwise_attention, no attention "
            f"launch): {out['plain_prefill_ms']:.1f} ms wall; last-token "
            f"logits rel RMS {err:.4f} (tolerance {tol['logits']}), argmax "
            f"agrees on {agree:.2f} of rows")
        check(err <= tol["logits"], "kernel and plain prefill logits differ "
                                    "beyond the tolerance")
        out["logits_rel"] = err
        del plain
        worst = _xattn_layers(cfg, params, tokens, kw[key])
        out["layers"] = worst
        say(f"[{tag}] layer by layer, same inputs: kernel vs plain "
            f"attention outputs rel RMS <= {worst['layer']:.2e} (cross "
            f"{worst['cross']:.2e}; tolerance {tol['layer']})"
            + (f"; the encoder's output {worst['encoder']:.2e} (tolerance "
               f"{tol['encoder']})" if "encoder" in worst else ""))
        check(worst["layer"] <= tol["layer"], "layer by layer: beyond the "
                                              "tolerance")
        if "encoder" in worst:
            check(worst["encoder"] <= tol["encoder"],
                  "the encoder's output: beyond the tolerance")
        _, caches = M.forward_prefill(cfg, params, tokens[:, :-1], **kw)
        fa.launches = 0
        step, deltas = M.forward_decode(cfg, params, tokens[:, -1:],
                                        Slen - 1, caches)
        torch.cuda.synchronize()
        n_cross = (cfg.num_layers if cfg.is_encoder_decoder else
                   sum(cfg.layer_kind(l) == "cross"
                       for l in range(cfg.num_layers)))
        check(fa.launches == n_cross, f"a decode step launched the kernel "
                                      f"{fa.launches} times, expected one "
                                      f"per cross-attention ({n_cross})")
        err = _rel(step[:, :V], logits[:, :V])
        say(f"[{tag}] prefill({Slen - 1}) + forward_decode at {Slen - 1} "
            f"({fa.launches} cross-attention launches) vs the {Slen}-token "
            f"prefill: logits rel RMS {err:.4f} (tolerance "
            f"{tol['decode_logits']}); delta keys "
            f"{sorted({k for d in deltas['blocks'].values() for k in d})}")
        check(bool(torch.isfinite(step).all())
              and err <= tol["decode_logits"],
              "prefill + decode differs from the prefill")
        out["decode_vs_prefill"] = err
        del step, logits
        say(f"[{tag}] (c) checks done at "
            f"+{time.perf_counter() - t_phase:.1f} s")

        # 3 profiled decode steps at position S-1 on the prefill's caches
        tok = tokens[:, -1:]
        n = 3

        def steps():
            t = tok
            for _ in range(n):
                lg, _ = M.forward_decode(cfg, params, t, Slen - 1, caches)
                t = lg.argmax(-1)[:, None]
        steps()
        _, dwall, ev = _profiled(steps)
        dbusy = sum(e[2] for e in ev)
        out["decode"] = dict(ms_per_step=dwall / n * 1e3,
                             busy=dbusy / 1e6 / dwall,
                             device_ms_per_step=dbusy / n / 1e3,
                             kernels_per_step=sum(e[1] for e in ev) / n)
        say(f"[{tag}] decode window, batch {Bsz}, {n} steps: "
            f"{out['decode']['ms_per_step']:.2f} ms/step wall, device busy "
            f"{out['decode']['busy']:.4f}, "
            f"{out['decode']['kernels_per_step']:.0f} kernels/step, "
            f"{out['decode']['device_ms_per_step']:.3f} ms/step of device "
            f"time")
        _kernel_shares(ev, dbusy, tag, n=5)
        del caches
    del params, tokens, kw
    torch.cuda.empty_cache()
    say(f"[{tag}] done at +{time.perf_counter() - t_phase:.1f} s")
    return out


def phase_xattn():
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    out = {"shapes": []}
    t_phase = time.perf_counter()
    sgen = torch.Generator(dev).manual_seed(13)
    with torch.inference_mode():
        # (a) the kernel against its plain version at the five full-width
        # calls, before any weights are on the card
        for name, qs, ks, causal, per in XATTN_SHAPES:
            q = torch.randn(qs, generator=sgen, device=dev).bfloat16()
            k, v = (torch.randn(ks, generator=sgen, device=dev).bfloat16()
                    for _ in range(2))
            err = _attn_check(name, q, k, v, causal=causal, tag="xattn")
            row = dict(name=name, q=list(qs), kv=list(ks), causal=causal,
                       launches_per_prefill=per, max_abs_err=err,
                       **_attn_times("xattn", name, q, k, v, tc=True,
                                     causal=causal))
            out["shapes"].append(row)
            del q, k, v
            torch.cuda.empty_cache()
    say(f"[xattn] (a) done at +{time.perf_counter() - t_phase:.1f} s")
    out["whisper"] = _xattn_model("xattn whisper",
                                  get_config(WHISPER["arch"]), WHISPER,
                                  WHISPER_TOL)
    full = get_config(VISION["arch"])
    cut = dataclasses.replace(full, num_layers=VISION["layers"])
    say(f"[xattn vision] depth cut: {full.num_layers} layers "
        f"({full.num_layers // full.block_period} blocks) to "
        f"{cut.num_layers} (one block, layer {full.cross_attn_offset} "
        f"cross); widths as published")
    out["vision"] = _xattn_model("xattn vision", cut, VISION, VISION_TOL)
    # each call's launches in the main path's prefills, by shape
    seen = {**out["whisper"]["by_shape"], **out["vision"]["by_shape"]}
    for row in out["shapes"]:
        k = (f"q {tuple(row['q'])} kv {tuple(row['kv'])} "
             f"{'causal' if row['causal'] else 'non-causal'}")
        row["launches"] = seen.get(k, 0)
        check(row["launches"] == row["launches_per_prefill"],
              f"{row['name']}: {row['launches']} launches in the prefill, "
              f"expected {row['launches_per_prefill']}")
    return out

# phase 14: the dry run (launch.dryrun) on the fake production meshes, and
# its memory model against what the card allocates
DRYRUN_CELLS = (("whisper-small", "decode_32k", False),
                ("whisper-small", "decode_32k", True),
                ("llama3.2-3b", "prefill_32k", False))
# 14b: two steps at the card's full width, predicted on a (1, 1) fake mesh
# and run on the card from tensors of the same shapes and dtypes: Llama's
# plain prefill at phase 8's 4 x 4096 and Mamba's train step at phase 11a's
# 16 x 2048 (grad_accum 2, remat)
DRYRUN_STEPS = {"llama_prefill": dict(arch="llama3.2-3b", kind="prefill",
                                      seq=4096, batch=4, accum=None),
                "mamba_train": dict(arch="mamba2-130m", kind="train",
                                    seq=2048, batch=16, accum=2)}
DRYRUN_PEAK_TOL = 0.10          # |predicted - measured| / measured peak


def _dryrun_card(name: str) -> None:
    """One of 14b's steps, in a process of its own (the card's allocator
    starts empty): the dry run's prediction on a (1, 1) fake mesh, then
    the same step on the card from random tensors of the inputs' shapes
    and dtypes, with ``max_memory_allocated`` after
    ``reset_peak_memory_stats``. Prints one JSON line."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.step import (build_prefill_step,
                                           build_train_step)
    from repro_torch.tree import flatten
    c = DRYRUN_STEPS[name]
    cfg = get_config(c["arch"])
    shape = ShapeConfig(name, c["seq"], c["batch"], c["kind"])
    t0 = time.perf_counter()
    with fake_mesh((1, 1), device=DEVICE) as mesh:
        pred = D.measure(cfg, shape, mesh, accum=c["accum"])
    predict_s = time.perf_counter() - t0
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(0)
    params = init_params(M.model_defs(cfg), gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]),
                           generator=gen, device=dev, dtype=torch.int32)
    if c["kind"] == "train":
        oc = OptConfig()
        args = (params, init_opt_state(params, oc),
                {"tokens": tokens, "labels": tokens.roll(-1, 1)})
        step = build_train_step(cfg, oc, shape=shape, grad_accum=c["accum"],
                                remat=True)
    else:
        args = (params, {"tokens": tokens})
        step = build_prefill_step(cfg, use_kernel=False)
    held = sum(t.nbytes for t in flatten(args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.set_grad_enabled(c["kind"] == "train"):
        out = step(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    print(json.dumps({
        "name": name, "predicted": pred, "predict_s": predict_s,
        "held_bytes": held, "peak_bytes": torch.cuda.max_memory_allocated(),
        "step_s": step_s, "finite": bool(all(
            torch.isfinite(t.float()).all() for t in flatten(out)
            if t.is_floating_point()))}))


def _dryrun_env() -> dict:
    import os
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _start_dryrun_cells() -> dict:
    """14a's cells, one subprocess each, their errors kept in a temporary
    file (nothing reads a pipe while they run). They trace fake tensors
    on the host and run nothing on the card, so ``main`` starts them
    before phase 12, whose device-bound work they overlap."""
    import tempfile
    out = {}
    for arch, shp, mp in DRYRUN_CELLS:
        err = tempfile.TemporaryFile(mode="w+")
        out[(arch, shp, mp)] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shp] + (["--multi-pod"] if mp else []),
            cwd=ROOT, env=_dryrun_env(), stdout=subprocess.DEVNULL,
            stderr=err, text=True), err)
    return out


def phase_dryrun(cells=None):
    """(a) the dry run of three cells on the fake production meshes, one
    subprocess each (``cells``, when ``main`` started them earlier); (b)
    its memory model against the card: 14b's steps predicted and run in
    a subprocess each, started together."""
    env = _dryrun_env()
    t_phase = time.perf_counter()
    cells = cells or _start_dryrun_cells()
    steps = {name: subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke, sys; "
         f"chip_smoke._dryrun_card({name!r})"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in DRYRUN_STEPS}
    outs = {k: p.communicate(timeout=600) + (p.returncode,)
            for k, p in steps.items()}
    for k, (p, err) in cells.items():
        p.wait(timeout=600)
        err.seek(0)
        outs[k] = (None, err.read(), p.returncode)
        err.close()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import cell_path
    res = {"cells": [], "steps": {}}
    for (arch, shp, mp) in DRYRUN_CELLS:
        _, err, rc = outs[(arch, shp, mp)]
        path = cell_path(arch, shp, mp)
        check(rc == 0 and path.exists(),
              f"dry run {arch} x {shp} (multi_pod={mp}) exited {rc}: "
              f"{err[-2000:]}")
        d = json.loads(path.read_text())
        check(d["status"] == "ok", f"dry run {arch} x {shp}: {d}")
        mem = d["memory"]
        check(d["n_chips"] == (512 if mp else 256)
              and d["cost"]["flops"] > 0
              and 0 < mem["argument_size_in_bytes"] < 4e9,
              f"dry run {arch} x {shp}: {d['n_chips']} chips, "
              f"{d['cost']['flops']} flops, {mem}")
        res["cells"].append(d)
        say(f"[dryrun] (a) {arch} x {shp} x {d['mesh']}: per device "
            f"arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, peak "
            f"{d['peak_bytes'] / 1e9:.3f} GB, "
            f"{d['cost']['flops'] / 1e12:.4f} TFLOP, collectives "
            f"{d['collectives']['total_bytes'] / 1e9:.4f} GB; traced in "
            f"{d['trace_s']:.1f} s ({d['device']})")
    for name in DRYRUN_STEPS:
        out, err, rc = outs[name]
        check(rc == 0, f"14b {name} exited {rc}: {err[-3000:]}")
        r = json.loads(out.strip().splitlines()[-1])
        p = r["predicted"]
        args = p["memory"]["argument_size_in_bytes"]
        off = (p["peak_bytes"] - r["peak_bytes"]) / r["peak_bytes"]
        say(f"[dryrun] (b) {name}: arguments predicted {args} B, held "
            f"{r['held_bytes']} B; peak predicted {p['peak_bytes']} B "
            f"(temp {p['memory']['temp_size_in_bytes']} B), "
            f"max_memory_allocated {r['peak_bytes']} B ({off:+.2%}); "
            f"predicted in {r['predict_s']:.1f} s, the card's step "
            f"{r['step_s']:.2f} s")
        check(r["finite"], f"14b {name}: non-finite outputs on the card")
        check(args == r["held_bytes"], f"14b {name}: predicted argument "
              f"bytes {args} != the card's {r['held_bytes']}")
        check(abs(off) <= DRYRUN_PEAK_TOL, f"14b {name}: predicted peak "
              f"{p['peak_bytes']} B is {off:+.2%} off the card's "
              f"{r['peak_bytes']} B")
        res["steps"][name] = r
    say(f"[dryrun] done in {time.perf_counter() - t_phase:.1f} s")
    return res


# ------------------------------------------------------------ phase 15 -----

STABLELM = dict(arch="stablelm-12b", batch=2, seq=4096, seed=0)
# relative RMS error of the kernel path against the plain path
# (blockwise_attention, which rounds p to bf16 before p.V), measured on
# the CPU with the kernel's plain version by ``python
# tests/test_torch_stablelm.py`` (40 layers of head width 160 at d_model
# 640, 2 x 512 tokens, 2 seeds): last-position logits 2.1e-2, the k/v
# caches of all layers 1.6e-2. Each bound ~4x its measurement
STABLELM_TOL = dict(logits=8e-2, cache=6e-2)
# phase 15's serve: 8 requests (177 decode steps of the 12B model). Its
# statistics, computed with the JAX package's ``repro.launch.serve.main``
# on the CPU with ``["--arch", "stablelm-12b", "--smoke",
# *STABLELM_SERVE_ARGV]``; tests/test_torch_stablelm.py checks both
# packages against them
STABLELM_SERVE_ARGV = ["--requests", "8", "--batch-size", "4"]
STABLELM_SERVE_EXPECTED = {"served": 8, "steps": 177,
                           "mean_slowdown": 0.8422611109699926,
                           "p99_slowdown": 0.9921741854636591}


def phase_stablelm():
    """Phase 15: StableLM-12B whole at full width on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.arbiter import kernel as arb_kernel
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    dev = torch.device(DEVICE)
    cfg = get_config(STABLELM["arch"])
    Bsz, Slen, V = STABLELM["batch"], STABLELM["seq"], cfg.vocab_size
    fa = attn_kernel.flash_attention
    calls = cfg.num_layers
    out = {}
    t_phase = time.perf_counter()

    def mark(what):
        say(f"[stablelm] {what} at +{time.perf_counter() - t_phase:.1f} s")

    torch.cuda.empty_cache()
    gen = torch.Generator(dev).manual_seed(STABLELM["seed"])
    t0 = time.perf_counter()
    params = init_params(M.model_defs(cfg), gen, dev)
    tokens = torch.randint(0, V, (Bsz, Slen), generator=gen, device=dev)
    torch.cuda.synchronize()
    out["weights_gb"] = torch.cuda.memory_allocated() / 1e9
    say(f"[stablelm] {cfg.name}: {M.count_model_params(cfg)} parameters "
        f"(bf16), {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {V} ({cfg.padded_vocab()} padded); random "
        f"weights, seed {STABLELM['seed']}; init "
        f"{time.perf_counter() - t0:.2f} s, {out['weights_gb']:.2f} GB on "
        f"the card")
    with torch.inference_mode():
        # no warm-up prefill (a 2 x 4096 prefill is ~4 s of fp32 GEMMs):
        # phase 12(a) has loaded the wide design, phases 8-13 cuBLAS
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.launches_tc = 0
        ssd_kernel.ssd_scan.launches = 0
        arb_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        logits, caches = M.forward_prefill(cfg, params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"], out["launches_tc"] = fa.launches, fa.launches_tc
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(out["launches"] == out["launches_tc"] == calls,
              f"prefill launched the attention kernel {out['launches']} "
              f"times, {out['launches_tc']} of them on the tensor cores; "
              f"expected one per layer ({calls}), all on them")
        check(ssd_kernel.ssd_scan.launches == 0
              and not any(arb_kernel.launch_counts().values()),
              "the prefill launched an SSD or arbitration kernel")
        check(logits.shape == (Bsz, cfg.padded_vocab())
              and bool(torch.isfinite(logits).all())
              and bool((logits[:, V:] == -1e9).all()),
              "prefill logits: wrong shape, not finite or padding unmasked")
        out["tokens_per_s"] = Bsz * Slen / wall
        out["prefill_ms"] = wall * 1e3
        say(f"[stablelm] prefill {Bsz} x {Slen} tokens on the kernel: "
            f"{wall * 1e3:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, peak "
            f"memory {out['peak_gb']:.2f} GB; flash_attention launches "
            f"{out['launches']}, on the tensor cores {out['launches_tc']}")
        # a window as phase 13's
        for attempt in range(3):
            hits, seen, pwall, ev = _counted_window(
                lambda: M.forward_prefill(cfg, params, tokens), calls,
                f"stablelm_{attempt}")
            if seen == calls:
                break
        busy = sum(e[2] for e in ev)
        check(seen == calls
              and not any("flash_attention_kernel" in e[0] for e in ev),
              f"profiler: flash_attention_tc_kernel launched "
              f"{[h[1] for h in hits]} times, expected {calls} and no "
              f"CUDA-core attention kernel")
        attn_us = sum(h[2] for h in hits)
        out["device_ms_per_launch"] = attn_us / calls / 1e3
        out["busy"] = busy / 1e6 / pwall
        out["device_ms"] = busy / 1e3
        out["attention_share"] = attn_us / busy
        say(f"[stablelm] profiled prefill: {pwall * 1e3:.1f} ms wall, device "
            f"busy {out['busy']:.4f}, {out['device_ms']:.2f} ms device time, "
            f"{sum(e[1] for e in ev)} kernels; attention "
            f"{out['device_ms_per_launch']:.4f} ms device time per launch, "
            f"{out['attention_share']:.4f} of the device time")
        out["shares"] = _kernel_shares(ev, busy, "stablelm")
        mark("prefill and its profile done")

        # against the plain path on the card: last-position logits and
        # every layer's k/v cache
        fa.launches = 0
        t0 = time.perf_counter()
        plain, pcaches = M.forward_prefill(cfg, params, tokens,
                                           use_kernel=False)
        torch.cuda.synchronize()
        out["plain_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        check(fa.launches == 0, "the plain prefill launched the attention "
                                "kernel")
        err = _rel(logits[:, :V], plain[:, :V])
        agree = float((logits[:, :V].argmax(-1)
                       == plain[:, :V].argmax(-1)).float().mean())
        kc, pc = caches["blocks"]["s0"], pcaches["blocks"]["s0"]
        cache_err = max(_rel(kc[key], pc[key]) for key in ("k", "v"))
        out["logits_rel"], out["cache_rel"] = err, cache_err
        say(f"[stablelm] plain prefill (blockwise_attention, no attention "
            f"launch): {out['plain_prefill_ms']:.1f} ms wall; last-position "
            f"logits rel RMS {err:.4f} (tolerance {STABLELM_TOL['logits']}), "
            f"argmax agrees on {agree:.2f} of rows; k/v caches of all "
            f"{calls} layers rel RMS {cache_err:.2e} (tolerance "
            f"{STABLELM_TOL['cache']})")
        check(err <= STABLELM_TOL["logits"], "kernel and plain prefill "
                                             "logits differ beyond the "
                                             "tolerance")
        check(cache_err <= STABLELM_TOL["cache"], "kernel and plain prefill "
                                                  "caches differ beyond the "
                                                  "tolerance")
        del logits, caches, plain, pcaches, kc, pc
    del params, tokens
    torch.cuda.empty_cache()
    mark("checks done")

    # the serving loop at full width (it draws its own weights; decode
    # runs no attention kernel, as in the JAX package)
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", STABLELM["arch"], *STABLELM_SERVE_ARGV,
                      "--device", DEVICE])
    wall = time.perf_counter() - t0
    got = {k: res[k] for k in STABLELM_SERVE_EXPECTED}
    check(got == STABLELM_SERVE_EXPECTED,
          f"serve statistics {got} != the JAX package's "
          f"{STABLELM_SERVE_EXPECTED}")
    check(fa.launches == 0, "the serve's decode launched the attention "
                            "kernel")
    out["decode_steps_per_s"] = res["steps"] / wall
    say(f"[stablelm] serve {STABLELM['arch']} {' '.join(STABLELM_SERVE_ARGV)}"
        f": {got} == the JAX package's (mean slowdown "
        f"{got['mean_slowdown']:.4f}, p99 {got['p99_slowdown']:.4f}); "
        f"{wall:.2f} s wall (parameter init included), "
        f"{out['decode_steps_per_s']:.1f} decode steps/s at batch "
        f"{STABLELM_SERVE_ARGV[-1]}")
    torch.cuda.empty_cache()
    mark("done")
    return out


# ------------------------------------------------------------ phase 16 -----

# (a) 6b's sweep on a world of 2; (b) 6a's mega cell and (c) 6b's sweep
# on a world of 5 (12 runs a group padded to 15): gloo worlds on the one
# card, each rank a spawned process
SHARD_WORLDS = {2: ("sweep",), 5: ("mega", "sweep")}
# the examples and the trace export on the card and on the CPU, each at
# these flags; in the worker pool, queued before phase 9
EXAMPLES = {
    "homa": ("examples/torch_homa_network_sim.py",
             ["--messages", "300", "--max-slots", "3000"]),
    "fabric": ("examples/torch_fabric_incast.py",
               ["--bursts", "2", "--background", "150", "--max-slots",
                "3000"]),
    "trace": ("scripts/torch_export_trace.py",
              ["--n-messages", "300", "--max-slots", "3000"]),
}


def _example_job(name, device):
    """One example's ``run`` on ``device`` in a worker: its printed lines
    (the trace export: its line and the JSON it wrote), the hand-written
    kernels' launches and the seconds."""
    import importlib.util
    import tempfile
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.arbiter import kernel
    script, argv = EXAMPLES[name]
    spec = importlib.util.spec_from_file_location(Path(script).stem,
                                                  ROOT / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # beside the pool's other workers
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = mod.run(argv + ["--device", device] + (
                ["--out", str(Path(tmp) / "trace.json")]
                if name == "trace" else []))
    finally:
        torch.set_num_threads(threads)
    if name == "trace":
        out = [out["line"].replace(tmp, "<tmp>"), out["trace"]]
    return out, kernel.launch_counts(), time.perf_counter() - t0


def _start_examples():
    """Queue the example jobs, card and CPU, on the worker pool."""
    calls = [(_example_job, (name, dev)) for name in EXAMPLES
             for dev in (DEVICE, "cpu")]
    return dict(zip([(n, d) for _, (n, d) in calls], _submit_each(calls)))


def _shard_rank(rank, tmp, world, jobs):
    """One rank of a phase-16 world: each job of ``jobs`` ("sweep": 6b's
    sweep; "mega": 6a's cell) with ``shard=True``, its launches counted
    from 0 just before it; what each returned, its launches and its
    seconds go to ``tmp/rank<r>.pkl``."""
    import pickle
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import run_sweep
    from repro_torch.kernels.arbiter import kernel
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), world), rank=rank, world_size=world)
    out = {}
    try:
        for job in jobs:
            kernel.reset_launch_counts()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            r = _sweep_mega() if job == "mega" else run_sweep(
                _sweep_config("fused"),
                _sweep_spec(_sweep_tables(), shard=True))
            torch.cuda.synchronize()
            out[job] = (r, kernel.launch_counts(), time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    (Path(tmp) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _same_stats(a, b) -> bool:
    """Two streaming results bit for bit: every field, the histogram and
    the per-level bytes elementwise."""
    import dataclasses
    import numpy as np
    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               if isinstance(getattr(a, f.name), np.ndarray)
               else getattr(a, f.name) == getattr(b, f.name)
               for f in dataclasses.fields(a))


def phase_shard(world1, examples):
    """Phase 16: the sharded sweep on gloo worlds of 2 and 5 ranks on the
    one card against phase 6's world-of-one results (``world1``; run in
    the pool when phase 6 did not), and the examples' card runs against
    their CPU runs (``examples``, queued on the pool)."""
    import pickle
    import tempfile
    import numpy as np
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    if world1 is None:
        (stats, _, _, wall1), mega = _in_workers(
            _sweep_job, [("sweep", "fused"), ("mega", None)])
        world1 = {"sweep": stats, "mega": (mega[5], mega[1], mega[3]),
                  "rate": len(stats) * SWEEP_SLOTS / wall1}
    B = len(world1["sweep"])
    pooled1, done1, horizon = world1["mega"]
    out = {"rate": {1: world1["rate"]}, "launches": {}}
    for world, jobs in SHARD_WORLDS.items():
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            mp.start_processes(_shard_rank, args=(tmp, world, jobs),
                               nprocs=world, start_method="spawn")
            ranks = [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes())
                     for r in range(world)]
        say(f"[shard] world of {world} on the one card: "
            f"{time.perf_counter() - t0:.1f} s with its processes' start")
        for r, got in enumerate(ranks):
            if "sweep" in got:
                stats, launches, _ = got["sweep"]
                check(len(stats) == B and all(
                    _same_stats(a, b) for a, b in zip(stats, world1["sweep"])),
                      f"world {world} rank {r}: the sharded sweep's "
                      f"statistics differ from the world of one's")
                check(launches == {"priority_arbiter": 0, "srpt_topk": 0,
                                   "fused_slot": 0,
                                   "fused_slot_batch": SWEEP_SLOTS,
                                   "ring_insert": 3 * SWEEP_SLOTS},
                      f"world {world} rank {r}: sweep launches {launches}, "
                      f"expected one fused_slot_batch a slot")
            if "mega" in got:
                (p99, done, _, _, _, pooled), launches, _ = got["mega"]
                check(done == done1 and all(
                    np.array_equal(pooled[p], pooled1[p]) for p in PROTOCOLS),
                      f"world {world} rank {r}: the mega cell's pooled "
                      f"histograms or completions ({done}) differ from the "
                      f"world of one's ({done1})")
                check(launches["fused_slot_batch"] == len(PROTOCOLS) * horizon,
                      f"world {world} rank {r}: mega launches {launches}, "
                      f"expected one fused_slot_batch a slot, {horizon} a "
                      f"protocol")
        if "sweep" in ranks[0]:
            wall = max(got["sweep"][2] for got in ranks)
            out["rate"][world] = B * SWEEP_SLOTS / wall
            out["launches"][world] = ranks[0]["sweep"][1]
            say(f"[shard] (a/c) 6b's {B} full-width runs x {SWEEP_SLOTS} "
                f"slots on {world} ranks ({-(-B // world)} runs a rank, "
                f"{-(-B // world) * world - B} padding): every rank's "
                f"statistics equal the world of one's, one fused_slot_batch "
                f"a slot on each; {wall:.2f} s, {out['rate'][world]:.1f} "
                f"runs*slots/s")
        if "mega" in ranks[0]:
            say(f"[shard] (b) the mega cell on {world} ranks (12 runs a "
                f"protocol padded to {-(-12 // world) * world}, "
                f"{len(PROTOCOLS)} protocols, {horizon} slots): pooled "
                f"histograms and {done1} completions equal the world of "
                f"one's on every rank; "
                f"{max(got['mega'][2] for got in ranks):.2f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(f"[shard] (c) runs*slots/s of 6b's sweep by world size on the one "
        f"card ({smi}): " + ", ".join(f"{w}: {r:.1f}"
                                      for w, r in out["rate"].items()))

    # the examples: the card's printed tables and trace JSON against the
    # CPU's
    for name in EXAMPLES:
        (card, launches, t_card), (cpu, cpu_launches, t_cpu) = (
            examples[name, d].result() for d in (DEVICE, "cpu"))
        check(card == cpu, f"{name}: the card's output differs from the "
                           f"CPU's")
        check(launches["priority_arbiter"] > 0 and launches["srpt_topk"] > 0
              and not any(cpu_launches.values()),
              f"{name}: kernel launches card {launches}, CPU {cpu_launches}")
        say(f"[shard] {EXAMPLES[name][0]} {' '.join(EXAMPLES[name][1])}: the "
            f"card's output (staged cuda backend, launches {launches}; "
            f"{t_card:.1f} s) equals the CPU's ({t_cpu:.1f} s)")
    say(f"[shard] done at +{time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------- main -----

PHASES = ("card", "kernels", "goldens", "full", "window", "sweep", "model",
          "llama", "faults", "host", "train", "deepseek", "xattn", "dryrun",
          "stablelm", "shard")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    bad = sorted(set(phases) - set(PHASES))
    if bad or ("window" in phases and "full" not in phases):
        print(f"FAIL: unknown phases {bad} or window without full (its "
              f"windows start from the full run's state)", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs the port on a card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT / 'src' / 'repro_torch'} missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    res = {}
    early = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        say(f"[summary] phase {name}: {time.perf_counter() - t0:.1f} s")
        return r

    try:
        run("card", phase_card)
        if "kernels" in phases:
            res["err"], res["perf"] = run("kernels", phase_kernels)
        if "goldens" in phases or "full" in phases:
            r = run(",".join(p for p in ("goldens", "full") if p in phases),
                    phase_goldens_full, phases)
            if r is not None:
                res["full_launches"], res["full_rate"], res["handoff"] = r
        if "window" in phases:
            res["window"] = run("window", phase_window, res["handoff"])
        if "sweep" in phases:
            (res["sweep_launches"], res["sweep_window"],
             res["sweep_rate"], res["world1"]) = run("sweep", phase_sweep)
        if "model" in phases:
            res["model"] = run("model", phase_model)
        if "llama" in phases:
            res["llama"] = run("llama", phase_llama)
        if "shard" in phases:
            examples = _start_examples()
        if "faults" in phases:
            res["faults"] = run("faults", phase_faults)
        if "host" in phases:
            res["host"] = run("host", phase_host)
        if "shard" in phases:
            res["shard"] = run("shard", phase_shard, res.get("world1"),
                               examples)
        _close_pool()                # no later phase uses it
        if "train" in phases:
            res["train"] = run("train", phase_train)
        if "dryrun" in phases and {"deepseek", "xattn"} & set(phases):
            early = _start_dryrun_cells()
        if "deepseek" in phases:
            res["deepseek"] = run("deepseek", phase_deepseek)
        if "xattn" in phases:
            res["xattn"] = run("xattn", phase_xattn)
        if "dryrun" in phases:
            res["dryrun"] = run("dryrun", phase_dryrun, early)
        if "stablelm" in phases:
            res["stablelm"] = run("stablelm", phase_stablelm)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        _close_pool()
        for p, err in early.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    say(f"[summary] phases {','.join(phases)}: "
        f"{time.perf_counter() - t_start:.1f} s")
    if set(phases) != set(PHASES):
        say("[summary] a subset of the phases ran: no result lines")
        return 0
    full_rate, window = res["full_rate"], res["window"]
    sweep_rate, sweep_window = res["sweep_rate"], res["sweep_window"]
    full_launches, sweep_launches = res["full_launches"], \
        res["sweep_launches"]
    err, perf, model, llama, fz, hz = (res["err"], res["perf"],
                                       res["model"], res["llama"],
                                       res["faults"], res["host"])
    say(f"[summary] runs*slots/s: B=1 cuda {full_rate:.1f}; B=12 "
        + ", ".join(f"{b} {r:.1f}" for b, r in sweep_rate.items()))
    sweep_cuda = sweep_window["cuda"]
    say(f"[summary] ms/slot (device busy): B=1 cuda "
        f"{window['cuda']['ms_per_slot']:.3f} ({window['cuda']['busy']:.4f}),"
        f" B=1 fused {window['fused']['ms_per_slot']:.3f} "
        f"({window['fused']['busy']:.4f}), B=12 fused "
        f"{sweep_window['ms_per_slot']:.3f} ({sweep_window['busy']:.4f}), "
        f"B=12 cuda {sweep_cuda['ms_per_slot']:.3f} "
        f"({sweep_cuda['busy']:.4f})")
    say(f"[summary] device us/slot: B=1 cuda "
        f"{window['cuda']['device_us_per_slot']:.1f}, B=1 fused "
        f"{window['fused']['device_us_per_slot']:.1f}, B=12 fused "
        f"{sweep_window['device_us_per_slot']:.1f}, B=12 cuda "
        f"{sweep_cuda['device_us_per_slot']:.1f}")
    fw = fz["window"]
    say(f"[summary] faults ({fz['label']}): slots/s cuda "
        f"{fz['rate']['cuda']:.1f}, fused {fz['rate']['fused']:.1f}, "
        f"reference {fz['rate']['reference']:.1f}; window ms/slot (device "
        f"busy; device us/slot) cuda {fw['cuda']['ms_per_slot']:.3f} "
        f"({fw['cuda']['busy']:.4f}; {fw['cuda']['device_us_per_slot']:.1f})"
        f", fused {fw['fused']['ms_per_slot']:.3f} "
        f"({fw['fused']['busy']:.4f}; "
        f"{fw['fused']['device_us_per_slot']:.1f}); B=4 sweep runs*slots/s "
        f"fused {fz['rate']['sweep_fused']:.1f}, cuda "
        f"{fz['rate']['sweep_cuda']:.1f}")
    hw = hz["window"]
    say(f"[summary] host (kernel_stack + trace, 144 hosts, 4000 slots in "
        f"workers): slots/s cuda {hz['rate']['cuda']:.1f}, fused "
        f"{hz['rate']['fused']:.1f}, reference {hz['rate']['reference']:.1f}"
        f"; window ms/slot (device busy; device us/slot; kernels/slot) cuda "
        f"{hw['cuda']['ms_per_slot']:.3f} ({hw['cuda']['busy']:.4f}; "
        f"{hw['cuda']['device_us_per_slot']:.1f}; "
        f"{hw['cuda']['kernels_per_slot']:.1f}), fused "
        f"{hw['fused']['ms_per_slot']:.3f} ({hw['fused']['busy']:.4f}; "
        f"{hw['fused']['device_us_per_slot']:.1f}; "
        f"{hw['fused']['kernels_per_slot']:.1f}) beside phase 5's cuda "
        f"{window['cuda']['kernels_per_slot']:.1f} kernels/slot, "
        f"{window['cuda']['device_us_per_slot']:.1f} us/slot; capture "
        f"cost {hz['capture_pct']:+.1f}%; B=4 sweep runs*slots/s fused "
        f"{hz['rate']['sweep_fused']:.1f}, cuda "
        f"{hz['rate']['sweep_cuda']:.1f}")
    say(f"[summary] mamba2-130m: prefill {model['tokens_per_s']:.0f} "
        f"tokens/s (4 x 4096), serve {model['decode_steps_per_s']:.1f} "
        f"decode steps/s (batch 4)")
    say(f"[summary] llama3.2-3b: prefill {llama['tokens_per_s']:.0f} "
        f"tokens/s (4 x 4096), serve {llama['decode_steps_per_s']:.1f} "
        f"decode steps/s (batch 4)")
    tr = res["train"]
    say(f"[summary] mamba2-130m train (16 x 2048, grad_accum 2, remat): "
        f"{tr['ms_per_step']:.1f} ms/step, {tr['tokens_per_s']:.0f} "
        f"tokens/s, peak {tr['peak_gb']:.2f} GB, busy {tr['busy']:.4f}; "
        f"homa sync {tr['dp']['homa']['chunks']} chunk collectives a step")
    ds = res["deepseek"]
    say(f"[summary] deepseek-v2-lite-16b: prefill {ds['tokens_per_s']:.0f} "
        f"tokens/s (4 x 4096), peak {ds['peak_gb']:.2f} GB, busy "
        f"{ds['busy']:.4f}; serve {ds['decode_steps_per_s']:.1f} decode "
        f"steps/s (batch 4); attention at MLA's (192, 128) "
        f"{ds['mla']['ms']:.4f} ms vs bound {ds['mla']['bound_ms']:.4f} ms, "
        f"StableLM's (160, 160) {ds['stablelm']['ms']:.4f} ms vs "
        f"{ds['stablelm']['bound_ms']:.4f} ms")
    xa = res["xattn"]
    for tag in ("whisper", "vision"):
        m = xa[tag]
        say(f"[summary] {tag} (phase 13): prefill {m['tokens_per_s']:.0f} "
            f"tokens/s ({m['prefill_ms']:.1f} ms), peak {m['peak_gb']:.2f} "
            f"GB, busy {m['busy']:.4f}, {m['launches']} attention launches;"
            f" decode {m['decode']['ms_per_step']:.2f} ms/step")
    for d in res["dryrun"]["cells"]:
        say(f"[summary] dry run {d['arch']} x {d['shape']} x {d['mesh']}: "
            f"peak {d['peak_bytes'] / 1e9:.3f} GB a device, "
            f"{d['cost']['flops'] / 1e12:.4f} TFLOP, collectives "
            f"{d['collectives']['total_bytes'] / 1e9:.4f} GB")
    for name, r in res["dryrun"]["steps"].items():
        say(f"[summary] dry-run memory model, {name}: peak predicted "
            f"{r['predicted']['peak_bytes'] / 1e9:.3f} GB, card "
            f"{r['peak_bytes'] / 1e9:.3f} GB")
    sl = res["stablelm"]
    say(f"[summary] stablelm-12b (phase 15): prefill "
        f"{sl['tokens_per_s']:.0f} tokens/s (2 x 4096, "
        f"{sl['prefill_ms']:.1f} ms), {sl['device_ms']:.1f} ms device time, "
        f"busy {sl['busy']:.4f}, attention {sl['attention_share']:.4f} of "
        f"it ({sl['device_ms_per_launch']:.4f} ms a launch), peak "
        f"{sl['peak_gb']:.2f} GB; serve {sl['decode_steps_per_s']:.1f} decode "
        f"steps/s (batch 4)")
    sh = res["shard"]
    say("[summary] sharded sweep (phase 16), 6b's runs*slots/s by world "
        "size on the one card: " + ", ".join(
            f"{w}: {r:.1f}" for w, r in sh["rate"].items()))
    say("[summary] attention at phase 13's calls (ms vs bound): " + "; ".join(
        f"{r['name']} {r['ms']:.4f} vs {r['bound_ms']:.4f}"
        for r in xa["shapes"]))
    src = "src/repro_torch/kernels/arbiter/csrc/arbiter.cu"
    rows = {
        # name: (replaces, launches on its path, device ms per launch)
        "priority_arbiter": ("src/repro/kernels/arbiter/kernel.py:67",
                             full_launches["cuda"]["priority_arbiter"],
                             window["cuda"]["per_launch_ms"]
                             ["priority_arbiter"]),
        "srpt_topk": ("src/repro/kernels/arbiter/kernel.py:139",
                      full_launches["cuda"]["srpt_topk"],
                      window["cuda"]["per_launch_ms"]["srpt_topk"]),
        "fused_slot": ("src/repro/kernels/arbiter/fused.py:206",
                       full_launches["fused"]["fused_slot"],
                       window["fused"]["per_launch_ms"]["fused_slot"]),
        "fused_slot_batch": ("src/repro/kernels/arbiter/fused.py:231",
                             sweep_launches["fused_slot_batch"],
                             sweep_window["per_launch_ms"]
                             ["fused_slot_batch"]),
    }
    # launches on the rounds top-K routine in the main path's runs (0:
    # every K = 7 launch took the one-pass routine)
    rounds = {"srpt_topk": full_launches["rounds"]["srpt_topk"],
              "fused_slot": full_launches["rounds"]["fused_slot"],
              "fused_slot_batch":
                  sweep_launches["rounds"]["fused_slot_batch"]}
    # launches on this slice's path, the fault runs of phase 9b (B = 1)
    # and 9c (the B = 4 sweep)
    fl = fz["launches"]
    fault_launches = {
        "priority_arbiter": fl["cuda"]["priority_arbiter"],
        "srpt_topk": fl["cuda"]["srpt_topk"],
        "fused_slot": fl["fused"]["fused_slot"],
        "fused_slot_batch": fl["sweep_fused"]["fused_slot_batch"]}
    # and on phase 10's: the host/trace runs of 10b (B = 1) and 10c (B = 4)
    hl = hz["launches"]
    host_launches = {
        "priority_arbiter": hl["cuda"]["priority_arbiter"],
        "srpt_topk": hl["cuda"]["srpt_topk"],
        "fused_slot": hl["fused"]["fused_slot"],
        "fused_slot_batch": hl["sweep_fused"]["fused_slot_batch"]}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "launches_faults": fault_launches[name],
         "launches_host": host_launches[name],
         "max_abs_err": err[name], "ms": perf[name]["ms"],
         "plain_ms": perf[name]["plain_ms"],
         "bound_ms": perf[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": perf[name]["library_ms"],
         "device_ms_per_launch": dev_ms,
         "device_ms_main_shapes": perf[name]["device_ms"],
         **({"launches_rounds": rounds[name]} if name in rounds else {}),
         # phase 16: each rank's launches of 6b's sweep on a world of 2
         **({"launches_shard": sh["launches"][2][name]}
            if name == "fused_slot_batch" else {}),
         **({"library_device_ms": perf[name]["library_device_ms"],
             "sort_device_ms": perf[name]["sort_device_ms"]}
            if name == "srpt_topk" else {}),
         **({"device_ms_b12": sweep_cuda["per_launch_ms"]
             ["priority_arbiter"],
             "floor_ms": perf[name]["floor_ms"],
             "library_device_ms": perf[name]["library_device_ms"],
             "up_device_ms": perf[name]["up_device_ms"],
             "device_ms_by_shape": perf[name]["by_shape"]}
            if name == "priority_arbiter" else {}),
         **({"device_ms_rows_new": perf[name]["device_ms_rows_new"],
             "device_ms_rows_scalar": perf[name]["device_ms_rows_scalar"]}
            if name.startswith("fused") else {})}
        for name, (rep, n, dev_ms) in rows.items()]
    kernels.append(
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd/kernel.py:69",
         "launches": model["launches"], "max_abs_err": model["max_abs_err"],
         "ms": model["ms"], "plain_ms": model["plain_ms"],
         "bound_ms": model["bound_ms"], "bound_by": model["bound_by"],
         "library_ms": None,
         "device_ms_per_launch": model["device_ms_per_launch"],
         "launches_tc": model["launches_tc"],
         "cuda_core_ms": model["cuda_core_ms"],
         "bound_fp32_ms": model["bound_fp32_ms"],
         "device_us_per_kernel": model["device_us_per_kernel"]})
    kernels.append(
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/attention/csrc/attention.cu",
         "replaces": "src/repro/kernels/attention/kernel.py:74",
         "launches": llama["launches"], "max_abs_err": llama["max_abs_err"],
         "ms": llama["ms"], "plain_ms": llama["plain_ms"],
         "bound_ms": llama["bound_ms"], "bound_by": llama["bound_by"],
         "library_ms": llama["library_ms"],
         "device_ms_per_launch": llama["device_ms_per_launch"],
         "launches_tc": llama["launches_tc"],
         "cuda_core_ms": llama["cuda_core_ms"],
         # phase 12's path: DeepSeek-V2-Lite's prefill at MLA's (192, 128)
         # on the tensor cores
         "mla": {"launches": ds["launches"],
                 "launches_tc": ds["launches_tc"],
                 "max_abs_err": ds["max_abs_err"],
                 "device_ms_per_launch": ds["device_ms_per_launch"],
                 **ds["mla"]},
         # phase 15's path: StableLM-12B's 2 x 4096 prefill, every call on
         # the tensor cores' wide design (dv 160); checked and timed at
         # phase 12(a)'s 4 x 4096
         "stablelm": {"launches": sl["launches"],
                      "launches_tc": sl["launches_tc"],
                      "max_abs_err": ds["stablelm_max_abs_err"],
                      "device_ms_per_launch": sl["device_ms_per_launch"],
                      **ds["stablelm"]},
         # phase 13's path: Whisper-small's and Llama-3.2-Vision's
         # prefills, every call on the tensor cores; each call's
         # launches per prefill counted by shape
         "xattn": {"launches": {t: xa[t]["launches"]
                                for t in ("whisper", "vision")},
                   "device_ms_per_launch": {
                       t: xa[t]["device_ms_per_launch"]
                       for t in ("whisper", "vision")},
                   "calls": xa["shapes"]}})
    say(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
