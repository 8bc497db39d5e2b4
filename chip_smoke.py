#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --ghs-scales 16,18`` only times ``method="ghs"``
on rmat at those scales: how phase 5e's scale was chosen.)

Phases (any failure ends the run with a non-zero exit and no result line):

1. card and build — the card's name and power limit, the torch and CUDA
   versions, and a build of every CUDA kernel from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, started together), with the
   compiler's ``-Xptxas -v`` report;
2. kernels against their plain PyTorch versions, bit for bit, at the
   paths' shapes and on edge cases, each timed with CUDA events (the host
   run ahead of the device, see ``_time_ms``) beside its bound, its plain
   version and, where one exists, a single PyTorch library call: the
   election scans and the pointer jump with inputs from round 1 of the
   RMAT scale-20 device-loop solve, the 32-bit scan with inputs from
   round 1 of the host-loop solve of the same graph, and the
   edge-hash lookup over the one-process hash table of that graph's
   adjacency packed into 16-byte records (its host build and the pack
   timed as set-up), beside the entry that takes the three arrays and
   packs them before each launch; the pointer jump (one cooperative
   launch that stops at the fixed point) also on every kind of forest
   (identity, deep chain, random, the cycle, labels >= n) at five sizes
   up to 2^22 and on comp shorter and longer than parent, timed on the
   identity forest and the deep chain beside round 1's input, each with
   its doubling steps to the fixed point, three calls queued on one
   stream and one on a side stream, its registers, spills and stack and
   its grid;
3. the main path — ``minimum_spanning_forest(graph, method="boruvka")`` on
   a Graph500-style RMAT graph of scale 20 (average degree 32, fixed seed)
   with ``use_pallas=True`` under both round bodies, each forest held
   against the numpy Borůvka oracle, the kernels' launch counts read, the
   median wall time over several runs, and one profiler window, which
   must show one pointer-jump kernel a call of its wrapper;
4. the legacy host loop (``round_loop="host"``) on the same graph with and
   without the 32-bit scan kernel, each forest held against the oracle,
   beside the device loop's medians; and the edge-hash lookup path
   (``edge_hash.ops.lookup`` in the table packed once) over every directed
   edge and as many misses, its answers checked against the adjacency;
5. a small RMAT scale-10 sweep over every knob the port exposes, both round
   loops, each forest held against Kruskal and against the same solve on
   the CPU;
5b. the graph pipeline and batched solving:
   a. ``pipeline.build`` of the counter-based RMAT scale 20 (degree 32,
      the general preprocessing path) on the card, timed by CUDA events and
      the host clock, byte-identical to ``build_host`` (timed once); every
      generator kind at scales 17 (the narrow path) and 18 likewise; the
      device edge sampler against ``sample_mask``;
   b. ``minimum_spanning_forest`` of that ``DeviceEdges`` (built afresh
      each run) with ``use_pallas=True`` under both round bodies: staged on
      the card (``edge_staging == "device"``), each forest held against
      the numpy Borůvka oracle, the kernels' launches read, medians of the
      solve and of build plus solve beside phase 3's; one profiler window;
   c. 256 pipeline RMAT graphs (scales 8 to 12) solved in buckets under
      both round bodies with ``use_pallas=True``, every interval dispatch
      under sync debug mode "error", after ``warm_bucket`` on each shape:
      each bucket alone launches K1 once a dispatched round where it fails
      the contraction gate (scales 11 and 12) and never where it passes,
      every lane equal to its single solve on the card and to Kruskal, with
      the same rounds; graphs a second of the batched solve beside the
      single solves in a loop;
5c. Filter-Borůvka and incremental updates, on phase 3's graph:
   a. ``minimum_spanning_forest(graph, method="filter_boruvka")`` with
      ``use_pallas=True`` under both round bodies at the default sample
      rate and levels, each forest equal to the oracle and to phase 3's
      Borůvka forest bit for bit; the survivors, the passes, K3's launches
      (and those of the label loop) and the label loop's host reads; the
      median wall time beside phase 3's; K3 against its plain version on
      the label chain's first hook forest, timed beside its bound; the
      level chain alone at 1, 2, 4 and 8 iterations between two reads;
   b. ``incremental_forest`` of the graph, then three chained
      ``apply_updates`` batches of 8,192 inserts and 8,192 deletes (half
      tree edges, one pair deleted and re-inserted lighter) with
      ``use_pallas=True``, ``round_kernel="pallas"``: each updated graph
      equal to ``apply_edge_batch``'s and each forest to a fresh solve on
      the card; the ledger, the candidates as a share of m, K3's launches
      and the label loop's reads, the update's wall time beside the fresh
      solve's;
5d. the MST service (``launch/serve.py``), on the card:
   a. the JAX package's serving settings (8 lanes, 50 ms, 64 queued, 256
      vertices, 1,024 edges): ``warmup`` timed, then 160 graphs (its serving
      workload: rmat scales 2 to 8, degree 8, every 16th at 32 and shed)
      offered by ``run_poisson`` at 5, 15 and 40 graphs/s; p50, p99 and mean
      latency, graphs/s, flushes by trigger, ghost lanes and sheds; every
      served forest equal to Kruskal's and to its batched solve;
   b. phase 5b's corpus (256 pipeline rmat graphs, scales 8 to 12) at 4,096
      vertices and 65,536 edges with ``use_pallas=True``, warmup timed,
      offered at 200 and 800 graphs/s, checked as in (a);
   c. 16 update requests (pipeline rmat scale 10, 64 inserts and 64 deletes
      each), each equal to a standalone ``apply_updates`` on the card;
5e. the paper-faithful GHS engine, ``method="ghs"``, on the card:
   a. rmat scale 10 under both round loops and the five ablation settings,
      each forest equal to Kruskal's, the interval kernel launched once an
      interval (device loop) or a superstep (host loop) and nothing else;
   b. the interval kernel against its plain version on every ``ShardState``
      array after each interval at rmat scale 8, every setting, bit for bit;
      its instances' registers, stack and spills;
   c. rmat scale GHS_BIG_SCALE: ``init_shards``' host time, the solve's
      supersteps, intervals, messages, wall time and ns a message (one
      profiler window) beside the Borůvka solve of the same graph, the
      forest equal to the numpy oracle; its first interval, kernel against
      plain on the whole state, timed beside its bound;
6. the LM serving path, Qwen1.5-0.5B at its full config in bf16:
   a. the attention kernels (flash attention for prefill, decode attention
      for each decode step) against their plain versions, within the
      tolerances stated below, in bf16 and float32: on the inputs of every
      layer of the served model's prefill and first decode step, on
      Qwen2.5-14B's GQA shapes (40 query heads over 8 KV heads, hd 128),
      on ragged lengths (S = 77 and 1000, non-causal, cache lengths 0,
      1 and S) and, for decode attention, on a mostly empty cache (length
      33 of S); each timed beside its bound, its plain version and
      ``scaled_dot_product_attention`` (and its time as a multiple of the
      latter's); one profiler window each over a prefill and over decode
      steps; flash attention's bf16 instance at every head dim: its
      registers, spills and shared memory a block, and its SASS
      (``cuobjdump -sass``), which must hold tensor-core instructions
      (HMMA or HGMMA); decode attention's instances at head dims 64, 96
      and 128, its split plan and rate (bytes over time) at its three
      shapes, and its wrapper's host time a call;
   b. ``serve_lm.main`` at batch 8, prompt 1024 and 512 generated tokens,
      its decode loop under sync debug mode "error", with the kernels'
      launch counts checked (one flash attention per layer, one decode
      attention per layer and step) and every logit finite; then
      Qwen2.5-14B at full width with its depth cut to 8 layers, batch 4,
      prompt 1024, 32 tokens;
   c. two layers at Qwen1.5-0.5B's width in float32, on the card with the
      kernels and on the CPU with the plain versions, from the same
      weights, teacher-forced, logits held within ``PARITY_TOL``;
   d. Phi-3-mini at its full config (head dim 96): the attention kernels
      against their plain versions on its layer-0 inputs and at head dims
      96 and 24 (its smoke config's), in bf16 and float32, timed at its
      shapes; then ``serve_lm.main`` at batch 8, prompt 1024, 32 tokens,
      with the launch counts checked;
7. RWKV6-3B at its full config in bf16, the WKV recurrence K9:
   a. K9 against its plain version on the inputs of every layer of the
      served model's prefill and on edge cases (T = 1, 77 and 0, head dims
      16 and 64, the decay near 0 and near 1), in bf16 and float32, within
      the tolerances stated below and bit for bit; its instances'
      registers, spills and shared memory; timed beside its bound and
      plain version; one profiler window each over a prefill and decode
      steps;
   b. ``serve_lm.main`` at batch 8, prompt 1024 and RWKV_GEN tokens: one K9
      launch per layer, every logit finite;
   c. two layers at its width in float32, card against CPU as in 6c;
8. Jamba v0.1 and MoE, the Mamba selective scan K8:
   a. K8 against its plain version on the inputs of every Mamba sublayer
      of the served Jamba prefill (one superblock at full width) and on
      edge cases (T = 1, 31, 32, 33, 77, 1000 and 0, N = 8 and 16, dim =
      200, 512 and 8192, Δ near 1e-3 and near 1), in bf16 and float32,
      with and without the final state, within the tolerances stated below
      and, since K8 repeats the plain version's every float32 operation in
      its order, bit for bit (the phase fails otherwise); its instances'
      registers, spills and shared memory; timed beside its bound (the
      largest of the bytes' time, the exps' on the special-function units
      and the float32 operations' issue, at the card's SM clock) and plain
      version; profiler windows over a Jamba prefill and decode steps;
   b. ``torch._grouped_mm``, MoE's grouped product, checked free of host
      syncs in bf16 and held against per-group products (float32's
      behaviour reported); ``serve_lm.serve`` on Jamba at full width,
      depth cut to one superblock, at batch 8, prompt 1024 and 32 tokens:
      7 K8 and 1 K6 in the prefill, 1 K7 a decode step, every logit
      finite; then ``serve_lm.main`` on Qwen2-MoE-A2.7B at its full
      config, batch 8, prompt 1024, 32 tokens, one K6 a layer and one K7
      a layer and step;
   c. Jamba's superblock at a quarter of its width and two layers of
      Qwen2-MoE at its full width, float32, card against CPU as in 6c,
      Jamba's prefill SSM state error reported;
9. one ``{"kernels": [...]}`` line, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

A record of the run is written to ``chip_smoke_out/chip_smoke.json`` and the
profilers' tables to ``chip_smoke_out/chip_smoke_profile*.txt``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chip_smoke_out"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor peak (float32 rate)
SCALE = 20
SEED = 20
SOLVE_RUNS = 5
HOST_SOLVE_RUNS = 3
MISS_SHIFT = 7919               # receiver shift of the lookup's miss queries
PIPE_SCALE = 20                 # rmat built on the card (general path)
PIPE_KIND_SCALES = (17, 18)     # every kind: the narrow path's last scale,
                                # the general path's first
PIPE_RUNS = 5
PIPE_SAMPLE_RATE = 0.1
CORPUS_GRAPHS = 256             # the batched corpus: rmat, degree 32,
CORPUS_SCALES = (8, 9, 10, 11, 12)  # seed i at scale CORPUS_SCALES[i % 5]
CORPUS_TIMED_RUNS = 3
FILTER_RUNS = 3                 # filter_boruvka solves a round body
LABEL_CHECK_SWEEP = (1, 2, 4, 8)  # label-loop iterations between flag reads
UPDATE_BATCHES = 3              # chained apply_updates batches
UPDATE_SIZE = 8192              # inserts, and deletes, a batch
SERVE_KNOBS = dict(serve_lanes=8, serve_max_wait_ms=50.0,  # the JAX
                   serve_max_queue=64, batch_max_vertices=256,  # package's
                   batch_max_edges=1024)      # serving settings
SERVE_RATES = (5.0, 15.0, 40.0)  # offered graphs/s
SERVE_REQUESTS = 160
CORPUS_SERVE_KNOBS = dict(SERVE_KNOBS, batch_max_vertices=4096,
                          batch_max_edges=65536, use_pallas=True)
CORPUS_SERVE_RATES = (200.0, 800.0)  # the corpus of phase 5b, offered
SERVE_UPDATES = 16              # update requests: pipeline rmat scale 10,
SERVE_UPDATE_SCALE = 10
SERVE_UPDATE_SIZE = 64          # inserts, and deletes, a request
GHS_SCALE = 10                  # every knob of the GHS engine
GHS_KERNEL_SCALE = 8            # the interval kernel against its plain version
GHS_BIG_SCALE = 17              # the largest rmat scale solved within 60 s
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
LM_ARCH = "qwen1.5-0.5b"        # the served model, full config, bf16
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 512
LM_SEED = 0
GQA_ARCH = "qwen2.5-14b"        # full width, depth cut to GQA_LAYERS
GQA_LAYERS, GQA_BATCH, GQA_GEN = 8, 4, 32
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT, PARITY_GEN = 2, 2, 128, 8
PROFILE_DECODE_STEPS = 32
PHI3_ARCH = "phi3-mini-3.8b"    # head dim 96 (24 in its smoke config)
PHI3_GEN = 32
RWKV_ARCH = "rwkv6-3b"          # full config, bf16: K9 in every prefill layer
RWKV_GEN = 128
# Attention kernel against its plain version on the card: both compute in
# float32 from the same inputs and differ only in the order of their sums.
# float32: 1e-4 times the largest output (when above 1), a few hundred ulps
# at outputs of order 1.  bfloat16: the two float32 results may round to
# neighbouring bf16 values, so two bf16 ulps of each output (2**-6 of it)
# plus 1e-5 for outputs near zero.
ATTN_F32_TOL = 1e-4
ATTN_BF16_REL = 2.0 ** -6
# The card (kernels) against the CPU (plain versions), float32 logits of two
# layers at Qwen1.5-0.5B's width: the CPU parity tests' logits tolerance.
# Sums of depth up to 2816 taken in another order on each side leave errors
# of order 1e-5 at logits of order 1.
PARITY_TOL = 1e-4
# K9 against its plain version on the card.  float32 (TF32 off): 1e-4
# absolute on the output and on the float32 final state.  bf16: the output
# as max |got - want| / max |want| at 1e-2, since the output grows with T
# (to about 1e3 at the served shapes) and one bf16 ulp there is 4 or 8; the
# float32 state at 1e-4 absolute.  The kernel repeats the plain version's
# float32 operations in the same order, so it is expected to agree to the
# bit (error 0); the tolerances are what the check allows.
WKV_F32_TOL = 1e-4
WKV_BF16_REL = 1e-2
JAMBA_ARCH = "jamba-v0.1-52b"   # full width, bf16, depth cut to JAMBA_LAYERS
JAMBA_LAYERS = 8                # one superblock: 7 Mamba (K8), 1 attention
JAMBA_GEN = 32
MOE_ARCH = "qwen2-moe-a2.7b"    # full config, bf16
MOE_GEN = 32
# Jamba's parity model: one superblock at a quarter of its width, so that
# the CPU side fits (hd stays 128 and the GQA group 4; 16 experts top 2,
# N 16 and d_conv 4 as in the full config): about 0.93 B parameters.
JAMBA_PARITY = dict(n_layers=JAMBA_LAYERS, d_model=1024, n_heads=8,
                    n_kv_heads=2, d_ff=3584, d_expert=3584)
# K8 against its plain version on the card.  float32 (TF32 off): 1e-4
# absolute on y, times max |y| where that is above 1, and on the float32
# final state.  bf16: two bf16 ulps of each y (2**-6 of it) plus 1e-5 near
# zero; the float32 state at 1e-4 absolute.  The kernel repeats the plain
# version's float32 operations in the same order (expf, the halving sum
# over n), so it is expected to agree to the bit (error 0).
SCAN_F32_TOL = 1e-4
SCAN_BF16_REL = 2.0 ** -6


def _log(*parts) -> None:
    print(*parts, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


_SLEEP_CYCLES_PER_MS: list = []


def _hold_device(torch, ms: float) -> None:
    """Enqueue ``torch.cuda._sleep`` for about ``ms`` milliseconds on the
    current stream (its cycles a millisecond measured once, by events)."""
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10_000_000)
        stop.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(stop))
    torch.cuda._sleep(int(ms * _SLEEP_CYCLES_PER_MS[0]))


def _time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls,
    with the host ahead of the device.  The warm-up calls are timed on the
    host clock; then a ``torch.cuda._sleep`` enqueued before the start event
    holds the device for twice the host's issue time of the ``iters`` calls
    (plus 1 ms, at most 2 s), so that the device runs them back to back and
    the events time its work, not the host's issue of it (for a kernel of
    a few tens of microseconds the wrapper's host time is of the same
    order).  A call that waits for the device itself is timed as before."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3 / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    _hold_device(torch, min(2 * issue_ms * iters + 1.0, 2000.0))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` in microseconds, over ``calls``
    calls issued while a ``torch.cuda._sleep`` keeps the device busy, so
    that the host never waits for it."""
    fn()
    torch.cuda.synchronize()
    _hold_device(torch, 50.0)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return host_us


def _max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over the words (exact integers); 0 if equal."""
    diff = torch.nonzero(got != want).flatten()[:1000]
    if diff.numel() == 0:
        return 0
    return max(abs(int(a) - int(b)) for a, b in
               zip(got[diff].tolist(), want[diff].tolist()))


def _bound_ms(nbytes: int, nops: int,
              ops_per_s: float = INT_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _scan_cases(torch, dev, inf, dtype=None):
    """Edge cases for the scan kernels: (name, seg, oth, key); the values
    are int64 words, or int32 words for ``dtype=torch.int32``."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    dtype = dtype or torch.int64
    span = 2 ** 62 if dtype == torch.int64 else 2 ** 31 - 1

    def keys(m, choices=None):
        if choices is not None:
            k = choices[torch.randint(0, choices.numel(), (m,), generator=g)]
        else:
            k = torch.randint(-span, span, (m,), generator=g)
        k[torch.rand(m, generator=g) < 0.05] = inf
        return k.to(dtype)

    def case(name, seg, key):
        oth = torch.randint(0, 64, (seg.numel(),), generator=g)
        return (name, seg.to(torch.int32).to(dev), oth.to(torch.int32).to(dev),
                key.to(dev))

    m = 1 << 22
    yield case("one run over many blocks", torch.zeros(m, dtype=torch.int64),
               keys(m))
    yield case("runs crossing block boundaries",
               torch.sort(torch.randint(0, m // 3000, (m,), generator=g)).values,
               keys(m))
    yield case("all INF", torch.sort(torch.randint(0, 64, (m,), generator=g)).values,
               torch.full((m,), inf, dtype=dtype))
    r = (1 << 20) + 12345
    yield case("ragged length", torch.sort(torch.randint(0, r // 7, (r,), generator=g)).values,
               keys(r))
    yield case("duplicate keys", torch.sort(torch.randint(0, m // 50, (m,), generator=g)).values,
               keys(m, torch.tensor([5, -7, inf - 1, -inf - 1], dtype=torch.int64)))


def phase_kernels(torch, dev, graph, bundle, record, jump_ptxas: str) -> list:
    """Phase 2: every kernel of the main path against its plain version;
    for K3 also its times on the identity forest and a deep chain, a queue
    of three calls on one stream and one on a side stream, its resources
    from the compiler's report ``jump_ptxas`` and its grid."""
    from repro_torch.core import keys, union_find
    from repro_torch.core.boruvka_dist import _take
    from repro_torch.kernels.spmv_minplus import ops as spmv_ops
    from repro_torch.kernels.segment_min.segment_min import (
        segmented_min2_scan, segmented_min2_scan_plain)
    from repro_torch.kernels.spmv_minplus.spmv_minplus import (
        jump_steps, masked_minplus_scan, masked_minplus_scan_plain,
        pointer_jump, pointer_jump_plain)
    inf = keys.INF_KEY
    n = bundle.num_vertices

    # Round 1 of the rmat-20 solve: every vertex is its own fragment.
    comp = torch.arange(n, dtype=torch.int32, device=dev)
    cs, cd = _take(comp, bundle.src), _take(comp, bundle.dst)
    key = bundle.key
    alive = (cs != cd) & (key != inf)
    k = torch.where(alive, key, inf)
    seg_s, order = torch.sort(torch.cat([cs, cd]), stable=True)
    k1_key = torch.cat([k, k])[order].contiguous()
    k2_oth = torch.cat([cd, cs])[order].contiguous()
    k2_key = torch.cat([key, key])[order].contiguous()
    best = spmv_ops.elect(cs, cd, key, num_segments=n, lowering="scatter")
    elected = best != inf
    csrc = torch.from_numpy(graph.src).to(dev)
    cdst = torch.from_numpy(graph.dst).to(dev)
    eid = keys.unpack_edge_id(best)
    cu, cv = comp[_take(csrc, eid)], comp[_take(cdst, eid)]
    f = torch.arange(n, dtype=torch.int32, device=dev)
    other = torch.where(cu == f, cv, cu)
    parent = union_find.hook_min(n, torch.maximum(f, other),
                                 torch.minimum(f, other), elected).contiguous()
    seg64 = seg_s.to(torch.int64)
    lib_out = torch.full((n,), inf, dtype=torch.int64, device=dev)
    masked = torch.where((seg_s != k2_oth) & (k2_key != inf), k2_key, inf)
    M = seg_s.numel()
    scan_cases = list(_scan_cases(torch, dev, inf))

    # (name, kernel, plain version, main-path inputs, library call,
    #  bytes moved, operations, edge cases)
    specs = [
        ("segmented_min2_scan", segmented_min2_scan, segmented_min2_scan_plain,
         (seg_s, k1_key),
         lambda: lib_out.scatter_reduce_(0, seg64, k1_key, "amin"),
         (4 + 8 + 8) * M, 2 * M,
         [(c[0], (c[1], c[3])) for c in scan_cases]),
        ("masked_minplus_scan", masked_minplus_scan, masked_minplus_scan_plain,
         (seg_s, k2_oth, k2_key),
         lambda: lib_out.scatter_reduce_(0, seg64, masked, "amin"),
         (4 + 4 + 8 + 8) * M, 3 * M,
         [(c[0], (c[1], c[2], c[3])) for c in scan_cases]),
        ("pointer_jump", pointer_jump, pointer_jump_plain, (parent, comp),
         None, 4 * n + 4 * n + 4 * n,
         2 * n * _fixed_point_steps(torch, parent, jump_steps(n)),
         _jump_cases(torch, dev, n)),
    ]
    rows = [_kernel_row(torch, *spec) for spec in specs]
    rows[-1].update(_jump_extras(torch, dev, rows[-1], (parent, comp),
                                 jump_ptxas))
    record["kernels_phase"] = rows
    return rows


def _kernel_row(torch, name, kernel, plain, args, library, nbytes, nops,
                cases) -> dict:
    """Hold one kernel against its plain version on the path's inputs and
    on its edge cases (any difference raises), then time the kernel, the
    plain version and the library call; the row of the kernels line."""
    from repro_torch.kernels import KERNELS
    for cname, case_args in [("main path", args)] + cases:
        got, want = kernel(*case_args), plain(*case_args)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        _log(f"kernel {name} [{cname}, {want.numel()} lanes] "
             f"bit_exact={err == 0}")
        if err:
            raise AssertionError(f"{name} disagrees with its plain "
                                 f"version on {cname} (max abs err {err})")
    ms = _time_ms(torch, lambda: kernel(*args), 20)
    plain_ms = _time_ms(torch, lambda: plain(*args), 3, warmup=1)
    library_ms = _time_ms(torch, library, 20) if library else None
    bound_ms, bound_by = _bound_ms(nbytes, nops)
    source, replaces = KERNELS[name]
    _log(f"kernel {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
         f"{bound_by}, plain {plain_ms:.4f} ms, library "
         f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'})")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, bit_exact=True, max_abs_err=0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, lanes=args[-1].numel())


JUMP_KINDS = ("identity", "deep chain", "random forest", "cycle",
              "labels >= n")
JUMP_SIZES = (1, 97, (1 << 20) + 12345, 1 << 22)   # beside the path's n


def _jump_forest(torch, dev, kind, n, g):
    """int32 (parent, comp) of n labels on ``dev``: the identity forest, a
    deep chain, a random hook forest, the cycle i -> i + 1 (mod n), which
    changes at every step, or labels >= n (up to 2**31 - 1), which break
    the hook contract and which the clip maps to n - 1."""
    ids = torch.arange(n)
    comp = torch.randint(0, n, (n,), generator=g)
    if kind == "identity":
        parent = ids
    elif kind == "deep chain":
        parent = (ids - 1).clamp(min=0)
    elif kind == "random forest":
        parent = torch.minimum(torch.randint(0, n, (n,), generator=g), ids)
    elif kind == "cycle":
        parent = (ids + 1) % n
    else:
        parent, comp = (torch.randint(0, 2 * n + 3, (n,), generator=g)
                        for _ in range(2))
        parent[torch.rand(n, generator=g) < 0.1] = 2 ** 31 - 1
        comp[torch.rand(n, generator=g) < 0.1] = 2 ** 31 - 1
    return (parent.to(torch.int32).to(dev).contiguous(),
            comp.to(torch.int32).to(dev).contiguous())


def _jump_cases(torch, dev, n):
    """K3's edge cases: every kind of forest at the path's n and at
    JUMP_SIZES, and comp shorter and longer than parent."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    cases = [(f"{kind}, n={size}", _jump_forest(torch, dev, kind, size, g))
             for size in (n,) + JUMP_SIZES for kind in JUMP_KINDS]
    rand, comp = _jump_forest(torch, dev, "random forest", n, g)
    return cases + [
        ("ragged comp", (rand, comp[: n // 3 + 7].contiguous())),
        ("comp longer than parent", (rand, torch.cat([comp, comp.flip(0)])))]


def _fixed_point_steps(torch, parent, cap: int) -> int:
    """Doubling steps until one changes no label, that one included, at
    most ``cap``: the steps K3 runs on ``parent`` (torch ops, not timed)."""
    n, p = parent.numel(), parent
    for k in range(1, cap + 1):
        q = p[p.clamp(0, n - 1)]
        if torch.equal(q, p):
            return k
        p = q
    return cap


def _jump_extras(torch, dev, row, path_args, ptxas: str) -> dict:
    """K3 beyond the common row: its registers, spills and stack, its
    grid, its time on the identity forest and on a deep chain beside the
    path's, each with the steps to the fixed point; three calls queued on
    one stream and one on a side stream, each equal to its plain result,
    the step flags back at 0 after them."""
    from repro_torch.kernels.spmv_minplus import spmv_minplus as sm
    instances = _resources(ptxas, "jump_kernel", [(0, "")])
    blocks, threads = sm.jump_grid(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = path_args[0].numel()
    _log(f"kernel pointer_jump: one cooperative launch of at most {blocks} "
         f"blocks ({blocks / sms:g} an SM) of {threads} threads")
    g = torch.Generator(device="cpu").manual_seed(SEED)
    inputs = {"round 1": path_args}
    for kind in ("identity", "deep chain", "cycle"):
        inputs[kind] = _jump_forest(torch, dev, kind, n, g)
    out = dict(instances=instances, grid_blocks=blocks, threads=threads)
    for label in ("round 1", "identity", "deep chain"):
        args = inputs[label]
        steps = _fixed_point_steps(torch, args[0], sm.jump_steps(n))
        ms = row["ms"] if label == "round 1" else _time_ms(
            torch, lambda: sm.pointer_jump(*args), 20)
        _log(f"kernel pointer_jump [{label}]: {ms:.4f} ms, {steps} doubling "
             f"steps to the fixed point (of {sm.jump_steps(n)})")
        key = label.replace(" ", "_")
        out[f"{key}_steps"] = steps
        if label != "round 1":
            out[f"{key}_ms"] = ms
    queue = [inputs[k] for k in ("cycle", "identity", "round 1")]
    torch.cuda.synchronize()
    got = [sm.pointer_jump(*args) for args in queue]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got.append(sm.pointer_jump(*path_args))
    torch.cuda.synchronize()
    for label, g_out, args in zip(("queued cycle", "queued identity",
                                   "queued round 1", "side stream"),
                                  got, queue + [path_args]):
        if not torch.equal(g_out, sm.pointer_jump_plain(*args)):
            raise AssertionError(f"pointer_jump disagrees with its plain "
                                 f"version on {label}")
    index = path_args[0].device.index
    for stream in (torch.cuda.current_stream(dev), side):
        if sm._jump_flags[(index, stream.cuda_stream)].any():
            raise AssertionError("pointer_jump left its step flags set")
    _log("kernel pointer_jump: three calls queued on one stream and one on "
         "a side stream bit_exact=True, step flags back at 0")
    return out


def phase_scan32(torch, dev, graph, record) -> dict:
    """Phase 2, the host loop's kernel: the 32-bit segmented scan on the
    lanes of round 1 of the rmat-20 host-loop solve (both endpoint
    orders), and on edge cases."""
    from repro_torch.core import keys
    from repro_torch.core.boruvka_dist import (
        _election_lanes, _host_lanes, _upload)
    from repro_torch.kernels.segment_min.segment_min import (
        segmented_min_scan, segmented_min_scan_plain)
    inf = keys.INF32
    n, m = graph.num_vertices, graph.num_edges
    # Round 1 of the host loop: its upload, and the lanes its election
    # sorts (``segment_min`` hands the kernel ``seg[order], val[order]``).
    src_d, dst_d, wb_d, _ = _upload(_host_lanes(graph), 8, dev)
    comp = torch.arange(n, dtype=torch.int32, device=dev)
    cs, cd, _, wb, order_s, order_d = _election_lanes(comp, src_d, dst_d,
                                                      wb_d, sort=True)
    seg_s, val_s = cs[order_s], wb[order_s]
    seg_d, val_d = cd[order_d], wb[order_d]
    M = seg_s.numel()
    seg64 = seg_s.to(torch.int64)
    lib_out = torch.full((n,), inf, dtype=torch.int32, device=dev)
    cases = [("dst order", (seg_d, val_d))] + [
        (c[0], (c[1], c[3]))
        for c in _scan_cases(torch, dev, inf, dtype=torch.int32)]
    row = _kernel_row(
        torch, "segmented_min_scan", segmented_min_scan,
        segmented_min_scan_plain, (seg_s, val_s),
        lambda: lib_out.scatter_reduce_(0, seg64, val_s, "amin"),
        (4 + 4 + 4) * M, 2 * M, cases)
    _log(f"kernel segmented_min_scan: {M} lanes (m={m}, padded)")
    record["scan32_phase"] = row
    return row


def _hash_inputs(graph):
    """The rmat-20 adjacency as one process's GHS shard lays it out (both
    directions, sorted by vertex then packed weight key; the position is
    the CSR slot), its table size, and the queries: every directed
    ``(receiver, sender)`` pair (hits), then the same with the receiver
    shifted by ``MISS_SHIFT`` (misses, unless that pair is an edge too)."""
    import numpy as np
    from repro_torch.core.params import GHSParams
    m = graph.num_edges
    ends = np.concatenate([graph.src, graph.dst])
    nbr = np.concatenate([graph.dst, graph.src])
    eid = np.concatenate([np.arange(m)] * 2)
    order = np.lexsort((graph.packed_keys[eid], ends))
    lv, u = ends[order].astype(np.int32), nbr[order].astype(np.int32)
    pos = np.arange(2 * m, dtype=np.int32)
    tsize = max(64, int(2 * m * GHSParams().hash_table_factor) | 1)
    q_lv = np.concatenate([lv, lv + MISS_SHIFT]).astype(np.int32)
    q_u = np.concatenate([u, u])
    return lv, u, pos, tsize, q_lv, q_u


def _hash_cases(torch, dev):
    """Edge cases for the lookup (``edge_hash/ref.edge_cases``), the table
    packed: (name, (records, q_lv, q_u))."""
    from repro_torch.kernels.edge_hash import ref as hash_ref
    from repro_torch.kernels.edge_hash.edge_hash import pack_records
    for name, arrays in hash_ref.edge_cases(SEED):
        h_lv, h_u, h_pos, q_lv, q_u = (torch.from_numpy(a).to(dev)
                                       for a in arrays)
        yield name, (pack_records(h_lv, h_u, h_pos), q_lv, q_u)


def _hash_plain(records, q_lv, q_u):
    """K5's plain version on a packed table: unpack, then probe."""
    from repro_torch.kernels.edge_hash import ref as hash_ref
    from repro_torch.kernels.edge_hash.edge_hash import hash_lookup_plain
    return hash_lookup_plain(*hash_ref.unpack(records), q_lv, q_u)


def _resources(ptxas: str, kernel: str, keys) -> dict:
    """A kernel's instances ``keys`` ((D, type) as ``build.ptxas_resources``
    gives them): registers, spilled bytes, stack frame and static shared
    memory a block from the compiler's ``-Xptxas -v`` report ``ptxas``,
    logged.  Raises if an instance is missing."""
    from repro_torch.kernels import build
    report = build.ptxas_resources(ptxas, kernel)
    out = {}
    for key in keys:
        r = report.get(key, {})
        label = f"{kernel} {key[1]} {key[0]}".strip() if key[0] else kernel
        if "registers" not in r:
            raise AssertionError(f"{label} missing from the ptxas report")
        _log(f"{label}: {r['registers']} registers, "
             f"{r.get('spill_bytes', 0)} bytes spilled, "
             f"{r.get('stack_bytes', 0)} bytes stack, "
             f"{r.get('smem_bytes', 0)} bytes shared memory a block")
        out[label] = r
    return out


def phase_hash(torch, dev, graph, record, ptxas: str):
    """Phase 2, the edge-hash lookup: the host build of the one-process
    table and its pack into 16-byte records on the card (set-up, both
    timed; the pack kernel held byte for byte to ``ref.pack``), then the
    kernel on the packed table against its plain version on every hit and
    miss query and on edge cases, and the three-array
    entry (which packs before each launch) against it; the kernel's
    registers, spills and shared memory from the compiler's report
    ``ptxas``.  Returns the row and the device inputs for the lookup
    path."""
    from repro_torch.kernels.edge_hash import ops as hash_ops
    from repro_torch.kernels.edge_hash import ref as hash_ref
    from repro_torch.kernels.edge_hash.edge_hash import (
        hash_lookup, hash_lookup_records, pack_records)
    instances = _resources(ptxas, "records_kernel", [(0, "")])
    t0 = time.perf_counter()
    lv, u, pos, tsize, q_lv, q_u = _hash_inputs(graph)
    t_layout = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = hash_ops.build_table(lv, u, pos, tsize)
    t_build = time.perf_counter() - t0
    arrays = tuple(torch.from_numpy(a).to(dev) for a in table)
    ql, qu = (torch.from_numpy(a).to(dev) for a in (q_lv, q_u))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = pack_records(*arrays)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    if not torch.equal(records, hash_ref.pack(*arrays)):
        raise AssertionError("pack_records disagrees with ref.pack")
    pack_ms = _time_ms(torch, lambda: pack_records(*arrays), 5, warmup=1)
    stack_ms = _time_ms(torch, lambda: hash_ref.pack(*arrays), 3, warmup=1)
    pack_bytes = 4 * tsize * (3 + hash_ref.RECORD_WORDS)
    _log(f"hash table: {lv.size} entries in {tsize} slots, layout "
         f"{t_layout:.2f} s, host build {t_build:.2f} s, pack into records "
         f"{t_pack:.4f} s wall, {pack_ms:.4f} ms on the card (set-up; "
         f"{pack_bytes} bytes, bound "
         f"{_bound_ms(pack_bytes, 0)[0]:.4f} ms; ref.pack's torch.stack "
         f"{stack_ms:.4f} ms)")
    probes = hash_ref.probe_counts(*arrays, ql, qu)
    traffic = hash_ref.probe_traffic(*arrays, ql, qu)
    Q = q_lv.size
    mean_probes = traffic["probes"] / Q
    _log(f"hash lookup: {Q} queries, mean probes {mean_probes:.4f}, max "
         f"{int(probes.max())}; table reads {traffic}")
    # The least bytes: each query word read and each answer written once,
    # and each 32-byte table sector the probes need read once, in the
    # layout that needs fewer: three arrays (h_pos and h_lv at every probed
    # slot, h_u only where h_lv matches) or records (every probed slot's
    # record).  Beside them, the bytes of a lookup that shares no sector
    # between queries, in each layout.
    sector = 32
    least = {"arrays": Q * 12 + sector * (2 * traffic["union_lv"]
                                          + traffic["union_u"]),
             "records": Q * 12 + sector * traffic["union_rec"]}
    chain = {"arrays": Q * 12 + sector * (2 * traffic["chain_lv"]
                                          + traffic["chain_u"]),
             "records": Q * 12 + sector * traffic["chain_rec"]}
    row = _kernel_row(
        torch, "hash_lookup", hash_lookup_records, _hash_plain,
        (records, ql, qu), None, min(least.values()), 6 * traffic["probes"],
        list(_hash_cases(torch, dev)))
    three = hash_lookup(*arrays, ql, qu)
    if not torch.equal(three, hash_lookup_records(records, ql, qu)):
        raise AssertionError("hash_lookup on the three arrays disagrees "
                             "with the kernel on the packed table")
    three_ms = _time_ms(torch, lambda: hash_lookup(*arrays, ql, qu), 20)
    bounds = {f"{kind}_{layout}_bound_ms": _bound_ms(b[layout], 0)[0]
              for kind, b in (("least", least), ("no_sharing", chain))
              for layout in b}
    _log(f"kernel hash_lookup: bytes each sector once {least} "
         f"(bounds {bounds['least_arrays_bound_ms']:.4f} / "
         f"{bounds['least_records_bound_ms']:.4f} ms), with no sector "
         f"shared between queries {chain} (bounds "
         f"{bounds['no_sharing_arrays_bound_ms']:.4f} / "
         f"{bounds['no_sharing_records_bound_ms']:.4f} ms); the three-array "
         f"entry, pack included: {three_ms:.4f} ms")
    row.update(mean_probes=mean_probes, table_slots=tsize,
               host_build_s=t_build, pack_s=t_pack, pack_ms=pack_ms,
               pack_stack_ms=stack_ms,
               three_array_ms=three_ms, table_reads=traffic,
               no_sharing_bound_ms=bounds["no_sharing_records_bound_ms"],
               instances=instances, **bounds)
    record["hash_phase"] = dict(row=row, layout_s=t_layout)
    del arrays, three
    return row, dict(records=records, q_lv=ql, q_u=qu,
                     lv=torch.from_numpy(lv).to(dev),
                     u=torch.from_numpy(u).to(dev), hits=lv.size)


def phase_solves(torch, graph, oracle, record) -> tuple[dict, dict]:
    """Phase 3: the main path under both kernel round bodies.  Returns the
    launch counts and each body's forest."""
    from repro_torch import kernels
    from repro_torch.core import mst_api
    from repro_torch.core.params import GHSParams
    launches, forests = {}, {}
    for rk, expect in (("pallas", ("masked_minplus_scan", "pointer_jump")),
                       ("xla", ("segmented_min2_scan",))):
        params = GHSParams(round_kernel=rk, use_pallas=True)
        walls, counts = [], None
        for i in range(SOLVE_RUNS):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, st = mst_api.minimum_spanning_forest(graph, params=params)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if counts is None:
                counts = dict(kernels.LAUNCHES)
            if not (res.edge_mask == oracle.edge_mask).all():
                raise AssertionError(f"round_kernel={rk}: forest != oracle")
            if res.num_components != oracle.num_components:
                raise AssertionError(f"round_kernel={rk}: components differ")
            _log(f"solve rmat-{SCALE} round_kernel={rk} run {i}: "
                 f"wall={walls[-1]:.4f} s rounds={st.rounds} "
                 f"intervals={st.intervals} host_syncs={st.host_syncs} "
                 f"compactions={st.compactions} "
                 f"active_history={list(st.active_history)} "
                 f"tree_edges={res.num_tree_edges}")
        for name in expect:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched on the path")
        launches.update({name: counts[name] for name in expect})
        forests[rk] = res
        med = statistics.median(walls)
        _log(f"solve rmat-{SCALE} round_kernel={rk}: median wall {med:.4f} s "
             f"over {SOLVE_RUNS} runs, {graph.num_edges / med:.4e} edges/s, "
             f"launches {counts}")
        record.setdefault("solves", {})[rk] = dict(
            walls_s=walls, median_s=med, launches=counts, rounds=st.rounds,
            intervals=st.intervals, host_syncs=st.host_syncs,
            compactions=st.compactions,
            active_history=list(st.active_history))
    return launches, forests


def phase_profile(torch, graph, record) -> None:
    """One profiler window over a fused-kernel solve, and the host
    staging step (layout + upload) timed on its own."""
    from repro_torch.core import runtime
    from repro_torch.core.params import GHSParams
    staging = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runtime.prepare_edges(graph, "block", chunk=8,
                              device=torch.device("cuda"))
        torch.cuda.synchronize()
        staging.append(time.perf_counter() - t0)
    record["staging_s"] = staging
    _log(f"host staging (prepare_edges): median "
         f"{statistics.median(staging):.4f} s over 3 runs")
    from repro_torch import kernels
    from repro_torch.core import mst_api
    params = GHSParams(round_kernel="pallas", use_pallas=True)
    kernels.reset_launches()
    record["profile"] = prof = _profile_window(
        torch, lambda: mst_api.minimum_spanning_forest(graph, params=params),
        "device loop", "chip_smoke_profile.txt",
        kernel_names=("jump_kernel",))
    # One K3 kernel a call of its wrapper: the window's device kernels.
    seen, calls = prof["counts"]["jump_kernel"], kernels.LAUNCHES["pointer_jump"]
    _log(f"profile (device loop): {seen} K3 kernels on the device for "
         f"{calls} pointer_jump calls")
    if prof["device_ops"] and seen != calls:
        raise AssertionError(f"{seen} K3 kernels ran for {calls} calls")


def _profile_window(torch, run, label, table_name, kernel_names=()) -> dict:
    """One profiler window over ``run()``: device busy time and idle
    share, the device ops that took longest, the host's time blocked
    in synchronizing CUDA calls, and how many device ops ran whose names
    hold each string of ``kernel_names``.  Writes the profiler's table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0))
    # Kernels (and copies) are the events that ran on the device; the CPU
    # operators that launched them are left out so nothing counts twice.
    on_device = [e for e in events
                 if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_device)
    n_ops = sum(e.count for e in on_device)
    top = sorted(on_device, key=dev_us, reverse=True)[:10]
    idle = 1.0 - busy_us / (window * 1e6) if busy_us else None
    waits = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
             if "Synchronize" in e.key]
    _log(f"profile ({label}): window {window:.4f} s, {n_ops} device ops, "
         f"device busy {busy_us / 1e3:.3f} ms, idle share "
         f"{'not measured' if idle is None else f'{idle:.4f}'}")
    for e in top:
        _log(f"  device op {e.key[:60]!r}: {dev_us(e) / 1e3:.3f} ms "
             f"x{e.count}")
    for key, ms, count in waits:
        _log(f"  host wait {key!r}: {ms:.3f} ms x{count}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / table_name).write_text(
        events.table(sort_by="self_cpu_time_total", row_limit=60))
    return dict(window_s=window, device_ops=n_ops,
                counts={c: sum(e.count for e in on_device if c in e.key)
                        for c in kernel_names},
                device_busy_ms=busy_us / 1e3,
                idle_share=idle, host_waits=waits,
                top=[(e.key, dev_us(e) / 1e3, e.count) for e in top])


def phase_host_solves(torch, graph, oracle, record) -> int:
    """Phase 4: the legacy host loop on the rmat-20 graph, with the 32-bit
    scan kernel and with the scatter-min, beside the device loop's medians
    from phase 3.  Returns the scan kernel's launches over one solve."""
    from repro_torch import kernels
    from repro_torch.core import mst_api
    from repro_torch.core.params import GHSParams
    launches = None
    for up in (True, False):
        params = GHSParams(round_loop="host", use_pallas=up)
        walls = []
        for i in range(HOST_SOLVE_RUNS):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, st = mst_api.minimum_spanning_forest(graph, params=params)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            count = kernels.LAUNCHES["segmented_min_scan"]
            if not (res.edge_mask == oracle.edge_mask).all():
                raise AssertionError(f"host loop use_pallas={up}: forest != "
                                     f"oracle")
            if res.num_components != oracle.num_components:
                raise AssertionError(f"host loop use_pallas={up}: "
                                     f"components differ")
            if up and count <= 0:
                raise AssertionError("segmented_min_scan was not launched "
                                     "on the host loop")
            if up and launches is None:
                launches = count
            _log(f"host loop rmat-{SCALE} use_pallas={up} run {i}: "
                 f"wall={walls[-1]:.4f} s rounds={st.rounds} "
                 f"intervals={st.intervals} host_syncs={st.host_syncs} "
                 f"compactions={st.compactions} segmented_min_scan "
                 f"launches={count} tree_edges={res.num_tree_edges}")
        med = statistics.median(walls)
        _log(f"host loop rmat-{SCALE} use_pallas={up}: median wall "
             f"{med:.4f} s over {HOST_SOLVE_RUNS} runs, "
             f"{graph.num_edges / med:.4e} edges/s")
        record.setdefault("host_solves", {})[str(up)] = dict(
            walls_s=walls, median_s=med, rounds=st.rounds,
            intervals=st.intervals, host_syncs=st.host_syncs,
            compactions=st.compactions, scan_launches=count,
            active_history=list(st.active_history))
    for rk, rec in record["solves"].items():
        _log(f"device loop rmat-{SCALE} round_kernel={rk} (phase 3, this "
             f"call): median wall {rec['median_s']:.4f} s")
    params = GHSParams(round_loop="host", use_pallas=True)
    record["host_profile"] = _profile_window(
        torch, lambda: mst_api.minimum_spanning_forest(graph, params=params),
        "host loop", "chip_smoke_profile_host.txt")
    return launches


def phase_lookup(torch, inputs, record) -> int:
    """Phase 4: the edge-hash lookup path, ``edge_hash.ops.lookup`` in the
    table packed once in phase 2, over every hit and miss query; each
    answer is checked against the adjacency.  Returns the kernel's
    launches."""
    from repro_torch import kernels
    from repro_torch.kernels.edge_hash import ops as hash_ops
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = hash_ops.lookup(inputs["records"], inputs["q_lv"], inputs["q_u"],
                          use_pallas=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["hash_lookup"]
    if launches <= 0:
        raise AssertionError("hash_lookup was not launched on the lookup path")
    hits = inputs["hits"]
    if got.shape != inputs["q_lv"].shape or got.dtype != torch.int32:
        raise AssertionError("lookup: wrong shape or type")
    pos = torch.arange(hits, dtype=torch.int32, device=got.device)
    unresolved = int((got[:hits] < 0).sum())
    if not torch.equal(got[:hits], pos):
        raise AssertionError(f"lookup: {unresolved} hit queries unresolved, "
                             f"or resolved to another position")
    miss = got[hits:]
    found = miss >= 0
    idx = miss[found].to(torch.int64)
    if not (torch.equal(inputs["lv"][idx], inputs["q_lv"][hits:][found])
            and torch.equal(inputs["u"][idx], inputs["q_u"][hits:][found])):
        raise AssertionError("lookup: a miss query resolved to another pair")
    _log(f"lookup path: {got.numel()} queries in {wall:.4f} s wall, hash_lookup "
         f"launches={launches}; all {hits} hits at their CSR slot, "
         f"{int(found.sum())} shifted queries are edges too and resolve "
         f"to them, {int((~found).sum())} miss")
    record["lookup"] = dict(wall_s=wall, launches=launches,
                            shifted_found=int(found.sum()))
    return launches


def phase_sweep(torch, record) -> None:
    """Phase 5: every knob on a small graph, on the card and on the CPU."""
    from repro_torch.core import generators, kruskal_ref, mst_api
    from repro_torch.core.params import GHSParams
    g = generators.rmat(10, seed=SEED)
    want = kruskal_ref.kruskal(g)
    fields = ("rounds", "intervals", "host_syncs", "extra_syncs",
              "compactions", "edges_scanned", "active_history")
    settings = [
        GHSParams(round_kernel=rk, use_pallas=up, interval_pipeline=ip,
                  partitioner=part)
        for rk, up, ip, part in itertools.product(
            ("xla", "pallas"), (False, True), (0, 1),
            ("block", "hashed", "balanced"))]
    settings += [
        GHSParams(round_loop="host", use_pallas=up, partitioner=part,
                  compaction=comp)
        for up, part, comp in itertools.product(
            (False, True), ("block", "hashed", "balanced"), ("none", "pow2"))]
    n_ok = 0
    for params in settings:
        res, st = mst_api.minimum_spanning_forest(g, params=params)
        cpu, cst = mst_api.minimum_spanning_forest(g, params=params,
                                                   device="cpu")
        if not ((res.edge_mask == want.edge_mask).all()
                and (cpu.edge_mask == want.edge_mask).all()):
            raise AssertionError(f"sweep {params}: forest != Kruskal")
        if any(getattr(st, f) != getattr(cst, f) for f in fields):
            raise AssertionError(f"sweep {params}: stats differ from CPU")
        n_ok += 1
    _log(f"sweep rmat-10: {n_ok}/{len(settings)} knob settings (both round "
         f"loops) equal Kruskal and the CPU solve")
    record["sweep_ok"] = n_ok


def _same_graph(a, b) -> bool:
    """Byte equality of two host graphs: vertices, endpoints, weight bits."""
    import numpy as np
    return (a.num_vertices == b.num_vertices
            and np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
            and np.array_equal(a.weight.view(np.uint32),
                               b.weight.view(np.uint32)))


def phase_pipeline_build(torch, record):
    """Phase 5b(a): the graph pipeline on the card.  rmat-PIPE_SCALE (the
    general preprocessing path) built PIPE_RUNS times, timed by CUDA events
    and the host clock (its one sync included), held byte for byte against
    ``build_host`` (built once, timed); every kind at PIPE_KIND_SCALES (the
    narrow path's last scale and the general path's first) likewise; and
    ``sample_device_edges`` against ``sample_mask`` over the host ids.
    Returns the spec and its host graph."""
    from repro_torch.core import keys, pipeline
    from repro_torch.core.graph import PAD_VERTEX
    spec = pipeline.GraphSpec("rmat", PIPE_SCALE, avg_degree=32, seed=SEED)
    walls, events = [], []
    for _ in range(PIPE_RUNS):
        dev = None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dev = pipeline.build(spec)
        stop.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        events.append(start.elapsed_time(stop))
    t0 = time.perf_counter()
    mirror = dev.to_graph()
    fetch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = pipeline.build_host(spec)
    host_s = time.perf_counter() - t0
    m = dev.num_edges
    if not _same_graph(mirror, host):
        raise AssertionError(f"rmat-{PIPE_SCALE}: device build != build_host")
    if not (bool((dev.src[m:] == int(PAD_VERTEX)).all())
            and bool((dev.key[m:] == keys.INF_KEY).all())):
        raise AssertionError(f"rmat-{PIPE_SCALE}: padding slots not inert")
    _log(f"pipeline rmat-{PIPE_SCALE}: n={spec.num_vertices} "
         f"samples={spec.num_samples} cap={dev.capacity} m={m}; device "
         f"build median {statistics.median(walls):.4f} s host clock "
         f"({[round(w, 4) for w in walls]}), "
         f"{statistics.median(events):.2f} ms CUDA events "
         f"({[round(e, 2) for e in events]}); host build {host_s:.2f} s; "
         f"mirror fetch (to_graph) {fetch_s:.4f} s; byte-identical")
    kinds = {}
    for scale in PIPE_KIND_SCALES:
        for kind in pipeline.KINDS:
            s = pipeline.GraphSpec(kind, scale, seed=SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = pipeline.build(s)
            torch.cuda.synchronize()
            t_dev = time.perf_counter() - t0
            t0 = time.perf_counter()
            h = pipeline.build_host(s)
            t_host = time.perf_counter() - t0
            if not _same_graph(d.to_graph(), h):
                raise AssertionError(f"{kind}-{scale}: device build != "
                                     f"build_host")
            kinds[f"{kind}-{scale}"] = dict(m=d.num_edges, device_s=t_dev,
                                            host_s=t_host)
            _log(f"pipeline {kind}-{scale}: m={d.num_edges} cap="
                 f"{d.capacity} device {t_dev:.4f} s, host {t_host:.3f} s, "
                 f"byte-identical")
            del d
    got = pipeline.sample_device_edges(dev, PIPE_SAMPLE_RATE, seed=SEED)
    want = pipeline.sample_mask(SEED, PIPE_SAMPLE_RATE, torch.arange(m))
    if not (torch.equal(got[:m].cpu(), want) and not bool(got[m:].any())):
        raise AssertionError("sample_device_edges != sample_mask")
    _log(f"sample_device_edges rate {PIPE_SAMPLE_RATE}: {int(want.sum())} of "
         f"{m} edges, equal to sample_mask over the host ids")
    record["pipeline_build"] = dict(
        m=m, cap=dev.capacity, walls_s=walls, events_ms=events,
        host_s=host_s, fetch_s=fetch_s, kinds=kinds,
        sampled=int(want.sum()))
    return spec, host


def phase_pipeline_solve(torch, spec, host, record) -> dict:
    """Phase 5b(b): ``minimum_spanning_forest`` of a freshly built
    rmat-PIPE_SCALE ``DeviceEdges`` with ``use_pallas=True`` under both
    round bodies, PIPE_RUNS times each: ``edge_staging == "device"``, the
    forest equal to the numpy Borůvka oracle on the host graph, the
    kernels' launches read; medians of the solve and of build plus solve,
    beside phase 3's host-Graph medians; one profiler window.  Returns the
    launch counts of each round body."""
    from repro_torch import kernels
    from repro_torch.core import kruskal_ref, mst_api, pipeline
    from repro_torch.core.params import GHSParams
    t0 = time.perf_counter()
    oracle = kruskal_ref.boruvka_numpy(host)
    _log(f"boruvka_numpy oracle of pipeline rmat-{PIPE_SCALE}: "
         f"{time.perf_counter() - t0:.1f} s, "
         f"tree_edges={oracle.num_tree_edges}")
    out = {}
    for rk, expect in (("pallas", ("masked_minplus_scan", "pointer_jump")),
                       ("xla", ("segmented_min2_scan",))):
        params = GHSParams(round_kernel=rk, use_pallas=True)
        builds, solves, counts = [], [], None
        for i in range(PIPE_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev = pipeline.build(spec)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kernels.reset_launches()
            res, st = mst_api.minimum_spanning_forest(dev, params=params)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if counts is None:
                counts = dict(kernels.LAUNCHES)
            del dev
            builds.append(t1 - t0)
            solves.append(t2 - t1)
            if st.edge_staging != "device":
                raise AssertionError(f"DeviceEdges solve round_kernel={rk}: "
                                     f"staging {st.edge_staging!r}")
            if not ((res.edge_mask == oracle.edge_mask).all()
                    and res.num_components == oracle.num_components):
                raise AssertionError(f"DeviceEdges solve round_kernel={rk}: "
                                     f"forest != oracle")
            _log(f"DeviceEdges solve rmat-{PIPE_SCALE} round_kernel={rk} "
                 f"run {i}: build {builds[-1]:.4f} s, solve "
                 f"{solves[-1]:.4f} s, rounds={st.rounds} "
                 f"intervals={st.intervals} host_syncs={st.host_syncs} "
                 f"compactions={st.compactions} "
                 f"active_history={list(st.active_history)}")
        for name in expect:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"DeviceEdges solve")
        totals = [b + s for b, s in zip(builds, solves)]
        med, med_total = statistics.median(solves), statistics.median(totals)
        phase3 = record["solves"][rk]["median_s"]
        _log(f"DeviceEdges solve rmat-{PIPE_SCALE} round_kernel={rk}: median "
             f"solve {med:.4f} s, build + solve {med_total:.4f} s over "
             f"{PIPE_RUNS} runs (phase 3, host Graph of the numpy rmat-"
             f"{SCALE}, this call: {phase3:.4f} s); launches {counts}")
        out[rk] = {name: counts[name] for name in expect}
        record.setdefault("pipeline_solves", {})[rk] = dict(
            solve_s=solves, build_s=builds, median_solve_s=med,
            median_total_s=med_total, phase3_median_s=phase3,
            launches=counts, rounds=st.rounds, intervals=st.intervals,
            host_syncs=st.host_syncs)
    params = GHSParams(round_kernel="pallas", use_pallas=True)
    dev = pipeline.build(spec)
    record["pipeline_profile"] = _profile_window(
        torch, lambda: mst_api.minimum_spanning_forest(dev, params=params),
        "DeviceEdges solve", "chip_smoke_profile_pipeline.txt",
        kernel_names=("jump_kernel", "tile_scan"))
    return out


def _sync_checked_intervals(torch):
    """Context: every batched interval dispatch runs under sync debug mode
    "error" (an operation that waits for the card raises)."""
    from repro_torch.core import boruvka_dist
    real = boruvka_dist._run_interval_batch

    def checked(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    @contextlib.contextmanager
    def patched():
        boruvka_dist._run_interval_batch = checked
        try:
            yield
        finally:
            boruvka_dist._run_interval_batch = real

    return patched()


def phase_batched(torch, record) -> tuple[dict, tuple]:
    """Phase 5b(c): a corpus of CORPUS_GRAPHS pipeline rmat graphs (degree
    32, seed i, scales CORPUS_SCALES in turn) solved in buckets with
    ``use_pallas=True`` under both round bodies, every interval dispatch
    under sync debug mode "error".  ``warm_bucket`` runs on each bucket
    shape first.  Each bucket alone (``solve_packed``): K1 launched once a
    dispatched round where the bucket fails the contraction gate, never
    where it passes; every lane equal to its single-graph solve on the card
    and to Kruskal, its rounds to the single solve's.  Then graphs a second
    of ``minimum_spanning_forests`` over the corpus (median of
    CORPUS_TIMED_RUNS) beside the single solves in a loop.  Returns the K1
    launches of one corpus solve, and the corpus (its host graphs and their
    Kruskal forests) for phase 5d."""
    from repro_torch import kernels
    from repro_torch.core import boruvka_dist, kruskal_ref, mst_api, pipeline
    from repro_torch.core.params import GHSParams
    specs = [pipeline.GraphSpec("rmat", CORPUS_SCALES[i % len(CORPUS_SCALES)],
                                avg_degree=32, seed=i)
             for i in range(CORPUS_GRAPHS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    devs = [pipeline.build(s) for s in specs]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mirrors = [d.to_graph() for d in devs]
    oracles = [kruskal_ref.kruskal(g) for g in mirrors]
    batches = pipeline.pack_batch(mirrors)
    gates = [boruvka_dist._contract_gate(b) for b in batches]
    _log(f"corpus: {len(devs)} pipeline rmat graphs built on the card in "
         f"{build_s:.3f} s; buckets (n_pad, cap, B, contraction bits): "
         f"{[(b.n_pad, b.cap, b.batch_size, g) for b, g in zip(batches, gates)]}")
    if not any(g is None for g in gates) or all(g is None for g in gates):
        raise AssertionError("the corpus must hold packed and fallback "
                             "buckets")
    out, rec = {}, {}
    with _sync_checked_intervals(torch):
        for rk in ("xla", "pallas"):
            params = GHSParams(round_kernel=rk, use_pallas=True)
            t0 = time.perf_counter()
            warmed = sum(mst_api.warm_bucket(b.batch_size, b.n_pad, b.cap,
                                             params=params) for b in batches)
            warm_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            singles = [mst_api.minimum_spanning_forest(d, params=params)
                       for d in devs]
            torch.cuda.synchronize()
            single_s = time.perf_counter() - t0
            for i, (res, _) in enumerate(singles):
                if not (res.edge_mask == oracles[i].edge_mask).all():
                    raise AssertionError(f"corpus graph {i}: single solve "
                                         f"!= Kruskal")
            fallback_rounds = 0
            for b, gate in zip(batches, gates):
                kernels.reset_launches()
                res, st = mst_api.solve_packed(b, params=params)
                torch.cuda.synchronize()
                counts = dict(kernels.LAUNCHES)
                dispatched = st.intervals + st.speculative_intervals
                want_k1 = dispatched if gate is None else 0
                fallback_rounds += want_k1
                if counts["segmented_min2_scan"] != want_k1 or any(
                        v for k, v in counts.items()
                        if k != "segmented_min2_scan"):
                    raise AssertionError(
                        f"bucket ({b.n_pad}, {b.cap}) x{b.batch_size} "
                        f"round_kernel={rk}: launches {counts}, expected "
                        f"{want_k1} K1 ({dispatched} dispatched rounds)")
                if st.host_syncs != st.intervals + 1:
                    raise AssertionError("a bucket synced inside an interval")
                for lane, idx in enumerate(b.indices):
                    one, one_st = singles[idx]
                    if not ((res[lane].edge_mask == one.edge_mask).all()
                            and st.rounds_per_graph[lane] == one_st.rounds):
                        raise AssertionError(
                            f"corpus graph {idx} round_kernel={rk}: lane != "
                            f"its single solve")
                _log(f"bucket ({b.n_pad}, {b.cap}) x{b.batch_size} "
                     f"round_kernel={rk} "
                     f"{'fallback' if gate is None else 'packed'}: "
                     f"intervals={st.intervals} rounds={st.rounds} "
                     f"compactions={st.compactions} K1 launches "
                     f"{counts['segmented_min2_scan']} for {dispatched} "
                     f"dispatched rounds; every lane = its single solve")
            walls = []
            for _ in range(CORPUS_TIMED_RUNS):
                kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res, st = mst_api.minimum_spanning_forests(devs, params=params)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                k1 = kernels.LAUNCHES["segmented_min2_scan"]
                if k1 != fallback_rounds:
                    raise AssertionError(f"corpus round_kernel={rk}: {k1} K1 "
                                         f"launches, {fallback_rounds} "
                                         f"fallback rounds")
                if st.host_syncs != st.intervals + st.buckets:
                    raise AssertionError("corpus: sync ledger broken")
                for i, (one, one_st) in enumerate(singles):
                    if not ((res[i].edge_mask == one.edge_mask).all()
                            and st.rounds_per_graph[i] == one_st.rounds):
                        raise AssertionError(f"corpus graph {i}: batched != "
                                             f"single")
            med = statistics.median(walls)
            _log(f"corpus round_kernel={rk}: warm_bucket {warmed} steps in "
                 f"{warm_s:.3f} s; batched median {med:.4f} s "
                 f"({[round(w, 4) for w in walls]}) = "
                 f"{len(devs) / med:.1f} graphs/s, {st.buckets} buckets, "
                 f"{st.intervals} intervals, host_syncs {st.host_syncs}; "
                 f"{len(devs)} single solves in a loop {single_s:.3f} s = "
                 f"{len(devs) / single_s:.1f} graphs/s; K1 launches "
                 f"{fallback_rounds} a corpus solve")
            out[rk] = fallback_rounds
            rec[rk] = dict(walls_s=walls, median_s=med,
                           graphs_per_s=len(devs) / med, single_s=single_s,
                           single_graphs_per_s=len(devs) / single_s,
                           warm_s=warm_s, warmed=warmed, buckets=st.buckets,
                           intervals=st.intervals, host_syncs=st.host_syncs,
                           k1_launches=fallback_rounds)
    record["batched"] = dict(build_s=build_s, runs=rec, shapes=[
        (b.n_pad, b.cap, b.batch_size, g is None)
        for b, g in zip(batches, gates)])
    return out, (mirrors, oracles)


def _same_forest(a, b) -> bool:
    """Bit equality of two forests: the edge mask and the three scalars."""
    return (bool((a.edge_mask == b.edge_mask).all())
            and (a.total_weight, a.num_components, a.num_tree_edges)
            == (b.total_weight, b.num_components, b.num_tree_edges))


@contextlib.contextmanager
def _label_loop_spy(spy: dict):
    """Inside the block, count the K3 launches of the label loop
    (``spmv_minplus.ops.connected_labels``, which ``component_maxkey``
    runs too) in ``spy["k3"]`` and its calls in ``spy["calls"]``; keep the
    first K3 input of the loop in ``spy["k3_input"]`` and the first
    arguments of the filter's level chain in ``spy["chain"]``."""
    from repro_torch import kernels
    from repro_torch.core import filter_boruvka
    from repro_torch.kernels.spmv_minplus import ops
    labels, jump, chain = (ops.connected_labels, ops.pointer_jump,
                           filter_boruvka._level_labels)
    inside = []

    def counted(*args, **kw):
        before = kernels.LAUNCHES["pointer_jump"]
        inside.append(True)
        try:
            return labels(*args, **kw)
        finally:
            inside.pop()
            spy["k3"] += kernels.LAUNCHES["pointer_jump"] - before
            spy["calls"] += 1

    def first_input(parent, comp):
        if inside and "k3_input" not in spy:
            spy["k3_input"] = (parent.clone(), comp.clone())
        return jump(parent, comp)

    def first_chain(*args):
        spy.setdefault("chain", args)
        return chain(*args)

    ops.connected_labels, ops.pointer_jump = counted, first_input
    filter_boruvka._level_labels = first_chain
    try:
        yield spy
    finally:
        ops.connected_labels, ops.pointer_jump = labels, jump
        filter_boruvka._level_labels = chain


def phase_filter(torch, graph, oracle, forests, record) -> dict:
    """Phase 5c(a): ``method="filter_boruvka"`` on phase 3's rmat-SCALE
    graph with ``use_pallas=True`` under both round bodies, FILTER_RUNS
    times each: every forest equal to the numpy oracle and to phase 3's
    Borůvka forest bit for bit; the survivors, the passes, K3's launches
    (all of them, and the label loop's) and the label loop's host reads;
    the median wall time beside phase 3's.  Then K3 against its plain
    version on the first input the label loop gave it, timed beside its
    bound, and the level chain alone at each of LABEL_CHECK_SWEEP
    iterations between two flag reads.  Returns the K3 launches."""
    from repro_torch import kernels
    from repro_torch.core import filter_boruvka, mst_api, runtime
    from repro_torch.core.params import GHSParams
    from repro_torch.kernels.spmv_minplus import ops
    from repro_torch.kernels.spmv_minplus.spmv_minplus import (
        jump_steps, pointer_jump, pointer_jump_plain)
    out, rec = {}, {}
    spy = None
    for rk in ("pallas", "xla"):
        params = GHSParams(round_kernel=rk, use_pallas=True)
        walls = []
        for i in range(FILTER_RUNS):
            kernels.reset_launches()
            with _label_loop_spy(dict(k3=0, calls=0)) as run_spy:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res, st = mst_api.minimum_spanning_forest(
                    graph, method="filter_boruvka", params=params)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            if i == 0:
                counts, loop = dict(kernels.LAUNCHES), run_spy
            if not (_same_forest(res, oracle) and _same_forest(res,
                                                              forests[rk])):
                raise AssertionError(f"filter round_kernel={rk}: forest != "
                                     f"oracle / phase 3's Borůvka forest")
            _log(f"filter rmat-{SCALE} round_kernel={rk} run {i}: wall "
                 f"{walls[-1]:.4f} s, survivors {list(st.survivor_history)}, "
                 f"edges_filtered={st.edges_filtered} "
                 f"filter_passes={st.filter_passes} rounds={st.rounds} "
                 f"host_syncs={st.host_syncs} label_syncs={st.label_syncs}")
        if loop["k3"] <= 0:
            raise AssertionError(f"filter round_kernel={rk}: the label loop "
                                 f"launched no K3")
        if rk == "xla":
            spy = loop
        med = statistics.median(walls)
        phase3 = record["solves"][rk]["median_s"]
        _log(f"filter rmat-{SCALE} round_kernel={rk}: median wall {med:.4f} "
             f"s over {FILTER_RUNS} runs (phase 3 Borůvka, this call: "
             f"{phase3:.4f} s); K3 launches {counts['pointer_jump']}, of "
             f"them {loop['k3']} in {loop['calls']} label-loop calls; "
             f"launches {counts}")
        out[rk] = counts["pointer_jump"]
        rec[rk] = dict(walls_s=walls, median_s=med, phase3_median_s=phase3,
                       launches=counts, label_k3=loop["k3"],
                       label_calls=loop["calls"],
                       survivor_history=list(st.survivor_history),
                       edges_filtered=st.edges_filtered,
                       filter_passes=st.filter_passes, rounds=st.rounds,
                       host_syncs=st.host_syncs, extra_syncs=st.extra_syncs,
                       label_syncs=st.label_syncs)

    # One profiler window over a fused-body filter run: K3 kernels on the
    # device, one a wrapper call.
    params = GHSParams(round_kernel="pallas", use_pallas=True)
    kernels.reset_launches()
    rec["profile"] = prof = _profile_window(
        torch, lambda: mst_api.minimum_spanning_forest(
            graph, method="filter_boruvka", params=params),
        "filter", "chip_smoke_profile_filter.txt",
        kernel_names=("jump_kernel",))
    seen, calls = prof["counts"]["jump_kernel"], kernels.LAUNCHES["pointer_jump"]
    _log(f"profile (filter): {seen} K3 kernels on the device for {calls} "
         f"pointer_jump calls")
    if prof["device_ops"] and seen != calls:
        raise AssertionError(f"{seen} K3 kernels ran for {calls} calls")

    # K3 on the label loop's own input: the first hook forest of the
    # first level that iterates (round_kernel="xla": the loop's only K3).
    parent, comp = spy["k3_input"]
    n = parent.numel()
    got, want = pointer_jump(parent, comp), pointer_jump_plain(parent, comp)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, got, want)
    if err:
        raise AssertionError(f"pointer_jump disagrees with its plain version "
                             f"on the label chain's input (max abs err {err})")
    steps = _fixed_point_steps(torch, parent, jump_steps(n))
    ms = _time_ms(torch, lambda: pointer_jump(parent, comp), 20)
    plain_ms = _time_ms(torch, lambda: pointer_jump_plain(parent, comp), 3,
                        warmup=1)
    bound_ms, bound_by = _bound_ms(12 * n, 2 * n * steps)
    _log(f"kernel pointer_jump [label chain, {n} lanes] bit_exact=True: "
         f"{ms:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}, plain "
         f"{plain_ms:.4f} ms), {steps} doubling steps to the fixed point")
    rec["k3_label_chain"] = dict(lanes=n, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 steps=steps, max_abs_err=err)

    # The level chain alone at several iterations between two flag reads.
    chain_args = spy["chain"]
    sweep, base = {}, None
    default = ops.LABEL_CHECK_EVERY
    try:
        for every in LABEL_CHECK_SWEEP:
            ops.LABEL_CHECK_EVERY = every
            walls = []
            for _ in range(3):
                stats = runtime.EngineStats()
                kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                labels = filter_boruvka._level_labels(*chain_args[:6], stats)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            if base is None:
                base = labels
            elif not torch.equal(labels, base):
                raise AssertionError(f"level labels differ at LABEL_CHECK_EVERY="
                                     f"{every}")
            sweep[every] = dict(median_s=statistics.median(walls),
                                reads=stats.host_syncs,
                                k3=kernels.LAUNCHES["pointer_jump"])
            _log(f"level chain ({tuple(base.shape)} labels) LABEL_CHECK_EVERY="
                 f"{every}: median {sweep[every]['median_s'] * 1e3:.3f} ms, "
                 f"{stats.host_syncs} reads, {sweep[every]['k3']} K3 launches")
    finally:
        ops.LABEL_CHECK_EVERY = default
    rec["check_every_sweep"] = sweep
    record["filter"] = rec
    return out


def _update_batch(np, rng, state, size=UPDATE_SIZE):
    """``size`` inserts and ``size`` deletes: random pairs with float32
    weights in (0, 1); half the deletes tree edges of the current forest,
    half non-tree edges; one deleted tree edge re-inserted at half its
    weight (so lighter)."""
    from repro_torch.core.incremental import EdgeBatch
    g, half = state.graph, size // 2
    tree = rng.choice(np.flatnonzero(state.forest.edge_mask), half,
                      replace=False)
    other = rng.choice(np.flatnonzero(~state.forest.edge_mask), half,
                       replace=False)
    dels = np.concatenate([tree, other])
    n, k = g.num_vertices, size - 1
    again = tree[0]
    return EdgeBatch(
        insert_src=np.append(rng.integers(0, n, k), g.src[again]).astype(
            np.int32),
        insert_dst=np.append(rng.integers(0, n, k), g.dst[again]).astype(
            np.int32),
        insert_weight=np.append(
            rng.integers(1, 1 << 24, k) / float(1 << 24),
            g.weight[again] / 2).astype(np.float32),
        delete_src=g.src[dels], delete_dst=g.dst[dels])


def phase_updates(torch, graph, record) -> dict:
    """Phase 5c(b): ``incremental_forest`` of phase 3's graph, then
    UPDATE_BATCHES chained ``apply_updates`` batches (``_update_batch``)
    with ``use_pallas=True``, ``round_kernel="pallas"``.  After each, the
    updated graph equals ``apply_edge_batch`` of the previous one and the
    forest a fresh Borůvka solve of it on the card, bit for bit; logged:
    the ledger, the candidates as a share of m, K3's launches (and the
    label loop's), the label loop's reads, and the wall times of the
    update, of the merge alone and of the fresh solve.  Returns the label
    loop's K3 launches of each batch."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import incremental, mst_api
    from repro_torch.core.params import GHSParams
    params = GHSParams(round_kernel="pallas", use_pallas=True)
    t0 = time.perf_counter()
    state, _ = mst_api.incremental_forest(graph, params=params)
    _log(f"incremental_forest rmat-{SCALE}: {time.perf_counter() - t0:.4f} s")
    rng = np.random.default_rng(SEED)
    rows, out = [], []
    for b in range(UPDATE_BATCHES):
        batch = _update_batch(np, rng, state)
        m_before = state.graph.num_edges
        kernels.reset_launches()
        with _label_loop_spy(dict(k3=0, calls=0)) as spy:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, st = mst_api.apply_updates(state, batch, params=params)
            torch.cuda.synchronize()
            upd_s = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        g2 = incremental.apply_edge_batch(state.graph, batch)
        merge_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh, _ = mst_api.minimum_spanning_forest(g2, params=params)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        if not _same_graph(new.graph, g2):
            raise AssertionError(f"update batch {b}: graph != apply_edge_batch")
        if not _same_forest(new.forest, fresh):
            raise AssertionError(f"update batch {b}: forest != fresh solve")
        if spy["k3"] <= 0:
            raise AssertionError(f"update batch {b}: the label loop launched "
                                 f"no K3")
        row = dict(m_before=m_before, m_after=g2.num_edges,
                   updates_applied=st.updates_applied,
                   replacement_probes=st.replacement_probes,
                   candidate_count=st.candidate_count,
                   candidate_share=st.candidate_count / g2.num_edges,
                   edges_filtered=st.edges_filtered, rounds=st.rounds,
                   host_syncs=st.host_syncs, label_syncs=st.label_syncs,
                   k3=counts["pointer_jump"], label_k3=spy["k3"],
                   launches=counts, update_s=upd_s, merge_s=merge_s,
                   fresh_s=fresh_s,
                   components=new.forest.num_components)
        _log(f"update batch {b} (rmat-{SCALE}, {batch.num_inserts} inserts, "
             f"{batch.num_deletes} deletes): apply_updates {upd_s:.4f} s "
             f"(apply_edge_batch alone {merge_s:.4f} s), fresh solve "
             f"{fresh_s:.4f} s; updates_applied={st.updates_applied} "
             f"replacement_probes={st.replacement_probes} "
             f"candidates={st.candidate_count} "
             f"({row['candidate_share']:.4%} of m={g2.num_edges}) "
             f"host_syncs={st.host_syncs} label_syncs={st.label_syncs} K3 "
             f"launches {counts['pointer_jump']} ({spy['k3']} in the label "
             f"loop); forest = fresh solve")
        rows.append(row)
        out.append(spy["k3"])
        prev, state = state, new
    # One profiler window over the last batch again, from the same state.
    kernels.reset_launches()
    again = []
    prof = _profile_window(
        torch, lambda: again.append(mst_api.apply_updates(
            prev, batch, params=params)[0]),
        "update batch", "chip_smoke_profile_update.txt",
        kernel_names=("jump_kernel",))
    if not _same_forest(again[0].forest, state.forest):
        raise AssertionError("update batch again: forest differs")
    seen, calls = prof["counts"]["jump_kernel"], kernels.LAUNCHES["pointer_jump"]
    _log(f"profile (update batch): {seen} K3 kernels on the device for "
         f"{calls} pointer_jump calls")
    if prof["device_ops"] and seen != calls:
        raise AssertionError(f"{seen} K3 kernels ran for {calls} calls")
    record["updates"] = dict(batches=rows, profile=prof)
    return out


@contextlib.contextmanager
def _calls(module, name, store: list):
    """Record the positional and keyword arguments of every call of
    ``module.name`` made inside the block in ``store``; restore it after."""
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        store.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _attn_tol(torch, want):
    if want.dtype == torch.bfloat16:
        return ATTN_BF16_REL * want.float().abs() + 1e-5
    return ATTN_F32_TOL * max(1.0, float(want.float().abs().max()))


def _attn_check(torch, name, kernel, plain, cname, args, kwargs) -> float:
    """One case of an attention kernel against its plain version; raises
    past the tolerance.  Returns the max abs error."""
    got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name} [{cname}]: {got.dtype} {tuple(got.shape)}"
                             f" != {want.dtype} {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= _attn_tol(torch, want)).all())
    _log(f"kernel {name} [{cname}, {args[0].dtype}, q {tuple(args[0].shape)}, "
         f"k {tuple(args[1].shape)}] max_abs_err={err:.3e} within_tol={ok}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"{cname} (max abs err {err})")
    return err


def _randn(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _flash_cost(q, k, v):
    """(bytes, operations) of causal attention: q, k, v and o each once;
    2·B·Hq·S²·D operations (the causal half of the two products)."""
    b, hq, s, d = q.shape
    es = q.element_size()
    return es * (2 * q.numel() + 2 * k.numel()), 2 * b * hq * s * s * d


def _decode_cost(q, k, v, length):
    """(bytes, operations) of decode attention: q, o and the lengths once,
    and the K and V rows up to each length (all S for a length <= 0)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rows = sum(s if n <= 0 else min(n, s) for n in length.tolist())
    es = q.element_size()
    return (es * (2 * q.numel() + 2 * hkv * rows * d) + 4 * b,
            4 * hq * rows * d)


def _sdpa(q, k, v):
    """The library call beside K6: causal GQA attention."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)


def _sdpa_decode(q, k, v, length):
    """The library call beside K7, at the first decode step's length."""
    import torch.nn.functional as F
    n = LM_PROMPT + 1
    return F.scaled_dot_product_attention(
        q[:, :, None], k[:, :, :n], v[:, :, :n], enable_gqa=True)


def _attn_timing(torch, kernel, plain, library, calls, cost) -> dict:
    """Kernel, plain and library times over ``calls`` (argument tuples,
    taken in turn, as the path's layers take them), and the bound."""
    def cycled(fn):
        it = itertools.cycle(calls)
        return lambda: fn(*next(it))
    ms = _time_ms(torch, cycled(kernel), 2 * len(calls))
    plain_ms = _time_ms(torch, cycled(plain), 3, warmup=1)
    library_ms = _time_ms(torch, cycled(library), 2 * len(calls))
    nbytes, nops = cost(*calls[0])
    rate = BF16_OPS_PER_S if calls[0][0].dtype == torch.bfloat16 \
        else INT_OPS_PER_S
    bound_ms, bound_by = _bound_ms(nbytes, nops, rate)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_ratio=ms / library_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, ops=nops)


def _served_attention(torch, dev, cfg, max_len):
    """The served run's weights and prompts (``serve_lm.serve`` draws them
    so), one prefill and one decode step of them, and the arguments of
    every attention call the two made: (params, tokens, cache, first
    tokens, flash attention calls, decode attention calls)."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.models import api, transformer
    from repro_torch.train.serve_step import pick
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = api.get_model(cfg).init(gen, cfg)
    tokens = api.synth_batch(LM_SEED, cfg, LM_BATCH, LM_PROMPT,
                             device=dev)["tokens"]
    flash_calls, decode_calls = [], []
    with _calls(attn_ops, "attention", flash_calls), \
            _calls(dec_ops, "decode_attention", decode_calls):
        logits, cache = transformer.prefill(params, tokens, cfg,
                                            max_len=max_len)
        first = pick(logits)[:, None]
        transformer.decode_step(params, cache, first, cfg)
    torch.cuda.synchronize()
    if len(flash_calls) != cfg.n_layers or len(decode_calls) != cfg.n_layers:
        raise AssertionError(f"{cfg.name} did not call attention once per "
                             f"layer")
    return (params, tokens, cache, first, [a for a, _ in flash_calls],
            [a for a, _ in decode_calls])


def _flash_tensor_cores(ptxas: str) -> dict:
    """Flash attention's bf16 instance (``flash_kernel_tc<D>``) at every
    head dim D: registers and spilled bytes from the compiler's ``-Xptxas
    -v`` report ``ptxas``, the dynamic shared memory a block takes (from the
    library), and its count of tensor-core instructions (HMMA or HGMMA) in
    the library's SASS.  Raises if an instance is missing from either or has
    no tensor-core instruction."""
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    def head_dim(symbol):
        """D of a ``flash_kernel_tc<D>`` symbol; None for any other."""
        if "flash_kernel_tc" not in symbol:
            return None
        return int(re.search(r"ILi(\d+)E", symbol).group(1))

    report = {d: r for (d, _), r in
              build.ptxas_resources(ptxas, "flash_kernel_tc").items()}
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    mma, d = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            d = head_dim(m.group(1))
            if d is not None:
                mma[d] = 0
        elif d is not None and re.search(r"\bH(G)?MMA\b", line):
            mma[d] += 1
    out = {}
    for d in range(8, 129, 8):
        r = report.get(d, {})
        if "registers" not in r or d not in mma:
            raise AssertionError(f"flash attention bf16 instance for hd {d} "
                                 f"missing from the ptxas report or the SASS")
        r.update(smem_bytes=lib.flash_attention_smem_bytes(d, 1),
                 tensor_core_instructions=mma[d])
        _log(f"flash_attention bf16 instance hd {d}: {r['registers']} "
             f"registers, {r.get('spill_bytes', 0)} bytes spilled, "
             f"{r['smem_bytes']} bytes shared memory a block, "
             f"{r['tensor_core_instructions']} HMMA/HGMMA in its SASS")
        if mma[d] == 0:
            raise AssertionError(f"flash attention's bf16 instance for hd {d} "
                                 f"has no tensor-core instruction")
        out[d] = r
    return out


def _decode_instances(ptxas: str) -> dict:
    """Decode attention's instances at head dims 64, 96 and 128 (Qwen1.5,
    Phi-3, Qwen2.5-14B, Jamba and Qwen2-MoE) in both types: registers,
    spilled bytes and stack from the compiler's ``-Xptxas -v`` report
    ``ptxas``, and the dynamic shared memory of a block of 1 and of 8 query
    heads (from the library).  Raises if an instance is missing."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.decode_attention import _load
    lib = _load()
    report = build.ptxas_resources(ptxas, "decode_kernel")
    out = {}
    for d in (64, 96, 128):
        for ty, bf16 in (("bf16", 1), ("f32", 0)):
            r = report.get((d, ty), {})
            if "registers" not in r:
                raise AssertionError(f"decode attention {ty} instance for hd "
                                     f"{d} missing from the ptxas report")
            r.update(smem_1_head=lib.decode_attention_smem_bytes(d, bf16, 1),
                     smem_8_heads=lib.decode_attention_smem_bytes(d, bf16, 8))
            _log(f"decode_attention {ty} instance hd {d}: {r['registers']} "
                 f"registers, {r.get('spill_bytes', 0)} bytes spilled, "
                 f"{r.get('stack_bytes', 0)} bytes stack, "
                 f"{r['smem_1_head']} / {r['smem_8_heads']} bytes shared "
                 f"memory a block of 1 / 8 query heads")
            out[f"{ty} hd {d}"] = r
    return out


def _decode_split(torch, label, calls, r) -> dict:
    """K7's split plan at one of its shapes (the first of ``calls``) and
    the rate it reached there, the bytes of its bound over its time ``r``
    (from ``_attn_timing``), logged beside the bound and SDPA's time."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        sm_count, split_plan)
    q, k = calls[0][0], calls[0][1]
    b, hq, d = q.shape
    chunk, chunks, grid = split_plan(b, hq, k.shape[1], k.shape[2], d,
                                     sm_count(q.device))
    gbps = r["bytes"] / r["ms"] / 1e6
    _log(f"decode_attention split ({label}): chunk {chunk} rows, {chunks} "
         f"chunks, grid {grid} ({math.prod(grid)} blocks); {gbps:.1f} GB/s "
         f"({100 * gbps * 1e9 / HBM_BYTES_PER_S:.1f} % of the memory rate); "
         f"{r['ms']:.4f} ms against its bound {r['bound_ms']:.4f} ms and "
         f"scaled_dot_product_attention's {r['library_ms']:.4f} ms")
    return dict(chunk=chunk, chunks=chunks, grid=list(grid),
                gb_per_s=gbps)


def phase_attention(torch, dev, record, ptxas: str,
                    decode_ptxas: str) -> list:
    """Phase 6a: the attention kernels against their plain versions, with
    inputs captured from the served model (its prefill and its first
    decode step, every layer), on the GQA shapes of Qwen2.5-14B and on
    ragged lengths; timed beside their bounds, plain versions and
    ``scaled_dot_product_attention``; one profiler window each over a
    prefill and over decode steps of the served model; flash attention's
    bf16 instances checked for tensor-core instructions (``ptxas`` is the
    compiler's report of its build); decode attention's instances at head
    dims 64, 96 and 128 reported (``decode_ptxas``), its split plan and
    rate at its shapes, and its wrapper's host time a call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.models import transformer
    from repro_torch.train.serve_step import pick
    tc = _flash_tensor_cores(ptxas)
    k7 = _decode_instances(decode_ptxas)
    cfg = get_config(LM_ARCH)
    max_len = LM_PROMPT + LM_GEN
    params, tokens, cache, first, f_calls, d_calls = _served_attention(
        torch, dev, cfg, max_len)

    record["lm_profile_prefill"] = _profile_window(
        torch, lambda: transformer.prefill(params, tokens, cfg,
                                           max_len=max_len),
        f"prefill {LM_ARCH} {LM_BATCH}x{LM_PROMPT}",
        "chip_smoke_profile_prefill.txt")

    def decode_steps():
        state, nxt = cache, first
        for _ in range(PROFILE_DECODE_STEPS):
            out, state = transformer.decode_step(params, state, nxt, cfg)
            nxt = pick(out)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_steps()
    torch.cuda.synchronize()
    record["lm_decode_step_ms"] = (time.perf_counter() - t0) * 1e3 / \
        PROFILE_DECODE_STEPS
    _log(f"decode step, {LM_ARCH} batch {LM_BATCH}, no profiler: "
         f"{record['lm_decode_step_ms']:.3f} ms (host clock, mean of "
         f"{PROFILE_DECODE_STEPS})")
    record["lm_profile_decode"] = _profile_window(
        torch, decode_steps, f"{PROFILE_DECODE_STEPS} decode steps {LM_ARCH} "
        f"batch {LM_BATCH}", "chip_smoke_profile_decode.txt")

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    q0, k0, v0 = f_calls[0]
    flash_cases = [("served layer 0", (q0, k0, v0), {}),
                   ("served layer 0", (q0.float(), k0.float(), v0.float()),
                    {}),
                   ("served layer 0, non-causal", (q0, k0, v0),
                    dict(causal=False))]
    for dt in (bf16, f32):
        for b, hq, hkv, s, d in ((2, 16, 16, 77, 64), (2, 40, 8, 1000, 128),
                                 (GQA_BATCH, 40, 8, LM_PROMPT, 128)):
            qkv = (_randn(torch, g, (b, hq, s, d), dt),
                   _randn(torch, g, (b, hkv, s, d), dt),
                   _randn(torch, g, (b, hkv, s, d), dt))
            for causal in (True, False):
                flash_cases.append((f"S={s} group {hq // hkv} hd {d} "
                                    f"causal={causal}", qkv,
                                    dict(causal=causal)))
    dq, dk, dv, dlen = d_calls[0]
    decode_cases = [("served layer 0, first step", (dq, dk, dv, dlen), {}),
                    ("served layer 0, first step",
                     (dq.float(), dk.float(), dv.float(), dlen), {})]
    for dt in (bf16, f32):
        for b, hq, hkv, s, d in ((3, 16, 16, 77, 64), (3, 40, 8, 1000, 128),
                                 (GQA_BATCH, 40, 8, LM_PROMPT + GQA_GEN,
                                  128)):
            lengths = [0, 1, s, 1 + s // 2][:b]
            args = (_randn(torch, g, (b, hq, d), dt),
                    _randn(torch, g, (b, hkv, s, d), dt),
                    _randn(torch, g, (b, hkv, s, d), dt),
                    torch.tensor(lengths, dtype=torch.int32, device=dev))
            decode_cases.append((f"S={s} group {hq // hkv} hd {d} lengths "
                                 f"{lengths}", args, {}))
    # A mostly empty cache at the served shapes: length 33 of S, so every
    # chunk of K7's split but the first is empty.
    g33 = torch.Generator(device=dev).manual_seed(SEED + 33)
    for dt in (bf16, f32):
        b, hq, d = dq.shape
        args = (_randn(torch, g33, (b, hq, d), dt),
                _randn(torch, g33, dk.shape, dt),
                _randn(torch, g33, dk.shape, dt),
                torch.full((b,), 33, dtype=torch.int32, device=dev))
        decode_cases.append((f"S={dk.shape[2]} length 33 (mostly empty "
                             f"cache) hd {d}", args, {}))
    errs = {}
    for name, kernel, plain, cases in (
            ("flash_attention", flash_attention, flash_attention_plain,
             flash_cases),
            ("decode_attention", decode_attention, decode_attention_plain,
             decode_cases)):
        errs[name] = [_attn_check(torch, name, kernel, plain, *c)
                      for c in cases]

    # The 14B model's shapes, one input set for each of its cut layers.
    gqa_flash = [(_randn(torch, g, (GQA_BATCH, 40, LM_PROMPT, 128), bf16),
                  _randn(torch, g, (GQA_BATCH, 8, LM_PROMPT, 128), bf16),
                  _randn(torch, g, (GQA_BATCH, 8, LM_PROMPT, 128), bf16))
                 for _ in range(GQA_LAYERS)]
    gqa_len = torch.full((GQA_BATCH,), LM_PROMPT + 1, dtype=torch.int32,
                         device=dev)
    gqa_decode = [(_randn(torch, g, (GQA_BATCH, 40, 128), bf16),
                   _randn(torch, g, (GQA_BATCH, 8, LM_PROMPT + GQA_GEN, 128),
                          bf16),
                   _randn(torch, g, (GQA_BATCH, 8, LM_PROMPT + GQA_GEN, 128),
                          bf16), gqa_len)
                  for _ in range(GQA_LAYERS)]
    rows = []
    for name, kernel, plain, library, calls, gqa, cost in (
            ("flash_attention", flash_attention, flash_attention_plain, _sdpa,
             f_calls, gqa_flash, _flash_cost),
            ("decode_attention", decode_attention, decode_attention_plain,
             _sdpa_decode, d_calls, gqa_decode, _decode_cost)):
        t = _attn_timing(torch, kernel, plain, library, calls, cost)
        tg = _attn_timing(torch, kernel, plain, library, gqa, cost)
        for label, r in (("served", t), ("qwen2.5-14b shapes", tg)):
            _log(f"kernel {name} ({label}, bf16): {r['ms']:.4f} ms (bound "
                 f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
                 f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
                 f"scaled_dot_product_attention; kernel/library "
                 f"{r['library_ratio']:.2f}x)")
        if name == "decode_attention":
            t["split"] = _decode_split(torch, "served", calls, t)
            tg["split"] = _decode_split(torch, "qwen2.5-14b shapes", gqa, tg)
            it = itertools.cycle(calls)
            t["host_us"] = _host_us(torch, lambda: kernel(*next(it)))
            _log(f"decode_attention wrapper: {t['host_us']:.1f} us of host "
                 f"time a call (served shapes, the device kept busy)")
        source, replaces = KERNELS[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=errs[name][0], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library_ratio=t["library_ratio"],
            max_abs_err_all_cases=max(errs[name]), gqa_14b=tg,
            **({"split": t["split"], "host_us": t["host_us"]}
               if name == "decode_attention" else {})))
    record["attention_phase"] = dict(
        rows=rows, flash_errs=errs["flash_attention"],
        decode_errs=errs["decode_attention"], flash_bf16_instances=tc,
        decode_instances=k7)
    return rows


def _serve_run(torch, label, cfg, batch, gen, run, want=None) -> dict:
    """One served run: launch counts read just after it (the counts set to
    0 just before) equal to ``want`` (by default one flash attention per
    layer and one decode attention per layer and step) and no other kernel,
    every logit finite, the tokens in the vocabulary."""
    from repro_torch import kernels
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = run()
    counts = dict(kernels.LAUNCHES)
    if want is None:
        want = {"flash_attention": cfg.n_layers,
                "decode_attention": cfg.n_layers * (gen - 1)}
    if any(counts[k] != want.get(k, 0) for k in counts):
        raise AssertionError(f"{label}: launches {counts}, expected {want} "
                             f"and no other kernel")
    if not res.logits_finite:
        raise AssertionError(f"{label}: a logit was not finite")
    if tuple(res.seqs.shape) != (batch, gen) or not bool(
            ((res.seqs >= 0) & (res.seqs < cfg.vocab)).all()):
        raise AssertionError(f"{label}: tokens of shape "
                             f"{tuple(res.seqs.shape)} or out of the vocab")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _log(f"serve {label}: batch {batch} prompt {LM_PROMPT} gen {gen}: "
         f"prefill {res.prefill_s:.4f} s "
         f"({batch * LM_PROMPT / res.prefill_s:.1f} tok/s), decode "
         f"{res.decode_s:.4f} s ({res.decode_tokens_per_s:.1f} tok/s, "
         f"{res.decode_s / max(gen - 1, 1) * 1e3:.3f} ms per step), "
         f"launches {counts}, logits finite, peak memory {peak:.2f} GiB; "
         f"first tokens {res.seqs[0, :8].tolist()}")
    return dict(prefill_s=res.prefill_s, decode_s=res.decode_s,
                decode_tokens_per_s=res.decode_tokens_per_s,
                launches={k: counts[k] for k in want}, peak_gib=peak,
                batch=batch, gen=gen, layers=cfg.n_layers)


def phase_serve(torch, record) -> dict:
    """Phase 6b: the served path, ``serve_lm.main`` at Qwen1.5-0.5B's full
    config (its decode loop under sync debug mode "error"), then
    ``serve_lm.serve`` on Qwen2.5-14B at full width, depth cut.  Returns
    the 0.5B run's launch counts of the attention kernels."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    served = _serve_run(
        torch, LM_ARCH, get_config(LM_ARCH), LM_BATCH, LM_GEN,
        lambda: serve_lm.main(["--arch", LM_ARCH, "--batch", str(LM_BATCH),
                               "--prompt-len", str(LM_PROMPT), "--gen",
                               str(LM_GEN), "--seed", str(LM_SEED)]))
    cfg = dataclasses.replace(get_config(GQA_ARCH), n_layers=GQA_LAYERS)
    gqa = _serve_run(
        torch, f"{GQA_ARCH} at {GQA_LAYERS} layers", cfg, GQA_BATCH, GQA_GEN,
        lambda: serve_lm.serve(cfg, batch=GQA_BATCH, prompt_len=LM_PROMPT,
                               gen=GQA_GEN, seed=LM_SEED))
    record["serve"] = {LM_ARCH: served, GQA_ARCH: gqa}
    return served["launches"]


def phase_parity(torch, dev, record, arch, want, **overrides) -> None:
    """Phases 6c, 7c and 8c: ``arch``'s width at PARITY_LAYERS layers in
    float32 (``overrides`` replace fields of that config), on the card with
    the kernels and on the CPU with the plain versions, from the same
    weights, teacher-forced on the CPU's greedy tokens.  ``want`` is the
    run's launch count of each kernel it uses; a state with a ``wkv`` or an
    ``ssm`` field also has its prefill error reported."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.train.serve_step import pick
    cfg = dataclasses.replace(get_config(arch), **dict(
        dict(n_layers=PARITY_LAYERS, compute_dtype="float32"), **overrides))
    model = api.get_model(cfg)
    card = model.init(torch.Generator(device=dev).manual_seed(LM_SEED), cfg)
    cpu = type(card)(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    tokens = api.synth_batch(LM_SEED, cfg, PARITY_BATCH, PARITY_PROMPT,
                             device="cpu")["tokens"]
    max_len = PARITY_PROMPT + PARITY_GEN
    kernels.reset_launches()
    want_logits, cstate = model.prefill(cpu, tokens, cfg, max_len=max_len)
    got, gstate = model.prefill(card, tokens.to(dev), cfg, max_len=max_len)
    state, state_err = "", None
    for field in ("wkv", "ssm"):
        if hasattr(cstate, field):
            want_state = getattr(cstate, field)
            state_err = float((getattr(gstate, field).cpu()
                               - want_state).abs().max())
            state = (f"; prefill {field.upper()} state max err "
                     f"{state_err:.3e} (max |state| "
                     f"{float(want_state.abs().max()):.4g})")
    errs, compared = [], 0
    for step in range(PARITY_GEN):
        if step:
            want_logits, cstate = model.decode_step(cpu, cstate, nxt, cfg)
            got, gstate = model.decode_step(card, gstate, nxt.to(dev), cfg)
        errs.append(float((got.cpu() - want_logits).abs().max()))
        top2 = want_logits[:, -1].topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > PARITY_TOL
        nxt = pick(want_logits)[:, None]
        if not torch.equal(pick(got.cpu())[sure], nxt[sure, 0]):
            raise AssertionError(f"{arch} parity step {step}: greedy tokens "
                                 f"differ where the margin exceeds the "
                                 f"tolerance")
        compared += int(sure.sum())
    counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
    _log(f"parity (card kernels vs CPU plain, f32, {cfg.n_layers} layers of "
         f"{arch}{f' {overrides}' if overrides else ''}, batch "
         f"{PARITY_BATCH}, prompt {PARITY_PROMPT}, "
         f"{PARITY_GEN} steps): max logit err per step "
         f"{[f'{e:.3e}' for e in errs]}, tolerance {PARITY_TOL}, "
         f"{compared} tokens compared{state}; launches {counts}")
    if max(errs) > PARITY_TOL:
        raise AssertionError(f"{arch}: card vs CPU logits differ by "
                             f"{max(errs)}")
    if counts != want:
        raise AssertionError(f"{arch} parity run launches {counts}, "
                             f"expected {want}")
    record.setdefault("parity", {})[arch] = dict(
        errs=errs, tol=PARITY_TOL, compared=compared, state_err=state_err)


def phase_phi3(torch, dev, rows, record) -> None:
    """Phase 6d: Phi-3-mini at its full config in bf16, head dim 96 (fault
    F1).  K6 and K7 against their plain versions, in bf16 and float32, on
    the inputs of layer 0 of the served model's prefill and first decode
    step and at head dims 96 and 24 (the smoke config's) on ragged
    lengths; K6 and K7 timed at Phi-3's shapes (added to their rows as
    ``phi3``); then ``serve_lm.main`` at batch 8, prompt 1024, PHI3_GEN
    tokens, with the kernels' launch counts checked."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.launch import serve_lm
    cfg = get_config(PHI3_ARCH)
    params, _, cache, _, f_calls, d_calls = _served_attention(
        torch, dev, cfg, LM_PROMPT + PHI3_GEN)
    del params, cache
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    q0, k0, v0 = f_calls[0]
    dq, dk, dv, dlen = d_calls[0]
    flash_cases = [("phi3 served layer 0", (q0, k0, v0), {}),
                   ("phi3 served layer 0",
                    (q0.float(), k0.float(), v0.float()), {})]
    decode_cases = [("phi3 served layer 0, first step", (dq, dk, dv, dlen),
                     {}),
                    ("phi3 served layer 0, first step",
                     (dq.float(), dk.float(), dv.float(), dlen), {})]
    for dt in (bf16, f32):
        for b, hq, hkv, s, d in ((2, 32, 32, 77, 96), (2, 4, 4, 1000, 24),
                                 (2, 8, 4, 130, 24)):
            qkv = (_randn(torch, g, (b, hq, s, d), dt),
                   _randn(torch, g, (b, hkv, s, d), dt),
                   _randn(torch, g, (b, hkv, s, d), dt))
            for causal in (True, False):
                flash_cases.append((f"S={s} group {hq // hkv} hd {d} "
                                    f"causal={causal}", qkv,
                                    dict(causal=causal)))
            lengths = [0, 1, s]
            args = (_randn(torch, g, (3, hq, d), dt),
                    _randn(torch, g, (3, hkv, s, d), dt),
                    _randn(torch, g, (3, hkv, s, d), dt),
                    torch.tensor(lengths, dtype=torch.int32, device=dev))
            decode_cases.append((f"S={s} group {hq // hkv} hd {d} lengths "
                                 f"{lengths}", args, {}))
    by_name = {row["name"]: row for row in rows}
    out = {}
    for name, kernel, plain, library, cases, calls, cost in (
            ("flash_attention", flash_attention, flash_attention_plain, _sdpa,
             flash_cases, f_calls, _flash_cost),
            ("decode_attention", decode_attention, decode_attention_plain,
             _sdpa_decode, decode_cases, d_calls, _decode_cost)):
        errs = [_attn_check(torch, name, kernel, plain, *c) for c in cases]
        t = _attn_timing(torch, kernel, plain, library, calls, cost)
        t.update(max_abs_err=errs[0], max_abs_err_all_cases=max(errs))
        if name == "decode_attention":
            t["split"] = _decode_split(torch, PHI3_ARCH, calls, t)
        _log(f"kernel {name} ({PHI3_ARCH} shapes, bf16): {t['ms']:.4f} ms "
             f"(bound {t['bound_ms']:.4f} ms by {t['bound_by']}, plain "
             f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
             f"scaled_dot_product_attention; kernel/library "
             f"{t['library_ratio']:.2f}x)")
        row = by_name[name]
        row["phi3"] = t
        row["max_abs_err_all_cases"] = max(row["max_abs_err_all_cases"],
                                           max(errs))
        out[name] = t
    del f_calls, d_calls, q0, k0, v0, dq, dk, dv
    served = _serve_run(
        torch, PHI3_ARCH, cfg, LM_BATCH, PHI3_GEN,
        lambda: serve_lm.main(["--arch", PHI3_ARCH, "--batch", str(LM_BATCH),
                               "--prompt-len", str(LM_PROMPT), "--gen",
                               str(PHI3_GEN), "--seed", str(LM_SEED)]))
    for name in out:
        by_name[name]["phi3"]["launches"] = served["launches"][name]
    record["phi3"] = dict(kernels=out, serve=served)


def _wkv_inputs(torch, g, bh, t, d, dt, decay="spread"):
    """r, k, v (BH, T, D) N(0, 0.25), the decay w in (0, 1) (``decay``:
    "spread", "near0" or "near1"), u (BH, D) N(0, 0.01), in type dt."""
    def randn(shape):
        return torch.randn(shape, generator=g, device=g.device)
    r, k, v = (0.5 * randn((bh, t, d)) for _ in range(3))
    mean, sd = {"spread": (-2.0, 1.5), "near0": (2.0, 0.5),
                "near1": (-6.0, 0.5)}[decay]
    w = torch.exp(-torch.exp(mean + sd * randn((bh, t, d))))
    u = 0.1 * randn((bh, d))
    return tuple(z.to(dt) for z in (r, k, v, w, u))


def _wkv_check(torch, cname, args) -> dict:
    """One case of K9 against its plain version, output and final state;
    raises past the tolerance.  Returns the errors."""
    from repro_torch.kernels.rwkv6.wkv6 import wkv6, wkv6_plain
    got, gstate = wkv6(*args, return_state=True)
    want, wstate = wkv6_plain(*args, return_state=True)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape or \
            gstate.shape != wstate.shape or gstate.dtype != torch.float32:
        raise AssertionError(f"wkv6 [{cname}]: {got.dtype} "
                             f"{tuple(got.shape)} != {want.dtype} "
                             f"{tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    mag = float(want.float().abs().max()) if want.numel() else 0.0
    rel = err / mag if mag else 0.0
    serr = float((gstate - wstate).abs().max())
    exact = bool(torch.equal(got, want) and torch.equal(gstate, wstate))
    ok = serr <= WKV_F32_TOL and (rel <= WKV_BF16_REL
                                  if got.dtype == torch.bfloat16
                                  else err <= WKV_F32_TOL)
    _log(f"kernel wkv6 [{cname}, {args[0].dtype}, r {tuple(args[0].shape)}] "
         f"max_abs_err={err:.3e} rel_err={rel:.3e} (max |out| {mag:.4g}) "
         f"state_max_abs_err={serr:.3e} bit_exact={exact} within_tol={ok}")
    if not ok:
        raise AssertionError(f"wkv6 disagrees with its plain version on "
                             f"{cname}")
    return dict(case=cname, abs=err, rel=rel, state=serr, exact=exact)


def _wkv_cost(r, k, v, w, u):
    """(bytes, operations) of K9: r, k, v, w, u and out once each, the
    float32 state once; 5 operations per (bh, t, i, j)."""
    bh, t, d = r.shape
    es = r.element_size()
    return es * (5 * r.numel() + u.numel()) + 4 * bh * d * d, 5 * bh * t * d * d


def phase_wkv6(torch, dev, record, ptxas: str) -> dict:
    """Phase 7a: K9 against its plain version on the inputs of every layer
    of the served RWKV6-3B's prefill (bf16; layer 0 also in float32), at
    T = 1, T = 77 (no chunk divides it), T = 0, D = 16 and 64, and w near 0
    and near 1, in bf16 and float32, within the tolerances and, since K9
    repeats the plain version's every float32 operation in its order, bit
    for bit (the phase fails otherwise); its instances' registers, spills
    and shared memory from the compiler's report ``ptxas``; timed over the
    served layers' inputs beside its bound and plain version (no single
    PyTorch call computes WKV6); one profiler window each over a prefill
    and over decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.wkv6 import wkv6, wkv6_plain
    from repro_torch.models import api, rwkv6
    from repro_torch.train.serve_step import pick
    instances = _resources(ptxas, "wkv6_kernel", [
        (d, ty) for d in (16, 64) for ty in ("bf16", "f32")])
    cfg = get_config(RWKV_ARCH)
    params = rwkv6.init(torch.Generator(device=dev).manual_seed(LM_SEED), cfg)
    tokens = api.synth_batch(LM_SEED, cfg, LM_BATCH, LM_PROMPT,
                             device=dev)["tokens"]
    calls = []
    with _calls(wkv_ops, "wkv6", calls):
        logits, state = rwkv6.prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    if len(calls) != cfg.n_layers:
        raise AssertionError("the served RWKV6 did not call wkv6 once per "
                             "layer")
    served = [args for args, _ in calls]
    bf16, f32 = torch.bfloat16, torch.float32
    results = [_wkv_check(torch, f"served layer {i}", args)
               for i, args in enumerate(served)]
    results.append(_wkv_check(torch, "served layer 0, float32",
                              tuple(z.float() for z in served[0])))
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    for dt in (bf16, f32):
        for bh, t, d, decay in ((6, 1, 64, "spread"), (6, 77, 16, "spread"),
                                (6, 77, 64, "spread"), (5, 1000, 64, "near0"),
                                (5, 1000, 64, "near1"), (5, 1000, 16, "near1"),
                                (4, 0, 64, "spread")):
            results.append(_wkv_check(
                torch, f"T={t} hd {d} w {decay}",
                _wkv_inputs(torch, g, bh, t, d, dt, decay)))
    inexact = [f"{r['case']}" for r in results if not r["exact"]]
    if inexact:
        raise AssertionError(f"wkv6 is not bit-exact to its plain version "
                             f"on {inexact}")

    def cycled(fn):
        it = itertools.cycle(served)
        return lambda: fn(*next(it), return_state=True)
    ms = _time_ms(torch, cycled(wkv6), 2 * len(served))
    plain_ms = _time_ms(torch, cycled(wkv6_plain), 3, warmup=1)
    nbytes, nops = _wkv_cost(*served[0])
    bound_ms, bound_by = _bound_ms(nbytes, nops)
    _log(f"kernel wkv6 (served, bf16, r {tuple(served[0][0].shape)}): "
         f"{ms:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}: {nbytes} "
         f"bytes, {nops} operations; plain {plain_ms:.4f} ms, library none)")
    del served, calls

    record["rwkv_profile_prefill"] = _profile_window(
        torch, lambda: rwkv6.prefill(params, tokens, cfg),
        f"prefill {RWKV_ARCH} {LM_BATCH}x{LM_PROMPT}",
        "chip_smoke_profile_rwkv_prefill.txt")
    first = pick(logits)[:, None]

    def decode_steps():
        nxt = first
        for _ in range(PROFILE_DECODE_STEPS):
            out, _ = rwkv6.decode_step(params, state, nxt, cfg)
            nxt = pick(out)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_steps()
    torch.cuda.synchronize()
    record["rwkv_decode_step_ms"] = (time.perf_counter() - t0) * 1e3 / \
        PROFILE_DECODE_STEPS
    _log(f"decode step, {RWKV_ARCH} batch {LM_BATCH}, no profiler: "
         f"{record['rwkv_decode_step_ms']:.3f} ms (host clock, mean of "
         f"{PROFILE_DECODE_STEPS})")
    record["rwkv_profile_decode"] = _profile_window(
        torch, decode_steps, f"{PROFILE_DECODE_STEPS} decode steps "
        f"{RWKV_ARCH} batch {LM_BATCH}", "chip_smoke_profile_rwkv_decode.txt")

    source, replaces = KERNELS["wkv6"]
    head = results[:cfg.n_layers]
    row = dict(name="wkv6", route="cuda", source=source, replaces=replaces,
               launches=0, max_abs_err=max(r["abs"] for r in head),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None,
               max_rel_err=max(r["rel"] for r in head),
               max_state_err_all_cases=max(r["state"] for r in results),
               bit_exact_all_cases=all(r["exact"] for r in results),
               bytes=nbytes, ops=nops, instances=instances)
    record["wkv6_phase"] = dict(row=row, cases=results)
    return row


def phase_rwkv_serve(torch, record) -> int:
    """Phase 7b: ``serve_lm.main`` at RWKV6-3B's full config, batch 8,
    prompt 1024, RWKV_GEN tokens: one K9 launch per layer, in the prefill,
    and no other kernel.  Returns K9's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    cfg = get_config(RWKV_ARCH)
    served = _serve_run(
        torch, RWKV_ARCH, cfg, LM_BATCH, RWKV_GEN,
        lambda: serve_lm.main(["--arch", RWKV_ARCH, "--batch", str(LM_BATCH),
                               "--prompt-len", str(LM_PROMPT), "--gen",
                               str(RWKV_GEN), "--seed", str(LM_SEED)]),
        want={"wkv6": cfg.n_layers})
    record["serve"][RWKV_ARCH] = served
    return served["launches"]["wkv6"]


def _scan_inputs(torch, g, bsz, t, dim, n, dt, delta="spread"):
    """x, Δ (B, T, dim), b, c (B, T, N) in type dt; a (dim, N) and d (dim,)
    float32.  x, b, c, d N(0, 1); Δ log-uniform over [1e-3, 1] ("spread"),
    near 1e-3 ("small"), near 1 ("large") or over [1e-3, 100] ("wide":
    exps that underflow to subnormals and zero); a = -(1..N) per channel
    times U(0.5, 1.5)."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device=g.device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=g.device)
    lo, hi = {"spread": (1e-3, 1.0), "small": (8e-4, 1.2e-3),
              "large": (0.8, 1.2), "wide": (1e-3, 100.0)}[delta]
    step = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                     * rand(bsz, t, dim))
    a = -(torch.arange(1, n + 1, device=g.device, dtype=torch.float32)
          * (0.5 + rand(dim, 1)))
    return (randn(bsz, t, dim).to(dt), step.to(dt), randn(bsz, t, n).to(dt),
            randn(bsz, t, n).to(dt), a.contiguous(), randn(dim))


def _scan_check(torch, cname, args, return_state=True) -> dict:
    """One case of K8 against its plain version, y and (with
    ``return_state``) the final state; raises past the tolerance."""
    from repro_torch.kernels.mamba_scan.mamba_scan import (
        selective_scan, selective_scan_plain)
    got = selective_scan(*args, return_state=return_state)
    want = selective_scan_plain(*args, return_state=return_state)
    torch.cuda.synchronize()
    (got, gstate), (want, wstate) = (
        (got, want) if return_state else ((got, None), (want, None)))
    if got.dtype != want.dtype or got.shape != want.shape or (
            return_state and (gstate.shape != wstate.shape
                              or gstate.dtype != torch.float32)):
        raise AssertionError(f"selective_scan [{cname}]: {got.dtype} "
                             f"{tuple(got.shape)} != {want.dtype} "
                             f"{tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if got.numel() else 0.0
    mag = float(want.float().abs().max()) if want.numel() else 0.0
    if got.dtype == torch.bfloat16:
        ok = bool((diff <= SCAN_BF16_REL * want.float().abs() + 1e-5).all())
    else:
        ok = err <= SCAN_F32_TOL * max(1.0, mag)
    serr = float((gstate - wstate).abs().max()) if return_state else 0.0
    ok = ok and serr <= SCAN_F32_TOL
    exact = bool(torch.equal(got, want) and (
        not return_state or torch.equal(gstate, wstate)))
    _log(f"kernel selective_scan [{cname}, {args[0].dtype}, x "
         f"{tuple(args[0].shape)}, N {args[2].shape[-1]}, state "
         f"{return_state}] max_abs_err={err:.3e} (max |y| {mag:.4g}) "
         f"state_max_abs_err={serr:.3e} bit_exact={exact} within_tol={ok}")
    if not ok:
        raise AssertionError(f"selective_scan disagrees with its plain "
                             f"version on {cname}")
    return dict(case=cname, abs=err, state=serr, exact=exact)


def _scan_cost(x, dt, b, c, a, d):
    """(bytes, operations, exps) of K8: x, Δ and y, b and c, a and d once
    each, the float32 state once; 5 float32 operations per (b, t, channel,
    n) and one exp."""
    bsz, t, dim = x.shape
    n = b.shape[-1]
    es = x.element_size()
    nbytes = (es * (3 * x.numel() + 2 * b.numel())
              + 4 * (a.numel() + d.numel() + bsz * dim * n))
    return nbytes, 5 * bsz * t * dim * n, bsz * t * dim * n


def _sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _scan_bound(torch, nbytes: int, nops: int, nexp: int) -> dict:
    """K8's bound, the largest of three times: the bytes at the memory
    rate; the exps on the special-function units, 16 a clock an SM; the 5
    float32 operations an element that cannot be fused, 128 a clock an SM;
    both at the card's highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _sm_clock_hz()
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "ex2": nexp / (16 * sms * clock) * 1e3,
             "float32 issue": nops / (128 * sms * clock) * 1e3}
    by = max(terms, key=terms.get)
    return dict(bound_ms=terms[by], bound_by="bytes" if by == "bytes"
                else "operations", terms_ms=terms, term=by, sms=sms,
                sm_clock_hz=clock)


def phase_mamba_scan(torch, dev, record, ptxas: str) -> dict:
    """Phase 8a: K8 against its plain version on the inputs of every Mamba
    sublayer of the served Jamba prefill (one superblock at full width,
    bf16 model, float32 scan inputs), with and without the state, and on
    edge cases (T = 1, 31, 32, 33, 77, 1000 and 0, N = 8 and 16, dim =
    200, 512 and 8192, Δ near 1e-3, near 1 and up to 100) in bf16 and
    float32, bit for bit (the phase fails otherwise); its instances'
    registers, spills and shared memory from the compiler's report
    ``ptxas``; timed over the served layers' inputs beside its bound and
    plain version (no single PyTorch call computes the scan); profiler
    windows over a Jamba prefill and decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan.mamba_scan import (
        selective_scan, selective_scan_plain)
    from repro_torch.models import api, jamba
    from repro_torch.train.serve_step import pick
    instances = _resources(ptxas, "scan_kernel", [
        (n, ty) for n in (8, 16) for ty in ("bf16", "f32")])
    cfg = dataclasses.replace(get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = jamba.init(gen, cfg)
    tokens = api.synth_batch(LM_SEED, cfg, LM_BATCH, LM_PROMPT,
                             device=dev)["tokens"]
    max_len = LM_PROMPT + 2 * PROFILE_DECODE_STEPS
    calls = []
    with _calls(scan_ops, "selective_scan", calls):
        logits, state = jamba.prefill(params, tokens, cfg, max_len=max_len)
    torch.cuda.synchronize()
    if len(calls) != jamba.N_MAMBA * (cfg.n_layers // jamba.SUPER):
        raise AssertionError("the served Jamba did not call the selective "
                             "scan once per Mamba sublayer")
    served = [args for args, _ in calls]
    results = [_scan_check(torch, f"served Mamba sublayer {i}", args)
               for i, args in enumerate(served)]
    results.append(_scan_check(torch, "served Mamba sublayer 0, stateless",
                               served[0], return_state=False))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    for dt in (torch.bfloat16, torch.float32):
        for bsz, t, dim, n, delta in ((3, 1, 8192, 16, "spread"),
                                      (2, 31, 8192, 16, "spread"),
                                      (2, 32, 200, 8, "large"),
                                      (2, 33, 8192, 8, "small"),
                                      (2, 77, 200, 8, "spread"),
                                      (2, 77, 200, 16, "small"),
                                      (4, 1000, 512, 16, "large"),
                                      (4, 1000, 512, 8, "small"),
                                      (2, 1000, 200, 16, "wide"),
                                      (2, 77, 8192, 8, "wide"),
                                      (2, 0, 256, 16, "spread")):
            args = _scan_inputs(torch, g, bsz, t, dim, n, dt, delta)
            for with_state in (True, False):
                results.append(_scan_check(
                    torch, f"T={t} dim {dim} N {n} delta {delta}", args,
                    with_state))
    inexact = [r["case"] for r in results if not r["exact"]]
    if inexact:
        raise AssertionError(f"selective_scan is not bit-exact to its plain "
                             f"version on {inexact}")

    def cycled(fn):
        it = itertools.cycle(served)
        return lambda: fn(*next(it), return_state=True)
    ms = _time_ms(torch, cycled(selective_scan), 2 * len(served))
    plain_ms = _time_ms(torch, cycled(selective_scan_plain), 3, warmup=1)
    nbytes, nops, nexp = _scan_cost(*served[0])
    bound = _scan_bound(torch, nbytes, nops, nexp)
    bound_ms, bound_by = bound["bound_ms"], bound["bound_by"]
    terms = ", ".join(f"{k} {v:.4f} ms" for k, v in bound["terms_ms"].items())
    _log(f"kernel selective_scan (served, x {tuple(served[0][0].shape)} "
         f"{served[0][0].dtype}, N {served[0][2].shape[-1]}): {ms:.4f} ms "
         f"(bound {bound_ms:.4f} ms by {bound['term']}: {terms}, from "
         f"{nbytes} bytes, {nops} operations, {nexp} exps, {bound['sms']} "
         f"SMs at {bound['sm_clock_hz'] / 1e9:.3f} GHz; plain "
         f"{plain_ms:.4f} ms, library none)")
    del served, calls

    record["jamba_profile_prefill"] = _profile_window(
        torch, lambda: jamba.prefill(params, tokens, cfg, max_len=max_len),
        f"prefill {JAMBA_ARCH} at {JAMBA_LAYERS} layers "
        f"{LM_BATCH}x{LM_PROMPT}", "chip_smoke_profile_jamba_prefill.txt")
    nxt = pick(logits)[:, None]

    def decode_steps():
        nonlocal state, nxt
        for _ in range(PROFILE_DECODE_STEPS):
            out, state = jamba.decode_step(params, state, nxt, cfg)
            nxt = pick(out)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_steps()
    torch.cuda.synchronize()
    record["jamba_decode_step_ms"] = (time.perf_counter() - t0) * 1e3 / \
        PROFILE_DECODE_STEPS
    _log(f"decode step, {JAMBA_ARCH} at {JAMBA_LAYERS} layers, batch "
         f"{LM_BATCH}, no profiler: {record['jamba_decode_step_ms']:.3f} ms "
         f"(host clock, mean of {PROFILE_DECODE_STEPS})")
    record["jamba_profile_decode"] = _profile_window(
        torch, decode_steps, f"{PROFILE_DECODE_STEPS} decode steps "
        f"{JAMBA_ARCH} batch {LM_BATCH}",
        "chip_smoke_profile_jamba_decode.txt")
    del params, state

    source, replaces = KERNELS["selective_scan"]
    head = results[:jamba.N_MAMBA]
    row = dict(name="selective_scan", route="cuda", source=source,
               replaces=replaces, launches=0,
               max_abs_err=max(r["abs"] for r in head), ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None,
               max_state_err_all_cases=max(r["state"] for r in results),
               bit_exact_all_cases=all(r["exact"] for r in results),
               bytes=nbytes, ops=nops, exps=nexp,
               bound_terms_ms=bound["terms_ms"], sms=bound["sms"],
               sm_clock_hz=bound["sm_clock_hz"], instances=instances)
    record["mamba_scan_phase"] = dict(row=row, cases=results)
    return row


def _grouped_mm_route(torch, dev) -> dict:
    """How ``torch._grouped_mm``, the MoE layer's grouped product (hazard
    H11), runs on this card in bf16 and float32: whether it waits for the
    card under sync debug mode "error", and its error against the products
    one group at a time.  The served decode needs bf16 free of host syncs
    and within two bf16 ulps (2**-6 × max(1, max |out|)) of the per-group
    products; float32 is reported."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    sizes = torch.tensor([8, 0, 24, 8] * 4, dtype=torch.int32, device=dev)
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    ends = offs.tolist()
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        x = _randn(torch, g, (ends[-1], 256), dt)
        w = _randn(torch, g, (16, 256, 128), dt)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch._grouped_mm(x, w, offs=offs)
            syncs = False
        except RuntimeError as e:
            if "synchronizing" not in str(e):
                raise
            syncs = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = torch._grouped_mm(x, w, offs=offs).float()
        want = torch.cat([x[e - n:e].float() @ w[i].float() for i, (e, n) in
                          enumerate(zip(ends, sizes.tolist()))])
        err = float((got - want).abs().max())
        tol = 2 ** -6 * max(1.0, float(want.abs().max()))
        _log(f"torch._grouped_mm {dt}: host sync under sync debug mode "
             f"'error': {syncs}; max err against per-group products "
             f"{err:.3e} (max |out| {float(want.abs().max()):.4g})")
        out[str(dt)] = dict(host_sync=syncs, max_abs_err=err, tol=tol)
    bf16 = out[str(torch.bfloat16)]
    if bf16["host_sync"]:
        raise AssertionError("torch._grouped_mm waits for the card in bf16: "
                             "the served MoE decode would sync")
    if not bf16["max_abs_err"] <= bf16["tol"]:
        raise AssertionError(f"torch._grouped_mm in bf16 is off the "
                             f"per-group products by {bf16['max_abs_err']:.3e}"
                             f" (tolerance {bf16['tol']:.3e})")
    return out


def phase_hybrid_serve(torch, record) -> dict:
    """Phase 8b: the grouped product's route (``_grouped_mm_route``), then
    ``serve_lm.serve`` on Jamba at full width over one superblock (7 K8
    and 1 K6 in the prefill, 1 K7 a decode step, no other kernel), then
    ``serve_lm.main`` on Qwen2-MoE-A2.7B at its full config (one K6 a layer,
    one K7 a layer and step), each at batch 8, prompt 1024, 32 tokens, its
    decode loop under sync debug mode "error".  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import jamba
    record["grouped_mm"] = _grouped_mm_route(torch, torch.device("cuda"))
    cfg = dataclasses.replace(get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS)
    nb = JAMBA_LAYERS // jamba.SUPER
    jamba_run = _serve_run(
        torch, f"{JAMBA_ARCH} at {JAMBA_LAYERS} layers", cfg, LM_BATCH,
        JAMBA_GEN,
        lambda: serve_lm.serve(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                               gen=JAMBA_GEN, seed=LM_SEED),
        want={"selective_scan": 7 * nb, "flash_attention": nb,
              "decode_attention": nb * (JAMBA_GEN - 1)})
    torch.cuda.empty_cache()
    moe_run = _serve_run(
        torch, MOE_ARCH, get_config(MOE_ARCH), LM_BATCH, MOE_GEN,
        lambda: serve_lm.main(["--arch", MOE_ARCH, "--batch", str(LM_BATCH),
                               "--prompt-len", str(LM_PROMPT), "--gen",
                               str(MOE_GEN), "--seed", str(LM_SEED)]))
    record["serve"][JAMBA_ARCH] = jamba_run
    record["serve"][MOE_ARCH] = moe_run
    return {"selective_scan": jamba_run["launches"]["selective_scan"]}


# ---------------------------------------------------------------------------
# Phase 5d: the MST service
# ---------------------------------------------------------------------------

def _serve_workload(np):
    """The JAX package's serving workload (``launch/serve.py`` ``main``):
    SERVE_REQUESTS rmat graphs of scales 2 to 8 at degree 8, every 16th at
    degree 32 (over the edge cap, so shed), from seed 0."""
    from repro_torch.core import generators
    rng = np.random.default_rng(0)
    top = max(SERVE_KNOBS["batch_max_vertices"].bit_length() - 1, 2)
    return [generators.generate(
        "rmat", int(rng.integers(2, top + 1)),
        avg_degree=8 if i % 16 else 32, seed=int(rng.integers(0, 2**31)))
        for i in range(SERVE_REQUESTS)]


def _service_run(torch, label, svc, graphs, rate, oracles) -> dict:
    """``run_poisson`` at ``rate`` on the real clock; every served forest
    equal to Kruskal's and to its batched solve on the card."""
    from repro_torch import kernels
    from repro_torch.core import mst_api
    from repro_torch.launch import serve
    kernels.reset_launches()
    t0 = time.perf_counter()
    futs = serve.run_poisson(svc, graphs, rate=rate, seed=0)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
    served = [(i, f.result()) for i, f in enumerate(futs) if f is not None]
    batched, _ = mst_api.minimum_spanning_forests(
        [graphs[i] for i, _ in served], params=svc.params)
    for (i, res), b in zip(served, batched):
        if not (_same_forest(res, oracles[i]) and _same_forest(res, b)):
            raise AssertionError(f"{label} request {i}: forest != Kruskal "
                                 f"or its batched solve")
    s = svc.stats.summary()
    _log(f"service {label} at {rate:g} graphs/s: {len(graphs)} offered in "
         f"{wall:.3f} s; p50 {s['p50_ms']} ms, p99 {s['p99_ms']} ms, mean "
         f"{s['mean_ms']} ms, {s['graphs_per_s']} graphs/s; flushes size "
         f"{s['size_flushes']} deadline {s['deadline_flushes']} drain "
         f"{s['drain_flushes']}; ghost lanes {s['ghost_lanes']}; shed "
         f"{s['shed_oversize']} oversize + {s['shed_queue_full']} queue full; "
         f"max queue {s['max_queue_depth']}; launches {counts}; every forest "
         f"= Kruskal = its batched solve")
    return dict(rate=rate, wall_s=wall, launches=counts, **s)


def phase_service(torch, record, corpus) -> None:
    """Phase 5d: ``launch/serve.py``'s ``MSTService`` on the card.
    (a) The JAX package's serving settings (SERVE_KNOBS): ``warmup`` timed
    (its 288 (shape, width) pairs), then SERVE_REQUESTS graphs offered by
    ``run_poisson`` at each of SERVE_RATES; (b) the corpus of phase 5b (256
    pipeline rmat graphs, scales 8 to 12) at CORPUS_SERVE_KNOBS, warmup
    timed, offered at each of CORPUS_SERVE_RATES (``corpus``: phase 5b's
    host graphs and Kruskal forests); every served forest equal to
    Kruskal's and to its batched solve.  (c) SERVE_UPDATES update
    requests (pipeline rmat scale SERVE_UPDATE_SCALE, SERVE_UPDATE_SIZE
    inserts and deletes each), each equal to a standalone ``apply_updates``
    on the card."""
    import numpy as np
    from repro_torch.core import kruskal_ref, mst_api, pipeline
    from repro_torch.core.params import GHSParams
    from repro_torch.launch import serve
    rec = dict(settings={})
    graphs = _serve_workload(np)
    settings = [("serving", SERVE_KNOBS, SERVE_RATES, graphs,
                 [kruskal_ref.kruskal(g) for g in graphs]),
                ("corpus", CORPUS_SERVE_KNOBS, CORPUS_SERVE_RATES, *corpus)]
    for label, knobs, rates, graphs, oracles in settings:
        params = GHSParams(**knobs)
        warm = serve.MSTService(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warmed = warm.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        _log(f"service {label}: warmup {warmed} (shape, width) pairs in "
             f"{warm_s:.3f} s")
        runs = [_service_run(torch, label, serve.MSTService(params), graphs,
                             rate, oracles) for rate in rates]
        rec["settings"][label] = dict(knobs=knobs, warmed=warmed,
                                      warm_s=warm_s, runs=runs)

    params = GHSParams(**CORPUS_SERVE_KNOBS)
    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(SERVE_UPDATES):
        g = pipeline.build(pipeline.GraphSpec(
            "rmat", SERVE_UPDATE_SCALE, avg_degree=32, seed=1000 + i))
        state, _ = mst_api.incremental_forest(g, params=params)
        reqs.append((state, _update_batch(np, rng, state, SERVE_UPDATE_SIZE)))
    svc = serve.MSTService(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [svc.submit_update(state, batch) for state, batch in reqs]
    svc.poll()
    svc.drain()
    upd_s = time.perf_counter() - t0
    for i, ((state, batch), fut) in enumerate(zip(reqs, futs)):
        alone, _ = mst_api.apply_updates(state, batch, params=params)
        got = fut.result()
        if not (_same_forest(got.forest, alone.forest)
                and _same_graph(got.graph, alone.graph)):
            raise AssertionError(f"update request {i} != apply_updates")
    s = svc.stats.summary()
    _log(f"service updates: {SERVE_UPDATES} requests (pipeline rmat-"
         f"{SERVE_UPDATE_SCALE}, {SERVE_UPDATE_SIZE} inserts and deletes "
         f"each) served in {upd_s:.3f} s, flushes size {s['size_flushes']} "
         f"drain {s['drain_flushes']}, updates_applied "
         f"{svc.stats.updates_applied}, replacement_probes "
         f"{svc.stats.replacement_probes}; each = apply_updates")
    rec["updates"] = dict(wall_s=upd_s, **s,
                          updates_applied=svc.stats.updates_applied,
                          replacement_probes=svc.stats.replacement_probes)
    record["service"] = rec


# ---------------------------------------------------------------------------
# Phase 5e: the paper-faithful GHS engine
# ---------------------------------------------------------------------------

GHS_ABLATIONS = {     # tests/test_mst_correctness.py's five settings
    "base": dict(use_hashing=False, relaxed_test_queue=False,
                 compress_messages=False),
    "binary": dict(use_hashing=False, hash_table_factor=-1.0,
                   relaxed_test_queue=False),
    "check1": dict(check_frequency=1),
    "check7": dict(check_frequency=7),
    "final": dict(),
}


def _ghs_registers(ptxas: str) -> dict:
    """Registers, spills and stack of each interval-kernel instance, keyed
    ``method/lanes/relaxed``."""
    out, key = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"ghs_intervalILi(\d)ELi(\d)ELb(\d)E", line)
        if "entry function" in line:
            key = (f"{('hash', 'linear', 'binary')[int(m[1])]}/{m[2]}/"
                   f"{'relaxed' if m[3] == '1' else 'strict'}") if m else None
            continue
        if key is None:
            continue
        r = out.setdefault(key, {})
        for field, pattern in (("registers", r"Used (\d+) registers"),
                               ("stack_bytes", r"(\d+) bytes stack frame"),
                               ("spill_bytes", r"(\d+) bytes spill stores")):
            m = re.search(pattern, line)
            if m:
                r[field] = int(m[1])
    return out


def _ghs_lockstep(torch, dev, arrays, topo, params, label) -> int:
    """The kernel on the card and its plain version on the CPU from the
    same state, an interval at a time until silence: every ShardState
    array and the scalar vector equal after each interval (raises
    otherwise).  Returns the intervals compared."""
    from repro_torch.core import ghs_state
    from repro_torch.kernels.ghs_superstep import ghs_superstep, ref
    cfg = ref.config(topo, params)
    cpu = ghs_state.upload(arrays, "cpu")
    card = ghs_state.upload(arrays, dev)
    n_steps = 1 if params.round_loop == "host" else cfg.check
    scal_c = torch.zeros(3, dtype=torch.int32)
    scal_g = scal_c.to(dev)
    for k in range(100_000):
        scal_g = ghs_superstep.interval(card, scal_g, n_steps, cfg)
        scal_c = ghs_superstep.interval(cpu, scal_c, n_steps, cfg)
        got, want = ghs_state.host_arrays(card), ghs_state.host_arrays(cpu)
        bad = [f for f in want if not _np_equal(got[f], want[f])]
        if bad or scal_g.tolist() != scal_c.tolist():
            raise AssertionError(f"ghs_superstep {label} interval {k}: "
                                 f"kernel != plain on {bad or 'scalars'}")
        _, silent, err = scal_c.tolist()
        if err or silent >= cfg.empty_needed:
            return k + 1
    raise AssertionError(f"ghs_superstep {label}: no silence")


def _np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def _ghs_first_interval(torch, dev, graph, params) -> dict:
    """The first interval of ``graph``'s solve: the kernel on the card
    (CUDA events, the host ahead; three fresh copies of the state) and
    the plain version on the CPU from the same state, every array equal
    after it; the bytes it must touch."""
    import numpy as np
    from repro_torch.core import ghs_state
    from repro_torch.kernels.ghs_superstep import ghs_superstep, ref
    topo, shards = ghs_state.host_shards(graph, 1, params)
    cfg = ref.config(topo, params)
    before = shards[0]
    times = []
    for _ in range(3):
        card = ghs_state.upload(before, dev)
        scal = torch.zeros(3, dtype=torch.int32, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        _hold_device(torch, 1.0)
        start.record()
        out = ghs_superstep.interval(card, scal, cfg.check, cfg)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    cpu = ghs_state.upload(before, "cpu")
    t0 = time.perf_counter()
    plain = ghs_superstep.interval(cpu, torch.zeros(3, dtype=torch.int32),
                                   cfg.check, cfg)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got, want = ghs_state.host_arrays(card), ghs_state.host_arrays(cpu)
    bad = [f for f in want if not _np_equal(got[f], want[f])]
    if bad or out.tolist() != plain.tolist():
        raise AssertionError(f"ghs_superstep first interval: kernel != plain "
                             f"on {bad or 'scalars'}")
    popped = int(want["n_processed"])
    pushed = int(want["n_sent_local"]) + int(want["n_sent_remote"])
    changed = sum(int((want[f] != before[f]).sum()) for f in (
        "sn", "ln", "fnw", "fne", "find_count", "in_branch", "best_edge",
        "best_w", "best_e", "test_edge", "se", "hist_act", "hist_sent"))
    # Each popped message read once and each pushed one written once (its
    # words and its position lane), one hash slot (three words) a popped
    # message, and each state word that changed written once.
    nbytes = 4 * ((topo.lanes + 1) * (popped + pushed) + 3 * popped
                  + changed)
    return dict(ms=statistics.median(times), times_ms=times,
                plain_ms=plain_ms, supersteps=out.tolist()[0],
                messages=popped, pushed=pushed, changed_words=changed,
                nbytes=nbytes)


def phase_ghs(torch, dev, record, ptxas: str) -> tuple[dict, int]:
    """Phase 5e: ``minimum_spanning_forest(method="ghs")`` on the card.
    (a) rmat-GHS_SCALE under both round loops and the five ablations, each
    forest equal to Kruskal's, the launches one an interval (device loop)
    or one a superstep (host loop); (b) the interval kernel against its
    plain version on the whole state after every interval at rmat-
    GHS_KERNEL_SCALE, every ablation and both loops, bit for bit; (c)
    rmat-GHS_BIG_SCALE: ``init_shards``' host time, the solve (supersteps,
    intervals, messages, wall, ns a message) beside the Borůvka solve of
    the same graph, one profiler window; its first interval, kernel against
    plain, timed beside its bound.  Returns the kernels-line row and the
    launches of the big solve."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import generators, ghs_state, kruskal_ref, mst_api
    from repro_torch.core.params import GHSParams
    from repro_torch.kernels import KERNELS
    rec = dict(registers=_ghs_registers(ptxas), solves={})
    _log(f"ghs_superstep instances (registers, stack, spills): "
         f"{rec['registers']}")

    g = generators.rmat(GHS_SCALE, seed=SEED)
    oracle = kruskal_ref.kruskal(g)
    for loop in ("device", "host"):
        for name, knobs in GHS_ABLATIONS.items():
            params = GHSParams(round_loop=loop, **knobs)
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, st = mst_api.minimum_spanning_forest(g, method="ghs",
                                                      params=params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = kernels.LAUNCHES["ghs_superstep"]
            want = (st.supersteps if loop == "host"
                    else st.intervals + st.speculative_intervals)
            if not _same_forest(res, oracle):
                raise AssertionError(f"ghs rmat-{GHS_SCALE} {loop} {name}: "
                                     f"forest != Kruskal")
            if n != want or any(v for k, v in kernels.LAUNCHES.items()
                                if k != "ghs_superstep"):
                raise AssertionError(f"ghs {loop} {name}: launches "
                                     f"{dict(kernels.LAUNCHES)}, expected "
                                     f"{want} of the interval kernel")
            _log(f"ghs rmat-{GHS_SCALE} (m={g.num_edges}) round_loop={loop} "
                 f"{name}: {wall:.4f} s, supersteps {st.supersteps}, "
                 f"intervals {st.intervals}, messages {st.processed} "
                 f"({wall / st.processed * 1e9:.0f} ns each), launches {n}, "
                 f"halted {st.halted_fragments}; forest = Kruskal")
            rec["solves"][f"{loop}/{name}"] = dict(
                wall_s=wall, supersteps=st.supersteps, intervals=st.intervals,
                processed=st.processed, launches=n)

    small = generators.rmat(GHS_KERNEL_SCALE, seed=SEED)
    compared = {}
    for loop in ("device", "host"):
        for name, knobs in GHS_ABLATIONS.items():
            params = GHSParams(round_loop=loop, **knobs)
            topo, shards = ghs_state.host_shards(small, 1, params)
            compared[f"{loop}/{name}"] = _ghs_lockstep(
                torch, dev, shards[0], topo, params, f"{loop}/{name}")
    _log(f"ghs_superstep rmat-{GHS_KERNEL_SCALE}: kernel = plain on every "
         f"ShardState array after each interval, bit for bit ({compared} "
         f"intervals)")
    rec["lockstep_intervals"] = compared

    big = generators.rmat(GHS_BIG_SCALE, seed=SEED)
    oracle = kruskal_ref.boruvka_numpy(big)
    t0 = time.perf_counter()
    ghs_state.host_shards(big, 1, GHSParams())
    init_s = time.perf_counter() - t0
    first = _ghs_first_interval(torch, dev, big, GHSParams())
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, _ = mst_api.minimum_spanning_forest(big)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not _same_forest(res, oracle):
        raise AssertionError(f"Borůvka rmat-{GHS_BIG_SCALE} != oracle")
    kernels.reset_launches()
    out = []
    prof = _profile_window(
        torch, lambda: out.append(mst_api.minimum_spanning_forest(
            big, method="ghs")), f"ghs rmat-{GHS_BIG_SCALE}",
        "chip_smoke_profile_ghs.txt", kernel_names=("ghs_interval",))
    res, st = out[0]
    launches = kernels.LAUNCHES["ghs_superstep"]
    if not _same_forest(res, oracle):
        raise AssertionError(f"ghs rmat-{GHS_BIG_SCALE}: forest != oracle")
    if launches != st.intervals + st.speculative_intervals:
        raise AssertionError(f"ghs rmat-{GHS_BIG_SCALE}: {launches} launches "
                             f"for {st.intervals} intervals")
    kernel_ms = sum(ms for key, ms, _ in prof["top"] if "ghs_interval" in key)
    wall = prof["window_s"]
    _log(f"ghs rmat-{GHS_BIG_SCALE} (n={big.num_vertices}, m="
         f"{big.num_edges}): init_shards on the host {init_s:.3f} s; solve "
         f"{wall:.3f} s, supersteps {st.supersteps}, intervals "
         f"{st.intervals}, messages {st.processed} "
         f"({wall / st.processed * 1e9:.0f} ns each; kernel {kernel_ms:.1f} ms in all, "
         f"{kernel_ms / max(launches, 1):.3f} ms an interval), launches "
         f"{launches}; Borůvka solve of the same graph median "
         f"{statistics.median(walls):.4f} s ({[round(w, 4) for w in walls]}); "
         f"forest = oracle")
    bound_ms, bound_by = _bound_ms(first["nbytes"], 0)
    _log(f"ghs_superstep first interval of rmat-{GHS_BIG_SCALE} "
         f"({first['supersteps']} supersteps, {first['messages']} messages): "
         f"{first['ms']:.3f} ms ({first['times_ms']}), plain "
         f"{first['plain_ms']:.1f} ms, bound {bound_ms:.4f} ms by bytes "
         f"({first['nbytes']} bytes); kernel = plain on every array")
    rec["big"] = dict(scale=GHS_BIG_SCALE, n=big.num_vertices,
                      m=big.num_edges, init_s=init_s, wall_s=wall,
                      supersteps=st.supersteps, intervals=st.intervals,
                      processed=st.processed,
                      ns_per_message=wall / st.processed * 1e9,
                      kernel_ms=kernel_ms, launches=launches,
                      boruvka_walls_s=walls, profile=prof, first=first)
    record["ghs"] = rec
    source, replaces = KERNELS["ghs_superstep"]
    row = dict(name="ghs_superstep", route="cuda", source=source,
               replaces=replaces, launches=0, bit_exact=True, max_abs_err=0,
               ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, lanes=first["messages"])
    return row, launches


def probe_ghs_scales(scales) -> int:
    """``python3 chip_smoke.py --ghs-scales 16,18``: ``method="ghs"`` on
    rmat at each scale (degree 32, seed SEED), its wall time, supersteps
    and messages logged, the forest held against the numpy oracle; how
    GHS_BIG_SCALE is chosen (the largest of 16-18 that ends within 60 s)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import generators, kruskal_ref, mst_api
    _log(_card_line())
    for scale in scales:
        g = generators.rmat(scale, seed=SEED)
        oracle = kruskal_ref.boruvka_numpy(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, st = mst_api.minimum_spanning_forest(g, method="ghs")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not _same_forest(res, oracle):
            raise AssertionError(f"ghs rmat-{scale}: forest != oracle")
        _log(f"ghs rmat-{scale} (m={g.num_edges}): {wall:.3f} s, supersteps "
             f"{st.supersteps}, messages {st.processed}; forest = oracle")
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import generators, kruskal_ref, runtime
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = _card_line()
    _log(card)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    record = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = build.build_all()
    record["build_s"] = time.perf_counter() - t0
    _log(f"kernel build: {record['build_s']:.2f} s into {build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line or "registers" in line or "spill" in line:
                _log(f"ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    graph = generators.rmat(SCALE, seed=SEED)
    record["generate_s"] = time.perf_counter() - t0
    _log(f"rmat-{SCALE}: n={graph.num_vertices} m={graph.num_edges} "
         f"generated in {record['generate_s']:.1f} s (host numpy)")
    t0 = time.perf_counter()
    oracle = kruskal_ref.boruvka_numpy(graph)
    record["oracle_s"] = time.perf_counter() - t0
    _log(f"boruvka_numpy oracle: {record['oracle_s']:.1f} s, "
         f"tree_edges={oracle.num_tree_edges}")

    bundle = runtime.prepare_edges(graph, "block", chunk=8, device=dev)
    rows = phase_kernels(torch, dev, graph, bundle, record,
                         logs["pointer_jump"])
    del bundle
    rows.append(phase_scan32(torch, dev, graph, record))
    hash_row, hash_inputs = phase_hash(torch, dev, graph, record,
                                       logs["edge_hash"])
    rows.append(hash_row)
    torch.cuda.empty_cache()
    launches, forests = phase_solves(torch, graph, oracle, record)
    phase_profile(torch, graph, record)
    launches["segmented_min_scan"] = phase_host_solves(torch, graph, oracle,
                                                       record)
    launches["hash_lookup"] = phase_lookup(torch, hash_inputs, record)
    del hash_inputs
    torch.cuda.empty_cache()
    phase_sweep(torch, record)
    t0 = time.perf_counter()
    spec, pipe_host = phase_pipeline_build(torch, record)
    pipe_launches = phase_pipeline_solve(torch, spec, pipe_host, record)
    del pipe_host
    torch.cuda.empty_cache()
    pipe_launches["batched_k1"], corpus = phase_batched(torch, record)
    record["pipeline_launches"] = pipe_launches
    record["pipeline_phase_s"] = time.perf_counter() - t0
    _log(f"phase 5b (graph pipeline, DeviceEdges solves, batched corpus): "
         f"{record['pipeline_phase_s']:.1f} s; launches {pipe_launches}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record["filter_update_launches"] = dict(
        filter=phase_filter(torch, graph, oracle, forests, record),
        updates_label_k3=phase_updates(torch, graph, record))
    del forests
    record["filter_update_phase_s"] = time.perf_counter() - t0
    _log(f"phase 5c (filter-Borůvka, incremental updates): "
         f"{record['filter_update_phase_s']:.1f} s; K3 launches "
         f"{record['filter_update_launches']}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_service(torch, record, corpus)
    del corpus
    record["service_phase_s"] = time.perf_counter() - t0
    _log(f"phase 5d (the MST service): {record['service_phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ghs_row, launches["ghs_superstep"] = phase_ghs(torch, dev, record,
                                                   logs["ghs_superstep"])
    record["ghs_phase_s"] = time.perf_counter() - t0
    _log(f"phase 5e (the GHS engine): {record['ghs_phase_s']:.1f} s")
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows += phase_attention(torch, dev, record, logs["flash_attention"],
                            logs["decode_attention"])
    torch.cuda.empty_cache()
    launches.update(phase_serve(torch, record))
    phase_parity(torch, dev, record, LM_ARCH, {
        "flash_attention": PARITY_LAYERS,
        "decode_attention": PARITY_LAYERS * (PARITY_GEN - 1)})
    torch.cuda.empty_cache()
    phase_phi3(torch, dev, rows, record)
    torch.cuda.empty_cache()
    rows.append(phase_wkv6(torch, dev, record, logs["wkv6"]))
    torch.cuda.empty_cache()
    launches["wkv6"] = phase_rwkv_serve(torch, record)
    phase_parity(torch, dev, record, RWKV_ARCH, {"wkv6": PARITY_LAYERS})
    torch.cuda.empty_cache()
    rows.append(phase_mamba_scan(torch, dev, record, logs["mamba_scan"]))
    torch.cuda.empty_cache()
    launches.update(phase_hybrid_serve(torch, record))
    torch.cuda.empty_cache()
    phase_parity(torch, dev, record, JAMBA_ARCH, {
        "selective_scan": 7, "flash_attention": 1,
        "decode_attention": PARITY_GEN - 1}, **JAMBA_PARITY)
    phase_parity(torch, dev, record, MOE_ARCH, {
        "flash_attention": PARITY_LAYERS,
        "decode_attention": PARITY_LAYERS * (PARITY_GEN - 1)})

    rows.append(ghs_row)
    for row in rows:
        row["launches"] = launches[row["name"]]
    record["seconds"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    _log(f"chip smoke: {record['seconds']:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ghs-scales"]:
        sys.exit(probe_ghs_scales(int(x) for x in sys.argv[2].split(",")))
    sys.exit(main())
