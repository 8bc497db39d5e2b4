#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. card and build — the card's name and power limit, the torch and CUDA
   versions, and a build of every CUDA kernel from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, started together), with the
   compiler's ``-Xptxas -v`` report;
2. kernels against their plain PyTorch versions, bit for bit, at the main
   path's shapes (inputs taken from round 1 of the RMAT scale-20 solve) and
   on edge cases, each timed with CUDA events beside its bytes bound, its
   plain version and, where one exists, a single PyTorch library call;
3. the main path — ``minimum_spanning_forest(graph, method="boruvka")`` on
   a Graph500-style RMAT graph of scale 20 (average degree 32, fixed seed)
   with ``use_pallas=True`` under both round bodies, each forest held
   against the numpy Borůvka oracle, the kernels' launch counts read, the
   median wall time over several runs, and one profiler window;
4. a small RMAT scale-10 sweep over every knob the port exposes, each
   forest held against Kruskal and against the same solve on the CPU;
5. one ``{"kernels": [...]}`` line, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

A record of the run is written to ``chip_smoke_out/chip_smoke.json`` and the
profiler's table to ``chip_smoke_out/chip_smoke_profile.txt``.
"""
from __future__ import annotations

import itertools
import json
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


def _log(*parts) -> None:
    print(*parts, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over the words (exact integers); 0 if equal."""
    diff = torch.nonzero(got != want).flatten()[:1000]
    if diff.numel() == 0:
        return 0
    return max(abs(int(a) - int(b)) for a, b in
               zip(got[diff].tolist(), want[diff].tolist()))


def _bound_ms(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _scan_cases(torch, dev, inf):
    """Edge cases for the scan kernels: (name, seg, oth, key)."""
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def keys(m, choices=None):
        if choices is not None:
            k = choices[torch.randint(0, choices.numel(), (m,), generator=g)]
        else:
            k = torch.randint(-2 ** 62, 2 ** 62, (m,), generator=g)
        k[torch.rand(m, generator=g) < 0.05] = inf
        return k

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
               torch.full((m,), inf, dtype=torch.int64))
    r = (1 << 20) + 12345
    yield case("ragged length", torch.sort(torch.randint(0, r // 7, (r,), generator=g)).values,
               keys(r))
    yield case("duplicate keys", torch.sort(torch.randint(0, m // 50, (m,), generator=g)).values,
               keys(m, torch.tensor([5, -7, inf - 1, -2 ** 63], dtype=torch.int64)))


def phase_kernels(torch, dev, graph, bundle, record) -> list:
    """Phase 2: every kernel of the main path against its plain version."""
    from repro_torch.core import keys, union_find
    from repro_torch.core.boruvka_dist import _take
    from repro_torch.kernels import KERNELS
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
         None, 4 * n + 4 * n + 4 * n, 2 * n * jump_steps(n),
         _jump_cases(torch, dev, n)),
    ]
    rows = []
    for name, kernel, plain, args, library, nbytes, nops, cases in specs:
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
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=0, bit_exact=True,
                         max_abs_err=0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms, lanes=args[-1].numel()))
        _log(f"kernel {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
             f"{bound_by}, plain {plain_ms:.4f} ms, library "
             f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'})")
    record["kernels_phase"] = rows
    return rows


def _jump_cases(torch, dev, n):
    """Hook forests for the pointer jump: one deep chain, and random."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    ids = torch.arange(n)
    chain = (ids - 1).clamp(min=0)
    rand = torch.minimum(torch.randint(0, n, (n,), generator=g), ids)
    comp = torch.randint(0, n, (n,), generator=g)
    as_dev = lambda t: t.to(torch.int32).to(dev).contiguous()  # noqa: E731
    return [("deep chain", (as_dev(chain), as_dev(comp))),
            ("random forest", (as_dev(rand), as_dev(comp))),
            ("ragged comp", (as_dev(rand), as_dev(comp[: n // 3 + 7])))]


def phase_solves(torch, graph, oracle, record) -> dict:
    """Phase 3: the main path under both kernel round bodies."""
    from repro_torch import kernels
    from repro_torch.core import mst_api
    from repro_torch.core.params import GHSParams
    launches = {}
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
        med = statistics.median(walls)
        _log(f"solve rmat-{SCALE} round_kernel={rk}: median wall {med:.4f} s "
             f"over {SOLVE_RUNS} runs, {graph.num_edges / med:.4e} edges/s, "
             f"launches {counts}")
        record.setdefault("solves", {})[rk] = dict(
            walls_s=walls, median_s=med, launches=counts, rounds=st.rounds,
            intervals=st.intervals, host_syncs=st.host_syncs,
            compactions=st.compactions,
            active_history=list(st.active_history))
    return launches


def phase_profile(torch, graph, record) -> None:
    """One profiler window over a fused-kernel solve, and the host
    staging step (layout + upload) timed on its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import mst_api, runtime
    from repro_torch.core.params import GHSParams
    params = GHSParams(round_kernel="pallas", use_pallas=True)
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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mst_api.minimum_spanning_forest(graph, params=params)
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
    top = sorted(on_device, key=dev_us, reverse=True)[:10]
    idle = 1.0 - busy_us / (window * 1e6) if busy_us else None
    _log(f"profile: window {window:.4f} s, device busy {busy_us / 1e3:.3f} ms, "
         f"idle share {'not measured' if idle is None else f'{idle:.4f}'}")
    for e in top:
        _log(f"  device op {e.key[:60]!r}: {dev_us(e) / 1e3:.3f} ms "
             f"x{e.count}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        events.table(sort_by="self_cpu_time_total", row_limit=60))
    record["profile"] = dict(
        window_s=window, device_busy_ms=busy_us / 1e3, idle_share=idle,
        top=[(e.key, dev_us(e) / 1e3, e.count) for e in top])


def phase_sweep(torch, record) -> None:
    """Phase 4: every knob on a small graph, on the card and on the CPU."""
    from repro_torch.core import generators, kruskal_ref, mst_api
    from repro_torch.core.params import GHSParams
    g = generators.rmat(10, seed=SEED)
    want = kruskal_ref.kruskal(g)
    fields = ("rounds", "intervals", "host_syncs", "compactions",
              "active_history")
    n_ok = 0
    for rk, up, ip, part in itertools.product(
            ("xla", "pallas"), (False, True), (0, 1),
            ("block", "hashed", "balanced")):
        params = GHSParams(round_kernel=rk, use_pallas=up,
                           interval_pipeline=ip, partitioner=part)
        res, st = mst_api.minimum_spanning_forest(g, params=params)
        cpu, cst = mst_api.minimum_spanning_forest(g, params=params,
                                                   device="cpu")
        if not ((res.edge_mask == want.edge_mask).all()
                and (cpu.edge_mask == want.edge_mask).all()):
            raise AssertionError(f"sweep {params}: forest != Kruskal")
        if any(getattr(st, f) != getattr(cst, f) for f in fields):
            raise AssertionError(f"sweep {params}: stats differ from CPU")
        n_ok += 1
    _log(f"sweep rmat-10: {n_ok}/24 knob settings equal Kruskal and the CPU "
         f"solve")
    record["sweep_ok"] = n_ok


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
    rows = phase_kernels(torch, dev, graph, bundle, record)
    del bundle
    launches = phase_solves(torch, graph, oracle, record)
    phase_profile(torch, graph, record)
    phase_sweep(torch, record)

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
    sys.exit(main())
