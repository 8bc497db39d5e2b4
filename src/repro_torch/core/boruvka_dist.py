"""Device-resident synchronous Borůvka engine on one device.

Per round, every fragment's minimum outgoing edge is ONE segmented min
over packed keys ``(weight_bits << 32) | edge_id`` (the weight and the
tie-break resolve in the same reduction); fragments merge by min-hooking
and pointer doubling.  The round loop stays on the device: an interval
queues ``check_frequency`` rounds without reading anything back, counts on
the device the rounds it started while not done, and returns one vector of
four scalars (done, rounds run, active edges, touched fragments) — the
host reads that vector once per interval and then decides on termination
and on compaction, a prefix-sum stream compaction of the surviving edges
into a power-of-two bucket.

Two round bodies (``params.round_kernel``): ``"xla"`` (:func:`_one_round`,
per-edge election and winner recording) and ``"pallas"``
(:func:`_one_round_fused`, the masked min-plus election with fragment-scale
recording and hooking).  With ``params.use_pallas`` they run the
hand-written CUDA kernels of :mod:`repro_torch.kernels` on a CUDA device.

The legacy host-driven loop (``params.round_loop="host"``,
:func:`_host_engine`) is the reference's before/after baseline: one round
per dispatch, a two-phase election over single uint32 lanes (weight bits,
then edge ids; each carried as a flipped int32, ``core/keys.py``), the
winners read back every round into a host bitmap, and a host compaction
with re-upload every ``check_frequency`` rounds.  With ``use_pallas`` its
per-segment mins run the 32-bit segmented scan kernel.

The reference's device gathers clamp out-of-range indices and its
scatters drop them; PyTorch raises on both.  So every label gather clamps
its index explicitly (:func:`_take`), and every dropping scatter writes
into one extra slot past the end of its buffer that is never read.  The
tree bitmap and the label buffers are updated in place.  Nothing in an
interval synchronizes with the host (bitmap writes use ``index_fill_``: an
indexed assignment of a Python scalar copies the scalar from pageable host
memory and so waits for the stream); the host waits only at the interval's
one readback.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import keys as keys_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core import runtime
from repro_torch.core import union_find
from repro_torch.core.graph import PAD_VERTEX, Graph
from repro_torch.core.kruskal_ref import ForestResult
from repro_torch.core.params import DEFAULT_PARAMS, GHSParams
from repro_torch.core.partition import pow2ceil
from repro_torch.kernels.segment_min import ops as segops
from repro_torch.kernels.spmv_minplus import ops as spmv_ops

INF_KEY = keys_lib.INF_KEY
INF32 = keys_lib.INF32           # flipped int32 "no edge" lane (INT32_MAX)
REF_INF32 = 0xFFFFFFFF           # the same lane as the reference's uint32
_PAD_SLOT = 0x7FFF0000   # compaction padding slot: never a live edge


@dataclasses.dataclass
class BoruvkaStats(runtime.EngineStats):
    rounds: int = 0
    compactions: int = 0
    edges_scanned: int = 0          # Σ active (padded) edge slots per round
    active_history: tuple = ()      # active edges after each interval


def _take(labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``labels[idx]`` with the index clamped into range, as the
    reference's gathers clamp (a ``PAD_VERTEX`` endpoint reads the last
    label, so a padding edge is a self-loop)."""
    return labels[idx.clamp(max=labels.shape[0] - 1)]


def _one_round(comp, mask, src, dst, key, slot, *, use_pallas: bool):
    """One Borůvka round: fused MOE election, winner recording, merging.

    ``mask`` is the per-slot tree bitmap with one extra slot at the end.
    """
    n = comp.shape[0]
    cap = mask.shape[0] - 1
    cs = _take(comp, src)
    cd = _take(comp, dst)
    alive = (cs != cd) & (key != INF_KEY)
    k = torch.where(alive, key, INF_KEY)
    best = segops.segment_min64(torch.cat([k, k]), torch.cat([cs, cd]),
                                num_segments=n, use_pallas=use_pallas)
    winners = alive & ((best[cs] == k) | (best[cd] == k))
    mask.index_fill_(0, torch.where(winners, slot.to(torch.int64), cap), True)
    parent = union_find.hook_min(n, torch.maximum(cs, cd),
                                 torch.minimum(cs, cd), winners)
    parent = union_find.pointer_double(parent)
    done = (best == INF_KEY).all()
    return parent[comp], mask, done


def _one_round_fused(comp, mask, src, dst, key, csrc, cdst, *,
                     lowering: str, sort_bits):
    """One Borůvka round as the fused masked min-plus election.

    The elected ``best[f]`` names the winning edge (its id lane is the
    canonical edge id), so winner recording writes a canonical-id bitmap
    (one extra slot at the end) at fragment scale, and the merge partner
    comes from the canonical endpoints ``csrc``/``cdst``.  Shortcut and
    relabel fuse into one call.
    """
    n = comp.shape[0]
    m = mask.shape[0] - 1
    cs = _take(comp, src)
    cd = _take(comp, dst)
    best = spmv_ops.elect(cs, cd, key, num_segments=n, lowering=lowering,
                          sort_bits=sort_bits)
    elected = best != INF_KEY
    eid = keys_lib.unpack_edge_id(best)      # 0xFFFFFFFF when not elected
    mask.index_fill_(0, torch.where(elected, eid, m), True)
    cu = comp[_take(csrc, eid)]              # garbage gated by ``elected``
    cv = comp[_take(cdst, eid)]
    f = torch.arange(n, dtype=comp.dtype, device=comp.device)
    other = torch.where(cu == f, cv, cu)
    parent = union_find.hook_min(n, torch.maximum(f, other),
                                 torch.minimum(f, other), elected)
    comp = spmv_ops.shortcut_relabel(parent, comp,
                                     use_pallas=(lowering == "pallas"))
    done = (best == INF_KEY).all()
    return comp, mask, done


def _run_interval(comp, mask, edges, rounds: int, round_fn):
    """Queue ``rounds`` rounds and the interval's scalar summary.

    The reference stops its loop at the first round that finds no live
    edge; here every round is queued, and a round started after ``done``
    is a fixed point (no live edge, identity parent) that is not counted.
    Returns the new state and a :class:`runtime.Readback` of
    ``(done, rounds run, active edges, touched fragments)``.
    """
    src, dst, key = edges[0], edges[1], edges[2]
    dev = comp.device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    r = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(rounds):
        comp, mask, done_i = round_fn(comp, mask, *edges)
        r = r + (~done).to(torch.int64)
        done = done | done_i
    # Active-edge census (the compaction bucket) and the distinct
    # fragments touched by active edges (the reference's candidate census).
    n = comp.shape[0]
    cs = _take(comp, src)
    cd = _take(comp, dst)
    active = (cs != cd) & (key != INF_KEY)
    touched = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    touched.index_fill_(0, torch.where(active, cs.to(torch.int64), n), True)
    touched.index_fill_(0, torch.where(active, cd.to(torch.int64), n), True)
    scalars = torch.stack([done.to(torch.int64), r, active.sum(),
                           touched[:n].sum()])
    return comp, mask, runtime.Readback(scalars)


def _compact(comp, src, dst, key, slot, *, cap: int):
    """Prefix-sum stream compaction of the edge block to ``cap`` slots.

    Dead edges (endpoints in one fragment) are dropped, survivors slide to
    the front carrying their load-time bitmap ``slot``, and the tail refills
    with the padding sentinels.  Dropped lanes write the extra slot ``cap``.
    """
    keep = (_take(comp, src) != _take(comp, dst)) & (key != INF_KEY)
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    idx = torch.where(keep, pos, cap)

    def scatter(fill, vals):
        out = torch.full((cap + 1,), fill, dtype=vals.dtype, device=vals.device)
        out[idx] = vals
        return out[:cap]

    return (scatter(int(PAD_VERTEX), src), scatter(int(PAD_VERTEX), dst),
            scatter(INF_KEY, key), scatter(_PAD_SLOT, slot))


def _device_engine(graph: Graph, params: GHSParams, device: torch.device,
                   max_rounds: Optional[int]) -> tuple[ForestResult, BoruvkaStats]:
    if np.any(graph.weight.view(np.uint32) == REF_INF32):
        raise ValueError("weights collide with the INF sentinel")
    bundle = runtime.prepare_edges(graph, params.partitioner, chunk=8,
                                   device=device)
    n, m = bundle.num_vertices, bundle.num_edges
    layout = bundle.layout
    comp = torch.arange(n, dtype=torch.int32, device=device)

    fused = runtime.resolve_round_kernel(params.round_kernel) == "pallas"
    if fused:
        zero = np.zeros(1, np.int32)
        csrc = torch.from_numpy(graph.src if m else zero).to(device)
        cdst = torch.from_numpy(graph.dst if m else zero).to(device)
        mask = torch.zeros(m + 1, dtype=torch.bool, device=device)
        sort_bits = spmv_ops.sort_gate(n, m)
        if sort_bits is not None and np.any(
                graph.weight.view(np.uint32) >= spmv_ops.WEIGHT_LIMIT_BITS):
            sort_bits = None   # weights outside (0, 1): no sort key
        lowering = ("pallas" if params.use_pallas
                    else "sort" if sort_bits is not None else "scatter")
        sb = sort_bits if lowering == "sort" else None

        def round_fn(comp, mask, src, dst, key, slot):
            return _one_round_fused(comp, mask, src, dst, key, csrc, cdst,
                                    lowering=lowering, sort_bits=sb)
    else:
        mask = torch.zeros(layout.num_slots + 1, dtype=torch.bool,
                           device=device)

        def round_fn(comp, mask, src, dst, key, slot):
            return _one_round(comp, mask, src, dst, key, slot,
                              use_pallas=params.use_pallas)

    overlap = (runtime.resolve_interval_pipeline(
        params.interval_pipeline) == 1)
    interval = max(params.check_frequency, 1)
    cap_rounds = max_rounds or (n + 2)
    stats = BoruvkaStats()
    history = []
    box = dict(cur_block=layout.block, dispatched=0, inflight=[])

    def dispatch(s):
        comp, mask, edges = s
        # Clamp by the DISPATCHED total: under overlap a dispatch happens
        # before the previous interval's readback is consumed.
        this_rounds = max(min(interval, cap_rounds - box["dispatched"]), 0)
        comp, mask, readback = _run_interval(comp, mask, edges, this_rounds,
                                             round_fn)
        box["dispatched"] += this_rounds
        box["inflight"].append(box["cur_block"])
        return (comp, mask, edges), readback

    def finish(s, vals):
        done_v, r, n_act, _ = vals
        blk = box["inflight"].pop(0)
        stats.rounds += r
        stats.edges_scanned += r * blk
        history.append(n_act)
        if done_v:
            return s, True
        if params.compaction == "pow2":
            new_block = max(pow2ceil(n_act), 8)
            if new_block < box["cur_block"]:
                comp, mask, edges = s
                edges = _compact(comp, *edges, cap=new_block)
                s = (comp, mask, edges)
                box["cur_block"] = new_block
                stats.compactions += 1
        return s, False

    edges = (bundle.src, bundle.dst, bundle.key, bundle.slot)
    comp, mask, _ = runtime.interval_loop(
        (comp, mask, edges), dispatch, finish, stats=stats,
        max_intervals=cap_rounds, fail_msg="Borůvka engine failed to converge",
        overlap=overlap)

    comp_final = comp.cpu().numpy()              # final state fetch
    mask_full = mask.cpu().numpy()[:-1]
    stats.host_syncs += 1
    stats.extra_syncs += 1

    if fused:
        tree = mask_full
    else:
        tree = layout.canonical_mask(mask_full, m)
    ncomp = int(np.unique(comp_final).size)
    res = runtime.forest_from_mask(graph, tree, num_components=ncomp)
    res.check_consistent(n)
    stats.active_history = tuple(history)
    return res, stats


# ---------------------------------------------------------------------------
# Legacy host-driven loop (round_loop="host"): per-round syncs + host-side
# compaction.  The before/after baseline of the device loop.
# ---------------------------------------------------------------------------

def _pad_pow2(arrs, multiple: int, fill_vals):
    """Pad to the next power-of-two multiple of ``multiple``.

    src/dst are filled with PAD_VERTEX (clamped gathers make padding edges
    self-loops), weight bits and edge ids with their INF sentinel.
    """
    m = arrs[0].shape[0]
    target = multiple
    while target < m:
        target *= 2
    pad = target - m
    return [
        np.concatenate([a, np.full(pad, f, a.dtype)]) if pad else a
        for a, f in zip(arrs, fill_vals)
    ]


def _host_lanes(graph: Graph):
    """The host loop's edge arrays in canonical order: int32 endpoints, and
    the weight bits and edge ids as the reference's uint32 lanes."""
    return (graph.src.astype(np.int32), graph.dst.astype(np.int32),
            graph.weight.view(np.uint32).copy(),
            np.arange(graph.num_edges, dtype=np.uint32))


def _upload(arrs, chunk: int, device: torch.device) -> list:
    """The host loop's upload: ``(src, dst, wbits, eid)`` (numpy; the last
    two uint32) padded to a power-of-two multiple of ``chunk``, on
    ``device``, with the uint32 lanes as flipped int32."""
    s, d, w, e = _pad_pow2(arrs, chunk,
                           [PAD_VERTEX, PAD_VERTEX, REF_INF32, REF_INF32])
    return [torch.from_numpy(a).to(device) for a in
            (s, d, keys_lib.from_reference32(w), keys_lib.from_reference32(e))]


def _election_lanes(comp, src, dst, wbits, *, sort: bool):
    """The lanes a round elects over: endpoint labels ``cs``/``cd``, the
    ``alive`` mask, the weight lanes ``wb`` (INF where dead) and, with
    ``sort``, one stable sorting permutation per endpoint array (reused by
    both election phases; else None)."""
    cs = _take(comp, src)
    cd = _take(comp, dst)
    alive = (cs != cd) & (wbits != INF32)
    wb = torch.where(alive, wbits, INF32)
    order_s = torch.sort(cs, stable=True).indices if sort else None
    order_d = torch.sort(cd, stable=True).indices if sort else None
    return cs, cd, alive, wb, order_s, order_d


def _round_body(comp, src, dst, wbits, eid, *, use_pallas: bool = False):
    """One two-phase round: elect MOE per fragment, hook, compress, relabel.

    ``wbits``/``eid`` are flipped int32 lanes; returns the new labels, the
    per-edge winner bitmap and the device ``done`` flag.  Per-segment mins
    are scatter-mins, or with ``use_pallas`` a sort and the 32-bit scan
    kernel.
    """
    n = comp.shape[0]

    def segmin(seg, val, order):
        return segops.segment_min(val, seg, num_segments=n,
                                  use_pallas=use_pallas, order=order)

    cs, cd, alive, wb, order_s, order_d = _election_lanes(
        comp, src, dst, wbits, sort=use_pallas)

    # Phase 1: best weight per fragment.
    bw = torch.minimum(segmin(cs, wb, order_s), segmin(cd, wb, order_d))

    # Phase 2: tie-break by unique edge id among weight-matching edges.
    cand_s = torch.where(alive & (wb == bw[cs]), eid, INF32)
    cand_d = torch.where(alive & (wb == bw[cd]), eid, INF32)
    be = torch.minimum(segmin(cs, cand_s, order_s),
                       segmin(cd, cand_d, order_d))

    # Winners: the elected MOE edges (each fragment elects exactly one).
    winners = alive & ((be[cs] == eid) | (be[cd] == eid))

    # Merge: min-hooking + pointer doubling.
    parent = union_find.hook_min(n, torch.maximum(cs, cd),
                                 torch.minimum(cs, cd), winners)
    parent = union_find.pointer_double(parent)
    new_comp = parent[comp]

    done = (bw == INF32).all()
    return new_comp, winners, done


def _host_engine(graph: Graph, params: GHSParams, device: torch.device,
                 max_rounds: Optional[int]) -> tuple[ForestResult, BoruvkaStats]:
    n, m = graph.num_vertices, graph.num_edges
    if n == 0:
        raise ValueError("the host loop needs a graph with vertices")
    chunk = 8

    src, dst, wbits, eid = _host_lanes(graph)
    if np.any(wbits == REF_INF32):
        raise ValueError("weights collide with the INF sentinel")

    # The legacy loop tracks edges by canonical id end to end, so a
    # partitioner only sets the upload order: its edges of shard 0, then of
    # shard 1, ...  On one device every partitioner puts every edge in
    # shard 0, so the order is canonical.
    partition_lib.get_partitioner(params.partitioner)

    round_fn = functools.partial(_round_body, use_pallas=params.use_pallas)
    stats = BoruvkaStats()

    def put_edges(arrs):
        stats.host_syncs += 1          # host→device re-upload
        stats.extra_syncs += 1
        return _upload(arrs, chunk, device)

    comp_dev = torch.arange(n, dtype=torch.int32, device=device)
    src_d, dst_d, wb_d, eid_d = put_edges([src, dst, wbits, eid])

    mask = np.zeros(m, dtype=bool)
    history = []
    cap = max_rounds or (n + 2)
    # Host mirror of the active edge set (for compaction + winner mapping).
    box = dict(active=np.arange(m, dtype=np.int64))

    def dispatch(s):
        comp_dev, src_d, dst_d, wb_d, eid_d, _ = s
        comp_dev, winners, done = round_fn(comp_dev, src_d, dst_d, wb_d,
                                           eid_d)
        # The runtime fetches the done flag (the legacy loop's per-round
        # sync); the winner readback below is an extra, metered one.
        return ((comp_dev, src_d, dst_d, wb_d, eid_d, winners),
                runtime.Readback(done))

    def finish(s, done_v):
        comp_dev, src_d, dst_d, wb_d, eid_d, winners = s
        rnd = stats.rounds
        stats.rounds += 1
        stats.edges_scanned += int(src_d.shape[0])
        history.append(len(box["active"]))
        if done_v:
            return s, True
        stats.host_syncs += 1          # device→host: the winners' edge ids
        stats.extra_syncs += 1
        # The winners' ids are gathered on the device, so only they cross.
        eids = keys_lib.to_reference32(torch.masked_select(eid_d, winners))
        mask[eids[eids != REF_INF32].astype(np.int64)] = True
        # Lazy compaction every check_frequency rounds.
        if (
            params.compaction == "pow2"
            and (rnd + 1) % max(params.check_frequency, 1) == 0
        ):
            stats.host_syncs += 1      # device→host: fragment labels
            stats.extra_syncs += 1
            comp_h = comp_dev.cpu().numpy()
            active = box["active"]
            keep = comp_h[src[active]] != comp_h[dst[active]]
            if not keep.all():
                box["active"] = active = active[keep]
                stats.compactions += 1
                src_d, dst_d, wb_d, eid_d = put_edges(
                    [src[active], dst[active], wbits[active], eid[active]])
                s = (comp_dev, src_d, dst_d, wb_d, eid_d, winners)
        return s, False

    comp_dev = runtime.interval_loop(
        (comp_dev, src_d, dst_d, wb_d, eid_d, None), dispatch, finish,
        stats=stats, max_intervals=cap,
        fail_msg="Borůvka engine failed to converge", overlap=False)[0]

    comp_final = comp_dev.cpu().numpy()    # not counted, as the reference
    ncomp = int(np.unique(comp_final).size)
    res = runtime.forest_from_mask(graph, mask, num_components=ncomp)
    res.check_consistent(n)
    stats.active_history = tuple(history)
    return res, stats


def minimum_spanning_forest(
    graph,
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
    mesh=None,
    max_rounds: Optional[int] = None,
) -> tuple[ForestResult, BoruvkaStats]:
    """Run the Borůvka engine on one device; returns the forest + stats.

    ``device=None`` runs on CUDA and raises when no card is present;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.
    ``params.round_loop`` picks the device-resident loop (the default) or
    the legacy host loop; both run on one device.
    """
    dev = runtime.resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "mesh runs are not ported yet (ROADMAP queue 1, item 13: "
            "multi-GPU)")
    if runtime.resolve_collective(params.collective) == "compressed":
        raise NotImplementedError(
            "collective='compressed' is not ported yet (ROADMAP queue 1, "
            "item 13: multi-GPU)")
    if runtime.resolve_round_loop(params.round_loop) == "host":
        return _host_engine(runtime.as_graph(graph), params, dev, max_rounds)
    return _device_engine(runtime.as_graph(graph), params, dev, max_rounds)
