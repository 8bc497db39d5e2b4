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

Two round bodies (``params.round_kernel``): ``"xla"``
(:func:`_one_round_sharded`, per-edge election and winner recording) and ``"pallas"``
(:func:`_one_round_fused`, the masked min-plus election with fragment-scale
recording and hooking).  With ``params.use_pallas`` they run the
hand-written CUDA kernels of :mod:`repro_torch.kernels` on a CUDA device.

Under a mesh (:class:`repro_torch.sharding.mesh.Mesh`, S shards on one
device) the edges are ``(S, block)`` tensors, one row a shard, and the
fragment labels are held once, as the reference replicates them.  Each
round elects per shard in ONE call over all S rows (each shard's segments
offset by ``s · n``, so one K1 or K2 launch), then reduces the ``(S, n)``
elections across shards with ``pmin`` or the compressed delta exchange
(``params.collective``, :mod:`repro_torch.sharding.collectives`); the
pointer jump (K3) runs once on the replicated parents.  The host picks
the collective an interval from the candidate census, as the reference
does, and records it in ``stats.comm_history`` and ``comm_bytes``.

The engine takes a host :class:`Graph` or a
:class:`repro_torch.core.pipeline.DeviceEdges`; the latter is staged on the
card in place (``stats.edge_staging``).  For many graphs,
:func:`minimum_spanning_forests` runs a whole shape bucket as ``(B, ·)``
tensors: packed rounds with a per-interval contraction where the bucket's
packing fits 64 bits, else :func:`_one_round` over the flattened bucket
(one election call, so one K1 launch, a round for every lane).

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
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import runtime
from repro_torch.core import union_find
from repro_torch.core.graph import PAD_VERTEX, Graph
from repro_torch.core.kruskal_ref import ForestResult
from repro_torch.core.params import DEFAULT_PARAMS, GHSParams
from repro_torch.core.partition import pow2ceil
from repro_torch.kernels.segment_min import ops as segops
from repro_torch.kernels.spmv_minplus import ops as spmv_ops
from repro_torch.sharding import collectives

INF_KEY = keys_lib.INF_KEY
INF32 = keys_lib.INF32           # flipped int32 "no edge" lane (INT32_MAX)
REF_INF32 = 0xFFFFFFFF           # the same lane as the reference's uint32
_PAD_SLOT = 0x7FFF0000   # compaction padding slot: never a live edge


@dataclasses.dataclass
class BoruvkaStats(runtime.EngineStats):
    rounds: int = 0
    compactions: int = 0
    edges_scanned: int = 0          # Σ active (padded) edge slots per round
    active_history: tuple = ()      # active edges after each interval (the
                                    # device loop: the largest shard's)
    comm_history: tuple = ()        # device loop: one (mode, cand_cap,
                                    # rounds, bytes) a consumed interval;
                                    # mode "pmin" or "compressed"


def _take(labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``labels[idx]`` with the index clamped into range, as the
    reference's gathers clamp (a ``PAD_VERTEX`` endpoint reads the last
    label, so a padding edge is a self-loop)."""
    return labels[idx.clamp(max=labels.shape[0] - 1)]


def _make_pmin(num_shards: int, collective: str, cand_cap: Optional[int]):
    """``pmin(x, default)`` of the round bodies over ``(S, n)`` per-shard
    values, returning the replicated ``(n,)``: the one row with one shard,
    the dense min for ``collective="pmin"`` (or no cap), else the
    compressed delta exchange with ``cand_cap``.  ``default`` is what a
    shard holds where its edges improved nothing."""
    if num_shards == 1:
        return lambda x, default=None: x[0]
    if collective != "compressed" or cand_cap is None:
        return lambda x, default=None: collectives.pmin(x)

    def pmin(x, default):
        return collectives.pmin_compressed(x, default=default, cap=cand_cap,
                                           num_shards=num_shards)
    return pmin


def _shard_offsets(num_shards: int, n: int, device) -> torch.Tensor:
    """(S, 1) int32 offsets ``s · n`` that give each shard its own run of
    ``n`` segments in one flattened election."""
    return (torch.arange(num_shards, dtype=torch.int32, device=device)
            * n)[:, None]


def _one_round(comp, mask, src, dst, key, slot, *, use_pallas: bool,
               lanes: int):
    """One Borůvka round of a flattened bucket of ``lanes`` graphs (labels
    and slots offset per lane, see :func:`_run_interval_batch`): fused MOE
    election, winner recording, merging.  ``mask`` is the per-slot tree
    bitmap with one extra slot at the end.  The election is one call for
    every lane, and ``done`` comes back per lane.
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
    # A lane's forest spans n // lanes labels: its doubling steps suffice.
    parent = union_find.pointer_double(
        parent, union_find.doubling_steps(n // lanes))
    return parent[comp], mask, (best == INF_KEY).view(lanes, -1).all(1)


def _one_round_sharded(comp, mask, src, dst, key, slot, *, pmin,
                       use_pallas: bool):
    """One round of the single-graph engine over S shards: fused MOE
    election, winner recording, merging.

    ``comp`` (n,) is replicated; the edges are ``(S, B)`` and ``slot``
    counts within each shard's block of the flat bitmap ``mask`` (S
    blocks, one extra slot at the end).  The election is one call over all
    rows, shard s's segments offset by ``s · n``; its ``(S, n)`` result
    and the per-shard hook parents each go through ``pmin``.
    """
    S = src.shape[0]
    n = comp.shape[0]
    block = (mask.shape[0] - 1) // S
    off = _shard_offsets(S, n, comp.device)
    cs = _take(comp, src)
    cd = _take(comp, dst)
    alive = (cs != cd) & (key != INF_KEY)
    k = torch.where(alive, key, INF_KEY)
    best = segops.segment_min64(torch.cat([k, k], 1).view(-1),
                                torch.cat([cs + off, cd + off], 1).view(-1),
                                num_segments=S * n, use_pallas=use_pallas)
    best = pmin(best.view(S, n), INF_KEY)
    winners = alive & ((best[cs] == k) | (best[cd] == k))
    base = torch.arange(S, device=comp.device)[:, None] * block
    mask.index_fill_(0, torch.where(winners, slot.to(torch.int64) + base,
                                    S * block).view(-1), True)
    parent = union_find.hook_min(n, torch.maximum(cs, cd),
                                 torch.minimum(cs, cd), winners)
    parent = pmin(parent, torch.arange(n, dtype=torch.int32,
                                       device=comp.device))
    parent = union_find.pointer_double(parent)
    return parent[comp], mask, (best == INF_KEY).all()


def _one_round_fused(comp, mask, src, dst, key, csrc, cdst, *, pmin,
                     lowering: str, sort_bits):
    """One Borůvka round as the fused masked min-plus election.

    The edges are ``(S, B)``; the election is one call over all rows
    (shard s's segments offset by ``s · n``; ``sort_bits`` fits ``S · n``
    segments), then one ``pmin`` of the ``(S, n)`` result.  The elected
    ``best[f]`` names the winning edge (its id lane is the canonical edge
    id), so winner recording writes a replicated canonical-id bitmap (one
    extra slot at the end) at fragment scale, and the merge partner comes
    from the canonical endpoints ``csrc``/``cdst``.  Shortcut and relabel
    fuse into one call on the replicated labels.
    """
    S = src.shape[0]
    n = comp.shape[0]
    m = mask.shape[0] - 1
    off = _shard_offsets(S, n, comp.device)
    cs = _take(comp, src)
    cd = _take(comp, dst)
    best = spmv_ops.elect((cs + off).view(-1), (cd + off).view(-1),
                          key.reshape(-1), num_segments=S * n,
                          lowering=lowering, sort_bits=sort_bits)
    best = pmin(best.view(S, n), INF_KEY)
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
    ``(done, rounds run, active edges, touched fragments)``, the last two
    of the shard that has most (the reference's ``pmax`` censuses).
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
    # fragments touched by active edges (the candidate census that caps
    # the compressed exchange), each shard's in its own run of n.
    S, n = src.shape[0], comp.shape[0]
    off = _shard_offsets(S, n, dev).to(torch.int64)
    cs = _take(comp, src)
    cd = _take(comp, dst)
    active = (cs != cd) & (key != INF_KEY)
    touched = torch.zeros(S * n + 1, dtype=torch.bool, device=dev)
    for c in (cs, cd):
        touched.index_fill_(0, torch.where(active, c + off, S * n).view(-1),
                            True)
    scalars = torch.stack([done.to(torch.int64), r, active.sum(1).max(),
                           touched[:S * n].view(S, n).sum(1).max()])
    return comp, mask, runtime.Readback(scalars)


def _device_engine(source, params: GHSParams, device: torch.device,
                   max_rounds: Optional[int],
                   num_shards: int = 1) -> tuple[ForestResult, BoruvkaStats]:
    S = num_shards
    if isinstance(source, Graph):
        # Host weights may be anything; the pipeline's lie in (0, 1) by
        # construction, so only a host Graph needs the sentinel check.
        if np.any(source.weight.view(np.uint32) == REF_INF32):
            raise ValueError("weights collide with the INF sentinel")
    bundle = runtime.prepare_edges(source, params.partitioner, chunk=8 * S,
                                   device=device, num_shards=S)
    n, m = bundle.num_vertices, bundle.num_edges
    layout = bundle.layout
    comp = torch.arange(n, dtype=torch.int32, device=device)

    fused = runtime.resolve_round_kernel(params.round_kernel) == "pallas"
    collective = runtime.resolve_collective(params.collective)
    if fused:
        if not m:
            csrc = cdst = torch.zeros(1, dtype=torch.int32, device=device)
        elif bundle.staging == "device":
            # The DeviceEdges buffers' live prefixes ARE the canonical
            # endpoints: no upload from the host mirror.
            csrc, cdst = bundle.src[:m], bundle.dst[:m]
        else:
            g_host = bundle.graph()
            csrc = torch.from_numpy(g_host.src).to(device)
            cdst = torch.from_numpy(g_host.dst).to(device)
        mask = torch.zeros(m + 1, dtype=torch.bool, device=device)
        sort_bits = spmv_ops.sort_gate(n, m)
        if sort_bits is not None and np.any(
                bundle.graph().weight.view(np.uint32)
                >= spmv_ops.WEIGHT_LIMIT_BITS):
            sort_bits = None   # weights outside (0, 1): no sort key
        lowering = ("pallas" if params.use_pallas
                    else "sort" if sort_bits is not None else "scatter")
        sb = sort_bits if lowering == "sort" else None
        if sb is not None and S > 1:
            # One election over S · n segments: the sort word needs their
            # bits; where it has none, the scatter election (the same
            # exact min) runs instead.
            sb = spmv_ops.sort_gate(S * n, m)
            lowering = "sort" if sb is not None else "scatter"

        def make_round(pmin):
            def round_fn(comp, mask, src, dst, key, slot):
                return _one_round_fused(comp, mask, src, dst, key, csrc,
                                        cdst, pmin=pmin, lowering=lowering,
                                        sort_bits=sb)
            return round_fn
    else:
        mask = torch.zeros(layout.num_slots + 1, dtype=torch.bool,
                           device=device)

        def make_round(pmin):
            def round_fn(comp, mask, src, dst, key, slot):
                return _one_round_sharded(comp, mask, src, dst, key, slot,
                                          pmin=pmin,
                                          use_pallas=params.use_pallas)
            return round_fn

    overlap = (runtime.resolve_interval_pipeline(
        params.interval_pipeline) == 1)
    interval = max(params.check_frequency, 1)
    cap_rounds = max_rounds or (n + 2)
    stats = BoruvkaStats()
    stats.edge_staging = bundle.staging
    history = []
    comm_hist = []
    # Value lanes of a round's reductions, for the wire model: the xla
    # body exchanges best (8 bytes) and the hook parents (4); the fused
    # body has one collective, best only.
    value_bytes = (8,) if fused else (8, 4)
    # cand_bound: a bound on any shard's candidates a round for the next
    # dispatch, from the last interval's touched-fragment census (which
    # never grows, so it stays valid one interval late under overlap);
    # before any census, each local edge touches at most two fragments.
    box = dict(cur_block=layout.block, dispatched=0, inflight=[],
               cand_bound=min(n, 2 * layout.block))

    def pick():
        """The next interval's collective and wire model: the compressed
        exchange with the census-derived cap where its bytes beat the
        dense pmin's, else the dense pmin (equal results either way)."""
        full_b = sum(collectives.dense_bytes(n, S, vb) for vb in value_bytes)
        if S > 1 and collective == "compressed":
            cand_cap = max(pow2ceil(box["cand_bound"]), 8)
            comp_b = sum(collectives.compressed_bytes(cand_cap, S, vb)
                         for vb in value_bytes)
            if comp_b < full_b:
                return "compressed", cand_cap, comp_b
        return "pmin", 0, full_b

    def dispatch(s):
        comp, mask, edges = s
        # Clamp by the DISPATCHED total: under overlap a dispatch happens
        # before the previous interval's readback is consumed.
        this_rounds = max(min(interval, cap_rounds - box["dispatched"]), 0)
        mode, cand_cap, bytes_per_round = pick()
        round_fn = make_round(_make_pmin(S, mode, cand_cap or None))
        comp, mask, readback = _run_interval(comp, mask, edges, this_rounds,
                                             round_fn)
        box["dispatched"] += this_rounds
        box["inflight"].append((mode, cand_cap, box["cur_block"],
                                bytes_per_round))
        return (comp, mask, edges), readback

    def finish(s, vals):
        done_v, r, n_act, n_cand = vals
        mode, cand_cap, blk, bytes_per_round = box["inflight"].pop(0)
        stats.rounds += r
        stats.edges_scanned += r * blk * S
        stats.comm_bytes += r * bytes_per_round
        comm_hist.append((mode, cand_cap, r, r * bytes_per_round))
        history.append(n_act)
        box["cand_bound"] = max(min(n, n_cand), 1)
        if done_v:
            return s, True
        if params.compaction == "pow2":
            new_block = max(pow2ceil(n_act), 8)
            if new_block < box["cur_block"]:
                comp, mask, edges = s
                edges = _compact_lanes(comp.expand(S, n), *edges,
                                       cap=new_block)
                s = (comp, mask, edges)
                box["cur_block"] = new_block
                stats.compactions += 1
        return s, False

    # One row a shard: row s is shard s's block of the layout.
    edges = tuple(t.view(S, layout.block) for t in (
        bundle.src, bundle.dst, bundle.key, bundle.slot))
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
    res = runtime.forest_from_mask(bundle.graph(), tree, num_components=ncomp)
    res.check_consistent(n)
    stats.active_history = tuple(history)
    stats.comm_history = tuple(comm_hist)
    return res, stats


# ---------------------------------------------------------------------------
# Batched multi-graph engine: a whole shape bucket as (B, ·) tensors
# ---------------------------------------------------------------------------
# The reference maps a lane function under ``jax.vmap``; here every tensor of
# a bucket carries the lane as its leading dim: gathers and scatters run
# along dim 1, sorts along the last dim, and no Python loop runs over lanes.
# The winner bitmap is one flat ``(B·cap + 1,)`` buffer: lane r's slot s is
# entry ``r·cap + s`` and the last entry is the dropped-write slot.

@dataclasses.dataclass
class BatchStats(BoruvkaStats):
    """Stats of a batched solve: ``rounds_per_graph`` (runtime protocol) in
    input order, ``bucket_shapes`` one ``(n_pad, cap, batch_size)`` per
    dispatched bucket.  :meth:`merge` sums a sub-solve's ledger (one bucket,
    or one single-graph run of the host-loop fallback)."""

    buckets: int = 0
    bucket_shapes: tuple = ()

    def merge(self, st: BoruvkaStats) -> None:
        self.host_syncs += st.host_syncs
        self.intervals += st.intervals
        self.extra_syncs += st.extra_syncs
        self.rounds += st.rounds
        self.compactions += st.compactions
        self.edges_scanned += st.edges_scanned
        self.active_history += st.active_history
        self.overlapped_syncs += st.overlapped_syncs
        self.speculative_intervals += st.speculative_intervals
        self.comm_bytes += st.comm_bytes
        self.comm_history += st.comm_history


def _lane_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Endpoints as int64 gather indices clamped to the lane's last label,
    as the reference's gathers clamp (a padding edge is a self-loop)."""
    return idx.clamp(max=n - 1).to(torch.int64)


def _lane_labels(comp: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    return torch.gather(comp, 1, si).to(torch.int64)


def _one_round_packed(comp, mask, si, di, key, live, *, s_bits: int,
                      c_bits: int, election: str):
    """One Borůvka round of a packed bucket (every lane in the identity
    layout, slot == canonical id).

    The election value packs (weight-bits ‖ edge-id ‖ other fragment), so
    each fragment's elected value names its winning slot and its merge
    partner: recording and hooking run at fragment scale.  ``"scatter"``
    elects by a scatter-min; ``"sort"`` prepends the electing fragment
    (``2·s_bits + 30 + c_bits ≤ 64``, the contraction gate), sorts each
    lane and probes each fragment's run with ``searchsorted``.  Both stay
    in the flipped domain, since the sort word can fill 64 bits.  Lanes
    not ``live`` record nothing.  Returns ``(comp, mask, done per lane)``.
    """
    lsr, flip = keys_lib.lsr, keys_lib.SIGN
    bsz, n = comp.shape
    cap = (mask.shape[0] - 1) // bsz
    cs = _lane_labels(comp, si)
    cd = _lane_labels(comp, di)
    alive = (cs != cd) & (key != INF_KEY)
    u = keys_lib.unflip(key)
    base = ((lsr(u, 32) << (c_bits + s_bits))
            | ((u & keys_lib.LANE_MASK) << s_bits))
    frag = torch.arange(n, dtype=torch.int64, device=comp.device)
    if election == "sort":
        shift = 30 + c_bits + s_bits

        def side(seg, oth):
            return torch.where(alive, ((seg << shift) | base | oth) ^ flip,
                               INF_KEY)

        sk = torch.sort(torch.cat([side(cs, cd), side(cd, cs)], 1),
                        dim=-1).values
        m2 = sk.shape[1]
        probe = ((frag << shift) ^ flip).expand(bsz, n).contiguous()
        pos = torch.searchsorted(sk, probe)
        cand = torch.gather(sk, 1, pos.clamp(max=m2 - 1))
        cu = keys_lib.unflip(cand)
        found = (pos < m2) & (lsr(cu, shift) == frag) & (cand != INF_KEY)
        best = torch.where(found, (cu & ((1 << shift) - 1)) ^ flip, INF_KEY)
    else:
        val = torch.cat([torch.where(alive, (base | cd) ^ flip, INF_KEY),
                         torch.where(alive, (base | cs) ^ flip, INF_KEY)], 1)
        best = torch.full((bsz, n), INF_KEY, dtype=torch.int64,
                          device=comp.device)
        best.scatter_reduce_(1, torch.cat([cs, cd], 1), val, "amin")
    elected = best != INF_KEY
    bu = keys_lib.unflip(best)               # garbage where not elected
    best_eid = lsr(bu, s_bits) & ((1 << c_bits) - 1)
    other = bu & ((1 << s_bits) - 1)
    lane = torch.arange(bsz, dtype=torch.int64, device=comp.device)[:, None]
    mask.index_fill_(0, torch.where(elected & live[:, None],
                                    best_eid + lane * cap,
                                    bsz * cap).view(-1), True)
    parent = union_find.hook_min(n, torch.maximum(frag, other),
                                 torch.minimum(frag, other), elected)
    parent = union_find.pointer_double(parent)
    return (torch.gather(parent, 1, comp.to(torch.int64)), mask,
            ~elected.any(1))


def _contract_lanes(comp, si, di, key, *, s_bits: int, c_bits: int):
    """Borůvka contraction of every lane, sort-based and scatter-free.

    Endpoints become fragment labels and parallel cross-fragment edges
    collapse to the min-key edge of each fragment pair; a dropped edge can
    never be any fragment's minimum outgoing edge, so no later election
    changes.  The (lo, hi, weight-bits, edge-id) quadruple packs into one
    64-bit word (flipped), so it is two key-only sorts: pair grouping, then
    survivors to the front.  Returns the new edge arrays and each lane's
    surviving count.
    """
    lsr, flip = keys_lib.lsr, keys_lib.SIGN
    bsz = comp.shape[0]
    cu = _lane_labels(comp, si)
    cd = _lane_labels(comp, di)
    alive = (cu != cd) & (key != INF_KEY)
    u = keys_lib.unflip(key)
    packed = ((torch.minimum(cu, cd) << (c_bits + 30 + s_bits))
              | (torch.maximum(cu, cd) << (c_bits + 30))
              | (lsr(u, 32) << c_bits) | (u & keys_lib.LANE_MASK))
    pk = torch.sort(torch.where(alive, packed ^ flip, INF_KEY), dim=-1).values
    pair = lsr(keys_lib.unflip(pk), c_bits + 30)
    head = torch.ones((bsz, 1), dtype=torch.bool, device=comp.device)
    first = (pk != INF_KEY) & torch.cat([head, pair[:, 1:] != pair[:, :-1]], 1)
    kept = torch.sort(torch.where(first, pk, INF_KEY), dim=-1).values
    dead = kept == INF_KEY
    ku = keys_lib.unflip(kept)
    eid = ku & ((1 << c_bits) - 1)
    wb = lsr(ku, c_bits) & ((1 << 30) - 1)
    hi = lsr(ku, c_bits + 30) & ((1 << s_bits) - 1)
    lo = lsr(ku, c_bits + 30 + s_bits)
    pad = int(PAD_VERTEX)
    return (torch.where(dead, pad, lo).to(torch.int32),
            torch.where(dead, pad, hi).to(torch.int32),
            torch.where(dead, INF_KEY, ((wb << 32) | eid) ^ flip),
            torch.where(dead, _PAD_SLOT, eid).to(torch.int32),
            first.sum(1))


def _rounds_to_converge(n_pad: int) -> int:
    """Rounds after which every lane of an ``n_pad``-vertex bucket is done,
    from any state: a round with a live edge merges every fragment that
    has one with at least one other, so a component's fragments halve
    each round (at most ceil(log2 n_pad) such rounds), and the round
    after elects nothing; one round more is kept as a margin."""
    return (max(n_pad, 1) - 1).bit_length() + 2


def _run_interval_batch(comp, mask, src, dst, key, slot, done, rdone,
                        rounds: int, *, use_pallas: bool,
                        contract_bits, election: str = "scatter"):
    """Queue ``rounds`` Borůvka rounds for a whole bucket.

    State: ``comp`` (B, n_pad) int32 lane-local labels, the flat bitmap
    ``mask``, the (B, cur_cap) edge arrays, ``done`` (B,) and ``rdone`` (B,)
    each lane's rounds so far.  A lane that is done is frozen (its labels
    and bitmap stay), so each lane follows the single-graph trajectory.
    The rounds are queued, at most ``_rounds_to_converge(n_pad)`` of them
    (any further one could change nothing); ``r`` counts those started
    while some lane was live, as the reference's loop stops at the first
    round with all done.

    ``contract_bits = (s_bits, c_bits)``: packed rounds
    (:func:`_one_round_packed`), then a per-lane :func:`_contract_lanes`
    in place; the census is the largest surviving count.  ``None`` (the
    packing does not fit 64 bits): :func:`_one_round` over the flattened
    bucket, labels offset by ``lane · n_pad`` and slots by ``lane · cap``,
    so each round is ONE election call (one kernel launch with
    ``use_pallas``) over all lanes; the census is the largest active count.

    Returns the new state and a :class:`runtime.Readback` of
    ``(all done, r, census)`` — nothing in here waits for the host.
    """
    bsz, n = comp.shape
    dev = comp.device
    rounds = min(rounds, _rounds_to_converge(n))   # later ones change nothing
    si = _lane_index(src, n)
    di = _lane_index(dst, n)
    if contract_bits is not None:
        s_bits, c_bits = contract_bits

        def step(comp, mask, live):
            return _one_round_packed(comp, mask, si, di, key, live,
                                     s_bits=s_bits, c_bits=c_bits,
                                     election=election)
    else:
        cap = (mask.shape[0] - 1) // bsz
        lane = torch.arange(bsz, dtype=torch.int64, device=dev)[:, None]
        off = (lane * n).to(torch.int32)
        src_g = (si + lane * n).to(torch.int32).view(-1)
        dst_g = (di + lane * n).to(torch.int32).view(-1)
        slot_g = (slot.to(torch.int64) + lane * cap).view(-1)
        key_g = key.reshape(-1)

        def step(comp, mask, live):
            comp_g, mask, lane_done = _one_round(
                (comp + off).view(-1), mask, src_g, dst_g, key_g, slot_g,
                use_pallas=use_pallas, lanes=bsz)
            return comp_g.view(bsz, n) - off, mask, lane_done

    r = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(rounds):
        live = ~done
        r = r + live.any()
        comp2, mask, done2 = step(comp, mask, live)
        comp = torch.where(live[:, None], comp2, comp)
        rdone = rdone + live
        done = done | done2

    if contract_bits is not None:
        src, dst, key, slot, counts = _contract_lanes(
            comp, si, di, key, s_bits=s_bits, c_bits=c_bits)
        census = counts.max()
    else:
        active = ((_lane_labels(comp, si) != _lane_labels(comp, di))
                  & (key != INF_KEY))
        census = active.sum(1).max()
    readback = runtime.Readback(torch.stack([done.all().to(torch.int64), r,
                                             census]))
    return (comp, mask, src, dst, key, slot, done, rdone), readback


def _compact_lanes(comp, src, dst, key, slot, *, cap: int):
    """Per-lane prefix-sum stream compaction to ``cap`` slots (the
    fallback's shrink): survivors slide to the front with their load-time
    ``slot``; the tail refills with the padding sentinels."""
    bsz, n = comp.shape
    si = _lane_index(src, n)
    di = _lane_index(dst, n)
    keep = ((_lane_labels(comp, si) != _lane_labels(comp, di))
            & (key != INF_KEY))
    idx = torch.where(keep, torch.cumsum(keep, 1) - 1, cap)

    def put(fill, vals):
        out = torch.full((bsz, cap + 1), fill, dtype=vals.dtype,
                         device=vals.device)
        out.scatter_(1, idx, vals)
        return out[:, :cap].contiguous()

    return (put(int(PAD_VERTEX), src), put(int(PAD_VERTEX), dst),
            put(INF_KEY, key), put(_PAD_SLOT, slot))


def _shrink_lanes(edges, cap: int):
    """Cut every lane's front-packed (contracted) edge arrays to ``cap``."""
    return tuple(t[:, :cap].contiguous() for t in edges)


def _gate_bits(n_pad: int, cap: int):
    """(s_bits, c_bits) of an ``(n_pad, cap)`` bucket when its contraction
    quadruple fits one 64-bit word (``2·s_bits + 30 + c_bits ≤ 64``), else
    None."""
    s_bits = max(n_pad - 1, 1).bit_length()
    c_bits = max(cap - 1, 1).bit_length()
    if 2 * s_bits + 30 + c_bits > 64:
        return None
    return (s_bits, c_bits)


def _lattice_contract_bits(params: GHSParams):
    """Uniform (s_bits, c_bits) of a bounded serving lattice: with
    ``batch_max_vertices``/``batch_max_edges`` set, every bucket's packed
    rounds may use the lattice top's wider shifts (labels < n_pad ≤ n_top,
    slots < cap ≤ cap_top, the 64-bit gate checked at the top)."""
    if (params.compaction != "pow2" or not params.batch_max_vertices
            or not params.batch_max_edges):
        return None
    n_top = pow2ceil(int(params.batch_max_vertices))
    cap_top = pow2ceil(max(int(params.batch_max_edges), 8))
    return _gate_bits(n_top, cap_top)


def _widen_contract_bits(contract_bits, params: GHSParams):
    """A bucket's own contraction bits, promoted to the lattice top's when
    the params define a lattice that covers them."""
    if contract_bits is None:
        return None
    lat = _lattice_contract_bits(params)
    if (lat is not None and lat[0] >= contract_bits[0]
            and lat[1] >= contract_bits[1]):
        return lat
    return contract_bits


def _weight_lanes(key: np.ndarray) -> np.ndarray:
    """Weight-bits lane (uint64) of the port's flipped int64 keys."""
    return keys_lib.to_reference(key) >> np.uint64(32)


def _contract_gate(batch):
    """(s_bits, c_bits) when the bucket's contraction quadruple fits one
    64-bit word — labels ``log2(n_pad)`` bits each, weight bits 30 (every
    real weight below 2.0, checked on the keys), the canonical id
    ``log2(cap)`` — else None (the unpacked fallback)."""
    bits = _gate_bits(batch.n_pad, batch.cap)
    if bits is None:
        return None
    real = batch.key != INF_KEY
    if np.any(real & (_weight_lanes(batch.key) >= np.uint64(1 << 30))):
        return None
    return bits


def _bucket_plan(params: GHSParams, contract_bits, key=None):
    """Widened contraction bits and the election of a bucket: ``"sort"``
    under ``round_kernel="pallas"`` when the bucket passes the gate and
    every real weight lies below 1.0 (``key`` None: assumed, as for
    pipeline weights), else ``"scatter"``."""
    contract_bits = _widen_contract_bits(contract_bits, params)
    election = "scatter"
    if (runtime.resolve_round_kernel(params.round_kernel) == "pallas"
            and contract_bits is not None):
        if key is None or not np.any(
                (key != INF_KEY) & (_weight_lanes(key)
                                    >= np.uint64(spmv_ops.WEIGHT_LIMIT_BITS))):
            election = "sort"
    return contract_bits, election


def _solve_bucket(batch, params: GHSParams, max_rounds: Optional[int],
                  device: torch.device):
    """Run one shape bucket through the batched device round loop."""
    n_pad, cap, bsz = batch.n_pad, batch.cap, batch.batch_size
    contract_bits = (_contract_gate(batch)
                     if params.compaction == "pow2" else None)
    contract_bits, election = _bucket_plan(params, contract_bits, batch.key)

    def put(a):
        return torch.from_numpy(a).to(device)

    comp = torch.arange(n_pad, dtype=torch.int32, device=device).repeat(bsz, 1)
    mask = torch.zeros(bsz * cap + 1, dtype=torch.bool, device=device)
    done = torch.zeros(bsz, dtype=torch.bool, device=device)
    rdone = torch.zeros(bsz, dtype=torch.int64, device=device)
    state = (comp, mask, put(batch.src), put(batch.dst), put(batch.key),
             put(batch.slot), done, rdone)

    overlap = (runtime.resolve_interval_pipeline(
        params.interval_pipeline) == 1)
    interval = max(params.batch_check_frequency, 1)
    cap_rounds = max_rounds or (n_pad + 2)
    stats = BatchStats(buckets=1, bucket_shapes=((n_pad, cap, bsz),))
    history = []
    box = dict(cur_cap=cap, dispatched=0, inflight=[])

    def dispatch(s):
        this_rounds = max(min(interval, cap_rounds - box["dispatched"]), 0)
        s, readback = _run_interval_batch(
            *s, this_rounds, use_pallas=params.use_pallas,
            contract_bits=contract_bits, election=election)
        box["dispatched"] += this_rounds
        box["inflight"].append(box["cur_cap"])
        return s, readback

    def finish(s, vals):
        all_done, r, census = vals
        stats.rounds += r
        stats.edges_scanned += r * box["inflight"].pop(0) * bsz
        history.append(census)
        if all_done:
            return s, True
        if params.compaction == "pow2":
            new_cap = max(pow2ceil(census), 8)
            if new_cap < box["cur_cap"]:
                comp, mask, *edges, done, rdone = s
                if contract_bits is not None:
                    # Contraction packed the survivors to the front.
                    edges = _shrink_lanes(edges, new_cap)
                else:
                    edges = _compact_lanes(comp, *edges, cap=new_cap)
                s = (comp, mask, *edges, done, rdone)
                box["cur_cap"] = new_cap
                stats.compactions += 1
        return s, False

    state = runtime.interval_loop(
        state, dispatch, finish, stats=stats, max_intervals=cap_rounds,
        fail_msg="batched Borůvka engine failed to converge",
        overlap=overlap)

    # The bucket's one final fetch: the rounds and the bitmap, one buffer.
    mask, rdone = state[1], state[7]
    raw = torch.cat([rdone.view(torch.uint8),
                     mask[:-1].view(torch.uint8)]).cpu().numpy()
    stats.host_syncs += 1
    stats.extra_syncs += 1
    results = batch.unpack(raw[8 * bsz:].view(bool).reshape(bsz, cap))
    stats.active_history = tuple(history)
    stats.rounds_per_graph = tuple(int(x) for x in raw[:8 * bsz].view(np.int64))
    return results, stats


def warm_bucket(batch_size: int, n_pad: int, cap: int,
                params: GHSParams = DEFAULT_PARAMS, device=None) -> int:
    """Run every interval and shrink a ``(batch_size, n_pad, cap)`` bucket
    can reach, on all-ghost lanes, so each kernel it launches is built and
    each buffer size allocated before the first real solve.

    The ladder is the reference's: the interval at the load cap and at
    every power-of-two compaction cap below it (none when one dispatch
    runs ``n_pad + 2`` rounds, so every lane converges before a shrink),
    and the shrinks between them.  The contraction gate and the election
    are taken as for (0, 1) weights.  Returns the reference's count: one
    per interval and shrink.
    """
    dev = runtime.resolve_device(device)
    bsz = int(batch_size)
    contract_bits = (_gate_bits(n_pad, cap)
                     if params.compaction == "pow2" else None)
    contract_bits, election = _bucket_plan(params, contract_bits)
    caps = [cap]
    if params.batch_check_frequency < n_pad + 2:
        c = 8
        while c * 2 < cap:
            c *= 2
        while 8 <= c < cap:
            caps.append(c)
            c //= 2
    count = 0
    pad = int(PAD_VERTEX)
    for cur in caps:
        state, readback = _run_interval_batch(
            torch.arange(n_pad, dtype=torch.int32, device=dev).repeat(bsz, 1),
            torch.zeros(bsz * cap + 1, dtype=torch.bool, device=dev),
            torch.full((bsz, cur), pad, dtype=torch.int32, device=dev),
            torch.full((bsz, cur), pad, dtype=torch.int32, device=dev),
            torch.full((bsz, cur), INF_KEY, dtype=torch.int64, device=dev),
            torch.from_numpy(partition_lib.batched_slots(bsz, cur)).to(dev),
            torch.zeros(bsz, dtype=torch.bool, device=dev),
            torch.zeros(bsz, dtype=torch.int64, device=dev),
            1, use_pallas=params.use_pallas, contract_bits=contract_bits,
            election=election)
        readback.get()
        count += 1
        for new in caps:
            if new < cur:
                _shrink_lanes(state[2:6], new)
                count += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return count


def solve_packed(batch, params: GHSParams = DEFAULT_PARAMS,
                 max_rounds: Optional[int] = None, device=None):
    """Solve ONE pre-packed shape bucket (:func:`pipeline.pack_bucket`).

    Results come back in lane order; each forest is bit-identical to the
    single-graph solve.  Device loop only.
    """
    dev = runtime.resolve_device(device)
    if runtime.resolve_round_loop(params.round_loop) != "device":
        raise ValueError(
            "solve_packed requires round_loop='device'; the host loop "
            "solves graphs one at a time via minimum_spanning_forest")
    for r, g in enumerate(batch.graphs):
        if np.any(g.weight.view(np.uint32) == REF_INF32):
            raise ValueError(
                f"lane {r}: weights collide with the INF sentinel")
    return _solve_bucket(batch, params, max_rounds, dev)


def minimum_spanning_forests(graphs, params: GHSParams = DEFAULT_PARAMS,
                             max_rounds: Optional[int] = None, device=None):
    """Solve many graphs, a shape bucket per dispatch.

    Graphs (``Graph`` or ``DeviceEdges``, the latter through their host
    mirror) are bucketed by padded shape (:func:`pipeline.pack_batch` under
    ``params.batch_bucket``, capacity-guarded) and each bucket runs the
    batched round loop: one dispatch and one scalar readback per interval
    for the whole bucket, one final fetch per bucket.  Results come back in
    input order, each forest and round count equal to the single-graph
    solve's.  ``params.round_loop == "host"`` falls back to a loop of
    single host-loop solves.
    """
    dev = runtime.resolve_device(device)
    graph_list = [runtime.as_graph(g) for g in graphs]
    for i, g in enumerate(graph_list):
        if np.any(g.weight.view(np.uint32) == REF_INF32):
            raise ValueError(
                f"graph {i}: weights collide with the INF sentinel")
    # Bucket and validate first: the policy and the capacity guards reject
    # bad inputs on both loop drivers.
    batches = pipeline_lib.pack_batch(
        graph_list, bucket=params.batch_bucket,
        max_vertices=params.batch_max_vertices or None,
        max_edges=params.batch_max_edges or None)

    stats = BatchStats()
    if runtime.resolve_round_loop(params.round_loop) == "host":
        results, rounds = [], []
        for g in graph_list:
            res, st = _host_engine(g, params, dev, max_rounds)
            results.append(res)
            rounds.append(st.rounds)
            stats.merge(st)
        stats.rounds_per_graph = tuple(rounds)
        return results, stats

    results: list = [None] * len(graph_list)
    rounds = [0] * len(graph_list)
    shapes = []
    for batch in batches:
        bres, bst = _solve_bucket(batch, params, max_rounds, dev)
        for idx, res, r in zip(batch.indices, bres, bst.rounds_per_graph):
            results[idx] = res
            rounds[idx] = r
        stats.merge(bst)
        shapes.extend(bst.bucket_shapes)
    stats.buckets = len(batches)
    stats.bucket_shapes = tuple(shapes)
    stats.rounds_per_graph = tuple(rounds)
    return results, stats


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


def _upload(arrs, chunk: int, device: torch.device,
            num_shards: int = 1) -> list:
    """The host loop's upload: ``(src, dst, wbits, eid)`` (numpy; the last
    two uint32) padded to a power-of-two multiple of ``chunk``, on
    ``device``, with the uint32 lanes as flipped int32, cut into
    ``num_shards`` equal rows."""
    s, d, w, e = _pad_pow2(arrs, chunk,
                           [PAD_VERTEX, PAD_VERTEX, REF_INF32, REF_INF32])
    return [torch.from_numpy(a).to(device).view(num_shards, -1) for a in
            (s, d, keys_lib.from_reference32(w), keys_lib.from_reference32(e))]


def _election_lanes(comp, src, dst, wbits):
    """The lanes a round elects over: endpoint labels ``cs``/``cd``, the
    ``alive`` mask and the weight lanes ``wb`` (INF where dead)."""
    cs = _take(comp, src)
    cd = _take(comp, dst)
    alive = (cs != cd) & (wbits != INF32)
    wb = torch.where(alive, wbits, INF32)
    return cs, cd, alive, wb


def _round_body(comp, src, dst, wbits, eid, *, use_pallas: bool = False):
    """One two-phase round: elect MOE per fragment, hook, compress, relabel.

    The edge lanes are ``(S, B)``, one row a shard; ``wbits``/``eid`` are
    flipped int32 lanes.  Each per-segment min runs once over all rows
    (shard s's segments offset by ``s · n``) and its ``(S, n)`` result is
    reduced across shards by a dense ``pmin``, as are the hook parents.
    Returns the new labels, the per-edge winner bitmap and the device
    ``done`` flag.  Per-segment mins are scatter-mins, or with
    ``use_pallas`` a sort and the 32-bit scan kernel.
    """
    S, n = src.shape[0], comp.shape[0]
    pmin = _make_pmin(S, "pmin", None)
    off = _shard_offsets(S, n, comp.device)

    def segmin(seg, val, order):
        return pmin(segops.segment_min(
            val.reshape(-1), seg, num_segments=S * n, use_pallas=use_pallas,
            order=order).view(S, n))

    cs, cd, alive, wb = _election_lanes(comp, src, dst, wbits)
    # One stable sorting permutation per endpoint array, reused by both
    # election phases.
    seg_s = (cs + off).view(-1)
    seg_d = (cd + off).view(-1)
    order_s = torch.sort(seg_s, stable=True).indices if use_pallas else None
    order_d = torch.sort(seg_d, stable=True).indices if use_pallas else None

    # Phase 1: best weight per fragment.
    bw = torch.minimum(segmin(seg_s, wb, order_s), segmin(seg_d, wb, order_d))

    # Phase 2: tie-break by unique edge id among weight-matching edges.
    cand_s = torch.where(alive & (wb == bw[cs]), eid, INF32)
    cand_d = torch.where(alive & (wb == bw[cd]), eid, INF32)
    be = torch.minimum(segmin(seg_s, cand_s, order_s),
                       segmin(seg_d, cand_d, order_d))

    # Winners: the elected MOE edges (each fragment elects exactly one).
    winners = alive & ((be[cs] == eid) | (be[cd] == eid))

    # Merge: min-hooking + pointer doubling.
    parent = pmin(union_find.hook_min(n, torch.maximum(cs, cd),
                                      torch.minimum(cs, cd), winners))
    parent = union_find.pointer_double(parent)
    new_comp = parent[comp]

    done = (bw == INF32).all()
    return new_comp, winners, done


def _host_engine(graph: Graph, params: GHSParams, device: torch.device,
                 max_rounds: Optional[int],
                 num_shards: int = 1) -> tuple[ForestResult, BoruvkaStats]:
    n, m = graph.num_vertices, graph.num_edges
    if n == 0:
        raise ValueError("the host loop needs a graph with vertices")
    S = num_shards
    chunk = 8 * S

    src, dst, wbits, eid = _host_lanes(graph)
    if np.any(wbits == REF_INF32):
        raise ValueError("weights collide with the INF sentinel")

    # The legacy loop tracks edges by canonical id end to end, so a
    # partitioner only sets the upload order: its edges of shard 0, then of
    # shard 1, ...; the padded upload is then cut into S equal rows, and a
    # compaction re-uploads the survivors the same way.
    part = partition_lib.get_partitioner(params.partitioner)
    if part.name != "block" and m:
        shard = part.edge_shard(graph, S)
        order = np.concatenate([np.flatnonzero(shard == s)
                                for s in range(S)]).astype(np.int64)
    else:
        order = np.arange(m, dtype=np.int64)

    round_fn = functools.partial(_round_body, use_pallas=params.use_pallas)
    stats = BoruvkaStats()

    def put_edges(arrs):
        stats.host_syncs += 1          # host→device re-upload
        stats.extra_syncs += 1
        return _upload(arrs, chunk, device, S)

    comp_dev = torch.arange(n, dtype=torch.int32, device=device)
    src_d, dst_d, wb_d, eid_d = put_edges(
        [src[order], dst[order], wbits[order], eid[order]])

    mask = np.zeros(m, dtype=bool)
    history = []
    cap = max_rounds or (n + 2)
    # Host mirror of the active edge set (for compaction + winner mapping).
    box = dict(active=order.copy())

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
        stats.edges_scanned += int(src_d.numel())
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
    """Run the Borůvka engine; returns the forest + stats.

    ``device=None`` runs on CUDA and raises when no card is present;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.  ``mesh``
    (a :class:`repro_torch.sharding.mesh.Mesh`) spreads the edges over its
    shards on its device, under ``params.partitioner`` and
    ``params.collective``.  ``params.round_loop`` picks the
    device-resident loop (the default) or the legacy host loop.  Every
    combination gives the same forest, and the JAX package's stats.
    """
    S, dev = runtime.resolve_mesh(mesh, device)
    runtime.resolve_collective(params.collective)
    if runtime.resolve_round_loop(params.round_loop) == "host":
        return _host_engine(runtime.as_graph(graph), params, dev, max_rounds,
                            S)
    return _device_engine(graph, params, dev, max_rounds, S)
