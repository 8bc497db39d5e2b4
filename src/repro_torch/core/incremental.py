"""Incremental MST for evolving graphs: batched inserts and deletes.

This module applies one :class:`EdgeBatch` of insertions and deletions to
a solved :class:`IncrementalForest` and returns the forest of the updated
graph, equal bit for bit to a solve from scratch, at a fraction of the
work.  The pass is the classical cycle/cut pair on the fragment-label
machinery (after Elkin & Goldenfeld's partwise aggregation, with the probe
batched as in Sanders & Schimek):

1. **Merge (host glue).**  :func:`apply_edge_batch` builds the updated
   graph: deletions remove canonical pairs, insertions go through the §3.1
   preprocessing semantics (self-loops dropped, the lightest copy of a
   pair wins, ties keep the surviving copy).  This construction defines
   the updated graph; the exact reference is a full solve of it.
2. **Anchor forest.**  ``F0`` = the old tree edges that survive with the
   same pair and weight.  A subset of a forest is a forest, and every F0
   edge is in the updated graph, so certificates over F0 hold there.
3. **Cycle probe (device).**  A non-F0 edge is provably non-MSF when its
   endpoints connect through strictly lighter edges.  Two certificates,
   both in the updated graph's packed-key space (sound under weight ties,
   where renumbered edge ids may flip old tie-breaks):

   * the quantized threshold levels of the filter pass, per-level labels
     over the F0 edges with key ≤ ``T_j``
     (:func:`repro_torch.kernels.spmv_minplus.ops.connected_labels`, level
     j warm-started from level j-1);
   * the max-key bound of
     :func:`repro_torch.kernels.spmv_minplus.ops.component_maxkey`, the
     same loop warm-started from the top level's labels: an edge inside
     one component whose key exceeds the component's largest tree key
     exceeds its path maximum.

4. **Cut probe (same pass).**  Deleting a tree edge severs its component;
   the replacement candidates are the non-F0 edges whose endpoints land
   in different F0 components.  No certificate drops them, the final
   solve elects the lightest across each cut, and ``replacement_probes``
   counts them.  The keep and cross masks come back in one read.
5. **Final solve.**  The Borůvka engine runs over the kept candidates
   (F0 and the uncertified edges) as a canonical subset
   (``partition.subgraph_by_mask`` / ``lift_mask`` keep the election
   order).  The candidates hold the updated MSF and that MSF is unique
   under the packed order, so the lifted forest equals the full solve's.

:func:`plan_updates` / :func:`finalize_plan` split the pass around the
final solve, so a server can solve many requests' candidates together
through ``minimum_spanning_forests``.

The merge and the joins are numpy host glue, as in the reference; the
labels and the probe run on the engine's device.  The label loop reads its
flag on the host: each read counts in ``host_syncs`` and ``extra_syncs``,
and in ``IncrementalStats.label_syncs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import boruvka_dist
from repro_torch.core import partition as partition_lib
from repro_torch.core import runtime
from repro_torch.core import keys as keys_lib
from repro_torch.core.filter_boruvka import (
    _below, _level_labels, _thresholds, _upload, shard_tree)
from repro_torch.core.graph import Graph, pair_ids, preprocess
from repro_torch.core.kruskal_ref import ForestResult
from repro_torch.core.params import DEFAULT_PARAMS, GHSParams
from repro_torch.kernels.spmv_minplus import ops as minplus_ops


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """One batched update: edge insertions (u, v, w) and deletions (u, v).

    Endpoints are vertex ids of the host graph (the vertex set is fixed);
    insert weights must lie in the engines' (0, 1) range.  Deletions name
    canonical pairs: deleting an absent pair is a no-op, as is inserting a
    self-loop.  A pair both deleted and inserted in one batch is deleted
    from the OLD graph first, then re-inserted.
    """

    insert_src: np.ndarray     # (I,) int32
    insert_dst: np.ndarray     # (I,) int32
    insert_weight: np.ndarray  # (I,) float32, in (0, 1)
    delete_src: np.ndarray     # (D,) int32
    delete_dst: np.ndarray     # (D,) int32

    @classmethod
    def make(cls, inserts=(), deletes=()) -> "EdgeBatch":
        """Build from sequences of ``(u, v, w)`` / ``(u, v)`` tuples."""
        ins = np.asarray(list(inserts), dtype=np.float64).reshape(-1, 3)
        dels = np.asarray(list(deletes), dtype=np.int64).reshape(-1, 2)
        return cls(
            insert_src=ins[:, 0].astype(np.int32),
            insert_dst=ins[:, 1].astype(np.int32),
            insert_weight=ins[:, 2].astype(np.float32),
            delete_src=dels[:, 0].astype(np.int32),
            delete_dst=dels[:, 1].astype(np.int32),
        )

    @property
    def num_inserts(self) -> int:
        return int(self.insert_src.shape[0])

    @property
    def num_deletes(self) -> int:
        return int(self.delete_src.shape[0])

    @property
    def size(self) -> int:
        return self.num_inserts + self.num_deletes

    def validate(self, num_vertices: int) -> None:
        for a in (self.insert_src, self.insert_dst,
                  self.delete_src, self.delete_dst):
            if a.size and not (int(a.min()) >= 0
                               and int(a.max()) < num_vertices):
                raise ValueError(
                    f"update endpoints must lie in [0, {num_vertices})")
        w = self.insert_weight
        if w.size and not (float(w.min()) > 0.0 and float(w.max()) < 1.0):
            raise ValueError("insert weights must lie in (0, 1) — the "
                             "packed-key range of the engines (keys.py)")


@dataclasses.dataclass(frozen=True)
class IncrementalForest:
    """A solved graph: the handle :func:`apply_updates` evolves.

    ``forest.edge_mask`` indexes ``graph``'s canonical edges; an update
    replaces both (canonical ids shift as edges come and go), so hold on
    to the RETURNED handle.
    """

    graph: Graph
    forest: ForestResult


@dataclasses.dataclass
class IncrementalStats(boruvka_dist.BatchStats):
    """Ledger of one :func:`apply_updates` batch.

    ``updates_applied`` / ``replacement_probes`` (runtime protocol) meter
    the pass: structural changes applied (inserts that created or
    lightened an edge, deletes that removed one) and cut-probe candidates
    (non-tree edges crossing severed components).  ``candidate_count`` is
    the final solve's edge count; the sub-solve's counters add up through
    the inherited :meth:`~repro_torch.core.boruvka_dist.BatchStats.merge`.
    ``label_syncs`` counts the label loop's host reads (also in
    ``host_syncs`` and ``extra_syncs``; the reference's loop reads nothing).
    """

    candidate_count: int = 0
    label_syncs: int = 0


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """What one probed update batch leaves on the host for its final solve:
    the updated graph, the candidate subgraph (a canonical subset), the
    lift index and the ledger.  :func:`finalize_plan` joins it with the
    candidate forest."""

    graph: Graph
    sub: Graph
    index: np.ndarray
    stats: IncrementalStats


def _canonical_pairs(src, dst, num_vertices: int) -> np.ndarray:
    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    return pair_ids(u, v, num_vertices)


def _apply_edge_batch_reference(graph: Graph, batch: EdgeBatch) -> Graph:
    """The definition of the updated graph: delete canonical pairs, then
    run everything back through §3.1 ``preprocess``.  A tie between an
    inserted copy and a surviving edge keeps the survivor (the lexsort is
    stable and survivors come first in the concatenation)."""
    n = graph.num_vertices
    keep = np.ones(graph.num_edges, dtype=bool)
    if batch.num_deletes:
        loops = batch.delete_src == batch.delete_dst
        dpid = np.unique(_canonical_pairs(
            batch.delete_src[~loops], batch.delete_dst[~loops], n))
        keep = ~np.isin(_canonical_pairs(graph.src, graph.dst, n), dpid)
    return preprocess(
        np.concatenate([graph.src[keep], batch.insert_src]),
        np.concatenate([graph.dst[keep], batch.insert_dst]),
        np.concatenate([graph.weight[keep], batch.insert_weight]),
        n)


def apply_edge_batch(graph: Graph, batch: EdgeBatch) -> Graph:
    """The updated graph, equal to :func:`_apply_edge_batch_reference`'s,
    by a sorted merge: ``preprocess`` emits edges sorted by pair id, so
    deletions are a searchsorted mask and insertions splice in at their
    sorted positions, with no sort of the whole survivor set.  Collisions
    keep the lighter weight, ties going to the survivor, and duplicate
    inserts keep their first lightest copy, as the reference's stable sort
    does.  A graph that is not pair-sorted takes the reference path."""
    batch.validate(graph.num_vertices)
    n = graph.num_vertices
    pid = _canonical_pairs(graph.src, graph.dst, n)
    if pid.size and not bool(np.all(pid[1:] > pid[:-1])):
        return _apply_edge_batch_reference(graph, batch)
    src, dst, weight = graph.src, graph.dst, graph.weight

    if batch.num_deletes:
        loops = batch.delete_src == batch.delete_dst
        dpid = np.unique(_canonical_pairs(
            batch.delete_src[~loops], batch.delete_dst[~loops], n))
        if dpid.size:
            pos = np.searchsorted(dpid, pid)
            pos_c = np.minimum(pos, dpid.size - 1)
            keep = ~((pos < dpid.size) & (dpid[pos_c] == pid))
            src, dst = src[keep], dst[keep]
            weight, pid = weight[keep], pid[keep]

    if batch.num_inserts:
        iu = np.minimum(batch.insert_src, batch.insert_dst).astype(np.int64)
        iv = np.maximum(batch.insert_src, batch.insert_dst).astype(np.int64)
        iw = batch.insert_weight
        real = iu != iv                       # self-loops drop
        iu, iv, iw = iu[real], iv[real], iw[real]
        ipid = pair_ids(iu, iv, n)
        # Within-batch dedup: the lightest copy of a pair, the first on
        # weight ties (np.lexsort is stable, as in the reference).
        order = np.lexsort((iw, ipid))
        ipid, iu, iv, iw = ipid[order], iu[order], iv[order], iw[order]
        first = np.ones(ipid.size, dtype=bool)
        first[1:] = ipid[1:] != ipid[:-1]
        ipid, iu, iv, iw = ipid[first], iu[first], iv[first], iw[first]
        # Collisions with survivors: strictly lighter inserts re-weight
        # the pair in place (ties keep the survivor).
        if pid.size:
            pos = np.searchsorted(pid, ipid)
            pos_c = np.minimum(pos, pid.size - 1)
            hit = (pos < pid.size) & (pid[pos_c] == ipid)
            lighter = hit & (iw < weight[pos_c])
            if lighter.any():
                weight = weight.copy()
                weight[pos_c[lighter]] = iw[lighter]
        else:
            pos = np.zeros(ipid.size, dtype=np.int64)
            hit = np.zeros(ipid.size, dtype=bool)
        # Fresh pairs splice in at their sorted positions.
        new = ~hit
        if new.any():
            at = pos[new]
            src = np.insert(src, at, iu[new].astype(np.int32))
            dst = np.insert(dst, at, iv[new].astype(np.int32))
            weight = np.insert(weight, at, iw[new])

    return Graph(num_vertices=n, src=src, dst=dst, weight=weight)


def _match_pairs(old: Graph, new: Graph) -> "tuple[np.ndarray, np.ndarray]":
    """Per-new-edge join against the old graph's canonical pairs:
    ``(hit, old_idx)``, ``old_idx`` valid only where ``hit``.  Canonical
    graphs are pair-sorted, so the join is usually one searchsorted."""
    pid_old = _canonical_pairs(old.src, old.dst, old.num_vertices)
    pid_new = _canonical_pairs(new.src, new.dst, old.num_vertices)
    if pid_old.size == 0:
        return (np.zeros(pid_new.size, dtype=bool),
                np.zeros(pid_new.size, dtype=np.int64))
    if bool(np.all(pid_old[1:] > pid_old[:-1])):
        order = None
        sorted_pid = pid_old
    else:
        order = np.argsort(pid_old, kind="stable")
        sorted_pid = pid_old[order]
    pos = np.searchsorted(sorted_pid, pid_new)
    pos_c = np.minimum(pos, sorted_pid.size - 1)
    hit = (pos < sorted_pid.size) & (sorted_pid[pos_c] == pid_new)
    return hit, (pos_c if order is None else order[pos_c])


def _anchor_tree_mask(old: IncrementalForest, new: Graph) -> np.ndarray:
    """F0 membership over the NEW graph's canonical edges: old tree pairs
    that survive with their weight unchanged (a re-weighted pair re-enters
    as a probe candidate: its old certificates are void)."""
    if old.graph.num_edges == 0:
        return np.zeros(new.num_edges, dtype=bool)
    hit, old_idx = _match_pairs(old.graph, new)
    return hit & old.forest.edge_mask[old_idx] \
        & (new.weight == old.graph.weight[old_idx])


def _probe_candidates(g: Graph, tmask: np.ndarray, params: GHSParams,
                      device: torch.device, stats: IncrementalStats,
                      num_shards: int = 1) -> "tuple[np.ndarray, int]":
    """(keep mask, cut-probe candidate count) over ``g``'s edges: the
    device half of the pass.  The level labels, then ``component_maxkey``
    warm-started from the top level (whose threshold is the largest tree
    key, so its loop reads its flag once and does not iterate), then every
    edge against all three certificates; ONE read brings back both masks.
    Under a mesh the tree edges are cut into one block a shard, as in the
    filter pass."""
    put = _upload(device)
    n = g.num_vertices
    tree_pos = np.flatnonzero(tmask)
    key = g.packed_keys
    use_pallas = bool(params.use_pallas)

    levels = int(params.update_levels) or int(params.filter_levels)
    thresholds = put(_thresholds(key[tree_pos], levels))
    t_src, t_dst, t_key = g.src[tree_pos], g.dst[tree_pos], key[tree_pos]
    collective, cand_cap = "pmin", None
    if num_shards > 1:
        t_src, t_dst, t_key, cand_cap = shard_tree(
            t_src, t_dst, t_key, n, num_shards,
            runtime.resolve_collective(params.collective))
        collective = "compressed" if cand_cap is not None else "pmin"
    t_src, t_dst, t_key = put(t_src), put(t_dst), put(t_key)
    before = stats.host_syncs
    labels = _level_labels(t_src, t_dst, t_key, thresholds, n, use_pallas,
                           stats, collective, cand_cap)
    comp, maxkey = minplus_ops.component_maxkey(
        t_src, t_dst, t_key, t_key != keys_lib.INF_KEY, num_vertices=n,
        init=labels[-1], use_pallas=use_pallas, stats=stats,
        collective=collective, cand_cap=cand_cap)
    stats.label_syncs += stats.host_syncs - before

    p_key, p_tree = put(key), put(tmask)
    below, u, v = _below(labels, thresholds, put(g.src), put(g.dst), p_key, n)
    joined = comp[u] == comp[v]
    over = joined & (p_key > maxkey[u])
    keep = p_tree | ~(below | over)
    cross = ~p_tree & ~joined
    keep, cross = torch.stack([keep, cross]).cpu().numpy()
    return keep, int(cross.sum())


def plan_updates(
    state: IncrementalForest,
    batch: EdgeBatch,
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
    mesh=None,
    updated: Optional[Graph] = None,
) -> UpdatePlan:
    """Merge and probe: everything in :func:`apply_updates` up to the
    final candidate solve.  ``updated`` optionally passes a precomputed
    :func:`apply_edge_batch` result.  ``device=None`` probes on the CUDA
    card and raises when there is none; ``mesh`` (a
    :class:`repro_torch.sharding.mesh.Mesh`) probes over its shards on its
    device."""
    S, dev = runtime.resolve_mesh(mesh, device)
    runtime.resolve_collective(params.collective)
    g2 = apply_edge_batch(state.graph, batch) if updated is None else updated
    stats = IncrementalStats()

    # Structural changes applied: pairs that vanished, appeared, or
    # changed weight (pairs are unique in a graph, so the join counts are
    # exact).
    hit, old_idx = _match_pairs(state.graph, g2)
    removed = state.graph.num_edges - int(hit.sum())
    added = int((~hit).sum())
    if state.graph.num_edges == 0:
        changed = 0
        tmask = np.zeros(g2.num_edges, dtype=bool)
    else:
        same_w = g2.weight == state.graph.weight[old_idx]
        changed = int((hit & ~same_w).sum())
        # F0 membership from the same join (_anchor_tree_mask is the
        # standalone form).
        tmask = hit & state.forest.edge_mask[old_idx] & same_w
    stats.updates_applied = removed + added + changed
    if tmask.any():
        keep, probes = _probe_candidates(g2, tmask, params, dev, stats, S)
        stats.host_syncs += 1     # the fused keep/cross-mask fetch
        stats.extra_syncs += 1
        stats.replacement_probes = probes
    else:
        # No anchor forest (empty, or every tree edge changed): no
        # certificate exists, and the final solve sees every edge.
        keep = np.ones(g2.num_edges, dtype=bool)

    stats.edges_filtered = int(g2.num_edges - keep.sum())
    stats.filter_passes = 1
    sub, index = partition_lib.subgraph_by_mask(g2, keep)
    stats.candidate_count = sub.num_edges
    return UpdatePlan(graph=g2, sub=sub, index=index, stats=stats)


def finalize_plan(plan: UpdatePlan,
                  sub_forest: ForestResult) -> IncrementalForest:
    """Lift the candidate forest back to the updated graph's canonical
    edges: the new handle."""
    g2 = plan.graph
    mask = partition_lib.lift_mask(plan.index, sub_forest.edge_mask,
                                   g2.num_edges)
    forest = runtime.forest_from_mask(
        g2, mask, num_components=sub_forest.num_components)
    forest.check_consistent(g2.num_vertices)
    return IncrementalForest(graph=g2, forest=forest)


def apply_updates(
    state: IncrementalForest,
    batch: EdgeBatch,
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
    mesh=None,
    max_rounds: Optional[int] = None,
) -> "tuple[IncrementalForest, IncrementalStats]":
    """Apply one insert/delete batch to a solved forest.

    Returns ``(new_state, stats)``; ``new_state.forest`` equals a solve
    from scratch of ``apply_edge_batch(state.graph, batch)`` bit for bit,
    for every knob.  ``stats`` carries ``updates_applied``,
    ``replacement_probes`` and ``candidate_count``, and the final solve's
    counters through ``merge``.  ``device=None`` runs on the CUDA card and
    raises when there is none; ``mesh`` runs the probe and the solve over
    its shards.
    """
    plan = plan_updates(state, batch, params=params, device=device, mesh=mesh)
    res, st = boruvka_dist.minimum_spanning_forest(
        plan.sub, params=params, device=device, mesh=mesh,
        max_rounds=max_rounds)
    plan.stats.merge(st)
    return finalize_plan(plan, res), plan.stats
