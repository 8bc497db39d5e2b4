"""Filter-Borůvka sampling hybrid: sample → solve → filter → solve.

After Sanders & Schimek (*Engineering Massively Parallel MST Algorithms*):

1. **Sample.**  A counter-based Bernoulli sample over canonical edge ids
   (:func:`repro_torch.core.pipeline.sample_mask`), a pure function of
   ``(pass, edge id)``.
2. **Solve the sample** with the Borůvka engine (every knob composes); its
   forest is the partial forest.
3. **Filter** (the cycle rule).  An edge outside the sample is provably
   non-MSF when its endpoints are connected in the partial forest through
   tree edges of smaller packed key: it is then the strict maximum of a
   cycle under the global (weight ‖ edge-id) order of :mod:`.keys`.  The
   probe quantizes the path maximum: the tree keys give
   ``params.filter_levels`` quantile thresholds ``T_1 ≤ … ≤ T_K``, level
   ``j`` labels the components of the tree edges with key ≤ ``T_j``
   (:func:`repro_torch.kernels.spmv_minplus.ops.connected_labels`, each
   level warm-started from the one below), and an edge is dropped when a
   level whose threshold lies below its key connects its endpoints.  Keys
   are distinct, so that certifies a strictly lighter path.  Quantization
   changes how many edges are dropped, never which forest comes out.
   Sampled non-tree edges are dropped outright; sampled tree edges stay.
4. **Final solve** over the survivors.  If they still outnumber
   ``params.filter_threshold`` (0: ``4·n``), one more pass runs first over
   the survivors under a fresh sample stream; never more
   (:data:`MAX_PASSES`).

The survivors hold every MSF edge and the MSF is unique under the packed
order, so the forest equals the plain engine's for every sample rate and
level count.  A rate ≤ 0 samples nothing, filters nothing, and the final
solve sees every edge.

The host glue (sampling, subsets, thresholds) is numpy, as in the
reference; the level labels and the probe run on the engine's device, and
the keep mask comes back in one read.  Under a mesh the sub-solves run
over its shards, and the tree edges of the label loop are cut into one
power-of-two block a shard, whose hooks meet in a ``pmin`` (or the
compressed exchange where its wire model beats the dense one).  The label loop reads its flag on
the host (``ops.connected_labels``): each read counts in ``host_syncs``
and ``extra_syncs``, and in ``FilterStats.label_syncs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import boruvka_dist
from repro_torch.core import keys as keys_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import runtime
from repro_torch.core.graph import PAD_VERTEX, Graph
from repro_torch.core.kruskal_ref import ForestResult
from repro_torch.core.params import DEFAULT_PARAMS, GHSParams
from repro_torch.kernels.spmv_minplus import ops as minplus_ops
from repro_torch.sharding import collectives

MAX_PASSES = 2          # the first pass and the single recursion


@dataclasses.dataclass
class FilterStats(boruvka_dist.BatchStats):
    """Ledger of a filter-Borůvka run.

    ``edges_filtered`` / ``filter_passes`` (runtime protocol) meter the
    filter; the sub-solves' counters add up through the inherited
    :meth:`~repro_torch.core.boruvka_dist.BatchStats.merge`.
    ``survivor_history`` holds the candidate count after each pass, and
    ``label_syncs`` the label loop's host reads (also in ``host_syncs``
    and ``extra_syncs``; the reference's loop reads nothing).
    """

    survivor_history: tuple = ()
    label_syncs: int = 0


def _thresholds(tree_keys: np.ndarray, num_levels: int) -> np.ndarray:
    """Ascending per-level key quantiles (upper edges) of the tree keys.
    The keys are flipped int64, whose sort is the reference's unsigned
    order, so the thresholds are the reference's words."""
    t_sorted = np.sort(tree_keys)
    t = t_sorted.size
    qi = (np.arange(1, num_levels + 1, dtype=np.int64) * t) // num_levels - 1
    return t_sorted[np.maximum(qi, 0)]


def _level_labels(t_src, t_dst, t_key, thresholds, n: int, use_pallas: bool,
                  stats, collective: str = "pmin",
                  cand_cap: Optional[int] = None) -> torch.Tensor:
    """(K, n) labels: level j's components over the tree edges with key ≤
    ``thresholds[j]``.  The levels are nested, so level j warm-starts from
    level j-1's labels and only newly active edges pay iterations."""
    comp, rows = None, []
    for j in range(thresholds.shape[0]):
        comp = minplus_ops.connected_labels(
            t_src, t_dst, t_key <= thresholds[j], num_vertices=n, init=comp,
            use_pallas=use_pallas, stats=stats, collective=collective,
            cand_cap=cand_cap)
        rows.append(comp)
    return torch.stack(rows)


def shard_tree(t_src, t_dst, t_key, n: int, num_shards: int,
               collective: str):
    """The label loop's tree edges under a mesh, as the reference lays
    them out: one power-of-two block a shard (``PAD_VERTEX`` / ``INF_KEY``
    padding, never active), numpy ``(S, block)`` arrays; and the
    compressed exchange's cap where ``collective="compressed"`` and its
    wire model beats the dense ``pmin`` (else None).  Each local tree edge
    hooks at most one entry an iteration, so the block bounds a shard's
    candidates."""
    S = num_shards
    block = partition_lib.pow2ceil(max(-(-max(t_src.size, 8) // S), 1))

    def pad(a, fill):
        return np.concatenate([a, np.full(block * S - a.size, fill,
                                          a.dtype)]).reshape(S, block)

    cand_cap = None
    if S > 1 and collective == "compressed":
        cap = max(partition_lib.pow2ceil(min(n, 2 * block)), 8)
        if (collectives.compressed_bytes(cap, S, 4)
                < collectives.dense_bytes(n, S, 4)):
            cand_cap = cap
    return (pad(t_src, PAD_VERTEX), pad(t_dst, PAD_VERTEX),
            pad(t_key, keys_lib.INF_KEY), cand_cap)


def _below(labels, thresholds, src, dst, key, n: int):
    """The quantized cycle certificate of each probe edge: some level whose
    threshold lies below ``key`` connects its endpoints.  Tree and probe
    keys are distinct, so ``side="left"`` counts the thresholds strictly
    below.  Returns ``(below, u, v)``, the endpoints as clipped indices."""
    idx = torch.searchsorted(thresholds, key, side="left")
    lvl = (idx - 1).clamp(min=0)
    u = src.clamp(0, n - 1).to(torch.int64)
    v = dst.clamp(0, n - 1).to(torch.int64)
    return (idx > 0) & (labels[lvl, u] == labels[lvl, v]), u, v


def _upload(device: torch.device):
    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return put


def _run_filter(g: Graph, cand: np.ndarray, tree_pos: np.ndarray,
                smask: np.ndarray, params: GHSParams, device: torch.device,
                stats: FilterStats, num_shards: int = 1) -> np.ndarray:
    """Keep mask over ``cand`` from the quantized cycle rule; the labels
    and the probe on ``device``, the mask fetched in one read."""
    put = _upload(device)
    n = g.num_vertices
    c_src, c_dst = g.src[cand], g.dst[cand]
    c_key = g.packed_keys[cand]
    tmask = np.zeros(cand.size, dtype=bool)
    tmask[tree_pos] = True

    thresholds = put(_thresholds(c_key[tree_pos], int(params.filter_levels)))
    t_src, t_dst, t_key = c_src[tree_pos], c_dst[tree_pos], c_key[tree_pos]
    collective, cand_cap = "pmin", None
    if num_shards > 1:
        t_src, t_dst, t_key, cand_cap = shard_tree(
            t_src, t_dst, t_key, n, num_shards,
            runtime.resolve_collective(params.collective))
        collective = "compressed" if cand_cap is not None else "pmin"
    before = stats.host_syncs
    labels = _level_labels(put(t_src), put(t_dst), put(t_key), thresholds, n,
                           bool(params.use_pallas), stats, collective,
                           cand_cap)
    stats.label_syncs += stats.host_syncs - before
    below, _, _ = _below(labels, thresholds, put(c_src), put(c_dst),
                         put(c_key), n)
    keep = torch.where(put(smask), put(tmask), ~below)
    return keep.cpu().numpy()


def minimum_spanning_forest(
    graph,
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
    mesh=None,
    max_rounds: Optional[int] = None,
) -> tuple[ForestResult, FilterStats]:
    """Filter-Borůvka solve, with the contract of the plain engine's entry.

    ``graph`` is a host :class:`Graph` or a
    :class:`repro_torch.core.pipeline.DeviceEdges` (through its host
    mirror).  ``device=None`` runs on the CUDA card and raises when there
    is none.  The forest equals ``method="boruvka"``'s (and the Kruskal
    oracle's) for every ``filter_sample_rate`` and ``filter_levels``.
    ``mesh`` (a :class:`repro_torch.sharding.mesh.Mesh`) runs the
    sub-solves and the label loop over its shards on its device.
    """
    if not 1 <= int(params.filter_levels) <= 64:
        raise ValueError(
            f"filter_levels must be in [1, 64], got {params.filter_levels}")
    S, dev = runtime.resolve_mesh(mesh, device)
    runtime.resolve_collective(params.collective)
    g = runtime.as_graph(graph)
    n, m = g.num_vertices, g.num_edges
    rate = float(params.filter_sample_rate)
    threshold = int(params.filter_threshold)
    if threshold <= 0:
        threshold = 4 * max(n, 1)

    stats = FilterStats()
    cand = np.arange(m, dtype=np.int64)          # canonical ids still in play

    for pass_idx in range(MAX_PASSES):
        # The sample is host glue, as in the reference: a CPU tensor, so
        # deciding it reads nothing back from the card.
        smask = pipeline_lib.sample_mask(
            pass_idx, rate, torch.from_numpy(cand)).numpy()
        s_pos = np.flatnonzero(smask)

        tree_pos = np.zeros(0, dtype=np.int64)
        if s_pos.size:
            # Canonical-subset order and a monotone renumbering keep the
            # election order, so the sample forest is the MSF of the
            # sampled subgraph (partition.subgraph_by_mask).
            pick = cand[s_pos]
            sample_g = Graph(num_vertices=n, src=g.src[pick],
                             dst=g.dst[pick], weight=g.weight[pick])
            f_s, st = boruvka_dist.minimum_spanning_forest(
                sample_g, params=params, device=dev, mesh=mesh,
                max_rounds=max_rounds)
            stats.merge(st)
            tree_pos = s_pos[f_s.edge_mask]

        if tree_pos.size:
            keep = _run_filter(g, cand, tree_pos, smask, params, dev, stats,
                               S)
            stats.host_syncs += 1      # the keep-mask fetch
            stats.extra_syncs += 1
        else:
            # Empty (or forest-free) sample: nothing is provably non-MSF,
            # so the final solve sees the whole candidate set.
            keep = np.ones(cand.size, dtype=bool)

        stats.filter_passes += 1
        stats.edges_filtered += int(cand.size - keep.sum())
        cand = cand[keep]
        stats.survivor_history += (cand.size,)
        if cand.size <= threshold or not tree_pos.size or rate >= 1.0:
            break

    live = np.zeros(m, dtype=bool)
    live[cand] = True
    sub, index = partition_lib.subgraph_by_mask(g, live)
    res, st = boruvka_dist.minimum_spanning_forest(
        sub, params=params, device=dev, mesh=mesh, max_rounds=max_rounds)
    stats.merge(st)

    forest = runtime.forest_from_mask(
        g, partition_lib.lift_mask(index, res.edge_mask, m),
        num_components=res.num_components)
    forest.check_consistent(n)
    return forest, stats
