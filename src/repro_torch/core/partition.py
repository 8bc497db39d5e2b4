"""Pluggable graph partitioners for both engines.

* The Borůvka engine distributes edges: a partitioner maps every canonical
  edge to a shard (:meth:`Partitioner.edge_shard`), and
  :func:`build_edge_layout` freezes that assignment into an
  :class:`EdgeLayout` (uniform per-shard slot blocks, slot →
  canonical-edge-id table).  The engine records tree edges by slot, so
  every layout yields the same forest; the layout only decides which slot
  an edge occupies and the padded slot count, which sets the engine's
  buffer and kernel shapes.
* The GHS engine distributes vertices in blocks (``owner = id //
  ceil(n / S)``, paper §3).  A partitioner supplies a vertex relabeling
  (:meth:`Partitioner.vertex_perm`) that makes the block rule realize its
  assignment; :func:`relabel_graph` applies it without touching edge
  order, weights or canonical ids, so the forest is the same for every
  partitioner and only the message routing changes.

* ``block``    — contiguous canonical-order blocks (power-of-two padding) /
  identity labels.
* ``hashed``   — pseudo-random scatter by splitmix64 of the edge id / of
  the vertex id.
* ``balanced`` — contiguous runs snapped to source-vertex boundaries with
  about equal edge counts / vertices snake-packed by descending degree.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import keys as keys_lib
from repro_torch.core.graph import Graph


def _mix64(x: np.ndarray) -> np.ndarray:
    return keys_lib.splitmix64(x.astype(np.uint64))


def pow2ceil(x: int) -> int:
    """Smallest power of two ≥ x (shared by layouts and engine buckets)."""
    p = 1
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class EdgeLayout:
    """Frozen edge→slot assignment: ``num_shards`` uniform blocks of
    ``block`` slots; ``eid[slot]`` is the canonical edge id held by that
    slot, or -1 for a padding slot."""

    num_shards: int
    block: int
    eid: np.ndarray            # (num_shards * block,) int64

    @property
    def num_slots(self) -> int:
        return self.num_shards * self.block

    def canonical_mask(self, slot_mask: np.ndarray, num_edges: int) -> np.ndarray:
        """Map a per-slot tree bitmap back to canonical edge ids."""
        slot_mask = np.asarray(slot_mask, dtype=bool)
        mask = np.zeros(num_edges, dtype=bool)
        sel = slot_mask & (self.eid >= 0)
        mask[self.eid[sel]] = True
        return mask


class Partitioner:
    """Partitioner contract: ``edge_shard`` gives one shard id per edge,
    ``vertex_perm`` one new id per vertex."""

    name: str = "?"

    def edge_shard(self, graph: Graph, num_shards: int) -> np.ndarray:
        """(M,) int64 shard id per canonical edge."""
        raise NotImplementedError

    def vertex_perm(self, graph: Graph, num_shards: int) -> np.ndarray:
        """(N,) int64 new vertex id per old id; the block rule (``owner =
        new_id // ceil(N / S)``) realizes the assignment, so at most
        ``ceil(N / S)`` vertices land in each block."""
        raise NotImplementedError


class BlockPartitioner(Partitioner):
    name = "block"

    def edge_shard(self, graph: Graph, num_shards: int) -> np.ndarray:
        block = -(-graph.num_edges // num_shards) if graph.num_edges else 1
        return np.arange(graph.num_edges, dtype=np.int64) // block

    def vertex_perm(self, graph: Graph, num_shards: int) -> np.ndarray:
        return np.arange(graph.num_vertices, dtype=np.int64)


class HashedPartitioner(Partitioner):
    name = "hashed"

    def edge_shard(self, graph: Graph, num_shards: int) -> np.ndarray:
        h = _mix64(np.arange(graph.num_edges, dtype=np.uint64))
        return (h % np.uint64(num_shards)).astype(np.int64)

    def vertex_perm(self, graph: Graph, num_shards: int) -> np.ndarray:
        n = graph.num_vertices
        order = np.argsort(_mix64(np.arange(n, dtype=np.uint64)),
                           kind="stable")
        perm = np.empty(n, dtype=np.int64)
        perm[order] = np.arange(n, dtype=np.int64)
        return perm


class BalancedPartitioner(Partitioner):
    name = "balanced"

    def edge_shard(self, graph: Graph, num_shards: int) -> np.ndarray:
        m = graph.num_edges
        if m == 0:
            return np.zeros(0, dtype=np.int64)
        src = graph.src.astype(np.int64)
        starts = np.flatnonzero(np.concatenate([[True], src[1:] != src[:-1]]))
        targets = (m * np.arange(num_shards, dtype=np.int64)) // num_shards
        bounds = starts[np.searchsorted(starts, targets, side="right") - 1]
        bounds[0] = 0
        bounds = np.maximum.accumulate(bounds)
        return (np.searchsorted(bounds, np.arange(m), side="right")
                - 1).astype(np.int64)

    def vertex_perm(self, graph: Graph, num_shards: int) -> np.ndarray:
        n, S = graph.num_vertices, num_shards
        deg = np.zeros(n, dtype=np.int64)
        np.add.at(deg, graph.src, 1)
        np.add.at(deg, graph.dst, 1)
        heavy_first = np.argsort(-deg, kind="stable")
        # Walk the id space [0, S·block) column-major (one slot a shard a
        # round), reversing the shard order every other round, and keep
        # the ids < n: the r-th heaviest vertex takes the r-th slot.  When
        # S does not divide n the last block is short and its missing ids
        # are never handed out.
        block = -(-n // S)
        rows = np.arange(S, dtype=np.int64)
        cols = np.arange(block, dtype=np.int64)
        snake = np.where(cols[:, None] % 2 == 0,
                         rows[None, :], rows[::-1][None, :])
        ids = (snake * block + cols[:, None]).ravel()
        new_of_rank = ids[ids < n]
        perm = np.empty(n, dtype=np.int64)
        perm[heavy_first] = new_of_rank
        return perm


PARTITIONERS = {
    p.name: p for p in (BlockPartitioner(), HashedPartitioner(),
                        BalancedPartitioner())
}


def get_partitioner(name: str) -> Partitioner:
    try:
        return PARTITIONERS[name]
    except KeyError:
        raise ValueError(
            f"unknown partitioner {name!r}; options: "
            f"{tuple(PARTITIONERS)}") from None


def build_edge_layout(
    graph: Graph, partitioner: Partitioner, num_shards: int, chunk: int
) -> EdgeLayout:
    """Freeze an edge partition into uniform per-shard slot blocks.

    ``block`` pads globally to a power-of-two multiple of ``chunk``; the
    others pad each shard to the largest per-shard count (power of two,
    ≥ 8), exactly as the reference sizes its layouts.
    """
    m = graph.num_edges
    if partitioner.name == "block":
        target = max(chunk, 1)
        while target < m:
            target *= 2
        eid = np.concatenate([
            np.arange(m, dtype=np.int64),
            np.full(target - m, -1, dtype=np.int64),
        ])
        return EdgeLayout(num_shards=num_shards,
                          block=target // num_shards, eid=eid)

    shard = partitioner.edge_shard(graph, num_shards)
    counts = np.bincount(shard, minlength=num_shards) if m else \
        np.zeros(num_shards, dtype=np.int64)
    block = pow2ceil(max(int(counts.max()) if m else 0,
                         max(chunk // num_shards, 8)))
    eid = np.full(num_shards * block, -1, dtype=np.int64)
    for s in range(num_shards):
        sel = np.flatnonzero(shard == s)       # ascending: canonical order
        eid[s * block: s * block + sel.size] = sel
    return EdgeLayout(num_shards=num_shards, block=block, eid=eid)


def identity_layout(num_edges: int, cap: int) -> EdgeLayout:
    """One-shard layout whose slot *i* is canonical edge *i*, padding slots
    from ``num_edges`` to ``cap``: the layout of every lane of a packed
    graph batch."""
    eid = np.full(cap, -1, dtype=np.int64)
    eid[:num_edges] = np.arange(num_edges, dtype=np.int64)
    return EdgeLayout(num_shards=1, block=cap, eid=eid)


def batched_slots(batch_size: int, cap: int) -> np.ndarray:
    """(B, cap) int32 slot side-lane of a packed graph batch: each lane
    carries its own slot index, so tree-edge recording survives per-lane
    compaction."""
    return np.broadcast_to(
        np.arange(cap, dtype=np.int32), (batch_size, cap)).copy()


def subgraph_by_mask(graph: Graph, mask: np.ndarray) -> "tuple[Graph, np.ndarray]":
    """Canonical-order edge subset as its own :class:`Graph`.

    Returns ``(sub, index)``: ``sub`` keeps every masked edge in canonical
    order and ``index[j]`` is the canonical edge id behind sub edge ``j``.
    The renumbering ``j ↦ index[j]`` is strictly increasing, so the
    (weight, edge-id) election order of ``sub`` is the input's order
    restricted to the subset, and an engine forest over ``sub`` is the
    restriction of the forest over the input.  The filter and incremental
    passes solve their survivors this way, under any partitioner.
    """
    mask = np.asarray(mask, dtype=bool)
    index = np.flatnonzero(mask).astype(np.int64)
    sub = Graph(num_vertices=graph.num_vertices,
                src=graph.src[index], dst=graph.dst[index],
                weight=graph.weight[index])
    return sub, index


def lift_mask(index: np.ndarray, sub_mask: np.ndarray,
              num_edges: int) -> np.ndarray:
    """Map a subset-edge bitmap back to canonical edge ids (the inverse of
    :func:`subgraph_by_mask`'s renumbering)."""
    sub_mask = np.asarray(sub_mask, dtype=bool)
    mask = np.zeros(num_edges, dtype=bool)
    mask[index[sub_mask]] = True
    return mask


def relabel_graph(graph: Graph, perm: np.ndarray) -> Graph:
    """Rename the vertices by ``perm`` without touching edge order or
    weights: edge *i* of the result is canonical edge *i* of the input
    (same weight, same packed key), its endpoints renamed and put back in
    ``src < dst`` order, so a forest of the result is a forest over the
    input's canonical edges."""
    perm = np.asarray(perm, dtype=np.int64)
    ps = perm[graph.src]
    pd = perm[graph.dst]
    return Graph(num_vertices=graph.num_vertices,
                 src=np.minimum(ps, pd).astype(np.int32),
                 dst=np.maximum(ps, pd).astype(np.int32),
                 weight=graph.weight)
