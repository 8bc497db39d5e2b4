"""Pluggable edge partitioners for the Borůvka engine.

A partitioner maps every canonical edge to a shard, and
:func:`build_edge_layout` freezes that assignment into an
:class:`EdgeLayout` (uniform per-shard slot blocks, slot → canonical-edge-id
table).  The engine records tree edges by slot, so every layout yields the
same forest; the layout only decides which slot an edge occupies and the
padded slot count, which sets the engine's buffer and kernel shapes.

* ``block``    — contiguous canonical-order blocks (power-of-two padding).
* ``hashed``   — pseudo-random scatter by splitmix64 of the edge id.
* ``balanced`` — contiguous runs snapped to source-vertex boundaries with
  about equal edge counts.
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
    """Partitioner contract: ``edge_shard`` gives one shard id per edge."""

    name: str = "?"

    def edge_shard(self, graph: Graph, num_shards: int) -> np.ndarray:
        """(M,) int64 shard id per canonical edge."""
        raise NotImplementedError


class BlockPartitioner(Partitioner):
    name = "block"

    def edge_shard(self, graph: Graph, num_shards: int) -> np.ndarray:
        block = -(-graph.num_edges // num_shards) if graph.num_edges else 1
        return np.arange(graph.num_edges, dtype=np.int64) // block


class HashedPartitioner(Partitioner):
    name = "hashed"

    def edge_shard(self, graph: Graph, num_shards: int) -> np.ndarray:
        h = _mix64(np.arange(graph.num_edges, dtype=np.uint64))
        return (h % np.uint64(num_shards)).astype(np.int64)


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
