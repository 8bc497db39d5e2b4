"""Sequential Kruskal and vectorized numpy Borůvka oracles.

Edges are scanned in packed-key order (weight, then unique edge id), the
same total order the engine uses, so the minimum spanning forest is unique
and forests compare edge-set-exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import keys as keys_lib
from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class ForestResult:
    """Minimum spanning forest summary."""

    total_weight: float
    edge_mask: np.ndarray      # (M,) bool — canonical edges in the forest
    num_components: int        # connected components of the input graph
    num_tree_edges: int

    def check_consistent(self, num_vertices: int) -> None:
        if self.num_tree_edges != int(self.edge_mask.sum()):
            raise AssertionError("num_tree_edges disagrees with edge_mask")
        if self.num_tree_edges != num_vertices - self.num_components:
            raise AssertionError("forest edge count != n - components")


class _DSU:
    __slots__ = ("parent",)

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:   # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[rb] = ra
        return True


def kruskal(graph: Graph) -> ForestResult:
    order = np.argsort(graph.packed_keys, kind="stable")
    dsu = _DSU(graph.num_vertices)
    mask = np.zeros(graph.num_edges, dtype=bool)
    taken = 0
    src, dst = graph.src, graph.dst
    for e in order:
        if dsu.union(int(src[e]), int(dst[e])):
            mask[e] = True
            taken += 1
            if taken == graph.num_vertices - 1:
                break
    total = float(graph.weight[mask].sum(dtype=np.float64))
    roots = {dsu.find(v) for v in range(graph.num_vertices)}
    res = ForestResult(total_weight=total, edge_mask=mask,
                       num_components=len(roots), num_tree_edges=taken)
    res.check_consistent(graph.num_vertices)
    return res


def boruvka_numpy(graph: Graph) -> ForestResult:
    """Vectorized numpy Borůvka — fast oracle for large graphs, independent
    of the torch engine (different control flow, same total order)."""
    n, m = graph.num_vertices, graph.num_edges
    key = graph.packed_keys
    src = graph.src.astype(np.int64)
    dst = graph.dst.astype(np.int64)
    comp = np.arange(n, dtype=np.int64)
    mask = np.zeros(m, dtype=bool)
    alive = np.ones(m, dtype=bool)
    while True:
        cs, cd = comp[src], comp[dst]
        alive &= cs != cd
        if not alive.any():
            break
        best = np.full(n, keys_lib.INF_KEY, dtype=np.int64)
        a = np.flatnonzero(alive)
        np.minimum.at(best, cs[a], key[a])
        np.minimum.at(best, cd[a], key[a])
        moe = best != keys_lib.INF_KEY
        eids = np.unique(keys_lib.unpack_edge_id_np(best[moe]).astype(np.int64))
        mask[eids] = True
        parent = np.arange(n, dtype=np.int64)
        u, v = comp[src[eids]], comp[dst[eids]]
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        parent[hi] = lo          # deterministic hooking (min root wins)
        while True:
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
        comp = parent[comp]
    total = float(graph.weight[mask].sum(dtype=np.float64))
    res = ForestResult(total_weight=total, edge_mask=mask,
                       num_components=int(np.unique(comp).size),
                       num_tree_edges=int(mask.sum()))
    res.check_consistent(n)
    return res
