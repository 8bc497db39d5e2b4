"""Graph container and paper §3.1 preprocessing (self-loop / multi-edge removal).

Canonical storage is an undirected edge list ``(src < dst, weight)`` in numpy
host memory; the engine stages it onto the device on demand.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from repro_torch.core import keys as keys_lib


@dataclasses.dataclass(frozen=True)
class Graph:
    """Preprocessed undirected weighted graph (no loops, no multi-edges)."""

    num_vertices: int
    src: np.ndarray      # (M,) int32, src < dst
    dst: np.ndarray      # (M,) int32
    weight: np.ndarray   # (M,) float32, in (0, 1)

    @classmethod
    def from_arrays(cls, src, dst, weight, num_vertices: int) -> "Graph":
        """Build from the fields of any preprocessed graph (for example the
        numpy arrays of the JAX package's ``Graph``), copied and typed."""
        return cls(num_vertices=int(num_vertices),
                   src=np.array(src, dtype=np.int32),
                   dst=np.array(dst, dtype=np.int32),
                   weight=np.array(weight, dtype=np.float32))

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @functools.cached_property
    def packed_keys(self) -> np.ndarray:
        """int64 sign-flipped (weight ‖ edge_id) keys — see keys.py."""
        eid = np.arange(self.num_edges, dtype=np.uint32)
        return keys_lib.pack_keys_np(self.weight, eid)

    def validate(self) -> None:
        if self.src.dtype != np.int32 or self.dst.dtype != np.int32:
            raise ValueError("src/dst must be int32")
        if self.weight.dtype != np.float32:
            raise ValueError("weight must be float32")
        if self.num_edges:
            if int(self.src.min()) < 0 or int(self.dst.max()) >= self.num_vertices:
                raise ValueError("vertex id out of range")
            if not np.all(self.src < self.dst):
                raise ValueError("edges must be canonical (u < v)")
            pair = pair_ids(self.src, self.dst, self.num_vertices)
            if np.unique(pair).size != pair.size:
                raise ValueError("multi-edges present")


def pair_ids(u: np.ndarray, v: np.ndarray, num_vertices: int) -> np.ndarray:
    """Unique uint64 id per vertex pair (vertex ids must fit 32 bits)."""
    if num_vertices >= 2 ** 32:
        raise ValueError(
            f"pair_ids packs vertex ids into 32-bit lanes; num_vertices="
            f"{num_vertices} overflows them")
    return (u.astype(np.uint64) << np.uint64(32)) | v.astype(np.uint64)


def preprocess(
    src: np.ndarray, dst: np.ndarray, weight: np.ndarray, num_vertices: int
) -> Graph:
    """Paper §3.1: drop self-loops, canonicalize u<v, dedup multi-edges,
    keeping the minimum-weight copy of each pair."""
    src = np.asarray(src).astype(np.int64)
    dst = np.asarray(dst).astype(np.int64)
    weight = np.asarray(weight, dtype=np.float32)
    keep = src != dst
    src, dst, weight = src[keep], dst[keep], weight[keep]
    u = np.minimum(src, dst)
    v = np.maximum(src, dst)
    pid = pair_ids(u, v, num_vertices)
    order = np.lexsort((weight, pid))
    pid, u, v, weight = pid[order], u[order], v[order], weight[order]
    first = np.ones(pid.shape[0], dtype=bool)
    first[1:] = pid[1:] != pid[:-1]
    return Graph(
        num_vertices=int(num_vertices),
        src=u[first].astype(np.int32),
        dst=v[first].astype(np.int32),
        weight=weight[first],
    )


# Fill value for padded src/dst slots, far out of any vertex range.  The
# engine clamps every label gather to the last vertex (as the reference's
# device gathers do), so a padding edge is a self-loop by construction.
PAD_VERTEX = np.int32(0x7FFF0000)


def pad_edges(
    graph: Graph, multiple: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad (src, dst, key, valid) so the edge count divides ``multiple``.
    Padding edges are (PAD_VERTEX, PAD_VERTEX) with INF_KEY, valid=False."""
    m = graph.num_edges
    pad = (-m) % multiple
    src = np.concatenate([graph.src, np.full(pad, PAD_VERTEX, np.int32)])
    dst = np.concatenate([graph.dst, np.full(pad, PAD_VERTEX, np.int32)])
    key = np.concatenate(
        [graph.packed_keys, np.full(pad, keys_lib.INF_KEY, np.int64)])
    valid = np.concatenate([np.ones(m, bool), np.zeros(pad, bool)])
    return src, dst, key, valid


def both_direction_arrays(
    graph: Graph,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unsorted both-direction incidence: (ends, neighbors, edge ids).

    The one home of the mirroring convention (canonical edge i appears as
    entries i and i+M); every adjacency builder sorts these by its own key
    (the packed weight key for the GHS shards).
    """
    m = graph.num_edges
    ends = np.concatenate([graph.src, graph.dst]).astype(np.int64)
    nbrs = np.concatenate([graph.dst, graph.src]).astype(np.int64)
    eidx = np.concatenate([np.arange(m, dtype=np.int64)] * 2)
    return ends, nbrs, eidx


def vertex_indptr(ends: np.ndarray, num_vertices: int) -> np.ndarray:
    """CSR window offsets from (sorted-by-vertex) incidence endpoints."""
    counts = np.bincount(ends, minlength=num_vertices).astype(np.int64)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr
