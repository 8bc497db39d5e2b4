"""Graph generators of the paper's evaluation (§4): RMAT, SSCA2, Uniform,
and the graph pipeline's scenario kinds.

``SCALE`` = log2(num_vertices), average vertex degree 32 (16·N undirected
edge samples), weights uniform in the open interval (0, 1).  The paper's
generators draw raw samples from a numpy seed; geo_knn, grid, chain and star
are the counter-based pipeline samplers on the host
(:func:`repro_torch.core.pipeline.build_host`).  Each returns the
§3.1-preprocessed graph.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, preprocess

_WEIGHT_EPS = np.float32(1e-9)


def _weights(rng: np.random.Generator, m: int) -> np.ndarray:
    w = rng.random(m, dtype=np.float32)
    return np.clip(w, _WEIGHT_EPS, np.float32(1.0) - _WEIGHT_EPS)


def rmat(
    scale: int,
    avg_degree: int = 32,
    *,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> Graph:
    """R-MAT recursive-quadrant sampler (Chakrabarti et al., Graph500 params)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * avg_degree // 2
    d = 1.0 - a - b - c
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    cum = np.cumsum(np.array([a, b, c, d]))
    for _ in range(scale):
        r = rng.random(m)
        quad = np.searchsorted(cum, r, side="right").astype(np.int64)
        quad = np.minimum(quad, 3)
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
    # Graph500-style vertex scrambling disperses the low-id hubs.
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    return preprocess(src, dst, _weights(rng, m), n)


def ssca2(
    scale: int,
    avg_degree: int = 32,
    *,
    seed: int = 0,
    max_clique: int | None = None,
) -> Graph:
    """SSCA2-style graph: randomly interconnected cliques (Bader & Madduri)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    if max_clique is None:
        # E[deg] ≈ (2/3)·max_clique for uniform clique sizes.
        max_clique = max(2, int(avg_degree * 3 / 2))
    sizes = np.zeros(0, dtype=np.int64)
    while int(sizes.sum()) < n:
        need = n - int(sizes.sum())
        batch = max(2 * need // (max_clique + 1) + 1, 16)
        sizes = np.concatenate(
            [sizes, rng.integers(1, max_clique + 1, size=batch)])
    cum = np.cumsum(sizes)
    n_cliques = int(np.searchsorted(cum, n, side="left")) + 1
    sizes = sizes[:n_cliques].copy()
    sizes[-1] -= int(cum[n_cliques - 1]) - n      # trim overshoot to n
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])])
    srcs, dsts = [], []
    for s in np.unique(sizes):
        if s < 2:
            continue
        u, v = np.triu_indices(int(s), k=1)
        s0 = starts[sizes == s]
        srcs.append((s0[:, None] + u[None, :]).ravel())
        dsts.append((s0[:, None] + v[None, :]).ravel())
    if n_cliques > 1:
        links_per = 3
        i = np.repeat(np.arange(1, n_cliques, dtype=np.int64), links_per)
        j = np.floor(rng.random(i.size) * i).astype(np.int64)
        u = starts[i] + np.floor(rng.random(i.size) * sizes[i]).astype(np.int64)
        v = starts[j] + np.floor(rng.random(i.size) * sizes[j]).astype(np.int64)
        srcs.append(u)
        dsts.append(v)
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    return preprocess(src, dst, _weights(rng, src.shape[0]), n)


def uniform_random(
    scale: int, avg_degree: int = 32, *, seed: int = 0
) -> Graph:
    """Erdős–Rényi-style G(n, m): endpoints chosen uniformly at random."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * avg_degree // 2
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return preprocess(src, dst, _weights(rng, m), n)


def disconnected(
    scale: int, components: int = 4, avg_degree: int = 8, *, seed: int = 0
) -> Graph:
    """Deliberately disconnected graph (forest test — paper §3.2)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    comp = max(1, components)
    size = n // comp
    srcs, dsts = [], []
    for ci in range(comp):
        base = ci * size
        sz = size if ci < comp - 1 else n - base
        if sz < 2:
            continue
        m = max(sz * avg_degree // 2, sz - 1)
        u = rng.integers(0, sz, size=m) + base
        v = rng.integers(0, sz, size=m) + base
        path = np.arange(base, base + sz - 1)   # keeps each block connected
        srcs.extend([u, path])
        dsts.extend([v, path + 1])
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    return preprocess(src, dst, _weights(rng, src.shape[0]), n)


def _pipeline_kind(kind: str):
    """Host-oracle wrapper of a counter-based pipeline generator
    (:func:`repro_torch.core.pipeline.build_host`)."""
    def gen(scale: int, avg_degree: int = 32, *, seed: int = 0) -> Graph:
        from repro_torch.core import pipeline
        return pipeline.build_host(
            pipeline.GraphSpec(kind, scale, avg_degree=avg_degree, seed=seed))
    gen.__name__ = kind
    return gen


GENERATORS = {
    "rmat": rmat,
    "ssca2": ssca2,
    "random": uniform_random,
    "disconnected": disconnected,
    # Scenario kinds of the graph pipeline (its host-oracle path).
    "geo_knn": _pipeline_kind("geo_knn"),
    "grid": _pipeline_kind("grid"),
    "chain": _pipeline_kind("chain"),
    "star": _pipeline_kind("star"),
}


def generate(kind: str, scale: int, **kw) -> Graph:
    return GENERATORS[kind](scale, **kw)
