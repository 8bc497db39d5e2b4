"""Graph pipeline on the device: counter-based generation, §3.1
preprocessing, and the hand-off of the canonical edges to the Borůvka
engine with no edge round trip through host memory; and the packing of many
graphs into shape buckets for the batched engine.

* **Counter-based generation.**  Every sampler is a pure function of
  ``(seed, sample index)`` built on the splitmix64 finalizer, written once
  against torch: :func:`build_host` runs it on the CPU, :func:`build` on
  the card, so the two agree byte for byte (and with the JAX package's
  samplers, which run the same arithmetic on uint64).  Counters and random
  words are raw unsigned 64-bit words carried in int64
  (:func:`repro_torch.core.keys.splitmix64_torch`); weights are
  ``(bits23 + 0.5) · 2⁻²³``, every float32 step exact.
* **§3.1 on the device.**  Self-loops and padding lanes drop, multi-edges
  keep their min-weight copy: one sort by (pair id, weight), a
  first-occurrence mask and a prefix-sum compaction into a fixed-capacity
  canonical buffer, byte-identical to :func:`graph.preprocess`.  Up to
  scale 17 the whole ``(u, v, weight-bits)`` triple is one 64-bit word
  (a key-only sort, kept sign-flipped so words with the top bit set sort
  unsigned); beyond it, a pair-id sort with the weight as payload and a
  segmented min.
* **Hand-off.**  :func:`build` returns :class:`DeviceEdges`, whose buffers
  are the engine's ``block`` layout as they stand
  (:func:`repro_torch.core.runtime.prepare_edges`); the build's one host
  sync is the deduped edge count.

Generator kinds: ``rmat`` (Graph500 R-MAT with an affine odd-multiplier
vertex scramble), ``random`` (uniform G(n, m)), ``geo_knn`` (a lattice,
each sample a uniform neighbour in a 5×5 window, weight led by the squared
distance), ``grid`` (4-neighbour lattice links, light, plus heavy random
shortcuts), ``chain`` (a path, half the samples duplicates) and ``star``
(every edge on vertex 0, each spoke twice).

PyTorch's gathers raise on an out-of-range index and its scatters have no
drop mode, so a dropped lane writes into one extra slot past the end of its
buffer, which is never read.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import keys as keys_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core import runtime
from repro_torch.core.graph import PAD_VERTEX, Graph, preprocess

KINDS = ("rmat", "random", "geo_knn", "grid", "chain", "star")

# R-MAT quadrant thresholds (a=0.57, b=0.19, c=0.19 — Graph500), each the
# float32 value as a Python float: exact in float32 and in double, so the
# comparison with a float32 sample is the same under either promotion.
_RMAT_T = tuple(float(np.float32(t)) for t in (0.57, 0.76, 0.95))
_GEO_WINDOW = 2                     # 5×5 neighbour window
_MASK64 = (1 << 64) - 1
_PAD = int(PAD_VERTEX)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static description of one generated graph."""

    kind: str
    scale: int                      # log2(num_vertices)
    avg_degree: int = 32
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown generator kind {self.kind!r}; options: {KINDS}")
        if not 1 <= self.scale <= 26:
            # scale 0 has no valid chain/star edge; > 26 overflows the
            # narrow-key/pid packings and any realistic sample buffer.
            raise ValueError(f"scale must be in [1, 26], got {self.scale}")

    @property
    def num_vertices(self) -> int:
        return 1 << self.scale

    @property
    def num_samples(self) -> int:
        """Raw (possibly loop/multi-edge) samples drawn, before §3.1."""
        n = self.num_vertices
        if self.kind in ("rmat", "random", "geo_knn"):
            return n * self.avg_degree // 2
        if self.kind == "grid":
            return 2 * n + max(n // 16, 1)      # lattice links + shortcuts
        return 2 * max(n - 1, 1)                # chain / star: spokes twice


# ---------------------------------------------------------------------------
# Counter-based RNG
# ---------------------------------------------------------------------------

def _stream_base(seed: int, stream: int) -> int:
    """Per-(seed, stream) xor constant, in exact Python ints, as the int64
    with its bits."""
    return keys_lib.signed64(
        ((seed * 0x9E3779B97F4A7C15) ^ (stream * 0xD6E8FEB86659FD93)
         ^ 0xA5A5A5A55A5A5A5A) & _MASK64)


def _rand_u64(seed: int, stream: int, ctr: torch.Tensor) -> torch.Tensor:
    """splitmix64 over int64 counters: raw 64-bit words."""
    return keys_lib.splitmix64_torch(ctr ^ _stream_base(seed, stream))


def _rand_u64_host(seed: int, stream: int, ctr: int) -> int:
    """One word of :func:`_rand_u64`, computed on the host with numpy."""
    base = np.uint64(_stream_base(seed, stream) & _MASK64)
    x = np.array([ctr], np.uint64) ^ base
    return int(keys_lib.splitmix64(x)[0])


def _to_f32_unit(bits23: torch.Tensor) -> torch.Tensor:
    """Exact (0, 1) float32 from 23 random bits: int→float32, + 0.5, × 2⁻²³,
    each a separate float32 operation."""
    w = bits23.to(torch.float32)
    w = w + 0.5
    return w * (2.0 ** -23)


def _unif01(seed: int, stream: int, ctr: torch.Tensor) -> torch.Tensor:
    return _to_f32_unit(keys_lib.lsr(_rand_u64(seed, stream, ctr), 41))


# ---------------------------------------------------------------------------
# Samplers — pure (seed, counter) → (src, dst int64, weight float32)
# ---------------------------------------------------------------------------
# Invalid samples are emitted as self-loops; §3.1 preprocessing drops them.

def _sample_rmat(spec: GraphSpec, ctr):
    n, seed = spec.num_vertices, spec.seed
    src = torch.zeros_like(ctr)
    dst = torch.zeros_like(ctr)
    for lvl in range(spec.scale):
        r = _unif01(seed, lvl, ctr)
        q = ((r >= _RMAT_T[0]).to(torch.int64) + (r >= _RMAT_T[1]).to(torch.int64)
             + (r >= _RMAT_T[2]).to(torch.int64))
        src = (src << 1) | (q >> 1)
        dst = (dst << 1) | (q & 1)
    # Affine odd-multiplier scramble mod n (a power of two): the low bits of
    # the wrapping int64 product are those of the uint64 one.
    mul = keys_lib.signed64(_rand_u64_host(seed, 97, 1) | 1)
    add = keys_lib.signed64(_rand_u64_host(seed, 98, 1))
    src = (src * mul + add) & (n - 1)
    dst = (dst * mul + add) & (n - 1)
    return src, dst, _unif01(seed, 64, ctr)


def _sample_random(spec: GraphSpec, ctr):
    n, seed = spec.num_vertices, spec.seed
    src = _rand_u64(seed, 0, ctr) & (n - 1)
    dst = _rand_u64(seed, 1, ctr) & (n - 1)
    return src, dst, _unif01(seed, 2, ctr)


def _sample_geo_knn(spec: GraphSpec, ctr):
    n, seed = spec.num_vertices, spec.seed
    side = 1 << (spec.scale // 2)
    rows = n // side
    W = _GEO_WINDOW
    u = _rand_u64(seed, 0, ctr) & (n - 1)
    dx = keys_lib.umod(_rand_u64(seed, 1, ctr), 2 * W + 1) - W
    dy = keys_lib.umod(_rand_u64(seed, 2, ctr), 2 * W + 1) - W
    vx = u % side
    vy = u // side
    nx = (vx + dx).clamp(0, side - 1)
    ny = (vy + dy).clamp(0, rows - 1)
    v = ny * side + nx
    dist2 = (nx - vx) ** 2 + (ny - vy) ** 2                 # ≤ 2W²
    # Weight bits: distance in the high lane, hash jitter in the low lane;
    # below 2²³, so the int→float32 conversion is exact.
    wbits = (dist2 << 19) | (_rand_u64(seed, 3, ctr) & ((1 << 19) - 1))
    return u, v, _to_f32_unit(wbits)


def _sample_grid(spec: GraphSpec, ctr):
    n, seed = spec.num_vertices, spec.seed
    side = 1 << (spec.scale // 2)
    rows = n // side
    is_right = ctr < n
    is_down = (ctr >= n) & (ctr < 2 * n)
    lattice = is_right | is_down
    v = ctr & (n - 1)
    vx = v % side
    vy = v // side
    # Border links clamp to self-loops (dropped): a road grid, not a torus.
    right = torch.where(vx < side - 1, v + 1, v)
    down = torch.where(vy < rows - 1, v + side, v)
    su = _rand_u64(seed, 10, ctr) & (n - 1)
    sv = _rand_u64(seed, 11, ctr) & (n - 1)
    src = torch.where(lattice, v, su)
    dst = torch.where(is_right, right, torch.where(is_down, down, sv))
    # Lattice roads are light (< 0.5); shortcuts are heavy (≥ 0.5) highways.
    bits22 = _rand_u64(seed, 12, ctr) & ((1 << 22) - 1)
    wbits = torch.where(lattice, bits22, bits22 | (1 << 22))
    return src, dst, _to_f32_unit(wbits)


def _sample_chain(spec: GraphSpec, ctr):
    n, seed = spec.num_vertices, spec.seed
    links = max(n - 1, 1)
    j = torch.where(ctr < links, ctr,
                    keys_lib.umod(_rand_u64(seed, 5, ctr), links))
    return j, j + 1, _unif01(seed, 6, ctr)


def _sample_star(spec: GraphSpec, ctr):
    n, seed = spec.num_vertices, spec.seed
    spoke = ctr % max(n - 1, 1) + 1
    return torch.zeros_like(ctr), spoke, _unif01(seed, 7, ctr)


_SAMPLERS = {
    "rmat": _sample_rmat,
    "random": _sample_random,
    "geo_knn": _sample_geo_knn,
    "grid": _sample_grid,
    "chain": _sample_chain,
    "star": _sample_star,
}


def raw_samples(spec: GraphSpec, ctr: Optional[torch.Tensor] = None,
                device=None):
    """Raw ``(src, dst, weight)`` samples (int64, int64, float32) of the
    counters ``ctr`` (int64; default ``0..num_samples-1`` on ``device``:
    the CUDA card when ``device`` is None, raising when there is none)."""
    if ctr is None:
        ctr = torch.arange(spec.num_samples, dtype=torch.int64,
                           device=runtime.resolve_device(device))
    return _SAMPLERS[spec.kind](spec, ctr)


# ---------------------------------------------------------------------------
# Edge sampling — the Filter-Borůvka counter-based sampler
# ---------------------------------------------------------------------------
# A sample decision is a pure function of (seed, canonical edge id), on the
# same splitmix64 finalizer as the generators, so it does not depend on
# where an edge is stored.

_SAMPLE_STREAM = 0x5A17                 # disjoint from generator streams


def sample_mask(seed: int, rate: float, eid: torch.Tensor) -> torch.Tensor:
    """Bernoulli(rate) keep-mask over canonical edge ids (int64 tensor).

    Endpoints are exact: rate ≤ 0 keeps nothing, rate ≥ 1 keeps all."""
    if rate <= 0.0:
        return torch.zeros(eid.shape, dtype=torch.bool, device=eid.device)
    if rate >= 1.0:
        return torch.ones(eid.shape, dtype=torch.bool, device=eid.device)
    thresh = int(rate * 2.0 ** 64)
    return keys_lib.ult(_rand_u64(seed, _SAMPLE_STREAM, eid), thresh)


def sample_mask_fixed_k(seed: int, k: int, eid: torch.Tensor) -> torch.Tensor:
    """Keep exactly the ``k`` smallest splitmix64 draws (ties only widen the
    sample): a global order statistic over the whole id range."""
    if k <= 0:
        return torch.zeros(eid.shape, dtype=torch.bool, device=eid.device)
    if k >= int(eid.shape[0]):
        return torch.ones(eid.shape, dtype=torch.bool, device=eid.device)
    h = _rand_u64(seed, _SAMPLE_STREAM, eid) ^ keys_lib.SIGN   # unsigned order
    kth = torch.sort(h).values[k - 1]
    return h <= kth


def sample_device_edges(edges: "DeviceEdges", rate: float,
                        seed: int = 0) -> torch.Tensor:
    """Bernoulli sample over a :class:`DeviceEdges` buffer: a (capacity,)
    bool tensor on its device.  The decision reads each slot's canonical id
    from the key's low lane (the sign flip leaves it as it is); padding
    slots are never sampled."""
    eid = edges.key & keys_lib.LANE_MASK
    return sample_mask(seed, rate, eid) & (edges.key != keys_lib.INF_KEY)


# ---------------------------------------------------------------------------
# Host oracle
# ---------------------------------------------------------------------------

def build_host(spec: GraphSpec) -> Graph:
    """The samplers on the CPU, then :func:`graph.preprocess` for §3.1: the
    oracle the device build is held byte-identical to."""
    src, dst, w = raw_samples(spec, device="cpu")
    return preprocess(src.numpy(), dst.numpy(), w.numpy(), spec.num_vertices)


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceEdges:
    """Canonical (preprocessed) edges resident on a device.

    ``src``/``dst`` (int32) and ``key`` (flipped int64, as
    :attr:`Graph.packed_keys`) have a power-of-two capacity; slots from
    ``num_edges`` on hold the padding sentinels (``PAD_VERTEX``,
    ``INF_KEY``).  Slot *i* is canonical edge *i* of the byte-identical host
    graph.
    """

    num_vertices: int
    num_edges: int
    src: torch.Tensor
    dst: torch.Tensor
    key: torch.Tensor
    spec: Optional[GraphSpec] = None

    @property
    def capacity(self) -> int:
        return int(self.src.shape[0])

    @functools.cached_property
    def _host_graph(self) -> Graph:
        m = self.num_edges
        # One device→host copy: the three live prefixes as one byte buffer.
        parts = (self.src[:m], self.dst[:m], self.key[:m])
        raw = torch.cat([p.contiguous().view(torch.uint8) for p in parts])
        raw = raw.cpu().numpy()
        src = raw[:4 * m].view(np.int32)
        dst = raw[4 * m:8 * m].view(np.int32)
        key = raw[8 * m:].view(np.int64)
        return Graph(num_vertices=self.num_vertices, src=src, dst=dst,
                     weight=keys_lib.unpack_weight_np(key))

    def to_graph(self) -> Graph:
        """Host mirror (one device→host fetch, cached)."""
        return self._host_graph


def _capacity(spec: GraphSpec, num_shards: int = 1) -> int:
    """Power-of-two capacity ≥ num_samples, divisible by the shard count."""
    return partition_lib.pow2ceil(
        -(-max(spec.num_samples, 8) // num_shards)) * num_shards


def _put(fill: int, dtype, cap: int, idx: torch.Tensor,
         vals: torch.Tensor) -> torch.Tensor:
    """``(cap,)`` buffer of ``fill`` with ``vals`` written at ``idx``; lanes
    with ``idx == cap`` land in an extra slot that is cut off."""
    out = torch.full((cap + 1,), fill, dtype=dtype, device=vals.device)
    out.scatter_(0, idx, vals.to(dtype))
    return out[:cap]


def _first_of_runs(run: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """True at each valid lane whose sorted ``run`` id differs from its
    predecessor's."""
    head = torch.ones(1, dtype=torch.bool, device=run.device)
    return valid & torch.cat([head, run[1:] != run[:-1]])


def _preprocess_device(src, dst, w, ctr, *, num_samples: int, cap: int,
                       scale: int):
    """§3.1 on the device, byte-identical to :func:`graph.preprocess`.

    ``src``/``dst`` int64, ``w`` float32, ``ctr`` int64, all ``(cap,)``.
    Padding lanes (counter ≥ ``num_samples``) and self-loops sort to the
    tail under the all-ones word and are dropped.  Returns the canonical
    ``(src, dst, key)`` buffers and the edge count (a device scalar).

    **Narrow path** (``2·scale + 30 ≤ 64``): a weight in (0, 1) has zero
    sign and exponent-MSB bits, so ``(u ‖ v ‖ weight-bits)`` is one 64-bit
    word, sorted sign-flipped (unsigned order); each pair's first word is
    its min-weight copy and every field unpacks from it.

    **General path**: the pair id ``u ‖ v`` (below 2⁶³) is sorted with the
    weight as a payload, and each pair's min weight comes from a float32
    scatter-min; equal pair ids may come out in any order, since only the
    min survives.
    """
    lsr = keys_lib.lsr
    u = torch.minimum(src, dst)
    v = torch.maximum(src, dst)
    drop = (u == v) | (ctr >= num_samples)
    slots = torch.arange(cap, dtype=torch.int64, device=src.device)

    if 2 * scale + 30 <= 64:
        wbits = w.view(torch.int32).to(torch.int64)       # < 2**30 in (0, 1)
        word = (u << (scale + 30)) | (v << 30) | wbits
        key_s = torch.sort(torch.where(drop, keys_lib.INF_KEY,
                                       word ^ keys_lib.SIGN)).values
        valid = key_s != keys_lib.INF_KEY
        raw = keys_lib.unflip(key_s)
        pid_s = lsr(raw, 30)                              # (u ‖ v)
        first = _first_of_runs(pid_s, valid)
        count = first.sum()
        idx = torch.where(first, torch.cumsum(first, 0) - 1, cap)
        out_src = _put(_PAD, torch.int32, cap, idx, lsr(pid_s, scale))
        out_dst = _put(_PAD, torch.int32, cap, idx, pid_s & ((1 << scale) - 1))
        out_wb = _put(0, torch.int64, cap, idx, raw & ((1 << 30) - 1))
        out_key = torch.where(slots < count,
                              ((out_wb << 32) | slots) ^ keys_lib.SIGN,
                              keys_lib.INF_KEY)
        return out_src, out_dst, out_key, count

    pid = torch.where(drop, keys_lib.INF_KEY, (u << 32) | v)
    pid_s, order = torch.sort(pid)
    w_s = w[order]
    valid = pid_s != keys_lib.INF_KEY
    first = _first_of_runs(pid_s, valid)
    count = first.sum()
    # pos: canonical edge id of each lane's pair group (groups are pid-sorted
    # runs, so a group's rank is its edge index, as in the oracle).
    pos = torch.cumsum(first, 0) - 1
    minw = torch.full((cap + 1,), float("inf"), dtype=torch.float32,
                      device=w.device)
    minw.scatter_reduce_(0, torch.where(valid, pos, cap), w_s, "amin")
    idx = torch.where(first, pos, cap)          # one representative a group
    out_src = _put(_PAD, torch.int32, cap, idx, pid_s >> 32)
    out_dst = _put(_PAD, torch.int32, cap, idx, pid_s & keys_lib.LANE_MASK)
    out_key = torch.where(slots < count,
                          keys_lib.pack_keys(minw[:cap], slots),
                          keys_lib.INF_KEY)
    return out_src, out_dst, out_key, count


def build(spec: GraphSpec, mesh=None, device=None) -> DeviceEdges:
    """Generate and preprocess ``spec`` on the device.

    ``device=None`` builds on the CUDA card and raises when there is none;
    ``device="cpu"`` runs the same ops on the CPU.  The one blocking
    transfer is the deduped edge count.  The result is byte-identical to
    :func:`build_host` of the same spec.

    Under a mesh (:class:`repro_torch.sharding.mesh.Mesh`) the build runs
    on its device with a capacity the shard count divides: shard s's
    slice of the canonical buffer is block s of the engines' edge layout,
    so :func:`runtime.prepare_edges` hands it to the Borůvka engine in
    place.  The reference has every shard run the counter-based build and
    keep its slice; with all shards on one device one build is that.
    """
    S, dev = runtime.resolve_mesh(mesh, device)
    cap = _capacity(spec, S)
    ctr = torch.arange(cap, dtype=torch.int64, device=dev)
    src, dst, w = _SAMPLERS[spec.kind](spec, ctr)
    out_src, out_dst, out_key, count = _preprocess_device(
        src, dst, w, ctr, num_samples=spec.num_samples, cap=cap,
        scale=spec.scale)
    del src, dst, w, ctr                   # free the sample buffers
    num_edges = int(count)                 # the build's one host sync
    return DeviceEdges(num_vertices=spec.num_vertices, num_edges=num_edges,
                       src=out_src, dst=out_dst, key=out_key, spec=spec)


# ---------------------------------------------------------------------------
# Batched packing — many graphs per engine dispatch
# ---------------------------------------------------------------------------

BATCH_BUCKETS = ("pow2", "exact")


@dataclasses.dataclass
class GraphBatch:
    """One shape bucket of a packed multi-graph batch (numpy, host).

    All lanes share the padded shape ``(n_pad, cap)``: lane *r* holds graph
    ``graphs[r]`` (position ``indices[r]`` of the caller's sequence) with
    its canonical edges in slots ``[0, num_edges[r])`` and the padding
    sentinels behind them (``PAD_VERTEX`` endpoints, ``INF_KEY`` keys).
    Vertices ``[num_vertices[r], n_pad)`` own no edges and stay isolated.
    ``key`` is the port's flipped int64; ``slot`` the per-lane slot
    side-lane (:func:`partition.batched_slots`).
    """

    indices: tuple
    graphs: tuple
    n_pad: int
    cap: int
    num_vertices: np.ndarray        # (B,) int64
    num_edges: np.ndarray           # (B,) int64
    src: np.ndarray                 # (B, cap) int32
    dst: np.ndarray                 # (B, cap) int32
    key: np.ndarray                 # (B, cap) int64, flipped
    slot: np.ndarray                # (B, cap) int32

    @property
    def batch_size(self) -> int:
        return len(self.indices)

    def unpack(self, mask_batch) -> list:
        """Per-lane :class:`ForestResult` list from a (B, cap) winner bitmap
        — one device→host fetch for the whole bucket."""
        if isinstance(mask_batch, torch.Tensor):
            mask_batch = mask_batch.cpu().numpy()
        masks = np.asarray(mask_batch, dtype=bool)
        out = []
        for r, g in enumerate(self.graphs):
            m = int(self.num_edges[r])
            layout = partition_lib.identity_layout(m, self.cap)
            canon = layout.canonical_mask(masks[r], m)
            res = runtime.forest_from_mask(g, canon)
            res.check_consistent(g.num_vertices)
            out.append(res)
        return out


def _bucket_shape(n: int, m: int, bucket: str) -> Tuple[int, int]:
    """Padded (n_pad, cap) of one graph under a bucketing policy: an
    edgeless graph gets ``cap=1`` under ``"exact"`` but ``cap=8`` under
    ``"pow2"`` (the shared floor)."""
    pow2ceil = partition_lib.pow2ceil
    if bucket == "pow2":
        return pow2ceil(max(n, 1)), pow2ceil(max(m, 8))
    return max(n, 1), max(m, 1)


def bucket_shape(
    num_vertices: int,
    num_edges: int,
    *,
    bucket: str = "pow2",
    max_vertices: Optional[int] = None,
    max_edges: Optional[int] = None,
) -> Tuple[int, int]:
    """Admission key of one graph: the padded ``(n_pad, cap)``
    :func:`pack_batch` would give it, with its ``ValueError``s for an
    unknown policy or a graph over ``max_vertices`` / ``max_edges``."""
    if bucket not in BATCH_BUCKETS:
        raise ValueError(
            f"unknown batch bucket policy {bucket!r}; options: "
            f"{BATCH_BUCKETS}")
    n, m = int(num_vertices), int(num_edges)
    if max_vertices is not None and n > max_vertices:
        raise ValueError(
            f"graph exceeds pack_batch capacity: num_vertices={n} "
            f"> max_vertices={max_vertices}")
    if max_edges is not None and m > max_edges:
        raise ValueError(
            f"graph exceeds pack_batch capacity: num_edges={m} "
            f"> max_edges={max_edges}")
    return _bucket_shape(n, m, bucket)


def pack_bucket(graphs, n_pad: int, cap: int, *,
                indices: Optional[tuple] = None) -> GraphBatch:
    """Pack a queue of graphs already routed to bucket ``(n_pad, cap)``
    into one :class:`GraphBatch`; a graph that does not fit raises
    ``ValueError``.  ``indices`` defaults to ``0..B-1``."""
    graph_list = list(graphs)
    if not graph_list:
        raise ValueError("pack_bucket needs at least one graph")
    idxs = tuple(range(len(graph_list))) if indices is None \
        else tuple(indices)
    if len(idxs) != len(graph_list):
        raise ValueError(
            f"indices length {len(idxs)} != batch size {len(graph_list)}")
    bsz = len(graph_list)
    src = np.full((bsz, cap), PAD_VERTEX, np.int32)
    dst = np.full((bsz, cap), PAD_VERTEX, np.int32)
    key = np.full((bsz, cap), keys_lib.INF_KEY, np.int64)
    for r, g in enumerate(graph_list):
        n, m = g.num_vertices, g.num_edges
        if n > n_pad or m > cap:
            raise ValueError(
                f"lane {r} does not fit bucket ({n_pad}, {cap}): "
                f"num_vertices={n}, num_edges={m}")
        src[r, :m] = g.src
        dst[r, :m] = g.dst
        key[r, :m] = g.packed_keys
    return GraphBatch(
        indices=idxs,
        graphs=tuple(graph_list),
        n_pad=int(n_pad), cap=int(cap),
        num_vertices=np.array(
            [g.num_vertices for g in graph_list], np.int64),
        num_edges=np.array([g.num_edges for g in graph_list], np.int64),
        src=src, dst=dst, key=key,
        slot=partition_lib.batched_slots(bsz, cap))


def pack_batch(
    graphs,
    *,
    bucket: str = "pow2",
    max_vertices: Optional[int] = None,
    max_edges: Optional[int] = None,
) -> list:
    """Bucket ``graphs`` by padded shape and pack each bucket.

    ``"pow2"`` rounds each graph's (n, m) up to powers of two so mixed
    sizes share a bucket; ``"exact"`` groups only identical shapes.  A
    graph over ``max_vertices`` / ``max_edges`` raises ``ValueError``.
    Buckets come back sorted by shape.
    """
    if bucket not in BATCH_BUCKETS:
        raise ValueError(
            f"unknown batch bucket policy {bucket!r}; options: "
            f"{BATCH_BUCKETS}")
    graph_list = list(graphs)
    buckets: dict = {}
    for i, g in enumerate(graph_list):
        n, m = g.num_vertices, g.num_edges
        if max_vertices is not None and n > max_vertices:
            raise ValueError(
                f"graph {i} exceeds pack_batch capacity: num_vertices={n} "
                f"> max_vertices={max_vertices}")
        if max_edges is not None and m > max_edges:
            raise ValueError(
                f"graph {i} exceeds pack_batch capacity: num_edges={m} "
                f"> max_edges={max_edges}")
        buckets.setdefault(_bucket_shape(n, m, bucket), []).append(i)

    return [
        pack_bucket([graph_list[i] for i in idxs], n_pad, cap,
                    indices=tuple(idxs))
        for (n_pad, cap), idxs in sorted(buckets.items())
    ]
