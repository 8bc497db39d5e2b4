"""State containers and host-side initialization of the paper-faithful GHS
engine (:mod:`repro_torch.core.ghs_message`).

Vertices are block-distributed across shards (paper §3: "All graph vertices
are sequentially distributed in blocks among the processes"); each shard
holds the CSR adjacency of its owned vertices (both directions),
weight-sorted per vertex so GHS's "probe Basic edges lightest-first" is a
cursor scan.

Message encoding (paper §3.5 / C3): a message is ``LANES`` uint32 words.
Compressed layout (5 lanes = 160 bits):

    [0] hdr  = type(3b) | state(1b) | level(28b)
    [1] src  vertex (global id)
    [2] dst  vertex (global id)
    [3] fw   weight bits   (fragment id / report weight, hi word)
    [4] fe   tiebreak lane (fragment id / report weight, lo word)

Uncompressed ablation layout (8 lanes = 256 bits): one field per lane.

The edge hash (§3.3, technique C2) replaces the linear search of a
vertex's edge list with an open-addressing table keyed on the ``(receiver,
sender)`` pair: :func:`hash_slot` and the host-side linear-probe build
:func:`_build_hash_table`.  :func:`hash_slot` computes the uint32
wraparound arithmetic on numpy arrays, and on torch tensors without uint32:
a product ``x * HASH_K1`` of two 32-bit words overflows int64, so the low
32 bits are formed from the two 16-bit halves of the constant.

:class:`ShardState` holds torch tensors with the JAX package's fields,
shapes and dtypes, except that its uint32 words (``WORD_FIELDS``) are
carried as int32 tensors of the same bits (torch has few uint32
operations); only the superstep kernel and its plain version read them,
as uint32.  :func:`init_shards` lays every shard out in numpy and uploads
each shard's arrays in one copy.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import graph as graph_lib
from repro_torch.core.graph import Graph
from repro_torch.core.params import GHSParams

INF32 = np.uint32(0xFFFFFFFF)

# Sentinel for the local-queue position side-lane: the message's edge has
# not been batch-resolved yet; dispatch must run the scalar probe (-1 is
# reserved for a genuine miss, which is an ERR_HASH_MISS).
POS_UNRESOLVED = np.int32(-2)

# Message types (3 bits).
CONNECT, INITIATE, TEST, ACCEPT, REJECT, REPORT, CHANGE_CORE = range(7)
MSG_NAMES = ("Connect", "Initiate", "Test", "Accept", "Reject", "Report",
             "ChangeCore")
# Vertex states.
SLEEPING, FIND, FOUND = 0, 1, 2
# Edge states.
BASIC, BRANCH, REJECTED = 0, 1, 2

# Hash mixing constants (32-bit adaptation of the paper's
# ((u << 32) | v) mod T).
HASH_K1 = np.uint32(2654435761)
HASH_K2 = np.uint32(2246822519)
_LOW32 = 0xFFFFFFFF


def _mul_low32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(x * k) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, without
    overflow: each partial product stays below ``2**48``."""
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _LOW32


def mix32(lv: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The uint32 hash word of each ``(lv, u)`` pair, as int64 in
    ``[0, 2**32)``; a lane of -1 is the uint32 ``0xFFFFFFFF``."""
    a = lv.to(torch.int64) & _LOW32
    b = u.to(torch.int64) & _LOW32
    return _mul_low32(a, int(HASH_K1)) ^ _mul_low32(b, int(HASH_K2))


def hash_slot(lv, u, table_size):
    """Home slot of each ``(lv, u)`` pair in a table of ``table_size``
    slots (int32).  numpy arrays take the reference's uint32 arithmetic;
    torch tensors the overflow-free int64 form of :func:`mix32`."""
    if isinstance(lv, torch.Tensor):
        return (mix32(lv, u) % int(table_size)).to(torch.int32)
    mixed = (lv.astype(np.uint32) * HASH_K1) ^ (u.astype(np.uint32) * HASH_K2)
    return (mixed % np.uint32(table_size)).astype(np.int32)


def _build_hash_table(lv: np.ndarray, u: np.ndarray, pos: np.ndarray,
                      tsize: int):
    """Vectorized linear-probe insertion (Knuth 6.4, paper §3.3).

    Each round places, for every empty slot that pending entries probe,
    the first of them (in entry order); the others move one slot on.
    Returns the three int32 arrays ``(h_lv, h_u, h_pos)``; an empty slot
    holds -1 in all three.
    """
    h_lv = np.full(tsize, -1, np.int32)
    h_u = np.full(tsize, -1, np.int32)
    h_pos = np.full(tsize, -1, np.int32)
    idx = hash_slot(lv, u, tsize).astype(np.int32)
    pending = np.arange(lv.shape[0], dtype=np.int32)
    for _probe in range(tsize + 1):
        if pending.size == 0:
            break
        slots = idx[pending]
        empty = h_pos[slots] < 0
        cand = pending[empty]
        cslots = slots[empty]
        # first writer wins per slot this round
        uniq, first = np.unique(cslots, return_index=True)
        winners = cand[first]
        h_lv[uniq] = lv[winners]
        h_u[uniq] = u[winners]
        h_pos[uniq] = pos[winners]
        placed = np.zeros(lv.shape[0], dtype=bool)
        placed[winners] = True
        pending = pending[~placed[pending]]
        idx[pending] = (idx[pending] + 1) % tsize
    else:
        raise RuntimeError("hash table build did not converge")
    return h_lv, h_u, h_pos


class ShardState(NamedTuple):
    """Per-shard GHS state: torch tensors on the engine's device, with no
    leading shard axis (:func:`stack_shards` adds one).  The fields marked
    u32 are ``WORD_FIELDS``: int32 tensors holding the uint32 bits."""

    # --- vertex state (nb,) ---
    sn: torch.Tensor          # i32 vertex state
    ln: torch.Tensor          # u32 fragment level
    fnw: torch.Tensor         # u32 fragment id (weight bits)
    fne: torch.Tensor         # u32 fragment id (tiebreak)
    find_count: torch.Tensor  # i32
    in_branch: torch.Tensor   # i32 CSR position or -1
    best_edge: torch.Tensor   # i32 CSR position or -1
    best_w: torch.Tensor      # u32
    best_e: torch.Tensor      # u32
    test_edge: torch.Tensor   # i32 CSR position or -1
    # --- adjacency (static topology) ---
    indptr: torch.Tensor      # (nb+1,) i32, weight-sorted windows
    nbr: torch.Tensor         # (eb,) i32 global neighbor
    ceid: torch.Tensor        # (eb,) i32 canonical edge id
    ewb: torch.Tensor         # (eb,) u32 weight bits
    etb: torch.Tensor         # (eb,) u32 tiebreak (canonical id)
    byid: torch.Tensor        # (eb,) i32 window positions sorted by neighbor
    se: torch.Tensor          # (eb,) i32 edge state (mutable)
    # --- hash table (static) ---
    h_lv: torch.Tensor        # (T,) i32 local vertex key (-1 empty)
    h_u: torch.Tensor         # (T,) i32 neighbor key
    h_pos: torch.Tensor       # (T,) i32 CSR position
    # --- queues (``*_pos`` side-lanes carry the batch-resolved CSR
    #     position of each queued message, or POS_UNRESOLVED) ---
    mq: torch.Tensor          # (qcap, lanes) u32 main queue ring
    mq_pos: torch.Tensor      # (qcap,) i32
    mq_head: torch.Tensor     # i32 scalar
    mq_tail: torch.Tensor     # i32 scalar
    tq: torch.Tensor          # (qcap, lanes) u32 test queue ring
    tq_pos: torch.Tensor      # (qcap,) i32
    tq_head: torch.Tensor     # i32 scalar
    tq_tail: torch.Tensor     # i32 scalar
    # --- outgoing rings, one per destination shard ---
    og: torch.Tensor          # (S, ocap, lanes) u32
    og_head: torch.Tensor     # (S,) i32
    og_tail: torch.Tensor     # (S,) i32
    # --- inbox (filled by the exchange) ---
    inbox: torch.Tensor       # (S, xcap, lanes) u32
    in_cnt: torch.Tensor      # (S,) i32
    # --- flags / counters (i32 scalars) ---
    err: torch.Tensor         # bitmask: 1 queue overflow, 2 hash miss, 4 logic
    halted: torch.Tensor      # fragments that reported w = best = inf
    n_processed: torch.Tensor    # messages popped (repeats included)
    n_productive: torch.Tensor   # messages that were not postponed
    n_sent_remote: torch.Tensor  # messages that crossed shards
    n_sent_local: torch.Tensor   # loopback messages
    # --- per-superstep histories (capacity 1 unless the driver asked for
    #     history; writes out of range are dropped) ---
    hist_act: torch.Tensor    # (hcap,) i32 global activity after superstep k
    hist_sent: torch.Tensor   # (hcap,) i32 cumulative remote sends after k


WORD_FIELDS = frozenset(("ln", "fnw", "fne", "best_w", "best_e", "ewb", "etb",
                         "mq", "tq", "og", "inbox"))


@dataclasses.dataclass(frozen=True)
class GHSTopology:
    """Static layout info shared by the driver and the superstep."""

    num_shards: int
    block: int          # vertices per shard
    nb: int             # == block
    eb: int             # padded adjacency entries per shard
    qcap: int
    ocap: int
    xcap: int           # exchange bucket capacity (paper MAX_MSG_SIZE)
    tsize: int          # hash table slots
    lanes: int          # 5 compressed / 8 uncompressed
    num_vertices: int
    num_edges: int


def encode_messages(
    lanes: int, mtype, level, state, src, dst, fw, fe
) -> np.ndarray:
    """Vectorized numpy encoder (init-time Connect(0) wave)."""
    n = len(np.atleast_1d(src))
    out = np.zeros((n, lanes), dtype=np.uint32)
    if lanes == 5:
        hdr = (np.uint32(mtype) | (np.uint32(state) << np.uint32(3))
               | (np.asarray(level, np.uint32) << np.uint32(4)))
        out[:, 0] = hdr
        out[:, 1] = src
        out[:, 2] = dst
        out[:, 3] = fw
        out[:, 4] = fe
    else:
        out[:, 0] = mtype
        out[:, 1] = level
        out[:, 2] = state
        out[:, 3] = src
        out[:, 4] = dst
        out[:, 5] = fw
        out[:, 6] = fe
    return out


def host_shards(
    graph: Graph, num_shards: int, params: GHSParams,
    history_capacity: int = 1,
) -> tuple[GHSTopology, list[dict]]:
    """The shards as numpy arrays in the JAX package's dtypes: one dict of
    ``ShardState`` fields a shard (see :func:`init_shards`)."""
    n = graph.num_vertices
    # Flipped int64 keys (keys.py): their signed order is the unsigned
    # order of the reference's uint64 keys, so the sort below gives the
    # reference's windows.
    wkey = graph.packed_keys
    block = -(-n // num_shards)
    lanes = 5 if params.compress_messages else 8
    hcap = max(int(history_capacity), 1)

    # Both-direction adjacency, weight-sorted within each vertex window
    # (paper §3.3 "probe Basic edges lightest-first" for free).
    ends, gnbr, geid = graph_lib.both_direction_arrays(graph)
    gnbr = gnbr.astype(np.int32)
    geid = geid.astype(np.int32)
    order = np.lexsort((wkey[geid], ends))
    ends, gnbr, geid = ends[order], gnbr[order], geid[order]
    gptr = graph_lib.vertex_indptr(ends, n)
    deg = np.diff(gptr)
    # Per-window neighbor-id order (binary-search ablation).
    gbyid = np.lexsort((gnbr, ends)).astype(np.int64)

    shard_edges = [
        int(deg[s * block: min(n, (s + 1) * block)].sum())
        for s in range(num_shards)
    ]
    eb = max(max(shard_edges), 1)
    xcap = max(int(params.max_msg_size), 64)
    if params.queue_capacity:
        qcap = int(params.queue_capacity)
    else:
        # One superstep appends at most the full exchange (S·xcap) plus
        # locally generated traffic: a vertex's Initiate fan-out (≤ max
        # degree) and the wake-up wave (≤ block), each with a 2-4x margin.
        # Overflow sets ERR_QUEUE_OVERFLOW and raises.
        dmax = int(deg.max()) if deg.size else 0
        qcap = max(4096, 2 * num_shards * xcap, 4 * dmax, 2 * block)
    ocap = qcap
    tsize = (max(64, int(eb * params.hash_table_factor) | 1)
             if params.use_hashing else 1)

    topo = GHSTopology(
        num_shards=num_shards, block=block, nb=block, eb=eb, qcap=qcap,
        ocap=ocap, xcap=xcap, tsize=tsize, lanes=lanes,
        num_vertices=n, num_edges=graph.num_edges,
    )

    shards = []
    for s in range(num_shards):
        v0, v1 = s * block, min(n, (s + 1) * block)
        nloc = v1 - v0
        a0, a1 = int(gptr[v0]), int(gptr[v1])
        mloc = a1 - a0
        nbr = gnbr[a0:a1].astype(np.int32)
        eid = geid[a0:a1].astype(np.int32)
        indptr = np.zeros(block + 1, np.int32)
        indptr[1:nloc + 1] = (gptr[v0 + 1:v1 + 1] - a0).astype(np.int32)
        indptr[nloc + 1:] = indptr[nloc]
        pad = eb - mloc
        nbr = np.concatenate([nbr, np.full(pad, -1, np.int32)])
        eid = np.concatenate([eid, np.zeros(pad, np.int32)])
        if graph.num_edges:
            ewb = graph.weight.view(np.uint32)[eid].copy()
        else:
            ewb = np.full(eb, INF32, np.uint32)
        etb = eid.astype(np.uint32)
        ewb[mloc:] = INF32
        etb[mloc:] = INF32
        byid = np.arange(eb, dtype=np.int32)
        byid[:mloc] = (gbyid[a0:a1] - a0).astype(np.int32)
        if params.use_hashing:
            owner_lv = np.repeat(np.arange(nloc, dtype=np.int32),
                                 np.diff(indptr[:nloc + 1]))
            h_lv, h_u, h_pos = _build_hash_table(
                owner_lv, nbr[:mloc], np.arange(mloc, dtype=np.int32), tsize)
        else:
            h_lv = np.full(tsize, -1, np.int32)
            h_u = np.full(tsize, -1, np.int32)
            h_pos = np.full(tsize, -1, np.int32)

        se = np.zeros(eb, np.int32)
        # Spontaneous awakening: every non-isolated owned vertex marks its
        # lightest edge Branch (window start) and queues Connect(0) to that
        # neighbor, in ascending vertex order.
        lvs = np.flatnonzero(np.diff(indptr[:nloc + 1]) > 0).astype(np.int64)
        starts = indptr[lvs]
        se[starts] = BRANCH
        dests = nbr[starts].astype(np.int64)
        wake = encode_messages(lanes, CONNECT, 0, 0,
                               (v0 + lvs).astype(np.uint32),
                               dests.astype(np.uint32), 0, 0) \
            if lvs.size else np.zeros((0, lanes), np.uint32)
        ds_all = dests // block

        mq = np.zeros((qcap, lanes), np.uint32)
        local = ds_all == s
        k = int(local.sum())
        if k > qcap:
            raise RuntimeError(
                f"GHS queue overflow at init: {k} wake-up messages exceed "
                f"queue_capacity={qcap}")
        if k:
            mq[:k] = wake[local]
        og = np.zeros((num_shards, ocap, lanes), np.uint32)
        og_tail = np.zeros(num_shards, np.int32)
        for ds in range(num_shards):
            if ds == s:
                continue
            sel = ds_all == ds
            cnt = int(sel.sum())
            if cnt > ocap:
                raise RuntimeError(
                    f"GHS queue overflow at init: {cnt} wake-up "
                    f"messages exceed queue_capacity={ocap}")
            if cnt:
                og[ds, :cnt] = wake[sel]
                og_tail[ds] = cnt

        zero = np.int32(0)
        shards.append(dict(
            sn=np.full(block, FOUND, np.int32), ln=np.zeros(block, np.uint32),
            fnw=np.zeros(block, np.uint32), fne=np.zeros(block, np.uint32),
            find_count=np.zeros(block, np.int32),
            in_branch=np.full(block, -1, np.int32),
            best_edge=np.full(block, -1, np.int32),
            best_w=np.full(block, INF32, np.uint32),
            best_e=np.full(block, INF32, np.uint32),
            test_edge=np.full(block, -1, np.int32),
            indptr=indptr, nbr=nbr, ceid=eid, ewb=ewb, etb=etb, byid=byid,
            se=se, h_lv=h_lv, h_u=h_u, h_pos=h_pos,
            mq=mq, mq_pos=np.full(qcap, POS_UNRESOLVED, np.int32),
            mq_head=zero, mq_tail=np.int32(k),
            tq=np.zeros((qcap, lanes), np.uint32),
            tq_pos=np.full(qcap, POS_UNRESOLVED, np.int32),
            tq_head=zero, tq_tail=zero,
            og=og, og_head=np.zeros(num_shards, np.int32), og_tail=og_tail,
            inbox=np.zeros((num_shards, xcap, lanes), np.uint32),
            in_cnt=np.zeros(num_shards, np.int32),
            err=zero, halted=zero, n_processed=zero, n_productive=zero,
            n_sent_remote=zero, n_sent_local=zero,
            hist_act=np.zeros(hcap, np.int32),
            hist_sent=np.zeros(hcap, np.int32),
        ))
    return topo, shards


def upload(arrays: dict, device) -> ShardState:
    """One shard's numpy arrays as a :class:`ShardState` on ``device``: the
    arrays' bits packed into one int32 buffer, copied in one transfer and
    cut into views (on the CPU the buffer itself)."""
    flat = [np.asarray(arrays[f]).reshape(-1).view(np.int32)
            for f in ShardState._fields]
    offsets = np.cumsum([0] + [a.size for a in flat])
    buf = torch.from_numpy(np.concatenate(flat)).to(device)
    return ShardState(*[
        buf[int(o):int(o) + a.size].view(np.shape(arrays[f]))
        for f, a, o in zip(ShardState._fields, flat, offsets)])


def host_arrays(state: ShardState) -> dict:
    """A state's arrays on the host in the JAX package's dtypes (uint32
    for ``WORD_FIELDS``), copied."""
    out = {}
    for f in ShardState._fields:
        a = getattr(state, f).detach().cpu().numpy().copy()
        out[f] = a.view(np.uint32) if f in WORD_FIELDS else a
    return out


def init_shards(
    graph: Graph, num_shards: int, params: GHSParams,
    history_capacity: int = 1, device=None,
) -> tuple[GHSTopology, list[ShardState]]:
    """Partition the graph, pre-sort adjacency by weight, build the hash
    tables, wake every vertex (spontaneous awakening) and enqueue its
    Connect(0), on the host (:func:`host_shards`); then upload each shard
    in one copy to ``device`` (the CUDA card by default, raising when
    there is none; ``"cpu"`` keeps it on the host)."""
    from repro_torch.core import runtime
    dev = runtime.resolve_device(device)
    topo, shards = host_shards(graph, num_shards, params, history_capacity)
    return topo, [upload(a, dev) for a in shards]


def stack_shards(shards: list[ShardState]) -> ShardState:
    """Stack per-shard states along a leading axis."""
    return ShardState(*[
        torch.stack([getattr(sh, f) for sh in shards])
        for f in ShardState._fields
    ])
