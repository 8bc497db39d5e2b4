"""Dispatch for the fused Borůvka round body.

Three lowerings of the same masked min-plus election, chosen by the
caller:

* ``"scatter"`` — two scatter-mins (the oracle); always available.
* ``"sort"``    — packs (fragment ‖ weight-bits ‖ edge-id) into one 64-bit
  word, sorts, and reads each fragment's winner with ``searchsorted``;
  gated by :func:`sort_gate` on the bit budget.
* ``"pallas"``  — the kernel lowering: sort by fragment, the masked scan
  kernel (:func:`.spmv_minplus.masked_minplus_scan`), run-end extraction.
  The name is the reference's; in the port it runs the CUDA kernel.

All three are exact min-reductions over identical keys, so they agree bit
for bit.

The converged-connectivity loop of the filter and incremental passes,
:func:`connected_labels` and :func:`component_maxkey`, runs min-hooking and
:func:`shortcut_relabel` (the pointer-jump kernel under ``use_pallas``) on
the tensors' device until no active edge crosses two components.  Under a
mesh the edges carry the shard axis first: each shard hooks its own edges,
the hooks meet in a ``pmin`` (or the compressed exchange), and the pointer
jump runs once on the replicated parents.
"""
from __future__ import annotations

import torch

from repro_torch.core import keys as keys_lib
from repro_torch.core import union_find
from repro_torch.kernels.segment_min.ops import run_end_min
from repro_torch.kernels.spmv_minplus import ref
from repro_torch.kernels.spmv_minplus.spmv_minplus import (
    masked_minplus_scan, pointer_jump)
from repro_torch.sharding import collectives

INF_KEY = keys_lib.INF_KEY
# Weight-bits budget of the sort lowering: engine weights lie in (0, 1), so
# their IEEE-754 patterns are < 0x3F800000 < 2**30.
WEIGHT_BITS = 30
WEIGHT_LIMIT_BITS = 0x3F800000  # ieee754_bits(1.0f)

ELECT_LOWERINGS = ("scatter", "sort", "pallas")
# Label-loop iterations queued between two host reads of the loop's flag.
# Past the fixed point an iteration changes nothing (no active edge
# crosses, ``hook_min`` returns the identity, and the shortcut of the
# identity returns the labels), so the extra iterations of the last batch
# are exact.  A read costs a wait, an idle iteration about ten kernels.
# The rmat-20 filter's 16 levels need 39 iterations in all: on an H100
# the level chain took 22.3, 22.4, 33.7 and 55.8 ms at 1, 2, 4 and 8
# iterations a read, with 55, 37, 33 and 32 reads (chip_smoke.py phase 5c).
LABEL_CHECK_EVERY = 2


def sort_gate(num_vertices: int, num_edges: int) -> "tuple[int, int] | None":
    """(s_bits, c_bits) for the sort lowering, or None when fragment labels
    + 30-bit weights + edge ids cannot share one 64-bit sort word.

    The budget is the full 64 bits, as in the reference: the word is kept
    sign-flipped (``core/keys.py``), so a word with its top bit set still
    sorts in unsigned order and the all-ones dead sentinel sorts last.
    Callers must separately guarantee weight bits < 2**30.
    """
    s_bits = max(int(num_vertices) - 1, 1).bit_length()
    c_bits = max(int(num_edges) - 1, 1).bit_length()
    if s_bits + WEIGHT_BITS + c_bits > 64:
        return None
    return s_bits, c_bits


def _elect_sort(cs, cd, key, *, num_segments, sort_bits):
    """Scatter-free election: one sort + a searchsorted winner probe."""
    _, c_bits = sort_bits
    shift = WEIGHT_BITS + c_bits
    lsr, flip = keys_lib.lsr, keys_lib.SIGN

    u = keys_lib.unflip(key)
    alive = (cs != cd) & (key != INF_KEY)
    # payload = (weight-bits ‖ edge-id), the edge id re-based from the
    # 32-bit lane of the key to the graph's c_bits width.
    payload = (lsr(u, 32) << c_bits) | (u & keys_lib.LANE_MASK)

    def side(seg):
        word = (seg.to(torch.int64) << shift) | payload
        return torch.where(alive, word ^ flip, INF_KEY)   # dead: all ones

    pk, _ = torch.sort(torch.cat([side(cs), side(cd)]))
    m2 = pk.shape[0]
    frag = torch.arange(num_segments, dtype=torch.int64, device=key.device)
    pos = torch.searchsorted(pk, (frag << shift) ^ flip)
    cand = pk[pos.clamp(max=m2 - 1)]
    cu = keys_lib.unflip(cand)
    ok = (pos < m2) & (lsr(cu, shift) == frag) & (cand != INF_KEY)
    pay = cu & ((1 << shift) - 1)
    best = ((lsr(pay, c_bits) << 32) | (pay & ((1 << c_bits) - 1))) ^ flip
    return torch.where(ok, best, INF_KEY)


def _elect_pallas(cs, cd, key, *, num_segments):
    """Kernel election: fragment-sort both directions, masked scan, run-end
    extraction (each fragment's slot written once)."""
    seg2 = torch.cat([cs, cd]).to(torch.int32)
    oth2 = torch.cat([cd, cs]).to(torch.int32)
    key2 = torch.cat([key, key])
    seg2, order = torch.sort(seg2, stable=True)
    scan = masked_minplus_scan(seg2, oth2[order], key2[order])
    return run_end_min(scan, seg2, num_segments)


def elect(cs: torch.Tensor, cd: torch.Tensor, key: torch.Tensor, *,
          num_segments: int, lowering: str = "scatter",
          sort_bits: "tuple[int, int] | None" = None) -> torch.Tensor:
    """Per-fragment minimum-outgoing-edge election over flipped int64 keys.

    ``cs``/``cd`` are the endpoint fragment labels of every edge slot
    (int32), ``key`` the packed keys.  Returns ``best`` of shape
    (num_segments,), INF_KEY where a fragment has no live edge.
    """
    if lowering not in ELECT_LOWERINGS:
        raise ValueError(f"unknown elect lowering: {lowering!r}")
    if cs.shape[0] == 0 or num_segments == 0:
        return torch.full((num_segments,), INF_KEY, dtype=torch.int64,
                          device=key.device)
    if lowering == "sort":
        if sort_bits is None:
            raise ValueError("sort lowering requires sort_bits")
        return _elect_sort(cs, cd, key, num_segments=num_segments,
                           sort_bits=sort_bits)
    if lowering == "pallas":
        return _elect_pallas(cs, cd, key, num_segments=num_segments)
    return ref.elect(cs, cd, key, num_segments=num_segments)


def shortcut_relabel(parent: torch.Tensor, comp: torch.Tensor, *,
                     use_pallas: bool = False) -> torch.Tensor:
    """Fused pointer-jumping shortcut + fragment relabel, equivalent to
    ``union_find.pointer_double(parent)[comp]``; ``use_pallas`` runs the
    pointer-jump kernel.  Returns labels of ``comp``'s dtype."""
    if not use_pallas:
        return ref.shortcut_relabel(parent, comp)
    return pointer_jump(parent.to(torch.int32).contiguous(),
                        comp.to(torch.int32).contiguous()).to(comp.dtype)


def _hook_pmin(parent: torch.Tensor, collective: str,
               cand_cap: "int | None") -> torch.Tensor:
    """The shards' ``(S, n)`` hook parents met in one replicated ``(n,)``:
    the dense ``pmin``, or with ``collective="compressed"`` and a cap the
    delta exchange against the identity parents (a shard that hooks
    nothing holds the identity)."""
    S, n = parent.shape
    if S == 1:
        return parent[0]
    if collective == "compressed" and cand_cap is not None:
        return collectives.pmin_compressed(
            parent, default=torch.arange(n, dtype=parent.dtype,
                                         device=parent.device),
            cap=cand_cap, num_shards=S)
    return collectives.pmin(parent)


def connected_labels(src: torch.Tensor, dst: torch.Tensor,
                     active: torch.Tensor, *, num_vertices: int,
                     init: "torch.Tensor | None" = None,
                     use_pallas: bool = False, stats=None,
                     collective: str = "pmin",
                     cand_cap: "int | None" = None) -> torch.Tensor:
    """Converged connected-component labels over the active edges.

    Min-hooking and :func:`shortcut_relabel` until no active edge crosses
    two components; each vertex ends labelled with the minimum vertex id
    of its component (int32, canonical, so comparable across callers).
    ``init`` warm-starts the loop from labels whose equal entries are
    already connected under ``active`` (the nested threshold levels of the
    filter); min-id labels stay canonical under that refinement, and so
    keep the pointer-jump kernel's ``parent[i] <= i`` contract.

    The loop runs on the tensors' device.  The reference runs it inside
    one device ``while_loop``; here the host reads a crossing flag before
    the first iteration and after every :data:`LABEL_CHECK_EVERY`
    iterations, and
    each such read adds one to ``stats.host_syncs`` and
    ``stats.extra_syncs`` when ``stats`` is given.  ``active`` must be
    False on padding lanes; endpoints are clipped into ``[0, n)`` before
    the gathers, so out-of-range padding vertices are safe.

    Edges of shape ``(S, B)`` are S shards' (the reference under
    ``shard_map``): each row hooks on its own, the ``(S, n)`` hooks meet in
    a ``pmin`` — the compressed exchange for ``collective="compressed"``
    with a ``cand_cap`` — and the loop's flag is any crossing edge of any
    shard (the reference's ``pmax``); the labels are replicated.  Min is
    exact, so the labels are the same at every shard count.
    """
    n = num_vertices
    si = src.clamp(0, n - 1).to(torch.int64)
    di = dst.clamp(0, n - 1).to(torch.int64)
    comp = (torch.arange(n, dtype=torch.int32, device=src.device)
            if init is None else init.to(torch.int32))

    def crossing(comp):
        cs, cd = comp[si], comp[di]
        return cs, cd, active & (cs != cd)

    cs, cd, alive = crossing(comp)
    while True:
        more = bool(alive.any())             # the loop's one host read
        if stats is not None:
            stats.host_syncs += 1
            stats.extra_syncs += 1
        if not more:
            return comp
        for _ in range(LABEL_CHECK_EVERY):
            parent = union_find.hook_min(n, torch.maximum(cs, cd),
                                         torch.minimum(cs, cd), alive)
            if parent.dim() == 2:
                parent = _hook_pmin(parent, collective, cand_cap)
            comp = shortcut_relabel(parent, comp, use_pallas=use_pallas)
            cs, cd, alive = crossing(comp)


def component_maxkey(src: torch.Tensor, dst: torch.Tensor, key: torch.Tensor,
                     active: torch.Tensor, *, num_vertices: int,
                     init: "torch.Tensor | None" = None,
                     use_pallas: bool = False, stats=None,
                     collective: str = "pmin",
                     cand_cap: "int | None" = None
                     ) -> "tuple[torch.Tensor, torch.Tensor]":
    """The loop of :func:`connected_labels`, then one scatter-max of the
    packed keys onto the converged labels.  Returns ``(comp, maxkey)``:
    ``maxkey[v]`` is the largest key of an active edge in ``v``'s
    component, or unsigned 0 (``keys.SIGN`` in the flipped form) where the
    component has none; no live key is 0, since weights are positive.
    Signed order of flipped keys is the reference's unsigned order, so the
    max is exact.  Under a mesh (``(S, B)`` edges) the shards' maxima meet
    in the reference's ``pmax``: one scatter-max over every shard's edges
    gives the same words."""
    comp = connected_labels(src, dst, active, num_vertices=num_vertices,
                            init=init, use_pallas=use_pallas, stats=stats,
                            collective=collective, cand_cap=cand_cap)
    n = num_vertices
    src, key, active = src.reshape(-1), key.reshape(-1), active.reshape(-1)
    # At convergence no active edge crosses, so one endpoint names the
    # component; inactive lanes write one extra slot that is dropped.
    seg = comp[src.clamp(0, n - 1).to(torch.int64)].to(torch.int64)
    mx = torch.full((n + 1,), keys_lib.SIGN, dtype=torch.int64,
                    device=key.device)
    mx.scatter_reduce_(0, torch.where(active, seg, n),
                       torch.where(active, key, keys_lib.SIGN), "amax")
    return comp, mx[comp.to(torch.int64)]
