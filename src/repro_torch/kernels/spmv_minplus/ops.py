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
"""
from __future__ import annotations

import torch

from repro_torch.core import keys as keys_lib
from repro_torch.kernels.segment_min.ops import run_end_min
from repro_torch.kernels.spmv_minplus import ref
from repro_torch.kernels.spmv_minplus.spmv_minplus import (
    masked_minplus_scan, pointer_jump)

INF_KEY = keys_lib.INF_KEY
# Weight-bits budget of the sort lowering: engine weights lie in (0, 1), so
# their IEEE-754 patterns are < 0x3F800000 < 2**30.
WEIGHT_BITS = 30
WEIGHT_LIMIT_BITS = 0x3F800000  # ieee754_bits(1.0f)

ELECT_LOWERINGS = ("scatter", "sort", "pallas")


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
