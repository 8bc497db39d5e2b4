"""Per-segment min: sorted-scan kernel paths + scatter paths.

``segment_min64*`` reduce flipped int64 packed keys (the pair-lex scan
kernel); ``segment_min*`` reduce single flipped int32 lanes (the 32-bit
scan kernel of the legacy host loop).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import keys as keys_lib
from repro_torch.kernels.segment_min import ref
from repro_torch.kernels.segment_min.segment_min import (
    segmented_min2_scan, segmented_min_scan)

INF_KEY = keys_lib.INF_KEY
INF32 = keys_lib.INF32
_INF = {torch.int64: INF_KEY, torch.int32: INF32}


def run_end_min(scan: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Each segment's min from an inclusive scan along sorted ``seg``.

    The last lane of every run (``seg != next seg``, with ``-3`` past the
    end, as the reference) holds the run's min; it is written to its
    segment once, and every other lane — like a segment id outside
    ``[0, num_segments)`` — goes to one extra slot that is dropped.  Works
    for both widths: segments never written keep the INF of ``scan``'s
    type.
    """
    nxt = torch.cat([seg[1:], torch.full((1,), -3, dtype=seg.dtype,
                                          device=seg.device)])
    seg64 = seg.to(torch.int64)
    run_end = (seg != nxt) & (seg64 >= 0) & (seg64 < num_segments)
    out = torch.full((num_segments + 1,), _INF[scan.dtype], dtype=scan.dtype,
                     device=scan.device)
    out.scatter_(0, torch.where(run_end, seg64, num_segments), scan)
    return out[:num_segments]


def segment_min64_sorted(key: torch.Tensor, seg: torch.Tensor, *,
                         num_segments: int) -> torch.Tensor:
    """Per-segment min over SORTED ``seg`` via the pair-lex scan kernel."""
    if seg.shape[0] == 0 or num_segments == 0:
        # No runs or no output slots: every segment is empty (INF), and no
        # kernel is launched over zero lanes.
        return torch.full((num_segments,), INF_KEY, dtype=torch.int64,
                          device=key.device)
    scan = segmented_min2_scan(seg, key)
    return run_end_min(scan, seg, num_segments)


def segment_min64(key: torch.Tensor, seg: torch.Tensor, *, num_segments: int,
                  use_pallas: bool = False) -> torch.Tensor:
    """Per-segment min over flipped int64 keys; unsorted ``seg`` (int32).

    ``use_pallas=True`` sorts by segment once and runs the scan kernel;
    otherwise a scatter-min.
    """
    if not use_pallas:
        return ref.segment_min64(key, seg, num_segments)
    seg_s, order = torch.sort(seg, stable=True)
    return segment_min64_sorted(key[order], seg_s, num_segments=num_segments)


def segment_min_sorted(val: torch.Tensor, seg: torch.Tensor, *,
                       num_segments: int) -> torch.Tensor:
    """Per-segment min of flipped int32 lanes over SORTED ``seg`` via the
    32-bit scan kernel."""
    if seg.shape[0] == 0 or num_segments == 0:
        # No runs or no output slots: every segment is empty (INF), and no
        # kernel is launched over zero lanes.
        return torch.full((num_segments,), INF32, dtype=torch.int32,
                          device=val.device)
    scan = segmented_min_scan(seg, val)
    return run_end_min(scan, seg, num_segments)


def segment_min(val: torch.Tensor, seg: torch.Tensor, *, num_segments: int,
                use_pallas: bool = False,
                order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment min over flipped int32 lanes; unsorted ``seg`` (int32).

    ``use_pallas=True`` sorts by segment and runs the scan kernel;
    ``order`` is a precomputed sorting permutation of ``seg``, for callers
    that reduce several lanes over one segment array.  Otherwise a
    scatter-min.
    """
    if not use_pallas:
        return ref.segment_min(val, seg, num_segments)
    if order is None:
        order = torch.sort(seg, stable=True).indices
    return segment_min_sorted(val[order], seg[order],
                              num_segments=num_segments)
