"""Oracles for the segment_min kernel: scatter-min and a sequential scan."""
from __future__ import annotations

import torch

from repro_torch.core import keys as keys_lib

INF_KEY = keys_lib.INF_KEY
INF32 = keys_lib.INF32


def segment_min(val: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment min of flipped int32 lanes by scatter-min (segments need
    not be sorted; ids outside ``[0, num_segments)`` are dropped)."""
    out = torch.full((num_segments + 1,), INF32, dtype=torch.int32,
                     device=val.device)
    seg = seg.to(torch.int64)
    idx = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out.scatter_reduce_(0, idx, val, "amin")
    return out[:num_segments]


def segment_min64(key: torch.Tensor, seg: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Per-segment min of flipped int64 keys by scatter-min (segments need
    not be sorted; ids outside ``[0, num_segments)`` are dropped)."""
    out = torch.full((num_segments + 1,), INF_KEY, dtype=torch.int64,
                     device=key.device)
    seg = seg.to(torch.int64)
    idx = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out.scatter_reduce_(0, idx, key, "amin")
    return out[:num_segments]


def segmented_min2_scan(seg, key):
    """Sequential inclusive segmented min-scan oracle (sorted segments),
    one lane at a time with the reference's carry identity."""
    seg_l = seg.tolist()
    key_l = key.tolist()
    cs, cv = -2, INF_KEY
    out = []
    for s, k in zip(seg_l, key_l):
        cv = min(cv, k) if s == cs else k
        cs = s
        out.append(cv)
    return torch.tensor(out, dtype=torch.int64)


def segmented_min_scan(seg, val):
    """Sequential inclusive segmented min-scan oracle over flipped int32
    lanes (sorted segments), with the reference's carry identity."""
    cs, cv = -2, INF32
    out = []
    for s, v in zip(seg.tolist(), val.tolist()):
        cv = min(cv, v) if s == cs else v
        cs = s
        out.append(cv)
    return torch.tensor(out, dtype=torch.int32)
