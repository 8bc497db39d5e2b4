"""Hooking + pointer-jumping primitives on fragment-label tensors.

Min-hooking builds a strictly decreasing parent forest (no cycles by
construction) and pointer doubling compresses it in ⌈log2 N⌉ gathers.
Labels are int32.
"""
from __future__ import annotations

import math

import torch


def hook_min(
    n: int, hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Scatter-min hooking: ``parent[hi] = min(lo)`` over valid requests.

    ``hi > lo`` must hold for valid entries.  Invalid entries are routed to
    one extra slot past the end and dropped with it (the reference drops
    them as out-of-range scatter indices).
    """
    parent = torch.arange(n + 1, dtype=torch.int32, device=hi.device)
    idx = torch.where(valid, hi.to(torch.int64), n)
    parent.scatter_reduce_(0, idx, lo.to(torch.int32), "amin")
    return parent[:n]


def pointer_double(parent: torch.Tensor, num_steps: int | None = None) -> torch.Tensor:
    """Full path compression by pointer doubling (⌈log2 N⌉ gathers)."""
    n = parent.shape[0]
    if num_steps is None:
        num_steps = max(1, math.ceil(math.log2(max(n, 2))))
    p = parent
    for _ in range(num_steps):
        p = p[p]
    return p
