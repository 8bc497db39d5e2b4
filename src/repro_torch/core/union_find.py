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
    """Scatter-min hooking: ``parent[hi] = min(lo)`` over valid requests,
    along the last dim (``(B, ·)`` requests hook each row on its own).

    ``hi > lo`` must hold for valid entries.  Invalid entries are routed to
    one extra slot past the end and dropped with it (the reference drops
    them as out-of-range scatter indices).
    """
    parent = torch.arange(n + 1, dtype=torch.int32, device=hi.device)
    parent = parent.expand(*hi.shape[:-1], n + 1).contiguous()
    idx = torch.where(valid, hi.to(torch.int64), n)
    parent.scatter_reduce_(-1, idx, lo.to(torch.int32), "amin")
    return parent[..., :n]


def doubling_steps(n: int) -> int:
    """⌈log2 n⌉ (at least 1): the doubling steps that compress any forest of
    ``n`` labels."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def pointer_double(parent: torch.Tensor, num_steps: int | None = None) -> torch.Tensor:
    """Full path compression by pointer doubling along the last dim
    (⌈log2 N⌉ gathers); a ``(B, N)`` parent compresses each row on its
    own."""
    if num_steps is None:
        num_steps = doubling_steps(parent.shape[-1])
    p = parent
    for _ in range(num_steps):
        p = p[p] if p.ndim == 1 else torch.gather(p, -1, p.to(torch.int64))
    return p
