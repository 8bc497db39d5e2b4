"""Scatter oracles for the fused Borůvka round body (spmv_minplus)."""
from __future__ import annotations

import torch

from repro_torch.core import keys as keys_lib
from repro_torch.core import union_find

INF_KEY = keys_lib.INF_KEY


def elect(cs: torch.Tensor, cd: torch.Tensor, key: torch.Tensor,
          *, num_segments: int) -> torch.Tensor:
    """Masked min-plus election oracle: per-fragment min packed key.

    An edge is live iff its endpoint fragments differ and its key is not
    INF; dead edges contribute the identity.  Both directions reduce by
    scatter-min.
    """
    alive = (cs != cd) & (key != INF_KEY)
    k = torch.where(alive, key, INF_KEY)
    out = torch.full((num_segments,), INF_KEY, dtype=torch.int64,
                     device=key.device)
    out.scatter_reduce_(0, cs.to(torch.int64), k, "amin")
    out.scatter_reduce_(0, cd.to(torch.int64), k, "amin")
    return out


def shortcut_relabel(parent: torch.Tensor, comp: torch.Tensor) -> torch.Tensor:
    """Oracle for the fused shortcut: full pointer doubling, then relabel."""
    return union_find.pointer_double(parent)[comp]
