"""The edge hash of the paper-faithful GHS engine: mixing and the build.

The paper (§3.3, technique C2) replaces the linear search of a vertex's
edge list with an open-addressing hash keyed on the ``(receiver, sender)``
vertex pair.  This module holds the pieces of the JAX package's
``core/ghs_state.py`` that the edge-hash lookup needs: the mixing constants,
:func:`hash_slot` and the host-side linear-probe build
:func:`_build_hash_table`.  The rest of that module (the shard state, the
message encoding and ``init_shards``) comes with the GHS engine (ROADMAP
queue 1, item 12).

:func:`hash_slot` computes the reference's uint32 wraparound arithmetic on
numpy arrays as the reference does, and on torch tensors without uint32:
a product ``x * HASH_K1`` of two 32-bit words overflows int64, so the low
32 bits are formed from the two 16-bit halves of the constant.
"""
from __future__ import annotations

import numpy as np
import torch

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
