"""Packed 64-bit edge keys, carried as sign-flipped int64.

The reference packs every edge into one sortable unsigned word,

    key = (ieee754_bits(weight_f32) << 32) | unique_edge_id_32

and elects with unsigned ``min``; all ones (``0xFFFF...``) is the identity,
"no edge".  PyTorch has no unsigned 64-bit ``>>``, ``min``,
``scatter_reduce("amin")``, ``searchsorted`` or ``flip`` on the CPU, so the
port stores each such word ``u`` as the int64 whose bits are
``u ^ (1 << 63)``:

* signed order of the stored words equals unsigned order of ``u``, so every
  ``min``, sort and search is exact, and a word that uses all 64 bits (the
  sort lowering's ``fragment ‖ weight ‖ edge id`` key) keeps its place;
* the reference's all-ones identity becomes ``INT64_MAX`` (:data:`INF_KEY`),
  so ``torch.full(..., INF_KEY)`` is the identity of every min-reduction;
* fields come out by undoing the flip and masking (:func:`unflip`,
  :func:`lsr`).

Real keys lie below ``2**63`` because weights are non-negative, so they are
the negative stored words.  :func:`from_reference` / :func:`to_reference`
convert numpy ``uint64`` keys of the reference to and from this form.

The legacy host loop elects over single uint32 lanes (weight bits, then
edge ids), and PyTorch has no usable uint32 ``min`` or scatter-min on the
CPU either.  Each such lane is carried the same way, as the int32 whose
bits are ``v ^ (1 << 31)``: signed order equals the reference's unsigned
order, and its all-ones identity ``0xFFFFFFFF`` becomes ``INT32_MAX``
(:data:`INF32`).  :func:`from_reference32` / :func:`to_reference32`
convert at the boundary.
"""
from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)                  # int64 with only the top bit set
INF_KEY = (1 << 63) - 1            # flipped all-ones: identity of min
LANE_MASK = 0xFFFFFFFF
SIGN32 = -(1 << 31)                # int32 with only the top bit set
INF32 = (1 << 31) - 1              # flipped 0xFFFFFFFF: identity of min

# splitmix64 constants (the hashed partitioner's finalizer and the graph
# pipeline's counter-based generator).
SPLITMIX_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SPLITMIX_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_M2 = np.uint64(0x94D049BB133111EB)


def signed64(u: int) -> int:
    """The int64 whose bits are the unsigned 64-bit word ``u`` (unflipped)."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >> 63 else u


def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a numpy uint64 array (wrapping arithmetic)."""
    z = x + SPLITMIX_GAMMA
    z = (z ^ (z >> np.uint64(30))) * _SPLITMIX_M1
    z = (z ^ (z >> np.uint64(27))) * _SPLITMIX_M2
    return z ^ (z >> np.uint64(31))


# --- numpy ----------------------------------------------------------------

def from_reference(key: np.ndarray) -> np.ndarray:
    """Reference uint64 keys -> the port's sign-flipped int64 keys."""
    u = np.asarray(key, dtype=np.uint64)
    return (u ^ np.uint64(1 << 63)).view(np.int64)


def to_reference(key) -> np.ndarray:
    """The port's int64 keys (numpy or tensor) -> reference uint64 keys."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    s = np.asarray(key, dtype=np.int64)
    return s.view(np.uint64) ^ np.uint64(1 << 63)


def from_reference32(val) -> np.ndarray:
    """Reference uint32 lanes -> the port's sign-flipped int32 lanes."""
    u = np.asarray(val, dtype=np.uint32)
    return (u ^ np.uint32(1 << 31)).view(np.int32)


def to_reference32(val) -> np.ndarray:
    """The port's int32 lanes (numpy or tensor) -> reference uint32 lanes."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    s = np.asarray(val, dtype=np.int32)
    return s.view(np.uint32) ^ np.uint32(1 << 31)


def pack_keys_np(weight: np.ndarray, edge_id: np.ndarray) -> np.ndarray:
    """numpy: float32 weights + uint32 edge ids -> flipped int64 keys."""
    w = np.asarray(weight, dtype=np.float32)
    if np.any(w < 0):
        raise ValueError("packed keys require non-negative weights")
    bits = w.view(np.uint32).astype(np.int64)
    eid = np.asarray(edge_id).astype(np.int64) & LANE_MASK
    return ((bits << 32) | eid) ^ SIGN


def unpack_weight_np(key: np.ndarray) -> np.ndarray:
    u = np.asarray(key, dtype=np.int64) ^ SIGN
    return ((u >> 32) & LANE_MASK).astype(np.uint32).view(np.float32)


def unpack_edge_id_np(key: np.ndarray) -> np.ndarray:
    u = np.asarray(key, dtype=np.int64) ^ SIGN
    return (u & LANE_MASK).astype(np.uint32)


# --- torch ----------------------------------------------------------------

def unflip(key: torch.Tensor) -> torch.Tensor:
    """The unsigned word's bits, as int64 (top bit set only for INF)."""
    return key ^ SIGN


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by ``1 <= s <= 63``."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def pack_keys(weight: torch.Tensor, edge_id: torch.Tensor) -> torch.Tensor:
    """torch: float32 weights + int edge ids -> flipped int64 keys."""
    bits = weight.to(torch.float32).view(torch.int32).to(torch.int64)
    bits = bits & LANE_MASK
    eid = edge_id.to(torch.int64) & LANE_MASK
    return ((bits << 32) | eid) ^ SIGN


def unpack_edge_id(key: torch.Tensor) -> torch.Tensor:
    """Edge-id lane as int64 in ``[0, 2**32)`` (``0xFFFFFFFF`` for INF)."""
    return unflip(key) & LANE_MASK


def unpack_weight(key: torch.Tensor) -> torch.Tensor:
    bits = lsr(unflip(key), 32)
    return bits.to(torch.int32).view(torch.float32)


def split_key_lanes(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight-bits, edge-id) lanes of a key, each int64 in ``[0, 2**32)``.
    Lexicographic order of the lanes equals the order of the keys."""
    u = unflip(key)
    return lsr(u, 32), u & LANE_MASK


def combine_key_lanes(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_key_lanes`."""
    hi = hi.to(torch.int64) & LANE_MASK
    lo = lo.to(torch.int64) & LANE_MASK
    return ((hi << 32) | lo) ^ SIGN


# --- raw unsigned 64-bit words in int64 ------------------------------------
# The graph pipeline's counters and random words are plain unsigned words
# carried as the int64 with the same bits (NOT sign-flipped like keys):
# int64 addition and multiplication wrap exactly as uint64 does, shifts go
# through :func:`lsr`, and unsigned order and remainder need the helpers
# below.

_GAMMA_S = signed64(int(SPLITMIX_GAMMA))
_M1_S = signed64(int(_SPLITMIX_M1))
_M2_S = signed64(int(_SPLITMIX_M2))


def splitmix64_torch(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over raw 64-bit words in an int64 tensor; the
    same bits as :func:`splitmix64` on the uint64 array."""
    z = x + _GAMMA_S
    z = (z ^ lsr(z, 30)) * _M1_S
    z = (z ^ lsr(z, 27)) * _M2_S
    return z ^ lsr(z, 31)


def umod(x: torch.Tensor, d: int) -> torch.Tensor:
    """Unsigned remainder of raw 64-bit words by a small ``1 <= d < 2**62``."""
    return ((lsr(x, 1) % d) * 2 + (x & 1)) % d


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a < b`` of raw 64-bit words; ``b`` a tensor of them or a
    Python int in ``[0, 2**64)``."""
    if isinstance(b, int):
        b = signed64(b)
    return (a ^ SIGN) < (b ^ SIGN)
