"""Batched linear-probe edge-hash lookup: the CUDA kernel and its plain
version.

Port of the Pallas kernel ``kernels/edge_hash/edge_hash.py::hash_lookup``
of the JAX package: each query ``(receiver, sender)`` is mixed into its
home slot exactly as ``ghs_state.hash_slot`` does, then probes
``idx, idx + 1, ...`` modulo the table size for at most ``max_probes``
slots.  It returns the slot's CSR position at a hit, and -1 at an empty
slot or when the probes run out.  The table keeps the reference's layout:
three int32 arrays ``(h_lv, h_u, h_pos)``.

On a CUDA tensor :func:`hash_lookup` launches ``csrc/edge_hash.cu`` (built
on first use); on a CPU tensor it runs :func:`hash_lookup_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.edge_hash import ref

MAX_PROBES = 64


def hash_lookup_plain(h_lv, h_u, h_pos, q_lv, q_u, *,
                      max_probes: int = MAX_PROBES) -> torch.Tensor:
    """Plain version: the lock-step probe of every query at once, stopping
    early once every query has frozen (the same words as the Pallas
    kernel's fixed ``max_probes`` trips)."""
    return ref.probe(h_lv, h_u, h_pos, q_lv, q_u, max_probes=max_probes)


def _check(h_lv, h_u, h_pos, q_lv, q_u) -> None:
    for name, t in (("h_lv", h_lv), ("h_u", h_u), ("h_pos", h_pos),
                    ("q_lv", q_lv), ("q_u", q_u)):
        if t.ndim != 1 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"hash_lookup: {name} must be contiguous 1-D "
                             f"int32")
        if t.device != h_lv.device:
            raise ValueError("hash_lookup: table and queries must share one "
                             "device")
    if not h_lv.shape == h_u.shape == h_pos.shape:
        raise ValueError("hash_lookup: the table arrays differ in length")
    if q_lv.shape != q_u.shape:
        raise ValueError("hash_lookup: the query arrays differ in length")
    if h_lv.shape[0] == 0:
        raise ValueError("hash_lookup: empty table")


def hash_lookup(h_lv: torch.Tensor, h_u: torch.Tensor, h_pos: torch.Tensor,
                q_lv: torch.Tensor, q_u: torch.Tensor, *,
                max_probes: int = MAX_PROBES) -> torch.Tensor:
    """Batched ``(receiver, sender)`` → CSR-position lookup; -1 = miss.

    Table: three int32 arrays of ``T`` slots; queries: two int32 arrays of
    ``Q`` lanes; returns int32 (Q,).  CUDA tensors launch the kernel; CPU
    tensors take the plain version; any other device raises.
    """
    _check(h_lv, h_u, h_pos, q_lv, q_u)
    if h_lv.device.type == "cpu":
        return hash_lookup_plain(h_lv, h_u, h_pos, q_lv, q_u,
                                 max_probes=max_probes)
    if h_lv.device.type != "cuda":
        raise RuntimeError(f"hash_lookup: no kernel for {h_lv.device}")
    from repro_torch.kernels import build
    lib = build.load("edge_hash")
    lib.edge_hash_lookup.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.edge_hash_lookup.restype = ctypes.c_int
    q = q_lv.shape[0]
    out = torch.empty_like(q_lv)
    if q == 0:
        return out
    stream = torch.cuda.current_stream(h_lv.device).cuda_stream
    err = lib.edge_hash_lookup(h_lv.data_ptr(), h_u.data_ptr(),
                               h_pos.data_ptr(), q_lv.data_ptr(),
                               q_u.data_ptr(), out.data_ptr(), q,
                               h_lv.shape[0], max_probes, stream)
    build.check(err, "hash_lookup")
    kernels.LAUNCHES["hash_lookup"] += 1
    return out
