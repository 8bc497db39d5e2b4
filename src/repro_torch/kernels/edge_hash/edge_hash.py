"""Batched linear-probe edge-hash lookup: the CUDA kernel and its plain
version.

Port of the Pallas kernel ``kernels/edge_hash/edge_hash.py::hash_lookup``
of the JAX package: each query ``(receiver, sender)`` is mixed into its
home slot exactly as ``ghs_state.hash_slot`` does, then probes
``idx, idx + 1, ...`` modulo the table size for at most ``max_probes``
slots.  It returns the slot's CSR position at a hit, and -1 at an empty
slot or when the probes run out.

The kernel ``csrc/edge_hash.cu`` reads the table as records: one ``(T, 4)``
int32 tensor of ``(lv, u, pos, 0)``, 16 bytes a slot, which
:func:`pack_records` makes from the reference's three int32 arrays ``(h_lv,
h_u, h_pos)`` (a copy kernel of the same source on the card, ``ref.pack``
on the CPU).  Two entries: :func:`hash_lookup_records` takes a packed
table, and :func:`hash_lookup` the three arrays, which it packs before the
launch.  On a CUDA tensor each launches the kernel (built on first use); on
a CPU tensor each runs :func:`hash_lookup_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.edge_hash import ref
from repro_torch.launch import flops

MAX_PROBES = 64


def hash_lookup_plain(h_lv, h_u, h_pos, q_lv, q_u, *,
                      max_probes: int = MAX_PROBES) -> torch.Tensor:
    """Plain version: the lock-step probe of every query at once, stopping
    early once every query has frozen (the same words as the Pallas
    kernel's fixed ``max_probes`` trips)."""
    return ref.probe(h_lv, h_u, h_pos, q_lv, q_u, max_probes=max_probes)


def _check_queries(q_lv, q_u, device) -> None:
    for name, t in (("q_lv", q_lv), ("q_u", q_u)):
        if t.ndim != 1 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"hash_lookup: {name} must be contiguous 1-D "
                             f"int32")
        if t.device != device:
            raise ValueError("hash_lookup: table and queries must share one "
                             "device")
    if q_lv.shape != q_u.shape:
        raise ValueError("hash_lookup: the query arrays differ in length")


def _check(h_lv, h_u, h_pos, q_lv, q_u) -> None:
    for name, t in (("h_lv", h_lv), ("h_u", h_u), ("h_pos", h_pos)):
        if t.ndim != 1 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"hash_lookup: {name} must be contiguous 1-D "
                             f"int32")
        if t.device != h_lv.device:
            raise ValueError("hash_lookup: the table arrays must share one "
                             "device")
    if not h_lv.shape == h_u.shape == h_pos.shape:
        raise ValueError("hash_lookup: the table arrays differ in length")
    _check_queries(q_lv, q_u, h_lv.device)
    if h_lv.shape[0] == 0:
        raise ValueError("hash_lookup: empty table")


def _check_records(records, q_lv, q_u) -> None:
    if (records.ndim != 2 or records.shape[1] != ref.RECORD_WORDS
            or records.dtype != torch.int32 or not records.is_contiguous()):
        raise ValueError("hash_lookup_records: the table must be contiguous "
                         "(T, 4) int32 records")
    _check_queries(q_lv, q_u, records.device)
    if records.shape[0] == 0:
        raise ValueError("hash_lookup_records: empty table")


def _lib():
    from repro_torch.kernels import build
    lib = build.load("edge_hash")
    lib.edge_hash_lookup_records.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.edge_hash_lookup_records.restype = ctypes.c_int
    lib.edge_hash_pack_records.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.edge_hash_pack_records.restype = ctypes.c_int
    return lib


def pack_records(h_lv: torch.Tensor, h_u: torch.Tensor,
                 h_pos: torch.Tensor) -> torch.Tensor:
    """The three table arrays as one ``(T, 4)`` int32 tensor of records
    ``(lv, u, pos, 0)``, on their device: on a CUDA tensor the copy kernel
    (a layout change, not a lookup: it counts no launch), on a CPU tensor
    ``ref.pack``; any other device raises."""
    dev = h_lv.device
    for name, t in (("h_lv", h_lv), ("h_u", h_u), ("h_pos", h_pos)):
        if t.ndim != 1 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"pack_records: {name} must be contiguous 1-D "
                             f"int32")
        if t.device != dev or t.shape != h_lv.shape:
            raise ValueError("pack_records: the table arrays must share one "
                             "device and one length")
    if dev.type == "cpu":
        return ref.pack(h_lv, h_u, h_pos)
    if dev.type != "cuda":
        raise RuntimeError(f"pack_records: no kernel for {dev}")
    from repro_torch.kernels import build
    records = torch.empty((h_lv.shape[0], ref.RECORD_WORDS),
                          dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().edge_hash_pack_records(
        h_lv.data_ptr(), h_u.data_ptr(), h_pos.data_ptr(),
        records.data_ptr(), h_lv.shape[0], stream)
    build.check(err, "pack_records")
    return records


@flops.kernel("hash_lookup")
def hash_lookup_records(records: torch.Tensor, q_lv: torch.Tensor,
                        q_u: torch.Tensor, *,
                        max_probes: int = MAX_PROBES) -> torch.Tensor:
    """Batched ``(receiver, sender)`` → CSR-position lookup in a packed
    table; -1 = miss.

    Table: ``(T, 4)`` int32 records ``(lv, u, pos, 0)`` (``ref.pack``);
    queries: two int32 arrays of ``Q`` lanes; returns int32 (Q,).  CUDA
    tensors launch the kernel; CPU tensors unpack the table and take the
    plain version; any other device raises.
    """
    _check_records(records, q_lv, q_u)
    if records.device.type == "cpu":
        return hash_lookup_plain(*ref.unpack(records), q_lv, q_u,
                                 max_probes=max_probes)
    if records.device.type != "cuda":
        raise RuntimeError(f"hash_lookup: no kernel for {records.device}")
    if records.data_ptr() % 16:
        raise ValueError("hash_lookup_records: the records must be 16-byte "
                         "aligned")
    from repro_torch.kernels import build
    lib = _lib()
    q = q_lv.shape[0]
    out = torch.empty_like(q_lv)
    if q == 0:
        return out
    stream = torch.cuda.current_stream(records.device).cuda_stream
    err = lib.edge_hash_lookup_records(
        records.data_ptr(), q_lv.data_ptr(), q_u.data_ptr(), out.data_ptr(),
        q, records.shape[0], max_probes, stream)
    build.check(err, "hash_lookup")
    kernels.LAUNCHES["hash_lookup"] += 1
    return out


@flops.kernel("hash_lookup")
def hash_lookup(h_lv: torch.Tensor, h_u: torch.Tensor, h_pos: torch.Tensor,
                q_lv: torch.Tensor, q_u: torch.Tensor, *,
                max_probes: int = MAX_PROBES) -> torch.Tensor:
    """Batched ``(receiver, sender)`` → CSR-position lookup; -1 = miss.

    Table: three int32 arrays of ``T`` slots; queries: two int32 arrays of
    ``Q`` lanes; returns int32 (Q,).  CUDA tensors are packed into records
    (:func:`pack_records`, a copy of the table) and launch the kernel; CPU
    tensors take the plain version; any other device raises.
    """
    _check(h_lv, h_u, h_pos, q_lv, q_u)
    if h_lv.device.type == "cpu":
        return hash_lookup_plain(h_lv, h_u, h_pos, q_lv, q_u,
                                 max_probes=max_probes)
    if h_lv.device.type != "cuda":
        raise RuntimeError(f"hash_lookup: no kernel for {h_lv.device}")
    return hash_lookup_records(pack_records(h_lv, h_u, h_pos), q_lv, q_u,
                               max_probes=max_probes)
