"""Single-token GQA attention over a KV cache: the CUDA kernel and its
plain version.

Port of the Pallas kernel ``kernels/decode_attention/decode_attention.py::
decode_attention`` of the JAX package: one query token per (batch, q head)
against a (B, Hkv, S, D) cache, positions ``>= length[b]`` masked with the
logit -1e30, float32 arithmetic, the output in q's type.  The q heads of
one KV head are handled together, so each cache row is read once per group.
A row with ``length == 0`` averages V over all S positions, as the Pallas
kernel's masking gives.  The Pallas kernel asserts ``S % 512 == 0`` once
S >= 512 (its TPU tiling); this kernel takes any S.

On a CUDA tensor :func:`decode_attention` launches
``csrc/decode_attention.cu`` (built on first use) as split-K flash
decoding: :func:`split_plan` cuts the cache into chunks, one block per
chunk, whose partial softmax sums the last block of each (b, kv head)
combines through a float32 workspace; on a CPU tensor it runs
:func:`decode_attention_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    MAX_GRID, TYPES, check_heads, check_launch)
from repro_torch.launch import flops

TILE = 32                 # cache rows of a tile (one a lane)
HEADS_PER_BLOCK = 8       # query heads a block at most, a warp each
WARPS_PER_SM = 8          # the plan gives each SM at least this many warps
BLOCKS_PER_SM = 2         # ... and at least this many blocks
MIN_CHUNK_TILES = 3       # tiles a chunk at least

_lib = None
_sm_counts: dict = {}
_counters: dict = {}


def decode_attention_plain(q, k, v, length, *,
                           scale: float | None = None) -> torch.Tensor:
    """Plain version: the masked einsum of ``ref.py``."""
    return ref.decode_attention(q, k, v, length, scale=scale)


@functools.lru_cache(maxsize=None)
def split_plan(b: int, hq: int, hkv: int, s: int, d: int,
               sm_count: int) -> tuple[int, int, tuple[int, int, int]]:
    """How the kernel cuts the cache: ``(chunk, chunks, grid)``.

    A KV head's group of query heads is cut into ceil(group / 8) tiles of
    equal size, one warp a head.  One block owns ``chunk`` cache rows (a
    multiple of :data:`TILE`) of one (b, kv head, head tile);
    ``chunks = ceil(s / chunk)`` and ``grid = (chunks, hkv · head tiles,
    b)``.  The chunk is the largest that still gives the card's
    ``sm_count`` SMs :data:`WARPS_PER_SM` warps and :data:`BLOCKS_PER_SM`
    blocks each, and at least :data:`MIN_CHUNK_TILES` tiles (``d`` does
    not change the cut).  A function of the shapes alone: the lengths stay
    on the device, and a block whose chunk starts past its row's length
    writes an empty partial.
    """
    del d
    group = hq // hkv
    head_tiles = -(-group // HEADS_PER_BLOCK)
    heads = -(-group // head_tiles)
    slices = b * hkv * head_tiles
    want = max(-(-WARPS_PER_SM * sm_count // (slices * heads)),
               -(-BLOCKS_PER_SM * sm_count // slices))
    tiles = -(-s // TILE)
    per_chunk = min(tiles, max(MIN_CHUNK_TILES, -(-tiles // want)))
    chunk = per_chunk * TILE
    chunks = -(-s // chunk)
    return chunk, chunks, (chunks, hkv * head_tiles, b)


def _load():
    """The kernel's library, its C signatures set once."""
    global _lib
    if _lib is None:
        lib = build.load("decode_attention")
        lib.decode_attention_supports.argtypes = [ctypes.c_int]
        lib.decode_attention_supports.restype = ctypes.c_int
        lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.decode_attention_smem_bytes.restype = ctypes.c_int
        lib.decode_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [
            ctypes.c_int]
        lib.decode_attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def sm_count(device: torch.device) -> int:
    """The card's number of SMs, read once per device."""
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


def _counts(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n int32 counters at 0 for launches on one stream of one
    device; each launch leaves them at 0, so they are zeroed only when
    first made or grown."""
    key = (device.index, stream)
    counts = _counters.get(key)
    if counts is None or counts.numel() < n:
        counts = torch.zeros(n, dtype=torch.int32, device=device)
        _counters[key] = counts
    return counts


@flops.kernel("decode_attention", flops.attention_matmul_flops)
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """Attention of q (B, Hq, D) over the first ``length[b]`` positions of
    k, v (B, Hkv, S, D); ``length`` int32 (B,).

    Returns (B, Hq, D) in q's type.  CUDA tensors launch the kernel; CPU
    tensors take the plain version; ``meta`` tensors (the dry run) get an
    empty output and compute nothing; any other device raises.
    """
    check_heads("decode_attention", q, k, v)
    if q.ndim != 3:
        raise ValueError("decode_attention: q must be (B, Hq, D)")
    if length.shape != (q.shape[0],) or length.dtype != torch.int32:
        raise ValueError("decode_attention: length must be int32 (B,)")
    if length.device != q.device:
        raise ValueError("decode_attention: length must be on q's device")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length, scale=scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention: no kernel for {q.device}")
    lib = _load()
    check_launch("decode_attention", lib.decode_attention_supports, q, k, v)
    if not length.is_contiguous():
        raise ValueError("decode_attention: length must be contiguous")
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if b > MAX_GRID:
        raise ValueError("decode_attention: batch must be <= 65535")
    if scale is None:
        scale = float(1.0 / np.sqrt(d))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if s == 0:
        raise ValueError("decode_attention: empty cache")
    chunk, chunks, grid = split_plan(b, hq, hkv, s, d, sm_count(q.device))
    work = torch.empty(b * hq * chunks * (d + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counts = _counts(q.device, stream, grid[1] * grid[2])
    err = lib.decode_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   length.data_ptr(), out.data_ptr(),
                                   TYPES[q.dtype], b, hq, hkv, s, d, scale,
                                   stream, work.data_ptr(), counts.data_ptr(),
                                   chunk)
    build.check(err, "decode_attention")
    kernels.LAUNCHES["decode_attention"] += 1
    return out
