"""Segmented min-scans: the CUDA kernels and their plain versions.

Ports of two Pallas kernels of ``kernels/segment_min/segment_min.py`` in
the JAX package:

* :func:`segmented_min2_scan` (``segmented_min2_scan``).  The reference
  scans the packed key as two uint32 lanes ``(hi, lo)`` compared
  lexicographically; the port carries the pair as one sign-flipped int64
  word (``core/keys.py``), whose signed order is that lexicographic order,
  and ``INF`` is ``INT64_MAX``.
* :func:`segmented_min_scan` (``segmented_min_scan``), the single-lane
  uint32 scan of the legacy host loop.  Each lane is one sign-flipped
  int32 word, and ``INF`` is ``INT32_MAX``.

On a CUDA tensor each launches ``csrc/segscan.cu`` (built on first use),
the 64-bit or the 32-bit instance; on a CPU tensor it runs its plain
version.  The masked variant of the 64-bit kernel
(``masked_minplus_scan``) shares :func:`launch_segscan`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.launch import flops


def check_lanes(name: str, seg: torch.Tensor, key: torch.Tensor,
                oth: Optional[torch.Tensor] = None, *,
                key_dtype: torch.dtype = torch.int64) -> None:
    lanes = (seg, key) if oth is None else (seg, oth, key)
    for t in lanes:
        if t.ndim != 1 or t.shape[0] != seg.shape[0]:
            raise ValueError(f"{name}: lanes must be 1-D of one length")
        if t.device != seg.device:
            raise ValueError(f"{name}: lanes must share one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: lanes must be contiguous")
    if seg.dtype != torch.int32 or (oth is not None and oth.dtype != torch.int32):
        raise TypeError(f"{name}: segment lanes must be int32")
    if key.dtype != key_dtype:
        raise TypeError(f"{name}: values must be {key_dtype} (flipped words)")


def segmented_min2_scan_plain(seg: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch inclusive segmented min-scan along sorted ``seg`` runs:
    Hillis–Steele doubling, ⌈log2 M⌉ shifted compares over the whole array.
    Any integer value type; the 32-bit scan's plain version too."""
    val = key.clone()
    m = val.shape[0]
    shift = 1
    while shift < m:
        take = seg[shift:] == seg[:-shift]
        nxt = val.clone()
        nxt[shift:] = torch.where(take, torch.minimum(val[shift:], val[:-shift]),
                                  val[shift:])
        val = nxt
        shift *= 2
    return val


def launch_segscan(name: str, seg: torch.Tensor, oth: Optional[torch.Tensor],
                   key: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/segscan.cu`` on the current stream (``oth=None`` for
    the unmasked scan) and count one launch of ``name``."""
    from repro_torch.kernels import build
    lib = build.load("segscan")
    lib.segscan_min.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                                        ctypes.c_void_p]
    lib.segscan_min.restype = ctypes.c_int
    lib.segscan_tile_size.restype = ctypes.c_int
    m = seg.shape[0]
    out = torch.empty_like(key)
    if m == 0:
        return out
    ntiles = -(-m // lib.segscan_tile_size())
    meta = torch.empty(3 * ntiles, dtype=torch.int32, device=seg.device)
    last = torch.empty(ntiles, dtype=torch.int64, device=seg.device)
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    err = lib.segscan_min(seg.data_ptr(),
                          None if oth is None else oth.data_ptr(),
                          key.data_ptr(), out.data_ptr(), meta.data_ptr(),
                          last.data_ptr(), m, stream)
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


@flops.kernel("segmented_min2_scan")
def segmented_min2_scan(seg: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented min-scan of ``key`` along sorted ``seg``.

    ``seg`` int32 (M,) sorted ascending, ``key`` flipped int64 (M,).  The
    run ends of the result hold each segment's min.  CUDA tensors launch the
    kernel; CPU tensors take the plain version; any other device raises.
    """
    check_lanes("segmented_min2_scan", seg, key)
    if seg.device.type == "cpu":
        return segmented_min2_scan_plain(seg, key)
    if seg.device.type != "cuda":
        raise RuntimeError(f"segmented_min2_scan: no kernel for {seg.device}")
    return launch_segscan("segmented_min2_scan", seg, None, key)



def segmented_min_scan_plain(seg: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Plain version of the single-lane scan (flipped int32 words)."""
    return segmented_min2_scan_plain(seg, val)


@flops.kernel("segmented_min_scan")
def segmented_min_scan(seg: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented min-scan of one 32-bit lane along sorted ``seg``.

    ``seg`` int32 (M,) sorted ascending, ``val`` flipped int32 (M,)
    (``keys.from_reference32``).  The run ends of the result hold each
    segment's min.  CUDA tensors launch the kernel; CPU tensors take the
    plain version; any other device raises.
    """
    check_lanes("segmented_min_scan", seg, val, key_dtype=torch.int32)
    if seg.device.type == "cpu":
        return segmented_min_scan_plain(seg, val)
    if seg.device.type != "cuda":
        raise RuntimeError(f"segmented_min_scan: no kernel for {seg.device}")
    from repro_torch.kernels import build
    lib = build.load("segscan")
    lib.segscan_min32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                                          ctypes.c_void_p]
    lib.segscan_min32.restype = ctypes.c_int
    lib.segscan_tile_size.restype = ctypes.c_int
    m = seg.shape[0]
    out = torch.empty_like(val)
    if m == 0:
        return out
    ntiles = -(-m // lib.segscan_tile_size())
    meta = torch.empty(3 * ntiles, dtype=torch.int32, device=seg.device)
    last = torch.empty(ntiles, dtype=torch.int32, device=seg.device)
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    err = lib.segscan_min32(seg.data_ptr(), val.data_ptr(), out.data_ptr(),
                            meta.data_ptr(), last.data_ptr(), m, stream)
    build.check(err, "segmented_min_scan")
    kernels.LAUNCHES["segmented_min_scan"] += 1
    return out
