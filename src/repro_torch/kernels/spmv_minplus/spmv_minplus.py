"""Fused Borůvka round-body kernels: masked min-plus scan and pointer jump.

Ports of the Pallas kernels ``kernels/spmv_minplus/spmv_minplus.py::
masked_minplus_scan`` and ``::pointer_jump`` of the JAX package, each with
its plain PyTorch version beside it:

* :func:`masked_minplus_scan` — the segmented pair-lex min-scan of
  ``kernels/segment_min`` with the Borůvka liveness mask applied in the
  kernel: a lane whose ``seg == oth`` (both endpoints in one fragment) or
  whose key is INF joins the scan as the identity.  CUDA: the masked
  instance of ``csrc/segscan.cu``.
* :func:`pointer_jump` — ⌈log2 n⌉ pointer-doubling steps over a hook
  forest, then the relabel ``parent*[comp]``, gathers clipped to
  ``[0, n - 1]``.  CUDA: ``csrc/pointer_jump.cu``, one cooperative launch
  that leaves its loop at the first step that changes no label (exact:
  every later step would return the same labels).

CUDA tensors launch the kernel, CPU tensors take the plain version, and
any other device raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.core import keys as keys_lib
from repro_torch.kernels import build
from repro_torch.kernels.segment_min.segment_min import (
    check_lanes, launch_segscan, segmented_min2_scan_plain)
from repro_torch.launch import flops

INF_KEY = keys_lib.INF_KEY

_grids: dict = {}          # device index -> K3's (blocks, threads)
_jump_flags: dict = {}     # (device index, stream) -> K3's step flags


def masked_minplus_scan_plain(seg: torch.Tensor, oth: torch.Tensor,
                              key: torch.Tensor) -> torch.Tensor:
    """Plain version: mask the lanes, then the plain segmented scan."""
    live = (seg != oth) & (key != INF_KEY)
    return segmented_min2_scan_plain(seg, torch.where(live, key, INF_KEY))


@flops.kernel("masked_minplus_scan")
def masked_minplus_scan(seg: torch.Tensor, oth: torch.Tensor,
                        key: torch.Tensor) -> torch.Tensor:
    """Masked inclusive segmented min-scan of ``key`` along sorted ``seg``.

    ``seg``/``oth`` int32 (M,), ``key`` flipped int64 (M,).  The run ends
    hold each segment's masked min.
    """
    check_lanes("masked_minplus_scan", seg, key, oth)
    if seg.device.type == "cpu":
        return masked_minplus_scan_plain(seg, oth, key)
    if seg.device.type != "cuda":
        raise RuntimeError(f"masked_minplus_scan: no kernel for {seg.device}")
    return launch_segscan("masked_minplus_scan", seg, oth, key)


def jump_steps(n: int) -> int:
    """Doubling steps that fully compress any forest of ``n`` labels."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def pointer_jump_plain(parent: torch.Tensor, comp: torch.Tensor) -> torch.Tensor:
    """Plain version: clipped doubling gathers, then the clipped relabel."""
    n = parent.shape[0]
    p = parent
    for _ in range(jump_steps(n)):
        p = p[p.clamp(0, n - 1)]
    return p[comp.clamp(0, n - 1)]


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def jump_grid(device: torch.device) -> tuple[int, int]:
    """K3's largest grid on the card: (blocks it holds at once, threads a
    block); its one cooperative launch takes at most that.  Read once per
    device."""
    index = _index(device)
    grid = _grids.get(index)
    if grid is None:
        blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
        build.check(_jump_lib().pointer_jump_grid(
            index, ctypes.byref(blocks), ctypes.byref(threads)),
            "pointer_jump_grid")
        if blocks.value <= 0:
            raise RuntimeError(f"pointer_jump: {device} cannot launch a "
                               "cooperative kernel")
        grid = _grids[index] = (blocks.value, threads.value)
    return grid


def _flags(device: torch.device, stream: int) -> torch.Tensor:
    """K3's three step flags for launches on one stream of one device,
    zeroed when made; each launch leaves them at 0."""
    key = (_index(device), stream)
    flags = _jump_flags.get(key)
    if flags is None:
        flags = _jump_flags[key] = torch.zeros(3, dtype=torch.int32,
                                               device=device)
    return flags


def _jump_lib():
    lib = build.load("pointer_jump")
    lib.pointer_jump.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.pointer_jump.restype = ctypes.c_int
    lib.pointer_jump_grid.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.pointer_jump_grid.restype = ctypes.c_int
    return lib


@flops.kernel("pointer_jump")
def pointer_jump(parent: torch.Tensor, comp: torch.Tensor) -> torch.Tensor:
    """Fused full path compression + relabel: ``pointer_double(parent)[comp]``.

    ``parent`` int32 (n,) with ``parent[i] <= i``, ``comp`` int32 (m,);
    returns int32 (m,).  The kernel is one launch that stops at the first
    step that changes no label; its result is that of all
    :func:`jump_steps` steps on any input.
    """
    for t in (parent, comp):
        if t.ndim != 1 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("pointer_jump: labels must be contiguous 1-D int32")
    if parent.device != comp.device:
        raise ValueError("pointer_jump: labels must share one device")
    if parent.shape[0] == 0:
        raise ValueError("pointer_jump: empty parent array")
    if parent.device.type == "cpu":
        return pointer_jump_plain(parent, comp)
    if parent.device.type != "cuda":
        raise RuntimeError(f"pointer_jump: no kernel for {parent.device}")
    lib = _jump_lib()
    n, m = parent.shape[0], comp.shape[0]
    out = torch.empty_like(comp)
    if m == 0:
        return out
    scratch = torch.empty(2 * n, dtype=torch.int32, device=parent.device)
    stream = torch.cuda.current_stream(parent.device).cuda_stream
    err = lib.pointer_jump(parent.data_ptr(), comp.data_ptr(), out.data_ptr(),
                           scratch.data_ptr(),
                           _flags(parent.device, stream).data_ptr(), n, m,
                           jump_steps(n), jump_grid(parent.device)[0],
                           stream)
    build.check(err, "pointer_jump")
    kernels.LAUNCHES["pointer_jump"] += 1
    return out
