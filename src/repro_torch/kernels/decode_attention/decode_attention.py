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
``csrc/decode_attention.cu`` (built on first use); on a CPU tensor it runs
:func:`decode_attention_plain`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    MAX_GRID, TYPES, check_heads, check_launch)


def decode_attention_plain(q, k, v, length, *,
                           scale: float | None = None) -> torch.Tensor:
    """Plain version: the masked einsum of ``ref.py``."""
    return ref.decode_attention(q, k, v, length, scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """Attention of q (B, Hq, D) over the first ``length[b]`` positions of
    k, v (B, Hkv, S, D); ``length`` int32 (B,).

    Returns (B, Hq, D) in q's type.  CUDA tensors launch the kernel; CPU
    tensors take the plain version; any other device raises.
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
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention: no kernel for {q.device}")
    from repro_torch.kernels import build
    lib = build.load("decode_attention")
    lib.decode_attention_supports.argtypes = [ctypes.c_int]
    lib.decode_attention_supports.restype = ctypes.c_int
    lib.decode_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    lib.decode_attention_fwd.restype = ctypes.c_int
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   length.data_ptr(), out.data_ptr(),
                                   TYPES[q.dtype], b, hq, hkv, s, d, scale,
                                   stream)
    build.check(err, "decode_attention")
    kernels.LAUNCHES["decode_attention"] += 1
    return out
