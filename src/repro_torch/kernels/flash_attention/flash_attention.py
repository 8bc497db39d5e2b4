"""Causal or full GQA attention forward: the CUDA kernel and its plain
version.  Without the causal mask the keys may have a length of their own
(cross-attention: the decoder's queries over the encoder's frames).

Port of the Pallas kernel ``kernels/flash_attention/flash_attention.py::
flash_attention`` of the JAX package: an online softmax over key tiles,
float32 arithmetic whatever the input type, the output in q's type, and
kv head = q head // (Hq / Hkv).  The Pallas kernel asserts ``S % 128 == 0``
once S >= 128; that is its TPU tiling, not the function: this kernel takes
any S.

On a CUDA tensor :func:`flash_attention` launches ``csrc/flash_attention.cu``
(built on first use); on a CPU tensor it runs :func:`flash_attention_plain`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import flops

TYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID = 65535                 # CUDA's limit on gridDim.y and gridDim.z


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """Plain version: the naive attention of ``ref.py``, (S, S) logits."""
    return ref.attention(q, k, v, causal=causal, scale=scale)


def check_heads(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> None:
    """k and v of one shape, on q's device and of q's type, with a number
    of KV heads that divides q's."""
    if k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"{name}: k and v must both be (B, Hkv, S, D)")
    if q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"{name}: q, k and v differ in batch or head dim")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"{name}: {q.shape[1]} query heads do not group "
                         f"over {k.shape[1]} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k and v must share one type")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k and v must share one device")


def check_lengths(name: str, q: torch.Tensor, k: torch.Tensor,
                  causal: bool) -> None:
    """q (B, Hq, S, D) and k (B, Hkv, S_kv, D): S_kv equals S under the
    causal mask, whose (S, S) triangle the reference broadcasts."""
    if q.ndim != 4:
        raise ValueError(f"{name}: q must be (B, Hq, S, D)")
    if causal and k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: a causal call needs k's length "
                         f"{k.shape[2]} equal to q's {q.shape[2]}")


def check_launch(name: str, lib_supports, *tensors) -> None:
    """What the CUDA kernels take: float32 or bfloat16, contiguous, 16-byte
    aligned, and a head dim the source is built for."""
    for t in tensors:
        if t.dtype not in TYPES:
            raise TypeError(f"{name}: no kernel for {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             f"16-byte aligned")
    d = tensors[0].shape[-1]
    if not lib_supports(d):
        raise ValueError(f"{name}: no kernel for head dim {d}")


@flops.kernel("flash_attention", flops.attention_matmul_flops)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Attention of q (B, Hq, S, D) over k, v (B, Hkv, S_kv, D); Hq % Hkv
    == 0, and S_kv == S when ``causal``.

    Returns (B, Hq, S, D) in q's type.  CUDA tensors launch the kernel; CPU
    tensors take the plain version; ``meta`` tensors (the dry run) get an
    empty output and compute nothing; any other device raises.
    """
    check_heads("flash_attention", q, k, v)
    check_lengths("flash_attention", q, k, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    lib.flash_attention_supports.argtypes = [ctypes.c_int]
    lib.flash_attention_supports.restype = ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    check_launch("flash_attention", lib.flash_attention_supports, q, k, v)
    b, hq, s, d = q.shape
    if b > MAX_GRID or hq > MAX_GRID:
        raise ValueError("flash_attention: batch and heads must be <= 65535")
    if scale is None:
        scale = float(1.0 / np.sqrt(d))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if k.shape[2] == 0:              # no keys: the plain version's zeros
        return out.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), TYPES[q.dtype], b, hq,
                                  k.shape[1], s, k.shape[2], d, scale,
                                  int(causal), stream)
    build.check(err, "flash_attention")
    kernels.LAUNCHES["flash_attention"] += 1
    return out
