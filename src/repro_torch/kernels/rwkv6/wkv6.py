"""The RWKV-6 WKV recurrence: the CUDA kernel and its plain version.

Port of the Pallas kernel ``kernels/rwkv6/rwkv6.py::wkv6`` of the JAX
package: per batch·head, ``out_t = r_t·(S + diag(u) k_tᵀv_t)`` and
``S ← diag(w_t) S + k_tᵀv_t`` from S = 0, float32 arithmetic, the output
in r's type.  Beside it the kernel returns the final (BH, D, D) float32
state, which the JAX package's op takes from its jnp scan instead
(``ops.py:10-12``), and it takes any T where the Pallas kernel asserts
``T % chunk == 0``.

On a CUDA tensor :func:`wkv6` launches ``csrc/wkv6.cu`` (built on first
use); on a CPU tensor it runs :func:`wkv6_plain`.  The two do the same
float32 operations in the same order, so on the card they agree bit for
bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.flash_attention import (
    TYPES, check_launch)
from repro_torch.kernels.flash_attention.ref import acc_dtype
from repro_torch.kernels.rwkv6 import ref
from repro_torch.launch import flops


def wkv6_plain(r, k, v, w, u, *, return_state: bool = False):
    """Plain version: the per-step float32 scan of ``ref.py``."""
    return ref.wkv6(r, k, v, w, u, return_state=return_state)


def _check(r, k, v, w, u) -> None:
    if r.ndim != 3 or any(z.shape != r.shape for z in (k, v, w)):
        raise ValueError("wkv6: r, k, v and w must all be (BH, T, D)")
    if u.shape != (r.shape[0], r.shape[2]):
        raise ValueError("wkv6: u must be (BH, D)")
    if any(z.dtype != r.dtype for z in (k, v, w, u)):
        raise TypeError("wkv6: r, k, v, w and u must share one type")
    if any(z.device != r.device for z in (k, v, w, u)):
        raise ValueError("wkv6: r, k, v, w and u must share one device")


@flops.kernel("wkv6")
def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, return_state: bool = False):
    """r, k, v, w (BH, T, D) with w the decay in (0, 1); u (BH, D).

    Returns out (BH, T, D) in r's type and, with ``return_state``, the
    final state (BH, D, D) float32.  CUDA tensors launch the kernel; CPU
    tensors take the plain version; ``meta`` tensors (the dry run) get
    empty outputs and compute nothing; any other device raises.
    """
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, return_state=return_state)
    if r.device.type == "meta":
        out = torch.empty_like(r)
        state = torch.empty((r.shape[0], r.shape[2], r.shape[2]),
                            dtype=acc_dtype(r.dtype), device="meta")
        return (out, state) if return_state else out
    if r.device.type != "cuda":
        raise RuntimeError(f"wkv6: no kernel for {r.device}")
    from repro_torch.kernels import build
    lib = build.load("wkv6")
    lib.wkv6_supports.argtypes = [ctypes.c_int]
    lib.wkv6_supports.restype = ctypes.c_int
    lib.wkv6_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.wkv6_fwd.restype = ctypes.c_int
    check_launch("wkv6", lib.wkv6_supports, r, k, v, w, u)
    bh, t, d = r.shape
    out = torch.empty_like(r)
    state = torch.empty((bh, d, d), dtype=torch.float32, device=r.device)
    if bh:
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           w.data_ptr(), u.data_ptr(), out.data_ptr(),
                           state.data_ptr(), TYPES[r.dtype], bh, t, d, stream)
        build.check(err, "wkv6")
        kernels.LAUNCHES["wkv6"] += 1
    return (out, state) if return_state else out
