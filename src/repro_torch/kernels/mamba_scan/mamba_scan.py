"""The Mamba selective scan (S6): the CUDA kernel and its plain version.

Port of the Pallas kernel ``kernels/mamba_scan/mamba_scan.py::
selective_scan`` of the JAX package: per batch, channel and state index,
``h_t = exp(Δ_t·A)·h_{t-1} + Δ_t·B_t·x_t`` from h = 0 and
``y_t = Σ_n C_t·h_t + D·x_t``, float32 arithmetic, y in x's type.  Beside
it the kernel returns the final (B, dim, N) float32 state, which the JAX
package's op takes from its jnp scan instead (``ops.py:12-15``), and it
takes any T where the Pallas kernel asserts ``T % chunk == 0``.

On a CUDA tensor :func:`selective_scan` launches ``csrc/mamba_scan.cu``
(built on first use); on a CPU tensor it runs :func:`selective_scan_plain`.
The two do the same float32 operations in the same order, so on the card
they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.flash_attention import TYPES
from repro_torch.kernels.flash_attention.ref import acc_dtype
from repro_torch.kernels.mamba_scan import ref
from repro_torch.launch import flops


def selective_scan_plain(x, dt, b, c, a, d, *, return_state: bool = False):
    """Plain version: the per-step float32 scan of ``ref.py``."""
    return ref.selective_scan(x, dt, b, c, a, d, return_state=return_state)


def _check(x, dt, b, c, a, d) -> None:
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError("selective_scan: x and dt must both be (B, T, dim)")
    bsz, t, dim = x.shape
    if b.ndim != 3 or b.shape[:2] != (bsz, t) or c.shape != b.shape:
        raise ValueError("selective_scan: b and c must both be (B, T, N)")
    if a.shape != (dim, b.shape[2]) or d.shape != (dim,):
        raise ValueError("selective_scan: a must be (dim, N) and d (dim,)")
    if any(z.dtype != x.dtype for z in (dt, b, c)):
        raise TypeError("selective_scan: x, dt, b and c must share one type")
    want = acc_dtype(x.dtype)
    if a.dtype != want or d.dtype != want:
        raise TypeError("selective_scan: a and d must be float32 (float64 "
                        "for float64 inputs)")
    if any(z.device != x.device for z in (dt, b, c, a, d)):
        raise ValueError("selective_scan: all inputs must share one device")


@flops.kernel("selective_scan")
def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor, *,
                   return_state: bool = False):
    """x, dt (B, T, dim); b, c (B, T, N) of x's type; a (dim, N) and d
    (dim,) float32.

    Returns y (B, T, dim) in x's type and, with ``return_state``, the final
    state (B, dim, N) float32.  CUDA tensors launch the kernel; CPU tensors
    take the plain version; ``meta`` tensors (the dry run) get empty
    outputs and compute nothing; any other device raises.
    """
    _check(x, dt, b, c, a, d)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, b, c, a, d,
                                    return_state=return_state)
    if x.device.type == "meta":
        y = torch.empty_like(x)
        state = torch.empty((x.shape[0], x.shape[2], b.shape[2]),
                            dtype=acc_dtype(x.dtype), device="meta")
        return (y, state) if return_state else y
    if x.device.type != "cuda":
        raise RuntimeError(f"selective_scan: no kernel for {x.device}")
    from repro_torch.kernels import build
    lib = build.load("mamba_scan")
    lib.selective_scan_supports.argtypes = [ctypes.c_int]
    lib.selective_scan_supports.restype = ctypes.c_int
    lib.selective_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.selective_scan_fwd.restype = ctypes.c_int
    if x.dtype not in TYPES:
        raise TypeError(f"selective_scan: no kernel for {x.dtype}")
    if not all(z.is_contiguous() for z in (x, dt, b, c, a, d)):
        raise ValueError("selective_scan: tensors must be contiguous")
    bsz, t, dim = x.shape
    n = b.shape[2]
    if not lib.selective_scan_supports(n):
        raise ValueError(f"selective_scan: no kernel for state size {n}")
    if bsz > 65535:
        raise ValueError("selective_scan: batch must be <= 65535")
    y = torch.empty_like(x)
    state = torch.empty((bsz, dim, n), dtype=torch.float32, device=x.device)
    if bsz and dim:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            a.data_ptr(), d.data_ptr(), y.data_ptr(), state.data_ptr(),
            TYPES[x.dtype], bsz, t, dim, n, stream)
        build.check(err, "selective_scan")
        kernels.LAUNCHES["selective_scan"] += 1
    return (y, state) if return_state else y
