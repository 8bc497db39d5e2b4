"""Selective-scan dispatch: the entry points the Mamba mixer calls.

The JAX package's ``selective_scan`` runs its jnp scan unless
``use_pallas`` picks the Pallas kernel, and takes the scan whenever the
final state is asked for; no model path passes ``use_pallas`` (ROADMAP
hazard H9).  The port has no such flag: on the card the stateless and the
stateful scan both run the kernel, on the CPU the plain version.  Where
the inputs need a gradient, the stateless scan runs through
:class:`SelectiveScan`, an autograd Function whose forward is that same
call and whose backward is ``backward.py``'s: JAX differentiates its jnp
scan.  ``selective_scan_step``, one decode token, is plain tensor code on
both, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import ref
from repro_torch.kernels.mamba_scan.backward import selective_scan_backward
from repro_torch.kernels.mamba_scan.mamba_scan import \
    selective_scan as _selective_scan


class SelectiveScan(torch.autograd.Function):
    """``mamba_scan.selective_scan`` (the kernel on a CUDA tensor, the
    plain version on a CPU tensor) with the explicit backward of
    ``backward.py``."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d):
        ctx.save_for_backward(x, dt, b, c, a, d)
        return _selective_scan(x, dt, b, c, a, d)

    @staticmethod
    def backward(ctx, dy):
        return selective_scan_backward(*ctx.saved_tensors, dy)


def selective_scan(x, dt, b, c, a, d, *, return_state: bool = False):
    """x, dt (B, T, dim); b, c (B, T, N); a (dim, N); d (dim,).  The kernel
    on a CUDA tensor, the plain version on a CPU tensor, and any other
    device raises; with a gradient to carry and no state asked for,
    through :class:`SelectiveScan`."""
    if not return_state and torch.is_grad_enabled() and any(
            z.requires_grad for z in (x, dt, b, c, a, d)):
        return SelectiveScan.apply(x, dt, b, c, a, d)
    return _selective_scan(x, dt, b, c, a, d, return_state=return_state)


selective_scan_step = ref.selective_scan_step
