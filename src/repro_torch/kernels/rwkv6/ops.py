"""WKV6 dispatch: the entry points the RWKV6 model calls.

The JAX package's ``wkv6`` runs its jnp scan unless ``use_pallas`` picks
the Pallas kernel, and takes the scan whenever the final state is asked
for; no model path passes ``use_pallas`` (ROADMAP hazard H9).  The port
has no such flag: on the card the stateless and the stateful forward both
run the kernel, on the CPU the plain version.  Where the inputs need a
gradient, the stateless forward runs through :class:`WKV6`, an autograd
Function whose forward is that same call and whose backward is
``backward.py``'s: JAX differentiates its jnp scan.  ``wkv6_step``, one
decode token, is plain tensor code on both, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import ref
from repro_torch.kernels.rwkv6.backward import wkv6_backward
from repro_torch.kernels.rwkv6.wkv6 import wkv6 as _wkv6


class WKV6(torch.autograd.Function):
    """``wkv6.wkv6`` (the kernel on a CUDA tensor, the plain version on a
    CPU tensor) with the explicit backward of ``backward.py``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return _wkv6(r, k, v, w, u)

    @staticmethod
    def backward(ctx, do):
        return wkv6_backward(*ctx.saved_tensors, do)


def wkv6(r, k, v, w, u, *, return_state: bool = False):
    """r, k, v, w (BH, T, D); u (BH, D).  The kernel on a CUDA tensor, the
    plain version on a CPU tensor, and any other device raises; with a
    gradient to carry and no state asked for, through :class:`WKV6`."""
    if not return_state and torch.is_grad_enabled() and any(
            z.requires_grad for z in (r, k, v, w, u)):
        return WKV6.apply(r, k, v, w, u)
    return _wkv6(r, k, v, w, u, return_state=return_state)


wkv6_step = ref.wkv6_step
