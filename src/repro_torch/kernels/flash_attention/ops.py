"""Attention dispatch: the entry point the models call.

The JAX package picks, by sequence length, between the naive einsum, the
XLA memory strategies ``chunked_attention`` and ``blocked_attention``, and
the Pallas kernel (``use_pallas``).  The port always runs its kernel on the
card and the plain version on the CPU, at any length.  Where the inputs
need a gradient, it runs them through :class:`Attention`, an autograd
Function whose forward is that same call and whose backward is
``backward.py``'s.  JAX differentiates ``ref.attention`` up to 1,024
positions and its chunked and blocked strategies past that, whose live
logits are a block's; past 1,024 positions the backward likewise takes
the query rows in blocks of ``_pick_chunk(S, 512)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.backward import attention_backward
from repro_torch.kernels.flash_attention.flash_attention import flash_attention

BLOCK_ABOVE = 1024      # the JAX package differentiates ref.attention up to here
Q_CHUNK = 512           # the query block of its blocked_attention


class Attention(torch.autograd.Function):
    """``flash_attention`` (the kernel on a CUDA tensor, the plain version
    on a CPU tensor) with the explicit backward of ``backward.py``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        """o = attention(q, k, v); q (B, Hq, S, D), k and v (B, Hkv, S_kv,
        D)."""
        o = flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        s = q.shape[2]
        dq, dk, dv = attention_backward(
            q, k, v, o, do, causal=ctx.causal, scale=ctx.scale,
            q_chunk=_pick_chunk(s, Q_CHUNK) if s > BLOCK_ABOVE else None)
        return dq, dk, dv, None, None


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (handles 4352-style lengths)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q (B, Hq, S, D); k, v (B, Hkv, S_kv, D), S_kv == S when ``causal``.
    The kernel on a CUDA tensor, the plain version on a CPU tensor, and any
    other device raises; with a gradient to carry, through
    :class:`Attention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return Attention.apply(q, k, v, causal, scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
