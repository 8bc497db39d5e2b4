"""Attention dispatch: the entry point the models call.

The JAX package picks, by sequence length, between the naive einsum, the
XLA memory strategies ``chunked_attention`` and ``blocked_attention``, and
the Pallas kernel (``use_pallas``).  The port always runs its kernel on the
card and the plain version on the CPU.  Where the inputs need a gradient,
it runs them through :class:`Attention`, an autograd Function whose
forward is that same call and whose backward is ``backward.py``'s: JAX
differentiates ``ref.attention``, which it takes for S <= 1024, so a
training forward longer than that waits for the XLA strategies (ROADMAP
queue 1, item 14, slice 4).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.backward import attention_backward
from repro_torch.kernels.flash_attention.flash_attention import flash_attention

TRAIN_MAX_SEQ = 1024    # the JAX package differentiates ref.attention up to here


class Attention(torch.autograd.Function):
    """``flash_attention`` (the kernel on a CUDA tensor, the plain version
    on a CPU tensor) with the explicit backward of ``backward.py``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        o = flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, do, causal=ctx.causal,
                                        scale=ctx.scale)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q (B, Hq, S, D); k, v (B, Hkv, S, D).  The kernel on a CUDA tensor,
    the plain version on a CPU tensor, and any other device raises; with a
    gradient to carry, through :class:`Attention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.shape[2] > TRAIN_MAX_SEQ:
            raise NotImplementedError(
                f"attention: a training forward of {q.shape[2]} > "
                f"{TRAIN_MAX_SEQ} positions needs chunked_attention / "
                f"blocked_attention (ROADMAP queue 1, item 14, slice 4)")
        return Attention.apply(q, k, v, causal, scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
