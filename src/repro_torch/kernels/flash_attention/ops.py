"""Attention dispatch: the entry point the models call.

The JAX package picks, by sequence length, between the naive einsum, the
XLA memory strategies ``chunked_attention`` and ``blocked_attention``, and
the Pallas kernel (``use_pallas``).  The port always runs its kernel on the
card and the plain version on the CPU; the XLA strategies wait (ROADMAP
queue 1, item 14).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q (B, Hq, S, D); k, v (B, Hkv, S, D).  The kernel on a CUDA tensor,
    the plain version on a CPU tensor, and any other device raises."""
    return flash_attention(q, k, v, causal=causal, scale=scale)
