"""Decode-attention dispatch: the entry point the models call.

The JAX package runs ``grouped_decode_attention`` (one einsum) unless
``use_pallas`` picks its Pallas kernel, and also has the XLA strategy
``chunked_decode_attention``.  The port always runs its kernel on the card
and the plain version on the CPU, which stands for
``grouped_decode_attention``; the JAX dispatch never calls
``chunked_decode_attention``, so it has no counterpart here.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention as _decode_attention)


def decode_attention(q, k, v, length, *, scale: float | None = None):
    """q (B, Hq, D); k, v (B, Hkv, S, D); length int32 (B,).  The kernel on
    a CUDA tensor, the plain version on a CPU tensor, and any other device
    raises."""
    return _decode_attention(q, k, v, length, scale=scale)
