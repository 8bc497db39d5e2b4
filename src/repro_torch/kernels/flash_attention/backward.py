"""The attention's backward pass, written out in tensor operations.

No Pallas kernel of the JAX package has a backward (there is no
``custom_vjp``): JAX trains by differentiating ``ref.attention``
(``kernels/flash_attention/ops.py`` takes it for S <= 1024), so XLA derives
the backward as plain matrix products.  This is that backward, in the
same float32 (float64 for float64 inputs): the softmax recomputed from q
and k as ``ref.attention`` computes it, then

    dV = Pᵀ·dO,  dS = P ∘ (dO·Vᵀ − rowsum(dO ∘ O)),
    dQ = scale·dS·K,  dK = scale·dSᵀ·Q.

A KV head's gradients are summed over its group of query heads: the
group's rows are laid side by side, (B, Hkv, G·S, D), so each product
sums over them.  The (S, S) probabilities are materialized, as in
``ref.attention``; a fused backward kernel is later speed work.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, acc_dtype


def attention_backward(q, k, v, o, do, *, causal: bool = True,
                       scale: float | None = None):
    """(dq, dk, dv) of ``o = attention(q, k, v)`` for ``do``, in the
    inputs' types.  q, o, do: (B, Hq, S, D); k, v: (B, Hkv, S, D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / np.sqrt(d))
    acc = acc_dtype(q.dtype)
    qf = q.to(acc).reshape(b, hkv, g * s, d)
    of = o.to(acc).reshape(b, hkv, g * s, d)
    dof = do.to(acc).reshape(b, hkv, g * s, d)
    kf, vf = k.to(acc), v.to(acc)
    logits = (qf @ kf.transpose(-1, -2)) * scale         # (B, Hkv, G·S, S)
    if causal:
        above = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        logits.masked_fill_(above.repeat(g, 1), NEG_INF)
    p = torch.softmax(logits, dim=-1)
    del logits
    dv = p.transpose(-1, -2) @ dof
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = (dof @ vf.transpose(-1, -2)).sub_(delta).mul_(p)   # in place: dS
    del p
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return (dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
