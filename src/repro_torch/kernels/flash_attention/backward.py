"""The attention's backward pass, written out in tensor operations.

No Pallas kernel of the JAX package has a backward (there is no
``custom_vjp``): JAX trains by differentiating the attention its
``kernels/flash_attention/ops.py`` picks, ``ref.attention`` for S <= 1024
and the XLA strategies ``chunked_attention`` (S < 2048) and
``blocked_attention`` past that, so XLA derives the backward as plain
matrix products.  This is that backward, in the same float32 (float64 for
float64 inputs): the softmax recomputed from q and k as ``ref.attention``
computes it, then

    dV = Pᵀ·dO,  dS = P ∘ (dO·Vᵀ − rowsum(dO ∘ O)),
    dQ = scale·dS·K,  dK = scale·dSᵀ·Q.

A KV head's gradients are summed over its group of query heads: the
group's rows are laid side by side, (B, Hkv, G·S, D), so each product
sums over them.  With ``q_chunk`` the query rows go in blocks of that many:
each block recomputes its rows' probabilities over all S_kv keys, writes
its rows of dQ and adds its share to dK and dV, so the transient is
(B, Hkv, G·q_chunk, S_kv) rather than (B, Hkv, G·S, S_kv), as the JAX
package's blocked strategies keep theirs.  Without it the (S, S_kv)
probabilities are materialized at once, as in ``ref.attention``; a fused
backward kernel is later speed work.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, acc_dtype


def _rows(t, hkv, acc):
    """(B, Hq, R, D) -> (B, Hkv, G·R, D) in ``acc``: a KV head's group of
    query heads side by side."""
    b, hq, r, d = t.shape
    return t.to(acc).reshape(b, hkv, hq // hkv * r, d)


def attention_backward(q, k, v, o, do, *, causal: bool = True,
                       scale: float | None = None,
                       q_chunk: int | None = None):
    """(dq, dk, dv) of ``o = attention(q, k, v)`` for ``do``, in the
    inputs' types.  q, o, do: (B, Hq, S, D); k, v: (B, Hkv, S_kv, D), S_kv
    == S when ``causal``.  ``q_chunk`` (a divisor of S) runs the query rows
    in blocks of that many."""
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / np.sqrt(d))
    chunk = s if q_chunk is None else q_chunk
    if s % chunk:
        raise ValueError(f"attention_backward: q_chunk {chunk} does not "
                         f"divide S = {s}")
    acc = acc_dtype(q.dtype)
    kf, vf = k.to(acc), v.to(acc)
    dqs, dk, dv = [], None, None
    for i in range(0, s, chunk):
        rows = slice(i, i + chunk)
        qf = _rows(q[:, :, rows], hkv, acc)
        of = _rows(o[:, :, rows], hkv, acc)
        dof = _rows(do[:, :, rows], hkv, acc)
        logits = (qf @ kf.transpose(-1, -2)) * scale    # (B, Hkv, G·c, S_kv)
        if causal:
            above = torch.ones(chunk, skv, dtype=torch.bool,
                               device=q.device).triu(i + 1)
            logits.masked_fill_(above.repeat(g, 1), NEG_INF)
        p = torch.softmax(logits, dim=-1)
        del logits
        dv_i = p.transpose(-1, -2) @ dof
        delta = (dof * of).sum(dim=-1, keepdim=True)
        ds = (dof @ vf.transpose(-1, -2)).sub_(delta).mul_(p)   # in place: dS
        del p
        dqs.append(((ds @ kf) * scale).reshape(b, hq, chunk, d))
        dk_i = (ds.transpose(-1, -2) @ qf) * scale
        del ds
        dk = dk_i if dk is None else dk.add_(dk_i)
        dv = dv_i if dv is None else dv.add_(dv_i)
    dq = dqs[0] if len(dqs) == 1 else torch.cat(dqs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
