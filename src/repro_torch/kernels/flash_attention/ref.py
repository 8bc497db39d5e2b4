"""Plain version of flash attention: naive causal GQA attention, the
(S, S_kv) logits materialized, all arithmetic in float32 (float64 for float64
inputs)."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic type: float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S_kv, D) with Hq % Hkv == 0 (and
    S_kv == S when ``causal``: the mask is (S, S)).  Returns (B, Hq, S, D)
    in q's type."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    if scale is None:
        scale = float(1.0 / np.sqrt(d))
    acc = acc_dtype(q.dtype)
    kf = k.repeat_interleave(group, dim=1).to(acc)
    vf = v.repeat_interleave(group, dim=1).to(acc)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kf) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
