"""Plain version of decode attention: one query token against a masked KV
cache, all arithmetic in float32.  Cache positions ``>= length[b]`` get
the logit -1e30; a row with ``length == 0`` so averages V over all S."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def decode_attention(q, k, v, length, *, scale: float | None = None):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); length: (B,) int.  Returns
    (B, Hq, D) in q's type."""
    b, hq, d = q.shape
    s = k.shape[2]
    group = hq // k.shape[1]
    if scale is None:
        scale = float(1.0 / np.sqrt(d))
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), kf) * scale
    mask = (torch.arange(s, device=q.device)[None, None, :]
            < length.to(q.device)[:, None, None])
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vf).to(q.dtype)
