"""Plain version of the RWKV-6 WKV recurrence: a per-step scan in float32.

Per batch·head, with key/value dim D and S_0 = 0:

    out_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t   = diag(w_t) S_{t-1} + k_tᵀ v_t

The JAX package's ``ref.wkv6`` runs the same steps in checkpointed chunks
of a divisor of T; chunking changes memory, not numbers, so this version
has none.  Every product and sum is a separately rounded float32 operation
in a fixed order, and the sum over i is a halving tree
(:func:`halving_sum`): the CUDA kernel ``csrc/wkv6.cu`` does the same
operations in the same order, so on the card the two agree bit for bit.
float64 inputs are computed in float64 (for ``gradcheck``); the kernel
takes float32 and bf16 only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import acc_dtype


def halving_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 as a halving tree: element i adds element i + n/2,
    the odd one out of an odd length carried to the next level."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        head = x[:, :h] + x[:, h:2 * h]
        x = head if x.shape[1] == 2 * h else torch.cat([head, x[:, 2 * h:]], 1)
    return x[:, 0]


def _step(s, r, k, v, w, u):
    """One float32 step: state (BH, D, D), token inputs and u (BH, D).
    Returns (new state, out (BH, D))."""
    kv = k[:, :, None] * v[:, None, :]
    out = halving_sum((s + u[:, :, None] * kv) * r[:, :, None])
    return w[:, :, None] * s + kv, out


def wkv6(r, k, v, w, u, *, return_state: bool = False):
    """r, k, v, w: (BH, T, D); u: (BH, D).  Returns out (BH, T, D) in r's
    type and, with ``return_state``, the final state (BH, D, D) float32
    (float64 for float64 inputs)."""
    bh, t, d = r.shape
    acc = acc_dtype(r.dtype)
    rf, kf, vf, wf, uf = (z.to(acc) for z in (r, k, v, w, u))
    s = torch.zeros((bh, d, d), dtype=acc, device=r.device)
    outs = []
    for i in range(t):
        s, o = _step(s, rf[:, i], kf[:, i], vf[:, i], wf[:, i], uf)
        outs.append(o)
    out = (torch.stack(outs, dim=1) if outs else
           torch.zeros((bh, 0, d), dtype=acc, device=r.device))
    out = out.to(r.dtype)
    return (out, s) if return_state else out


def wkv6_step(s, r, k, v, w, u):
    """One decode step: state (BH, D, D), token inputs (BH, D), in the
    types given (the model passes its compute type and a float32 state).
    Returns (new state, out (BH, D))."""
    kv = k[:, :, None] * v[:, None, :]
    out = ((s + u[:, :, None] * kv) * r[:, :, None]).sum(dim=1)
    s = w[:, :, None] * s + kv
    return s, out
