"""Plain version of the Mamba selective scan (S6): a per-step float32 loop.

Per batch, channel d and state index n, from h_0 = 0:

    h_t[d,n] = exp(Δ_t[d]·A[d,n]) · h_{t-1}[d,n] + (Δ_t[d]·x_t[d]) · B_t[n]
    y_t[d]   = Σ_n C_t[n]·h_t[d,n] + D[d]·x_t[d]

The JAX package's ``ref.selective_scan`` runs the same steps in
checkpointed chunks of a divisor of T, which bound its backward residuals;
chunking changes memory, not numbers, so this version has none.  Every
product and sum is a separately rounded float32 operation in a fixed order,
and the sum over n is the halving tree of ``kernels/rwkv6/ref.halving_sum``:
the CUDA kernel ``csrc/mamba_scan.cu`` does the same operations in the same
order, so on the card the two agree bit for bit.  float64 inputs are
computed in float64 (for ``gradcheck``); the kernel takes float32 and bf16
only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import acc_dtype
from repro_torch.kernels.rwkv6.ref import halving_sum


def selective_scan(x, dt, b, c, a, d, *, return_state: bool = False):
    """x, dt: (B, T, dim); b, c: (B, T, N); a: (dim, N); d: (dim,).

    Returns y (B, T, dim) in x's type and, with ``return_state``, the final
    state (B, dim, N) float32 (float64 for float64 inputs)."""
    bsz, t, dim = x.shape
    n = b.shape[-1]
    acc = acc_dtype(x.dtype)
    xf, dtf, bf, cf, af, df = (z.to(acc) for z in (x, dt, b, c, a, d))
    h = torch.zeros((bsz, dim, n), dtype=acc, device=x.device)
    ys = []
    for i in range(t):
        dti, xi = dtf[:, i], xf[:, i]
        decay = torch.exp(dti[:, :, None] * af)
        h = decay * h + (dti * xi)[:, :, None] * bf[:, i, None, :]
        hc = (h * cf[:, i, None, :]).reshape(bsz * dim, n)
        ys.append(halving_sum(hc).reshape(bsz, dim) + df * xi)
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((bsz, 0, dim), dtype=acc, device=x.device))
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def selective_scan_step(h, x, dt, b, c, a, d):
    """One decode step: h (B, dim, N); x, dt (B, dim); b, c (B, N), in the
    types given (the model passes float32).  Returns (new h, y (B, dim))."""
    decay = torch.exp(dt[:, :, None] * a[None].float())
    h = decay * h + (dt * x)[:, :, None] * b[:, None, :]
    y = (h * c[:, None, :]).sum(dim=2) + d[None].float() * x
    return h, y
