"""The WKV6 recurrence's backward pass, written out in tensor operations.

No Pallas kernel of the JAX package has a backward: JAX trains RWKV6 by
differentiating ``ref.wkv6``, a ``lax.scan`` in checkpointed chunks of
time.  This is that backward, in float32 (float64 for float64 inputs).
Per batch·head, with S_0 = 0,

    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t),   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t,

the adjoint G_t = ∂L/∂S_t runs backwards from G_T = 0 as
G_{t-1} = diag(w_t) G_t + r_tᵀ dy_t, and then

    dr_t = (S_{t-1} + diag(u) k_tᵀ v_t) dy_tᵀ,   dk_t = G_t v_t + u∘r_t (v_t·dy_t),
    dv_t = G_tᵀ k_t + dy_t Σ_i r_t u k_t,       dw_t = rowsum(G_t ∘ S_{t-1}),
    du   = Σ_t r_t∘k_t (v_t·dy_t).

Time goes in chunks of ``min(CHUNK, T)`` steps, the reference's chunk.
The chunks' start states come from a plain forward of the states (one
``addcmul_`` a step); then, chunk by chunk from the last, the chunk's
states are recomputed from its start state and its adjoints run
backwards, one ``addcmul_`` a step each, into (BH, C, D, D) buffers; every
other term is a batched product over the whole chunk.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import acc_dtype

CHUNK = 128


def _chunk_states(s, k, v, w):
    """The states of a chunk from its start state ``s``: (P, end), P (BH,
    C, D, D) the state before each step (P[:, 0] = ``s``, P[:, i+1] =
    diag(w_i) P[:, i] + k_iᵀ v_i) and ``end`` the state after the last."""
    n = k.shape[1]
    p = torch.empty((s.shape[0], n) + s.shape[1:], dtype=s.dtype,
                    device=s.device)
    p[:, 0] = s
    torch.mul(k[:, :-1, :, None], v[:, :-1, None, :], out=p[:, 1:])
    for i in range(1, n):
        p[:, i].addcmul_(w[:, i - 1, :, None], p[:, i - 1])
    end = torch.addcmul(k[:, -1, :, None] * v[:, -1, None, :],
                        w[:, -1, :, None], p[:, -1])
    return p, end


def wkv6_backward(r, k, v, w, u, do):
    """(dr, dk, dv, dw, du) of ``out = wkv6(r, k, v, w, u)`` for ``do``, in
    the inputs' types.  r, k, v, w, do: (BH, T, D); u: (BH, D)."""
    bh, t, d = r.shape
    acc = acc_dtype(r.dtype)
    rf, kf, vf, wf, dy = (z.to(acc) for z in (r, k, v, w, do))
    uf = u.to(acc)
    grads = [torch.zeros((bh, t, d), dtype=acc, device=r.device)
             for _ in range(4)]
    du = torch.zeros((bh, d), dtype=acc, device=r.device)
    c = min(CHUNK, t)
    bounds = [(t0, min(t0 + c, t)) for t0 in range(0, t, c)] if t else []
    starts = [torch.zeros((bh, d, d), dtype=acc, device=r.device)]
    for t0, t1 in bounds[:-1]:
        starts.append(_chunk_states(starts[-1], kf[:, t0:t1], vf[:, t0:t1],
                                    wf[:, t0:t1])[1])
    carry = torch.zeros((bh, d, d), dtype=acc, device=r.device)
    for (t0, t1), s0 in zip(reversed(bounds), reversed(starts)):
        rc, kc, vc, wc, dc = (z[:, t0:t1] for z in (rf, kf, vf, wf, dy))
        n = t1 - t0
        prev = _chunk_states(s0, kc, vc, wc)[0]         # S_{t-1}
        g = torch.empty_like(prev)                      # G_t
        torch.mul(rc[:, 1:, :, None], dc[:, 1:, None, :], out=g[:, :n - 1])
        g[:, n - 1] = carry
        for i in range(n - 1, 0, -1):
            g[:, i - 1].addcmul_(wc[:, i, :, None], g[:, i])
        carry = torch.addcmul(rc[:, 0, :, None] * dc[:, 0, None, :],
                              wc[:, 0, :, None], g[:, 0])
        vdy = (vc * dc).sum(-1, keepdim=True)
        uk = uf[:, None] * kc
        # matrix-vector products as a product and a sum: as a batched
        # matmul they run as cuBLAS gemv at a fraction of the memory rate
        grads[0][:, t0:t1] = (prev * dc[..., None, :]).sum(-1) + uk * vdy
        grads[1][:, t0:t1] = (g * vc[..., None, :]).sum(-1) \
            + uf[:, None] * rc * vdy
        grads[2][:, t0:t1] = (g * kc[..., None]).sum(-2) \
            + dc * (rc * uk).sum(-1, keepdim=True)
        grads[3][:, t0:t1] = (g * prev).sum(-1)
        du.add_((rc * kc * vdy).sum(1))
        del prev, g
    return tuple(z.to(x.dtype) for z, x in
                 zip(grads + [du], (r, k, v, w, u)))
