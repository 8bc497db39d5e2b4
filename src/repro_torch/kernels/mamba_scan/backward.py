"""The selective scan's backward pass, written out in tensor operations.

No Pallas kernel of the JAX package has a backward: JAX trains the Mamba
mixer by differentiating ``ref.selective_scan``, a ``lax.scan`` in
checkpointed chunks of time.  This is that backward, in float32 (float64
for float64 inputs).  Per batch, with h_0 = 0, a_t = exp(Δ_t A),

    h_t = a_t ∘ h_{t-1} + (Δ_t x_t) B_t,   y_t = C_t · h_t + D ∘ x_t,

the adjoint G_t = ∂L/∂h_t runs backwards as G_t = a_{t+1} ∘ G_{t+1} +
dy_t ⊗ C_t, and then, with q_t = G_t ∘ h_{t-1} ∘ a_t,

    dC_t = h_tᵀ dy_t,        dB_t = G_tᵀ (Δ_t x_t),     dD = Σ_t dy_t ∘ x_t,
    dx_t = dy_t ∘ D + Δ_t ∘ G_t B_t,   dΔ_t = x_t ∘ G_t B_t + rowsum(q_t ∘ A),
    dA   = Σ_t q_t ∘ Δ_t.

``a`` and ``d`` are the float32 ``-exp(a_log)`` and ``d_skip`` the model
passes, so their gradients flow on to ``a_log`` and ``d_skip``.  Time goes
in chunks as in ``kernels/rwkv6/backward.py``: the chunks' start states
from a plain forward of the states, then per chunk from the last its
states recomputed and its adjoints run backwards, one ``addcmul_`` a step
each; the rest is batched over the chunk.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import acc_dtype

CHUNK = 128


def _chunk_states(h, decay, dbx):
    """The states of a chunk from its start state ``h`` (B, dim, N):
    (H, end), H (B, C, dim, N) the state before each step (H[:, 0] =
    ``h``, H[:, i+1] = a_i ∘ H[:, i] + (Δ_i x_i) B_i) and ``end`` the state
    after the last."""
    n = decay.shape[1]
    p = torch.empty_like(decay)
    p[:, 0] = h
    p[:, 1:] = dbx[:, :-1]
    for i in range(1, n):
        p[:, i].addcmul_(decay[:, i - 1], p[:, i - 1])
    return p, torch.addcmul(dbx[:, -1], decay[:, -1], p[:, -1])


def selective_scan_backward(x, dt, b, c, a, d, dy):
    """(dx, ddt, db, dc, da, dd) of ``y = selective_scan(x, dt, b, c, a,
    d)`` for ``dy``, in the inputs' types.  x, dt, dy: (B, T, dim); b, c:
    (B, T, N); a: (dim, N); d: (dim,)."""
    bsz, t, dim = x.shape
    n = b.shape[-1]
    acc = acc_dtype(x.dtype)
    xf, dtf, bf, cf, af, df, dyf = (z.to(acc)
                                    for z in (x, dt, b, c, a, d, dy))
    dx, ddt = (torch.zeros((bsz, t, dim), dtype=acc, device=x.device)
               for _ in range(2))
    db, dc = (torch.zeros((bsz, t, n), dtype=acc, device=x.device)
              for _ in range(2))
    da = torch.zeros((dim, n), dtype=acc, device=x.device)
    dd = (dyf * xf).sum((0, 1))

    def inputs(t0, t1):
        """a_t and (Δ_t x_t) B_t over steps t0..t1-1: (B, C, dim, N)."""
        dtc = dtf[:, t0:t1]
        return (torch.exp(dtc[..., None] * af),
                (dtc * xf[:, t0:t1])[..., None] * bf[:, t0:t1, None, :])

    ck = min(CHUNK, t)
    bounds = [(t0, min(t0 + ck, t)) for t0 in range(0, t, ck)] if t else []
    starts = [torch.zeros((bsz, dim, n), dtype=acc, device=x.device)]
    for t0, t1 in bounds[:-1]:
        starts.append(_chunk_states(starts[-1], *inputs(t0, t1))[1])
    carry = torch.zeros((bsz, dim, n), dtype=acc, device=x.device)
    for (t0, t1), h0 in zip(reversed(bounds), reversed(starts)):
        decay, dbx = inputs(t0, t1)
        prev, end = _chunk_states(h0, decay, dbx)        # h_{t-1}
        dyc, cc, bc = dyf[:, t0:t1], cf[:, t0:t1], bf[:, t0:t1]
        g = dyc[..., None] * cc[:, :, None, :]           # G_t
        g[:, -1].add_(carry)
        for i in range(t1 - t0 - 1, 0, -1):
            g[:, i - 1].addcmul_(decay[:, i], g[:, i])
        carry = decay[:, 0] * g[:, 0]
        # h_t: the states after each step, prev shifted by one
        cur = torch.cat([prev[:, 1:], end[:, None]], dim=1)
        dc[:, t0:t1] = torch.einsum("btdn,btd->btn", cur, dyc)
        del cur, dbx
        dtc, xc = dtf[:, t0:t1], xf[:, t0:t1]
        gb = torch.einsum("btdn,btn->btd", g, bc)
        db[:, t0:t1] = torch.einsum("btdn,btd->btn", g, dtc * xc)
        q = g.mul_(prev).mul_(decay)                      # in place: q_t
        del prev, decay
        dx[:, t0:t1] = dyc * df + dtc * gb
        ddt[:, t0:t1] = xc * gb + torch.einsum("btdn,dn->btd", q, af)
        da.add_(torch.einsum("btdn,btd->dn", q, dtc))
        del q, g
    return tuple(z.to(w.dtype) for z, w in
                 zip((dx, ddt, db, dc, da, dd), (x, dt, b, c, a, d)))
