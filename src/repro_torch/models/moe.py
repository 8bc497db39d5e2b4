"""Mixture-of-Experts layer: a top-k router and sort-based grouped expert
products, in the names of the JAX package's ``models/moe.py``.

The single-device path of the JAX package's ``moe_apply``: a float32
softmax router over the experts padded to a multiple of ``EXPERT_PAD``
(the padding experts masked out), top-k with the gates renormalized, the
Switch-style aux loss, the token replicas sorted by expert (a stable
sort), three grouped products, a float32 scatter-add combine, and the
sigmoid-gated shared expert.  The JAX package's expert-parallel path
(``moe_ep.py``) runs only under a mesh whose model axis is larger than 1;
it waits for shards on several cards (ROADMAP queue 1, item 13b).

The grouped products are ``torch._grouped_mm`` over the sorted replicas,
the expert stacks kept in the JAX package's (E, in, out) layout; the JAX
package's ``ragged_dot`` is a plain XLA product that no Pallas kernel
computes (ROADMAP hazard H11).  Nothing here reads the device from the
host: the group sizes are counted with ``index_add_`` into a zero tensor
and their offsets are a device ``cumsum``.  On the card PyTorch runs a bf16
``_grouped_mm`` as one grouped GEMM with no host read, so a bf16 decode
step with MoE (the served type) runs under
``torch.cuda.set_sync_debug_mode("error")``; in float32 it takes its
fallback, one product per group, which reads the offsets on the host.
Rows must be 16-byte aligned (d_model and d_expert multiples of 8 in bf16,
of 4 in float32).  PyTorch's autograd differentiates ``_grouped_mm``
(``GroupedMmBackward0``): on the card in bf16 its backward is grouped
products with no host read, so training needs no backward of its own
here; the router's aux loss keeps its gradient.  The router and
``shared_gate`` stay float32 and are applied to float32 activations, as
in the JAX package (hazard H10); the expert stacks and the shared expert
are kept in the compute type.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

EXPERT_PAD = 16   # the expert count is padded to a multiple of this


def padded_experts(cfg: ModelConfig) -> int:
    return -(-cfg.n_experts // EXPERT_PAD) * EXPERT_PAD


class MoE(nn.Module):
    """``router`` (E_pad, d) float32; ``e_wi`` and ``e_wg`` (E_pad, d, f)
    and ``e_wd`` (E_pad, f, d) in the compute type (or the ``master``
    type, trainable); with shared experts, ``shared`` (a
    :class:`~repro_torch.models.layers.SwiGLU` of width ``d_shared``) and
    ``shared_gate`` (1, d) float32."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        e, d, f = padded_experts(cfg), cfg.d_model, cfg.d_expert
        dt, grad = layers.wdtype(cfg, master), master is not None
        new = functools.partial(layers.param, device=device,
                                requires_grad=grad)
        self.router = new((e, d), torch.float32)
        self.e_wi = new((e, d, f), dt)
        self.e_wg = new((e, d, f), dt)
        self.e_wd = new((e, f, d), dt)
        self.shared = self.shared_gate = None
        if cfg.n_shared:
            self.shared = layers.SwiGLU(d, cfg.d_shared, dtype=dt,
                                        device=device, requires_grad=grad)
            self.shared_gate = new((1, d), torch.float32)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The router N(0, 1/d); ``e_wi`` and ``e_wg`` N(0, 1/d) and
        ``e_wd`` N(0, 1/f), drawn in float32 as the JAX package draws
        them; the shared expert and its gate as dense matrices."""
        layers.dense_init_(self.router, generator)
        d, f = self.e_wi.shape[1], self.e_wi.shape[2]
        for w, fan_in in ((self.e_wi, d), (self.e_wg, d), (self.e_wd, f)):
            draw = torch.randn(w.shape, generator=generator, device=w.device)
            w.copy_(draw * float(1.0 / np.sqrt(fan_in)))
        if self.shared is not None:
            self.shared.reset_parameters(generator)
            layers.dense_init_(self.shared_gate, generator)


def moe_apply(p: MoE, x, cfg: ModelConfig):
    """x: (B, S, d) -> ((B, S, d), the router's aux loss, a float32
    scalar)."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    e_pad = p.e_wi.shape[0]
    xf = x.reshape(t, d)

    logits = F.linear(xf.float(), p.router)                  # (T, E_pad) f32
    pad = torch.arange(e_pad, device=x.device) >= e
    logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)     # (T, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # Aux load-balance loss (Switch-style): E · Σ_e f_e · p_e.
    flat = expert_idx.reshape(-1)                            # (T·k,)
    me = probs[:, :e].mean(dim=0)
    ce = torch.zeros(e_pad, dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.full((t * k,), 1.0 / (t * k), device=x.device))
    aux = e * torch.sum(me * ce[:e]) * cfg.router_aux_coef

    # Replicas sorted by expert; the groups' ends as device offsets.
    order = torch.argsort(flat, stable=True)
    token_of = order // k
    xs = xf[token_of]                                        # (T·k, d)
    sizes = torch.zeros(e_pad, dtype=torch.int32, device=x.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(sizes, dim=0, dtype=torch.int32)
    dt = x.dtype
    h = F.silu(torch._grouped_mm(xs, p.e_wg.to(dt), offs=offs)) * \
        torch._grouped_mm(xs, p.e_wi.to(dt), offs=offs)
    ys = torch._grouped_mm(h, p.e_wd.to(dt), offs=offs)      # (T·k, d)
    gates = gate_vals.reshape(-1)[order]
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add_(
        0, token_of, ys.float() * gates[:, None]).to(x.dtype)

    if p.shared is not None:
        sg = torch.sigmoid(F.linear(xf.float(), p.shared_gate))
        out = out + layers.swiglu_apply(p.shared, xf) * sg.to(x.dtype)
    return out.reshape(b, s, d), aux
