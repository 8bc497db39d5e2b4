"""Mamba-1 (S6) mixer layer for the Jamba hybrid (arXiv:2403.19887), in
the names of the JAX package's ``models/mamba.py``.

in_proj → depthwise causal conv1d → selective scan (through
``kernels/mamba_scan/ops``: the kernel K8 on the card, stateless or with
the final state) → gated output.  Decode carries a (conv window, SSM state)
pair per layer, O(1) in the sequence, and runs ``selective_scan_step``,
plain tensor code, as the JAX package does.

The precision is the JAX package's (ROADMAP hazard H10): ``in_proj``,
``x_proj`` and ``out_proj`` are kept in the compute type, as the JAX
package casts them at each use; ``dt_proj``, ``dt_bias``, ``a_log``,
``d_skip`` and the conv's ``conv_w`` and ``conv_b`` stay float32 masters.
The prefill conv runs in the compute type, the decode conv in float32, the
Δ projection and the scan in float32.  A mixer made with
``master=torch.float32`` trains: its three matrices become float32 masters
cast to the compute type at each use, every parameter requires grad (the
float32 leaves stay float32), and the scan runs through
``scan_ops.SelectiveScan`` (K8 forward, an explicit backward).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import runtime
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


class Mamba(nn.Module):
    """One mixer's parameters, named as the JAX package's ``mamba_init``
    names them: ``in_proj`` (2·d_inner, d), ``x_proj`` (r + 2N, d_inner)
    and ``out_proj`` (d, d_inner) in the compute type (or the ``master``
    type, trainable); ``dt_proj`` (d_inner, r), ``conv_w`` (K, d_inner),
    ``conv_b``, ``dt_bias``, ``a_log`` (d_inner, N) and ``d_skip``
    float32."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        d, di, n = cfg.d_model, cfg.d_inner, cfg.d_state
        r, dt, f32 = dt_rank(cfg), layers.wdtype(cfg, master), torch.float32
        new = functools.partial(layers.param, device=device,
                                requires_grad=master is not None)
        self.in_proj = new((2 * di, d), dt)
        self.conv_w = new((cfg.d_conv, di), f32)
        self.conv_b = new((di,), f32, fill=0.0)
        self.x_proj = new((r + 2 * n, di), dt)
        self.dt_proj = new((di, r), f32)
        self.dt_bias = new((di,), f32)
        self.a_log = new((di, n), f32)
        self.d_skip = new((di,), f32, fill=1.0)
        self.out_proj = new((d, di), dt)
        with torch.no_grad():
            self.a_log.copy_(torch.log(torch.arange(
                1, n + 1, dtype=f32, device=device)).expand(di, n))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random matrices (``dt_proj`` N(0, 1/r)), ``conv_w`` N(0, 1/K),
        and ``dt_bias`` the inverse softplus of U(0, 0.1) clipped to
        [1e-3, 0.1], as the JAX package draws them; ``conv_b``, ``a_log``
        (log 1..N in every row) and ``d_skip`` keep their constants."""
        for w in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            layers.dense_init_(w, generator)
        dev = self.conv_w.device
        k = self.conv_w.shape[0]
        self.conv_w.copy_(torch.randn(self.conv_w.shape, generator=generator,
                                      device=dev) * float(1.0 / np.sqrt(k)))
        u = torch.rand(self.dt_bias.shape, generator=generator, device=dev)
        self.dt_bias.copy_(torch.log(torch.expm1(
            torch.clamp(u * 0.1, 1e-3, 0.1))))


def _conv1d(x, w, b):
    """Depthwise causal conv in x's type.  x: (B, T, di); w: (K, di)
    float32, cast to x's type as the JAX package casts it; each output is
    the float32 sum of its K products, rounded once."""
    k, t = w.shape[0], x.shape[1]
    wx = w.to(x.dtype).float()
    xp = F.pad(x, (0, 0, k - 1, 0)).float()
    out = xp[:, :t] * wx[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * wx[i]
    return out.to(x.dtype) + b.to(x.dtype)


def _scan_inputs(p: Mamba, xc, cfg: ModelConfig):
    """From the conv output xc (..., di) in the compute type: Δ in float32
    and b, c (..., N) float32, contiguous."""
    r, n = dt_rank(cfg), cfg.d_state
    dbc = F.linear(xc, layers._cast(p.x_proj, xc))
    dtr, bmat, cmat = torch.split(dbc, [r, n, n], dim=-1)
    dt_t = F.softplus(F.linear(dtr.float(), p.dt_proj) + p.dt_bias)
    return dt_t, bmat.float().contiguous(), cmat.float().contiguous()


def mamba_apply(p: Mamba, x, cfg: ModelConfig, *, return_state: bool = False):
    """x: (B, T, d).  Returns y and, with ``return_state``, the decode
    state (conv state (B, K-1, di): the last K-1 pre-conv inputs, in x's
    type; SSM state (B, di, N) float32).  A prompt shorter than K-1 tokens
    has no full conv window to carry, and raises."""
    di, k = cfg.d_inner, cfg.d_conv
    if return_state and x.shape[1] < k - 1:
        raise ValueError(f"a prompt of {x.shape[1]} tokens is shorter than "
                         f"the conv window's {k - 1} (d_conv - 1): decode "
                         f"needs that many pre-conv inputs")
    dt_ = x.dtype
    xz = F.linear(x, layers._cast(p.in_proj, x))
    x1, z = xz[..., :di], xz[..., di:]
    xc = F.silu(_conv1d(x1, p.conv_w, p.conv_b))
    dt_t, bmat, cmat = _scan_inputs(p, xc, cfg)
    a = -torch.exp(p.a_log)
    res = scan_ops.selective_scan(xc.float().contiguous(), dt_t, bmat, cmat,
                                  a, p.d_skip, return_state=return_state)
    y, h = res if return_state else (res, None)
    y = F.linear(y.to(dt_) * F.silu(z), layers._cast(p.out_proj, x))
    if return_state:
        return y, (x1[:, x.shape[1] - (k - 1):], h)
    return y


def mamba_step(p: Mamba, x, cfg: ModelConfig, state):
    """x: (B, 1, d); state = (conv state (B, K-1, di), SSM state
    (B, di, N)).  Returns (y (B, 1, d), the new state)."""
    conv_state, h = state
    di = cfg.d_inner
    dt_ = x.dtype
    xz = F.linear(x, layers._cast(p.in_proj, x))
    x1, z = xz[:, 0, :di], xz[:, 0, di:]
    window = torch.cat([conv_state, x1[:, None]], dim=1)          # (B, K, di)
    xc = torch.einsum("bkd,kd->bd", window.float(), p.conv_w) + p.conv_b
    xc = F.silu(xc).to(dt_)
    dt_t, bvec, cvec = _scan_inputs(p, xc, cfg)
    a = -torch.exp(p.a_log)
    h, y = scan_ops.selective_scan_step(h, xc.float(), dt_t, bvec, cvec, a,
                                        p.d_skip)
    y = F.linear(y.to(dt_) * F.silu(z), layers._cast(p.out_proj, x))
    return y[:, None], (window[:, 1:], h)


def init_state(cfg: ModelConfig, batch: int, *, device=None):
    """Zero (conv state, SSM state), on the card unless ``device`` names
    another."""
    dev = runtime.resolve_device(device)
    return (torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                        dtype=layers.cdtype(cfg), device=dev),
            torch.zeros((batch, cfg.d_inner, cfg.d_state),
                        dtype=torch.float32, device=dev))
