"""Shared neural layers: norms, RoPE, GQA attention, SwiGLU, the token
embedding and the chunked LM loss, in the names of the JAX package's
``models/layers.py``.

Each block of parameters is an ``nn.Module`` (:class:`Attention`,
:class:`SwiGLU`), and each function takes that module as ``p`` where the
JAX function takes its parameter dict.  Matrices are kept in ``F.linear``'s
(out, in) layout.  A served module keeps them in the compute type, cast
once when they are made or loaded, with ``requires_grad=False``; a module
made for training (``master=torch.float32``) keeps float32 masters that
require grad, as the JAX package does.  Either way each use casts the
matrix to the activations' type (``w.to(x.dtype)``), which for a served
module is the tensor itself.  Norm gains stay float32, as ``rmsnorm``
reads them.  ``sharding.specs.shard`` is a no-op on one device, so its
calls are dropped.

Cross-attention (the encoder–decoder family) is the ``x_kv`` argument of
``_project_qkv`` and ``attn_apply``, whose keys and values then come from
``x_kv`` with a length of their own, and the ``cross_kv`` branch of
``attn_decode``, which attends over the encoder's cached K/V.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core import runtime
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.config import ModelConfig


_aten = torch.ops.aten
# remat -> None (no checkpoint), () (a checkpoint that keeps nothing: the
# layer's forward reruns in the backward) or the ops whose outputs a
# selective checkpoint keeps: the matrix products (JAX's ``checkpoint_dots``)
# or those without batch dims (``checkpoint_dots_with_no_batch_dims``).
REMAT_POLICIES = {
    "none": None,
    "full": (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def remat(fn, policy: str):
    """``fn`` under ``policy``: itself, or a call of it under a checkpoint
    that keeps nothing (``full``) or the outputs of the matrix products
    (``dots``, ``dots_no_batch``), as the JAX package's ``jax.checkpoint``
    of a layer does.  A recomputed forward reruns its kernels."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {policy!r}; options: "
                         f"{sorted(REMAT_POLICIES)}")
    keep = REMAT_POLICIES[policy]
    if keep is None:
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if keep:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, list(keep))
    return functools.partial(ckpt.checkpoint, fn, **kw)


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def wdtype(cfg: ModelConfig, master: Optional[torch.dtype]) -> torch.dtype:
    """The type a module keeps its matrices in: the compute type for
    serving (``master`` None), else the master type."""
    return cdtype(cfg) if master is None else master


def param(shape, dtype, device, fill: Optional[float] = None, *,
          requires_grad: bool = False) -> nn.Parameter:
    """An uninitialized parameter (or one filled with ``fill``)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=requires_grad)


def dense_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Fill ``w`` (out, in) with N(0, 1/in) draws, made in float32 as the
    JAX package's ``dense_init`` makes them, then cast to ``w``'s type."""
    draw = torch.randn(w.shape, generator=generator, device=w.device,
                       dtype=torch.float32)
    w.copy_(draw * float(1.0 / np.sqrt(w.shape[1])))


def rmsnorm(x, gamma, eps):
    xf = x.float()
    nrm = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * nrm * gamma.float()).to(x.dtype)


def layernorm(x, gamma, beta, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (B, H, S, D); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = (1.0 / theta) ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        ang = (positions.float()[:, None] * freqs[None, :])[None, None]
    else:
        ang = positions.float()[:, None, :, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Stacked KV cache.  ``k``, ``v``: (L, B, Hkv, Smax, hd) device tensors,
    written in place (the JAX package returns a new cache at each step);
    ``index``: the filled length, a host int, so no step reads the device."""
    k: torch.Tensor
    v: torch.Tensor
    index: int


class Attention(nn.Module):
    """One GQA attention block: ``wq`` (q_dim, d_model), ``wk`` and ``wv``
    (kv_dim, d_model), ``wo`` (d_model, q_dim) in the compute type (or the
    ``master`` type); biases ``bq``/``bk``/``bv`` when ``cfg.qkv_bias``;
    per-head RMS gains ``qn``/``kn`` (float32) when ``cfg.qk_norm``."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        dt = wdtype(cfg, master)
        new = functools.partial(param, device=device,
                                requires_grad=master is not None)
        self.wq = new((cfg.q_dim, cfg.d_model), dt)
        self.wk = new((cfg.kv_dim, cfg.d_model), dt)
        self.wv = new((cfg.kv_dim, cfg.d_model), dt)
        self.wo = new((cfg.d_model, cfg.q_dim), dt)
        self.bq = self.bk = self.bv = self.qn = self.kn = None
        if cfg.qkv_bias:
            self.bq = new((cfg.q_dim,), dt, fill=0.0)
            self.bk = new((cfg.kv_dim,), dt, fill=0.0)
            self.bv = new((cfg.kv_dim,), dt, fill=0.0)
        if cfg.qk_norm:
            self.qn = new((cfg.hd,), torch.float32, fill=1.0)
            self.kn = new((cfg.hd,), torch.float32, fill=1.0)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random matrices; biases stay zero and gains one."""
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def attn_init(generator: torch.Generator, cfg: ModelConfig) -> Attention:
    """An :class:`Attention` with random matrices, zero biases and unit
    gains, on the generator's device."""
    p = Attention(cfg, device=generator.device)
    p.reset_parameters(generator)
    return p


def _cast(w, x):
    """``w`` in ``x``'s type (the tensor itself when it is already), or
    None."""
    return None if w is None else w.to(x.dtype)


def _project_qkv(p: Attention, x, cfg: ModelConfig, x_kv=None):
    """q (B, Hq, S, hd), k and v (B, Hkv, S_kv, hd), as views of the
    projections; k and v project ``x_kv`` (B, S_kv, d_model) where given,
    else ``x``."""
    x_kv = x if x_kv is None else x_kv
    b, s, _ = x.shape
    skv = x_kv.shape[1]
    q = F.linear(x, _cast(p.wq, x), _cast(p.bq, x))
    k = F.linear(x_kv, _cast(p.wk, x), _cast(p.bk, x))
    v = F.linear(x_kv, _cast(p.wv, x), _cast(p.bv, x))
    q = q.view(b, s, cfg.n_heads, cfg.hd).transpose(1, 2)
    k = k.view(b, skv, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
    v = v.view(b, skv, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, p.qn, cfg.norm_eps)
        k = rmsnorm(k, p.kn, cfg.norm_eps)
    return q, k, v


def attn_apply(p: Attention, x, cfg: ModelConfig, *, positions,
               causal: bool = True, use_rope: bool = True, x_kv=None,
               return_kv: bool = False):
    """Full-sequence attention (training, prefill, the encoder, and
    cross-attention over ``x_kv`` (B, S_kv, d_model), whose keys take the
    positions 0..S_kv-1 under RoPE).  ``return_kv`` also returns k and v
    (B, Hkv, S_kv, hd), after RoPE, for the cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, x_kv=x_kv)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if x_kv is None else
                 torch.arange(k.shape[2], device=x.device), cfg.rope_theta)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = attn_ops.attention(q, k, v, causal=causal)
    out = F.linear(o.transpose(1, 2).reshape(b, s, cfg.q_dim),
                   _cast(p.wo, x))
    if return_kv:
        return out, (k, v)
    return out


def attn_decode(p: Attention, x, cfg: ModelConfig, cache: Optional[KVCache],
                *, use_rope: bool = True, cross_kv=None):
    """One-token decode step, x (B, 1, d_model).  Returns (out, cache).

    With ``cross_kv`` = (k, v) (B, Hkv, S_kv, hd), the encoder's cached
    K/V, it attends over all S_kv of them (no RoPE on q, which the JAX
    package's branch leaves out too) and returns ``cache`` as given.
    Otherwise ``cache`` is one layer's (B, Hkv, Smax, hd) cache: this
    token's k and v are written at ``cache.index`` in place and the step
    attends over the first ``index + 1`` positions; the returned cache
    shares its tensors, one index on."""
    b = x.shape[0]
    if cross_kv is not None:
        k, v = cross_kv
        q = F.linear(x, _cast(p.wq, x), _cast(p.bq, x))
        q = q.view(b, cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p.qn, cfg.norm_eps)
        length = torch.full((b,), k.shape[2], dtype=torch.int32,
                            device=x.device)
        o = decode_ops.decode_attention(q.contiguous(), k, v, length)
        return F.linear(o.reshape(b, 1, cfg.q_dim), _cast(p.wo, x)), cache
    index = cache.index
    if not 0 <= index < cache.k.shape[2]:
        raise IndexError(f"KV cache of {cache.k.shape[2]} positions is full "
                         f"(index {index})")
    q, k1, v1 = _project_qkv(p, x, cfg)
    if use_rope:
        pos = torch.arange(index, index + 1, device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k1 = rope(k1, pos, cfg.rope_theta)
    cache.k[:, :, index] = k1[:, :, 0]
    cache.v[:, :, index] = v1[:, :, 0]
    length = torch.full((b,), index + 1, dtype=torch.int32, device=x.device)
    o = decode_ops.decode_attention(q[:, :, 0].contiguous(), cache.k,
                                    cache.v, length)
    out = F.linear(o.reshape(b, 1, cfg.q_dim), _cast(p.wo, x))
    return out, KVCache(k=cache.k, v=cache.v, index=index + 1)


def attn_decode_stacked(p: Attention, x, cfg: ModelConfig, ks, vs,
                        layer: int, index: int, *, use_rope: bool = True):
    """One-token decode step against the stacked (L, B, Hkv, S, hd) cache.

    Writes this token's k and v into ``ks``/``vs`` at (layer, index) in
    place and attends over the first ``index + 1`` positions.  Returns
    ``(out, ks, vs)`` as the JAX function does; ``ks``/``vs`` are the
    tensors passed in.  An ``index`` past the cache raises (the JAX
    package's ``dynamic_update_slice`` would clamp it)."""
    if not 0 <= index < ks.shape[3]:
        raise IndexError(f"KV cache of {ks.shape[3]} positions is full "
                         f"(index {index})")
    b = x.shape[0]
    q, k1, v1 = _project_qkv(p, x, cfg)
    if use_rope:
        pos = torch.arange(index, index + 1, device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k1 = rope(k1, pos, cfg.rope_theta)
    ks[layer, :, :, index] = k1[:, :, 0]
    vs[layer, :, :, index] = v1[:, :, 0]
    length = torch.full((b,), index + 1, dtype=torch.int32, device=x.device)
    o = decode_ops.decode_attention(q[:, :, 0].contiguous(), ks[layer],
                                    vs[layer], length)
    out = F.linear(o.reshape(b, 1, cfg.q_dim), _cast(p.wo, x))
    return out, ks, vs


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               n_layers: Optional[int] = None, device=None) -> KVCache:
    """Zero-filled stacked KV cache (L, B, Hkv, max_len, hd) in the compute
    type, on the card unless ``device`` names another."""
    nl = n_layers if n_layers is not None else cfg.n_layers
    shape = (nl, batch, cfg.n_kv_heads, max_len, cfg.hd)
    dev = runtime.resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=cdtype(cfg), device=dev),
                   v=torch.zeros(shape, dtype=cdtype(cfg), device=dev),
                   index=0)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``wi`` and ``wg`` (d_ff, d_model), ``wd`` (d_model, d_ff), in
    ``dtype``; trainable when ``requires_grad``."""

    def __init__(self, d_model: int, d_ff: int, *, dtype: torch.dtype,
                 device=None, requires_grad: bool = False):
        super().__init__()
        new = functools.partial(param, dtype=dtype, device=device,
                                requires_grad=requires_grad)
        self.wi = new((d_ff, d_model))
        self.wg = new((d_ff, d_model))
        self.wd = new((d_model, d_ff))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wi, self.wg, self.wd):
            dense_init_(w, generator)


def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int, *,
                dtype: torch.dtype) -> SwiGLU:
    p = SwiGLU(d_model, d_ff, dtype=dtype, device=generator.device)
    p.reset_parameters(generator)
    return p


def swiglu_apply(p: SwiGLU, x):
    return F.linear(F.silu(F.linear(x, _cast(p.wg, x)))
                    * F.linear(x, _cast(p.wi, x)), _cast(p.wd, x))


# ---------------------------------------------------------------------------
# Token embedding and the LM head
# ---------------------------------------------------------------------------

def embed_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """``embed`` (vocab, d_model) N(0, 0.02²) and, unless the embeddings are
    tied, ``lm_head`` (vocab, d_model) N(0, 1/d_model): float32 draws on the
    generator's device."""
    dev = generator.device
    out = dict(embed=torch.randn((cfg.vocab, cfg.d_model),
                                 generator=generator, device=dev) * 0.02)
    if not cfg.tie_embeddings:
        out["lm_head"] = torch.empty((cfg.vocab, cfg.d_model), device=dev)
        dense_init_(out["lm_head"], generator)
    return out


def embed_tokens(p, tokens, cfg: ModelConfig):
    """Rows of ``p.embed`` for int tokens (B, S), in the compute type."""
    return F.embedding(tokens, p.embed).to(cdtype(cfg))


def _head(p, cfg: ModelConfig):
    return p.embed if cfg.tie_embeddings else p.lm_head


def lm_logits(p, x, cfg: ModelConfig):
    return F.linear(x, _cast(_head(p, cfg), x))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def chunked_lm_loss(p, x, labels, cfg: ModelConfig, *, chunk: int = 512):
    """Mean cross-entropy over sequence chunks: each chunk's (B, chunk, V)
    logits live only inside a ``checkpoint`` and are recomputed in the
    backward, so the full (B, S, V) logits are never held (the JAX
    package's ``@jax.checkpoint`` scan).  A sequence that is not a
    multiple of ``chunk``, or not longer, takes the plain head."""
    b, s, _ = x.shape
    if s % chunk != 0 or s <= chunk:
        return cross_entropy(lm_logits(p, x, cfg), labels)
    w = _cast(_head(p, cfg), x)          # cast once, outside the chunks
    nll = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        n, c = ckpt.checkpoint(_chunk_sums, x[:, i:i + chunk], w,
                          labels[:, i:i + chunk], use_reentrant=False,
                          preserve_rng_state=False)
        nll, cnt = nll + n, cnt + c
    return nll / torch.clamp_min(cnt, 1.0)


def _chunk_sums(x, w, labels):
    return _ce_sums(F.linear(x, w), labels)


def _ce_sums(logits, labels, mask=None):
    """(summed negative log-likelihood, count) in float32 over the valid
    labels (``labels >= 0``, and ``mask`` where given).  The label's
    log-probability is a gather, which equals the JAX package's masked sum
    over the vocab (one nonzero term)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    valid = labels >= 0 if mask is None else mask & (labels >= 0)
    valid_f = valid.float()
    return ((lse - ll) * valid_f).sum(), valid_f.sum()


def cross_entropy(logits, labels, mask=None):
    """Mean cross-entropy in float32; labels -100 (or ``mask`` 0) are
    ignored."""
    nll, cnt = _ce_sums(logits, labels, mask)
    return nll / torch.clamp_min(cnt, 1.0)
