"""Decoder-only transformer LM, dense, MoE and VLM families: ``init``,
``forward``, ``loss_fn``, ``prefill`` and ``decode_step``, in the names of
the JAX package's ``models/transformer.py``.

The JAX package scans over stacked layer parameters; here each layer is a
:class:`Block` module in a ``ModuleList`` and the layer loop is a Python
loop.  The KV cache keeps the stacked (L, B, Hkv, S, hd) layout and is
written in place.  The moe family (Qwen2-MoE, Qwen3-MoE) runs here too: a
layer holds a :class:`~repro_torch.models.moe.MoE` in place of its dense
MLP when ``cfg.n_experts > 0``.  A model made with ``master=torch.float32``
trains: float32 masters that require grad, cast to the compute type at
each use.  ``layers.REMAT_POLICIES`` name what a layer's checkpoint keeps,
as the JAX package's ``jax.checkpoint`` policies do.  The vlm family
(InternVL2) is the dense model with a stub frontend, as in the JAX
package: precomputed patch embeddings (B, P, d_frontend), projected by
``patch_proj`` and put before the tokens (``prefix_embeds``); the loss
counts the token positions only.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import KVCache


FAMILIES = ("dense", "moe", "vlm")


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.n_experts > 0


class Block(nn.Module):
    """One pre-norm layer: ``ln1``, ``attn``, ``ln2``, and ``mlp`` (a dense
    SwiGLU) or, for an MoE config, ``moe``; trainable float32 masters when
    ``master`` is given."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        grad = master is not None
        self.ln1 = layers.param((cfg.d_model,), torch.float32, device, 1.0,
                                requires_grad=grad)
        self.ln2 = layers.param((cfg.d_model,), torch.float32, device, 1.0,
                                requires_grad=grad)
        self.attn = layers.Attention(cfg, device, master)
        if _is_moe(cfg):
            self.moe = moe.MoE(cfg, device, master)
        else:
            self.mlp = layers.SwiGLU(cfg.d_model, cfg.d_ff,
                                     dtype=layers.wdtype(cfg, master),
                                     device=device, requires_grad=grad)

    def _mlp(self, x):
        """The MLP half with its residual: (x + y, the router's aux loss,
        float32, or None for a dense MLP)."""
        cfg = self.cfg
        h = layers.rmsnorm(x, self.ln2, cfg.norm_eps)
        if _is_moe(cfg):
            y, aux = moe.moe_apply(self.moe, h, cfg)
            return x + y, aux
        return x + layers.swiglu_apply(self.mlp, h), None

    def forward(self, x, positions):
        """Prefill: x (B, S, d_model) -> (x, (k, v)), k and v (B, Hkv, S, hd)."""
        cfg = self.cfg
        h = layers.rmsnorm(x, self.ln1, cfg.norm_eps)
        a, kv = layers.attn_apply(self.attn, h, cfg, positions=positions,
                                  return_kv=True)
        return self._mlp(x + a)[0], kv

    def train_forward(self, x, positions):
        """Training: x (B, S, d_model) -> (x, aux); the attention keeps its
        gradient (``attn_ops.attention``'s autograd Function)."""
        h = layers.rmsnorm(x, self.ln1, self.cfg.norm_eps)
        x = x + layers.attn_apply(self.attn, h, self.cfg, positions=positions)
        x, aux = self._mlp(x)
        return x, (torch.zeros((), dtype=torch.float32, device=x.device)
                   if aux is None else aux)

    def decode(self, x, ks, vs, layer: int, index: int):
        """One token: x (B, 1, d_model); writes the cache at (layer, index)."""
        cfg = self.cfg
        h = layers.rmsnorm(x, self.ln1, cfg.norm_eps)
        a, _, _ = layers.attn_decode_stacked(self.attn, h, cfg, ks, vs,
                                             layer, index)
        return self._mlp(x + a)[0]


class Transformer(nn.Module):
    """The dense, MoE or VLM LM: ``embed``, ``lm_head`` (None when tied),
    ``layers``, ``final_norm`` and, with a frontend (``cfg.d_frontend``),
    ``patch_proj`` (d_model, d_frontend); parameters uninitialized until
    :func:`init` or ``convert.from_reference`` fills them.  ``master``
    None serves (matrices in the compute type, no grad); a dtype
    (float32) trains (masters of that type, every parameter requiring
    grad)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the transformer serves the {FAMILIES} "
                f"families, not {cfg.family}, which models.api.get_model "
                f"gives a model of its own (ROADMAP queue 1, item 14, done)")
        self.cfg = cfg
        dt = layers.wdtype(cfg, master)
        new = functools.partial(layers.param, device=device,
                                requires_grad=master is not None)
        self.embed = new((cfg.vocab, cfg.d_model), dt)
        self.lm_head = (None if cfg.tie_embeddings else
                        new((cfg.vocab, cfg.d_model), dt))
        self.final_norm = new((cfg.d_model,), torch.float32, fill=1.0)
        self.layers = nn.ModuleList(Block(cfg, device, master)
                                    for _ in range(cfg.n_layers))
        self.patch_proj = (new((cfg.d_model, cfg.d_frontend), dt)
                           if cfg.d_frontend else None)


def init(generator: torch.Generator, cfg: ModelConfig,
         master: Optional[torch.dtype] = None) -> Transformer:
    """Random weights from ``generator``, on its device; trainable float32
    masters when ``master`` is ``torch.float32``."""
    model = Transformer(cfg, device=generator.device, master=master)
    with torch.no_grad():
        for blk in model.layers:
            blk.attn.reset_parameters(generator)
            (blk.moe if _is_moe(cfg) else blk.mlp).reset_parameters(generator)
        for name, t in layers.embed_init(generator, cfg).items():
            getattr(model, name).copy_(t)
        if model.patch_proj is not None:
            layers.dense_init_(model.patch_proj, generator)
    return model


def _embed(params: Transformer, tokens, cfg: ModelConfig, prefix_embeds):
    """The tokens' embeddings, after the projected ``prefix_embeds`` (B, P,
    d_frontend) where given: (B, P + S, d_model)."""
    x = layers.embed_tokens(params, tokens, cfg)
    if prefix_embeds is None:
        return x
    pe = F.linear(prefix_embeds.to(x.dtype), params.patch_proj.to(x.dtype))
    return torch.cat([pe, x], dim=1)


def forward(params: Transformer, tokens, cfg: ModelConfig, *,
            prefix_embeds=None, remat: str = "none"):
    """The final hidden states (B, P + S, d_model), after the final norm,
    and the layers' summed aux loss (float32; 0 for a dense model)."""
    layer = layers.remat(Block.train_forward, remat)
    x = _embed(params, tokens, cfg, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.layers:
        x, a = layer(blk, x, positions)
        aux = aux + a
    return layers.rmsnorm(x, params.final_norm, cfg.norm_eps), aux


def loss_fn(params: Transformer, batch, cfg: ModelConfig, *,
            remat: str = "none"):
    """The chunked LM loss plus the aux loss, a float32 scalar.  ``batch``:
    ``tokens`` and ``labels`` (B, S) int, labels -100 ignored, and for the
    VLM ``patch_embeds`` (B, P, d_frontend), whose positions the loss
    skips."""
    prefix = batch.get("patch_embeds")
    x, aux = forward(params, batch["tokens"], cfg, prefix_embeds=prefix,
                     remat=remat)
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    return layers.chunked_lm_loss(params, x, batch["labels"], cfg) + aux


def prefill(params: Transformer, tokens, cfg: ModelConfig, *, max_len: int,
            prefix_embeds=None):
    """Run the prompt (B, S), after ``prefix_embeds`` (B, P, d_frontend)
    where given; return the last token's logits (B, 1, V) and a stacked
    cache of ``max_len`` positions filled to P + S."""
    x = _embed(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    positions = torch.arange(s, device=x.device)
    cache = layers.make_cache(cfg, b, max_len, n_layers=len(params.layers),
                              device=x.device)
    for i, blk in enumerate(params.layers):
        x, (k, v) = blk(x, positions)
        cache.k[i, :, :, :s] = k
        cache.v[i, :, :, :s] = v
    x = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = layers.lm_logits(params, x[:, -1:], cfg)
    return logits, KVCache(k=cache.k, v=cache.v, index=s)


def decode_step(params: Transformer, cache: KVCache, tokens,
                cfg: ModelConfig):
    """tokens (B, 1).  Returns (logits (B, 1, V), the cache one token on).

    The returned cache shares ``cache``'s tensors, which this step writes
    at position ``cache.index``: ``cache`` itself stays valid for its own
    index, since no read goes past it."""
    x = layers.embed_tokens(params, tokens, cfg)
    for i, blk in enumerate(params.layers):
        x = blk.decode(x, cache.k, cache.v, i, cache.index)
    x = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = layers.lm_logits(params, x, cfg)
    return logits, KVCache(k=cache.k, v=cache.v, index=cache.index + 1)
