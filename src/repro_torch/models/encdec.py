"""Encoder–decoder backbone (SeamlessM4T-large v2): ``init``, ``encode``,
``decode_train``, ``loss_fn``, ``prefill`` and ``decode_step``, in the
names of the JAX package's ``models/encdec.py``.

The modality frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, S_enc, d_frontend) and projects them with
``frame_proj``.  Everything after it is real: ``n_enc_layers`` encoder
layers (non-causal self-attention with RoPE), ``n_layers`` decoder layers
(causal self-attention with RoPE, then cross-attention over the encoder's
output, non-causal, no RoPE), and the vocabulary head.  The JAX package
scans over stacked layers; here each is a module in a ``ModuleList`` and
the loops are Python loops.  Every attention of the prefill runs the
flash-attention kernel K6 (cross-attention with the encoder's length as
its key length), and each decode step runs the decode-attention kernel K7
twice a layer: over the self cache and over the cross K/V the prefill
cached.  A model made with ``master=torch.float32`` trains, as
``transformer.Transformer`` does; ``remat`` checkpoints each layer of both
stacks under ``layers.REMAT_POLICIES``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import KVCache


def _norm(cfg, device, grad):
    return layers.param((cfg.d_model,), torch.float32, device, 1.0,
                        requires_grad=grad)


class EncLayer(nn.Module):
    """``ln1``, ``attn`` (non-causal self-attention), ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        grad = master is not None
        self.ln1 = _norm(cfg, device, grad)
        self.ln2 = _norm(cfg, device, grad)
        self.attn = layers.Attention(cfg, device, master)
        self.mlp = layers.SwiGLU(cfg.d_model, cfg.d_ff,
                                 dtype=layers.wdtype(cfg, master),
                                 device=device, requires_grad=grad)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.attn, self.mlp):
            m.reset_parameters(generator)

    def forward(self, x, positions):
        cfg = self.cfg
        h = layers.rmsnorm(x, self.ln1, cfg.norm_eps)
        x = x + layers.attn_apply(self.attn, h, cfg, positions=positions,
                                  causal=False)
        h = layers.rmsnorm(x, self.ln2, cfg.norm_eps)
        return x + layers.swiglu_apply(self.mlp, h)


class DecLayer(nn.Module):
    """``ln1``, ``attn`` (causal self-attention), ``ln2``, ``xattn``
    (cross-attention over the encoder's output), ``ln3``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        grad = master is not None
        self.ln1 = _norm(cfg, device, grad)
        self.ln2 = _norm(cfg, device, grad)
        self.ln3 = _norm(cfg, device, grad)
        self.attn = layers.Attention(cfg, device, master)
        self.xattn = layers.Attention(cfg, device, master)
        self.mlp = layers.SwiGLU(cfg.d_model, cfg.d_ff,
                                 dtype=layers.wdtype(cfg, master),
                                 device=device, requires_grad=grad)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.attn, self.xattn, self.mlp):
            m.reset_parameters(generator)

    def _cross(self, x, enc_out, positions, return_kv=False):
        h = layers.rmsnorm(x, self.ln2, self.cfg.norm_eps)
        return layers.attn_apply(self.xattn, h, self.cfg,
                                 positions=positions, causal=False,
                                 x_kv=enc_out, use_rope=False,
                                 return_kv=return_kv)

    def _mlp(self, x):
        h = layers.rmsnorm(x, self.ln3, self.cfg.norm_eps)
        return x + layers.swiglu_apply(self.mlp, h)

    def forward(self, x, enc_out, positions):
        """Training: x (B, S_dec, d_model) over enc_out (B, S_enc,
        d_model)."""
        h = layers.rmsnorm(x, self.ln1, self.cfg.norm_eps)
        x = x + layers.attn_apply(self.attn, h, self.cfg,
                                  positions=positions)
        return self._mlp(x + self._cross(x, enc_out, positions))

    def prefill(self, x, enc_out, positions):
        """-> (x, (k, v) of the self-attention, (k, v) of the cross)."""
        cfg = self.cfg
        h = layers.rmsnorm(x, self.ln1, cfg.norm_eps)
        a, kv = layers.attn_apply(self.attn, h, cfg, positions=positions,
                                  return_kv=True)
        x = x + a
        a, cross = self._cross(x, enc_out, positions, return_kv=True)
        return self._mlp(x + a), kv, cross

    def decode(self, x, ks, vs, cross, layer: int, index: int):
        """One token against the stacked self cache (written at (layer,
        index)) and this layer's cross K/V."""
        cfg = self.cfg
        h = layers.rmsnorm(x, self.ln1, cfg.norm_eps)
        a, _, _ = layers.attn_decode_stacked(self.attn, h, cfg, ks, vs,
                                             layer, index)
        x = x + a
        h = layers.rmsnorm(x, self.ln2, cfg.norm_eps)
        a, _ = layers.attn_decode(self.xattn, h, cfg, None, cross_kv=cross)
        return self._mlp(x + a)


class EncDec(nn.Module):
    """The encoder–decoder LM: ``enc_layers``, ``dec_layers``,
    ``enc_norm``, ``final_norm``, ``frame_proj`` (d_model, d_frontend),
    ``embed`` and ``lm_head`` (None when tied); parameters uninitialized
    until :func:`init` or ``convert.from_reference`` fills them.
    ``master`` as in ``transformer.Transformer``."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDec serves the encdec family, "
                             f"not {cfg.family}")
        if cfg.qk_norm:     # the JAX package caches cross K/V before it
            raise NotImplementedError(f"{cfg.name}: qk_norm in the encdec "
                                      f"family")
        self.cfg = cfg
        dt = layers.wdtype(cfg, master)
        new = functools.partial(layers.param, device=device,
                                requires_grad=master is not None)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device, master)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device, master)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = new((cfg.d_model,), torch.float32, fill=1.0)
        self.final_norm = new((cfg.d_model,), torch.float32, fill=1.0)
        self.frame_proj = new((cfg.d_model, cfg.d_frontend), dt)
        self.embed = new((cfg.vocab, cfg.d_model), dt)
        self.lm_head = (None if cfg.tie_embeddings else
                        new((cfg.vocab, cfg.d_model), dt))


def init(generator: torch.Generator, cfg: ModelConfig,
         master: Optional[torch.dtype] = None) -> EncDec:
    """Random weights from ``generator``, on its device; trainable float32
    masters when ``master`` is ``torch.float32``."""
    model = EncDec(cfg, device=generator.device, master=master)
    with torch.no_grad():
        for lyr in (*model.enc_layers, *model.dec_layers):
            lyr.reset_parameters(generator)
        layers.dense_init_(model.frame_proj, generator)
        for name, t in layers.embed_init(generator, cfg).items():
            getattr(model, name).copy_(t)
    return model


def encode(params: EncDec, frame_embeds, cfg: ModelConfig, *,
           remat: str = "none"):
    """frame_embeds (B, S_enc, d_frontend), the stub's features -> the
    encoder's output (B, S_enc, d_model), after ``enc_norm``."""
    layer = layers.remat(EncLayer.forward, remat)
    dt = layers.cdtype(cfg)
    x = F.linear(frame_embeds.to(dt), params.frame_proj.to(dt))
    positions = torch.arange(x.shape[1], device=x.device)
    for lyr in params.enc_layers:
        x = layer(lyr, x, positions)
    return layers.rmsnorm(x, params.enc_norm, cfg.norm_eps)


def decode_train(params: EncDec, tokens, enc_out, cfg: ModelConfig, *,
                 remat: str = "none"):
    """The decoder over the whole of ``tokens`` (B, S_dec) -> hidden states
    (B, S_dec, d_model), after ``final_norm``."""
    layer = layers.remat(DecLayer.forward, remat)
    x = layers.embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for lyr in params.dec_layers:
        x = layer(lyr, x, enc_out, positions)
    return layers.rmsnorm(x, params.final_norm, cfg.norm_eps)


def loss_fn(params: EncDec, batch, cfg: ModelConfig, *, remat: str = "none"):
    """The chunked LM loss, a float32 scalar.  ``batch``: ``frame_embeds``
    (B, S_enc, d_frontend), ``tokens`` and ``labels`` (B, S_dec)."""
    enc_out = encode(params, batch["frame_embeds"], cfg, remat=remat)
    x = decode_train(params, batch["tokens"], enc_out, cfg, remat=remat)
    return layers.chunked_lm_loss(params, x, batch["labels"], cfg)


def prefill(params: EncDec, batch, cfg: ModelConfig, *, max_len: int):
    """Encode ``batch["frame_embeds"]`` and run the prompt
    ``batch["tokens"]`` (B, S).  Returns the last token's logits (B, 1,
    V), the stacked self cache of ``max_len`` positions filled to S, and
    the cross K/V ``(cks, cvs)``, each (L, B, Hkv, S_enc, hd)."""
    enc_out = encode(params, batch["frame_embeds"], cfg)
    x = layers.embed_tokens(params, batch["tokens"], cfg)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    positions = torch.arange(s, device=x.device)
    nl, se = len(params.dec_layers), enc_out.shape[1]
    cache = layers.make_cache(cfg, b, max_len, n_layers=nl, device=x.device)
    shape = (nl, b, cfg.n_kv_heads, se, cfg.hd)
    cks = torch.empty(shape, dtype=x.dtype, device=x.device)
    cvs = torch.empty(shape, dtype=x.dtype, device=x.device)
    for i, lyr in enumerate(params.dec_layers):
        x, (k, v), (ck, cv) = lyr.prefill(x, enc_out, positions)
        cache.k[i, :, :, :s] = k
        cache.v[i, :, :, :s] = v
        cks[i], cvs[i] = ck, cv
    x = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = layers.lm_logits(params, x[:, -1:], cfg)
    return logits, KVCache(k=cache.k, v=cache.v, index=s), (cks, cvs)


def decode_step(params: EncDec, cache: KVCache, cross_kv, tokens,
                cfg: ModelConfig):
    """tokens (B, 1).  Returns (logits (B, 1, V), the self cache one token
    on); the cross K/V are read only.  The cache is written in place, as
    in ``transformer.decode_step``."""
    x = layers.embed_tokens(params, tokens, cfg)
    cks, cvs = cross_kv
    for i, lyr in enumerate(params.dec_layers):
        x = lyr.decode(x, cache.k, cache.v, (cks[i], cvs[i]), i, cache.index)
    x = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = layers.lm_logits(params, x, cfg)
    return logits, KVCache(k=cache.k, v=cache.v, index=cache.index + 1)
