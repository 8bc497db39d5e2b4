"""Jamba v0.1 hybrid: Mamba and attention 7:1, MoE (16 experts, top 2) at
every other sublayer (arXiv:2403.19887): ``init``, ``init_state``,
``forward``, ``loss_fn``, ``prefill`` and ``decode_step``, in the names of
the JAX package's ``models/jamba.py``.

Sublayer l of a superblock of 8: the mixer is attention iff l == 4, else
Mamba; the MLP is MoE iff l is odd, else a dense SwiGLU, exactly the
published block pattern.  The JAX package scans over stacked superblocks;
here each is a :class:`Superblock` module in a ``ModuleList`` and the loop
is a Python loop.  Attention runs the flash-attention kernel K6 in the
prefill and the decode-attention kernel K7 in each decode step, as the
dense family does; each Mamba mixer runs the selective-scan kernel K8 in
the prefill (``models/mamba.py``).  A model made with
``master=torch.float32`` trains, as ``transformer.Transformer`` does: the
training pass of a superblock (:meth:`Superblock.train_forward`) runs K8
through ``SelectiveScan`` and K6 through ``Attention``, the autograd
Functions with explicit backwards, and ``forward(remat=)`` checkpoints
whole superblocks, as the JAX package's ``jax.checkpoint`` of its scan
body does (its ``sub_remat=False``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers, mamba, moe
from repro_torch.models.config import ModelConfig

SUPER = 8                 # sublayers per superblock
ATTN_POS = 4              # attention at index 4 within each superblock
MOE_POS = (1, 3, 5, 7)    # MoE at odd indices
FF_POS = (0, 2, 4, 6)
N_MAMBA = SUPER - 1


class Superblock(nn.Module):
    """Eight sublayers' parameters, named as the JAX package's
    ``_superblock_init`` names them: ``mamba`` (7 mixers), ``attn``,
    ``moe`` (4), ``ff`` (4 SwiGLU of width ``d_ff``), and the norms' gains
    ``ln_mix`` and ``ln_mlp`` (8, d) float32; trainable float32 masters
    when ``master`` is given."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        grad = master is not None
        self.mamba = nn.ModuleList(mamba.Mamba(cfg, device, master)
                                   for _ in range(N_MAMBA))
        self.attn = layers.Attention(cfg, device, master)
        self.moe = nn.ModuleList(moe.MoE(cfg, device, master)
                                 for _ in range(len(MOE_POS)))
        self.ff = nn.ModuleList(layers.SwiGLU(
            cfg.d_model, cfg.d_ff, dtype=layers.wdtype(cfg, master),
            device=device, requires_grad=grad) for _ in range(len(FF_POS)))
        self.ln_mix = layers.param((SUPER, cfg.d_model), torch.float32,
                                   device, 1.0, requires_grad=grad)
        self.ln_mlp = layers.param((SUPER, cfg.d_model), torch.float32,
                                   device, 1.0, requires_grad=grad)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (*self.mamba, self.attn, *self.moe, *self.ff):
            m.reset_parameters(generator)

    def _mlp(self, idx: int, x):
        """The MLP half of sublayer ``idx`` with its residual: (x + y, the
        router's aux loss, float32, or None for a dense MLP)."""
        cfg = self.cfg
        h = layers.rmsnorm(x, self.ln_mlp[idx], cfg.norm_eps)
        if idx in MOE_POS:
            y, aux = moe.moe_apply(self.moe[MOE_POS.index(idx)], h, cfg)
            return x + y, aux
        return x + layers.swiglu_apply(self.ff[FF_POS.index(idx)], h), None

    def train_forward(self, x, positions):
        """Training: x (B, S, d) -> (x, the four MoE layers' summed aux
        loss), writing no state; K8 and K6 keep their gradients."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        mi = 0
        for idx in range(SUPER):
            h = layers.rmsnorm(x, self.ln_mix[idx], cfg.norm_eps)
            if idx == ATTN_POS:
                a = layers.attn_apply(self.attn, h, cfg, positions=positions)
            else:
                a = mamba.mamba_apply(self.mamba[mi], h, cfg)
                mi += 1
            x, a = self._mlp(idx, x + a)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward(self, x, positions, state: "HybridState", bi: int):
        """Prefill of superblock ``bi``: x (B, S, d) -> x; writes its Mamba
        states and its attention K/V (positions :S) into ``state``."""
        cfg = self.cfg
        s = x.shape[1]
        mi = 0
        for idx in range(SUPER):
            h = layers.rmsnorm(x, self.ln_mix[idx], cfg.norm_eps)
            if idx == ATTN_POS:
                a, (k, v) = layers.attn_apply(self.attn, h, cfg,
                                              positions=positions,
                                              return_kv=True)
                state.k[bi, :, :, :s] = k
                state.v[bi, :, :, :s] = v
            else:
                a, (conv, ssm) = mamba.mamba_apply(self.mamba[mi], h, cfg,
                                                   return_state=True)
                state.conv[bi, mi] = conv
                state.ssm[bi, mi] = ssm
                mi += 1
            x = self._mlp(idx, x + a)[0]
        return x

    def decode(self, x, state: "HybridState", bi: int):
        """One token of superblock ``bi``: x (B, 1, d) -> x; updates its
        Mamba states and writes its K/V at ``state.index``, in place."""
        cfg = self.cfg
        mi = 0
        for idx in range(SUPER):
            h = layers.rmsnorm(x, self.ln_mix[idx], cfg.norm_eps)
            if idx == ATTN_POS:
                a, _, _ = layers.attn_decode_stacked(
                    self.attn, h, cfg, state.k, state.v, bi, state.index)
            else:
                a, (conv, ssm) = mamba.mamba_step(
                    self.mamba[mi], h, cfg, (state.conv[bi, mi],
                                             state.ssm[bi, mi]))
                state.conv[bi, mi] = conv
                state.ssm[bi, mi] = ssm
                mi += 1
            x = self._mlp(idx, x + a)[0]
        return x


class Jamba(nn.Module):
    """The LM: ``embed``, ``lm_head`` (None when tied), ``blocks`` (one
    :class:`Superblock` per 8 layers) and ``final_norm``; parameters
    uninitialized until :func:`init` or ``convert.from_reference`` fills
    them.  ``master`` None serves; a dtype (float32) trains."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: not a Jamba (hybrid) config")
        if cfg.n_layers % SUPER:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"whole superblocks of {SUPER}")
        self.cfg = cfg
        dt = layers.wdtype(cfg, master)
        new = functools.partial(layers.param, device=device,
                                requires_grad=master is not None)
        self.embed = new((cfg.vocab, cfg.d_model), dt)
        self.lm_head = (None if cfg.tie_embeddings else
                        new((cfg.vocab, cfg.d_model), dt))
        self.final_norm = new((cfg.d_model,), torch.float32, fill=1.0)
        self.blocks = nn.ModuleList(Superblock(cfg, device, master)
                                    for _ in range(cfg.n_layers // SUPER))


@dataclasses.dataclass
class HybridState:
    """Decode state in the JAX package's layout, written in place:
    ``conv`` (nb, 7, B, K-1, d_inner) in the compute type, ``ssm``
    (nb, 7, B, d_inner, N) float32, ``k``/``v`` (nb, B, Hkv, max_len, hd)
    in the compute type, and ``index``, the filled length, a host int."""
    conv: torch.Tensor
    ssm: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    index: int


def init(generator: torch.Generator, cfg: ModelConfig,
         master: Optional[torch.dtype] = None) -> Jamba:
    """Random weights from ``generator``, on its device; trainable float32
    masters when ``master`` is ``torch.float32``."""
    model = Jamba(cfg, device=generator.device, master=master)
    with torch.no_grad():
        for blk in model.blocks:
            blk.reset_parameters(generator)
        for name, t in layers.embed_init(generator, cfg).items():
            getattr(model, name).copy_(t)
    return model


def forward(params: Jamba, tokens, cfg: ModelConfig, *, remat: str = "none"):
    """The final hidden states (B, S, d), after the final norm, and the
    superblocks' summed aux loss (float32); each superblock checkpointed
    whole under ``remat`` (``layers.REMAT_POLICIES``)."""
    block = layers.remat(Superblock.train_forward, remat)
    x = layers.embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        x, a = block(blk, x, positions)
        aux = aux + a
    return layers.rmsnorm(x, params.final_norm, cfg.norm_eps), aux


def loss_fn(params: Jamba, batch, cfg: ModelConfig, *, remat: str = "none"):
    """The chunked LM loss plus the aux loss, a float32 scalar.  ``batch``:
    ``tokens`` and ``labels`` (B, S) int, labels -100 ignored."""
    x, aux = forward(params, batch["tokens"], cfg, remat=remat)
    return layers.chunked_lm_loss(params, x, batch["labels"], cfg) + aux


def init_state(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> HybridState:
    """Zero state for ``batch`` sequences of up to ``max_len`` tokens, on
    the card unless ``device`` names another."""
    nb = cfg.n_layers // SUPER
    conv, ssm = mamba.init_state(cfg, batch, device=device)
    cache = layers.make_cache(cfg, batch, max_len, n_layers=nb,
                              device=conv.device)
    return HybridState(
        conv=conv.expand((nb, N_MAMBA) + conv.shape).contiguous(),
        ssm=ssm.expand((nb, N_MAMBA) + ssm.shape).contiguous(),
        k=cache.k, v=cache.v, index=0)


def prefill(params: Jamba, tokens, cfg: ModelConfig, *, max_len: int):
    """Run the prompt (B, S); return the last token's logits (B, 1, V) and
    the state after it: the Mamba states and the K/V caches of ``max_len``
    positions filled to S.  A prompt shorter than ``d_conv - 1`` tokens
    raises (``mamba.mamba_apply``)."""
    x = layers.embed_tokens(params, tokens, cfg)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    positions = torch.arange(s, device=x.device)
    state = init_state(cfg, b, max_len, device=x.device)
    for bi, blk in enumerate(params.blocks):
        x = blk(x, positions, state, bi)
    x = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    state.index = s
    return layers.lm_logits(params, x[:, -1:], cfg), state


def decode_step(params: Jamba, state: HybridState, tokens, cfg: ModelConfig):
    """tokens (B, 1).  Returns (logits (B, 1, V), the state one token on).

    The returned state is ``state``: its tensors are written in place and
    its index advanced, so the state passed in is the new one afterwards.
    An index past the cache raises (``layers.attn_decode_stacked``)."""
    x = layers.embed_tokens(params, tokens, cfg)
    for bi, blk in enumerate(params.blocks):
        x = blk.decode(x, state, bi)
    x = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    state.index += 1
    return layers.lm_logits(params, x, cfg), state
