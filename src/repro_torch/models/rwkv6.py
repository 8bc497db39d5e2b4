"""RWKV6 "Finch" (attention-free, data-dependent decay), arXiv:2404.05892:
``init``, ``forward``, ``prefill``, ``decode_step`` and ``init_state``, in
the names of the JAX package's ``models/rwkv6.py``.

Each layer is a :class:`Layer` module and the layer loop a Python loop
(the JAX package scans over stacked layer parameters).  A layer is a
time-mix (token-shift lerps, r/k/v/g projections, the LoRA-modulated decay
w_t, the WKV6 recurrence, a layer norm over the whole width) and a
channel-mix (token shift, squared ReLU).  The WKV recurrence goes through
``kernels/rwkv6/ops``: on the card the forward, stateless or not, runs the
kernel K9; a decode step runs ``wkv6_step``, plain tensor code.

The rounding is the JAX package's: the decay is made in float32 and cast
to the compute type, u is cast to the compute type before the recurrence,
a decode step's WKV output is cast back to the compute type, the WKV state
stays float32 and the shift states are in the compute type.  Matrices are
kept in ``F.linear``'s (out, in) layout and in the compute type; the LoRA
matrices of the decay, every vector and the norms' gains stay float32, as
the JAX package reads its float32 masters there.  A model made with
``master=torch.float32`` trains: float32 masters that require grad, each
matrix cast to the compute type at its use (``layers._cast``); the
recurrence then runs through ``wkv_ops.WKV6`` (K9 forward, an explicit
backward), and ``forward(remat=)`` checkpoints each layer as the JAX
package's ``jax.checkpoint`` of its scan body does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import runtime
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

LORA_DIM = 64
MATRICES = ("r_proj", "k_proj", "v_proj", "g_proj", "out_proj", "ck_proj",
            "cv_proj", "cr_proj")


class Layer(nn.Module):
    """One layer's parameters, named as the JAX package's ``_layer_init``
    names them: the projections (out, in) in the compute type (or the
    ``master`` type, trainable), ``w_lora_a`` (64, d) and ``w_lora_b``
    (d, 64) float32, ``u`` (n_heads, head_dim) and every other vector
    float32."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        dt, f32 = layers.wdtype(cfg, master), torch.float32
        new = functools.partial(layers.param, device=device,
                                requires_grad=master is not None)
        for name in ("ln1", "ln2", "gn"):
            setattr(self, name, new((d,), f32, fill=1.0))
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cmu_r",
                     "cmu_k"):
            setattr(self, name, new((d,), f32, fill=0.5))
        self.w0 = new((d,), f32, fill=-6.0)
        self.gn_b = new((d,), f32, fill=0.0)
        for name in ("r_proj", "k_proj", "v_proj", "g_proj", "out_proj",
                     "cr_proj"):
            setattr(self, name, new((d, d), dt))
        self.ck_proj = new((cfg.d_ff, d), dt)
        self.cv_proj = new((d, cfg.d_ff), dt)
        self.w_lora_a = new((LORA_DIM, d), f32)
        self.w_lora_b = new((d, LORA_DIM), f32)
        self.u = new((d // hd, hd), f32)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random matrices, ``w_lora_b`` N(0, 0.01²) and ``u`` N(0, 0.1²),
        as the JAX package draws them; the vectors keep their constants."""
        for name in MATRICES + ("w_lora_a",):
            layers.dense_init_(getattr(self, name), generator)
        for name, scale in (("w_lora_b", 0.01), ("u", 0.1)):
            t = getattr(self, name)
            t.copy_(torch.randn(t.shape, generator=generator,
                                device=t.device) * scale)


class RWKV6(nn.Module):
    """The LM: ``embed``, ``lm_head`` (None when tied), ``layers`` and
    ``final_norm``; parameters uninitialized until :func:`init` or
    ``convert.from_reference`` fills them.  ``master`` None serves; a
    dtype (float32) trains, as ``transformer.Transformer`` does."""

    def __init__(self, cfg: ModelConfig, device=None,
                 master: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: not an RWKV6 (ssm) config")
        self.cfg = cfg
        dt = layers.wdtype(cfg, master)
        new = functools.partial(layers.param, device=device,
                                requires_grad=master is not None)
        self.embed = new((cfg.vocab, cfg.d_model), dt)
        self.lm_head = (None if cfg.tie_embeddings else
                        new((cfg.vocab, cfg.d_model), dt))
        self.final_norm = new((cfg.d_model,), torch.float32, fill=1.0)
        self.layers = nn.ModuleList(Layer(cfg, device, master)
                                    for _ in range(cfg.n_layers))


@dataclasses.dataclass
class RWKVState:
    """Per-layer decode state, stacked over layers and written in place:
    ``tm`` and ``cm`` (L, B, d) the time- and channel-mix shift tokens in
    the compute type, ``wkv`` (L, B, n_heads, hd, hd) float32."""
    tm: torch.Tensor
    cm: torch.Tensor
    wkv: torch.Tensor


def init(generator: torch.Generator, cfg: ModelConfig,
         master: Optional[torch.dtype] = None) -> RWKV6:
    """Random weights from ``generator``, on its device; trainable float32
    masters when ``master`` is ``torch.float32``."""
    model = RWKV6(cfg, device=generator.device, master=master)
    with torch.no_grad():
        for layer in model.layers:
            layer.reset_parameters(generator)
        for name, t in layers.embed_init(generator, cfg).items():
            getattr(model, name).copy_(t)
    return model


def init_state(cfg: ModelConfig, batch: int, *, device=None) -> RWKVState:
    """Zero state for ``batch`` sequences, on the card unless ``device``
    names another."""
    nl, d, hd = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
    dev = runtime.resolve_device(device)
    dt = layers.cdtype(cfg)
    return RWKVState(
        tm=torch.zeros((nl, batch, d), dtype=dt, device=dev),
        cm=torch.zeros((nl, batch, d), dtype=dt, device=dev),
        wkv=torch.zeros((nl, batch, d // hd, hd, hd), dtype=torch.float32,
                        device=dev))


def _shift(x, prev):
    """Token shift: the previous token at each position, ``prev`` (B, D)
    before the first."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _decay(lp: Layer, xw, dt):
    """The per-channel decay w in (0, 1), made in float32, in type ``dt``."""
    w = lp.w0 + F.linear(torch.tanh(F.linear(xw.float(), lp.w_lora_a)),
                         lp.w_lora_b)
    return torch.exp(-torch.exp(w)).to(dt)


def _time_mix(lp: Layer, x, cfg: ModelConfig, prev_tok, wkv_state):
    """x (B, T, D).  Returns (out, new prev token (B, D), new WKV state
    (B, H, hd, hd) float32, or None when ``wkv_state`` is None)."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd
    dt = x.dtype
    xs = _shift(x, prev_tok)

    def mix(mu):
        return x + (xs - x) * mu.to(dt)

    r = F.linear(mix(lp.mu_r), layers._cast(lp.r_proj, x))
    k = F.linear(mix(lp.mu_k), layers._cast(lp.k_proj, x))
    v = F.linear(mix(lp.mu_v), layers._cast(lp.v_proj, x))
    g = F.silu(F.linear(mix(lp.mu_g), layers._cast(lp.g_proj, x)))
    w = _decay(lp, mix(lp.mu_w), dt)

    def heads(z):
        return z.reshape(b, t, nh, hd).transpose(1, 2).reshape(b * nh, t, hd)

    u = lp.u.to(dt).expand(b, nh, hd).reshape(b * nh, hd)
    if t == 1 and wkv_state is not None:
        s = wkv_state.reshape(b * nh, hd, hd)
        s, o = wkv_ops.wkv6_step(s, heads(r)[:, 0], heads(k)[:, 0],
                                 heads(v)[:, 0], heads(w)[:, 0], u)
        o = o[:, None].to(dt)          # keep the residual stream's type
        new_state = s.float().reshape(b, nh, hd, hd)
    elif wkv_state is not None:        # prefill: the final state goes out
        o, s = wkv_ops.wkv6(heads(r), heads(k), heads(v), heads(w), u,
                            return_state=True)
        new_state = s.reshape(b, nh, hd, hd)
    else:
        o = wkv_ops.wkv6(heads(r), heads(k), heads(v), heads(w), u)
        new_state = None
    o = o.reshape(b, nh, t, hd).transpose(1, 2).reshape(b, t, d)
    o = layers.layernorm(o, lp.gn, lp.gn_b, cfg.norm_eps)
    return F.linear(o * g, layers._cast(lp.out_proj, x)), x[:, -1], new_state


def _channel_mix(lp: Layer, x, prev_tok, dt):
    """x (B, T, D).  Returns (out, new prev token (B, D))."""
    xs = _shift(x, prev_tok)
    xr = x + (xs - x) * lp.cmu_r.to(dt)
    xk = x + (xs - x) * lp.cmu_k.to(dt)
    kk = torch.square(torch.relu(F.linear(xk, layers._cast(lp.ck_proj, x))))
    out = torch.sigmoid(F.linear(xr, layers._cast(lp.cr_proj, x))) * \
        F.linear(kk, layers._cast(lp.cv_proj, x))
    return out, x[:, -1]


def _train_layer(lp: Layer, x, cfg: ModelConfig):
    """One layer of the stateless forward: x (B, T, d) -> x."""
    zeros_tok = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                            device=x.device)
    h = layers.rmsnorm(x, lp.ln1, cfg.norm_eps)
    x = x + _time_mix(lp, h, cfg, zeros_tok, None)[0]
    h = layers.rmsnorm(x, lp.ln2, cfg.norm_eps)
    return x + _channel_mix(lp, h, zeros_tok, x.dtype)[0]


def forward(params: RWKV6, tokens, cfg: ModelConfig, *, remat: str = "none",
            return_state: bool = False):
    """The final-normed hidden states (B, T, d) of tokens (B, T) and, with
    ``return_state``, the :class:`RWKVState` after the last token.  The
    stateless forward (training) checkpoints each layer under ``remat``
    (``layers.REMAT_POLICIES``); the stateful one (prefill) takes none."""
    x = layers.embed_tokens(params, tokens, cfg)
    if not return_state:
        layer = layers.remat(_train_layer, remat)
        for lp in params.layers:
            x = layer(lp, x, cfg)
        return layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    b, t, d = x.shape
    zeros_tok = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    state = init_state(cfg, b, device=x.device)
    for i, lp in enumerate(params.layers):
        h = layers.rmsnorm(x, lp.ln1, cfg.norm_eps)
        o, state.tm[i], state.wkv[i] = _time_mix(lp, h, cfg, zeros_tok,
                                                 state.wkv[i])
        x = x + o
        h = layers.rmsnorm(x, lp.ln2, cfg.norm_eps)
        o, state.cm[i] = _channel_mix(lp, h, zeros_tok, x.dtype)
        x = x + o
    return layers.rmsnorm(x, params.final_norm, cfg.norm_eps), state


def loss_fn(params: RWKV6, batch, cfg: ModelConfig, *, remat: str = "none"):
    """The chunked LM loss, a float32 scalar.  ``batch``: ``tokens`` and
    ``labels`` (B, T) int, labels -100 ignored."""
    x = forward(params, batch["tokens"], cfg, remat=remat)
    return layers.chunked_lm_loss(params, x, batch["labels"], cfg)


def prefill(params: RWKV6, tokens, cfg: ModelConfig, **_):
    """Run the prompt (B, T) once; return the last token's logits (B, 1, V)
    and the state after it.  A ``max_len`` is accepted and ignored: the state
    is O(1) in the sequence."""
    x, state = forward(params, tokens, cfg, return_state=True)
    return layers.lm_logits(params, x[:, -1:], cfg), state


def decode_step(params: RWKV6, state: RWKVState, tokens, cfg: ModelConfig):
    """tokens (B, 1).  Returns (logits (B, 1, V), the state one token on).

    The returned state is ``state``: its tensors are written in place, so
    the state passed in is the new one afterwards."""
    x = layers.embed_tokens(params, tokens, cfg)
    for i, lp in enumerate(params.layers):
        h = layers.rmsnorm(x, lp.ln1, cfg.norm_eps)
        o, tm, wkv = _time_mix(lp, h, cfg, state.tm[i], state.wkv[i])
        x = x + o
        h = layers.rmsnorm(x, lp.ln2, cfg.norm_eps)
        o, cm = _channel_mix(lp, h, state.cm[i], x.dtype)
        x = x + o
        state.tm[i] = tm
        state.cm[i] = cm
        state.wkv[i] = wkv
    x = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return layers.lm_logits(params, x, cfg), state
