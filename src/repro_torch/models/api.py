"""Uniform model API: family -> (init, loss_fn, prefill, decode_step,
make_decode_state), ``train_input_specs`` (a training batch's shapes and
types as ``meta`` tensors) and ``synth_batch`` (random batches for smoke
runs).

Every family of the JAX package is ported, and all six train: dense, moe
and vlm (all three on the transformer, as in the JAX package), encdec
(``encdec.py``), ssm (RWKV6) and hybrid (Jamba).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.models import encdec, jamba, layers, rwkv6, transformer
from repro_torch.models.config import ModelConfig

# family -> what it waits for; empty, since every family is ported
# (ROADMAP queue 1, item 14, done)
WAITING: dict = {}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable                  # (generator, cfg, master=None) -> model
    loss_fn: Callable               # (model, batch, cfg, remat=) -> loss
    prefill: Callable
    decode_step: Callable
    make_decode_state: Callable     # (cfg, batch, max_len, device) -> state


def _transformer_state(cfg, batch, max_len, device=None):
    return layers.make_cache(cfg, batch, max_len, device=device)


def _rwkv_state(cfg, batch, max_len, device=None):
    return rwkv6.init_state(cfg, batch, device=device)


def _jamba_state(cfg, batch, max_len, device=None):
    return jamba.init_state(cfg, batch, max_len, device=device)


def _encdec_state(cfg, batch, max_len, device=None):
    """(the stacked self cache, the cross K/V): zeros, the cross length
    equal to ``max_len`` as in the JAX package."""
    cache = layers.make_cache(cfg, batch, max_len, device=device)
    return cache, (torch.zeros_like(cache.k), torch.zeros_like(cache.v))


def get_model(cfg: ModelConfig) -> ModelApi:
    fam = cfg.family
    if fam in transformer.FAMILIES:
        return ModelApi(transformer.init, transformer.loss_fn,
                        transformer.prefill, transformer.decode_step,
                        _transformer_state)
    if fam == "ssm":
        return ModelApi(rwkv6.init, rwkv6.loss_fn, rwkv6.prefill,
                        rwkv6.decode_step, _rwkv_state)
    if fam == "hybrid":
        return ModelApi(jamba.init, jamba.loss_fn, jamba.prefill,
                        jamba.decode_step, _jamba_state)
    if fam == "encdec":
        return ModelApi(encdec.init, encdec.loss_fn, encdec.prefill,
                        encdec.decode_step, _encdec_state)
    if fam in WAITING:
        raise NotImplementedError(
            f"{cfg.name}: the {fam} family is not ported yet (ROADMAP queue "
            f"1, {WAITING[fam]})")
    raise ValueError(fam)


def train_input_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """One training batch's tensors as ``meta`` tensors (shapes and types,
    nothing allocated): ``tokens`` and ``labels`` (B, S) int32, and the
    frontend embeddings of the encoder–decoder and VLM families."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = dict(tokens=spec((batch, seq), torch.int32),
                 labels=spec((batch, seq), torch.int32))
    if cfg.family == "encdec":
        specs["frame_embeds"] = spec((batch, seq, cfg.d_frontend),
                                     layers.cdtype(cfg))
    if cfg.family == "vlm":
        specs["patch_embeds"] = spec(
            (batch, cfg.n_frontend_tokens, cfg.d_frontend),
            layers.cdtype(cfg))
    return specs


def synth_batch(rng_seed: int, cfg: ModelConfig, batch: int, seq: int, *,
                device=None) -> dict:
    """Random ``tokens`` (B, S) int32 and their next-token ``labels``, and
    the stub frontends' embeddings in the compute type: ``frame_embeds``
    (B, S, d_frontend) for encdec, ``patch_embeds`` (B, n_frontend_tokens,
    d_frontend) for vlm, N(0, 0.1²).  Drawn with numpy in the JAX package's
    order and rounded to float32 before the compute type, as its
    ``jnp.asarray`` does without x64, so both packages see the same arrays
    for one seed.  On the card unless ``device`` names another."""
    dev = runtime.resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    out: dict[str, Any] = dict(
        tokens=torch.from_numpy(tokens).to(dev),
        labels=torch.from_numpy(np.roll(tokens, -1, axis=1)).to(dev))

    def embeds(shape):
        x = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        return torch.from_numpy(x).to(dev, layers.cdtype(cfg))

    if cfg.family == "encdec":
        out["frame_embeds"] = embeds((batch, seq, cfg.d_frontend))
    if cfg.family == "vlm":
        out["patch_embeds"] = embeds((batch, cfg.n_frontend_tokens,
                                      cfg.d_frontend))
    return out
