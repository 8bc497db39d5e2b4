"""Serving steps: prefill (prompt -> cache) and decode (one token a step)
for the ported families."""
from __future__ import annotations

import torch

from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig

SAMPLERS = ("greedy", "categorical")


def make_prefill_step(cfg: ModelConfig, *, max_len: int):
    """Returns ``prefill_step(params, batch) -> (logits, state)``: exactly a
    2-tuple for every family, as the JAX package's.  encdec's prefill
    returns ``(logits, cache, cross)``, given here as ``(logits, (cache,
    cross))``, the state :func:`make_decode_step` unpacks; it reads
    ``batch["frame_embeds"]``.  The vlm family's prefill puts
    ``batch["patch_embeds"]`` before the tokens, so its cache holds
    ``max_len + cfg.n_frontend_tokens`` positions.  The ssm family's
    prefill accepts ``max_len`` and ignores it: its state does not grow
    with the sequence."""
    model = get_model(cfg)

    def prefill_step(params, batch):
        if cfg.family == "encdec":
            logits, cache, cross = model.prefill(params, batch, cfg,
                                                 max_len=max_len)
            return logits, (cache, cross)
        if cfg.family == "vlm":
            return model.prefill(params, batch["tokens"], cfg,
                                 max_len=max_len + cfg.n_frontend_tokens,
                                 prefix_embeds=batch["patch_embeds"])
        return model.prefill(params, batch["tokens"], cfg, max_len=max_len)

    return prefill_step


def pick(logits, *, sample: str = "greedy", temperature: float = 1.0,
         generator=None):
    """Next tokens (B,) int32 from the last position of logits (B, S, V).
    ``"greedy"`` takes the argmax; ``"categorical"`` samples
    softmax(logits / temperature) by the Gumbel-max trick, with uniform
    noise from ``generator`` (on the logits' device), so no pick waits for
    the device."""
    lf = logits[:, -1].float()
    if sample == "greedy":
        return lf.argmax(dim=-1).to(torch.int32)
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    gumbel = -torch.log(-torch.log(u))
    return (lf / temperature + gumbel).argmax(dim=-1).to(torch.int32)


def make_decode_step(cfg: ModelConfig, *, sample: str = "greedy",
                     temperature: float = 1.0):
    """Returns ``decode_step(params, state, tokens, generator=None) ->
    (next_tokens (B, 1) int32, state, logits)``; ``sample`` as in
    :func:`pick`."""
    if sample not in SAMPLERS:
        raise ValueError(f"unknown sampler {sample!r}; options: {SAMPLERS}")
    model = get_model(cfg)

    def decode_step(params, state, tokens, generator=None):
        if cfg.family == "encdec":
            cache, cross = state
            logits, cache = model.decode_step(params, cache, cross, tokens,
                                              cfg)
            new_state = (cache, cross)
        else:
            logits, new_state = model.decode_step(params, state, tokens, cfg)
        nxt = pick(logits, sample=sample, temperature=temperature,
                   generator=generator)
        return nxt[:, None], new_state, logits

    return decode_step


def decode_input_specs(cfg: ModelConfig, batch: int, cache_len: int):
    """One decode step's (state, tokens) as ``meta`` tensors, the dry run's
    inputs: the family's decode state of ``cache_len`` positions, its
    caches standing at ``cache_len - 1`` (the step decodes the last slot,
    as the JAX package's specs assume), and tokens (B, 1) int32."""
    state = get_model(cfg).make_decode_state(cfg, batch, cache_len,
                                             device="meta")
    cache = state[0] if cfg.family == "encdec" else state
    if hasattr(cache, "index"):
        cache.index = cache_len - 1
    return state, torch.empty((batch, 1), dtype=torch.int32, device="meta")
