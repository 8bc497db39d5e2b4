"""Train step factory: loss → grads (remat, microbatch accumulation,
optional bf16 gradient compression with error feedback) → AdamW, in the
names of the JAX package's ``train/train_step.py``.

The train state is a dict: ``params``, the model (float32 masters that
require grad), ``opt``, the AdamW state (``optimizer.init``), and, with
``compress_grads``, ``grad_residual``.  A step updates the model and the
moments in place and returns the same dict.  Its metrics are device
scalars: a step reads nothing on the host unless its caller reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.collectives import compress_tree
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    remat: str = "full"          # none | full | dots | dots_no_batch
    grad_accum: int = 1          # microbatch accumulation steps
    adamw: opt.AdamWConfig = opt.AdamWConfig()


def init_train_state(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """A model of random float32 masters from ``generator`` (on its
    device) and its AdamW state."""
    model = get_model(cfg).init(generator, cfg, master=torch.float32)
    return dict(params=model, opt=opt.init(dict(model.named_parameters())))


def make_train_step(cfg: ModelConfig, hp: TrainHParams):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds ``tokens`` and ``labels`` (B, S), and the frontend embeddings of
    the encdec and vlm families (``frame_embeds``, ``patch_embeds``), all
    with the batch first, B a multiple of ``hp.grad_accum``: each
    microbatch takes its rows of every entry.  ``metrics``: ``loss``,
    ``grad_norm``, ``lr``."""
    model_api = get_model(cfg)
    adamw = hp.adamw

    def loss_and_grads(model, names, leaves, batch):
        loss = model_api.loss_fn(model, batch, cfg, remat=hp.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), dict(zip(names, grads))

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        names, leaves = list(params), list(params.values())
        if hp.grad_accum > 1:
            a = hp.grad_accum
            b = batch["tokens"].shape[0]
            if b % a:
                raise ValueError(f"batch {b} does not split into "
                                 f"{a} microbatches")
            mb = b // a
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
            for i in range(a):
                micro = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                l_i, g_i = loss_and_grads(model, names, leaves, micro)
                loss = loss + l_i
                torch._foreach_add_(list(grads.values()),
                                    [g_i[n] for n in grads])
            loss = loss / a
            torch._foreach_div_(list(grads.values()), float(a))
        else:
            loss, grads = loss_and_grads(model, names, leaves, batch)

        if adamw.compress_grads:
            grads, residual = compress_tree(grads,
                                            state.get("grad_residual"))
        _, new_opt, metrics = opt.update(grads, state["opt"], params, adamw)
        state["opt"] = new_opt
        if adamw.compress_grads:
            state["grad_residual"] = residual
        return state, dict(loss=loss, **metrics)

    return train_step


def make_eval_step(cfg: ModelConfig, hp: Optional[TrainHParams] = None):
    """Returns ``eval_step(params, batch) -> loss``, with no gradient (the
    attention runs its kernel alone)."""
    model_api = get_model(cfg)
    remat = hp.remat if hp else "none"

    @torch.no_grad()
    def eval_step(params, batch):
        return model_api.loss_fn(params, batch, cfg, remat=remat)

    return eval_step
