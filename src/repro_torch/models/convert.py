"""Load the JAX package's parameters into the port's modules.

The JAX package keeps a model's parameters as a dict pytree: float32
masters, matrices in ``x @ W`` layout (in, out), and every per-layer leaf
stacked on a leading layer axis.  The port's modules hold ``F.linear``
matrices (out, in) in the compute type.  :func:`from_reference` is the one
place that maps the one layout onto the other, for the dense family and
for RWKV6.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.models import rwkv6, transformer
from repro_torch.models.config import ModelConfig

MATRICES = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("wi", "wg", "wd")}
VECTORS = {"attn": ("bq", "bk", "bv", "qn", "kn")}


def from_reference(params, cfg: ModelConfig, *, device=None):
    """The port's model of ``cfg`` (a :class:`~repro_torch.models.
    transformer.Transformer`, or an :class:`~repro_torch.models.rwkv6.RWKV6`
    for the ssm family) holding ``params`` (the JAX pytree, leaves as numpy
    arrays or anything ``np.asarray`` takes), on the card unless ``device``
    names another.  Raises if a parameter is missing, left over or of
    another shape."""
    dev = runtime.resolve_device(device)
    state = {"embed": params["embed"], "final_norm": params["final_norm"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = np.asarray(params["lm_head"]).T
    stack = params["layers"]
    if cfg.family == "ssm":
        model = rwkv6.RWKV6(cfg, device=dev)
        matrices = rwkv6.MATRICES + ("w_lora_a", "w_lora_b")
        for name, leaf in stack.items():
            leaf = np.asarray(leaf)
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{name}"] = (leaf[i].T if name in matrices
                                               else leaf[i])
        return _load(model, state)
    model = transformer.Transformer(cfg, device=dev)
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        state[pre + "ln1"] = np.asarray(stack["ln1"])[i]
        state[pre + "ln2"] = np.asarray(stack["ln2"])[i]
        for block, names in MATRICES.items():
            for name in names:
                state[f"{pre}{block}.{name}"] = np.asarray(
                    stack[block][name])[i].T
        for block, names in VECTORS.items():
            for name in names:
                if name in stack[block]:
                    state[f"{pre}{block}.{name}"] = np.asarray(
                        stack[block][name])[i]
    return _load(model, state)


def _load(model, state: dict):
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in state.items()}, strict=True)
    return model
