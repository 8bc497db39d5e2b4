"""Load the JAX package's parameters into the port's modules.

The JAX package keeps a model's parameters as a dict pytree: float32
masters, matrices in ``x @ W`` layout (in, out), and every per-layer leaf
stacked on a leading layer axis (Jamba: a superblock axis, and a second
axis over the Mamba mixers, MoE layers and dense MLPs of a superblock).
The port's modules hold ``F.linear`` matrices (out, in), in the compute
type or float32 as each module says, one module per layer.  The expert
stacks of an MoE layer keep the JAX package's (E, in, out) layout, which
the grouped product takes.  :func:`from_reference` is the one place
that maps the one layout onto the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.models import jamba, rwkv6, transformer
from repro_torch.models.config import ModelConfig

# Leaves kept as (in, out) matrices by the JAX package and as (out, in)
# here, by leaf name.
TRANSPOSED = frozenset({
    "lm_head",
    "wq", "wk", "wv", "wo", "wi", "wg", "wd",            # attention, SwiGLU
    "router", "shared_gate",                             # MoE
    "in_proj", "x_proj", "dt_proj", "out_proj",          # Mamba (and RWKV6)
    "r_proj", "k_proj", "v_proj", "g_proj", "ck_proj", "cv_proj", "cr_proj",
    "w_lora_a", "w_lora_b",                              # RWKV6
})
# family -> (model class, the name of the stacked per-layer subtree)
MODELS = {
    "dense": (transformer.Transformer, "layers"),
    "moe": (transformer.Transformer, "layers"),
    "ssm": (rwkv6.RWKV6, "layers"),
    "hybrid": (jamba.Jamba, "blocks"),
}
# Subtrees of a Jamba superblock stacked on a second axis: one slice per
# module of the superblock's ModuleList of that name.
SUBSTACKED = ("mamba", "moe", "ff")


def _leaves(tree, prefix: str = ""):
    """(dotted key, numpy leaf) of a nested dict pytree."""
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, f"{prefix}{name}.")
        else:
            yield prefix + name, np.asarray(sub)


def _port(key: str, leaf: np.ndarray) -> np.ndarray:
    return leaf.T if key.rsplit(".", 1)[-1] in TRANSPOSED else leaf


def from_reference(params, cfg: ModelConfig, *, device=None):
    """The port's model of ``cfg`` (a :class:`~repro_torch.models.
    transformer.Transformer` for the dense and moe families, an
    :class:`~repro_torch.models.rwkv6.RWKV6` for ssm, a
    :class:`~repro_torch.models.jamba.Jamba` for hybrid) holding ``params``
    (the JAX pytree, leaves as numpy arrays or anything ``np.asarray``
    takes), on the card unless ``device`` names another.  Raises if a
    parameter is missing, left over or of another shape."""
    if cfg.family not in MODELS:
        raise NotImplementedError(f"{cfg.name}: no port of the {cfg.family} "
                                  f"family to load into")
    cls, stack = MODELS[cfg.family]
    model = cls(cfg, device=runtime.resolve_device(device))
    state = {}
    for key, leaf in _leaves(params):
        top, _, rest = key.partition(".")
        if top != stack:
            state[key] = _port(key, leaf)
            continue
        sub, _, name = rest.partition(".")
        for i in range(leaf.shape[0]):
            if cfg.family == "hybrid" and sub in SUBSTACKED:
                for j in range(leaf.shape[1]):
                    state[f"{stack}.{i}.{sub}.{j}.{name}"] = _port(
                        key, leaf[i, j])
            else:
                state[f"{stack}.{i}.{rest}"] = _port(key, leaf[i])
    return _load(model, state)


def _load(model, state: dict):
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in state.items()}, strict=True)
    return model
