"""Load the JAX package's parameters into the port's modules.

The JAX package keeps a model's parameters as a dict pytree: float32
masters, matrices in ``x @ W`` layout (in, out), and every per-layer leaf
stacked on a leading layer axis (Jamba: a superblock axis, and a second
axis over the Mamba mixers, MoE layers and dense MLPs of a superblock; the
encoder–decoder: two stacks, ``enc_layers`` and ``dec_layers``).
The port's modules hold ``F.linear`` matrices (out, in), in the compute
type or float32 as each module says, one module per layer.  The expert
stacks of an MoE layer keep the JAX package's (E, in, out) layout, which
the grouped product takes.  :func:`from_reference` is the one place
that maps the one layout onto the other, and :func:`to_reference` its
inverse, for any name→tensor mapping of the port's parameter names
(parameters, gradients, optimizer moments).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.models import encdec, jamba, rwkv6, transformer
from repro_torch.models.config import ModelConfig

# Leaves kept as (in, out) matrices by the JAX package and as (out, in)
# here, by leaf name.
TRANSPOSED = frozenset({
    "lm_head", "frame_proj", "patch_proj",               # heads, frontends
    "wq", "wk", "wv", "wo", "wi", "wg", "wd",            # attention, SwiGLU
    "router", "shared_gate",                             # MoE
    "in_proj", "x_proj", "dt_proj", "out_proj",          # Mamba (and RWKV6)
    "r_proj", "k_proj", "v_proj", "g_proj", "ck_proj", "cv_proj", "cr_proj",
    "w_lora_a", "w_lora_b",                              # RWKV6
})
# family -> (model class, the names of the stacked per-layer subtrees)
MODELS = {
    "dense": (transformer.Transformer, ("layers",)),
    "moe": (transformer.Transformer, ("layers",)),
    "vlm": (transformer.Transformer, ("layers",)),
    "ssm": (rwkv6.RWKV6, ("layers",)),
    "hybrid": (jamba.Jamba, ("blocks",)),
    "encdec": (encdec.EncDec, ("enc_layers", "dec_layers")),
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


def from_reference(params, cfg: ModelConfig, *, device=None,
                   train: bool = False):
    """The port's model of ``cfg`` (a :class:`~repro_torch.models.
    transformer.Transformer` for the dense, moe and vlm families, an
    :class:`~repro_torch.models.rwkv6.RWKV6` for ssm, a
    :class:`~repro_torch.models.jamba.Jamba` for hybrid, an
    :class:`~repro_torch.models.encdec.EncDec` for encdec) holding ``params``
    (the JAX pytree, leaves as numpy arrays or anything ``np.asarray``
    takes), on the card unless ``device`` names another.  ``train`` loads
    them as float32 masters that require grad.  Raises if a parameter is
    missing, left over or of another shape."""
    if cfg.family not in MODELS:
        raise NotImplementedError(f"{cfg.name}: no port of the {cfg.family} "
                                  f"family to load into")
    cls, stacks = MODELS[cfg.family]
    kw = dict(master=torch.float32) if train else {}
    model = cls(cfg, device=runtime.resolve_device(device), **kw)
    state = {}
    for key, leaf in _leaves(params):
        top, _, rest = key.partition(".")
        if top not in stacks:
            state[key] = _port(key, leaf)
            continue
        stack = top
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


def to_reference(tensors, cfg: ModelConfig) -> dict:
    """The JAX pytree layout of ``tensors``, a mapping from the port's
    parameter names (``named_parameters`` or ``state_dict``) to tensors of
    those shapes: nested dicts of float32 numpy arrays, matrices back in
    (in, out), per-layer leaves stacked on the layer axis (and Jamba's
    substacks on their second axis).  The inverse of
    :func:`from_reference`'s mapping."""
    _, stacks = MODELS[cfg.family]
    stacked: dict = {}                   # reference key -> {index: leaf}
    out: dict = {}
    for name, t in tensors.items():
        leaf = _port(name, t.detach().float().cpu().numpy())
        top, _, rest = name.partition(".")
        if top not in stacks:
            out[name] = leaf
            continue
        stack = top
        i, _, rest = rest.partition(".")
        sub, _, tail = rest.partition(".")
        if cfg.family == "hybrid" and sub in SUBSTACKED:
            j, _, tail = tail.partition(".")
            index = (int(i), int(j))
            key = f"{stack}.{sub}.{tail}"
        else:
            index, key = (int(i),), f"{stack}.{rest}"
        stacked.setdefault(key, {})[index] = leaf
    for key, parts in stacked.items():
        out[key] = _stack(parts)
    tree: dict = {}
    for key, leaf in out.items():
        *path, last = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _stack(parts: dict) -> np.ndarray:
    """One array of the leaves at consecutive indices (tuples of one or two
    axes, each starting at 0)."""
    if len(next(iter(parts))) == 1:
        return np.stack([parts[(i,)] for i in range(len(parts))])
    n_i = 1 + max(i for i, _ in parts)
    n_j = len(parts) // n_i
    return np.stack([np.stack([parts[(i, j)] for j in range(n_j)])
                     for i in range(n_i)])
