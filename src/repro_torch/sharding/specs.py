"""Logical-axis sharding rules over the (pod, data, model) mesh, applied to
the port's own parameters: the counterpart of the JAX package's
``sharding/specs.py``.

:class:`ShardingRules` maps a logical axis name to mesh axes, with the
same table.  :func:`param_spec` takes a port parameter name, such as
``layers.3.attn.wq``, and its shape, and returns one entry per dimension:
``None``, one mesh axis, or a tuple of mesh axes, the ``PartitionSpec``
counterpart.  It matches by the leaf name with the JAX package's regex
table (first match wins), on the JAX package's layout of the leaf: a
name in ``models/convert.TRANSPOSED`` is an (out, in) matrix here and an
(in, out) one there, so its two trailing entries are swapped.  The JAX
leaves carry the stacked layer axes in front; no rule puts a mesh axis on
them, so a per-layer parameter of the port gets the JAX leaf's spec with
those axes removed.  An entry whose dimension does not divide by the
product of its mesh axes is dropped, as there.  :func:`placements` turns
a spec into DTensor placements over a ``torch.distributed`` DeviceMesh.

No counterpart, by design:

* ``shard``, ``use_sharding`` and ``current_ctx`` (the activation
  constraints and their context): on one card ``shard`` is a no-op, and
  the JAX package's only other reader of the context is its
  expert-parallel dispatch (``models/moe.py:50-56`` there), which comes
  with shards over several cards (ROADMAP queue 1, item 13b);
* the rules of the single-axis meshes of tests, the ``ShardingRules``
  default there: they go with ``launch/mesh.make_rules``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

from repro_torch.models.convert import TRANSPOSED


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis name -> mesh axes (None = replicate)."""

    batch: tuple = ("data",)          # ('pod','data') on multi-pod meshes
    model: Optional[str] = "model"    # TP axis
    fsdp: tuple = ("data",)           # parameter sharding axes

    def logical(self, name: Optional[str]):
        if name is None:
            return None
        if name == "batch":
            return self.batch
        if name in ("heads", "ff", "vocab", "experts", "model", "seq"):
            return self.model
        if name == "batch_heads":   # (B·H) flattened dims: data × model
            m = (self.model,) if self.model else ()
            return tuple(self.batch) + m
        if name == "fsdp":
            return self.fsdp
        raise KeyError(name)


# (regex over the JAX leaf path, trailing logical dims) -- first match wins.
_PARAM_RULES: Sequence[tuple] = (
    (r"(^|/)embed$",        ("vocab", "fsdp")),
    (r"(^|/)lm_head$",      ("fsdp", "vocab")),
    (r"(^|/)w[qkv]$",       ("fsdp", "heads")),
    (r"(^|/)wo$",           ("heads", "fsdp")),
    (r"(^|/)(wi|wg)$",      ("fsdp", "ff")),
    (r"(^|/)wd$",           ("ff", "fsdp")),
    (r"(^|/)router$",       ("fsdp", None)),
    (r"(^|/)(e_wi|e_wg)$",  ("experts", "fsdp", None)),
    (r"(^|/)e_wd$",         ("experts", None, "fsdp")),
    # Mamba: the channel dim (d_inner) is the TP axis; out_proj contracts
    # over it (column-parallel in, row-parallel out).
    (r"(^|/)in_proj$",      ("fsdp", "model")),
    (r"(^|/)out_proj$",     ("model", "fsdp")),
    (r"(^|/)x_proj$",       ("model", None)),
    (r"(^|/)dt_proj$",      (None, "model")),
    (r"(^|/)(r_proj|k_proj|v_proj|g_proj|w_proj|patch_proj|frame_proj|"
     r"cr_proj)$", ("fsdp", None)),
    (r"(^|/)ck_proj$",      ("fsdp", "ff")),
    (r"(^|/)cv_proj$",      ("ff", "fsdp")),
    (r".*",                 None),   # default: replicate
)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` (None, a name or a tuple)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def _reference_spec(path: str, shape, rules: ShardingRules, mesh) -> tuple:
    """The JAX rule for a leaf of ``shape`` at ``path``, one entry a dim."""
    ndim = len(shape)
    for pat, logical in _PARAM_RULES:
        if not re.search(pat, path):
            continue
        pad = ndim - len(logical) if logical is not None else -1
        if pad < 0:   # replicated, or smaller than the rule (a fused bias)
            return (None,) * ndim
        axes = [None] * pad + [rules.logical(a) for a in logical]
        if mesh is not None:   # drop indivisible constraints
            axes = [None if a is not None and shape[i] % axis_size(mesh, a)
                    else a for i, a in enumerate(axes)]
        # a tuple of one axis is that axis, as in a ``PartitionSpec``
        return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                     for a in axes)
    return (None,) * ndim


def param_spec(name: str, shape, rules: ShardingRules,
               mesh=None) -> tuple:
    """The spec of the port parameter ``name`` (a ``named_parameters``
    name) of ``shape``: one entry a dimension, ``None``, a mesh axis or a
    tuple of mesh axes.  With ``mesh``, entries that do not divide their
    dimension are dropped."""
    path = "/".join(p for p in name.split(".") if not p.isdigit())
    shape = tuple(shape)
    swap = path.rsplit("/", 1)[-1] in TRANSPOSED and len(shape) >= 2
    if swap:
        shape = shape[:-2] + (shape[-1], shape[-2])
    spec = _reference_spec(path, shape, rules, mesh)
    return spec[:-2] + (spec[-1], spec[-2]) if swap else spec


def param_specs(model, rules: ShardingRules, mesh=None) -> dict:
    """{name: :func:`param_spec`} over ``model.named_parameters()``."""
    return {name: param_spec(name, p.shape, rules, mesh)
            for name, p in model.named_parameters()}


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` over the DeviceMesh ``mesh``, one a
    mesh dimension: ``Shard(i)`` on each mesh dimension that tensor
    dimension i names (a tensor dimension over ``("pod", "data")`` is
    ``Shard(i)`` on both, split pod-major as in the JAX package),
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    dims: dict = {}
    for i, entry in enumerate(spec):
        for axis in (() if entry is None else
                     (entry,) if isinstance(entry, str) else entry):
            if axis in dims:
                raise ValueError(f"mesh axis {axis!r} shards two dims of "
                                 f"{spec}")
            dims[axis] = i
    names = mesh.mesh_dim_names
    unknown = set(dims) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} that "
                         f"the mesh {names} lacks")
    return [Shard(dims[a]) if a in dims else Replicate() for a in names]
