"""S shards of a mesh, held on one device.

The JAX package runs its mesh paths single-controller: one process, S
devices, ``shard_map`` over the axis ``"x"`` (``compat.make_mesh((S,),
("x",))``).  Here the S shards live on one device along a leading axis:
an array the reference shards (``P("x")``) is a tensor whose first
dimension is S, an array it replicates (``P()``) is held once, and each
collective is the tensor operation that ``shard_map`` computes
(:mod:`repro_torch.sharding.collectives`).  So the whole sharded
algorithm, its exchanges included, runs on one card, with the same
kernels, and in one process on the CPU.
"""
from __future__ import annotations

import torch


class Mesh:
    """``num_shards`` shards on ``device``: the CUDA card unless the caller
    names another (``"cpu"`` runs the kernels' plain versions); with no
    card present the default raises instead of falling back to the CPU."""

    def __init__(self, num_shards: int, device=None):
        from repro_torch.core import runtime
        num_shards = int(num_shards)
        if num_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{num_shards}")
        self.num_shards = num_shards
        self.device = runtime.resolve_device(device)

    def __repr__(self) -> str:
        return f"Mesh(num_shards={self.num_shards}, device={self.device})"

    def shard(self, parts) -> torch.Tensor:
        """Stack the per-shard tensors (or arrays) ``parts``, shard 0 first,
        along a new leading dimension on the mesh's device."""
        if len(parts) != self.num_shards:
            raise ValueError(f"{len(parts)} parts for {self.num_shards} "
                             f"shards")
        return torch.stack([torch.as_tensor(p) for p in parts]).to(
            self.device)

    def axis_index(self) -> torch.Tensor:
        """Each shard's index along the axis (``lax.axis_index``), int32."""
        return torch.arange(self.num_shards, dtype=torch.int32,
                            device=self.device)

