"""Production meshes, the counterpart of the JAX package's
``launch/mesh.py``.

Single pod: 16 × 16 = 256 ranks (data × model).  Multi-pod: 2 × 16 × 16 =
512 ranks with a leading ``pod`` axis (data parallel and FSDP across
pods).

The JAX package builds these meshes over 512 host devices that it forces
on the CPU (its dry run's first lines).  Here :func:`fake_world` opens a
``torch.distributed`` process group of the ``fake`` backend, with
``world_size`` ranks in one process, and :func:`make_production_mesh`
builds a ``DeviceMesh`` over it.  The mesh's device type is only the fake
group's label: nothing runs on it, no collective moves data, and every
tensor placed on it in this package is a ``meta`` tensor, which says what
each rank would hold and allocates nothing.

``fake_world`` uses ``torch.testing._internal.distributed.fake_pg`` (the
``FakeStore``, and the import that registers the ``fake`` backend), a
private module of PyTorch.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist

from repro_torch.sharding.specs import ShardingRules

DEVICE_TYPE = "cpu"     # the fake group's label; no tensor lives there


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the body of the ``with``; destroyed on exit, also when the body
    raises.  Raises if a process group is open already."""
    if dist.is_initialized():
        raise RuntimeError("a process group is open already; fake_world "
                           "opens the only one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a mesh of {n} ranks needs a process group of "
                           f"{n} ranks (open fake_world({n}) first); the "
                           f"open group has {have}")
    return init_device_mesh(DEVICE_TYPE, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) over ``("data", "model")``, or with ``multi_pod`` (2, 16,
    16) over ``("pod", "data", "model")``, inside ``fake_world(256)`` or
    ``fake_world(512)``."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_rules(mesh) -> ShardingRules:
    """The rules of a mesh, by its axis names."""
    names = mesh.mesh_dim_names
    if "pod" in names:
        return ShardingRules(batch=("pod", "data"), model="model",
                             fsdp=("pod", "data"))
    if "data" in names:
        return ShardingRules(batch=("data",), model="model", fsdp=("data",))
    # single-axis test meshes
    ax = names[0]
    return ShardingRules(batch=(ax,), model=None, fsdp=(ax,))


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over this host's cards.  Only 1 × 1 is ported,
    over an open process group of one rank (``fake_world(1)``, say); more
    than one rank waits for shards on several cards."""
    if data * model > 1:
        raise NotImplementedError(
            f"a {data}x{model} host mesh waits for shards on several cards "
            f"(ROADMAP queue 1, item 13b)")
    return _mesh((data, model), ("data", "model"))
