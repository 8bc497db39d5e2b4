"""Engine runtime — the interval-driven driver of the device round loop.

The engine's inner loop stays on the device:

    loop:  dispatch one interval          (rounds queued on the stream)
           read back ONE vector of scalars
           host decides: done? compact?

This module owns the engine-independent pieces: :func:`interval_loop` (the
host driver, sequential or double-buffered), :class:`Readback` (the one
device→host copy per interval), :class:`EngineStats`,
:func:`forest_from_mask`, the knob validators, and :func:`prepare_edges`
(the partition layer: a host :class:`Graph` is laid out on the host and
uploaded, a :class:`repro_torch.core.pipeline.DeviceEdges` is handed to the
engine in place; under a mesh the layout has one block of slots a
shard), :func:`vertex_partitioned` (the GHS engine's vertex partition, a
relabeling) and :func:`resolve_mesh`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import keys as keys_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core.graph import PAD_VERTEX, Graph
from repro_torch.core.kruskal_ref import ForestResult
from repro_torch.sharding import collectives
from repro_torch.sharding.mesh import Mesh

ROUND_LOOPS = ("device", "host")
ROUND_KERNELS = ("xla", "pallas")
INTERVAL_PIPELINES = (0, 1)


@dataclasses.dataclass
class EngineStats:
    """Host↔device traffic ledger of an engine driver.

    :func:`interval_loop` adds one ``host_syncs`` and one ``intervals`` per
    consumed interval readback; the engine adds one ``host_syncs`` and one
    ``extra_syncs`` for its final state fetch, so a single-graph device
    loop keeps ``host_syncs == intervals + 1``; the batched driver adds one
    final fetch per bucket, so ``host_syncs == intervals + buckets``.
    ``overlapped_syncs`` counts readbacks consumed while a successor
    interval was already queued; ``speculative_intervals`` counts trailing
    dispatches whose scalars were never read because termination had been
    observed.  ``edge_staging`` names the :func:`prepare_edges` path that
    staged the input (``"device"``: a DeviceEdges handed over in place;
    ``"host"``: laid out on the host and uploaded; empty for drivers that
    do not stage through it).  ``rounds_per_graph`` is filled by the
    batched driver: one round count per input graph, in input order.

    ``edges_filtered`` / ``filter_passes`` are filled by the Filter-Borůvka
    hybrid (``core/filter_boruvka.py``): the edges its cycle-rule probe
    proved non-MSF and the sample→solve→filter passes it ran.
    ``updates_applied`` / ``replacement_probes`` are filled by the
    incremental pass (``core/incremental.py``): the structural edge changes
    a batch applied, and the non-tree edges that cross a component severed
    by a deleted tree edge.  Engines that solve from scratch leave all four
    at 0.  ``comm_bytes`` is the per-shard on-wire byte total of the
    engine's cross-shard reductions under ``params.collective`` (0 with
    one shard).
    """

    host_syncs: int = 0
    intervals: int = 0
    extra_syncs: int = 0
    edge_staging: str = ""
    rounds_per_graph: tuple = ()
    edges_filtered: int = 0
    filter_passes: int = 0
    updates_applied: int = 0
    replacement_probes: int = 0
    overlapped_syncs: int = 0
    speculative_intervals: int = 0
    comm_bytes: int = 0


class Readback:
    """One device→host copy of an interval's scalar vector.

    On a CUDA tensor the copy goes to pinned host memory without blocking,
    and an event marks its end, so the host can queue the next interval
    before it waits.  On a CPU tensor the values are already on the host.
    """

    def __init__(self, scalars: torch.Tensor):
        if scalars.is_cuda:
            self._host = torch.empty(scalars.shape, dtype=scalars.dtype,
                                     pin_memory=True)
            self._host.copy_(scalars, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = scalars
            self._event = None

    def get(self) -> list:
        """Wait for the copy (the interval's one host sync) and return it."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


def interval_loop(
    state: Any,
    dispatch: Callable[[Any], Tuple[Any, Readback]],
    finish: Callable[[Any, list], Tuple[Any, bool]],
    *,
    stats: EngineStats,
    max_intervals: int,
    fail_msg: str,
    overlap: bool = False,
) -> Any:
    """Drive a device-resident engine to completion.

    ``dispatch(state) -> (state, readback)`` queues one interval and starts
    the copy of its scalar summary; ``finish(state, values)`` interprets the
    fetched values (counters, compaction) and reports termination.

    ``overlap=True`` double-buffers the loop: interval k+1 is queued from
    interval k's state before k's readback is waited on, so ``finish``
    receives interval k's values with the state after k+1.  The engine
    guarantees that an interval queued from a terminated state is a fixed
    point, and that what ``finish`` does from k's values stays valid for
    state k+1 (the active-edge census only shrinks).

    Raises ``RuntimeError(fail_msg)`` after ``max_intervals`` intervals
    without termination.
    """
    if not overlap:
        for _ in range(max_intervals):
            state, readback = dispatch(state)
            vals = readback.get()
            stats.host_syncs += 1
            stats.intervals += 1
            state, done = finish(state, vals)
            if done:
                return state
        raise RuntimeError(fail_msg)

    state, pending = dispatch(state)
    for _ in range(max_intervals):
        state, readback = dispatch(state)     # interval k+1, speculative
        vals = pending.get()                  # interval k's one host sync
        stats.host_syncs += 1
        stats.intervals += 1
        stats.overlapped_syncs += 1
        state, done = finish(state, vals)
        if done:
            stats.speculative_intervals += 1
            return state
        pending = readback
    raise RuntimeError(fail_msg)


def forest_from_mask(
    graph: Graph,
    mask: np.ndarray,
    *,
    num_components: Optional[int] = None,
) -> ForestResult:
    """Build a :class:`ForestResult` from a canonical edge bitmap."""
    mask = np.asarray(mask, dtype=bool)
    ntree = int(mask.sum())
    total = float(graph.weight[mask].sum(dtype=np.float64))
    if num_components is None:
        num_components = graph.num_vertices - ntree
    return ForestResult(total_weight=total, edge_mask=mask,
                        num_components=num_components, num_tree_edges=ntree)


def resolve_round_loop(round_loop: str) -> str:
    if round_loop not in ROUND_LOOPS:
        raise ValueError(
            f"unknown round_loop {round_loop!r}; options: {ROUND_LOOPS}")
    return round_loop


def resolve_round_kernel(round_kernel: str) -> str:
    if round_kernel not in ROUND_KERNELS:
        raise ValueError(
            f"unknown round_kernel {round_kernel!r}; options: {ROUND_KERNELS}")
    return round_kernel


def resolve_collective(collective: str) -> str:
    """Validate the ``params.collective`` knob: ``"pmin"`` full-width
    reductions, ``"compressed"`` the delta exchange of
    :func:`repro_torch.sharding.collectives.pmin_compressed`."""
    return collectives.resolve_collective(collective)


def resolve_mesh(mesh, device) -> Tuple[int, torch.device]:
    """``(num_shards, device)`` of an engine call: one shard on
    :func:`resolve_device` of ``device`` without a mesh, else the mesh's
    shards on its device (a ``device`` that names another raises)."""
    if mesh is None:
        return 1, resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.sharding.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device={device!r} differs from the mesh's "
                         f"device {mesh.device}")
    return mesh.num_shards, mesh.device


def resolve_interval_pipeline(depth: int) -> int:
    if depth not in INTERVAL_PIPELINES:
        raise ValueError(
            f"interval_pipeline must be one of {INTERVAL_PIPELINES}, "
            f"got {depth!r}")
    return depth


def resolve_device(device) -> torch.device:
    """The engine's device: CUDA unless the caller names another.  With no
    card present, the default raises instead of falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Partition layer
# ---------------------------------------------------------------------------

def _device_edges_type():
    from repro_torch.core.pipeline import DeviceEdges
    return DeviceEdges


def as_graph(source) -> Graph:
    """Host :class:`Graph` view of an engine input (a Graph, or the cached
    host mirror of a DeviceEdges)."""
    if isinstance(source, Graph):
        return source
    if isinstance(source, _device_edges_type()):
        return source.to_graph()
    raise NotImplementedError(
        f"engine input {type(source).__name__} is not supported: the port "
        f"takes a repro_torch Graph (see Graph.from_arrays) or a "
        f"repro_torch DeviceEdges (see pipeline.build)")


@dataclasses.dataclass
class EdgeBundle:
    """Edge state in engine layout on the device.

    ``src``/``dst`` (int32, ``PAD_VERTEX`` in padding slots) and ``key``
    (flipped int64, ``INF_KEY`` in padding slots) hold ``layout.num_slots``
    slots, shard s's block at ``[s·block, (s+1)·block)``; ``slot`` carries each slot's own index so tree-edge recording
    survives compaction.  ``source`` keeps the caller's input for the host
    mirror the forest is built from; ``staging`` names the path taken.
    """

    layout: partition_lib.EdgeLayout
    src: torch.Tensor
    dst: torch.Tensor
    key: torch.Tensor
    slot: torch.Tensor
    num_vertices: int
    num_edges: int
    source: Any = None
    staging: str = "host"

    def graph(self) -> Graph:
        return as_graph(self.source)


def prepare_edges(source, partitioner_name: str, *, chunk: int,
                  device: torch.device, num_shards: int = 1) -> EdgeBundle:
    """Stage an engine input on ``device`` under the chosen partitioner.

    * A host :class:`Graph`: the :class:`EdgeLayout` is built on the host,
      the arrays are gathered into slot order and uploaded once.
    * A :class:`~repro_torch.core.pipeline.DeviceEdges` under ``block``
      whose capacity divides into ``num_shards`` blocks: its canonical
      buffers are the block layout, handed over as they stand (moved with
      ``.to(device)`` if they live on another device); no edge crosses to
      the host.  Otherwise (another partitioner's layout is a host
      decision, or the capacity does not divide) it mirrors the edges
      through the host under a ``UserWarning`` that names the reason.

    With ``num_shards`` S the layout has S blocks, and ``slot`` counts
    within each block.  The path taken is ``EdgeBundle.staging`` (``"device"`` or ``"host"``).
    """
    part = partition_lib.get_partitioner(partitioner_name)
    S = num_shards
    if isinstance(source, _device_edges_type()):
        if part.name == "block" and source.capacity % S == 0:
            cap = source.capacity
            block = cap // S
            eid = np.arange(cap, dtype=np.int64)
            eid[source.num_edges:] = -1
            layout = partition_lib.EdgeLayout(num_shards=S, block=block,
                                              eid=eid)
            return EdgeBundle(
                layout=layout, src=source.src.to(device),
                dst=source.dst.to(device), key=source.key.to(device),
                slot=torch.arange(block, dtype=torch.int32,
                                  device=device).repeat(S),
                num_vertices=source.num_vertices,
                num_edges=source.num_edges, source=source, staging="device")
        why = (f"partitioner {part.name!r} is a host-side layout decision"
               if part.name != "block" else
               f"capacity {source.capacity} is not divisible by num_shards "
               f"{S}")
        warnings.warn(
            f"DeviceEdges cannot take the no-host-round-trip fast path "
            f"({why}); falling back to a full host mirror", stacklevel=2)
    graph = as_graph(source)
    layout = partition_lib.build_edge_layout(graph, part, S, chunk)
    valid = layout.eid >= 0
    gather = layout.eid[valid]
    src_p = np.full(layout.num_slots, PAD_VERTEX, np.int32)
    dst_p = np.full(layout.num_slots, PAD_VERTEX, np.int32)
    key_p = np.full(layout.num_slots, keys_lib.INF_KEY, np.int64)
    src_p[valid] = graph.src[gather]
    dst_p[valid] = graph.dst[gather]
    key_p[valid] = graph.packed_keys[gather]
    slot_np = (np.arange(layout.num_slots, dtype=np.int64)
               % layout.block).astype(np.int32)

    def put(a):
        return torch.from_numpy(a).to(device)

    return EdgeBundle(layout=layout, src=put(src_p), dst=put(dst_p),
                      key=put(key_p), slot=put(slot_np),
                      num_vertices=graph.num_vertices,
                      num_edges=graph.num_edges, source=source)


def vertex_partitioned(graph: Graph, partitioner_name: str,
                       num_shards: int) -> Graph:
    """The GHS engine's vertex partition: a relabeled graph whose block
    distribution (``owner = id // ceil(n / S)``) is the partitioner's
    assignment.  Edge order, weights and canonical edge ids stay, so the
    forest (recorded by canonical id) is the same for every partitioner."""
    part = partition_lib.get_partitioner(partitioner_name)
    if part.name == "block":
        return graph
    return partition_lib.relabel_graph(graph,
                                       part.vertex_perm(graph, num_shards))
