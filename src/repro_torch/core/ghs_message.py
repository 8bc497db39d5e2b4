"""Paper-faithful message-driven GHS engine (Mazeev et al. 2016).

Executes the original GHS vertex procedures (Gallager–Humblet–Spira 1983,
handlers (1)-(11)) under the paper's implementation scheme (§3.2):

    While (True) {
        read_msgs();                   -> ingest
        process_queue();               -> sequential pop/dispatch loop
        [every CHECK_FREQUENCY steps]  -> drain the separate Test queue (C1)
        send_all_bufs();               -> flush
        check_finish();                -> silence detection (C5)
    }

Each MPI process of the paper maps to one shard of a mesh
(:class:`repro_torch.sharding.mesh.Mesh`, S shards on one device; without
a mesh, one shard holds every vertex).  Vertices are block-distributed
(``params.partitioner`` realizes other assignments as a relabeling,
:func:`runtime.vertex_partitioned`), and per-destination aggregation
buffers are fixed-capacity buckets exchanged once a superstep.  Messages
are bit-packed uint32 lanes (C3); a message locates its edge by the
linear-probe hash (C2) or the linear/binary-search ablations.

The superstep loop stays on the device: one launch of the interval kernel
(``kernels/ghs_superstep``, one block a shard, the exchange and the
silence sum inside the launch) runs up to ``check_frequency`` supersteps,
counting consecutive silent checks (``empty_iter_cnt_to_break``, paper
§3.6), so the host reads one vector of three scalars an interval; the
legacy driver (``params.round_loop == "host"``) launches it for one
superstep at a time.  Both run through
:func:`repro_torch.core.runtime.interval_loop`, and give the JAX package's
forest, counters and histories bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.core.ghs_state import BRANCH, init_stacked
from repro_torch.core.kruskal_ref import ForestResult
from repro_torch.core.params import DEFAULT_PARAMS, GHSParams
from repro_torch.kernels.ghs_superstep import ghs_superstep
from repro_torch.kernels.ghs_superstep import ref as superstep_ref
from repro_torch.kernels.ghs_superstep.ref import (
    ERR_HASH_MISS, ERR_LOGIC, ERR_QUEUE_OVERFLOW)


@dataclasses.dataclass
class GHSStats(runtime.EngineStats):
    supersteps: int = 0
    processed: int = 0
    productive: int = 0
    sent_remote: int = 0
    sent_local: int = 0
    halted_fragments: int = 0
    bytes_remote: int = 0
    # per-superstep histories (Fig 3 / Fig 4 analogues)
    queue_history: tuple = ()
    bytes_history: tuple = ()


_ERR_DESCRIPTIONS = (
    (ERR_QUEUE_OVERFLOW,
     "ERR_QUEUE_OVERFLOW: a message ring exceeded its capacity — raise "
     "params.queue_capacity (or leave it 0 to auto-size from the shard "
     "adjacency)"),
    (ERR_HASH_MISS,
     "ERR_HASH_MISS: edge hash lookup failed (hash table too small — raise "
     "params.hash_table_factor)"),
    (ERR_LOGIC,
     "ERR_LOGIC: protocol invariant violated (engine bug)"),
)


def _raise_on_err(err: int):
    if err:
        what = "; ".join(d for flag, d in _ERR_DESCRIPTIONS if err & flag)
        raise RuntimeError(
            f"GHS engine error flags: {err:#x} ({what or 'unknown flag'})")


def _device_driver(state, cfg, params, stats, total_cap: int, dev):
    """Fused loop: one launch and at most one host sync per
    ``check_frequency`` supersteps.

    The superstep and silent-streak counters ride the kernel's device
    vector (absolute step counts), so the next interval is queued straight
    from the previous one's unfetched outputs; that is what lets
    ``params.interval_pipeline`` double-buffer this driver.  A launch from
    a silent state runs nothing, so the speculative trailing interval
    cannot perturb the forest."""
    interval = max(params.check_frequency, 1)
    overlap = (runtime.resolve_interval_pipeline(params.interval_pipeline)
               == 1)
    box = dict(steps=0, dispatched=0)

    def dispatch(scal):
        # Clamp by the DISPATCHED total: under overlap this runs before the
        # previous interval's readback is consumed.  A clamped-to-zero
        # interval returns its inputs' counters.
        n_steps = max(min(interval, total_cap - box["dispatched"]), 0)
        box["dispatched"] += n_steps
        scal = ghs_superstep.interval(state, scal, n_steps, cfg)
        return scal, runtime.Readback(scal)

    def finish(scal, vals):
        steps_abs, silent, err = vals
        _raise_on_err(err)
        box["steps"] = steps_abs
        return scal, silent >= cfg.empty_needed

    runtime.interval_loop(
        torch.zeros(3, dtype=torch.int32, device=dev), dispatch, finish,
        stats=stats, max_intervals=-(-total_cap // interval),
        fail_msg=f"GHS engine did not reach silence in {total_cap} steps",
        overlap=overlap)
    return box["steps"]


def _host_driver(state, cfg, params, stats, total_cap: int, dev):
    """Legacy per-superstep loop (``round_loop="host"``): one launch and
    one readback a superstep, the counters kept on the host."""
    box = dict(steps=0, silent=0)

    def dispatch(_):
        scal = torch.tensor([box["steps"], box["silent"], 0],
                            dtype=torch.int32).to(dev)
        out = ghs_superstep.interval(state, scal, 1, cfg)
        return None, runtime.Readback(out)

    def finish(_, vals):
        _, silent, err = vals
        _raise_on_err(err)
        box["steps"] += 1
        box["silent"] = silent
        return None, silent >= cfg.empty_needed

    runtime.interval_loop(
        None, dispatch, finish, stats=stats, max_intervals=total_cap,
        fail_msg=f"GHS engine did not reach silence in {total_cap} steps")
    return box["steps"]


def minimum_spanning_forest(
    graph,
    params: GHSParams = DEFAULT_PARAMS,
    mesh=None,
    max_supersteps: Optional[int] = None,
    collect_history: bool = False,
    device=None,
) -> tuple[ForestResult, GHSStats]:
    """Run the faithful GHS engine; returns forest + execution stats.

    ``graph`` is a host :class:`Graph` or a
    :class:`repro_torch.core.pipeline.DeviceEdges` (mirrored to the host
    once: the shards are laid out on the host, then uploaded).  ``mesh``
    (a :class:`repro_torch.sharding.mesh.Mesh`) spreads the vertices over
    its shards on its device; ``params.partitioner`` picks the vertex
    distribution, a relabeling that keeps canonical edge ids, so the
    forest is the same for every partitioner and only the message routing
    changes.  ``params.round_loop`` selects the driver: ``"device"``
    (default) runs ``check_frequency`` supersteps a launch; ``"host"``
    one.  Both give the same forest.  ``device=None`` runs on the CUDA
    card and raises when there is none; ``device="cpu"`` runs the kernel's
    plain version.
    """
    S, dev = runtime.resolve_mesh(mesh, device)
    graph = runtime.as_graph(graph)
    loop = runtime.resolve_round_loop(params.round_loop)
    n = graph.num_vertices
    cap = max_supersteps or (40 * n + 2000)
    empty_needed = max(params.empty_iter_cnt_to_break, 1)
    total_cap = cap + empty_needed - 1   # silence-confirmation steps are free
    topo, state = init_stacked(
        runtime.vertex_partitioned(graph, params.partitioner, S), S, params,
        history_capacity=total_cap if collect_history else 1, device=dev)
    cfg = superstep_ref.config(topo, params)

    stats = GHSStats()
    driver = _device_driver if loop == "device" else _host_driver
    steps = driver(state, cfg, params, stats, total_cap, dev)
    stats.supersteps = steps

    # Final state fetch: forest, counters and histories in one transfer.
    fetched = (state.se, state.ceid, state.n_processed, state.n_productive,
               state.n_sent_remote, state.n_sent_local, state.halted,
               state.hist_act, state.hist_sent)
    flat = torch.cat([t.reshape(-1) for t in fetched]).cpu().numpy()
    stats.host_syncs += 1
    stats.extra_syncs += 1
    parts = np.split(flat, np.cumsum([t.numel() for t in fetched])[:-1])
    se, ceid = parts[0].reshape(S, -1), parts[1].reshape(S, -1)
    processed, productive, sent_remote, sent_local, halted = (
        int(p.sum()) for p in parts[2:7])
    hist_act = parts[7].reshape(S, -1)
    hist_sent = parts[8].reshape(S, -1)

    mask = np.zeros(graph.num_edges, dtype=bool)
    mask[ceid[se == BRANCH]] = True
    res = runtime.forest_from_mask(graph, mask)

    bytes_per_msg = topo.lanes * 4
    stats.processed = processed
    stats.productive = productive
    stats.sent_remote = sent_remote
    stats.sent_local = sent_local
    stats.halted_fragments = halted
    stats.bytes_remote = stats.sent_remote * bytes_per_msg
    if collect_history:
        # The activity is summed over the shards (the same on each); the
        # sends are each shard's running count, summed here.
        stats.queue_history = tuple(int(x) for x in hist_act[0][:steps])
        stats.bytes_history = tuple(
            int(x) * bytes_per_msg for x in hist_sent.sum(axis=0)[:steps])
    return res, stats
