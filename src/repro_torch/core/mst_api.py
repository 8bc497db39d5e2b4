"""Public MST API of the port — a thin façade over the engines.

``method="boruvka"`` (the synchronous engine) and ``"filter_boruvka"``
(the sampling hybrid, :mod:`.filter_boruvka`) are ported, as are batched
solving and the incremental entries (:mod:`.incremental`).
``method="ghs"`` raises ``NotImplementedError`` naming the ROADMAP item
that will port it.
"""
from __future__ import annotations

from repro_torch.core import boruvka_dist, filter_boruvka, incremental, runtime
from repro_torch.core.kruskal_ref import ForestResult
from repro_torch.core.params import DEFAULT_PARAMS, GHSParams

METHODS = ("ghs", "boruvka", "filter_boruvka")

_ENGINES = {
    "boruvka": boruvka_dist.minimum_spanning_forest,
    "filter_boruvka": filter_boruvka.minimum_spanning_forest,
}
_NOT_PORTED = {
    "ghs": "ROADMAP queue 1, item 12: the paper-faithful GHS engine",
}


def minimum_spanning_forest(
    graph,
    method: str = "boruvka",
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
    **kw,
) -> tuple[ForestResult, runtime.EngineStats]:
    """Compute the minimum spanning forest of ``graph``.

    ``graph`` is a host :class:`Graph` or a
    :class:`repro_torch.core.pipeline.DeviceEdges` from
    :func:`pipeline.build`, which the engine takes with no edge round trip
    through the host (``stats.edge_staging == "device"`` under the default
    ``block`` partitioner).  ``device=None`` runs on the CUDA card and
    raises when there is none; pass ``device="cpu"`` for the plain PyTorch
    path.  ``method="filter_boruvka"`` samples, solves the sample, drops
    the edges the cycle rule proves non-MSF and solves the survivors
    (``params.filter_sample_rate`` / ``filter_levels`` /
    ``filter_threshold``).  Returns ``(ForestResult, stats)``; the forest
    is bit-identical to the JAX package's for every method and knob,
    because every engine elects edges under the same packed (weight,
    edge-id) total order.
    """
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet ({_NOT_PORTED[method]})")
    if method not in _ENGINES:
        raise ValueError(f"unknown method {method!r}; options: {METHODS}")
    return _ENGINES[method](graph, params=params, device=device, **kw)


def minimum_spanning_forests(
    graphs,
    method: str = "boruvka",
    params: GHSParams = DEFAULT_PARAMS,
    max_rounds=None,
    device=None,
) -> tuple[list, runtime.EngineStats]:
    """Compute minimum spanning forests of MANY graphs at once.

    Graphs are bucketed by padded shape (``params.batch_bucket``,
    capacity-guarded by ``params.batch_max_vertices`` / ``batch_max_edges``)
    and each bucket runs the Borůvka round loop as ``(B, ·)`` tensors: one
    dispatch and one scalar readback per interval for the whole bucket.
    Returns ``(forests, stats)`` in input order; each forest equals the
    single-graph solve's, and ``stats.rounds_per_graph`` its rounds.  Only
    ``method="boruvka"`` has a batched path.  ``params.round_loop ==
    "host"`` falls back to a loop of single solves.
    """
    if method != "boruvka":
        raise ValueError(
            f"batched solving supports method='boruvka' only, got "
            f"{method!r}; solve GHS queries one graph at a time via "
            f"minimum_spanning_forest")
    return boruvka_dist.minimum_spanning_forests(
        graphs, params=params, max_rounds=max_rounds, device=device)


def solve_packed(
    batch,
    params: GHSParams = DEFAULT_PARAMS,
    max_rounds=None,
    device=None,
) -> tuple[list, runtime.EngineStats]:
    """Solve one pre-packed :class:`repro_torch.core.pipeline.GraphBatch`
    (routed with :func:`pipeline.bucket_shape`, packed with
    :func:`pipeline.pack_bucket`); results in lane order."""
    return boruvka_dist.solve_packed(
        batch, params=params, max_rounds=max_rounds, device=device)


def warm_bucket(
    batch_size: int,
    n_pad: int,
    cap: int,
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
) -> int:
    """Build and allocate everything a bucket shape can touch in a solve
    (see :func:`repro_torch.core.boruvka_dist.warm_bucket`)."""
    return boruvka_dist.warm_bucket(batch_size, n_pad, cap, params=params,
                                    device=device)


def incremental_forest(
    graph,
    method: str = "boruvka",
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
    **kw,
) -> tuple[incremental.IncrementalForest, runtime.EngineStats]:
    """Solve ``graph`` and wrap it as the evolving-graph handle that
    :func:`apply_updates` takes.  Every engine gives the same forest, so
    the handle is the same from any of them."""
    res, stats = minimum_spanning_forest(
        graph, method=method, params=params, device=device, **kw)
    return incremental.IncrementalForest(
        graph=runtime.as_graph(graph), forest=res), stats


def apply_updates(
    forest: incremental.IncrementalForest,
    edge_batch: incremental.EdgeBatch,
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
    mesh=None,
    max_rounds=None,
) -> tuple[incremental.IncrementalForest, incremental.IncrementalStats]:
    """Apply one batched insert/delete update to a solved forest.

    The updated graph is :func:`repro_torch.core.incremental.
    apply_edge_batch` of the inputs; the surviving tree edges anchor a
    cycle/cut probe on the device (one mask read a batch, beside the label
    loop's flag reads), and the Borůvka engine solves only the uncertified
    candidates.  The returned forest is bit-identical to a solve from
    scratch of the updated graph.  ``stats.updates_applied`` /
    ``stats.replacement_probes`` meter the pass.  ``device=None`` runs on
    the CUDA card and raises when there is none.
    """
    return incremental.apply_updates(
        forest, edge_batch, params=params, device=device, mesh=mesh,
        max_rounds=max_rounds)
