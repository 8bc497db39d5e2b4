"""Public MST API of the port — a thin façade over the engines.

Only ``method="boruvka"`` is ported; the other methods of the JAX package
raise ``NotImplementedError`` naming the ROADMAP item that will port them.
"""
from __future__ import annotations

from repro_torch.core import boruvka_dist, runtime
from repro_torch.core.kruskal_ref import ForestResult
from repro_torch.core.params import DEFAULT_PARAMS, GHSParams

METHODS = ("ghs", "boruvka", "filter_boruvka")

_NOT_PORTED = {
    "ghs": "ROADMAP queue 1, item 12: the paper-faithful GHS engine",
    "filter_boruvka": "ROADMAP queue 1, item 9: core/filter_boruvka.py",
}


def minimum_spanning_forest(
    graph,
    method: str = "boruvka",
    params: GHSParams = DEFAULT_PARAMS,
    device=None,
    **kw,
) -> tuple[ForestResult, runtime.EngineStats]:
    """Compute the minimum spanning forest of a :class:`Graph`.

    ``device=None`` runs on the CUDA card and raises when there is none;
    pass ``device="cpu"`` for the plain PyTorch path.  Returns
    ``(ForestResult, stats)``; the forest is bit-identical to the JAX
    package's for every knob, because both elect edges under the same
    packed (weight, edge-id) total order.
    """
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet ({_NOT_PORTED[method]})")
    if method != "boruvka":
        raise ValueError(f"unknown method {method!r}; options: {METHODS}")
    return boruvka_dist.minimum_spanning_forest(
        graph, params=params, device=device, **kw)
