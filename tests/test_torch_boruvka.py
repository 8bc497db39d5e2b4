"""The port's single-device Borůvka solve held against the JAX package's:
the same forest and the same stats ledger for every knob setting, on small
generated graphs and on a copy of the adversarial corpus."""
import itertools
import sys
import types

import numpy as np
import pytest

from repro_torch.core import generators, kruskal_ref, mst_api
from repro_torch.core.graph import preprocess
from repro_torch.core.params import GHSParams

GENERATED = {"rmat": 7, "ssca2": 6, "random": 6, "disconnected": 6}
CORPUS = ["self-loops", "parallel-edges", "all-equal-weights", "no-edges",
          "single-edge"]
KNOBS = list(itertools.product(("xla", "pallas"), (False, True), (0, 1),
                               ("block", "hashed", "balanced")))
STATS = ("rounds", "intervals", "host_syncs", "compactions", "active_history",
         "extra_syncs", "overlapped_syncs", "speculative_intervals",
         "edges_scanned")


def _raw_corpus():
    """Raw edge lists of the adversarial corpus (a copy of the JAX
    package's ``tests/test_mst_correctness.py`` corpus): the degenerate
    inputs generators rarely emit, preprocessed by each package."""
    rng = np.random.default_rng(42)
    n = 64
    loops = np.arange(n)
    src = np.concatenate([loops, rng.integers(0, n, 160)])
    dst = np.concatenate([loops, rng.integers(0, n, 160)])
    w = rng.random(src.size, dtype=np.float32) * 0.9 + 0.05
    yield "self-loops", (src, dst, w, n)
    base_u = rng.integers(0, 32, 48)
    base_v = rng.integers(0, 32, 48)
    src = np.tile(np.concatenate([base_u, base_v]), 4)
    dst = np.tile(np.concatenate([base_v, base_u]), 4)
    w = rng.random(src.size, dtype=np.float32) * 0.9 + 0.05
    yield "parallel-edges", (src, dst, w, 32)
    src = rng.integers(0, 48, 300)
    dst = rng.integers(0, 48, 300)
    w = np.full(300, np.float32(0.5))
    yield "all-equal-weights", (src, dst, w, 48)
    yield "no-edges", (np.zeros(0), np.zeros(0), np.zeros(0, np.float32), 37)
    yield "single-edge", (np.array([2]), np.array([5]),
                          np.array([0.25], np.float32), 9)


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's solve, imported for this module only (the
    ``jax.experimental.enable_x64`` name is installed for the import and
    removed again with the ``repro`` modules on teardown), with each test
    graph built once by both packages."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro.core import generators as rgen, mst_api as rapi
        from repro.core.graph import preprocess as rpre
        from repro.core.params import GHSParams as RParams
        graphs = {}
        for kind, scale in GENERATED.items():
            graphs[kind] = (rgen.generate(kind, scale, seed=13),
                            generators.generate(kind, scale, seed=13))
        for name, raw in _raw_corpus():
            graphs[name] = (rpre(*raw), preprocess(*raw))
        yield types.SimpleNamespace(api=rapi, params=RParams, graphs=graphs)
    finally:
        if shimmed:
            del jax.experimental.enable_x64
        for name in _repro_modules():
            del sys.modules[name]
        sys.modules.update(saved)


@pytest.mark.parametrize("rk,up,ip,part", KNOBS,
                         ids=["-".join(map(str, k)) for k in KNOBS])
@pytest.mark.parametrize("name", list(GENERATED) + CORPUS)
def test_solve_matches_reference(ref, name, rk, up, ip, part):
    rgraph, graph = ref.graphs[name]
    knobs = dict(round_kernel=rk, use_pallas=up, interval_pipeline=ip,
                 partitioner=part)
    want, wst = ref.api.minimum_spanning_forest(rgraph, method="boruvka",
                                                params=ref.params(**knobs))
    got, st = mst_api.minimum_spanning_forest(graph, params=GHSParams(**knobs),
                                              device="cpu")
    assert np.array_equal(got.edge_mask, want.edge_mask)
    assert (got.total_weight, got.num_components, got.num_tree_edges) == \
        (want.total_weight, want.num_components, want.num_tree_edges)
    for field in STATS:
        assert getattr(st, field) == getattr(wst, field), field
    assert st.host_syncs == st.intervals + 1


@pytest.mark.parametrize("name", list(GENERATED) + CORPUS)
def test_solve_matches_oracles(ref, name):
    _, graph = ref.graphs[name]
    got, _ = mst_api.minimum_spanning_forest(graph, device="cpu")
    for oracle in (kruskal_ref.kruskal, kruskal_ref.boruvka_numpy):
        want = oracle(graph)
        assert np.array_equal(got.edge_mask, want.edge_mask)
        assert got.num_components == want.num_components


@pytest.mark.parametrize("check_frequency,max_rounds,compaction",
                         [(1, None, "pow2"), (3, None, "none"), (2, 3, "pow2")])
def test_interval_knobs_match_reference(ref, check_frequency, max_rounds,
                                        compaction):
    """Other interval lengths, no compaction, and a round cap (which may
    stop the solve early) give the reference's ledger or its error."""
    rgraph, graph = ref.graphs["rmat"]
    knobs = dict(check_frequency=check_frequency, compaction=compaction)
    kw = {} if max_rounds is None else {"max_rounds": max_rounds}
    try:
        want, wst = ref.api.minimum_spanning_forest(
            rgraph, method="boruvka", params=ref.params(**knobs), **kw)
    except RuntimeError as err:
        with pytest.raises(RuntimeError, match=str(err)):
            mst_api.minimum_spanning_forest(graph, params=GHSParams(**knobs),
                                            device="cpu", **kw)
        return
    got, st = mst_api.minimum_spanning_forest(graph, params=GHSParams(**knobs),
                                              device="cpu", **kw)
    assert np.array_equal(got.edge_mask, want.edge_mask)
    for field in STATS:
        assert getattr(st, field) == getattr(wst, field), field
