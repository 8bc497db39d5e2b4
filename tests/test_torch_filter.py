"""The port's Filter-Borůvka hybrid held against the JAX package's, on the
cases of ``tests/test_filter_boruvka.py``: the same forest (and Kruskal's),
the same ``edges_filtered``, ``filter_passes`` and ``survivor_history``,
the sub-solves' counters equal, and ``host_syncs`` / ``extra_syncs`` the
reference's plus the label loop's flag reads.  Also the pieces under it:
``connected_labels`` and ``component_maxkey`` (with the Pallas pointer
jump in interpret mode on the reference side), ``subgraph_by_mask`` /
``lift_mask`` and the edge sampler.  Cases marked ``gpu`` run on the
card."""
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import filter_boruvka, kruskal_ref, mst_api, partition
from repro_torch.core import pipeline, runtime, union_find
from repro_torch.core.filter_boruvka import MAX_PASSES
from repro_torch.core.graph import PAD_VERTEX, Graph
from repro_torch.core.keys import from_reference, to_reference
from repro_torch.core.params import GHSParams
from repro_torch.kernels.spmv_minplus import ops as minplus_ops

# Counters that must equal the reference's; host_syncs and extra_syncs are
# the reference's plus the label loop's reads (``label_syncs``).
LEDGER = ("edges_filtered", "filter_passes", "survivor_history", "rounds",
          "intervals", "compactions", "edges_scanned", "active_history",
          "overlapped_syncs", "speculative_intervals", "rounds_per_graph",
          "buckets", "bucket_shapes")


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package, imported for this module only (the
    ``jax.experimental.enable_x64`` name is installed for the import and
    removed again with the ``repro`` modules on teardown)."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro.core import generators as rgen, kruskal_ref as rkr
        from repro.core import mst_api as rapi, partition as rpart
        from repro.core import pipeline as rpipe
        from repro.core.graph import preprocess as rpre
        from repro.core.params import GHSParams as RParams
        from repro.kernels.spmv_minplus import ops as rops
        yield types.SimpleNamespace(
            generators=rgen, kruskal=rkr, api=rapi, partition=rpart,
            pipeline=rpipe, preprocess=rpre, params=RParams, ops=rops,
            enable_x64=jax.experimental.enable_x64)
    finally:
        if shimmed:
            del jax.experimental.enable_x64
        for name in _repro_modules():
            del sys.modules[name]
        sys.modules.update(saved)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never while the module imports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _port(g) -> Graph:
    return Graph.from_arrays(g.src, g.dst, g.weight, g.num_vertices)


def _raw_corpus():
    from test_torch_boruvka import _raw_corpus as corpus
    return corpus()


CORPUS = [name for name, _ in _raw_corpus()]


def _assert_forest(got, want, ctx=None):
    assert np.array_equal(got.edge_mask, want.edge_mask), ctx
    assert (got.total_weight, got.num_components, got.num_tree_edges) == \
        (want.total_weight, want.num_components, want.num_tree_edges), ctx


def _assert_ledger(gst, wst, ctx=None):
    for field in LEDGER:
        assert getattr(gst, field) == getattr(wst, field), (field, ctx)
    assert gst.host_syncs == wst.host_syncs + gst.label_syncs, ctx
    assert gst.extra_syncs == wst.extra_syncs + gst.label_syncs, ctx


def _filter_both(ref, rgraph, **knobs):
    """One graph through both packages' filter with the same knobs; the
    port's forest also held against Kruskal and its own Borůvka solve."""
    want, wst = ref.api.minimum_spanning_forest(
        rgraph, method="filter_boruvka", params=ref.params(**knobs))
    g = _port(rgraph)
    got, gst = mst_api.minimum_spanning_forest(
        g, method="filter_boruvka", params=GHSParams(**knobs), device="cpu")
    _assert_forest(got, want, knobs)
    _assert_ledger(gst, wst, knobs)
    _assert_forest(got, kruskal_ref.kruskal(g), knobs)
    plain, _ = mst_api.minimum_spanning_forest(g, device="cpu")
    _assert_forest(got, plain, knobs)
    assert 1 <= gst.filter_passes <= MAX_PASSES
    assert gst.edges_filtered == g.num_edges - gst.survivor_history[-1]
    return got, gst


# --- forests and ledgers ------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmat", "random", "disconnected"])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0])
def test_filter_matches_reference_and_kruskal(ref, kind, rate):
    g = ref.generators.generate(kind, 8, seed=11)
    _, st = _filter_both(ref, g, filter_sample_rate=rate)
    assert (st.label_syncs > 0) == (0.0 < rate)


@pytest.mark.parametrize("name", CORPUS)
def test_adversarial_corpus_filter_exact(ref, name):
    raw = dict(_raw_corpus())[name]
    for rate in (0.0, 0.4, 1.0):
        _filter_both(ref, ref.preprocess(*raw), filter_sample_rate=rate)


def test_filter_levels_sweep_identical(ref):
    """The level count quantizes the cycle rule: it changes how many edges
    are dropped (more levels, no fewer), never the forest."""
    g = ref.generators.generate("rmat", 9, seed=4)
    filtered = []
    for levels in (1, 2, 16, 64):
        _, st = _filter_both(ref, g, filter_sample_rate=0.25,
                             filter_levels=levels)
        filtered.append(st.edges_filtered)
    assert filtered == sorted(filtered)


@pytest.mark.parametrize("knobs", [
    dict(round_kernel="pallas", use_pallas=True),
    dict(use_pallas=True, interval_pipeline=0),
    dict(round_loop="host", partitioner="hashed"),
    dict(compaction="none", filter_levels=3),
], ids=["fused-kernels", "segscan-sequential", "host-loop", "no-compaction"])
def test_filter_knobs_match_reference(ref, knobs):
    g = ref.generators.generate("rmat", 8, seed=5)
    _filter_both(ref, g, filter_sample_rate=0.3, **knobs)


def test_filter_takes_device_edges(ref):
    spec = pipeline.GraphSpec("rmat", 8, seed=2)
    rspec = ref.pipeline.GraphSpec("rmat", 8, seed=2)
    want, wst = ref.api.minimum_spanning_forest(
        ref.pipeline.build(rspec), method="filter_boruvka")
    got, gst = mst_api.minimum_spanning_forest(
        pipeline.build(spec, device="cpu"), method="filter_boruvka",
        device="cpu")
    _assert_forest(got, want)
    _assert_ledger(gst, wst)


def test_filter_knob_validation(ref):
    g = _port(ref.generators.generate("rmat", 6, seed=0))
    for levels in (0, 65):
        with pytest.raises(ValueError, match="filter_levels"):
            mst_api.minimum_spanning_forest(
                g, method="filter_boruvka",
                params=GHSParams(filter_levels=levels), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        mst_api.minimum_spanning_forest(g, method="filter_boruvka",
                                        device="cpu", mesh=object())
    # The compressed collective is ported: one shard runs it as the dense
    # path, and it gives the plain engine's forest.
    got, _ = mst_api.minimum_spanning_forest(
        g, method="filter_boruvka", device="cpu",
        params=GHSParams(collective="compressed"))
    want, _ = mst_api.minimum_spanning_forest(g, device="cpu")
    assert np.array_equal(got.edge_mask, want.edge_mask)


def test_filter_recursion_bound(ref):
    """A tiny threshold forces the recursion; still at most MAX_PASSES
    passes, and exact."""
    g = ref.generators.generate("random", 8, seed=2)
    _, st = _filter_both(ref, g, filter_sample_rate=0.2, filter_threshold=1)
    assert st.filter_passes == MAX_PASSES
    assert len(st.survivor_history) == MAX_PASSES


def test_empty_sample_keeps_isolated_vertex_bridge(ref):
    """With rate 0 the sample is empty: nothing is dropped and the final
    solve sees every edge, the one bridge to vertex n-1 included."""
    rng = np.random.default_rng(7)
    n = 40
    src = np.concatenate([rng.integers(0, n - 1, 300), [0]])
    dst = np.concatenate([rng.integers(0, n - 1, 300), [n - 1]])
    w = np.concatenate([rng.random(300, dtype=np.float32) * 0.9 + 0.05,
                        np.float32([0.99])])
    rg = ref.preprocess(src, dst, w, n)
    bridge = np.flatnonzero((rg.src == 0) & (rg.dst == n - 1))
    assert bridge.size == 1
    got, st = _filter_both(ref, rg, filter_sample_rate=0.0)
    assert got.edge_mask[bridge[0]]
    assert st.edges_filtered == 0
    assert st.survivor_history == (rg.num_edges,)
    assert st.filter_passes == 1
    assert st.label_syncs == 0


def test_filter_no_card_raises(ref, monkeypatch):
    g = _port(ref.generators.generate("rmat", 5, seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mst_api.minimum_spanning_forest(g, method="filter_boruvka")


def test_filter_property_randomized(ref):
    from hypothesis import given, settings, strategies as st_

    @st_.composite
    def cases(draw):
        n = draw(st_.integers(min_value=2, max_value=48))
        m = draw(st_.integers(min_value=0, max_value=160))
        seed = draw(st_.integers(min_value=0, max_value=2**31 - 1))
        rate = draw(st_.floats(min_value=0.0, max_value=1.0))
        levels = draw(st_.integers(min_value=1, max_value=20))
        rng = np.random.default_rng(seed)
        w = rng.random(m, dtype=np.float32) * 0.98 + 0.01
        g = ref.preprocess(rng.integers(0, n, m), rng.integers(0, n, m), w, n)
        return g, rate, levels

    @settings(max_examples=15, deadline=None)
    @given(cases())
    def inner(case):
        g, rate, levels = case
        _filter_both(ref, g, filter_sample_rate=rate, filter_levels=levels)

    inner()


# --- the pieces ---------------------------------------------------------------

def _random_edges(seed, pad=0):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 120))
    m = int(rng.integers(0, 400))
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    active = rng.random(m) < 0.6
    key = rng.integers(1, 2**63, size=m, dtype=np.uint64)
    if pad:      # inert padding lanes, as the reference pads its trees
        src = np.concatenate([src, np.full(pad, PAD_VERTEX, np.int32)])
        dst = np.concatenate([dst, np.full(pad, PAD_VERTEX, np.int32)])
        active = np.concatenate([active, np.zeros(pad, bool)])
        key = np.concatenate([key, np.full(pad, 2**64 - 1, np.uint64)])
    return n, src, dst, active, key


def _iterations(n, src, dst, active, init=None) -> int:
    """Iterations of the hook-and-shortcut loop to its fixed point, by the
    plain ops (the reference's while_loop count)."""
    comp = torch.arange(n, dtype=torch.int32) if init is None else init
    si = torch.from_numpy(src).clamp(0, n - 1).long()
    di = torch.from_numpy(dst).clamp(0, n - 1).long()
    a = torch.from_numpy(active)
    for k in range(n + 1):
        cs, cd = comp[si], comp[di]
        alive = a & (cs != cd)
        if not alive.any():
            return k
        parent = union_find.hook_min(n, torch.maximum(cs, cd),
                                     torch.minimum(cs, cd), alive)
        comp = union_find.pointer_double(parent)[comp.long()]
    raise AssertionError("no fixed point")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_connected_labels_matches_reference(ref, seed, use_pallas):
    n, src, dst, active, _ = _random_edges(seed, pad=seed % 2 * 5)
    want = np.asarray(ref.ops.connected_labels(
        src, dst, active, num_vertices=n, use_pallas=use_pallas))
    stats = runtime.EngineStats()
    got = minplus_ops.connected_labels(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(active), num_vertices=n, use_pallas=use_pallas,
        stats=stats)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # One read before the first iteration and one after every batch.
    its = _iterations(n, src, dst, active)
    k = minplus_ops.LABEL_CHECK_EVERY
    assert stats.host_syncs == stats.extra_syncs == 1 + -(-its // k)
    # A warm start from a coarser active set refines to the same labels.
    half = active & (np.arange(active.size) % 2 == 0)
    init = np.array(ref.ops.connected_labels(
        src, dst, half, num_vertices=n, use_pallas=use_pallas))
    want2 = np.asarray(ref.ops.connected_labels(
        src, dst, active, num_vertices=n, init=init, use_pallas=use_pallas))
    got2 = minplus_ops.connected_labels(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(active), num_vertices=n,
        init=torch.from_numpy(init), use_pallas=use_pallas)
    assert np.array_equal(got2.numpy(), want2)
    assert np.array_equal(want2, want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_component_maxkey_matches_reference(ref, seed, use_pallas):
    n, src, dst, active, key = _random_edges(seed + 10, pad=seed % 2 * 5)
    with ref.enable_x64():
        comp, mk = ref.ops.component_maxkey(
            src, dst, key, active, num_vertices=n, use_pallas=use_pallas)
        comp, mk = np.asarray(comp), np.asarray(mk)
    args = (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(from_reference(key)), torch.from_numpy(active))
    gc, gm = minplus_ops.component_maxkey(*args, num_vertices=n,
                                          use_pallas=use_pallas)
    assert np.array_equal(gc.numpy(), comp)
    assert np.array_equal(to_reference(gm), mk)
    # Warm-started from the converged labels: one read, no iteration.
    stats = runtime.EngineStats()
    gc2, gm2 = minplus_ops.component_maxkey(
        *args, num_vertices=n, init=gc, use_pallas=use_pallas, stats=stats)
    assert torch.equal(gc2, gc) and torch.equal(gm2, gm)
    assert stats.host_syncs == 1


def test_label_padding_lanes_inert():
    src = torch.tensor([0, 2, PAD_VERTEX, PAD_VERTEX], dtype=torch.int32)
    dst = torch.tensor([1, 3, PAD_VERTEX, PAD_VERTEX], dtype=torch.int32)
    active = torch.tensor([True, True, False, False])
    got = minplus_ops.connected_labels(src, dst, active, num_vertices=5)
    assert got.tolist() == [0, 0, 2, 2, 4]
    key = torch.from_numpy(from_reference(np.array([7, 9, 2**64 - 1, 5],
                                                   np.uint64)))
    comp, mk = minplus_ops.component_maxkey(src, dst, key, active,
                                            num_vertices=5)
    assert comp.tolist() == [0, 0, 2, 2, 4]
    assert to_reference(mk).tolist() == [7, 7, 9, 9, 0]


@pytest.mark.parametrize("check_every", [1, 2, 3, 8])
def test_label_loop_reads_and_kernel_route(monkeypatch, check_every):
    """Each iteration runs the shortcut through the pointer-jump wrapper
    under ``use_pallas`` (its plain version on the CPU), and the loop
    reads its flag once before the first iteration and once after every
    ``LABEL_CHECK_EVERY`` iterations; the labels do not depend on it."""
    n, src, dst, active, _ = _random_edges(5)
    args = (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(active))
    want = minplus_ops.connected_labels(*args, num_vertices=n)
    calls = []
    real = minplus_ops.pointer_jump
    monkeypatch.setattr(minplus_ops, "pointer_jump",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(minplus_ops, "LABEL_CHECK_EVERY", check_every)
    stats = runtime.EngineStats()
    got = minplus_ops.connected_labels(*args, num_vertices=n,
                                       use_pallas=True, stats=stats)
    its = _iterations(n, src, dst, active)
    batches = -(-its // check_every)
    assert its > 1
    assert len(calls) == batches * check_every
    assert stats.host_syncs == 1 + batches
    assert torch.equal(got, want)
    # Under a mesh (the edges as four shard rows, padded with inactive
    # lanes) the labels and the reads are the same, and the pointer jump
    # still runs once an iteration, on the replicated parents.
    pad = -len(src) % 4
    rows = [torch.cat([a, torch.zeros(pad, dtype=a.dtype)]).view(4, -1)
            for a in args]
    calls.clear()
    stats = runtime.EngineStats()
    got = minplus_ops.connected_labels(*rows, num_vertices=n,
                                       use_pallas=True, stats=stats,
                                       collective="compressed", cand_cap=8)
    assert torch.equal(got, want)
    assert len(calls) == batches * check_every
    assert stats.host_syncs == 1 + batches


def test_subgraph_by_mask_and_lift_match_reference(ref):
    rg = ref.generators.generate("rmat", 7, seed=3)
    g = _port(rg)
    rng = np.random.default_rng(0)
    for mask in (rng.random(g.num_edges) < 0.3, np.zeros(g.num_edges, bool),
                 np.ones(g.num_edges, bool)):
        rsub, rindex = ref.partition.subgraph_by_mask(rg, mask)
        sub, index = partition.subgraph_by_mask(g, mask)
        assert np.array_equal(index, rindex)
        for f in ("src", "dst", "weight"):
            assert np.array_equal(getattr(sub, f), getattr(rsub, f))
            assert getattr(sub, f).dtype == getattr(rsub, f).dtype
        sub_mask = rng.random(sub.num_edges) < 0.5
        assert np.array_equal(
            partition.lift_mask(index, sub_mask, g.num_edges),
            ref.partition.lift_mask(rindex, sub_mask, g.num_edges))


def test_sample_mask_matches_reference_numpy(ref):
    """The filter's sample over candidate ids (an int64 tensor) is the
    reference's numpy draw over the same ids as uint64, byte for byte."""
    rng = np.random.default_rng(1)
    cand = np.sort(rng.choice(1 << 40, 5000, replace=False)).astype(np.int64)
    for seed, rate in ((0, 0.15), (1, 0.15), (3, 0.37), (0, 0.0), (0, 1.0)):
        want = np.asarray(ref.pipeline.sample_mask(
            seed, rate, cand.astype(np.uint64)), dtype=bool)
        got = pipeline.sample_mask(seed, rate, torch.from_numpy(cand))
        assert got.dtype == torch.bool
        assert got.numpy().tobytes() == want.tobytes(), (seed, rate)


def test_thresholds_match_reference_order(ref):
    rng = np.random.default_rng(2)
    ukeys = rng.integers(1, 2**63, size=300, dtype=np.uint64)
    for levels in (1, 5, 16, 64, 400):
        t = filter_boruvka._thresholds(from_reference(ukeys), levels)
        want = np.sort(ukeys)[np.maximum(
            (np.arange(1, levels + 1) * 300) // levels - 1, 0)]
        assert np.array_equal(to_reference(t), want)


# --- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rk", ["xla", "pallas"])
def test_gpu_filter_matches_cpu(cuda, rk):
    from repro_torch.core import generators
    g = generators.rmat(10, seed=3)
    params = GHSParams(round_kernel=rk, use_pallas=True,
                       filter_sample_rate=0.2)
    want, wst = mst_api.minimum_spanning_forest(
        g, method="filter_boruvka", params=params, device="cpu")
    kernels.reset_launches()
    got, gst = mst_api.minimum_spanning_forest(
        g, method="filter_boruvka", params=params)
    assert kernels.LAUNCHES["pointer_jump"] > 0
    _assert_forest(got, want)
    for field in LEDGER + ("host_syncs", "extra_syncs", "label_syncs"):
        assert getattr(gst, field) == getattr(wst, field), field


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gpu_connected_labels_kernel_matches_plain(cuda, seed):
    rng = np.random.default_rng(seed)
    n = 1 << 16
    m = 3 * n
    src = torch.from_numpy(rng.integers(0, n, m).astype(np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(0, n, m).astype(np.int32)).to(cuda)
    active = torch.from_numpy(rng.random(m) < 0.4).to(cuda)
    key = torch.from_numpy(from_reference(
        rng.integers(1, 2**63, size=m, dtype=np.uint64))).to(cuda)
    kernels.reset_launches()
    got = minplus_ops.component_maxkey(src, dst, key, active, num_vertices=n,
                                       use_pallas=True)
    assert kernels.LAUNCHES["pointer_jump"] > 0
    want = minplus_ops.component_maxkey(src, dst, key, active,
                                        num_vertices=n)
    cpu = minplus_ops.component_maxkey(src.cpu(), dst.cpu(), key.cpu(),
                                       active.cpu(), num_vertices=n)
    for a, b, c in zip(got, want, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
