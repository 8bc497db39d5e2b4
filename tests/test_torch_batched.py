"""The port's batched solving held against the JAX package's, on the cases
of ``tests/test_batched.py``: every lane's forest, ``rounds_per_graph``,
``bucket_shapes``, ``active_history`` and the sync ledger equal the
reference's; ``warm_bucket`` returns its count; and the unpacked fallback
elects a whole bucket with one call a round.  Cases marked ``gpu`` run on
the card."""
import contextlib
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import boruvka_dist, incremental, kruskal_ref, mst_api
from repro_torch.core import pipeline
from repro_torch.core import keys
from repro_torch.core.graph import Graph
from repro_torch.core.params import GHSParams
from repro_torch.kernels.segment_min import ops as segops

LEDGER = ("rounds_per_graph", "bucket_shapes", "active_history", "buckets",
          "host_syncs", "intervals", "extra_syncs", "rounds", "compactions",
          "edges_scanned", "overlapped_syncs", "speculative_intervals")


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
        from repro.core import boruvka_dist as rbd, generators as rgen
        from repro.core import mst_api as rapi, pipeline as rpipe
        from repro.core.graph import preprocess as rpre
        from repro.core.params import GHSParams as RParams
        yield types.SimpleNamespace(bd=rbd, generators=rgen, api=rapi,
                                    pipeline=rpipe, preprocess=rpre,
                                    params=RParams)
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


def _single_edge(ref, n=2, w=0.5):
    return ref.preprocess(np.array([0]), np.array([1]),
                          np.array([w], np.float32), n)


def _edgeless(ref, n=6):
    return ref.preprocess(np.zeros(0), np.zeros(0), np.zeros(0, np.float32),
                          n)


def _mixed_batch(ref):
    gen = ref.generators.generate
    return [gen("rmat", 7, seed=1), gen("random", 8, seed=2),
            gen("rmat", 7, seed=3), gen("disconnected", 6, seed=4),
            _edgeless(ref), _single_edge(ref), gen("rmat", 6, seed=5)]


def _degenerates(ref):
    return [_edgeless(ref), _edgeless(ref, 1), _single_edge(ref),
            _edgeless(ref, 3)]


def _unpackable(ref):
    """The reference's two buckets that fail the contraction gate: weights
    ≥ 2.0, and 2·log2(n_pad) + 30 + log2(cap) = 65."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 64, 400)
    dst = rng.integers(0, 64, 400)
    w_wide = (rng.random(400, dtype=np.float32) * 3 + 0.5).astype(np.float32)
    g_wide = ref.preprocess(src, dst, w_wide, 64)
    n = 1 << 12
    src = rng.integers(0, n, 1600)
    dst = rng.integers(0, n, 1600)
    w_big = rng.random(1600, dtype=np.float32) * 0.9 + 0.05
    g_big = ref.preprocess(src, dst, w_big, n)
    return {"wide": g_wide, "big": g_big}


def _both(ref, graphs, knobs=None, **kw):
    """The same batch solved by both packages with the same knobs."""
    knobs = knobs or {}
    want, wst = ref.api.minimum_spanning_forests(
        graphs, params=ref.params(**knobs), **kw)
    got, gst = mst_api.minimum_spanning_forests(
        [_port(g) for g in graphs], params=GHSParams(**knobs),
        device="cpu", **kw)
    return got, gst, want, wst


def _assert_same(got, gst, want, wst, *, device_loop=True):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a.edge_mask, b.edge_mask), i
        assert (a.total_weight, a.num_components, a.num_tree_edges) == \
            (b.total_weight, b.num_components, b.num_tree_edges), i
    for field in LEDGER:
        assert getattr(gst, field) == getattr(wst, field), field
    if device_loop:
        assert gst.host_syncs == gst.intervals + gst.buckets
        assert gst.extra_syncs == gst.buckets


# --- forests and ledgers ------------------------------------------------------

@pytest.mark.parametrize("ip", [0, 1])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("rk", ["xla", "pallas"])
def test_mixed_batch_matches_reference(ref, rk, use_pallas, ip):
    graphs = _mixed_batch(ref)
    got, gst, want, wst = _both(ref, graphs, dict(
        round_kernel=rk, use_pallas=use_pallas, interval_pipeline=ip))
    _assert_same(got, gst, want, wst)
    assert gst.buckets >= 2
    for i, g in enumerate(graphs):
        single, st = mst_api.minimum_spanning_forest(_port(g), device="cpu")
        assert np.array_equal(got[i].edge_mask, single.edge_mask), i
        assert gst.rounds_per_graph[i] == st.rounds, i
        assert np.array_equal(got[i].edge_mask,
                              kruskal_ref.kruskal(_port(g)).edge_mask), i


@pytest.mark.parametrize("bucket", ["pow2", "exact"])
def test_degenerate_shapes_match_reference(ref, bucket):
    assert pipeline.bucket_shape(6, 0, bucket="pow2") == (8, 8)
    assert pipeline.bucket_shape(6, 0, bucket="exact") == (6, 1)
    assert pipeline.bucket_shape(1, 0, bucket="exact") == (1, 1)
    gen = ref.generators.generate
    degenerates = _degenerates(ref)
    mixed = degenerates + [gen("rmat", 6, seed=5), gen("rmat", 7, seed=1),
                           _edgeless(ref, 5)]
    for graphs in (degenerates, mixed):
        _assert_same(*_both(ref, graphs, dict(batch_bucket=bucket)))


@pytest.mark.parametrize("compaction,freq", [("none", 1), ("pow2", 1),
                                             ("pow2", 3)])
def test_compaction_matches_reference(ref, compaction, freq):
    graphs = [ref.generators.generate("rmat", 8, seed=s) for s in (1, 2, 3)]
    got, gst, want, wst = _both(ref, graphs, dict(
        compaction=compaction, batch_check_frequency=freq))
    _assert_same(got, gst, want, wst)
    if compaction == "pow2" and freq == 1:
        assert gst.compactions >= 1


def test_host_loop_fallback_matches_reference(ref):
    graphs = _mixed_batch(ref)
    got, gst, want, wst = _both(ref, graphs, dict(round_loop="host"))
    _assert_same(got, gst, want, wst, device_loop=False)
    dev, dst = mst_api.minimum_spanning_forests(
        [_port(g) for g in graphs], device="cpu")
    assert dst.rounds_per_graph == gst.rounds_per_graph
    for a, b in zip(dev, got):
        assert np.array_equal(a.edge_mask, b.edge_mask)


def test_device_edges_input_matches_reference(ref):
    rdev = ref.pipeline.build(ref.pipeline.GraphSpec("geo_knn", 7, seed=1))
    rhost = ref.pipeline.build_host(ref.pipeline.GraphSpec("geo_knn", 7,
                                                           seed=1))
    want, wst = ref.api.minimum_spanning_forests([rdev, rhost])
    spec = pipeline.GraphSpec("geo_knn", 7, seed=1)
    got, gst = mst_api.minimum_spanning_forests(
        [pipeline.build(spec, device="cpu"), pipeline.build_host(spec)],
        device="cpu")
    _assert_same(got, gst, want, wst)
    oracle = kruskal_ref.kruskal(pipeline.build_host(spec))
    assert np.array_equal(got[0].edge_mask, oracle.edge_mask)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["wide", "big"])
def test_unpacked_fallback_matches_reference(ref, name, use_pallas):
    g = _unpackable(ref)[name]
    (batch,) = pipeline.pack_batch([_port(g)])
    assert boruvka_dist._contract_gate(batch) is None
    got, gst, want, wst = _both(ref, [g, g], dict(use_pallas=use_pallas))
    _assert_same(got, gst, want, wst)
    single, st = mst_api.minimum_spanning_forest(_port(g), device="cpu")
    assert np.array_equal(got[0].edge_mask, single.edge_mask)
    assert gst.rounds_per_graph == (st.rounds, st.rounds)


def test_solve_packed_matches_reference(ref):
    gen = ref.generators.generate
    graphs = [gen("rmat", 7, seed=s) for s in (1, 2, 3)]
    shape = ref.pipeline.bucket_shape(graphs[0].num_vertices,
                                      max(g.num_edges for g in graphs))
    assert pipeline.bucket_shape(graphs[0].num_vertices,
                                 max(g.num_edges for g in graphs)) == shape
    want, wst = ref.api.solve_packed(ref.pipeline.pack_bucket(graphs, *shape))
    got, gst = mst_api.solve_packed(
        pipeline.pack_bucket([_port(g) for g in graphs], *shape),
        device="cpu")
    _assert_same(got, gst, want, wst)


def test_empty_input():
    results, stats = mst_api.minimum_spanning_forests([], device="cpu")
    assert results == []
    assert stats.buckets == 0 and stats.host_syncs == 0


# --- packing ------------------------------------------------------------------

@pytest.mark.parametrize("bucket", ["pow2", "exact"])
def test_pack_batch_matches_reference(ref, bucket):
    graphs = _mixed_batch(ref) + _degenerates(ref)
    want = ref.pipeline.pack_batch(graphs, bucket=bucket)
    got = pipeline.pack_batch([_port(g) for g in graphs], bucket=bucket)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.indices, a.n_pad, a.cap) == (b.indices, b.n_pad, b.cap)
        for f in ("num_vertices", "num_edges", "src", "dst", "slot"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert np.array_equal(keys.to_reference(a.key), b.key)


def test_pack_errors_match_reference(ref):
    big = ref.generators.generate("rmat", 8, seed=1)
    small = _single_edge(ref)
    cases = [dict(max_edges=64), dict(max_vertices=64), dict(bucket="golf")]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            ref.pipeline.pack_batch([small, big], **kw)
        with pytest.raises(ValueError) as got:
            pipeline.pack_batch([_port(small), _port(big)], **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="does not fit bucket"):
        pipeline.pack_bucket([_port(big)], 8, 8)
    with pytest.raises(ValueError, match="at least one graph"):
        pipeline.pack_bucket([], 8, 8)
    with pytest.raises(ValueError, match="indices length"):
        pipeline.pack_bucket([_port(small)], 8, 8, indices=(0, 1))


def test_capacity_and_knob_errors(ref):
    big = _port(ref.generators.generate("rmat", 8, seed=1))
    g = _port(_single_edge(ref))
    for loop in ("device", "host"):
        with pytest.raises(ValueError, match="exceeds pack_batch capacity"):
            mst_api.minimum_spanning_forests(
                [big], params=GHSParams(batch_max_edges=8, round_loop=loop),
                device="cpu")
    with pytest.raises(ValueError, match="unknown batch bucket policy"):
        mst_api.minimum_spanning_forests(
            [g], params=GHSParams(batch_bucket="golf"), device="cpu")
    with pytest.raises(ValueError, match="unknown round_loop"):
        mst_api.minimum_spanning_forests(
            [g], params=GHSParams(round_loop="warp"), device="cpu")
    with pytest.raises(ValueError, match="method='boruvka'"):
        mst_api.minimum_spanning_forests([g], method="ghs", device="cpu")
    with pytest.raises(ValueError, match="round_loop='device'"):
        mst_api.solve_packed(pipeline.pack_bucket([g], 2, 8),
                             params=GHSParams(round_loop="host"),
                             device="cpu")
    state, _ = mst_api.incremental_forest(g, device="cpu")
    ghs_handle, _ = mst_api.incremental_forest(g, method="ghs", device="cpu")
    assert np.array_equal(ghs_handle.forest.edge_mask, state.forest.edge_mask)
    with pytest.raises(NotImplementedError, match="item 13"):
        mst_api.apply_updates(state, incremental.EdgeBatch.make(),
                              device="cpu", mesh=object())


def test_inf_sentinel_weights_rejected(ref):
    bad = _port(ref.preprocess(
        np.array([0]), np.array([1]),
        np.array([np.uint32(0xFFFFFFFF)]).view(np.float32), 2))
    with pytest.raises(ValueError, match="INF sentinel"):
        mst_api.minimum_spanning_forests([bad], device="cpu")
    with pytest.raises(ValueError, match="lane 0: .*INF sentinel"):
        mst_api.solve_packed(pipeline.pack_bucket([bad], 2, 8), device="cpu")


# --- warmup -------------------------------------------------------------------

WARM = [
    (2, 64, 256, {}),
    (3, 128, 1024, dict(batch_check_frequency=200)),
    (1, 4096, 2048, dict(use_pallas=True)),       # fails the gate
    (2, 256, 1024, dict(round_kernel="pallas", batch_max_vertices=512,
                        batch_max_edges=4096)),
    (2, 32, 64, dict(compaction="none")),
]


@pytest.mark.parametrize("bsz,n_pad,cap,knobs", WARM,
                         ids=[f"{b}-{n}-{c}" for b, n, c, _ in WARM])
def test_warm_bucket_count_matches_reference(ref, bsz, n_pad, cap, knobs):
    want = ref.api.warm_bucket(bsz, n_pad, cap, params=ref.params(**knobs))
    got = mst_api.warm_bucket(bsz, n_pad, cap, params=GHSParams(**knobs),
                              device="cpu")
    assert got == want


# --- one election call a round for a whole fallback bucket --------------------

@contextlib.contextmanager
def _election_spy(monkeypatch):
    calls = []
    real = segops.segment_min64

    def spy(key, seg, *, num_segments, use_pallas=False):
        calls.append((int(key.shape[0]), num_segments, use_pallas))
        return real(key, seg, num_segments=num_segments,
                    use_pallas=use_pallas)

    monkeypatch.setattr(segops, "segment_min64", spy)
    yield calls


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("bsz", [1, 3])
def test_fallback_elects_bucket_once_a_round(ref, monkeypatch, bsz,
                                             use_pallas):
    g = _port(_unpackable(ref)["big"])
    lanes = [g] * bsz
    (batch,) = pipeline.pack_batch(lanes)
    with _election_spy(monkeypatch) as calls:
        res, st = mst_api.solve_packed(
            batch, params=GHSParams(use_pallas=use_pallas), device="cpu")
    dispatched = st.intervals + st.speculative_intervals
    assert len(calls) == dispatched        # one call a round, whatever B
    assert st.compactions >= 1
    lengths = [length for length, _, _ in calls]
    assert lengths[0] == 2 * bsz * batch.cap
    assert lengths == sorted(lengths, reverse=True)   # caps only shrink
    for length, segs, up in calls:
        assert segs == bsz * batch.n_pad and up == use_pallas
        assert length % (2 * bsz) == 0     # both endpoints of every lane
    want = kruskal_ref.kruskal(g)
    for r in res:
        assert np.array_equal(r.edge_mask, want.edge_mask)


def test_port_runs_no_python_loop_over_lanes(ref, monkeypatch):
    """The packed rounds see every lane at once: each packed round and
    contraction gets the whole (B, ·) bucket."""
    seen = []
    real = boruvka_dist._one_round_packed

    def spy(comp, *a, **kw):
        seen.append(tuple(comp.shape))
        return real(comp, *a, **kw)

    monkeypatch.setattr(boruvka_dist, "_one_round_packed", spy)
    graphs = [_port(ref.generators.generate("rmat", 7, seed=s))
              for s in (1, 2, 3, 4)]
    res, st = mst_api.minimum_spanning_forests(graphs, device="cpu")
    assert seen and all(s[0] == 4 for s in seen)
    for g, r in zip(graphs, res):
        assert np.array_equal(r.edge_mask, kruskal_ref.kruskal(g).edge_mask)


# --- on the card --------------------------------------------------------------

def _no_sync_dispatch(monkeypatch):
    real = boruvka_dist._run_interval_batch

    def checked(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(boruvka_dist, "_run_interval_batch", checked)


@pytest.mark.gpu
@pytest.mark.parametrize("rk", ["xla", "pallas"])
def test_gpu_batched_matches_cpu(cuda, monkeypatch, rk):
    specs = [pipeline.GraphSpec("rmat", 8 + i % 4, seed=i) for i in range(8)]
    graphs = [pipeline.build(s) for s in specs]
    params = GHSParams(round_kernel=rk, use_pallas=True)
    _no_sync_dispatch(monkeypatch)
    got, gst = mst_api.minimum_spanning_forests(graphs, params=params)
    want, wst = mst_api.minimum_spanning_forests(
        [pipeline.build_host(s) for s in specs], params=params, device="cpu")
    _assert_same(got, gst, want, wst)
    for g, r in zip(graphs, got):
        assert np.array_equal(r.edge_mask,
                              kruskal_ref.kruskal(g.to_graph()).edge_mask)


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", [1, 5])
def test_gpu_fallback_launches_k1_once_a_round(cuda, monkeypatch, bsz):
    specs = [pipeline.GraphSpec("rmat", 12, seed=s) for s in range(bsz)]
    graphs = [pipeline.build(s).to_graph() for s in specs]
    batches = pipeline.pack_batch(graphs)
    params = GHSParams(use_pallas=True)
    _no_sync_dispatch(monkeypatch)
    for batch in batches:
        assert boruvka_dist._contract_gate(batch) is None
        kernels.reset_launches()
        res, st = mst_api.solve_packed(batch, params=params)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["segmented_min2_scan"] == \
            st.intervals + st.speculative_intervals
        for g, r in zip(batch.graphs, res):
            assert np.array_equal(r.edge_mask,
                                  kruskal_ref.kruskal(g).edge_mask)


def test_interval_queues_no_round_past_convergence(monkeypatch):
    """A run-to-completion interval (``batch_check_frequency`` n_pad + 2,
    the service's) queues at most ``_rounds_to_converge(n_pad)`` rounds,
    and still ends every lane in one interval: on chains (the most rounds
    Borůvka needs), stars and rmat graphs, packed and fallback buckets."""
    from repro_torch.core import generators
    from repro_torch.core.graph import preprocess
    calls = []
    for name in ("_one_round_packed", "_one_round"):
        real = getattr(boruvka_dist, name)
        monkeypatch.setattr(
            boruvka_dist, name,
            lambda *a, real=real, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 64, 257, 1024):
        chain = preprocess(np.arange(n - 1), np.arange(1, n),
                           rng.random(n - 1, dtype=np.float32) * .9 + .05, n)
        star = preprocess(np.zeros(n - 1), np.arange(1, n),
                          rng.random(n - 1, dtype=np.float32) * .9 + .05, n)
        graphs = [chain, star, generators.rmat(max(n.bit_length() - 1, 1),
                                               seed=n)]
        for g in graphs:
            n_pad, cap = pipeline.bucket_shape(g.num_vertices, g.num_edges)
            for pallas in (False, True):
                params = GHSParams(batch_check_frequency=n_pad + 2,
                                   use_pallas=pallas)
                calls.clear()
                res, st = mst_api.solve_packed(
                    pipeline.pack_bucket([g, g], n_pad, cap), params=params,
                    device="cpu")
                assert st.intervals == 1
                bound = boruvka_dist._rounds_to_converge(n_pad)
                assert len(calls) <= bound
                assert max(st.rounds_per_graph) <= bound - 1
                for r in res:
                    assert np.array_equal(r.edge_mask,
                                          kruskal_ref.kruskal(g).edge_mask)
