"""The port's incremental updates held against the JAX package's, on the
cases of ``tests/test_incremental.py``: after every batch the forest and
the updated graph's arrays equal the reference's, ``updates_applied``,
``replacement_probes``, ``candidate_count`` and ``edges_filtered`` equal
the reference's, the sub-solve's counters too, ``host_syncs`` /
``extra_syncs`` are the reference's plus the label loop's flag reads, and
the forest equals a fresh solve of the updated graph and Kruskal's.  Cases
marked ``gpu`` run on the card."""
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import incremental, kruskal_ref, mst_api
from repro_torch.core.graph import Graph
from repro_torch.core.incremental import (
    EdgeBatch, _anchor_tree_mask, _apply_edge_batch_reference,
    apply_edge_batch, finalize_plan, plan_updates)
from repro_torch.core.params import GHSParams

LEDGER = ("updates_applied", "replacement_probes", "candidate_count",
          "edges_filtered", "filter_passes", "rounds", "intervals",
          "compactions", "edges_scanned", "active_history",
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
        from repro.core import generators as rgen, incremental as rinc
        from repro.core import mst_api as rapi
        from repro.core.graph import preprocess as rpre
        from repro.core.params import GHSParams as RParams
        yield types.SimpleNamespace(generators=rgen, inc=rinc, api=rapi,
                                    preprocess=rpre, params=RParams)
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


def _same_graph(a, b) -> bool:
    return (a.num_vertices == b.num_vertices
            and np.array_equal(a.src, b.src) and a.src.dtype == b.src.dtype
            and np.array_equal(a.dst, b.dst) and a.dst.dtype == b.dst.dtype
            and a.weight.dtype == b.weight.dtype
            and np.array_equal(a.weight.view(np.uint32),
                               b.weight.view(np.uint32)))


def _assert_forest(got, want, ctx=None):
    assert np.array_equal(got.edge_mask, want.edge_mask), ctx
    assert (got.total_weight, got.num_components, got.num_tree_edges) == \
        (want.total_weight, want.num_components, want.num_tree_edges), ctx


class Pair:
    """The same evolving graph in both packages."""

    def __init__(self, ref, rgraph, knobs=None, method="boruvka"):
        self.ref, self.knobs = ref, knobs or {}
        self.rstate, _ = ref.api.incremental_forest(
            rgraph, method=method, params=ref.params(**self.knobs))
        self.state, _ = mst_api.incremental_forest(
            _port(rgraph), method=method, params=GHSParams(**self.knobs),
            device="cpu")
        _assert_forest(self.state.forest, self.rstate.forest)

    @property
    def graph(self):
        return self.state.graph

    def update(self, inserts=(), deletes=(), ctx=None):
        """One batch through both packages: forests, graphs and ledgers
        equal; the forest equal to a fresh solve and to Kruskal."""
        old = self.state
        self.rstate, wst = self.ref.api.apply_updates(
            self.rstate, self.ref.inc.EdgeBatch.make(inserts, deletes),
            params=self.ref.params(**self.knobs))
        batch = EdgeBatch.make(inserts, deletes)
        self.state, st = mst_api.apply_updates(
            self.state, batch, params=GHSParams(**self.knobs), device="cpu")
        g2 = self.state.graph
        assert _same_graph(g2, _port(self.rstate.graph)), ctx
        assert _same_graph(g2, apply_edge_batch(old.graph, batch)), ctx
        _assert_forest(self.state.forest, self.rstate.forest, ctx)
        for field in LEDGER:
            assert getattr(st, field) == getattr(wst, field), (field, ctx)
        assert st.host_syncs == wst.host_syncs + st.label_syncs, ctx
        assert st.extra_syncs == wst.extra_syncs + st.label_syncs, ctx
        assert st.host_syncs == st.intervals + st.extra_syncs, ctx
        fresh, _ = mst_api.minimum_spanning_forest(g2, device="cpu")
        _assert_forest(self.state.forest, fresh, ctx)
        _assert_forest(self.state.forest, kruskal_ref.kruskal(g2), ctx)
        return st

    def random_batch(self, rng, n_ins=6, n_tree_del=2, n_rand_del=2):
        """Inserts, tree-edge deletes and arbitrary-pair deletes."""
        g, n = self.graph, self.graph.num_vertices
        ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
                float(rng.random() * 0.98 + 0.01)) for _ in range(n_ins)]
        dels = []
        tree = np.flatnonzero(self.state.forest.edge_mask)
        if tree.size and n_tree_del:
            for i in rng.choice(tree, size=min(n_tree_del, tree.size),
                                replace=False):
                dels.append((int(g.src[i]), int(g.dst[i])))
        dels += [(int(rng.integers(0, n)), int(rng.integers(0, n)))
                 for _ in range(n_rand_del)]
        return ins, dels


def _absent_pair(g, u=0, v=1):
    pid = set(zip(g.src.tolist(), g.dst.tolist()))
    while (u, v) in pid or (v, u) in pid or u == v:
        v += 1
    return u, v


# --- EdgeBatch -----------------------------------------------------------------

def test_edge_batch_make_and_counts(ref):
    ins, dels = [(0, 1, 0.5), (2, 3, 0.25)], [(4, 5)]
    b, rb = EdgeBatch.make(ins, dels), ref.inc.EdgeBatch.make(ins, dels)
    assert (b.num_inserts, b.num_deletes, b.size) == (2, 1, 3)
    for f in ("insert_src", "insert_dst", "insert_weight", "delete_src",
              "delete_dst"):
        assert np.array_equal(getattr(b, f), getattr(rb, f))
        assert getattr(b, f).dtype == getattr(rb, f).dtype
    assert EdgeBatch.make().size == 0


@pytest.mark.parametrize("ins,dels,match", [
    ([(0, 99, 0.5)], [], "endpoints"),
    ([], [(-1, 3)], "endpoints"),
    ([(0, 1, 1.5)], [], r"\(0, 1\)"),
    ([(0, 1, 0.0)], [], r"\(0, 1\)"),
])
def test_edge_batch_validation(ref, ins, dels, match):
    with pytest.raises(ValueError, match=match):
        ref.inc.EdgeBatch.make(ins, dels).validate(16)
    with pytest.raises(ValueError, match=match):
        EdgeBatch.make(ins, dels).validate(16)
    EdgeBatch.make([(0, 15, 0.5)]).validate(16)


# --- single batches -------------------------------------------------------------

def test_empty_batch_is_identity(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=1))
    old = p.state
    st = p.update(ctx="empty")
    assert st.updates_applied == 0
    assert np.array_equal(p.state.forest.edge_mask, old.forest.edge_mask)
    assert _same_graph(p.graph, old.graph)


def test_self_loop_insert_is_noop(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=2))
    assert p.update([(3, 3, 0.5), (7, 7, 0.01)], ctx="loops") \
        .updates_applied == 0


def test_duplicate_inserts_keep_min_weight(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=3))
    u, v = _absent_pair(p.graph)
    st = p.update([(u, v, 0.7), (v, u, 0.2), (u, v, 0.9)], ctx="dup")
    i = np.flatnonzero((p.graph.src == u) & (p.graph.dst == v))
    assert i.size == 1 and p.graph.weight[i[0]] == np.float32(0.2)
    assert st.updates_applied == 1


def test_parallel_insert_of_existing_edge(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=4))
    g = p.graph
    i = int(np.flatnonzero(p.state.forest.edge_mask)[0])
    u, v, w = int(g.src[i]), int(g.dst[i]), float(g.weight[i])
    assert p.update([(u, v, min(w + 0.01, 0.99))], ctx="heavier") \
        .updates_applied == 0
    assert p.update([(u, v, w / 2)], ctx="lighter").updates_applied == 1


def test_insert_existing_forest_edge_same_weight_is_noop(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=5))
    g, old = p.graph, p.state
    i = int(np.flatnonzero(old.forest.edge_mask)[3])
    st = p.update([(int(g.src[i]), int(g.dst[i]), float(g.weight[i]))],
                  ctx="reinsert-tree")
    assert st.updates_applied == 0
    assert np.array_equal(p.state.forest.edge_mask, old.forest.edge_mask)


def test_delete_non_tree_edge_keeps_forest(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=6))
    g, old = p.graph, p.state
    i = int(np.flatnonzero(~old.forest.edge_mask)[0])
    assert p.update([], [(int(g.src[i]), int(g.dst[i]))],
                    ctx="del-non-tree").updates_applied == 1
    assert np.array_equal(
        np.sort(g.weight[old.forest.edge_mask].view(np.uint32)),
        np.sort(p.graph.weight[p.state.forest.edge_mask].view(np.uint32)))


def test_delete_absent_pair_is_noop(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=7))
    u, v = _absent_pair(p.graph)
    assert p.update([], [(u, v), (5, 5)], ctx="del-absent") \
        .updates_applied == 0


def test_delete_bridge_without_replacement_splits_forest(ref):
    p = Pair(ref, ref.generators.generate("chain", 5, seed=0))
    g, old = p.graph, p.state
    i = int(np.flatnonzero(old.forest.edge_mask)[4])
    st = p.update([], [(int(g.src[i]), int(g.dst[i]))], ctx="bridge")
    assert p.state.forest.num_components == old.forest.num_components + 1
    assert st.replacement_probes == 0


def test_delete_tree_edge_with_replacement_probes_the_cut(ref):
    rg = ref.generators.generate("rmat", 6, seed=8)
    tree = np.flatnonzero(Pair(ref, rg).state.forest.edge_mask)
    for i in tree[:8]:
        p = Pair(ref, rg)
        g, old = p.graph, p.state
        st = p.update([], [(int(g.src[i]), int(g.dst[i]))], ctx=int(i))
        if p.state.forest.num_components == old.forest.num_components:
            assert st.replacement_probes > 0
            return
    pytest.fail("no replaceable tree edge among the first 8")


def test_delete_and_reinsert_same_pair_in_one_batch(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=9))
    g = p.graph
    i = int(np.flatnonzero(p.state.forest.edge_mask)[0])
    u, v = int(g.src[i]), int(g.dst[i])
    p.update([(u, v, 0.995)], [(u, v)], ctx="del+ins")
    j = np.flatnonzero((p.graph.src == u) & (p.graph.dst == v))
    assert j.size == 1 and p.graph.weight[j[0]] == np.float32(0.995)


def test_update_from_empty_graph_builds_forest(ref):
    p = Pair(ref, ref.preprocess(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                 np.zeros(0, np.float32), 8))
    assert p.state.forest.num_components == 8
    st = p.update([(i, i + 1, 0.1 * (i + 1)) for i in range(7)],
                  ctx="from-empty")
    assert p.state.forest.num_components == 1
    assert st.updates_applied == 7 and st.label_syncs == 0


def test_delete_every_edge_empties_the_graph(ref):
    p = Pair(ref, ref.generators.generate("chain", 4, seed=1))
    g = p.graph
    p.update([], [(int(u), int(v)) for u, v in zip(g.src, g.dst)],
             ctx="delete-all")
    assert p.graph.num_edges == 0
    assert p.state.forest.num_components == g.num_vertices


def test_sorted_merge_matches_preprocess_reference(ref):
    """The sorted merge equals the preprocess-based definition, and both
    equal the JAX package's, across deletes, colliding inserts (lighter,
    heavier and tied copies), duplicate inserts, self-loops and empty
    graphs."""
    rng = np.random.default_rng(11)
    for trial in range(30):
        n = int(rng.integers(2, 64))
        m = int(rng.integers(0, 150))
        rg = ref.preprocess(rng.integers(0, n, m), rng.integers(0, n, m),
                            rng.random(m, dtype=np.float32) * 0.98 + 0.01, n)
        g = _port(rg)
        ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
                float(rng.random() * 0.98 + 0.01))
               for _ in range(int(rng.integers(0, 10)))]
        if g.num_edges:
            i = int(rng.integers(0, g.num_edges))
            w = float(g.weight[i])
            ins += [(int(g.src[i]), int(g.dst[i]), w),
                    (int(g.dst[i]), int(g.src[i]), min(w * 1.5, 0.99)),
                    (int(g.src[i]), int(g.dst[i]), w / 2)]
        if ins:
            ins.append(ins[0])
        dels = [(int(rng.integers(0, n)), int(rng.integers(0, n)))
                for _ in range(int(rng.integers(0, 5)))]
        if g.num_edges:
            j = int(rng.integers(0, g.num_edges))
            dels.append((int(g.dst[j]), int(g.src[j])))
        batch = EdgeBatch.make(ins, dels)
        got = apply_edge_batch(g, batch)
        assert _same_graph(got, _apply_edge_batch_reference(g, batch)), trial
        want = ref.inc.apply_edge_batch(rg, ref.inc.EdgeBatch.make(ins, dels))
        assert _same_graph(got, _port(want)), trial


@pytest.mark.parametrize("name", ["self-loops", "parallel-edges",
                                  "all-equal-weights", "no-edges",
                                  "single-edge"])
def test_adversarial_corpus_updates_exact(ref, name):
    from test_torch_boruvka import _raw_corpus
    p = Pair(ref, ref.preprocess(*dict(_raw_corpus())[name]))
    p.update(*p.random_batch(np.random.default_rng(0)), ctx=name)


# --- the ledger -----------------------------------------------------------------

def test_updates_applied_counts_structural_changes_exactly(ref):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=10))
    g = p.graph
    tree = np.flatnonzero(p.state.forest.edge_mask)
    i, j = int(tree[0]), int(tree[1])
    u, v = _absent_pair(g)
    ins = [(u, v, 0.5), (int(g.src[j]), int(g.dst[j]),
                         float(g.weight[j]) / 2), (3, 3, 0.5)]
    dels = [(int(g.src[i]), int(g.dst[i]))]
    st = p.update(ins, dels, ctx="ledger")
    assert st.updates_applied == 3
    assert st.filter_passes == 1
    assert st.edges_filtered == p.graph.num_edges - st.candidate_count
    assert st.label_syncs > 0


def test_probe_shrinks_the_final_solve(ref):
    p = Pair(ref, ref.generators.generate("rmat", 8, seed=0),
             knobs=dict(update_levels=32))
    st = p.update(*p.random_batch(np.random.default_rng(1)), ctx="shrink")
    assert st.candidate_count < p.graph.num_edges // 2
    assert st.edges_filtered > 0


def test_plan_finalize_split_matches_apply_updates(ref):
    """Plan, solve the candidates batched, finalize: the same forest as
    the one-call path, and as the reference's split."""
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=11))
    ins, dels = p.random_batch(np.random.default_rng(2))
    batch = EdgeBatch.make(ins, dels)
    plan = plan_updates(p.state, batch, device="cpu")
    rplan = ref.inc.plan_updates(p.rstate, ref.inc.EdgeBatch.make(ins, dels))
    assert _same_graph(plan.sub, _port(rplan.sub))
    assert np.array_equal(plan.index, rplan.index)
    assert np.array_equal(_anchor_tree_mask(p.state, plan.graph),
                          ref.inc._anchor_tree_mask(p.rstate, rplan.graph))
    forests, _ = mst_api.minimum_spanning_forests([plan.sub], device="cpu")
    via_plan = finalize_plan(plan, forests[0])
    prior = p.state
    p.update(ins, dels, ctx="split")
    _assert_forest(via_plan.forest, p.state.forest)
    assert _same_graph(via_plan.graph, p.graph)
    direct, _ = incremental.apply_updates(prior, batch, device="cpu")
    _assert_forest(direct.forest, p.state.forest)


@pytest.mark.parametrize("name,knobs", [
    ("default", {}),
    ("pallas-round", dict(round_kernel="pallas")),
    ("pallas-kernels", dict(round_kernel="pallas", use_pallas=True)),
    ("pallas-segmin", dict(use_pallas=True)),
    ("host-loop", dict(round_loop="host")),
    ("no-compaction", dict(compaction="none")),
    ("hashed", dict(partitioner="hashed")),
    ("levels-1", dict(update_levels=1)),
    ("levels-64", dict(update_levels=64)),
])
def test_param_surface_identical(ref, name, knobs):
    p = Pair(ref, ref.generators.generate("rmat", 6, seed=12), knobs=knobs)
    p.update(*p.random_batch(np.random.default_rng(3)), ctx=name)


def test_handle_from_any_engine_is_equivalent(ref):
    rg = ref.generators.generate("rmat", 6, seed=13)
    batch = Pair(ref, rg).random_batch(np.random.default_rng(4))
    masks = {}
    for method in ("boruvka", "filter_boruvka", "ghs"):
        p = Pair(ref, rg, method=method)
        p.update(*batch, ctx=method)
        masks[method] = p.state.forest.edge_mask
    assert np.array_equal(masks["boruvka"], masks["filter_boruvka"])
    assert np.array_equal(masks["boruvka"], masks["ghs"])


def test_update_levels_sweep_identical(ref):
    rg = ref.generators.generate("rmat", 7, seed=14)
    batch = Pair(ref, rg).random_batch(np.random.default_rng(5))
    masks = []
    for levels in (1, 4, 16, 64):
        p = Pair(ref, rg, knobs=dict(update_levels=levels))
        p.update(*batch, ctx=levels)
        masks.append(p.state.forest.edge_mask)
    for m in masks[1:]:
        assert np.array_equal(m, masks[0])


def test_update_entries_raise_without_card_or_with_mesh(ref, monkeypatch):
    p = Pair(ref, ref.generators.generate("rmat", 5, seed=0))
    with pytest.raises(TypeError, match="Mesh"):
        mst_api.apply_updates(p.state, EdgeBatch.make(), device="cpu",
                              mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mst_api.incremental_forest(p.graph),
                 lambda: mst_api.apply_updates(p.state, EdgeBatch.make())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- streams ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmat", "grid", "chain"])
@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_update_stream(ref, kind, seed):
    rng = np.random.default_rng(1000 + seed)
    p = Pair(ref, ref.generators.generate(kind, 6, seed=seed))
    for step in range(4):
        p.update(*p.random_batch(rng, n_ins=int(rng.integers(0, 8)),
                                 n_tree_del=int(rng.integers(0, 3)),
                                 n_rand_del=int(rng.integers(0, 3))),
                 ctx=(kind, seed, step))


def test_incremental_property_randomized(ref):
    from hypothesis import given, settings, strategies as st_

    @st_.composite
    def cases(draw):
        n = draw(st_.integers(min_value=2, max_value=40))
        m = draw(st_.integers(min_value=0, max_value=120))
        seed = draw(st_.integers(min_value=0, max_value=2**31 - 1))
        n_ins = draw(st_.integers(min_value=0, max_value=10))
        n_tdel = draw(st_.integers(min_value=0, max_value=4))
        levels = draw(st_.integers(min_value=1, max_value=16))
        rng = np.random.default_rng(seed)
        w = rng.random(m, dtype=np.float32) * 0.98 + 0.01
        g = ref.preprocess(rng.integers(0, n, m), rng.integers(0, n, m), w, n)
        return g, seed, n_ins, n_tdel, levels

    @settings(max_examples=15, deadline=None)
    @given(cases())
    def inner(case):
        g, seed, n_ins, n_tdel, levels = case
        p = Pair(ref, g, knobs=dict(update_levels=levels))
        batch = p.random_batch(np.random.default_rng(seed ^ 0x5EED),
                               n_ins=n_ins, n_tree_del=n_tdel, n_rand_del=2)
        p.update(*batch, ctx=(seed, n_ins, n_tdel, levels))

    inner()


# --- on the card --------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rk", ["xla", "pallas"])
def test_gpu_update_stream_matches_cpu(cuda, rk):
    """A chained stream on the card: every batch's forest, graph and
    ledger equal the CPU's, and the label loop launches K3."""
    from repro_torch.core import generators
    params = GHSParams(round_kernel=rk, use_pallas=True)
    g = generators.rmat(10, seed=4)
    gpu, _ = mst_api.incremental_forest(g, params=params)
    cpu, _ = mst_api.incremental_forest(g, params=params, device="cpu")
    rng = np.random.default_rng(7)
    n = g.num_vertices
    for step in range(4):
        tree = np.flatnonzero(cpu.forest.edge_mask)
        dels = [(int(cpu.graph.src[i]), int(cpu.graph.dst[i]))
                for i in rng.choice(tree, 16, replace=False)]
        ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
                float(rng.random() * 0.98 + 0.01)) for _ in range(32)]
        batch = EdgeBatch.make(ins, dels)
        kernels.reset_launches()
        gpu, gst = mst_api.apply_updates(gpu, batch, params=params)
        assert kernels.LAUNCHES["pointer_jump"] > 0, step
        cpu, cst = mst_api.apply_updates(cpu, batch, params=params,
                                         device="cpu")
        assert _same_graph(gpu.graph, cpu.graph), step
        _assert_forest(gpu.forest, cpu.forest, step)
        for field in LEDGER + ("host_syncs", "extra_syncs", "label_syncs"):
            assert getattr(gst, field) == getattr(cst, field), (field, step)
