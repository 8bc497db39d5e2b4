"""The port's legacy host round loop and its 32-bit segmented scan (K4)
held against the JAX package's: the same forests and the same stats ledger
for every knob setting, and the scan bit for bit against the Pallas kernel
run in interpret mode and against the oracles.

On the CPU the scan wrapper runs its plain PyTorch version; the tests
marked ``gpu`` compare the CUDA kernel with it on the card and skip
without one."""
import functools
import itertools
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import generators, keys, kruskal_ref, mst_api
from repro_torch.core.graph import preprocess
from repro_torch.core.params import GHSParams
from repro_torch.kernels.segment_min import ops as seg_ops
from repro_torch.kernels.segment_min import ref as seg_ref
from repro_torch.kernels.segment_min.segment_min import (
    segmented_min_scan, segmented_min_scan_plain)

INF32 = keys.INF32
BLOCK = 128          # Pallas tile for the interpret-mode runs
GENERATED = {"rmat": 7, "ssca2": 6, "random": 6, "disconnected": 6}
CORPUS = ["self-loops", "parallel-edges", "all-equal-weights", "no-edges",
          "single-edge"]
KNOBS = list(itertools.product((False, True), ("block", "hashed", "balanced"),
                               ("pow2", "none"), (1, 5)))
STATS = ("rounds", "intervals", "host_syncs", "extra_syncs", "compactions",
         "edges_scanned", "active_history", "overlapped_syncs",
         "speculative_intervals")
SCAN_CASES = ["plain", "ragged", "all_inf", "dup_values", "one_segment",
              "special_values"]


def _raw_corpus():
    """Raw edge lists of the adversarial corpus (a copy of the JAX
    package's ``tests/test_mst_correctness.py`` corpus), preprocessed by
    each package."""
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
    """The JAX package, imported for this module only (the
    ``jax.experimental.enable_x64`` name is installed for the import and
    removed again with the ``repro`` modules on teardown), with each test
    graph built once by both packages.

    The reference's host loop builds a new ``jax.jit`` of its round body in
    every solve (``_make_round_fn``), so every solve compiles again.  For
    this module that pure factory is memoized, so solves of one shape reuse
    one executable; the reference's code runs unchanged."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro.core import boruvka_dist as rbd
        from repro.core import generators as rgen, mst_api as rapi
        from repro.core.graph import preprocess as rpre
        from repro.core.params import GHSParams as RParams
        from repro.kernels.segment_min import ops as so, ref as sr
        from repro.kernels.segment_min import segment_min as sk
        rbd._make_round_fn = functools.lru_cache(maxsize=None)(
            rbd._make_round_fn)
        graphs = {}
        for kind, scale in GENERATED.items():
            graphs[kind] = (rgen.generate(kind, scale, seed=13),
                            generators.generate(kind, scale, seed=13))
        for name, raw in _raw_corpus():
            graphs[name] = (rpre(*raw), preprocess(*raw))
        yield types.SimpleNamespace(api=rapi, params=RParams, graphs=graphs,
                                    preprocess=rpre, seg_ops=so, seg_ref=sr,
                                    seg_kernel=sk)
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


# --- K4: the 32-bit segmented min-scan --------------------------------------

def _scan_case(case: str, seed: int = 0):
    """Sorted int32 segments and reference uint32 values."""
    rng = np.random.default_rng(seed)
    m = {"ragged": 1000, "special_values": 3 * BLOCK}.get(case, 8 * BLOCK)
    nseg = {"one_segment": 1, "ragged": 5}.get(case, 37)
    seg = np.sort(rng.integers(0, nseg, m)).astype(np.int32)
    val = rng.integers(0, 2 ** 32 - 1, m, dtype=np.uint32)
    if case == "dup_values":
        val = rng.integers(0, 5, m).astype(np.uint32)
    if case == "special_values":
        val = rng.choice(np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                                   0xFFFFFFFF], np.uint32), m)
    val[rng.random(m) < 0.1] = 0xFFFFFFFF
    if case == "all_inf":
        val[:] = 0xFFFFFFFF
    return seg, val


@pytest.mark.parametrize("case", SCAN_CASES)
def test_segmented_min_scan_plain_matches_pallas(ref, case):
    import jax.numpy as jnp
    seg, val = _scan_case(case)
    m = seg.shape[0]
    tseg = torch.from_numpy(seg)
    tval = torch.from_numpy(keys.from_reference32(val))
    got = segmented_min_scan(tseg, tval)
    assert got.dtype == torch.int32
    pad = (-m) % BLOCK
    pseg = np.concatenate([seg, np.full(pad, 0x7FFFFFF0, np.int32)])
    pval = np.concatenate([val, np.full(pad, 0xFFFFFFFF, np.uint32)])
    want = ref.seg_kernel.segmented_min_scan(
        jnp.asarray(pseg), jnp.asarray(pval), block=BLOCK, interpret=True)
    assert np.array_equal(keys.to_reference32(got),
                          np.asarray(want)[:m])
    oracle = ref.seg_ref.segmented_min_scan(jnp.asarray(seg), jnp.asarray(val))
    assert np.array_equal(keys.to_reference32(got), np.asarray(oracle))
    assert torch.equal(got, seg_ref.segmented_min_scan(tseg, tval))


@pytest.mark.parametrize("m,s", [(0, 4), (5, 0), (1, 1), (700, 9),
                                 (3000, 77)])
def test_segment_min_paths_match_reference(ref, m, s):
    import jax.numpy as jnp
    rng = np.random.default_rng(m + s)
    seg = rng.integers(0, max(s, 1), m).astype(np.int32)
    val = rng.integers(0, 2 ** 32 - 2, m, dtype=np.uint32)
    want = np.asarray(ref.seg_ref.segment_min(jnp.asarray(val),
                                              jnp.asarray(seg), s))
    want_k = np.asarray(ref.seg_ops.segment_min(
        jnp.asarray(val), jnp.asarray(seg), num_segments=s, use_pallas=True))
    assert np.array_equal(want, want_k)
    tval = torch.from_numpy(keys.from_reference32(val))
    tseg = torch.from_numpy(seg)
    order = torch.sort(tseg, stable=True).indices
    kernels.reset_launches()
    for use_pallas, order_arg in ((False, None), (True, None), (True, order)):
        got = seg_ops.segment_min(tval, tseg, num_segments=s,
                                  use_pallas=use_pallas, order=order_arg)
        assert got.dtype == torch.int32 and got.shape == (s,)
        assert np.array_equal(keys.to_reference32(got), want), use_pallas
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_lane_converters_keep_unsigned_order():
    u = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)
    f = keys.from_reference32(u)
    assert f.dtype == np.int32 and np.all(np.diff(f) > 0)
    assert f[-1] == INF32
    assert np.array_equal(keys.to_reference32(torch.from_numpy(f)), u)


# --- the host loop ----------------------------------------------------------

def _solve_both(ref, name, **knobs):
    rgraph, graph = ref.graphs[name]
    want = ref.api.minimum_spanning_forest(
        rgraph, method="boruvka", params=ref.params(round_loop="host", **knobs))
    got = mst_api.minimum_spanning_forest(
        graph, params=GHSParams(round_loop="host", **knobs), device="cpu")
    return got, want


def _assert_same(got, want):
    (res, st), (wres, wst) = got, want
    assert np.array_equal(res.edge_mask, wres.edge_mask)
    assert (res.total_weight, res.num_components, res.num_tree_edges) == \
        (wres.total_weight, wres.num_components, wres.num_tree_edges)
    for field in STATS:
        assert getattr(st, field) == getattr(wst, field), field
    assert st.intervals == st.rounds
    assert st.host_syncs == st.intervals + st.extra_syncs


@pytest.mark.parametrize("up,part,compaction,cf", KNOBS,
                         ids=["-".join(map(str, k)) for k in KNOBS])
@pytest.mark.parametrize("name", list(GENERATED) + CORPUS)
def test_host_loop_matches_reference(ref, name, up, part, compaction, cf):
    _assert_same(*_solve_both(ref, name, use_pallas=up, partitioner=part,
                              compaction=compaction, check_frequency=cf))


@pytest.mark.parametrize("name", list(GENERATED) + CORPUS)
def test_host_loop_ignores_interval_pipeline(ref, name):
    """The host loop consumes every round's winners, so it never
    double-buffers: ``interval_pipeline`` changes nothing."""
    got, want = _solve_both(ref, name, use_pallas=True, interval_pipeline=0,
                            check_frequency=1)
    _assert_same(got, want)
    got1, want1 = _solve_both(ref, name, use_pallas=True, interval_pipeline=1,
                              check_frequency=1)
    _assert_same(got1, want1)
    _assert_same(got1, got)


@pytest.mark.parametrize("max_rounds", [1, 2, 3, 6])
def test_host_loop_round_cap_matches_reference(ref, max_rounds):
    """A round cap too small raises the reference's error; one that is
    large enough gives the reference's forest and ledger."""
    rgraph, graph = ref.graphs["rmat"]
    try:
        want = ref.api.minimum_spanning_forest(
            rgraph, method="boruvka", params=ref.params(round_loop="host"),
            max_rounds=max_rounds)
    except RuntimeError as err:
        with pytest.raises(RuntimeError, match=str(err)):
            mst_api.minimum_spanning_forest(
                graph, params=GHSParams(round_loop="host"), device="cpu",
                max_rounds=max_rounds)
        assert max_rounds < 5
        return
    got = mst_api.minimum_spanning_forest(
        graph, params=GHSParams(round_loop="host"), device="cpu",
        max_rounds=max_rounds)
    _assert_same(got, want)


@pytest.mark.parametrize("name", list(GENERATED) + CORPUS)
def test_host_loop_equals_device_loop(ref, name):
    _, graph = ref.graphs[name]
    host, _ = mst_api.minimum_spanning_forest(
        graph, params=GHSParams(round_loop="host", use_pallas=True),
        device="cpu")
    dev, _ = mst_api.minimum_spanning_forest(graph, device="cpu")
    assert np.array_equal(host.edge_mask, dev.edge_mask)
    assert host.num_components == dev.num_components
    assert np.array_equal(host.edge_mask, kruskal_ref.kruskal(graph).edge_mask)


def test_host_loop_graph_without_vertices_raises(ref):
    """A graph with no vertices fails in both packages' host loops."""
    raw = (np.zeros(0), np.zeros(0), np.zeros(0, np.float32), 0)
    with pytest.raises(Exception):
        ref.api.minimum_spanning_forest(
            ref.preprocess(*raw), method="boruvka",
            params=ref.params(round_loop="host"))
    with pytest.raises(ValueError, match="vertices"):
        mst_api.minimum_spanning_forest(
            preprocess(*raw), params=GHSParams(round_loop="host"),
            device="cpu")


# --- on the card -----------------------------------------------------------

def _gpu_scan_inputs(case, device):
    g = torch.Generator(device="cpu").manual_seed(4)
    m = {"tiny": 5, "one_tile": 2048, "ragged": 2048 * 3 + 17,
         "many_tiles": 2048 * 1100 + 37, "one_run": 2048 * 40}[case]
    nseg = {"one_run": 1, "many_tiles": 50_000}.get(case, 7)
    seg = torch.sort(torch.randint(0, nseg, (m,), generator=g)).values
    val = torch.randint(-2 ** 31, 2 ** 31 - 1, (m,), generator=g)
    val[torch.rand(m, generator=g) < 0.1] = INF32
    return (seg.to(torch.int32).to(device),
            val.to(torch.int32).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tiny", "one_tile", "ragged", "many_tiles",
                                  "one_run"])
def test_gpu_segmented_min_scan_matches_plain(cuda, case):
    seg, val = _gpu_scan_inputs(case, cuda)
    kernels.reset_launches()
    got = segmented_min_scan(seg, val)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["segmented_min_scan"] == 1
    assert torch.equal(got, segmented_min_scan_plain(seg, val))
    inf = torch.full_like(val, INF32)
    assert torch.equal(segmented_min_scan(seg, inf), inf)


@pytest.mark.gpu
def test_gpu_host_loop_matches_device_loop(cuda):
    g = generators.rmat(12, seed=5)
    kernels.reset_launches()
    host, st = mst_api.minimum_spanning_forest(
        g, params=GHSParams(round_loop="host", use_pallas=True))
    assert kernels.LAUNCHES["segmented_min_scan"] > 0
    dev, _ = mst_api.minimum_spanning_forest(g)
    assert np.array_equal(host.edge_mask, dev.edge_mask)
    assert host.num_components == dev.num_components
    cpu, cst = mst_api.minimum_spanning_forest(
        g, params=GHSParams(round_loop="host", use_pallas=True), device="cpu")
    assert np.array_equal(host.edge_mask, cpu.edge_mask)
    for field in STATS:
        assert getattr(st, field) == getattr(cst, field), field
