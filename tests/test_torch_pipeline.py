"""The port's graph pipeline held against the JAX package's: the torch
splitmix64 and unsigned helpers, the counter-based samplers, the host and
device builds byte for byte (both preprocessing paths), the edge samplers,
the DeviceEdges hand-off into the engine, and DeviceEdges solves with every
stats field.  Cases marked ``gpu`` build on the card."""
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import generators, keys, kruskal_ref, mst_api, pipeline
from repro_torch.core import runtime
from repro_torch.core.graph import Graph, preprocess
from repro_torch.core.params import GHSParams

EDGE_WORDS = [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1,
              0x9E3779B97F4A7C15, 12345678901234567890]
STATS = ("rounds", "intervals", "host_syncs", "extra_syncs", "compactions",
         "edges_scanned", "active_history", "overlapped_syncs",
         "speculative_intervals", "edge_staging")


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
        from repro.core import generators as rgen, keys as rkeys
        from repro.core import mst_api as rapi, pipeline as rpipe
        from repro.core import runtime as rrt
        from repro.core.graph import preprocess as rpre
        from repro.core.params import GHSParams as RParams
        yield types.SimpleNamespace(
            generators=rgen, keys=rkeys, api=rapi, pipeline=rpipe,
            runtime=rrt, preprocess=rpre, params=RParams,
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


def _words():
    u = np.array(EDGE_WORDS, dtype=np.uint64)
    return u, torch.from_numpy(u.view(np.int64).copy())


def _as_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _same_graph(a, b) -> bool:
    return (a.num_vertices == b.num_vertices
            and np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
            and np.array_equal(np.asarray(a.weight).view(np.uint32),
                               np.asarray(b.weight).view(np.uint32)))


# --- raw 64-bit words --------------------------------------------------------

def test_splitmix64_torch_matches_reference(ref):
    u, t = _words()
    want = ref.keys.splitmix64(u)
    assert np.array_equal(_as_u64(keys.splitmix64_torch(t)), want)
    assert np.array_equal(keys.splitmix64(u), want)


@pytest.mark.parametrize("d", [1, 2, 5, 7, 255, (1 << 17) - 1, (1 << 31) - 1])
def test_umod_matches_uint64(d):
    u, t = _words()
    assert np.array_equal(_as_u64(keys.umod(t, d)), u % np.uint64(d))


def test_unsigned_less_than_matches_uint64():
    u, t = _words()
    for b in EDGE_WORDS:
        assert np.array_equal(keys.ult(t, b).numpy(), u < np.uint64(b)), b
    for b in EDGE_WORDS:
        bt = torch.full_like(t, keys.signed64(b))
        assert np.array_equal(keys.ult(t, bt).numpy(), u < np.uint64(b)), b


# --- generation ---------------------------------------------------------------

@pytest.mark.parametrize("scale", [7, 9])
@pytest.mark.parametrize("kind", pipeline.KINDS)
def test_raw_samples_match_reference(ref, kind, scale):
    rsrc, rdst, rw = ref.pipeline.raw_samples(
        ref.pipeline.GraphSpec(kind, scale, seed=3), np)
    src, dst, w = pipeline.raw_samples(pipeline.GraphSpec(kind, scale, seed=3),
                                       device="cpu")
    assert np.array_equal(_as_u64(src), rsrc)
    assert np.array_equal(_as_u64(dst), rdst)
    assert np.array_equal(w.numpy().view(np.uint32), rw.view(np.uint32))


def _check_builds(ref, kind, scale):
    rspec = ref.pipeline.GraphSpec(kind, scale, seed=3)
    spec = pipeline.GraphSpec(kind, scale, seed=3)
    want_host = ref.pipeline.build_host(rspec)
    want_dev = ref.pipeline.build(rspec)
    host = pipeline.build_host(spec)
    dev = pipeline.build(spec, device="cpu")
    assert dev.num_edges == host.num_edges == want_dev.num_edges
    assert dev.capacity == want_dev.capacity
    assert _same_graph(host, want_host)
    assert _same_graph(dev.to_graph(), want_dev.to_graph())
    # The whole buffers, padding included, equal the reference's bytes.
    with ref.enable_x64():
        import jax
        rs, rd, rk = jax.device_get((want_dev.src, want_dev.dst,
                                     want_dev.key))
    assert np.array_equal(dev.src.numpy(), np.asarray(rs))
    assert np.array_equal(dev.dst.numpy(), np.asarray(rd))
    assert np.array_equal(keys.to_reference(dev.key), np.asarray(rk))
    return host


@pytest.mark.parametrize("scale", [7, 9])
@pytest.mark.parametrize("kind", pipeline.KINDS)
def test_builds_byte_identical_to_reference(ref, kind, scale):
    host = _check_builds(ref, kind, scale)
    host.validate()


@pytest.mark.parametrize("kind", ["rmat", "chain"])
def test_builds_byte_identical_at_narrow_key_limit(ref, kind):
    """Scale 17 is the narrow key's last scale: ``u << 47`` fills all 64
    bits, so the sort word's top bit is set for u ≥ 2^16."""
    host = _check_builds(ref, kind, 17)
    assert int(host.src.max()) >= 1 << 16


def test_preprocess_general_path_matches_reference(ref):
    """The scale > 17 branch (pair-id sort + float32 scatter-min), on the
    reference's own small case, against ``graph.preprocess`` and the JAX
    ``_preprocess_device``."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    cap, m, n = 512, 400, 1 << 18
    src = rng.integers(0, n, cap).astype(np.uint64)
    dst = rng.integers(0, n, cap).astype(np.uint64)
    dst[::7] = src[::7]                     # self-loops
    dst[1::5] = dst[::5][:len(dst[1::5])]   # extra collisions
    src[1::5] = src[::5][:len(src[1::5])]
    w = (rng.integers(0, 1 << 23, cap).astype(np.float32) + 0.5) * 2.0 ** -23
    s, d, k, cnt = pipeline._preprocess_device(
        torch.from_numpy(src.astype(np.int64)),
        torch.from_numpy(dst.astype(np.int64)), torch.from_numpy(w),
        torch.arange(cap), num_samples=m, cap=cap, scale=18)
    cnt = int(cnt)
    want = preprocess(src[:m], dst[:m], w[:m], n)
    assert cnt == want.num_edges
    assert np.array_equal(s.numpy()[:cnt], want.src)
    assert np.array_equal(d.numpy()[:cnt], want.dst)
    assert np.array_equal(k.numpy()[:cnt], want.packed_keys)
    with ref.enable_x64():
        rs, rd, rk, rcnt = jax.jit(
            lambda s, d, w, c: ref.pipeline._preprocess_device(
                s, d, w, c, num_samples=m, cap=cap, scale=18)
        )(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
          jnp.arange(cap, dtype=np.uint64))
        rs, rd, rk = jax.device_get((rs, rd, rk))
    assert cnt == int(rcnt)
    assert np.array_equal(s.numpy(), np.asarray(rs))
    assert np.array_equal(d.numpy(), np.asarray(rd))
    assert np.array_equal(keys.to_reference(k), np.asarray(rk))


@pytest.mark.parametrize("kind", ["geo_knn", "grid", "chain", "star"])
def test_pipeline_generator_kinds(ref, kind):
    want = ref.generators.generate(kind, 7, seed=5, avg_degree=8)
    got = generators.generate(kind, 7, seed=5, avg_degree=8)
    assert _same_graph(got, want)


def test_graph_spec_checks():
    with pytest.raises(ValueError, match="unknown generator kind"):
        pipeline.GraphSpec("nope", 7)
    for scale in (0, 27):
        with pytest.raises(ValueError, match="scale must be"):
            pipeline.GraphSpec("rmat", scale)
    with pytest.raises(TypeError, match="Mesh"):
        pipeline.build(pipeline.GraphSpec("rmat", 5), mesh=object(),
                       device="cpu")


def _entry_points():
    spec = pipeline.GraphSpec("rmat", 5, seed=0)
    g = generators.rmat(5, seed=0)
    return {
        "raw_samples": lambda: pipeline.raw_samples(spec),
        "build": lambda: pipeline.build(spec),
        "minimum_spanning_forests":
            lambda: mst_api.minimum_spanning_forests([g, g]),
        "solve_packed": lambda: mst_api.solve_packed(
            pipeline.pack_bucket([g], 32, 256)),
        "warm_bucket": lambda: mst_api.warm_bucket(2, 32, 256),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_need_a_card(monkeypatch, name):
    """With no card, ``device=None`` raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


# --- edge sampling ------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_sample_mask_matches_reference(ref, rate):
    eid = np.arange(5000, dtype=np.uint64)
    want = ref.pipeline.sample_mask(11, rate, eid)
    got = pipeline.sample_mask(11, rate, torch.arange(5000))
    assert np.array_equal(got.numpy(), want)


def test_sample_mask_threshold_near_one(ref):
    """A rate just below 1 puts the threshold near 2^64: the compare must
    be unsigned."""
    eid = np.arange(20000, dtype=np.uint64)
    rate = 1.0 - 2.0 ** -12
    want = ref.pipeline.sample_mask(2, rate, eid)
    got = pipeline.sample_mask(2, rate, torch.arange(20000))
    assert np.array_equal(got.numpy(), want)
    assert not want.all()


@pytest.mark.parametrize("k", [0, 5, 3000])
def test_sample_mask_fixed_k_matches_reference(ref, k):
    eid = np.arange(3000, dtype=np.uint64)
    want = ref.pipeline.sample_mask_fixed_k(np, 4, k, eid)
    got = pipeline.sample_mask_fixed_k(4, k, torch.arange(3000))
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == k


@pytest.mark.parametrize("rate", [0.0, 0.1, 1.0])
def test_sample_device_edges_matches_reference(ref, rate):
    rspec = ref.pipeline.GraphSpec("rmat", 8, seed=2)
    dev = pipeline.build(pipeline.GraphSpec("rmat", 8, seed=2), device="cpu")
    with ref.enable_x64():
        import jax
        want = np.asarray(jax.device_get(ref.pipeline.sample_device_edges(
            ref.pipeline.build(rspec), rate, seed=9)))
    got = pipeline.sample_device_edges(dev, rate, seed=9)
    assert np.array_equal(got.numpy(), want)
    # Over the live ids it is sample_mask; padding slots never sample.
    host = pipeline.sample_mask(9, rate, torch.arange(dev.num_edges))
    assert torch.equal(got[:dev.num_edges], host)
    assert not got[dev.num_edges:].any()


# --- the hand-off into the engine ---------------------------------------------

def test_prepare_edges_staging_signal():
    """DeviceEdges under ``block`` are handed over in place (identity eid,
    -1 past num_edges); any other partitioner mirrors through the host
    under a warning; a host Graph stages from the host without one."""
    dev = pipeline.build(pipeline.GraphSpec("rmat", 7, seed=2), device="cpu")
    cpu = torch.device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bundle = runtime.prepare_edges(dev, "block", chunk=8, device=cpu)
    assert bundle.staging == "device"
    assert bundle.src is dev.src and bundle.key is dev.key
    m = dev.num_edges
    assert np.array_equal(bundle.layout.eid[:m], np.arange(m))
    assert (bundle.layout.eid[m:] == -1).all()
    assert bundle.layout.num_slots == dev.capacity
    assert bundle.graph() is dev.to_graph()
    for part in ("hashed", "balanced"):
        with pytest.warns(UserWarning, match="fast path.*" + part):
            bundle = runtime.prepare_edges(dev, part, chunk=8, device=cpu)
        assert bundle.staging == "host"
    g = generators.generate("rmat", 6, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bundle = runtime.prepare_edges(g, "block", chunk=8, device=cpu)
    assert bundle.staging == "host"
    _, st = mst_api.minimum_spanning_forest(dev, device="cpu")
    assert st.edge_staging == "device"
    _, st = mst_api.minimum_spanning_forest(g, device="cpu")
    assert st.edge_staging == "host"


def test_device_edges_to_graph_is_one_cached_mirror():
    dev = pipeline.build(pipeline.GraphSpec("geo_knn", 7, seed=1),
                         device="cpu")
    g = dev.to_graph()
    assert g is dev.to_graph()
    assert isinstance(g, Graph) and g.num_edges == dev.num_edges
    assert runtime.as_graph(dev) is g
    assert _same_graph(g, pipeline.build_host(dev.spec))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("rk", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["rmat", "geo_knn"])
def test_device_edges_solve_matches_reference(ref, kind, rk, use_pallas):
    rdev = ref.pipeline.build(ref.pipeline.GraphSpec(kind, 8, seed=1))
    dev = pipeline.build(pipeline.GraphSpec(kind, 8, seed=1), device="cpu")
    want, wst = ref.api.minimum_spanning_forest(
        rdev, method="boruvka",
        params=ref.params(round_kernel=rk, use_pallas=use_pallas))
    got, st = mst_api.minimum_spanning_forest(
        dev, params=GHSParams(round_kernel=rk, use_pallas=use_pallas),
        device="cpu")
    assert np.array_equal(got.edge_mask, want.edge_mask)
    assert (got.total_weight, got.num_components, got.num_tree_edges) == \
        (want.total_weight, want.num_components, want.num_tree_edges)
    for field in STATS:
        assert getattr(st, field) == getattr(wst, field), field
    assert st.edge_staging == "device"
    oracle = kruskal_ref.kruskal(dev.to_graph())
    assert np.array_equal(got.edge_mask, oracle.edge_mask)


def test_device_edges_host_loop_and_other_partitioners():
    dev = pipeline.build(pipeline.GraphSpec("grid", 8, seed=4), device="cpu")
    want = kruskal_ref.kruskal(dev.to_graph())
    res, st = mst_api.minimum_spanning_forest(
        dev, params=GHSParams(round_loop="host"), device="cpu")
    assert np.array_equal(res.edge_mask, want.edge_mask)
    with pytest.warns(UserWarning, match="fast path"):
        res, st = mst_api.minimum_spanning_forest(
            dev, params=GHSParams(partitioner="hashed"), device="cpu")
    assert np.array_equal(res.edge_mask, want.edge_mask)
    assert st.edge_staging == "host"


# --- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("scale", [9, 17, 18])
@pytest.mark.parametrize("kind", pipeline.KINDS)
def test_gpu_build_matches_build_host(cuda, kind, scale):
    spec = pipeline.GraphSpec(kind, scale, seed=3)
    dev = pipeline.build(spec)
    assert dev.src.is_cuda and dev.key.is_cuda
    assert _same_graph(dev.to_graph(), pipeline.build_host(spec))
    cpu = pipeline.build(spec, device="cpu")
    for a, b in ((dev.src, cpu.src), (dev.dst, cpu.dst), (dev.key, cpu.key)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("rk", ["xla", "pallas"])
def test_gpu_device_edges_solve(cuda, rk):
    spec = pipeline.GraphSpec("rmat", 12, seed=7)
    dev = pipeline.build(spec)
    kernels.reset_launches()
    got, st = mst_api.minimum_spanning_forest(
        dev, params=GHSParams(round_kernel=rk, use_pallas=True))
    expect = ("masked_minplus_scan", "pointer_jump") if rk == "pallas" \
        else ("segmented_min2_scan",)
    for name in expect:
        assert kernels.LAUNCHES[name] > 0, name
    assert st.edge_staging == "device"
    want = kruskal_ref.kruskal(pipeline.build_host(spec))
    assert np.array_equal(got.edge_mask, want.edge_mask)
    cpu, cst = mst_api.minimum_spanning_forest(
        pipeline.build(spec, device="cpu"),
        params=GHSParams(round_kernel=rk, use_pallas=True), device="cpu")
    for field in STATS:
        assert getattr(st, field) == getattr(cst, field), field
    assert torch.equal(pipeline.sample_device_edges(dev, 0.1, seed=3).cpu(),
                       pipeline.sample_device_edges(
                           pipeline.build(spec, device="cpu"), 0.1, seed=3))
