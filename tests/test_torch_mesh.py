"""The port's mesh paths held against the JAX package's, on the CPU: the
collectives over the shard axis (``pmin_compressed`` with its overflow
switch, the wire model), the vertex partitioners, the Borůvka engine over
a :class:`repro_torch.sharding.mesh.Mesh` of 1, 2, 4 and 8 shards (both
round bodies, both collectives, ``check_frequency=2``, the legacy host
loop with and without K4's plain version at every shard count, a
DeviceEdges input), the
pipeline's mesh build, Filter-Borůvka and an incremental update over 2
and 4 shards (their label loops sharded, the hooks through ``pmin`` or
the compressed exchange).  The port's label loop reads its flag on the
host, so its ``host_syncs`` and ``extra_syncs`` are the reference's plus
its ``label_syncs``.

The reference runs once for the module, in one subprocess with 8 forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
set before JAX starts) and the ``jax.experimental.enable_x64`` name
installed before ``repro`` is imported; it writes its results to an
``.npz`` that the tests read.  Tolerance: exact equality, every array and
every stats field."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import keys as keys_lib
from repro_torch.core import kruskal_ref, mst_api, partition, pipeline
from repro_torch.core.graph import Graph
from repro_torch.core.params import GHSParams
from repro_torch.sharding import collectives
from repro_torch.sharding.mesh import Mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SHARDS = (1, 2, 4, 8)
PC_CASES = ("random", "all_equal", "zero_delta", "overflow", "baseline",
            "baseline_overflow")
PC_N = 96

# (name, shards, params) of the device loop; every one at check_frequency=2.
BORUVKA = [
    (f"s{S}-{rk}-{coll}", S, dict(round_kernel=rk, collective=coll,
                                  check_frequency=2))
    for S in SHARDS for rk in ("xla", "pallas")
    for coll in ("pmin", "compressed")
] + [
    ("s4-xla-compressed-hashed", 4, dict(collective="compressed",
                                         partitioner="hashed",
                                         check_frequency=2)),
    ("s4-pallas-compressed-balanced", 4, dict(
        round_kernel="pallas", collective="compressed",
        partitioner="balanced", check_frequency=2)),
    ("s2-xla-pallas-seq", 2, dict(use_pallas=True, interval_pipeline=0,
                                  check_frequency=2)),
    ("s8-pallas-pallas-compressed", 8, dict(
        round_kernel="pallas", use_pallas=True, collective="compressed",
        check_frequency=2)),
] + [
    (f"host-s{S}-{up}", S, dict(round_loop="host", use_pallas=up,
                                check_frequency=2))
    for S in SHARDS for up in (False, True)
] + [("host-s4-hashed", 4, dict(round_loop="host", partitioner="hashed",
                                check_frequency=2))]

STATS = ("rounds", "intervals", "host_syncs", "extra_syncs", "compactions",
         "edges_scanned", "active_history", "comm_bytes", "comm_history",
         "overlapped_syncs", "speculative_intervals", "edge_staging")

PERM_GRAPHS = {"rmat9": ("rmat", 9, 3), "ssca6": ("ssca2", 6, 5)}
# Filter-Borůvka and the incremental pass: (name, shards, knobs).
HYBRID = [(f"s{S}-{coll}", S, dict(collective=coll, check_frequency=2))
          for S in (2, 4) for coll in ("pmin", "compressed")]
LEDGER = ("edges_filtered", "filter_passes", "survivor_history", "rounds",
          "intervals", "compactions", "edges_scanned", "active_history",
          "overlapped_syncs", "speculative_intervals", "comm_bytes",
          "comm_history")
INC_LEDGER = tuple(f for f in LEDGER if f != "survivor_history") + (
    "updates_applied", "replacement_probes", "candidate_count")
PERM_SHARDS = (1, 2, 3, 4, 8)

CHILD = r'''
import json, sys
import numpy as np
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import generators, partition, pipeline
from repro.core.mst_api import minimum_spanning_forest
from repro.core.params import GHSParams
from repro.sharding import collectives

spec = json.loads(sys.argv[2])
out = {}
meta = {}

# --- pmin_compressed: per-shard outputs under shard_map -------------------
N = spec["pc_n"]
x64 = jax.experimental.enable_x64()     # uint64 words need x64
x64.__enter__()
for S in spec["shards"]:
    mesh = make_mesh((S,), ("x",))
    for dname, dtype, inf in (("u64", jnp.uint64, 2**64 - 1),
                              ("u32", jnp.uint32, 2**32 - 1)):
        rng = np.random.default_rng(100 + S)
        for case in spec["pc_cases"]:
            baseline = case.startswith("baseline")
            if baseline and dname == "u64":
                continue
            data = np.full((S, N), inf, np.uint64)
            if baseline:
                data[:] = np.arange(N, dtype=np.uint64)
                k = 40 if case == "baseline_overflow" else 12
                for s in range(S):
                    idx = rng.choice(np.arange(1, N), size=k, replace=False)
                    data[s, idx] = rng.integers(0, idx)
                cap = 8 if case == "baseline_overflow" else 32
                default = jnp.arange(N, dtype=dtype)
            else:
                k = {"random": 16, "all_equal": 16, "zero_delta": 0,
                     "overflow": 64}[case]
                if k:
                    idx = rng.choice(N, size=k, replace=False)
                    vals = rng.integers(1, 1 << 30, size=k, dtype=np.uint64)
                    for s in range(S):
                        if case == "all_equal":
                            data[s, idx] = vals
                        else:
                            take = rng.random(k) < 0.7
                            data[s, idx[take]] = vals[take] + s
                cap = 8 if case == "overflow" else 32
                default = jnp.full((N,), inf, dtype)
            x = jnp.asarray(data).astype(dtype)

            def f(xs, default=default, cap=cap, S=S):
                return collectives.pmin_compressed(
                    xs[0], "x", default=default, cap=cap,
                    num_shards=S)[None]
            got = shard_map(f, mesh, in_specs=(P("x"),),
                            out_specs=P("x"))(x)
            key = f"pc-{S}-{dname}-{case}"
            out[key + "-x"] = np.asarray(data)
            out[key + "-out"] = np.asarray(jax.device_get(got)).astype(
                np.uint64)
            meta[key] = cap
x64.__exit__(None, None, None)

meta["compressed_bytes"] = [
    [cap, S, vb, collectives.compressed_bytes(cap, S, vb)]
    for cap in (8, 64, 1024) for S in (1, 2, 4, 8) for vb in (4, 8)]
meta["dense_bytes"] = [
    [n, S, vb, collectives.dense_bytes(n, S, vb)]
    for n in (1, 97, 512, 1 << 20) for S in (1, 2, 3, 4, 8) for vb in (4, 8)]

# --- vertex partitioners ---------------------------------------------------
for gname, (kind, scale, seed) in spec["perm_graphs"].items():
    g = generators.generate(kind, scale, seed=seed)
    out[f"g-{gname}-src"], out[f"g-{gname}-dst"] = g.src, g.dst
    out[f"g-{gname}-w"] = g.weight
    meta[f"g-{gname}-n"] = g.num_vertices
    for S in spec["perm_shards"]:
        for name in ("block", "hashed", "balanced"):
            out[f"perm-{gname}-{S}-{name}"] = partition.get_partitioner(
                name).vertex_perm(g, S)
        rg = partition.relabel_graph(g, out[f"perm-{gname}-{S}-hashed"])
        out[f"relabel-{gname}-{S}-src"] = rg.src
        out[f"relabel-{gname}-{S}-dst"] = rg.dst

# --- Borůvka under a mesh ----------------------------------------------------
g = generators.generate("rmat", 9, seed=3)
out["rmat9-src"], out["rmat9-dst"], out["rmat9-w"] = g.src, g.dst, g.weight
meta["rmat9-n"] = g.num_vertices

def record(name, res, st):
    out[f"bv-{name}-mask"] = np.asarray(res.edge_mask)
    meta[f"bv-{name}"] = dict(
        total_weight=float(res.total_weight),
        num_components=int(res.num_components),
        num_tree_edges=int(res.num_tree_edges),
        **{f: getattr(st, f) for f in spec["stats"]})

for name, S, knobs in spec["boruvka"]:
    res, st = minimum_spanning_forest(
        g, method="boruvka", params=GHSParams(**knobs),
        mesh=make_mesh((S,), ("x",)))
    record(name, res, st)

pspec = pipeline.GraphSpec("rmat", 9, seed=4)
hg = pipeline.build_host(pspec)
out["pipe-src"], out["pipe-dst"], out["pipe-w"] = hg.src, hg.dst, hg.weight
meta["pipe-n"] = hg.num_vertices
for S in (2, 4):
    res, st = minimum_spanning_forest(
        pipeline.build(pspec), method="boruvka",
        params=GHSParams(collective="compressed"),
        mesh=make_mesh((S,), ("x",)))
    record(f"pipe-s{S}", res, st)

for S in (2, 4):
    dev = pipeline.build(pspec, mesh=make_mesh((S,), ("x",)))
    out[f"pipemesh-s{S}-src"] = np.asarray(dev.src)
    out[f"pipemesh-s{S}-dst"] = np.asarray(dev.dst)
    out[f"pipemesh-s{S}-key"] = np.asarray(dev.key)
    meta[f"pipemesh-s{S}-m"] = dev.num_edges
    res, st = minimum_spanning_forest(dev, method="boruvka",
                                      mesh=make_mesh((S,), ("x",)))
    record(f"pipemesh-s{S}", res, st)

# --- Filter-Borůvka and one incremental update under a mesh -----------------
from repro.core import incremental as inc
from repro.core import mst_api as rapi
ginc = generators.generate("rmat", 8, seed=1)
out["inc-src"], out["inc-dst"], out["inc-w"] = (ginc.src, ginc.dst,
                                                ginc.weight)
meta["inc-n"] = ginc.num_vertices
base, _ = rapi.incremental_forest(ginc)
rng = np.random.default_rng(5)
tree = np.flatnonzero(base.forest.edge_mask)
dels = np.concatenate([rng.choice(tree, 12, replace=False),
                       rng.choice(ginc.num_edges, 12, replace=False)])
dels = np.stack([ginc.src[dels], ginc.dst[dels]], 1).astype(np.int64)
ins = np.stack([rng.integers(0, ginc.num_vertices, 30),
                rng.integers(0, ginc.num_vertices, 30),
                rng.random(30, dtype=np.float32) * 0.9 + 0.05], 1)
out["inc-ins"], out["inc-dels"] = ins, dels
batch = inc.EdgeBatch.make([tuple(r) for r in ins],
                           [tuple(r) for r in dels])
for name, S, knobs in spec["hybrid"]:
    mesh = make_mesh((S,), ("x",))
    res, st = minimum_spanning_forest(g, method="filter_boruvka",
                                      params=GHSParams(**knobs), mesh=mesh)
    out[f"fb-{name}-mask"] = np.asarray(res.edge_mask)
    meta[f"fb-{name}"] = dict(
        host_syncs=st.host_syncs, extra_syncs=st.extra_syncs,
        **{f: getattr(st, f) for f in spec["ledger"]})
    new, st = rapi.apply_updates(base, batch, params=GHSParams(**knobs),
                                 mesh=mesh)
    out[f"inc-{name}-mask"] = np.asarray(new.forest.edge_mask)
    meta[f"inc-{name}"] = dict(
        host_syncs=st.host_syncs, extra_syncs=st.extra_syncs,
        **{f: getattr(st, f) for f in spec["inc_ledger"]})

np.savez(sys.argv[1], meta=np.asarray(json.dumps(meta)), **out)
'''


def _run_reference(path: str) -> None:
    spec = dict(shards=SHARDS, pc_n=PC_N, pc_cases=PC_CASES,
                perm_graphs=PERM_GRAPHS, perm_shards=PERM_SHARDS,
                boruvka=BORUVKA, stats=STATS, hybrid=HYBRID, ledger=LEDGER,
                inc_ledger=INC_LEDGER)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", CHILD, path, json.dumps(spec)], env=env,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results, computed once for the module."""
    path = str(tmp_path_factory.mktemp("mesh_ref") / "ref.npz")
    _run_reference(path)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(str(data.pop("meta")))
    return data, meta


def _graph(data, meta, name) -> Graph:
    return Graph.from_arrays(data[f"{name}-src"], data[f"{name}-dst"],
                             data[f"{name}-w"], meta[f"{name}-n"])


def _norm(v):
    """JSON-comparable form of a stats value (tuples become lists)."""
    return json.loads(json.dumps(v))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _port_values(x: np.ndarray, dname: str, case: str):
    """The reference's uint words in the port's form, and the default."""
    if case.startswith("baseline"):
        return (torch.from_numpy(x.astype(np.int32)),
                torch.arange(x.shape[1], dtype=torch.int32))
    if dname == "u64":
        return torch.from_numpy(keys_lib.from_reference(x)), keys_lib.INF_KEY
    return (torch.from_numpy(keys_lib.from_reference32(x.astype(np.uint32))),
            keys_lib.INF32)


def _to_reference(t: torch.Tensor, dname: str, case: str) -> np.ndarray:
    if case.startswith("baseline"):
        return t.numpy().astype(np.uint64)
    if dname == "u64":
        return keys_lib.to_reference(t)
    return keys_lib.to_reference32(t).astype(np.uint64)


@pytest.mark.parametrize("case", PC_CASES)
@pytest.mark.parametrize("shards", SHARDS)
def test_pmin_compressed_equals_reference(ref, shards, case):
    data, meta = ref
    for dname in ("u64", "u32"):
        key = f"pc-{shards}-{dname}-{case}"
        if key not in meta:
            continue
        x, default = _port_values(data[key + "-x"], dname, case)
        got = collectives.pmin_compressed(x, default=default, cap=meta[key],
                                          num_shards=shards)
        got = _to_reference(got, dname, case)
        want = data[key + "-out"]
        for row in want:                      # every shard's result
            assert np.array_equal(got, row), key
        dense = _to_reference(collectives.pmin(x), dname, case)
        assert np.array_equal(got, dense), key


def test_wire_model_equals_reference(ref):
    _, meta = ref
    for cap, S, vb, want in meta["compressed_bytes"]:
        assert collectives.compressed_bytes(cap, S, vb) == want
    for n, S, vb, want in meta["dense_bytes"]:
        assert collectives.dense_bytes(n, S, vb) == want


def test_axis_collectives():
    """The stacked-axis counterparts of lax's collectives."""
    mesh = Mesh(3, "cpu")
    x = mesh.shard([torch.tensor([[1, 5], [2, 6], [3, 7]]) * (s + 1)
                    for s in range(3)])
    assert torch.equal(mesh.axis_index(), torch.arange(3, dtype=torch.int32))
    assert torch.equal(collectives.pmin(x), x[0])
    assert torch.equal(collectives.pmax(x), x[2])
    assert torch.equal(collectives.psum(x), x[0] * 6)
    y = collectives.all_to_all(x)          # y[d, s] = x[s, d]
    for s in range(3):
        for d in range(3):
            assert torch.equal(y[d, s], x[s, d])
    r = collectives.ppermute_ring(x)       # row i -> row i + 1
    assert torch.equal(r[1], x[0]) and torch.equal(r[0], x[2])
    with pytest.raises(ValueError, match="collective"):
        collectives.resolve_collective("ring")
    with pytest.raises(ValueError, match="parts"):
        mesh.shard([torch.zeros(2)])
    with pytest.raises(ValueError, match="at least one"):
        Mesh(0, "cpu")


# ---------------------------------------------------------------------------
# Vertex partitioners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gname", list(PERM_GRAPHS))
def test_vertex_perm_and_relabel_equal_reference(ref, gname):
    data, meta = ref
    g = _graph(data, meta, f"g-{gname}")
    for S in PERM_SHARDS:
        block = -(-g.num_vertices // S)
        for name in ("block", "hashed", "balanced"):
            got = partition.get_partitioner(name).vertex_perm(g, S)
            assert np.array_equal(got, data[f"perm-{gname}-{S}-{name}"]), \
                (S, name)
            assert np.array_equal(np.sort(got), np.arange(g.num_vertices))
            assert np.bincount(got // block).max() <= block
        rg = partition.relabel_graph(g, data[f"perm-{gname}-{S}-hashed"])
        assert np.array_equal(rg.src, data[f"relabel-{gname}-{S}-src"])
        assert np.array_equal(rg.dst, data[f"relabel-{gname}-{S}-dst"])
        assert np.array_equal(rg.weight, g.weight)


# ---------------------------------------------------------------------------
# Borůvka over a mesh
# ---------------------------------------------------------------------------

def _assert_solve(data, meta, name, got, st, graph):
    want = meta[f"bv-{name}"]
    assert np.array_equal(got.edge_mask, data[f"bv-{name}-mask"]), name
    assert (got.total_weight, got.num_components, got.num_tree_edges) == (
        want["total_weight"], want["num_components"],
        want["num_tree_edges"]), name
    for field in STATS:
        assert _norm(getattr(st, field)) == want[field], (name, field)
    assert st.host_syncs == st.intervals + st.extra_syncs
    assert np.array_equal(got.edge_mask, kruskal_ref.kruskal(graph).edge_mask)


@pytest.mark.parametrize("name,shards,knobs", BORUVKA,
                         ids=[c[0] for c in BORUVKA])
def test_boruvka_mesh_equals_reference(ref, name, shards, knobs):
    data, meta = ref
    g = _graph(data, meta, "rmat9")
    got, st = mst_api.minimum_spanning_forest(
        g, method="boruvka", params=GHSParams(**knobs),
        mesh=Mesh(shards, "cpu"))
    _assert_solve(data, meta, name, got, st, g)
    if knobs.get("round_loop") != "host":
        assert st.host_syncs == st.intervals + 1
        if shards > 1:
            assert st.comm_bytes > 0
        if shards > 1 and knobs.get("collective") == "compressed":
            assert "compressed" in [c[0] for c in st.comm_history], name


@pytest.mark.parametrize("shards", (2, 4))
def test_device_edges_under_mesh_equal_reference(ref, shards):
    data, meta = ref
    spec = pipeline.GraphSpec("rmat", 9, seed=4)
    dev = pipeline.build(spec, device="cpu")
    got, st = mst_api.minimum_spanning_forest(
        dev, method="boruvka", params=GHSParams(collective="compressed"),
        mesh=Mesh(shards, "cpu"))
    _assert_solve(data, meta, f"pipe-s{shards}", got, st,
                  _graph(data, meta, "pipe"))
    assert st.edge_staging == "device"


@pytest.mark.parametrize("shards", (2, 4))
def test_pipeline_mesh_build_equals_reference(ref, shards):
    data, meta = ref
    dev = pipeline.build(pipeline.GraphSpec("rmat", 9, seed=4),
                         mesh=Mesh(shards, "cpu"))
    name = f"pipemesh-s{shards}"
    assert dev.num_edges == meta[name + "-m"]
    assert np.array_equal(dev.src.numpy(), data[name + "-src"])
    assert np.array_equal(dev.dst.numpy(), data[name + "-dst"])
    assert np.array_equal(keys_lib.to_reference(dev.key), data[name + "-key"])
    got, st = mst_api.minimum_spanning_forest(dev, method="boruvka",
                                              mesh=Mesh(shards, "cpu"))
    _assert_solve(data, meta, name, got, st, _graph(data, meta, "pipe"))
    assert st.edge_staging == "device"


def _assert_ledger(st, want, fields, ctx):
    for field in fields:
        assert _norm(getattr(st, field)) == want[field], (ctx, field)
    assert st.host_syncs == want["host_syncs"] + st.label_syncs, ctx
    assert st.extra_syncs == want["extra_syncs"] + st.label_syncs, ctx


@pytest.mark.parametrize("name,shards,knobs", HYBRID,
                         ids=[c[0] for c in HYBRID])
def test_filter_boruvka_mesh_equals_reference(ref, name, shards, knobs):
    data, meta = ref
    g = _graph(data, meta, "rmat9")
    got, st = mst_api.minimum_spanning_forest(
        g, method="filter_boruvka", params=GHSParams(**knobs),
        mesh=Mesh(shards, "cpu"))
    assert np.array_equal(got.edge_mask, data[f"fb-{name}-mask"])
    _assert_ledger(st, meta[f"fb-{name}"], LEDGER, name)
    assert st.label_syncs > 0


@pytest.mark.parametrize("name,shards,knobs", HYBRID,
                         ids=[c[0] for c in HYBRID])
def test_incremental_update_mesh_equals_reference(ref, name, shards, knobs):
    from repro_torch.core.incremental import EdgeBatch
    data, meta = ref
    g = _graph(data, meta, "inc")
    base, _ = mst_api.incremental_forest(g, device="cpu")
    batch = EdgeBatch.make([tuple(r) for r in data["inc-ins"]],
                           [tuple(r) for r in data["inc-dels"]])
    new, st = mst_api.apply_updates(base, batch, params=GHSParams(**knobs),
                                    mesh=Mesh(shards, "cpu"))
    assert np.array_equal(new.forest.edge_mask, data[f"inc-{name}-mask"])
    _assert_ledger(st, meta[f"inc-{name}"], INC_LEDGER, name)
    fresh, _ = mst_api.minimum_spanning_forest(new.graph, device="cpu")
    assert np.array_equal(new.forest.edge_mask, fresh.edge_mask)


def test_connected_labels_over_shards_equal_one_shard():
    """The label loop over (S, B) shard rows gives the one-shard labels,
    and the same max keys, under both collectives."""
    from repro_torch.kernels.spmv_minplus import ops as minplus_ops
    rng = np.random.default_rng(3)
    n, m = 300, 400
    src = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    key = torch.from_numpy(keys_lib.from_reference(
        rng.integers(1, 1 << 62, m, dtype=np.uint64)))
    active = torch.from_numpy(rng.random(m) < 0.5)
    want = minplus_ops.component_maxkey(src, dst, key, active,
                                        num_vertices=n)
    for S, coll, cap in ((4, "pmin", None), (4, "compressed", 256),
                         (8, "compressed", 8)):
        got = minplus_ops.component_maxkey(
            src.view(S, -1), dst.view(S, -1), key.view(S, -1),
            active.view(S, -1), num_vertices=n, collective=coll,
            cand_cap=cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mesh_arguments():
    g = _graph_small()
    with pytest.raises(TypeError, match="Mesh"):
        mst_api.minimum_spanning_forest(g, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="differs"):
        mst_api.minimum_spanning_forest(g, device="cuda",
                                        mesh=Mesh(2, "cpu"))
    got, _ = mst_api.minimum_spanning_forest(g, device="cpu",
                                             mesh=Mesh(2, "cpu"))
    assert np.array_equal(got.edge_mask, kruskal_ref.kruskal(g).edge_mask)


def _graph_small() -> Graph:
    from repro_torch.core import generators
    return generators.rmat(5, seed=0)


# ---------------------------------------------------------------------------
# On the card: the election kernels over S offset shards, and the engine
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never while the module imports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shards", (2, 4, 8))
def test_gpu_k1_k2_over_offset_shards_equal_plain(cuda, shards):
    """One K1 (segment_min64) and one K2 (the masked election) launch over
    S shards' rows, each shard's segments offset by s·n, equal the plain
    versions on the CPU bit for bit."""
    from repro_torch import kernels
    from repro_torch.kernels.segment_min import ops as segops
    from repro_torch.kernels.spmv_minplus import ops as spmv_ops
    rng = np.random.default_rng(shards)
    n, block = 1000, 4096
    cs = torch.from_numpy(rng.integers(0, n, (shards, block)).astype(np.int32))
    cd = torch.from_numpy(rng.integers(0, n, (shards, block)).astype(np.int32))
    key = torch.from_numpy(keys_lib.from_reference(
        rng.integers(0, 1 << 62, (shards, block), dtype=np.uint64)))
    key[:, -7:] = keys_lib.INF_KEY                    # padding slots
    off = (torch.arange(shards, dtype=torch.int32) * n)[:, None]
    seg = torch.cat([cs + off, cd + off], 1).view(-1)
    kk = torch.cat([key, key], 1).view(-1)
    want1 = segops.segment_min64(kk, seg, num_segments=shards * n)
    want2 = spmv_ops.elect((cs + off).view(-1), (cd + off).view(-1),
                           key.view(-1), num_segments=shards * n)
    kernels.reset_launches()
    got1 = segops.segment_min64(kk.to(cuda), seg.to(cuda),
                                num_segments=shards * n, use_pallas=True)
    got2 = spmv_ops.elect((cs + off).view(-1).to(cuda),
                          (cd + off).view(-1).to(cuda), key.view(-1).to(cuda),
                          num_segments=shards * n, lowering="pallas")
    torch.cuda.synchronize()
    assert torch.equal(got1.cpu(), want1)
    assert torch.equal(got2.cpu(), want2)
    assert kernels.LAUNCHES["segmented_min2_scan"] == 1
    assert kernels.LAUNCHES["masked_minplus_scan"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [
    dict(round_kernel="xla", collective="compressed"),
    dict(round_kernel="pallas", collective="compressed"),
    dict(round_kernel="pallas", collective="pmin", partitioner="hashed"),
    dict(round_loop="host")])
def test_gpu_boruvka_mesh_equals_cpu_and_launches(cuda, knobs):
    from repro_torch import kernels
    from repro_torch.core import generators
    g = generators.rmat(11, seed=3)
    params = GHSParams(use_pallas=True, check_frequency=2, **knobs)
    want, wst = mst_api.minimum_spanning_forest(g, params=params,
                                                mesh=Mesh(4, "cpu"))
    kernels.reset_launches()
    got, st = mst_api.minimum_spanning_forest(g, params=params,
                                              mesh=Mesh(4, cuda))
    assert np.array_equal(got.edge_mask, want.edge_mask)
    for field in STATS:
        assert getattr(st, field) == getattr(wst, field), field
    if knobs.get("round_loop") == "host":
        assert kernels.LAUNCHES["segmented_min_scan"] == 4 * st.rounds
    elif knobs["round_kernel"] == "xla":
        assert kernels.LAUNCHES["segmented_min2_scan"] > 0
    else:
        assert kernels.LAUNCHES["masked_minplus_scan"] > 0
        assert kernels.LAUNCHES["pointer_jump"] > 0
