"""The port's paper-faithful GHS engine over a mesh held against the JAX
package's, on the CPU: rmat-6 (seed 9) on 2 and 4 shards, under the seven
ablations of ``tests/test_distributed.py`` (FIFO and relaxed Test queue,
raw and packed messages, hash, linear and binary lookup), the three vertex
partitioners and both round loops.  The forest, the superstep and
interval counts, the host syncs, every message counter, ``sent_remote``,
``bytes_remote`` and both histories equal the reference's.  A cross-shard
star overflows a small ring on both drivers and raises, naming the flag
and the knob.

The reference runs once for the module, in one subprocess with 8 forced
host devices (``XLA_FLAGS`` set before JAX starts) and the
``jax.experimental.enable_x64`` name installed before ``repro`` is
imported; it compiles one interval function a setting, four at a time,
and writes its results to an ``.npz`` that the tests read.  Tolerance:
exact equality.  Cases marked ``gpu`` hold the S-block interval kernel
against its plain version on the card after every interval."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import ghs_message, ghs_state, kruskal_ref, mst_api
from repro_torch.core import generators
from repro_torch.core.graph import Graph, preprocess
from repro_torch.core.params import GHSParams
from repro_torch.kernels.ghs_superstep import ghs_superstep
from repro_torch.kernels.ghs_superstep import ref as step_ref
from repro_torch.sharding.mesh import Mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# The seven ablations of tests/test_distributed.py:97-105.
ABLATIONS = {
    "fifo": dict(relaxed_test_queue=False),
    "relaxed": dict(relaxed_test_queue=True),
    "raw": dict(compress_messages=False),
    "packed": dict(compress_messages=True),
    "hash": dict(use_hashing=True),
    "linear": dict(use_hashing=False),
    "binary": dict(use_hashing=False, hash_table_factor=-1.0),
}
# (name, shards, knobs); "relaxed", "packed" and "hash" are the defaults,
# so one solve each shard count stands for all three.
CASES = [(f"s2-{a}", 2, k) for a, k in ABLATIONS.items()
         if a not in ("relaxed", "packed", "hash")] + [
    ("s2-default", 2, {}),
    ("s2-hashed", 2, dict(partitioner="hashed")),
    ("s2-balanced", 2, dict(partitioner="balanced")),
    ("s2-host", 2, dict(round_loop="host")),
    ("s4-default", 4, {}),
    ("s4-fifo", 4, ABLATIONS["fifo"]),
    ("s4-hashed", 4, dict(partitioner="hashed")),
    ("s4-balanced-host", 4, dict(partitioner="balanced",
                                 round_loop="host")),
]
ALIASES = {f"s{S}-{a}": f"s{S}-default" for S in (2, 4)
           for a in ("relaxed", "packed", "hash")}

FIELDS = ("supersteps", "intervals", "host_syncs", "extra_syncs",
          "overlapped_syncs", "speculative_intervals", "processed",
          "productive", "sent_local", "sent_remote", "halted_fragments",
          "bytes_remote", "queue_history", "bytes_history")

CHILD = r'''
import json, sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from repro.compat import make_mesh
from repro.core import generators
from repro.core.ghs_message import minimum_spanning_forest
from repro.core.params import GHSParams

spec = json.loads(sys.argv[2])
g = generators.generate("rmat", 6, seed=9)
out = dict(src=g.src, dst=g.dst, w=g.weight)
meta = dict(n=g.num_vertices)
meshes = {S: make_mesh((S,), ("x",)) for S in (2, 4)}

def solve(case):
    name, S, knobs = case
    res, st = minimum_spanning_forest(g, params=GHSParams(**knobs),
                                      mesh=meshes[S], collect_history=True)
    return name, res, st

with ThreadPoolExecutor(4) as pool:
    for name, res, st in pool.map(solve, spec["cases"]):
        out[name] = np.asarray(res.edge_mask)
        meta[name] = dict(total_weight=float(res.total_weight),
                          **{f: getattr(st, f) for f in spec["fields"]})
np.savez(sys.argv[1], meta=np.asarray(json.dumps(meta)), **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's solves, computed once for the module."""
    path = str(tmp_path_factory.mktemp("mesh_ghs_ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    spec = dict(cases=CASES, fields=FIELDS)
    out = subprocess.run(
        [sys.executable, "-c", CHILD, path, json.dumps(spec)], env=env,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(str(data.pop("meta")))
    graph = Graph.from_arrays(data["src"], data["dst"], data["w"], meta["n"])
    return data, meta, graph


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never while the module imports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _norm(v):
    return json.loads(json.dumps(v))


@pytest.mark.parametrize("name,shards,knobs",
                         CASES + [(a, int(a[1]), ABLATIONS[a[3:]])
                                  for a in ALIASES],
                         ids=[c[0] for c in CASES] + list(ALIASES))
def test_ghs_mesh_equals_reference(ref, name, shards, knobs):
    data, meta, g = ref
    want_name = ALIASES.get(name, name)
    want = meta[want_name]
    got, st = mst_api.minimum_spanning_forest(
        g, method="ghs", params=GHSParams(**knobs), collect_history=True,
        mesh=Mesh(shards, "cpu"))
    assert np.array_equal(got.edge_mask, data[want_name]), name
    assert np.array_equal(got.edge_mask, kruskal_ref.kruskal(g).edge_mask)
    assert got.total_weight == want["total_weight"]
    for field in FIELDS:
        assert _norm(getattr(st, field)) == want[field], (name, field)
    assert st.sent_remote > 0
    assert st.host_syncs == st.intervals + 1
    if knobs.get("round_loop") == "host":
        assert st.intervals == st.supersteps


def _star(n: int = 256) -> Graph:
    """tests/test_distributed.py:141-147: a star whose center's rings fill
    from the other shard."""
    rng = np.random.default_rng(0)
    w = rng.random(n - 1, dtype=np.float32) * 0.9 + 0.05
    return preprocess(np.zeros(n - 1, np.int64),
                      np.arange(1, n, dtype=np.int64), w, n)


@pytest.mark.parametrize("loop", ["device", "host"])
def test_cross_shard_queue_overflow_raises(loop):
    g = _star()
    mesh = Mesh(2, "cpu")
    with pytest.raises(RuntimeError) as err:
        ghs_message.minimum_spanning_forest(
            g, GHSParams(queue_capacity=160, round_loop=loop), mesh=mesh)
    msg = str(err.value)
    assert "error flags" in msg and "ERR_QUEUE_OVERFLOW" in msg
    assert "queue_capacity" in msg
    got, _ = ghs_message.minimum_spanning_forest(
        g, GHSParams(round_loop=loop), mesh=mesh)
    assert np.array_equal(got.edge_mask, kruskal_ref.kruskal(g).edge_mask)


def test_stacked_state_and_plain_interval():
    """One stacked upload holds every shard's arrays; the plain interval
    over a stacked state of one shard equals it over the unstacked one."""
    g = generators.rmat(6, seed=1)
    params = GHSParams()
    topo, shards = ghs_state.host_shards(g, 3, params, history_capacity=9)
    state = ghs_state.upload_stacked(shards, "cpu")
    got = ghs_state.host_arrays(state)
    for field in ghs_state.ShardState._fields:
        for s in range(3):
            assert np.array_equal(got[field][s], shards[s][field]), field
    topo1, one = ghs_state.host_shards(g, 1, params, history_capacity=9)
    a = ghs_state.upload(one[0], "cpu")
    b = ghs_state.upload_stacked(one, "cpu")
    cfg = step_ref.config(topo1, params)
    scal = torch.zeros(3, dtype=torch.int32)
    for _ in range(4):
        sa = ghs_superstep.interval(a, scal, 5, cfg)
        sb = ghs_superstep.interval(b, scal, 5, cfg)
        assert sa.tolist() == sb.tolist()
        scal = sa
    ha, hb = ghs_state.host_arrays(a), ghs_state.host_arrays(b)
    for field in ghs_state.ShardState._fields:
        assert np.array_equal(ha[field], hb[field][0]), field


# ---------------------------------------------------------------------------
# On the card: the S-block interval kernel against its plain version
# ---------------------------------------------------------------------------

def _lockstep(cuda, shards: list, topo, params, ctx):
    """Run the kernel on the card and the plain version on the CPU from the
    same stacked state, one interval at a time, until silence or an error;
    every state array of every shard and the scalar vector equal after
    each interval.  Returns the number of intervals."""
    cfg = step_ref.config(topo, params)
    cpu = ghs_state.upload_stacked(shards, "cpu")
    card = ghs_state.upload_stacked(shards, cuda)
    n_steps = 1 if params.round_loop == "host" else cfg.check
    scal_c = torch.zeros(3, dtype=torch.int32)
    scal_g = scal_c.to(cuda)
    for k in range(10_000):
        before = kernels.LAUNCHES["ghs_superstep"]
        scal_g = ghs_superstep.interval(card, scal_g, n_steps, cfg)
        scal_c = ghs_superstep.interval(cpu, scal_c, n_steps, cfg)
        assert kernels.LAUNCHES["ghs_superstep"] == before + 1
        torch.cuda.synchronize()
        assert scal_g.cpu().tolist() == scal_c.tolist(), (ctx, k)
        want = ghs_state.host_arrays(cpu)
        got = ghs_state.host_arrays(card)
        for field in ghs_state.ShardState._fields:
            assert np.array_equal(got[field], want[field]), (ctx, k, field)
        _, silent, err = scal_c.tolist()
        if err or silent >= cfg.empty_needed:
            return k + 1
    raise AssertionError(f"{ctx}: no silence")


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("knobs", [{}, dict(round_loop="host"),
                                   ABLATIONS["fifo"], ABLATIONS["raw"],
                                   ABLATIONS["binary"],
                                   dict(partitioner="hashed")])
def test_gpu_mesh_kernel_equals_plain_after_every_interval(cuda, shards,
                                                           knobs):
    from repro_torch.core import runtime
    g = runtime.vertex_partitioned(generators.rmat(8, seed=8),
                                   knobs.get("partitioner", "block"), shards)
    params = GHSParams(**knobs)
    topo, host = ghs_state.host_shards(g, shards, params,
                                       history_capacity=4096)
    assert _lockstep(cuda, host, topo, params, (shards, knobs)) > 1


# The hub graph of tests/test_torch_ghs.py: rmat-10 at degree 32, hubs of
# degree up to 489, no multiple of 32, so the warp-wide scans run over
# several ragged windows in every shard that holds a hub.
def _hub_graph():
    return generators.rmat(10, 32, seed=20)


@pytest.mark.parametrize("shards", [2, 4])
def test_hub_graph_mesh_plain_equals_kruskal(shards):
    """The plain S-shard interval over the hub graph: the forest equals
    Kruskal's, messages cross shards, and every shard holds a hub of
    degree above 100."""
    g = _hub_graph()
    _, host = ghs_state.host_shards(g, shards, GHSParams())
    for arrays in host:
        assert (np.diff(arrays["indptr"]) > 100).any()
    got, st = ghs_message.minimum_spanning_forest(g, mesh=Mesh(shards, "cpu"))
    assert np.array_equal(got.edge_mask, kruskal_ref.kruskal(g).edge_mask)
    assert st.sent_remote > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("knobs", [{}, dict(relaxed_test_queue=False,
                                            compress_messages=False,
                                            use_hashing=False)])
def test_gpu_mesh_kernel_equals_plain_on_hub_scans(cuda, shards, knobs):
    params = GHSParams(**knobs)
    topo, host = ghs_state.host_shards(_hub_graph(), shards, params,
                                       history_capacity=4096)
    assert _lockstep(cuda, host, topo, params, (shards, knobs)) > 1


@pytest.mark.gpu
def test_gpu_mesh_solve_equals_cpu_and_launches(cuda):
    g = generators.rmat(9, seed=4)
    for loop in ("device", "host"):
        params = GHSParams(round_loop=loop)
        want, wst = ghs_message.minimum_spanning_forest(
            g, params, collect_history=True, mesh=Mesh(4, "cpu"))
        kernels.reset_launches()
        got, st = ghs_message.minimum_spanning_forest(
            g, params, collect_history=True, mesh=Mesh(4, cuda))
        assert np.array_equal(got.edge_mask, want.edge_mask)
        for field in FIELDS:
            assert getattr(st, field) == getattr(wst, field), field
        want_launches = (st.supersteps if loop == "host"
                         else st.intervals + st.speculative_intervals)
        assert kernels.LAUNCHES["ghs_superstep"] == want_launches


@pytest.mark.gpu
def test_gpu_too_many_shards_for_one_grid_raise(cuda):
    """An S past the card's co-resident blocks raises before any launch
    (a state of S tiny shards: one vertex, one slot a ring)."""
    cfg = step_ref.Config(block=1, qcap=1, ocap=1, xcap=1, tsize=1, lanes=5,
                          method="hash", relaxed=True, check=1,
                          empty_needed=1)
    S = ghs_superstep.capacity(cfg, 2048, cuda) + 1
    assert ghs_superstep.capacity(cfg, S, cuda) < S
    shapes = dict(indptr=(2,), mq=(1, 5), tq=(1, 5), og=(S, 1, 5),
                  inbox=(S, 1, 5), og_head=(S,), og_tail=(S,), in_cnt=(S,),
                  mq_head=(), mq_tail=(), tq_head=(), tq_tail=(), err=(),
                  halted=(), n_processed=(), n_productive=(),
                  n_sent_remote=(), n_sent_local=())
    state = ghs_state.ShardState(*[
        torch.zeros((S,) + shapes.get(f, (1,)), dtype=torch.int32,
                    device=cuda) for f in ghs_state.ShardState._fields])
    before = kernels.LAUNCHES["ghs_superstep"]
    with pytest.raises(RuntimeError, match="co-resident"):
        ghs_superstep.interval(state, torch.zeros(3, dtype=torch.int32,
                                                  device=cuda), 1, cfg)
    assert kernels.LAUNCHES["ghs_superstep"] == before
