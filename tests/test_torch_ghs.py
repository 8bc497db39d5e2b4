"""The port's paper-faithful GHS engine held against the JAX package's, on
the cases of ``tests/test_mst_correctness.py`` (rmat and ``disconnected``
at scale 7, the five ablation settings, the tie-weight graph) and on both
round loops and silence streaks of 1 and 4: the forest, every counter and
both histories equal the reference's bit for bit.  ``init_shards`` gives
the reference's arrays; forced states (messages in the inbox, a full Test
ring, an edge the table lacks) give the reference's state after an
interval, error flags and messages included.  Cases marked ``gpu`` hold
the interval kernel against its plain version on the card."""
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import ghs_message, ghs_state, kruskal_ref, mst_api
from repro_torch.core import generators
from repro_torch.core.graph import Graph
from repro_torch.core.params import GHSParams
from repro_torch.kernels.ghs_superstep import ghs_superstep
from repro_torch.kernels.ghs_superstep import ref as step_ref

FIELDS = ("supersteps", "intervals", "host_syncs", "extra_syncs",
          "overlapped_syncs", "speculative_intervals", "processed",
          "productive", "sent_local", "sent_remote", "halted_fragments",
          "bytes_remote", "queue_history", "bytes_history")

# The five ablation settings of tests/test_mst_correctness.py:37-50.
ABLATIONS = {
    "base": dict(use_hashing=False, relaxed_test_queue=False,
                 compress_messages=False),
    "binary": dict(use_hashing=False, hash_table_factor=-1.0,
                   relaxed_test_queue=False),
    "check1": dict(relaxed_test_queue=True, check_frequency=1),
    "check7": dict(relaxed_test_queue=True, check_frequency=7),
    "final": dict(),
}

CASES = {
    **{f"rmat7-{k}": ("rmat7", v) for k, v in ABLATIONS.items()},
    "disconnected7": ("disconnected7", {}),
    "rmat7-empty4": ("rmat7", dict(empty_iter_cnt_to_break=4)),
    "rmat7-host-empty4": ("rmat7", dict(round_loop="host",
                                        empty_iter_cnt_to_break=4)),
    "ties": ("ties", {}),
}


def _repro_modules():
    return {k: v for k, v in sys.modules.items()
            if k == "repro" or k.startswith("repro.")}


@pytest.fixture(scope="module")
def ref():
    """The JAX package, imported for this module only (the
    ``jax.experimental.enable_x64`` name is installed for the import and
    removed again with the ``repro`` modules on teardown).  ``solve``
    memoizes the reference's solves for the module."""
    import jax
    import jax.experimental
    saved = _repro_modules()
    shimmed = not hasattr(jax.experimental, "enable_x64")
    if shimmed:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        import jax.numpy as jnp
        from repro.core import generators as rgen, ghs_message as rghs
        from repro.core import ghs_state as rstate
        from repro.core.graph import preprocess as rpre
        from repro.core.params import GHSParams as RParams
        graphs = {
            "rmat7": rgen.generate("rmat", 7, seed=9),
            "disconnected7": rgen.generate("disconnected", 7, seed=3),
            "ties": rpre(*_tie_arrays(), 128),
        }
        memo = {}

        def solve(case):
            if case not in memo:
                gname, knobs = CASES[case]
                memo[case] = rghs.minimum_spanning_forest(
                    graphs[gname], RParams(**knobs), collect_history=True)
            return memo[case]

        yield types.SimpleNamespace(
            ghs=rghs, state=rstate, params=RParams, graphs=graphs,
            solve=solve, jnp=jnp, jax=jax)
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


def _tie_arrays():
    """tests/test_mst_correctness.py:53-67: three weights, many ties."""
    rng = np.random.default_rng(0)
    n, m = 128, 1024
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.choice(np.asarray([0.25, 0.5, 0.75], np.float32), m)
    return src, dst, w


def _port(g) -> Graph:
    return Graph.from_arrays(g.src, g.dst, g.weight, g.num_vertices)


def _assert_forest(got, want, ctx=None):
    assert np.array_equal(got.edge_mask, want.edge_mask), ctx
    assert (got.total_weight, got.num_components, got.num_tree_edges) == \
        (want.total_weight, want.num_components, want.num_tree_edges), ctx


@pytest.mark.parametrize("case", list(CASES))
def test_forest_counters_and_histories_equal_reference(ref, case):
    gname, knobs = CASES[case]
    want, wst = ref.solve(case)
    g = _port(ref.graphs[gname])
    got, st = mst_api.minimum_spanning_forest(
        g, method="ghs", params=GHSParams(**knobs), collect_history=True,
        device="cpu")
    _assert_forest(got, want, case)
    _assert_forest(got, kruskal_ref.kruskal(g), case)
    for field in FIELDS:
        assert getattr(st, field) == getattr(wst, field), (case, field)
    assert st.halted_fragments >= 1
    assert len(st.queue_history) == st.supersteps
    if knobs.get("round_loop") == "host":
        assert st.intervals == st.supersteps
    assert st.host_syncs == st.intervals + 1


def test_history_off_and_sequential_intervals(ref):
    """Without history the histories are empty and nothing else moves;
    ``interval_pipeline=0`` gives the same forest and counters with no
    overlapped or speculative intervals."""
    g = _port(ref.graphs["rmat7"])
    want, wst = ref.solve("rmat7-final")
    got, st = ghs_message.minimum_spanning_forest(g, device="cpu")
    _assert_forest(got, want)
    assert (st.queue_history, st.bytes_history) == ((), ())
    for field in FIELDS[:-2]:
        assert getattr(st, field) == getattr(wst, field), field
    seq, sst = ghs_message.minimum_spanning_forest(
        g, GHSParams(interval_pipeline=0), device="cpu",
        collect_history=True)
    _assert_forest(seq, want)
    assert (sst.overlapped_syncs, sst.speculative_intervals) == (0, 0)
    for field in FIELDS:
        if field not in ("overlapped_syncs", "speculative_intervals"):
            assert getattr(sst, field) == getattr(wst, field), field


@pytest.mark.parametrize("knobs", [{}, ABLATIONS["base"],
                                   dict(queue_capacity=5000)])
def test_init_shards_equal_reference(ref, knobs):
    rg = ref.graphs["rmat7"]
    g = _port(rg)
    wtopo, wshards = ref.state.init_shards(rg, 1, ref.params(**knobs),
                                           history_capacity=7)
    topo, shards = ghs_state.init_shards(g, 1, GHSParams(**knobs),
                                         history_capacity=7, device="cpu")
    assert dataclasses.asdict(topo) == dataclasses.asdict(wtopo)
    got = ghs_state.host_arrays(shards[0])
    for field in ghs_state.ShardState._fields:
        want = np.asarray(getattr(wshards[0], field))
        assert got[field].dtype == want.dtype, field
        assert got[field].shape == want.shape, field
        assert np.array_equal(got[field], want), field
    # The flipped int64 keys sort the windows as the reference's uint64
    # keys do.
    ends, _, geid = ghs_state.graph_lib.both_direction_arrays(g)
    want_order = np.lexsort((rg.packed_keys[geid], ends))
    assert rg.packed_keys.dtype == np.uint64
    assert np.array_equal(np.lexsort((g.packed_keys[geid], ends)),
                          want_order)


def test_init_overflow_raises_like_reference(ref):
    rg = ref.graphs["rmat7"]
    knobs = dict(queue_capacity=64)
    with pytest.raises(RuntimeError) as want:
        ref.ghs.minimum_spanning_forest(rg, ref.params(**knobs))
    with pytest.raises(RuntimeError) as got:
        ghs_message.minimum_spanning_forest(_port(rg), GHSParams(**knobs),
                                            device="cpu")
    assert str(got.value) == str(want.value)
    assert "queue_capacity=64" in str(got.value)


def test_error_messages_equal_reference(ref):
    for err in range(1, 8):
        with pytest.raises(RuntimeError) as want:
            ref.ghs._raise_on_err(err)
        with pytest.raises(RuntimeError) as got:
            ghs_message._raise_on_err(err)
        assert str(got.value) == str(want.value)
    ghs_message._raise_on_err(0)


# ---------------------------------------------------------------------------
# Forced states: one interval of the reference's interval function against
# the port's, every array compared
# ---------------------------------------------------------------------------

def _force(arrays: dict, kind: str, topo) -> None:
    """Edit one shard's numpy arrays in place (both packages get the same
    edit)."""
    mq = arrays["mq"]
    dst = 2 if topo.lanes == 5 else 4            # the lane of a message's dst
    if kind == "inbox":
        # Three wake-up Connects and a Test over a real edge arrive in the
        # inbox; the ring keeps the rest.
        lanes = topo.lanes
        lv = int(mq[1, dst])                     # the second Connect's dst
        a = int(arrays["indptr"][lv])
        u = int(arrays["nbr"][a + 1 if arrays["indptr"][lv + 1] > a + 1
                               else a])
        test = ghs_state.encode_messages(lanes, ghs_state.TEST, 0, 0,
                                         np.uint32(u), np.uint32(lv), 0, 0)
        arrays["inbox"][0, :3] = mq[:3]
        arrays["inbox"][0, 3] = test[0]
        arrays["in_cnt"][0] = 4
        arrays["mq_head"] = np.int32(3)
    elif kind == "full_test_ring":
        # The Test ring is full of Connect(0) messages from a vertex to
        # itself, so the first Test pushed overflows it.
        arrays["tq_tail"] = np.int32(topo.qcap)
        arrays["tq"][:] = mq[0]
    elif kind == "miss":
        # A Connect from a vertex that is no neighbor of its receiver.
        lv = int(mq[0, dst])
        nbrs = set(arrays["nbr"][arrays["indptr"][lv]:
                                 arrays["indptr"][lv + 1]].tolist())
        u = next(x for x in range(topo.num_vertices)
                 if x not in nbrs and x != lv)
        msg = ghs_state.encode_messages(topo.lanes, ghs_state.CONNECT, 0, 0,
                                        np.uint32(u), np.uint32(lv), 0, 0)
        arrays["inbox"][0, 0] = msg[0]
        arrays["in_cnt"][0] = 1
    else:
        raise ValueError(kind)


FORCED = [("inbox", {}), ("inbox", ABLATIONS["base"]),
          ("full_test_ring", {}), ("miss", {}), ("miss", ABLATIONS["binary"])]


@pytest.mark.parametrize("kind,knobs", FORCED)
def test_forced_interval_equals_reference(ref, kind, knobs):
    rg = ref.graphs["rmat7"]
    rparams, params = ref.params(**knobs), GHSParams(**knobs)
    # The solves' history capacity, so the reference reuses their compiled
    # interval function.
    hcap = 40 * rg.num_vertices + 2000
    wtopo, wshards = ref.state.init_shards(rg, 1, rparams,
                                           history_capacity=hcap)
    warrays = wshards[0]._asdict()
    _force(warrays, kind, wtopo)
    wshard = type(wshards[0])(**warrays)
    fn = ref.ghs._build_interval_fn(wtopo, rparams, None)
    wst, wscal = fn(ref.jax.tree.map(ref.jnp.asarray, wshard),
                    np.int32(0), np.int32(0), np.int32(3))
    wscal = [int(x) for x in np.asarray(wscal)]

    topo, shards = ghs_state.host_shards(_port(rg), 1, params,
                                         history_capacity=hcap)
    arrays = shards[0]
    _force(arrays, kind, topo)
    state = ghs_state.upload(arrays, "cpu")
    cfg = step_ref.config(topo, params)
    scal = ghs_superstep.interval(state, torch.zeros(3, dtype=torch.int32),
                                  3, cfg).tolist()
    assert scal == wscal, kind
    got = ghs_state.host_arrays(state)
    for field in ghs_state.ShardState._fields:
        assert np.array_equal(got[field], np.asarray(getattr(wst, field))), \
            (kind, field)
    want_flag = dict(inbox=0, full_test_ring=ghs_message.ERR_QUEUE_OVERFLOW,
                     miss=ghs_message.ERR_HASH_MISS)[kind]
    assert scal[2] == want_flag
    if kind == "inbox":
        assert int(got["n_processed"]) > 0


def test_resolve_batch_equals_reference(ref):
    """The ingest pre-pass: hits, misses, invalid lanes, a probe cap below
    the longest chain."""
    from repro.kernels.edge_hash import ops as rops
    from repro_torch.kernels.edge_hash import ops
    rng = np.random.default_rng(7)
    n, m, tsize = 64, 400, 449
    lv = rng.integers(0, n, m).astype(np.int32)
    u = rng.integers(0, n, m).astype(np.int32)
    table = ops.build_table(lv, u, np.arange(m, dtype=np.int32), tsize)
    q_lv = np.concatenate([lv, rng.integers(0, n, 200)]).astype(np.int32)
    q_u = np.concatenate([u, rng.integers(n, 2 * n, 200)]).astype(np.int32)
    valid = rng.random(q_lv.shape[0]) < 0.8
    for probes in (64, 3):
        want = rops.resolve_batch(*(ref.jnp.asarray(t) for t in table),
                                  ref.jnp.asarray(q_lv),
                                  ref.jnp.asarray(q_u),
                                  ref.jnp.asarray(valid), max_probes=probes)
        got = ops.resolve_batch(*(torch.from_numpy(t) for t in table),
                                torch.from_numpy(q_lv), torch.from_numpy(q_u),
                                torch.from_numpy(valid), max_probes=probes)
        assert np.array_equal(got.numpy(), np.asarray(want)), probes
        assert (got.numpy()[~valid] == -1).all()


def test_unported_knobs_raise():
    g = generators.rmat(5, seed=0)
    with pytest.raises(NotImplementedError, match="item 13"):
        ghs_message.minimum_spanning_forest(g, mesh=object(), device="cpu")
    for part in ("hashed", "balanced"):
        with pytest.raises(NotImplementedError, match="item 13"):
            ghs_message.minimum_spanning_forest(
                g, GHSParams(partitioner=part), device="cpu")
    with pytest.raises(ValueError):
        ghs_message.minimum_spanning_forest(
            g, GHSParams(partitioner="x"), device="cpu")
    with pytest.raises(ValueError, match="method='boruvka'"):
        mst_api.minimum_spanning_forests([g], method="ghs", device="cpu")
    with pytest.raises(RuntimeError, match="did not reach silence"):
        ghs_message.minimum_spanning_forest(g, max_supersteps=2,
                                            device="cpu")


def test_device_edges_input_and_plain_path_counts_nothing():
    from repro_torch.core import pipeline
    spec = pipeline.GraphSpec("rmat", 6, seed=2)
    kernels.reset_launches()
    got, _ = mst_api.minimum_spanning_forest(
        pipeline.build(spec, device="cpu"), method="ghs", device="cpu")
    _assert_forest(got, kruskal_ref.kruskal(pipeline.build_host(spec)))
    assert kernels.LAUNCHES["ghs_superstep"] == 0


# ---------------------------------------------------------------------------
# On the card: the interval kernel against its plain version
# ---------------------------------------------------------------------------

CARD_KNOBS = [dict(ABLATIONS[k]) for k in ABLATIONS] + [
    dict(round_loop="host"), dict(empty_iter_cnt_to_break=4)]


def _lockstep(cuda, arrays: dict, topo, params, ctx, max_intervals=None):
    """Run the kernel on the card and the plain version on the CPU from the
    same state, one interval at a time, until silence or an error (or for
    ``max_intervals``); every state array and the scalar vector equal after
    each interval.  Returns the number of intervals."""
    cfg = step_ref.config(topo, params)
    cpu = ghs_state.upload(arrays, "cpu")
    card = ghs_state.upload(arrays, cuda)
    n_steps = 1 if params.round_loop == "host" else cfg.check
    scal_c = torch.zeros(3, dtype=torch.int32)
    scal_g = scal_c.to(cuda)
    for k in range(max_intervals or 10_000):
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
        step, silent, err = scal_c.tolist()
        if err or silent >= cfg.empty_needed:
            return k + 1
    if max_intervals:
        return max_intervals
    raise AssertionError(f"{ctx}: no silence")


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", CARD_KNOBS)
def test_gpu_kernel_equals_plain_after_every_interval(cuda, knobs):
    g = generators.rmat(8, seed=8)
    params = GHSParams(**knobs)
    topo, shards = ghs_state.host_shards(g, 1, params, history_capacity=4096)
    assert _lockstep(cuda, shards[0], topo, params, knobs) > 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind,knobs", FORCED)
def test_gpu_kernel_equals_plain_on_forced_states(cuda, kind, knobs):
    g = generators.rmat(7, seed=9)
    params = GHSParams(**knobs)
    topo, shards = ghs_state.host_shards(g, 1, params)
    _force(shards[0], kind, topo)
    # A forced state need not lead to silence (the Test of the inbox case
    # is one no vertex sent): compare a fixed run.
    _lockstep(cuda, shards[0], topo, params, kind, max_intervals=40)


@pytest.mark.gpu
@pytest.mark.parametrize("loop", ["device", "host"])
def test_gpu_solve_equals_cpu_and_launches(cuda, loop):
    g = generators.rmat(9, seed=4)
    params = GHSParams(round_loop=loop)
    want, wst = ghs_message.minimum_spanning_forest(
        g, params, collect_history=True, device="cpu")
    kernels.reset_launches()
    got, st = ghs_message.minimum_spanning_forest(
        g, params, collect_history=True)
    _assert_forest(got, want)
    for field in FIELDS:
        assert getattr(st, field) == getattr(wst, field), field
    want_launches = (st.supersteps if loop == "host"
                     else st.intervals + st.speculative_intervals)
    assert kernels.LAUNCHES["ghs_superstep"] == want_launches
