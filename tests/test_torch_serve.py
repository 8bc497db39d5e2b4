"""The port's MST service held against the JAX package's: the virtual-clock
scenarios of ``tests/test_serving.py`` replayed on both services with the
same submits, polls and drains.  After each scenario the ``summary()``
dicts, the flush counts and the queues are equal, every served forest is
bit-identical to the reference's, and every update handle is bit-identical
to the reference's and to a standalone ``apply_updates`` of the port.
Cases marked ``gpu`` serve on the card."""
import math
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core import incremental, kruskal_ref, mst_api
from repro_torch.core.graph import Graph
from repro_torch.core.params import GHSParams
from repro_torch.launch import serve
from repro_torch.launch.serve import (
    LATENCY_WINDOW, MSTService, OversizeError, QueueFullError, ServeStats,
    run_poisson)


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
        from repro.launch import serve as rserve
        yield types.SimpleNamespace(generators=rgen, inc=rinc, api=rapi,
                                    preprocess=rpre, params=RParams,
                                    serve=rserve)
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


class FakeClock:
    """Injectable time source: tests advance it instead of sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# Seeds whose scale-4 rmat graphs all share the (n_pad=16, cap=32) pow2
# bucket (tests/test_serving.py's pool).
_POOL = (0, 2, 3, 4, 5, 6, 9, 10, 12, 13)


def _knobs(**kw):
    base = dict(serve_lanes=3, serve_max_wait_ms=50.0, serve_max_queue=6,
                batch_max_vertices=64, batch_max_edges=256)
    base.update(kw)
    return base


def _port(g) -> Graph:
    return Graph.from_arrays(g.src, g.dst, g.weight, g.num_vertices)


def _assert_forest(got, want, ctx=None):
    assert np.array_equal(got.edge_mask, want.edge_mask), ctx
    assert (got.total_weight, got.num_components, got.num_tree_edges) == \
        (want.total_weight, want.num_components, want.num_tree_edges), ctx


def _same_summary(a: dict, b: dict) -> bool:
    """Equal dicts, NaN equal to NaN (the percentiles of an empty window)."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (isinstance(a[k], float) and math.isnan(a[k])
                         and math.isnan(b[k])) for k in a)


class Twin:
    """The reference's service and the port's (on the CPU), each on its own
    fake clock, driven by the same calls."""

    def __init__(self, ref, **kw):
        self.ref = ref
        self.rclock, self.clock = FakeClock(), FakeClock()
        self.rsvc = ref.serve.MSTService(ref.params(**_knobs(**kw)),
                                         clock=self.rclock)
        self.svc = MSTService(GHSParams(**_knobs(**kw)), clock=self.clock,
                              device="cpu")
        self.served = []          # (reference future, port future, input)

    def g(self, seed, scale=4, degree=4):
        return self.ref.generators.generate("rmat", scale, avg_degree=degree,
                                            seed=seed)

    def advance(self, dt):
        self.rclock.advance(dt)
        self.clock.advance(dt)

    def _both(self, rcall, pcall):
        """Both calls return, or both raise the same type and message (the
        port's exception is raised on)."""
        try:
            want = rcall()
        except (ValueError, RuntimeError) as e:
            with pytest.raises(getattr(serve, type(e).__name__,
                                       type(e))) as got:
                pcall()
            assert str(got.value) == str(e)
            raise got.value from None
        return want, pcall()

    def submit(self, rg, **kw):
        rfut, fut = self._both(lambda: self.rsvc.submit(rg, **kw),
                               lambda: self.svc.submit(_port(rg), **kw))
        self.served.append((rfut, fut, None))
        return fut

    def submit_update(self, rstate, state, inserts, deletes, **kw):
        rb = self.ref.inc.EdgeBatch.make(inserts, deletes)
        b = incremental.EdgeBatch.make(inserts, deletes)
        rfut, fut = self._both(
            lambda: self.rsvc.submit_update(rstate, rb, **kw),
            lambda: self.svc.submit_update(state, b, **kw))
        self.served.append((rfut, fut, (state, b)))
        return fut

    def poll(self, now=None):
        want, got = self.rsvc.poll(now), self.svc.poll(now)
        assert got == want
        return got

    def drain(self, now=None):
        want, got = self.rsvc.drain(now), self.svc.drain(now)
        assert got == want
        return got

    def check(self):
        """Ledgers, queues and every completed result equal."""
        assert _same_summary(self.svc.stats.summary(),
                             self.rsvc.stats.summary())
        assert list(self.svc.stats.latencies_ms) == \
            list(self.rsvc.stats.latencies_ms)
        assert {k: len(q) for k, q in self.svc._queues.items()} == \
            {k: len(q) for k, q in self.rsvc._queues.items()}
        for rfut, fut, upd in self.served:
            assert fut.done() == rfut.done()
            if not fut.done():
                continue
            got, want = fut.result(), rfut.result()
            if upd is None:
                _assert_forest(got, want)
                continue
            _assert_forest(got.forest, want.forest)
            for f in ("src", "dst", "weight"):
                assert np.array_equal(getattr(got.graph, f),
                                      getattr(want.graph, f))
            alone, _ = mst_api.apply_updates(*upd, device="cpu")
            _assert_forest(got.forest, alone.forest)


def _oracle(g, fut):
    want = kruskal_ref.kruskal(_port(g))
    assert np.array_equal(fut.result().edge_mask, want.edge_mask)


# ---------------------------------------------------------------------------
# Dispatch triggers
# ---------------------------------------------------------------------------

def test_size_flush_fires_without_time_passing(ref):
    t = Twin(ref)
    graphs = [t.g(s) for s in _POOL[:3]]
    futs = [t.submit(g) for g in graphs]
    assert not any(f.done() for f in futs)
    assert t.poll(now=0.0) == 1
    assert (t.svc.stats.size_flushes, t.svc.stats.ghost_lanes) == (1, 0)
    t.check()
    for g, f in zip(graphs, futs):
        _oracle(g, f)


def test_deadline_flush_at_occupied_width(ref):
    t = Twin(ref)
    fut = t.submit(t.g(7))
    assert t.poll(now=0.049) == 0
    assert not fut.done()
    assert t.poll(now=0.050) == 1
    assert (t.svc.stats.deadline_flushes, t.svc.stats.ghost_lanes) == (1, 0)
    t.check()
    _oracle(t.g(7), fut)


def test_deadline_measured_from_oldest_request(ref):
    t = Twin(ref)
    t.submit(t.g(_POOL[0]))
    t.advance(0.04)
    t.submit(t.g(_POOL[1]))
    assert t.poll(now=0.050) == 1
    assert t.svc.stats.completed == 2
    t.check()


def test_partial_flush_rounds_to_pow2_width(ref):
    t = Twin(ref, serve_lanes=4, serve_max_queue=8)
    futs = [t.submit(t.g(s)) for s in _POOL[:3]]
    assert t.poll(now=0.050) == 1
    assert t.svc.stats.ghost_lanes == 1
    t.check()
    for s, f in zip(_POOL, futs):
        _oracle(t.g(s), f)


def test_completion_in_arrival_order(ref):
    t = Twin(ref)
    order = []
    for i, s in enumerate(_POOL[:3]):
        t.submit(t.g(s)).add_done_callback(
            lambda f, i=i: order.append(i))
    t.poll(now=0.0)
    assert order == [0, 1, 2]
    t.check()


def test_mixed_buckets_route_and_drain(ref):
    t = Twin(ref)
    empty = ref.preprocess(np.zeros(0), np.zeros(0), np.zeros(0, np.float32),
                           6)
    graphs = [t.g(1, scale=3), t.g(2, scale=5), t.g(3, scale=3), empty]
    futs = [t.submit(g) for g in graphs]
    assert len(t.svc._queues) >= 2
    assert list(t.svc._queues) == list(t.rsvc._queues)
    assert t.poll(now=0.0) == 0
    assert t.drain() == len(t.svc._queues)
    t.check()
    for g, f in zip(graphs, futs):
        _oracle(g, f)


# ---------------------------------------------------------------------------
# Backpressure and knobs
# ---------------------------------------------------------------------------

def test_oversize_shed_is_typed_and_counted(ref):
    t = Twin(ref, batch_max_edges=8)
    with pytest.raises(OversizeError, match="exceeds pack_batch capacity"):
        t.submit(t.g(3, scale=5, degree=8))
    assert t.svc.stats.shed_oversize == 1
    assert t.svc.queue_depth() == 0
    t.check()


def test_queue_full_shed_then_poll_recovers(ref):
    t = Twin(ref)
    futs = [t.submit(t.g(s)) for s in _POOL[:6]]
    with pytest.raises(QueueFullError, match="queue is full"):
        t.submit(t.g(_POOL[6]))
    assert t.svc.stats.max_queue_depth == 6
    assert t.poll(now=0.0) == 2
    assert all(f.done() for f in futs)
    t.submit(t.g(_POOL[7]))
    assert t.svc.stats.accepted == 7
    t.check()


def test_shed_rate_accounting(ref):
    t = Twin(ref, batch_max_edges=8)
    t.submit(ref.preprocess(np.array([0]), np.array([1]),
                            np.array([0.5], np.float32), 2))
    with pytest.raises(OversizeError):
        t.submit(t.g(3, scale=5, degree=8))
    assert t.svc.stats.shed_rate == pytest.approx(0.5)
    t.drain(now=0.0)
    t.check()


@pytest.mark.parametrize("knobs", [dict(serve_lanes=0),
                                   dict(serve_lanes=4, serve_max_queue=2)])
def test_service_rejects_inconsistent_knobs(ref, knobs):
    with pytest.raises(ValueError) as want:
        ref.serve.MSTService(ref.params(**_knobs(**knobs)))
    with pytest.raises(ValueError) as got:
        MSTService(GHSParams(**_knobs(**knobs)), device="cpu")
    assert str(got.value) == str(want.value)


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MSTService(GHSParams(**_knobs()))


# ---------------------------------------------------------------------------
# Warmup lattice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs,count", [
    (dict(batch_max_vertices=8, batch_max_edges=16), 24),
    (dict(serve_lanes=8, serve_max_queue=64, batch_max_vertices=256,
          batch_max_edges=1024), 288),
    (dict(batch_max_vertices=0, batch_max_edges=0), 0),
    (dict(batch_bucket="exact"), 0),
])
def test_warmup_walks_the_reference_lattice(ref, monkeypatch, knobs, count):
    """The port warms the same (n_pad, cap, width) lattice and returns the
    reference's count (the reference's lattice walk is counted with its
    compiles stubbed out)."""
    rsvc = ref.serve.MSTService(ref.params(**_knobs(**knobs)),
                                clock=FakeClock())
    monkeypatch.setattr(ref.serve.mst_api, "warm_bucket",
                        lambda *a, **k: None)
    want = rsvc.warmup()
    calls = []
    real = serve.mst_api.warm_bucket
    monkeypatch.setattr(serve.mst_api, "warm_bucket",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    svc = MSTService(GHSParams(**_knobs(**knobs)), clock=FakeClock(),
                     device="cpu")
    assert svc.flush_widths() == rsvc.flush_widths()
    assert svc.warmup() == want == count == len(calls)
    assert svc.stats.buckets_warmed == count
    assert svc.stats.accepted == svc.stats.completed == svc.stats.flushes == 0


def test_serve_dispatch_runs_to_completion(ref):
    svc = MSTService(GHSParams(**_knobs()), clock=FakeClock(), device="cpu")
    rsvc = ref.serve.MSTService(ref.params(**_knobs()), clock=FakeClock())
    assert svc._dispatch_params(16).batch_check_frequency == \
        rsvc._dispatch_params(16).batch_check_frequency >= 18


# ---------------------------------------------------------------------------
# Poisson driver and the latency ledger
# ---------------------------------------------------------------------------

def test_run_poisson_virtual_time(ref):
    t = Twin(ref, serve_max_queue=32)
    graphs = [t.g(s, scale=3) for s in range(8)]
    want = ref.serve.run_poisson(t.rsvc, graphs, rate=200.0, seed=1,
                                 sleep=t.rclock.advance)
    got = run_poisson(t.svc, [_port(g) for g in graphs], rate=200.0, seed=1,
                      sleep=t.clock.advance)
    assert [f is None for f in got] == [f is None for f in want]
    t.served = [(w, f, None) for w, f in zip(want, got) if f is not None]
    assert t.svc.stats.graphs_per_s > 0
    t.check()
    for g, f in zip(graphs, got):
        if f is not None:
            _oracle(g, f)


def test_virtual_and_real_clock_latency(ref):
    t = Twin(ref)
    t.submit(t.g(7))
    assert t.poll(now=0.050) == 1
    assert t.svc.stats.latencies_ms[-1] == pytest.approx(50.0)
    t.submit(t.g(8), t_arrival=0.050)
    assert t.drain(now=0.075) == 1
    assert t.svc.stats.latencies_ms[-1] == pytest.approx(25.0)
    # No injected now: stamped from the service clock after the solve.
    t.submit(t.g(9))
    t.advance(0.2)
    assert t.poll() == 1
    assert t.svc.stats.latencies_ms[-1] == pytest.approx(200.0)
    t.check()


def test_latency_window_soak(ref):
    stats, rstats = ServeStats(), ref.serve.ServeStats()
    for i in range(1_000_000):
        stats.record_latency(float(i % 97))
        rstats.record_latency(float(i % 97))
    stats.completed = rstats.completed = 1_000_000
    assert len(stats.latencies_ms) == LATENCY_WINDOW
    assert _same_summary(stats.summary(), rstats.summary())
    assert _same_summary(ServeStats().summary(),
                         ref.serve.ServeStats().summary())


# ---------------------------------------------------------------------------
# Update requests
# ---------------------------------------------------------------------------

def _update_for(state, rng):
    n = state.graph.num_vertices
    ins = [(int(rng.integers(n)), int(rng.integers(n)),
            float(rng.uniform(0.01, 0.99))) for _ in range(4)]
    tree = np.flatnonzero(state.forest.edge_mask)
    dele = [(int(state.graph.src[i]), int(state.graph.dst[i]))
            for i in rng.choice(tree, min(2, tree.size), replace=False)]
    return ins, dele


def _handles(t, seed):
    rg = t.g(seed)
    rstate, _ = t.ref.api.incremental_forest(rg)
    state, _ = mst_api.incremental_forest(_port(rg), device="cpu")
    return rstate, state


def test_update_requests_share_flush_and_match_apply_updates(ref):
    rng = np.random.default_rng(3)
    t = Twin(ref, serve_max_queue=8)
    futs = []
    for s in _POOL[:3]:
        rstate, state = _handles(t, s)
        futs.append(t.submit_update(rstate, state, *_update_for(state, rng)))
    assert not any(f.done() for f in futs)
    assert t.svc.stats.update_requests == 3
    assert t.poll(now=0.0) == 1
    assert t.svc.stats.updates_applied > 0
    t.check()


def test_update_and_solve_buckets_coexist(ref):
    rng = np.random.default_rng(4)
    t = Twin(ref)
    t.submit(t.g(11))
    rstate, state = _handles(t, 12)
    t.submit_update(rstate, state, *_update_for(state, rng))
    assert list(t.svc._queues) == list(t.rsvc._queues)
    assert len(t.svc._queues) == 2
    assert t.drain(now=0.0) == 2
    t.check()


def test_update_sheds_and_bad_batches(ref):
    base = ref.preprocess(np.arange(4), np.arange(4) + 1,
                          np.full(4, 0.5, np.float32), 16)
    t = Twin(ref, batch_max_edges=8)
    rstate, _ = ref.api.incremental_forest(base)
    state, _ = mst_api.incremental_forest(_port(base), device="cpu")
    big = [(i, (i + 7) % 16, 0.5 + i * 1e-3) for i in range(16)
           if i != (i + 7) % 16]
    with pytest.raises(OversizeError, match="exceeds pack_batch capacity"):
        t.submit_update(rstate, state, big, [])
    with pytest.raises(ValueError, match="endpoints"):
        t.submit_update(rstate, state, [(0, 10**6, 0.5)], [])
    assert (t.svc.stats.shed_oversize, t.svc.stats.accepted) == (1, 0)
    t.check()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_service_equals_cpu_service(cuda):
    from repro_torch.core import generators
    rng = np.random.default_rng(5)
    graphs = [generators.rmat(4, avg_degree=4, seed=s) for s in _POOL[:6]]
    handles = [mst_api.incremental_forest(generators.rmat(5, seed=s),
                                          device="cpu")[0] for s in (1, 2)]
    batches = [incremental.EdgeBatch.make(*_update_for(h, rng))
               for h in handles]
    out = {}
    for dev in ("cpu", cuda):
        svc = MSTService(GHSParams(**_knobs()), clock=FakeClock(),
                         device=dev)
        assert svc.warmup() == 126
        futs = [svc.submit(g) for g in graphs]
        futs += [svc.submit_update(h, b) for h, b in zip(handles, batches)]
        assert svc.poll(now=0.0) == 2
        assert svc.drain(now=0.1) == 1
        out[str(dev)] = ([f.result() for f in futs], svc.stats.summary())
    (cpu, cs), (card, gs) = out.values()
    assert _same_summary(cs, gs)
    for a, b in zip(cpu[:6], card[:6]):
        _assert_forest(b, a)
    for a, b in zip(cpu[6:], card[6:]):
        _assert_forest(b.forest, a.forest)
