"""Continuous-batching MST service with latency SLOs.

The online half of the batched engine: ``mst_api.minimum_spanning_forests``
solves a CLOSED batch, this module accepts an OPEN request stream.  Each
submitted graph is routed by
:func:`repro_torch.core.pipeline.bucket_shape` (the ``params.batch_bucket``
admission policy) into a per-shape queue; the dispatcher flushes a queue
when it reaches ``params.serve_lanes`` graphs OR when its oldest request has
waited ``params.serve_max_wait_ms`` — whichever comes first — packs it with
:func:`repro_torch.core.pipeline.pack_bucket`, solves it through
:func:`repro_torch.core.mst_api.solve_packed`, and completes the requests'
futures in arrival order.

Part-full flushes dispatch at the pow2-rounded OCCUPIED lane count (ghost
graphs — single vertex, no edges — pad only up to that width, capped at
``serve_lanes``): a solo deadline flush pays a width-1 solve instead of a
full-width one, which keeps the low-rate regime's mean latency near its
p50.  :meth:`MSTService.warmup` walks the pow2 shape lattice up to
``batch_max_vertices`` / ``batch_max_edges`` at startup, at every adaptive
flush width per shape (:func:`mst_api.warm_bucket`: each kernel a flush
can launch built, each buffer size allocated), so no runtime flush pays
for a first use.

Update requests share the same bucket/flush/backpressure
path: :meth:`MSTService.submit_update` merges the edge batch at admission
(the updated graph routes the bucket and trips the same oversize guard),
queues it under an update-kind bucket key, and the flush plans every
request's cycle/cut probe, solves all candidate subgraphs through ONE
batched ``minimum_spanning_forests`` dispatch, and completes the futures
with new :class:`~repro_torch.core.incremental.IncrementalForest` handles —
each bit-identical to a standalone ``mst_api.apply_updates`` call.

Backpressure (the batch capacity guards made online): an oversized graph is
shed at submit with :class:`OversizeError`, a full bucket queue sheds with
:class:`QueueFullError` — typed, counted in :class:`ServeStats`, never a
silent drop or truncation.

Dispatch happens ONLY inside :meth:`MSTService.poll` / :meth:`drain` (never
inside ``submit``), and the service takes an injectable clock — both
deadline-flush and backpressure paths are testable deterministically, with
no sleeps in assertions.  The service solves on the CUDA card, and raises
without one, unless it is given another device (``device="cpu"`` runs
the kernels' plain versions).

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from repro_torch.core import incremental, mst_api, pipeline, runtime
from repro_torch.core.graph import Graph
from repro_torch.core.params import DEFAULT_PARAMS, GHSParams
from repro_torch.core.partition import pow2ceil

# Trailing-window size of the ServeStats latency ledger: enough samples for
# stable p50/p99 estimates, bounded so a long-running service cannot grow
# without bound (the ``completed`` counter stays exact forever).
LATENCY_WINDOW = 4096


class ShedError(RuntimeError):
    """Base of the typed backpressure rejections (never raised itself)."""


class OversizeError(ShedError):
    """Graph exceeds ``batch_max_vertices`` / ``batch_max_edges`` — it can
    never be packed, so it is rejected at submit (the capacity guard)."""


class QueueFullError(ShedError):
    """The graph's bucket queue is at ``serve_max_queue`` — the service is
    over-rate for this shape; retry after a poll drains the queue."""


def _ghost_graph() -> Graph:
    """Inert padding lane: one vertex, zero edges — solves to an empty
    forest in round one and can never elect an edge."""
    return Graph(num_vertices=1,
                 src=np.zeros(0, np.int32),
                 dst=np.zeros(0, np.int32),
                 weight=np.zeros(0, np.float32))


@dataclasses.dataclass
class ServeStats:
    """Serving ledger.

    Counters: ``accepted`` / ``completed`` requests, sheds by cause
    (``shed_oversize`` at admission, ``shed_queue_full`` at the per-bucket
    bound), flushes by trigger (``size_flushes`` — a queue reached
    ``serve_lanes``; ``deadline_flushes`` — the oldest request aged past
    ``serve_max_wait_ms``; ``drain_flushes`` — explicit :meth:`drain`),
    ``ghost_lanes`` padded into part-full flushes, ``max_queue_depth``
    high-water mark across buckets, ``buckets_warmed`` (shape, width)
    pairs warmed at startup, and ``update_requests`` /
    ``updates_applied`` / ``replacement_probes`` metering the
    incremental-update kind (summed from the per-request
    :class:`~repro_torch.core.runtime.EngineStats` ledger fields).

    ``latencies_ms`` holds one submit→complete measurement per served
    request over a TRAILING window of :data:`LATENCY_WINDOW` samples (a
    bounded deque — a long soak stays memory-flat); :meth:`percentile` /
    :meth:`summary` reduce it to the SLO numbers (p50/p99) and report
    ``latency_samples`` alongside the exact ``completed`` count, so the
    window is never mistaken for the population.  ``graphs_per_s`` is
    filled by the drivers that know wall-clock span
    (:func:`run_poisson`)."""

    accepted: int = 0
    completed: int = 0
    shed_oversize: int = 0
    shed_queue_full: int = 0
    size_flushes: int = 0
    deadline_flushes: int = 0
    drain_flushes: int = 0
    ghost_lanes: int = 0
    max_queue_depth: int = 0
    buckets_warmed: int = 0
    update_requests: int = 0
    updates_applied: int = 0
    replacement_probes: int = 0
    graphs_per_s: float = 0.0
    latencies_ms: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW))

    def record_latency(self, ms: float) -> None:
        """Append one sample; the deque evicts beyond the window."""
        self.latencies_ms.append(ms)

    @property
    def shed(self) -> int:
        return self.shed_oversize + self.shed_queue_full

    @property
    def flushes(self) -> int:
        return self.size_flushes + self.deadline_flushes \
            + self.drain_flushes

    @property
    def shed_rate(self) -> float:
        offered = self.accepted + self.shed
        return self.shed / offered if offered else 0.0

    def percentile(self, q: float) -> float:
        """Percentile over the trailing :data:`LATENCY_WINDOW` samples."""
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    def summary(self) -> dict:
        return {
            "accepted": self.accepted,
            "completed": self.completed,
            "shed": self.shed,
            "shed_oversize": self.shed_oversize,
            "shed_queue_full": self.shed_queue_full,
            "shed_rate": round(self.shed_rate, 4),
            "size_flushes": self.size_flushes,
            "deadline_flushes": self.deadline_flushes,
            "drain_flushes": self.drain_flushes,
            "ghost_lanes": self.ghost_lanes,
            "max_queue_depth": self.max_queue_depth,
            "buckets_warmed": self.buckets_warmed,
            "update_requests": self.update_requests,
            "latency_samples": len(self.latencies_ms),
            "p50_ms": round(self.percentile(50), 3),
            "p99_ms": round(self.percentile(99), 3),
            "mean_ms": (round(float(np.mean(np.asarray(self.latencies_ms))),
                              3)
                        if self.latencies_ms else float("nan")),
            "graphs_per_s": round(self.graphs_per_s, 2),
        }


@dataclasses.dataclass
class _Request:
    graph: Graph            # solve kind: the input; update kind: the merged
                            # (updated) graph that routed the bucket
    future: Future
    t_submit: float
    # Update-kind payload (None on solve requests): the handle to evolve
    # and the edge batch to apply at flush time.
    forest: "Optional[incremental.IncrementalForest]" = None
    edge_batch: "Optional[incremental.EdgeBatch]" = None


class MSTService:
    """Continuous-batching MST solver: ``submit()`` graphs, ``poll()`` the
    dispatcher, read results off the returned futures.

    ``clock`` is injectable (defaults to ``time.monotonic``); tests drive
    deadline expiry by passing explicit ``now`` values to :meth:`poll`
    instead of sleeping.  Dispatch happens only in :meth:`poll` /
    :meth:`drain`, so a burst of submits between polls exercises the
    ``serve_max_queue`` backpressure bound deterministically.
    ``device=None`` solves on the CUDA card and raises when there is none;
    ``device="cpu"`` runs the kernels' plain versions.
    """

    def __init__(
        self,
        params: GHSParams = DEFAULT_PARAMS,
        *,
        clock: Callable[[], float] = time.monotonic,
        max_rounds: Optional[int] = None,
        device=None,
    ):
        if params.serve_lanes < 1:
            raise ValueError(
                f"serve_lanes must be >= 1, got {params.serve_lanes}")
        if params.serve_max_queue < params.serve_lanes:
            raise ValueError(
                f"serve_max_queue ({params.serve_max_queue}) must be >= "
                f"serve_lanes ({params.serve_lanes}); a full dispatch "
                f"could otherwise never assemble")
        self.params = params
        self.device = runtime.resolve_device(device)
        self.stats = ServeStats()
        self._clock = clock
        self._max_rounds = max_rounds
        # bucket shape -> FIFO of _Request; insertion-ordered so poll()
        # visits buckets in first-traffic order (deterministic).
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()

    # -- admission ---------------------------------------------------------

    def submit(self, graph, *, t_arrival: Optional[float] = None) -> Future:
        """Admit one graph; returns a future resolving to its
        :class:`~repro_torch.core.kruskal_ref.ForestResult`.

        ``t_arrival`` optionally backdates the request to its scheduled
        arrival time (open-loop benchmarking: latency is measured from when
        the request WOULD have arrived, not from when a busy driver got
        around to submitting it).  Raises :class:`OversizeError` /
        :class:`QueueFullError` on backpressure — typed and counted, the
        request is NOT queued."""
        g = runtime.as_graph(graph)
        p = self.params
        try:
            shape = pipeline.bucket_shape(
                g.num_vertices, g.num_edges, bucket=p.batch_bucket,
                max_vertices=p.batch_max_vertices or None,
                max_edges=p.batch_max_edges or None)
        except ValueError as e:
            self.stats.shed_oversize += 1
            raise OversizeError(str(e)) from None
        q = self._queues.setdefault(shape, deque())
        if len(q) >= p.serve_max_queue:
            self.stats.shed_queue_full += 1
            raise QueueFullError(
                f"bucket {shape} queue is full "
                f"({p.serve_max_queue} pending)")
        fut: Future = Future()
        q.append(_Request(graph=g, future=fut,
                          t_submit=(self._clock() if t_arrival is None
                                    else float(t_arrival))))
        self.stats.accepted += 1
        self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                         len(q))
        return fut

    def submit_update(
        self,
        forest: "incremental.IncrementalForest",
        edge_batch: "incremental.EdgeBatch",
        *,
        t_arrival: Optional[float] = None,
    ) -> Future:
        """Admit one incremental update; returns a future resolving to the
        NEW :class:`~repro_torch.core.incremental.IncrementalForest` handle,
        bit-identical to ``mst_api.apply_updates`` on the inputs.

        The edge batch is merged here (host glue) so the UPDATED graph
        routes the bucket and trips the same ``OversizeError`` guard as a
        solve; update buckets queue separately from solve buckets (an
        update-kind key) but share the size-or-deadline flush, the
        ``serve_max_queue`` bound, and the stats ledger.  Malformed
        batches (endpoints/weights out of range) raise ``ValueError`` at
        the caller — that is an input bug, not backpressure."""
        p = self.params
        g2 = incremental.apply_edge_batch(forest.graph, edge_batch)
        try:
            shape = ("update",) + pipeline.bucket_shape(
                g2.num_vertices, g2.num_edges, bucket=p.batch_bucket,
                max_vertices=p.batch_max_vertices or None,
                max_edges=p.batch_max_edges or None)
        except ValueError as e:
            self.stats.shed_oversize += 1
            raise OversizeError(str(e)) from None
        q = self._queues.setdefault(shape, deque())
        if len(q) >= p.serve_max_queue:
            self.stats.shed_queue_full += 1
            raise QueueFullError(
                f"bucket {shape} queue is full "
                f"({p.serve_max_queue} pending)")
        fut: Future = Future()
        q.append(_Request(graph=g2, future=fut,
                          t_submit=(self._clock() if t_arrival is None
                                    else float(t_arrival)),
                          forest=forest, edge_batch=edge_batch))
        self.stats.accepted += 1
        self.stats.update_requests += 1
        self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                         len(q))
        return fut

    # -- dispatch ----------------------------------------------------------

    def queue_depth(self, shape: Optional[tuple] = None) -> int:
        if shape is not None:
            return len(self._queues.get(shape, ()))
        return sum(len(q) for q in self._queues.values())

    def poll(self, now: Optional[float] = None) -> int:
        """Run the dispatcher once: flush every bucket that is full
        (``serve_lanes``) or whose oldest request has waited past
        ``serve_max_wait_ms``.  Returns the number of flushes.

        A caller-injected ``now`` (virtual clock) is threaded through to
        the flushes' completion stamps, so latency ledgers never mix
        timebases; with no injection, completion is stamped from the real
        clock AFTER the solve (the solve's own wall time counts)."""
        injected = now is not None
        if now is None:
            now = self._clock()
        p = self.params
        wait_s = p.serve_max_wait_ms / 1e3
        flushed = 0
        for shape, q in list(self._queues.items()):
            while len(q) >= p.serve_lanes:
                self.stats.size_flushes += 1
                self._flush(shape, q, now=now if injected else None)
                flushed += 1
            if q and now - q[0].t_submit >= wait_s:
                self.stats.deadline_flushes += 1
                self._flush(shape, q, now=now if injected else None)
                flushed += 1
        return flushed

    def drain(self, now: Optional[float] = None) -> int:
        """Flush every non-empty bucket regardless of size or deadline
        (shutdown / end-of-stream).  Returns the number of flushes.
        ``now`` threads a virtual completion stamp exactly as in
        :meth:`poll`."""
        flushed = 0
        for shape, q in list(self._queues.items()):
            while q:
                self.stats.drain_flushes += 1
                self._flush(shape, q, now=now)
                flushed += 1
        return flushed

    def _flush(self, shape: tuple, q: deque,
               now: Optional[float] = None) -> None:
        p = self.params
        reqs = [q.popleft() for _ in range(min(len(q), p.serve_lanes))]
        if shape[0] == "update":
            results = self._solve_updates(reqs)
        else:
            results = self._solve_graphs(shape, reqs)
        # Completion stamp: the injected virtual time when the dispatcher
        # was driven with one (poll(now=...) — a single timebase for the
        # whole ledger), else the real clock AFTER the solve: the forests
        # are on the host by then, so the device's time counts.
        done = self._clock() if now is None else now
        # Requests left the FIFO in arrival order; their futures complete
        # in that same order (ghost lanes have no future to complete).
        for r, res in zip(reqs, results):
            self.stats.completed += 1
            self.stats.record_latency((done - r.t_submit) * 1e3)
            r.future.set_result(res)

    def _dispatch_params(self, n_pad: int) -> GHSParams:
        """Solving params for one flush: a run-to-completion interval
        (``batch_check_frequency >= n_pad + 2``, the round bound) so the
        bucket converges in ONE dispatch — one readback per flush, and the
        mid-solve compaction ladder never runs, which keeps the warmed
        lattice at one warm-up per (shape, width).  (The default
        short-interval policy exists for throughput-scale batched solves,
        where per-interval contraction amortizes; at serving shapes it
        would instead put a compaction ladder inside a request's latency.)
        A user-set longer interval is kept."""
        p = self.params
        return dataclasses.replace(
            p, batch_check_frequency=max(p.batch_check_frequency,
                                         n_pad + 2))

    def _solve_graphs(self, shape: tuple, reqs: list) -> list:
        """One packed bucket dispatch at the pow2-rounded occupied width."""
        p = self.params
        lanes = min(pow2ceil(len(reqs)), p.serve_lanes)
        ghosts = lanes - len(reqs)
        graphs = [r.graph for r in reqs] + \
            [_ghost_graph() for _ in range(ghosts)]
        n_pad, cap = shape
        batch = pipeline.pack_bucket(graphs, n_pad, cap)
        results, _ = mst_api.solve_packed(
            batch, params=self._dispatch_params(n_pad),
            max_rounds=self._max_rounds, device=self.device)
        self.stats.ghost_lanes += ghosts
        return results[:len(reqs)]

    def _solve_updates(self, reqs: list) -> list:
        """Plan every update's cycle/cut probe, then solve ALL candidate
        subgraphs through one batched dispatch — each lane bit-identical to
        a standalone ``mst_api.apply_updates``."""
        p = self.params
        plans = [incremental.plan_updates(r.forest, r.edge_batch,
                                          params=p, device=self.device,
                                          updated=r.graph)
                 for r in reqs]
        forests, _ = mst_api.minimum_spanning_forests(
            [pl.sub for pl in plans], params=p,
            max_rounds=self._max_rounds, device=self.device)
        out = []
        for pl, f in zip(plans, forests):
            self.stats.updates_applied += pl.stats.updates_applied
            self.stats.replacement_probes += pl.stats.replacement_probes
            out.append(incremental.finalize_plan(pl, f))
        return out

    # -- warmup ------------------------------------------------------------

    def flush_widths(self) -> list:
        """The lane widths an adaptive flush can dispatch at: every power
        of two below ``serve_lanes``, plus ``serve_lanes`` itself (a full
        or over-rounded flush caps there — ``min(pow2ceil(occupied),
        serve_lanes)`` can produce no other value)."""
        widths, w = [], 1
        while w < self.params.serve_lanes:
            widths.append(w)
            w *= 2
        widths.append(self.params.serve_lanes)
        return widths

    def warmup(self) -> int:
        """Warm the pow2 bucket lattice: every ``(n_pad, cap)`` shape up to
        ``batch_max_vertices`` / ``batch_max_edges``, at every adaptive
        flush width (:meth:`flush_widths`).  Per (shape, width),
        :func:`repro_torch.core.mst_api.warm_bucket` runs every interval and
        shrink the bucket can reach on ghost lanes, so each kernel a flush
        launches is built and each buffer size allocated before the first
        request (pipeline weights live in (0, 1), so the contraction gate
        resolves for empty warm lanes as for real traffic).  Requires
        bounded capacities and the ``"pow2"`` policy (``"exact"`` shapes are
        unbounded); returns the number of (shape, width) pairs warmed.
        Update-kind flushes are not warmed here: their candidate subgraph
        shapes depend on the traffic's graphs."""
        p = self.params
        if (p.batch_bucket != "pow2" or not p.batch_max_vertices
                or not p.batch_max_edges):
            return 0
        n_top = pow2ceil(p.batch_max_vertices)
        cap_top = pow2ceil(max(p.batch_max_edges, 8))
        widths = self.flush_widths()
        warmed = 0
        n_pad = 1
        while n_pad <= n_top:
            wp = self._dispatch_params(n_pad)
            cap = 8
            while cap <= cap_top:
                for lanes in widths:
                    mst_api.warm_bucket(lanes, n_pad, cap, params=wp,
                                        device=self.device)
                    warmed += 1
                cap *= 2
            n_pad *= 2
        self.stats.buckets_warmed = warmed
        return warmed


# ---------------------------------------------------------------------------
# Open-loop Poisson driver — the benchmark's offered-load generator
# ---------------------------------------------------------------------------

def run_poisson(
    service: MSTService,
    graphs,
    *,
    rate: float,
    seed: int = 0,
    sleep: Callable[[float], None] = time.sleep,
) -> list:
    """Offer ``graphs`` to ``service`` as a Poisson stream of ``rate``
    graphs/second; returns one future per request (``None`` where the
    service shed it).

    Open-loop semantics: arrival times are drawn up front
    (exponential inter-arrival gaps, ``numpy`` Generator seeded with
    ``seed``) and requests are backdated to their SCHEDULED arrival via
    ``submit(t_arrival=...)`` — when a long flush makes the driver late,
    the measured latency still starts at the arrival the load model
    demanded, and the queue bound sheds honestly instead of the driver
    quietly throttling the offered load.  Between arrivals the driver
    polls the dispatcher, so deadline flushes fire on schedule.  The
    stream is drained at the end and ``stats.graphs_per_s`` is filled
    from the wall-clock span."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=len(graphs))
    clock = service._clock
    t0 = clock()
    arrivals = t0 + np.cumsum(gaps)
    futures: list = []
    for g, t_arr in zip(graphs, arrivals):
        while True:
            now = clock()
            if now >= t_arr:
                break
            service.poll(now)
            sleep(min(t_arr - now, 1e-3))
        try:
            futures.append(service.submit(g, t_arrival=float(t_arr)))
        except ShedError:
            futures.append(None)
        service.poll()
    service.poll()
    service.drain()
    span = clock() - t0
    service.stats.graphs_per_s = (service.stats.completed / span
                                  if span > 0 else 0.0)
    return futures


# ---------------------------------------------------------------------------
# CLI demo
# ---------------------------------------------------------------------------

def main(argv=None):
    from repro_torch.core import generators, kruskal_ref

    ap = argparse.ArgumentParser(
        description="Continuous-batching MST service demo")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run: fewer requests, smaller graphs")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="offered load, graphs/second")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--max-vertices", type=int, default=256)
    ap.add_argument("--max-edges", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="check every served forest against the Kruskal "
                         "oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = min(args.requests, 64)
        args.max_vertices = min(args.max_vertices, 64)
        args.max_edges = min(args.max_edges, 256)

    params = dataclasses.replace(
        DEFAULT_PARAMS,
        serve_lanes=args.lanes,
        serve_max_wait_ms=args.max_wait_ms,
        serve_max_queue=args.max_queue,
        batch_max_vertices=args.max_vertices,
        batch_max_edges=args.max_edges)
    service = MSTService(params, device=args.device)

    if not args.no_warmup:
        t0 = time.monotonic()
        warmed = service.warmup()
        print(f"warmup: {warmed} bucket shapes in "
              f"{time.monotonic() - t0:.1f}s")

    rng = np.random.default_rng(args.seed)
    scale_top = max(args.max_vertices.bit_length() - 1, 2)
    # Degree 8 keeps every scale inside --max-edges; a handful of
    # full-degree graphs ride along to exercise the oversize shed path.
    graphs = [
        generators.generate(
            "rmat", int(rng.integers(2, scale_top + 1)),
            avg_degree=8 if i % 16 else 32,
            seed=int(rng.integers(0, 2**31)))
        for i in range(args.requests)
    ]

    futures = run_poisson(service, graphs, rate=args.rate, seed=args.seed)

    if args.verify:
        for g, f in zip(graphs, futures):
            if f is None:
                continue
            res = f.result()
            oracle = kruskal_ref.kruskal(g)
            assert np.array_equal(res.edge_mask, oracle.edge_mask), \
                "served forest diverged from the Kruskal oracle"
        print("verify: all served forests oracle-exact")

    for k, v in service.stats.summary().items():
        print(f"{k:>18}: {v}")
    return service.stats


if __name__ == "__main__":
    main()
