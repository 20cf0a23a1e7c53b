"""InfluenceService: an instrumented request/response loop over the store
and the batcher.

The counterpart of ``repro/serve/service.py``; the in-process serving API
that ``launch/train.py --serve`` drives:

    service = InfluenceService(problem, solver, params=trained)
    t = service.submit(query_example)          # parks the query
    service.pump()                             # flushes due blocks
    resp = service.result(t)                   # scores/indices + metrics

Request life: ``submit`` computes the query's per-example gradient (one
``torch.func.grad`` function, built once per service), parks the vector in
the :class:`QueryBatcher` and applies backpressure: a bounded queue raises
:class:`ServiceOverloaded` instead of growing. ``pump`` flushes every due
block: the prepared solver state comes from the :class:`SketchStore` (a
warm hit bills zero build HVPs), the block goes through
``solver.apply_matrix`` as one (p, m) pass (kernels B and C at m = 1,
A's cross and C's block form at m ≥ 2 on ``backend='cuda'``), and the
streamed top-k scan (``make_topk_scanner``) scores the training set.

Degradation: if the sketch build fails, the service logs a warning and
answers that flush with a fresh CG solve, the slow but dependable path,
marking its responses ``degraded=True``. A fault of the hand-written
kernels (:class:`~repro_torch.kernels._lib.KernelError`: a build, load or
launch failure, or a wrapper's refusal of its operands) is not a failure
of the build's numerics and is not answered around: it propagates.

The sketch's columns come from ``torch.Generator().manual_seed(seed)`` at
every build, or from ``indices=`` (a draw made elsewhere, as
``influence(indices=)`` takes one). Every response carries latency, cache
and batching metadata; ``bench_rows()`` aggregates a run into schema-v2
rows (latency percentiles, queue depth, cache hit rate, HVP bill).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch
from torch.func import grad

from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.problem import (_TRAIN_DEFAULTS, InfluenceProblem,
                                      influence_build_hvps,
                                      influence_curvature_hvp,
                                      make_topk_scanner,
                                      train_influence_params)
from repro_torch.core.solvers import CGIHVP
from repro_torch.core.tree_util import PyTreeIndexer, tree_map
from repro_torch.kernels._lib import KernelError
from repro_torch.serve.batcher import (QueryBatcher, block_until_ready,
                                       calibrate_block_size)
from repro_torch.serve.store import SketchStore, sketch_key

log = logging.getLogger(__name__)


class ServiceOverloaded(RuntimeError):
    """Raised by ``submit`` when the bounded request queue is full.

    Backpressure, not buffering: the caller decides whether to retry, shed
    or pump; the service never parks unbounded work.
    """


@dataclasses.dataclass(frozen=True)
class InfluenceRequest:
    """Bookkeeping for one in-flight query."""
    ticket: int
    t_submit: float
    deadline: float | None


@dataclasses.dataclass
class InfluenceResponse:
    """One answered query: scores plus serving metadata."""
    ticket: int
    scores: torch.Tensor         # (top_k,) influence scores, descending
    indices: torch.Tensor        # (top_k,) training-example indices
    latency_s: float             # submit → answer wall time
    batched_m: int               # width of the flush that answered it
    cache_hit: bool              # sketch came warm from the store
    degraded: bool               # answered through the CG fallback
    deadline_missed: bool        # answered after its deadline


class InfluenceService:
    """Serve top-k influence queries against one trained model.

    Parameters
    ----------
    problem:
        The :class:`InfluenceProblem` being served; the service runs where
        its tensors lie.
    config:
        ``HypergradConfig`` or a built solver. Must be amortizable for the
        store to engage; iterative solvers serve every flush fresh (the
        store is bypassed).
    params:
        Trained parameters; ``None`` trains through
        :func:`~repro_torch.core.train_influence_params` first.
    store:
        A shared :class:`SketchStore`; ``None`` builds a private one.
    top_k / batch_size:
        Top-k width per query and training-stream tile size (defaults from
        the problem's training defaults).
    block_size / max_delay / deadline_slack:
        Batching knobs, forwarded to :class:`QueryBatcher`. ``warmup()``
        overrides ``block_size`` with the calibrated optimum.
    max_queue:
        Bounded-queue capacity; ``submit`` past it raises
        :class:`ServiceOverloaded`.
    seed / indices:
        The sketch's column draw: ``torch.Generator().manual_seed(seed)``
        at every build, or ``indices`` (a structured draw) in its place.
        ``seed`` also seeds the training when ``params`` is None.
    clock:
        Injectable time source shared with the batcher (tests drive
        deadline flushes without sleeping).
    """

    def __init__(self, problem: InfluenceProblem,
                 config: HypergradConfig | Any = None, *,
                 params: Any = None, source: Any = None,
                 store: SketchStore | None = None,
                 top_k: int = 10, batch_size: int | None = None,
                 block_size: int = 8, max_delay: float = 0.01,
                 deadline_slack: float = 0.0, max_queue: int = 64,
                 train_steps: int | None = None, seed: int = 0,
                 indices: dict | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if config is None:
            config = HypergradConfig()
        self.solver = (config.build() if isinstance(config, HypergradConfig)
                       else config)
        self.problem = problem
        self.source = problem.data if source is None else source
        d = {**_TRAIN_DEFAULTS, **problem.defaults}
        self.batch_size = batch_size if batch_size is not None else d['batch_size']
        self.top_k = top_k
        self.store = store if store is not None else SketchStore()
        self.clock = clock
        self.max_queue = max_queue
        self.seed = seed
        self._indices = indices

        if params is None:
            params = train_influence_params(problem, train_steps=train_steps,
                                            batch_size=self.batch_size,
                                            seed=seed)
        self.params = params
        self._indexer = PyTreeIndexer(params)
        self._hvp = influence_curvature_hvp(problem, params, self.source,
                                            self.batch_size)
        self._amortizable = getattr(type(self.solver), 'amortizable', False)
        self._key = (sketch_key(params, self.solver)
                     if self._amortizable else None)
        self._fallback = CGIHVP(rho=getattr(self.solver, 'rho', 1e-3))
        self._scan = make_topk_scanner(problem.loss, params, self.source,
                                       self.batch_size)
        loss = problem.loss
        # one example (no leading axis) → its gradient tree
        self._qgrad = grad(lambda p, example: loss(
            p, tree_map(lambda x: x[None], example)))
        self.batcher = QueryBatcher(block_size=block_size,
                                    max_delay=max_delay,
                                    deadline_slack=deadline_slack,
                                    clock=clock)
        self._requests: dict[int, InfluenceRequest] = {}
        self._responses: dict[int, InfluenceResponse] = {}

        # ----- run metrics (feed bench_rows) -----
        self.latencies: list[float] = []
        self.queue_depths: list[int] = []
        self.flush_ms: list[float] = []
        self.total_queries = 0
        self.total_build_hvps = 0
        self.total_fallback_hvps = 0
        self.degraded_flushes = 0
        self.deadline_misses = 0
        self.busy_seconds = 0.0

    # ------------------------------------------------------------ submit
    def submit(self, example: Any, *, deadline_s: float | None = None) -> int:
        """Park one query example (a single unbatched tree); returns its
        ticket. ``deadline_s`` is a relative latency budget in seconds.
        Raises :class:`ServiceOverloaded` when the queue is full."""
        if len(self.batcher) >= self.max_queue:
            raise ServiceOverloaded(
                f'request queue full ({self.max_queue} pending); '
                'pump() or shed load')
        now = self.clock()
        deadline = None if deadline_s is None else now + deadline_s
        vec = self._qgrad(self.params, example)
        ticket = self.batcher.submit(vec, deadline=deadline)
        self._requests[ticket] = InfluenceRequest(ticket=ticket,
                                                  t_submit=now,
                                                  deadline=deadline)
        self.queue_depths.append(len(self.batcher))
        self.total_queries += 1
        return ticket

    # ------------------------------------------------------------- serve
    def _build(self, solver):
        return solver.prepare(self._hvp, self._indexer,
                              torch.Generator().manual_seed(self.seed),
                              indices=self._indices)

    def _prepared_state(self) -> tuple[Any, bool, bool]:
        """(state, cache_hit, degraded). Amortizable solvers go through the
        store; a failed build degrades to the CG fallback, unless the
        kernels themselves failed."""
        if not self._amortizable:
            return self._build(self.solver), False, False
        bill = influence_build_hvps(self.solver, self.params)
        try:
            state, built = self.store.get_or_build(
                self._key, lambda: self._build(self.solver), build_hvps=bill)
        except KernelError:
            raise
        except Exception:
            log.warning(
                'sketch build failed for %s; degrading this flush to fresh '
                'per-request CG', self._key, exc_info=True)
            return self._build(self._fallback), False, True
        if built:
            self.total_build_hvps += bill
        return state, not built, False

    def _flush_one(self) -> int:
        """Answer one block; returns the number of queries answered."""
        t0 = self.clock()
        V, taken = self.batcher.take_block()
        m = len(taken)
        state, cache_hit, degraded = self._prepared_state()
        solver = self._fallback if degraded else self.solver
        if degraded:
            self.degraded_flushes += 1
            self.total_fallback_hvps += getattr(solver, 'iters', 0) * m
        elif not self._amortizable:
            self.total_fallback_hvps += getattr(solver, 'iters', 0) * m
        S = solver.apply_matrix(state, V)
        vals, idxs = block_until_ready(self._scan(S, self.top_k))
        now = self.clock()
        for j, q in enumerate(taken):
            req = self._requests.pop(q.ticket)
            missed = req.deadline is not None and now > req.deadline
            if missed:
                self.deadline_misses += 1
            latency = now - req.t_submit
            self.latencies.append(latency)
            self._responses[q.ticket] = InfluenceResponse(
                ticket=q.ticket, scores=vals[j], indices=idxs[j],
                latency_s=latency, batched_m=m, cache_hit=cache_hit,
                degraded=degraded, deadline_missed=missed)
        self.flush_ms.append((now - t0) * 1e3)
        self.busy_seconds += now - t0
        self.queue_depths.append(len(self.batcher))
        return m

    def pump(self) -> int:
        """Flush every due block (full, aged out, or deadline-imminent).
        Returns queries answered. The caller's event loop invokes this
        between submissions; it never blocks waiting for block-mates."""
        n = 0
        while self.batcher.due():
            n += self._flush_one()
        return n

    def flush(self) -> int:
        """Force-flush everything pending regardless of due-ness."""
        n = 0
        while len(self.batcher):
            n += self._flush_one()
        return n

    def result(self, ticket: int) -> InfluenceResponse:
        """Pop the response for ``ticket``; raises KeyError if it has not
        been flushed yet (pump()/flush() first)."""
        if ticket not in self._responses:
            raise KeyError(
                f'ticket {ticket} not answered yet '
                f'({len(self.batcher)} queries pending — pump() or flush())')
        return self._responses.pop(ticket)

    def audit_query_path(self, m: int | None = None):
        """The reference audits the warm flush computation's jaxpr against
        its query-path contract (f32 accumulation, no host round trip).
        Stating such contracts against what torch exposes is ROADMAP item
        13 (structural checks), not ported yet: this raises."""
        raise NotImplementedError(
            'audit_query_path needs the program auditor, ROADMAP item 13 '
            '(structural checks), which the port does not have yet')

    # ------------------------------------------------------------ warmup
    def prepare(self) -> bool:
        """Build (or fetch) the sketch ahead of traffic, off the request
        path; returns whether it came warm from the store."""
        _, cache_hit, _ = self._prepared_state()
        return cache_hit

    def reset_metrics(self) -> None:
        """Zero the run metrics (latencies, HVP bill, queue depths) without
        touching the store or the batcher's settings: a run calls this
        after warm-up so that its numbers cover only the serving phase."""
        self.latencies.clear()
        self.queue_depths.clear()
        self.flush_ms.clear()
        self.total_queries = 0
        self.total_build_hvps = 0
        self.total_fallback_hvps = 0
        self.degraded_flushes = 0
        self.deadline_misses = 0
        self.busy_seconds = 0.0
        self.batcher.flushes = 0
        self.batcher.flushed_queries = 0

    def warmup(self, candidates: tuple[int, ...] = (1, 2, 4, 8, 16),
               reps: int = 3) -> dict[int, float]:
        """Build (or fetch) the sketch and calibrate ``block_size`` from a
        small throughput sweep; returns the {m: queries/sec} profile."""
        state, _, degraded = self._prepared_state()
        solver = self._fallback if degraded else self.solver
        template = tree_map(torch.zeros_like, self.params)
        best, rates = calibrate_block_size(
            lambda V: solver.apply_matrix(state, V), template,
            candidates=candidates, reps=reps)
        self.batcher.block_size = best
        log.info('calibrated block_size=%d from sweep %s', best,
                 {m: f'{r:.1f} q/s' for m, r in rates.items()})
        return rates

    # ------------------------------------------------------------- stats
    def stats(self) -> dict[str, Any]:
        """Run-level metric snapshot (plus the store's counters)."""
        lat = sorted(self.latencies)

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        depths = self.queue_depths or [0]
        return {
            'queries': self.total_queries,
            'answered': len(self.latencies),
            'flushes': self.batcher.flushes,
            'latency_mean_ms': (sum(lat) / len(lat) * 1e3) if lat else 0.0,
            'latency_p50_ms': pct(0.50) * 1e3,
            'latency_p95_ms': pct(0.95) * 1e3,
            'latency_max_ms': (lat[-1] * 1e3) if lat else 0.0,
            'queue_depth_mean': sum(depths) / len(depths),
            'queue_depth_max': max(depths),
            'build_hvps': self.total_build_hvps,
            'fallback_hvps': self.total_fallback_hvps,
            'degraded_flushes': self.degraded_flushes,
            'deadline_misses': self.deadline_misses,
            'busy_seconds': self.busy_seconds,
            'store': self.store.stats(),
        }

    def bench_rows(self, *, phase: str = 'serve') -> list[dict[str, Any]]:
        """The run as schema-v2 bench rows (one row per run): identity
        fields (solver, backend, m, problem, phase, cache hit rate) and
        measurements (latency percentiles, queue depth, throughput,
        hvp_count)."""
        s = self.stats()
        backend = getattr(self.solver, 'backend', 'tree')
        backend = backend if isinstance(backend, str) else getattr(
            backend, 'name', type(backend).__name__)
        qps = (s['answered'] / s['busy_seconds']
               if s['busy_seconds'] > 0 else 0.0)
        # repro: allow[bench-row-literal] — src/ cannot import benchmarks/;
        # the rows carry the schema's keys (tests/test_torch_serve.py)
        return [{
            'solver': type(self.solver).__name__,
            'backend': backend,
            'm': self.batcher.block_size,
            'problem': self.problem.name,
            'phase': phase,
            'applies_per_sec': qps,
            'wall_seconds': s['busy_seconds'],
            'hvp_count': s['build_hvps'] + s['fallback_hvps'],
            'cache_hit_rate': round(self.store.hit_rate, 6),
            'latency_mean_ms': s['latency_mean_ms'],
            'latency_p50_ms': s['latency_p50_ms'],
            'latency_p95_ms': s['latency_p95_ms'],
            'latency_max_ms': s['latency_max_ms'],
            'queue_depth_mean': s['queue_depth_mean'],
            'queue_depth_max': s['queue_depth_max'],
            'degraded_flushes': self.degraded_flushes,
            'deadline_misses': self.deadline_misses,
        }]
