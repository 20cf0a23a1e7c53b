"""QueryBatcher: adaptive micro-batching of IHVP queries into (p, m) blocks.

The counterpart of ``repro/serve/batcher.py``. ``apply_matrix`` answers m
queries against one sketch in one set of passes over C (kernel A's cross
and kernel C's block form on ``backend='cuda'``), near-flat in cost in m
until the passes saturate, so a serving loop should batch. But a query
parked waiting for block-mates is a query not answered. This module makes
that trade a setting instead of a caller decision:

  * queries accumulate until the block is full (``block_size``), the
    oldest query has waited ``max_delay`` seconds, or a per-query deadline
    is about to expire, whichever comes first;
  * ``block_size`` itself can be calibrated from a small warm-up sweep
    (:func:`calibrate_block_size`) that measures per-query throughput at
    candidate widths against the live sketch.

The clock is injectable (``clock=``) so tests drive deadline and delay
flushes without sleeping.

Blocks stack query trees along a new trailing axis, the (p, m) layout
``apply_matrix`` takes, and results are scattered back per query by slicing
that axis. At m = 1 the solvers strip the axis and run the vector apply, so
a single query flushed through the batcher is bitwise equal to calling
``solver.apply`` directly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.core.tree_util import tree_leaves, tree_map


@dataclasses.dataclass
class PendingQuery:
    """One parked query vector awaiting a flush."""
    ticket: int
    vector: Any                       # tree, same structure as params
    t_submit: float
    deadline: float | None = None     # absolute clock time, or None

    def latest_flush(self, max_delay: float, slack: float) -> float:
        """The clock time by which this query must be in a flush."""
        t = self.t_submit + max_delay
        if self.deadline is not None:
            t = min(t, self.deadline - slack)
        return t


def stack_block(vectors: list[Any]) -> Any:
    """Stack m query trees into one (p, m) block (new trailing axis)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=-1), *vectors)


def split_block(block: Any, m: int) -> list[Any]:
    """Inverse of :func:`stack_block`: the m per-query columns."""
    return [tree_map(lambda x: x[..., j], block) for j in range(m)]


def block_until_ready(tree: Any) -> Any:
    """Wait for the card to finish the work that produces ``tree``'s
    tensors (``jax.block_until_ready``'s counterpart); nothing to wait for
    on the CPU. Returns ``tree``."""
    for dev in {x.device for x in tree_leaves(tree)
                if isinstance(x, torch.Tensor) and x.device.type == 'cuda'}:
        torch.cuda.synchronize(dev)
    return tree


class QueryBatcher:
    """Accumulates query vectors; decides when a (p, m) flush is due.

    Parameters
    ----------
    block_size:
        Target m. A flush is due the moment this many queries are parked.
    max_delay:
        Seconds the oldest parked query may wait before a partial flush.
        0 means flush-on-submit (no batching).
    deadline_slack:
        Seconds before a query's deadline at which a flush is forced:
        headroom for the apply itself. Only matters for queries submitted
        with explicit deadlines.
    clock:
        Monotonic time source; injectable for deterministic tests.
    """

    def __init__(self, block_size: int = 8, max_delay: float = 0.01, *,
                 deadline_slack: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if block_size < 1:
            raise ValueError(f'block_size must be >= 1, got {block_size}')
        if max_delay < 0:
            raise ValueError(f'max_delay must be >= 0, got {max_delay}')
        self.block_size = block_size
        self.max_delay = max_delay
        self.deadline_slack = deadline_slack
        self.clock = clock
        self._pending: list[PendingQuery] = []
        self._next_ticket = 0
        self.flushes = 0
        self.flushed_queries = 0

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, vector: Any, *, deadline: float | None = None) -> int:
        """Park one query vector; returns its ticket."""
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append(PendingQuery(ticket=ticket, vector=vector,
                                          t_submit=self.clock(),
                                          deadline=deadline))
        return ticket

    def due(self, now: float | None = None) -> bool:
        """Is a flush due? Full block, aged-out oldest query, or an
        imminent deadline."""
        if not self._pending:
            return False
        if len(self._pending) >= self.block_size:
            return True
        now = self.clock() if now is None else now
        return any(q.latest_flush(self.max_delay, self.deadline_slack) <= now
                   for q in self._pending)

    def next_due_at(self) -> float | None:
        """Clock time of the next forced flush (None when the queue is
        empty). A pump loop sleeps until min(this, next submission)."""
        if not self._pending:
            return None
        return min(q.latest_flush(self.max_delay, self.deadline_slack)
                   for q in self._pending)

    def take_block(self) -> tuple[Any, list[PendingQuery]]:
        """Pop the oldest ≤ block_size queries as one (p, m) block.

        Returns ``(block, taken)``; callers apply the block and scatter the
        result columns back to ``taken`` in order (``split_block``). Raises
        if the queue is empty: guard with ``len(batcher)``.
        """
        if not self._pending:
            raise ValueError('take_block() on an empty batcher')
        taken = self._pending[:self.block_size]
        self._pending = self._pending[self.block_size:]
        self.flushes += 1
        self.flushed_queries += len(taken)
        return stack_block([q.vector for q in taken]), taken


def calibrate_block_size(apply_block: Callable[[Any], Any], template: Any,
                         candidates: tuple[int, ...] = (1, 2, 4, 8, 16),
                         reps: int = 3) -> tuple[int, dict[int, float]]:
    """Pick the throughput-optimal m from a small warm-up sweep.

    ``apply_block(V)`` is the service's block apply closed over the live
    sketch state; ``template`` is one query-shaped tree used to build
    synthetic blocks. Each candidate m is timed over ``reps`` applies (after
    one untimed warm-up that takes first-call set-up) and scored as queries
    per second; returns ``(best_m, {m: queries_per_sec})``.

    The sweep is O(len(candidates) · reps) block applies against an already
    built sketch (no HVPs), run once at service start, not per request.
    """
    rates: dict[int, float] = {}
    for m in candidates:
        block = tree_map(
            lambda x: x[..., None].expand(*x.shape, m).contiguous(), template)
        block_until_ready(apply_block(block))          # warm-up
        t0 = time.perf_counter()
        for _ in range(reps):
            block_until_ready(apply_block(block))
        dt = time.perf_counter() - t0
        rates[m] = (m * reps) / dt if dt > 0 else float('inf')
    best = max(rates, key=lambda m: (rates[m], -m))
    return best, rates
