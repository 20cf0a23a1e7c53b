"""Problem dependency graphs — multi-level optimization as a typed DAG (the
port's copy of ``repro/engine/graph.py``: pure-Python dataclasses, the
same checks and messages).

A :class:`ProblemNode` is one optimization variable with one scalar
objective; a :class:`ProblemEdge` declares that its ``lower`` node is solved
to stationarity and differentiated through — with the edge's *own* IHVP
solver and sketch cadence — whenever an ``upper`` node's objective is
differentiated. A :class:`ProblemGraph` collects both and validates the
shape (no dangling names, no cycles, one solver per solved node) before
:class:`~repro_torch.engine.engine.Engine` runs it.

Where Betty runs a Python loop of ``.step()`` calls between problems, the
whole inner-to-outer sweep here goes through nested ``implicit_root``
maps, because ``implicit_root`` carries both a jvp and a backward rule,
each differentiable again: an interior node is differentiated from above
(reverse, for the outer update) and from below (forward, inside the HVPs
of the level above it) at once.

The bilevel special case stays a two-node graph::

    graph = from_bilevel(get_problem('logreg_wd'))
    # nodes: {'params', 'hparams'}; one edge params -> hparams

Losses follow the graph-wide signature ``loss(own, ctx, batch)`` where
``ctx`` maps *other* node names to their current values — solved values for
nodes below, live variables for nodes above.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.core.tree_util import PyTree

NodeLoss = Callable[[PyTree, Mapping[str, PyTree], Any], torch.Tensor]


class GraphError(ValueError):
    """A malformed problem graph (cycle, dangling edge, duplicate solver)."""


@dataclasses.dataclass(frozen=True)
class ProblemNode:
    """One optimization variable + objective in a multi-level graph.

    ``loss(own, ctx, batch)`` — ``own`` is this node's variable, ``ctx``
    maps every other node name in scope to its value. ``init(rng)`` builds
    the variable (``rng``: a ``torch.Generator``). ``unroll_steps``/``unroll_lr`` configure the plain-SGD
    inner unroll used when this node is solved implicitly (the forward pass
    of its ``implicit_root`` map; never differentiated through).
    ``data`` is an optional :class:`~repro_torch.core.problem.BatchSource`;
    ``batch_size`` its per-step draw (0 = whole-data, batch is None).
    """
    name: str
    loss: NodeLoss
    init: Callable[[torch.Generator], PyTree]
    data: Any = None
    unroll_steps: int = 20
    unroll_lr: float = 0.1
    batch_size: int = 0


@dataclasses.dataclass(frozen=True)
class ProblemEdge:
    """``lower`` is implicitly solved and differentiated through toward
    ``upper``. ``config`` is the edge's IHVP solver — a
    :class:`~repro_torch.core.hypergrad.HypergradConfig` (its ``solver`` field
    names a ``SOLVERS`` entry), a built solver instance, or None for the
    default Nyström configuration. ``refresh_every`` is the edge's sketch
    cadence under engine-managed amortization (ignored for iterative
    solvers, whose state is trace-local)."""
    lower: str
    upper: str
    config: Any = None
    refresh_every: int = 1


@dataclasses.dataclass
class ProblemGraph:
    """Nodes + typed edges; validated before lowering.

    ``validate`` raises :class:`GraphError` naming the offender for:
    dangling edge endpoints, self-loops, more than one edge solving the
    same ``lower`` node toward different uppers is allowed only as multiple
    uppers reading one solved node — but each solved node has exactly ONE
    solver, so duplicate ``lower`` entries are rejected; cycles in the
    lower→upper direction; and graphs with no top (every node solved).
    """
    nodes: dict[str, ProblemNode]
    edges: list[ProblemEdge]

    # ------------------------------------------------------------ checks
    def validate(self) -> None:
        for name, node in self.nodes.items():
            if node.name != name:
                raise GraphError(
                    f'node key {name!r} disagrees with node.name '
                    f'{node.name!r}')
        if not self.edges:
            raise GraphError('graph has no edges — nothing to solve '
                             'implicitly; use solve() for single problems')
        seen_lower: set[str] = set()
        for e in self.edges:
            for end in (e.lower, e.upper):
                if end not in self.nodes:
                    raise GraphError(
                        f'edge {e.lower!r}->{e.upper!r} references unknown '
                        f'node {end!r}; known: {sorted(self.nodes)}')
            if e.lower == e.upper:
                raise GraphError(f'self-loop on node {e.lower!r}')
            if e.lower in seen_lower:
                raise GraphError(
                    f'node {e.lower!r} is the lower end of two edges — a '
                    'solved node carries exactly one IHVP solver')
            seen_lower.add(e.lower)
        order = self.topo_order()          # raises GraphError on cycles
        if set(order[-1:]) & seen_lower and len(self.tops()) == 0:
            raise GraphError('graph has no top node — every node is solved; '
                             'at least one node must own the outer objective')

    def tops(self) -> list[str]:
        """Nodes never implicitly solved (own the outer objective)."""
        lowers = {e.lower for e in self.edges}
        return [n for n in self.nodes if n not in lowers]

    def edge_for(self, lower: str) -> ProblemEdge:
        for e in self.edges:
            if e.lower == lower:
                return e
        raise GraphError(f'no edge solves node {lower!r}')

    def topo_order(self) -> list[str]:
        """Inner-to-outer topological order over lower→upper edges
        (Kahn's algorithm; deterministic by insertion order). Raises
        :class:`GraphError` on a cycle, naming the strongly-tangled nodes."""
        indeg = {n: 0 for n in self.nodes}
        out: dict[str, list[str]] = {n: [] for n in self.nodes}
        for e in self.edges:
            indeg[e.upper] += 1
            out[e.lower].append(e.upper)
        ready = [n for n in self.nodes if indeg[n] == 0]
        order: list[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in out[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.nodes):
            cyc = sorted(n for n in self.nodes if n not in order)
            raise GraphError(f'cycle through nodes {cyc} — the lower->upper '
                             'relation must be a DAG')
        return order

    def chain_order(self) -> list[str]:
        """The topological order, additionally checked to be a single chain
        (exactly one node per level, consecutive levels linked) — the shape
        ``Engine.solve`` currently lowers. General DAGs validate but need
        the chain restriction lifted to solve."""
        order = self.topo_order()
        lowers = {e.lower: e.upper for e in self.edges}
        for a, b in zip(order[:-1], order[1:]):
            if lowers.get(a) != b:
                raise GraphError(
                    f'graph is not a chain: expected an edge {a!r}->{b!r} '
                    f'in topological order {order}; Engine.solve currently '
                    'lowers chains only (general DAGs validate but are not '
                    'yet solvable)')
        return order


def from_bilevel(problem, config: Any = None,
                 unroll_steps: int = 20, unroll_lr: float = 0.1,
                 refresh_every: int = 1) -> ProblemGraph:
    """Wrap a registered :class:`~repro_torch.core.problem.BilevelProblem` as a
    two-node graph (``params`` solved toward ``hparams``) — the adapter that
    makes every existing problem a degenerate multi-level graph, and the
    parity fixture for Engine-vs-``solve()`` tests."""
    inner = ProblemNode(
        name='params',
        loss=lambda own, ctx, batch: problem.inner_loss(
            own, ctx['hparams'], batch),
        init=problem.init_params,
        unroll_steps=unroll_steps, unroll_lr=unroll_lr)
    outer = ProblemNode(
        name='hparams',
        loss=lambda own, ctx, batch: problem.outer_loss(
            ctx['params'], own, batch),
        init=problem.init_hparams)
    return ProblemGraph(
        nodes={'params': inner, 'hparams': outer},
        edges=[ProblemEdge(lower='params', upper='hparams', config=config,
                           refresh_every=refresh_every)])
