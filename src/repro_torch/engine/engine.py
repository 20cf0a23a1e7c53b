"""Engine — drive a ProblemGraph as nested implicit maps, eagerly.

``Engine.solve(graph, config)`` runs the whole inner-to-outer sweep of a
validated chain graph once per outer step:

* every solved node becomes a nested ``implicit_root`` map, built bottom-up
  so a level's inner loss *contains* the solution maps of every level below
  it — an HVP of that loss is jvp-of-grad through the lower maps, which the
  second-order rules of ``implicit_root`` make possible;
* every edge carries its own IHVP solver (a ``SOLVERS`` entry via
  ``HypergradConfig``) and, when amortizable, its own
  :class:`~repro_torch.core.solvers.SketchPolicy` cadence — sketches are
  carried across outer steps and refreshed inner-to-outer, so a lower
  edge's fresh sketch is already live when the edge above it rebuilds
  (whose build HVPs differentiate through the lower map);
* warm starts are carried per node: each step's unrolls start from the
  previous step's solved values, the same alternating convention as
  ``BilevelTrainer``.

The step runs eagerly, one Python call per outer step (the reference jits
it; ``EngineConfig.jit`` is accepted and does nothing here).

Plumbing: the maps' batch slot (``pack``) holds tensors only — the warm
starts and the data batches — because ``implicit_root`` flattens its batch
into operands, which get zero tangents and cotangents. The carried
sketches, the per-edge column-sampling generators and any injected index
draws reach the maps through a :class:`Plumbing` they read at call time.

The dense oracle (:func:`engine_hypergrad_reference`) rebuilds the *same*
nested maps with exact IHVPs on every edge, so
``hypergrad_error(engine_hypergrad(...), engine_hypergrad_reference(...))``
isolates solver error: both run an identical primal sweep from identical
warm starts and differ only in the per-edge linear solves.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Mapping

import torch
from torch.func import grad, grad_and_value

from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.implicit import implicit_root
from repro_torch.core.solvers import (ExactIHVP, SketchPolicy, SketchState,
                                      build_hvp_bill)
from repro_torch.core.tree_util import (PyTree, tree_flatten, tree_leaves,
                                        tree_map)
from repro_torch.engine.graph import ProblemGraph
from repro_torch.optim import (Optimizer, adam, chain, clip_by_global_norm,
                               momentum, sgd)

# ---------------------------------------------------------------------------
# Config / result
# ---------------------------------------------------------------------------
_OUTER_OPTS = {
    'adam': lambda lr: chain(clip_by_global_norm(10.0), adam(lr)),
    'momentum': lambda lr: chain(clip_by_global_norm(10.0), momentum(lr)),
    'sgd': lambda lr: sgd(lr),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Drive parameters for ``Engine.solve``.

    ``amortize=True`` carries a :class:`SketchState` per amortizable edge
    across outer steps (each edge's ``refresh_every`` cadence applies);
    ``False`` prepares every edge's state fresh inside each derivative pass
    — the Grazzi-style per-step baseline. ``outer_opt`` is an
    ``_OUTER_OPTS`` name or a built :class:`repro_torch.optim.Optimizer`.
    ``seed`` seeds the node inits and the per-step column draws. ``jit`` is
    accepted for the reference's signature and does nothing: the step runs
    eagerly."""
    n_outer: int = 10
    outer_lr: float = 1e-2
    outer_opt: Any = 'adam'
    amortize: bool = True
    seed: int = 0
    jit: bool = True

    def build_outer_opt(self) -> Optimizer:
        if isinstance(self.outer_opt, Optimizer):
            return self.outer_opt
        try:
            return _OUTER_OPTS[self.outer_opt](self.outer_lr)
        except KeyError:
            raise ValueError(
                f'unknown outer_opt {self.outer_opt!r}; expected one of '
                f'{sorted(_OUTER_OPTS)} or an Optimizer instance') from None


@dataclasses.dataclass
class EngineResult:
    """Outcome of ``Engine.solve``: final node values, the top objective per
    outer step, and the analytic per-edge HVP bills
    (:func:`engine_edge_bills` at the run's settings, as the reference
    reports them)."""
    values: dict[str, PyTree]
    losses: list[float]
    edge_hvps: dict[str, int]
    hvp_count: int
    n_outer: int
    seconds: float
    hypergrad_err: float | None = None


# ---------------------------------------------------------------------------
# Map construction — nested implicit_root, bottom-up
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Plumbing:
    """What the maps read besides their operands, per solved node: its live
    solver state (None: prepare fresh inside each derivative pass), its
    column-sampling generator, and an injected index draw (None: sample)."""
    states: dict = dataclasses.field(default_factory=dict)
    rngs: dict = dataclasses.field(default_factory=dict)
    indices: dict = dataclasses.field(default_factory=dict)


def _edge_solver(edge):
    cfg = HypergradConfig() if edge.config is None else edge.config
    return cfg.build() if isinstance(cfg, HypergradConfig) else cfg


def _level_loss(graph: ProblemGraph, order: list[str], i: int,
                maps: dict[str, Callable]) -> Callable:
    """The inner loss of level ``i`` in graph-resolved form:
    ``f_i(theta, phi, pack)`` where ``phi`` maps every node strictly above
    level i to its value. Nodes below are resolved top-down through their
    solution maps (already in ``maps`` — construction is bottom-up), so
    differentiating this loss differentiates through every lower level."""
    name = order[i]
    node = graph.nodes[name]

    def inner_loss(theta: PyTree, phi: Mapping[str, PyTree],
                   pack: dict) -> torch.Tensor:
        ctx = dict(phi)
        ctx[name] = theta
        for j in range(i - 1, -1, -1):
            below = order[j]
            phi_j = {m: ctx[m] for m in order[j + 1:]}
            ctx[below] = maps[below](phi_j, pack)
        own = ctx.pop(name)
        return node.loss(own, ctx, pack['batches'].get(name))

    return inner_loss


def _unroll_solver(node, inner_loss: Callable, name: str) -> Callable:
    """The forward pass of a node's solution map: ``unroll_steps`` plain-SGD
    steps on the level loss from the engine-carried warm start. Matches
    ``sgd_solver`` but draws θ0 from the pack (per-node warm start).

    A map's forward runs on plain tensors (the map is an autograd Function),
    so each step's gradient is taken with ``torch.autograd``, at about a
    third of ``torch.func.grad``'s host cost a call: the unrolls nest, and
    a middle level's unroll runs the whole lower unroll at each of its
    steps. Under a ``torch.func`` transform (a task-batched map) it is
    ``torch.func.grad``."""
    grad_fn = grad(inner_loss)

    def gradient(theta, phi, pack):
        if torch._C._are_functorch_transforms_active():
            return grad_fn(theta, phi, pack)
        leaves, tdef = tree_flatten(theta)
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            loss = inner_loss(tdef.unflatten(leaves), phi, pack)
            return tdef.unflatten(list(torch.autograd.grad(loss, leaves)))

    def solver_fn(phi, pack):
        theta = pack['warm'][name]
        for _ in range(node.unroll_steps):
            g = gradient(theta, phi, pack)
            with torch.no_grad():
                theta = tree_map(lambda w, gw: w - node.unroll_lr * gw,
                                 theta, g)
        return theta

    return solver_fn


def build_maps(graph: ProblemGraph, order: list[str],
               solvers: Mapping[str, Any] | None = None,
               plumbing: Plumbing | None = None
               ) -> tuple[dict[str, Callable], dict[str, Callable]]:
    """Build the nested solution maps for a chain, bottom-up.

    Returns ``(maps, losses)``: ``maps[name](phi, pack) -> theta*`` for every
    solved node (``phi`` = values of all nodes strictly above it, ``pack`` =
    the warm starts and batches riding the zero-tangent batch slot), and
    ``losses[name]`` the graph-resolved level losses (what each edge's
    :class:`SketchPolicy` builds sketches of). ``solvers`` overrides the
    per-edge solver (name → built instance); defaults to each edge's own
    config — the override is how the dense oracle swaps every edge to
    ``ExactIHVP`` without touching the graph. ``plumbing`` carries the
    states, generators and draws the maps read at call time (default: none
    of them, so every derivative pass prepares fresh from seed 0)."""
    plumbing = Plumbing() if plumbing is None else plumbing
    maps: dict[str, Callable] = {}
    losses: dict[str, Callable] = {}
    for i, name in enumerate(order[:-1]):
        node = graph.nodes[name]
        solver = (solvers[name] if solvers is not None
                  else _edge_solver(graph.edge_for(name)))
        inner_loss = _level_loss(graph, order, i, maps)
        root = implicit_root(_unroll_solver(node, inner_loss, name),
                             inner_loss, solver)

        def mapped(phi, pack, _name=name, _root=root):
            return _root(phi, pack, rng=plumbing.rngs.get(_name),
                         state=plumbing.states.get(_name),
                         indices=plumbing.indices.get(_name))

        maps[name] = mapped
        losses[name] = inner_loss
    return maps, losses


def _top_objective(graph: ProblemGraph, order: list[str],
                   maps: Mapping[str, Callable]) -> Callable:
    """``(theta_top, pack) -> (loss, solved)``: the outer objective with the
    full chain resolved below it; ``solved`` (the aux) carries every solved
    node's value out for the warm-start carry."""
    top = order[-1]

    def objective(theta_top: PyTree, pack: dict):
        ctx = {top: theta_top}
        for j in range(len(order) - 2, -1, -1):
            below = order[j]
            phi_j = {m: ctx[m] for m in order[j + 1:]}
            ctx[below] = maps[below](phi_j, pack)
        own = ctx.pop(top)
        return graph.nodes[top].loss(own, ctx, pack['batches'].get(top)), ctx

    return objective


def _edge_rngs(seed: int, step: int, solved: list[str]) -> dict:
    """One column-sampling generator per edge for one step (the reference
    folds the step and the edge's index into its key)."""
    return {n: torch.Generator().manual_seed(
        (seed * 1_000_003 + step) * 1_009 + idx)
        for idx, n in enumerate(solved)}


def _pack(values: Mapping[str, PyTree], solved: list[str]) -> dict:
    return {'warm': {n: values[n] for n in solved}, 'batches': {}}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EngineProgram:
    """The lowered form of a graph: ``init(values=None) -> carry`` and
    ``step(carry, i, draws=None) -> (carry, loss)``, one outer step ``i``
    (``draws``: an index draw per edge, injected into its sketch build and
    fresh prepares). ``top_gradient(values) -> (grad, loss)`` is the top
    objective's gradient at ``values`` against the edges' live states (the
    last step's sketches: no prepare). ``plumbing`` is what the maps
    read."""
    init: Callable[..., tuple]
    step: Callable[..., tuple]
    top_gradient: Callable[..., tuple]
    order: list[str]
    plumbing: Plumbing


class Engine:
    """Lowers a :class:`ProblemGraph` chain and drives it.

    ``lower`` builds the program; ``solve`` runs it. One Engine instance is
    stateless and reusable."""

    def lower(self, graph: ProblemGraph,
              config: EngineConfig | None = None) -> EngineProgram:
        config = config or EngineConfig()
        graph.validate()
        order = graph.chain_order()
        solved = order[:-1]
        top = order[-1]
        solvers = {n: _edge_solver(graph.edge_for(n)) for n in solved}
        plumbing = Plumbing()
        maps, losses = build_maps(graph, order, solvers, plumbing)
        objective = grad_and_value(_top_objective(graph, order, maps),
                                   has_aux=True)
        outer_opt = config.build_outer_opt()

        policies = {
            n: SketchPolicy(solver=solvers[n], inner_loss=losses[n],
                            refresh_every=graph.edge_for(n).refresh_every)
            for n in solved
            if config.amortize and getattr(type(solvers[n]), 'amortizable',
                                           False)}

        def init(values: Mapping[str, PyTree] | None = None) -> tuple:
            if values is None:
                gen = torch.Generator().manual_seed(config.seed)
                values = {n: graph.nodes[n].init(gen) for n in order}
            values = dict(values)
            # stale states: the first step's refresh builds them, so
            # initialization costs no HVPs and cadence is uniform from step 0
            sk = {n: policies[n].init_state() for n in policies}
            return (values, outer_opt.init(values[top]), sk, 0)

        def step(carry: tuple, i: int, draws: Mapping | None = None
                 ) -> tuple:
            values, opt_state, sk, t = carry
            draws = dict(draws or {})
            plumbing.rngs = _edge_rngs(config.seed, 1 + i, solved)
            plumbing.indices = {n: draws.get(n) for n in solved}
            plumbing.states = {m: (sk[m].sketch if m in sk else None)
                               for m in solved}
            pack = _pack(values, solved)

            # 1. linearize + refresh, interleaved inner-to-outer. A level's
            #    unroll *differentiates* every edge below it (its level loss
            #    contains the lower maps), and an edge's build HVPs do too —
            #    so each edge must see this step's fresh lower sketches
            #    before it is itself unrolled or rebuilt. On non-refresh
            #    steps (cadence > 1) the carried sketch serves.
            new_sk: dict[str, SketchState] = {}
            for j, n in enumerate(solved):
                phi_j = {m: values[m] for m in order[j + 1:]}
                lin = maps[n](phi_j, pack)
                if n in policies:
                    new_sk[n], _ = policies[n].refresh(
                        sk[n], lin, phi_j, pack, plumbing.rngs[n],
                        indices=draws.get(n))
                    plumbing.states[n] = new_sk[n].sketch

            # 2. outer gradient with every edge's live state, then the
            #    outer-optimizer update; solved values (the aux) become the
            #    next step's warm starts
            g, (loss, solved_vals) = objective(values[top], pack)
            new_top, opt_state = outer_opt.apply(g, opt_state, values[top], t)
            new_values = {**solved_vals, top: new_top}
            return (new_values, opt_state, new_sk, t + 1), loss

        def top_gradient(values: Mapping[str, PyTree]) -> tuple:
            g, (loss, _) = objective(values[top], _pack(values, solved))
            return g, loss

        return EngineProgram(init=init, step=step, top_gradient=top_gradient,
                             order=order, plumbing=plumbing)

    def solve(self, graph: ProblemGraph, config: EngineConfig | None = None,
              *, values: Mapping[str, PyTree] | None = None,
              indices: list[Mapping] | None = None) -> EngineResult:
        """Run the program for ``config.n_outer`` outer steps.

        ``values`` replaces the seeded initial node values; ``indices``
        gives, per outer step, an index draw per edge (the parity tests
        inject the reference's). The graph's tensors set the device."""
        config = config or EngineConfig()
        program = self.lower(graph, config)
        carry = program.init(values)
        losses: list[float] = []
        _sync(carry[0])
        t0 = time.perf_counter()
        for i in range(config.n_outer):
            carry, loss = program.step(
                carry, i, None if indices is None else indices[i])
            losses.append(float(loss))
        seconds = time.perf_counter() - t0
        bills = engine_edge_bills(graph, n_outer=config.n_outer,
                                  amortize=config.amortize)
        return EngineResult(values=carry[0], losses=losses, edge_hvps=bills,
                            hvp_count=sum(bills.values()),
                            n_outer=config.n_outer, seconds=seconds)


def _sync(values) -> None:
    leaves = tree_leaves(values)
    if leaves and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


# ---------------------------------------------------------------------------
# Oracle + accounting
# ---------------------------------------------------------------------------
def engine_hypergrad(graph: ProblemGraph, values: Mapping[str, PyTree],
                     solvers: Mapping[str, Any] | None = None,
                     rng: torch.Generator | None = None, *,
                     indices: Mapping | None = None
                     ) -> tuple[PyTree, torch.Tensor]:
    """One top-level hypergradient at explicit node ``values``.

    Rebuilds the nested maps (per-edge ``solvers`` override, else the
    graph's own edge configs), warm-starts every unroll from ``values``, and
    differentiates the top objective — the multi-level analogue of
    :func:`repro_torch.core.problem.hypergrad_at`. States are prepared fresh
    inside the derivative pass (no amortization), each edge with its own
    generator seeded from ``rng`` (default: seed 0) or its injected draw in
    ``indices`` (edge → draw). Returns ``(grad, loss)``."""
    graph.validate()
    order = graph.chain_order()
    solved = order[:-1]
    built = {n: (solvers[n] if solvers is not None
                 else _edge_solver(graph.edge_for(n))) for n in solved}
    base = (0 if rng is None
            else int(torch.randint(2 ** 62, (1,), generator=rng)))
    plumbing = Plumbing(rngs=_edge_rngs(base, 0, solved),
                        indices=dict(indices or {}))
    maps, _ = build_maps(graph, order, built, plumbing)
    objective = _top_objective(graph, order, maps)
    g, (loss, _) = grad_and_value(objective, has_aux=True)(
        values[order[-1]], _pack(values, solved))
    return g, loss


def engine_hypergrad_reference(graph: ProblemGraph,
                               values: Mapping[str, PyTree],
                               rho: float = 0.0) -> tuple[PyTree, torch.Tensor]:
    """Dense-oracle top hypergradient: the same nested sweep with every edge
    solved by ``ExactIHVP(rho)`` (full column scan + dense factorization per
    edge). ``rho=0`` is the true multi-level implicit gradient; pass an
    edge's damping to isolate sketch error from damping bias. Toy sizes
    only."""
    order = graph.chain_order()
    oracle = {n: ExactIHVP(rho=rho) for n in order[:-1]}
    return engine_hypergrad(graph, values, solvers=oracle)


def _per_build(graph: ProblemGraph, name: str, solver) -> int:
    """HVPs one state build costs on edge ``name``. Delegates to
    :func:`repro_torch.core.solvers.build_hvp_bill` — the same bill
    definition ``influence()`` and the store's per-entry accounting use. The
    node's shapes come from its ``init`` run on the ``meta`` device (no
    data, no RNG work)."""
    with torch.device('meta'):
        shapes = graph.nodes[name].init(torch.Generator())
    return build_hvp_bill(solver, shapes)


def engine_edge_bills(graph: ProblemGraph, n_outer: int,
                      amortize: bool = True) -> dict[str, int]:
    """Analytic per-edge HVP bills for ``n_outer`` engine steps.

    The multi-level extension of :func:`repro_torch.core.problem.
    accounted_hvps`:

    * **amortized** (default): each amortizable edge pays per *build* —
      ``ceil(n_outer / refresh_every) × k`` — and builds stack *additively*
      across levels, because a lower edge's live sketch makes its derivative
      rule free of prepare HVPs no matter how many times an upper build
      differentiates through it.
    * **fresh** (``amortize=False``): every derivative pass through an edge
      re-prepares, and passes *multiply* down the chain — an upper edge's
      k-probe prepare differentiates the lower map k+1 times, each spawning
      a full lower prepare. The model counts derivative-rule invocations per
      outer step by the recursion below (primal unrolls of a level also
      differentiate every lower map once per SGD step).

    Iterative edges (CG/Neumann) pay ``iters`` sequential HVPs per rule
    invocation in either mode. This is a rule-invocation cost model: exact
    for amortized sketch edges, and the same counting convention as the
    paper's cost tables elsewhere.
    """
    order = graph.chain_order()
    solved = order[:-1]
    solvers = {n: _edge_solver(graph.edge_for(n)) for n in solved}
    amortizable = {n: getattr(type(solvers[n]), 'amortizable', False)
                   for n in solved}

    # rule invocations (druns) and primal map evaluations (evals) per outer
    # step, propagated outer -> inner so spawned work cascades down the chain
    evals = {n: 1 for n in solved}   # the top objective resolves every map
    druns = {n: 1 for n in solved}   # ... and the top grad differentiates it
    for i in range(len(solved) - 1, 0, -1):
        n = solved[i]
        spawned = evals[n] * graph.nodes[n].unroll_steps
        if amortizable[n] and amortize:
            deriv_passes = druns[n]              # mixed term only; no probes
        elif amortizable[n]:
            deriv_passes = druns[n] * (_per_build(graph, n, solvers[n]) + 1)
        else:
            deriv_passes = druns[n] * (getattr(solvers[n], 'iters', 0) + 1)
        for m in solved[:i]:
            evals[m] += spawned + deriv_passes
            druns[m] += spawned + deriv_passes

    bills: dict[str, int] = {}
    for n in solved:
        if amortizable[n] and amortize:
            builds = math.ceil(n_outer
                               / max(1, graph.edge_for(n).refresh_every))
            bills[n] = builds * _per_build(graph, n, solvers[n])
        elif amortizable[n]:
            bills[n] = n_outer * druns[n] * _per_build(graph, n, solvers[n])
        else:
            bills[n] = n_outer * druns[n] * getattr(solvers[n], 'iters', 0)
    return bills
