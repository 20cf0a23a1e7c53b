"""The solver observatory: PROBLEMS × SOLVERS × accuracy-knob sweeps.

One measurement primitive — ``hypergrad_at`` at a fixed linearization point
(θ_T, φ), scored against the exact-IHVP oracle — swept over

  * the **problem axis**: any registered ``PROBLEMS`` builder at toy size
    (``parse_problem_spec``'s ``name:kw=v`` syntax picks the size),
  * the **population axis**: T variants of the problem (seeds by default,
    or an explicit ``vary`` axis such as imbalance factors), measured
    under ONE ``torch.func.vmap`` (the solution map's task rule runs the
    solver once per member on plain tensors, so the kernels see real
    device pointers),
  * the **solver axis**: any subset of the ``SOLVERS`` registry, and
  * the **grid axis**: accuracy knobs (Nyström k, CG/Neumann iterations,
    damping ρ, Neumann α). Each solver sweeps exactly the grid keys its
    ``SolverSpec`` consumes — ``exact`` ignores ``k``, a newly registered
    solver opts into the sweep by listing its knobs in its spec.

Each cell yields a :class:`SweepCell`: relative hypergradient error vs the
oracle (mean and max over the population), the per-hypergradient HVP bill
(``accounted_hvps`` — the same arithmetic ``solve`` reports), and measured
wall time.

The population is built once per problem (inner-SGD adaptation to θ_T and
the p-HVP oracle are shared by every cell), so adding a solver or a grid
point costs only that cell's own measurement.

Draws come from outside where the caller gives them (the parity tests
inject the reference's): each member's θ₀ and φ, its sketch columns, and
the data sources' batch ``draw``. Without them every draw comes from a
``torch.Generator`` seeded from ``seed``. Every entry point runs on the
card unless it is given ``device='cpu'``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.problem import (BilevelProblem, _check_device,
                                      _stack_draws, _sync, accounted_hvps,
                                      get_problem, hypergrad_at,
                                      hypergrad_error, hypergrad_reference,
                                      resolved_defaults)
from repro_torch.core.solvers import SOLVERS
from repro_torch.core.tree_util import (PyTree, PyTreeIndexer, tree_leaves,
                                        tree_map)
from repro_torch.device import resolve_device

# Toy-size default sweep set: small enough that the exact-IHVP oracle
# (p HVPs + a dense p×p solve, per population member) runs on a CPU.
DEFAULT_PROBLEM_SPECS = (
    'logreg_wd:D=8:n=60',
    'distillation:n_per_class=1:image_size=8:width=16',
    'reweighting:d=8:width=16',
)

# Accuracy knobs swept by default. Keys are HypergradConfig field names:
# ``k`` doubles as the iteration count l for CG/Neumann (the registry's
# field renames), ``rho`` reaches nystrom/cg/exact, ``alpha`` neumann only.
DEFAULT_GRID: dict[str, tuple] = {'k': (2, 5, 10), 'rho': (1e-2,)}

# The oracle materializes the full inner Hessian: p HVPs + an O(p³) solve
# per population member. Refuse quietly-quadratic mistakes above this.
DEFAULT_MAX_ORACLE_P = 20_000

# The reference's salts for its per-member draws (fold_in(rng, t) for θ₀,
# fold_in(rng, 10_000 + t) for φ, fold_in(rng, 777) for the sketch keys);
# here they seed the members' torch.Generators.
_PARAMS_SALT, _HPARAMS_SALT, _SKETCH_SALT = 0, 10_000, 777

_AUDIT_MSG = ('audit=True needs the program-structure auditor, which the '
              'port does not have yet (ROADMAP.md queue 1, item 13)')


# ---------------------------------------------------------------------------
# Spec mini-language
# ---------------------------------------------------------------------------
def _parse_value(text: str):
    """int → float → bool → str, first that parses."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text.lower() in ('true', 'false'):
        return text.lower() == 'true'
    return text


def parse_problem_spec(spec: str) -> tuple[str, dict]:
    """``'name:kw=v:kw=v'`` → (name, builder kwargs).

    Colons separate the kwargs so commas stay free as the list separator in
    ``--problems a,b,c``:

    >>> parse_problem_spec('logreg_wd:D=8:n=60')
    ('logreg_wd', {'D': 8, 'n': 60})
    >>> parse_problem_spec('reweighting')
    ('reweighting', {})
    """
    name, *parts = spec.split(':')
    kwargs = {}
    for part in parts:
        if '=' not in part:
            raise ValueError(
                f'bad problem spec part {part!r} in {spec!r} '
                "(expected 'name:kw=v:kw=v')")
        key, _, val = part.partition('=')
        kwargs[key] = _parse_value(val)
    return name, kwargs


def parse_grid(text: str) -> dict[str, tuple]:
    """``'k=2:4:8,rho=0.01'`` → ``{'k': (2, 4, 8), 'rho': (0.01,)}``.

    Commas separate axes, colons separate an axis's values:

    >>> parse_grid('k=2:4,rho=0.01:0.1')
    {'k': (2, 4), 'rho': (0.01, 0.1)}
    """
    grid = {}
    for axis in filter(None, text.split(',')):
        if '=' not in axis:
            raise ValueError(f'bad grid axis {axis!r} in {text!r} '
                             "(expected 'key=v1:v2:...')")
        key, _, vals = axis.partition('=')
        grid[key] = tuple(_parse_value(v) for v in vals.split(':'))
    return grid


def parse_vary(text: str) -> tuple[str, tuple]:
    """``'imbalance=10,100'`` → ``('imbalance', (10, 100))`` — an explicit
    population axis (builder kwarg × values) instead of the seed default.

    >>> parse_vary('imbalance=10,100')
    ('imbalance', (10, 100))
    """
    if '=' not in text:
        raise ValueError(f'bad vary spec {text!r} '
                         "(expected 'builder_kwarg=v1,v2,...')")
    key, _, vals = text.partition('=')
    return key, tuple(_parse_value(v) for v in vals.split(','))


def solver_grid_points(solver: str, grid: dict[str, tuple]) -> list[dict]:
    """The grid cells a solver actually sweeps: the product of the grid axes
    whose keys its ``SolverSpec`` consumes (others are simply not its dials).

    >>> solver_grid_points('exact', {'k': (2, 4), 'rho': (0.01,)})
    [{'rho': 0.01}]
    >>> solver_grid_points('neumann', {'k': (2, 4), 'rho': (0.01,)})
    [{'k': 2}, {'k': 4}]
    """
    if solver not in SOLVERS:
        raise ValueError(
            f'unknown solver {solver!r}; registered: {sorted(SOLVERS)}')
    axes = [(key, vals) for key, vals in grid.items()
            if key in SOLVERS[solver].fields]
    if not axes:
        return [{}]
    keys = [k for k, _ in axes]
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(vals for _, vals in axes))]


# ---------------------------------------------------------------------------
# Population construction (shared across every cell of a problem)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PopulationBundle:
    """A measured problem population, frozen at its linearization points.

    ``theta``/``phi``/``inner_b``/``outer_b`` all carry a leading task axis
    of size ``tasks``; ``reference`` is the stacked exact-IHVP oracle
    hypergradient at those points (computed once, reused by every cell).
    ``problem`` is the variant-0 build — its loss *functions* are shared by
    all variants (data enters only through the stacked batches).
    ``sketch_indices(k)`` is the members' column draw of k columns, stacked
    on the task axis: the same draw for every cell of one k, as the
    reference's fixed per-member keys give. ``seconds`` holds the build's
    wall time by part (``adapt``, ``oracle``)."""
    problem: BilevelProblem
    spec: str                 # the 'name:kw=v' spec this was built from
    tasks: int
    p: int                    # inner parameter count (the oracle's HVP bill)
    theta: PyTree             # adapted inner params θ_T, stacked
    phi: PyTree               # outer variables φ, stacked
    inner_b: Any
    outer_b: Any
    sketch_indices: Callable[[int], dict]
    reference: PyTree         # oracle hypergradients, stacked
    oracle_rho: float
    seconds: dict = dataclasses.field(default_factory=dict)


def _stack(trees: list) -> PyTree:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _member(tree: PyTree, t: int) -> PyTree:
    return tree_map(lambda x: x[t], tree)


def _generator(seed: int, *salt: int) -> torch.Generator:
    """A CPU generator for one (seed, salt) stream: the port's fold_in."""
    state = np.random.SeedSequence([seed, *salt]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def _params_size(problem: BilevelProblem) -> int:
    """p from the problem's init on fake tensors: nothing is allocated (the
    reference's ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        shapes = problem.init_params(torch.Generator().manual_seed(0))
    return sum(int(math.prod(s.shape)) for s in tree_leaves(shapes))


def build_population(spec: str, *, tasks: int = 3,
                     vary: tuple[str, tuple] | None = None,
                     steps: int | None = None, batch_size: int | None = None,
                     seed: int = 0, oracle_rho: float = 0.0,
                     max_oracle_p: int = DEFAULT_MAX_ORACLE_P,
                     theta0: PyTree | None = None, phi: PyTree | None = None,
                     draw: Callable | None = None,
                     sketch_indices: Callable[[int, int], dict] | None = None,
                     device=None) -> PopulationBundle:
    """Build a problem population and its oracle references.

    Variants: ``vary=None`` sweeps the builder's ``seed`` over
    ``seed+0..seed+tasks-1``; ``vary=('imbalance', (10, 100))`` sweeps that
    builder kwarg instead (``tasks`` is then its value count). Each variant
    contributes one population member: fresh (θ₀, φ) from its init
    functions, step-``t`` batches from its data source, and θ_T from
    ``steps`` full-batch inner-SGD steps on its inner batch (defaults from
    ``resolved_defaults`` — the problem's own training protocol), all
    members at once under ``torch.func.vmap``. The adaptation matters:
    several tasks are degenerate at θ₀ (e.g. logreg's mixed term vanishes
    at w=0), so errors are only meaningful at θ_T.

    Meta-problems (``EpisodeSource``) draw the population from
    ``task_batch`` instead: ``tasks`` episodes, θ₀ = φ = the meta-init,
    per-episode proximal adaptation — the same geometry ``solve``'s
    ``vmap_tasks`` path differentiates through.

    Injected draws: ``theta0``/``phi`` are the members' initial points,
    stacked (on a meta-problem ``phi`` is the stacked meta-init and θ₀ is
    φ); ``draw`` becomes every variant's ``ArraySource.draw``;
    ``sketch_indices(t, k)`` gives member t's column draw of k columns.
    Without them, member t's θ₀, φ and columns come from generators seeded
    from (``seed``, salt, t). The oracle is ``hypergrad_reference`` at
    ρ = ``oracle_rho``, vmapped over the members as the cells are.
    """
    device = resolve_device(device)
    name, kwargs = parse_problem_spec(spec)
    if vary is not None:
        key, values = vary
        variants = [{**kwargs, key: v} for v in values]
        tasks = len(variants)          # the vary axis IS the population
    else:
        variants = [{**kwargs, 'seed': seed + t} for t in range(tasks)]

    problems = [get_problem(name, **v, device=device) for v in variants]
    problem = problems[0]
    p = _params_size(problem)
    if p > max_oracle_p:
        raise ValueError(
            f'problem {spec!r} has p={p} inner parameters; the exact-IHVP '
            f'oracle costs p HVPs + a dense p×p solve per task '
            f'(max_oracle_p={max_oracle_p}). Sweep a toy size '
            f"(e.g. {DEFAULT_PROBLEM_SPECS[0]!r}) or raise max_oracle_p")
    d = resolved_defaults(problem, steps_per_outer=steps,
                          batch_size=batch_size)

    if hasattr(problem.data, 'task_batch'):
        if vary is not None:
            raise ValueError(
                f'--vary is not supported for meta-problem {name!r}: its '
                'population axis is the episode draw from task_batch')
        inner_b, outer_b = problem.data.task_batch(0, tasks)
        if phi is None:
            phi0 = problem.init_hparams(_generator(seed, _HPARAMS_SALT))
            phi = tree_map(
                lambda x: x.expand((tasks,) + x.shape).contiguous(), phi0)
        theta0 = phi                      # adapt from the meta-init, as iMAML
    else:
        if draw is not None:
            for pb in problems:
                pb.data.draw = draw
        inner_b = _stack([pb.data.train_batch(t, d['batch_size'])
                          for t, pb in enumerate(problems)])
        outer_b = _stack([pb.data.val_batch(t, d['batch_size'])
                          for t, pb in enumerate(problems)])
        if theta0 is None:
            theta0 = _stack([pb.init_params(_generator(seed, _PARAMS_SALT, t))
                             for t, pb in enumerate(problems)])
        if phi is None:
            phi = _stack([pb.init_hparams(_generator(seed, _HPARAMS_SALT, t))
                          for t, pb in enumerate(problems)])

    lr, n_steps = d['inner_lr'], d['steps_per_outer']
    inner_grad = grad(problem.inner_loss)

    def adapt(th, ph, batch):
        for _ in range(n_steps):
            g = inner_grad(th, ph, batch)
            th = tree_map(lambda w, gw: w - lr * gw, th, g)
        return th

    t0 = time.perf_counter()
    with torch.no_grad():
        theta = vmap(adapt)(theta0, phi, inner_b)
    _sync(device)
    t1 = time.perf_counter()
    reference = vmap(lambda th, ph, ib, ob: hypergrad_reference(
        problem, th, ph, ib, ob, rho=oracle_rho, device=device))(
            theta, phi, inner_b, outer_b)
    _sync(device)
    t2 = time.perf_counter()

    if sketch_indices is None:
        def sketch_indices(t, k):
            return PyTreeIndexer(_member(theta, t)).sample_indices(
                _generator(seed, _SKETCH_SALT, t), k)

    def stacked_indices(k: int) -> dict:
        return _stack_draws([sketch_indices(t, k) for t in range(tasks)])

    return PopulationBundle(problem=problem, spec=spec, tasks=tasks, p=p,
                            theta=theta, phi=phi, inner_b=inner_b,
                            outer_b=outer_b, sketch_indices=stacked_indices,
                            reference=reference, oracle_rho=oracle_rho,
                            seconds={'adapt': t1 - t0, 'oracle': t2 - t1})


# ---------------------------------------------------------------------------
# Cell measurement
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SweepCell:
    """One observatory measurement: (problem, solver, grid point) over the
    population. ``problem`` is the full ``'name:kw=v'`` spec (two sizes of
    one builder are different cells). ``hypergrad_error`` is the population
    mean of the relative
    error vs the oracle (``err_max`` the worst member); ``hvp_count`` is
    the per-hypergradient analytic bill (k for Nyström, l for CG/Neumann,
    p for exact); ``wall_seconds`` is the best-of-``reps`` wall time of the
    whole vmapped population program (the warm call excluded),
    ``applies_per_sec`` = tasks / wall_seconds.

    The two ``None``-default fields are the optional program-structure
    audit of the reference (``collective_count``, ``accum_dtype_ok``); the
    port has no auditor yet, so they stay ``None``."""
    problem: str
    solver: str
    grid: dict
    tasks: int
    hypergrad_error: float
    err_max: float
    hvp_count: int
    wall_seconds: float
    applies_per_sec: float
    backend: str = 'tree'
    collective_count: int | None = None
    accum_dtype_ok: bool | None = None


def _cell_solver(solver_name: str, point: dict, backend: str):
    """The cell's solver from ``HypergradConfig``; ``backend`` reaches only a
    solver whose spec declares ``builds_backend``."""
    cfg = dict(point)
    if SOLVERS[solver_name].builds_backend:
        cfg['backend'] = backend
    return HypergradConfig(solver=solver_name, **cfg).build()


def _population_fn(bundle: PopulationBundle, solver, device):
    """The measured program: ``hypergrad_at`` for every member under one
    ``torch.func.vmap``, the stacked column draw injected where the solver
    samples columns (``k``)."""
    problem = bundle.problem
    batched = (bundle.theta, bundle.phi, bundle.inner_b, bundle.outer_b)
    k = getattr(solver, 'k', None)
    if k is None:
        fn = vmap(lambda th, ph, ib, ob: hypergrad_at(
            problem, solver, th, ph, ib, ob, device=device))
        return lambda: fn(*batched)
    idx = bundle.sketch_indices(k)
    fn = vmap(lambda th, ph, ib, ob, ix: hypergrad_at(
        problem, solver, th, ph, ib, ob, indices=ix, device=device))
    return lambda: fn(*batched, idx)


def cell_hypergrads(bundle: PopulationBundle, solver_name: str, point: dict,
                    *, backend: str = 'tree', device=None) -> PyTree:
    """The stacked hypergradients one cell measures (the program
    :func:`measure_cell` times), for comparing cells value by value."""
    device = _check_device(bundle.problem, device)
    solver = _cell_solver(solver_name, point, backend)
    return _population_fn(bundle, solver, device)()


def measure_cell(bundle: PopulationBundle, solver_name: str, point: dict,
                 *, backend: str = 'tree', reps: int = 2,
                 audit: bool = False, device=None) -> SweepCell:
    """Measure one (solver, grid point, backend) cell against a built
    population. ``backend`` ('tree' | 'flat' | 'cuda') reaches the solver
    only when its ``SolverSpec`` declares ``builds_backend`` (Nyström's
    operand layouts); for the others it is recorded as-is in the cell —
    they have no backend dial. One warm call, then the best of ``reps``
    on the host clock, each ending in ``torch.cuda.synchronize()`` on a
    card. ``audit=True`` raises: the port has no auditor yet."""
    if audit:
        raise NotImplementedError(_AUDIT_MSG)
    device = _check_device(bundle.problem, device)
    solver = _cell_solver(solver_name, point, backend)
    run = _population_fn(bundle, solver, device)
    hg = run()                                    # warm
    _sync(device)
    wall = math.inf
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall = min(wall, time.perf_counter() - t0)
    errs = vmap(hypergrad_error)(hg, bundle.reference)
    return SweepCell(
        problem=bundle.spec, solver=solver_name, grid=dict(point),
        tasks=bundle.tasks, hypergrad_error=float(torch.mean(errs)),
        err_max=float(torch.max(errs)),
        hvp_count=accounted_hvps(solver, bundle.problem, 1),
        wall_seconds=wall, applies_per_sec=bundle.tasks / max(wall, 1e-12),
        backend=backend)


def run_sweep(problem_specs=DEFAULT_PROBLEM_SPECS,
              solvers=('nystrom', 'cg', 'neumann', 'exact'),
              grid: dict[str, tuple] | None = None, *, tasks: int = 3,
              backends: tuple[str, ...] = ('tree',),
              vary: tuple[str, tuple] | None = None, steps: int | None = None,
              batch_size: int | None = None, seed: int = 0,
              oracle_rho: float = 0.0, reps: int = 2,
              max_oracle_p: int = DEFAULT_MAX_ORACLE_P,
              audit: bool = False,
              progress: Callable[[str], None] | None = None,
              injected: dict[str, dict] | None = None,
              device=None) -> list[SweepCell]:
    """The full sweep: problems × solvers × per-solver grid points ×
    backends.

    Unknown solver names raise before any measurement, and so does
    ``audit=True`` (the port has no auditor yet). The ``backends`` axis
    applies only to solvers whose ``SolverSpec`` declares
    ``builds_backend`` (Nyström); backend-less solvers measure each grid
    point once, tagged 'tree'. The population (adaptation + oracle) is
    built once per problem and shared by all its cells. ``injected`` maps
    a spec to the draws :func:`build_population` takes from outside
    (``theta0``, ``phi``, ``draw``, ``sketch_indices``).
    """
    if audit:
        raise NotImplementedError(_AUDIT_MSG)
    device = resolve_device(device)
    say = progress or (lambda msg: None)
    grid = DEFAULT_GRID if grid is None else grid
    points = {s: solver_grid_points(s, grid) for s in solvers}
    for s in solvers:                     # validated before any measurement
        if not SOLVERS[s].builds_backend and len(backends) > 1:
            say(f'[observatory] note: {s} has no backend dial; measuring '
                f"its cells once (tagged 'tree')")
    if vary is not None:
        tasks = len(vary[1])
    cells = []
    for spec in problem_specs:
        bundle = build_population(
            spec, tasks=tasks, vary=vary, steps=steps,
            batch_size=batch_size, seed=seed, oracle_rho=oracle_rho,
            max_oracle_p=max_oracle_p, device=device,
            **(injected or {}).get(spec, {}))
        say(f'[observatory] {spec}: population of {bundle.tasks} built '
            f'(p={bundle.p}, oracle rho={oracle_rho})')
        for solver_name in solvers:
            solver_backends = (tuple(backends)
                               if SOLVERS[solver_name].builds_backend
                               else ('tree',))
            for point in points[solver_name]:
                for backend in solver_backends:
                    cell = measure_cell(bundle, solver_name, point,
                                        backend=backend, reps=reps,
                                        device=device)
                    cells.append(cell)
                    knobs = ','.join(f'{k}={v}'
                                     for k, v in point.items()) or '-'
                    say(f'[observatory]   {solver_name:<8} {knobs:<16} '
                        f'be={backend:<6} err={cell.hypergrad_error:.3e} '
                        f'hvps={cell.hvp_count} '
                        f'wall={cell.wall_seconds:.3f}s')
    return cells
