"""BilevelProblem: one typed problem API from task definition to hypergradient.

    problem = build_reweighting()                      # a BilevelProblem
    result  = solve(problem, HypergradConfig(solver='nystrom', k=10,
                                             backend='cuda'), n_outer=5)
    result.metrics['accuracy'], result.hvp_count, result.seconds

A problem carries ``inner_loss``/``outer_loss``/``init_params``/
``init_hparams``/``data`` (any :class:`BatchSource`) and the device its data
lives on. ``solve`` has two drive modes: the alternating warm-start loop of
:class:`~repro_torch.core.bilevel.BilevelTrainer`, and, for meta-problems
(iMAML) whose source serves ``task_batch``, ``vmap_tasks=N``: per-task
hypergradients under ``torch.func.vmap``, optionally sharing one sketch
across the meta-batch (``shared_sketch=True``: k HVPs a meta-step instead
of N·k).

The module also hosts the one-shot influence path: an
:class:`InfluenceProblem` is a single-level training problem, and
:func:`influence` scores every training example against m queries with one
prepared sketch. The m query IHVPs go through ``solver.apply_matrix`` as one
(p, m) block, and the scores stream over the training set in (m, b) tiles
with a running top-k, never an n_train × m matrix. With ``store=`` (the
serving tier's :class:`~repro_torch.serve.SketchStore`) the prepared sketch
is fetched by content key instead of rebuilt: a warm hit, from memory or
from the store's disk tier, bills zero HVPs.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Iterable, Protocol, runtime_checkable

import numpy as np
import torch
from torch.func import grad, grad_and_value, vmap

from repro_torch.core.bilevel import (BilevelState, BilevelTrainer,
                                      split_generator)
from repro_torch.core.hypergrad import HypergradConfig, hypergradient
from repro_torch.core.implicit import implicit_root, sgd_solver
from repro_torch.core.tree_util import (PyTree, PyTreeIndexer, tree_leaves,
                                        tree_map, tree_norm)
from repro_torch.device import resolve_device
from repro_torch.optim import adam, chain, clip_by_global_norm, momentum, sgd

@runtime_checkable
class BatchSource(Protocol):
    """Deterministic step-indexed batch streams (``repro_torch.data``).

    ``train_batch`` feeds the inner problem, ``val_batch`` the outer loss.
    Meta-problem sources raise from these and serve
    ``task_batch(step, n_tasks)`` instead (the ``vmap_tasks=`` path).
    """

    def train_batch(self, step: int, batch_size: int) -> Any: ...

    def val_batch(self, step: int, batch_size: int) -> Any: ...


# Training-hyperparameter defaults a problem may override via its
# ``defaults`` dict; ``solve()`` kwargs override both.
_TRAIN_DEFAULTS: dict[str, Any] = dict(
    inner_lr=0.1, inner_momentum=0.0, outer_lr=1e-3, outer_opt='adam',
    steps_per_outer=20, batch_size=128, reset_inner=False)


@dataclasses.dataclass
class BilevelProblem:
    """A typed bilevel task. Losses follow ``f(params, hparams, batch)``;
    ``init_params``/``init_hparams`` take a ``torch.Generator``. ``device``
    is where the task's data and parameters live."""
    name: str
    inner_loss: Callable[..., torch.Tensor]
    outer_loss: Callable[..., torch.Tensor]
    init_params: Callable[[torch.Generator], PyTree]
    init_hparams: Callable[[torch.Generator], PyTree]
    data: Any = None
    device: torch.device = torch.device('cpu')
    metrics: dict[str, Callable[..., float]] = dataclasses.field(
        default_factory=dict)
    baseline_loss: Callable[..., torch.Tensor] | None = None
    reference: dict[str, Any] = dataclasses.field(default_factory=dict)
    defaults: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BilevelResult:
    """What ``solve`` hands back. ``hvp_count`` is the accounted number of
    HVPs (k per sketch build); ``seconds`` the wall time of the loop.
    ``params`` is None on the ``vmap_tasks`` meta path, whose per-task
    adapted parameters are transient (``hparams`` is the meta-init)."""
    problem: str
    params: PyTree | None
    hparams: PyTree
    history: dict[str, list[float]]
    metrics: dict[str, float]
    hvp_count: int
    seconds: float
    state: BilevelState | None = None
    hypergrad_error: float | None = None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
PROBLEMS: dict[str, Callable[..., BilevelProblem]] = {}


def register_problem(name: str):
    """Decorator: register a ``(**kwargs) -> BilevelProblem`` builder."""
    def deco(builder):
        PROBLEMS[name] = builder
        return builder
    return deco


def get_problem(name: str, **kwargs) -> BilevelProblem:
    """Build a registered problem by name."""
    if name not in PROBLEMS:
        import repro_torch.tasks  # noqa: F401  (registers the builders)
    if name not in PROBLEMS:
        raise ValueError(f'unknown problem {name!r}; registered: '
                         f'{sorted(PROBLEMS)}')
    return PROBLEMS[name](**kwargs)


# ---------------------------------------------------------------------------
# Optimizers shared by solve() and BilevelTrainer.from_problem
# ---------------------------------------------------------------------------
def resolved_defaults(problem: BilevelProblem, **overrides) -> dict[str, Any]:
    """_TRAIN_DEFAULTS ← problem.defaults ← non-None solve() kwargs."""
    d = {**_TRAIN_DEFAULTS, **problem.defaults}
    d.update({k: v for k, v in overrides.items() if v is not None})
    return d


def default_optimizers(problem: BilevelProblem, d: dict | None = None):
    """(inner_opt, outer_opt): momentum or plain SGD inner, Adam or
    SGD-momentum outer behind a global-norm clip of 10."""
    d = resolved_defaults(problem) if d is None else d
    inner = (momentum(d['inner_lr'], d['inner_momentum'])
             if d['inner_momentum'] else sgd(d['inner_lr']))
    base = (adam(d['outer_lr']) if d['outer_opt'] == 'adam'
            else momentum(d['outer_lr'], 0.9))
    return inner, chain(clip_by_global_norm(10.0), base)


def accounted_hvps(solver, problem: BilevelProblem, n_outer: int,
                   refresh_every: int = 1, reset_inner: bool = False,
                   vmap_tasks: int | None = None,
                   shared_sketch: bool = False) -> int:
    """HVPs the hypergradient machinery runs over ``n_outer`` outer steps.
    Amortizable solvers pay per build, ``k`` HVPs a build (p for the exact
    solver): one every ``refresh_every`` steps (every step under
    ``reset_inner``); on the ``vmap_tasks`` meta path one per task per
    meta-step, or one per meta-step with ``shared_sketch``. Iterative
    solvers pay their ``iters`` sequential HVPs on every apply, per task."""
    if not getattr(type(solver), 'amortizable', False):
        return n_outer * getattr(solver, 'iters', 0) * (vmap_tasks or 1)
    per_build = getattr(solver, 'k', None)
    if per_build is None:
        params = problem.init_params(torch.Generator().manual_seed(0))
        per_build = sum(int(x.numel()) for x in tree_leaves(params))
    if vmap_tasks:
        return n_outer * per_build * (1 if shared_sketch else vmap_tasks)
    builds = (n_outer if reset_inner
              else math.ceil(n_outer / max(1, refresh_every)))
    return builds * per_build


def _check_device(problem, device) -> torch.device:
    device = resolve_device(device)
    if torch.device(problem.device).type != device.type:
        raise ValueError(f'problem {problem.name!r} lives on {problem.device}'
                         f', not {device}: build it with device={device}')
    return device


# ---------------------------------------------------------------------------
# Hypergradient at a point, and the exact oracle
# ---------------------------------------------------------------------------
def hypergrad_at(problem: BilevelProblem, config: HypergradConfig | Any,
                 params: PyTree, hparams: PyTree, inner_batch: Any,
                 outer_batch: Any, *, rng: torch.Generator | None = None,
                 indices: dict | None = None, device=None) -> PyTree:
    """One implicit hypergradient at an explicit linearization point:
    ``params`` is taken as θ* and ``outer_loss(θ*(φ), φ)`` is differentiated
    through ``implicit_root``. ``rng`` seeds the column sampling, or
    ``indices`` injects the columns. Vmappable: ``torch.func.vmap`` over
    stacked (params, hparams, batches, indices) measures a population of
    points in one call (the solver runs once per point on plain tensors,
    inside the solution map's task rule)."""
    _check_device(problem, device)
    if config is None:
        config = HypergradConfig()
    solver = (config.build() if isinstance(config, HypergradConfig)
              else config)
    if rng is None and indices is None:
        rng = torch.Generator().manual_seed(0)
    return hypergradient(problem.inner_loss, problem.outer_loss, params,
                         hparams, inner_batch, outer_batch, solver, rng,
                         indices=indices)


def hypergrad_reference(problem: BilevelProblem, params: PyTree,
                        hparams: PyTree, inner_batch: Any, outer_batch: Any,
                        *, rho: float = 0.0, device=None) -> PyTree:
    """Exact-IHVP oracle hypergradient (p HVPs + a p×p solve; test-scale
    problems only). ``rho=0.0`` is the true implicit hypergradient."""
    from repro_torch.core.solvers import ExactIHVP
    return hypergrad_at(problem, ExactIHVP(rho=rho), params, hparams,
                        inner_batch, outer_batch, device=device)


def hypergrad_error(hg: PyTree, reference: PyTree) -> torch.Tensor:
    """Relative L2 error ‖hg − ref‖ / ‖ref‖ over the whole trees."""
    num = tree_norm(tree_map(lambda a, b: a.float() - b.float(), hg,
                             reference))
    den = tree_norm(tree_map(lambda b: b.float(), reference))
    return num / torch.clamp(den, min=1e-30)


# ---------------------------------------------------------------------------
# solve() — the single entry point
# ---------------------------------------------------------------------------
def solve(problem: BilevelProblem, config: HypergradConfig | Any = None, *,
          n_outer: int, steps_per_outer: int | None = None,
          batch_size: int | None = None, inner_opt=None, outer_opt=None,
          reset_inner: bool | None = None, seed: int = 0,
          sketch_refresh_every: int | None = None,
          vmap_tasks: int | None = None, shared_sketch: bool = False,
          log_every: int = 0, with_hypergrad_error: bool = False,
          oracle_rho: float = 0.0, device=None, params: PyTree | None = None,
          hparams: PyTree | None = None,
          index_draws: Iterable[dict] | None = None) -> BilevelResult:
    """Optimize a :class:`BilevelProblem` end to end. Two drive modes:

    * default — the alternating warm-start loop: ``steps_per_outer`` inner
      optimizer steps per hypergradient update, batches from
      ``problem.data``'s train/val streams, the sketch rebuilt every
      ``sketch_refresh_every`` outer steps.
    * ``vmap_tasks=N`` — meta-batched (:func:`_solve_meta`): each meta-step
      draws N tasks from ``problem.data.task_batch``, adapts each with
      ``steps_per_outer`` inner SGD steps from the meta-init φ, and averages
      the N per-task hypergradients taken under ``torch.func.vmap``.
      ``shared_sketch=True`` prepares one sketch at the meta-init on the
      pooled support data and shares it across the tasks.

    Runs on the card unless ``device='cpu'``; the problem must have been
    built on the same device.

    Injected draws (the parity tests): ``params``/``hparams`` replace the
    seeded initial point (on the meta path ``hparams`` is the meta-init),
    ``index_draws`` gives one structured column draw per sketch build (on
    the meta path one per task per meta-step, or one per meta-step when
    shared). ``with_hypergrad_error=True`` scores the solver against the
    exact oracle at the solved state (p HVPs: test-scale only; not on the
    meta path, whose adapted parameters are transient).
    """
    _check_device(problem, device)
    if config is None:
        config = HypergradConfig()
    if with_hypergrad_error and vmap_tasks:
        raise ValueError(
            'with_hypergrad_error is not supported on the vmap_tasks meta '
            'path (per-task adapted parameters are transient)')
    d = resolved_defaults(problem, steps_per_outer=steps_per_outer,
                          batch_size=batch_size, reset_inner=reset_inner)
    solver = (config.build() if isinstance(config, HypergradConfig)
              else config)
    if vmap_tasks:
        if not hasattr(problem.data, 'task_batch'):
            raise TypeError(
                f'solve(vmap_tasks={vmap_tasks}) needs a meta-problem data '
                'source exposing task_batch(step, n_tasks) (e.g. '
                f'EpisodeSource); problem {problem.name!r} carries '
                f'{type(problem.data).__name__}')
        return _solve_meta(problem, solver, d, n_outer=n_outer,
                           vmap_tasks=vmap_tasks, shared_sketch=shared_sketch,
                           outer_opt=outer_opt, seed=seed,
                           log_every=log_every, hparams=hparams,
                           index_draws=index_draws)
    d_inner, d_outer = default_optimizers(problem, d)
    trainer = BilevelTrainer.from_problem(
        problem, solver, inner_opt=inner_opt or d_inner,
        outer_opt=outer_opt or d_outer, reset_inner=d['reset_inner'])
    rng = torch.Generator().manual_seed(seed)
    p0 = problem.init_params(rng) if params is None else params
    h0 = problem.init_hparams(rng) if hparams is None else hparams
    state = trainer.init(rng, p0, h0)

    bs = d['batch_size']
    train_it = (problem.data.train_batch(i, bs) for i in itertools.count())
    val_it = (problem.data.val_batch(i, bs) for i in itertools.count())

    refresh = (sketch_refresh_every if sketch_refresh_every is not None
               else (config.sketch_refresh_every
                     if isinstance(config, HypergradConfig) else 1))
    t0 = time.perf_counter()
    state, history = trainer.run(
        state, train_it, val_it, steps_per_outer=d['steps_per_outer'],
        n_outer=n_outer, log_every=log_every, sketch_refresh_every=refresh,
        index_draws=index_draws)
    _sync(problem.device)
    seconds = time.perf_counter() - t0

    hvps = accounted_hvps(solver, problem, n_outer, refresh_every=refresh,
                          reset_inner=d['reset_inner'])
    metrics = {name: float(fn(state.params, state.hparams))
               for name, fn in problem.metrics.items()}
    hg_err = None
    if with_hypergrad_error:
        ib = problem.data.train_batch(n_outer, bs)
        ob = problem.data.val_batch(n_outer, bs)
        hg = hypergrad_at(problem, solver, state.params, state.hparams, ib,
                          ob, rng=torch.Generator().manual_seed(seed + n_outer),
                          device=problem.device)
        ref = hypergrad_reference(problem, state.params, state.hparams, ib,
                                  ob, rho=oracle_rho, device=problem.device)
        hg_err = float(hypergrad_error(hg, ref))
    return BilevelResult(problem=problem.name, params=state.params,
                         hparams=state.hparams, history=history,
                         metrics=metrics, hvp_count=hvps, seconds=seconds,
                         state=state, hypergrad_error=hg_err)


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _stack_draws(draws: list) -> dict:
    """n structured draws → one with a leading task axis."""
    def tensor(x):
        return (x.long() if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.array(x, dtype=np.int64)))
    return {key: torch.stack([tensor(d[key]) for d in draws])
            for key in ('leaf', 'dims')}


def _solve_meta(problem: BilevelProblem, solver, d: dict, *, n_outer: int,
                vmap_tasks: int, shared_sketch: bool, outer_opt, seed: int,
                log_every: int, hparams: PyTree | None,
                index_draws: Iterable[dict] | None) -> BilevelResult:
    """The ``vmap_tasks=`` meta-batch drive mode (iMAML-style problems).

    A meta-step: per-task hypergradients of the query loss through the
    ``sgd_solver`` adaptation map under ``vmap(grad_and_value(...))``, their
    mean, one outer-optimizer step. Shared: one sketch at (meta, meta) on
    the pooled support sets, closed over by the vmapped function (its
    backward passes run as one block apply). Otherwise each task prepares
    its own sketch at its adapted θ: from its slice of the injected draws,
    or from one sampling stream split from ``seed``, task by task."""
    adapt = sgd_solver(problem.inner_loss, d['steps_per_outer'],
                       d['inner_lr'])
    solution = implicit_root(adapt, problem.inner_loss, solver)
    shared = shared_sketch and getattr(type(solver), 'amortizable', False)
    if shared_sketch and not shared:
        raise TypeError(
            f'shared_sketch needs an amortizable solver; '
            f'{type(solver).__name__} prepares a step-local state that '
            'cannot be shared across the meta-batch')
    if outer_opt is None:
        outer_opt = (adam(d['outer_lr']) if d['outer_opt'] == 'adam'
                     else momentum(d['outer_lr'], 0.9))
    rng = torch.Generator().manual_seed(seed)
    meta = problem.init_hparams(rng) if hparams is None else hparams
    vjp_rng = split_generator(rng)
    draws = None if index_draws is None else iter(index_draws)
    ost = outer_opt.init(meta)
    history: dict[str, list[float]] = {'outer_loss': [], 'inner_loss': []}
    pending: list[torch.Tensor] = []
    t0 = time.perf_counter()
    for s in range(n_outer):
        inner_b, outer_b = problem.data.task_batch(s, vmap_tasks)
        if shared:
            pooled = tree_map(lambda x: x.reshape((-1,) + x.shape[2:]),
                              inner_b)
            sketch = solution.prepare_state(
                meta, meta, pooled, vjp_rng,
                indices=None if draws is None else next(draws))

            def task_vg(ib, ob):
                return grad_and_value(lambda m: problem.outer_loss(
                    solution(m, ib, state=sketch), m, ob))(meta)
            hg, losses = vmap(task_vg)(inner_b, outer_b)
        elif draws is None:
            def task_vg(ib, ob):
                return grad_and_value(lambda m: problem.outer_loss(
                    solution(m, ib, rng=vjp_rng), m, ob))(meta)
            hg, losses = vmap(task_vg)(inner_b, outer_b)
        else:
            idx = _stack_draws([next(draws) for _ in range(vmap_tasks)])

            def task_vg(ib, ob, ix):
                return grad_and_value(lambda m: problem.outer_loss(
                    solution(m, ib, indices=ix), m, ob))(meta)
            hg, losses = vmap(task_vg)(inner_b, outer_b, idx)
        hg = tree_map(lambda x: x.mean(0), hg)
        meta, ost = outer_opt.apply(hg, ost, meta, s)
        pending.append(losses.mean())
        if log_every and (s + 1) % log_every == 0:
            history['outer_loss'].extend(float(x) for x in pending)
            pending.clear()
            print(f'[solve:{problem.name}] meta-step {s + 1}/{n_outer} '
                  f'g={history["outer_loss"][-1]:.4f} (pre-update, '
                  f'{vmap_tasks} tasks)')
    history['outer_loss'].extend(float(x) for x in pending)
    _sync(problem.device)
    seconds = time.perf_counter() - t0

    hvps = accounted_hvps(solver, problem, n_outer, vmap_tasks=vmap_tasks,
                          shared_sketch=shared)
    metrics = {name: float(fn(None, meta))
               for name, fn in problem.metrics.items()}
    return BilevelResult(problem=problem.name, params=None, hparams=meta,
                         history=history, metrics=metrics, hvp_count=hvps,
                         seconds=seconds)


# ---------------------------------------------------------------------------
# Influence functions — the matrix-valued apply path
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class InfluenceProblem:
    """A single-level training problem posed for influence queries:
    ``loss(params, batch) -> scalar`` (a mean over the batch's leading
    axis), ``init_params(rng)`` and a ``data`` source that also streams its
    training split in order (``n_train`` / ``train_slice``, as
    :class:`~repro_torch.data.ArraySource` does). ``defaults`` may override
    ``influence``'s ``inner_lr``, ``batch_size`` and ``train_steps``."""
    name: str
    loss: Callable[..., torch.Tensor]
    init_params: Callable[[torch.Generator], PyTree]
    data: Any = None
    device: torch.device = torch.device('cpu')
    defaults: dict[str, Any] = dataclasses.field(default_factory=dict)
    reference: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class InfluenceResult:
    """``influence``'s output. ``scores`` (m, top_k): s(q, i) =
    −∇L(q)ᵀ (H+ρI)⁻¹ ∇L(zᵢ), descending per query; ``indices`` the matching
    training-example indices; ``self_scores`` (m,) the queries' own
    ∇L(q)ᵀ (H+ρI)⁻¹ ∇L(q) when asked for; ``hvp_count`` k for one sketch
    build, amortized over all m queries and the whole sweep."""
    problem: str
    scores: torch.Tensor
    indices: torch.Tensor
    self_scores: torch.Tensor | None
    params: PyTree
    hvp_count: int
    seconds: float


def _per_example_grads(loss, params, batch):
    """(b,)+param-shaped gradient stack: each example re-batched to size 1
    so ``loss``'s mean-over-batch contract holds per example."""
    def one(ex):
        return grad(lambda p: loss(p, tree_map(lambda x: x[None], ex)))(
            params)
    return vmap(one)(batch)


def make_topk_scanner(loss, params, source, batch_size: int):
    """The streamed top-k scorer: ``scan(S, top_k) -> (vals, idxs)``.

    Given the solved query block S = (H+ρI)⁻¹∇L(q) (a parameter tree with a
    trailing (m,) axis), it sweeps the ordered training stream in
    ``batch_size`` slices, scores each as an (m, b) f32 tile, and folds the
    tile into a running top-k; the n_train × m matrix is never built. The
    merge is a stable descending sort of [running, tile], so equal scores
    keep the lower index first, as the reference's ``jax.lax.top_k``
    does."""
    n = source.n_train

    def score_tile(S, batch):
        G = _per_example_grads(loss, params, batch)
        return -sum(
            (g.float().reshape(g.shape[0], -1)
             @ s.float().reshape(-1, s.shape[-1])).T
            for s, g in zip(tree_leaves(S), tree_leaves(G)))

    def merge(vals, idxs, tile, base: int):
        m, b = tile.shape
        gidx = base + torch.arange(b, device=tile.device).expand(m, b)
        cand_v = torch.cat([vals, tile], dim=1)
        cand_i = torch.cat([idxs, gidx], dim=1)
        order = torch.sort(cand_v, dim=1, descending=True,
                           stable=True).indices[:, :vals.shape[1]]
        return (torch.gather(cand_v, 1, order),
                torch.gather(cand_i, 1, order))

    def scan(S, top_k: int):
        leaf = tree_leaves(S)[0]
        m, kk = leaf.shape[-1], min(top_k, n)
        vals = torch.full((m, kk), -math.inf, device=leaf.device)
        idxs = torch.full((m, kk), -1, dtype=torch.int64, device=leaf.device)
        for start in range(0, n, batch_size):
            vals, idxs = merge(vals, idxs, score_tile(
                S, source.train_slice(start, batch_size)), start)
        return vals, idxs

    return scan


def train_influence_params(problem: InfluenceProblem, *,
                           train_steps: int | None = None,
                           batch_size: int | None = None,
                           seed: int = 0) -> PyTree:
    """Plain-SGD training of an :class:`InfluenceProblem`'s model: the
    parameters every influence query is scored at."""
    d = {**_TRAIN_DEFAULTS, **problem.defaults}
    bs = batch_size if batch_size is not None else d['batch_size']
    steps = (train_steps if train_steps is not None
             else d.get('train_steps', 200))
    params = problem.init_params(torch.Generator().manual_seed(seed))
    opt = sgd(d['inner_lr'])
    ost = opt.init(params)
    for i in range(steps):
        g = grad(problem.loss)(params, problem.data.train_batch(i, bs))
        params, ost = opt.apply(g, ost, params, i)
    return params


def influence_curvature_hvp(problem: InfluenceProblem, params: PyTree,
                            source: Any, batch_size: int):
    """The curvature every influence apply solves against: the loss Hessian
    at ``params`` over one large ordered training slice."""
    from repro_torch.core.hvp import make_hvp
    curv = source.train_slice(0, min(source.n_train, max(batch_size, 1024)))
    return make_hvp(lambda p, hp, b: problem.loss(p, b), params, None, curv)


def influence_build_hvps(solver, params: PyTree) -> int:
    """HVPs one state build bills: k (Nyström) or p (exact column scan),
    by :func:`~repro_torch.core.solvers.build_hvp_bill`."""
    from repro_torch.core.solvers import build_hvp_bill
    return build_hvp_bill(solver, params)


def influence(problem: InfluenceProblem, config: HypergradConfig | Any = None,
              queries: Any = None, source: Any = None, *,
              params: PyTree | None = None, top_k: int = 10,
              batch_size: int | None = None, train_steps: int | None = None,
              self_influence: bool = False, seed: int = 0, store: Any = None,
              indices: dict | None = None, device=None) -> InfluenceResult:
    """Score training examples against m queries with one prepared sketch.

    For each query q (a row of ``queries``, a batch with leading axis m) and
    each training example zᵢ streamed from ``source`` (default
    ``problem.data``): s(q, i) = −∇L(q)ᵀ (H + ρI)⁻¹ ∇L(zᵢ), and the
    top-``top_k`` (score, index) pairs per query. The m query gradients
    become one (p, m) block and go through one ``solver.apply_matrix``
    (kernels A and C on ``backend='cuda'``); the sweep is
    :func:`make_topk_scanner`'s.

    ``params=None`` first trains the model (:func:`train_influence_params`);
    the parity tests pass trained parameters. The sketch's columns come
    from ``torch.Generator().manual_seed(seed)``, or ``indices=`` injects a
    draw.

    ``store``: an optional :class:`~repro_torch.serve.SketchStore`. When
    given (and the solver is amortizable), the prepared state is fetched by
    content key (a digest of ``params`` and the solver's ρ-free
    fingerprint) instead of rebuilt: a warm hit answers all m queries with
    zero sketch-build HVPs (``hvp_count == 0``), and one cached sketch
    serves a damping sweep. The store gets the state's template
    (:func:`~repro_torch.core.solvers.state_template`, no HVP) as a
    function it calls only on a memory miss with a disk tier, so a spilled
    sketch re-enters warm as well and a warm memory hit allocates nothing. Iterative solvers bypass it.
    """
    _check_device(problem, device)
    if config is None:
        config = HypergradConfig()
    solver = (config.build() if isinstance(config, HypergradConfig)
              else config)
    source = problem.data if source is None else source
    if queries is None:
        raise ValueError('influence() needs a queries batch (leading axis m)')
    for attr in ('n_train', 'train_slice'):
        if not hasattr(source, attr):
            raise TypeError(
                f'influence() needs an ordered-streaming source exposing '
                f'n_train/train_slice (see ArraySource); '
                f'{type(source).__name__} lacks {attr!r}')
    d = {**_TRAIN_DEFAULTS, **problem.defaults}
    bs = batch_size if batch_size is not None else d['batch_size']

    t0 = time.perf_counter()
    if params is None:
        params = train_influence_params(problem, train_steps=train_steps,
                                        batch_size=bs, seed=seed)
    hvp = influence_curvature_hvp(problem, params, source, bs)
    indexer = PyTreeIndexer(params)
    amortizable = getattr(type(solver), 'amortizable', False)

    def build():
        return solver.prepare(hvp, indexer,
                              torch.Generator().manual_seed(seed),
                              indices=indices)

    built = True
    if store is not None and amortizable:
        from repro_torch.core.solvers import state_template
        from repro_torch.serve import sketch_key
        state, built = store.get_or_build(
            sketch_key(params, solver), build,
            like=lambda: state_template(solver, indexer),
            build_hvps=influence_build_hvps(solver, params))
    else:
        state = build()

    # m query gradients → one (p, m) block → one apply_matrix
    G_q = _per_example_grads(problem.loss, params, queries)
    V = tree_map(lambda g: g.movedim(0, -1), G_q)
    S = solver.apply_matrix(state, V)
    m = tree_leaves(S)[0].shape[-1]
    self_scores = None
    if self_influence:
        self_scores = sum(
            (v.float() * s.float()).reshape(-1, m).sum(0)
            for v, s in zip(tree_leaves(V), tree_leaves(S)))
    vals, idxs = make_topk_scanner(problem.loss, params, source, bs)(S, top_k)
    if amortizable:
        # a warm store hit ran no build at all: the bill is zero
        hvps = influence_build_hvps(solver, params) if built else 0
    else:
        hvps = getattr(solver, 'iters', 0) * m   # per-query iterative solves
    _sync(problem.device)
    return InfluenceResult(problem=problem.name, scores=vals, indices=idxs,
                           self_scores=self_scores, params=params,
                           hvp_count=int(hvps),
                           seconds=time.perf_counter() - t0)
