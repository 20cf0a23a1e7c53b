"""BilevelProblem: one typed problem API from task definition to hypergradient.

    problem = build_reweighting()                      # a BilevelProblem
    result  = solve(problem, HypergradConfig(solver='nystrom', k=10,
                                             backend='cuda'), n_outer=5)
    result.metrics['accuracy'], result.hvp_count, result.seconds

A problem carries ``inner_loss``/``outer_loss``/``init_params``/
``init_hparams``/``data`` and the device its data lives on. ``solve`` runs
the alternating warm-start loop of
:class:`~repro_torch.core.bilevel.BilevelTrainer` on that device. Only the
alternating path is ported; the ``vmap_tasks`` meta path and the influence
service come later.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Iterable

import torch

from repro_torch.core.bilevel import BilevelState, BilevelTrainer
from repro_torch.core.hypergrad import HypergradConfig, hypergradient
from repro_torch.core.tree_util import (PyTree, tree_leaves, tree_map,
                                        tree_norm)
from repro_torch.device import resolve_device
from repro_torch.optim import adam, chain, clip_by_global_norm, momentum, sgd

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
    HVPs (k per sketch build); ``seconds`` the wall time of the loop."""
    problem: str
    params: PyTree
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
                   refresh_every: int = 1, reset_inner: bool = False) -> int:
    """HVPs the hypergradient machinery runs over ``n_outer`` outer steps:
    one build per ``refresh_every`` steps (every step under
    ``reset_inner``), ``k`` HVPs a build (p for the exact solver)."""
    per_build = getattr(solver, 'k', None)
    if per_build is None:
        params = problem.init_params(torch.Generator().manual_seed(0))
        per_build = sum(int(x.numel()) for x in tree_leaves(params))
    builds = (n_outer if reset_inner
              else math.ceil(n_outer / max(1, refresh_every)))
    return builds * per_build


def _check_device(problem: BilevelProblem, device) -> torch.device:
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
    ``indices`` injects the columns."""
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
          sketch_refresh_every: int | None = None, log_every: int = 0,
          with_hypergrad_error: bool = False, oracle_rho: float = 0.0,
          device=None, params: PyTree | None = None,
          hparams: PyTree | None = None,
          index_draws: Iterable[dict] | None = None) -> BilevelResult:
    """Optimize a :class:`BilevelProblem` end to end.

    ``steps_per_outer`` inner optimizer steps per hypergradient update,
    batches from ``problem.data``'s train/val streams, the sketch rebuilt
    every ``sketch_refresh_every`` outer steps. Runs on the card unless
    ``device='cpu'``; the problem must have been built on the same device.

    Injected draws (the parity tests): ``params``/``hparams`` replace the
    seeded initial point, ``index_draws`` gives one structured column draw
    per sketch build. ``with_hypergrad_error=True`` scores the solver
    against the exact oracle at the solved state (p HVPs: test-scale only).
    """
    _check_device(problem, device)
    if config is None:
        config = HypergradConfig()
    d = resolved_defaults(problem, steps_per_outer=steps_per_outer,
                          batch_size=batch_size, reset_inner=reset_inner)
    solver = (config.build() if isinstance(config, HypergradConfig)
              else config)
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
    if torch.device(problem.device).type == 'cuda':
        torch.cuda.synchronize()
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
