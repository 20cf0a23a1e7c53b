"""Warm-start alternating bilevel driver (Eq. 1–2 of the paper), eager.

Inner: θ_t = Θ(θ_{t-1}, ∇_θ f(θ_{t-1}, φ, T), φ) for T steps.
Outer: φ ← φ − η · (approximate dg/dφ by implicit differentiation).

Outer steps differentiate through the ``implicit_root`` solution map: the
warm-started θ is wrapped as θ*(φ) and the hypergradient is
``torch.autograd.grad`` of ``g(θ*(φ), φ)``. Two ``torch.Generator`` streams
live in the state: ``rng`` drives inner resets, ``vjp_rng`` only the sketch
column sampling. For the amortizable solvers (Nyström, exact) a
:class:`~repro_torch.core.solvers.SketchPolicy` rebuilds the sketch every
``sketch_refresh_every`` outer steps; ``vjp_rng`` is drawn from only when a
sketch is built, so the cadence does not shift the stream. The iterative
solvers (CG, Neumann) prepare afresh inside every backward pass.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import torch
from torch.func import grad_and_value
from torch.profiler import record_function

from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.implicit import implicit_root
from repro_torch.core.solvers import SketchPolicy, SketchState
from repro_torch.core.tree_util import PyTree, tree_flatten, tree_leaves
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Optimizer


def split_generator(rng: torch.Generator) -> torch.Generator:
    """A new generator seeded from one draw of ``rng``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
    return torch.Generator().manual_seed(seed)


@dataclasses.dataclass
class BilevelState:
    params: PyTree
    hparams: PyTree
    inner_opt_state: PyTree
    outer_opt_state: PyTree
    inner_step: int
    outer_step: int
    rng: torch.Generator
    vjp_rng: torch.Generator    # seeds the backward pass's sketch columns


@dataclasses.dataclass
class BilevelTrainer:
    """Alternating warm-start bilevel optimization with an IHVP solver.

    ``reset_inner`` re-initializes θ at every outer update (the paper's
    §5.1/§5.2 protocol). ``device`` is where the state lives: None means
    the card (and raises without one), ``'cpu'`` the CPU."""
    inner_loss: Callable[..., torch.Tensor]   # f(params, hparams, batch)
    outer_loss: Callable[..., torch.Tensor]   # g(params, hparams, batch)
    inner_opt: Optimizer
    outer_opt: Optimizer
    hypergrad: Any
    init_params: Callable[[torch.Generator], PyTree] | None = None
    reset_inner: bool = False
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def from_problem(cls, problem, hypergrad=None, *, inner_opt=None,
                     outer_opt=None, reset_inner: bool | None = None
                     ) -> 'BilevelTrainer':
        """A trainer with the problem's default optimizers and protocol."""
        from repro_torch.core.problem import (default_optimizers,
                                              resolved_defaults)
        d = resolved_defaults(problem, reset_inner=reset_inner)
        d_inner, d_outer = default_optimizers(problem, d)
        return cls(inner_loss=problem.inner_loss,
                   outer_loss=problem.outer_loss,
                   inner_opt=inner_opt or d_inner,
                   outer_opt=outer_opt or d_outer,
                   hypergrad=(hypergrad if hypergrad is not None
                              else HypergradConfig()),
                   init_params=problem.init_params,
                   reset_inner=bool(d['reset_inner']), device=problem.device)

    def init(self, rng: torch.Generator, params: PyTree,
             hparams: PyTree) -> BilevelState:
        for leaf in tree_leaves((params, hparams)):
            if leaf.device.type != self.device.type:
                raise ValueError(f'state on {leaf.device}, trainer on '
                                 f'{self.device}')
        vjp_rng = split_generator(rng)
        return BilevelState(
            params=params, hparams=hparams,
            inner_opt_state=self.inner_opt.init(params),
            outer_opt_state=self.outer_opt.init(hparams),
            inner_step=0, outer_step=0, rng=rng, vjp_rng=vjp_rng)

    # ------------------------------------------------------------------ inner
    def inner_step_fn(self, state: BilevelState, batch: Any
                      ) -> tuple[BilevelState, torch.Tensor]:
        grads, loss = grad_and_value(self.inner_loss)(
            state.params, state.hparams, batch)
        params, opt_state = self.inner_opt.apply(
            grads, state.inner_opt_state, state.params, state.inner_step)
        return dataclasses.replace(
            state, params=params, inner_opt_state=opt_state,
            inner_step=state.inner_step + 1), loss.detach()

    # ------------------------------------------------------------------ outer
    def built_solver(self):
        return (self.hypergrad.build()
                if isinstance(self.hypergrad, HypergradConfig)
                else self.hypergrad)

    def sketch_policy(self, refresh_every: int | None = None) -> SketchPolicy:
        if refresh_every is None:
            refresh_every = (self.hypergrad.sketch_refresh_every
                             if isinstance(self.hypergrad, HypergradConfig)
                             else 1)
        return SketchPolicy(solver=self.built_solver(),
                            inner_loss=self.inner_loss,
                            refresh_every=refresh_every)

    def outer_step_with_sketch(self, state: BilevelState, sketch,
                               inner_batch: Any, outer_batch: Any
                               ) -> tuple[BilevelState, torch.Tensor]:
        """One hypergradient update on φ against a prepared ``sketch``,
        then the ``reset_inner`` protocol. Returns the pre-update outer
        loss g(θ, φ_t)."""
        params = state.params
        solve = implicit_root(lambda phi, batch: params, self.inner_loss,
                              self.built_solver())
        leaves, treedef = tree_flatten(state.hparams)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        phi = treedef.unflatten(leaves)
        loss = self.outer_loss(solve(phi, inner_batch, state=sketch), phi,
                               outer_batch)
        hgrad = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
        hparams, outer_opt_state = self.outer_opt.apply(
            hgrad, state.outer_opt_state, state.hparams, state.outer_step)
        state = dataclasses.replace(
            state, hparams=hparams, outer_opt_state=outer_opt_state,
            outer_step=state.outer_step + 1)
        if self.reset_inner:
            if self.init_params is None:
                raise ValueError('reset_inner needs init_params')
            params = self.init_params(split_generator(state.rng))
            state = dataclasses.replace(
                state, params=params,
                inner_opt_state=self.inner_opt.init(params), inner_step=0)
        return state, loss.detach()

    def outer_step_with_policy(self, state: BilevelState,
                               sketch_state: SketchState, inner_batch: Any,
                               outer_batch: Any, policy: SketchPolicy,
                               indices: dict | None = None):
        """Refresh the sketch if it is due (k HVPs, sampled from
        ``state.vjp_rng`` or taken from ``indices``), then update φ."""
        with record_function('bilevel.sketch'):
            sketch_state, _ = policy.refresh(
                sketch_state, state.params, state.hparams, inner_batch,
                state.vjp_rng, indices=indices)
        with record_function('bilevel.update'):
            state, outer_loss_pre = self.outer_step_with_sketch(
                state, sketch_state.sketch, inner_batch, outer_batch)
        if self.reset_inner:
            # θ just jumped to a fresh init: the sketch's curvature is void
            sketch_state = policy.invalidate(sketch_state)
        return state, sketch_state, outer_loss_pre

    # ------------------------------------------------------------------ loop
    def run(self, state: BilevelState, inner_batches, outer_batches,
            steps_per_outer: int, n_outer: int, log_every: int = 0,
            sketch_refresh_every: int | None = None,
            fresh_inner_batch: bool = False,
            index_draws: Iterable[dict] | None = None):
        """Host loop. The outer step's Hessian is evaluated on the batch the
        inner unroll ended on (``fresh_inner_batch=True`` draws one more).
        ``index_draws`` injects one structured index draw per sketch build
        in place of sampling (the parity tests feed the reference's draws).
        An iterative solver has no sketch: its backward pass prepares
        afresh, and ``sketch_refresh_every`` > 1 raises.
        Losses stay on the device until ``log_every`` boundaries and the
        end. Each outer step's phases are ``torch.profiler`` ranges:
        ``bilevel.inner``, ``bilevel.sketch`` and ``bilevel.update``."""
        solver = self.built_solver()
        policy = None
        if getattr(type(solver), 'amortizable', False):
            policy = self.sketch_policy(sketch_refresh_every)
        elif (sketch_refresh_every or 1) > 1:
            raise TypeError(
                f'sketch_refresh_every={sketch_refresh_every} needs an '
                f'amortizable solver; {type(solver).__name__} prepares a '
                'step-local state with nothing to reuse')
        draws = None if index_draws is None else iter(index_draws)
        history = {'inner_loss': [], 'outer_loss': []}
        pending_inner: list[torch.Tensor] = []
        pending_outer: list[torch.Tensor] = []

        def flush():
            history['inner_loss'].extend(float(x) for x in pending_inner)
            history['outer_loss'].extend(float(x) for x in pending_outer)
            pending_inner.clear()
            pending_outer.clear()

        it_in, it_out = iter(inner_batches), iter(outer_batches)
        sketch_state = None if policy is None else policy.init_state()
        no_batch = object()
        for o in range(n_outer):
            ib = no_batch
            with record_function('bilevel.inner'):
                for _ in range(steps_per_outer):
                    ib = next(it_in)
                    state, li = self.inner_step_fn(state, ib)
                    pending_inner.append(li)
            if fresh_inner_batch or ib is no_batch:
                ib = next(it_in)
            ob = next(it_out)
            if policy is None:
                with record_function('bilevel.update'):
                    state, lo = self.outer_step_with_sketch(state, None, ib,
                                                            ob)
            else:
                idx = (next(draws) if draws is not None
                       and policy.due(sketch_state) else None)
                state, sketch_state, lo = self.outer_step_with_policy(
                    state, sketch_state, ib, ob, policy, indices=idx)
            pending_outer.append(lo)
            if log_every and (o + 1) % log_every == 0:
                flush()
                print(f'[bilevel] outer {o + 1}/{n_outer} '
                      f'g={history["outer_loss"][-1]:.4f} (pre-update)')
        flush()
        return state, history
