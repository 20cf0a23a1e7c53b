"""Differentiable implicit solutions: ``implicit_root``.

``implicit_root(inner_solver_fn, inner_loss, hypergrad)`` wraps an inner
solver into a map φ, batch → θ* whose backward pass is the implicit
function theorem: the φ-cotangent of θ*(φ) is −(∂²f/∂φ∂θ)ᵀ (H+ρI)⁻¹ v,
computed with the solver's ``prepare``/``apply`` and one VJP through the
inner gradient. In PyTorch the map is a ``torch.autograd.Function``, so the
hypergradient (Eq. 3) is plain ``torch.autograd.grad`` of
``g(θ*(φ), φ)``.

Example — a quadratic inner problem with an analytic solution map
(``f = ½·Σ d·θ² − θ·φ`` has ``θ*(φ) = φ/d``, so ``dθ*/dφ = 1/d``):

>>> import torch
>>> from repro_torch.core.implicit import implicit_root
>>> from repro_torch.core.hypergrad import HypergradConfig
>>> d = torch.tensor([1.0, 2.0, 4.0])
>>> def inner(theta, phi, batch):
...     return 0.5 * torch.sum(d * theta ** 2) - torch.sum(theta * phi)
>>> solve = implicit_root(lambda phi, batch: phi / d, inner,
...                       HypergradConfig(solver='exact', rho=0.0))
>>> phi = torch.ones(3, requires_grad=True)
>>> g, = torch.autograd.grad(solve(phi, None).sum(), phi)
>>> bool(torch.allclose(g, 1.0 / d, atol=1e-5))
True

The forward-mode rule and task batching under ``vmap`` are not ported yet.
"""
from __future__ import annotations

import types
from typing import Any, Callable

import torch
from torch.func import grad, vmap

from repro_torch.core.hvp import make_hvp
from repro_torch.core.tree_util import (PyTree, PyTreeIndexer, tree_flatten,
                                        tree_leaves, tree_map, tree_scale)

InnerSolver = Callable[[PyTree, Any], PyTree]   # (phi, batch) -> theta*
InnerLoss = Callable[..., torch.Tensor]         # f(theta, phi, batch) -> scalar


def _default_rng(rng, indices):
    """The sampling stream when the caller gave neither a generator nor an
    index draw: a fixed seed, as the reference defaults to PRNGKey(0)."""
    if rng is None and indices is None:
        return torch.Generator().manual_seed(0)
    return rng


def _mixed_vjp(inner_loss: InnerLoss, theta: PyTree, phi: PyTree,
               batch: Any, u: PyTree) -> PyTree:
    """−∇_φ ⟨∇_θ f(θ, φ), u⟩ = −(∂²f/∂φ∂θ)ᵀ u, f32 accumulation."""
    def inner_grad_dot_u(p):
        g_theta = grad(inner_loss, argnums=0)(theta, p, batch)
        return sum(tree_leaves(tree_map(
            lambda a, b: torch.sum(a.float() * b.float()), g_theta, u)))

    return tree_scale(grad(inner_grad_dot_u)(phi), -1.0)


def _implicit_phi_vjp(solver, inner_loss: InnerLoss, theta: PyTree,
                      phi: PyTree, batch: Any, v: PyTree, rng,
                      state, indices: dict | None = None) -> PyTree:
    """The φ-cotangent of θ*(φ): −(∂²f/∂φ∂θ)ᵀ (H+ρI)⁻¹ v.

    ``state`` is an optional pre-built solver state; when absent the
    solver's ``prepare`` runs here (k HVPs), sampling with ``rng`` or taking
    the injected ``indices``."""
    if state is None:
        hvp = make_hvp(inner_loss, theta, phi, batch)
        state = solver.prepare(hvp, PyTreeIndexer(theta), rng,
                               indices=indices)
    u = tree_map(torch.Tensor.detach, solver.apply(state, v))
    return _mixed_vjp(inner_loss, theta, phi, batch, u)


def phi_vjp_block(solver, inner_loss: InnerLoss, theta: PyTree,
                  phi: PyTree, batch: Any, V: PyTree, rng=None,
                  state=None, *, indices: dict | None = None) -> PyTree:
    """The φ-cotangent of θ*(φ) for an m-query block of cotangents.

    ``V``: every leaf is the matching θ-leaf's shape plus a trailing (m,)
    axis. Returns the φ-shaped block −(∂²f/∂φ∂θ)ᵀ (H+ρI)⁻¹ V with the same
    trailing axis. One solver state serves all m queries through
    ``solver.apply_matrix``; only the mixed-term VJP is batched per query
    (``torch.func.vmap``).
    ``rng=None`` samples with ``torch.Generator().manual_seed(0)``."""
    if state is None:
        hvp = make_hvp(inner_loss, theta, phi, batch)
        state = solver.prepare(hvp, PyTreeIndexer(theta),
                               _default_rng(rng, indices), indices=indices)
    U = tree_map(torch.Tensor.detach, solver.apply_matrix(state, V))
    return vmap(lambda u: _mixed_vjp(inner_loss, theta, phi, batch, u),
                in_dims=-1, out_dims=-1)(U)


class _SolutionMap(torch.autograd.Function):
    """θ*(φ) with the implicit-function-theorem backward pass.

    The tensors passed through ``apply`` are φ's leaves; everything else
    (the solver, the batch, the sampling stream, a shared state) rides on
    ``spec``, a plain Python object."""

    @staticmethod
    def forward(ctx, spec, *phi_leaves):
        phi = spec.phi_def.unflatten(phi_leaves)
        theta = spec.inner_solver_fn(phi, spec.batch)
        theta_leaves, spec.theta_def = tree_flatten(theta)
        ctx.spec = spec
        ctx.save_for_backward(*phi_leaves)
        ctx.theta = [t.detach() for t in theta_leaves]
        # clone: the returned tensors get this node as their grad_fn, and
        # the inner solver may hand back tensors its caller still owns
        return tuple(t.detach().clone() for t in theta_leaves)

    @staticmethod
    def backward(ctx, *v_leaves):
        spec = ctx.spec
        phi = spec.phi_def.unflatten([p.detach() for p in ctx.saved_tensors])
        theta = spec.theta_def.unflatten(ctx.theta)
        v = spec.theta_def.unflatten(list(v_leaves))
        phi_bar = _implicit_phi_vjp(spec.solver, spec.inner_loss, theta, phi,
                                    spec.batch, v, spec.rng, spec.state,
                                    spec.indices)
        return (None, *tree_leaves(phi_bar))


def implicit_root(inner_solver_fn: InnerSolver, inner_loss: InnerLoss,
                  hypergrad=None) -> Callable:
    """Wrap an inner solver into a differentiable solution map φ, batch → θ*.

    Args:
      inner_solver_fn: ``(phi, batch) -> theta_star`` — any approximate inner
        optimization. It is not differentiated through.
      inner_loss: ``f(theta, phi, batch) -> scalar``, whose stationarity
        defines θ*.
      hypergrad: a ``HypergradConfig`` (built once here), a built solver, or
        None for the default Nyström configuration.

    Returns ``solve(phi, batch=None, rng=None, state=None, indices=None)``:

      * ``rng`` (a ``torch.Generator``) seeds the backward pass's column
        sampling; ``indices=`` injects a structured draw instead. With
        neither, ``torch.Generator().manual_seed(0)``.
      * ``state`` injects a pre-built solver state, so the backward pass
        skips ``prepare``.
      * ``batch``, ``rng`` and ``state`` get no gradient.

    ``solve.prepare_state(theta, phi, batch=None, rng=None, indices=None)``
    builds such a state through :class:`~repro_torch.core.solvers.SketchPolicy`.
    """
    from repro_torch.core.hypergrad import HypergradConfig
    from repro_torch.core.solvers import SketchPolicy
    if hypergrad is None:
        hypergrad = HypergradConfig()
    solver = (hypergrad.build() if isinstance(hypergrad, HypergradConfig)
              else hypergrad)

    def solve(phi: PyTree, batch: Any = None, rng=None, state=None,
              indices: dict | None = None) -> PyTree:
        phi_leaves, phi_def = tree_flatten(phi)
        spec = types.SimpleNamespace(
            inner_solver_fn=inner_solver_fn, inner_loss=inner_loss,
            solver=solver, batch=batch, rng=_default_rng(rng, indices),
            state=state, indices=indices, phi_def=phi_def, theta_def=None)
        theta_leaves = _SolutionMap.apply(spec, *phi_leaves)
        return spec.theta_def.unflatten(list(theta_leaves))

    def prepare_state(theta: PyTree, phi: PyTree, batch: Any = None,
                      rng=None, indices: dict | None = None):
        """Build an amortizable solver state at (theta, phi, batch) for the
        ``state=`` argument (k HVPs, once)."""
        return SketchPolicy(solver=solver, inner_loss=inner_loss).build(
            theta, phi, batch, _default_rng(rng, indices), indices=indices)

    solve.prepare_state = prepare_state
    return solve
