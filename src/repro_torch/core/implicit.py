"""Differentiable implicit solutions: ``implicit_root``.

``implicit_root(inner_solver_fn, inner_loss, hypergrad)`` wraps an inner
solver into a map φ, batch → θ* whose derivatives come from the implicit
function theorem at the point the solver returns:

* reverse mode: the φ-cotangent of θ*(φ) is −(∂²f/∂φ∂θ)ᵀ (H+ρI)⁻¹ v, with
  the solver's ``prepare``/``apply`` and one VJP through the inner gradient;
* forward mode (``forward_mode=True``, the default): the φ-tangent is
  −(H+ρI)⁻¹ (∂²f/∂θ∂φ) φ̇, the same solver applied through
  :func:`~repro_torch.core.solvers.tangent_apply`.

The map is a ``torch.autograd.Function``, so the hypergradient (Eq. 3) is
plain ``torch.autograd.grad`` (or ``torch.func.grad``) of ``g(θ*(φ), φ)``,
and ``torch.func.jvp`` gives the oracle tangent dθ*/dφ · φ̇.

``torch.func.vmap`` over a task axis gives per-task hypergradients (iMAML's
meta-batches). The solver's CUDA kernels read raw device pointers, which a
batched tensor does not have, so every step that can reach them runs inside
the forward of a Function with a ``vmap`` rule: the rule moves the task axis
to the front of plain tensors and runs a *task-batched* version. With a
state shared across tasks (``state=`` closed over by the vmapped function),
the n tasks' right-hand sides become one (p, n) block and one
``apply_matrix`` (kernel A's cross and kernel C's block form); without one,
each task prepares and applies its own sketch. The inner solver and the
mixed-term VJP run under ``torch.func.vmap`` across tasks.

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

Per-task hypergradients under ``torch.func.vmap``:

>>> from torch.func import grad, jvp, vmap
>>> phis = torch.stack([torch.ones(3), 2.0 * torch.ones(3)])
>>> per_task = vmap(grad(lambda p: solve(p, None).sum()))(phis)
>>> per_task.shape
torch.Size([2, 3])

Forward mode gives the tangent of the solution map (here ``v/d``):

>>> v = torch.tensor([3.0, 2.0, 4.0])
>>> _, tangent = jvp(lambda p: solve(p, None), (torch.ones(3),), (v,))
>>> bool(torch.allclose(tangent, v / d, atol=1e-5))
True
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from repro_torch.core.hvp import make_hvp
from repro_torch.core.tree_util import (PyTree, PyTreeIndexer, TreeDef,
                                        tree_flatten, tree_leaves, tree_map,
                                        tree_scale)

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


def _mixed_jvp(inner_loss: InnerLoss, theta: PyTree, phi: PyTree,
               batch: Any, phi_dot: PyTree) -> PyTree:
    """(∂²f/∂θ∂φ) φ̇: the jvp of the inner gradient in the φ slot."""
    def inner_grad(p):
        return grad(inner_loss, argnums=0)(theta, p, batch)

    return jvp(inner_grad, (phi,), (phi_dot,))[1]


def _prepared(solver, inner_loss, theta, phi, batch, rng, state, indices):
    """``state``, or a fresh one prepared at (θ, φ, batch): k HVPs."""
    if state is not None:
        return state
    hvp = make_hvp(inner_loss, theta, phi, batch)
    return solver.prepare(hvp, PyTreeIndexer(theta), rng, indices=indices)


def _implicit_phi_vjp(solver, inner_loss: InnerLoss, theta: PyTree,
                      phi: PyTree, batch: Any, v: PyTree, rng,
                      state, indices: dict | None = None) -> PyTree:
    """The φ-cotangent of θ*(φ): −(∂²f/∂φ∂θ)ᵀ (H+ρI)⁻¹ v.

    ``state`` is an optional pre-built solver state; when absent the
    solver's ``prepare`` runs here (k HVPs), sampling with ``rng`` or taking
    the injected ``indices``."""
    state = _prepared(solver, inner_loss, theta, phi, batch, rng, state,
                      indices)
    u = tree_map(torch.Tensor.detach, solver.apply(state, v))
    return _mixed_vjp(inner_loss, theta, phi, batch, u)


def _implicit_phi_tangent(solver, inner_loss: InnerLoss, theta: PyTree,
                          phi: PyTree, batch: Any, phi_dot: PyTree, rng,
                          state, indices: dict | None = None) -> PyTree:
    """The φ-tangent of θ*(φ): −(H+ρI)⁻¹ (∂²f/∂θ∂φ) φ̇, the forward-mode
    mirror of :func:`_implicit_phi_vjp` (the stationarity condition
    ∇_θ f(θ*(φ), φ) = 0 differentiated along φ̇), solved with the same
    ``apply`` through :func:`~repro_torch.core.solvers.tangent_apply`. The
    linearization point and the state are frozen: AID differentiates the
    implicit map, never the sketch."""
    from repro_torch.core.solvers import tangent_apply
    state = _prepared(solver, inner_loss, theta, phi, batch, rng, state,
                      indices)
    m_dot = _mixed_jvp(inner_loss, theta, phi, batch, phi_dot)
    hvp = make_hvp(inner_loss, theta, phi, batch)
    return tree_scale(tangent_apply(solver, state, hvp, m_dot), -1.0)


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
    state = _prepared(solver, inner_loss, theta, phi, batch,
                      _default_rng(rng, indices), state, indices)
    U = tree_map(torch.Tensor.detach, solver.apply_matrix(state, V))
    return vmap(lambda u: _mixed_vjp(inner_loss, theta, phi, batch, u),
                in_dims=-1, out_dims=-1)(U)


# ---------------------------------------------------------------------------
# The solution map and its derivative rules, as autograd Functions
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Spec:
    """Everything a solution-map Function needs besides its tensors.

    A Function's operands are flat: φ's leaves, the batch's leaves, the
    injected index draw (``leaf``, ``dims``) when there is one, then — for
    the derivative rules — θ's leaves and the cotangent's (or φ̇'s) leaves.
    ``tasks`` is None, or the task count of a batched call, where
    ``batched[i]`` says whether operand i carries the leading task axis (an
    operand without it is shared by every task)."""
    inner_solver_fn: InnerSolver
    inner_loss: InnerLoss
    solver: Any
    rng: Any
    state: Any
    phi_def: TreeDef
    batch_def: TreeDef
    n_phi: int
    n_batch: int
    n_idx: int
    forward_mode: bool = True
    theta_def: TreeDef | None = None
    tasks: int | None = None
    batched: tuple = ()

    @property
    def n_map(self) -> int:
        return self.n_phi + self.n_batch + self.n_idx

    def trees(self, ops) -> tuple[PyTree, Any, dict | None]:
        """(φ, batch, indices) from the map's operands."""
        a, b = self.n_phi, self.n_phi + self.n_batch
        idx = ({'leaf': ops[b], 'dims': ops[b + 1]} if self.n_idx else None)
        return (self.phi_def.unflatten(ops[:a]),
                self.batch_def.unflatten(ops[a:b]), idx)

    def task(self, ops, b: int) -> list:
        """Task b's operands: the b-th slice where an operand has the axis."""
        return [x[b] if t else x for x, t in zip(ops, self.batched)]

    def over_tasks(self, fn, ops) -> tuple:
        """``fn(*operands)`` → tuple of tensors, for every task at once
        under ``torch.func.vmap``."""
        dims = tuple(0 if t else None for t in self.batched)
        return vmap(fn, in_dims=dims)(*ops)


def _detached(args) -> list:
    return [a.detach() if isinstance(a, torch.Tensor) else a for a in args]


def _save(ctx, args, forward: bool) -> None:
    """Save a Function's operands: tensors through the context (for the
    backward pass, and for the jvp when ``forward``), the rest as is."""
    tensors = [a if isinstance(a, torch.Tensor) else None for a in args]
    ctx.others = [None if isinstance(a, torch.Tensor) else a for a in args]
    ctx.save_for_backward(*tensors)
    if forward:
        ctx.save_for_forward(*tensors)


def _saved(ctx) -> list:
    return [t if o is None else o
            for t, o in zip(ctx.saved_tensors, ctx.others)]


def _vmap_rule(fn_cls):
    """The ``vmap`` staticmethod of ``fn_cls``: move every batched operand's
    axis to the front and re-apply ``fn_cls`` on plain tensors with the task
    layout recorded in the spec (its forward then runs the task-batched
    version). Every output carries the task axis first."""
    def rule(info, in_dims, spec, *args):
        if spec.tasks is not None:
            raise NotImplementedError(
                'implicit_root supports one vmapped task axis, not nested '
                'vmaps')
        ops = [a if d is None else a.movedim(d, 0)
               for a, d in zip(args, in_dims[1:])]
        bspec = dataclasses.replace(
            spec, tasks=info.batch_size,
            batched=tuple(d is not None for d in in_dims[1:]))
        out = fn_cls.apply(bspec, *ops)
        spec.theta_def = bspec.theta_def
        return out, (0,) * len(out)
    return staticmethod(rule)


def _all_tasks(spec: _Spec, x: torch.Tensor, batched: bool) -> torch.Tensor:
    """x with the leading task axis (a shared operand broadcast to it)."""
    return x if batched else x.expand(spec.tasks, *x.shape)


def _ihvp_tasks(spec: _Spec, ops: list, theta: list, w: list) -> list:
    """u_b = (H_b + ρI)⁻¹ w_b for every task b (leaves with the task axis).

    A shared state serves all tasks as one (p, n) block through
    ``apply_matrix`` (kernels A and C once); without one, each task
    prepares its own state at its own θ (its own draw: the task's slice of
    the index operands, or the next from ``rng``) and applies it to its
    right-hand side."""
    from repro_torch.core.solvers import apply_tasks
    if spec.state is not None:
        return apply_tasks(spec.solver, spec.state,
                           spec.theta_def.unflatten(w))
    us = []
    for b in range(spec.tasks):
        phi, batch, idx = spec.trees(spec.task(ops, b))
        th = spec.theta_def.unflatten([x[b] for x in theta])
        state = _prepared(spec.solver, spec.inner_loss, th, phi, batch,
                          spec.rng, None, idx)
        us.append(tree_leaves(spec.solver.apply(
            state, spec.theta_def.unflatten([x[b] for x in w]))))
    return [torch.stack(xs) for xs in zip(*us)]


class _PhiVJP(torch.autograd.Function):
    """The reverse-mode rule's value, −(∂²f/∂φ∂θ)ᵀ (H+ρI)⁻¹ v, as a
    forward-only Function: operands (*map operands, *θ, *v) → φ̄'s leaves.
    Under ``vmap`` it runs task-batched (:func:`_ihvp_tasks`)."""

    @staticmethod
    def forward(spec, *args):
        ops, n = _detached(args), spec.n_map
        half = n + (len(ops) - n) // 2     # θ's leaves, then v's
        theta, v = ops[n:half], ops[half:]
        if spec.tasks is None:
            phi, batch, idx = spec.trees(ops[:n])
            th = spec.theta_def.unflatten(theta)
            return tuple(tree_leaves(_implicit_phi_vjp(
                spec.solver, spec.inner_loss, th, phi, batch,
                spec.theta_def.unflatten(v), spec.rng, spec.state, idx)))
        theta = [_all_tasks(spec, x, t)
                 for x, t in zip(theta, spec.batched[n:half])]
        v = [_all_tasks(spec, x, t) for x, t in zip(v, spec.batched[half:])]
        u = _ihvp_tasks(spec, ops[:n], theta, v)
        mspec = dataclasses.replace(
            spec, batched=spec.batched[:n] + (True,) * (2 * len(theta)))

        def mixed(*o):
            phi, batch, _ = spec.trees(o[:n])
            th = spec.theta_def.unflatten(o[n:n + len(theta)])
            uu = spec.theta_def.unflatten(o[n + len(theta):])
            return tuple(tree_leaves(_mixed_vjp(spec.inner_loss, th, phi,
                                                batch, uu)))
        return mspec.over_tasks(mixed, ops[:n] + theta + u)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


class _PhiTangent(torch.autograd.Function):
    """The forward-mode rule's value, −(H+ρI)⁻¹ (∂²f/∂θ∂φ) φ̇, as a
    forward-only Function: operands (*map operands, *θ, *φ̇) → θ̇'s leaves.
    Under ``vmap`` it runs task-batched (:func:`_ihvp_tasks`)."""

    @staticmethod
    def forward(spec, *args):
        ops, n = _detached(args), spec.n_map
        cut = len(ops) - spec.n_phi        # θ's leaves, then φ̇'s
        theta, phi_dot = ops[n:cut], ops[cut:]
        if spec.tasks is None:
            phi, batch, idx = spec.trees(ops[:n])
            return tuple(tree_leaves(_implicit_phi_tangent(
                spec.solver, spec.inner_loss, spec.theta_def.unflatten(theta),
                phi, batch, spec.phi_def.unflatten(phi_dot), spec.rng,
                spec.state, idx)))
        theta = [_all_tasks(spec, x, t)
                 for x, t in zip(theta, spec.batched[n:])]
        mspec = dataclasses.replace(
            spec, batched=(spec.batched[:n] + (True,) * len(theta)
                           + spec.batched[cut:]))

        def mixed(*o):
            phi, batch, _ = spec.trees(o[:n])
            th = spec.theta_def.unflatten(o[n:n + len(theta)])
            return tuple(tree_leaves(_mixed_jvp(
                spec.inner_loss, th, phi, batch,
                spec.phi_def.unflatten(o[n + len(theta):]))))
        m_dot = mspec.over_tasks(mixed, ops[:n] + theta + phi_dot)
        return tuple(-u for u in _ihvp_tasks(spec, ops[:n], theta,
                                             list(m_dot)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


class _SolutionMap(torch.autograd.Function):
    """θ*(φ) with the implicit-function-theorem derivative rules.

    Operands: φ's leaves, the batch's leaves and the index draw; the rest
    (solver, sampling stream, a shared state) rides on the spec. The batch
    and the draw get no gradient. Both rules call a forward-only Function,
    so that under ``torch.func`` transforms the kernels see plain tensors.
    The jvp rule exists where ``spec.forward_mode`` says so."""

    @staticmethod
    def forward(spec, *args):
        def run(*ops):
            phi, batch, _ = spec.trees(ops)
            leaves, spec.theta_def = tree_flatten(
                spec.inner_solver_fn(phi, batch))
            return tuple(leaves)
        ops = _detached(args)
        out = run(*ops) if spec.tasks is None else spec.over_tasks(run, ops)
        # clone: the returned tensors get this node as their grad_fn, and
        # the inner solver may hand back tensors its caller still owns
        return tuple(t.detach().clone() for t in out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, *args = inputs
        ctx.spec = spec
        _save(ctx, [*args, *output], forward=spec.forward_mode)

    @staticmethod
    def backward(ctx, *v):
        spec = ctx.spec
        args = _saved(ctx)
        ops, theta = args[:spec.n_map], args[spec.n_map:]
        v = [torch.zeros_like(t) if g is None else g
             for g, t in zip(v, theta)]
        if spec.tasks is not None:   # θ and v carry the task axis
            spec = dataclasses.replace(
                spec, batched=spec.batched + (True,) * (2 * len(theta)))
        phi_bar = _PhiVJP.apply(spec, *ops, *theta, *v)
        return (None, *phi_bar, *[None] * (spec.n_map - spec.n_phi))

    @staticmethod
    def jvp(ctx, _spec_dot, *dots):
        spec = ctx.spec
        if not spec.forward_mode:
            raise RuntimeError(
                'this solution map was built with forward_mode=False: it has '
                'the reverse-mode rule only, no jvp')
        args = _saved(ctx)
        ops, theta = args[:spec.n_map], args[spec.n_map:]
        phi = ops[:spec.n_phi]
        phi_dot = [torch.zeros_like(p) if d is None else d
                   for d, p in zip(dots[:spec.n_phi], phi)]
        if spec.tasks is not None:   # θ has the task axis, φ̇ φ's layout
            spec = dataclasses.replace(
                spec, batched=(spec.batched + (True,) * len(theta)
                               + spec.batched[:spec.n_phi]))
        return _PhiTangent.apply(spec, *ops, *theta, *phi_dot)


for _fn in (_PhiVJP, _PhiTangent, _SolutionMap):
    _fn.vmap = _vmap_rule(_fn)


def _index_operands(indices: dict | None) -> list:
    """An injected draw as int tensors (a batched draw stays as it is)."""
    if indices is None:
        return []
    return [x if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.array(x, dtype=np.int64))
            for x in (indices['leaf'], indices['dims'])]


def implicit_root(inner_solver_fn: InnerSolver, inner_loss: InnerLoss,
                  hypergrad=None, forward_mode: bool = True) -> Callable:
    """Wrap an inner solver into a differentiable solution map φ, batch → θ*.

    Args:
      inner_solver_fn: ``(phi, batch) -> theta_star`` — any approximate inner
        optimization. It is not differentiated through.
      inner_loss: ``f(theta, phi, batch) -> scalar``, whose stationarity
        defines θ*.
      hypergrad: a ``HypergradConfig`` (built once here), a built solver, or
        None for the default Nyström configuration.
      forward_mode: True (default) gives the map both rules, so
        ``torch.func.jvp`` / ``jacfwd`` compose with it; False keeps the
        reverse-mode rule alone (a jvp raises). The reverse rule is the
        same hand-written VJP either way, the value the reference's
        transposed tangent rule takes.

    Returns ``solve(phi, batch=None, rng=None, state=None, indices=None)``:

      * ``rng`` (a ``torch.Generator``) seeds the derivative pass's column
        sampling; ``indices=`` injects a structured draw instead (under
        ``vmap``, a draw with a leading task axis gives each task its own).
        With neither, ``torch.Generator().manual_seed(0)``.
      * ``state`` injects a pre-built solver state, so the derivative pass
        skips ``prepare``; closed over by a vmapped function it is shared by
        every task (k HVPs a meta-batch instead of a task).
      * ``batch``, ``rng``, ``indices`` and ``state`` get no gradient.

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
        batch_leaves, batch_def = tree_flatten(batch)
        idx = _index_operands(indices)
        spec = _Spec(inner_solver_fn=inner_solver_fn, inner_loss=inner_loss,
                     solver=solver, rng=_default_rng(rng, indices),
                     state=state, phi_def=phi_def, batch_def=batch_def,
                     n_phi=len(phi_leaves), n_batch=len(batch_leaves),
                     n_idx=len(idx), forward_mode=forward_mode)
        theta_leaves = _SolutionMap.apply(spec, *phi_leaves, *batch_leaves,
                                          *idx)
        return spec.theta_def.unflatten(list(theta_leaves))

    def prepare_state(theta: PyTree, phi: PyTree, batch: Any = None,
                      rng=None, indices: dict | None = None):
        """Build an amortizable solver state at (theta, phi, batch) for the
        ``state=`` argument (k HVPs, once)."""
        return SketchPolicy(solver=solver, inner_loss=inner_loss).build(
            theta, phi, batch, _default_rng(rng, indices), indices=indices)

    solve.prepare_state = prepare_state
    return solve


def sgd_solver(inner_loss: InnerLoss, steps: int, lr: float,
               init: Callable[[PyTree, Any], PyTree] | None = None
               ) -> InnerSolver:
    """The canonical ``inner_solver_fn``: ``steps`` plain-SGD steps on
    ``inner_loss``, a plain loop that builds no autograd graph
    (``implicit_root`` differentiates the result, not the unroll).

    ``init``: ``(phi, batch) → θ0``. The default starts from φ itself — the
    iMAML pattern, where φ is the meta-initialization (and also the
    proximal anchor inside ``inner_loss``)."""
    grad_fn = grad(inner_loss)

    def solve(phi: PyTree, batch: Any) -> PyTree:
        with torch.no_grad():
            theta = phi if init is None else init(phi, batch)
            for _ in range(steps):
                g = grad_fn(theta, phi, batch)
                theta = tree_map(lambda w, gw: w - lr * gw, theta, g)
        return theta

    return solve
