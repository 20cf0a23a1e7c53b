"""Differentiable implicit solutions: ``implicit_root``.

``implicit_root(inner_solver_fn, inner_loss, hypergrad)`` wraps an inner
solver into a map φ, batch → θ* whose derivatives come from the implicit
function theorem at the point the solver returns:

* reverse mode: the φ-cotangent of θ*(φ) is −(∂²f/∂φ∂θ)ᵀ (H+ρI)⁻¹ v, with
  the solver's ``prepare``/``apply`` and one VJP through the inner gradient;
* forward mode (``forward_mode=True``, the default): the φ-tangent is
  −(H+ρI)⁻¹ (∂²f/∂θ∂φ) φ̇, the same solver.

The map is a ``torch.autograd.Function``, so the hypergradient (Eq. 3) is
plain ``torch.autograd.grad`` (or ``torch.func.grad``) of ``g(θ*(φ), φ)``,
and ``torch.func.jvp`` gives the oracle tangent dθ*/dφ · φ̇.

Both rules are differentiable again, as the reference's are (its jvp rule
re-enters itself): the mixed term is plain PyTorch at live φ, and the solve
is :func:`~repro_torch.core.solvers.linear_solve`, whose own rules are
solve(ẇ − Ḣ·u) forward and the transposed solve backward. So
``jacfwd(grad)``, ``jacrev(grad)``, ``hessian`` and an HVP of a loss that
contains the map (jvp of grad: the multi-level engine's nested maps) take
the reference's convention (AID): θ* and the solver state are frozen, φ is
live in the mixed term and in the solve's system matvec. Forward over
forward (``jacfwd(jacfwd(map))``) raises: PyTorch runs a Function's jvp
rule with forward-mode AD off; ``jacrev(jacfwd(map))`` gives that
derivative.

``torch.func.vmap`` over a task axis gives per-task hypergradients (iMAML's
meta-batches). The solver's CUDA kernels read raw device pointers, which a
batched tensor does not have, so the solver only runs inside the forward
of a Function with a ``vmap`` rule (the map's and the solve's): the rule
moves the task axis to the front of plain tensors and runs a
*task-batched* version. With a state shared across tasks (``state=``
closed over by the vmapped function, or a point without the task axis),
the n right-hand sides become one (p, n) block and one ``apply_matrix``
(kernel A's cross and kernel C's block form); otherwise each task prepares
and applies its own sketch. The inner solver and the mixed terms run under
``torch.func.vmap`` across tasks.

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
import functools
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from repro_torch.core.hvp import make_hvp
from repro_torch.core.solvers import (_detached, _save, _saved, _zeros_for,
                                      forward_rule, linear_solve,
                                      theta_backend)
from repro_torch.core.tree_util import (PyTree, TreeDef,
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
               batch: Any, u: PyTree, vdot: Callable) -> PyTree:
    """−∇_φ ⟨∇_θ f(θ, φ), u⟩ = −(∂²f/∂φ∂θ)ᵀ u, f32 accumulation. ``vdot``:
    the inner product of θ-trees, the solver's backend's
    (:func:`~repro_torch.core.solvers.theta_backend`: a split model's sums
    its blocks over the mesh)."""
    def inner_grad_dot_u(p):
        return vdot(grad(inner_loss, argnums=0)(theta, p, batch), u)

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
    return solver.prepare(hvp, theta_backend(solver).indexer(theta), rng,
                          indices=indices)


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
    vdot = theta_backend(solver).vdot
    return vmap(lambda u: _mixed_vjp(inner_loss, theta, phi, batch, u, vdot),
                in_dims=-1, out_dims=-1)(U)


# ---------------------------------------------------------------------------
# The solution map and its derivative rules, as autograd Functions
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Spec:
    """Everything a solution-map Function needs besides its tensors.

    The map's operands are flat: φ's leaves, the batch's leaves, and the
    injected index draw (``leaf``, ``dims``) when there is one; its rules
    extend that layout with θ's leaves and a cotangent's (or tangent's)
    leaves. ``tasks`` is None, or the task count of a batched call, where
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

    def over_tasks(self, fn, ops) -> tuple:
        """``fn(*operands)`` → tuple of tensors, for every task at once
        under ``torch.func.vmap``."""
        dims = tuple(0 if t else None for t in self.batched)
        return vmap(fn, in_dims=dims)(*ops)


def _frozen(tree: PyTree) -> PyTree:
    return tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                    else x, tree)


def _ihvp(spec: _Spec, ops: list, theta: list, w: list) -> list:
    """u = (H + ρI)⁻¹ w at (θ, φ, batch): the solve of both rules, through
    :func:`~repro_torch.core.solvers.linear_solve`. θ, the batch and the
    state are frozen, φ is live: the solve differentiates through the
    system matvec in φ (the reference's ``custom_linear_solve``). Without a
    shared ``state`` the solver prepares at (θ, φ, batch) once per call
    (per task where the point is batched), with ``rng`` or the injected
    draw, and the rules' own solves re-apply that state."""
    n = spec.n_map

    def unpack(point):
        phi, batch, idx = spec.trees(point[:n])
        return spec.theta_def.unflatten(point[n:]), (phi, _frozen(batch)), idx

    def prepare(th, args, idx):
        return _prepared(spec.solver, spec.inner_loss, th, *args, spec.rng,
                         None, idx)

    live = (True,) * spec.n_phi + (False,) * (n - spec.n_phi + len(theta))
    batched = (spec.batched + (True,) * len(w) if spec.tasks is not None
               else ())
    return linear_solve(spec.solver, spec.state, spec.inner_loss,
                        [*ops, *theta], unpack, live,
                        spec.theta_def.unflatten(w), prepare=prepare,
                        tasks=spec.tasks, batched=batched)


def _mixed(spec: _Spec, fn, ops: list, theta: list, x: list, x_def,
           x_batched: tuple, like: list) -> list:
    """``fn(inner_loss, θ, φ, batch, x)`` — the mixed term of a rule — at
    frozen θ and batch and live φ, over every task where the spec is
    task-batched, in the dtypes of ``like``'s leaves (a forward-mode
    formula of PyTorch's may widen a tangent to f64)."""
    n, nt = spec.n_map, len(theta)

    def run(*o):
        phi, batch, _ = spec.trees(o[:n])
        th = spec.theta_def.unflatten([t.detach() for t in o[n:n + nt]])
        return tuple(tree_leaves(fn(spec.inner_loss, th, phi, _frozen(batch),
                                    x_def.unflatten(o[n + nt:]))))
    if spec.tasks is None:
        out = run(*ops, *theta, *x)
    else:
        mspec = dataclasses.replace(
            spec, batched=spec.batched[:n] + (True,) * nt + x_batched)
        out = mspec.over_tasks(run, [*ops, *theta, *x])
    return [o.to(l.dtype) for o, l in zip(out, like)]


class _SolutionMap(torch.autograd.Function):
    """θ*(φ) with the implicit-function-theorem derivative rules.

    Operands: φ's leaves, the batch's leaves and the index draw; the rest
    (solver, sampling stream, a shared state) rides on the spec. The batch
    and the draw get no gradient. Both rules reach the solver through
    :func:`_ihvp` (a Function, so that under ``torch.func`` transforms the
    kernels see plain tensors) and the mixed term through plain PyTorch,
    so both can be differentiated again. The jvp rule exists where
    ``spec.forward_mode`` says so."""

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
    def vmap(info, in_dims, spec, *args):
        """Move every batched operand's axis to the front and re-apply the
        map on plain tensors with the task layout recorded in the spec (its
        forward then runs the task-batched version); every output carries
        the task axis first."""
        if spec.tasks is not None:
            raise NotImplementedError(
                'implicit_root supports one vmapped task axis, not nested '
                'vmaps')
        ops = [a if d is None else a.movedim(d, 0)
               for a, d in zip(args, in_dims[1:])]
        bspec = dataclasses.replace(
            spec, tasks=info.batch_size,
            batched=tuple(d is not None for d in in_dims[1:]))
        out = _SolutionMap.apply(bspec, *ops)
        spec.theta_def = bspec.theta_def
        return out, (0,) * len(out)

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
        if spec.tasks is not None:   # θ and v carry the task axis
            spec = dataclasses.replace(
                spec, batched=spec.batched + (True,) * len(theta))
        u = _ihvp(spec, ops, theta, _zeros_for(v, theta))
        mixed = functools.partial(_mixed_vjp,
                                  vdot=theta_backend(spec.solver).vdot)
        phi_bar = _mixed(spec, mixed, ops, theta, u, spec.theta_def,
                         (True,) * len(u), ops[:spec.n_phi])
        return (None, *phi_bar, *[None] * (spec.n_map - spec.n_phi))

    @forward_rule
    def jvp(ctx, _spec_dot, *dots):
        spec = ctx.spec
        if not spec.forward_mode:
            raise RuntimeError(
                'this solution map was built with forward_mode=False: it has '
                'the reverse-mode rule only, no jvp')
        args = _saved(ctx)
        ops, theta = args[:spec.n_map], args[spec.n_map:]
        phi_dot = _zeros_for(dots[:spec.n_phi], ops[:spec.n_phi])
        if spec.tasks is not None:   # θ has the task axis, φ̇ φ's layout
            spec = dataclasses.replace(
                spec, batched=spec.batched + (True,) * len(theta))
        m_dot = _mixed(spec, _mixed_jvp, ops, theta, phi_dot, spec.phi_def,
                       spec.batched[:spec.n_phi], theta)
        return tuple(-u for u in _ihvp(spec, ops, theta, m_dot))



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
