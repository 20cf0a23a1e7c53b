"""Hypergradient assembly (Eq. 3) and its configuration.

    dg/dφ = −(∂g/∂θ) (∇²_θ f + ρI)⁻¹ (∂²f/∂φ∂θ) + ∂g/∂φ

The assembly lives in :mod:`repro_torch.core.implicit`: the inner solution
is an autograd Function whose backward pass is the IHVP plus the mixed-term
VJP, so Eq. 3 is plain ``torch.autograd.grad``. ``hypergradient`` is the
imperative entry point on top of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.tree_util import PyTree, tree_flatten

InnerLoss = Callable[..., torch.Tensor]   # f(params, hparams, batch) -> scalar
OuterLoss = Callable[..., torch.Tensor]   # g(params, hparams, batch) -> scalar


def hypergradient(inner_loss: InnerLoss, outer_loss: OuterLoss,
                  params: PyTree, hparams: PyTree, inner_batch: Any,
                  outer_batch: Any, solver, rng=None, *, sketch=None,
                  indices: dict | None = None) -> PyTree:
    """Approximate dg/dφ at (params, hparams) by implicit differentiation.

    Treats ``params`` as the inner solution θ*, wraps it in the
    ``implicit_root`` map and differentiates ``g(θ*(φ), φ)``. ``sketch`` is
    an optional pre-built solver state; ``rng``/``indices`` pick the sketch
    columns otherwise."""
    from repro_torch.core.implicit import implicit_root
    solve = implicit_root(lambda phi, batch: params, inner_loss, solver)
    leaves, treedef = tree_flatten(hparams)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    phi = treedef.unflatten(leaves)
    theta = solve(phi, inner_batch, rng=rng, state=sketch, indices=indices)
    loss = outer_loss(theta, phi, outer_batch)
    return treedef.unflatten(list(torch.autograd.grad(loss, leaves)))


# Config fields consumed outside solver construction: ``solver`` selects the
# registry entry; ``sketch_refresh_every`` is the trainer's sketch cadence.
_TRAINER_FIELDS = ('solver', 'sketch_refresh_every')
# Backend-selection fields, consumed by solvers whose SolverSpec sets
# builds_backend (nystrom).
_BACKEND_FIELDS = ('backend', 'sketch_dtype')

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclasses.dataclass
class HypergradConfig:
    """Which IHVP solver a hypergradient uses, and how.

    ``backend`` names a contraction backend ('tree' | 'flat' | 'cuda').
    ``sketch_dtype`` ('bfloat16' halves the sketch; contractions still
    accumulate f32) applies to the flat family. Every backend runs where
    its operands lie: 'cuda' launches the kernels on the card's tensors and
    runs their plain versions on the CPU's.

    >>> cfg = HypergradConfig(solver='nystrom', k=4, backend='flat')
    >>> solver = cfg.build()
    >>> (solver.k, solver.backend)
    (4, 'flat')
    >>> HypergradConfig(solver='exact', k=5).build()
    Traceback (most recent call last):
        ...
    ValueError: HypergradConfig.k=5 is not consumed by solver='exact' (it \
consumes: rho) — it would be silently ignored
    """
    solver: str = 'nystrom'       # nystrom | exact
    k: int = 10                   # Nyström rank
    rho: float = 1e-2             # damping
    column_chunk: int | None = None
    sketch_refresh_every: int = 1  # outer steps between sketch rebuilds
    backend: Any = 'tree'         # tree | flat | cuda, or a built backend
    sketch_dtype: str | None = None  # flat family: 'bfloat16'
    refine: int = 1               # residual sweeps on the stabilized apply
    stabilized: bool = True       # False = the literal Eq. 6 apply

    def _build_backend(self):
        from repro_torch.core.backend import get_backend
        if not isinstance(self.backend, str):
            if self.sketch_dtype is not None:
                raise ValueError(
                    'backend is a pre-built instance: set sketch_dtype on the '
                    'instance itself — the config field would be silently '
                    'ignored')
            return self.backend
        kwargs = {}
        if self.sketch_dtype is not None:
            if self.backend == 'tree':
                raise ValueError(
                    "sketch_dtype has no effect on backend='tree' (it never "
                    'builds a fused buffer); pick a flat-family backend')
            if self.sketch_dtype not in _DTYPES:
                raise ValueError(f'sketch_dtype must be one of '
                                 f'{sorted(_DTYPES)}, got {self.sketch_dtype!r}')
            kwargs['sketch_dtype'] = _DTYPES[self.sketch_dtype]
        return get_backend(self.backend, **kwargs) if kwargs else self.backend

    def build(self):
        """Construct the configured solver via the ``SOLVERS`` registry. A
        field set to a non-default value that the chosen solver does not
        consume is an error."""
        from repro_torch.core.solvers import SOLVERS
        spec = SOLVERS.get(self.solver)
        if spec is None:
            raise ValueError(f'unknown solver {self.solver!r}; registered: '
                             f'{sorted(SOLVERS)}')
        consumed = set(spec.fields) | set(_TRAINER_FIELDS)
        if spec.builds_backend:
            consumed |= set(_BACKEND_FIELDS)
        for f in dataclasses.fields(self):
            if f.name in consumed:
                continue
            if getattr(self, f.name) != f.default:
                raise ValueError(
                    f'HypergradConfig.{f.name}={getattr(self, f.name)!r} is '
                    f'not consumed by solver={self.solver!r} (it consumes: '
                    f'{", ".join(sorted(spec.fields))}) — it would be '
                    'silently ignored')
        kwargs = {kw: getattr(self, name) for name, kw in spec.fields.items()}
        if spec.builds_backend:
            kwargs['backend'] = self._build_backend()
        return spec.cls(**kwargs)
