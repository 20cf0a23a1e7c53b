"""Hypergradient assembly (Eq. 3) and its configuration.

    dg/dφ = −(∂g/∂θ) (∇²_θ f + ρI)⁻¹ (∂²f/∂φ∂θ) + ∂g/∂φ

The assembly lives in :mod:`repro_torch.core.implicit`: the inner solution
is an autograd Function whose backward pass is the IHVP plus the mixed-term
VJP, so Eq. 3 is plain ``torch.autograd.grad`` or ``torch.func.grad``.
``hypergradient`` is the imperative entry point on top of it;
``unrolled_hypergradient``, the oracle that differentiates through the
unrolled inner SGD, checks it on tiny problems. ``config_from_cli`` builds
a config from command-line flags.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from torch.func import grad

from repro_torch.core.tree_util import PyTree, tree_map

InnerLoss = Callable[..., torch.Tensor]   # f(params, hparams, batch) -> scalar
OuterLoss = Callable[..., torch.Tensor]   # g(params, hparams, batch) -> scalar


def hypergradient(inner_loss: InnerLoss, outer_loss: OuterLoss,
                  params: PyTree, hparams: PyTree, inner_batch: Any,
                  outer_batch: Any, solver, rng=None, *, sketch=None,
                  indices: dict | None = None) -> PyTree:
    """Approximate dg/dφ at (params, hparams) by implicit differentiation.

    Treats ``params`` as the inner solution θ*, wraps it in the
    ``implicit_root`` map and differentiates ``g(θ*(φ), φ)`` with
    ``torch.func.grad``, so it composes with ``torch.func`` transforms:
    under ``vmap`` over stacked points it gives per-point hypergradients.
    ``sketch`` is an optional pre-built solver state; ``rng``/``indices``
    pick the sketch columns otherwise."""
    from repro_torch.core.implicit import implicit_root
    solve = implicit_root(lambda phi, batch: params, inner_loss, solver)

    def outer_of(phi):
        theta = solve(phi, inner_batch, rng=rng, state=sketch,
                      indices=indices)
        return outer_loss(theta, phi, outer_batch)

    return grad(outer_of)(tree_map(torch.Tensor.detach, hparams))


def unrolled_hypergradient(inner_loss: InnerLoss, outer_loss: OuterLoss,
                           params: PyTree, hparams: PyTree, inner_batch: Any,
                           outer_batch: Any, steps: int,
                           lr: float) -> PyTree:
    """The oracle: dg/dφ through ``steps`` unrolled SGD steps from
    ``params``. O(steps × activations) memory: tiny problems only."""
    def outer_of_unroll(phi):
        p = params
        for _ in range(steps):
            g = grad(inner_loss, argnums=0)(p, phi, inner_batch)
            p = tree_map(lambda w, gw: w - lr * gw, p, g)
        return outer_loss(p, phi, outer_batch)

    return grad(outer_of_unroll)(hparams)


def config_from_cli(solver: str, flags: dict, defaults: dict,
                    **consumed_extras) -> 'HypergradConfig':
    """A HypergradConfig from command-line flags, checked against the
    registry.

    ``flags`` maps field → parsed value, ``None`` meaning the flag was not
    passed. A passed flag the solver does not consume raises, even when its
    value equals the default (which ``build()``'s own check cannot tell
    apart). Unpassed flags take ``defaults`` where the solver consumes them.
    ``consumed_extras`` are script-level settings forwarded only to solvers
    that consume them, and dropped otherwise.

    >>> config_from_cli('nystrom', flags={'backend': 'flat'},
    ...                 defaults={}).backend
    'flat'
    >>> config_from_cli('cg', flags={'backend': 'flat'}, defaults={})
    Traceback (most recent call last):
        ...
    ValueError: --backend=flat is not consumed by solver='cg' (it consumes: \
k, rho, sketch_refresh_every)
    """
    from repro_torch.core.solvers import SOLVERS
    if solver not in SOLVERS:
        raise ValueError(f'unknown solver {solver!r}; registered: '
                         f'{sorted(SOLVERS)}')
    spec = SOLVERS[solver]
    consumed = set(spec.fields) | (set(_TRAINER_FIELDS) - {'solver'})
    if spec.builds_backend:
        consumed |= set(_BACKEND_FIELDS)
    kwargs = {'solver': solver}
    for name, value in flags.items():
        if value is not None:
            if name not in consumed:
                raise ValueError(
                    f'--{name}={value} is not consumed by solver='
                    f'{solver!r} (it consumes: '
                    f'{", ".join(sorted(consumed))})')
            kwargs[name] = value
        elif name in consumed and name in defaults:
            kwargs[name] = defaults[name]
    for name, value in consumed_extras.items():
        if name in consumed:
            kwargs[name] = value
    return HypergradConfig(**kwargs)


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
    solver: str = 'nystrom'       # nystrom | cg | neumann | exact
    k: int = 10                   # Nyström rank / iterations l for baselines
    rho: float = 1e-2             # damping (Nyström/exact) or CG Tikhonov
    alpha: float = 1e-2           # Neumann step size
    kappa: int | None = None      # Alg. 1 chunk width (None: no chunking)
    column_chunk: int | None = None
    sketch_refresh_every: int = 1  # outer steps between sketch rebuilds
    importance_sampling: bool = False  # weighted column draw (Remark 1)
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
