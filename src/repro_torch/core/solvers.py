"""IHVP solvers: the paper's Nyström method and the exact oracle.

Every solver approximates u ≈ (H + ρI)⁻¹ v, with H = ∇²_θ f reached only
through Hessian-vector products, behind one protocol:

    prepare(hvp, indexer, rng) -> state     # touches the model (HVPs)
    apply(state, v)            -> u         # touches only the state
    apply_matrix(state, V)     -> U         # m queries per state pass
    amortizable                             # may the state outlive a step?

``apply_matrix`` takes a *query block*: a tree shaped like v with one
trailing (m,) axis on every leaf. m = 1 goes through the vector ``apply``,
so a width-1 block is bitwise the vector path on every backend.

* ``NystromIHVP`` — the paper's contribution (Eq. 4/6): k HVPs build the
  sketch once; every apply is a few tall-skinny contractions and one k×k
  solve. The default apply is the whitened Woodbury form with refinement
  sweeps; ``stabilized=False`` is the literal Eq. 6.
* ``ExactIHVP`` — dense solve, the oracle of the tests.

The contractions go through a backend (:mod:`repro_torch.core.backend`):
'tree', 'flat' or 'cuda' (the hand-written kernels).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar

import torch

from repro_torch.core.backend import flatten_vecm, get_backend, unflatten_vecm
from repro_torch.core.hvp import extract_columns, make_hvp
from repro_torch.core.tree_util import (PyTree, PyTreeIndexer, tree_flatten,
                                        tree_leaves, tree_map, tree_size)

HVP = Callable[[PyTree], PyTree]

# Eigenvalues of H_KK below this relative threshold are dropped from the
# whitened factor (truncated pseudo-inverse: ReLU-style dead columns).
_EIG_REL_TOL = 1e-7


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _sym_solve(M: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Solve M w = t for a symmetric (possibly indefinite) k×k M; t is (k,)
    or a (k, m) block.

    Jacobi (diagonal) scaling: M = H_KK + CᵀC/ρ mixes the scales of H and
    H²/ρ, which costs about 3 digits in f32; symmetric diagonal scaling
    restores them. The 1e-7 jitter handles zero columns."""
    M = 0.5 * (M + M.T)
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(M)), min=1e-30))
    Ms = M / d[:, None] / d[None, :]
    ds = d if t.ndim == 1 else d[:, None]
    w = torch.linalg.solve(Ms + 1e-7 * _eye(M.shape[0], M), t / ds)
    return w / ds


def query_width(V: PyTree) -> int:
    """The m of a query block: the trailing-axis width every leaf shares."""
    leaves = tree_leaves(V)
    if not leaves:
        raise ValueError('query block has no leaves')
    widths = {l.shape[-1] if l.ndim else None for l in leaves}
    if len(widths) != 1 or None in widths:
        raise ValueError(
            'inconsistent query block: every leaf must carry the same '
            f'trailing (m,) query axis, got widths {sorted(map(str, widths))}')
    return leaves[0].shape[-1]


def _matrix_via_vector(apply_fn, V: PyTree) -> PyTree:
    """m = 1: strip the query axis, run the vector apply, restore the axis —
    bitwise the vector path."""
    u = apply_fn(tree_map(lambda x: x[..., 0], V))
    return tree_map(lambda x: x[..., None], u)


# ---------------------------------------------------------------------------
# Nyström (the paper)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NystromSketch:
    """Prepared sketch, reusable across applies and outer steps.

    ``C`` is the backend-native operand (a leading-k tree for 'tree', the
    (k, p) buffer for 'flat', the (p, k) buffer for 'cuda'). ``B``/``gram_B``
    is the whitened factor of H_k (H_k = B Bᵀ, gram_B = BᵀB), present for
    ``stabilized=True``; ``gram_C`` = CᵀC is cached otherwise. The sketch is
    ρ-free: every apply solves against the applying solver's ρ, so one
    sketch serves a damping sweep. ``rho`` records the prepare-time value.
    """
    C: Any
    H_KK: torch.Tensor
    indices: dict
    rho: float
    B: Any = None
    gram_B: torch.Tensor | None = None
    gram_C: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class NystromIHVP:
    """The paper's method.

    ``stabilized=True`` (default) applies the inverse through the whitened
    factor of H_k, whose k×k system BᵀB + ρI carries cond(H) rather than
    Eq. 6's cond(H)². ``stabilized=False`` is the literal Eq. 6.
    ``refine`` residual sweeps re-apply the inverse to v − (H_k + ρI)u (four
    extra C-passes each, zero HVPs) and drive the f32 cancellation error
    toward roundoff. ``backend`` names a contraction backend or is a built
    one (e.g. ``CudaBackend(sketch_dtype=torch.bfloat16)``).
    """
    amortizable: ClassVar[bool] = True   # NystromSketch is tensors only

    k: int
    rho: float = 1e-2
    column_chunk: int | None = None
    stabilized: bool = True
    backend: Any = 'tree'
    refine: int = 1

    def _be(self):
        if isinstance(self.backend, str):
            return get_backend(self.backend)
        return self.backend

    def prepare(self, hvp: HVP, indexer: PyTreeIndexer, rng, *,
                indices: dict | None = None) -> NystromSketch:
        """k HVPs at sampled columns. ``rng`` is a ``torch.Generator``;
        ``indices=`` injects a structured draw instead."""
        be = self._be()
        idx = indexer.sample_indices(rng, self.k, indices=indices)
        C_tree = extract_columns(hvp, indexer, idx, self.column_chunk)
        H_KK = indexer.gather(C_tree, idx)
        H_KK = 0.5 * (H_KK + H_KK.T)
        C_op = be.prepare_operand(C_tree)
        B = gram_B = gram_C = None
        if self.stabilized:
            B, gram_B = _whitened_form(be, C_op, H_KK)
        else:
            gram_C = be.gram(C_op)   # ρ-independent: Eq. 6 stays two-pass
        return NystromSketch(C=C_op, H_KK=H_KK, indices=idx,
                             rho=float(self.rho), B=B, gram_B=gram_B,
                             gram_C=gram_C)

    def apply(self, sketch: NystromSketch, v: PyTree) -> PyTree:
        be = self._be()
        if self.stabilized and sketch.B is not None:
            return _apply_whitened(be, sketch, v, self.rho, self.refine)
        return _apply_woodbury_direct(be, sketch, v, self.rho)

    def apply_matrix(self, sketch: NystromSketch, V: PyTree) -> PyTree:
        """m IHVPs per sketch pass: every contraction of the vector apply
        widens to a (·, m) GEMM, so m queries cost one set of C-reads."""
        if query_width(V) == 1:
            return _matrix_via_vector(lambda v: self.apply(sketch, v), V)
        be = self._be()
        if self.stabilized and sketch.B is not None:
            return _apply_whitened_m(be, sketch, V, self.rho, self.refine)
        return _apply_woodbury_direct_m(be, sketch, V, self.rho)

    def solve(self, hvp: HVP, indexer: PyTreeIndexer, v: PyTree, rng, *,
              indices: dict | None = None) -> PyTree:
        return self.apply(self.prepare(hvp, indexer, rng, indices=indices), v)


def _whitened_form(be, C_op, H_KK: torch.Tensor):
    """H_k = C H_KK† Cᵀ = B Bᵀ with B = C · U diag(λ†^(1/2)), via a k×k eigh.

    The apply then uses the exact Woodbury identity
    (B Bᵀ + ρI)⁻¹ = (I − B (BᵀB + ρI)⁻¹ Bᵀ) / ρ. Directions with λ(H_KK)
    below the relative threshold become zero columns of B. Eigenvector signs
    differ between libraries; B does too, BᵀB and every applied result do
    not."""
    lam, U = torch.linalg.eigh(H_KK)
    lam_max = torch.max(torch.abs(lam)) + 1e-30
    tol = _EIG_REL_TOL * lam_max * H_KK.shape[0]
    inv_sqrt = torch.where(lam > tol,
                           1.0 / torch.sqrt(torch.maximum(lam, tol)),
                           torch.zeros_like(lam))
    B = be.mul_right(C_op, U * inv_sqrt[None, :])
    G = be.gram(B)
    return B, 0.5 * (G + G.T)


def _apply_whitened(be, s: NystromSketch, v: PyTree, rho: float,
                    refine: int = 1) -> PyTree:
    """u = v/ρ − B (BᵀB + ρI)⁻¹ (Bᵀ v) / ρ, plus ``refine`` residual
    sweeps against H_k = BBᵀ."""
    vf = be.vec(v)
    M = s.gram_B + rho * _eye(s.gram_B.shape[0], s.gram_B)

    def woodbury(x):
        t = be.ctv(s.B, x)
        w = -torch.linalg.solve(M, t) / rho
        return be.combine(s.B, w, x, rho)

    u = woodbury(vf)
    for _ in range(refine):
        h_u = be.cv(s.B, be.ctv(s.B, u))       # H_k u
        r = be.sub(be.sub(vf, be.scale(u, rho)), h_u)
        u = be.add(u, woodbury(r))
    return be.unvec(u, v)


def _apply_whitened_m(be, s: NystromSketch, V: PyTree, rho: float,
                      refine: int = 1) -> PyTree:
    """The whitened apply over an m-query block: the same algebra with every
    k-vector widened to (k, m) and every p-vector to a (p, m) block."""
    Vm = be.vecm(V)
    M = s.gram_B + rho * _eye(s.gram_B.shape[0], s.gram_B)

    def woodbury(X):
        T = be.ctm(s.B, X)
        W = -torch.linalg.solve(M, T) / rho
        return be.combinem(s.B, W, X, rho)

    U = woodbury(Vm)
    for _ in range(refine):
        h_u = be.cm(s.B, be.ctm(s.B, U))       # H_k U
        r = be.sub(be.sub(Vm, be.scale(U, rho)), h_u)
        U = be.add(U, woodbury(r))
    return be.unvecm(U, V)


def _apply_woodbury_direct(be, s: NystromSketch, v: PyTree,
                           rho: float) -> PyTree:
    """Eq. 6: u = v/ρ − C (H_KK + CᵀC/ρ)⁻¹ (Cᵀv) / ρ²."""
    vf = be.vec(v)
    t = be.ctv(s.C, vf)
    gram_C = s.gram_C if s.gram_C is not None else be.gram(s.C)
    w = _sym_solve(s.H_KK + gram_C / rho, t)
    return be.unvec(be.combine(s.C, -w / (rho * rho), vf, rho), v)


def _apply_woodbury_direct_m(be, s: NystromSketch, V: PyTree,
                             rho: float) -> PyTree:
    """Eq. 6 over an m-query block: one k×k system, m right-hand sides."""
    Vm = be.vecm(V)
    T = be.ctm(s.C, Vm)
    gram_C = s.gram_C if s.gram_C is not None else be.gram(s.C)
    W = _sym_solve(s.H_KK + gram_C / rho, T)
    return be.unvecm(be.combinem(s.C, -W / (rho * rho), Vm, rho), V)


# ---------------------------------------------------------------------------
# Exact oracle
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DenseFactor:
    """ExactIHVP's prepared state: the materialized, symmetrized Hessian.
    ρ-free: ``apply`` adds the applying solver's ρI."""
    H: torch.Tensor    # (p, p)


@dataclasses.dataclass(frozen=True)
class ExactIHVP:
    """Materialize H column by column and dense-solve (tests, tiny models)."""
    amortizable: ClassVar[bool] = True   # DenseFactor is tensors only

    rho: float = 1e-2

    def prepare(self, hvp: HVP, indexer: PyTreeIndexer, rng=None, *,
                indices: dict | None = None) -> DenseFactor:
        del rng, indices
        idx = indexer.all_indices()
        C = extract_columns(hvp, indexer, idx)
        H = indexer.gather(C, idx)
        return DenseFactor(H=0.5 * (H + H.T))

    def _solve(self, state: DenseFactor, rhs: torch.Tensor) -> torch.Tensor:
        return torch.linalg.solve(
            state.H + self.rho * _eye(state.H.shape[0], state.H), rhs)

    def apply(self, state: DenseFactor, v: PyTree) -> PyTree:
        leaves, treedef = tree_flatten(v)
        u = self._solve(state, torch.cat([x.float().reshape(-1)
                                          for x in leaves]))
        outs, off = [], 0
        for leaf in leaves:
            n = leaf.numel()
            outs.append(u[off:off + n].reshape(leaf.shape).to(leaf.dtype))
            off += n
        return treedef.unflatten(outs)

    def apply_matrix(self, state: DenseFactor, V: PyTree) -> PyTree:
        """One factorization against m right-hand sides."""
        if query_width(V) == 1:
            return _matrix_via_vector(lambda v: self.apply(state, v), V)
        return unflatten_vecm(self._solve(state, flatten_vecm(V)), V)

    def solve(self, hvp: HVP, indexer: PyTreeIndexer, v: PyTree, rng=None
              ) -> PyTree:
        return self.apply(self.prepare(hvp, indexer, rng), v)


def build_hvp_bill(solver, params_like: PyTree) -> int:
    """HVPs one prepared-state build costs: the Nyström rank ``k``, or the
    parameter count for the exact solver's column scan."""
    k = getattr(solver, 'k', None)
    if k is not None:
        return int(k)
    return tree_size(params_like)


# ---------------------------------------------------------------------------
# Sketch lifecycle — build / refresh / invalidate of amortizable states
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SketchState:
    """A prepared solver state plus its age in outer steps served since the
    last build. ``sketch`` is None until the first build."""
    sketch: Any
    age: int


@dataclasses.dataclass(frozen=True)
class SketchPolicy:
    """Owns the lifecycle of an amortizable solver state.

    ``refresh_every=N`` rebuilds the state every N uses: N = 1 is the
    always-fresh cadence, larger N trades accuracy (the backward pass
    linearizes at a stale θ) for k fewer HVPs on N−1 of every N outer
    steps. The decision is plain Python control flow (the reference stages
    it through ``lax.cond``)."""
    solver: Any
    inner_loss: Callable[..., torch.Tensor]   # f(theta, phi, batch) -> scalar
    refresh_every: int = 1

    def __post_init__(self):
        if self.refresh_every < 1:
            raise ValueError(
                f'refresh_every must be >= 1, got {self.refresh_every}')
        if not getattr(type(self.solver), 'amortizable', False):
            raise TypeError(
                f'{type(self.solver).__name__} prepares a trace-local state — '
                'it has nothing to amortize across outer steps')

    def build(self, params: PyTree, hparams: PyTree, batch: Any, rng, *,
              indices: dict | None = None):
        """Prepare the solver state at (params, hparams, batch): the only
        lifecycle stage that runs HVPs."""
        hvp = make_hvp(self.inner_loss, params, hparams, batch)
        return self.solver.prepare(hvp, PyTreeIndexer(params), rng,
                                   indices=indices)

    def init_state(self) -> SketchState:
        """A stale state: the first ``refresh`` builds it."""
        return SketchState(sketch=None, age=self.refresh_every)

    def due(self, state: SketchState) -> bool:
        return state.sketch is None or state.age >= self.refresh_every

    def refresh(self, state: SketchState, params: PyTree, hparams: PyTree,
                batch: Any, rng, *, indices: dict | None = None
                ) -> tuple[SketchState, bool]:
        """Advance by one outer step: rebuild when due, else keep and age.
        Returns (state', rebuilt)."""
        if self.due(state):
            sketch = self.build(params, hparams, batch, rng, indices=indices)
            return SketchState(sketch=sketch, age=1), True
        return SketchState(sketch=state.sketch, age=state.age + 1), False

    def invalidate(self, state: SketchState) -> SketchState:
        """Mark the state stale so the next ``refresh`` rebuilds."""
        return SketchState(sketch=state.sketch, age=self.refresh_every)


# ---------------------------------------------------------------------------
# Registry — drives HypergradConfig.build()
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Registry entry: constructor + the HypergradConfig fields it consumes
    (config-field name → constructor kwarg). ``builds_backend`` marks the
    solvers that also consume the backend-selection fields."""
    cls: type
    fields: dict[str, str]
    builds_backend: bool = False


SOLVERS = {
    'nystrom': SolverSpec(NystromIHVP,
                          {'k': 'k', 'rho': 'rho',
                           'column_chunk': 'column_chunk',
                           'refine': 'refine', 'stabilized': 'stabilized'},
                          builds_backend=True),
    'exact': SolverSpec(ExactIHVP, {'rho': 'rho'}),
}
