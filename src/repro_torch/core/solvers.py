"""IHVP solvers: the paper's Nyström method, the baselines it compares to
(CG, Neumann) and the exact oracle.

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
  sweeps; ``stabilized=False`` is the literal Eq. 6; ``kappa < k`` is
  Alg. 1, recursive rank-κ Woodbury updates.
* ``CGIHVP`` / ``NeumannIHVP`` — the iterative baselines: a fixed count
  of sequential HVPs per apply, nothing to amortize (``amortizable`` is
  False: the state is a handle on the step's hvp).
* ``ExactIHVP`` — dense solve, the oracle of the tests.

The contractions go through a backend (:mod:`repro_torch.core.backend`):
'tree', 'flat', 'cuda' (the hand-written kernels) or 'flat_sharded' (the
kernels on each rank's blocks of a mesh, whose operand and vectors its own
``slice_k``/``scale``/``sub``/``add`` handle).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar

import torch

from repro_torch.core.backend import flatten_vecm, get_backend, unflatten_vecm
from repro_torch.core.hvp import (HVP, extract_columns,
                                  for_each_column_chunk, make_hvp)
from repro_torch.core.tree_util import (PyTree, PyTreeIndexer, tree_axpy,
                                        tree_flatten, tree_flatten_with_path,
                                        tree_leaves, tree_map, tree_scale,
                                        tree_size, tree_vdot)

HVP = Callable[[PyTree], PyTree]

# Eigenvalues of H_KK below this relative threshold are dropped from the
# whitened factor, and sent to _SAFE_BIG on Alg. 1's path so that their
# rank-1 Woodbury term vanishes (truncated pseudo-inverse: ReLU-style dead
# columns).
_EIG_REL_TOL = 1e-7
_SAFE_BIG = 1e30


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
    ``stabilized=True`` unless Alg. 1 is selected (``kappa < k``, which never
    reads it); ``gram_C`` = CᵀC is cached otherwise. The sketch is ρ-free:
    every apply solves against the applying solver's ρ, so one sketch serves
    a damping sweep. ``rho`` records the prepare-time value.
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

    ``kappa < k`` selects Alg. 1, the chunked apply: recursive rank-κ
    Woodbury updates, the paper's memory-lean form. It takes precedence over
    ``stabilized`` (it carries its own truncation of small eigenvalues), so
    ``prepare`` caches ``gram_C`` and builds no whitened factor; ``refine``
    stays live. ``importance_sampling`` draws the sketch's columns with the
    weights ``prepare`` is given as ``diag_weights`` (Remark 1).
    """
    amortizable: ClassVar[bool] = True   # NystromSketch is tensors only

    k: int
    rho: float = 1e-2
    kappa: int | None = None
    column_chunk: int | None = None
    importance_sampling: bool = False
    stabilized: bool = True
    backend: Any = 'tree'
    refine: int = 1

    def _be(self):
        if isinstance(self.backend, str):
            return get_backend(self.backend)
        return self.backend

    def _chunked(self) -> bool:
        return self.kappa is not None and self.kappa < self.k

    def prepare(self, hvp: HVP, indexer: PyTreeIndexer, rng,
                diag_weights: torch.Tensor | None = None, *,
                indices: dict | None = None) -> NystromSketch:
        """k HVPs at sampled columns. ``rng`` is a ``torch.Generator``;
        ``indices=`` injects a structured draw instead. ``diag_weights``
        (flat, length p) weight the draw when ``importance_sampling``."""
        be = self._be()
        weights = diag_weights if self.importance_sampling else None
        idx = indexer.sample_indices(rng, self.k, weights, indices=indices)
        C_op, H_KK = _build_operand(be, hvp, indexer, idx, self.column_chunk)
        H_KK = 0.5 * (H_KK + H_KK.T)
        B = gram_B = gram_C = None
        if self.stabilized and not self._chunked():
            B, gram_B = _whitened_form(be, C_op, H_KK)
        else:
            gram_C = be.gram(C_op)   # ρ-independent: Eq. 6 stays two-pass
        return NystromSketch(C=C_op, H_KK=H_KK, indices=idx,
                             rho=float(self.rho), B=B, gram_B=gram_B,
                             gram_C=gram_C)

    def apply(self, sketch: NystromSketch, v: PyTree) -> PyTree:
        be = self._be()
        if self._chunked():
            return _apply_woodbury_chunked(be, sketch, v, self.kappa,
                                           self.rho, self.refine)
        if self.stabilized and sketch.B is not None:
            return _apply_whitened(be, sketch, v, self.rho, self.refine)
        return _apply_woodbury_direct(be, sketch, v, self.rho)

    def apply_matrix(self, sketch: NystromSketch, V: PyTree) -> PyTree:
        """m IHVPs per sketch pass: every contraction of the vector apply
        widens to a (·, m) GEMM, so m queries cost one set of C-reads (the
        same precedence: chunked, whitened, direct)."""
        if query_width(V) == 1:
            return _matrix_via_vector(lambda v: self.apply(sketch, v), V)
        be = self._be()
        if self._chunked():
            return _apply_woodbury_chunked_m(be, sketch, V, self.kappa,
                                             self.rho, self.refine)
        if self.stabilized and sketch.B is not None:
            return _apply_whitened_m(be, sketch, V, self.rho, self.refine)
        return _apply_woodbury_direct_m(be, sketch, V, self.rho)

    def solve(self, hvp: HVP, indexer: PyTreeIndexer, v: PyTree, rng, *,
              indices: dict | None = None) -> PyTree:
        return self.apply(self.prepare(hvp, indexer, rng, indices=indices), v)


def theta_backend(solver):
    """The backend that holds ``solver``'s θ-trees, whose ``indexer`` and
    ``vdot`` the sketch build and Eq. 3's mixed term use: the Nyström
    solver's own (``flat_sharded`` over a split model holds this rank's
    blocks), the tree backend for the solvers that take whole trees."""
    return solver._be() if isinstance(solver, NystromIHVP) else \
        get_backend('tree')


def _build_operand(be, hvp: HVP, indexer: PyTreeIndexer, idx: dict,
                   column_chunk: int | None):
    """(C in the backend's layout, H_KK unsymmetrized), chunk by chunk: each
    chunk's columns are gathered at the draw (its rows of H_KK) and written
    into the backend's operand (for the flat family, the fused buffer
    allocated once in ``sketch_dtype``), then dropped. The peak is the
    operand plus one chunk's one-hots and columns, where a whole tree of
    columns, its copy in the buffer's dtype and layout, and their
    concatenation would coexist."""
    sink = be.operand_sink(idx['leaf'].shape[0], indexer.total,
                           indexer.device)
    rows: list = []

    def take(start: int, cols: PyTree) -> None:
        rows.append(indexer.gather(cols, idx))
        sink.write(start, cols)

    for_each_column_chunk(hvp, indexer, idx, column_chunk, take)
    return sink.finish(), torch.cat(rows, 0)


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


def _eig_factors(be, s: NystromSketch):
    """L = C·U and λ(H_KK), small eigenvalues sent to _SAFE_BIG (Alg. 1)."""
    lam, U = torch.linalg.eigh(s.H_KK)
    scale = torch.max(torch.abs(lam)) + 1e-30
    lam_safe = torch.where(torch.abs(lam) < _EIG_REL_TOL * scale,
                           torch.full_like(lam, _SAFE_BIG), lam)
    return be.mul_right(s.C, U), lam_safe


def _chunk_factors(be, s: NystromSketch, kappa: int, rho: float):
    """Alg. 1's factors, shared by the vector and block applies.

    After chunk m, Ĥ_m x = x/ρ − Σ_{j≤m} G_j R_j (G_jᵀ x), held as the list
    {(G_j, R_j)}. Per chunk: apply Ĥ_m to the κ new columns of L (a block
    of backend contractions), invert a κ×κ system, append a factor. Equal to
    Eq. 6 for every κ. Returns (L, λ_safe, factors)."""
    k = s.indices['leaf'].shape[0]
    L, lam = _eig_factors(be, s)
    factors: list[tuple[Any, torch.Tensor]] = []

    def apply_running_block(X):
        out = be.scale(X, 1.0 / rho)
        for G, R in factors:
            out = be.sub(out, be.mul_right(G, R @ be.cross(G, X)))
        return out

    for start in range(0, k, kappa):
        width = min(kappa, k - start)
        Lm = be.slice_k(L, start, width)
        HmL = apply_running_block(Lm)
        S = torch.diag(lam[start:start + width]) + be.cross(Lm, HmL)
        S = 0.5 * (S + S.T)
        jitter = 1e-8 * (torch.trace(torch.abs(S)) / width + 1.0)
        R = torch.linalg.inv(S + jitter * _eye(width, S))
        factors.append((HmL, 0.5 * (R + R.T)))
    return L, lam, factors


def _apply_woodbury_chunked(be, s: NystromSketch, v: PyTree, kappa: int,
                            rho: float, refine: int = 0) -> PyTree:
    """Alg. 1 in operator form: u = Ĥ_K v, plus ``refine`` residual sweeps
    against H_k + ρI with H_k u = L diag(λ_safe⁻¹) (Lᵀ u)."""
    L, lam, factors = _chunk_factors(be, s, kappa, rho)

    def apply_factors(x):
        out = be.scale(x, 1.0 / rho)
        for G, R in factors:
            out = be.sub(out, be.cv(G, R @ be.ctv(G, x)))
        return out

    vf = be.vec(v)
    u = apply_factors(vf)
    for _ in range(refine):
        h_u = be.cv(L, be.ctv(L, u) / lam)
        r = be.sub(be.sub(vf, be.scale(u, rho)), h_u)
        u = be.add(u, apply_factors(r))
    return be.unvec(u, v)


def _apply_woodbury_chunked_m(be, s: NystromSketch, V: PyTree, kappa: int,
                              rho: float, refine: int = 0) -> PyTree:
    """Alg. 1 over an m-query block: the factors are built once and each
    rank-κ correction hits all m queries as one GEMM pair."""
    L, lam, factors = _chunk_factors(be, s, kappa, rho)

    def apply_factors(X):
        out = be.scale(X, 1.0 / rho)
        for G, R in factors:
            out = be.sub(out, be.cm(G, R @ be.ctm(G, X)))
        return out

    Vm = be.vecm(V)
    U = apply_factors(Vm)
    for _ in range(refine):
        h_u = be.cm(L, be.ctm(L, U) / lam[:, None])
        r = be.sub(be.sub(Vm, be.scale(U, rho)), h_u)
        U = be.add(U, apply_factors(r))
    return be.unvecm(U, V)


def nystrom_inverse_dense(H: torch.Tensor, k: int, rho: float, rng=None, *,
                          indices=None) -> torch.Tensor:
    """(H_k + ρI)⁻¹ as an explicit p×p matrix, in H's dtype (the Fig. 1
    oracle; test scale only). The k distinct columns come from ``rng`` (a
    CPU ``torch.Generator``) or are injected as ``indices`` (flat ints)."""
    p = H.shape[0]
    if indices is None:
        indices = torch.randperm(p, generator=rng)[:min(k, p)]
    idx = torch.as_tensor(indices, dtype=torch.int64, device=H.device)
    C = H[:, idx]
    H_KK = 0.5 * (C[idx, :] + C[idx, :].T)
    M = H_KK + C.T @ C / rho
    M = 0.5 * (M + M.T) + 1e-8 * _eye(M.shape[0], M)
    return _eye(p, H) / rho - C @ torch.linalg.solve(M, C.T) / rho ** 2


# ---------------------------------------------------------------------------
# Iterative baselines
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class IterativeOperator:
    """Prepared state of an iterative solver: a handle on the step's hvp.
    It holds a callable, not tensors, so it has no byte footprint and no
    identity to cache, and it cannot outlive the parameters it closes
    over."""
    hvp: HVP


def _vmapped(apply_fn, V: PyTree) -> PyTree:
    """An iterative apply over an m-query block: the m solves stay
    independent (each has its own scalars), the HVPs inside run batched
    under ``torch.func.vmap`` over the trailing axis."""
    if query_width(V) == 1:
        return _matrix_via_vector(apply_fn, V)
    return torch.func.vmap(apply_fn, in_dims=-1, out_dims=-1)(V)


def _guard(x: torch.Tensor) -> torch.Tensor:
    """x with |x| < 1e-30 replaced by 1e-30: a divisor that never is 0."""
    return torch.where(torch.abs(x) < 1e-30, torch.full_like(x, 1e-30), x)


@dataclasses.dataclass(frozen=True)
class CGIHVP:
    """Truncated conjugate gradient on (H + ρI) x = v: a fixed ``iters``
    count of sequential HVPs, with no host synchronisation inside the loop.
    ρ = 0 is the paper's baseline; ρ > 0 is Tikhonov damping."""
    amortizable: ClassVar[bool] = False  # IterativeOperator is step-local

    iters: int = 5
    rho: float = 0.0

    def prepare(self, hvp: HVP, indexer: PyTreeIndexer = None, rng=None, *,
                indices: dict | None = None) -> IterativeOperator:
        del indexer, rng, indices
        return IterativeOperator(hvp=hvp)

    def apply(self, state: IterativeOperator, v: PyTree) -> PyTree:
        def matvec(x):
            return tree_axpy(self.rho, x, state.hvp(x))

        x = tree_map(torch.zeros_like, v)
        r = p = v
        rs = tree_vdot(r, r)
        for _ in range(self.iters):
            Ap = matvec(p)
            alpha = rs / _guard(tree_vdot(p, Ap))
            x = tree_axpy(alpha, p, x)
            r = tree_axpy(-alpha, Ap, r)
            rs_new = tree_vdot(r, r)
            beta = rs_new / _guard(rs)
            p = tree_axpy(beta, p, r)
            rs = rs_new
        return x

    def apply_matrix(self, state: IterativeOperator, V: PyTree) -> PyTree:
        return _vmapped(lambda v: self.apply(state, v), V)

    def solve(self, hvp: HVP, indexer: PyTreeIndexer, v: PyTree, rng=None
              ) -> PyTree:
        return self.apply(self.prepare(hvp, indexer, rng), v)


@dataclasses.dataclass(frozen=True)
class NeumannIHVP:
    """Truncated Neumann series (Lorraine et al. 2020):
    H⁻¹ ≈ α Σ_{j=0}^{l} (I − αH)^j; converges only for ‖αH‖ < 2 on PSD H,
    and diverges past it."""
    amortizable: ClassVar[bool] = False  # IterativeOperator is step-local

    iters: int = 5
    alpha: float = 1e-2

    def prepare(self, hvp: HVP, indexer: PyTreeIndexer = None, rng=None, *,
                indices: dict | None = None) -> IterativeOperator:
        del indexer, rng, indices
        return IterativeOperator(hvp=hvp)

    def apply(self, state: IterativeOperator, v: PyTree) -> PyTree:
        p = acc = v
        for _ in range(self.iters):
            p = tree_axpy(-self.alpha, state.hvp(p), p)   # p ← (I − αH) p
            acc = tree_axpy(1.0, p, acc)
        return tree_scale(acc, self.alpha)

    def apply_matrix(self, state: IterativeOperator, V: PyTree) -> PyTree:
        return _vmapped(lambda v: self.apply(state, v), V)

    def solve(self, hvp: HVP, indexer: PyTreeIndexer, v: PyTree, rng=None
              ) -> PyTree:
        return self.apply(self.prepare(hvp, indexer, rng), v)


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


# ---------------------------------------------------------------------------
# The solver as a linear-system solve, and over a task axis
# ---------------------------------------------------------------------------
def apply_tasks(solver, state, W: PyTree) -> list:
    """u_b = (H + ρI)⁻¹ w_b for every row b of ``W``'s leading task axis,
    against one shared state: the n right-hand sides become one query block
    and one ``apply_matrix`` (a single set of sketch passes). Returns u's
    leaves, task axis first."""
    U = solver.apply_matrix(state, tree_map(lambda x: x.movedim(0, -1), W))
    return [x.movedim(-1, 0) for x in tree_leaves(U)]


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


def _zeros_for(grads, like) -> list:
    """(Co)tangents in the dtypes of ``like``'s leaves, zeros where None (a
    forward-mode formula of PyTorch's may widen a tangent to f64, which the
    kernels refuse)."""
    return [torch.zeros_like(x) if g is None else g.to(x.dtype)
            for g, x in zip(grads, like)]


_RULE_LEVELS: list = []   # the forward-mode levels of the jvp rules running


def forward_rule(jvp_rule):
    """Wrap a Function's ``jvp`` staticmethod so that forward mode over it
    raises instead of answering zero. PyTorch runs a jvp rule with
    forward-mode AD off, so a forward-mode transform *outside* the one the
    rule serves (``jacfwd(jacfwd(...))``) would see no tangent through the
    rule's work. A forward level opened inside another rule (that rule's
    own mixed-term jvp) is fine, and so are reverse levels (``jacrev`` of
    ``jacfwd``, ``jacfwd`` of ``grad``)."""
    from torch._C._functorch import TransformType
    from torch._functorch.pyfunctorch import \
        retrieve_all_functorch_interpreters

    def rule(ctx, *dots):
        levels = [i.level() for i in retrieve_all_functorch_interpreters()
                  if i.key() == TransformType.Jvp]
        if any(lv not in _RULE_LEVELS for lv in levels[:-1]):
            raise NotImplementedError(
                'forward mode over forward mode through a solution map '
                '(jacfwd of jacfwd) is not available: take jacrev of '
                'jacfwd, or jacfwd/jacrev of grad')
        _RULE_LEVELS.append(levels[-1] if levels else None)
        try:
            return jvp_rule(ctx, *dots)
        finally:
            _RULE_LEVELS.pop()
    return staticmethod(rule)


@dataclasses.dataclass
class _SolveSpec:
    """Everything a :class:`_LinearSolve` needs besides its tensors.

    Operands: the system's point (``n_point`` leaves), then w's leaves. The
    system is ρI + H, H the Hessian in ``params`` of ``loss_fn`` at
    ``unpack(point) = (params, args, extra)``: ``params`` is frozen (the
    linearization point), the point leaves that ``live`` marks are live
    (the solve differentiates through them), and ``extra`` (an injected
    index draw) only ``prepare`` reads. ``state`` is a prepared state, or
    None: then ``prepare(params, args, extra)`` builds one at the first
    forward (one per task where the point carries the task axis), and every
    call of the rules re-applies it (``prepared``). ``tasks``/``batched``
    as in the solution map's spec."""
    solver: Any
    state: Any
    loss_fn: Callable
    unpack: Callable[[list], tuple]
    n_point: int
    live: tuple
    w_def: Any
    prepare: Callable | None = None
    prepared: Any = None
    prepared_tasks: list | None = None
    tasks: int | None = None
    batched: tuple = ()

    def state_at(self, point: list):
        if self.state is not None:
            return self.state
        if self.prepared is None:
            self.prepared = self.prepare(*self.unpack(point))
        return self.prepared

    def system(self, point: list) -> Callable[[PyTree], PyTree]:
        """u ↦ H u at the point, ``params`` frozen."""
        params, args, _ = self.unpack(point)
        return make_hvp(self.loss_fn, tree_map(torch.Tensor.detach, params),
                        *args)

    def live_at(self, point: list, dots: list) -> list[int]:
        """The point leaves that are live and carry a tangent (cotangent
        request) here."""
        return [i for i, (x, d) in enumerate(zip(point, dots))
                if self.live[i] and d and isinstance(x, torch.Tensor)
                and x.is_floating_point()]

    def per_task(self, fn, ops: list, flags: Callable[[tuple], tuple]):
        """``fn(*ops)``, under ``torch.func.vmap`` over the task axis where
        the spec is task-batched (``flags(batched)``: which of ``ops`` carry
        it)."""
        if self.tasks is None:
            return fn(*ops)
        return torch.func.vmap(fn, in_dims=tuple(
            0 if b else None for b in flags(self.batched)))(*ops)


class _LinearSolve(torch.autograd.Function):
    """w ↦ u = (H + ρI)⁻¹ w through ``solver.apply``, differentiated as the
    reference's ``custom_linear_solve``: the jvp is
    solve(ẇ − Ḣ·u), with Ḣ the derivative of the system matvec
    ρ·u + H(point)·u along the live point's tangent, and the backward pass
    the transposed solve (the system is symmetric): w̄ = solve(ū) and
    point̄ = −∇⟨w̄, H(point)·u⟩. Both rules re-apply this Function, so
    higher orders re-enter them and the kernels always see plain tensors.
    Under ``vmap`` the rows of w go through one ``apply_matrix`` against one
    state, or each task prepares its own where the point is batched."""

    @staticmethod
    def forward(spec, *args):
        ops, n = _detached(args), spec.n_point
        point, w = ops[:n], ops[n:]
        if spec.tasks is None:
            return tuple(tree_leaves(spec.solver.apply(
                spec.state_at(point), spec.w_def.unflatten(w))))
        w = [x if t else x.expand(spec.tasks, *x.shape)
             for x, t in zip(w, spec.batched[n:])]
        if spec.state is not None or not any(spec.batched[:n]):
            return tuple(apply_tasks(spec.solver, spec.state_at(point),
                                     spec.w_def.unflatten(w)))
        if spec.prepared_tasks is None:
            spec.prepared_tasks = [
                spec.prepare(*spec.unpack([x[b] if t else x for x, t in zip(
                    point, spec.batched)])) for b in range(spec.tasks)]
        us = [tree_leaves(spec.solver.apply(
            state, spec.w_def.unflatten([x[b] for x in w])))
            for b, state in enumerate(spec.prepared_tasks)]
        return tuple(torch.stack(xs) for xs in zip(*us))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[0]
        _save(ctx, [*inputs[1:], *output], forward=True)

    @forward_rule
    def jvp(ctx, _spec_dot, *dots):
        spec, n = ctx.spec, ctx.spec.n_point
        saved = _saved(ctx)
        point, w = saved[:n], saved[n:len(dots)]
        u = saved[len(dots):]
        rhs = _zeros_for(dots[n:], w)
        live = spec.live_at(point, [d is not None for d in dots[:n]])
        if live:
            def h_dot(*xs):
                pt, ud = list(xs[:n]), list(xs[n:n + len(u)])
                tangents = xs[n + len(u):]

                def hu(*lv):
                    for i, x in zip(live, lv):
                        pt[i] = x
                    return tuple(tree_leaves(spec.system(pt)(
                        spec.w_def.unflatten(ud))))
                return torch.func.jvp(hu, tuple(xs[i] for i in live),
                                      tuple(tangents))[1]
            hd = spec.per_task(
                h_dot, [*point, *u, *(dots[i] for i in live)],
                lambda b: (*b[:n], *(True,) * len(u), *(b[i] for i in live)))
            rhs = [r - h.to(r.dtype) for r, h in zip(rhs, hd)]
        return _LinearSolve.apply(_task_rhs(spec), *point, *rhs)

    @staticmethod
    def backward(ctx, *g):
        spec, n = ctx.spec, ctx.spec.n_point
        saved = _saved(ctx)
        point, u = saved[:n], saved[n + len(g):]
        w_bar = _LinearSolve.apply(_task_rhs(spec), *point,
                                   *_zeros_for(g, u))
        point_bar = [None] * n
        live = spec.live_at(point, ctx.needs_input_grad[1:n + 1])
        if live:
            def vjp(*xs):
                pt, ud = list(xs[:n]), list(xs[n:n + len(u)])

                def hu(*lv):
                    for i, x in zip(live, lv):
                        pt[i] = x
                    return tuple(tree_leaves(spec.system(pt)(
                        spec.w_def.unflatten(ud))))
                _, pull = torch.func.vjp(hu, *(xs[i] for i in live))
                return tuple(-x for x in pull(tuple(xs[n + len(u):])))
            grads = spec.per_task(
                vjp, [*point, *u, *w_bar],
                lambda b: (*b[:n], *(True,) * (2 * len(u))))
            for i, x in zip(live, grads):
                point_bar[i] = x.to(point[i].dtype)
        return (None, *point_bar, *w_bar)

    @staticmethod
    def vmap(info, in_dims, spec, *args):
        dims = in_dims[1:]
        if spec.tasks is not None:
            # a vmap over a task-batched solve (jacfwd of jacfwd): one
            # solve per row of the outer axis, each against the spec's
            # state(s) unless the point itself varies along that axis
            fresh = any(d is not None for d in dims[:spec.n_point])
            rows = [_LinearSolve.apply(
                dataclasses.replace(spec, prepared=None, prepared_tasks=None)
                if fresh else spec,
                *[a if d is None else a.select(d, b)
                  for a, d in zip(args, dims)])
                for b in range(info.batch_size)]
            return (tuple(torch.stack(xs) for xs in zip(*rows)),
                    (0,) * len(rows[0]))
        ops = [a if d is None else a.movedim(d, 0)
               for a, d in zip(args, dims)]
        bspec = dataclasses.replace(
            spec, tasks=info.batch_size,
            batched=tuple(d is not None for d in dims))
        out = _LinearSolve.apply(bspec, *ops)
        spec.prepared, spec.prepared_tasks = (bspec.prepared,
                                              bspec.prepared_tasks)
        return out, (0,) * len(out)


def _task_rhs(spec: _SolveSpec) -> _SolveSpec:
    """The spec of a rule's own solve: the same point and state, and a
    right-hand side that carries the task axis wherever the spec has one."""
    if spec.tasks is None:
        return spec
    n = spec.n_point
    return dataclasses.replace(
        spec, batched=spec.batched[:n] + (True,) * (len(spec.batched) - n))


def linear_solve(solver, state, loss_fn, point: list, unpack, live: tuple,
                 w: PyTree, *, prepare=None, tasks=None,
                 batched: tuple = ()) -> list:
    """u = (H + ρI)⁻¹ w through :class:`_LinearSolve` (see
    :class:`_SolveSpec` for the point's layout). Returns u's leaves."""
    leaves, w_def = tree_flatten(w)
    spec = _SolveSpec(solver=solver, state=state, loss_fn=loss_fn,
                      unpack=unpack, n_point=len(point), live=tuple(live),
                      w_def=w_def, prepare=prepare, tasks=tasks,
                      batched=tuple(batched))
    return list(_LinearSolve.apply(spec, *point, *leaves))


def tangent_apply(solver, state, hvp: HVP, w: PyTree) -> PyTree:
    """u = (H + ρI)⁻¹ w as a linear-system solve: the counterpart of the
    reference's ``custom_linear_solve`` (``repro/core/solvers.py:677``).

    Its value is ``solver.apply(state, w)`` bit for bit (ρ is the solver's,
    as in the reference). It differentiates as a linear map of ``w`` whose
    transpose is itself (the system is symmetric): reverse mode applies the
    solver to the cotangent, forward mode to the tangent; under
    ``torch.func.vmap`` the rows of ``w`` go through one ``apply_matrix``
    (:func:`apply_tasks`). ``hvp`` is the system's matvec, H·, at the
    linearization point, an :class:`~repro_torch.core.hvp.HVP` from
    ``make_hvp``: the solve is also differentiated through it, in the
    HVP's ``args`` (its ``params`` are the frozen linearization point), as
    the reference does: du = solve(dw − dH·u), the hyper-Hessian term. The
    state is frozen."""
    p_leaves, p_def = tree_flatten(hvp.params)
    a_leaves, a_def = tree_flatten(hvp.args)
    n = len(p_leaves)

    def unpack(point):
        return (p_def.unflatten(point[:n]), a_def.unflatten(point[n:]), None)

    u = linear_solve(solver, state, hvp.loss_fn, [*p_leaves, *a_leaves],
                     unpack, (False,) * n + (True,) * len(a_leaves), w)
    return tree_flatten(w)[1].unflatten(u)


def build_hvp_bill(solver, params_like: PyTree) -> int:
    """HVPs one prepared-state build costs: the Nyström rank ``k``, or the
    parameter count for the exact solver's column scan."""
    k = getattr(solver, 'k', None)
    if k is not None:
        return int(k)
    return tree_size(params_like)


def state_template(solver, indexer: PyTreeIndexer):
    """The state ``solver.prepare`` would build over ``indexer``'s tree,
    with every leaf present at its shape, dtype and device but unfilled
    (``torch.empty``), and no HVP run: what the reference gets from
    ``jax.eval_shape(build)``. The serving tier's disk tier reads a spill
    into it (``SketchStore.load_entry``'s ``like``).

    The layout follows the solver's backend, by the backend's own
    ``prepare_operand`` and ``mul_right`` run on ``meta`` tensors (a
    leading-k tree for 'tree', the (k, p) buffer for 'flat', (p, k) for
    'cuda'; ``sketch_dtype``), and its apply: ``B``/``gram_B`` for the
    whitened form, ``gram_C`` for Eq. 6 and Alg. 1. Only the template's own
    leaves are allocated: no GEMM and no kernel launch runs. Iterative
    solvers raise (their state is a handle, with no leaves)."""
    dev = indexer.device

    def empty(t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, device=dev)

    if isinstance(solver, ExactIHVP):
        return DenseFactor(H=torch.empty((indexer.total, indexer.total),
                                         device=dev))
    if not isinstance(solver, NystromIHVP):
        raise TypeError(f'{type(solver).__name__} prepares no state of '
                        'tensors: there is nothing to template')
    be = solver._be()
    k = min(solver.k, indexer.total) if indexer.total < 2 ** 31 else solver.k
    C_meta = be.prepare_operand(indexer.treedef.unflatten([
        torch.empty((k,) + shape, dtype=dtype, device='meta')
        for shape, dtype in zip(indexer.shapes, indexer.dtypes)]))
    kk_meta = torch.empty((k, k), device='meta')
    idx = {'leaf': torch.empty((k,), dtype=torch.int32, device=dev),
           'dims': torch.empty((k, indexer.max_rank), dtype=torch.int32,
                               device=dev)}
    whitened = solver.stabilized and not solver._chunked()
    return NystromSketch(
        C=tree_map(empty, C_meta), H_KK=empty(kk_meta), indices=idx,
        rho=float(solver.rho),
        B=(tree_map(empty, be.mul_right(C_meta, kk_meta)) if whitened
           else None),
        gram_B=empty(kk_meta) if whitened else None,
        gram_C=None if whitened else empty(kk_meta))


def state_nbytes(state) -> int:
    """Bytes of a prepared solver state: the tensors it holds (a Nyström
    sketch is dominated by C and B, about 2·k·p·itemsize; a dense factor by
    its p×p Hessian). A Python number (the sketch's ρ record) counts as the
    32-bit scalar the reference stores. An ``IterativeOperator`` holds a
    callable, which has no footprint: it raises."""
    total = 0
    for _, leaf in tree_flatten_with_path(state)[0]:
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
            total += 4
        else:
            raise TypeError(
                f'{type(state).__name__} holds a non-tensor leaf '
                f'({type(leaf).__name__}): only amortizable solver states '
                '(tensors) have a byte footprint; an IterativeOperator '
                'cannot be sized or cached')
    return total


def _backend_tag(backend) -> str:
    """A stable tag for a backend selection (a name or a built one)."""
    if isinstance(backend, str):
        return backend
    tag = getattr(backend, 'name', type(backend).__name__)
    dtype = getattr(backend, 'sketch_dtype', None)
    if dtype is not None:
        tag += f':{str(dtype).removeprefix("torch.")}'
    return tag


def solver_fingerprint(solver) -> str:
    """The identity of the state a solver prepares: equal fingerprints
    prepare interchangeable states from the same point. ``rho`` and
    ``refine`` are left out (sketches are ρ-free; refinement is apply-time).
    Iterative solvers raise: their state is step-local, with no identity to
    cache.

    >>> solver_fingerprint(NystromIHVP(k=8, rho=1e-3)) == \\
    ...     solver_fingerprint(NystromIHVP(k=8, rho=1e-1))
    True
    """
    if not getattr(type(solver), 'amortizable', False):
        raise TypeError(
            f'{type(solver).__name__} prepares a step-local state — it has '
            'no cacheable identity (nothing survives the step to cache)')
    parts = [type(solver).__name__]
    for f in sorted(dataclasses.fields(solver), key=lambda f: f.name):
        if f.name in ('rho', 'refine'):
            continue
        value = getattr(solver, f.name)
        if f.name == 'backend':
            value = _backend_tag(value)
        parts.append(f'{f.name}={value!r}')
    return ';'.join(parts)


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
        return self.solver.prepare(
            hvp, theta_backend(self.solver).indexer(params), rng,
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
                          {'k': 'k', 'rho': 'rho', 'kappa': 'kappa',
                           'column_chunk': 'column_chunk',
                           'importance_sampling': 'importance_sampling',
                           'refine': 'refine', 'stabilized': 'stabilized'},
                          builds_backend=True),
    # the paper reuses k as the baselines' iteration count l
    'cg': SolverSpec(CGIHVP, {'k': 'iters', 'rho': 'rho'}),
    'neumann': SolverSpec(NeumannIHVP, {'k': 'iters', 'alpha': 'alpha'}),
    'exact': SolverSpec(ExactIHVP, {'rho': 'rho'}),
}
