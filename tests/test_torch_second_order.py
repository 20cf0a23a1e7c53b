"""Second-order derivatives through the port's ``implicit_root`` against
the reference's, on the same numpy inputs.

* A non-quadratic toy: inner loss
  ``0.5‖x‖² + 0.025‖x‖₄⁴·Σexp(φ) − (Aφ)·x`` (A from
  ``np.random.RandomState(0)``), outer loss ``‖x − 1‖²``, 200 SGD steps at
  0.2 from zeros, at φ₀ = 0.1·1. ``jacfwd(grad)``, ``jacrev(grad)`` and
  ``hessian`` against ``jax.jacfwd``, ``jax.hessian``, and
  ``jacrev(jacfwd)`` of the map against ``jax.jacfwd(jax.jacfwd)``, for the
  exact solver (ρ = 0) and the full-rank Nyström sketch (k = 4, ρ = 1e-2)
  on the 'tree', 'flat' and 'cuda' backends (the last runs the kernels'
  plain versions here). ``jacfwd(jacfwd)`` of the map raises: PyTorch runs
  a Function's jvp rule with forward-mode AD off. The answer is the AID
  convention's, not the true Hessian: θ* and the solver state are frozen
  in the rules, φ is live in the mixed term and in the solve's system
  matvec.
* The hyper-Hessian term: without the solve's derivative through its
  system matvec (du = solve(dw − dH·u)), the port would miss the reference
  on the toy by far more than the tolerance; the test states by how much.
* The closed form: ``jacfwd(grad)`` on the reference's quadratic bilevel
  (``tests/test_implicit.py``'s ``test_jvp_of_vjp_hyper_hessian``) equals
  (A⁻¹B)ᵀ(A⁻¹B) at ρ = 0.
* Under ``vmap``: k Hessian columns of an upper loss that contains the
  solution map (``extract_columns`` of its HVP — what an upper edge's
  sketch build runs) against the reference's.

Tolerance: 1e-4 relative L2 (an IHVP and second derivatives of the inner
gradient in f32, summed in another order than XLA); the closed form at the
reference's own 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd, jacrev

from repro.core.hvp import extract_columns as jextract_columns
from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.implicit import implicit_root as jimplicit_root
from repro.core.implicit import sgd_solver as jsgd_solver
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro_torch.core import (HypergradConfig, PyTreeIndexer,
                              extract_columns, implicit_root, make_hvp,
                              sgd_solver)
from repro_torch.core import solvers as port_solvers
from repro_torch.core.tree_util import tree_leaves
from torch_threads import torch_thread_cap  # noqa: F401

A_NP = np.random.RandomState(0).randn(4, 4).astype(np.float32)
PHI0 = np.full(4, 0.1, np.float32)
CONFIGS = {
    'exact': dict(solver='exact', rho=0.0),
    'nystrom-tree': dict(solver='nystrom', k=4, rho=1e-2, backend='tree'),
    'nystrom-flat': dict(solver='nystrom', k=4, rho=1e-2, backend='flat'),
    'nystrom-cuda': dict(solver='nystrom', k=4, rho=1e-2, backend='cuda'),
}
KINDS = ('jacfwd_grad', 'jacrev_grad', 'hessian', 'jacrev_jacfwd_map')
TOL = 1e-4


def _jconfig(fields):
    return JConfig(**{k: ('flat' if v == 'cuda' else v)
                      for k, v in fields.items()})


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --------------------------------------------------------------- the toy
def _jtoy(fields):
    A = jnp.asarray(A_NP)

    def inner(x, phi, b):
        return (0.5 * jnp.sum(x ** 2)
                + 0.025 * jnp.sum(x ** 4) * jnp.sum(jnp.exp(phi))
                - (A @ phi) @ x)
    solve = jimplicit_root(
        jsgd_solver(inner, 200, 0.2, init=lambda p, b: jnp.zeros(4)), inner,
        _jconfig(fields))
    return solve, lambda p: jnp.sum((solve(p, None) - 1.0) ** 2)


def _toy(fields):
    A = torch.from_numpy(A_NP)

    def inner(x, phi, b):
        return (0.5 * torch.sum(x ** 2)
                + 0.025 * torch.sum(x ** 4) * torch.sum(torch.exp(phi))
                - (A @ phi) @ x)
    solve = implicit_root(
        sgd_solver(inner, 200, 0.2, init=lambda p, b: torch.zeros(4)), inner,
        HypergradConfig(**fields))
    return solve, lambda p: torch.sum((solve(p, None) - 1.0) ** 2)


_REFERENCE: dict = {}


def _reference(name: str) -> dict:
    """The reference's four derivatives on the toy (jitted, once a config)."""
    if name not in _REFERENCE:
        solve, f = _jtoy(CONFIGS[name])
        phi = jnp.asarray(PHI0)
        _REFERENCE[name] = {
            'jacfwd_grad': jax.jit(jax.jacfwd(jax.grad(f)))(phi),
            'jacrev_grad': jax.jit(jax.jacrev(jax.grad(f)))(phi),
            'hessian': jax.jit(jax.hessian(f))(phi),
            'jacrev_jacfwd_map': jax.jit(jax.jacfwd(jax.jacfwd(
                lambda p: solve(p, None))))(phi)}
    return _REFERENCE[name]


def _port(kind: str, fields) -> torch.Tensor:
    solve, f = _toy(fields)
    phi = torch.from_numpy(PHI0)
    if kind == 'jacfwd_grad':
        return jacfwd(grad(f))(phi)
    if kind == 'jacrev_grad':
        return jacrev(grad(f))(phi)
    if kind == 'hessian':
        return torch.autograd.functional.hessian(f, phi)
    return jacrev(jacfwd(lambda p: solve(p, None)))(phi)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('name', list(CONFIGS))
def test_toy_second_order_matches_the_reference(name, kind):
    got = _port(kind, CONFIGS[name])
    want = _reference(name)[kind]
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


def test_forward_over_forward_refuses_instead_of_answering_zero():
    """PyTorch runs a Function's jvp rule with forward-mode AD off, so
    ``jacfwd(jacfwd(map))`` would see a zero second derivative: it raises,
    and ``jacrev(jacfwd(map))`` (above) gives the reference's
    ``jax.jacfwd(jax.jacfwd(map))``."""
    solve, _ = _toy(CONFIGS['exact'])
    with pytest.raises(NotImplementedError, match='jacfwd of jacfwd'):
        jacfwd(jacfwd(lambda p: solve(p, None)))(torch.from_numpy(PHI0))


def test_torch_func_hessian_matches_the_reference():
    """``torch.func.hessian`` (jacfwd over jacrev) as well as
    ``torch.autograd.functional.hessian`` (double backward)."""
    _, f = _toy(CONFIGS['exact'])
    got = hessian(f)(torch.from_numpy(PHI0))
    assert _rel(got, _reference('exact')['hessian']) < TOL


def test_without_the_hyper_hessian_term_the_port_would_miss(monkeypatch):
    """The solve's derivative through its system matvec carries the
    reference's answer: with it the port matches to 1.0e-7; dropping it (no
    live point in the solve's rules, the solve differentiated at a frozen
    system) moves jacfwd(grad) on the toy 1.9e-2 relative from the
    reference (measured), gated here at over a hundred times the 1e-4
    tolerance."""
    want = _reference('exact')['jacfwd_grad']
    assert _rel(_port('jacfwd_grad', CONFIGS['exact']), want) < TOL
    monkeypatch.setattr(port_solvers._SolveSpec, 'live_at',
                        lambda self, point, dots: [])
    frozen = _rel(_port('jacfwd_grad', CONFIGS['exact']), want)
    assert frozen > 100 * TOL


# ------------------------------------------------- the closed form (ρ = 0)
def _quadratic_bilevel(seed=0, P=12, Hdim=5):
    """The reference's ``tests/test_implicit.py`` fixture, as numpy."""
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    Am = jax.random.normal(k1, (P, P))
    Am = Am @ Am.T / P + jnp.eye(P)
    return tuple(np.asarray(x) for x in (
        Am, jax.random.normal(k2, (P, Hdim)), jax.random.normal(k3, (P,)),
        jax.random.normal(k4, (P,))))


def test_jvp_of_vjp_hyper_hessian_closed_form():
    Am, Bm, c, t = _quadratic_bilevel()
    Aj, Bj, cj, tj = (jnp.asarray(x) for x in (Am, Bm, c, t))
    A, B, C, T = (torch.tensor(x) for x in (Am, Bm, c, t))

    def jinner(prm, hp, batch):
        th = prm['theta']
        return 0.5 * th @ Aj @ th - th @ (Bj @ hp['phi'] + cj)

    def inner(prm, hp, batch):
        th = prm['theta']
        return 0.5 * th @ A @ th - th @ (B @ hp['phi'] + C)

    jsolve = jimplicit_root(
        lambda hp, b: {'theta': jnp.linalg.solve(Aj, Bj @ hp['phi'] + cj)},
        jinner, JConfig(solver='exact', rho=0.0))
    solve = implicit_root(
        lambda hp, b: {'theta': torch.linalg.solve(A, B @ hp['phi'] + C)},
        inner, HypergradConfig(solver='exact', rho=0.0))
    want = jax.jacfwd(jax.grad(lambda hp: 0.5 * jnp.sum(
        (jsolve(hp, None)['theta'] - tj) ** 2)))(
        {'phi': jnp.ones(5)})['phi']['phi']
    got = jacfwd(grad(lambda hp: 0.5 * torch.sum(
        (solve(hp, None)['theta'] - T) ** 2)))(
        {'phi': torch.ones(5)})['phi']['phi']
    S = np.linalg.solve(Am.astype(np.float64), Bm.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), S.T @ S, rtol=2e-3, atol=2e-3)
    assert _rel(got, want) < TOL


# ---------------------------------------------- k columns through the map
@pytest.mark.parametrize('name', ['exact', 'nystrom-flat'])
def test_sketch_columns_through_a_lower_map(name):
    """An upper edge's build: ``extract_columns`` vmaps the HVP of a loss
    that contains the solution map over k one-hot tangents, each HVP a jvp
    of a grad through the map's rules."""
    jsolve, _ = _jtoy(CONFIGS[name])
    solve, _ = _toy(CONFIGS[name])

    def jupper(phi, b):
        return jnp.sum((jsolve(phi, None) - 1.0) ** 2) + 0.5 * jnp.sum(
            phi ** 2)

    def upper(phi, b):
        return torch.sum((solve(phi, None) - 1.0) ** 2) + 0.5 * torch.sum(
            phi ** 2)

    idx = {'leaf': np.zeros(3, np.int32),
           'dims': np.array([[0], [2], [3]], np.int32)}
    want = jextract_columns(jmake_hvp(jupper, jnp.asarray(PHI0), None),
                            JIndexer(jnp.asarray(PHI0)), idx)
    phi = torch.from_numpy(PHI0)
    got = extract_columns(make_hvp(upper, phi, None), PyTreeIndexer(phi),
                          PyTreeIndexer(phi).check(idx))
    assert got.shape == (3, 4)
    assert _rel(got, want) < TOL
    # the columns are those of the full jacfwd(grad) of the upper loss
    full = jacfwd(grad(lambda p: upper(p, None)))(phi)
    assert _rel(got, full[:, [0, 2, 3]].T) < TOL


def test_rules_leave_tangents_in_the_primal_dtype():
    """PyTorch's forward-mode formula of a Python-scalar product widens the
    toy's mixed-term tangent to f64; the rules hand the solve (and so the
    kernels, which refuse f64) f32 right-hand sides."""
    seen = []
    apply = port_solvers.NystromIHVP.apply

    def spy(self, state, v):
        seen.extend(x.dtype for x in tree_leaves(v))
        return apply(self, state, v)
    port_solvers.NystromIHVP.apply = spy
    try:
        _port('jacfwd_grad', CONFIGS['nystrom-cuda'])
    finally:
        port_solvers.NystromIHVP.apply = apply
    assert seen and set(seen) == {torch.float32}
