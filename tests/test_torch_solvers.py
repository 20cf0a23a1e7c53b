"""Parity of the port's Nyström solver with the reference's.

Both packages sketch the same quadratic at the reference's own column draw
and apply the whitened form (with refinement), literal Eq. 6 and the
m-query ``apply_matrix``. Tolerance: rtol 1e-4 with atol 1e-4·‖ref‖∞ —
each apply solves a k×k system that multiplies the f32 roundoff of the
contractions by its condition number. Against dense truth the reference's
own tolerance (5e-3) is kept.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.solvers import NystromIHVP as JNystrom
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro_torch.convert import to_torch
from repro_torch.core.backend import (CudaBackend, flatten_vec, flatten_vecm,
                                      get_backend)
from repro_torch.core.hvp import make_hvp
from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.solvers import (ExactIHVP, NystromIHVP, SketchPolicy,
                                      query_width)
from repro_torch.core.tree_util import PyTreeIndexer, tree_leaves

SHAPES = {'w': (4, 3), 'b': (3,)}
P = 15
RNG = np.random.RandomState(0)
A = RNG.randn(P, 8).astype(np.float32)
H = (A @ A.T + 0.5 * np.eye(P)).astype(np.float32)
PARAMS = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}


def _jflat(t):
    return jnp.concatenate([x.ravel() for x in jax.tree.leaves(t)])


def _jloss(theta, phi, batch):
    x = _jflat(theta)
    return 0.5 * x @ jnp.asarray(H) @ x


def _tloss(theta, phi, batch):
    x = flatten_vec(theta)
    return 0.5 * x @ torch.tensor(H) @ x


def _vec(seed, trail=()):
    r = np.random.RandomState(seed)
    return {k: r.randn(*s, *trail).astype(np.float32)
            for k, s in SHAPES.items()}


def _draw(k, seed=1):
    jix = JIndexer(jax.tree.map(jnp.asarray, PARAMS))
    return jax.tree.map(np.asarray, jix.sample_indices(
        jax.random.PRNGKey(seed), k))


def _ref(stabilized, v, k=6, rho=0.1, matrix=False, seed=1):
    jparams = jax.tree.map(jnp.asarray, PARAMS)
    solver = JNystrom(k=k, rho=rho, stabilized=stabilized, backend='flat')
    sk = solver.prepare(jmake_hvp(_jloss, jparams, None, None),
                        JIndexer(jparams), jax.random.PRNGKey(seed))
    fn = solver.apply_matrix if matrix else solver.apply
    return fn(sk, jax.tree.map(jnp.asarray, v))


def _port(backend, stabilized, v, k=6, rho=0.1, matrix=False, seed=1):
    tparams = to_torch(PARAMS)
    solver = NystromIHVP(k=k, rho=rho, stabilized=stabilized, backend=backend)
    sk = solver.prepare(make_hvp(_tloss, tparams, None, None),
                        PyTreeIndexer(tparams), None, indices=_draw(k, seed))
    fn = solver.apply_matrix if matrix else solver.apply
    return fn(sk, to_torch(v))


def _close(got, want, rtol=1e-4):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                   atol=rtol * np.abs(b).max())


BACKENDS = {'tree': lambda: 'tree', 'flat': lambda: 'flat',
            'cuda': lambda: CudaBackend()}


@pytest.mark.parametrize('backend', list(BACKENDS))
@pytest.mark.parametrize('stabilized', [True, False])
def test_apply_matches_reference(backend, stabilized):
    v = _vec(2)
    _close(_port(BACKENDS[backend](), stabilized, v), _ref(stabilized, v))


@pytest.mark.parametrize('backend', list(BACKENDS))
@pytest.mark.parametrize('stabilized', [True, False])
def test_apply_matrix_matches_reference(backend, stabilized):
    V = _vec(3, trail=(4,))
    _close(_port(BACKENDS[backend](), stabilized, V, matrix=True),
           _ref(stabilized, V, matrix=True))


@pytest.mark.parametrize('backend', list(BACKENDS))
def test_width_one_block_is_bitwise_the_vector_path(backend):
    V = _vec(4, trail=(1,))
    v = {k: x[..., 0] for k, x in V.items()}
    U = _port(BACKENDS[backend](), True, V, matrix=True)
    u = _port(BACKENDS[backend](), True, v)
    for a, b in zip(tree_leaves(U), tree_leaves(u)):
        assert torch.equal(a[..., 0], b)


def _truth(rho, v):
    return np.linalg.solve(H.astype(np.float64) + rho * np.eye(P),
                           flatten_vec(to_torch(v)).double().numpy())


@pytest.mark.parametrize('backend', list(BACKENDS))
def test_full_rank_sketch_is_exact(backend):
    v = _vec(5)
    u = _port(BACKENDS[backend](), True, v, k=P, rho=1e-2)
    np.testing.assert_allclose(flatten_vec(u).numpy(), _truth(1e-2, v),
                               rtol=5e-3, atol=5e-3)


def test_sketch_retargets_across_rho():
    """One ρ-free sketch applied under three damping values matches each
    value's dense truth."""
    tparams = to_torch(PARAMS)
    sk = NystromIHVP(k=P, rho=1e-2, backend='flat').prepare(
        make_hvp(_tloss, tparams, None, None), PyTreeIndexer(tparams),
        torch.Generator().manual_seed(24))
    v = _vec(6)
    for rho in (1e-2, 1e-1, 1.0):
        u = NystromIHVP(k=P, rho=rho, backend='flat').apply(sk, to_torch(v))
        np.testing.assert_allclose(flatten_vec(u).numpy(), _truth(rho, v),
                                   rtol=5e-3, atol=5e-3, err_msg=f'rho={rho}')


def test_exact_solver_and_its_block_form():
    tparams = to_torch(PARAMS)
    ex = ExactIHVP(rho=0.1)
    st = ex.prepare(make_hvp(_tloss, tparams, None, None),
                    PyTreeIndexer(tparams))
    np.testing.assert_allclose(st.H.numpy(), H, rtol=1e-5, atol=1e-5)
    V = _vec(7, trail=(3,))
    U = flatten_vecm(ex.apply_matrix(st, to_torch(V))).double().numpy()
    want = np.linalg.solve(H.astype(np.float64) + 0.1 * np.eye(P),
                           flatten_vecm(to_torch(V)).double().numpy())
    np.testing.assert_allclose(U, want, rtol=1e-4, atol=1e-4)


def test_query_width_rejects_mixed_blocks():
    with pytest.raises(ValueError, match='inconsistent'):
        query_width({'a': torch.ones(2, 3), 'b': torch.ones(4)})


def test_sketch_policy_cadence_and_invalidate():
    tparams = to_torch(PARAMS)
    policy = SketchPolicy(NystromIHVP(k=3, backend='flat'), _tloss,
                          refresh_every=2)
    st = policy.init_state()
    built = []
    for _ in range(4):
        st, rebuilt = policy.refresh(st, tparams, None, None,
                                     torch.Generator().manual_seed(0))
        built.append(rebuilt)
    assert built == [True, False, True, False]
    assert policy.due(policy.invalidate(st))

    @dataclasses.dataclass(frozen=True)
    class Iterative:
        amortizable = False

    with pytest.raises(TypeError, match='nothing to amortize'):
        SketchPolicy(Iterative(), _tloss)


def test_config_build_is_strict():
    assert HypergradConfig(k=4, backend='flat').build().k == 4
    with pytest.raises(ValueError, match='not consumed'):
        HypergradConfig(solver='exact', k=5).build()
    with pytest.raises(ValueError, match='pre-built instance'):
        HypergradConfig(backend=get_backend('flat'),
                        sketch_dtype='bfloat16').build()
    with pytest.raises(ValueError, match='no effect'):
        HypergradConfig(sketch_dtype='bfloat16').build()
    with pytest.raises(ValueError, match='unknown solver'):
        HypergradConfig(solver='cg').build()
