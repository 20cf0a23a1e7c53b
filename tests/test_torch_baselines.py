"""The iterative baselines (CG, Neumann), their plumbing, and the unrolled
oracle, against the reference.

Tolerances:

* parity with the reference's CG and Neumann applies (vector and m = 3
  block) on the same quadratic, and of ``unrolled_hypergradient``: rtol
  1e-4 with atol 1e-4·‖ref‖∞;
* CG to convergence against the f64 truth: rtol = atol = 1e-3, the
  reference's ``test_cg_converges``; Neumann on a benign spectrum
  (eigenvalues in [0.5, 1.5]): 1e-3, its ``test_neumann_converges``; the
  divergence past α‖H‖ > 2 as the reference asserts it (a non-finite
  entry or one above 1e6);
* CG and Neumann hypergradients against the unrolled oracle (800 SGD steps)
  on a quadratic bilevel problem: 1e-3, the reference's
  ``test_unrolled_matches_analytic``;
* ``state_nbytes``, ``solver_fingerprint``, the config's strictness and
  ``config_from_cli``: equal to the reference's (integers and strings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvers as jsolvers
from repro.core.backend import FlatBackend as JFlat
from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.hypergrad import config_from_cli as jconfig_from_cli
from repro.core.hypergrad import hypergradient as jhypergradient
from repro.core.hypergrad import unrolled_hypergradient as junrolled
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro_torch.convert import to_torch
from repro_torch.core.backend import FlatBackend, flatten_vec
from repro_torch.core.hvp import make_hvp
from repro_torch.core.hypergrad import (HypergradConfig, config_from_cli,
                                        hypergradient, unrolled_hypergradient)
from repro_torch.core.solvers import (CGIHVP, ExactIHVP, IterativeOperator,
                                      NeumannIHVP, NystromIHVP,
                                      solver_fingerprint, state_nbytes)
from repro_torch.core.tree_util import PyTreeIndexer, tree_leaves
from torch_threads import torch_thread_cap  # noqa: F401

SHAPES = {'w': (4, 3), 'b': (3,)}
P = 15
PARAMS = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}


def _psd(seed, shift=0.5):
    A = np.random.RandomState(seed).randn(P, 8).astype(np.float32)
    return (A @ A.T + shift * np.eye(P)).astype(np.float32)


def _benign(seed):
    """Eigenvalues evenly in [0.5, 1.5]: ‖I − αH‖ < 1 for α ≤ 1."""
    Q, _ = np.linalg.qr(np.random.RandomState(seed).randn(P, P))
    return ((Q * np.linspace(0.5, 1.5, P)) @ Q.T).astype(np.float32)


def _losses(Hm):
    def jloss(theta, phi, batch):
        x = jnp.concatenate([t.ravel() for t in jax.tree.leaves(theta)])
        return 0.5 * x @ jnp.asarray(Hm) @ x

    def tloss(theta, phi, batch):
        x = flatten_vec(theta)
        return 0.5 * x @ torch.tensor(Hm) @ x

    return jloss, tloss


def _vec(seed, trail=()):
    r = np.random.RandomState(seed)
    return {k: r.randn(*s, *trail).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(tree):
    leaves = tree_leaves(tree)
    if not isinstance(leaves[0], torch.Tensor):
        leaves = jax.tree.leaves(tree)
    return np.concatenate([np.ravel(np.asarray(x)) for x in leaves])


def _close(got, want, rtol=1e-4):
    a, b = _flat(got), _flat(want)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def _both(Hm, jsolver, tsolver, v, matrix=False):
    jloss, tloss = _losses(Hm)
    jparams = jax.tree.map(jnp.asarray, PARAMS)
    tparams = to_torch(PARAMS)
    jst = jsolver.prepare(jmake_hvp(jloss, jparams, None, None),
                          JIndexer(jparams))
    tst = tsolver.prepare(make_hvp(tloss, tparams, None, None),
                          PyTreeIndexer(tparams))
    if matrix:
        return (tsolver.apply_matrix(tst, to_torch(v)),
                jsolver.apply_matrix(jst, jax.tree.map(jnp.asarray, v)))
    return (tsolver.apply(tst, to_torch(v)),
            jsolver.apply(jst, jax.tree.map(jnp.asarray, v)))


@pytest.mark.parametrize('iters', [3, 10])
@pytest.mark.parametrize('rho', [0.0, 1e-2])
@pytest.mark.parametrize('matrix', [False, True], ids=['vector', 'block'])
def test_cg_matches_reference(iters, rho, matrix):
    got, want = _both(_psd(0), jsolvers.CGIHVP(iters=iters, rho=rho),
                      CGIHVP(iters=iters, rho=rho),
                      _vec(1, trail=(3,) if matrix else ()), matrix)
    _close(got, want)


@pytest.mark.parametrize('iters', [5, 20])
@pytest.mark.parametrize('matrix', [False, True], ids=['vector', 'block'])
def test_neumann_matches_reference(iters, matrix):
    got, want = _both(_psd(2), jsolvers.NeumannIHVP(iters=iters, alpha=0.02),
                      NeumannIHVP(iters=iters, alpha=0.02),
                      _vec(3, trail=(3,) if matrix else ()), matrix)
    _close(got, want)


def _truth(Hm, rho, v):
    return np.linalg.solve(Hm.astype(np.float64) + rho * np.eye(P),
                           _flat(to_torch(v)).astype(np.float64))


def _port_solve(Hm, solver, v):
    _, tloss = _losses(Hm)
    tparams = to_torch(PARAMS)
    return solver.solve(make_hvp(tloss, tparams, None, None),
                        PyTreeIndexer(tparams), to_torch(v))


def test_cg_converges_to_the_truth():
    Hm, v = _psd(15), _vec(16)
    u = _port_solve(Hm, CGIHVP(iters=4 * P, rho=1e-2), v)
    np.testing.assert_allclose(_flat(u), _truth(Hm, 1e-2, v), rtol=1e-3,
                               atol=1e-3)


def test_neumann_converges_on_a_benign_spectrum():
    Hm, v = _benign(16), _vec(17)
    u = _port_solve(Hm, NeumannIHVP(iters=200, alpha=0.5), v)
    np.testing.assert_allclose(_flat(u), _truth(Hm, 0.0, v), rtol=1e-3,
                               atol=1e-3)


def test_neumann_diverges_past_its_norm_bound():
    Hm = _psd(18)
    assert np.linalg.eigvalsh(Hm).max() > 2.0        # α‖H‖ > 2 at α = 1
    u = _flat(_port_solve(Hm, NeumannIHVP(iters=100, alpha=1.0), _vec(19)))
    assert (~np.isfinite(u)).any() or np.abs(u).max() > 1e6


@pytest.mark.parametrize('solver', [CGIHVP(iters=6, rho=1e-2),
                                    NeumannIHVP(iters=6, alpha=0.02)],
                         ids=['cg', 'neumann'])
def test_width_one_block_is_bitwise_the_vector_path(solver):
    V = _vec(20, trail=(1,))
    _, tloss = _losses(_psd(21))
    tparams = to_torch(PARAMS)
    st = solver.prepare(make_hvp(tloss, tparams, None, None))
    U = solver.apply_matrix(st, to_torch(V))
    u = solver.apply(st, to_torch({k: x[..., 0] for k, x in V.items()}))
    for a, b in zip(tree_leaves(U), tree_leaves(u)):
        assert torch.equal(a[..., 0], b)


# --------------------------------------------------------------- plumbing
def _nystrom_states(**kw):
    Hm = _psd(4)
    jloss, tloss = _losses(Hm)
    jparams = jax.tree.map(jnp.asarray, PARAMS)
    tparams = to_torch(PARAMS)
    key = jax.random.PRNGKey(5)
    js = jsolvers.NystromIHVP(k=6, backend='flat', **kw)
    jst = js.prepare(jmake_hvp(jloss, jparams, None, None), JIndexer(jparams),
                     key)
    draw = jax.tree.map(np.asarray, JIndexer(jparams).sample_indices(key, 6))
    tst = NystromIHVP(k=6, backend='flat', **kw).prepare(
        make_hvp(tloss, tparams, None, None), PyTreeIndexer(tparams), None,
        indices=draw)
    return tst, jst


@pytest.mark.parametrize('kw', [{}, {'kappa': 2}, {'stabilized': False}],
                         ids=['whitened', 'chunked', 'eq6'])
def test_state_nbytes_matches_reference(kw):
    tst, jst = _nystrom_states(**kw)
    assert state_nbytes(tst) == jsolvers.state_nbytes(jst) > 6 * P * 4


def test_state_nbytes_of_the_dense_factor_and_the_iterative_handle():
    _, tloss = _losses(_psd(6))
    tparams = to_torch(PARAMS)
    hvp = make_hvp(tloss, tparams, None, None)
    assert state_nbytes(ExactIHVP().prepare(hvp, PyTreeIndexer(tparams))) \
        == P * P * 4
    with pytest.raises(TypeError, match='IterativeOperator'):
        state_nbytes(CGIHVP().prepare(hvp))
    assert isinstance(NeumannIHVP().prepare(hvp), IterativeOperator)


FINGERPRINTED = [
    ({'k': 8, 'rho': 1e-3}, {}),
    ({'k': 8, 'rho': 1e-1, 'refine': 3}, {}),
    ({'k': 16, 'kappa': 4, 'backend': 'flat'}, {}),
    ({'k': 8, 'importance_sampling': True, 'stabilized': False}, {}),
    ({'k': 8}, {'sketch_dtype': 'bfloat16'}),
]


@pytest.mark.parametrize('kw,be', FINGERPRINTED)
def test_solver_fingerprint_matches_reference(kw, be):
    if be:
        want = jsolvers.solver_fingerprint(jsolvers.NystromIHVP(
            **kw, backend=JFlat(sketch_dtype=jnp.bfloat16)))
        got = solver_fingerprint(NystromIHVP(
            **kw, backend=FlatBackend(sketch_dtype=torch.bfloat16)))
        assert "backend='flat:bfloat16'" in got
    else:
        want = jsolvers.solver_fingerprint(jsolvers.NystromIHVP(**kw))
        got = solver_fingerprint(NystromIHVP(**kw))
    assert got == want
    assert solver_fingerprint(ExactIHVP(rho=0.1)) == \
        jsolvers.solver_fingerprint(jsolvers.ExactIHVP(rho=0.2))
    for solver in (CGIHVP(), NeumannIHVP()):
        with pytest.raises(TypeError, match='step-local'):
            solver_fingerprint(solver)


CONFIGS = [
    dict(solver='cg', k=7, rho=0.0),
    dict(solver='neumann', k=9, alpha=0.05),
    dict(solver='nystrom', k=10, kappa=5, importance_sampling=True),
    dict(solver='cg', alpha=0.5),
    dict(solver='neumann', rho=0.5),
    dict(solver='cg', kappa=3),
    dict(solver='neumann', backend='flat'),
    dict(solver='exact', alpha=0.1),
]


def _outcome(cfg):
    try:
        solver = cfg.build()
    except ValueError as e:
        return 'ValueError', str(e)
    return type(solver).__name__, {
        f.name: getattr(solver, f.name) for f in dataclasses.fields(solver)
        if f.name != 'backend'}


@pytest.mark.parametrize('fields', CONFIGS,
                         ids=[f"{c['solver']}-{'-'.join(sorted(c)[:-1])}"
                              for c in CONFIGS])
def test_config_builds_and_refuses_as_the_reference(fields):
    assert _outcome(HypergradConfig(**fields)) == _outcome(JConfig(**fields))


CLI = [
    ('nystrom', {'backend': 'flat', 'kappa': None}, {'kappa': 4}, {}),
    ('cg', {'k': 12, 'rho': None}, {'rho': 0.0, 'alpha': 0.3}, {}),
    ('cg', {'backend': 'flat'}, {}, {}),
    ('neumann', {'alpha': 0.1, 'rho': 0.5}, {}, {}),
    ('neumann', {'k': None}, {'k': 20}, {'column_chunk': 4}),
    ('nystrom', {'k': 8}, {}, {'column_chunk': 4}),
    ('lbfgs', {}, {}, {}),
]


def _cli_outcome(fn, args):
    solver, flags, defaults, extras = args
    try:
        cfg = fn(solver, flags, defaults, **extras)
    except ValueError as e:
        return 'ValueError', str(e)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ('mesh', 'param_specs')}


@pytest.mark.parametrize('args', CLI, ids=[f'{a[0]}-{i}'
                                           for i, a in enumerate(CLI)])
def test_config_from_cli_matches_reference(args):
    assert _cli_outcome(config_from_cli, args) == \
        _cli_outcome(jconfig_from_cli, args)


# ------------------------------------------------------ the unrolled oracle
def _quadratic_bilevel(seed=0, p=12, h=5):
    r = np.random.RandomState(seed)
    Am = r.randn(p, p).astype(np.float32)
    Am = (Am @ Am.T / p + np.eye(p)).astype(np.float32)
    Bm = r.randn(p, h).astype(np.float32)
    c = r.randn(p).astype(np.float32)
    t = r.randn(p).astype(np.float32)
    phi0 = np.ones(h, np.float32)
    theta_star = np.linalg.solve(Am, Bm @ phi0 + c).astype(np.float32)

    def make(xp, asarr):
        A, B, cc, tt = (asarr(x) for x in (Am, Bm, c, t))

        def inner(prm, hp, batch):
            th = prm['theta']
            return 0.5 * th @ A @ th - th @ (B @ hp['phi'] + cc)

        def outer(prm, hp, batch):
            return 0.5 * xp.sum((prm['theta'] - tt) ** 2)

        return inner, outer

    return make, {'theta': theta_star}, {'phi': phi0}


def test_unrolled_hypergradient_matches_reference():
    make, params, hparams = _quadratic_bilevel()
    jin, jout = make(jnp, jnp.asarray)
    tin, tout = make(torch, torch.tensor)
    start = {'theta': np.zeros_like(params['theta'])}
    want = junrolled(jin, jout, jax.tree.map(jnp.asarray, start),
                     jax.tree.map(jnp.asarray, hparams), None, None,
                     steps=50, lr=0.05)
    got = unrolled_hypergradient(tin, tout, to_torch(start),
                                 to_torch(hparams), None, None, steps=50,
                                 lr=0.05)
    _close(got, want)


@pytest.mark.parametrize('solver', [CGIHVP(iters=48, rho=0.0),
                                    NeumannIHVP(iters=300, alpha=0.1)],
                         ids=['cg', 'neumann'])
def test_baseline_hypergradients_match_the_unrolled_oracle(solver):
    make, params, hparams = _quadratic_bilevel()
    tin, tout = make(torch, torch.tensor)
    oracle = unrolled_hypergradient(tin, tout, to_torch(params),
                                    to_torch(hparams), None, None,
                                    steps=800, lr=0.05)
    got = hypergradient(tin, tout, to_torch(params), to_torch(hparams), None,
                        None, solver)
    np.testing.assert_allclose(got['phi'].numpy(), oracle['phi'].numpy(),
                               rtol=1e-3, atol=1e-3)
    jin, jout = make(jnp, jnp.asarray)
    jsolver = (jsolvers.CGIHVP(iters=48, rho=0.0)
               if isinstance(solver, CGIHVP)
               else jsolvers.NeumannIHVP(iters=300, alpha=0.1))
    want = jhypergradient(jin, jout, jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, hparams), None, None,
                          jsolver, jax.random.PRNGKey(0))
    _close(got, want)
