"""Alg. 1, the chunked apply, and the dense Nyström oracle, against the
reference.

Both packages sketch the same quadratic (p = 15) at the reference's own
column draw. Tolerances:

* parity with the reference's chunked apply on identical draws, for
  κ ∈ {1, 2, 3, 5}, refine ∈ {0, 2}, vector and m = 4 block forms, on the
  'tree', 'flat' and 'cuda' backends (the kernels' plain versions on the
  CPU): rtol 1e-4 with atol 1e-4·‖ref‖∞, as ``test_torch_solvers.py``;
* κ-equivalence with the whitened and the literal Eq. 6 applies on the same
  sketch: 2e-3 of ‖ref‖∞, the reference's ``test_kappa_equivalence``;
* refinement on the chunked path: the reference's
  ``test_kappa_honors_refine`` bounds (a tenfold drop, under 1e-5);
* ``nystrom_inverse_dense`` against the reference's own output on its own
  column draw (fixed seeds, rank-20 H of size 40): rtol 1e-4 with atol
  1e-4·‖ref‖∞; in f64, for a full-rank H and k = p, against the dense
  inverse (1e-8: the 1e-8 jitter on the k×k system is all that differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.solvers import NystromIHVP as JNystrom
from repro.core.solvers import nystrom_inverse_dense as jdense
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro_torch.convert import to_torch
from repro_torch.core.backend import CudaBackend, flatten_vec, get_backend
from repro_torch.core.hvp import make_hvp
from repro_torch.core.solvers import NystromIHVP, nystrom_inverse_dense
from repro_torch.core.tree_util import PyTreeIndexer, tree_leaves
from torch_threads import torch_thread_cap  # noqa: F401

SHAPES = {'w': (4, 3), 'b': (3,)}
P = 15
K = 12
_R = np.random.RandomState(0)
_A = _R.randn(P, 8).astype(np.float32)
H = (_A @ _A.T + 0.5 * np.eye(P)).astype(np.float32)
PARAMS = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
BACKENDS = {'tree': lambda: 'tree', 'flat': lambda: 'flat',
            'cuda': lambda: CudaBackend()}


def _jloss(theta, phi, batch):
    x = jnp.concatenate([t.ravel() for t in jax.tree.leaves(theta)])
    return 0.5 * x @ jnp.asarray(H) @ x


def _tloss(theta, phi, batch):
    x = flatten_vec(theta)
    return 0.5 * x @ torch.tensor(H) @ x


def _vec(seed, trail=()):
    r = np.random.RandomState(seed)
    return {k: r.randn(*s, *trail).astype(np.float32)
            for k, s in SHAPES.items()}


def _ref(v, matrix=False, seed=1, **kw):
    jparams = jax.tree.map(jnp.asarray, PARAMS)
    solver = JNystrom(k=K, backend='flat', **kw)
    sk = solver.prepare(jmake_hvp(_jloss, jparams, None, None),
                        JIndexer(jparams), jax.random.PRNGKey(seed))
    fn = solver.apply_matrix if matrix else solver.apply
    return fn(sk, jax.tree.map(jnp.asarray, v))


def _draw(seed=1):
    jix = JIndexer(jax.tree.map(jnp.asarray, PARAMS))
    return jax.tree.map(np.asarray, jix.sample_indices(
        jax.random.PRNGKey(seed), K))


def _sketch(solver, seed=1):
    tparams = to_torch(PARAMS)
    return solver.prepare(make_hvp(_tloss, tparams, None, None),
                          PyTreeIndexer(tparams), None, indices=_draw(seed))


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x))
                           for x in (tree_leaves(tree)
                                     if isinstance(tree_leaves(tree)[0],
                                                   torch.Tensor)
                                     else jax.tree.leaves(tree))])


def _close(got, want, rtol=1e-4):
    a, b = _flat(got), _flat(want)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize('backend', list(BACKENDS))
@pytest.mark.parametrize('kappa', [1, 2, 3, 5])
@pytest.mark.parametrize('refine', [0, 2])
@pytest.mark.parametrize('matrix', [False, True], ids=['vector', 'block'])
def test_chunked_apply_matches_reference(backend, kappa, refine, matrix):
    v = _vec(3, trail=(4,) if matrix else ())
    want = _ref(v, matrix, rho=0.1, kappa=kappa, refine=refine)
    solver = NystromIHVP(k=K, rho=0.1, kappa=kappa, refine=refine,
                         backend=BACKENDS[backend]())
    sk = _sketch(solver)
    fn = solver.apply_matrix if matrix else solver.apply
    _close(fn(sk, to_torch(v)), want)


@pytest.mark.parametrize('backend', list(BACKENDS))
@pytest.mark.parametrize('kappa', [1, 2, 3, 5])
def test_kappa_equivalence_with_whitened_and_eq6(backend, kappa):
    """Alg. 1 gives the same inverse for every κ: held against the whitened
    apply and the literal Eq. 6 on one sketch (built whitened, so both
    applies read it; Eq. 6 computes its gram on the fly)."""
    be = BACKENDS[backend]()
    sk = _sketch(NystromIHVP(k=K, rho=0.1, backend=be))
    v = to_torch(_vec(4))
    out = _flat(NystromIHVP(k=K, rho=0.1, kappa=kappa, backend=be)
                .apply(sk, v))
    for ref in (NystromIHVP(k=K, rho=0.1, backend=be),
                NystromIHVP(k=K, rho=0.1, stabilized=False, backend=be)):
        want = _flat(ref.apply(sk, v))
        scale = np.abs(want).max()
        np.testing.assert_allclose(out / scale, want / scale, atol=2e-3)


@pytest.mark.parametrize('backend', list(BACKENDS))
def test_kappa_takes_precedence_over_stabilized(backend):
    v = to_torch(_vec(5))
    outs = []
    for stabilized in (True, False):
        solver = NystromIHVP(k=K, rho=0.1, kappa=3, stabilized=stabilized,
                             backend=BACKENDS[backend]())
        sk = _sketch(solver)
        assert sk.B is None and sk.gram_B is None   # no whitened factor
        assert sk.gram_C is not None                # Eq. 6 stays two-pass
        outs.append(solver.apply(sk, v))
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b)
    # κ ≥ k is not Alg. 1: the whitened factor is built and used
    assert _sketch(NystromIHVP(k=K, kappa=K, backend='flat')).B is not None


def test_refine_is_live_on_the_chunked_path():
    """Full rank (k = p) at ρ = 1e-3: the sweeps drive the error against
    the f64 truth down by more than ten times, under 1e-5."""
    tparams = to_torch(PARAMS)
    sk = NystromIHVP(k=P, rho=1e-3, backend='flat').prepare(
        make_hvp(_tloss, tparams, None, None), PyTreeIndexer(tparams),
        torch.Generator().manual_seed(28))
    v = _vec(6)
    truth = np.linalg.solve(H.astype(np.float64) + 1e-3 * np.eye(P),
                            _flat(to_torch(v)).astype(np.float64))
    errs = []
    for refine in (0, 2):
        u = NystromIHVP(k=P, rho=1e-3, kappa=3, refine=refine,
                        backend='flat').apply(sk, to_torch(v))
        errs.append(np.abs(_flat(u) - truth).max() / np.abs(truth).max())
    assert errs[1] < errs[0] / 10
    assert errs[1] < 1e-5


@pytest.mark.parametrize('backend', list(BACKENDS))
def test_slice_k_takes_the_columns_of_each_layout(backend):
    be = get_backend(backend)
    C_tree = {'b': torch.arange(12.).reshape(4, 3),
              'w': torch.arange(24.).reshape(4, 2, 3)}     # k = 4
    C = be.prepare_operand(C_tree)
    got = be.slice_k(C, 1, 2)
    want = be.prepare_operand({n: c[1:3] for n, c in C_tree.items()})
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    if backend == 'cuda':       # the kernels take contiguous operands only
        assert got.is_contiguous() and got.shape == (9, 2)


def _rank_r(seed, p=40, r=20):
    A = np.random.RandomState(seed).randn(p, r).astype(np.float32)
    return A @ A.T


@pytest.mark.parametrize('seed', [13, 14])
@pytest.mark.parametrize('k', [5, 20, 40])
def test_nystrom_inverse_dense_matches_reference(seed, k):
    Hd = _rank_r(seed)
    key = jax.random.PRNGKey(seed + 100)
    want = np.asarray(jdense(jnp.asarray(Hd), k=k, rho=0.1, rng=key))
    draw = np.asarray(jax.random.choice(key, Hd.shape[0], (k,),
                                        replace=False))
    got = nystrom_inverse_dense(torch.tensor(Hd), k, 0.1,
                                indices=draw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_nystrom_inverse_dense_full_rank_is_the_inverse_in_f64():
    Hd = torch.tensor(_rank_r(15) + np.eye(40), dtype=torch.float64)
    p = Hd.shape[0]
    got = nystrom_inverse_dense(Hd, p, 0.1,
                                torch.Generator().manual_seed(0))
    assert got.dtype == torch.float64
    want = torch.linalg.inv(Hd + 0.1 * torch.eye(p, dtype=torch.float64))
    # the 1e-8 jitter on the k×k system is the only departure
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8,
                               atol=1e-8 * float(want.abs().max()))
