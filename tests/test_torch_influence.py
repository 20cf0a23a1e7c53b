"""The port's one-shot influence path against the reference's:
per-example gradients, the streamed top-k scanner (with ties), training,
``influence`` end to end with self-influence (Nyström through the kernels'
plain versions, and the exact solver), and ``store=`` honoured.

The reference's trained parameters and column draw are injected. Sizes:
``build_influence(d=8, width=16)`` (p = 586, 1,200 training examples),
m = 4 queries. Tolerances: per-example gradients 1e-6 relative L2; scores
and self-influence 1e-5 relative (an IHVP and a (b, p)·(p, m) product in
f32, summed in another order than XLA); top-k indices equal; trained
parameters 1e-5 (20 SGD steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.problem import _per_example_grads as j_per_example_grads
from repro.core.problem import influence as jinfluence
from repro.core.problem import make_topk_scanner as jmake_topk_scanner
from repro.core.problem import train_influence_params as jtrain
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.tasks.paper import build_influence as jbuild_influence
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import (HypergradConfig, influence, make_topk_scanner,
                              train_influence_params)
from repro_torch.core.problem import _per_example_grads
from repro_torch.core.tree_util import tree_leaves
from repro_torch.data import ArraySource
from repro_torch.tasks import build_influence
from torch_threads import torch_thread_cap  # noqa: F401

TOY = dict(d=8, width=16)
M = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jj(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel(port, ref):
    a = np.concatenate([np.ravel(x) for x in tree_leaves(to_numpy(port))])
    b = np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree.leaves(ref)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_draw(key, batch_size, n):
    """The reference's batch draw (``ArraySource._draw``)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key),
                                         (batch_size,), 0, n))


_TRAINED = {}


def _trained():
    """The reference's problem, and its parameters after the task's
    default 200 SGD steps."""
    if not _TRAINED:
        jp = jbuild_influence(**TOY)
        _TRAINED['jp'] = jp
        _TRAINED['params'] = _np(jtrain(jp))
    return _TRAINED['jp'], _TRAINED['params']


def test_per_example_grads_match_reference():
    jp, params = _trained()
    tp = build_influence(**TOY, device='cpu')
    batch = _np(jp.data.train_slice(100, 32))
    want = j_per_example_grads(jp.loss, _jj(params), _jj(batch))
    got = _per_example_grads(tp.loss, to_torch(params), to_torch(batch))
    assert tree_leaves(got)[0].shape[0] == 32
    assert _rel(got, want) <= 1e-6


def test_training_matches_reference_with_its_batch_draws():
    jp = jbuild_influence(**TOY)
    params = _np(jtrain(jp, train_steps=20))
    tp = build_influence(**TOY, device='cpu')
    tp.data = ArraySource(train=tp.data.train, val=tp.data.val,
                          draw=_jax_draw)
    init = to_torch(_np(jp.init_params(jax.random.PRNGKey(0))))
    tp.init_params = lambda rng: init
    got = train_influence_params(tp, train_steps=20)
    assert _rel(got, params) <= 1e-5


def test_scanner_breaks_ties_as_the_reference():
    """Integer data and a linear loss make every score an exact integer in
    both packages, with many ties; the running top-k must keep the lower
    index first on a tie, across tile boundaries (tiles of 7 over 40)."""
    rng = np.random.RandomState(0)
    X = rng.randint(-2, 3, size=(40, 3)).astype(np.float32)
    y = np.zeros(40, np.int32)
    S = {'w': rng.randint(-2, 3, size=(3, 5)).astype(np.float32)}
    params = {'w': np.zeros(3, np.float32)}

    def jloss(p, b):
        return jnp.mean(b[0] @ p['w'])

    def loss(p, b):
        return torch.mean(b[0] @ p['w'])

    from repro.data.sources import ArraySource as JSource
    jsrc = JSource(train=(jnp.asarray(X), jnp.asarray(y)),
                   val=(jnp.asarray(X), jnp.asarray(y)))
    src = ArraySource(train=(torch.from_numpy(X), torch.from_numpy(y)),
                      val=(torch.from_numpy(X), torch.from_numpy(y)))
    want_v, want_i = jmake_topk_scanner(jloss, _jj(params), jsrc, 7)(
        _jj(S), 6)
    got_v, got_i = make_topk_scanner(loss, to_torch(params), src, 7)(
        to_torch(S), 6)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert any(len(set(row)) < len(row) for row in got_v.tolist())


def _check_against_reference(got, want):
    ref_v = np.asarray(want.scores)
    assert got.scores.shape == (M, 5)
    np.testing.assert_allclose(got.scores.numpy(), ref_v,
                               atol=1e-5 * np.abs(ref_v).max(), rtol=1e-5)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.self_scores.numpy(),
                               np.asarray(want.self_scores), rtol=1e-5)
    assert got.hvp_count == want.hvp_count


def test_influence_matches_reference():
    """Nyström k = 5 through the kernels' plain versions, at the
    reference's column draw."""
    jp, params = _trained()
    tp = build_influence(**TOY, device='cpu')
    queries = _np(jp.reference['queries'](M))
    want = jinfluence(jp, JConfig(k=5, rho=1e-2, backend='flat'),
                      _jj(queries), params=_jj(params), top_k=5,
                      self_influence=True, seed=3)
    draw = _np(JIndexer(_jj(params)).sample_indices(jax.random.PRNGKey(3),
                                                    5))
    got = influence(tp, HypergradConfig(k=5, rho=1e-2, backend='cuda'),
                    to_torch(queries), params=to_torch(params), top_k=5,
                    self_influence=True, indices=draw, device='cpu')
    _check_against_reference(got, want)
    assert got.hvp_count == 5


def test_exact_solver_matches_reference():
    """The exact solver, in two steps. (1) Its dense Hessian equals the
    reference's to f32 roundoff (1e-6 of max |H|). (2) H + ρI is indefinite
    here, with condition number about 1.4e5: an f32 LU solve is off by about
    1e-4 of the scores in either package, and two solves agree no closer.
    So both packages solve against the reference's Hessian, and each is
    scored against that solve done in f64: the port must be within twice
    the reference's own error (or 1e-5 of max |score|), with equal
    indices."""
    from repro.core.problem import influence_curvature_hvp as jcurvature
    from repro.core.solvers import ExactIHVP as JExact
    from repro_torch.core import DenseFactor, ExactIHVP, PyTreeIndexer
    from repro_torch.core.problem import influence_curvature_hvp
    jp, params = _trained()
    tp = build_influence(**TOY, device='cpu')
    jH = np.asarray(JExact(rho=1e-2).prepare(
        jcurvature(jp, _jj(params), jp.data, 128), JIndexer(_jj(params))).H)
    H = ExactIHVP(rho=1e-2).prepare(
        influence_curvature_hvp(tp, to_torch(params), tp.data, 128),
        PyTreeIndexer(to_torch(params))).H
    np.testing.assert_allclose(H.numpy(), jH, rtol=0,
                               atol=1e-6 * np.abs(jH).max())

    class AtReferenceHessian(ExactIHVP):
        def prepare(self, hvp, indexer, rng=None, *, indices=None):
            return DenseFactor(H=torch.tensor(jH))

    queries = _np(jp.reference['queries'](M))
    want = jinfluence(jp, JConfig(solver='exact', rho=1e-2), _jj(queries),
                      params=_jj(params), top_k=5, self_influence=True)
    got = influence(tp, AtReferenceHessian(rho=1e-2), to_torch(queries),
                    params=to_torch(params), top_k=5, self_influence=True,
                    device='cpu')

    def flat_grads(batch):
        G = j_per_example_grads(jp.loss, _jj(params), _jj(batch))
        return np.concatenate([np.asarray(g).reshape(g.shape[0], -1)
                               for g in jax.tree.leaves(G)], 1).astype(
                                   np.float64)
    Gq = flat_grads(queries)
    S = np.linalg.solve(jH.astype(np.float64) + 1e-2 * np.eye(len(jH)),
                        Gq.T)
    true = -(flat_grads(jp.data.train) @ S).T
    true_top = -np.sort(-true, axis=1)[:, :5]
    true_self = np.sum(Gq.T * S, 0)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    for port, ref, exact in ((got.scores.numpy(), want.scores, true_top),
                             (got.self_scores.numpy(), want.self_scores,
                              true_self)):
        ref_err = np.abs(np.asarray(ref) - exact).max()
        assert np.abs(port - exact).max() <= max(
            2 * ref_err, 1e-5 * np.abs(exact).max())
    assert got.hvp_count == want.hvp_count == 586


def test_store_is_refused_not_ignored():
    """``store=`` is honoured, not ignored: the call's sketch lands in the
    store under its content key, billed k HVPs, and a second call is a
    warm hit that bills none (the serving tier's cases are in
    ``tests/test_torch_serve.py``)."""
    from repro_torch.serve import SketchStore, sketch_key
    tp = build_influence(**TOY, device='cpu')
    params = tp.init_params(torch.Generator().manual_seed(0))
    store = SketchStore()
    solver = HypergradConfig(k=2).build()
    runs = [influence(tp, solver, tp.reference['queries'](2), params=params,
                      store=store, device='cpu') for _ in range(2)]
    assert store.keys() == [sketch_key(params, solver)]
    assert [r.hvp_count for r in runs] == [2, 0]
    assert store._entries[store.keys()[0]].build_hvps == 2
