"""``distillation`` (§5.2, Tab. 2) through the port against the reference,
at toy size: 8 × 8 images, an MLP 64→16→10 (p = 1,210), 50 distilled
images.

* ``DistillationTask``'s images and labels: bitwise (the same numpy draws).
* The hypergradient at one point, for the four configurations Tab. 2 runs
  on the card (Nyström whitened, Nyström κ = 5, Neumann, CG; k = l = 10,
  ρ = α = 1e-2, CG undamped), on the reference's batches and column draw,
  through the 'flat' and 'cuda' backends (the kernels' plain versions on
  the CPU): rtol 1e-4 with atol 1e-4·‖ref‖∞. CG at ρ = 0 on this singular
  Hessian (p = 1,210 against 50 images) multiplies the last-bit
  differences of its HVPs and dot products: at this point the reference
  moves by 4.0e-4 (max-norm relative) between its f32 run and its run with
  f64 HVPs, and the port lies 1.2e-4 from it. So CG is held to the stated
  tolerance at l = 5 (2.5e-6 apart), and at l = 10 to no more than the
  reference's own f32-against-f64 distance, measured in the test.
* A 2-outer-step ``solve`` (10 inner steps, batch 32) with the reference's
  batches, column draws and reset parameters injected: outer and inner
  losses rtol 1e-4, final images relative L2 ≤ 1e-4. The images start from
  0.5·N(0, 1), injected in both: from the task's zero images every
  distilled image feeds the hidden layer its bias b1, whose entries sit
  within roundoff of leaky-ReLU's kink after the first inner steps, and
  θ's 4e-10 difference then moves the hypergradient by 30% (the port's own,
  at the reference's θ and at its own).
* Alg. 1 (κ = 5) and the literal Eq. 6 on distillation's sketch at a
  solved state (3 outer steps from the zero images), where H_KK is
  indefinite and nearly singular: both packages' applies part ways by
  more than the 2e-3·‖ref‖∞ that holds on a well-conditioned sketch (Alg.
  1 sends the eigenvalues under its threshold to ``_SAFE_BIG``, Eq. 6
  keeps them), and the two packages' Eq. 6 applies on that sketch agree
  to rtol 1e-4, atol 1e-4·‖ref‖∞.
* ``distilled_accuracy`` on the reference's fresh-model weights: within 2
  of the 1,024 test predictions (a tie flipped by f32 roundoff may move
  one).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.problem import hypergrad_at as jhypergrad_at
from repro.core.problem import solve as jsolve
from repro.core.solvers import NystromIHVP as JNystrom
from repro.core.solvers import NystromSketch as JSketch
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.data.synthetic import DistillationTask as JTask
from repro.tasks.paper import build_distillation as jbuild
from repro.tasks.paper import mlp_init as jmlp_init
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import (HypergradConfig, NystromIHVP, PyTreeIndexer,
                              get_problem, hypergrad_at, make_hvp, solve)
from repro_torch.core.tree_util import tree_leaves
from repro_torch.data.synthetic import DistillationTask
from torch_threads import torch_thread_cap  # noqa: F401

TOY = dict(image_size=8, width=16)
SIZES = (64, 16, 10)
TAB2 = {  # Tab. 2's settings (benchmarks/tab2_distillation.py)
    'nystrom': dict(solver='nystrom', k=10, rho=1e-2),
    'nystrom_kappa5': dict(solver='nystrom', k=10, rho=1e-2, kappa=5),
    'neumann': dict(solver='neumann', k=10, alpha=1e-2),
    'cg': dict(solver='cg', k=10, rho=0.0),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jj(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel(port_tree, ref_tree):
    a = np.concatenate([np.ravel(x) for x in tree_leaves(to_numpy(port_tree))])
    b = np.concatenate([np.ravel(np.asarray(x))
                        for x in jax.tree.leaves(ref_tree)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_draw(key, batch_size, n):
    """The reference's batch draw (``ArraySource._draw``)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key),
                                         (batch_size,), 0, n))


@pytest.mark.parametrize('image_size', [8, 28])
def test_task_data_is_the_references_bit_for_bit(image_size):
    port = DistillationTask(image_size=image_size)
    ref = JTask(image_size=image_size)
    np.testing.assert_array_equal(port.prototypes, ref.prototypes)
    for (X, y), (jX, jy) in ((port.train(), ref.train()),
                             (port.test(), ref.test())):
        assert X.dtype == torch.float32 and X.shape[1:] == (
            image_size, image_size, 1)
        np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_problem_is_registered_with_the_references_defaults():
    tp = get_problem('distillation', device='cpu', **TOY)
    jp = jbuild(**TOY)
    assert tp.defaults == jp.defaults == dict(
        inner_lr=0.01, outer_lr=1e-3, steps_per_outer=100, batch_size=256,
        reset_inner=True)
    np.testing.assert_array_equal(tp.reference['distill_labels'].numpy(),
                                  np.asarray(jp.reference['distill_labels']))
    assert tp.init_hparams(None)['images'].shape == (50, 8, 8, 1)
    assert sum(x.numel() for x in tree_leaves(tp.init_params(
        torch.Generator().manual_seed(0)))) == 64 * 16 + 16 + 16 * 10 + 10


@functools.lru_cache(maxsize=None)
def _point():
    """(reference problem, params, images, inner batch, outer batch); the
    callers copy before they change anything."""
    jp = jbuild(**TOY)
    params = _np(jmlp_init(jax.random.PRNGKey(1), SIZES))
    hparams = {'images': (0.5 * np.random.RandomState(2).randn(
        50, 8, 8, 1)).astype(np.float32)}
    ib = _np(jp.data.train_batch(0, 64))
    ob = _np(jp.data.val_batch(0, 64))
    return jp, params, hparams, ib, ob


def _hypergrads(fields, backend='flat', f64=False):
    """(port, reference) hypergradients w.r.t. the images at ``_point``,
    on the reference's column draw; ``f64`` runs both on f64 arrays (the
    reference under ``jax.enable_x64``)."""
    jp, params, hparams, ib, ob = _point()
    if f64:
        params, hparams, ib, ob = jax.tree.map(
            lambda x: x.astype(np.float64) if x.dtype == np.float32 else x,
            (params, hparams, ib, ob))
    key = jax.random.PRNGKey(3)
    nystrom = fields['solver'] == 'nystrom'
    with jax.enable_x64(f64):
        want = jhypergrad_at(jp, JConfig(**fields, **(
            {'backend': 'flat'} if nystrom else {})), _jj(params),
            _jj(hparams), _jj(ib), _jj(ob), rng=key)['images']
        want = np.asarray(want)
    draw = _np(JIndexer(_jj(params)).sample_indices(key, 10))
    tp = get_problem('distillation', device='cpu', **TOY)
    cfg = HypergradConfig(**fields, **({'backend': backend} if nystrom
                                       else {}))
    got = hypergrad_at(tp, cfg, to_torch(params), to_torch(hparams),
                       to_torch(ib), to_torch(ob), indices=draw,
                       device='cpu')['images'].numpy()
    assert want.dtype == got.dtype == (np.float64 if f64 else np.float32)
    return got, want


# the baselines build no backend: one case each; CG's case is below
CASES = [('nystrom', 'flat'), ('nystrom_kappa5', 'flat'),
         ('neumann', 'flat'), ('nystrom', 'cuda'), ('nystrom_kappa5', 'cuda')]


@pytest.mark.parametrize('config,backend', CASES)
def test_hypergradient_matches_reference(config, backend):
    got, want = _hypergrads(TAB2[config], backend)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0


def _maxrel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_cg_hypergradient_matches_reference():
    got, want = _hypergrads(dict(TAB2['cg'], k=5))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    got, want = _hypergrads(TAB2['cg'])
    _, want64 = _hypergrads(TAB2['cg'], f64=True)
    # the reference's own f32 rounding moves it past the stated tolerance
    assert _maxrel(want, want64) > 1e-4
    assert _maxrel(got, want) <= _maxrel(want, want64)


def _reference_draws(n_outer, seed=0):
    """Replay the reference trainer's streams: ``init`` splits
    PRNGKey(seed) into (rng, vjp_rng); every outer step splits vjp_rng for
    the sketch's columns, and ``reset_inner`` splits rng for the fresh
    parameters."""
    rng, vjp_rng = jax.random.split(jax.random.PRNGKey(seed))
    columns, resets = [], []
    for _ in range(n_outer):
        vjp_rng, sub = jax.random.split(vjp_rng)
        columns.append(sub)
        rng, sub = jax.random.split(rng)
        resets.append(_np(jmlp_init(sub, SIZES)))
    return columns, resets


@pytest.mark.parametrize('config', ['nystrom_kappa5', 'cg'])
def test_solve_trajectory_matches_reference(config):
    n_outer, steps, bs = 2, 10, 32
    fields = TAB2[config]
    h0 = {'images': (0.5 * np.random.RandomState(4).randn(
        50, 8, 8, 1)).astype(np.float32)}
    jp = jbuild(**TOY)
    jp.init_hparams = lambda rng: _jj(h0)
    want = jsolve(jp, JConfig(**fields), n_outer=n_outer,
                  steps_per_outer=steps, batch_size=bs)
    keys, resets = _reference_draws(n_outer)
    p0 = _np(jp.init_params(jax.random.PRNGKey(0)))
    draws = [_np(JIndexer(_jj(p0)).sample_indices(k, 10)) for k in keys]

    tp = get_problem('distillation', device='cpu', **TOY)
    tp.data.draw = _jax_draw
    reset_it = iter(resets)
    tp.init_params = lambda rng: to_torch(next(reset_it))
    got = solve(tp, HypergradConfig(**fields), n_outer=n_outer,
                steps_per_outer=steps, batch_size=bs, device='cpu',
                params=to_torch(p0), hparams=to_torch(h0), index_draws=draws)
    np.testing.assert_allclose(got.history['outer_loss'],
                               want.history['outer_loss'], rtol=1e-4)
    np.testing.assert_allclose(got.history['inner_loss'],
                               want.history['inner_loss'], rtol=1e-4)
    assert _rel(got.hparams, want.hparams) <= 1e-4
    assert got.hvp_count == want.hvp_count == n_outer * 10
    # the images moved: the comparison is not of the initial point
    assert _rel(got.hparams, h0) > 1e-4


def test_distilled_accuracy_on_the_references_fresh_model():
    jp, params, hparams, _, _ = _point()
    want = jp.metrics['distilled_accuracy'](_jj(params), _jj(hparams))
    tp = get_problem('distillation', device='cpu', **TOY)
    init = to_torch(_np(jmlp_init(jax.random.PRNGKey(7), SIZES)))
    got = tp.metrics['distilled_accuracy'](to_torch(params),
                                           to_torch(hparams), init=init)
    assert abs(got - want) <= 2 / 1024
    assert 0.0 <= tp.metrics['distilled_accuracy'](
        to_torch(params), to_torch(hparams)) <= 1.0


def _scaled_gap(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_alg1_and_eq6_part_ways_on_distillations_sketch_in_both_packages():
    tp = get_problem('distillation', device='cpu', **TOY)
    res = solve(tp, HypergradConfig(k=10, kappa=5, backend='flat'),
                n_outer=3, steps_per_outer=5, batch_size=32, device='cpu')
    idx = PyTreeIndexer(res.params).sample_indices(
        torch.Generator().manual_seed(3), 10)
    sk = NystromIHVP(k=10, kappa=5, backend='flat').prepare(
        make_hvp(tp.inner_loss, res.params, res.hparams, None),
        PyTreeIndexer(res.params), None, indices=idx)
    lam = torch.linalg.eigvalsh(sk.H_KK.double())
    assert lam.min() < 0 < lam.max()                     # indefinite
    v = torch.func.grad(tp.outer_loss)(res.params, res.hparams,
                                       tp.data.val_batch(3, 32))
    jsk = JSketch(C=jnp.asarray(sk.C.numpy()), H_KK=jnp.asarray(
        sk.H_KK.numpy()), indices=_jj(to_numpy(sk.indices)),
        rho=jnp.float32(1e-2), gram_C=jnp.asarray(sk.gram_C.numpy()))
    jv = _jj(to_numpy(v))
    gaps = {}
    for pkg, make, state, vec in (('port', NystromIHVP, sk, v),
                                  ('reference', JNystrom, jsk, jv)):
        out = {}
        for name, kw in (('alg1', dict(kappa=5)),
                         ('eq6', dict(stabilized=False))):
            u = make(k=10, rho=1e-2, backend='flat', **kw).apply(state, vec)
            leaves = (tree_leaves(to_numpy(u)) if pkg == 'port'
                      else jax.tree.leaves(u))
            out[name] = np.concatenate([np.ravel(np.asarray(x))
                                        for x in leaves])
        gaps[pkg] = out
        assert _scaled_gap(out['alg1'], out['eq6']) > 2e-3, pkg
    want = gaps['reference']['eq6']
    np.testing.assert_allclose(gaps['port']['eq6'], want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
