"""The slice as a whole: the port's main path against the reference's.

* ``hypergrad_at`` on ``reweighting`` (MLP at width 16) at the reference's
  parameters, batches and column draw, through the port's 'flat' backend
  and its 'cuda' backend (the kernels' plain versions on the CPU).
* a 3-outer-step ``solve`` on ``logreg_wd`` (D = 20) with the reference's
  batch draws and sketch columns injected: the outer-loss trajectory and
  the final hyperparameters.

Tolerance: relative L2 ≤ 1e-4 for hypergradients and hyperparameters;
rtol 1e-4 for the losses. Each outer step runs 20 inner SGD steps and a
Nyström hypergradient whose f32 sums run in another order than XLA's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.problem import hypergrad_at as jhypergrad_at
from repro.core.problem import solve as jsolve
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.tasks.paper import build_logreg_weight_decay as jbuild_logreg
from repro.tasks.paper import build_reweighting as jbuild_rw
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import HypergradConfig, hypergrad_at, solve
from repro_torch.core.tree_util import tree_leaves
from repro_torch.tasks import build_logreg_weight_decay, build_reweighting


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


@pytest.mark.parametrize('backend', ['flat', 'cuda'])
def test_reweighting_hypergradient_matches_reference(backend):
    jp = jbuild_rw(width=16)
    tp = build_reweighting(width=16, device='cpu')
    params = _np(jp.init_params(jax.random.PRNGKey(1)))
    hparams = _np(jp.init_hparams(jax.random.PRNGKey(2)))
    ib = _np(jp.data.train_batch(0, 128))
    ob = _np(jp.data.val_batch(0, 128))
    key = jax.random.PRNGKey(3)
    want = jhypergrad_at(jp, JConfig(k=10, backend='flat'), _jj(params),
                         _jj(hparams), _jj(ib), _jj(ob), rng=key)
    draw = _np(JIndexer(_jj(params)).sample_indices(key, 10))
    got = hypergrad_at(tp, HypergradConfig(k=10, backend=backend), to_torch(params), to_torch(hparams),
                       to_torch(ib), to_torch(ob), indices=draw, device='cpu')
    assert _rel(got, want) <= 1e-4


def test_port_batches_match_reference_under_injected_draws():
    jp = jbuild_rw(width=16)
    tp = build_reweighting(width=16, device='cpu')
    tp.data.draw = _jax_draw
    for step in (0, 5):
        for a, b in zip(tp.data.train_batch(step, 32),
                        jp.data.train_batch(step, 32)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tp.data.val_batch(step, 32),
                        jp.data.val_batch(step, 32)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _reference_index_draws(n_outer, k, params, seed=0):
    """Replay the reference trainer's column stream: ``init`` splits
    PRNGKey(seed) into (rng, vjp_rng); every outer step splits vjp_rng and
    builds the sketch from the sub-key (refresh every step here)."""
    _, vjp_rng = jax.random.split(jax.random.PRNGKey(seed))
    draws = []
    for _ in range(n_outer):
        vjp_rng, sub = jax.random.split(vjp_rng)
        draws.append(_np(JIndexer(params).sample_indices(sub, k)))
    return draws


def test_logreg_solve_trajectory_matches_reference():
    n_outer, k, steps = 3, 5, 20
    jp = jbuild_logreg(D=20)
    want = jsolve(jp, JConfig(k=k, backend='flat'), n_outer=n_outer,
                  steps_per_outer=steps)
    tp = build_logreg_weight_decay(D=20, device='cpu')
    tp.data.draw = _jax_draw
    draws = _reference_index_draws(n_outer, k, {'w': jnp.zeros(20)})
    got = solve(tp, HypergradConfig(k=k, backend='cuda'),
                n_outer=n_outer, steps_per_outer=steps, device='cpu',
                index_draws=draws)
    np.testing.assert_allclose(got.history['outer_loss'],
                               want.history['outer_loss'], rtol=1e-4)
    np.testing.assert_allclose(got.history['inner_loss'],
                               want.history['inner_loss'], rtol=1e-4)
    assert _rel(got.hparams, want.hparams) <= 1e-4
    assert got.hvp_count == want.hvp_count == n_outer * k
    # the hyperparameters really moved: the comparison is not of the init
    assert _rel(got.hparams, {'wd': np.ones(20, np.float32)}) > 1e-3


def test_entry_points_refuse_a_problem_on_another_device():
    tp = build_logreg_weight_decay(D=5, n=8, device='cpu')
    if torch.cuda.is_available():
        pytest.skip('a card is present: solve() defaults to it')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(tp, HypergradConfig(k=2), n_outer=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_reweighting(width=4)
