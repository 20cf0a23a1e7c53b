"""Parity of the port's ``implicit_root`` (an autograd Function) with the
reference's: the analytic quadratic of ``implicit.py``'s docstring, the
hypergradient on ``logreg_wd`` at the reference's column draw, and the
m-query ``phi_vjp_block``.

Tolerance: relative L2 ≤ 1e-4 for hypergradients (an IHVP apply, a k×k
solve and a second-order VJP, each summing f32 in another order than XLA),
atol 1e-5 against analytic values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.implicit import phi_vjp_block as jphi_vjp_block
from repro.core.problem import hypergrad_at as jhypergrad_at
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.tasks.paper import build_logreg_weight_decay as jbuild_logreg
from repro_torch.convert import to_torch
from repro_torch.core.backend import CudaBackend
from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.implicit import implicit_root, phi_vjp_block
from repro_torch.core.problem import hypergrad_at
from repro_torch.core.tree_util import tree_leaves
from repro_torch.tasks.paper import build_logreg_weight_decay
from torch_threads import torch_thread_cap  # noqa: F401

D = torch.tensor([1.0, 2.0, 4.0])


def _inner(theta, phi, batch):
    return 0.5 * torch.sum(D * theta ** 2) - torch.sum(theta * phi)


@pytest.mark.parametrize('config', [
    HypergradConfig(solver='exact', rho=0.0),
    HypergradConfig(k=3, rho=1e-3, backend='cuda'),
])
def test_analytic_quadratic_solution_map(config):
    """θ*(φ) = φ/d, so d(Σθ*)/dφ = 1/d; with damping ρ the IHVP gives
    1/(d + ρ). The full-rank Nyström sketch (k = p) is exact."""
    solve = implicit_root(lambda phi, batch: phi / D, _inner, config)
    phi = torch.ones(3, requires_grad=True)
    g, = torch.autograd.grad(solve(phi, None).sum(), phi)
    np.testing.assert_allclose(g.numpy(), (1.0 / (D + config.rho)).numpy(),
                               atol=1e-5)


def test_shared_state_equals_fresh_prepare_at_the_same_columns():
    solve = implicit_root(lambda phi, batch: phi / D, _inner,
                          HypergradConfig(k=2, rho=0.1, backend='flat'))
    idx = {'leaf': np.array([0, 0]), 'dims': np.array([[0], [2]])}
    phi = torch.ones(3, requires_grad=True)
    state = solve.prepare_state(torch.ones(3) / D, phi.detach(), None,
                                indices=idx)
    g_shared, = torch.autograd.grad(solve(phi, None, state=state).sum(), phi)
    g_fresh, = torch.autograd.grad(solve(phi, None, indices=idx).sum(), phi)
    assert torch.equal(g_shared, g_fresh)


def _rel(a_tree, b_tree):
    a = np.concatenate([np.ravel(x.detach().numpy()) for x in tree_leaves(a_tree)])
    b = np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree.leaves(b_tree)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _logreg_point():
    jp = jbuild_logreg(D=20, n=64)
    tp = build_logreg_weight_decay(D=20, n=64, device='cpu')
    params = {'w': np.random.RandomState(0).randn(20).astype(np.float32)}
    hparams = {'wd': np.random.RandomState(1).rand(20).astype(np.float32)}
    X, y = (np.asarray(a) for a in jp.data.train)
    Xv, yv = (np.asarray(a) for a in jp.data.val)
    return jp, tp, params, hparams, (X, y), (Xv, yv)


@pytest.mark.parametrize('backend', ['flat', 'cuda'])
def test_logreg_hypergradient_matches_reference(backend):
    jp, tp, params, hparams, ib, ob = _logreg_point()
    key = jax.random.PRNGKey(9)
    jj = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    want = jhypergrad_at(jp, JConfig(k=6, rho=0.05, backend='flat'),
                         jj(params), jj(hparams), jj(ib), jj(ob), rng=key)
    draw = jax.tree.map(np.asarray,
                        JIndexer(jj(params)).sample_indices(key, 6))
    cfg = (HypergradConfig(k=6, rho=0.05, backend='cuda')
           if backend == 'cuda' else HypergradConfig(k=6, rho=0.05,
                                                     backend='flat'))
    got = hypergrad_at(tp, cfg, to_torch(params), to_torch(hparams),
                       to_torch(ib), to_torch(ob), indices=draw, device='cpu')
    assert _rel(got, want) <= 1e-4


def test_phi_vjp_block_matches_reference():
    jp, tp, params, hparams, ib, _ = _logreg_point()
    key = jax.random.PRNGKey(11)
    jj = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    V = {'w': np.random.RandomState(3).randn(20, 5).astype(np.float32)}
    jsolver = JConfig(k=6, rho=0.05, backend='flat').build()
    want = jphi_vjp_block(jsolver, jp.inner_loss, jj(params), jj(hparams),
                          jj(ib), jj(V), rng=key)
    draw = jax.tree.map(np.asarray,
                        JIndexer(jj(params)).sample_indices(key, 6))
    solver = HypergradConfig(k=6, rho=0.05,
                             backend=CudaBackend()).build()
    got = phi_vjp_block(solver, tp.inner_loss, to_torch(params),
                        to_torch(hparams), to_torch(ib), to_torch(V),
                        indices=draw)
    assert got['wd'].shape == (20, 5)
    assert _rel(got, want) <= 1e-4
