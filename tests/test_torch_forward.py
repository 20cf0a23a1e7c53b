"""The forward-mode rule of the port's ``implicit_root`` against the
reference's ``jax.custom_jvp`` rule, and the pieces it is built from.

* ``torch.func.jvp`` tangents against ``jax.jvp``: the analytic quadratic
  (θ*(φ) = φ/d, tangent φ̇/(d + ρ)) for each solver, and ``reweighting``
  at toy width at the reference's column draw;
* jvp through a vmapped map against per-task jvps (the reference's
  ``test_jvp_of_vmap_matches_per_task``), with the exact solver and with
  per-task and shared Nyström sketches;
* the jvp and the VJP are transposes of one another (⟨u, Jφ̇⟩ = ⟨Jᵀu, φ̇⟩);
* ``tangent_apply``: its value is ``solver.apply``'s, it is its own
  transpose, and under vmap it is one ``apply_matrix``;
* ``forward_mode=False`` keeps the same reverse rule and refuses a jvp.

Tolerances: 1e-5 relative L2 for tangents (an IHVP and a jvp of the inner
gradient in f32, summed in another order than XLA), atol 1e-5 against
analytic values, 1e-5 relative for the dot test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vmap

from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.implicit import implicit_root as jimplicit_root
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.tasks.paper import build_reweighting as jbuild_rw
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import (HypergradConfig, PyTreeIndexer, implicit_root,
                              make_hvp, tangent_apply)
from repro_torch.core.tree_util import tree_leaves, tree_map, tree_vdot
from torch_threads import torch_thread_cap  # noqa: F401

D = torch.tensor([1.0, 2.0, 4.0])
DJ = jnp.array([1.0, 2.0, 4.0])
SOLVERS = [dict(solver='exact', rho=0.0),
           dict(solver='nystrom', k=3, rho=1e-3, backend='cuda'),
           dict(solver='cg', k=3, rho=0.0),
           dict(solver='neumann', k=200, alpha=0.3)]


def _quad(theta, phi, batch):
    return 0.5 * torch.sum(D * theta ** 2) - torch.sum(theta * phi)


def _jquad(theta, phi, batch):
    return 0.5 * jnp.sum(DJ * theta ** 2) - jnp.sum(theta * phi)


def _rel(port_tree, ref_tree):
    a = np.concatenate([np.ravel(x) for x in tree_leaves(to_numpy(port_tree))])
    b = np.concatenate([np.ravel(np.asarray(x))
                        for x in jax.tree.leaves(ref_tree)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize('fields', SOLVERS, ids=lambda f: f['solver'])
def test_quadratic_tangent_matches_reference_and_closed_form(fields):
    v = np.array([3.0, 2.0, 4.0], np.float32)
    jfields = {k: ('flat' if k == 'backend' else x)
               for k, x in fields.items()}
    jsolve = jimplicit_root(lambda phi, b: phi / DJ, _jquad,
                            JConfig(**jfields))
    _, want = jax.jvp(lambda p: jsolve(p, None), (jnp.ones(3),),
                      (jnp.asarray(v),))
    solve = implicit_root(lambda phi, b: phi / D, _quad,
                          HypergradConfig(**fields))
    _, got = jvp(lambda p: solve(p, None), (torch.ones(3),),
                 (torch.from_numpy(v),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               v / (D.numpy() + fields.get('rho', 0.0)),
                               atol=1e-5)


def _reweighting_point():
    jp = jbuild_rw(width=16)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params = np_(jp.init_params(jax.random.PRNGKey(1)))
    hparams = np_(jp.init_hparams(jax.random.PRNGKey(2)))
    ib = np_(jp.data.train_batch(0, 128))
    phi_dot = jax.tree.map(
        lambda x: np.random.RandomState(x.size).randn(*x.shape)
        .astype(np.float32), hparams)
    key = jax.random.PRNGKey(9)
    draw = np_(JIndexer(jax.tree.map(jnp.asarray, params))
               .sample_indices(key, 6))
    return jp, params, hparams, ib, phi_dot, key, draw


@pytest.mark.parametrize('backend', ['flat', 'cuda'])
def test_reweighting_tangent_matches_reference(backend):
    from repro_torch.tasks import build_reweighting
    jp, params, hparams, ib, phi_dot, key, draw = _reweighting_point()
    jj = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    jsolve = jimplicit_root(lambda phi, b: jj(params), jp.inner_loss,
                            JConfig(k=6, rho=1e-2, backend='flat'))
    _, want = jax.jvp(lambda h: jsolve(h, jj(ib), rng=key), (jj(hparams),),
                      (jj(phi_dot),))
    tp = build_reweighting(width=16, device='cpu')
    tparams = to_torch(params)
    solve = implicit_root(lambda phi, b: tparams, tp.inner_loss,
                          HypergradConfig(k=6, rho=1e-2, backend=backend))
    _, got = jvp(lambda h: solve(h, to_torch(ib), indices=draw),
                 (to_torch(hparams),), (to_torch(phi_dot),))
    assert _rel(got, want) <= 1e-5


def test_jvp_and_vjp_are_transposes():
    from repro_torch.tasks import build_reweighting
    _, params, hparams, ib, phi_dot, _, draw = _reweighting_point()
    tp = build_reweighting(width=16, device='cpu')
    tparams, h, hd = to_torch(params), to_torch(hparams), to_torch(phi_dot)
    solve = implicit_root(lambda phi, b: tparams, tp.inner_loss,
                          HypergradConfig(k=6, rho=1e-2, backend='cuda'))
    batch = to_torch(ib)
    _, J_phi_dot = jvp(lambda x: solve(x, batch, indices=draw), (h,), (hd,))
    u = tree_map(lambda x: torch.randn(x.shape,
                                       generator=torch.Generator()
                                       .manual_seed(x.numel())), tparams)
    JT_u = grad(lambda x: tree_vdot(u, solve(x, batch, indices=draw)))(h)
    a, b = float(tree_vdot(u, J_phi_dot)), float(tree_vdot(JT_u, hd))
    assert abs(a - b) <= 1e-5 * abs(b)


@pytest.mark.parametrize('shared', [False, True])
@pytest.mark.parametrize('config', [
    HypergradConfig(solver='exact', rho=0.0),
    HypergradConfig(k=2, rho=1e-2, backend='cuda'),
], ids=['exact', 'nystrom'])
def test_jvp_of_vmapped_map_equals_per_task(config, shared):
    """jvp through a vmapped meta-batch of solves, and vmap of jvps, equal
    the per-task jvps: with the same draw per task, or one shared state."""
    A = torch.tensor([[3.0, 1.0, 0.0], [1.0, 2.0, 0.5], [0.0, 0.5, 1.5]])
    Bm = torch.tensor([[1.0, 0.0], [2.0, 1.0], [0.0, -1.0]])

    def inner(prm, hp, batch):
        th = prm['theta']
        return 0.5 * th @ A @ th - th @ (Bm @ hp['phi'])

    def smap(hp, batch):
        return {'theta': torch.linalg.solve(A, Bm @ hp['phi'])}

    solve = implicit_root(smap, inner, config)
    idx = {'leaf': np.zeros(2, np.int64), 'dims': np.array([[0], [2]])}
    state = (solve.prepare_state(smap({'phi': torch.ones(2)}, None),
                                 {'phi': torch.ones(2)}, indices=idx)
             if shared else None)

    def one(hp):
        return solve(hp, None, state=state,
                     indices=None if shared else idx)['theta']

    phis = {'phi': torch.stack([(i + 1.0) * torch.ones(2) for i in range(3)])}
    dphis = {'phi': 0.1 * torch.arange(6.0).reshape(3, 2)}
    _, batched = jvp(vmap(one), (phis,), (dphis,))
    mapped = vmap(lambda p, t: jvp(one, (p,), (t,))[1])(phis, dphis)
    for i in range(3):
        _, want = jvp(one, ({'phi': phis['phi'][i]},),
                      ({'phi': dphis['phi'][i]},))
        torch.testing.assert_close(batched[i], want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(mapped[i], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('fields', SOLVERS[:3], ids=lambda f: f['solver'])
def test_tangent_apply_is_the_solver_apply_and_its_own_transpose(fields):
    from repro_torch.tasks import build_reweighting
    tp = build_reweighting(width=8, d=4, device='cpu')
    prm = tp.init_params(torch.Generator().manual_seed(0))
    hp = tp.init_hparams(torch.Generator().manual_seed(1))
    batch = tp.data.train_batch(0, 64)
    solver = HypergradConfig(**{**fields, 'rho': 0.1}).build()
    hvp = make_hvp(tp.inner_loss, prm, hp, batch)
    state = solver.prepare(hvp, PyTreeIndexer(prm),
                           torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    w, a = (tree_map(lambda x: torch.randn(x.shape, generator=g), prm)
            for _ in range(2))
    got = tangent_apply(solver, state, hvp, w)
    for x, y in zip(tree_leaves(got), tree_leaves(solver.apply(state, w))):
        assert torch.equal(x, y)
    # the transpose: d<a, S w>/dw = S a
    wg = tree_map(lambda x: x.clone().requires_grad_(True), w)
    grads = torch.autograd.grad(
        tree_vdot(a, tangent_apply(solver, state, hvp, wg)), tree_leaves(wg))
    for x, y in zip(grads, tree_leaves(solver.apply(state, a))):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    # rows of a task axis: one apply_matrix
    W = tree_map(lambda x, y: torch.stack([x, y]), w, a)
    rows = vmap(lambda x: tangent_apply(solver, state, hvp, x))(W)
    block = solver.apply_matrix(state, tree_map(lambda x: x.movedim(0, -1), W))
    for x, y in zip(tree_leaves(rows), tree_leaves(block)):
        torch.testing.assert_close(x, y.movedim(-1, 0), rtol=1e-5, atol=1e-6)


def test_forward_mode_false_keeps_the_reverse_rule_and_refuses_jvp():
    fwd = implicit_root(lambda phi, b: phi / D, _quad,
                        HypergradConfig(k=3, rho=1e-3, backend='cuda'))
    rev = implicit_root(lambda phi, b: phi / D, _quad,
                        HypergradConfig(k=3, rho=1e-3, backend='cuda'),
                        forward_mode=False)
    phi = torch.tensor([1.0, -2.0, 0.5])
    g_fwd = grad(lambda p: (fwd(p, None) ** 2).sum())(phi)
    g_rev = grad(lambda p: (rev(p, None) ** 2).sum())(phi)
    assert torch.equal(g_fwd, g_rev)
    with pytest.raises(RuntimeError, match='jvp'):
        jvp(lambda p: rev(p, None), (phi,), (torch.ones(3),))
