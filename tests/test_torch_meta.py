"""The iMAML meta path of the port against the reference's: episodes, the
episode source, ``sgd_solver``, per-task hypergradients under
``torch.func.vmap(torch.func.grad(...))`` (per-task and shared sketches),
a 2-meta-step ``solve(vmap_tasks=3)`` trajectory, the HVP accounting, the
refusals, and the two ported examples at tiny sizes.

Every draw is the reference's: episodes are numpy draws made alike in both
packages; the meta-init comes from the reference's ``init_hparams``; the
sketch columns are its ``PyTreeIndexer.sample_indices`` draws at the keys
its ``_solve_meta`` uses (``keys = split(fold_in(PRNGKey(seed), s), N)``;
the shared sketch is drawn with ``keys[0]``).

Tolerances: episodes bitwise; ``sgd_solver`` 1e-6 relative L2 (3 gradient
steps summed in another order than XLA); per-task hypergradients 1e-5
relative L2 (the adaptation, an IHVP and a second-order VJP, each in f32);
meta trajectories 1e-4 (two Adam steps on those hypergradients).
"""
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.implicit import implicit_root as jimplicit_root
from repro.core.implicit import sgd_solver as jsgd_solver
from repro.core.problem import solve as jsolve
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.data.synthetic import FewShotSampler as JSampler
from repro.tasks.paper import build_imaml as jbuild_imaml
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import (HypergradConfig, accounted_hvps,
                              implicit_root, sgd_solver, solve)
from repro_torch.core.tree_util import tree_leaves, tree_map
from repro_torch.data import EpisodeSource, FewShotSampler
from repro_torch.kernels import ops
from repro_torch.tasks import build_imaml, build_logreg_weight_decay
from torch_threads import torch_thread_cap  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(width=8, image_size=6)
N_TASKS, K = 3, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x))
                           for x in jax.tree.leaves(tree)])


def _rel(port_tree, ref_tree):
    a = np.concatenate([np.ravel(x) for x in tree_leaves(to_numpy(port_tree))])
    b = _flat(ref_tree)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# --------------------------------------------------------------- episodes
@pytest.mark.parametrize('test', [False, True])
def test_episodes_are_bitwise_the_reference(test):
    ref = JSampler(seed=3, image_size=6, n_classes=40)
    port = FewShotSampler(seed=3, image_size=6, n_classes=40)
    np.testing.assert_array_equal(port.prototypes, ref.prototypes)
    for idx in (0, 5, 11):
        for a, b in zip(port.episode(idx, test=test),
                        ref.episode(idx, test=test)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_task_batch_stacks_episodes_and_refuses_the_flat_stream():
    jp, tp = jbuild_imaml(**TOY), build_imaml(**TOY, device='cpu')
    (sx, sy), (qx, qy) = tp.data.task_batch(2, N_TASKS)
    (jsx, jsy), (jqx, jqy) = jp.data.task_batch(2, N_TASKS)
    assert isinstance(tp.data, EpisodeSource)
    assert sx.shape == (N_TASKS, 5, 6, 6, 1) and qy.shape == (N_TASKS, 25)
    for a, b in ((sx, jsx), (sy, jsy), (qx, jqx), (qy, jqy)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(TypeError, match='vmap_tasks'):
        tp.data.train_batch(0, 8)


def test_sgd_solver_matches_reference():
    jp, tp = jbuild_imaml(**TOY), build_imaml(**TOY, device='cpu')
    meta = _np(jp.init_hparams(jax.random.PRNGKey(0)))
    sx, sy, _, _ = jp.reference['sampler'].episode(1)
    want = jsgd_solver(jp.inner_loss, 3, 0.1)(
        jax.tree.map(jnp.asarray, meta), (sx, sy))
    got = sgd_solver(tp.inner_loss, 3, 0.1)(to_torch(meta),
                                           to_torch(_np((sx, sy))))
    assert _rel(got, want) <= 1e-6
    assert not any(x.requires_grad for x in tree_leaves(got))


# ------------------------------------------- per-task hypergradients
D = torch.tensor([1.0, 2.0, 4.0])


def _quad(theta, phi, batch):
    return 0.5 * torch.sum(D * theta ** 2) - torch.sum(theta * phi)


@pytest.mark.parametrize('config', [
    HypergradConfig(solver='exact', rho=0.0),
    HypergradConfig(k=3, rho=1e-3, backend='cuda'),
])
def test_vmap_grad_on_the_quadratic_is_one_over_d(config):
    """The doctest: θ*(φ) = φ/d, so every task's gradient of Σθ* is 1/d
    (1/(d + ρ) with damping; the full-rank sketch is exact), with a fresh
    state per task and with one shared state."""
    solve_map = implicit_root(lambda phi, batch: phi / D, _quad, config)
    phis = torch.stack([torch.ones(3), 2.0 * torch.ones(3),
                        -torch.ones(3)])
    per_task = vmap(grad(lambda p: solve_map(p, None).sum()))(phis)
    state = solve_map.prepare_state(torch.ones(3) / D, torch.ones(3))
    shared = vmap(grad(lambda p: solve_map(p, None, state=state).sum()))(
        phis)
    for g in (per_task, shared):
        torch.testing.assert_close(g, (1.0 / (D + config.rho)).expand(3, 3),
                                   rtol=0, atol=1e-6)


def _meta_batch(jp, step=0):
    (sx, sy), (qx, qy) = jp.data.task_batch(step, N_TASKS)
    return sx, sy, qx, qy


@functools.lru_cache(maxsize=None)
def _reference_per_task(shared):
    """The reference's per-task hypergradients on the toy meta-batch
    (Nyström k = 4, ρ = 1e-2, 'flat'), its meta-init and its keys."""
    jp = jbuild_imaml(**TOY)
    meta = _np(jp.init_hparams(jax.random.PRNGKey(0)))
    keys = jax.random.split(jax.random.PRNGKey(7), N_TASKS)
    config = JConfig(k=K, rho=1e-2, backend='flat')
    solution = jimplicit_root(jsgd_solver(jp.inner_loss, 10, 0.1),
                              jp.inner_loss, config)
    SX, SY, QX, QY = _meta_batch(jp)
    jmeta = jax.tree.map(jnp.asarray, meta)
    if shared:
        pooled = (SX.reshape((-1,) + SX.shape[2:]), SY.reshape(-1))
        sketch = solution.prepare_state(jmeta, jmeta, pooled, keys[0])

        def task_grad(sx, sy, qx, qy, key):
            return jax.grad(lambda m: jp.outer_loss(
                solution(m, (sx, sy), state=sketch), m, (qx, qy)))(jmeta)
    else:
        def task_grad(sx, sy, qx, qy, key):
            return jax.grad(lambda m: jp.outer_loss(
                solution(m, (sx, sy), rng=key), m, (qx, qy)))(jmeta)
    return _np(jax.vmap(task_grad)(SX, SY, QX, QY, keys)), meta, keys


def _draw(meta, key):
    return _np(JIndexer(jax.tree.map(jnp.asarray, meta)).sample_indices(key,
                                                                         K))


@pytest.mark.parametrize('backend', ['flat', 'cuda'])
@pytest.mark.parametrize('shared', [True, False])
def test_per_task_hypergradients_match_reference(shared, backend):
    jp, tp = jbuild_imaml(**TOY), build_imaml(**TOY, device='cpu')
    want, meta, keys = _reference_per_task(shared)
    solution = implicit_root(sgd_solver(tp.inner_loss, 10, 0.1),
                             tp.inner_loss,
                             HypergradConfig(k=K, rho=1e-2, backend=backend))
    SX, SY, QX, QY = (to_torch(np.asarray(x)) for x in _meta_batch(jp))
    tmeta = to_torch(meta)
    if shared:
        pooled = (SX.reshape((-1,) + SX.shape[2:]), SY.reshape(-1))
        sketch = solution.prepare_state(tmeta, tmeta, pooled,
                                        indices=_draw(meta, keys[0]))

        def task_grad(sx, sy, qx, qy):
            return grad(lambda m: tp.outer_loss(
                solution(m, (sx, sy), state=sketch), m, (qx, qy)))(tmeta)
        got = vmap(task_grad)(SX, SY, QX, QY)
    else:
        draws = [_draw(meta, key) for key in keys]
        idx = {key: torch.stack([torch.tensor(d[key]) for d in draws])
               for key in ('leaf', 'dims')}

        def task_grad(sx, sy, qx, qy, ix):
            return grad(lambda m: tp.outer_loss(
                solution(m, (sx, sy), indices=ix), m, (qx, qy)))(tmeta)
        got = vmap(task_grad)(SX, SY, QX, QY, idx)
    for t in range(N_TASKS):
        assert _rel(tree_map(lambda x: x[t], got),
                    jax.tree.map(lambda x: x[t], want)) <= 1e-5


def test_shared_meta_backward_is_one_block_apply_on_plain_tensors(
        monkeypatch):
    """Under vmap(grad(...)) with a shared sketch, the kernels' entry points
    see plain tensors only (never a functorch wrapper), and the tasks'
    right-hand sides reach them as one (p, N) block: with ``refine=0`` one
    cross and one block apply for the whole meta-batch, and no vector
    apply."""
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            assert not any(torch._C._functorch.is_functorch_wrapped_tensor(a)
                           for a in args if isinstance(a, torch.Tensor))
            calls.append((name, args[-2].ndim if name == 'apply'
                          else args[-1].ndim))
            return fn(*args)
        return wrapped
    monkeypatch.setattr(ops, 'woodbury_ctv', spy('ctv', ops.woodbury_ctv))
    monkeypatch.setattr(ops, 'woodbury_apply',
                        spy('apply', ops.woodbury_apply))
    tp = build_imaml(**TOY, device='cpu')
    meta = tp.init_hparams(torch.Generator().manual_seed(0))
    solution = implicit_root(sgd_solver(tp.inner_loss, 3, 0.1),
                             tp.inner_loss,
                             HypergradConfig(k=K, backend='cuda', refine=0))
    (SX, SY), (QX, QY) = tp.data.task_batch(0, N_TASKS)
    sketch = solution.prepare_state(
        meta, meta, (SX.reshape(-1, 6, 6, 1), SY.reshape(-1)))
    calls.clear()
    vmap(lambda sx, sy, qx, qy: grad(lambda m: tp.outer_loss(
        solution(m, (sx, sy), state=sketch), m, (qx, qy)))(meta))(
        SX, SY, QX, QY)
    assert calls == [('ctv', 2), ('apply', 2)]


# ------------------------------------------------------ the meta path
@pytest.mark.parametrize('shared', [True, False])
def test_two_meta_steps_match_reference(shared):
    jp, tp = jbuild_imaml(**TOY), build_imaml(**TOY, device='cpu')
    config = dict(k=K, rho=1e-2)
    ref = jsolve(jp, JConfig(**config, backend='flat'), n_outer=2,
                 vmap_tasks=N_TASKS, shared_sketch=shared, seed=0)
    rng = jax.random.PRNGKey(0)
    meta0 = _np(jp.init_hparams(rng))
    draws = []
    for s in range(2):
        keys = jax.random.split(jax.random.fold_in(rng, s), N_TASKS)
        draws += [_draw(meta0, key) for key in keys[:1 if shared else None]]
    got = solve(tp, HypergradConfig(**config, backend='cuda'), n_outer=2,
                vmap_tasks=N_TASKS, shared_sketch=shared,
                hparams=to_torch(meta0), index_draws=draws, device='cpu')
    assert got.params is None and got.hvp_count == ref.hvp_count
    np.testing.assert_allclose(got.history['outer_loss'],
                               ref.history['outer_loss'], rtol=1e-4)
    assert _rel(got.hparams, ref.hparams) <= 1e-4


@pytest.mark.parametrize('solver,shared,want', [
    (HypergradConfig(k=4), True, 2 * 4),
    (HypergradConfig(k=4), False, 2 * 3 * 4),
    (HypergradConfig(solver='cg', k=5, rho=0.0), False, 2 * 3 * 5),
])
def test_accounted_hvps_on_the_meta_path(solver, shared, want):
    problem = build_imaml(**TOY, device='cpu')
    built = solver.build()
    assert accounted_hvps(built, problem, 2, vmap_tasks=3,
                          shared_sketch=shared) == want
    if isinstance(built, type(HypergradConfig(k=4).build())):
        assert accounted_hvps(built, problem, 2) == 2 * 4


@pytest.mark.parametrize('case', ['flat_stream', 'no_task_batch',
                                  'shared_iterative', 'oracle_error'])
def test_meta_path_refusals(case):
    imaml = build_imaml(**TOY, device='cpu')
    kwargs = dict(n_outer=1, device='cpu')
    if case == 'flat_stream':
        problem, config, err, match = (imaml, HypergradConfig(k=4),
                                       TypeError, 'vmap_tasks')
    elif case == 'no_task_batch':
        problem = build_logreg_weight_decay(D=5, n=8, device='cpu')
        config, err, match = HypergradConfig(k=4), TypeError, 'task_batch'
        kwargs['vmap_tasks'] = 2
    elif case == 'shared_iterative':
        problem, config = imaml, HypergradConfig(solver='cg', k=4, rho=0.0)
        err, match = TypeError, 'amortizable'
        kwargs.update(vmap_tasks=2, shared_sketch=True)
    else:
        problem, config = imaml, HypergradConfig(k=4)
        err, match = ValueError, 'with_hypergrad_error'
        kwargs.update(vmap_tasks=2, with_hypergrad_error=True)
    with pytest.raises(err, match=match):
        solve(problem, config, **kwargs)


# --------------------------------------------------------------- examples
@pytest.mark.parametrize('script,args', [
    ('quickstart_torch.py', ['--outer-steps', '2', '--inner-steps', '10',
                             '--dim', '10', '--legacy-check']),
    ('imaml_fewshot_torch.py', ['--episodes', '4', '--meta-batch', '2',
                                '--width', '8', '--image-size', '6',
                                '--n-eval', '2', '--shared-sketch']),
])
def test_example_runs_on_the_cpu(script, args):
    out = subprocess.run(
        [sys.executable, str(ROOT / 'examples' / script), '--device', 'cpu',
         *args], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()
    if script.startswith('quickstart'):
        assert 'hypergradient() max deviation: 0.00e+00' in out.stdout
        assert last[-1].startswith('final validation loss:')
    else:
        assert [line.split(':')[0] for line in last] == ['nystrom', 'cg',
                                                        'neumann']
