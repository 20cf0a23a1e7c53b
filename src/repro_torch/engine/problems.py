"""Registered multi-level problems + the GRAPHS registry (the reference's
``repro/engine/problems.py``, same signatures, node settings and losses).

Two trilevel chains, both toy-scale by construction (the dense oracle
materializes every solved node's Hessian):

* ``distill_hpo`` — dataset distillation under hyperparameter optimization.
  Bottom: a ridge-regression student trained on the synthetic set with a
  learned weight decay (quadratic in the weights, so the bottom Hessian is
  PSD by construction). Middle: the synthetic inputs+targets, tuned so the
  student fits real training data (plus a proximal regularizer that keeps
  the level strongly convex around its solutions). Top: the log weight
  decay, tuned on a validation split — the smallest graph where a sketch's
  build HVPs themselves differentiate through a lower implicit map.

* ``reweight_maml`` — example reweighting over meta-learning. Bottom:
  per-task adapted parameters (proximal to the meta-init, the iMAML inner
  problem, vmapped over a stacked task axis inside the loss). Middle: the
  meta-initialization, trained on softmax-reweighted per-task query losses
  (one task's queries are label-corrupted). Top: the task logits ω, tuned
  so the meta-init does well on clean held-out queries.

Both register under ``GRAPHS`` and run via ``launch/train.py --problem``.
The reference draws its data and inits with ``jax.random``; here the data
come from ``numpy.random.RandomState(seed)`` unless ``data=`` hands them in
(the parity tests pass the reference's arrays), and the inits from the
``torch.Generator`` the engine passes (``Engine.solve(values=)`` replaces
them). Builders run on the card unless ``device='cpu'``.

Oracle-parity expectations differ by construction, as in the reference:
``reweight_maml``'s solved levels are quadratic in their own variables, so
the AID rules are exact there; ``distill_hpo``'s middle level is
non-quadratic, and under the AID convention (the rules freeze their
linearization point, so second derivatives drop ∂M/∂θ·θ̇ terms) the upper
level's Hessian estimator picks up a small non-symmetric part that
different solvers resolve differently.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.device import resolve_device
from repro_torch.engine.graph import ProblemEdge, ProblemGraph, ProblemNode

GRAPHS: dict[str, Callable[..., ProblemGraph]] = {}


def register_graph(name: str):
    """Decorator: register a graph builder under ``name`` (the
    ``launch/train.py --problem`` / ``get_graph`` key)."""
    def wrap(builder):
        GRAPHS[name] = builder
        return builder
    return wrap


def get_graph(name: str, **kwargs) -> ProblemGraph:
    """Build a registered problem graph by name (kwargs go to the builder).
    Raises ``ValueError`` naming the known graphs on a miss."""
    try:
        builder = GRAPHS[name]
    except KeyError:
        raise ValueError(f'unknown graph {name!r}; registered: '
                         f'{sorted(GRAPHS)}') from None
    return builder(**kwargs)


def _mse(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Half mean squared error over rows, summed across output channels
    (f32 accumulation)."""
    err = pred.float() - targets.float()
    return 0.5 * torch.mean(torch.sum(torch.square(err), dim=-1))


def _arrays(data: dict, device) -> dict:
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in data.items()}


def _placed(x: torch.Tensor, device) -> torch.Tensor:
    """An init's tensor on the graph's device (left on ``meta``, where the
    bills read shapes)."""
    return x if x.is_meta else x.to(device)


def _randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen)


def _cfg(solver: str, k: int, rho: float) -> HypergradConfig:
    if solver == 'exact':
        return HypergradConfig(solver='exact', rho=rho)
    return HypergradConfig(solver=solver, k=k, rho=rho)


# ---------------------------------------------------------------------------
# distill_hpo — student <- images <- hpo
# ---------------------------------------------------------------------------
def distill_hpo_data(d: int = 6, n_classes: int = 3, n_train: int = 64,
                     n_val: int = 64, seed: int = 0) -> dict:
    """The real splits ``distill_hpo`` fits and validates on: class means
    2·N(0, I), labels uniform, inputs mean + N(0, I), one-hot targets."""
    rs = np.random.RandomState(seed)
    mu = 2.0 * rs.randn(n_classes, d)

    def sample(n):
        y = rs.randint(0, n_classes, n)
        return mu[y] + rs.randn(n, d), np.eye(n_classes)[y]

    x_tr, y_tr = sample(n_train)
    x_val, y_val = sample(n_val)
    return {'x_tr': x_tr, 'y_tr': y_tr, 'x_val': x_val, 'y_val': y_val}


@register_graph('distill_hpo')
def distill_hpo(d: int = 6, n_classes: int = 3, n_syn: int = 8,
                n_train: int = 64, n_val: int = 64, seed: int = 0,
                mu_images: float = 0.5, k_student: int | None = None,
                k_images: int | None = None, rho: float = 1e-4,
                refresh_every: int = 1, solver: str = 'nystrom', *,
                data: dict | None = None, device: Any = None
                ) -> ProblemGraph:
    """Trilevel dataset distillation + weight-decay HPO (see module doc).

    Node sizes: student p = d·C + C, images p = n_syn·(d + C), hpo p = 1.
    ``k_student``/``k_images`` set the per-edge Nyström ranks — the default
    is full rank. ``mu_images`` is the middle level's proximal weight.
    ``solver='exact'`` swaps both edges to dense solves. ``data``: the
    ``x_tr``, ``y_tr``, ``x_val``, ``y_val`` arrays (default
    :func:`distill_hpo_data`)."""
    device = resolve_device(device)
    if data is None:
        data = distill_hpo_data(d, n_classes, n_train, n_val, seed)
    t = _arrays(data, device)
    x_tr, y_tr, x_val, y_val = t['x_tr'], t['y_tr'], t['x_val'], t['y_val']

    def student_loss(w, ctx, batch):
        del batch
        syn = ctx['images']
        wd = torch.exp(ctx['hpo']['log_wd'])
        sq = torch.sum(torch.square(w['W'].float())) + torch.sum(
            torch.square(w['b'].float()))
        return _mse(syn['x'] @ w['W'] + w['b'], syn['y']) + 0.5 * wd * sq

    def images_loss(syn, ctx, batch):
        del batch
        w = ctx['student']
        fit = _mse(x_tr @ w['W'] + w['b'], y_tr)
        # per-coordinate proximal pull: μ·I dominates the fit term's small
        # negative curvature, keeping the level strongly convex wherever the
        # unroll linearizes (the Nyström whitening needs PSD curvature)
        prox = 0.5 * mu_images * (torch.sum(torch.square(syn['x']))
                                  + torch.sum(torch.square(syn['y'])))
        return fit + prox

    def hpo_loss(h, ctx, batch):
        del batch
        w = ctx['student']
        return (_mse(x_val @ w['W'] + w['b'], y_val)
                + 1e-2 * torch.square(h['log_wd']))

    def init_student(rng):
        return {'W': _placed(0.1 * _randn(rng, d, n_classes), device),
                'b': _placed(torch.zeros(n_classes), device)}

    def init_images(rng):
        # targets near a balanced one-hot assignment so the student has
        # signal from step 0
        y0 = torch.eye(n_classes)[torch.arange(n_syn) % n_classes]
        return {'x': _placed(_randn(rng, n_syn, d), device),
                'y': _placed(y0 + 0.1 * _randn(rng, n_syn, n_classes),
                             device)}

    def init_hpo(rng):
        del rng
        return {'log_wd': _placed(torch.tensor(-1.0), device)}

    p_student = d * n_classes + n_classes
    p_images = n_syn * (d + n_classes)
    return ProblemGraph(
        nodes={
            'student': ProblemNode('student', student_loss, init_student,
                                   unroll_steps=80, unroll_lr=0.3),
            'images': ProblemNode('images', images_loss, init_images,
                                  unroll_steps=60, unroll_lr=0.3),
            'hpo': ProblemNode('hpo', hpo_loss, init_hpo),
        },
        edges=[
            ProblemEdge('student', 'images',
                        config=_cfg(solver, k_student or p_student, rho),
                        refresh_every=refresh_every),
            ProblemEdge('images', 'hpo',
                        config=_cfg(solver, k_images or p_images, rho),
                        refresh_every=refresh_every),
        ])


# ---------------------------------------------------------------------------
# reweight_maml — adapted <- meta <- weights
# ---------------------------------------------------------------------------
def reweight_maml_data(d: int = 8, n_tasks: int = 3, n_support: int = 16,
                       n_query: int = 16, corrupt: float = 2.0,
                       seed: int = 0) -> dict:
    """The tasks ``reweight_maml`` adapts to: per-task linear truths, support
    and query sets with 0.1 noise, task 0's reweighting queries corrupted
    by ``corrupt``-scaled noise, and a clean held-out query split."""
    rs = np.random.RandomState(seed)
    a_true = rs.randn(n_tasks, d)
    xs = rs.randn(n_tasks, n_support, d)
    xq = rs.randn(n_tasks, n_query, d)
    xc = rs.randn(n_tasks, n_query, d)
    ys = (np.einsum('tnd,td->tn', xs, a_true)
          + 0.1 * rs.randn(n_tasks, n_support))
    yq = np.einsum('tnd,td->tn', xq, a_true) + 0.1 * rs.randn(n_tasks, n_query)
    yq[0] += corrupt * rs.randn(n_query)
    yclean = np.einsum('tnd,td->tn', xc, a_true)
    return {'xs': xs, 'ys': ys, 'xq': xq, 'yq': yq, 'xc': xc,
            'yclean': yclean}


def _task_mse(a, x, y):
    """Per-task half MSE over the stacked task axis: a (T, d), x (T, n, d),
    y (T, n) → (T,) (the reference vmaps the one-task form)."""
    pred = torch.matmul(x, a[..., None])[..., 0]
    return 0.5 * torch.mean(torch.square(pred - y), dim=-1)


@register_graph('reweight_maml')
def reweight_maml(d: int = 8, n_tasks: int = 3, n_support: int = 16,
                  n_query: int = 16, prox: float = 1.0, corrupt: float = 2.0,
                  seed: int = 0, k_adapted: int | None = None,
                  k_meta: int | None = None,
                  rho: float = 1e-4, refresh_every: int = 1,
                  solver: str = 'nystrom', *, data: dict | None = None,
                  device: Any = None) -> ProblemGraph:
    """Trilevel task reweighting over proximal meta-learning (see module
    doc). The adapted node stacks all tasks on a leading (T, d) axis and
    takes the per-task residuals over it inside its loss. ``data``: the ``xs``,
    ``ys``, ``xq``, ``yq``, ``xc``, ``yclean`` arrays (default
    :func:`reweight_maml_data`)."""
    device = resolve_device(device)
    if data is None:
        data = reweight_maml_data(d, n_tasks, n_support, n_query, corrupt,
                                  seed)
    t = _arrays(data, device)
    xs, ys, xq, yq, xc, yclean = (t[k] for k in ('xs', 'ys', 'xq', 'yq',
                                                 'xc', 'yclean'))
    def adapted_loss(a, ctx, batch):
        del batch
        theta0 = ctx['meta']['theta0']
        fit = _task_mse(a['a'], xs, ys)
        prox_term = 0.5 * prox * torch.mean(
            torch.sum(torch.square(a['a'] - theta0[None, :]), dim=-1))
        return torch.sum(fit) / n_tasks + prox_term

    def meta_loss(m, ctx, batch):
        del batch
        a = ctx['adapted']['a']
        w = torch.softmax(ctx['weights']['omega'], dim=-1)
        q = _task_mse(a, xq, yq)
        return torch.sum(w * q) + 5e-2 * torch.sum(torch.square(m['theta0']))

    def weights_loss(o, ctx, batch):
        del batch
        a = ctx['adapted']['a']
        clean = torch.mean(_task_mse(a, xc, yclean))
        return clean + 5e-2 * torch.sum(torch.square(o['omega']))

    def init_adapted(rng):
        return {'a': _placed(0.1 * _randn(rng, n_tasks, d), device)}

    def init_meta(rng):
        return {'theta0': _placed(0.1 * _randn(rng, d), device)}

    def init_weights(rng):
        del rng
        return {'omega': _placed(torch.zeros(n_tasks), device)}

    return ProblemGraph(
        nodes={
            'adapted': ProblemNode('adapted', adapted_loss, init_adapted,
                                   unroll_steps=40, unroll_lr=0.5),
            'meta': ProblemNode('meta', meta_loss, init_meta,
                                unroll_steps=40, unroll_lr=0.3),
            'weights': ProblemNode('weights', weights_loss, init_weights),
        },
        edges=[
            ProblemEdge('adapted', 'meta',
                        config=_cfg(solver, k_adapted or n_tasks * d, rho),
                        refresh_every=refresh_every),
            ProblemEdge('meta', 'weights', config=_cfg(solver, k_meta or d,
                                                       rho),
                        refresh_every=refresh_every),
        ])
