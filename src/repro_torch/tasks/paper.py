"""The paper's experiment tasks as registered problems: ``logreg_wd``
(§5.1), ``distillation`` (§5.2), ``imaml`` (§5.3, a meta-problem driven by
``solve(..., vmap_tasks=N)``), ``reweighting`` (§5.4), and ``influence``,
an :class:`~repro_torch.core.problem.InfluenceProblem` on reweighting's
data, driven by :func:`~repro_torch.core.problem.influence`.

Models use leaky-ReLU as §5 prescribes. Nonlinearities whose derivative
has a kink are written with the reference's conventions at the kink (JAX
takes the x ≥ 0 branch for ``abs`` and ``leaky_relu`` at exactly 0; torch's
built-ins take the other), so gradients agree even where an input is
exactly 0 — which ``logreg_wd`` hits on every first step, from w = 0.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.func import grad

from repro_torch.core.problem import (BilevelProblem, InfluenceProblem,
                                      register_problem)
from repro_torch.data.sources import ArraySource, EpisodeSource
from repro_torch.data.synthetic import (DistillationTask, FewShotSampler,
                                        LongTailDataset, make_logreg_problem)
from repro_torch.device import resolve_device
from repro_torch.optim import sgd


def act(x: torch.Tensor) -> torch.Tensor:
    """leaky-ReLU(0.01), slope 1 at 0 (``jax.nn.leaky_relu``)."""
    return torch.where(x >= 0, x, 0.01 * x)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with derivative +1 at 0 (``jnp.abs``)."""
    return torch.where(x >= 0, x, -x)


# --------------------------------------------------------------- tiny MLP
def mlp_init(rng: torch.Generator, sizes, device: Any = 'cpu') -> list:
    """He-normal weights, zero biases; drawn on the CPU from ``rng`` and
    moved to ``device``, so a seed gives the same weights on every device."""
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=rng) * (2.0 / a) ** 0.5
        params.append({'w': w.to(device),
                       'b': torch.zeros((b,), device=device)})
    return params


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    h = x.reshape(x.shape[0], -1)
    for i, layer in enumerate(params):
        h = h @ layer['w'] + layer['b']
        if i < len(params) - 1:
            h = act(h)
    return h


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.gather(torch.log_softmax(logits, -1), 1,
                                    labels[:, None]))


def _plain_xent_loss(params, batch):
    X, y = batch
    return _xent(mlp_apply(params, X), y)


def _bce(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                      - logit * y + torch.log1p(torch.exp(-_abs(logit))))


# ----------------------------------------------------------------- §5.1
@register_problem('logreg_wd')
def build_logreg_weight_decay(D: int = 100, n: int = 500, seed: int = 0,
                              device: Any = None) -> BilevelProblem:
    """Per-parameter weight decay for logistic regression (Fig. 2/3)."""
    device = resolve_device(device)
    (Xt, yt), (Xv, yv) = make_logreg_problem(D, n, seed, device=device)

    def inner(params, hparams, batch):
        X, y = batch
        return (_bce(X @ params['w'], y)
                + torch.sum(_abs(hparams['wd']) * params['w'] ** 2))

    def outer(params, hparams, batch):
        X, y = batch
        return _bce(X @ params['w'], y)

    return BilevelProblem(
        name='logreg_wd', inner_loss=inner, outer_loss=outer,
        init_params=lambda rng: {'w': torch.zeros((D,), device=device)},
        init_hparams=lambda rng: {'wd': torch.ones((D,), device=device)},
        data=ArraySource(train=(Xt, yt), val=(Xv, yv)), device=device,
        defaults=dict(inner_lr=0.1, outer_lr=0.1, outer_opt='sgd_momentum',
                      steps_per_outer=100, batch_size=500, reset_inner=True))


# ----------------------------------------------------------------- §5.2
@register_problem('distillation')
def build_distillation(n_per_class: int = 5, seed: int = 0, width: int = 64,
                       image_size: int = 28,
                       device: Any = None) -> BilevelProblem:
    """Dataset distillation (Tab. 2): φ is C = 10·``n_per_class`` synthetic
    images with fixed labels; the inner problem trains an MLP
    s²→``width``→10 on them alone (p = 50,890 at the defaults), the outer
    loss scores it on real training batches."""
    device = resolve_device(device)
    task = DistillationTask(seed=seed, image_size=image_size, device=device)
    C = task.n_classes * n_per_class
    s = task.image_size
    Xt, yt = task.train()
    Xs, ys = task.test()
    distill_labels = torch.arange(task.n_classes,
                                  device=device).repeat(n_per_class)
    sizes = (s * s, width, task.n_classes)

    def inner(params, hparams, batch):
        return _xent(mlp_apply(params, hparams['images']), distill_labels)

    def outer(params, hparams, batch):
        X, y = batch
        return _xent(mlp_apply(params, X), y)

    def accuracy(params, hparams):
        pred = mlp_apply(params, Xs).argmax(-1)
        return float((pred == ys).float().mean())

    def distilled_accuracy(params, hparams, init=None):
        """Tab. 2's score: a fresh model trained 100 SGD steps (lr 0.01) on
        the distilled images alone, scored on the test set. Its weights
        come from ``torch.Generator().manual_seed(7)`` or are ``init``."""
        prm = (mlp_init(torch.Generator().manual_seed(7), sizes, device)
               if init is None else init)
        opt = sgd(0.01)
        st = opt.init(prm)
        for i in range(100):
            g = grad(inner)(prm, hparams, None)
            prm, st = opt.apply(g, st, prm, i)
        return accuracy(prm, hparams)

    return BilevelProblem(
        name='distillation', inner_loss=inner, outer_loss=outer,
        init_params=lambda rng: mlp_init(rng, sizes, device),
        init_hparams=lambda rng: {'images': torch.zeros((C, s, s, 1),
                                                        device=device)},
        data=ArraySource(train=(Xt, yt), val=(Xt, yt)), device=device,
        metrics={'accuracy': accuracy,
                 'distilled_accuracy': distilled_accuracy},
        baseline_loss=_plain_xent_loss,
        reference={'distill_labels': distill_labels, 'dataset': task},
        defaults=dict(inner_lr=0.01, outer_lr=1e-3, steps_per_outer=100,
                      batch_size=256, reset_inner=True))


# ----------------------------------------------------------------- §5.3
@register_problem('imaml')
def build_imaml(n_way: int = 5, k_shot: int = 1, seed: int = 0,
                reg: float = 1.0, width: int = 64, image_size: int = 20,
                device: Any = None) -> BilevelProblem:
    """iMAML (Tab. 3): the inner problem adapts to a task under a proximal
    term to the meta-initialization, the outer moves the initialization.
    A meta-problem: drive it through ``solve(..., vmap_tasks=N)`` (its
    ``EpisodeSource`` has no flat stream). The default MLP
    400→64→64→5 has p = 30,149."""
    device = resolve_device(device)
    sampler = FewShotSampler(n_way=n_way, k_shot=k_shot, seed=seed,
                             image_size=image_size, device=device)
    s = sampler.image_size
    sizes = (s * s, width, width, n_way)

    def inner(params, hparams, batch):
        sx, sy = batch
        prox = sum(torch.sum((p['w'] - h['w']) ** 2)
                   + torch.sum((p['b'] - h['b']) ** 2)
                   for p, h in zip(params, hparams))
        return _xent(mlp_apply(params, sx), sy) + 0.5 * reg * prox

    def outer(params, hparams, batch):
        qx, qy = batch
        return _xent(mlp_apply(params, qx), qy)

    return BilevelProblem(
        name='imaml', inner_loss=inner, outer_loss=outer,
        init_params=lambda rng: mlp_init(rng, sizes, device),
        init_hparams=lambda rng: mlp_init(rng, sizes, device),
        data=EpisodeSource(sampler), device=device,
        reference={'sampler': sampler},
        defaults=dict(inner_lr=0.1, outer_lr=1e-3, steps_per_outer=10))


# ----------------------------------------------------------------- §5.4
@register_problem('reweighting')
def build_reweighting(imbalance: int = 100, seed: int = 0, d: int = 64,
                      width: int = 128, device: Any = None) -> BilevelProblem:
    """Data reweighting (Tab. 4/5/6): μ_φ maps per-example loss → weight.
    The default MLP 64→128→128→10 has p = 26,122 parameters."""
    device = resolve_device(device)
    data = LongTailDataset(imbalance_factor=imbalance, seed=seed, d=d,
                           device=device)
    sizes = (d, width, width, data.n_classes)

    def weight_net(hparams, losses):
        h = act(losses[:, None] @ hparams['w1'] + hparams['b1'])
        return torch.sigmoid(h @ hparams['w2'] + hparams['b2'])[:, 0]

    def inner(params, hparams, batch):
        X, y = batch
        logits = mlp_apply(params, X)
        per = -torch.gather(torch.log_softmax(logits, -1), 1, y[:, None])[:, 0]
        w = weight_net(hparams, per.detach())
        return torch.mean(per * w)

    def outer(params, hparams, batch):
        X, y = batch
        return _xent(mlp_apply(params, X), y)

    def init_hparams(rng):
        w1 = torch.randn((1, 100), generator=rng) * 0.1
        w2 = torch.randn((100, 1), generator=rng) * 0.1
        return {'w1': w1.to(device), 'b1': torch.zeros((100,), device=device),
                'w2': w2.to(device), 'b2': torch.zeros((1,), device=device)}

    def accuracy(params, hparams):
        pred = mlp_apply(params, data.Xv).argmax(-1)
        return float((pred == data.yv).float().mean())

    return BilevelProblem(
        name='reweighting', inner_loss=inner, outer_loss=outer,
        init_params=lambda rng: mlp_init(rng, sizes, device),
        init_hparams=init_hparams,
        data=ArraySource(train=(data.X, data.y), val=(data.Xv, data.yv)),
        device=device, metrics={'accuracy': accuracy},
        baseline_loss=_plain_xent_loss, reference={'dataset': data},
        defaults=dict(inner_lr=0.1, inner_momentum=0.9, outer_lr=1e-3,
                      steps_per_outer=20, batch_size=128))


# -------------------------------------------------- influence functions
@register_problem('influence')
def build_influence(imbalance: int = 100, seed: int = 0, d: int = 64,
                    width: int = 128, device: Any = None) -> InfluenceProblem:
    """Influence queries over the long-tail data of ``reweighting``: the
    same MLP (64→128→128→10, p = 26,122 at the defaults) trained on the
    plain cross-entropy; ``reference['queries'](m)`` is the first m
    validation examples, the natural query pool."""
    device = resolve_device(device)
    data = LongTailDataset(imbalance_factor=imbalance, seed=seed, d=d,
                           device=device)
    sizes = (d, width, width, data.n_classes)

    def queries(m: int):
        return data.Xv[:m], data.yv[:m]

    return InfluenceProblem(
        name='influence', loss=_plain_xent_loss,
        init_params=lambda rng: mlp_init(rng, sizes, device),
        data=ArraySource(train=(data.X, data.y), val=(data.Xv, data.yv)),
        device=device,
        defaults=dict(inner_lr=0.1, batch_size=128, train_steps=200),
        reference={'dataset': data, 'queries': queries})
