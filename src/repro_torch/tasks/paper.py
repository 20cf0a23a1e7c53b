"""The paper's experiment tasks as registered problems (ported so far:
``logreg_wd``, §5.1, and ``reweighting``, §5.4).

Models use leaky-ReLU as §5 prescribes. Nonlinearities whose derivative
has a kink are written with the reference's conventions at the kink (JAX
takes the x ≥ 0 branch for ``abs`` and ``leaky_relu`` at exactly 0; torch's
built-ins take the other), so gradients agree even where an input is
exactly 0 — which ``logreg_wd`` hits on every first step, from w = 0.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.problem import BilevelProblem, register_problem
from repro_torch.data.sources import ArraySource
from repro_torch.data.synthetic import LongTailDataset, make_logreg_problem
from repro_torch.device import resolve_device


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
