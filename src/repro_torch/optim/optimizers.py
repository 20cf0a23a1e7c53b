"""Gradient-transform optimizers over parameter trees.

The reference's design: an ``Optimizer`` is an (init, update) pair over
trees and ``chain`` composes transforms. ``update(grads, state, params,
step)`` returns parameter *deltas*. Ported: ``sgd``, ``momentum``,
``adam``, ``adamw``, ``adafactor``, ``clip_by_global_norm``, ``chain``,
``scale_by_schedule`` and the cosine schedules, with the reference's
formulas; Adafactor's decay and the schedules are computed in f32, as the
reference computes them from its int32 step.

``stacked_blocks`` runs an optimizer on the reference's stacked layout of
a transformer tree: Adafactor factors and clips each leaf as a whole, and
the reference's leaves carry every block (``scan_layers``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, int], tuple[PyTree, PyTree]]

    def apply(self, grads: PyTree, state: PyTree, params: PyTree,
              step: int) -> tuple[PyTree, PyTree]:
        updates, state = self.update(grads, state, params, step)
        params = tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
        return params, state


def sgd(lr) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        lr_t = lr(step) if callable(lr) else lr
        return tree_map(lambda g: -lr_t * g, grads), state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, m, params, step):
        lr_t = lr(step) if callable(lr) else lr
        m = tree_map(lambda mi, g: beta * mi + g, m, grads)
        if nesterov:
            upd = tree_map(lambda mi, g: -lr_t * (beta * mi + g), m, grads)
        else:
            upd = tree_map(lambda mi: -lr_t * mi, m)
        return upd, m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: PyTree
    nu: PyTree


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    def init(params):
        return AdamState(
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params),
            nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params))

    def update(grads, state, params, step):
        lr_t = lr(step) if callable(lr) else lr
        count = float(step) + 1.0
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        upd = tree_map(lambda m, v: -lr_t * (m / bc1)
                       / (torch.sqrt(v / bc2) + eps), mu, nu)
        return upd, AdamState(mu, nu)

    return Optimizer(init, update)


def _lr(lr, step):
    return lr(step) if callable(lr) else lr


def _f32(step) -> torch.Tensor:
    """The step as an f32 scalar on the host."""
    return torch.as_tensor(step, dtype=torch.float32).detach().cpu()


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam plus decoupled weight decay: −lr·wd·θ added to each delta."""
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params, step):
        lr_t = _lr(lr, step)
        upd, state = base.update(grads, state, params, step)
        upd = tree_map(lambda u, p: u - lr_t * weight_decay * p.float(),
                       upd, params)
        return upd, state

    return Optimizer(base.init, update)


class AdafactorState(NamedTuple):
    vr: PyTree    # factored second moment: row accumulator
    vc: PyTree    # column accumulator (a scalar for leaves of rank < 2)


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Adafactor (Shazeer & Stern) without momentum: O(rows + cols) second
    moment per leaf, then each leaf's update clipped to RMS ≤
    ``clip_threshold`` and scaled by −lr. Factoring and clipping are per
    leaf, so the tree's layout matters: see :func:`stacked_blocks`."""
    def init(params):
        def rows(p):
            shape = p.shape if p.ndim < 2 else p.shape[:-1]
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def cols(p):
            shape = () if p.ndim < 2 else p.shape[:-2] + p.shape[-1:]
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(vr=tree_map(rows, params),
                              vc=tree_map(cols, params))

    def update(grads, state, params, step):
        lr_t = _lr(lr, step)
        beta = 1.0 - (_f32(step) + 1.0) ** -decay

        def upd(g, vr, vc):
            b = beta.to(g.device)
            g = g.float()
            g2 = g * g + eps
            if g.ndim < 2:
                vr_new = b * vr + (1 - b) * g2
                return g * torch.rsqrt(vr_new + eps), vr_new, vc
            vr_new = b * vr + (1 - b) * g2.mean(-1)
            vc_new = b * vc + (1 - b) * g2.mean(-2)
            r = vr_new / torch.clamp(vr_new.mean(-1, keepdim=True), min=eps)
            u = (g * torch.rsqrt(r[..., None] + eps)
                 * torch.rsqrt(vc_new[..., None, :] + eps)
                 * torch.sqrt(torch.clamp(vc_new.mean(-1, keepdim=True),
                                          min=eps))[..., None])
            return u, vr_new, vc_new

        flat_g, treedef = tree_flatten(grads)
        outs = [upd(g, vr, vc) for g, vr, vc in zip(
            flat_g, tree_leaves(state.vr), tree_leaves(state.vc))]
        upds, vr, vc = (treedef.unflatten([o[i] for o in outs])
                        for i in range(3))

        def clip_scale(u):
            rms = torch.sqrt(torch.mean(u * u) + eps)
            return -lr_t * u / torch.clamp(rms / clip_threshold, min=1.0)

        return tree_map(clip_scale, upds), AdafactorState(vr, vc)

    return Optimizer(init, update)


def stacked_blocks(base: Optimizer) -> Optimizer:
    """``base`` on the reference's stacked layout of a transformer tree.

    The port keeps ``params['blocks']`` as a list of block dicts; the
    reference with ``scan_layers`` stacks them into one dict whose leaves
    lead with an ``n_blocks`` axis. A per-leaf rule (Adafactor's factored
    moments and update clip) sees every block at once there, so this
    wrapper stacks grads and params before ``base`` and splits the deltas
    after; ``base``'s state lives in the stacked layout. Element-wise
    optimizers and global-norm clipping give the same numbers either way
    and need no wrapper."""
    def stack(tree):
        out = dict(tree)
        out['blocks'] = tree_map(lambda *xs: torch.stack(xs),
                                 *tree['blocks'])
        return out

    def unstack(tree, n):
        out = dict(tree)
        out['blocks'] = [tree_map(lambda x, i=i: x[i], tree['blocks'])
                         for i in range(n)]
        return out

    def init(params):
        return base.init(stack(params))

    def update(grads, state, params, step):
        upd, state = base.update(stack(grads), state, stack(params), step)
        return unstack(upd, len(params['blocks'])), state

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float,
                        sq_norm: Callable | None = None) -> Optimizer:
    """Rescale grads to global norm ≤ max_norm. ``sq_norm``: grads → the
    squared global norm (default the sum over leaves; a split model's sums
    its blocks over the mesh)."""
    def init(params):
        return ()

    def update(grads, state, params, step):
        sq = (sq_norm(grads) if sq_norm is not None else
              sum(torch.sum(torch.square(g.float()))
                  for g in tree_leaves(grads)))
        scale = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-12), max=1.0)
        return tree_map(lambda g: g * scale, grads), state

    return Optimizer(init, update)


def chain(*stages: Optimizer) -> Optimizer:
    """Compose gradient transforms left to right; the last maps grads to
    parameter deltas."""
    def init(params):
        return tuple(s.init(params) for s in stages)

    def update(grads, states, params, step):
        new_states = []
        for s, st in zip(stages, states):
            grads, st = s.update(grads, st, params, step)
            new_states.append(st)
        return grads, tuple(new_states)

    return Optimizer(init, update)


def scale_by_schedule(base: Optimizer, schedule: Callable) -> Optimizer:
    """``base``'s deltas times ``schedule(step)``."""
    def update(grads, state, params, step):
        upd, state = base.update(grads, state, params, step)
        s = schedule(step)
        return tree_map(lambda u: u * s, upd), state

    return Optimizer(base.init, update)


def cosine_schedule(base_lr: float, total_steps: int,
                    min_ratio: float = 0.1) -> Callable:
    """base_lr · (min_ratio + (1 − min_ratio)·½(1 + cos(π·min(step/T, 1)))),
    an f32 scalar tensor."""
    def sched(step):
        frac = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        return base_lr * (min_ratio + (1 - min_ratio) * 0.5
                          * (1 + torch.cos(torch.pi * frac)))
    return sched


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, min_ratio: float = 0.1
                           ) -> Callable:
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then
    :func:`cosine_schedule` over the remaining steps."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          min_ratio)

    def sched(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))
    return sched
