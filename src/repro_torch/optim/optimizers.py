"""Gradient-transform optimizers over parameter trees.

The reference's design: an ``Optimizer`` is an (init, update) pair over
trees and ``chain`` composes transforms. ``update(grads, state, params,
step)`` returns parameter *deltas*. Only what the paper tasks' defaults use
is ported: ``sgd``, ``momentum``, ``adam``, ``clip_by_global_norm`` and
``chain``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree_util import tree_leaves, tree_map

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


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Rescale grads to global norm ≤ max_norm."""
    def init(params):
        return ()

    def update(grads, state, params, step):
        sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
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
