"""Batch sources: the data half of a
:class:`~repro_torch.core.problem.BilevelProblem`.

``train_batch(step, batch_size)`` / ``val_batch(step, batch_size)`` are pure
functions of (seed, step): train draws use key ``seed + step``, val draws
``seed + VAL_KEY_OFFSET + step``, the reference's key schedule.
:class:`ArraySource` also streams its training split in order
(``n_train`` / ``train_slice``, the influence sweep's protocol);
:class:`EpisodeSource` serves meta-problems, which have no flat stream.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

VAL_KEY_OFFSET = 1000


@dataclasses.dataclass
class ArraySource:
    """Step-indexed sampling over in-memory ``(X, y)`` splits.

    By default a batch's row indices come from a ``torch.Generator`` seeded
    with the step's key. ``draw(key, batch_size, n) -> indices`` replaces
    that draw: the parity tests pass one that reproduces the reference's
    ``jax.random.randint`` stream, so both packages see the same batches.
    """
    train: tuple[torch.Tensor, torch.Tensor]
    val: tuple[torch.Tensor, torch.Tensor]
    seed: int = 0
    draw: Callable | None = None

    def _draw(self, arrays, key: int, batch_size: int):
        X, y = arrays
        n = X.shape[0]
        if self.draw is not None:
            idx = torch.tensor(np.array(self.draw(key, batch_size, n)),
                               dtype=torch.int64)
            if idx.shape != (batch_size,) or (idx < 0).any() or (idx >= n).any():
                raise ValueError(f'injected draw must be {batch_size} indices '
                                 f'in [0, {n})')
        else:
            gen = torch.Generator().manual_seed(key)
            idx = torch.randint(0, n, (batch_size,), generator=gen)
        idx = idx.to(X.device)
        return X[idx], y[idx]

    def train_batch(self, step: int, batch_size: int):
        return self._draw(self.train, self.seed + step, batch_size)

    def val_batch(self, step: int, batch_size: int):
        return self._draw(self.val, self.seed + VAL_KEY_OFFSET + step,
                          batch_size)

    # -- ordered streaming (influence sweeps) -------------------------------
    @property
    def n_train(self) -> int:
        return int(self.train[0].shape[0])

    def train_slice(self, start: int, size: int):
        """Examples [start, min(start + size, n_train)) in storage order, so
        a score's index always names the same example."""
        X, y = self.train
        if not 0 <= start < X.shape[0]:
            raise IndexError(f'train_slice start {start} outside '
                             f'[0, {X.shape[0]})')
        return X[start:start + size], y[start:start + size]


@dataclasses.dataclass
class EpisodeSource:
    """Meta-batches of few-shot episodes (iMAML-style meta-problems).

    Wraps an episode sampler (``FewShotSampler``: ``episode(idx) -> (sx,
    sy, qx, qy)``). ``task_batch`` stacks ``n_tasks`` consecutive episodes
    into ((SX, SY), (QX, QY)) with a leading task axis, on the sampler's
    device: the inner/outer batch pair of one vmapped meta-step.
    """
    sampler: Any

    def task_batch(self, step: int, n_tasks: int):
        eps = [self.sampler.episode(step * n_tasks + j)
               for j in range(n_tasks)]
        sx, sy, qx, qy = (torch.stack(z) for z in zip(*eps))
        return (sx, sy), (qx, qy)

    def _no_stream(self):
        raise TypeError(
            'EpisodeSource is a meta-problem source: it has no flat '
            'train/val stream. Drive it through solve(..., vmap_tasks=N) '
            '(which draws task_batch meta-batches) instead of the '
            'alternating BilevelTrainer path.')

    def train_batch(self, step: int, batch_size: int):
        self._no_stream()

    def val_batch(self, step: int, batch_size: int):
        self._no_stream()
