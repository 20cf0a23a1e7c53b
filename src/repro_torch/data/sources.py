"""Batch sources: the data half of a
:class:`~repro_torch.core.problem.BilevelProblem`.

``train_batch(step, batch_size)`` / ``val_batch(step, batch_size)`` are pure
functions of (seed, step): train draws use key ``seed + step``, val draws
``seed + VAL_KEY_OFFSET + step``, the reference's key schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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
