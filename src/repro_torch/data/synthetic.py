"""Deterministic synthetic datasets, regenerated bit for bit.

The reference draws these with ``numpy.random.RandomState``; the port runs
the same numpy draws and hands the arrays to torch, so both packages see
identical data. Only the generators the ported tasks use are here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def make_logreg_problem(D: int = 100, n: int = 500, seed: int = 0,
                        noise: float = 0.5, device: Any = 'cpu'):
    """y = (w*ᵀ x + ε > 0); returns (train, val) tensor pairs (§5.1)."""
    rng = np.random.RandomState(seed)
    w_star = rng.randn(D).astype(np.float32)

    def split(m):
        X = rng.randn(m, D).astype(np.float32)
        y = (X @ w_star + noise * rng.randn(m) > 0).astype(np.float32)
        return (torch.as_tensor(X, device=device),
                torch.as_tensor(y, device=device))

    return split(n), split(n)


@dataclasses.dataclass
class LongTailDataset:
    """Long-tailed classification: class c has ~ n_max · if^{-c/(C-1)}
    samples (the Cui et al. exponential profile of CIFAR-10-LT), with a
    balanced validation split (§5.4)."""
    n_classes: int = 10
    imbalance_factor: int = 100
    n_max: int = 500
    d: int = 64
    seed: int = 0
    device: Any = 'cpu'

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.means = 1.0 * rng.randn(self.n_classes, self.d).astype(np.float32)
        counts = [int(self.n_max * self.imbalance_factor
                      ** (-c / (self.n_classes - 1)))
                  for c in range(self.n_classes)]
        xs, ys = [], []
        for c, n in enumerate(counts):
            xs.append(self.means[c] + rng.randn(n, self.d).astype(np.float32))
            lab = np.full(n, c)
            flip = rng.rand(n) < 0.1
            lab[flip] = rng.randint(0, self.n_classes, flip.sum())
            ys.append(lab)
        perm = rng.permutation(sum(counts))
        self.X = torch.as_tensor(np.concatenate(xs)[perm], device=self.device)
        self.y = torch.as_tensor(np.concatenate(ys)[perm], dtype=torch.int64,
                                 device=self.device)
        nv = 40
        xs, ys = [], []
        for c in range(self.n_classes):
            xs.append(self.means[c] + rng.randn(nv, self.d).astype(np.float32))
            ys.append(np.full(nv, c))
        self.Xv = torch.as_tensor(np.concatenate(xs), device=self.device)
        self.yv = torch.as_tensor(np.concatenate(ys), dtype=torch.int64,
                                  device=self.device)
