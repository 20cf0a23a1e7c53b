"""Deterministic synthetic datasets, regenerated bit for bit.

The reference draws these with ``numpy.random.RandomState``; the port runs
the same numpy draws and hands the arrays to torch, so both packages see
identical data. Only the generators the ported tasks use are here:
``make_logreg_problem`` (§5.1), ``DistillationTask`` (§5.2),
``FewShotSampler`` (§5.3), ``LongTailDataset`` (§5.4) and ``TokenStream``
(§5.4 at LM scale).
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
class DistillationTask:
    """10-class "digits" (§5.2, an MNIST analog): each class's prototype is
    a smooth random field (4 × 4 cosine modes), samples add Gaussian noise.
    ``train()``/``test()`` give (images (n, s, s, 1) f32, labels (n,)
    int64) on ``device``."""
    n_classes: int = 10
    image_size: int = 28
    n_train: int = 2048
    n_test: int = 1024
    seed: int = 0
    device: Any = 'cpu'

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        s = self.image_size
        freqs = rng.randn(self.n_classes, 4, 4)
        grid = np.linspace(0, 1, s)
        basis = np.stack([np.cos(np.pi * k * grid) for k in range(4)])
        protos = np.einsum('ckl,ks,lt->cst', freqs, basis, basis)
        self.prototypes = (protos / np.abs(protos).max((1, 2), keepdims=True)
                           ).astype(np.float32)

    def _sample(self, n, seed):
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, self.n_classes, n)
        imgs = self.prototypes[labels] + 0.35 * rng.randn(
            n, self.image_size, self.image_size).astype(np.float32)
        return (torch.as_tensor(imgs[..., None], device=self.device),
                torch.as_tensor(labels, dtype=torch.int64,
                                device=self.device))

    def train(self):
        return self._sample(self.n_train, self.seed + 1)

    def test(self):
        return self._sample(self.n_test, self.seed + 2)


@dataclasses.dataclass
class FewShotSampler:
    """N-way K-shot episodes over procedurally generated "characters" (§5.3,
    an Omniglot analog): each class's prototype is a smooth random field
    (5 × 5 sine modes); the first 80% of the classes are meta-train, the
    rest meta-test. Episodes are tensors on ``device``: images (n, s, s, 1)
    f32, labels (n,) int64."""
    n_way: int = 5
    k_shot: int = 1
    k_query: int = 5
    image_size: int = 20
    n_classes: int = 200
    seed: int = 0
    device: Any = 'cpu'

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        s = self.image_size
        coeff = rng.randn(self.n_classes, 5, 5)
        grid = np.linspace(0, 1, s)
        basis = np.stack([np.sin(np.pi * (k + 1) * grid) for k in range(5)])
        protos = np.einsum('ckl,ks,lt->cst', coeff, basis, basis)
        self.prototypes = (protos / np.abs(protos).max((1, 2), keepdims=True)
                           ).astype(np.float32)
        self.split = int(0.8 * self.n_classes)

    def episode(self, idx: int, test: bool = False):
        """Episode ``idx`` → (support_x, support_y, query_x, query_y)."""
        rng = np.random.RandomState(self.seed + 7919 * idx
                                    + (1 if test else 0))
        pool = (np.arange(self.split, self.n_classes) if test
                else np.arange(self.split))
        classes = rng.choice(pool, self.n_way, replace=False)
        s = self.image_size

        def draw(per_class):
            xs, ys = [], []
            for yi, c in enumerate(classes):
                xs.append(self.prototypes[c] + 0.3 * rng.randn(
                    per_class, s, s).astype(np.float32))
                ys.append(np.full(per_class, yi))
            return (torch.as_tensor(np.concatenate(xs)[..., None],
                                    device=self.device),
                    torch.as_tensor(np.concatenate(ys), dtype=torch.int64,
                                    device=self.device))

        return draw(self.k_shot) + draw(self.k_query)


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


# ------------------------------------------------------------------ LM corpus
@dataclasses.dataclass
class TokenStream:
    """Domain-mixture synthetic corpus for LM training.

    Each domain is a depth-1 Markov chain over a structured sub-vocabulary
    (the first min(V, 512) tokens) with 10% uniform noise;
    ``noisy_domains`` emit uniform tokens, with no structure: the bilevel
    data reweighting should learn to down-weight them. Batches are host
    tensors; the consumer moves them to its device."""
    vocab_size: int
    seq_len: int
    n_domains: int = 8
    noisy_domains: tuple[int, ...] = (6, 7)
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        V = min(self.vocab_size, 512)
        self._V = V
        self.next_tok = rng.randint(0, V, size=(self.n_domains, V))

    def batch(self, step: int, batch_size: int, clean_only: bool = False
              ) -> dict:
        """{'inputs', 'labels'} (B, S) int32, 'domain' (B,) int64 and
        'mask' (B, S) f32 ones, for global step ``step``; ``clean_only``
        draws from the structured domains only (the outer batch)."""
        rng = np.random.RandomState((self.seed + 31337 * step
                                     + (7 if clean_only else 0)) % (2**32 - 1))
        V, S = self._V, self.seq_len
        if clean_only:
            domains = rng.choice([d for d in range(self.n_domains)
                                  if d not in self.noisy_domains], batch_size)
        else:
            domains = rng.randint(0, self.n_domains, batch_size)
        toks = np.empty((batch_size, S + 1), np.int32)
        toks[:, 0] = rng.randint(0, V, batch_size)
        for t in range(S):
            nxt = self.next_tok[domains, toks[:, t]]
            noise = rng.randint(0, V, batch_size)
            flip = rng.rand(batch_size) < 0.1
            nxt = np.where(flip, noise, nxt)
            nxt = np.where(np.isin(domains, self.noisy_domains),
                           rng.randint(0, V, batch_size), nxt)
            toks[:, t + 1] = nxt
        return {'inputs': torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
                'labels': torch.from_numpy(np.ascontiguousarray(toks[:, 1:])),
                'domain': torch.from_numpy(np.asarray(domains, np.int64)),
                'mask': torch.ones((batch_size, S), dtype=torch.float32)}
