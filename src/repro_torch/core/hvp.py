"""Hessian-vector products and Nyström column extraction.

An HVP against a one-hot tangent e_j yields the j-th *column* of the Hessian;
k of them form the Nyström sketch C = H[:, K] (Eq. 4 of the paper). Columns
are parameter trees whose leaves carry a leading k axis.

Two curvature helpers serve the sampling variants: ``gauss_newton_hvp``, a
PSD surrogate, and ``hessian_diagonal_estimate``, the Hutchinson estimate of
|diag(H)| behind the importance-weighted column draw (Remark 1).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, jvp, vmap

from repro_torch.core.tree_util import (PyTree, PyTreeIndexer, slice_indices,
                                        tree_axpy, tree_leaves, tree_map,
                                        tree_scale, tree_vdot)

LossFn = Callable[..., torch.Tensor]  # loss(params, *args) -> scalar


class HVP:
    """v ↦ (∇²_θ loss) v at (params, *args), forward-over-reverse: ``jvp`` of
    ``grad``. One extra forward pass over plain ``grad``, with backprop's
    memory profile.

    It keeps its operands (``loss_fn``, ``params``, ``args``) so that a
    solve against it (:func:`~repro_torch.core.solvers.tangent_apply`) can
    differentiate the system through ``args``. ``params`` is rebuilt in
    JAX's leaf order (dict keys sorted), the order of the one-hot tangents
    ``extract_columns`` makes: ``jvp`` refuses a tangent whose dict keys
    come in another order."""

    def __init__(self, loss_fn: LossFn, params: PyTree, args: tuple):
        self.loss_fn, self.args = loss_fn, tuple(args)
        self.params = tree_map(lambda x: x, params)
        self._grad = grad(loss_fn)

    def __call__(self, v: PyTree) -> PyTree:
        return jvp(lambda p: self._grad(p, *self.args), (self.params,),
                   (v,))[1]


def make_hvp(loss_fn: LossFn, params: PyTree, *args) -> HVP:
    """v ↦ (∇²_θ loss) v at (params, *args): an :class:`HVP`."""
    return HVP(loss_fn, params, args)


def for_each_column_chunk(hvp: Callable[[PyTree], PyTree],
                          indexer: PyTreeIndexer, indices: dict,
                          column_chunk: int | None,
                          fn: Callable[[int, PyTree], None]) -> None:
    """``fn(start, columns)`` for each chunk of the draw in order, where
    ``columns`` = H[:, K[start:start + w]] is a tree with a leading w axis.

    A chunk's one-hot tangents are built just before its HVPs and the
    chunk's columns are dropped once ``fn`` returns, so at most one chunk of
    each is live (the sketch build writes each chunk into the fused buffer
    as it comes). The w HVPs of a chunk run batched under
    ``torch.func.vmap``; ``column_chunk`` bounds w (None: all k at once)."""
    k = indices['leaf'].shape[0]
    chunk = k if column_chunk is None else max(1, min(column_chunk, k))
    for s in range(0, k, chunk):
        fn(s, vmap(hvp)(indexer.one_hots(slice_indices(indices, s,
                                                       s + chunk))))


def extract_columns(hvp: Callable[[PyTree], PyTree],
                    indexer: PyTreeIndexer,
                    indices: dict,
                    column_chunk: int | None = None) -> PyTree:
    """C = H[:, K] as a tree with leading axis k = #indices, assembled from
    :func:`for_each_column_chunk` (peak activation memory
    O(chunk · activations) instead of O(k · activations))."""
    parts: list = []
    for_each_column_chunk(hvp, indexer, indices, column_chunk,
                          lambda _, cols: parts.append(cols))
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda *xs: torch.cat(xs, 0), *parts)


def gauss_newton_hvp(loss_fn: LossFn, params: PyTree, *args,
                     damping: float = 0.0) -> Callable[[PyTree], PyTree]:
    """The rank-1 PSD surrogate of the scalar loss's curvature:
    v ↦ g (gᵀ v) + damping · v with g = ∇loss at ``params`` (computed once
    here). Callers with structured losses should pass a model-split loss."""
    g = grad(loss_fn)(params, *args)

    def hvp(v: PyTree) -> PyTree:
        return tree_axpy(damping, v, tree_scale(g, tree_vdot(g, v)))

    return hvp


def hessian_diagonal_estimate(hvp: Callable[[PyTree], PyTree],
                              indexer: PyTreeIndexer, rng=None,
                              n_probes: int = 8, *,
                              probes: PyTree | None = None) -> torch.Tensor:
    """Hutchinson's |diag(H)| estimate, (p,) f32 in the flat leaf order:
    |mean_z z ⊙ Hz| over Rademacher probes z.

    The probes are drawn per leaf from ``rng`` (a CPU ``torch.Generator``),
    or injected as ``probes``: a tree like the parameters with a leading
    ``n_probes`` axis (the parity tests pass the reference's draws)."""
    if probes is None:
        probes = indexer.treedef.unflatten([
            (torch.randint(0, 2, (n_probes, *shape), generator=rng) * 2 - 1)
            .to(dtype=dtype, device=indexer.device)
            for shape, dtype in zip(indexer.shapes, indexer.dtypes)])
    n = tree_leaves(probes)[0].shape[0]
    est = 0.0
    for i in range(n):
        z = tree_map(lambda t: t[i], probes)
        hz = hvp(z)
        est = est + torch.cat([(a.float() * b.float()).reshape(-1)
                               for a, b in zip(tree_leaves(z),
                                               tree_leaves(hz))])
    return torch.abs(est / n)
