"""Hessian-vector products and Nyström column extraction.

An HVP against a one-hot tangent e_j yields the j-th *column* of the Hessian;
k of them form the Nyström sketch C = H[:, K] (Eq. 4 of the paper). Columns
are parameter trees whose leaves carry a leading k axis.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, jvp, vmap

from repro_torch.core.tree_util import PyTree, PyTreeIndexer, tree_map

LossFn = Callable[..., torch.Tensor]  # loss(params, *args) -> scalar


def make_hvp(loss_fn: LossFn, params: PyTree, *args) -> Callable[[PyTree], PyTree]:
    """v ↦ (∇²_θ loss) v, forward-over-reverse: ``jvp`` of ``grad``.

    One extra forward pass over plain ``grad``, with backprop's memory
    profile."""
    grad_fn = grad(loss_fn)

    def hvp(v: PyTree) -> PyTree:
        return jvp(lambda p: grad_fn(p, *args), (params,), (v,))[1]

    return hvp


def extract_columns(hvp: Callable[[PyTree], PyTree],
                    indexer: PyTreeIndexer,
                    indices: dict,
                    column_chunk: int | None = None) -> PyTree:
    """C = H[:, K] as a tree with leading axis k = #indices.

    The k HVPs run batched under ``torch.func.vmap``; ``column_chunk`` bounds
    how many run at once (peak activation memory O(chunk · activations)
    instead of O(k · activations))."""
    tangents = indexer.one_hots(indices)
    k = indices['leaf'].shape[0]
    chunk = k if column_chunk is None else max(1, min(column_chunk, k))
    if chunk >= k:
        return vmap(hvp)(tangents)
    parts = [vmap(hvp)(tree_map(lambda t: t[s:s + chunk], tangents))
             for s in range(0, k, chunk)]
    return tree_map(lambda *xs: torch.cat(xs, 0), *parts)
