"""Carry trees across between the reference and the port.

The reference's parameter trees reach here as numpy (in the tests:
``jax.tree.map(np.asarray, tree)``). ``to_torch`` turns such a tree — dicts,
lists, tuples of arrays, including the structured index dicts
``{'leaf', 'dims'}`` of ``PyTreeIndexer`` — into tensors on a device;
``to_numpy`` turns a port tree back. Leaf order is JAX's on both sides.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree_util import PyTree, tree_map

_INT_INDEX_KEYS = ('leaf', 'dims')


def to_torch(tree: PyTree, device: Any = 'cpu') -> PyTree:
    """Arrays → tensors on ``device`` (copied; dtypes kept)."""
    return tree_map(lambda x: torch.tensor(np.array(x), device=device), tree)


def to_numpy(tree: PyTree) -> PyTree:
    """Tensors → numpy arrays on the host (bf16 is widened to float32:
    numpy has no bfloat16)."""
    def conv(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return tree_map(conv, tree)


def indices_to_torch(indices: dict, device: Any = 'cpu') -> dict:
    """A structured index dict ``{'leaf': (k,), 'dims': (k, R)}`` → int32
    tensors on ``device``."""
    return {key: torch.tensor(np.array(indices[key]), dtype=torch.int32,
                              device=device) for key in _INT_INDEX_KEYS}
