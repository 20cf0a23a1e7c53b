"""Carry trees across between the reference and the port.

The reference's parameter trees reach here as numpy (in the tests:
``jax.tree.map(np.asarray, tree)``). ``to_torch`` turns such a tree — dicts,
lists, tuples of arrays, including the structured index dicts
``{'leaf', 'dims'}`` of ``PyTreeIndexer`` — into tensors on a device;
``to_numpy`` turns a port tree back. Leaf order is JAX's on both sides.
``model_params_from_jax`` carries a transformer's parameters across.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree_util import PyTree, tree_map

_INT_INDEX_KEYS = ('leaf', 'dims')


def _array_to_torch(x, device) -> torch.Tensor:
    x = np.array(x)
    if x.dtype.name == 'bfloat16':
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart: carry the
        # 16-bit patterns across and reinterpret them, bit for bit
        return torch.from_numpy(x.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.tensor(x, device=device)


def to_torch(tree: PyTree, device: Any = 'cpu') -> PyTree:
    """Arrays → tensors on ``device`` (copied; dtypes kept, bf16 bit for
    bit)."""
    return tree_map(lambda x: _array_to_torch(x, device), tree)


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


def model_params_from_jax(tree: PyTree, cfg, device: Any = 'cpu') -> dict:
    """The reference's transformer parameters (numpy leaves, as from
    ``jax.tree.map(np.asarray, params)``) → the port's, on ``device``.
    With ``scan_layers`` the reference stacks ``blocks`` into one dict whose
    leaves lead with an ``n_blocks`` axis; the port keeps a list of block
    dicts, so that axis is split. Leaves are matched by name."""
    tree = dict(tree)
    blocks = tree['blocks']
    if isinstance(blocks, dict):
        blocks = [tree_map(lambda x, i=i: x[i], blocks)
                  for i in range(cfg.n_blocks)]
    tree['blocks'] = list(blocks)
    return to_torch(tree, device)
