"""Carry trees across between the reference and the port.

The reference's parameter trees reach here as numpy (in the tests:
``jax.tree.map(np.asarray, tree)``). ``to_torch`` turns such a tree — dicts,
lists, tuples of arrays, including the structured index dicts
``{'leaf', 'dims'}`` of ``PyTreeIndexer`` — into tensors on a device;
``to_numpy`` turns a port tree back. Leaf order is JAX's on both sides.
``model_params_from_jax`` carries a transformer's parameters across (every
family's: MoE experts, Mamba and RWKV mixers, an encoder's blocks),
``model_indices_from_jax`` a structured column draw over them, and
``cache_from_jax`` / ``cache_to_numpy`` a decode cache either way (the KV
cache, Mamba's and RWKV's states, the cross-attention K and V).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree_util import (PyTree, PyTreeIndexer,
                                        tree_flatten_with_path, tree_map)

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


def _tensor_to_bits(x: torch.Tensor) -> np.ndarray:
    """A tensor → numpy on the host; bf16 as numpy's ``bfloat16``
    (the ``ml_dtypes`` package), bit for bit."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


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


def _block_counts(cfg) -> dict:
    """The stacks of blocks in a transformer's tree and their lengths: the
    decoder's ``blocks``, and an encoder-decoder's ``enc_blocks`` (one
    slot a block)."""
    counts = {'blocks': cfg.n_blocks}
    if cfg.is_encdec:
        counts['enc_blocks'] = cfg.n_enc_layers
    return counts


def model_params_from_jax(tree: PyTree, cfg, device: Any = 'cpu',
                          mesh=None) -> dict:
    """The reference's transformer parameters (numpy leaves, as from
    ``jax.tree.map(np.asarray, params)``) → the port's, on ``device``.
    With ``scan_layers`` the reference stacks ``blocks`` (and
    ``enc_blocks``) into one dict whose leaves lead with a block axis; the
    port keeps a list of block dicts, so that axis is split. Leaves are
    matched by name. ``mesh``: this rank's blocks of them for the model
    split on it (:func:`repro_torch.models.split.shard_params` under
    ``param_specs(cfg, mesh)``)."""
    tree = dict(tree)
    for key, n in _block_counts(cfg).items():
        blocks = tree[key]
        if isinstance(blocks, dict):
            blocks = [tree_map(lambda x, i=i: x[i], blocks)
                      for i in range(n)]
        tree[key] = list(blocks)
    if mesh is None:
        return to_torch(tree, device)
    from repro_torch.models.split import shard_params, split_specs
    return tree_map(lambda x: x.to(device),
                    shard_params(to_torch(tree, 'cpu'),
                                 split_specs(cfg, mesh), mesh))


def _stacked_paths(cfg, port_tree: dict) -> list:
    """(path, rank) of each leaf of the reference's transformer tree, in its
    leaf order: with ``scan_layers`` ``blocks`` (and ``enc_blocks``) is one
    dict whose leaves lead with a block axis (the port's block 0 gives the
    names and the unstacked shapes)."""
    tree = dict(port_tree)
    if cfg.scan_layers:
        for key, n in _block_counts(cfg).items():
            tree[key] = tree_map(lambda x, n=n: x.expand((n,) + tuple(x.shape)),
                                 tree[key][0])
    pairs, _ = tree_flatten_with_path(tree)
    return [(path, x.ndim) for path, x in pairs]


def model_indices_from_jax(indices: dict, cfg, device: Any = 'cpu') -> dict:
    """A structured draw over the reference's transformer tree
    (``{'leaf': (k,), 'dims': (k, R)}``, numpy or arrays) → the same
    coordinates over the port's tree, as int32 tensors on ``device``.

    Leaves are matched by path. With ``scan_layers`` a reference leaf under
    ``blocks`` or ``enc_blocks`` is stacked, so its first coordinate is the
    block: it becomes the port's list position, and the remaining
    coordinates shift down one.
    Coordinates past a leaf's rank are 0, as the indexers pad them."""
    from repro_torch.models.transformer import abstract_params
    port = abstract_params(cfg)
    port_pairs, _ = tree_flatten_with_path(port)
    port_leaf = {path: i for i, (path, _) in enumerate(port_pairs)}
    max_rank = PyTreeIndexer(port).max_rank
    ref_paths = _stacked_paths(cfg, port)
    leaf = np.asarray(indices['leaf']).astype(np.int64).reshape(-1)
    dims = np.asarray(indices['dims']).astype(np.int64).reshape(len(leaf), -1)
    out_leaf = np.empty(len(leaf), np.int64)
    out_dims = np.zeros((len(leaf), max_rank), np.int64)
    for j, (lid, d) in enumerate(zip(leaf, dims)):
        path, rank = ref_paths[lid]
        coords = list(d[:rank])
        if cfg.scan_layers and path[0] in ('blocks', 'enc_blocks'):
            path = (path[0], str(coords[0])) + path[1:]
            coords = coords[1:]
        out_leaf[j] = port_leaf[path]
        out_dims[j, :len(coords)] = coords
    return indices_to_torch({'leaf': out_leaf, 'dims': out_dims}, device)


def cache_from_jax(cache: PyTree, device: Any = 'cpu') -> dict:
    """The reference's decode cache (``{'pos', 'slots': {'slot{i}': {'k',
    'v'} | {'conv', 'ssm'} | {'tm_prev', 'cm_prev', 'wkv'}}}`` and an
    encoder-decoder's ``'cross': {'k', 'v'}``, numpy leaves) → the
    port's, on ``device``: the same layout, bf16 leaves bit for bit."""
    return to_torch(cache, device)


def cache_to_numpy(cache: dict) -> dict:
    """The port's decode cache → numpy leaves in its own dtypes, bf16 as
    numpy's ``bfloat16`` bit for bit, so that ``cache_from_jax`` (or the
    reference) takes it back unchanged."""
    return tree_map(_tensor_to_bits, cache)
