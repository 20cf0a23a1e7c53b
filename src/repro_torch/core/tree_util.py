"""Parameter-tree helpers in JAX's leaf order.

Parameters are plain trees: dicts, lists and tuples (named tuples included)
whose leaves are tensors. ``None`` is an empty subtree, as in JAX. Leaves are
visited in **JAX's order**: dict keys sorted, so ``'b'`` comes before ``'w'``.
``torch.utils._pytree`` keeps insertion order instead, which would make every
fused buffer of :mod:`repro_torch.core.backend` a permutation of the
reference's.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    def __init__(self, kind, meta, children):
        self.kind, self.meta, self.children = kind, meta, children

    def __eq__(self, other):
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.meta == other.meta
                and self.children == other.children)

    def __repr__(self):
        return f'TreeDef({self.kind}, {self.meta}, {self.children})'

    def unflatten(self, leaves) -> PyTree:
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError('too many leaves for this tree structure')
        return out

    def _build(self, it):
        if self.kind == 'leaf':
            return next(it)
        if self.kind == 'none':
            return None
        vals = [c._build(it) for c in self.children]
        if self.kind == 'dict':
            return dict(zip(self.meta, vals))
        if self.kind == 'list':
            return vals
        if self.kind == 'namedtuple':
            return self.meta(*vals)
        return tuple(vals)


_END = object()


def _host_int64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().long()
    return torch.tensor(np.array(x), dtype=torch.int64)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, '_fields')


def tree_flatten(tree: PyTree) -> tuple[list, TreeDef]:
    """(leaves in JAX order, structure)."""
    leaves: list = []

    def go(x):
        if x is None:
            return TreeDef('none', None, ())
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return TreeDef('dict', keys, tuple(go(x[k]) for k in keys))
        if _is_namedtuple(x):
            return TreeDef('namedtuple', type(x), tuple(go(v) for v in x))
        if isinstance(x, (list, tuple)):
            kind = 'list' if isinstance(x, list) else 'tuple'
            return TreeDef(kind, None, tuple(go(v) for v in x))
        leaves.append(x)
        return TreeDef('leaf', None, ())

    treedef = go(tree)
    return leaves, treedef


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over corresponding leaves; every tree must share ``tree``'s
    structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        rl, rd = tree_flatten(r)
        if rd != treedef:
            raise ValueError(f'tree structures differ: {treedef} vs {rd}')
        others.append(rl)
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])


def tree_vdot(a: PyTree, b: PyTree) -> torch.Tensor:
    """<a, b> over all leaves, f32 accumulation."""
    parts = tree_leaves(tree_map(
        lambda x, y: torch.sum(x.float() * y.float()), a, b))
    return torch.stack(parts).sum() if parts else torch.tensor(0.0)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x: PyTree, y: PyTree) -> PyTree:
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_norm(a: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_vdot(a, a))


def tree_size(a: PyTree) -> int:
    """Total number of scalar parameters."""
    return sum(int(x.numel()) for x in tree_leaves(a))


# ---------------------------------------------------------------------------
# Structured indexing across a tree (Nyström column selection).
# ---------------------------------------------------------------------------
class PyTreeIndexer:
    """Maps parameter coordinates to one-hot tangent trees.

    Indices are *structured*, ``{'leaf': (k,) int32, 'dims': (k, R) int32}``
    with R the largest leaf rank, as in the reference: never a global flat
    offset, so the scheme stays int32-safe at any parameter count. They live
    on the device of the tree's leaves.
    """

    def __init__(self, tree: PyTree):
        leaves, self.treedef = tree_flatten(tree)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.device = leaves[0].device if leaves else torch.device('cpu')
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        self.total = sum(self.sizes)
        self.max_rank = max((len(s) for s in self.shapes), default=1) or 1
        L = len(self.shapes)
        self._dim_table = np.ones((L, self.max_rank), np.int64)
        self._stride_table = np.ones((L, self.max_rank), np.int64)
        for i, s in enumerate(self.shapes):
            for d, n in enumerate(s):
                if n >= 2 ** 31:
                    raise ValueError(
                        f'leaf dim {n} exceeds int32; reshape the leaf — the '
                        'structured indexer is per-dimension int32')
                self._dim_table[i, d] = n
            stride = 1
            for d in range(len(s) - 1, -1, -1):
                self._stride_table[i, d] = stride
                stride *= s[d]

    def _structured(self, leaf: np.ndarray, dims: np.ndarray) -> dict:
        return {'leaf': torch.as_tensor(leaf, dtype=torch.int32,
                                        device=self.device),
                'dims': torch.as_tensor(dims, dtype=torch.int32,
                                        device=self.device)}

    def from_flat(self, flat) -> dict:
        """Global flat indices (host values) → structured indices."""
        flat = np.asarray(flat, np.int64).reshape(-1)
        offs = np.cumsum([0] + self.sizes)
        if flat.size and (flat.min() < 0 or flat.max() >= self.total):
            raise IndexError(f'flat index outside [0, {self.total})')
        leaf = np.searchsorted(offs, flat, 'right') - 1
        local = flat - offs[leaf]
        dims = (local[:, None] // self._stride_table[leaf]) \
            % self._dim_table[leaf]
        return self._structured(leaf, dims.reshape(len(flat), self.max_rank))

    def check(self, indices: dict) -> dict:
        """Validate injected structured indices (e.g. the reference's own
        draws) and move them to this tree's device."""
        leaf, dims = (_host_int64(indices[key]) for key in ('leaf', 'dims'))
        if leaf.ndim != 1 or dims.shape != (leaf.shape[0], self.max_rank):
            raise ValueError(
                f'indices must be leaf (k,) and dims (k, {self.max_rank}); got '
                f'{tuple(leaf.shape)} and {tuple(dims.shape)}')
        if leaf.numel() and (leaf.min() < 0 or leaf.max() >= len(self.shapes)):
            raise IndexError('leaf index outside the tree')
        table = torch.as_tensor(self._dim_table)[leaf]
        if dims.numel() and ((dims < 0).any() or (dims >= table).any()):
            raise IndexError('coordinate outside its leaf')
        return self._structured(leaf.numpy(), dims.numpy())

    def _local_offsets(self, indices: dict) -> torch.Tensor:
        """Row-major offset of each index inside its own leaf, (k,) int64."""
        leaf = indices['leaf'].long()
        strides = torch.as_tensor(self._stride_table,
                                  device=leaf.device)[leaf]
        return (indices['dims'].long() * strides).sum(-1)

    def one_hots(self, indices: dict) -> PyTree:
        """Batched one-hot tree: every leaf carries a leading k axis."""
        leaf = indices['leaf'].long()
        local = self._local_offsets(indices)
        k = leaf.shape[0]
        rows = torch.arange(k, device=leaf.device)
        outs = []
        for lid, (shape, size, dtype) in enumerate(
                zip(self.shapes, self.sizes, self.dtypes)):
            oh = torch.zeros((k, size), dtype=dtype, device=self.device)
            mask = leaf == lid
            oh[rows[mask], local[mask]] = 1
            outs.append(oh.reshape((k,) + shape))
        return self.treedef.unflatten(outs)

    def gather(self, batched_tree: PyTree, indices: dict) -> torch.Tensor:
        """Entries of each batched-tree column at the structured indices:
        (k_batch, k_idx) f32."""
        leaf = indices['leaf'].long()
        local = self._local_offsets(indices)
        leaves = tree_leaves(batched_tree)
        kb = leaves[0].shape[0]
        out = torch.zeros((kb, leaf.shape[0]), dtype=torch.float32,
                          device=leaves[0].device)
        for lid, c in enumerate(leaves):
            mask = leaf == lid
            out[:, mask] = c.reshape(kb, -1)[:, local[mask]].float()
        return out

    def sample_indices(self, rng: torch.Generator, k: int, *,
                       indices: dict | None = None) -> dict:
        """k distinct structured indices, uniform over all parameters.

        ``rng`` is a ``torch.Generator`` on the CPU. ``indices=`` injects a
        draw made elsewhere (the reference's, in the parity tests) in place
        of sampling. Needs p < 2³¹: the reference's with-replacement scheme
        beyond that, and its importance-weighted draw, are not ported."""
        if indices is not None:
            return self.check(indices)
        if self.total >= 2 ** 31:
            raise ValueError('sampling needs p < 2^31 (the large-p scheme is '
                             'not ported)')
        flat = torch.randperm(self.total, generator=rng)[:min(k, self.total)]
        return self.from_flat(flat.numpy())

    def all_indices(self) -> dict:
        """Every parameter (tiny models only — ExactIHVP)."""
        if self.total >= 2 ** 31:
            raise ValueError('all_indices needs p < 2^31')
        return self.from_flat(np.arange(self.total))
