"""Parameter-tree helpers in JAX's leaf order.

Parameters are plain trees: dicts, lists and tuples (named tuples included)
whose leaves are tensors. ``None`` is an empty subtree, as in JAX. Leaves are
visited in **JAX's order**: dict keys sorted, so ``'b'`` comes before ``'w'``.
``torch.utils._pytree`` keeps insertion order instead, which would make every
fused buffer of :mod:`repro_torch.core.backend` a permutation of the
reference's.

``tree_flatten`` keeps a dataclass whole, as a leaf. ``tree_flatten_with_path``
also walks dataclass instances, field by field in declaration order, as the
reference's ``register_dataclass`` states are walked: it is how a prepared
solver state or a checkpointed tree is laid out on disk.
"""
from __future__ import annotations

import dataclasses
import math
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
        if self.kind == 'dataclass':
            cls, names = self.meta
            return cls(**dict(zip(names, vals)))
        return tuple(vals)


_END = object()


def _host_int64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().long()
    return torch.tensor(np.array(x), dtype=torch.int64)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, '_fields')


def _flatten(x, leaves: list) -> TreeDef:
    if x is None:
        return TreeDef('none', None, ())
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return TreeDef('dict', keys,
                       tuple(_flatten(x[k], leaves) for k in keys))
    if _is_namedtuple(x):
        return TreeDef('namedtuple', type(x),
                       tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, (list, tuple)):
        kind = 'list' if isinstance(x, list) else 'tuple'
        return TreeDef(kind, None, tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return TreeDef('leaf', None, ())


def tree_flatten(tree: PyTree) -> tuple[list, TreeDef]:
    """(leaves in JAX order, structure). The walk is a module-level
    function: a nested one that calls itself sits in a reference cycle with
    its closure, which would hold the leaves until the garbage collector
    runs (tens of GB at a model's full width)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_flatten_with_path(tree: PyTree) -> tuple[list, TreeDef]:
    """([(path, leaf), ...] in JAX order, structure), dataclass instances
    walked field by field. A path is a tuple of entries rendered as the
    reference's checkpoint renders JAX's keys: a dict key as ``str(key)``, a
    list or tuple position as ``str(i)``, a named-tuple or dataclass field
    as ``'.' + name``; ``'/'.join(path)`` is the leaf's name in a checkpoint
    (``repro/checkpoint/manager.py``'s ``_flatten``). Kept apart from
    :func:`tree_flatten`, which every eager step calls, so that one builds
    no paths."""
    pairs: list = []
    return pairs, _flatten_with_path(tree, (), pairs)


def _flatten_with_path(x, path: tuple, pairs: list) -> TreeDef:
    if x is None:
        return TreeDef('none', None, ())
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return TreeDef('dict', keys, tuple(
            _flatten_with_path(x[k], path + (str(k),), pairs) for k in keys))
    if _is_namedtuple(x):
        return TreeDef('namedtuple', type(x), tuple(
            _flatten_with_path(v, path + ('.' + f,), pairs)
            for f, v in zip(x._fields, x)))
    if isinstance(x, (list, tuple)):
        kind = 'list' if isinstance(x, list) else 'tuple'
        return TreeDef(kind, None, tuple(
            _flatten_with_path(v, path + (str(i),), pairs)
            for i, v in enumerate(x)))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return TreeDef('dataclass', (type(x), names), tuple(
            _flatten_with_path(getattr(x, n), path + ('.' + n,), pairs)
            for n in names))
    pairs.append((path, x))
    return TreeDef('leaf', None, ())


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
# Uniform column draws take randperm(p)'s first k below this size (the
# draws every seeded run of the port has made) and an O(k) draw from it up:
# randperm at p ≈ 10⁹ is 7 GB of int64 and seconds of host time.
RANDPERM_BELOW = 2 ** 24


def slice_indices(indices: dict, start: int, stop: int) -> dict:
    """Entries ``start:stop`` of a structured draw."""
    return {key: indices[key][start:stop] for key in ('leaf', 'dims')}


class PyTreeIndexer:
    """Maps parameter coordinates to one-hot tangent trees.

    Indices are *structured*, ``{'leaf': (k,) int32, 'dims': (k, R) int32}``
    with R the largest leaf rank, as in the reference: never a global flat
    offset, so the scheme stays int32-safe at any parameter count. They live
    on the device of the tree's leaves.

    Over a split tree (``mesh=`` and ``specs=``, the sanitized spec tree:
    each leaf is this rank's block of a whole leaf,
    :mod:`repro_torch.models.split`) the indices address the **whole**
    leaves (``shapes``, ``total``): every rank draws the same ones from the
    same generator, :meth:`one_hots` gives this rank's block of the whole
    one-hots (a coordinate outside the block gives a zero block), and
    :meth:`gather` gives the whole entries on every rank (one
    ``all_reduce``).
    """

    def __init__(self, tree: PyTree, mesh=None, specs=None):
        leaves, self.treedef = tree_flatten(tree)
        self.mesh = mesh
        self.local_shapes = [tuple(l.shape) for l in leaves]
        self.shapes = self.local_shapes
        if mesh is not None:
            from repro_torch.distributed.sharding import (block_slices,
                                                          global_shape,
                                                          holds_first_replica,
                                                          spec_leaves)
            self.specs = spec_leaves(specs)
            self.shapes = [global_shape(s, sp, mesh)
                           for s, sp in zip(self.local_shapes, self.specs)]
            self._starts = [[sl.start for sl in block_slices(s, sp, mesh)]
                            for s, sp in zip(self.shapes, self.specs)]
            self._first = [holds_first_replica(sp, mesh)
                           for sp in self.specs]
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

    def _in_block(self, lid: int, indices: dict, mask: torch.Tensor):
        """(where the masked indices of leaf ``lid`` fall in this rank's
        block, their row-major offsets inside it)."""
        dims = indices['dims'][mask].long()
        shape = self.local_shapes[lid]
        r = len(shape)
        start = torch.as_tensor(self._starts[lid] + [0] * (self.max_rank - r),
                                dtype=torch.int64, device=dims.device)
        local = dims - start
        size = torch.as_tensor(list(shape) + [1] * (self.max_rank - r),
                               dtype=torch.int64, device=dims.device)
        inside = ((local >= 0) & (local < size)).all(-1)
        off = torch.zeros_like(inside, dtype=torch.int64)
        stride = 1
        for d in range(r - 1, -1, -1):
            off = off + local[:, d] * stride
            stride *= shape[d]
        return inside, off

    def one_hots(self, indices: dict) -> PyTree:
        """Batched one-hot tree: every leaf carries a leading k axis. The
        sketch build calls it on one chunk of the draw at a time
        (:func:`slice_indices`), so that k·p one-hots never coexist. Over a
        split tree: this rank's blocks of them."""
        leaf = indices['leaf'].long()
        k = leaf.shape[0]
        rows = torch.arange(k, device=leaf.device)
        if self.mesh is None:
            local = self._local_offsets(indices)
        outs = []
        for lid, (shape, dtype) in enumerate(zip(self.local_shapes,
                                                 self.dtypes)):
            size = math.prod(shape)
            oh = torch.zeros((k, size), dtype=dtype, device=self.device)
            mask = leaf == lid
            if self.mesh is None:
                oh[rows[mask], local[mask]] = 1
            else:
                inside, off = self._in_block(lid, indices, mask)
                oh[rows[mask][inside], off[inside]] = 1
            outs.append(oh.reshape((k,) + shape))
        return self.treedef.unflatten(outs)

    def gather(self, batched_tree: PyTree, indices: dict) -> torch.Tensor:
        """Entries of each batched-tree column at the structured indices:
        (k_batch, k_idx) f32. Over a split tree each entry is read on the
        rank whose block holds it (one replica of it) and the whole matrix
        is all-reduced, so every rank holds it."""
        leaf = indices['leaf'].long()
        leaves = tree_leaves(batched_tree)
        kb = leaves[0].shape[0]
        out = torch.zeros((kb, leaf.shape[0]), dtype=torch.float32,
                          device=leaves[0].device)
        if self.mesh is None:
            local = self._local_offsets(indices)
        for lid, c in enumerate(leaves):
            mask = leaf == lid
            if self.mesh is None:
                out[:, mask] = c.reshape(kb, -1)[:, local[mask]].float()
            elif self._first[lid]:
                inside, off = self._in_block(lid, indices, mask)
                cols = torch.nonzero(mask).reshape(-1)[inside]
                out[:, cols] = c.reshape(kb, -1)[:, off[inside]].float()
        if self.mesh is not None:
            from repro_torch.distributed.ctx import _all_reduce
            out = _all_reduce(out, self.mesh, None, 'sum', 'gather')
        return out

    def sample_indices(self, rng: torch.Generator, k: int,
                       weights: torch.Tensor | None = None, *,
                       indices: dict | None = None) -> dict:
        """k structured indices over all parameters, drawn from ``rng`` (a
        ``torch.Generator`` on the CPU), or ``indices=``, a draw made
        elsewhere (the reference's, in the parity tests), checked and used
        in place of sampling.

        p < 2³¹: k distinct flat indices, uniform (``randperm(p)``'s first
        k below ``RANDPERM_BELOW``, an O(k) draw above it: see
        :meth:`_uniform_distinct`), or with ``weights`` (a
        flat (p,) vector, Remark 1's Drineas–Mahoney weights) drawn without
        replacement in proportion to them (Gumbel top-k, the scheme of the
        reference's ``jax.random.choice``). p ≥ 2³¹: a leaf in proportion to
        its size, then a uniform coordinate in each of its dimensions, with
        replacement (a collision, probability ≤ k²/2p, only lowers the
        sketch's rank by one); weights are refused there."""
        if indices is not None:
            return self.check(indices)
        if self.total < 2 ** 31:
            kk = min(k, self.total)
            if weights is None and self.total < RANDPERM_BELOW:
                flat = torch.randperm(self.total, generator=rng)[:kk]
            elif weights is None:
                return self.from_flat(self._uniform_distinct(rng, kk))
            else:
                w = weights.detach().to('cpu', torch.float64).reshape(-1)
                if w.shape != (self.total,):
                    raise ValueError(f'weights must be ({self.total},), '
                                     f'got {tuple(w.shape)}')
                u = torch.rand(self.total, generator=rng, dtype=torch.float64)
                gumbel = -torch.log(-torch.log(u))
                flat = torch.topk(gumbel + torch.log(w / w.sum()), kk).indices
            return self.from_flat(flat.numpy())
        if weights is not None:
            raise ValueError('importance sampling needs p < 2^31')
        probs = torch.tensor(self.sizes, dtype=torch.float64) / self.total
        leaf = torch.multinomial(probs, k, replacement=True, generator=rng)
        sizes_k = torch.as_tensor(self._dim_table)[leaf]          # (k, R)
        u = torch.rand((k, self.max_rank), generator=rng, dtype=torch.float64)
        dims = torch.minimum((u * sizes_k).long(), sizes_k - 1)
        return self._structured(leaf.numpy(), dims.numpy())

    def _uniform_distinct(self, rng: torch.Generator, k: int) -> np.ndarray:
        """k distinct flat indices in [0, p), uniform without replacement,
        in O(k) time and memory: uniform draws, a repeat dropped and drawn
        again (sequential rejection, so every ordered k-subset is equally
        likely). ``randperm(p)`` would cost O(p): 7 GB of int64 at
        p ≈ 10⁹."""
        picked: list[int] = []
        seen: set[int] = set()
        while len(picked) < k:
            for t in torch.randint(self.total, (k - len(picked),),
                                   generator=rng).tolist():
                if t not in seen:
                    seen.add(t)
                    picked.append(t)
        return np.asarray(picked, np.int64)

    def all_indices(self) -> dict:
        """Every parameter (tiny models only — ExactIHVP)."""
        if self.total >= 2 ** 31:
            raise ValueError('all_indices needs p < 2^31')
        return self.from_flat(np.arange(self.total))
