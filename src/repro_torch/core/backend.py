"""Tall-skinny contraction backends for the Nyström solver.

Everything expensive the Nyström IHVP does after the sketch HVPs is a
contraction against the tall-skinny operand C (p × k):

    ctv        t = Cᵀ v       → (k,)      (apply pass 1)
    cv         u = C w        → p-vector  (apply pass 2)
    gram       G = CᵀC        → (k, k)    (prepare)
    mul_right  B = C M        → p × j     (spectral whitening)
    slice_k    C[:, a:a+w]    → p × w     (Alg. 1's chunks)

and their m-query forms (``ctm``, ``cm``, ``combinem``) over a (p, m)
block. A backend owns the operand's layout. Four ship:

* ``tree``  — C stays a parameter tree with a leading k axis; per-leaf
  einsums. The parity oracle for the others.
* ``flat``  — the tree is fused once into a sketch-major (k, p) buffer;
  every contraction is one ``torch.matmul`` with f32 accumulation.
* ``cuda``  — the fused buffer in the (p, k) layout, with ``gram``,
  ``ctv``, ``ctm``, ``combine`` and ``combinem`` in the hand-written CUDA
  kernels of :mod:`repro_torch.kernels`. It stands where the reference's
  ``pallas`` backend stands. ``cv``, ``cm``, ``cross`` and ``mul_right``
  stay ``torch.matmul``, as the reference leaves them to XLA.
* ``flat_sharded`` — under a mesh (:mod:`repro_torch.distributed`), each
  rank's own blocks of the leaves fused in the 'cuda' layout, through the
  same kernels, with one ``all_reduce`` per k-output pass
  (:class:`FlatShardedBackend`).

The flat family takes ``sketch_dtype=`` (default f32): a bf16 buffer halves
the sketch's memory while every contraction still accumulates in f32.
Buffers concatenate leaves in JAX's order (dict keys sorted), so they equal
the reference's element for element.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.tree_util import (PyTree, tree_axpy, tree_flatten,
                                        tree_leaves, tree_map, tree_scale,
                                        tree_sub)
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# tree <-> fused-buffer conversion
# ---------------------------------------------------------------------------
def flatten_sketch(C: PyTree, dtype=torch.float32) -> torch.Tensor:
    """Fuse a leading-k tree (leaves (k, *shape)) into one (k, p) buffer of
    ``dtype``, leaves concatenated in JAX's leaf order."""
    return torch.cat([c.to(dtype).reshape(c.shape[0], -1)
                      for c in tree_leaves(C)], dim=1)


def flatten_vec(v: PyTree) -> torch.Tensor:
    """Parameter tree → (p,) f32, same leaf order as ``flatten_sketch``."""
    return torch.cat([x.float().reshape(-1) for x in tree_leaves(v)])


def unflatten_vec(u: torch.Tensor, like: PyTree) -> PyTree:
    """(p,) → tree shaped and typed like ``like``."""
    leaves, treedef = tree_flatten(like)
    outs, off = [], 0
    for l in leaves:
        n = l.numel()
        outs.append(u[off:off + n].reshape(l.shape).to(l.dtype))
        off += n
    return treedef.unflatten(outs)


def flatten_vecm(V: PyTree) -> torch.Tensor:
    """Query-block tree (every leaf = param shape + trailing (m,)) → (p, m)
    f32, rows in ``flatten_vec``'s leaf order."""
    return torch.cat([x.float().reshape(-1, x.shape[-1])
                      for x in tree_leaves(V)], dim=0)


def unflatten_vecm(U: torch.Tensor, like: PyTree) -> PyTree:
    """(p, m) → query-block tree shaped and typed like ``like``."""
    leaves, treedef = tree_flatten(like)
    outs, off = [], 0
    for l in leaves:
        rows = l.numel() // l.shape[-1]
        outs.append(U[off:off + rows].reshape(l.shape).to(l.dtype))
        off += rows
    return treedef.unflatten(outs)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A matmul accumulated and returned in f32 whatever the storage type."""
    return a.float() @ b.float()


# Rows of p that a row-wise contraction (``cv``, ``mul_right``) upcasts and
# multiplies at a time: 2²⁴ rows of a k = 8 sketch are 512 MiB in f32, where
# the whole of a p ≈ 10⁹ bf16 sketch would be 28 GB.
ROW_BLOCK = 1 << 24


def _by_rows(f, C: torch.Tensor, axis: int, out_shape: tuple,
             out_axis: int, dtype) -> torch.Tensor:
    """``f(C)`` for an ``f`` whose every output row (index ``r`` along
    ``out_axis``) depends only on C's row r (along ``axis``, the p axis):
    ``ROW_BLOCK`` rows at a time into one output of ``dtype``, so that the
    f32 upcast inside ``f`` never holds more than a block. Each row is the
    same sum of k products either way; the BLAS may still order a short
    tail block's sums differently (on the CPU ``cv``'s matrix-vector product
    moves some rows' last bit there, ``mul_right``'s B stays bitwise:
    ``tests/test_torch_lm_build.py``)."""
    p = C.shape[axis]
    if p <= ROW_BLOCK:
        return f(C).to(dtype)
    out = torch.empty(out_shape, dtype=dtype, device=C.device)
    for r in range(0, p, ROW_BLOCK):
        n = min(ROW_BLOCK, p - r)
        out.narrow(out_axis, r, n).copy_(f(C.narrow(axis, r, n)))
    return out


class _TreeSink:
    """The tree backend's operand from chunks of columns: the chunks'
    leaves concatenated along k at the end (the operand stays a tree)."""

    def __init__(self):
        self.parts: list = []

    def write(self, start: int, cols: PyTree) -> None:
        del start
        self.parts.append(cols)

    def finish(self) -> PyTree:
        if len(self.parts) == 1:
            return self.parts[0]
        return tree_map(lambda *xs: torch.cat(xs, 0), *self.parts)


class _FusedSink:
    """The flat family's operand from chunks of columns: the fused buffer,
    allocated once in ``dtype``, sketch-major (k, p) or row-major (p, k);
    each chunk is written into its rows (resp. columns) as it comes, leaves
    in JAX's order, and may be freed before the next one."""

    def __init__(self, k: int, p: int, dtype, device, k_major: bool):
        self.k_major = k_major
        self.buf = torch.empty((k, p) if k_major else (p, k), dtype=dtype,
                               device=device)

    def write(self, start: int, cols: PyTree) -> None:
        off = 0
        for c in tree_leaves(cols):
            w, n = c.shape[0], math.prod(c.shape[1:])
            src = c.reshape(w, n)
            if self.k_major:
                self.buf[start:start + w, off:off + n].copy_(src)
            else:
                self.buf[off:off + n, start:start + w].copy_(src.T)
            off += n

    def finish(self) -> torch.Tensor:
        return self.buf


def _sink_of_tree(be, C: PyTree):
    """``be``'s sink sized for a whole leading-k tree."""
    leaves = tree_leaves(C)
    p = sum(math.prod(l.shape[1:]) for l in leaves)
    return be.operand_sink(leaves[0].shape[0], p, leaves[0].device)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------
class _WholeTrees:
    """What a backend says of the θ-trees it is handed where each rank
    holds them whole: their column indexer and their inner product."""

    def indexer(self, theta: PyTree):
        """The column indexer of ``theta``."""
        from repro_torch.core.tree_util import PyTreeIndexer
        return PyTreeIndexer(theta)

    def vdot(self, a: PyTree, b: PyTree) -> torch.Tensor:
        """⟨a, b⟩ of two θ-trees, f32 accumulation."""
        return sum(tree_leaves(tree_map(
            lambda x, y: torch.sum(x.float() * y.float()), a, b)))


@dataclasses.dataclass(frozen=True)
class TreeBackend(_WholeTrees):
    """Per-leaf einsum contractions on the parameter tree."""
    name = 'tree'

    def prepare_operand(self, C: PyTree):
        return C

    def operand_sink(self, k: int, p: int, device) -> _TreeSink:
        """Where the sketch build writes its chunks of columns."""
        del k, p, device
        return _TreeSink()

    def vec(self, v: PyTree):
        return v

    def unvec(self, u, like: PyTree) -> PyTree:
        del like
        return u

    def ctv(self, C, v) -> torch.Tensor:
        return sum(tree_leaves(tree_map(
            lambda c, x: torch.einsum('k...,...->k', c.float(), x.float()),
            C, v)))

    def cv(self, C, w: torch.Tensor):
        return tree_map(lambda c: torch.einsum('k...,k->...', c.float(), w), C)

    def gram(self, C) -> torch.Tensor:
        return self.cross(C, C)

    def cross(self, A, B) -> torch.Tensor:
        return sum(tree_leaves(tree_map(
            lambda a, b: torch.einsum('k...,j...->kj', a.float(), b.float()),
            A, B)))

    def mul_right(self, C, M: torch.Tensor):
        return tree_map(
            lambda c: torch.einsum('k...,kj->j...', c.float(), M), C)

    def slice_k(self, C, start: int, width: int):
        return tree_map(lambda c: c[start:start + width], C)

    def scale(self, x, s):
        return tree_scale(x, s)

    def sub(self, a, b):
        return tree_sub(a, b)

    def add(self, a, b):
        return tree_map(torch.add, a, b)

    def combine(self, C, w: torch.Tensor, v, rho: float):
        """u = v/ρ + C w (the Woodbury pass 2)."""
        return tree_axpy(1.0, self.cv(C, w), tree_scale(v, 1.0 / rho))

    # -- matrix-valued queries: trailing (m,) axis on every leaf ------------
    def vecm(self, V: PyTree):
        return V

    def unvecm(self, U, like: PyTree) -> PyTree:
        del like
        return U

    def ctm(self, C, V) -> torch.Tensor:
        """CᵀV over an m-query block → (k, m)."""
        return sum(tree_leaves(tree_map(
            lambda c, x: torch.einsum('k...,...m->km', c.float(), x.float()),
            C, V)))

    def cm(self, C, W: torch.Tensor):
        """C W for W (k, m) → a query-block tree."""
        return tree_map(
            lambda c: torch.einsum('k...,km->...m', c.float(), W), C)

    def combinem(self, C, W: torch.Tensor, V, rho: float):
        """U = V/ρ + C W (the Woodbury pass 2, m queries at once)."""
        return tree_axpy(1.0, self.cm(C, W), tree_scale(V, 1.0 / rho))


@dataclasses.dataclass(frozen=True)
class FlatBackend(_WholeTrees):
    """One ``torch.matmul`` per contraction over the sketch-major (k, p)
    buffer; f32 accumulation whatever ``sketch_dtype`` stores."""
    name = 'flat'
    sketch_dtype: Any = torch.float32

    k_major = True     # the fused buffer is (k, p)

    def prepare_operand(self, C: PyTree) -> torch.Tensor:
        """The fused buffer of a whole leading-k tree (equal to
        ``flatten_sketch(C, sketch_dtype)``, or its transpose for 'cuda')."""
        sink = _sink_of_tree(self, C)
        sink.write(0, C)
        return sink.finish()

    def operand_sink(self, k: int, p: int, device) -> _FusedSink:
        """The fused buffer, allocated once in ``sketch_dtype``, that the
        sketch build writes its chunks of columns into."""
        return _FusedSink(k, p, self.sketch_dtype, device, self.k_major)

    def vec(self, v: PyTree) -> torch.Tensor:
        return flatten_vec(v)

    def unvec(self, u: torch.Tensor, like: PyTree) -> PyTree:
        return unflatten_vec(u, like)

    def ctv(self, Ckp: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
        return _mm(Ckp, vf)

    def cv(self, Ckp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _by_rows(lambda c: _mm(w, c), Ckp, 1, (Ckp.shape[1],), 0,
                        torch.float32)

    def gram(self, Ckp: torch.Tensor) -> torch.Tensor:
        c = Ckp.float()          # one upcast serves both operands
        return c @ c.T

    def cross(self, Akp: torch.Tensor, Bkp: torch.Tensor) -> torch.Tensor:
        return _mm(Akp, Bkp.T)

    def mul_right(self, Ckp: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        return _by_rows(lambda c: _mm(M.T, c), Ckp, 1,          # (j, p)
                        (M.shape[1], Ckp.shape[1]), 1, self.sketch_dtype)

    def slice_k(self, Ckp: torch.Tensor, start: int,
                width: int) -> torch.Tensor:
        return Ckp[start:start + width]             # rows: contiguous

    def scale(self, x: torch.Tensor, s) -> torch.Tensor:
        return x * s

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a - b

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a + b

    def combine(self, Ckp: torch.Tensor, w: torch.Tensor, vf: torch.Tensor,
                rho: float) -> torch.Tensor:
        return vf / rho + self.cv(Ckp, w)

    # -- matrix-valued queries: (p, m) fused blocks -------------------------
    def vecm(self, V: PyTree) -> torch.Tensor:
        return flatten_vecm(V)

    def unvecm(self, U: torch.Tensor, like: PyTree) -> PyTree:
        return unflatten_vecm(U, like)

    def ctm(self, Ckp: torch.Tensor, Vm: torch.Tensor) -> torch.Tensor:
        return _mm(Ckp, Vm)

    def cm(self, Ckp: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        return _mm(Ckp.T, W)

    def combinem(self, Ckp: torch.Tensor, W: torch.Tensor, Vm: torch.Tensor,
                 rho: float) -> torch.Tensor:
        return Vm / rho + self.cm(Ckp, W)


@dataclasses.dataclass(frozen=True)
class CudaBackend(FlatBackend):
    """Fused (p, k) buffer with the C-streaming passes in the hand-written
    CUDA kernels (``repro_torch/csrc``): ``gram`` and ``ctm`` in kernel A,
    ``ctv`` in kernel B, ``combine``/``combinem`` in kernel C. Each pass
    reads C from device memory once.

    It runs where its operand lies: on a CUDA tensor every pass launches its
    kernel (or raises), on a CPU tensor the kernels' plain versions run (the
    CPU tests). The device is chosen once, where the problem's tensors are
    made: the entry points raise without a card unless ``device='cpu'``.
    """
    name = 'cuda'
    k_major = False    # the fused buffer is (p, k)

    def ctv(self, Cpk: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
        return ops.woodbury_ctv(Cpk, vf)

    def cv(self, Cpk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _by_rows(lambda c: _mm(c, w), Cpk, 0, (Cpk.shape[0],), 0,
                        torch.float32)

    def gram(self, Cpk: torch.Tensor) -> torch.Tensor:
        return ops.nystrom_gram(Cpk)

    def cross(self, Apk: torch.Tensor, Bpk: torch.Tensor) -> torch.Tensor:
        return _mm(Apk.T, Bpk)

    def mul_right(self, Cpk: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        return _by_rows(lambda c: _mm(c, M), Cpk, 0,            # (p, j)
                        (Cpk.shape[0], M.shape[1]), 0, self.sketch_dtype)

    def slice_k(self, Cpk: torch.Tensor, start: int,
                width: int) -> torch.Tensor:
        # a column slice is a strided view, which the kernels refuse: copy
        return Cpk[:, start:start + width].contiguous()

    def combine(self, Cpk: torch.Tensor, w: torch.Tensor, vf: torch.Tensor,
                rho: float) -> torch.Tensor:
        # woodbury_apply computes v/ρ − C w̃/ρ²; w̃ = −ρ² w gives v/ρ + C w.
        return ops.woodbury_apply(Cpk, -(rho * rho) * w, vf, rho)

    def ctm(self, Cpk: torch.Tensor, Vm: torch.Tensor) -> torch.Tensor:
        return ops.woodbury_ctv(Cpk, Vm)

    def cm(self, Cpk: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        return _mm(Cpk, W)

    def combinem(self, Cpk: torch.Tensor, W: torch.Tensor, Vm: torch.Tensor,
                 rho: float) -> torch.Tensor:
        return ops.woodbury_apply(Cpk, -(rho * rho) * W, Vm, rho)


# ---------------------------------------------------------------------------
# flat_sharded: per-rank fused buffers + one all-reduce per k-output pass
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedOperand:
    """FlatShardedBackend's operand: this rank's fused buffer and its
    reduction weights.

    ``buf`` is (p_local, k), the 'cuda' backend's layout, fused from this
    rank's blocks of the sketch's leaves only. ``w`` is the (p_local,) f32
    vector of 1/replication weights: a sum over the whole mesh counts each
    distinct parameter once even where a leaf is replicated along some
    axes. ``w_exact`` records that every weight is a power of two, so that
    a buffer scaled by them loses nothing in its own dtype."""
    buf: torch.Tensor
    w: torch.Tensor
    w_exact: bool = True


class _ShardedSink:
    """FlatShardedBackend's operand from chunks of columns: each chunk's
    leaves (full, (width, *shape)) give up this rank's block (over a split
    model they are that block already), which is written into the
    (p_local, k) buffer, allocated at the first chunk."""

    def __init__(self, be, k: int, device):
        self.be, self.k, self.device = be, k, device
        self.buf = self.plan = None

    def write(self, start: int, cols: PyTree) -> None:
        from repro_torch.distributed.sharding import block_slices
        leaves = tree_leaves(cols)
        if self.plan is None:
            self.plan = self.be._plan(cols, lead=1)
            p_local = sum(e[2] for e in self.plan)
            self.buf = torch.empty((p_local, self.k),
                                   dtype=self.be.sketch_dtype,
                                   device=self.device)
        off = 0
        for c, (gshape, spec, lsize, _) in zip(leaves, self.plan):
            w = c.shape[0]
            blk = c if self.be.split else c[
                (slice(None),) + block_slices(gshape, spec, self.be.mesh)]
            self.buf[off:off + lsize, start:start + w].copy_(
                blk.reshape(w, lsize).T)
            off += lsize

    def finish(self) -> ShardedOperand:
        w, exact = self.be._weights(self.plan, self.buf.device)
        return ShardedOperand(buf=self.buf, w=w, w_exact=exact)


@dataclasses.dataclass(frozen=True, eq=False)
class FlatShardedBackend(_WholeTrees):
    """``flat``'s fusion under a mesh (the reference's ``flat_sharded``):
    each rank fuses only its blocks of the sketch's leaves (``specs``, a
    spec tree over the parameters, e.g.
    :func:`~repro_torch.distributed.sharding.param_specs`; entries that
    cannot shard a leaf degrade to replication, ``specs=None`` replicates
    all) into a (p_local, k) buffer, the 'cuda' backend's layout.

    The k-output reductions (``ctv``; ``gram``, ``cross`` and ``ctm`` at
    k × k or k × m) run on the local buffer, columns weighted by
    1/replication, and end in exactly one ``all_reduce(SUM)`` over the
    whole mesh: one (k, m) all-reduce per pass of an m-query apply, not m
    of them (the reference's ``FLAT_SHARDED_CONTRACT``). The p-output
    passes (``cv``, ``mul_right``, ``combine``, ``cm``, ``combinem``) are
    local and need no collective. On a CUDA buffer ``ctv`` runs in kernel
    B (on v·w), ``gram``, ``cross`` and ``ctm`` in kernel A (the weights on
    one operand: one temporary (p_local, k) or (p_local, m) copy, in the
    buffer's dtype when every weight is a power of two, else f32), and
    ``combine``/``combinem`` in kernel C, as in ``CudaBackend``; on a CPU
    buffer their plain versions run. Nothing falls back to a library call.

    With a replicated model (``split=False``) vectors come in full and
    ``vec`` takes this rank's blocks; ``unvec`` gathers the blocks of a
    result into whole leaves with one more ``all_reduce`` an apply, which
    the replicated model's Eq. 3 mixed term needs. Over a model split on
    the mesh (``split=True``, :mod:`repro_torch.models.split`; ``specs``
    its sanitized spec tree) every tree is this rank's blocks already:
    ``vec`` fuses them as they come, the HVP columns are written as they
    are, and ``unvec`` hands the blocks back with no collective. Then
    :meth:`indexer` draws columns over the whole leaves and :meth:`vdot`
    is the inner product of two such trees over the mesh."""
    name = 'flat_sharded'
    mesh: Any = None
    specs: Any = None
    sketch_dtype: Any = torch.float32
    split: bool = False

    k_major = False    # the fused buffer is (p_local, k)

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError(
                "flat_sharded requires a mesh: get_backend('flat_sharded', "
                "mesh=mesh, specs=param_spec_tree)")

    # -- shard planning (host side; specs × mesh × leaf shapes) ------------
    def _plan(self, tree, lead: int, trail: int = 0) -> list:
        """Per leaf (global shape, sanitized spec, local size, weight) in
        ``tree_leaves`` order; ``lead`` leading and ``trail``
        trailing unsharded dims (the sketch's k, a block's m) are left
        out."""
        from repro_torch.distributed.sharding import (global_shape,
                                                      local_shape,
                                                      replication_factor,
                                                      sanitize_spec,
                                                      specs_like)
        plan = []
        for leaf, sp in zip(tree_leaves(tree), specs_like(tree, self.specs)):
            gshape = tuple(leaf.shape)[lead:leaf.ndim - trail]
            if self.split:
                gshape = global_shape(gshape, sp, self.mesh)
            sp = sanitize_spec(gshape, sp, self.mesh)
            lsize = math.prod(local_shape(gshape, sp, self.mesh))
            plan.append((gshape, sp, lsize,
                         1.0 / replication_factor(sp, self.mesh)))
        return plan

    def _weights(self, plan, device):
        w = torch.cat([torch.full((lsize,), weight, dtype=torch.float32,
                                  device=device)
                       for _, _, lsize, weight in plan if lsize])
        exact = all(math.frexp(weight)[0] == 0.5
                    for _, _, _, weight in plan)
        return w, exact

    def _local(self, tree, lead: int, trail: int) -> list:
        from repro_torch.distributed.sharding import block_slices
        if self.split:
            return tree_leaves(tree)
        out = []
        for leaf, (gshape, sp, _, _) in zip(tree_leaves(tree),
                                            self._plan(tree, lead, trail)):
            idx = ((slice(None),) * lead + block_slices(gshape, sp, self.mesh)
                   + (slice(None),) * trail)
            out.append(leaf[idx])
        return out

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed.ctx import _all_reduce
        return _all_reduce(x, self.mesh, None, 'sum', 'psum')

    def _weighted(self, C: ShardedOperand) -> torch.Tensor:
        """C's buffer scaled by its weights row by row: the one temporary
        copy of ``gram`` and ``cross``."""
        if C.w_exact:
            return C.buf * C.w[:, None].to(C.buf.dtype)
        return C.buf.float() * C.w[:, None]

    # -- tree <-> per-rank fused form ----------------------------------------
    def prepare_operand(self, C: PyTree) -> ShardedOperand:
        leaves = tree_leaves(C)
        sink = self.operand_sink(leaves[0].shape[0], None, leaves[0].device)
        sink.write(0, C)
        return sink.finish()

    def operand_sink(self, k: int, p, device) -> _ShardedSink:
        del p
        return _ShardedSink(self, k, device)

    def vec(self, v: PyTree) -> torch.Tensor:
        return torch.cat([x.float().reshape(-1)
                          for x in self._local(v, 0, 0)])

    def vecm(self, V: PyTree) -> torch.Tensor:
        return torch.cat([x.float().reshape(-1, x.shape[-1])
                          for x in self._local(V, 0, 1)], dim=0)

    def _unfuse(self, u: torch.Tensor, like: PyTree, trail: int) -> PyTree:
        """(p_local, *m) → the leaves of ``like``, gathered whole with one
        ``all_reduce`` over the mesh of the zero-padded blocks, each
        shard written by one of its replicas."""
        from repro_torch.distributed.sharding import (block_slices,
                                                      holds_first_replica,
                                                      local_shape)
        leaves, treedef = tree_flatten(like)
        plan = self._plan(like, 0, trail)
        tail = tuple(u.shape[1:])
        sizes = [math.prod(g) for g, _, _, _ in plan]
        full = u.new_zeros((sum(sizes),) + tail)
        off = goff = 0
        for (gshape, sp, lsize, _), n in zip(plan, sizes):
            if holds_first_replica(sp, self.mesh):
                view = full[goff:goff + n].view(gshape + tail)
                view[block_slices(gshape, sp, self.mesh)] = (
                    u[off:off + lsize].reshape(
                        local_shape(gshape, sp, self.mesh) + tail))
            off, goff = off + lsize, goff + n
        from repro_torch.distributed.ctx import _all_reduce
        full = _all_reduce(full, self.mesh, None, 'sum', 'gather')
        outs, goff = [], 0
        for l, n in zip(leaves, sizes):
            outs.append(full[goff:goff + n].reshape(l.shape).to(l.dtype))
            goff += n
        return treedef.unflatten(outs)

    def unvec(self, u: torch.Tensor, like: PyTree) -> PyTree:
        if self.split:
            return unflatten_vec(u, like)
        return self._unfuse(u, like, 0)

    def unvecm(self, U: torch.Tensor, like: PyTree) -> PyTree:
        if self.split:
            return unflatten_vecm(U, like)
        return self._unfuse(U, like, 1)

    # -- a split model's trees ----------------------------------------------
    def indexer(self, theta: PyTree):
        """The column indexer of ``theta``: over the whole leaves where the
        model is split (every rank draws the same columns and builds its
        blocks of them), plain otherwise."""
        from repro_torch.core.tree_util import PyTreeIndexer
        if self.split:
            return PyTreeIndexer(theta, mesh=self.mesh, specs=self.specs)
        return super().indexer(theta)

    def vdot(self, a: PyTree, b: PyTree) -> torch.Tensor:
        """⟨a, b⟩ of two θ-trees: over the mesh where they are a split
        model's blocks (:func:`~repro_torch.distributed.ctx.split_vdot`),
        the plain sum otherwise."""
        if self.split:
            from repro_torch.distributed.ctx import split_vdot
            return split_vdot(a, b, self.specs, self.mesh)
        return super().vdot(a, b)

    # -- reductions: a local contraction + one all_reduce ------------------
    def ctv(self, C: ShardedOperand, vf: torch.Tensor) -> torch.Tensor:
        return self._psum(ops.woodbury_ctv(C.buf, vf * C.w))

    def gram(self, C: ShardedOperand) -> torch.Tensor:
        return self.cross(C, C)

    def cross(self, A: ShardedOperand, B: ShardedOperand) -> torch.Tensor:
        return self._psum(ops.nystrom_cross(self._weighted(A), B.buf))

    def ctm(self, C: ShardedOperand, Vm: torch.Tensor) -> torch.Tensor:
        """CᵀV over an m-query block → (k, m): exactly one all-reduce of
        k × m floats a pass, whatever m."""
        return self._psum(ops.nystrom_cross(C.buf, Vm * C.w[:, None]))

    # -- p-output passes: 'cuda''s on the local buffer, no collective -----
    def cv(self, C: ShardedOperand, w: torch.Tensor) -> torch.Tensor:
        return CudaBackend.cv(self, C.buf, w)

    def mul_right(self, C: ShardedOperand, M: torch.Tensor) -> ShardedOperand:
        return ShardedOperand(buf=CudaBackend.mul_right(self, C.buf, M),
                              w=C.w, w_exact=C.w_exact)

    def combine(self, C: ShardedOperand, w: torch.Tensor, vf: torch.Tensor,
                rho: float) -> torch.Tensor:
        return CudaBackend.combine(self, C.buf, w, vf, rho)

    def cm(self, C: ShardedOperand, W: torch.Tensor) -> torch.Tensor:
        return CudaBackend.cm(self, C.buf, W)

    def combinem(self, C: ShardedOperand, W: torch.Tensor, Vm: torch.Tensor,
                 rho: float) -> torch.Tensor:
        return CudaBackend.combinem(self, C.buf, W, Vm, rho)

    # -- structural helpers (operand- and vector-form aware) ---------------
    def slice_k(self, C: ShardedOperand, start: int,
                width: int) -> ShardedOperand:
        # a column slice is a strided view, which the kernels refuse: copy
        return ShardedOperand(buf=C.buf[:, start:start + width].contiguous(),
                              w=C.w, w_exact=C.w_exact)

    def scale(self, x, s):
        if isinstance(x, ShardedOperand):
            return ShardedOperand(buf=x.buf * s, w=x.w, w_exact=x.w_exact)
        return x * s

    def sub(self, a, b):
        if isinstance(a, ShardedOperand):
            return ShardedOperand(buf=a.buf - b.buf, w=a.w, w_exact=a.w_exact)
        return a - b

    def add(self, a, b):
        if isinstance(a, ShardedOperand):
            return ShardedOperand(buf=a.buf + b.buf, w=a.w, w_exact=a.w_exact)
        return a + b


BACKENDS = {'tree': TreeBackend, 'flat': FlatBackend, 'cuda': CudaBackend,
            'flat_sharded': FlatShardedBackend}


def get_backend(name: str, **kwargs):
    """'tree' | 'flat' | 'cuda' | 'flat_sharded' → backend instance. kwargs
    reach the constructor (``sketch_dtype=`` for the flat family,
    ``mesh=``/``specs=`` for 'flat_sharded').

    >>> get_backend('flat_sharded')
    Traceback (most recent call last):
        ...
    ValueError: flat_sharded requires a mesh: get_backend('flat_sharded', \
mesh=mesh, specs=param_spec_tree)
    """
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise ValueError(
            f'unknown backend {name!r}; expected one of {sorted(BACKENDS)}')
    return cls(**kwargs)
