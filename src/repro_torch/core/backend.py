"""Tall-skinny contraction backends for the Nyström solver.

Everything expensive the Nyström IHVP does after the sketch HVPs is a
contraction against the tall-skinny operand C (p × k):

    ctv        t = Cᵀ v       → (k,)      (apply pass 1)
    cv         u = C w        → p-vector  (apply pass 2)
    gram       G = CᵀC        → (k, k)    (prepare)
    mul_right  B = C M        → p × j     (spectral whitening)

and their m-query forms (``ctm``, ``cm``, ``combinem``) over a (p, m)
block. A backend owns the operand's layout. Three ship:

* ``tree``  — C stays a parameter tree with a leading k axis; per-leaf
  einsums. The parity oracle for the others.
* ``flat``  — the tree is fused once into a sketch-major (k, p) buffer;
  every contraction is one ``torch.matmul`` with f32 accumulation.
* ``cuda``  — the fused buffer in the (p, k) layout, with ``gram``,
  ``ctv``, ``ctm``, ``combine`` and ``combinem`` in the hand-written CUDA
  kernels of :mod:`repro_torch.kernels`. It stands where the reference's
  ``pallas`` backend stands. ``cv``, ``cm``, ``cross`` and ``mul_right``
  stay ``torch.matmul``, as the reference leaves them to XLA.

The flat family takes ``sketch_dtype=`` (default f32): a bf16 buffer halves
the sketch's memory while every contraction still accumulates in f32.
Buffers concatenate leaves in JAX's order (dict keys sorted), so they equal
the reference's element for element.
"""
from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TreeBackend:
    """Per-leaf einsum contractions on the parameter tree."""
    name = 'tree'

    def prepare_operand(self, C: PyTree):
        return C

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
class FlatBackend:
    """One ``torch.matmul`` per contraction over the sketch-major (k, p)
    buffer; f32 accumulation whatever ``sketch_dtype`` stores."""
    name = 'flat'
    sketch_dtype: Any = torch.float32

    def prepare_operand(self, C: PyTree) -> torch.Tensor:
        return flatten_sketch(C, dtype=self.sketch_dtype)

    def vec(self, v: PyTree) -> torch.Tensor:
        return flatten_vec(v)

    def unvec(self, u: torch.Tensor, like: PyTree) -> PyTree:
        return unflatten_vec(u, like)

    def ctv(self, Ckp: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
        return _mm(Ckp, vf)

    def cv(self, Ckp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _mm(w, Ckp)

    def gram(self, Ckp: torch.Tensor) -> torch.Tensor:
        return self.cross(Ckp, Ckp)

    def cross(self, Akp: torch.Tensor, Bkp: torch.Tensor) -> torch.Tensor:
        return _mm(Akp, Bkp.T)

    def mul_right(self, Ckp: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        return _mm(M.T, Ckp).to(self.sketch_dtype)            # (j, p)

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

    def prepare_operand(self, C: PyTree) -> torch.Tensor:
        return torch.cat([c.to(self.sketch_dtype).reshape(c.shape[0], -1).T
                          for c in tree_leaves(C)], dim=0).contiguous()  # (p, k)

    def ctv(self, Cpk: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
        return ops.woodbury_ctv(Cpk, vf)

    def cv(self, Cpk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _mm(Cpk, w)

    def gram(self, Cpk: torch.Tensor) -> torch.Tensor:
        return ops.nystrom_gram(Cpk)

    def cross(self, Apk: torch.Tensor, Bpk: torch.Tensor) -> torch.Tensor:
        return _mm(Apk.T, Bpk)

    def mul_right(self, Cpk: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        return _mm(Cpk, M).to(self.sketch_dtype)              # (p, j)

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


BACKENDS = {'tree': TreeBackend, 'flat': FlatBackend, 'cuda': CudaBackend}


def get_backend(name: str, **kwargs):
    """'tree' | 'flat' | 'cuda' → backend instance. kwargs reach the
    constructor (``sketch_dtype=`` for the flat family)."""
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise ValueError(
            f'unknown backend {name!r}; expected one of {sorted(BACKENDS)}')
    return cls(**kwargs)
