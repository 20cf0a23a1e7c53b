"""The lean sketch build: the fused buffer is allocated once in
``sketch_dtype`` and the backend's layout, each chunk of HVP columns is
written into it and dropped, and ``mul_right``/``cv`` upcast C a block of
rows at a time. Held bitwise against the old path (all k one-hot tangents
at once, the columns concatenated, then fused: ``flatten_sketch`` for
'flat', transposed copies concatenated for 'cuda'; whole-buffer upcasts),
on the 'tree', 'flat' and 'cuda' backends (the last runs its kernels' plain
versions on the CPU), f32 and bf16 sketches, several ``column_chunk``
values, k = 7 not a multiple of the chunk; the row-blocked contractions at
the real block size. Also the uniform column draw: ``randperm``'s below
``RANDPERM_BELOW``, the O(k) draw above it."""
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro_torch.core import NystromIHVP, PyTreeIndexer, make_hvp
from repro_torch.core import backend as backend_mod
from repro_torch.core import tree_util
from repro_torch.core.backend import (CudaBackend, FlatBackend, TreeBackend,
                                      _mm, flatten_sketch)
from repro_torch.core.hvp import extract_columns
from repro_torch.core.solvers import _EIG_REL_TOL
from repro_torch.core.tree_util import tree_leaves, tree_map
from torch_threads import torch_thread_cap  # noqa: F401

K = 7


def _problem():
    g = torch.Generator().manual_seed(0)
    params = {'l1': {'w': torch.randn(6, 5, generator=g) * 0.5,
                     'b': torch.randn(5, generator=g) * 0.1},
              'l2': {'w': torch.randn(5, 3, generator=g) * 0.5}}
    x = torch.randn(16, 6, generator=g)
    y = torch.randn(16, 3, generator=g)

    def loss(p, h, batch):
        xb, yb = batch
        hdn = torch.tanh(xb @ p['l1']['w'] + p['l1']['b'])
        return ((hdn @ p['l2']['w'] - yb) ** 2).mean() + h * sum(
            (l ** 2).sum() for l in tree_leaves(p))

    return params, make_hvp(loss, params, torch.tensor(0.01), (x, y))


def _old_columns(hvp, indexer, idx, chunk):
    """The old extraction: every one-hot at once, chunks sliced off."""
    tangents = indexer.one_hots(idx)
    k = idx['leaf'].shape[0]
    chunk = k if chunk is None else max(1, min(chunk, k))
    if chunk >= k:
        return vmap(hvp)(tangents)
    parts = [vmap(hvp)(tree_map(lambda t: t[s:s + chunk], tangents))
             for s in range(0, k, chunk)]
    return tree_map(lambda *xs: torch.cat(xs, 0), *parts)


def _old_operand(be, C):
    if be.name == 'tree':
        return C
    if be.name == 'flat':
        return flatten_sketch(C, dtype=be.sketch_dtype)
    return torch.cat([c.to(be.sketch_dtype).reshape(c.shape[0], -1).T
                      for c in tree_leaves(C)], dim=0).contiguous()


def _old_mul_right(be, C, M):
    if be.name == 'flat':
        return _mm(M.T, C).to(be.sketch_dtype)
    return _mm(C, M).to(be.sketch_dtype)


def _draw(indexer):
    return indexer.sample_indices(torch.Generator().manual_seed(3), K)


@pytest.mark.parametrize('chunk', [None, 1, 3, 7, 10])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', ['flat', 'cuda'])
def test_fused_buffer_and_whitened_factor_are_bitwise_the_old_path(
        name, dtype, chunk):
    params, hvp = _problem()
    indexer = PyTreeIndexer(params)
    idx = _draw(indexer)
    be = {'flat': FlatBackend, 'cuda': CudaBackend}[name](sketch_dtype=dtype)
    sketch = NystromIHVP(k=K, column_chunk=chunk, backend=be).prepare(
        hvp, indexer, None, indices=idx)
    C_tree = _old_columns(hvp, indexer, idx, chunk)
    C_old = _old_operand(be, C_tree)
    assert sketch.C.dtype == dtype and sketch.C.is_contiguous()
    assert sketch.C.shape == ((K, indexer.total) if name == 'flat'
                              else (indexer.total, K))
    assert torch.equal(sketch.C, C_old)
    H_KK = indexer.gather(C_tree, idx)
    H_KK = 0.5 * (H_KK + H_KK.T)
    assert torch.equal(sketch.H_KK, H_KK)
    lam, U = torch.linalg.eigh(H_KK)
    tol = _EIG_REL_TOL * (torch.max(torch.abs(lam)) + 1e-30) * K
    inv_sqrt = torch.where(lam > tol, 1.0 / torch.sqrt(torch.maximum(lam,
                                                                     tol)),
                           torch.zeros_like(lam))
    B_old = _old_mul_right(be, C_old, U * inv_sqrt[None, :])
    assert torch.equal(sketch.B, B_old)
    assert torch.equal(be.prepare_operand(C_tree), C_old)


@pytest.mark.parametrize('chunk', [None, 2, 3])
def test_tree_backend_keeps_its_tree(chunk):
    params, hvp = _problem()
    indexer = PyTreeIndexer(params)
    idx = _draw(indexer)
    sketch = NystromIHVP(k=K, column_chunk=chunk, backend=TreeBackend()
                         ).prepare(hvp, indexer, None, indices=idx)
    old = _old_columns(hvp, indexer, idx, chunk)
    for a, b in zip(tree_leaves(sketch.C), tree_leaves(old)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(extract_columns(hvp, indexer, idx, chunk)),
                    tree_leaves(old)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', ['flat', 'cuda'])
def test_row_blocked_contractions_at_the_real_block(name, dtype):
    """p = ROW_BLOCK + 4099 (two blocks, the second a short tail), k = 8:
    ``mul_right`` (which makes B) is bitwise the unblocked product. ``cv``
    (a matrix-vector product) is within 1e-6 of it: on the CPU, BLAS takes
    another path for the tail's 4099 rows and can move a row's last bit."""
    g = torch.Generator().manual_seed(5)
    p, k = backend_mod.ROW_BLOCK + 4099, 8
    C = torch.randn(p, k, generator=g).to(dtype)
    be = {'flat': FlatBackend, 'cuda': CudaBackend}[name](sketch_dtype=dtype)
    op = C.T.contiguous() if name == 'flat' else C
    del C
    M = torch.randn(k, k, generator=g)
    w = torch.randn(k, generator=g)
    B = be.mul_right(op, M)
    assert B.dtype == dtype
    assert torch.equal(B, _old_mul_right(be, op, M))
    del B
    u = be.cv(op, w)
    whole = _mm(w, op) if name == 'flat' else _mm(op, w)
    assert u.dtype == torch.float32 and u.shape == (p,)
    torch.testing.assert_close(u, whole, rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))


@pytest.fixture
def o_k_draw(monkeypatch):
    """Sample as a tree of p ≥ ``RANDPERM_BELOW`` does: the O(k) draw."""
    monkeypatch.setattr(tree_util, 'RANDPERM_BELOW', 0)


def test_small_trees_keep_randperms_draw():
    params, _ = _problem()
    indexer = PyTreeIndexer(params)
    idx = indexer.sample_indices(torch.Generator().manual_seed(4), 6)
    want = torch.randperm(indexer.total,
                          generator=torch.Generator().manual_seed(4))[:6]
    assert _flat(indexer, idx) == want.tolist()


def test_uniform_draw_is_distinct_in_range_and_reproducible(o_k_draw):
    params, _ = _problem()
    indexer = PyTreeIndexer(params)
    p = indexer.total
    for k in (1, 5, p):
        idx = indexer.sample_indices(torch.Generator().manual_seed(k), k)
        flat = _flat(indexer, idx)
        assert len(set(flat)) == k and min(flat) >= 0 and max(flat) < p
        again = indexer.sample_indices(torch.Generator().manual_seed(k), k)
        assert _flat(indexer, again) == flat


def test_uniform_draw_covers_the_coordinates_evenly(o_k_draw):
    params, _ = _problem()
    indexer = PyTreeIndexer(params)
    p = indexer.total
    gen = torch.Generator().manual_seed(11)
    counts = np.zeros(p)
    n = 3000
    for _ in range(n):
        for j in _flat(indexer, indexer.sample_indices(gen, 4)):
            counts[j] += 1
    expected = 4 * n / p
    # chi-square with p - 1 = 47 degrees of freedom: 99.9% quantile ~ 82
    assert ((counts - expected) ** 2 / expected).sum() < 82


def _flat(indexer, idx):
    offs = np.cumsum([0] + indexer.sizes)
    strides = indexer._stride_table
    return [int(offs[l] + (np.asarray(d) * strides[l]).sum())
            for l, d in zip(idx['leaf'].tolist(), idx['dims'].tolist())]
