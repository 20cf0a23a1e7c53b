"""Parity of the port's contraction backends with the reference's.

Every contraction of every port backend ('tree', 'flat', 'cuda' with its
kernels' plain versions on the CPU, f32 and bf16 sketches) is held against
the reference's 'flat' backend on the same tree, through the backend's own
vec/unvec so that layouts cannot hide a permutation. Tolerance: rtol 1e-5,
atol 1e-5·‖ref‖∞ (f32 sums in different orders); bf16 sketches compare
with the reference's bf16 sketch (the identical rounded values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import get_backend as jget_backend
from repro_torch.convert import to_torch
from repro_torch.core.backend import CudaBackend, get_backend
from repro_torch.core.tree_util import tree_leaves

K, M, RHO = 5, 3, 0.07


def _tree(lead=(), trail=(), seed=0):
    rng = np.random.RandomState(seed)
    shapes = {'w': (4, 6), 'b': (6,), 'z': [(3,), (2, 2)]}
    return jax.tree.map(
        lambda s: rng.randn(*lead, *s, *trail).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))


def _port_backends():
    return {
        'tree': get_backend('tree'),
        'flat': get_backend('flat'),
        'cuda': CudaBackend(),
        'flat_bf16': get_backend('flat', sketch_dtype=torch.bfloat16),
        'cuda_bf16': CudaBackend(sketch_dtype=torch.bfloat16),
    }


def _ref_backend(name):
    if name.endswith('bf16'):
        return jget_backend('flat', sketch_dtype=jnp.bfloat16)
    return jget_backend('flat')


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got_leaves, want_leaves = [got], [want]
    else:
        got_leaves, want_leaves = tree_leaves(got), jax.tree.leaves(want)
    for a, b in zip(got_leaves, want_leaves):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.detach().float().numpy(), b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize('name', list(_port_backends()))
def test_contractions_match_reference(name):
    be = _port_backends()[name]
    jbe = _ref_backend(name)
    C, v, V = _tree(lead=(K,)), _tree(seed=1), _tree(trail=(M,), seed=2)
    w = np.random.RandomState(3).randn(K).astype(np.float32)
    W = np.random.RandomState(4).randn(K, M).astype(np.float32)
    Mx = np.random.RandomState(5).randn(K, 2).astype(np.float32)
    jC = jbe.prepare_operand(jax.tree.map(jnp.asarray, C))
    jv, jV = jbe.vec(jax.tree.map(jnp.asarray, v)), jbe.vecm(
        jax.tree.map(jnp.asarray, V))
    op = be.prepare_operand(to_torch(C))
    tv, tV = be.vec(to_torch(v)), be.vecm(to_torch(V))
    tw, tW = torch.tensor(w), torch.tensor(W)

    _close(be.ctv(op, tv), jbe.ctv(jC, jv))
    _close(be.gram(op), jbe.gram(jC))
    _close(be.ctm(op, tV), jbe.ctm(jC, jV))
    _close(be.unvec(be.cv(op, tw), to_torch(v)),
           jbe.unvec(jbe.cv(jC, jnp.asarray(w)), v))
    _close(be.unvec(be.combine(op, tw, tv, RHO), to_torch(v)),
           jbe.unvec(jbe.combine(jC, jnp.asarray(w), jv, RHO), v))
    _close(be.unvecm(be.cm(op, tW), to_torch(V)),
           jbe.unvecm(jbe.cm(jC, jnp.asarray(W)), V))
    _close(be.unvecm(be.combinem(op, tW, tV, RHO), to_torch(V)),
           jbe.unvecm(jbe.combinem(jC, jnp.asarray(W), jV, RHO), V))
    # mul_right then gram: the whitening step, layout-free
    B, jB = be.mul_right(op, torch.tensor(Mx)), jbe.mul_right(
        jC, jnp.asarray(Mx))
    _close(be.gram(B), jbe.gram(jB))
    _close(be.cross(op, B), jbe.cross(jC, jB))


def test_fused_buffers_equal_the_reference_element_for_element():
    C = _tree(lead=(K,))
    flat = get_backend('flat').prepare_operand(to_torch(C))
    np.testing.assert_array_equal(
        flat.numpy(),
        np.asarray(jget_backend('flat').prepare_operand(
            jax.tree.map(jnp.asarray, C))))
    cuda = CudaBackend().prepare_operand(to_torch(C))
    assert cuda.is_contiguous() and cuda.shape == flat.T.shape
    np.testing.assert_array_equal(cuda.numpy(), flat.T.numpy())


def test_bf16_sketch_is_stored_bf16_and_accumulates_f32():
    be = CudaBackend(sketch_dtype=torch.bfloat16)
    op = be.prepare_operand(to_torch(_tree(lead=(K,))))
    assert op.dtype == torch.bfloat16
    assert be.gram(op).dtype == torch.float32
    assert be.mul_right(op, torch.eye(K)).dtype == torch.bfloat16


def test_cuda_backend_runs_where_its_operand_lies():
    """On CPU tensors every pass is the kernel's plain version: nothing is
    launched, and the results are the flat backend's."""
    from repro_torch.kernels import _lib
    be, flat = get_backend('cuda'), get_backend('flat')
    C = to_torch(_tree(lead=(K,)))
    op = be.prepare_operand(C)
    assert op.device.type == 'cpu'
    _lib.reset_launches()
    np.testing.assert_allclose(be.gram(op).numpy(),
                               flat.gram(flat.prepare_operand(C)).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not any(_lib.LAUNCHES.values())


def test_unknown_backend_is_rejected():
    with pytest.raises(ValueError, match='unknown backend'):
        get_backend('pallas')
