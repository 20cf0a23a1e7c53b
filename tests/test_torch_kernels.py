"""Parity of the port's kernel modules with the reference's Pallas kernels.

On the CPU the port's wrappers run their plain versions
(``repro_torch/kernels/ref.py``); the reference's kernels run as
``tests/test_kernels.py`` runs them here, in Pallas interpret mode. Shapes
are small (p ≤ 4,096), ragged against ``block_p``, over k ∈ {1, 10, 64},
m ∈ {1, 3, 32}, f32 and bf16.

Tolerance: rtol 1e-5, atol 1e-5·‖ref‖∞. Both sides widen their inputs to
f32 (bf16 inputs are the identical bf16 values, widened exactly) and
accumulate in f32, in different orders; the difference is f32 roundoff of
the sum. Results are compared as applied values (t, G, u, U).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _lib
from repro_torch.kernels import ops

DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}
BLOCK_P = 1024


def _pair(shape, seed, dtype):
    """The same values as a jax array and a torch tensor of one dtype."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jd)
    tx = torch.tensor(x).to(td)
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    return jx, tx


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('k', [1, 10, 64])
@pytest.mark.parametrize('p', [1000, 4096])
def test_nystrom_gram(p, k, dtype):
    jC, tC = _pair((p, k), 0, dtype)
    got = ops.nystrom_gram(tC)
    assert got.dtype == torch.float32 and got.shape == (k, k)
    _close(got, jops.nystrom_gram(jC, block_p=BLOCK_P, interpret=True))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('m', [1, 3, 32])
@pytest.mark.parametrize('k', [1, 10, 64])
def test_nystrom_cross(k, m, dtype):
    p = 3000
    jA, tA = _pair((p, k), 1, dtype)
    jB, tB = _pair((p, m), 2, dtype)
    got = ops.nystrom_cross(tA, tB)
    assert got.shape == (k, m)
    _close(got, jops.nystrom_cross(jA, jB, block_p=BLOCK_P, interpret=True))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('k', [1, 10, 64])
def test_woodbury_ctv_vector_and_block(k, dtype):
    p = 2500
    jC, tC = _pair((p, k), 3, dtype)
    jv, tv = _pair((p,), 4, 'f32')
    _close(ops.woodbury_ctv(tC, tv),
           jops.woodbury_ctv(jC, jv, block_p=BLOCK_P, interpret=True))
    jV, tV = _pair((p, 3), 5, 'f32')
    _close(ops.woodbury_ctv(tC, tV),
           jops.woodbury_ctv(jC, jV, block_p=BLOCK_P, interpret=True))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('k,rho', [(1, 1.0), (10, 0.1), (64, 0.01)])
def test_woodbury_apply_vector(k, rho, dtype):
    p = 2049
    jC, tC = _pair((p, k), 6, dtype)
    jw, tw = _pair((k,), 7, 'f32')
    jv, tv = _pair((p,), 8, 'f32')
    got = ops.woodbury_apply(tC, tw, tv, rho)
    assert got.shape == (p,) and got.dtype == torch.float32
    _close(got, jops.woodbury_apply(jC, jw, jv, rho, block_p=BLOCK_P,
                                    interpret=True))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('k,m', [(1, 3), (10, 32), (64, 32), (64, 1)])
def test_woodbury_apply_block(k, m, dtype):
    p, rho = 3001, 0.05
    jC, tC = _pair((p, k), 9, dtype)
    jW, tW = _pair((k, m), 10, 'f32')
    jV, tV = _pair((p, m), 11, 'f32')
    got = ops.woodbury_apply(tC, tW, tV, rho)
    assert got.shape == (p, m)
    _close(got, jops.woodbury_apply(jC, jW, jV, rho, block_p=BLOCK_P,
                                    interpret=True))


def test_nystrom_ihvp_apply_matches_reference_pipeline():
    """The composed Eq. 6 apply (ctv → gram → Jacobi k×k solve → apply).
    rtol 1e-4: the k×k solve amplifies the contractions' roundoff by the
    scaled system's condition number."""
    p, r, k, rho = 96, 12, 16, 0.05
    rng = np.random.RandomState(6)
    A = rng.randn(p, r).astype(np.float32)
    H = A @ A.T
    idx = rng.choice(p, k, replace=False)
    C = H[:, idx]
    H_KK = 0.5 * (C[idx, :] + C[idx, :].T)
    v = rng.randn(p).astype(np.float32)
    want = np.asarray(jops.nystrom_ihvp_apply(
        jnp.asarray(C), jnp.asarray(H_KK), jnp.asarray(v), rho,
        interpret=True))
    got = ops.nystrom_ihvp_apply(torch.tensor(C), torch.tensor(H_KK),
                                 torch.tensor(v), rho)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_cpu_tensors_take_the_plain_path_and_are_not_counted():
    _lib.reset_launches()
    C = torch.randn(100, 4)
    ops.nystrom_gram(C)
    ops.woodbury_ctv(C, torch.randn(100))
    ops.woodbury_apply(C, torch.randn(4), torch.randn(100), 0.1)
    assert set(_lib.LAUNCHES.values()) == {0}


@pytest.mark.parametrize('call', [
    lambda: ops.nystrom_gram(torch.randn(10)),
    lambda: ops.nystrom_gram(torch.randn(10, 3, dtype=torch.float64)),
    lambda: ops.nystrom_cross(torch.randn(10, 3), torch.randn(11, 2)),
    lambda: ops.woodbury_ctv(torch.randn(10, 3), torch.randn(9)),
    lambda: ops.woodbury_apply(torch.randn(10, 3), torch.randn(2),
                               torch.randn(10), 0.1),
    lambda: ops.woodbury_apply(torch.randn(10, 3), torch.randn(3, 2),
                               torch.randn(10, 3), 0.1),
    lambda: ops.woodbury_apply(torch.randn(10, 3), torch.randn(3),
                               torch.randn(10), 0.0),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_row_split_covers_p_in_whole_tiles():
    for p in (1, 15, 16, 17, 26122, 2 ** 24):
        nblocks, rows = _lib.split_rows(p)
        assert rows % _lib.ROW_TILE == 0
        assert nblocks <= _lib.MAX_BLOCKS
        assert (nblocks - 1) * rows < p <= nblocks * rows
