"""The hand-written CUDA kernels against their plain versions, on the card.

Skips where there is no CUDA card (decided inside the fixture, never at
import). Tolerance: f32 rtol 1e-5, atol 1e-5·‖ref‖∞; bf16 inputs the same,
after the identical upcast (both sides widen the same bf16 values to f32
and accumulate f32, in different orders).
"""
import pytest
import torch

from repro_torch.kernels import _lib, ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _close(got, want):
    torch.cuda.synchronize()
    atol = 1e-5 * float(want.abs().max().clamp(min=1e-30))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


def _randn(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('p,k,m', [(26122, 10, 32), (4097, 64, 3),
                                   (100, 1, 1), (3001, 256, 16)])
def test_kernels_match_plain_versions(cuda, dtype, p, k, m):
    C = _randn((p, k), dtype, cuda, 0)
    v = _randn((p,), torch.float32, cuda, 1)
    V = _randn((p, m), torch.float32, cuda, 2)
    w = _randn((k,), torch.float32, cuda, 3)
    W = _randn((k, m), torch.float32, cuda, 4)
    _close(ops.nystrom_gram(C), ref.nystrom_gram(C))
    _close(ops.nystrom_cross(C, V), ref.nystrom_cross(C, V))
    _close(ops.woodbury_ctv(C, v), ref.woodbury_ctv(C, v))
    if k * m <= 8192:
        for rho in (0.01, 1.0):
            _close(ops.woodbury_apply(C, w, v, rho),
                   ref.woodbury_apply(C, w, v, rho))
            _close(ops.woodbury_apply(C, W, V, rho),
                   ref.woodbury_apply(C, W, V, rho))


def test_launches_are_counted_and_deterministic(cuda):
    _lib.reset_launches()
    C = _randn((50000, 16), torch.float32, cuda, 5)
    a, b = ops.nystrom_gram(C), ops.nystrom_gram(C)
    assert torch.equal(a, b)
    ops.woodbury_ctv(C, C[:, 0].contiguous())
    ops.woodbury_apply(C, C[0], C[:, 1].contiguous(), 0.1)
    ops.woodbury_apply(C, C[:2].T.contiguous(), C[:, :2].contiguous(), 0.1)
    assert _lib.LAUNCHES == {'nystrom_gram': 2, 'nystrom_cross': 0,
                             'woodbury_ctv': 1, 'woodbury_apply': 1,
                             'woodbury_apply_block': 1}


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    C = _randn((64, 8), torch.float32, cuda, 6)
    with pytest.raises(ValueError, match='contiguous'):
        ops.nystrom_gram(C.T.contiguous().T)
    with pytest.raises(ValueError, match='different devices'):
        ops.woodbury_ctv(C, torch.randn(64))
    with pytest.raises(ValueError, match='k, m <= 256'):
        ops.nystrom_gram(_randn((64, 300), torch.float32, cuda, 7))
