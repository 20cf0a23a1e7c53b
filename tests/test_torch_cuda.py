"""The hand-written CUDA kernels against their plain versions, on the card.

Skips where there is no CUDA card (decided inside the fixture, never at
import). Tolerance of the Nyström kernels: f32 rtol 1e-5, atol 1e-5·‖ref‖∞;
bf16 inputs the same, after the identical upcast (both sides widen the same
bf16 values to f32 and accumulate f32, in different orders). RMSNorm and
flash attention: |err| ≤ atol + rtol·|ref|, in f32 with the tolerances of
``tests/test_kernels.py`` (atol = rtol = 1e-5 and 2e-5), RMSNorm in bf16
likewise at 2e-2, and flash in bf16 within one ulp of the rounded output
(rtol 2⁻⁷, atol 1e-5): both sides compute in f32 from the same widened
inputs, and only the final rounding differs. Kernel E's tensor-core
variant is held to the same one-ulp gate: its products take the bf16
inputs exactly and accumulate in f32, and its probabilities enter P·V as
two bf16 fragments (hi + lo) that carry 16 bits of them.
"""
import pytest
import torch

from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels.flash_attention import expand_kv

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
                             'woodbury_apply_block': 1, 'rmsnorm': 0,
                             'flash_attention': 0, 'flash_attention_tc': 0}


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    C = _randn((64, 8), torch.float32, cuda, 6)
    with pytest.raises(ValueError, match='contiguous'):
        ops.nystrom_gram(C.T.contiguous().T)
    with pytest.raises(ValueError, match='different devices'):
        ops.woodbury_ctv(C, torch.randn(64))
    with pytest.raises(ValueError, match='k, m <= 256'):
        ops.nystrom_gram(_randn((64, 300), torch.float32, cuda, 7))


def _rel_close(got, want, tol, rtol=None):
    """Elementwise |got − want| ≤ tol + rtol·|want| (rtol defaults to tol),
    in f32."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    rtol = tol if rtol is None else rtol
    assert bool((err <= tol + rtol * want.abs()).all()), float(err.max())


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('shape', [(4, 128), (2, 3, 256), (5, 640),
                                   (64, 4096), (7, 1000), (9, 1001), (3, 5)])
@pytest.mark.parametrize('scale_dtype', [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, tol, shape, scale_dtype):
    x = _randn(shape, dtype, cuda, 8)
    s = _randn(shape[-1:], scale_dtype, cuda, 9)
    got = ops.rmsnorm(x, s, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    _rel_close(got, ref.rmsnorm(x, s, 1e-5), tol)


def test_rmsnorm_kernel_takes_unaligned_rows(cuda):
    """d = 1001 bf16 rows start off the 16-byte grid (scalar head and
    tail), and a view that starts 2 bytes in is re-based by the wrapper."""
    x = _randn((6, 1002), torch.bfloat16, cuda, 10)[:, 1:]
    s = _randn((1001,), torch.bfloat16, cuda, 11)
    _rel_close(ops.rmsnorm(x, s), ref.rmsnorm(x, s), 2e-2)


@pytest.mark.parametrize('dtype,tol,rtol', [(torch.float32, 2e-5, 2e-5),
                                            (torch.bfloat16, 1e-5, 2 ** -7)])
@pytest.mark.parametrize('B,S,H,hd', [(1, 128, 2, 64), (2, 256, 4, 128),
                                      (1, 100, 3, 40), (1, 192, 2, 256),
                                      (2, 64, 2, 30), (1, 2048, 2, 128)])
@pytest.mark.parametrize('causal', [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, tol, rtol, B, S, H, hd,
                                    causal):
    q, k, v = (_randn((B, S, H, hd), dtype, cuda, 12 + i) for i in range(3))
    got = ops.flash_attention(q, k, v, causal=causal, q_block=S, k_block=S)
    assert got.dtype == dtype and got.shape == q.shape
    _rel_close(got, ref.flash_attention(q, k, v, causal=causal), tol, rtol)


def test_flash_kernel_reads_strided_and_uneven_lengths(cuda):
    """q, k, v as strided views of one fused projection, T ≠ S unmasked."""
    B, S, T, H, hd = 2, 96, 160, 4, 64
    qkv = _randn((B, T, 3, H, hd), torch.float32, cuda, 15)
    q, k, v = qkv[:, :S, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = ops.flash_attention(q, k, v, causal=False, q_block=32, k_block=32)
    _rel_close(got, ref.flash_attention(q, k, v, causal=False), 2e-5)


def test_model_kernels_are_counted_and_forward_only(cuda):
    _lib.reset_launches()
    x = _randn((8, 64), torch.float32, cuda, 16)
    ops.rmsnorm(x, torch.ones(64, device=cuda))
    q = _randn((1, 64, 2, 32), torch.float32, cuda, 17)
    ops.flash_attention(q, q, q)
    assert (_lib.LAUNCHES['rmsnorm'], _lib.LAUNCHES['flash_attention']) \
        == (1, 1)
    with pytest.raises(RuntimeError, match='forward-only'):
        ops.rmsnorm(x.requires_grad_(), torch.ones(64, device=cuda))
    with torch.no_grad():
        ops.rmsnorm(x, torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match='divide block'):
        ops.flash_attention(q, q, q, q_block=48)


def _flash_checked(q, k, v, causal, tensor_cores):
    """Kernel E on q, k, v (KV heads in place), held to one bf16 ulp (or
    2e-5 in f32) against the plain version on the expanded heads; the
    variant that launched must be ``tensor_cores``."""
    H, KV = q.shape[2], k.shape[2]
    before = dict(_lib.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal, q_block=q.shape[1],
                              k_block=k.shape[1])
    assert _lib.LAUNCHES['flash_attention'] == before['flash_attention'] + 1
    assert (_lib.LAUNCHES['flash_attention_tc']
            - before['flash_attention_tc']) == int(tensor_cores)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = ref.flash_attention(q, expand_kv(k, H // KV), expand_kv(v, H // KV),
                               causal=causal)
    if q.dtype == torch.float32:
        _rel_close(got, want, 2e-5)
    else:
        _rel_close(got, want, 1e-5, 2 ** -7)


@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('S', [64, 100, 2048])
@pytest.mark.parametrize('causal', [True, False])
def test_flash_tensor_core_kernel_matches_plain(cuda, hd, S, causal):
    B, H = (1, 2) if S == 2048 else (2, 4)
    q, k, v = (_randn((B, S, H, hd), torch.bfloat16, cuda, 20 + i)
               for i in range(3))
    _flash_checked(q, k, v, causal, tensor_cores=True)


@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('KV', [1, 2])
@pytest.mark.parametrize('causal', [True, False])
def test_flash_kernel_reads_gqa_heads_in_place(cuda, hd, KV, causal):
    B, S, H = 2, 320, 8
    q = _randn((B, S, H, hd), torch.bfloat16, cuda, 23)
    k, v = (_randn((B, S, KV, hd), torch.bfloat16, cuda, 24 + i)
            for i in range(2))
    _flash_checked(q, k, v, causal, tensor_cores=True)


@pytest.mark.parametrize('causal', [True, False])
def test_flash_tensor_cores_read_views_of_a_fused_projection(cuda, causal):
    """q, k, v as strided head ranges of one (B, S, H + 2 KV, hd)
    projection: TMA reads them through their strides."""
    B, S, H, KV, hd = 2, 256, 8, 2, 128
    qkv = _randn((B, S, H + 2 * KV, hd), torch.bfloat16, cuda, 26)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    _flash_checked(q, k, v, causal, tensor_cores=True)


@pytest.mark.parametrize('dtype,hd,shift,tensor_cores', [
    (torch.bfloat16, 128, 0, True),
    (torch.bfloat16, 128, 4, False),   # base 8 bytes off the 16-byte grid
    (torch.bfloat16, 96, 0, False),    # hd not in {64, 128}
    (torch.float32, 128, 0, False),    # f32 stays on the CUDA cores
])
def test_flash_variant_follows_the_dispatch_rule(cuda, dtype, hd, shift,
                                                 tensor_cores):
    B, S, H, KV = 1, 192, 4, 2

    def shifted(shape, seed):
        x = _randn(shape, dtype, cuda, seed)
        buf = x.new_empty(x.numel() + shift)
        out = buf[shift:].view(shape)
        out.copy_(x)
        return out
    q = shifted((B, S, H, hd), 27)
    k, v = (shifted((B, S, KV, hd), 28 + i) for i in range(2))
    _flash_checked(q, k, v, True, tensor_cores)


def test_flash_takes_broadcast_kv_views(cuda):
    """k and v broadcast over their heads (stride 0, which TMA cannot
    address) run the CUDA-core kernel and still read the heads in place."""
    B, S, H, KV, hd = 2, 128, 4, 2, 128
    q = _randn((B, S, H, hd), torch.bfloat16, cuda, 31)
    k, v = (_randn((B, S, 1, hd), torch.bfloat16, cuda, 32 + i).expand(
        B, S, KV, hd) for i in range(2))
    _flash_checked(q, k, v, True, tensor_cores=False)
