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

Alg. 1's chunked apply through the kernels (B on every chunk factor and
refine sweep, A's cross in the block form) is held to the same apply with
each kernel replaced by its plain version evaluated in f64, on the card, at
relative L2 ≤ 1e-4 (the gate of ``chip_smoke.py``'s hypergradients: each
chunk inverts a κ×κ system, which multiplies the contractions' roundoff).
Both build the factors with the same cuBLAS calls, so a bf16 factor is
rounded from the same f32 values on both sides.

The seventh slice's block paths (iMAML's vmapped backward over a shared
sketch, influence's (p, 32) query block) are held to the same plain
versions in f64 at the same 1e-4, and must launch exactly one cross and
one block apply each (``refine=0``: one Woodbury pass).

The serving tier's flushes (the eighth slice) are held to the same service
on ``backend='flat'`` at the same 1e-4 of max |score|, with the launches
of a cold m = 1 flush and a warm m = 4 flush counted exactly.

The ninth slice's gates (``chip_smoke.py`` phase 17): second derivatives
through ``implicit_root`` and the engine's two registered graphs, the
kernels against ``backend='flat'`` at 1e-4 relative, with kernels A, B
and C each launched on the way.

The tenth slice's lean sketch build on the card: at p ≈ 2²⁰ the fused
buffer (written chunk by chunk) and B bitwise equal to the old path's, and
the row-blocked ``mul_right`` bitwise the unblocked product at the real
block size (``cv`` within 1e-6, as on the CPU).

The eleventh slice at ``reduced()`` size: ``forward`` (MoE layers
included) and ``build_serve_step``'s decode on the card against the port
on the CPU in f32 (relative L2 1e-5, no kernel launched in decode), and a
MoE prefill's launches of kernels D (twice a layer) and E (once a layer,
on the tensor cores in bf16), with the f32 kernel path against the plain
path at 1e-4.

The twelfth slice: kernel E at the new families' shapes (SeamlessM4T's
non-causal encoder at hd 64, Qwen2-VL's GQA group of 7) and kernel D at
their widths (d = 3584 and 1024), at the gates above; then each new
family at ``reduced()`` size on the card against the port on the CPU in
f32 (forward, 8 decode steps, relative L2 1e-5), with kernels D and E
launched by its prefill as the reference's ``use_pallas`` says and none
by its decode.

The fifteenth slice: one Mamba and one RWKV-6 layer's backward on the
card at 2 × 256 (the time loops by chunks of 64 under
``torch.utils.checkpoint``) against the same layer on the CPU, f32,
relative L2 ≤ 1e-4 on the output and on every gradient.
"""
import ctypes
import math

import pytest
import torch

from repro_torch.core.backend import CudaBackend
from repro_torch.core.solvers import NystromIHVP, NystromSketch
from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels.flash_attention import expand_kv
from torch_threads import torch_thread_cap  # noqa: F401

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
                             'flash_attention': 0, 'nystrom_gram_tc': 0,
                             'nystrom_cross_tc': 0, 'flash_attention_tc': 0}
    Cb = C.bfloat16()
    ops.nystrom_gram(Cb)
    ops.nystrom_cross(Cb, Cb[:, :8].contiguous())
    assert (_lib.LAUNCHES['nystrom_gram'], _lib.LAUNCHES['nystrom_gram_tc'],
            _lib.LAUNCHES['nystrom_cross'],
            _lib.LAUNCHES['nystrom_cross_tc']) == (3, 1, 1, 1)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    C = _randn((64, 8), torch.float32, cuda, 6)
    with pytest.raises(ValueError, match='contiguous'):
        ops.nystrom_gram(C.T.contiguous().T)
    with pytest.raises(ValueError, match='different devices'):
        ops.woodbury_ctv(C, torch.randn(64))
    # k = 300, which PR 15's kernel A refused: computed, not refused
    C300 = _randn((64, 300), torch.float32, cuda, 7)
    _close(ops.nystrom_gram(C300), ref.nystrom_gram(C300))
    # kernel A's C entry, asked for the tensor-core variant on operands it
    # cannot take, refuses them and runs nothing in their place
    Cb = _shifted(_randn((3001, 64), torch.bfloat16, cuda, 8))
    for A in (Cb, C, Cb[:, :10].contiguous()):
        with pytest.raises(RuntimeError, match='invalid argument'):
            _lib.check(_rt_atb(A, tensor_cores=1), 'atb')


def _rt_atb(A, tensor_cores):
    """Kernel A's C entry on the gram of A, with the variant forced."""
    p, k = A.shape
    nblocks, rows = _lib.split_rows(p, _lib.ATB_ROWS, _lib.sm_count(A.device))
    partial = torch.empty((nblocks, k * k), device=A.device)
    out = torch.empty((k, k), device=A.device)
    return _lib.lib().rt_atb(
        A.data_ptr(), _lib.DTYPE_CODE[A.dtype], A.data_ptr(),
        _lib.DTYPE_CODE[A.dtype], partial.data_ptr(), out.data_ptr(), p, k, k,
        1, tensor_cores, nblocks, rows, _lib.stream())


def _shifted(t):
    """t's values in a tensor whose base address is 8 bytes past the
    16-byte grid (strides unchanged)."""
    n = 8 // t.element_size()
    buf = t.new_empty(t.numel() + n)
    out = buf[n:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 8
    return out


def _atb_checked(A, B, gram):
    """Kernel A on A, B (gram: B is A), held to the plain version; the
    variant it launched must be the rule's; two calls agree bit for bit and
    a gram is exactly symmetric."""
    p, k = A.shape
    m = B.shape[1]
    rule = _lib.atb_variant(A.dtype, B.dtype, p, k, m,
                            (A.data_ptr(), B.data_ptr()))
    name = 'nystrom_gram' if gram else 'nystrom_cross'
    before = dict(_lib.LAUNCHES)
    got = ops.nystrom_gram(A) if gram else ops.nystrom_cross(A, B)
    assert _lib.LAUNCHES[name] == before[name] + 1
    assert (_lib.LAUNCHES[name + '_tc'] - before[name + '_tc']
            == int(rule == 'tensor_cores'))
    assert got.dtype == torch.float32 and got.shape == (k, m)
    _close(got, ref.nystrom_gram(A) if gram else ref.nystrom_cross(A, B))
    again = ops.nystrom_gram(A) if gram else ops.nystrom_cross(A, B)
    assert torch.equal(got, again)
    if gram:
        assert torch.equal(got, got.T)
    return rule


ATB_KS = [1, 10, 16, 64, 100, 256]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k', ATB_KS)
def test_gram_variants_match_plain(cuda, dtype, k):
    """p = 3001 is a whole number of no tile (16, 128 rows); bf16 with
    k % 8 == 0 runs on the tensor cores, the rest on the CUDA cores."""
    C = _randn((3001, k), dtype, cuda, 40 + k)
    rule = _atb_checked(C, C, gram=True)
    assert (rule == 'tensor_cores') == (dtype == torch.bfloat16
                                        and k % 8 == 0)


@pytest.mark.parametrize('dtypes', [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)],
                         ids=['f32', 'bf16-f32', 'f32-bf16', 'bf16'])
@pytest.mark.parametrize('m', [1, 3, 32, 256])
@pytest.mark.parametrize('k', ATB_KS)
def test_cross_variants_match_plain(cuda, dtypes, k, m):
    A = _randn((3001, k), dtypes[0], cuda, 50 + k)
    B = _randn((3001, m), dtypes[1], cuda, 60 + m)
    rule = _atb_checked(A, B, gram=False)
    assert (rule == 'tensor_cores') == (dtypes == (torch.bfloat16,) * 2
                                        and k % 8 == 0 and m % 8 == 0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_atb_off_the_grid_takes_the_cuda_cores(cuda, dtype):
    """Bases 8 bytes off the 16-byte grid: the rule names the CUDA-core
    variant, whose staging then takes plain loads."""
    C = _shifted(_randn((5000, 64), dtype, cuda, 70))
    V = _shifted(_randn((5000, 32), dtype, cuda, 71))
    assert _atb_checked(C, C, gram=True) == 'cuda_cores'
    assert _atb_checked(C, V, gram=False) == 'cuda_cores'


def test_atb_large_bf16_gram_on_the_tensor_cores(cuda):
    """Many stages per block, against the plain version in f64."""
    C = _randn((1_000_003, 64), torch.bfloat16, cuda, 72)
    before = _lib.LAUNCHES['nystrom_gram_tc']
    got = ops.nystrom_gram(C)
    assert _lib.LAUNCHES['nystrom_gram_tc'] == before + 1
    _close(got, ref.nystrom_gram(C.double()).float())
    assert torch.equal(got, got.T)


def test_atb_past_int32_rows_takes_the_cuda_cores(cuda):
    """p ≥ 2³¹ rows (an 8.6 GB f32 column of ones): beyond TMA's int32 row
    coordinate, so the rule names the CUDA-core variant, whose rows are
    int64; the gram is p."""
    p = 2 ** 31 + 5
    C = torch.ones((p, 1), device=cuda)
    assert _lib.atb_variant(C.dtype, C.dtype, p, 1, 1,
                            (C.data_ptr(),)) == 'cuda_cores'
    before = _lib.LAUNCHES['nystrom_gram']
    got = ops.nystrom_gram(C)
    assert _lib.LAUNCHES['nystrom_gram'] == before + 1
    torch.cuda.synchronize()
    assert abs(float(got) - p) <= 1e-5 * p
    del C


APPLY_KM = [(k, m) for k in ATB_KS for m in (1, 3, 32, 256)]


@pytest.mark.parametrize('v_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k,m', APPLY_KM)
def test_apply_forms_match_plain(cuda, c_dtype, v_dtype, k, m):
    """Kernel C, vector (m = 1) and block form; p = 3001 is a whole number
    of no stage; two calls agree bit for bit."""
    p = 3001
    C = _randn((p, k), c_dtype, cuda, 80 + k)
    V = _randn((p, m), v_dtype, cuda, 81)
    W = _randn((k, m), torch.float32, cuda, 82)
    if m == 1:
        V, W = V[:, 0].contiguous(), W[:, 0].contiguous()
    before = dict(_lib.LAUNCHES)
    got = ops.woodbury_apply(C, W, V, 0.05)
    name = 'woodbury_apply' if m == 1 else 'woodbury_apply_block'
    assert _lib.LAUNCHES[name] == before[name] + 1
    _close(got, ref.woodbury_apply(C, W, V, 0.05))
    assert torch.equal(got, ops.woodbury_apply(C, W, V, 0.05))


@pytest.mark.parametrize('c_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k,m', [(10, 512), (1, 8192), (16, 300),
                                 (512, 16), (300, 3), (4096, 2), (8192, 1),
                                 (1000, 1)])
def test_apply_takes_every_k_m_up_to_8192(cuda, c_dtype, k, m):
    """Kernel C takes any k·m ≤ 8192: the block form in slices of at most
    256 columns of W and V, and, where W's slice and two rows of C do not
    fit in shared memory (k = 4096, m = 2), the vector form once a
    column."""
    p = 3001
    C = _randn((p, k), c_dtype, cuda, 100 + k)
    V = _randn((p, m), torch.float32, cuda, 101)
    W = _randn((k, m), torch.float32, cuda, 102)
    if m == 1:
        V, W = V[:, 0].contiguous(), W[:, 0].contiguous()
    name = 'woodbury_apply' if m == 1 else 'woodbury_apply_block'
    before = _lib.LAUNCHES[name]
    got = ops.woodbury_apply(C, W, V, 0.05)
    assert _lib.LAUNCHES[name] == before + 1
    _close(got, ref.woodbury_apply(C, W, V, 0.05))
    assert torch.equal(got, ops.woodbury_apply(C, W, V, 0.05))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('p,k,m', [(3001, 512, 512), (4097, 64, 256),
                                   (3001, 300, 3), (3001, 100, 32)])
def test_every_kernel_takes_shapes_beyond_256(cuda, dtype, p, k, m):
    """Kernels A, B and C at shapes PR 15 refused (k or m above 256, k·m
    above 8192), and bf16 k = 100 (200-byte rows, off the 16-byte grid):
    gram (exactly symmetric), cross with ``dtype`` and f32 queries, Cᵀv,
    and both apply forms, each against its plain version and bit for bit
    on a second call."""
    C = _randn((p, k), dtype, cuda, 110 + k)
    V = _randn((p, m), torch.float32, cuda, 111)
    v = _randn((p,), torch.float32, cuda, 112)
    w = _randn((k,), torch.float32, cuda, 113)
    W = _randn((k, m), torch.float32, cuda, 114)
    _atb_checked(C, C, gram=True)
    _atb_checked(C, V, gram=False)
    if dtype == torch.bfloat16:   # bf16 x bf16: the tensor cores where
        _atb_checked(C, V.to(dtype), gram=False)   # k, m are multiples of 8
    for call, plain in ((lambda: ops.woodbury_ctv(C, v),
                         lambda: ref.woodbury_ctv(C, v)),
                        (lambda: ops.woodbury_apply(C, w, v, 0.05),
                         lambda: ref.woodbury_apply(C, w, v, 0.05)),
                        (lambda: ops.woodbury_apply(C, W, V, 0.05),
                         lambda: ref.woodbury_apply(C, W, V, 0.05))):
        got = call()
        _close(got, plain())
        assert torch.equal(got, call())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k', [1000, 1, 4, 8, 12, 100, 129, 257])
def test_ctv_takes_any_k(cuda, dtype, k):
    """Kernel B at any k: rows16 windows of 32 chunks (k = 1000), one to 32
    chunks a row, and scalar rows (k = 1, bf16 k = 4, k = 257...)."""
    C = _randn((5003, k), dtype, cuda, 120 + k)
    v = _randn((5003,), dtype, cuda, 121)
    _close(ops.woodbury_ctv(C, v), ref.woodbury_ctv(C, v))


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of the driver API (``cuda.h``)."""
    _fields_ = ([('func', ctypes.c_void_p)]
                + [(f, ctypes.c_uint) for f in ('grid_x', 'grid_y', 'grid_z',
                                                'block_x', 'block_y',
                                                'block_z', 'smem')]
                + [(f, ctypes.c_void_p) for f in ('params', 'extra', 'kern',
                                                  'ctx')])


def _graph_kernels(fn):
    """The names of the device kernels that one ``fn()`` records into a
    CUDA graph, read from the graph's nodes through the driver API (every
    node must be a kernel: no memset, no copy), and ``fn``'s output after
    one replay. A warm-up call on the capturing stream comes first, so that
    per-stream state exists before the capture."""
    cu = ctypes.CDLL('libcuda.so.1')
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        assert kind.value == 0, f'graph node of type {kind.value}'  # kernel
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        assert cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                ctypes.byref(params)) == 0
        assert cu.cuFuncGetName(ctypes.byref(name),
                                ctypes.c_void_p(params.func)) == 0
        names.append(name.value.decode())
    graph.replay()
    torch.cuda.synchronize()
    return out, names


@pytest.mark.parametrize('dtype,k,shift,path', [
    (torch.float32, 64, False, 'ctv_rows16'),
    (torch.bfloat16, 64, False, 'ctv_rows16'),
    (torch.float32, 1000, False, 'ctv_rows16'),
    (torch.float32, 10, False, 'ctv_scalar'),    # the main path's rows
    (torch.float32, 64, True, 'ctv_scalar'),     # base off the 16-byte grid
    (torch.bfloat16, 100, False, 'ctv_scalar'),
])
def test_ctv_one_launch_same_bits_on_both_paths(cuda, dtype, k, shift,
                                                path):
    """Kernel B: one device kernel a call (no reduction kernel, no memset),
    named by the rule's load path, as a CUDA graph captures it; the
    graph's replay and further calls give the same bits."""
    C = _randn((26122, k), dtype, cuda, 130 + k)
    if shift:
        C = _shifted(C)
    v = _randn((26122,), torch.float32, cuda, 131)
    assert _lib.ctv_path(C.dtype, k, C.data_ptr()) == path
    before = _lib.LAUNCHES['woodbury_ctv']
    got, names = _graph_kernels(lambda: ops.woodbury_ctv(C, v))
    assert _lib.LAUNCHES['woodbury_ctv'] == before + 2
    assert len(names) == 1 and path in names[0], names
    _close(got, ref.woodbury_ctv(C, v))
    for _ in range(3):
        assert torch.equal(got, ops.woodbury_ctv(C, v))


def test_ctv_streams_keep_their_own_counters(cuda):
    """Kernel B on a second stream, interleaved with calls on the current
    one: each stream has its own scratch (ticket counter and partials), and
    every call gives the same bits."""
    C = _randn((200003, 64), torch.float32, cuda, 132)
    v = _randn((200003,), torch.float32, cuda, 133)
    want = ops.woodbury_ctv(C, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(4):
        outs.append(ops.woodbury_ctv(C, v))
        with torch.cuda.stream(side):
            outs.append(ops.woodbury_ctv(C, v))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    _close(want, ref.woodbury_ctv(C, v))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m', [1, 32])
def test_apply_off_the_grid_reads_plain(cuda, dtype, m):
    """C 8 bytes off the 16-byte grid: the rule (``_lib.rows16``) sends it
    to the scalar (vector form) or plain (block form) loads."""
    p, k = 4099, 64
    C = _shifted(_randn((p, k), dtype, cuda, 90))
    assert not _lib.rows16(C.dtype, k, C.data_ptr())
    V = _shifted(_randn((p, m), torch.float32, cuda, 91)).squeeze(1)
    W = _randn((k, m), torch.float32, cuda, 92).squeeze(1)
    _close(ops.woodbury_apply(C, W, V, 0.1), ref.woodbury_apply(C, W, V, 0.1))


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


def _low_rank_sketch(p, k, dtype, device, seed, rank=32):
    """A sketch C = H[:, K] of H = G Gᵀ/r + I (G (p, r) Gaussian), built
    without H, on ``device`` with C stored in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    G = torch.randn(p, rank, generator=g) / rank ** 0.5
    K = torch.randperm(p, generator=g)[:k]
    C = G @ G[K].T
    C[K, torch.arange(k)] += 1.0
    H_KK = 0.5 * (C[K] + C[K].T)
    Cpk = C.to(dtype).contiguous().to(device)
    leaf = torch.zeros(k, dtype=torch.int32, device=device)
    return NystromSketch(C=Cpk, H_KK=H_KK.to(device),
                         indices={'leaf': leaf, 'dims': K[:, None].int()},
                         rho=1e-2, gram_C=ref.nystrom_gram(Cpk))


def _plain_f64(dtype):
    """The ``cuda`` backend with each kernel replaced by its plain version
    evaluated in f64 and rounded to f32."""
    def f64(fn):
        return lambda *a: fn(*[x.double() if torch.is_tensor(x) else x
                               for x in a]).float()

    class PlainF64(CudaBackend):
        gram = staticmethod(f64(ref.nystrom_gram))
        ctv = ctm = staticmethod(f64(ref.woodbury_ctv))

        def combine(self, C, w, v, rho):
            return f64(ref.woodbury_apply)(C, -(rho * rho) * w, v, rho)

        combinem = combine

    return PlainF64(sketch_dtype=dtype)


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k,kappa', [(10, 3), (64, 16)])
@pytest.mark.parametrize('m', [1, 32])
def test_chunked_apply_through_the_kernels(cuda, dtype, k, kappa, m):
    p = 20011
    sk = _low_rank_sketch(p, k, dtype, cuda, seed=k + m)
    solver = NystromIHVP(k=k, rho=1e-2, kappa=kappa,
                         backend=CudaBackend(sketch_dtype=dtype))
    v = _randn((p, m) if m > 1 else (p,), torch.float32, cuda, 9)
    _lib.reset_launches()
    got = solver.apply_matrix(sk, v) if m > 1 else solver.apply(sk, v)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    plain = NystromIHVP(k=k, rho=1e-2, kappa=kappa,
                        backend=_plain_f64(dtype))
    want = (plain.apply_matrix if m > 1 else plain.apply)(sk, v)
    assert _rel_l2(got, want) <= 1e-4
    # refine = 1: every factor twice, L once
    passes = 2 * math.ceil(k / kappa) + 1
    assert launches['nystrom_cross' if m > 1 else 'woodbury_ctv'] == passes
    assert launches['woodbury_apply'] == launches['woodbury_apply_block'] == 0


def _rel_tree(a, b):
    from repro_torch.core.tree_util import tree_leaves
    fa = torch.cat([x.reshape(-1).double() for x in tree_leaves(a)])
    fb = torch.cat([x.reshape(-1).double() for x in tree_leaves(b)])
    return float((fa - fb).norm() / fb.norm())


def test_shared_sketch_meta_backward_is_one_block_apply(cuda):
    """vmap(grad(...)) over 8 iMAML tasks at Tab. 3's widths (p = 30,149)
    with one shared sketch and ``refine=0``: the meta-batch's backward
    passes launch kernel A's cross once and kernel C's block form once, at
    m = 8, and no vector kernel; the per-task hypergradients match the same
    run with every kernel's plain version in f64 (relative L2 ≤ 1e-4)."""
    from torch.func import grad, vmap
    from repro_torch.core import implicit_root, sgd_solver
    from repro_torch.tasks import build_imaml
    problem = build_imaml(device=cuda)
    meta = problem.init_hparams(torch.Generator().manual_seed(0))
    (SX, SY), (QX, QY) = problem.data.task_batch(0, 8)
    pooled = (SX.reshape(-1, 20, 20, 1), SY.reshape(-1))

    def per_task(backend):
        solution = implicit_root(
            sgd_solver(problem.inner_loss, 10, 0.1), problem.inner_loss,
            NystromIHVP(k=10, rho=1e-2, refine=0, backend=backend))
        sketch = solution.prepare_state(meta, meta, pooled,
                                        torch.Generator().manual_seed(1))
        _lib.reset_launches()
        g = vmap(lambda sx, sy, qx, qy: grad(lambda m: problem.outer_loss(
            solution(m, (sx, sy), state=sketch), m, (qx, qy)))(meta))(
            SX, SY, QX, QY)
        torch.cuda.synchronize()
        return g, dict(_lib.LAUNCHES)

    got, launches = per_task(CudaBackend())
    want, plain = per_task(_plain_f64(torch.float32))
    assert (launches['nystrom_cross'], launches['woodbury_apply_block'],
            launches['woodbury_ctv'], launches['woodbury_apply']) == (1, 1,
                                                                      0, 0)
    assert not any(plain.values())
    for t in range(8):
        pick = lambda tree: [{k: v[t] for k, v in layer.items()}  # noqa
                             for layer in tree]
        assert _rel_tree(pick(got), pick(want)) <= 1e-4


def test_influence_block_is_one_cross_and_one_block_apply(cuda):
    """``influence`` at p = 26,122 with m = 32 queries and ``refine=0``:
    one gram (the sketch), one cross and one block apply (the (p, 32)
    query block); scores and self-influence match the kernels' plain
    versions in f64 within 1e-4 relative, with equal top-k indices."""
    from repro_torch.core import influence
    from repro_torch.tasks import build_influence
    problem = build_influence(device=cuda)
    params = problem.init_params(torch.Generator().manual_seed(0))
    queries = problem.reference['queries'](32)
    runs = {}
    for name, be in (('kernel', CudaBackend()),
                     ('plain', _plain_f64(torch.float32))):
        _lib.reset_launches()
        res = influence(problem, NystromIHVP(k=10, rho=1e-2, refine=0,
                                             backend=be), queries,
                        params=params, top_k=10, self_influence=True)
        torch.cuda.synchronize()
        runs[name] = res, dict(_lib.LAUNCHES)
    (got, launches), (want, plain) = runs['kernel'], runs['plain']
    assert (launches['nystrom_gram'], launches['nystrom_cross'],
            launches['woodbury_apply_block'], launches['woodbury_ctv'],
            launches['woodbury_apply']) == (1, 1, 1, 0, 0)
    assert not any(plain.values())
    scale = float(want.scores.abs().max())
    assert float((got.scores - want.scores).abs().max()) <= 1e-4 * scale
    # equal indices wherever the neighbouring scores are apart
    v = want.scores
    gap = torch.full_like(v, math.inf)
    gap[:, 1:] = (v[:, 1:] - v[:, :-1]).abs()
    gap[:, :-1] = torch.minimum(gap[:, :-1], gap[:, 1:].clone())
    apart = gap > 1e-5 * scale
    assert torch.equal(got.indices[apart], want.indices[apart])
    torch.testing.assert_close(got.self_scores, want.self_scores, rtol=1e-4,
                               atol=0)


def test_service_flushes_through_the_kernels_match_flat(cuda):
    """The serving tier at the influence task's full width (p = 26,122),
    Nyström k = 10: a cold m = 1 flush (the sketch build: one gram; the
    vector apply with ``refine=1``: three ctv and two vector applies), then
    a warm m = 4 flush (three crosses and two block applies, no gram),
    against the same service on ``backend='flat'``, which launches nothing:
    scores within 1e-4 of max |score|, top-k indices equal wherever the
    neighbouring scores are apart, no degraded flush."""
    from repro_torch.core import HypergradConfig
    from repro_torch.serve import InfluenceService
    from repro_torch.tasks import build_influence
    problem = build_influence(device=cuda)
    params = problem.init_params(torch.Generator().manual_seed(0))
    X, y = problem.reference['queries'](5)
    runs = {}
    for be in ('cuda', 'flat'):
        svc = InfluenceService(problem, HypergradConfig(k=10, rho=1e-2,
                                                        backend=be),
                               params=params, top_k=10, block_size=1,
                               max_delay=60.0)
        _lib.reset_launches()
        tickets = [svc.submit((X[0], y[0]))]
        assert svc.pump() == 1
        torch.cuda.synchronize()
        cold = dict(_lib.LAUNCHES)
        _lib.reset_launches()
        svc.batcher.block_size = 4
        tickets += [svc.submit((X[q], y[q])) for q in range(1, 5)]
        assert svc.pump() == 4
        torch.cuda.synchronize()
        warm = dict(_lib.LAUNCHES)
        answers = [svc.result(t) for t in tickets]
        assert [a.batched_m for a in answers] == [1, 4, 4, 4, 4]
        assert [a.cache_hit for a in answers] == [False] + [True] * 4
        assert svc.degraded_flushes == 0
        runs[be] = answers, cold, warm
    (got, cold, warm), (want, *plain) = runs['cuda'], runs['flat']
    names = ('nystrom_gram', 'woodbury_ctv', 'woodbury_apply',
             'nystrom_cross', 'woodbury_apply_block')
    assert tuple(cold[n] for n in names) == (1, 3, 2, 0, 0)
    assert tuple(warm[n] for n in names) == (0, 0, 0, 3, 2)
    assert not any(v for launches in plain for v in launches.values())
    v = torch.stack([a.scores for a in want])
    scale = float(v.abs().max())
    got_v = torch.stack([a.scores for a in got])
    assert float((got_v - v).abs().max()) <= 1e-4 * scale
    gap = torch.full_like(v, math.inf)
    gap[:, 1:] = (v[:, 1:] - v[:, :-1]).abs()
    gap[:, :-1] = torch.minimum(gap[:, :-1], gap[:, 1:].clone())
    apart = gap > 1e-5 * scale
    got_i = torch.stack([a.indices for a in got])
    want_i = torch.stack([a.indices for a in want])
    assert torch.equal(got_i[apart], want_i[apart])


def _toy_outer(dev, backend):
    """The non-quadratic toy of ``tests/test_torch_second_order.py``: its
    outer loss through a full-rank Nyström map (k = 4, ρ = 1e-2)."""
    import numpy as np
    from repro_torch.core import HypergradConfig, implicit_root, sgd_solver
    A = torch.from_numpy(np.random.RandomState(0).randn(4, 4).astype(
        np.float32)).to(dev)

    def inner(x, phi, b):
        return (0.5 * torch.sum(x ** 2)
                + 0.025 * torch.sum(x ** 4) * torch.sum(torch.exp(phi))
                - (A @ phi) @ x)
    solve = implicit_root(
        sgd_solver(inner, 200, 0.2,
                   init=lambda p, b: torch.zeros(4, device=dev)),
        inner, HypergradConfig(solver='nystrom', k=4, rho=1e-2,
                               backend=backend))
    return lambda p: torch.sum((solve(p, None) - 1.0) ** 2)


def _launched_a_b_c(launches):
    return (launches['nystrom_gram'] + launches['nystrom_cross'] > 0
            and launches['woodbury_ctv'] > 0
            and launches['woodbury_apply']
            + launches['woodbury_apply_block'] > 0)


@pytest.mark.parametrize('kind', ['jacfwd', 'jacrev'])
def test_second_order_rules_launch_the_kernels(cuda, kind):
    """``chip_smoke.py`` phase 17 (a): a second derivative of the toy
    through ``implicit_root``'s new rules, the kernels against
    ``backend='flat'`` at 1e-4 relative L2, with kernels A, B and C each
    launched inside the rules."""
    from torch.func import grad, jacfwd, jacrev
    outer = {'jacfwd': jacfwd, 'jacrev': jacrev}[kind]
    phi = torch.full((4,), 0.1, device=cuda)
    want = outer(grad(_toy_outer(cuda, 'flat')))(phi)
    _lib.reset_launches()
    got = outer(grad(_toy_outer(cuda, 'cuda')))(phi)
    torch.cuda.synchronize()
    assert _launched_a_b_c(_lib.LAUNCHES), _lib.LAUNCHES
    assert float((got - want).norm() / want.norm()) <= 1e-4


@pytest.mark.parametrize('name', ['reweight_maml', 'distill_hpo'])
def test_engine_graph_through_the_kernels_matches_flat(cuda, name):
    """``chip_smoke.py`` phase 17 (b) at the reference's test sizes, one
    outer step: every edge on ``backend='cuda'`` against
    ``backend='flat'``, top losses at 1e-4 relative, the bills, and kernels
    A, B and C launched."""
    import dataclasses
    from repro_torch.engine import (Engine, EngineConfig, engine_edge_bills,
                                    get_graph)
    kw = {'reweight_maml': dict(d=4, n_tasks=2, n_support=8, n_query=8),
          'distill_hpo': dict(d=4, n_classes=2, n_syn=4, n_train=16,
                              n_val=16)}[name]
    base = get_graph(name, device=cuda, **kw)
    losses = {}
    for backend in ('flat', 'cuda'):
        graph = dataclasses.replace(base, edges=[
            dataclasses.replace(e, config=dataclasses.replace(
                e.config, backend=backend)) for e in base.edges])
        _lib.reset_launches()
        res = Engine().solve(graph, EngineConfig(n_outer=1))
        torch.cuda.synchronize()
        losses[backend] = res.losses
        assert res.edge_hvps == engine_edge_bills(graph, n_outer=1)
    assert _launched_a_b_c(_lib.LAUNCHES), _lib.LAUNCHES
    for a, b in zip(losses['cuda'], losses['flat']):
        assert math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)


def test_observatory_population_through_the_kernels_matches_flat(cuda):
    """``chip_smoke.py`` phase 22 at toy size: a 2-member ``logreg_wd``
    population, its Nyström cell on ``backend='cuda'`` against
    ``backend='flat'`` (hypergradients at 1e-4 relative L2 per member,
    errors at 1e-4 relative, the same bill), with kernels A, B and C
    launched under the population's vmap."""
    from repro_torch.bench import build_population
    from repro_torch.bench.observatory import cell_hypergrads, measure_cell
    bundle = build_population('logreg_wd:D=8:n=60', tasks=2, oracle_rho=1e-2,
                              device=cuda)
    point = {'k': 5, 'rho': 1e-2}
    hg, cells = {}, {}
    for backend in ('flat', 'cuda'):
        _lib.reset_launches()
        cells[backend] = measure_cell(bundle, 'nystrom', point,
                                      backend=backend, reps=1, device=cuda)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
        hg[backend] = cell_hypergrads(bundle, 'nystrom', point,
                                      backend=backend, device=cuda)
    assert _launched_a_b_c(launches), launches
    a, b = cells['cuda'], cells['flat']
    assert a.hvp_count == b.hvp_count == 5 and a.backend == 'cuda'
    assert abs(a.hypergrad_error - b.hypergrad_error) <= \
        1e-4 * b.hypergrad_error and math.isfinite(a.err_max)
    for t in range(2):
        x, y = (torch.cat([leaf[t].reshape(-1) for leaf in h.values()])
                for h in (hg['cuda'], hg['flat']))
        assert float((x - y).norm() / y.norm()) <= 1e-4


def _wide_mlp(device):
    """An MLP with p = 1,049,087 ≈ 2²⁰ parameters on ``device``, and an
    HVP of its loss."""
    from repro_torch.core import make_hvp
    g = torch.Generator().manual_seed(0)
    params = {'l1': {'w': torch.randn(512, 1024, generator=g) * 0.05,
                     'b': torch.zeros(1024)},
              'l2': {'w': torch.randn(1024, 511, generator=g) * 0.05}}
    x = torch.randn(64, 512, generator=g)
    y = torch.randn(64, 511, generator=g)
    params = {n: {k: v.to(device) for k, v in d.items()}
              for n, d in params.items()}

    def loss(p, batch):
        xb, yb = batch
        h = torch.tanh(xb @ p['l1']['w'] + p['l1']['b'])
        return ((h @ p['l2']['w'] - yb) ** 2).mean()

    return params, make_hvp(loss, params, (x.to(device), y.to(device)))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('chunk', [3, None])
def test_lean_build_is_bitwise_the_old_path_on_the_card(cuda, dtype, chunk):
    from test_torch_lm_build import _old_columns, _old_mul_right, _old_operand

    from repro_torch.core import PyTreeIndexer
    from repro_torch.core.solvers import _EIG_REL_TOL
    params, hvp = _wide_mlp(cuda)
    indexer = PyTreeIndexer(params)
    assert abs(indexer.total - 2 ** 20) < 2 ** 12
    k = 8
    idx = indexer.sample_indices(torch.Generator().manual_seed(1), k)
    be = CudaBackend(sketch_dtype=dtype)
    sketch = NystromIHVP(k=k, column_chunk=chunk, backend=be).prepare(
        hvp, indexer, None, indices=idx)
    C_tree = _old_columns(hvp, indexer, idx, chunk)
    C_old = _old_operand(be, C_tree)
    assert sketch.C.device.type == cuda.type
    assert torch.equal(sketch.C, C_old)
    H_KK = indexer.gather(C_tree, idx)
    H_KK = 0.5 * (H_KK + H_KK.T)
    assert torch.equal(sketch.H_KK, H_KK)
    lam, U = torch.linalg.eigh(H_KK)
    tol = _EIG_REL_TOL * (torch.max(torch.abs(lam)) + 1e-30) * k
    inv_sqrt = torch.where(lam > tol, 1.0 / torch.sqrt(torch.maximum(lam,
                                                                     tol)),
                           torch.zeros_like(lam))
    assert torch.equal(sketch.B,
                       _old_mul_right(be, C_old, U * inv_sqrt[None, :]))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_row_blocked_mul_right_is_the_unblocked_product(cuda, dtype):
    from repro_torch.core import backend as backend_mod
    from repro_torch.core.backend import _mm
    p, k = backend_mod.ROW_BLOCK + 4099, 8
    C = _randn((p, k), dtype, cuda, 3)
    M = _randn((k, k), torch.float32, cuda, 4)
    w = _randn((k,), torch.float32, cuda, 5)
    be = CudaBackend(sketch_dtype=dtype)
    assert torch.equal(be.mul_right(C, M), _mm(C, M).to(dtype))
    whole = _mm(C, w)
    torch.testing.assert_close(be.cv(C, w), whole, rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))


def _cpu_and_card_models(cfg, cuda):
    """A seeded init on the CPU and the same parameters on the card."""
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import build_model
    params = build_model(cfg, device='cpu').init(
        torch.Generator().manual_seed(0))
    return params, tree_map(lambda t: t.to(cuda), params)


@pytest.mark.parametrize('arch', ['yi_9b', 'phi35_moe_42b_a66b',
                                  'llama4_maverick_400b_a17b'])
def test_decode_and_moe_forward_on_the_card_match_the_cpu(cuda, arch):
    """The eleventh slice at ``reduced()`` size in f32: ``forward`` (MoE
    layers included) and 8 ``build_serve_step`` tokens on the card against
    the port on the CPU, relative L2 ≤ 1e-5, aux within 1e-6; decode
    launches no kernel, as in the reference."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    params, gparams = _cpu_and_card_models(cfg, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    want, want_aux = build_model(cfg, device='cpu').forward(params, tokens)
    got, aux = build_model(cfg, device=cuda).forward(gparams, tokens.to(cuda))
    assert float((got.cpu() - want).norm() / want.norm()) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    outs = {}
    for dev, prm in (('cpu', params), (cuda, gparams)):
        step = build_serve_step(cfg, device=dev)
        cache = build_model(cfg, device=dev).init_cache(2, 8)
        _lib.reset_launches()
        logits = []
        for t in range(8):
            out, cache = step(prm, tokens[:, t:t + 1], cache)
            logits.append(out.cpu())
        assert set(_lib.LAUNCHES.values()) == {0}
        assert cache['pos'].device.type == torch.device(dev).type
        outs[str(dev)] = torch.cat(logits, 1)
    want = outs['cpu']
    assert float((outs['cuda'] - want).norm() / want.norm()) <= 1e-5


@pytest.mark.parametrize('arch', ['phi35_moe_42b_a66b',
                                  'llama4_maverick_400b_a17b'])
def test_moe_prefill_launches_kernels_d_and_e(cuda, arch):
    """A MoE prefill at ``reduced(head_dim=64)`` with ``use_pallas``, S = 64
    past ``attn_chunk``: kernel D twice and kernel E once a layer. In f32
    (E's CUDA-core variant) the kernel path is held to the plain path at
    1e-4 relative L2 (``chip_smoke.py`` phase 10's gate); in bf16 every E
    launch is on the tensor cores."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    cfg = get_config(arch).reduced(head_dim=64, use_pallas=True)
    _, gparams = _cpu_and_card_models(cfg, cuda)
    batch = {'inputs': torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=torch.Generator().manual_seed(2))}
    L = cfg.n_layers
    for dtype, tc in (('float32', 0), ('bfloat16', L)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        _lib.reset_launches()
        kern = build_prefill_step(c, device=cuda)(gparams, batch)
        torch.cuda.synchronize()
        assert (_lib.LAUNCHES['rmsnorm'], _lib.LAUNCHES['flash_attention'],
                _lib.LAUNCHES['flash_attention_tc']) == (2 * L, L, tc)
        assert torch.isfinite(kern).all()
        if dtype == 'float32':
            plain = build_prefill_step(dataclasses.replace(
                c, use_pallas=False), device=cuda)(gparams, batch)
            assert float((kern - plain).norm() / plain.norm()) <= 1e-4


@pytest.mark.parametrize('causal', [False, True])
def test_flash_at_seamless_shapes(cuda, causal):
    """SeamlessM4T: 16 heads of 64 (MHA), non-causal in the encoder and
    causal in the decoder, at S = 1024 (a quarter of its 4096)."""
    q, k, v = (_randn((1, 1024, 16, 64), torch.bfloat16, cuda, 40 + i)
               for i in range(3))
    _flash_checked(q, k, v, causal, tensor_cores=True)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_flash_at_a_gqa_group_of_7(cuda, dtype):
    """Qwen2-VL: 28 query heads over 4 KV heads of 128, causal."""
    q = _randn((1, 512, 28, 128), dtype, cuda, 43)
    k, v = (_randn((1, 512, 4, 128), dtype, cuda, 44 + i) for i in range(2))
    _flash_checked(q, k, v, True, tensor_cores=dtype == torch.bfloat16)


@pytest.mark.parametrize('d', [3584, 1024])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_rmsnorm_at_the_new_families_widths(cuda, d, dtype, tol):
    """Qwen2-VL's d = 3584 and SeamlessM4T's d = 1024, 4096 rows."""
    x = _randn((4096, d), dtype, cuda, 46)
    s = _randn((d,), torch.bfloat16, cuda, 47)
    _rel_close(ops.rmsnorm(x, s, 1e-6), ref.rmsnorm(x, s, 1e-6), tol)


#: the new families' prefill launches at reduced() size, S = 64 > attn_chunk
#: with use_pallas: kernel D on ln1/ln2 of every non-RWKV slot (and the
#: encoder's), kernel E on every self-attention (and the encoder's)
NEW_FAMILIES = {'jamba_v01_52b': (32, 2), 'rwkv6_1b6': (0, 0),
                'seamless_m4t_large_v2': (8, 4), 'qwen2_vl_7b': (4, 2)}


@pytest.mark.parametrize('arch', sorted(NEW_FAMILIES))
def test_new_families_on_the_card_match_the_cpu(cuda, arch):
    """f32 at ``reduced(head_dim=64)``: the kernel path's prefill on the
    card against the port's plain forward on the CPU (1e-4, phase 10's
    gate) with D and E launched exactly; 8 decode steps on the card
    against the CPU (1e-5), no kernel launched."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced(head_dim=64)
    if cfg.mrope:
        cfg = dataclasses.replace(cfg, mrope_sections=(8, 12, 12))
    params, gparams = _cpu_and_card_models(cfg, cuda)
    rng = np.random.RandomState(3)
    if cfg.embed_inputs or cfg.is_encdec:
        inputs = torch.tensor(rng.randint(0, cfg.vocab_size, (2, 64)))
    else:
        inputs = torch.tensor(rng.randn(2, 64, cfg.d_model).astype(
            np.float32))
    batch = {'inputs': inputs}
    if cfg.is_encdec:
        batch['enc_inputs'] = torch.tensor(rng.randn(
            2, 64, cfg.d_model).astype(np.float32))
    if cfg.mrope:
        batch['positions'] = torch.tensor(rng.randint(
            0, 64, (2, 3, 64)).astype(np.int32))
    want = build_prefill_step(cfg, device='cpu')(params, batch)
    _lib.reset_launches()
    got = build_prefill_step(dataclasses.replace(cfg, use_pallas=True),
                             device=cuda)(gparams, batch)
    torch.cuda.synchronize()
    assert (_lib.LAUNCHES['rmsnorm'], _lib.LAUNCHES['flash_attention']) \
        == NEW_FAMILIES[arch]
    assert float((got.cpu() - want).norm() / want.norm()) <= 1e-4
    outs = {}
    for dev, prm in (('cpu', params), (cuda, gparams)):
        model = build_model(cfg, device=dev)
        cache = model.init_cache(2, 8)
        if cfg.is_encdec:
            cache = model.fill_cross_cache(prm, cache, model.encode(
                prm, batch['enc_inputs'].to(dev)))
        step = build_serve_step(cfg, device=dev)
        _lib.reset_launches()
        logits = []
        for t in range(8):
            out, cache = step(prm, inputs[:, t:t + 1], cache)
            logits.append(out.cpu())
        assert set(_lib.LAUNCHES.values()) == {0}
        outs[str(dev)] = torch.cat(logits, 1)[..., :cfg.vocab_size]
    want = outs['cpu']
    assert float((outs['cuda'] - want).norm() / want.norm()) <= 1e-5


@pytest.mark.parametrize('arch', ['jamba_v01_52b', 'rwkv6_1b6'])
def test_recurrent_layer_backward_on_the_card_matches_the_cpu(cuda, arch):
    """A Mamba or RWKV-6 slot of the ``reduced()`` config (its norms, its
    mixer and its FFN or channel mix) at B = 2, S = 256 in f32: the output
    and the gradients of x and of every leaf on the card within 1e-4 of
    the CPU's, the time loop running by checkpointed chunks on both."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree_util import tree_flatten, tree_map
    from repro_torch.models.transformer import _apply_slot, init_params
    cfg = get_config(arch).reduced()
    mixer = 'rwkv' if cfg.ssm_kind == 'rwkv6' else 'mamba'
    slot = next(i for i, (m, _) in enumerate(cfg.layer_kinds())
                if m == mixer)
    ffn = cfg.layer_kinds()[slot][1]
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device='cpu')['blocks'][0][f'slot{slot}']
    x = _randn((2, 256, cfg.d_model), torch.float32, 'cpu', 48)
    gy = _randn((2, 256, cfg.d_model), torch.float32, 'cpu', 49)
    outs = {}
    for dev in ('cpu', cuda):
        leaves, treedef = tree_flatten(tree_map(lambda t: t.to(dev), params))
        live = [t.requires_grad_(True) for t in leaves]
        xd = x.to(dev).requires_grad_(True)
        y, _ = _apply_slot(cfg, treedef.unflatten(live), xd, None, mixer,
                           ffn, True, None)
        grads = torch.autograd.grad(y, [xd] + live, gy.to(dev))
        outs[str(dev)] = [y.detach().cpu()] + [g.cpu() for g in grads]
    for got, want in zip(outs['cuda'], outs['cpu']):
        assert float((got - want).norm()) <= 1e-4 * float(want.norm())


def test_flat_sharded_on_one_nccl_rank(cuda, tmp_path):
    """The sixteenth slice: ``flat_sharded`` on a 1×1 mesh of one NCCL
    rank (a spawned process: the pytest process initialises no process
    group; ``tests/mesh_cases_cuda.py``). Every spec replicates, so the
    fused buffer is the 'cuda' backend's bit for bit, no collective runs,
    and ctv, gram, ctm, combine and combinem launch kernels B, A, A, C and
    C once each, within the kernels' tolerance of the 'cuda' backend."""
    import torch_mesh
    ranks, _ = torch_mesh.run_both('mesh_cases_cuda', 'one_rank', None,
                                   tmp_path, world=1, backend='nccl')
    for dtype, out in ranks[0].items():
        assert out['same_buffer'], dtype
        assert out['collectives'] == {}, dtype
        assert out['launches'].get('woodbury_ctv') == 1
        assert out['launches'].get('nystrom_cross') == 2
        assert out['launches'].get('woodbury_apply') == 1
        assert out['launches'].get('woodbury_apply_block') == 1
        for k, want in out['want'].items():
            got = out['got'][k]
            atol = 1e-5 * float(want.abs().max().clamp(min=1e-30))
            torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


def test_split_prefill_on_two_gloo_ranks(cuda, tmp_path):
    """The seventeenth slice: reduced Yi-9B with one KV head split over
    'model' on two gloo ranks sharing the card (``tests/mesh_cases_cuda.py``):
    the KV weights stay whole, and kernel E reads the rank's slice of the
    KV heads (its 2 of 4 q heads share KV head 0). Each rank launches D
    twice a layer and E once, and the gathered last-position logits are
    the unsplit plain path's within 1e-4 relative L2 (f32, phase 10's
    gate), equal on both ranks."""
    import torch_mesh
    ranks, _ = torch_mesh.run_both('mesh_cases_cuda', 'split_prefill', None,
                                   tmp_path, world=2, backend='gloo')
    want = ranks[0]['want']
    for r in ranks:
        assert r['launches'].get('rmsnorm') == 4, r['launches']
        assert r['launches'].get('flash_attention') == 2, r['launches']
        err = float((r['got'] - want).norm() / want.norm())
        assert err <= 1e-4, err
        assert torch.equal(r['got'], ranks[0]['got'])
