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
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import expand_kv
from torch_threads import torch_thread_cap  # noqa: F401

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


# Shapes that PR 15's CUDA kernels refused (k or m above 256, k·m above
# 8192) and the reference's kernels take, padding k and m to 128 lanes.
F1_SHAPES = [(1000, 512, 512), (1000, 64, 256), (700, 300, 3)]


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('p,k,m', F1_SHAPES)
@pytest.mark.parametrize('entry', ['gram', 'cross', 'ctv', 'apply',
                                   'apply_block'])
def test_entry_points_take_every_shape_the_reference_takes(entry, p, k, m,
                                                           dtype):
    """The five entry points at k, m ∈ {512, 256, 300, 64, 3} against the
    Pallas kernels in interpret mode, the same numpy inputs on both sides
    (C in ``dtype``, queries and weights f32); rtol 1e-5 as above."""
    jC, tC = _pair((p, k), 20, dtype)
    rho = 0.05
    if entry == 'gram':
        got, want = ops.nystrom_gram(tC), jops.nystrom_gram(
            jC, block_p=BLOCK_P, interpret=True)
    elif entry == 'cross':
        jV, tV = _pair((p, m), 21, 'f32')
        got, want = ops.nystrom_cross(tC, tV), jops.nystrom_cross(
            jC, jV, block_p=BLOCK_P, interpret=True)
    elif entry == 'ctv':
        jv, tv = _pair((p,), 22, 'f32')
        got, want = ops.woodbury_ctv(tC, tv), jops.woodbury_ctv(
            jC, jv, block_p=BLOCK_P, interpret=True)
    else:
        shape = (p, m) if entry == 'apply_block' else (p,)
        jv, tv = _pair(shape, 23, 'f32')
        jw, tw = _pair((k,) + shape[1:], 24, 'f32')
        got, want = ops.woodbury_apply(tC, tw, tv, rho), jops.woodbury_apply(
            jC, jw, jv, rho, block_p=BLOCK_P, interpret=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


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
    """Kernel A's split (128-row stages, one block per SM of an H100) and
    kernel B's blocks along p (at most 2 an SM, no more than p has
    sweeps)."""
    for tile, max_blocks in ((16, 528), (_lib.ATB_ROWS, 132)):
        for p in (1, 15, 16, 17, 127, 128, 129, 26122, 2 ** 24):
            nblocks, rows = _lib.split_rows(p, tile, max_blocks)
            assert rows % tile == 0
            assert nblocks <= max_blocks
            assert (nblocks - 1) * rows < p <= nblocks * rows
    for p in (1, 15, 200, 201, 26122, 2 ** 24):
        for k, isz, rows16 in ((10, 4, False), (64, 4, True), (64, 2, True),
                               (1000, 4, True), (100, 2, False)):
            n = _lib.ctv_blocks(p, k, isz, rows16, 132)
            assert 1 <= n <= _lib.CTV_BLOCKS_PER_SM * 132
    # kernel B at the main path's p (f32 k = 10, scalar loads: 25 groups of
    # 10 lanes, 8 rows each, 200 rows a sweep): 131 blocks
    assert _lib.ctv_blocks(26122, 10, 4, False, 132) == 131
    # at p = 2^24, k = 64: 264 blocks; k = 1000 in f32 has 8 windows of 32
    # chunks, which share the 264
    assert _lib.ctv_blocks(2 ** 24, 64, 4, True, 132) == 264
    assert _lib.ctv_blocks(2 ** 24, 1000, 4, True, 132) == 33


BF, F = torch.bfloat16, torch.float32


P = 26122   # the main path's p


@pytest.mark.parametrize('a,b,p,k,m,ptrs,variant', [
    (BF, BF, P, 64, 64, (0, 0), 'tensor_cores'),       # gram of a bf16 sketch
    (BF, BF, P, 64, 32, (4096, 256), 'tensor_cores'),  # bf16 cross
    (BF, BF, P, 8, 256, (16, 32), 'tensor_cores'),
    (BF, BF, 2 ** 31 - 1, 64, 64, (0, 0), 'tensor_cores'),
    (BF, BF, 2 ** 31, 64, 64, (0, 0), 'cuda_cores'),   # TMA's int32 rows
    (BF, BF, P, 10, 10, (0, 0), 'cuda_cores'),         # k not a multiple of 8
    (BF, BF, P, 64, 3, (0, 0), 'cuda_cores'),          # m not a multiple of 8
    (BF, BF, P, 64, 64, (8, 8), 'cuda_cores'),         # 8 bytes off the grid
    (BF, BF, P, 64, 32, (0, 24), 'cuda_cores'),
    (BF, F, P, 64, 32, (0, 0), 'cuda_cores'),          # bf16 sketch, f32 queries
    (F, BF, P, 64, 32, (0, 0), 'cuda_cores'),
    (F, F, P, 64, 64, (0, 0), 'cuda_cores'),           # IEEE f32: no TF32
    (F, F, 2 ** 31 + 5, 1, 1, (0, 0), 'cuda_cores'),
])
def test_atb_variant_rule(a, b, p, k, m, ptrs, variant):
    assert _lib.atb_variant(a, b, p, k, m, ptrs) == variant


@pytest.mark.parametrize('dtype,k,ptr,whole', [
    (F, 64, 0, True), (F, 4, 16, True), (F, 256, 0, True),
    (F, 10, 0, False),     # 40-byte rows
    (F, 64, 8, False),     # base off the 16-byte grid
    (F, 260, 0, False),    # more than 64 chunks a row
    (BF, 64, 0, True), (BF, 512, 0, True), (BF, 8, 48, True),
    (BF, 100, 0, False),   # 200-byte rows
    (BF, 64, 8, False),
])
def test_apply_rows16_rule(dtype, k, ptr, whole):
    assert _lib.rows16(dtype, k, ptr) == whole


@pytest.mark.parametrize('dtype,k,ptr,path', [
    (F, 64, 0, 'ctv_rows16'), (F, 4, 16, 'ctv_rows16'),
    (F, 260, 0, 'ctv_rows16'),   # more than 64 chunks: still 16-byte loads
    (F, 1000, 0, 'ctv_rows16'),
    (F, 10, 0, 'ctv_scalar'),    # 40-byte rows, the main path's
    (F, 64, 8, 'ctv_scalar'),    # base off the 16-byte grid
    (BF, 64, 0, 'ctv_rows16'), (BF, 8, 48, 'ctv_rows16'),
    (BF, 1000, 0, 'ctv_rows16'),
    (BF, 100, 0, 'ctv_scalar'),  # 200-byte rows
    (BF, 4, 0, 'ctv_scalar'),    # 8-byte rows
    (BF, 64, 8, 'ctv_scalar'),
])
def test_ctv_path_rule(dtype, k, ptr, path):
    """Kernel B's load path: ``rows16``'s test without its 64-chunk limit,
    so wherever kernel C reads 16-byte rows, kernel B does too."""
    assert _lib.ctv_path(dtype, k, ptr) == path
    if _lib.rows16(dtype, k, ptr):
        assert path == 'ctv_rows16'


@pytest.mark.parametrize('p,k,m,nblocks', [
    (26122, 10, 32, 103),        # the main path: 205 stages, 2 a block
    (2 ** 24, 64, 32, 132),
    (2 ** 20, 512, 512, 131),    # 1 MiB a partial: the cap (256) not reached
    (2 ** 20, 2048, 2048, 16),   # 16 MiB a partial: 16 blocks
    (2 ** 20, 4096, 8192, 2),
    (10 ** 6, 8192, 8192, 1),    # one partial beyond the cap: one block
    (3001, 300, 3, 24),          # p's 24 stages
    (100, 1, 1, 1),
])
def test_atb_scratch_is_capped(p, k, m, nblocks):
    """Kernel A's blocks along p as a pure function of (p, k, m) on 132
    SMs: whole 128-row stages covering p, at most one block an SM, and a
    scratch of blocks · k · m f32 within ``ATB_SCRATCH_BYTES`` unless one
    block's partial alone is larger."""
    got, rows = _lib.atb_split(p, k, m, 132)
    assert got == nblocks
    assert rows % _lib.ATB_ROWS == 0
    assert (got - 1) * rows < p <= got * rows
    assert got * k * m * 4 <= max(_lib.ATB_SCRATCH_BYTES, k * m * 4)


def _two_level_gram(C: torch.Tensor, nblocks: int, stage: int = 128,
                    depth: int = 16) -> torch.Tensor:
    """Kernel A's summation order for a bf16 sketch on the tensor cores,
    in f32 on the CPU: p cut into nblocks runs of whole stages; in a stage
    each 16-row slice's products (exact in f32) summed, the slice sums
    added in turn into the stage's sum, the stage's sum added into the
    block's running f32 sum; then the blocks' partials folded as
    reduce_partials folds them (one per thread, then a fixed tree)."""
    p, k = C.shape
    tiles = -(-p // stage)
    rows = -(-tiles // nblocks) * stage
    X = torch.zeros(nblocks * rows, k)
    X[:p] = C.float()
    X = X.view(nblocks, rows // stage, stage // depth, depth, k)
    acc = torch.zeros(nblocks, k, k)
    for s in range(rows // stage):
        slices = X[:, s]                          # (blocks, slices, 16, k)
        part = slices.transpose(-1, -2) @ slices  # each slice's 16 rows
        d = part[:, 0].clone()
        for t in range(1, stage // depth):        # the stage's slices
            d += part[:, t]
        acc += d                                  # the running sum
    red = torch.zeros(256, k, k)
    red[:nblocks] = acc
    width = 128
    while width:                                  # reduce_partials' tree
        red[:width] += red[width:2 * width]
        width //= 2
    return red[0]


def test_two_level_sum_keeps_the_large_p_gate():
    """At p = 2^20, k = 64 (bf16 values, one block per SM of an H100:
    7,936 rows, 62 stages a block), the kernel's two-level order stays
    within chip_smoke.py's gate against the f64 sum: rtol 1e-5 and
    atol 1e-5·‖ref‖∞."""
    p, k = 2 ** 20, 64
    rng = np.random.RandomState(3)
    C = torch.tensor(rng.randn(p, k).astype(np.float32)).bfloat16()
    want = C.double().T @ C.double()
    got = _two_level_gram(C, 132).double()
    err = (got - want).abs()
    limit = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    assert bool((err <= limit).all()), float((err / limit).max())


# ----------------------------------------------------- kernels D and E
# Tolerances of tests/test_kernels.py: rmsnorm 1e-5 (f32) / 2e-2 (bf16),
# flash 2e-5 (f32) / 2e-2 (bf16), as rtol = atol. The Pallas kernels run in
# interpret mode; on the CPU the port's wrappers run their plain versions.
def _as_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', [(4, 128), (2, 3, 256), (5, 640), (6, 64)])
def test_rmsnorm_matches_pallas(shape, dtype):
    jx, tx = _pair(shape, 12, dtype)
    js, ts = _pair(shape[-1:], 13, dtype)
    got = ops.rmsnorm(tx, ts, 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = 1e-5 if dtype == 'f32' else 2e-2
    np.testing.assert_allclose(
        _as_f32(got), _as_f32(jops.rmsnorm(jx, js, 1e-5, interpret=True)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('B,S,H,hd', [(1, 128, 2, 64), (2, 256, 4, 128)])
def test_flash_attention_matches_pallas(B, S, H, hd, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_pair((B, S, H, hd), 14 + i, dtype)
                                    for i in range(3))
    got = ops.flash_attention(tq, tk, tv, causal=causal, q_block=64,
                              k_block=64)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jops.flash_attention(jq, jk, jv, causal=causal, q_block=64,
                                k_block=64, interpret=True)
    tol = 2e-5 if dtype == 'f32' else 2e-2
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('H,KV', [(8, 1), (8, 2), (4, 4)])
def test_flash_attention_reads_kv_heads_in_place(H, KV, causal, dtype):
    """k, v with KV < H heads: bit for bit the call on heads repeated as
    ``expand_kv`` repeats them, and within the tolerance of the Pallas
    kernel (interpret mode) on those expanded heads."""
    B, S, hd = 2, 128, 64
    jq, tq = _pair((B, S, H, hd), 17, dtype)
    (jk, tk), (jv, tv) = (_pair((B, S, KV, hd), 18 + i, dtype)
                          for i in range(2))
    got = ops.flash_attention(tq, tk, tv, causal=causal, q_block=64,
                              k_block=64)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tx, vx = (expand_kv(t, H // KV) for t in (tk, tv))
    assert torch.equal(got, ops.flash_attention(tq, tx, vx, causal=causal,
                                                q_block=64, k_block=64))
    # the reference's own repeat, jnp.repeat along the head axis
    jx, jvx = (jnp.repeat(t, H // KV, axis=2) for t in (jk, jv))
    np.testing.assert_array_equal(_as_f32(tx), _as_f32(jx))
    want = jops.flash_attention(jq, jx, jvx, causal=causal, q_block=64,
                                k_block=64, interpret=True)
    tol = 2e-5 if dtype == 'f32' else 2e-2
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=tol,
                               atol=tol)


def test_flash_attention_rejects_heads_that_do_not_group():
    q, k = torch.zeros(1, 64, 3, 16), torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match='multiple of KV heads'):
        ops.flash_attention(q, k, k)


def _p_split_misses(rounding) -> int:
    """Outputs of a (1, 512, 4, 128) causal bf16 attention off by more than
    one bf16 ulp (2⁻⁷·|ref| + 1e-5) when the tensor-core kernel's
    probabilities P = exp(s − m) (f32) go into P·V through ``rounding``
    (each product and sum in f32, l summed from the f32 P, as the kernel
    does)."""
    S, H, hd = 512, 4, 128
    q, k, v = (torch.tensor(np.random.RandomState(30 + i).randn(
        1, S, H, hd).astype(np.float32)).bfloat16() for i in range(3))
    s = torch.einsum('bshd,bthd->bhst', q.float(), k.float()) * hd ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum('bhst,bthd->bshd', rounding(p), v.float())
    out = (out / p.sum(-1).transpose(1, 2)[..., None]).bfloat16().float()
    want = ref.flash_attention(q, k, v, causal=True).float()
    return int(((out - want).abs() > 1e-5 + 2 ** -7 * want.abs()).sum())


def test_p_split_keeps_the_one_ulp_gate():
    """Why kernel E's tensor-core variant splits P into two bf16
    fragments: P rounded once to bf16 misses the one-ulp gate of
    ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` (near-zero
    outputs), hi + lo = bf16(P) + bf16(P − bf16(P)) does not."""
    def hi(p):
        return p.bfloat16().float()

    def hi_lo(p):
        return hi(p) + (p - hi(p)).bfloat16().float()
    assert _p_split_misses(hi) > 0
    assert _p_split_misses(hi_lo) == 0


@pytest.mark.parametrize('call', [
    lambda q: ops.flash_attention(q, q, q, q_block=64, k_block=64),
    lambda q: ops.flash_attention(q, q[:, :64], q[:, :64], causal=True,
                                  q_block=50, k_block=64),
    lambda q: ops.flash_attention(*[torch.zeros(1, 64, 2, 300)] * 3),
    lambda q: ops.rmsnorm(q, torch.ones(63)),
    lambda q: ops.rmsnorm(q.double(), torch.ones(64, dtype=torch.float64)),
])
def test_model_kernels_reject_what_they_do_not_take(call):
    """S = 100 against blocks of 64 (the Pallas kernel asserts the same),
    causal with S ≠ T, hd > 256, a scale of the wrong width, float64."""
    with pytest.raises(ValueError):
        call(torch.zeros(1, 100, 2, 64))


def test_model_kernels_on_cpu_are_not_counted():
    _lib.reset_launches()
    x = torch.randn(2, 64, 2, 16)
    ops.rmsnorm(x, torch.ones(16))
    ops.flash_attention(x, x, x)
    assert set(_lib.LAUNCHES.values()) == {0}
