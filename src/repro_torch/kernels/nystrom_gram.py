"""Wrappers of CUDA kernel A (``csrc/atb.cu``): CᵀC and AᵀB over p.

They stand where ``repro/kernels/nystrom_gram.py``'s Pallas kernels stand.
A CUDA tensor launches one of the kernel's two variants, chosen by
:func:`~repro_torch.kernels._lib.atb_variant` (bf16 × bf16 on the 16-byte
grid with k, m multiples of 8 → tensor cores; everything else → CUDA cores
in IEEE f32), or raises on what the kernel does not take; a CPU tensor runs
the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref


def _check_operand(x: torch.Tensor, name: str) -> None:
    _lib.require(x.ndim == 2, f'{name} must be 2-D, got {tuple(x.shape)}')
    _lib.require(x.dtype in _lib.DTYPE_CODE,
                 f'{name} must be float32 or bfloat16, got {x.dtype}')
    _lib.require(x.shape[0] >= 1, f'{name} has no rows')


def atb(A: torch.Tensor, B: torch.Tensor, *,
        sym: bool = False) -> tuple[torch.Tensor, str]:
    """Launch kernel A on CUDA tensors: AᵀB → (k, m) f32, and the variant
    that ran, :func:`~repro_torch.kernels._lib.atb_variant`'s answer.
    ``sym``: B is A (gram): the upper triangle is computed and mirrored, so
    the result is exactly symmetric. No counting: the public wrappers below
    count."""
    p, k = A.shape
    m = B.shape[1]
    _lib.require(A.is_contiguous() and B.is_contiguous(),
                 'atb needs contiguous row-major operands')
    variant = _lib.atb_variant(A.dtype, B.dtype, p, k, m,
                               (A.data_ptr(), B.data_ptr()))
    nblocks, rows = _lib.atb_split(p, k, m, _lib.sm_count(A.device))
    partial = torch.empty((nblocks, k * m), dtype=torch.float32,
                          device=A.device)
    out = torch.empty((k, m), dtype=torch.float32, device=A.device)
    code = _lib.lib().rt_atb(
        A.data_ptr(), _lib.DTYPE_CODE[A.dtype], B.data_ptr(),
        _lib.DTYPE_CODE[B.dtype], partial.data_ptr(), out.data_ptr(), p, k, m,
        int(sym), int(variant == 'tensor_cores'), nblocks, rows,
        _lib.stream())
    _lib.check(code, f'atb ({variant})')
    return out, variant


def nystrom_gram(C: torch.Tensor) -> torch.Tensor:
    """CᵀC for C (p, k) → (k, k) f32."""
    _check_operand(C, 'C')
    if _lib.device_of(C) == 'cpu':
        return ref.nystrom_gram(C)
    out, variant = atb(C, C, sym=True)
    _lib.LAUNCHES['nystrom_gram'] += 1
    _lib.LAUNCHES['nystrom_gram_tc'] += variant == 'tensor_cores'
    return out


def nystrom_cross(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """AᵀB for A (p, k) against a query block B (p, m) → (k, m) f32."""
    _check_operand(A, 'A')
    _check_operand(B, 'B')
    _lib.require(A.shape[0] == B.shape[0],
                 f'row mismatch: A has p={A.shape[0]}, B has p={B.shape[0]}')
    if _lib.device_of(A, B) == 'cpu':
        return ref.nystrom_cross(A, B)
    out, variant = atb(A, B)
    _lib.LAUNCHES['nystrom_cross'] += 1
    _lib.LAUNCHES['nystrom_cross_tc'] += variant == 'tensor_cores'
    return out
