"""Wrappers of CUDA kernel A (``csrc/atb.cu``): CᵀC and AᵀB over p.

They stand where ``repro/kernels/nystrom_gram.py``'s Pallas kernels stand.
A CUDA tensor launches the kernel (or raises on what the kernel does not
take); a CPU tensor runs the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref


def _check_operand(x: torch.Tensor, name: str) -> None:
    _lib.require(x.ndim == 2, f'{name} must be 2-D, got {tuple(x.shape)}')
    _lib.require(x.dtype in _lib.DTYPE_CODE,
                 f'{name} must be float32 or bfloat16, got {x.dtype}')
    _lib.require(x.shape[0] >= 1, f'{name} has no rows')


def _device_of(*xs: torch.Tensor) -> str:
    kinds = {x.device.type for x in xs}
    _lib.require(len(kinds) == 1 and len({x.device for x in xs}) == 1,
                 f'operands on different devices: {[x.device for x in xs]}')
    kind = kinds.pop()
    _lib.require(kind in ('cpu', 'cuda'), f'unsupported device {kind!r}')
    return kind


def atb(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Launch kernel A on CUDA tensors: AᵀB → (k, m) f32. No counting: the
    public wrappers below count."""
    p, k = A.shape
    m = B.shape[1]
    _lib.require(A.is_contiguous() and B.is_contiguous(),
                 'atb needs contiguous row-major operands')
    _lib.require(k <= 256 and m <= 256, f'atb takes k, m <= 256; got {k}, {m}')
    nblocks, rows = _lib.split_rows(p)
    partial = torch.empty((nblocks, k * m), dtype=torch.float32,
                          device=A.device)
    out = torch.empty((k, m), dtype=torch.float32, device=A.device)
    code = _lib.lib().rt_atb(
        A.data_ptr(), _lib.DTYPE_CODE[A.dtype], B.data_ptr(),
        _lib.DTYPE_CODE[B.dtype], partial.data_ptr(), out.data_ptr(), p, k, m,
        nblocks, rows, _lib.stream())
    _lib.check(code, 'atb')
    return out


def nystrom_gram(C: torch.Tensor) -> torch.Tensor:
    """CᵀC for C (p, k) → (k, k) f32."""
    _check_operand(C, 'C')
    if _device_of(C) == 'cpu':
        return ref.nystrom_gram(C)
    out = atb(C, C)
    _lib.LAUNCHES['nystrom_gram'] += 1
    return out


def nystrom_cross(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """AᵀB for A (p, k) against a query block B (p, m) → (k, m) f32."""
    _check_operand(A, 'A')
    _check_operand(B, 'B')
    _lib.require(A.shape[0] == B.shape[0],
                 f'row mismatch: A has p={A.shape[0]}, B has p={B.shape[0]}')
    if _device_of(A, B) == 'cpu':
        return ref.nystrom_cross(A, B)
    out = atb(A, B)
    _lib.LAUNCHES['nystrom_cross'] += 1
    return out
