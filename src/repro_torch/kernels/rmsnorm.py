"""Wrapper of CUDA kernel D (``csrc/rmsnorm.cu``): row RMSNorm.

It stands where ``repro/kernels/rmsnorm.py``'s Pallas kernel stands, and is
forward only, as that kernel is. A CUDA tensor launches the kernel (or
raises); a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of x (..., d) over its last axis, scaled by ``scale`` (d,);
    the result has x's dtype and shape."""
    _lib.require(x.ndim >= 1 and x.shape[-1] >= 1,
                 f'x must have a last axis, got {tuple(x.shape)}')
    d = x.shape[-1]
    _lib.require(tuple(scale.shape) == (d,),
                 f'scale must be ({d},), got {tuple(scale.shape)}')
    for name, t in (('x', x), ('scale', scale)):
        _lib.require(t.dtype in _lib.DTYPE_CODE,
                     f'{name} must be float32 or bfloat16, got {t.dtype}')
    if _lib.device_of(x, scale) == 'cpu':
        return ref.rmsnorm(x, scale, eps)
    _lib.require_no_grad('rmsnorm', x, scale)
    x = x.contiguous()
    if x.data_ptr() % 16:      # rows of x and out must share their alignment
        x = x.clone()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    n = x.numel() // d
    if n == 0:
        return out
    code = _lib.lib().rt_rmsnorm(
        x.data_ptr(), _lib.DTYPE_CODE[x.dtype], scale.data_ptr(),
        _lib.DTYPE_CODE[scale.dtype], out.data_ptr(), n, d, float(eps),
        _lib.stream())
    _lib.check(code, 'rmsnorm')
    _lib.LAUNCHES['rmsnorm'] += 1
    return out
