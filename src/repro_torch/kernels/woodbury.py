"""Wrappers of CUDA kernels B (``csrc/ctv.cu``) and C
(``csrc/woodbury_apply.cu``): the Woodbury apply's two p-passes.

Pass 1, ``woodbury_ctv``: t = Cᵀv, (p, k) × (p,) → (k,); a (p, m) block
goes to :func:`~repro_torch.kernels.nystrom_gram.nystrom_cross`.
Pass 2, ``woodbury_apply``: u = v/ρ − C w/ρ², vector or (p, m) block, with
ρ a run-time argument.

They stand where ``repro/kernels/woodbury.py``'s Pallas kernels stand. A
CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels.nystrom_gram import (_check_operand, _device_of,
                                              nystrom_cross)


def woodbury_ctv(C: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """t = Cᵀv. v (p,) → (k,) via kernel B; v (p, m) → (k, m) via kernel A."""
    if v.ndim == 2:
        return nystrom_cross(C, v)
    _check_operand(C, 'C')
    p, k = C.shape
    _lib.require(v.shape == (p,), f'v must be ({p},), got {tuple(v.shape)}')
    _lib.require(v.dtype in _lib.DTYPE_CODE,
                 f'v must be float32 or bfloat16, got {v.dtype}')
    if _device_of(C, v) == 'cpu':
        return ref.woodbury_ctv(C, v)
    _lib.require(C.is_contiguous() and v.is_contiguous(),
                 'woodbury_ctv needs contiguous operands')
    _lib.require(k <= 256, f'woodbury_ctv takes k <= 256, got {k}')
    nblocks, rows = _lib.split_rows(p)
    partial = torch.empty((nblocks, k), dtype=torch.float32, device=C.device)
    out = torch.empty((k,), dtype=torch.float32, device=C.device)
    code = _lib.lib().rt_ctv(
        C.data_ptr(), _lib.DTYPE_CODE[C.dtype], v.data_ptr(),
        _lib.DTYPE_CODE[v.dtype], partial.data_ptr(), out.data_ptr(), p, k,
        nblocks, rows, _lib.stream())
    _lib.check(code, 'woodbury_ctv')
    _lib.LAUNCHES['woodbury_ctv'] += 1
    return out


def woodbury_apply(C: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                   rho: float) -> torch.Tensor:
    """u = v/ρ − C w/ρ². Vector (w (k,), v (p,)) → (p,) or block
    (w (k, m), v (p, m)) → (p, m), f32."""
    _check_operand(C, 'C')
    p, k = C.shape
    block = v.ndim == 2
    m = v.shape[1] if block else 1
    want_v, want_w = ((p, m), (k, m)) if block else ((p,), (k,))
    _lib.require(tuple(v.shape) == want_v,
                 f'v must be {want_v}, got {tuple(v.shape)}')
    _lib.require(tuple(w.shape) == want_w,
                 f'w must be {want_w}, got {tuple(w.shape)}')
    _lib.require(v.dtype in _lib.DTYPE_CODE,
                 f'v must be float32 or bfloat16, got {v.dtype}')
    rho = float(rho)
    _lib.require(rho > 0.0, f'rho must be positive, got {rho}')
    if _device_of(C, w, v) == 'cpu':
        return ref.woodbury_apply(C, w, v, rho)
    _lib.require(C.is_contiguous() and v.is_contiguous(),
                 'woodbury_apply needs contiguous C and v')
    _lib.require(k * m <= 8192, f'woodbury_apply takes k*m <= 8192, got {k * m}')
    w = w.float().contiguous()
    out = torch.empty(want_v, dtype=torch.float32, device=C.device)
    nblocks = max(1, min(-(-p * m // 256), 16 * 132))
    code = _lib.lib().rt_woodbury_apply(
        C.data_ptr(), _lib.DTYPE_CODE[C.dtype], w.data_ptr(), v.data_ptr(),
        _lib.DTYPE_CODE[v.dtype], out.data_ptr(), p, k, m, 1.0 / rho,
        1.0 / (rho * rho), nblocks, _lib.stream())
    _lib.check(code, 'woodbury_apply')
    _lib.LAUNCHES['woodbury_apply_block' if block else 'woodbury_apply'] += 1
    return out
