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
from repro_torch.kernels.nystrom_gram import _check_operand, nystrom_cross


def woodbury_ctv(C: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """t = Cᵀv. v (p,) → (k,) via kernel B (one launch, one allocation: t;
    the blocks' partials and the ticket counter live in the stream's
    scratch, :func:`~repro_torch.kernels._lib.ctv_scratch`); v (p, m) →
    (k, m) via kernel A."""
    if v.ndim == 2:
        return nystrom_cross(C, v)
    _check_operand(C, 'C')
    p, k = C.shape
    _lib.require(v.shape == (p,), f'v must be ({p},), got {tuple(v.shape)}')
    _lib.require(v.dtype in _lib.DTYPE_CODE,
                 f'v must be float32 or bfloat16, got {v.dtype}')
    if _lib.device_of(C, v) == 'cpu':
        return ref.woodbury_ctv(C, v)
    _lib.require(C.is_contiguous() and v.is_contiguous(),
                 'woodbury_ctv needs contiguous operands')
    rows16 = _lib.ctv_path(C.dtype, k, C.data_ptr()) == 'ctv_rows16'
    nrb = _lib.ctv_blocks(p, k, C.element_size(), rows16,
                          _lib.sm_count(C.device))
    out = torch.empty((k,), dtype=torch.float32, device=C.device)
    stream = _lib.stream()
    scratch = _lib.ctv_scratch(C.device, stream, nrb * k).data_ptr()
    code = _lib.lib().rt_ctv(
        C.data_ptr(), _lib.DTYPE_CODE[C.dtype], v.data_ptr(),
        _lib.DTYPE_CODE[v.dtype], scratch + 16, out.data_ptr(), scratch, p,
        k, nrb, int(rows16), stream)
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
    if _lib.device_of(C, w, v) == 'cpu':
        return ref.woodbury_apply(C, w, v, rho)
    _lib.require(C.is_contiguous() and v.is_contiguous(),
                 'woodbury_apply needs contiguous C and v')
    w = w.float().contiguous()
    out = torch.empty(want_v, dtype=torch.float32, device=C.device)
    code = _lib.lib().rt_woodbury_apply(
        C.data_ptr(), _lib.DTYPE_CODE[C.dtype], w.data_ptr(), v.data_ptr(),
        _lib.DTYPE_CODE[v.dtype], out.data_ptr(), p, k, m, 1.0 / rho,
        1.0 / (rho * rho), int(_lib.rows16(C.dtype, k, C.data_ptr())),
        _lib.sm_count(C.device), _lib.stream())
    _lib.check(code, 'woodbury_apply')
    _lib.LAUNCHES['woodbury_apply_block' if block else 'woodbury_apply'] += 1
    return out
