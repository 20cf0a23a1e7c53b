"""Wrapper of CUDA kernel E (``csrc/flash_attention.cu``): attention
forward, the prefill path's attention.

It stands where ``repro/kernels/flash_attention.py``'s Pallas kernel
stands, and is forward only, as that kernel is. A CUDA tensor launches the
kernel (or raises); a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`.

The contract is the Pallas kernel's: q (B, S, H, hd) and k, v (B, T, H, hd)
with H already GQA-expanded, hd ≤ 256, S % q_block == 0 and
T % k_block == 0 (blocks cut to S and T). The CUDA kernel's own tiles are
its business; the block sizes are checked, not used. Causal attention
needs S == T: the Pallas kernel aligns the diagonal top-left and the
reference oracle bottom-right, and the two agree only there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_block: int = 512, k_block: int = 512) -> torch.Tensor:
    """softmax(q kᵀ · scale) v per head → (B, S, H, hd) in q's dtype."""
    _lib.require(q.ndim == 4 and k.ndim == 4 and v.ndim == 4,
                 'q, k, v must be (B, S, H, hd)')
    B, S, H, hd = q.shape
    T = k.shape[1]
    _lib.require(tuple(k.shape) == (B, T, H, hd) and k.shape == v.shape,
                 f'k and v must be ({B}, T, {H}, {hd}); got '
                 f'{tuple(k.shape)} and {tuple(v.shape)}')
    _lib.require(q.dtype in _lib.DTYPE_CODE and k.dtype == q.dtype
                 and v.dtype == q.dtype,
                 'q, k, v must share one dtype, float32 or bfloat16')
    _lib.require(1 <= hd <= 256, f'head_dim must be in 1..256, got {hd}')
    q_block, k_block = min(q_block, S), min(k_block, T)
    _lib.require(q_block > 0 and k_block > 0 and S % q_block == 0
                 and T % k_block == 0,
                 f'seq must divide block: S={S}, q_block={q_block}, '
                 f'T={T}, k_block={k_block}')
    _lib.require(not causal or S == T,
                 f'causal attention needs S == T, got S={S}, T={T}')
    scale = hd ** -0.5 if scale is None else float(scale)
    if _lib.device_of(q, k, v) == 'cpu':
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    _lib.require_no_grad('flash_attention', q, k, v)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    code = _lib.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _lib.DTYPE_CODE[q.dtype], B, S, T, H, hd, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], scale, int(causal), _lib.stream())
    _lib.check(code, 'flash_attention')
    _lib.LAUNCHES['flash_attention'] += 1
    return out
