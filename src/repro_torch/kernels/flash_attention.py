"""Wrapper of CUDA kernel E (``csrc/flash_attention.cu``): attention
forward, the prefill path's attention.

It stands where ``repro/kernels/flash_attention.py``'s Pallas kernel
stands, and is forward only, as that kernel is. A CUDA tensor launches one
of kernel E's two variants (or raises); a CPU tensor runs the plain
version in :mod:`repro_torch.kernels.ref` on the KV heads repeated to H
(:func:`expand_kv`).

The contract is the Pallas kernel's, with the KV heads read in place: q
(B, S, H, hd) and k, v (B, T, KV, hd) with H % KV == 0 (query head h reads
KV head h // (H // KV); KV == H is the Pallas kernel's own contract),
hd ≤ 256, S % q_block == 0 and T % k_block == 0 (blocks cut to S and T).
The CUDA kernels' own tiles are their business; the block sizes are
checked, not used. Causal attention needs S == T: the Pallas kernel aligns
the diagonal top-left and the reference oracle bottom-right, and the two
agree only there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref


def expand_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """(B, T, KV, hd) → (B, T, KV·group, hd), each KV head repeated group
    times in place (a copy; ``k`` itself when group == 1)."""
    if group == 1:
        return k
    B, T, KV, hd = k.shape
    return k[:, :, :, None, :].expand(B, T, KV, group, hd).reshape(
        B, T, KV * group, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_block: int = 512, k_block: int = 512) -> torch.Tensor:
    """softmax(q kᵀ · scale) v per head → (B, S, H, hd) in q's dtype.

    On CUDA tensors one rule picks kernel E's variant, and nothing else
    does: bf16 with hd ∈ {64, 128} whose base addresses and (batch,
    sequence, head) strides all lie on the 16-byte grid, the strides
    positive (what TMA can address), runs the tensor-core kernel (``flash_fwd_tc``, counted in
    ``LAUNCHES['flash_attention_tc']``); everything else, f32 included,
    runs the CUDA-core kernel (``flash_fwd``). A failure of the chosen
    kernel raises; there is no fallback to the other."""
    _lib.require(q.ndim == 4 and k.ndim == 4 and v.ndim == 4,
                 'q, k, v must be (B, S, H, hd)')
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    _lib.require(tuple(k.shape) == (B, T, KV, hd) and k.shape == v.shape,
                 f'k and v must be ({B}, T, KV, {hd}); got '
                 f'{tuple(k.shape)} and {tuple(v.shape)}')
    _lib.require(KV >= 1 and H % KV == 0,
                 f'query heads must be a multiple of KV heads: H={H}, '
                 f'KV={KV}')
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
        return ref.flash_attention(q, expand_kv(k, H // KV),
                                   expand_kv(v, H // KV), causal=causal,
                                   scale=scale)
    _lib.require_no_grad('flash_attention', q, k, v)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if (q.dtype == torch.bfloat16 and hd in (64, 128)
            and all(t.data_ptr() % 16 == 0
                    and all(st > 0 and st % 8 == 0 for st in t.stride()[:3])
                    for t in (q, k, v))):
        code = _lib.lib().rt_flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            T, H, KV, hd, *strides, scale, int(causal), _lib.stream())
        _lib.check(code, 'flash_attention (tensor cores)')
        _lib.LAUNCHES['flash_attention_tc'] += 1
    else:
        code = _lib.lib().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _lib.DTYPE_CODE[q.dtype], B, S, T, H, KV, hd, *strides, scale,
            int(causal), _lib.stream())
        _lib.check(code, 'flash_attention')
    _lib.LAUNCHES['flash_attention'] += 1
    return out
