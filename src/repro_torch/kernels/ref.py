"""Plain PyTorch versions of the kernels: the ground truth the CUDA kernels
are held against, and what the wrappers run on CPU tensors.

Every input is widened to f32 before it is multiplied, as in the reference
(``repro/kernels/ref.py``): a bf16 sketch is stored in bf16 and accumulated
in f32. Float64 inputs stay float64: ``chip_smoke.py`` evaluates these same
functions in f64 as the reference for sums over millions of rows, where
cuBLAS's own f32 rounding is as large as the kernels'.
"""
from __future__ import annotations

import torch


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def nystrom_gram(C: torch.Tensor) -> torch.Tensor:
    """CᵀC for tall-skinny C (p, k) → (k, k), f32 accumulation."""
    Cf = _wide(C)
    return Cf.T @ Cf


def nystrom_cross(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """AᵀB : (p, k), (p, m) → (k, m), f32 accumulation."""
    return _wide(A).T @ _wide(B)


def woodbury_ctv(C: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """t = Cᵀ v : (p, k), (p,) → (k,) — or (p, m) → (k, m) for a block."""
    return _wide(C).T @ _wide(v)


def woodbury_apply(C: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                   rho: float) -> torch.Tensor:
    """u = v/ρ − C w / ρ² (vector w (k,), v (p,) — or block w (k, m),
    v (p, m))."""
    corr = _wide(C) @ _wide(w)
    return _wide(v) / rho - corr / (rho * rho)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last axis: variance in f32, then
    ``y.to(x.dtype) * scale.to(x.dtype)`` (the reference's cast order)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Dense-softmax attention in f32. q (B, S, H, hd), k/v (B, T, H, hd)
    with H already GQA-expanded; the causal diagonal is aligned
    bottom-right (``tril(·, T − S)``), as in the reference oracle."""
    S, hd = q.shape[1], q.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    logits = torch.einsum('bshd,bthd->bhst', q.float(), k.float()) * scale
    if causal:
        T = k.shape[1]
        mask = torch.ones((S, T), dtype=torch.bool,
                          device=q.device).tril(T - S)
        logits = logits.masked_fill(~mask, float('-inf'))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum('bhst,bthd->bshd', w, v.float()).to(q.dtype)
