"""Plain PyTorch versions of the Nyström kernels: the ground truth the CUDA
kernels are held against, and what the wrappers run on CPU tensors.

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
