"""Public kernel wrappers, and the Eq. 6 apply composed from them.

The counterpart of ``repro/kernels/ops.py``. There is no interpret mode: a
CUDA tensor goes through the hand-written kernel, a CPU tensor through its
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.nystrom_gram import nystrom_cross, nystrom_gram
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.woodbury import woodbury_apply, woodbury_ctv

__all__ = ['nystrom_gram', 'nystrom_cross', 'woodbury_ctv', 'woodbury_apply',
           'nystrom_ihvp_apply', 'rmsnorm', 'flash_attention']


def nystrom_ihvp_apply(C: torch.Tensor, H_KK: torch.Tensor, v: torch.Tensor,
                       rho: float) -> torch.Tensor:
    """Full Eq. 6 apply through the kernels: t = Cᵀv (kernel B) →
    w = solve(H_KK + CᵀC/ρ, t) (Jacobi-scaled k×k solve) → u = v/ρ − C w/ρ²
    (kernel C), with CᵀC from kernel A. One C-read per pass."""
    t = woodbury_ctv(C, v)
    gram = nystrom_gram(C)
    M = H_KK + gram / rho
    M = 0.5 * (M + M.T)
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(M)), min=1e-30))
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    w = torch.linalg.solve(M / d[:, None] / d[None, :] + 1e-7 * eye,
                           t / d) / d
    return woodbury_apply(C, w, v, rho)
