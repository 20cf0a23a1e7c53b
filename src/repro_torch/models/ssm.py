"""Mamba-1 selective SSM block (Jamba's mixer): the port of
``repro/models/ssm.py``'s ``init_mamba``, ``_ssm_inputs``, ``mamba_scan``,
``init_mamba_state`` and ``mamba_decode``.

The scan is a plain loop over time that carries the state ``h``
(B, d_inner, d_state) in f32, as the reference's ``lax.scan`` does; the
reference has no scan kernel (its CUDA selective scan became ``lax.scan``),
so neither has the port. Where the reference chunks the scan (``S %
chunk == 0 and S > chunk``, ``chunk`` 64 by default) and runs each chunk
under ``jax.checkpoint``, the port runs each chunk under
``torch.utils.checkpoint`` in an autograd pass that records a graph
(:func:`~repro_torch.models.layers.records_graph`): backward keeps the
state at the chunks' boundaries and recomputes their interiors, O(S/chunk)
states instead of O(S). Chunking moves memory, not values: the gradients
with and without it are equal bit for bit. Inside ``torch.func``
transforms (the HVP columns), which refuse checkpoint's saved-tensor
hooks, and without a graph (prefill), the loop runs in one piece.

The casts are the reference's: ``Bc``, ``Cc``, ``dt_`` and ``A`` in f32,
``u``, ``z`` and the projections in the compute dtype. The f32
``decay``/``drive`` tensors are (B, S, d_inner, d_state) each and are
materialised, as in the reference, by the loop in one piece, or a chunk
at a time inside each checkpointed chunk (which so keeps none of them).
Decode carries the conv window and the SSM state, O(1) in the sequence
length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, dense_init, records_graph

CHUNK = 64         # the reference's scan chunk


def init_mamba(cfg: ModelConfig, generator: torch.Generator | None,
               dtype: torch.dtype) -> dict:
    """The reference's leaves, shapes and scales, drawn from
    ``generator`` (``None``: unfilled ``meta`` tensors). ``dt_proj_b`` is
    softplus⁻¹ of a step drawn log-uniform in [1e-3, 1e-1]; ``A_log`` is
    log(1..d_state) on every channel."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.d_state
    dev = 'meta' if generator is None else generator.device
    p = {'in_proj': dense_init(generator, (d, 2 * di), dtype),
         'conv_w': dense_init(generator, (cfg.d_conv, di), dtype,
                              scale=cfg.d_conv ** -0.5),
         'conv_b': torch.zeros((di,), dtype=dtype, device=dev),
         'x_proj': dense_init(generator, (di, 2 * ds + 1), dtype),
         'dt_proj_w': dense_init(generator, (1, di), dtype, scale=1.0)}
    if generator is None:
        p['dt_proj_b'] = torch.empty((di,), dtype=dtype, device='meta')
    else:
        u = torch.empty((di,), dtype=torch.float32, device=dev)
        u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
        p['dt_proj_b'] = torch.log(torch.expm1(torch.exp(u))).to(dtype)
    # a leaf of its own: an expanded view would alias one row d_inner
    # times, which forward-mode AD (the HVP columns) and in-place updates
    # refuse
    p['A_log'] = torch.log(torch.arange(
        1, ds + 1, dtype=torch.float32, device=dev)).expand(
            di, ds).contiguous().to(dtype)
    p['D'] = torch.ones((di,), dtype=dtype, device=dev)
    p['out_proj'] = dense_init(generator, (di, d), dtype)
    return p


def _selective(params, u: torch.Tensor, cfg: ModelConfig):
    """From the conv's output u (…, d_inner): Bc, Cc (…, d_state) and
    dt_ (…, d_inner) in f32, and A (d_inner, d_state) in f32."""
    ct, ds = cdtype(cfg), cfg.d_state
    bcd = u @ params['x_proj'].to(ct)                        # (…, 2ds+1)
    Bc = bcd[..., :ds].float()
    Cc = bcd[..., ds:2 * ds].float()
    dt_raw = bcd[..., -1:] @ params['dt_proj_w'].to(ct)      # (…, di)
    dt_ = F.softplus(dt_raw.float() + params['dt_proj_b'].float())
    A = -torch.exp(params['A_log'].float())
    return Bc, Cc, dt_, A


def _ssm_inputs(params, x: torch.Tensor, cfg: ModelConfig):
    """The shared front half: the input projection, the depthwise causal
    conv over time, then the selective (Δ, B̄, C). x: (B, S, d). Returns
    u, z (B, S, d_inner) in the compute dtype, dt_, Bc, Cc and A."""
    ct = cdtype(cfg)
    xz = x @ params['in_proj'].to(ct)                        # (B, S, 2di)
    u, z = xz.chunk(2, dim=-1)
    S = u.shape[1]
    w = params['conv_w'].to(ct)                              # (K, di)
    pad = F.pad(u, (0, 0, cfg.d_conv - 1, 0))
    conv = pad[:, 0:S] * w[0]
    for i in range(1, cfg.d_conv):
        conv = conv + pad[:, i:i + S] * w[i]
    u = F.silu(conv + params['conv_b'].to(ct))
    Bc, Cc, dt_, A = _selective(params, u, cfg)
    return u, z, dt_, Bc, Cc, A


def _output(params, y: torch.Tensor, u: torch.Tensor, z: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """(y + u·D) · silu(z), projected out; all in the compute dtype."""
    ct = cdtype(cfg)
    y = y + u * params['D'].to(ct)
    return (y * F.silu(z)) @ params['out_proj'].to(ct)


def mamba_scan(params, x: torch.Tensor, cfg: ModelConfig,
               chunk: int = CHUNK) -> torch.Tensor:
    """Forward, prefill and training. x: (B, S, d) → (B, S, d). The state
    starts at zero; each step is h = h·decay_t + drive_t, y_t = h·C_t;
    ``chunk`` as in :func:`_scan`."""
    u, z, dt_, Bc, Cc, A = _ssm_inputs(params, x, cfg)
    y = _scan(dt_, u.float(), Bc, Cc, A, chunk)
    return _output(params, y.to(cdtype(cfg)), u, z, cfg)


def _scan(dt_: torch.Tensor, u: torch.Tensor, Bc: torch.Tensor,
          Cc: torch.Tensor, A: torch.Tensor,
          chunk: int = CHUNK) -> torch.Tensor:
    """The time loop: h_t = h_{t−1}·decay_t + drive_t from h = 0, and
    y_t = h_t·C_t, with decay_t = exp(Δ_t·A) and drive_t = Δ_t·u_t ⊗ B_t.
    dt_ and u (B, S, d_inner), Bc and Cc (B, S, d_state), A (d_inner,
    d_state), all f32. Returns y (B, S, d_inner) f32; two launches a step.
    By chunks of ``chunk`` steps under ``torch.utils.checkpoint`` where
    the reference chunks and a graph is recorded (the module's
    docstring), else in one piece. Each piece makes its own (B, s,
    d_inner, d_state) decay and drive, so that a checkpointed chunk keeps
    only its boundary state and its (B, s, d_inner) inputs."""
    B, S, di = dt_.shape
    ds = A.shape[1]
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=dt_.device)
    # A broadcast over (B, S) as a view, so that its gradient is reduced
    # over (B, S) once, after the pieces have been put together
    A = A.expand(B, S, di, ds)
    if not (S % chunk == 0 and S > chunk
            and records_graph(dt_, u, Bc, Cc, A)):
        return _scan_steps(h, dt_, u, Bc, Cc, A)[1].transpose(1, 2)
    ys = []
    for t in range(0, S, chunk):
        part = slice(t, t + chunk)
        h, y = checkpoint(_scan_steps, h, dt_[:, part], u[:, part],
                          Bc[:, part], Cc[:, part], A[:, part],
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=-1).transpose(1, 2)


def _scan_steps(h: torch.Tensor, dt_, u, Bc, Cc, A):
    """:func:`_scan`'s steps over (B, s, …) inputs (A expanded to (B, s,
    d_inner, d_state)) from the state h (B, d_inner, d_state). Returns
    (the last h, y (B, d_inner, s))."""
    decay = (dt_[..., None] * A).exp_()                      # (B,s,di,ds)
    drive = (dt_ * u)[..., None] * Bc[:, :, None, :]
    ys = []
    for dec, drv, c in zip(decay.unbind(1), drive.unbind(1),
                           Cc[..., None].unbind(1)):
        h = torch.addcmul(drv, h, dec)
        ys.append(h @ c)                                     # (B, di, 1)
    return h, torch.cat(ys, dim=-1)


def init_mamba_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The decode carry: the conv window's last d_conv − 1 inputs and the
    SSM state, both f32 zeros."""
    return {'conv': torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                dtype=torch.float32, device=device),
            'ssm': torch.zeros((batch, cfg.d_inner, cfg.d_state),
                               dtype=torch.float32, device=device)}


def mamba_decode(params, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """One decode step. x: (B, 1, d); ``state`` as :func:`init_mamba_state`.
    Returns (out (B, 1, d), new state); the state is not written."""
    ct = cdtype(cfg)
    xz = x[:, 0, :] @ params['in_proj'].to(ct)
    u, z = xz.chunk(2, dim=-1)                               # (B, di)
    window = torch.cat([state['conv'].to(ct), u[:, None, :]], dim=1)
    u_conv = torch.einsum('bkd,kd->bd', window, params['conv_w'].to(ct))
    u_conv = F.silu(u_conv + params['conv_b'].to(ct))
    Bc, Cc, dt_, A = _selective(params, u_conv, cfg)
    h = (state['ssm'] * torch.exp(dt_[..., None] * A)
         + (dt_ * u_conv.float())[..., None] * Bc[:, None, :])
    y = torch.einsum('bdn,bn->bd', h, Cc).to(ct)
    out = _output(params, y, u_conv, z, cfg)[:, None, :]
    return out, {'conv': window[:, 1:, :].float(), 'ssm': h}
