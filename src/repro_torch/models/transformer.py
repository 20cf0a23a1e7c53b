"""Decoder-only transformer of the dense family: the port of
``repro/models/transformer.py``'s ``init_params`` and ``forward``.

Parameters are a dict ``{'embed', 'unembed', 'blocks', 'final_norm'}``
with the reference's names; ``blocks`` is a list with one dict per block of
``cfg.block_period`` slots (one layer each in the dense family), which is
the reference's tree without ``scan_layers``' stacking. Depth is a Python
loop.

Only the dense family runs so far: attention mixers with dense SwiGLU
FFNs, token inputs and plain RoPE. MoE, Mamba, RWKV, encoder-decoder and
M-RoPE configs raise ``NotImplementedError`` (``ROADMAP.md`` queue 1 item
12), as do decode and the training loss.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, init_embedding, init_mlp,
                                       init_rmsnorm, mlp, pdtype, rmsnorm,
                                       rope_tables, unembed)


def check_ported(cfg: ModelConfig) -> None:
    """Raise on any part of ``cfg`` outside the dense family."""
    missing = [kind for kind in cfg.layer_kinds() if kind != ('attn', 'dense')]
    if cfg.is_encdec:
        missing.append('encoder-decoder')
    if cfg.mrope:
        missing.append('M-RoPE')
    if not cfg.embed_inputs:
        missing.append('embedding inputs')
    if missing:
        raise NotImplementedError(
            f'{cfg.name}: {sorted(set(map(str, missing)))} not ported yet; '
            'the port runs the dense family (ROADMAP.md queue 1 item 12)')


# ---------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (the card
    unless the caller passes ``device='cpu'``), drawn from ``generator``,
    which must lie on that device. Each weight is drawn in f32 and cast at
    once, so a bf16 init at full width (``param_dtype='bfloat16'``) peaks
    near its bf16 size plus one f32 weight."""
    check_ported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f'generator on {generator.device}, parameters on '
                         f'{dev}')
    dtype = pdtype(cfg)
    params: dict[str, Any] = {'embed': init_embedding(cfg, generator, dtype)}
    if not cfg.tie_embeddings:
        params['unembed'] = init_embedding(cfg, generator, dtype)
    params['blocks'] = [
        {f'slot{i}': {'ln1': init_rmsnorm(cfg, dev, dtype),
                      'ln2': init_rmsnorm(cfg, dev, dtype),
                      'mixer': attn.init_attention(cfg, generator, dtype),
                      'ffn': init_mlp(cfg, generator, dtype)}
         for i in range(cfg.block_period)}
        for _ in range(cfg.n_blocks)]
    params['final_norm'] = init_rmsnorm(cfg, dev, dtype)
    return params


# ------------------------------------------------------------------- forward
def _apply_slot(cfg: ModelConfig, sp: dict, x: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One pre-norm residual layer: attention, then the SwiGLU FFN. ln1 and
    ln2 go through kernel D when ``cfg.use_pallas``."""
    h = rmsnorm(sp['ln1'], x, cfg.norm_eps, cfg.use_pallas)
    x = x + attn.multihead_attention(sp['mixer'], h, cfg, rope=rope)
    h = rmsnorm(sp['ln2'], x, cfg.norm_eps, cfg.use_pallas)
    return x + mlp(sp['ffn'], h, cfg)


def forward(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            positions: torch.Tensor | None = None):
    """inputs: (B, S) int tokens. Returns (logits (B, S, V_padded), aux);
    aux is the reference's MoE router loss, 0 for the dense family."""
    check_ported(cfg)
    x = embed(params['embed'], inputs, cfg)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    rope = rope_tables(positions.to(x.device), cfg.head_dim, cfg.rope_theta)
    for block in params['blocks']:
        for i in range(cfg.block_period):
            x = _apply_slot(cfg, block[f'slot{i}'], x, rope)
    x = rmsnorm(params['final_norm'], x, cfg.norm_eps)
    table = params['embed'] if cfg.tie_embeddings else params['unembed']
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(table, x, cfg), aux
