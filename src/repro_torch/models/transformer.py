"""Decoder-only transformer of the dense and MoE families: the port of
``repro/models/transformer.py``'s ``init_params``, ``forward``,
``train_loss``, ``init_cache`` and ``decode_step``.

Parameters are a dict ``{'embed', 'unembed', 'blocks', 'final_norm'}``
with the reference's names; ``blocks`` is a list with one dict per block of
``cfg.block_period`` slots (Llama-4 Maverick's block is a dense layer then
a MoE one), which is the reference's tree without ``scan_layers``'
stacking. Depth is a Python loop. ``forward`` returns the logits and the
sum over layers of the MoE router's aux loss (0 without experts).

``train_loss`` is the reference's masked next-token CE, weighted by
example: the bilevel inner objective of §5.4's data reweighting.
``cfg.remat`` (with ``scan_layers``, the reference's condition) runs each
block under ``torch.utils.checkpoint`` in a plain autograd pass; inside
``torch.func`` transforms (the HVP columns, the mixed term), which refuse
checkpoint's saved-tensor hooks, the blocks run plainly. Remat moves
memory, not values.

Decode keeps the reference's cache layout: ``{'pos': 0-d int32, 'slots':
{'slot{i}': {'k', 'v'}}}``, each leaf (n_blocks, B, Smax, KV, hd) in the
compute dtype, one allocation per slot. ``decode_step`` writes each
layer's new key and value into it in place and reads ``pos`` only on the
device.

What runs: attention mixers with dense SwiGLU or MoE FFNs, token inputs and
plain RoPE (:func:`check_ported`). Mamba, RWKV, encoder-decoder, M-RoPE
and embedding inputs raise ``NotImplementedError``, and so does training a
MoE config (:func:`check_trainable`), both naming ``ROADMAP.md``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cdtype, embed, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, pdtype,
                                       rmsnorm, rope_tables, unembed)
from repro_torch.models.moe import init_moe, moe_ffn


def check_ported(cfg: ModelConfig) -> None:
    """Raise on any part of ``cfg`` that forward, prefill and decode do not
    run: anything but attention mixers with dense or MoE FFNs over token
    inputs with plain RoPE."""
    missing = [kind for kind in cfg.layer_kinds() if kind[0] != 'attn']
    if cfg.is_encdec:
        missing.append('encoder-decoder')
    if cfg.mrope:
        missing.append('M-RoPE')
    if not cfg.embed_inputs:
        missing.append('embedding inputs')
    if missing:
        raise NotImplementedError(
            f'{cfg.name}: {sorted(set(map(str, missing)))} not ported yet; '
            'the port runs attention with dense or MoE FFNs (ROADMAP.md '
            'queue 1 item 12)')


def check_trainable(cfg: ModelConfig) -> None:
    """:func:`check_ported`, and no MoE FFN: MoE training needs
    ``_rdot``'s VJP and data-dependent routing under ``torch.func``'s HVP
    columns, which are not ported yet."""
    check_ported(cfg)
    if any(ffn == 'moe' for _, ffn in cfg.layer_kinds()):
        raise NotImplementedError(
            f'{cfg.name}: training a MoE config is not ported yet; the port '
            'serves it (forward, prefill, decode) but trains the dense '
            'family only (ROADMAP.md queue 1 item 12)')


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
    gen_dev = 'meta' if generator is None else generator.device.type
    if gen_dev != dev.type:      # no generator: abstract_params, on meta
        raise ValueError(f'generator on {gen_dev}, parameters on {dev}')
    dtype = pdtype(cfg)
    params: dict[str, Any] = {'embed': init_embedding(cfg, generator, dtype)}
    if not cfg.tie_embeddings:
        params['unembed'] = init_embedding(cfg, generator, dtype)
    params['blocks'] = [
        {f'slot{i}': {'ln1': init_rmsnorm(cfg, dev, dtype),
                      'ln2': init_rmsnorm(cfg, dev, dtype),
                      'mixer': attn.init_attention(cfg, generator, dtype),
                      'ffn': (init_moe(cfg, generator, dtype) if ffn == 'moe'
                              else init_mlp(cfg, generator, dtype))}
         for i, (_, ffn) in enumerate(cfg.layer_kinds())}
        for _ in range(cfg.n_blocks)]
    params['final_norm'] = init_rmsnorm(cfg, dev, dtype)
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as unfilled ``meta`` tensors: shapes, dtypes and
    leaf order, no storage (the reference's ``jax.eval_shape(init)``)."""
    return init_params(cfg, None, device='meta')


# ------------------------------------------------------------------- forward
def _ffn(cfg: ModelConfig, ffn: str, params, h: torch.Tensor):
    """The slot's FFN: (out, aux), aux None for a dense one."""
    if ffn == 'moe':
        return moe_ffn(params, h, cfg)
    return mlp(params, h, cfg), None


def _add_aux(total, aux):
    """Sum of the aux losses so far; None while every one was None."""
    return aux if total is None else (total if aux is None else total + aux)


def _apply_slot(cfg: ModelConfig, sp: dict, x: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor], ffn: str):
    """One pre-norm residual layer: attention, then the FFN (SwiGLU or
    MoE). Returns (x, aux), aux None for a dense FFN. ln1 and ln2 go
    through kernel D when ``cfg.use_pallas``."""
    h = rmsnorm(sp['ln1'], x, cfg.norm_eps, cfg.use_pallas)
    x = x + attn.multihead_attention(sp['mixer'], h, cfg, rope=rope)
    h = rmsnorm(sp['ln2'], x, cfg.norm_eps, cfg.use_pallas)
    h, aux = _ffn(cfg, ffn, sp['ffn'], h)
    return x + h, aux


def _apply_block(cfg: ModelConfig, block: dict, x: torch.Tensor,
                 rope: tuple[torch.Tensor, torch.Tensor]):
    """The block's slots in order: (x, the sum of their aux or None)."""
    aux = None
    for i, (_, ffn) in enumerate(cfg.layer_kinds()):
        x, a = _apply_slot(cfg, block[f'slot{i}'], x, rope, ffn)
        aux = _add_aux(aux, a)
    return x, aux


def _save_dots(ctx, op, *args, **kwargs):
    """remat='dots': keep the outputs of plain matmuls (the reference's
    ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_active(cfg: ModelConfig) -> bool:
    """Blocks run under activation checkpointing: ``cfg.remat`` with
    ``scan_layers`` (the reference remats the scanned body only), in an
    autograd pass that records a graph, outside ``torch.func``'s
    transforms."""
    return (cfg.remat != 'none' and cfg.scan_layers
            and torch.is_grad_enabled()
            and torch._C._functorch.peek_interpreter_stack() is None)


def forward(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            positions: torch.Tensor | None = None):
    """inputs: (B, S) int tokens. Returns (logits (B, S, V_padded), aux);
    aux is the reference's MoE router loss summed over layers, 0 for the
    dense family."""
    check_ported(cfg)
    x = embed(params['embed'], inputs, cfg)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    rope = rope_tables(positions.to(x.device), cfg.head_dim, cfg.rope_theta)
    remat = _remat_active(cfg)
    aux = None
    for block in params['blocks']:
        if not remat:
            x, a = _apply_block(cfg, block, x, rope)
        elif cfg.remat == 'dots':
            x, a = checkpoint(_apply_block, cfg, block, x, rope,
                              use_reentrant=False,
                              context_fn=lambda: (
                                  create_selective_checkpoint_contexts(
                                      _save_dots)))
        else:
            x, a = checkpoint(_apply_block, cfg, block, x, rope,
                              use_reentrant=False)
        aux = _add_aux(aux, a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = rmsnorm(params['final_norm'], x, cfg.norm_eps)
    table = params['embed'] if cfg.tie_embeddings else params['unembed']
    return unembed(table, x, cfg), aux


# ------------------------------------------------------------------- losses
def train_loss(cfg: ModelConfig, params: dict, batch: dict,
               example_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token CE, the bilevel inner objective f.

    ``batch``: ``inputs`` and ``labels`` (B, S) ints, optional ``mask``
    (B, S) and ``positions``. ``example_weights``: optional (B,) loss
    weights per example, where the outer parameters of data reweighting
    (§5.4) enter. The reference's formula, op for op: the logits stay in
    the compute dtype, the log-sum-exp and the label's logit (a masked max,
    as the reference picks it) are reduced in f32, and the loss is
    Σ tok·w / max(Σ w, 1e-6) plus the dense family's zero aux term. A MoE
    config raises (:func:`check_trainable`)."""
    check_trainable(cfg)
    logits, aux = forward(cfg, params, batch['inputs'],
                          positions=batch.get('positions'))
    labels = batch['labels'].to(logits.device)
    mask = batch.get('mask')
    V = logits.shape[-1]
    is_label = (torch.arange(V, device=logits.device)
                == labels[..., None].long())
    m = torch.amax(logits, dim=-1).float()                       # (B, S)
    sumexp = torch.sum(torch.exp(logits.float() - m[..., None]), dim=-1)
    lse = m + torch.log(sumexp)
    ll = torch.amax(torch.where(is_label, logits,
                                torch.finfo(logits.dtype).min),
                    dim=-1).float()
    tok_loss = lse - ll                                          # (B, S)
    mask = (torch.ones_like(tok_loss) if mask is None
            else mask.to(tok_loss.device))
    if example_weights is not None:
        mask = mask * example_weights[:, None]
    loss = (tok_loss * mask).sum() / torch.clamp(mask.sum(), min=1e-6)
    return loss + aux


# -------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None, device=None) -> dict:
    """The zeroed decode cache on ``device`` (the card unless the caller
    passes ``device='cpu'``): ``{'pos': 0-d int32, 'slots': {'slot{i}':
    {'k', 'v'}}}``, each leaf (n_blocks, B, max_len, KV, hd) in ``dtype``
    (default the compute dtype), the reference's layout."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cdtype(cfg)
    slots = {}
    for i in range(cfg.block_period):
        kv = attn.init_kv_cache(cfg, cfg.n_blocks, batch, max_len, dtype, dev)
        slots[f'slot{i}'] = {'k': kv['k'], 'v': kv['v']}
    return {'pos': torch.zeros((), dtype=torch.int32, device=dev),
            'slots': slots}


def decode_step(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                cache: dict):
    """One token for every sequence. inputs: (B, 1) int tokens. Returns
    (logits (B, 1, V_padded), cache) with ``pos + 1``.

    The input cache is consumed, as the reference donates it: its k and v
    leaves are written in place and come back in the returned cache, and
    ``pos`` stays on the device. RMSNorm takes its plain path, as in the
    reference's decode; a MoE layer reads its group sizes on the host."""
    check_ported(cfg)
    pos = cache['pos']
    x = embed(params['embed'], inputs.to(pos.device), cfg)
    B = x.shape[0]
    rope = rope_tables(pos.to(torch.int32).expand(B, 1), cfg.head_dim,
                       cfg.rope_theta)
    for b, block in enumerate(params['blocks']):
        for i, (_, ffn) in enumerate(cfg.layer_kinds()):
            sp, sc = block[f'slot{i}'], cache['slots'][f'slot{i}']
            h = rmsnorm(sp['ln1'], x, cfg.norm_eps)
            h, _, _ = attn.decode_attention(sp['mixer'], h, sc['k'][b],
                                            sc['v'][b], pos, cfg, rope=rope)
            x = x + h
            h = rmsnorm(sp['ln2'], x, cfg.norm_eps)
            x = x + _ffn(cfg, ffn, sp['ffn'], h)[0]
    x = rmsnorm(params['final_norm'], x, cfg.norm_eps)
    table = params['embed'] if cfg.tie_embeddings else params['unembed']
    return unembed(table, x, cfg), {'pos': pos + 1, 'slots': cache['slots']}
