"""The model zoo's transformer over every family of the reference: the
port of ``repro/models/transformer.py``'s ``init_params``, ``forward``,
``encode``, ``train_loss``, ``init_cache``, ``fill_cross_cache`` and
``decode_step``.

Layers are grouped into blocks of ``cfg.block_period`` slots, each slot an
attention, Mamba (``ssm.py``) or RWKV-6 (``rwkv.py``) mixer with a dense
SwiGLU or MoE FFN (RWKV's channel mix is its FFN). Parameters are a dict
with the reference's names: ``blocks`` is a list with one dict per block,
the reference's tree without ``scan_layers``' stacking; inputs are tokens
through ``embed`` or, where ``cfg.embed_inputs`` is off, precomputed
(B, S, d) embeddings (the modality frontend is a stub, as in the
reference) with only ``unembed``. An encoder-decoder (``n_enc_layers`` >
0) adds ``enc_blocks`` (period-1 dense attention, non-causal),
``enc_final_norm``, the decoder's token ``embed``, and cross-attention in
every decoder slot. Depth is a Python loop. ``forward`` returns the logits
and the sum over layers of the MoE router's aux loss (0 without experts).

Kernel D takes ``ln1``/``ln2`` of every non-RWKV slot and kernel E the
self-attention past ``attn_chunk`` when ``cfg.use_pallas``, as in the
reference; the final norm, ``ln_cross``, RWKV's norms, cross-attention
and every decode norm stay plain there and here.

``train_loss`` is the reference's masked next-token CE, weighted by
example: the bilevel inner objective of §5.4's data reweighting.
``cfg.remat`` (with ``scan_layers``, the reference's condition) runs each
block under ``torch.utils.checkpoint`` in a plain autograd pass; inside
``torch.func`` transforms (the HVP columns, the mixed term), which refuse
checkpoint's saved-tensor hooks, the blocks run plainly. Remat moves
memory, not values; a MoE layer's routing (on one rank, with its host
sync) runs again in the recompute. Every family trains. The Mamba and
RWKV time loops checkpoint their chunks of 64 steps in such a pass, as
the reference does, whatever ``cfg.remat`` says; under ``'full'`` and
``'dots'`` that checkpoint nests inside the block's (for ``'dots'``,
inside its selective-checkpoint context), and the gradients stay those
without remat.

Decode keeps the reference's cache layout: ``{'pos': 0-d int32, 'slots':
{'slot{i}': state}}`` (and ``'cross': {'k', 'v'}`` for an
encoder-decoder), each leaf leading with ``n_blocks``, one allocation per
slot: ``{'k', 'v'}`` (n_blocks, B, Smax, KV, hd) in the compute dtype for
attention, ``{'conv', 'ssm'}`` for Mamba and ``{'tm_prev', 'cm_prev',
'wkv'}`` for RWKV in f32. ``decode_step`` writes each layer's new key and
value, or its new recurrent state, into the cache in place and reads
``pos`` only on the device.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cdtype, embed, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, pdtype,
                                       records_graph, rmsnorm, rope_for,
                                       rope_tables, split_token_loss,
                                       unembed)
from repro_torch.models.moe import init_moe, moe_ffn, moe_split

_ENC_KINDS = [('attn', 'dense')]   # the encoder's one slot a block


# ---------------------------------------------------------------------- init
def _init_slot(cfg: ModelConfig, generator, dtype: torch.dtype, dev,
               mixer: str, ffn: str, with_cross: bool) -> dict:
    p: dict[str, Any] = {'ln1': init_rmsnorm(cfg, dev, dtype),
                         'ln2': init_rmsnorm(cfg, dev, dtype)}
    if mixer == 'attn':
        p['mixer'] = attn.init_attention(cfg, generator, dtype)
    elif mixer == 'mamba':
        p['mixer'] = ssm_lib.init_mamba(cfg, generator, dtype)
    else:                              # rwkv: ln2 feeds its channel mix
        p['mixer'] = rwkv_lib.init_rwkv_block(cfg, generator, dtype)
    if mixer != 'rwkv':
        p['ffn'] = (init_moe(cfg, generator, dtype) if ffn == 'moe'
                    else init_mlp(cfg, generator, dtype))
    if with_cross:
        p['ln_cross'] = init_rmsnorm(cfg, dev, dtype)
        p['cross'] = attn.init_attention(cfg, generator, dtype, cross=True)
    return p


def _init_blocks(cfg: ModelConfig, generator, dtype: torch.dtype, dev,
                 n_blocks: int, kinds, with_cross: bool) -> list:
    return [{f'slot{i}': _init_slot(cfg, generator, dtype, dev, mixer, ffn,
                                    with_cross)
             for i, (mixer, ffn) in enumerate(kinds)}
            for _ in range(n_blocks)]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (the card
    unless the caller passes ``device='cpu'``), drawn from ``generator``,
    which must lie on that device. Each weight is drawn in f32 and cast at
    once, so a bf16 init at full width (``param_dtype='bfloat16'``) peaks
    near its bf16 size plus one f32 weight."""
    dev = resolve_device(device)
    gen_dev = 'meta' if generator is None else generator.device.type
    if gen_dev != dev.type:      # no generator: abstract_params, on meta
        raise ValueError(f'generator on {gen_dev}, parameters on {dev}')
    dtype = pdtype(cfg)
    params: dict[str, Any] = {}
    if cfg.embed_inputs:
        params['embed'] = init_embedding(cfg, generator, dtype)
        if not cfg.tie_embeddings:
            params['unembed'] = init_embedding(cfg, generator, dtype)
    else:       # a stub frontend: inputs arrive as (B, S, d) embeddings
        params['unembed'] = init_embedding(cfg, generator, dtype)
    params['blocks'] = _init_blocks(cfg, generator, dtype, dev, cfg.n_blocks,
                                    cfg.layer_kinds(), cfg.is_encdec)
    params['final_norm'] = init_rmsnorm(cfg, dev, dtype)
    if cfg.is_encdec:
        params['enc_blocks'] = _init_blocks(cfg, generator, dtype, dev,
                                            cfg.n_enc_layers, _ENC_KINDS,
                                            False)
        params['enc_final_norm'] = init_rmsnorm(cfg, dev, dtype)
        params['embed'] = init_embedding(cfg, generator, dtype)  # decoder's
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as unfilled ``meta`` tensors: shapes, dtypes and
    leaf order, no storage (the reference's ``jax.eval_shape(init)``)."""
    return init_params(cfg, None, device='meta')


# ------------------------------------------------------------------- forward
def _ffn(cfg: ModelConfig, ffn: str, params, h: torch.Tensor, split=None):
    """The slot's FFN: (out, aux), aux None for a dense one. ``split``: a
    MoE layer runs :func:`~repro_torch.models.moe.moe_split` on the rank's
    rows and blocks, never ``moe_ffn``, which would take blocks of them
    again."""
    if ffn == 'moe':
        if split is not None:
            return moe_split(params, h, cfg, split)
        return moe_ffn(params, h, cfg)
    return mlp(params, h, cfg, split), None


def _add_aux(total, aux):
    """Sum of the aux losses so far; None while every one was None."""
    return aux if total is None else (total if aux is None else total + aux)


def _used_slot(cfg: ModelConfig, split, sp: dict, specs: dict) -> dict:
    """A slot's parameter blocks as a split model's layer reads them
    (``Split.use``): the norms' scales whole, the mixer's, the
    cross-attention's and the FFN's blocks entering the rank's heads and
    columns. Under the padded head layout the q/k/v biases are added to
    the whole heads after the row-parallel ``psum``, outside the rank's
    heads, so they do not vary over 'model'; a MoE layer's router routes
    the whole residual alike on every 'model' rank, so it does not vary
    over 'model' either (its gates meet the rank's d_ff slice inside
    :func:`~repro_torch.models.moe.moe_split`)."""
    padded = split.heads(cfg).padded
    out = {}
    for k, v in sp.items():
        if padded and k in ('mixer', 'cross'):
            out[k] = {n: split.use(w, specs[k][n], n not in ('bq', 'bk',
                                                              'bv'))
                      for n, w in v.items()}
        elif k == 'ffn' and 'router' in v:
            experts = {n: w for n, w in v.items() if n != 'router'}
            out[k] = {'router': split.use(v['router'], specs[k]['router'],
                                          False),
                      **split.use_tree(experts, specs[k], True)}
        else:
            out[k] = split.use_tree(v, specs[k],
                                    k in ('mixer', 'cross', 'ffn'))
    return out


def _apply_slot(cfg: ModelConfig, sp: dict, x: torch.Tensor, rope,
                mixer: str, ffn: str, causal: bool,
                enc_out: torch.Tensor | None, split=None, specs=None):
    """One pre-norm residual layer: the mixer, cross-attention to
    ``enc_out`` where given, then the FFN. Returns (x, aux), aux None for
    a dense FFN. An RWKV slot starts from a zero state and drops the state
    it ends in, as in the reference; its norms are plain. ``split``: the
    slot's blocks (spec tree ``specs``) are read here, so that under remat
    the recompute gathers them again."""
    if split is not None:
        sp = _used_slot(cfg, split, sp, specs)
    if mixer == 'rwkv':
        B = x.shape[0]
        zeros_prev = torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        wkv = rwkv_lib.init_rwkv_state(cfg, B, x.device)['wkv']
        h, _, _ = rwkv_lib.rwkv_time_mix(
            sp['mixer'], rmsnorm(sp['ln1'], x, cfg.norm_eps), zeros_prev,
            wkv, cfg)
        x = x + h
        h, _ = rwkv_lib.rwkv_channel_mix(
            sp['mixer'], rmsnorm(sp['ln2'], x, cfg.norm_eps), zeros_prev,
            cfg)
        return x + h, None
    h = rmsnorm(sp['ln1'], x, cfg.norm_eps, cfg.use_pallas)
    if mixer == 'attn':
        h = attn.multihead_attention(sp['mixer'], h, cfg, rope=rope,
                                     causal=causal, split=split)
    else:
        h = ssm_lib.mamba_scan(sp['mixer'], h, cfg)
    x = x + h
    if enc_out is not None:
        h = rmsnorm(sp['ln_cross'], x, cfg.norm_eps)
        x = x + attn.cross_attention(
            sp['cross'], h,
            *attn.cross_attention_cache(sp['cross'], enc_out, cfg, split),
            cfg, split)
    h = rmsnorm(sp['ln2'], x, cfg.norm_eps, cfg.use_pallas)
    h, aux = _ffn(cfg, ffn, sp['ffn'], h, split)
    return x + h, aux


def _apply_block(cfg: ModelConfig, block: dict, x: torch.Tensor, rope,
                 kinds, causal: bool, enc_out: torch.Tensor | None,
                 split=None, specs=None):
    """The block's slots in order: (x, the sum of their aux or None)."""
    aux = None
    for i, (mixer, ffn) in enumerate(kinds):
        x, a = _apply_slot(cfg, block[f'slot{i}'], x, rope, mixer, ffn,
                           causal, enc_out, split,
                           None if specs is None else specs[f'slot{i}'])
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
    transforms (:func:`~repro_torch.models.layers.records_graph`)."""
    return cfg.remat != 'none' and cfg.scan_layers and records_graph()


def _run_blocks(cfg: ModelConfig, blocks: list, x: torch.Tensor, rope,
                kinds, causal: bool, enc_out: torch.Tensor | None = None,
                split=None, specs: list | None = None):
    """Every block in order, under remat where :func:`_remat_active`.
    ``specs``: the blocks' spec trees under ``split``. Returns (x, the
    aux summed over layers, 0 without experts)."""
    remat = _remat_active(cfg)
    aux = None
    for b, block in enumerate(blocks):
        args = (cfg, block, x, rope, kinds, causal, enc_out, split,
                None if split is None else specs[b])
        if not remat:
            x, a = _apply_block(*args)
        elif cfg.remat == 'dots':
            x, a = checkpoint(_apply_block, *args, use_reentrant=False,
                              context_fn=lambda: (
                                  create_selective_checkpoint_contexts(
                                      _save_dots)))
        else:
            x, a = checkpoint(_apply_block, *args, use_reentrant=False)
        aux = _add_aux(aux, a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _inputs(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            device: torch.device, split=None) -> torch.Tensor:
    """The decoder's input stream on ``device``: token ids through
    ``embed`` (an encoder-decoder's decoder reads text tokens whatever its
    frontend), or (B, S, d) embeddings cast to the compute dtype."""
    if not (cfg.is_encdec or cfg.embed_inputs):
        return inputs.to(device=device, dtype=cdtype(cfg))
    if split is not None:
        table = split.use_tree(params['embed'], split.specs['embed'], True)
        return embed(table, inputs.to(device), cfg, split)
    return embed(params['embed'], inputs.to(device), cfg)


def forward(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
            positions: torch.Tensor | None = None,
            enc_inputs: torch.Tensor | None = None, split=None):
    """inputs: (B, S) int tokens, or (B, S, d) embeddings where
    ``cfg.embed_inputs`` is off (an encoder-decoder's decoder takes tokens
    either way). ``positions``: (B, S), or (B, 3, S) (t, h, w) ids under
    M-RoPE; default 0..S−1 (on all three components under M-RoPE).
    ``enc_inputs``: the encoder's (B, T, d) frames, which an
    encoder-decoder needs. Returns (logits (B, S, V_padded), aux); aux is
    the reference's MoE router loss summed over layers, 0 without
    experts.

    ``split`` (a :class:`~repro_torch.models.split.Split`): ``params``
    are this rank's blocks and ``inputs`` (with ``positions`` and
    ``enc_inputs``) its rows of the batch; the logits are this rank's
    (B_local, S, V_padded / model) block of the vocab."""
    x = _inputs(cfg, params, inputs, params['final_norm']['scale'].device,
                split)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        if cfg.mrope:
            positions = positions[:, None, :].expand(B, 3, S)
    rope = rope_for(cfg, positions.to(x.device))
    enc_out = None
    if cfg.is_encdec:
        if enc_inputs is None:
            raise ValueError(f'{cfg.name}: an encoder-decoder needs '
                             'enc_inputs')
        enc_out = encode(cfg, params, enc_inputs, split)
    x, aux = _run_blocks(cfg, params['blocks'], x, rope, cfg.layer_kinds(),
                         causal=True, enc_out=enc_out, split=split,
                         specs=None if split is None
                         else split.specs['blocks'])
    name = 'embed' if cfg.tie_embeddings else 'unembed'
    if split is None:
        x = rmsnorm(params['final_norm'], x, cfg.norm_eps)
        return unembed(params[name], x, cfg), aux
    norm = split.use_tree(params['final_norm'], split.specs['final_norm'],
                          False)
    table = split.use_tree(params[name], split.specs[name], True)
    x = rmsnorm(norm, x, cfg.norm_eps)
    return unembed(table, x, cfg, split), aux


def encode(cfg: ModelConfig, params: dict, enc_inputs: torch.Tensor,
           split=None) -> torch.Tensor:
    """The encoder stack over precomputed frame or patch embeddings
    (B, T, d): period-1 dense attention blocks, non-causal, RoPE at
    0..T−1, then ``enc_final_norm``. Returns (B, T, d) in the compute
    dtype. ``split``: this rank's blocks and rows, the whole d and T."""
    dev = params['enc_final_norm']['scale'].device
    x = enc_inputs.to(device=dev, dtype=cdtype(cfg))
    B, T = x.shape[0], x.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, _ = _run_blocks(cfg, params['enc_blocks'], x, rope, _ENC_KINDS,
                       causal=False, split=split,
                       specs=None if split is None
                       else split.specs['enc_blocks'])
    norm = params['enc_final_norm']
    if split is not None:
        norm = split.use_tree(norm, split.specs['enc_final_norm'], False)
    return rmsnorm(norm, x, cfg.norm_eps)


# ------------------------------------------------------------------- losses
def train_loss(cfg: ModelConfig, params: dict, batch: dict,
               example_weights: torch.Tensor | None = None,
               split=None) -> torch.Tensor:
    """Next-token CE, the bilevel inner objective f.

    ``batch``: ``inputs`` ((B, S) ints, or (B, S, d) embeddings where
    ``cfg.embed_inputs`` is off and there is no encoder), ``labels`` (B, S)
    ints, optional ``mask`` (B, S), ``positions`` ((B, 3, S) under M-RoPE)
    and an encoder-decoder's ``enc_inputs`` (B, T, d): the layout of
    ``launch.steps.make_batch_sds``. ``example_weights``: optional (B,) loss
    weights per example, where the outer parameters of data reweighting
    (§5.4) enter. The reference's formula, op for op: the logits stay in
    the compute dtype, the log-sum-exp and the label's logit (a masked max,
    as the reference picks it) are reduced in f32, and the loss is
    Σ tok·w / max(Σ w, 1e-6) plus ``forward``'s aux (the MoE router's
    load-balance loss, 0 without experts).

    ``split``: ``params`` are this rank's blocks and ``batch`` (with
    ``example_weights``) its rows; the token CE runs over the split vocab
    (:func:`~repro_torch.models.layers.split_token_loss`) and the masked
    mean is ``psum(Σ tok·w) / max(psum(Σ w), 1e-6)`` over the batch
    axes, the whole batch's mean on every rank."""
    logits, aux = forward(cfg, params, batch['inputs'],
                          positions=batch.get('positions'),
                          enc_inputs=batch.get('enc_inputs'), split=split)
    labels = batch['labels'].to(logits.device)
    mask = batch.get('mask')
    if split is not None:
        tok_loss = split_token_loss(logits, labels, split)
        mask = (torch.ones_like(tok_loss) if mask is None
                else mask.to(tok_loss.device))
        if example_weights is not None:
            mask = mask * example_weights[:, None]
        total = split.batch_sum((tok_loss * mask).sum())
        return total / torch.clamp(split.batch_sum(mask.sum()), min=1e-6) \
            + aux
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
               dtype: torch.dtype | None = None, device=None,
               split=None) -> dict:
    """The zeroed decode cache on ``device`` (the card unless the caller
    passes ``device='cpu'``) in the reference's layout: ``{'pos': 0-d
    int32, 'slots': {'slot{i}': ...}}`` with attention's k, v (n_blocks,
    B, max_len, KV, hd) in ``dtype`` (default the compute dtype), Mamba's
    and RWKV's states in f32, and for an encoder-decoder ``'cross'``'s k,
    v (n_blocks, B, cross_len, KV, hd) in ``dtype``.

    ``split`` (a :class:`~repro_torch.models.split.Split` for ``batch``
    rows): this rank's block of each leaf of that whole cache, under
    :func:`~repro_torch.models.split.cache_split_specs` (the sequence
    over 'model', the batch over the batch axes where they divide it)."""
    if split is not None:
        from repro_torch.distributed.sharding import local_shape
        from repro_torch.models.split import cache_split_specs
        specs = cache_split_specs(cfg, split.mesh, batch, max_len)
        whole = init_cache(cfg, batch, max_len, dtype, 'meta')
        dev = resolve_device(device)

        def local(x, s):
            if isinstance(x, dict):
                return {k: local(x[k], s[k]) for k in x}
            return torch.zeros(local_shape(tuple(x.shape), s, split.mesh),
                               dtype=x.dtype, device=dev)

        return local(whole, specs)
    dev = resolve_device(device)
    dtype = dtype or cdtype(cfg)
    nb = cfg.n_blocks

    def stacked(state: dict) -> dict:
        return {name: torch.zeros((nb,) + tuple(x.shape), dtype=x.dtype,
                                  device=dev) for name, x in state.items()}

    slots = {}
    for i, (mixer, _) in enumerate(cfg.layer_kinds()):
        if mixer == 'attn':
            kv = attn.init_kv_cache(cfg, nb, batch, max_len, dtype, dev)
            slots[f'slot{i}'] = {'k': kv['k'], 'v': kv['v']}
        elif mixer == 'mamba':
            slots[f'slot{i}'] = stacked(
                ssm_lib.init_mamba_state(cfg, batch, 'meta'))
        else:
            slots[f'slot{i}'] = stacked(
                rwkv_lib.init_rwkv_state(cfg, batch, 'meta'))
    cache = {'pos': torch.zeros((), dtype=torch.int32, device=dev),
             'slots': slots}
    if cfg.is_encdec:
        shape = (nb, batch, cfg.cross_len, cfg.n_kv_heads, cfg.head_dim)
        cache['cross'] = {'k': torch.zeros(shape, dtype=dtype, device=dev),
                          'v': torch.zeros(shape, dtype=dtype, device=dev)}
    return cache


def fill_cross_cache(cfg: ModelConfig, params: dict, cache: dict,
                     enc_out: torch.Tensor, split=None) -> dict:
    """Every decoder block's cross-attention K and V of ``enc_out``
    (B, T, d), written into ``cache['cross']`` in place (a new pair where
    (B, T) differ from the cache's), in the cache's dtype: the reference's
    ``scan_layers`` branch, which gives each block its own. Returns the
    cache.

    ``split``: ``params`` are this rank's blocks, ``enc_out`` its rows
    (whole T, as :func:`encode` gives them) and ``cache`` its blocks; the
    rank fills its block of T, every KV head
    (:func:`~repro_torch.models.attention.cross_cache_block`)."""
    k_all, v_all = cache['cross']['k'], cache['cross']['v']
    B, T = enc_out.shape[0], enc_out.shape[1]
    if split is not None:
        if T % split.model:
            raise NotImplementedError(
                f'{T} encoder states over model {split.model}: the cross '
                'cache\'s sequence needs \'model\' to divide it')
        T //= split.model
    if tuple(k_all.shape[1:3]) != (B, T):
        shape = (cfg.n_blocks, B, T) + tuple(k_all.shape[3:])
        k_all = torch.empty(shape, dtype=k_all.dtype, device=k_all.device)
        v_all = torch.empty(shape, dtype=v_all.dtype, device=v_all.device)
    for b, block in enumerate(params['blocks']):
        if split is None:
            k, v = attn.cross_attention_cache(block['slot0']['cross'],
                                              enc_out, cfg)
        else:
            k, v = attn.cross_cache_block(
                block['slot0']['cross'],
                split.specs['blocks'][b]['slot0']['cross'], enc_out, cfg,
                split)
        k_all[b].copy_(k)
        v_all[b].copy_(v)
    return dict(cache, cross={'k': k_all, 'v': v_all})


def _decode_recurrent(cfg: ModelConfig, sp: dict, sc: dict, b: int,
                      mixer: str, x: torch.Tensor, h: torch.Tensor):
    """A Mamba or RWKV slot's decode step on block ``b``'s state, written
    back in place. Returns x after the mixer (and, for RWKV, its channel
    mix)."""
    if mixer == 'mamba':
        h, st = ssm_lib.mamba_decode(
            sp['mixer'], h, {'conv': sc['conv'][b], 'ssm': sc['ssm'][b]},
            cfg)
        sc['conv'][b].copy_(st['conv'])
        sc['ssm'][b].copy_(st['ssm'])
        return x + h
    h, tm_prev, wkv = rwkv_lib.rwkv_time_mix(
        sp['mixer'], h, sc['tm_prev'][b].to(h.dtype), sc['wkv'][b], cfg)
    x = x + h
    h = rmsnorm(sp['ln2'], x, cfg.norm_eps)
    h, cm_prev = rwkv_lib.rwkv_channel_mix(
        sp['mixer'], h, sc['cm_prev'][b].to(h.dtype), cfg)
    sc['tm_prev'][b].copy_(tm_prev)
    sc['cm_prev'][b].copy_(cm_prev)
    sc['wkv'][b].copy_(wkv)
    return x + h


def decode_step(cfg: ModelConfig, params: dict, inputs: torch.Tensor,
                cache: dict, split=None):
    """One token for every sequence. inputs: (B, 1) int tokens, or (B, 1,
    d) embeddings where ``cfg.embed_inputs`` is off and there is no
    encoder. Returns (logits (B, 1, V_padded), cache) with ``pos + 1``.

    The input cache is consumed, as the reference donates it: its
    attention k, v and recurrent states are written in place and come back
    in the returned cache, and ``pos`` stays on the device. Every norm is
    plain, as in the reference's decode; a MoE layer reads its group sizes
    on the host (on one rank; split, it runs the ``capacity`` path). An
    encoder-decoder attends to ``cache['cross']`` (see
    :func:`fill_cross_cache`) and unembeds through ``embed``, as the
    reference's decode does (its ``forward`` uses ``unembed``).

    ``split``: ``params`` are this rank's blocks, ``inputs`` its rows and
    ``cache`` its blocks (:func:`init_cache`'s ``split=``): every
    attention, self and cross, runs flash-decoding over the rank's block
    of the cache's sequence
    (:func:`~repro_torch.models.attention.decode_attention`); the logits
    are this rank's (B_local, 1, V_padded / model) block."""
    pos = cache['pos']
    x = _inputs(cfg, params, inputs, pos.device, split)
    rope = attn.decode_rope(cfg, pos, x.shape[0])
    cross = cache.get('cross')
    for b, block in enumerate(params['blocks']):
        for i, (mixer, ffn) in enumerate(cfg.layer_kinds()):
            sp, sc = block[f'slot{i}'], cache['slots'][f'slot{i}']
            if split is not None:
                sp = _used_slot(cfg, split, sp,
                                split.specs['blocks'][b][f'slot{i}'])
            h = rmsnorm(sp['ln1'], x, cfg.norm_eps)
            if mixer == 'attn':
                h, _, _ = attn.decode_attention(sp['mixer'], h, sc['k'][b],
                                                sc['v'][b], pos, cfg,
                                                rope=rope, split=split)
                x = x + h
            else:
                x = _decode_recurrent(cfg, sp, sc, b, mixer, x, h)
                if mixer == 'rwkv':       # its channel mix is its FFN
                    continue
            if cross is not None:
                h = rmsnorm(sp['ln_cross'], x, cfg.norm_eps)
                x = x + attn.cross_attention(sp['cross'], h, cross['k'][b],
                                             cross['v'][b], cfg, split,
                                             decode=True)
            h = rmsnorm(sp['ln2'], x, cfg.norm_eps)
            x = x + _ffn(cfg, ffn, sp['ffn'], h, split)[0]
    name = 'embed' if (cfg.tie_embeddings or cfg.is_encdec) else 'unembed'
    norm, table = params['final_norm'], params[name]
    if split is not None:
        norm = split.use_tree(norm, split.specs['final_norm'], False)
        table = split.use_tree(table, split.specs[name], True)
    x = rmsnorm(norm, x, cfg.norm_eps)
    return unembed(table, x, cfg, split), dict(cache, pos=pos + 1)
