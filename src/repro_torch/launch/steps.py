"""The step functions of the port, on one card, without a mesh or sharding
specs: the port of ``repro/launch/steps.py``.

  train_step(params, opt_state, step, batch)
      → params, opt_state, step + 1, {'loss', 'grad_norm'}
  prefill_step(params, batch) → logits of the last position (B, V_padded)
  serve_step(params, inputs, cache) → logits (B, 1, V_padded), cache
  hypergrad_step(params, hparams, inner_batch, outer_batch, rng)
      → hparams after one Nyström hypergradient step (§5.4 at LM scale)

``serve_params`` casts the floating parameters to bf16, as the reference's
serving load does (``_param_sds(serve=True)``). Batches are dicts of
tensors in the layout :func:`make_batch_sds` gives; a step moves them to
its parameters' device. ``build_step`` picks one of the four by kind.
All ten architectures serve and train; the recurrent ones (Jamba's Mamba,
RWKV-6) take their HVP columns through the Python time loops.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import NystromIHVP, implicit_root
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, forward, train_loss
from repro_torch.optim import (adafactor, adamw, chain, clip_by_global_norm,
                               stacked_blocks)

N_DOMAINS = 64          # outer-parameter dimension for LM data reweighting


def make_optimizer(cfg: ModelConfig):
    """Adafactor above 100B parameters (its factored state is what fits),
    AdamW below. Adafactor runs on the reference's stacked layout of the
    blocks (``stacked_blocks``) where ``cfg.scan_layers`` stacks them, so
    that its per-leaf factoring and clipping give the reference's
    numbers."""
    if cfg.param_count() > 100e9:
        base = adafactor(1e-2)
        return chain(clip_by_global_norm(1.0),
                     stacked_blocks(base) if cfg.scan_layers else base)
    return chain(clip_by_global_norm(1.0), adamw(3e-4, weight_decay=0.1))


def to_device(batch: dict, device) -> dict:
    """A host batch's tensors on ``device``."""
    return {key: x.to(device, non_blocking=True) for key, x in batch.items()}


def make_batch_sds(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """A training batch's fields as ``meta`` tensors (shape and dtype, no
    storage), the reference's ``make_batch_sds`` layout: ``labels`` (B, S)
    int32 and ``mask`` (B, S) f32; ``inputs`` (B, S) int32 tokens, or
    (B, S, d) bf16 embeddings where ``cfg.embed_inputs`` is off, with
    ``positions`` (B, 3, S) int32 under M-RoPE; an encoder-decoder's token
    ``inputs`` and its (B, S, d) bf16 ``enc_inputs``. The hypergradient
    step's batches add a (B,) int32 ``domain``, as the reference's
    ``build_hypergrad_step`` does."""
    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device='meta')

    b = {'labels': sds((batch, seq), torch.int32),
         'mask': sds((batch, seq), torch.float32)}
    if cfg.is_encdec:
        b['inputs'] = sds((batch, seq), torch.int32)
        b['enc_inputs'] = sds((batch, seq, cfg.d_model), torch.bfloat16)
    elif not cfg.embed_inputs:
        b['inputs'] = sds((batch, seq, cfg.d_model), torch.bfloat16)
        if cfg.mrope:
            b['positions'] = sds((batch, 3, seq), torch.int32)
    else:
        b['inputs'] = sds((batch, seq), torch.int32)
    return b


def loss_and_grads(loss_fn: Callable, params, *args):
    """(loss, ∇loss) by one plain autograd pass, so that the model's remat
    (``torch.utils.checkpoint``) applies."""
    leaves, treedef = tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss = loss_fn(treedef.unflatten(live), *args)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), treedef.unflatten(list(grads))


def build_train_step(cfg: ModelConfig, optimizer=None,
                     microbatches: int | None = None) -> Callable:
    """``train_step(params, opt_state, step, batch)``: the masked token CE's
    gradient (plus a MoE model's router aux), then ``optimizer`` (default
    :func:`make_optimizer`). ``batch`` holds :func:`make_batch_sds`'s
    fields.

    ``microbatches`` > 1 splits the batch along its first axis and sums the
    microbatches' gradients in f32 from zeros before dividing, as the
    reference's scan does; the loss is their mean. Default: 4 for the
    scanned production path above 300B parameters, else 1."""
    optimizer = optimizer or make_optimizer(cfg)
    if microbatches is None:
        microbatches = 4 if (cfg.param_count() > 3e11
                             and cfg.scan_layers) else 1

    def loss_fn(params, batch):
        return train_loss(cfg, params, batch)

    def train_step(params, opt_state, step, batch):
        device = tree_leaves(params)[0].device
        batch = to_device(batch, device)
        if microbatches > 1:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            losses = []
            size = next(iter(batch.values())).shape[0] // microbatches
            for i in range(microbatches):
                mb = {key: x[i * size:(i + 1) * size]
                      for key, x in batch.items()}
                loss_i, grads = loss_and_grads(loss_fn, params, mb)
                gsum = tree_map(torch.add, gsum, grads)
                losses.append(loss_i)
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = loss_and_grads(loss_fn, params, batch)
        params, opt_state = optimizer.apply(grads, opt_state, params, step)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        return params, opt_state, step + 1, {'loss': loss, 'grad_norm': gnorm}

    return train_step


def domain_losses(cfg: ModelConfig):
    """(inner_loss, outer_loss) of §5.4's data reweighting: the inner loss
    weights each example by N_DOMAINS · softmax(domain_logits)[domain], the
    outer loss is the plain token CE on a clean batch."""
    def inner_loss(params, hparams, batch):
        w = torch.softmax(hparams['domain_logits'], dim=-1) * N_DOMAINS
        return train_loss(cfg, params, batch,
                          example_weights=w[batch['domain']])

    def outer_loss(params, hparams, batch):
        del hparams
        return train_loss(cfg, params, batch)

    return inner_loss, outer_loss


def lm_hypergrad(solver, inner_loss: Callable, outer_loss: Callable, params,
                 hparams: dict, inner_batch: dict, outer_batch: dict, *,
                 state=None, rng=None, indices: dict | None = None):
    """(outer value, hypergradient) at ``params`` as the implicit solution:
    the gradient of ``outer_loss(θ*(φ), φ, outer_batch)`` through
    ``implicit_root``, whose backward solves against ``state`` (a prepared
    sketch) or prepares one at (params, φ, inner_batch) from ``rng`` or the
    injected ``indices``."""
    solution = implicit_root(lambda phi, b: params, inner_loss, solver)

    def outer_obj(phi):
        theta = solution(phi, inner_batch, rng=rng, state=state,
                         indices=indices)
        return outer_loss(theta, phi, outer_batch)

    return loss_and_grads(outer_obj, hparams)


def build_hypergrad_step(cfg: ModelConfig, k: int = 8,
                         rho: float = 1e-2) -> Callable:
    """``hypergrad_step(params, hparams, inner_batch, outer_batch, rng=None,
    indices=None)``: the Nyström-IHVP hypergradient of the clean batch's
    loss with respect to the per-domain loss weights, at the trained
    ``params`` as the implicit solution (``NystromIHVP(k, rho,
    column_chunk=2)``), then ``h − 1e-2·g``. ``rng`` (a CPU
    ``torch.Generator``) draws the sketch's columns, or ``indices=``
    injects a draw."""
    solver = NystromIHVP(k=k, rho=rho, column_chunk=2)
    inner_loss, outer_loss = domain_losses(cfg)

    def hypergrad_step(params, hparams, inner_batch, outer_batch, rng=None,
                       indices=None):
        device = tree_leaves(params)[0].device
        _, hg = lm_hypergrad(solver, inner_loss, outer_loss, params, hparams,
                             to_device(inner_batch, device),
                             to_device(outer_batch, device), rng=rng,
                             indices=indices)
        return tree_map(lambda h, g: h - 1e-2 * g, hparams, hg)

    return hypergrad_step


def serve_params(params):
    """Floating leaves → bf16; other leaves unchanged."""
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.is_floating_point() else x, params)


def build_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """``prefill_step(params, batch)``: ``forward`` over ``batch['inputs']``
    ((B, S) tokens, or (B, S, d) embeddings where ``cfg.embed_inputs`` is
    off), with ``batch['positions']`` and an encoder-decoder's
    ``batch['enc_inputs']`` where given, moved to the step's device (the
    card unless ``device='cpu'``), under ``torch.inference_mode()``;
    returns the next-token logits ``logits[:, -1, :]`` as a tensor of its
    own."""
    device = resolve_device(device)

    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            batch = to_device(batch, device)
            logits, _ = forward(cfg, params, batch['inputs'],
                                positions=batch.get('positions'),
                                enc_inputs=batch.get('enc_inputs'))
            return logits[:, -1, :].clone()

    return prefill_step


def build_serve_step(cfg: ModelConfig, device=None) -> Callable:
    """``serve_step(params, inputs, cache)``: one :func:`decode_step` of
    (B, 1) tokens, or (B, 1, d) embeddings where ``cfg.embed_inputs`` is
    off and there is no encoder, moved to the step's device (the card
    unless ``device='cpu'``), under ``torch.inference_mode()``; returns
    (logits (B, 1, V_padded), cache). The cache comes from ``init_cache``
    (an encoder-decoder's filled by ``fill_cross_cache``) and is consumed:
    its k, v and recurrent states are written in place."""
    device = resolve_device(device)

    def serve_step(params: dict, inputs: torch.Tensor, cache: dict):
        with torch.inference_mode():
            return decode_step(cfg, params, inputs.to(device), cache)

    return serve_step


def build_step(cfg: ModelConfig, kind: str, **kwargs) -> Callable:
    """The step of ``kind``: ``'train'`` (:func:`build_train_step`),
    ``'prefill'`` (:func:`build_prefill_step`), ``'decode'``
    (:func:`build_serve_step`) or ``'hypergrad'``
    (:func:`build_hypergrad_step`), with ``kwargs`` passed on."""
    builders = {'train': build_train_step, 'prefill': build_prefill_step,
                'decode': build_serve_step,
                'hypergrad': build_hypergrad_step}
    if kind not in builders:
        raise ValueError(f'unknown step kind {kind!r}')
    return builders[kind](cfg, **kwargs)
