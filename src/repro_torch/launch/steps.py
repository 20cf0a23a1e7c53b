"""The step functions of the port, on one card or over a model split on a
mesh: the port of ``repro/launch/steps.py``.

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

``mesh=`` (a :class:`~repro_torch.launch.mesh.Mesh`) builds every step
over a model split on it, as the
reference's builders take ``param_specs(cfg, mesh)`` for their input
shardings: ``params`` (and the optimizer state) are this rank's blocks
(:func:`repro_torch.models.split.shard_params`), batches are whole and
each rank takes its rows (over ('pod', 'data') where they divide the
batch, else all), and what a step returns is whole on every rank (the
loss, the norm, the last position's logits, the hyperparameters) or this
rank's blocks (parameters, optimizer state, the decode cache). The
attention families split (dense GQA, Qwen2's heads zero-padded where
'model' does not divide them, M-RoPE with embedding inputs, the
encoder-decoder), with dense or MoE FFNs (the experts' d_ff over 'model',
the ``capacity`` path on each rank's tokens), and serve over the KV
cache's sequence split over 'model'; Mamba and RWKV-6 raise
(:func:`~repro_torch.models.split.check_splittable`), and so does the
training of a model above 100B parameters (Llama-4 Maverick), whose
optimizer is Adafactor. With ``mesh=None``
each builder is the one-card step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core import NystromIHVP, implicit_root
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.distributed.ctx import split_vdot
from repro_torch.models.config import ModelConfig
from repro_torch.models.split import Split, make_split, split_specs
from repro_torch.models.transformer import decode_step, forward, train_loss
from repro_torch.optim import (adafactor, adamw, chain, clip_by_global_norm,
                               stacked_blocks)

N_DOMAINS = 64          # outer-parameter dimension for LM data reweighting


def make_optimizer(cfg: ModelConfig, split: Split | None = None):
    """Adafactor above 100B parameters (its factored state is what fits),
    AdamW below. Adafactor runs on the reference's stacked layout of the
    blocks (``stacked_blocks``) where ``cfg.scan_layers`` stacks them, so
    that its per-leaf factoring and clipping give the reference's
    numbers. ``split``: AdamW on a split model's blocks (elementwise),
    clipped by the whole gradient's norm; Adafactor's factored statistics
    need whole rows and columns, and are refused there."""
    if split is not None:
        if cfg.param_count() > 100e9:
            raise NotImplementedError(
                f'{cfg.name}: above 100B parameters the optimizer is '
                'Adafactor, whose factored statistics need whole rows and '
                'columns; Adafactor on a split model\'s blocks is ROADMAP '
                'item 12, not ported')
        return chain(clip_by_global_norm(1.0, _sq_norm(split)),
                     adamw(3e-4, weight_decay=0.1))
    if cfg.param_count() > 100e9:
        base = adafactor(1e-2)
        return chain(clip_by_global_norm(1.0),
                     stacked_blocks(base) if cfg.scan_layers else base)
    return chain(clip_by_global_norm(1.0), adamw(3e-4, weight_decay=0.1))


def _sq_norm(split: Split) -> Callable:
    """grads (a split model's blocks) → the squared whole norm: each
    leaf's local squares summed over the axes its spec splits it on, every
    distinct block counted once."""
    return lambda grads: split_vdot(grads, grads, split.specs, split.mesh)


def _splits(cfg: ModelConfig, mesh) -> Callable[[int], Split]:
    """``rows → Split`` of ``cfg`` on ``mesh`` for a batch of that many
    rows, the spec tree worked out once."""
    return functools.partial(make_split, cfg, mesh,
                             specs=split_specs(cfg, mesh))


def local_batch(batch: dict, split: Split, device) -> dict:
    """This rank's rows of a whole batch, on ``device``."""
    return {key: split.batch_block(x).to(device, non_blocking=True)
            for key, x in batch.items()}


def _rows(splits, batch: dict, device) -> tuple[dict, Split | None]:
    """(this rank's rows of a whole batch on ``device``, their
    :class:`Split`); without a mesh (``splits`` None) the whole batch and
    None."""
    if splits is None:
        return to_device(batch, device), None
    split = splits(next(iter(batch.values())).shape[0])
    return local_batch(batch, split, device), split


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
                     microbatches: int | None = None,
                     mesh=None) -> Callable:
    """``train_step(params, opt_state, step, batch)``: the masked token CE's
    gradient (plus a MoE model's router aux), then ``optimizer`` (default
    :func:`make_optimizer`). ``batch`` holds :func:`make_batch_sds`'s
    fields.

    ``microbatches`` > 1 splits the batch along its first axis and sums the
    microbatches' gradients in f32 from zeros before dividing, as the
    reference's scan does; the loss is their mean. Default: 4 for the
    scanned production path above 300B parameters, else 1.

    ``mesh``: over a model split on it (module doc): ``params`` and
    ``opt_state`` are this rank's blocks, each microbatch's rows are split
    over the batch axes, the loss is the whole batch's masked mean and
    ``grad_norm`` the whole gradient's norm, on every rank."""
    splits = None if mesh is None else _splits(cfg, mesh)
    if optimizer is None:
        optimizer = make_optimizer(cfg, None if mesh is None else splits(1))
    elif mesh is not None:
        raise ValueError('optimizer= with mesh=: a caller\'s optimizer would '
                         'clip by each rank\'s own norm; over a split model '
                         'the step uses make_optimizer(cfg, split)')
    if microbatches is None:
        microbatches = 4 if (cfg.param_count() > 3e11
                             and cfg.scan_layers) else 1

    def grads_of(params, batch, device):
        """(loss, grads) of a whole (micro)batch."""
        rows, split = _rows(splits, batch, device)
        return loss_and_grads(
            lambda p, b: train_loss(cfg, p, b, split=split), params, rows)

    def train_step(params, opt_state, step, batch):
        device = tree_leaves(params)[0].device
        if microbatches > 1:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            losses = []
            size = next(iter(batch.values())).shape[0] // microbatches
            for i in range(microbatches):
                mb = {key: x[i * size:(i + 1) * size]
                      for key, x in batch.items()}
                loss_i, grads = grads_of(params, mb, device)
                gsum = tree_map(torch.add, gsum, grads)
                losses.append(loss_i)
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = grads_of(params, batch, device)
        params, opt_state = optimizer.apply(grads, opt_state, params, step)
        if splits is None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)))
        else:
            gnorm = torch.sqrt(_sq_norm(splits(1))(grads))
        return params, opt_state, step + 1, {'loss': loss, 'grad_norm': gnorm}

    return train_step


def domain_losses(cfg: ModelConfig, split: Split | None = None):
    """(inner_loss, outer_loss) of §5.4's data reweighting: the inner loss
    weights each example by N_DOMAINS · softmax(domain_logits)[domain], the
    outer loss is the plain token CE on a clean batch. ``split``: over a
    split model, on this rank's rows; the weights (whole on every rank)
    enter the rows' work through a ``pvary`` over the batch axes, so that
    their cotangent is summed over the batch's shards once."""
    from repro_torch.distributed import ctx

    def inner_loss(params, hparams, batch):
        w = torch.softmax(hparams['domain_logits'], dim=-1) * N_DOMAINS
        if split is not None:
            w = ctx.pvary(w, split.mesh, split.batch_axes)
        return train_loss(cfg, params, batch,
                          example_weights=w[batch['domain']], split=split)

    def outer_loss(params, hparams, batch):
        del hparams
        return train_loss(cfg, params, batch, split=split)

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


def split_solver(mesh, specs, hg_cfg) -> NystromIHVP:
    """``hg_cfg``'s Nyström solver (a :class:`HypergradConfig`) over a
    model split on ``mesh`` (``specs``: its sanitized spec tree):
    ``flat_sharded`` on the rank's blocks (``split=True``: HVP columns,
    vectors and u stay blocks, one all-reduce per k-output pass, kernels
    A–C on a card) in ``hg_cfg``'s ``sketch_dtype``. Another solver, a backend chosen other than
    'flat_sharded' (the field's default 'tree' counts as not chosen), or
    ``mesh``/``param_specs`` set on ``hg_cfg`` raise: the split model
    decides them."""
    from repro_torch.core.backend import FlatShardedBackend
    from repro_torch.core.hypergrad import _DTYPES
    if hg_cfg.solver != 'nystrom':
        raise NotImplementedError(
            f'solver={hg_cfg.solver!r} over a split model: its vector '
            'algebra sums whole trees on one rank; only the Nyström solver '
            '(flat_sharded over the blocks) is ported to the mesh')
    if hg_cfg.backend not in ('tree', 'flat_sharded'):
        raise ValueError(
            f'backend={hg_cfg.backend!r} over a split model: its sketch '
            "and vectors are the rank's blocks, which only 'flat_sharded' "
            'takes')
    if hg_cfg.mesh is not None or hg_cfg.param_specs is not None:
        raise ValueError('mesh/param_specs over a split model are the '
                         "split's own: leave them unset")
    backend = FlatShardedBackend(
        mesh=mesh, specs=specs, split=True,
        sketch_dtype=_DTYPES[hg_cfg.sketch_dtype or 'float32'])
    return dataclasses.replace(hg_cfg, backend=backend,
                               sketch_dtype=None).build()


def build_hypergrad_step(cfg: ModelConfig, k: int = 8, rho: float = 1e-2,
                         mesh=None, hg_cfg=None) -> Callable:
    """``hypergrad_step(params, hparams, inner_batch, outer_batch, rng=None,
    indices=None)``: the Nyström-IHVP hypergradient of the clean batch's
    loss with respect to the per-domain loss weights, at the trained
    ``params`` as the implicit solution, then ``h − 1e-2·g``. The solver
    is ``hg_cfg``'s (a :class:`HypergradConfig`), by default
    ``NystromIHVP(k, rho, column_chunk=2)``; ``k`` and ``rho`` are
    shorthand for that default and must stay at theirs when ``hg_cfg`` is
    given. ``rng`` (a CPU ``torch.Generator``) draws the sketch's columns,
    or ``indices=`` injects a draw.

    ``mesh``: over a model split on it, through ``flat_sharded`` on the
    rank's blocks (:func:`split_solver` of the same ``hg_cfg``): every
    rank draws the same columns over the whole leaves and computes its
    blocks of them, u comes back as blocks, and the hypergradient is whole
    on every rank."""
    from repro_torch.core.hypergrad import HypergradConfig
    if hg_cfg is None:
        hg_cfg = HypergradConfig(k=k, rho=rho, column_chunk=2)
    elif (k, rho) != (8, 1e-2):
        raise ValueError('k and rho are shorthand for the default hg_cfg: '
                         'set them on the hg_cfg given')
    splits = None if mesh is None else _splits(cfg, mesh)
    solver = (hg_cfg.build() if mesh is None
              else split_solver(mesh, splits(1).specs, hg_cfg))

    def hypergrad_step(params, hparams, inner_batch, outer_batch, rng=None,
                       indices=None):
        device = tree_leaves(params)[0].device
        ib, inner_split = _rows(splits, inner_batch, device)
        ob, outer_split = _rows(splits, outer_batch, device)
        _, hg = lm_hypergrad(solver, domain_losses(cfg, inner_split)[0],
                             domain_losses(cfg, outer_split)[1], params,
                             hparams, ib, ob, rng=rng, indices=indices)
        return tree_map(lambda h, g: h - 1e-2 * g, hparams, hg)

    return hypergrad_step


def serve_params(params):
    """Floating leaves → bf16; other leaves unchanged."""
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.is_floating_point() else x, params)


def build_prefill_step(cfg: ModelConfig, device=None, mesh=None) -> Callable:
    """``prefill_step(params, batch)``: ``forward`` over ``batch['inputs']``
    ((B, S) tokens, or (B, S, d) embeddings where ``cfg.embed_inputs`` is
    off), with ``batch['positions']`` and an encoder-decoder's
    ``batch['enc_inputs']`` where given, moved to the step's device (the
    card unless ``device='cpu'``), under ``torch.inference_mode()``;
    returns the next-token logits ``logits[:, -1, :]`` as a tensor of its
    own. ``mesh``: over a model split on it; each rank runs its rows and
    heads, and the last position's logits come back gathered whole
    (B, V_padded) on every rank."""
    device = resolve_device(device)
    splits = None if mesh is None else _splits(cfg, mesh)

    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            batch, split = _rows(splits, batch, device)
            logits, _ = forward(cfg, params, batch['inputs'],
                                positions=batch.get('positions'),
                                enc_inputs=batch.get('enc_inputs'),
                                split=split)
            if split is None:
                return logits[:, -1, :].clone()
            from repro_torch.distributed import ctx
            from repro_torch.distributed.sharding import P
            return ctx.gather(logits[:, -1, :].contiguous(),
                              P(split.batch_axes or None, 'model'), mesh)

    return prefill_step


def build_serve_step(cfg: ModelConfig, device=None, mesh=None) -> Callable:
    """``serve_step(params, inputs, cache)``: one :func:`decode_step` of
    (B, 1) tokens, or (B, 1, d) embeddings where ``cfg.embed_inputs`` is
    off and there is no encoder, moved to the step's device (the card
    unless ``device='cpu'``), under ``torch.inference_mode()``; returns
    (logits (B, 1, V_padded), cache). The cache comes from ``init_cache``
    (an encoder-decoder's filled by ``fill_cross_cache``) and is consumed:
    its k, v and recurrent states are written in place.

    ``mesh``: over a model split on it (module doc): ``params`` are this
    rank's blocks, ``inputs`` the whole batch (each rank takes its rows),
    and ``cache`` this rank's blocks, made by ``init_cache(cfg, B, Smax,
    split=make_split(cfg, mesh, B))`` (the KV and cross caches' sequence
    over 'model'); the logits come back gathered whole on every rank.
    Mamba and RWKV-6 raise (ROADMAP item 12)."""
    device = resolve_device(device)
    splits = None if mesh is None else _splits(cfg, mesh)

    def serve_step(params: dict, inputs: torch.Tensor, cache: dict):
        with torch.inference_mode():
            if splits is None:
                return decode_step(cfg, params, inputs.to(device), cache)
            split = splits(inputs.shape[0])
            logits, cache = decode_step(
                cfg, params, split.batch_block(inputs).to(device), cache,
                split=split)
            from repro_torch.distributed import ctx
            from repro_torch.distributed.sharding import P
            return ctx.gather(logits, P(split.batch_axes or None, None,
                                        'model'), mesh), cache

    return serve_step


def build_step(cfg: ModelConfig, kind: str, **kwargs) -> Callable:
    """The step of ``kind``: ``'train'`` (:func:`build_train_step`),
    ``'prefill'`` (:func:`build_prefill_step`), ``'decode'``
    (:func:`build_serve_step`) or ``'hypergrad'``
    (:func:`build_hypergrad_step`), with ``kwargs`` (``mesh=`` included)
    passed on."""
    builders = {'train': build_train_step, 'prefill': build_prefill_step,
                'decode': build_serve_step,
                'hypergrad': build_hypergrad_step}
    if kind not in builders:
        raise ValueError(f'unknown step kind {kind!r}')
    return builders[kind](cfg, **kwargs)
