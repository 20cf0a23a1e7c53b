"""A model split on a mesh: each rank holds its blocks of every
parameter, as ``distributed.sharding.param_specs(cfg, mesh)`` gives them,
and runs the reference's GSPMD layout by hand (Megatron's tensor
parallelism with ZeRO-3 under ``cfg.fsdp``), with the differentiable
collectives of :mod:`repro_torch.distributed.ctx`:

  * the batch is split over the batch axes ('pod', 'data') where they
    divide it, else replicated (the reference's ``_maybe_batch_spec``);
  * the residual stream is whole (replicated over 'model') on each rank's
    tokens, and RMSNorm runs on the whole d;
  * attention takes this rank's q heads (and KV heads where ``KV % model
    == 0``), ``wo`` is row-parallel and followed by a ``psum``; where
    'model' does not divide the heads (the reference's fallback specs:
    QKV row-parallel on d_model, ``wo`` replicated) the q heads are
    zero-padded per KV group (:func:`head_layout`) and each rank takes
    its share of the padded heads; the FFN's ``w1``/``w3`` are
    column-parallel, ``w2`` row-parallel;
  * ``embed``/``unembed`` hold a block of the padded vocab;
  * under ``cfg.fsdp`` each weight is gathered over 'data' on use
    (:meth:`Split.use`), inside the block's remat;
  * a MoE layer (:func:`~repro_torch.models.moe.moe_split`) runs the
    reference's ``capacity`` path on the rank's tokens: the router whole
    and model-invariant, the experts' and the shared expert's d_ff over
    'model', the output summed over 'model' in f32; no all-to-all and no
    gather of the tokens;
  * decode holds each rank's block of the KV cache's (and the cross
    cache's) sequence, over 'model' (:func:`cache_split_specs`).

A :class:`Split` is what the model functions take (``split=``) to run
split; without one they run whole on one rank. Which family and mesh can
split is explicit (:func:`check_splittable`): the attention families
(dense GQA, M-RoPE with embedding inputs, the encoder-decoder) with a
dense or MoE FFN, whose d_ff (the experts' too) and vocab divide the
'model' axis. Mamba and RWKV-6 raise, naming ROADMAP item 12.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import (P, batch_axes, block_slices,
                                              param_specs, sanitize_spec,
                                              spec_axes, spec_leaves)
from repro_torch.models.config import ModelConfig


def check_splittable(cfg: ModelConfig, mesh) -> None:
    """Raise ``NotImplementedError`` where this family or this mesh has no
    split path: Mamba, RWKV-6, and d_ff (a dense FFN's or the experts') or
    vocab that the 'model' axis does not divide. Heads that it does not
    divide take the padded layout (:func:`head_layout`)."""
    m = mesh.shape.get('model', 1) if 'model' in mesh.axis_names else 1
    why = []
    if any(mx != 'attn' for mx, _ in cfg.layer_kinds()):
        why.append('Mamba or RWKV-6 mixers (d_inner, d_model and their '
                   'caches over \'model\')')
    if cfg.n_heads % m and cfg.d_model % m:
        why.append(f'heads {cfg.n_heads} and d_model {cfg.d_model} that '
                   f'model {m} does not divide (the padded heads\' QKV is '
                   'row-parallel on d_model)')
    if cfg.d_ff % m:
        why.append(f'd_ff {cfg.d_ff} % model {m} != 0')
    if cfg.padded_vocab % m:
        why.append(f'padded vocab {cfg.padded_vocab} % model {m} != 0')
    if why:
        raise NotImplementedError(
            f'{cfg.name} on {dict(mesh.shape)}: a model split on the mesh '
            'covers the attention families with dense or MoE FFNs; '
            + ', '.join(why) + ' is ROADMAP item 12, not ported')


def padded_group(n_heads: int, n_kv: int, model: int) -> int:
    """The smallest GQA group g' >= H/KV such that 'model' divides
    KV·g': the padded layout's group, H/KV itself where 'model' divides
    the heads. Qwen2's 28/4 on 8 and on 16 give 32 heads, Llama-4's 40/8
    on 16 gives 48: the reference's counts."""
    g = n_heads // n_kv
    while (n_kv * g) % model:
        g += 1
    return g


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """This rank's attention heads on the 'model' axis.

    ``padded``: 'model' does not divide the heads, so the specs are the
    reference's fallback (QKV row-parallel on d_model, ``wo`` replicated)
    and the q heads are zero-padded per KV group to ``group`` = g' each,
    ``KV·g'`` in all (:func:`padded_group`): ``g' - H/KV`` zero heads at
    the end of each group. ``q_heads``: for each of the rank's
    ``KV·g'/model`` heads, its head of the model, or None for a pad head.
    ``kv``: the KV head each of them reads; ``kv_run``: those form a
    run that kernel E's GQA rule maps right (local head i reads KV head
    ``kv[0] + i // (n_local / n_kv_local)``), so the run is read as it
    lies, else each q head is given its own copy (a group of 1)."""
    padded: bool
    group: int
    q_heads: tuple
    kv: tuple
    kv_run: bool

    @property
    def n_local(self) -> int:
        return len(self.q_heads)


@functools.lru_cache(maxsize=None)
def head_layout(n_heads: int, n_kv: int, model: int, rank: int
                ) -> HeadLayout:
    """:class:`HeadLayout` of rank ``rank`` (its 'model' coordinate) for
    ``n_heads`` q heads over ``n_kv`` KV heads on ``model`` ranks."""
    g = n_heads // n_kv
    padded = n_heads % model != 0
    gp = padded_group(n_heads, n_kv, model) if padded else g
    n_local = n_kv * gp // model
    h0 = rank * n_local
    pos = [(h0 + i) // gp * g + (h0 + i) % gp for i in range(n_local)]
    q_heads = tuple(p if (h0 + i) % gp < g else None
                    for i, p in enumerate(pos))
    reads = tuple((h0 + i) // gp for i in range(n_local))
    n = reads[-1] + 1 - reads[0]
    run = n_local % n == 0 and all(r - reads[0] == i // (n_local // n)
                                   for i, r in enumerate(reads))
    return HeadLayout(padded, gp, q_heads, reads, run)


def split_specs(cfg: ModelConfig, mesh, template: dict | None = None) -> dict:
    """``param_specs(cfg, mesh)`` sanitized against each leaf's global
    shape (the spec tree the blocks follow), after
    :func:`check_splittable`. ``template``: the whole parameter tree (any
    device, ``meta`` included); default ``abstract_params(cfg)``."""
    from repro_torch.core.tree_util import tree_flatten
    from repro_torch.models.transformer import abstract_params
    check_splittable(cfg, mesh)
    if template is None:
        template = abstract_params(cfg)
    leaves, treedef = tree_flatten(template)
    specs = spec_leaves(param_specs(cfg, mesh))
    if len(specs) != len(leaves):
        raise ValueError(f'{len(specs)} specs for {len(leaves)} leaves')
    return treedef.unflatten([sanitize_spec(tuple(x.shape), s, mesh)
                              for x, s in zip(leaves, specs)])


def shard_params(params, specs, mesh):
    """This rank's block of every leaf of the whole tree ``params`` under
    the spec tree ``specs`` (:func:`split_specs`), each in storage of its
    own."""
    from repro_torch.core.tree_util import tree_flatten
    from repro_torch.distributed.sharding import NamedSharding, shard
    leaves, treedef = tree_flatten(params)
    return treedef.unflatten([shard(x, NamedSharding(mesh, s))
                              for x, s in zip(leaves, spec_leaves(specs))])


def state_spec_leaves(state, params, specs) -> list:
    """One spec a leaf of an optimizer state built from ``params`` (in the
    state's leaf order): a subtree shaped as ``params`` (Adam's moments)
    takes their specs leaf by leaf, anything else (a step count)
    replicates. Matched by structure, not by shape: two leaves of one
    shape may be split differently (``wq`` and ``wo``)."""
    from repro_torch.core.tree_util import tree_flatten
    pdef = tree_flatten(params)[1]
    pspecs = spec_leaves(specs)
    out: list = []

    def walk(x):
        leaves, tdef = tree_flatten(x)
        if tdef == pdef:
            out.extend(pspecs)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            out.extend([P()] * len(leaves))

    walk(state)
    return out


def batch_split_axes(mesh, global_batch: int) -> tuple:
    """The batch axes that split a batch of ``global_batch`` rows: all of
    ('pod', 'data') on the mesh where their product divides it, none
    otherwise (the reference's ``_maybe_batch_spec``)."""
    axes = batch_axes(mesh)
    return axes if axes and global_batch % mesh.axes_size(axes) == 0 else ()


@dataclasses.dataclass(frozen=True, eq=False)
class Split:
    """How a model runs split: the ``mesh``, the sanitized spec tree of
    its parameters (:func:`split_specs`) and the axes its batch is split
    over (``()``: every rank holds the whole batch)."""
    mesh: Any
    specs: dict
    batch_axes: tuple = ()

    @property
    def model(self) -> int:
        """The 'model' axis' size (1 without one)."""
        return (self.mesh.shape['model'] if 'model' in self.mesh.axis_names
                else 1)

    @property
    def model_rank(self) -> int:
        return (self.mesh.coords['model'] if 'model' in self.mesh.axis_names
                else 0)

    def use(self, x: torch.Tensor, spec: P, model_varying: bool):
        """A parameter block as its work reads it: gathered over the FSDP
        axes its spec holds besides 'model', and entering work that varies
        over the batch axes (and over 'model' where ``model_varying``) that
        it does not vary over itself, so that its cotangent is summed over
        them (a reduce-scatter where it was gathered)."""
        axes = spec_axes(spec, self.mesh)
        fsdp = tuple(a for a in axes if a != 'model')
        vary = set(self.batch_axes)
        if model_varying and 'model' not in axes:
            vary.add('model')
        vary = tuple(a for a in self.mesh.axis_names if a in vary)
        if fsdp:
            return ctx.gather(x, spec, self.mesh, axes=fsdp, vary=vary)
        return ctx.pvary(x, self.mesh, vary)

    def use_tree(self, tree: dict, specs: dict, model_varying: bool):
        return {k: (self.use_tree(v, specs[k], model_varying)
                    if isinstance(v, dict)
                    else self.use(v, specs[k], model_varying))
                for k, v in tree.items()}

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream (whole on every 'model' rank) entering the
        rank's heads, FFN columns or vocab block."""
        return ctx.pvary(x, self.mesh, ('model',))

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over 'model' of a row-parallel product's partial sums."""
        return ctx.psum(x, self.mesh, ('model',))

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        return ctx.psum(x, self.mesh, self.batch_axes)

    def batch_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch's field (all of them where the
        batch is replicated)."""
        if not self.batch_axes:
            return x
        return x[block_slices(tuple(x.shape), P(self.batch_axes),
                              self.mesh)]

    def vocab_offset(self, local_vocab: int) -> int:
        return self.model_rank * local_vocab

    def heads(self, cfg: ModelConfig) -> HeadLayout:
        """This rank's attention heads (:func:`head_layout`)."""
        return head_layout(cfg.n_heads, cfg.n_kv_heads, self.model,
                           self.model_rank)


def make_split(cfg: ModelConfig, mesh, global_batch: int | None = None,
               specs: dict | None = None) -> Split:
    """The :class:`Split` of ``cfg`` on ``mesh`` for a batch of
    ``global_batch`` rows (None: replicated)."""
    return Split(mesh=mesh, specs=specs or split_specs(cfg, mesh),
                 batch_axes=(() if global_batch is None
                             else batch_split_axes(mesh, global_batch)))


def cache_split_specs(cfg: ModelConfig, mesh, batch: int,
                      max_len: int) -> dict:
    """The spec tree of a decode cache of ``batch`` rows and ``max_len``
    positions (``cfg.cross_len`` encoder states) on ``mesh``:
    :func:`~repro_torch.distributed.sharding.sanitize_cache_specs` (the
    batch axes dropped where they do not divide ``batch``, as
    :func:`batch_split_axes` drops them from a :class:`Split`). The
    sequence of the KV and cross caches is over 'model'; a length that
    'model' does not divide raises."""
    from repro_torch.distributed.sharding import sanitize_cache_specs
    from repro_torch.models.transformer import init_cache
    check_splittable(cfg, mesh)
    whole = init_cache(cfg, batch, max_len, device='meta')
    specs = sanitize_cache_specs(cfg, mesh, whole, batch)
    model = mesh.shape['model'] if 'model' in mesh.axis_names else 1
    kv = [(f'{slot} ', sc, specs['slots'][slot])
          for slot, sc in whole['slots'].items()]
    if cfg.is_encdec:
        kv.append(('cross ', whole['cross'], specs['cross']))
    for name, leaves, s in kv:
        if model > 1 and s['k'][2] != 'model':
            raise NotImplementedError(
                f'the {name}cache\'s sequence of {leaves["k"].shape[2]} over '
                f'model {model}: the flash-decoding layout needs \'model\' '
                'to divide it')
    return specs


def shard_cache(cache: dict, specs: dict, mesh) -> dict:
    """This rank's block of every leaf of the whole decode cache ``cache``
    under :func:`cache_split_specs`' tree ``specs``, each in storage of
    its own; ``pos`` is whole on every rank."""
    from repro_torch.distributed.sharding import NamedSharding, shard
    return {k: (shard_cache(v, specs[k], mesh) if isinstance(v, dict)
                else shard(v, NamedSharding(mesh, specs[k])))
            for k, v in cache.items()}


__all__ = ['HeadLayout', 'Split', 'batch_split_axes', 'cache_split_specs',
           'check_splittable', 'head_layout', 'make_split', 'padded_group',
           'shard_cache', 'shard_params', 'split_specs',
           'state_spec_leaves']
