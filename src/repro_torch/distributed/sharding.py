"""Logical → physical sharding rules for every family: the counterpart of
``repro/distributed/sharding.py``, with the same policy (its module doc):

  * batch            → ('pod', 'data')     [pod present on the 2-pod mesh]
  * vocab (padded)   → 'model'
  * d_ff / d_inner   → 'model'             (column / row parallel FFN)
  * attention        → the flattened q-head dim over 'model' iff
                       H % model == 0; K/V replicated when KV % model != 0;
                       otherwise row-parallel on d_model for wq, K/V/O
                       replicated
  * KV-cache seq     → 'model'
  * FSDP (cfg.fsdp)  → params additionally over 'data' on the largest
                       divisible non-'model' dim

A dim that does not divide its axis is replicated: the rules degrade and
never raise, on any (arch × mesh) pair.

A spec is the port's own :class:`P`, a tuple whose entries are None, an
axis name, or a tuple of names (one dim split over several axes, major to
minor, as JAX splits it). The rules read only ``mesh.axis_names``,
``mesh.shape`` and ``mesh.devices.size``, so any object with those serves
(a :class:`~repro_torch.launch.mesh.Mesh`, or a stand-in where no process
group exists). Spec trees follow the port's parameter trees: ``blocks`` is
a list with one dict per block, each leaf without the reference's stacked
block axis (its ``scan_layers=False`` layout).

:func:`named_shardings` pairs a mesh with each spec, and :func:`shard`
takes this rank's block of a full tensor under one: the counterpart of
``jax.device_put(array, NamedSharding(mesh, spec))``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.config import ModelConfig


def _canonical(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P(tuple):
    """A partition spec: one entry per leading dim of a tensor (None, an
    axis name, or a tuple of names); missing trailing entries replicate.
    As JAX's, a one-name tuple entry is that name and an empty one None.
    It is a leaf of every spec tree (:func:`spec_leaves`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canonical(e) for e in entries))

    def __repr__(self):
        return f'P{tuple.__repr__(self)}'


def _is_spec(x) -> bool:
    return isinstance(x, P)


def spec_map(fn, spec_tree):
    """``fn`` over the specs of a spec tree (dicts, lists, tuples of
    specs), keeping its structure."""
    if _is_spec(spec_tree) or spec_tree is None:
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(spec_map(fn, v) for v in spec_tree)
    raise TypeError(f'not a spec tree: {type(spec_tree).__name__}')


def spec_leaves(spec_tree) -> list:
    """The specs of a spec tree, in the order of the port's
    ``tree_leaves`` (dict keys sorted)."""
    out: list = []

    def walk(x):
        if _is_spec(x) or x is None:
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            raise TypeError(f'not a spec tree: {type(x).__name__}')

    walk(spec_tree)
    return out


def specs_like(tree, spec_tree) -> list:
    """One spec per leaf of ``tree`` (in ``tree_leaves`` order): a spec
    tree that stops at a spec where ``tree`` goes on gives that spec to
    every leaf below it, as JAX's ``flatten_up_to`` reads a prefix; None
    gives every leaf ``P()``."""
    out: list = []

    def walk(x, s):
        if s is None:
            s = P()
        if _is_spec(s):
            from repro_torch.core.tree_util import tree_leaves
            out.extend([s] * len(tree_leaves(x)))
        elif isinstance(x, dict):
            if not isinstance(s, dict) or set(s) != set(x):
                raise ValueError(
                    f'spec tree does not match the tree: keys '
                    f'{sorted(x)} against '
                    f'{sorted(s) if isinstance(s, dict) else s}')
            for k in sorted(x):
                walk(x[k], s[k])
        elif isinstance(x, (list, tuple)):
            if not isinstance(s, (list, tuple)) or len(s) != len(x):
                raise ValueError('spec tree does not match the tree: a '
                                 f'sequence of {len(x)} against {s}')
            for v, sv in zip(x, s):
                walk(v, sv)
        else:
            raise ValueError(f'spec tree ends in {s!r} at a leaf')

    walk(tree, spec_tree)
    return out


# --------------------------------------------------------------- mesh helpers
def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ('pod', 'data') if a in mesh.axis_names)


def batch_spec(mesh, extra_dims: int = 0) -> P:
    return P(batch_axes(mesh), *([None] * extra_dims))


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _div(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % _axis_size(mesh, axis) == 0


# --------------------------------------------------------------- param rules
def _attn_specs(cfg: ModelConfig, mesh, fsdp: str | None,
                cross: bool = False):
    """Specs for one attention param dict (trailing dims only)."""
    m = _axis_size(mesh, 'model')
    head_ok = cfg.n_heads % m == 0
    kv_ok = cfg.n_kv_heads % m == 0
    f = fsdp
    if head_ok:
        out = {'wq': P(f, 'model'), 'wo': P('model', f),
               'wk': P(f, 'model') if kv_ok else P(f, None),
               'wv': P(f, 'model') if kv_ok else P(f, None)}
        bias = {'bq': P('model'), 'bk': P('model') if kv_ok else P(None),
                'bv': P('model') if kv_ok else P(None)}
    else:
        # fallback: row-parallel QKV on d_model; O replicated (+fsdp)
        out = {'wq': P('model', f), 'wk': P('model', f), 'wv': P('model', f),
               'wo': P(f, None)}
        bias = {'bq': P(None), 'bk': P(None), 'bv': P(None)}
    if cfg.qkv_bias and not cross:
        out.update(bias)
    return out


def _slot_specs(cfg: ModelConfig, mesh, mixer: str, ffn: str,
                with_cross: bool, fsdp: str | None):
    f = fsdp
    specs: dict[str, Any] = {'ln1': {'scale': P(None)},
                             'ln2': {'scale': P(None)}}
    if mixer == 'attn':
        specs['mixer'] = _attn_specs(cfg, mesh, f)
    elif mixer == 'mamba':
        dm = 'model' if _div(cfg.d_inner, mesh, 'model') else None
        specs['mixer'] = {
            'in_proj': P(f, dm), 'conv_w': P(None, dm), 'conv_b': P(dm),
            'x_proj': P(dm, None), 'dt_proj_w': P(None, dm), 'dt_proj_b': P(dm),
            'A_log': P(dm, None), 'D': P(dm), 'out_proj': P(dm, f)}
    else:  # rwkv
        dm = 'model' if _div(cfg.d_model, mesh, 'model') else None
        specs['mixer'] = {
            'mu': P(None, None), 'w_lora_a': P(f, None), 'w_lora_b': P(None, dm),
            'w0': P(dm), 'bonus': P(None, None),
            'wr': P(f, dm), 'wk': P(f, dm), 'wv': P(f, dm), 'wg': P(f, dm),
            'wo': P(dm, f), 'ln_scale': P(None, None),
            'mu_cm': P(None, None), 'ck': P(f, 'model'),
            'cv': P('model', f), 'cr': P(f, dm)}
    if mixer != 'rwkv':
        if ffn == 'moe':
            specs['ffn'] = {'router': P(f, None),
                            'w1': P(None, f, 'model'), 'w3': P(None, f, 'model'),
                            'w2': P(None, 'model', f)}
            if cfg.shared_expert:
                specs['ffn']['shared'] = {'w1': P(f, 'model'),
                                          'w3': P(f, 'model'),
                                          'w2': P('model', f)}
        else:
            specs['ffn'] = {'w1': P(f, 'model'), 'w3': P(f, 'model'),
                            'w2': P('model', f)}
    if with_cross:
        specs['ln_cross'] = {'scale': P(None)}
        specs['cross'] = _attn_specs(cfg, mesh, f, cross=True)
    return specs


def param_specs(cfg: ModelConfig, mesh) -> dict:
    """Spec tree matching ``build_model(cfg).init(...)``'s structure: the
    reference's rules, with ``blocks`` (and ``enc_blocks``) a list of one
    spec dict per block, as the port's trees hold them."""
    fsdp = 'data' if (cfg.fsdp and 'data' in mesh.axis_names) else None
    emb = {'table': P('model', None)}   # padded vocab always divides
    specs: dict[str, Any] = {}
    if cfg.embed_inputs or cfg.is_encdec:
        specs['embed'] = emb
    if not (cfg.tie_embeddings and cfg.embed_inputs) or not cfg.embed_inputs:
        specs['unembed'] = emb
    if cfg.tie_embeddings and cfg.embed_inputs:
        specs.pop('unembed', None)

    kinds = cfg.layer_kinds()
    block = {f'slot{i}': _slot_specs(cfg, mesh, m_, f_, cfg.is_encdec, fsdp)
             for i, (m_, f_) in enumerate(kinds)}
    specs['blocks'] = [block] * cfg.n_blocks
    specs['final_norm'] = {'scale': P(None)}
    if cfg.is_encdec:
        enc_block = {'slot0': _slot_specs(cfg, mesh, 'attn', 'dense',
                                          False, fsdp)}
        specs['enc_blocks'] = [enc_block] * cfg.n_enc_layers
        specs['enc_final_norm'] = {'scale': P(None)}
    return specs


# --------------------------------------------------------------- cache rules
def cache_specs(cfg: ModelConfig, mesh) -> dict:
    """Decode-cache specs: KV sequence axis → 'model', batch → (pod, data)."""
    b = batch_axes(mesh)
    slots: dict[str, Any] = {}
    seq_ax = 'model' if 'model' in mesh.axis_names else None
    for i, (mixer, _) in enumerate(cfg.layer_kinds()):
        if mixer == 'attn':
            slots[f'slot{i}'] = {'k': P(None, b, seq_ax, None, None),
                                 'v': P(None, b, seq_ax, None, None)}
        elif mixer == 'mamba':
            di_ax = 'model' if _div(cfg.d_inner, mesh, 'model') else None
            slots[f'slot{i}'] = {'conv': P(None, b, None, di_ax),
                                 'ssm': P(None, b, di_ax, None)}
        else:
            d_ax = 'model' if _div(cfg.d_model, mesh, 'model') else None
            h_ax = 'model' if _div(cfg.d_model // 64, mesh, 'model') else None
            slots[f'slot{i}'] = {'tm_prev': P(None, b, d_ax),
                                 'cm_prev': P(None, b, d_ax),
                                 'wkv': P(None, b, h_ax, None, None)}
    cache = {'pos': P(), 'slots': slots}
    if cfg.is_encdec:
        cache['cross'] = {'k': P(None, b, seq_ax, None, None),
                          'v': P(None, b, seq_ax, None, None)}
    return cache


def sanitize_cache_specs(cfg: ModelConfig, mesh, template: dict,
                         batch: int) -> dict:
    """:func:`cache_specs` for the whole cache ``template`` of ``batch``
    rows (a tree of tensors, ``meta`` ones included): where the batch
    axes do not divide ``batch`` they are dropped from every spec, as the
    reference's ``build_serve_step`` does for the B = 1 long-context case;
    then each spec is sanitized against its leaf's shape."""
    specs = cache_specs(cfg, mesh)
    axes = batch_axes(mesh)
    size = 1
    for a in axes:
        size *= _axis_size(mesh, a)
    if batch % size:
        specs = spec_map(lambda s: P(*[
            None if set(_entry_axes(e)) & set(axes) else e for e in s]),
            specs)

    def walk(x, s):
        if isinstance(x, dict):
            return {k: walk(x[k], s[k]) for k in x}
        return sanitize_spec(tuple(x.shape), s, mesh)

    return walk(template, specs)


# --------------------------------------------------- per-leaf shard queries
def _entry_axes(e) -> tuple:
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def sanitize_spec(shape: tuple, spec: P | None, mesh) -> P:
    """``spec`` with the entries that cannot shard ``shape`` on ``mesh``
    dropped (→ a replicated dim): an entry goes when any of its axes is not
    on the mesh, their combined size is 1, or the dim does not divide by
    it. The result has ``len(shape)`` entries."""
    entries = list(spec) if spec is not None else []
    entries = entries[:len(shape)] + [None] * (len(shape) - len(entries))
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        size = 1
        for a in _entry_axes(e):
            size *= _axis_size(mesh, a) if a in mesh.axis_names else 0
        out.append(e if size > 1 and dim % size == 0 else None)
    return P(*out)


def spec_shard_count(spec: P, mesh) -> int:
    """The number of distinct shards a (sanitized) spec makes: the product
    of its axes' sizes."""
    n = 1
    for e in spec:
        for a in _entry_axes(e):
            n *= _axis_size(mesh, a)
    return n


def replication_factor(spec: P, mesh) -> int:
    """How many ranks hold each shard: mesh size / distinct shards (1 when
    sharded over every axis, the mesh's size when replicated). A sum over
    the whole mesh of per-rank fused buffers divides it out per leaf."""
    return mesh.devices.size // spec_shard_count(spec, mesh)


def local_shape(shape: tuple, spec: P, mesh) -> tuple:
    """A rank's block shape of a leaf with (sanitized) ``spec``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        size = 1
        for a in _entry_axes(e):
            size *= _axis_size(mesh, a)
        out.append(dim // size)
    return tuple(out)


def spec_axes(spec: P, mesh) -> tuple:
    """The mesh axes that ``spec`` splits over, in the mesh's order."""
    used = {a for e in spec for a in _entry_axes(e)}
    return tuple(a for a in mesh.axis_names if a in used)


def global_shape(local: tuple, spec: P, mesh) -> tuple:
    """A leaf's whole shape from a rank's block shape under a sanitized
    ``spec``: the inverse of :func:`local_shape`."""
    entries = list(spec) + [None] * (len(local) - len(spec))
    out = []
    for dim, e in zip(local, entries):
        for a in _entry_axes(e):
            dim *= _axis_size(mesh, a)
        out.append(dim)
    return tuple(out)


def block_slices(shape: tuple, spec: P, mesh) -> tuple:
    """This rank's block of a leaf under ``spec`` as one ``slice`` per dim.
    A dim split over several axes takes the index major to minor; the
    mesh's ``coords`` give this rank's place. A dim that does not divide
    raises."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if len(entries) > len(shape):
        raise ValueError(f'spec {spec} has more entries than shape {shape}')
    out = []
    for dim, e in zip(shape, entries):
        axes = _entry_axes(e)
        size, index = 1, 0
        for a in axes:
            index = index * mesh.shape[a] + mesh.coords[a]
            size *= mesh.shape[a]
        if dim % size:
            raise ValueError(f'dim {dim} of {tuple(shape)} does not divide '
                             f'over {axes} ({size}) under {spec}')
        n = dim // size
        out.append(slice(index * n, (index + 1) * n))
    return tuple(out)


def holds_first_replica(spec: P, mesh) -> bool:
    """True on the one rank of each shard's replicas that sits at
    coordinate 0 on every axis ``spec`` does not use: gathering blocks
    from those ranks only counts each shard once."""
    used = {a for e in spec for a in _entry_axes(e)}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in used)


# --------------------------------------------------------------- utilities
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: P


def named_shardings(mesh, spec_tree):
    return spec_map(lambda s: NamedSharding(mesh, P() if s is None else s),
                    spec_tree)


def shard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``sharding``, in
    storage of its own (a view would keep the whole of ``x`` alive): what
    ``jax.device_put(x, sharding)`` leaves on this rank's device."""
    return x[block_slices(tuple(x.shape), sharding.spec,
                          sharding.mesh)].clone(
                              memory_format=torch.contiguous_format)


def mirror_specs(template_tree, spec_tree, state_tree):
    """Give each optimizer-state leaf the spec of the same-shaped param leaf
    (momentum/Adam moments are param-shaped); anything else replicates."""
    from repro_torch.core.tree_util import tree_leaves, tree_map
    by_shape: dict[tuple, P] = {}
    for leaf, spec in zip(tree_leaves(template_tree), spec_leaves(spec_tree)):
        by_shape.setdefault(tuple(leaf.shape), spec)

    def assign(leaf):
        return by_shape.get(tuple(getattr(leaf, 'shape', ())), P())

    return tree_map(assign, state_tree)
