"""The activation mesh, ``shard_map``'s counterpart, and the collectives
the port uses: the counterpart of ``repro/distributed/ctx.py``.

``activation_mesh(mesh)`` makes ``mesh`` current while a step runs (the
MoE layer reads it and takes its sharded ``capacity`` path);
``constrain(x, *entries)`` is the reference's layout hint, which changes
no value: the port returns ``x`` as it is, inside a mesh or not.

A model runs replicated (every rank holds the full parameters and
activations, and a sharded piece of work takes this rank's blocks of them
with :func:`shard_map`) or split (each rank holds its blocks of every
parameter, :mod:`repro_torch.models.split`). The collectives are
``all_reduce`` and ``broadcast`` only, which every backend offers for CPU
and CUDA tensors (gloo offers nothing else for CUDA tensors): a gather is
an ``all_reduce`` of zero-padded blocks, and a reduce-scatter is a sum
then a block. Each call counts itself in :data:`COLLECTIVES` under its own
name.

The collectives differentiate as the reference's ``shard_map`` transposes
them, for a loss every rank computes alike: :func:`psum`'s cotangent
passes through as a :func:`pvary` (:func:`pmean`'s scaled by 1/n),
:func:`pvary` (an invariant value entering work that varies over some
axes) sums its cotangent over them, :func:`block` (a full tensor → this
rank's block) gathers its cotangent over the spec's axes, and
:func:`gather` takes the block of its cotangent. Each also has a forward
rule (the same collective on the tangent) and a ``vmap`` rule, and its
backward is built of these collectives again: HVP columns
(``vmap(jvp(grad))``) and second derivatives pass through them.
"""
from __future__ import annotations

import collections
import contextlib

import torch

from repro_torch.distributed.sharding import (P, _entry_axes,
                                              block_slices, global_shape,
                                              holds_first_replica, spec_axes,
                                              spec_leaves)

#: collectives run since the last :func:`reset_collectives`, by name
#: (``psum``, ``pmax``, ``gather``, ``pvary``, ``block``); each is one
#: ``all_reduce`` call
COLLECTIVES: collections.Counter = collections.Counter()

_MESH = None


def reset_collectives() -> None:
    COLLECTIVES.clear()


@contextlib.contextmanager
def activation_mesh(mesh):
    """Make ``mesh`` current inside the block; the previous one after."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield
    finally:
        _MESH = prev


def current_mesh():
    return _MESH


def constrain(x: torch.Tensor, *entries) -> torch.Tensor:
    """The reference's sharding hint: it moves no value, so ``x`` comes
    back as it is (outside a mesh the reference's is the identity too).
    Under a mesh it checks one entry per dim, as the reference does."""
    if _MESH is not None and len(entries) != x.ndim:
        raise ValueError(f'constrain: {len(entries)} entries for a tensor '
                         f'of shape {tuple(x.shape)}')
    return x


# --------------------------------------------------------- raw collectives
def _all_reduce(x: torch.Tensor, mesh, axes, op: str, name: str):
    """A copy of ``x`` all-reduced over ``axes``' group (no copy and no
    call when those axes hold one rank)."""
    import torch.distributed as dist
    if axes is None:
        axes = mesh.axis_names
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if mesh.axes_size(axes) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op={'sum': dist.ReduceOp.SUM,
                             'max': dist.ReduceOp.MAX}[op],
                    group=mesh.group(axes))
    COLLECTIVES[name] += 1
    return out


def _padded(x_block: torch.Tensor, spec: P, mesh, full_shape) -> torch.Tensor:
    out = x_block.new_zeros(full_shape)
    out[block_slices(tuple(full_shape), spec, mesh)] = x_block
    return out


def _spec_axes(spec: P) -> tuple:
    return tuple(a for e in spec for a in _entry_axes(e))


# ------------------------------------------- differentiable collectives
# Each collective is an autograd Function in the ``setup_context`` form, so
# that plain autograd and every ``torch.func`` transform see it: a ``jvp``
# rule (the same collective on the tangent: each is linear), a ``vmap``
# rule (one collective on the batched tensor, its batch dimension kept, so
# every rank calls the same collectives in the same order), and a backward
# written with the differentiable collectives themselves, so that a
# gradient's own graph (``jvp(grad)``, ``vmap`` of it, a second backward)
# holds them too. The transposes are shard_map's: psum ↔ pvary, block ↔
# gather.
def _batched_spec(spec: P, dim) -> P:
    """``spec`` for a tensor with a batch dimension moved to the front."""
    return spec if dim is None else P(None, *spec)


def _front(x: torch.Tensor, dim):
    return x if dim is None else x.movedim(dim, 0)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes, scale, name):
        out = _all_reduce(x, mesh, axes, 'sum', name)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, axes, scale, _ = ctx.args
        g = pvary(g, mesh, mesh.axis_names if axes is None else axes)
        return (g * scale if scale != 1.0 else g), None, None, None, None

    @staticmethod
    def jvp(ctx, x_dot, *_):
        return _PSum.apply(x_dot, *ctx.args)

    @staticmethod
    def vmap(info, in_dims, x, *args):
        return _PSum.apply(x, *args), in_dims[0]


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _PSum.apply(g, mesh, axes, 1.0, 'pvary'), None, None

    @staticmethod
    def jvp(ctx, x_dot, *_):
        return _PVary.apply(x_dot, *ctx.args)

    @staticmethod
    def vmap(info, in_dims, x, *args):
        return _PVary.apply(x, *args), in_dims[0]


def _restrict(spec: P, axes) -> P:
    """``spec`` with only the entries over ``axes`` kept (None: all); an
    entry partly over them raises."""
    if axes is None:
        return spec
    out = []
    for e in spec:
        used = _entry_axes(e)
        inside = [a in axes for a in used]
        if any(inside) and not all(inside):
            raise ValueError(f'entry {e} of {spec} is only partly over {axes}')
        out.append(e if used and all(inside) else None)
    return P(*out)


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, spec, axes):
        return x[block_slices(tuple(x.shape), _restrict(spec, axes), mesh)]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, spec, axes = ctx.args
        spec = _restrict(spec, axes)
        return (_Gather.apply(g, mesh, spec, _spec_axes(spec), (), 'block'),
                None, None, None)

    @staticmethod
    def jvp(ctx, x_dot, *_):
        return _Block.apply(x_dot, *ctx.args)

    @staticmethod
    def vmap(info, in_dims, x, mesh, spec, axes):
        d = in_dims[0]
        return (_Block.apply(_front(x, d), mesh, _batched_spec(spec, d),
                             axes), None if d is None else 0)


class _Gather(torch.autograd.Function):
    """The whole tensor from the blocks: over ``axes`` (every rank of an
    ``axes`` group holds a distinct block), or over the whole mesh
    (``axes=None``: each shard written by one of its replicas). ``vary``:
    the axes the result enters varying work over (a ``pvary`` fused in:
    the cotangent is summed over them before its block is taken, which is
    a reduce-scatter)."""

    @staticmethod
    def forward(x_block, mesh, spec, axes, vary, name='gather'):
        spec = _restrict(spec, axes)
        shape = global_shape(tuple(x_block.shape), spec, mesh)
        full = _padded(x_block, spec, mesh, shape)
        if axes is None and not holds_first_replica(spec, mesh):
            full.zero_()
        return _all_reduce(full, mesh, axes, 'sum', name)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, spec, axes, vary = ctx.args[:4]
        if vary and mesh.axes_size(vary) > 1:
            g = _PSum.apply(g, mesh, vary, 1.0, 'pvary')
        return (_Block.apply(g, mesh, spec, axes),) + (None,) * 5

    @staticmethod
    def jvp(ctx, x_dot, *_):
        return _Gather.apply(x_dot, *ctx.args)

    @staticmethod
    def vmap(info, in_dims, x, mesh, spec, axes, vary, name='gather'):
        d = in_dims[0]
        return (_Gather.apply(_front(x, d), mesh, _batched_spec(spec, d),
                              axes, vary, name), None if d is None else 0)


def psum(x: torch.Tensor, mesh, axes=None) -> torch.Tensor:
    """Σ of ``x`` over ``axes`` (None: the whole mesh), on every rank."""
    axes_ = mesh.axis_names if axes is None else axes
    if mesh.axes_size(axes_) == 1:
        return x
    return _PSum.apply(x, mesh, axes, 1.0, 'psum')


def pmean(x: torch.Tensor, mesh, axes=None) -> torch.Tensor:
    """The mean of ``x`` over ``axes``, on every rank."""
    axes_ = mesh.axis_names if axes is None else axes
    if mesh.axes_size(axes_) == 1:
        return x
    return _PSum.apply(x, mesh, axes, 1.0 / mesh.axes_size(axes_), 'psum')


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axes):
        return _all_reduce(x, mesh, axes, 'max', 'pmax')

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None

    @staticmethod
    def jvp(ctx, x_dot, *_):
        return torch.zeros_like(x_dot)

    @staticmethod
    def vmap(info, in_dims, x, *args):
        return _PMax.apply(x, *args), in_dims[0]


def pmax(x: torch.Tensor, mesh, axes=None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axes`` (no gradient)."""
    axes_ = mesh.axis_names if axes is None else axes
    if mesh.axes_size(axes_) == 1:
        return x.detach()
    return _PMax.apply(x.detach(), mesh, axes)


def pvary(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x``, invariant over ``axes``, entering work that varies over them:
    the value is unchanged, the cotangent is summed over ``axes``."""
    if not axes or mesh.axes_size(axes) == 1:
        return x
    return _PVary.apply(x, mesh, tuple(axes))


def block(x: torch.Tensor, spec: P, mesh, axes=None) -> torch.Tensor:
    """This rank's block of the full (replicated) ``x`` under ``spec``
    (only the entries over ``axes``, when given)."""
    return _Block.apply(x, mesh, spec, None if axes is None else tuple(axes))


def gather(x_block: torch.Tensor, spec: P, mesh, axes=None,
           vary=()) -> torch.Tensor:
    """The full tensor from every rank's block under ``spec``: one
    ``all_reduce`` of the zero-padded blocks, over the whole mesh (each
    shard written by one of its replicas only) or, with ``axes``, over
    those axes' group, taking only the spec's entries over them (FSDP's
    gather on use). ``vary``: axes the result enters varying work over;
    its cotangent is summed over them before the block is taken."""
    if axes is not None:
        axes = tuple(axes)
        if mesh.axes_size(_spec_axes(_restrict(spec, axes))) == 1:
            return pvary(x_block, mesh, vary)
    return _Gather.apply(x_block, mesh, spec, axes, tuple(vary))


def split_vdot(a, b, specs, mesh) -> torch.Tensor:
    """⟨a, b⟩ over whole trees held as blocks (``specs``: their sanitized
    spec tree): each leaf's local dot summed over the axes its spec splits
    it on only, one ``psum`` per set of axes, so that the value is the
    whole dot on every rank and its derivatives through the collectives
    are too (a replicated leaf is counted once, as it is held)."""
    from repro_torch.core.tree_util import tree_leaves
    groups: dict = {}
    for x, y, s in zip(tree_leaves(a), tree_leaves(b), spec_leaves(specs)):
        key = spec_axes(s, mesh)
        d = torch.sum(x.float() * y.float())
        groups[key] = d if key not in groups else groups[key] + d
    out = None
    for key in sorted(groups):
        d = psum(groups[key], mesh, key) if key else groups[key]
        out = d if out is None else out + d
    return out


def shard_map(f, mesh, in_specs, out_specs):
    """The counterpart of ``jax.shard_map`` on the port's replicated
    tensors: ``f`` runs on this rank's blocks of its (full) arguments, as
    ``in_specs`` (one spec tree an argument) select them. What ``f``
    returns comes back as it is: an output under ``P()`` is equal on every
    rank by construction, a sharded one is this rank's block
    (:func:`gather` makes it whole)."""
    from repro_torch.core.tree_util import tree_flatten
    from repro_torch.distributed.sharding import specs_like

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f'{len(args)} arguments for {len(in_specs)} '
                             'in_specs')
        local = []
        for arg, spec_tree in zip(args, in_specs):
            leaves, treedef = tree_flatten(arg)
            specs = specs_like(arg, spec_tree)
            local.append(treedef.unflatten([block(x, s, mesh)
                                            for x, s in zip(leaves, specs)]))
        return f(*local)

    del out_specs   # the outputs are f's own blocks
    return run


__all__ = ['COLLECTIVES', 'activation_mesh', 'block', 'constrain',
           'current_mesh', 'gather', 'pmax', 'pmean', 'psum',
           'pvary', 'reset_collectives', 'shard_map', 'split_vdot']
