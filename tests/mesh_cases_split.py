"""The ranks' side of ``tests/test_torch_split_*.py``: the port's model
split on a mesh of gloo ranks (``tests/torch_mesh.py``), against the
reference's unsplit functions, which the test files run in the pytest
process.

Each rank reads ``inputs.pt`` beside its output directory (the reference's
parameters and column draw as numpy, the batches, the mesh's shape and
``fsdp``), takes its blocks (``model_params_from_jax(..., mesh=)``) and
returns what it computed: whole tensors where the step gathers them,
its blocks otherwise. Nothing here imports JAX: the ranks never load it.
"""
import math
from pathlib import Path

import numpy as np

ARCH = 'yi_9b'
B, S = 4, 16
K, RHO, CHUNK = 4, 1e-2, 2
#: mesh shapes ('data', 'model') and FSDP: the model split over 'model'
#: on 2 ranks, over both axes with ZeRO-3 on 4, and over 'model' on 4
#: (reduced Yi-9B's 2 KV heads stay whole there: KV % 4 != 0)
SHAPES = {'1x2': ((1, 2), False), '2x2_fsdp': ((2, 2), True),
          '1x4': ((1, 4), False)}


def inputs(out_dir) -> dict:
    import torch
    return torch.load(Path(out_dir).parent / 'inputs.pt', weights_only=False)


def _setup(out_dir):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_jax, to_torch
    from repro_torch.launch.mesh import make_host_mesh
    x = inputs(out_dir)
    shape, fsdp = x['shape'], x['fsdp']
    cfg = get_config(ARCH).reduced(fsdp=fsdp)
    mesh = make_host_mesh(*shape)
    blocks = model_params_from_jax(x['params'], cfg, mesh=mesh)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             x['batch'].items()}
    return x, cfg, mesh, blocks, batch, to_torch


def _leaf_shapes(tree) -> list:
    from repro_torch.core.tree_util import tree_leaves
    return [tuple(t.shape) for t in tree_leaves(tree)]


# ------------------------------------------------------------ model, steps
def model(rank: int, world: int, out_dir) -> dict:
    """Logits, ``train_loss`` and its gradient, the prefill step and one
    ``build_train_step`` step, on the model split on the mesh."""
    import torch

    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_train_step, local_batch,
                                          loss_and_grads, make_optimizer)
    from repro_torch.models.split import make_split
    from repro_torch.models.transformer import forward, train_loss
    x, cfg, mesh, blocks, batch, _ = _setup(out_dir)
    split = make_split(cfg, mesh, B)
    local = local_batch(batch, split, 'cpu')
    with torch.no_grad():
        logits, _ = forward(cfg, blocks, local['inputs'], split=split)
        logits = ctx.gather(logits, P(split.batch_axes or None, None,
                                      'model'), mesh)
    loss, grads = loss_and_grads(
        lambda p, b: train_loss(cfg, p, b, split=split), blocks, local)
    prefill = build_prefill_step(cfg, device='cpu', mesh=mesh)(
        blocks, {'inputs': batch['inputs']})
    step = build_train_step(cfg, mesh=mesh)
    opt_state = make_optimizer(cfg, split).init(blocks)
    new, new_state, nxt, metrics = step(blocks, opt_state, 0, batch)
    return {'coords': mesh.coords, 'batch_axes': split.batch_axes,
            'shapes': _leaf_shapes(blocks), 'logits': logits,
            'loss': loss, 'grads': grads, 'prefill': prefill,
            'step': {'params': new, 'next': nxt,
                     'loss': metrics['loss'],
                     'grad_norm': metrics['grad_norm'],
                     'moment_shapes': _leaf_shapes(new_state)}}


# ------------------------------------------------------- the hypergradient
def hypergrad(rank: int, world: int, out_dir) -> dict:
    """HVP columns at the injected draw (this rank's blocks of them), the
    hypergradient of Eq. 3 through ``lm_hypergrad`` and one
    ``build_hypergrad_step``, and the collectives of one apply."""
    import torch

    from repro_torch.convert import model_indices_from_jax
    from repro_torch.core import HypergradConfig
    from repro_torch.core.hvp import extract_columns, make_hvp
    from repro_torch.distributed import ctx
    from repro_torch.launch.steps import (build_hypergrad_step,
                                          domain_losses, lm_hypergrad,
                                          local_batch, loss_and_grads,
                                          split_solver)
    from repro_torch.models.split import make_split
    x, cfg, mesh, blocks, batch, to_torch = _setup(out_dir)
    split = make_split(cfg, mesh, B)
    ib = local_batch(batch, split, 'cpu')
    ob_whole = to_torch(x['outer'])
    ob = local_batch(ob_whole, split, 'cpu')
    h = {'domain_logits': torch.from_numpy(x['h0'])}
    idx = model_indices_from_jax(x['draw'], cfg)
    solver = split_solver(mesh, split.specs, HypergradConfig(
        k=K, rho=RHO, column_chunk=CHUNK))
    inner, outer = domain_losses(cfg, split)
    hvp = make_hvp(inner, blocks, h, ib)
    indexer = solver.backend.indexer(blocks)
    cols = extract_columns(hvp, indexer, indexer.check(idx), CHUNK)
    _, hg = lm_hypergrad(solver, inner, outer, blocks, h, ib, ob,
                         indices=idx)
    new_h = build_hypergrad_step(cfg, k=K, rho=RHO, mesh=mesh)(
        blocks, h, batch, ob_whole, indices=idx)
    sketch = solver.prepare(hvp, indexer, None, indices=idx)
    _, g_theta = loss_and_grads(lambda p: outer(p, h, ob), blocks)
    ctx.reset_collectives()
    u = solver.apply(sketch, g_theta)
    apply_counts = dict(ctx.COLLECTIVES)
    return {'coords': mesh.coords, 'columns': cols,
            'hypergrad': hg['domain_logits'],
            'step': new_h['domain_logits'], 'apply_counts': apply_counts,
            'u_shapes': _leaf_shapes(u), 'shapes': _leaf_shapes(blocks),
            'p_local': int(sketch.C.buf.shape[0]),
            'total': indexer.total}


# --------------------------------------------------------------- train_lm
def lm(rank: int, world: int, out_dir) -> dict:
    """``train_lm`` over the CLI's host mesh (2 × 1: the batch split) and
    over a 1 × 2 one (the model split), 4 steps with one outer step; then
    the LM CLI itself in this world (its host mesh, the group kept)."""
    from repro_torch.configs import get_config
    from repro_torch.core import config_from_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import train_lm
    x = inputs(out_dir)
    cfg = get_config(ARCH).reduced()
    out = {}
    for label, mesh in (('host', make_host_mesh()),
                        ('model', make_host_mesh(1, 2))):
        hg_cfg = config_from_cli('nystrom', flags={},
                                 defaults={'k': K, 'rho': RHO},
                                 column_chunk=CHUNK)
        run = train_lm(cfg, hg_cfg, steps=x['steps'], batch=B, seq=S,
                       outer_every=x['steps'], log_every=0, device='cpu',
                       mesh=mesh)
        out[label] = {'coords': mesh.coords, 'losses': run.losses,
                      'outer': [(o['val'], o['hypergrad'])
                                for o in run.outer],
                      'params': run.params}
    run = train_main(cli_argv(x['steps']))     # in the world: host mesh
    out['cli'] = {'losses': run.losses,
                  'outer': [(o['val'], o['hypergrad']) for o in run.outer]}
    return out


def cli_argv(steps: int) -> list:
    """The LM CLI's arguments for the same run on the CPU."""
    return ['--arch', ARCH, '--reduced', '--steps', str(steps),
            '--outer-every', str(steps), '--batch', str(B), '--seq', str(S),
            '--k', str(K), '--log-every', '0', '--device', 'cpu']


# ------------------------------------------------------------ collectives
def collective_inputs() -> dict:
    """Whole inputs of the collectives' cases, f64: ``X`` (4, 6) split
    into blocks over ('data', 'model'), an invariant ``V`` (4, 6) (its
    top-left block-sized corner is the invariant ``v``), constants ``C``
    (4, 6) and ``Z`` (4, 4), tangents ``T`` (3, 4, 6) and ``W`` (4, 6) for
    the second backward."""
    r = np.random.RandomState(7)
    return {k: r.randn(*s) for k, s in (
        ('X', (4, 6)), ('V', (4, 6)), ('C', (4, 6)), ('Z', (4, 4)),
        ('T', (3, 4, 6)), ('W', (4, 6)))}


def blocks_in_order(X, mesh_shape):
    """The blocks of X's last two dims over ('data', 'model'), in rank
    order."""
    d, m = mesh_shape
    R, Cn = X.shape[-2] // d, X.shape[-1] // m
    return [X[..., i * R:(i + 1) * R, j * Cn:(j + 1) * Cn]
            for i in range(d) for j in range(m)]


def corner(t, mesh_shape):
    """The top-left block-sized corner of t's last two dims."""
    R, Cn = t.shape[-2] // mesh_shape[0], t.shape[-1] // mesh_shape[1]
    return t[..., :R, :Cn]


def invariant(c, name, mesh_shape):
    """(the invariant input, its 3 tangents, its second-backward weight)
    of case ``name``, or Nones."""
    inv = INVARIANT[name]
    if inv is None:
        return None, None, None
    if inv == 'v':
        return (corner(c['V'], mesh_shape), corner(c['T'], mesh_shape) * 0.3,
                corner(c['W'], mesh_shape))
    return c['V'], c['T'] * 0.5, c['W']


def split_cases(mesh, c):
    """name → f(xb, y) on a rank: ``xb`` this rank's block of X, ``y`` an
    invariant input (or None); each value is the whole function's."""
    import torch

    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P
    spec = P('data', 'model')
    shape = (mesh.shape['data'], mesh.shape['model'])
    C, Z = corner(c['C'], shape), c['Z']

    return {
        'psum': lambda xb, y: torch.tanh(ctx.psum(xb, mesh) * C).sum(),
        'pmean': lambda xb, y: torch.tanh(ctx.pmean(xb, mesh) * C).sum(),
        'pvary': lambda xb, y: ctx.psum(torch.sin(
            ctx.pvary(y, mesh, mesh.axis_names) * xb).sum(), mesh),
        'block': lambda xb, y: ctx.psum(
            (torch.sin(ctx.block(y, spec, mesh)) ** 2 * xb).sum(), mesh),
        'gather': lambda xb, y: (torch.cos(ctx.gather(xb, spec, mesh))
                                 * c['C']).sum(),
        'gather_data_vary': lambda xb, y: ctx.psum(torch.tanh(
            ctx.block(Z, P('data'), mesh, axes=('data',))
            @ ctx.gather(xb, spec, mesh, axes=('data',),
                         vary=('data',))).sum(), mesh),
        'pmax': lambda xb, y: ctx.psum(
            ((xb - ctx.pmax(xb.max(), mesh)) ** 2).sum(), mesh),
    }


def whole_cases(c, mesh_shape):
    """The same functions of the whole X (and the invariant input) on one
    process, for a mesh of ``mesh_shape``."""
    import torch
    C, Z = corner(c['C'], mesh_shape), c['Z']
    n = mesh_shape[0] * mesh_shape[1]

    def blocks_sum(X):
        return sum(blocks_in_order(X, mesh_shape))

    return {
        'psum': lambda X, Y: torch.tanh(blocks_sum(X) * C).sum(),
        'pmean': lambda X, Y: torch.tanh(blocks_sum(X) / n * C).sum(),
        'pvary': lambda X, Y: sum(torch.sin(Y * b).sum()
                                  for b in blocks_in_order(X, mesh_shape)),
        'block': lambda X, Y: (torch.sin(Y) ** 2 * X).sum(),
        'gather': lambda X, Y: (torch.cos(X) * c['C']).sum(),
        'gather_data_vary': lambda X, Y: torch.tanh(Z @ X).sum(),
        'pmax': lambda X, Y: ((X - X.max().detach()) ** 2).sum(),
    }


#: the invariant input of each case: None, 'v' (block-sized) or 'V'
INVARIANT = {'psum': None, 'pmean': None, 'pvary': 'v', 'block': 'V',
             'gather': None, 'gather_data_vary': None, 'pmax': None}


def collectives(rank: int, world: int, out_dir) -> dict:
    """Each case's value, gradient (reverse mode), ``jvp``, HVP columns
    (``vmap(jvp(grad))`` over three tangents) and second backward, on this
    rank's blocks (world 4: a 2 × 2 mesh; world 1: a 1 × 1 one, where every
    collective is the identity)."""
    import torch
    from torch.func import grad, jvp, vmap

    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P, block_slices
    from repro_torch.launch.mesh import make_host_mesh
    shape = (2, 2) if world == 4 else (1, 1)
    mesh = make_host_mesh(*shape)
    c = {k: torch.from_numpy(v) for k, v in collective_inputs().items()}
    spec = P('data', 'model')

    def mine(t):
        return t[(...,) + block_slices(tuple(t.shape[-2:]), spec, mesh)] \
            .clone()

    out = {}
    for name, f in split_cases(mesh, c).items():
        y, ty, w_y = invariant(c, name, shape)
        xb, tx, w_x = mine(c['X']), mine(c['T']), mine(c['W'])
        ctx.reset_collectives()
        if y is None:
            fx = lambda a: f(a, None)                     # noqa: E731
            res = {'val': fx(xb), 'g': (grad(fx)(xb),),
                   'jvp': jvp(fx, (xb,), (tx[0],))[1],
                   'hvp': (vmap(lambda t: jvp(grad(fx), (xb,),
                                              (t,))[1])(tx),)}
            a = xb.clone().requires_grad_(True)
            ga, = torch.autograd.grad(fx(a), a, create_graph=True)
            res['dbl'] = torch.autograd.grad((ga * w_x).sum(), a)
        else:
            g2 = grad(f, argnums=(0, 1))
            res = {'val': f(xb, y), 'g': g2(xb, y),
                   'jvp': jvp(f, (xb, y), (tx[0], ty[0]))[1],
                   'hvp': vmap(lambda t, s: jvp(g2, (xb, y), (t, s))[1])(
                       tx, ty)}
            a, b = (xb.clone().requires_grad_(True),
                    y.clone().requires_grad_(True))
            ga, gb = torch.autograd.grad(f(a, b), (a, b), create_graph=True)
            res['dbl'] = torch.autograd.grad(
                (ga * w_x).sum() + (gb * w_y).sum(), (a, b))
        res['counts'] = dict(ctx.COLLECTIVES)
        out[name] = res
    out['coords'] = mesh.coords
    return out


def leaf_block(t, spec, mesh_shape: tuple, coords: dict, lead: int = 0):
    """The block of the whole ``t`` (its last dims the leaf) at
    ``coords`` under ``spec`` on a ('data', 'model') mesh of
    ``mesh_shape``: for the tests, without a mesh."""
    sizes = dict(zip(('data', 'model'), mesh_shape))
    entries = list(spec) + [None] * (t.ndim - lead - len(spec))
    idx = [slice(None)] * lead
    for n, e in zip(t.shape[lead:], entries):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        size = math.prod(sizes[a] for a in axes)
        i = 0
        for a in axes:
            i = i * sizes[a] + coords[a]
        idx.append(slice(i * (n // size), (i + 1) * (n // size)))
    return t[tuple(idx)]


# ------------------------------------------------ decode and the families
SMAX = 16           # the cache's length: 12 steps cross three 1 x 4 blocks
DECODE_STEPS = 12   # teacher-forced steps from 0, then one at pos = SMAX


def _family_setup(out_dir):
    """(inputs, the port's config, the mesh, this rank's blocks) of a
    family's run: ``inputs.pt`` names the arch, its ``reduced()``
    overrides and the mesh's shape."""
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    x = inputs(out_dir)
    cfg = get_config(x['arch']).reduced(**x['over'])
    mesh = make_host_mesh(*x['shape'])
    return x, cfg, mesh, model_params_from_jax(x['params'], cfg, mesh=mesh)


def _serve(cfg, mesh, blocks, x) -> dict:
    """``build_serve_step(mesh=)`` over ``x['steps']`` (whole inputs, one
    a step) from an empty cache of ``SMAX`` (an encoder-decoder's cross
    cache filled from ``x['frames']`` first), ``pos`` set to ``SMAX``
    before the last step; every all-reduce's size is recorded while the
    steps run."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import ctx
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.split import make_split
    from repro_torch.models.transformer import (encode, fill_cross_cache,
                                                init_cache)
    steps = x['steps']
    B = steps[0].shape[0]
    split = make_split(cfg, mesh, B)
    cache = init_cache(cfg, B, SMAX, device='cpu', split=split)
    if cfg.is_encdec:
        with torch.no_grad():
            enc = encode(cfg, blocks, split.batch_block(x['frames']), split)
            cache = fill_cross_cache(cfg, blocks, cache, enc, split)
    step = build_serve_step(cfg, device='cpu', mesh=mesh)
    sizes, reduce = [], dist.all_reduce

    def recorded(t, *args, **kwargs):
        sizes.append(t.numel())
        return reduce(t, *args, **kwargs)

    logits = []
    dist.all_reduce = recorded
    ctx.reset_collectives()
    try:
        for t, inp in enumerate(steps):
            if t == len(steps) - 1:
                cache['pos'] = torch.tensor(SMAX, dtype=torch.int32)
            out, cache = step(blocks, inp, cache)
            logits.append(out)
    finally:
        dist.all_reduce = reduce
    return {'coords': mesh.coords, 'batch_axes': split.batch_axes,
            'logits': torch.stack(logits), 'cache': cache,
            'sizes': sizes, 'counts': dict(ctx.COLLECTIVES)}


def decode(rank: int, world: int, out_dir) -> dict:
    """Reduced Yi-9B's teacher-forced decode over the model split on the
    mesh (:func:`_serve`)."""
    x, cfg, mesh, blocks = _family_setup(out_dir)
    return _serve(cfg, mesh, blocks, x)


def family(rank: int, world: int, out_dir) -> dict:
    """A family split on the mesh: the gathered logits, the prefill step,
    ``train_loss`` and its gradient, one ``build_train_step`` step, this
    rank's blocks of the HVP columns at the injected draw, the first
    layer's split self-attention of ``x['attn_in']`` (whole on every
    rank) and the decode (:func:`_serve`), on ``x['params']``; and the
    hypergradient (``lm_hypergrad`` through ``flat_sharded(split=True)``
    at the draw) and one ``build_hypergrad_step``, on the reference's
    init ``x['params_init']``."""
    import torch

    from repro_torch.convert import (model_indices_from_jax,
                                     model_params_from_jax)
    from repro_torch.core import HypergradConfig
    from repro_torch.core.hvp import extract_columns, make_hvp
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.steps import (build_hypergrad_step,
                                          build_prefill_step,
                                          build_train_step, domain_losses,
                                          lm_hypergrad, local_batch,
                                          loss_and_grads, make_optimizer,
                                          split_solver)
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rope_for
    from repro_torch.models.split import make_split
    from repro_torch.models.transformer import _used_slot, forward, train_loss
    x, cfg, mesh, blocks = _family_setup(out_dir)
    batch = x['batch']
    split = make_split(cfg, mesh, batch['labels'].shape[0])
    local = local_batch(batch, split, 'cpu')
    with torch.no_grad():
        logits, _ = forward(cfg, blocks, local['inputs'],
                            positions=local.get('positions'),
                            enc_inputs=local.get('enc_inputs'), split=split)
        logits = ctx.gather(logits, P(split.batch_axes or None, None,
                                      'model'), mesh)
        h = x['attn_in']
        sp = _used_slot(cfg, split, blocks['blocks'][0]['slot0'],
                        split.specs['blocks'][0]['slot0'])
        rope = rope_for(cfg, torch.from_numpy(x['attn_pos']))
        attn_out = attn.multihead_attention(sp['mixer'], h, cfg, rope=rope,
                                            split=split)
    prefill = build_prefill_step(cfg, device='cpu', mesh=mesh)(
        blocks, {k: v for k, v in batch.items()
                 if k in ('inputs', 'positions', 'enc_inputs')})
    loss, grads = loss_and_grads(
        lambda p, b: train_loss(cfg, p, b, split=split), blocks, local)
    new, _, _, metrics = build_train_step(cfg, mesh=mesh)(
        blocks, make_optimizer(cfg, split).init(blocks), 0, batch)
    h0 = {'domain_logits': torch.from_numpy(x['h0'])}
    idx = model_indices_from_jax(x['draw'], cfg)
    solver = split_solver(mesh, split.specs, HypergradConfig(
        k=K, rho=RHO, column_chunk=CHUNK))
    ib, ob = (local_batch(x[k], split, 'cpu') for k in ('inner', 'outer'))
    inner, outer = domain_losses(cfg, split)
    indexer = solver.backend.indexer(blocks)
    cols = extract_columns(make_hvp(inner, blocks, h0, ib), indexer,
                           indexer.check(idx), CHUNK)
    init = model_params_from_jax(x['params_init'], cfg, mesh=mesh)
    _, hg = lm_hypergrad(solver, inner, outer, init, h0, ib, ob,
                         indices=idx)
    new_h = build_hypergrad_step(cfg, k=K, rho=RHO, mesh=mesh)(
        init, h0, x['inner'], x['outer'], indices=idx)
    out = {'coords': mesh.coords, 'logits': logits, 'prefill': prefill,
           'attn': attn_out, 'loss': loss, 'grads': grads,
           'step': {'params': new, 'loss': metrics['loss'],
                    'grad_norm': metrics['grad_norm']},
           'columns': cols, 'hypergrad': hg['domain_logits'],
           'hg_step': new_h['domain_logits'],
           'serve': _serve(cfg, mesh, blocks, x)}
    if x.get('f64_apply'):
        # on x['params'] (seeded biases), the apply solved in f64
        _, hg64 = lm_hypergrad(f64_apply(solver), inner, outer, blocks, h0,
                               ib, ob, indices=idx)
        out['hypergrad_f64'] = hg64['domain_logits']
    return out


def f64_apply(solver):
    """``solver`` (a Nyström solver on ``flat_sharded(split=True)``) with
    its apply solved in f64 on its own f32 sketch: the rank's rows of C
    whitened by H_KK's eigenvectors (those above 1e-7·k of the largest
    eigenvalue, the reference's cut), BᵀB and Bᵀv summed over the mesh by
    the backend's weights (each parameter once), then the exact Woodbury
    solve of (H_k + ρI) u = v on the rank's rows. The same solve as the
    reference's ``_F64Apply`` in ``tests/test_torch_split_families.py``."""
    import dataclasses

    import torch

    class F64Apply(type(solver)):
        def apply(self, sketch, v):
            be = self._be()
            C, w = sketch.C.buf.double(), sketch.C.w.double()
            H = sketch.H_KK.double()
            lam, U = torch.linalg.eigh(0.5 * (H + H.T))
            keep = lam > 1e-7 * (lam.abs().max() + 1e-30) * len(lam)
            Bw = C @ (U[:, keep] / lam[keep].sqrt())
            vf = be.vec(v).double()
            M = be._psum(Bw.T @ (Bw * w[:, None])) + self.rho * torch.eye(
                Bw.shape[1], dtype=torch.float64)
            t = be._psum(Bw.T @ (vf * w))
            u = (vf - Bw @ torch.linalg.solve(M, t)) / self.rho
            return be.unvec(u.float(), v)

    return F64Apply(**{f.name: getattr(solver, f.name)
                       for f in dataclasses.fields(solver)})


def moe(rank: int, world: int, out_dir) -> dict:
    """A MoE family split on the mesh: :func:`family`'s results, and the
    replicas that the capacity path drops in the forward of the gathered
    logits, layer by layer on this rank's tokens (a ``moe_split`` that
    counts them under the port's routing)."""
    import torch

    import mesh_cases_moe
    from repro_torch.launch.steps import local_batch
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer
    from repro_torch.models.split import make_split
    x, cfg, mesh, blocks = _family_setup(out_dir)
    split = make_split(cfg, mesh, x['batch']['labels'].shape[0])
    local = local_batch(x['batch'], split, 'cpu')
    drops = []

    def counting(params, h, cfg_, split_):
        drops.append(mesh_cases_moe.port_drops(
            params, h.reshape(-1, h.shape[-1]), cfg_))
        return tmoe.moe_split(params, h, cfg_, split_)

    transformer.moe_split = counting
    try:
        with torch.no_grad():
            transformer.forward(cfg, blocks, local['inputs'], split=split)
    finally:
        transformer.moe_split = tmoe.moe_split
    out = family(rank, world, out_dir)
    out['drops'] = drops
    return out

