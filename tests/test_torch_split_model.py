"""Reduced Yi-9B (4 heads, 2 KV heads, d 64, vocab 256, 2 layers) split
on a mesh of gloo ranks, against the reference's unsplit functions on the
same weights and batch: on 1 × 2 (heads, FFN columns and vocab over
'model'), 2 × 2 with ``fsdp`` (every weight also over 'data', the batch
split over 'data') and 1 × 4 (the 2 KV heads stay whole: each rank reads
the one its q head needs).

Tolerances (f32): the gathered logits and the prefill step's 1e-5
relative L2, ``train_loss`` 1e-5 relative, every gradient leaf (each
rank's block of the reference's) 1e-4 relative L2; one
``build_train_step`` step against the reference step's body: loss and
gradient norm 1e-5 relative, every parameter block after AdamW 1e-4. The
data shards' masks differ, so that a mean of the shards' means would miss
(checked). Also: each rank holds only its ``param_specs`` blocks, and the
families the slice does not split (MoE, Mamba, RWKV-6) raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_cases_split as cases
import split_reference as SR
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.steps import build_prefill_step as jbuild_prefill_step
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.models.transformer import forward as jforward
from repro.models.transformer import train_loss as jtrain_loss
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import local_shape, param_specs
from repro_torch.core import HypergradConfig
from repro_torch.launch.steps import (build_hypergrad_step,
                                      build_serve_step, build_train_step,
                                      make_optimizer, split_solver)
from repro_torch.models.split import check_splittable, split_specs
from torch_threads import torch_thread_cap  # noqa: F401

SHAPES = sorted(cases.SHAPES)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    return {label: SR.run_ranks(tmp_path_factory, 'model', label, *spec)
            for label, spec in cases.SHAPES.items()}


@pytest.fixture(scope='module')
def ref():
    jcfg, cfg = SR.configs()
    jp = jax.tree.map(jnp.asarray, SR.R.reference_params())
    b = SR.batch(1)
    jb = {k: jnp.asarray(v) for k, v in b.items() if k != 'domain'}
    logits = np.asarray(jax.jit(lambda p, x: jforward(jcfg, p, x)[0])(
        jp, jb['inputs']))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtrain_loss(jcfg, p, bb)))(jp, jb)
    mesh = jmake_host_mesh()
    prefill = np.asarray(jax.jit(jbuild_prefill_step(
        jcfg, mesh, cases.B, cases.S).fn)(jp, {'inputs': jb['inputs']}))
    step = jax.jit(jbuild_train_step(jcfg, mesh, cases.B, cases.S).fn)
    new, _, _, metrics = step(jp, jmake_optimizer(jcfg).init(jp),
                              jnp.int32(0), jb)
    # the mean of the data shards' means (what a split must not compute)
    shard_means = []
    for r in range(2):
        rows = slice(r * cases.B // 2, (r + 1) * cases.B // 2)
        shard_means.append(float(jtrain_loss(
            jcfg, jp, {k: v[rows] for k, v in jb.items()})))
    return {'logits': logits, 'loss': float(loss),
            'grads': SR.port_whole(grads, cfg), 'prefill': prefill,
            'step': SR.port_whole(new, cfg),
            'step_loss': float(metrics['loss']),
            'grad_norm': float(metrics['grad_norm']),
            'mean_of_means': float(np.mean(shard_means))}


def _fsdp(label):
    return cases.SHAPES[label][1]


@pytest.mark.parametrize('label', SHAPES)
def test_each_rank_holds_only_its_param_specs_blocks(runs, label):
    ranks, x = runs[label]
    shape, fsdp = cases.SHAPES[label]
    cfg = SR.configs(fsdp)[1]
    whole = [tuple(t.shape) for t in
             jax.tree.leaves(SR.port_whole(SR.R.reference_params(), cfg))]
    n_whole = sum(int(np.prod(s)) for s in whole)
    for r in ranks:
        specs = SR.specs_at(cfg, shape, r['coords'])
        want = [local_shape(s, sp, SR.mesh_at(shape, r['coords']))
                for s, sp in zip(whole, specs)]
        assert r['shapes'] == want
        held = sum(int(np.prod(s)) for s in r['shapes'])
        # a 1/n share, plus the norms (and 1 x 4's KV weights) held whole
        assert held < n_whole * (0.55 if shape == (1, 2) else 0.35)
        assert r['step']['moment_shapes'] == want + want
    if fsdp:   # every weight matrix is split over both axes
        mesh = SR.mesh_at(shape, ranks[0]['coords'])
        for spec in jax.tree.leaves(
                param_specs(cfg, mesh)['blocks'][0],
                is_leaf=lambda s: isinstance(s, tuple)):
            if len(spec) == 2 and spec != (None,):
                assert set(spec) == {'data', 'model'}, spec


@pytest.mark.parametrize('label', SHAPES)
def test_gathered_logits_match_the_reference(runs, ref, label):
    for r in runs[label][0]:
        assert SR.rel(r['logits'].numpy(), ref['logits']) <= 1e-5


@pytest.mark.parametrize('label', SHAPES)
def test_prefill_step_matches_the_reference(runs, ref, label):
    for r in runs[label][0]:
        assert r['prefill'].shape == ref['prefill'].shape
        assert SR.rel(r['prefill'].numpy(), ref['prefill']) <= 1e-5


@pytest.mark.parametrize('label', SHAPES)
def test_train_loss_is_the_whole_batch_masked_mean(runs, ref, label):
    """Every rank holds the whole batch's loss; where the batch is split
    the mean of the shards' means is off by far more than the gate."""
    for r in runs[label][0]:
        assert abs(float(r['loss']) / ref['loss'] - 1) <= 1e-5
    assert abs(ref['mean_of_means'] / ref['loss'] - 1) > 1e-3


@pytest.mark.parametrize('label', SHAPES)
def test_every_gradient_leaf_is_the_references_block(runs, ref, label):
    ranks, _ = runs[label]
    shape, fsdp = cases.SHAPES[label]
    cfg = SR.configs(fsdp)[1]
    for r in ranks:
        SR.assert_blocks_close(r['grads'], ref['grads'], cfg, shape,
                               r['coords'], 1e-4)


@pytest.mark.parametrize('label', SHAPES)
def test_one_train_step_matches_the_reference_step(runs, ref, label):
    ranks, _ = runs[label]
    shape, fsdp = cases.SHAPES[label]
    cfg = SR.configs(fsdp)[1]
    for r in ranks:
        assert r['step']['next'] == 1
        assert abs(float(r['step']['loss']) / ref['step_loss'] - 1) <= 1e-5
        assert abs(float(r['step']['grad_norm']) / ref['grad_norm']
                   - 1) <= 1e-5
        SR.assert_blocks_close(r['step']['params'], ref['step'], cfg, shape,
                               r['coords'], 1e-4)


class _Mesh:
    """A stand-in mesh for the rules (no process group)."""

    def __init__(self, data, model):
        self.axis_names = ('data', 'model')
        self.shape = {'data': data, 'model': model}
        self.devices = np.arange(data * model).reshape(data, model)
        self.coords = {'data': 0, 'model': 0}

    def axes_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))


@pytest.mark.parametrize('arch,model', [
    ('jamba_v01_52b', 4), ('jamba_v01_52b', 2), ('rwkv6_1b6', 2),
    ('rwkv6_1b6', 8), ('jamba_v01_52b', 8), ('rwkv6_1b6', 4)])
def test_families_the_slice_does_not_split_raise(arch, model):
    """Mamba (Jamba, whose MoE layers split) and RWKV-6 name ROADMAP item
    12, on 'model' axes of 2 to 8."""
    cfg = get_config(arch)
    with pytest.raises(NotImplementedError, match='item 12'):
        check_splittable(cfg, _Mesh(1, model))
    with pytest.raises(NotImplementedError, match='item 12'):
        build_hypergrad_step(cfg, mesh=_Mesh(1, model))


def test_adafactor_and_decode_on_a_split_model_raise():
    """Above 100B parameters the optimizer is Adafactor, which a split
    model refuses; decode over a split Jamba (its Mamba layers) is not
    ported."""
    with pytest.raises(NotImplementedError, match='Adafactor'):
        build_train_step(get_config('mistral_large_123b'), mesh=_Mesh(2, 2))
    with pytest.raises(NotImplementedError, match='item 12'):
        build_serve_step(get_config('jamba_v01_52b'), device='cpu',
                         mesh=_Mesh(1, 2))


def test_a_split_model_refuses_what_it_would_drop():
    """Over a split model the solver is Nyström on 'flat_sharded' over the
    blocks and the optimizer clips by the whole norm: another backend or
    solver, mesh/param_specs on the config, a caller's optimizer, or k/rho
    beside a config raise instead of being replaced or ignored."""
    cfg, mesh = get_config('yi_9b').reduced(), _Mesh(1, 2)
    specs = split_specs(cfg, mesh)
    for bad, err in ((dict(backend='cuda'), ValueError),
                     (dict(backend='flat'), ValueError),
                     (dict(mesh=mesh), ValueError),
                     (dict(solver='cg'), NotImplementedError)):
        with pytest.raises(err):
            split_solver(mesh, specs, HypergradConfig(**bad))
    with pytest.raises(ValueError, match='optimizer'):
        build_train_step(cfg, optimizer=make_optimizer(cfg), mesh=mesh)
    with pytest.raises(ValueError, match='shorthand'):
        build_hypergrad_step(cfg, k=4, hg_cfg=HypergradConfig(k=4))


def test_split_solver_takes_the_configs_sketch_dtype():
    cfg, mesh = get_config('yi_9b').reduced(), _Mesh(1, 2)
    solver = split_solver(mesh, split_specs(cfg, mesh), HypergradConfig(
        k=4, rho=0.5, sketch_dtype='bfloat16', column_chunk=2))
    be = solver.backend
    assert (solver.k, solver.rho, solver.column_chunk) == (4, 0.5, 2)
    assert be.split and be.mesh is mesh
    assert be.sketch_dtype == torch.bfloat16


def test_dense_configs_split_at_full_width():
    """Yi-9B on model = 4 and 8 (KV whole at 8), Llama-3 405B on 16."""
    for arch, model in (('yi_9b', 4), ('yi_9b', 8), ('llama3_405b', 16)):
        specs = split_specs(get_config(arch), _Mesh(1, model))
        assert specs['unembed']['table'][0] == 'model'
