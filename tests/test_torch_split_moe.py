"""The MoE family split on a mesh of gloo ranks, against the reference's
unsplit functions on the same weights and batches (the reference running
in the pytest process), f32 at ``reduced()`` size:

  * Phi-3.5-MoE (4 experts, top-2) on 2 × 2 with FSDP: each data shard's
    tokens routed with its own capacity, the expert blocks
    ``P(None, 'data', 'model')`` gathered over 'data' on dim 1;
  * Llama-4 Maverick with 6 heads over 2 KV heads on 1 × 4: the heads
    padded per KV group, dense and MoE layers alternating, a shared
    expert, top-1.

The reference's whole forward cannot run under a mesh with jax 0.9.0
(``constrain``), so its ``moe_ffn`` is replaced by
``split_reference.capacity_moe``: the reference's own
``_moe_local(impl='capacity')`` on each batch shard's tokens, joined, the
aux statistics averaged over the shards, which is what its ``shard_map``
body computes. ``test_oracle_is_the_references_moe_ffn_under_its_mesh``
pins that helper to the reference's ``moe_ffn`` under its 4-device host
mesh (1e-5). The embeddings and routers are skewed toward expert 0
(``split_reference.moe_skew``) so that replicas drop in the forward: the
drops the port's routing counts on each rank's tokens are positive and
the oracle's, shard by shard.

Tolerances: the gathered logits, the prefill step and ``train_loss`` 1e-5
relative; every gradient leaf (each rank's block of the reference's) 1e-4
relative L2, except top-1 Maverick's routers, held with both packages to
the aux loss's own gradient within 5e-3 (``test_torch_moe_capacity.py``'s
rule: the gate g/g carries only rounding noise); one Phi train step 1e-5
on the loss and the norm and 1e-4 on each block; the HVP columns 1e-4;
the hypergradient (k = 4 through ``flat_sharded(split=True)``) 1e-4 and
one ``build_hypergrad_step`` 1e-5, on the init; each decode step's
gathered logits 1e-5 (12 teacher-forced steps across the cache's blocks,
then one past its end).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_cases_moe
import mesh_cases_split as cases
import split_reference as SR
import torch_mesh
import torch_train_reference as TR
from repro.core.hvp import extract_columns as jextract_columns
from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.launch.train import build_losses
from repro.models import moe as jmoe
from repro.models.transformer import forward as jforward
from repro.models.transformer import train_loss as jtrain_loss
from repro_torch.configs import get_config
from repro_torch.convert import to_torch
from repro_torch.core.tree_util import (tree_flatten_with_path,
                                       tree_leaves)
from repro_torch.launch.steps import (N_DOMAINS, build_prefill_step,
                                      build_serve_step, build_train_step)
from repro_torch.models.split import (cache_split_specs, check_splittable,
                                      head_layout, split_specs)
from torch_threads import torch_thread_cap  # noqa: F401

PHI, MAVERICK = 'phi35_moe_42b_a66b', 'llama4_maverick_400b_a17b'
#: label: (arch, reduced() overrides, mesh shape)
FAMILIES = {PHI: (PHI, {'fsdp': True}, (2, 2)),
            'maverick_padded': (MAVERICK, {'n_heads': 6, 'n_kv_heads': 2},
                                (1, 4))}
LABELS = sorted(FAMILIES)
B, S, DECODE_B = 4, 16, 2
KEY = 7                            # the reference hypergradient step's key


def _batch(arch, seed, domain=False):
    b = TR.numpy_batch(arch, seed, batch=B, seq=S, domain=domain)
    return {k: jnp.asarray(v) for k, v in b.items()}, to_torch(b)


def _inputs(label) -> dict:
    arch, over, shape = FAMILIES[label]
    jcfg, cfg = SR.family_configs(arch, over)
    r = np.random.RandomState(3)
    x = {'arch': arch, 'over': over, 'shape': shape, 'jcfg': jcfg,
         'cfg': cfg,
         'params_init': SR.family_params(arch, over, biases=False),
         'batch': _batch(arch, 1), 'inner': _batch(arch, 4, True),
         'outer': _batch(arch, 5, True),
         'h0': (0.1 * r.randn(N_DOMAINS)).astype(np.float32),
         'attn_in': r.randn(B, S, cfg.d_model).astype(np.float32),
         'attn_pos': np.ascontiguousarray(np.broadcast_to(
             np.arange(S, dtype=np.int32), (B, S))),
         'steps': SR.decode_inputs(cfg, DECODE_B, seed=6)}
    x['params'] = SR.moe_skew(x['params_init'], cfg.d_model)
    x['draw'] = jax.tree.map(np.asarray, JIndexer(jax.tree.map(
        jnp.asarray, x['params'])).sample_indices(jax.random.PRNGKey(KEY),
                                                  cases.K))
    return x


@pytest.fixture(scope='module')
def inputs():
    return {label: _inputs(label) for label in LABELS}


@pytest.fixture(scope='module')
def started(tmp_path_factory, inputs):
    """Every family's ranks, and the reference's ``moe_ffn`` under its
    4-device host mesh (``mesh_cases_moe.reference``), started together;
    the reference runs in this process meanwhile (:func:`ref`)."""
    out = {}
    for label, x in inputs.items():
        ranks = {k: x[k] for k in ('arch', 'over', 'shape', 'params',
                                   'params_init', 'h0', 'attn_pos', 'draw')}
        ranks.update(batch=x['batch'][1], inner=x['inner'][1],
                     outer=x['outer'][1],
                     attn_in=torch.from_numpy(x['attn_in']),
                     steps=[torch.from_numpy(s) for s in x['steps']])
        out[label] = SR.start_family_ranks(tmp_path_factory, 'moe', label,
                                           **ranks)
    tmp = tmp_path_factory.mktemp('moe_ffn_mesh')
    out['pin'] = ([torch_mesh.start_reference('mesh_cases_moe', 'reference',
                                              tmp)], tmp)
    return out


@pytest.fixture(scope='module')
def runs(started, ref):
    return {label: SR.family_results(started[label]) for label in LABELS}


@pytest.fixture(scope='module')
def pinned(started, ref):
    procs, tmp = started['pin']
    torch_mesh.join(procs, 300)
    with np.load(tmp / 'reference.npz') as z:
        return {k: z[k] for k in z.files}


def _reference(x) -> dict:
    """The reference's side of one family, its ``moe_ffn`` replaced by
    ``capacity_moe``: each program compiled once, taking the gate's hold
    as an argument (0: the whole gradient, 1: a top-1 router's aux-held
    one, ``_blocks_close``) and the parameters (the skewed ones, and the
    init for the hypergradient)."""
    jcfg, cfg, shards = x['jcfg'], x['cfg'], x['shape'][0]
    jp = jax.tree.map(jnp.asarray, x['params'])
    init = jax.tree.map(jnp.asarray, x['params_init'])
    jb = x['batch'][0]
    phi = {'domain_logits': jnp.asarray(x['h0'])}
    draw = jax.tree.map(jnp.asarray, x['draw'])
    inner = build_losses(jcfg)[0]

    def patched(hold=0.0, record=False):
        return mock.patch.object(jmoe, 'moe_ffn',
                                 SR.capacity_moe(shards, hold, record))

    @jax.jit
    def grads(p, hold):
        with patched(hold):
            return jax.value_and_grad(lambda q: jtrain_loss(jcfg, q, jb))(p)

    @jax.jit
    def columns(p, hold):
        with patched(hold):
            return jextract_columns(jmake_hvp(inner, p, phi, x['inner'][0]),
                                    JIndexer(p), draw, cases.CHUNK)

    out = {}
    SR.DROPS.clear()
    with patched(record=True):
        out['logits'] = np.asarray(jax.jit(lambda p: jforward(
            jcfg, p, jb['inputs'])[0])(jp))
    jax.effects_barrier()
    out['drops'] = list(SR.DROPS)
    loss, g = grads(jp, 0.0)
    out.update(loss=float(loss), grads=SR.port_whole(g, cfg),
               columns=SR.port_columns(columns(jp, 0.0), cfg))
    with patched():
        if cfg.top_k > 1:
            new, _, _, metrics = jax.jit(jbuild_train_step(
                jcfg, jmake_host_mesh(), B, S).fn)(
                jp, jmake_optimizer(jcfg).init(jp), jnp.int32(0), jb)
            out.update(step=SR.port_whole(new, cfg),
                       step_loss=float(metrics['loss']),
                       grad_norm=float(metrics['grad_norm']))
        # Eq. 3 from the reference's pieces on the init (the sketch of its
        # own columns at the reference step's draw)
        hg = TR.eq3(jcfg, init, x['h0'], x['inner'][0], x['outer'][0],
                    x['draw'], cases.K, cases.RHO, cases.CHUNK,
                    columns=columns(init, 0.0))
        out.update(g=hg, h=x['h0'] - 1e-2 * hg)
        out['decode'] = SR.reference_decode(jcfg, x['params'], x['steps'])
    if cfg.top_k == 1:
        out.update(held_grads=SR.port_whole(grads(jp, 1.0)[1], cfg),
                   held_columns=SR.port_columns(columns(jp, 1.0), cfg))
    return out


@pytest.fixture(scope='module')
def ref(inputs):
    return {label: _reference(x) for label, x in inputs.items()}


def _blocks_close(got, ref_label, key, cfg, shape, coords,
                  lead: int = 0) -> None:
    """Every leaf of a rank's blocks of ``ref_label[key]`` (``'grads'`` or
    ``'columns'``) against its block of the reference's (1e-4). With a
    top-1 router, the routers' leaves are held, with the reference's own,
    to the aux-held reference's (``'held_' + key``): within 5e-3 of it, or,
    where it is exactly 0 (HVP columns drawn where no mixed term with the
    router's aux exists), within 1e-4 of the rank's whole held blocks."""
    held_key = 'held_' + key
    if held_key not in ref_label:
        SR.assert_blocks_close(got, ref_label[key], cfg, shape, coords, 1e-4,
                               lead)
        return
    pairs = tree_flatten_with_path(ref_label[key])[0]
    got_l = tree_leaves(got)
    specs = SR.specs_at(cfg, shape, coords)
    held_l = [SR.block_of(t, sp, shape, coords, lead).double().numpy()
              for t, sp in zip(tree_leaves(ref_label[held_key]), specs)]
    assert len(got_l) == len(pairs) == len(held_l) == len(specs)
    total = np.sqrt(sum(np.sum(h ** 2) for h in held_l))
    for (path, w), g, h, sp in zip(pairs, got_l, held_l, specs):
        g = g.detach().double().numpy()
        w = SR.block_of(w, sp, shape, coords, lead).double().numpy()
        assert g.shape == w.shape == h.shape, (path, g.shape, w.shape)
        if path[-1] == 'router':
            tol = 5e-3 * np.linalg.norm(h) if np.any(h) else 1e-4 * total
            for side in (g, w):
                assert np.linalg.norm(side - h) <= tol, (
                    path, np.linalg.norm(side - h), tol)
        elif not np.any(w):
            assert not np.any(g), path
        else:
            assert SR.rel(g, w) <= 1e-4, (path, SR.rel(g, w))


@pytest.mark.parametrize('label', LABELS)
def test_gathered_logits_match_the_reference(runs, ref, label):
    for r in runs[label]:
        assert SR.rel(r['logits'].numpy(), ref[label]['logits']) <= 1e-5


@pytest.mark.parametrize('label', LABELS)
def test_replicas_drop_as_the_references_shard_by_shard(runs, ref, inputs,
                                                        label):
    """The replicas over capacity in the forward, layer by layer: each
    rank counts its tokens' (the ranks of a data shard agree), and the
    data shards' counts are the oracle's, positive in all."""
    data = FAMILIES[label][2][0]
    want = ref[label]['drops']
    layers = inputs[label]['cfg'].n_layers // inputs[label]['cfg'].moe_every
    assert len(want) == layers * data and sum(want) > 0
    by_shard = {}
    for r in runs[label]:
        by_shard.setdefault(r['coords']['data'], []).append(r['drops'])
    assert sorted(by_shard) == list(range(data))
    for shard, counts in by_shard.items():
        assert all(c == counts[0] for c in counts), (shard, counts)
        assert counts[0] == want[shard::data], (shard, counts[0], want)


@pytest.mark.parametrize('label', LABELS)
def test_prefill_step_matches_the_reference(runs, ref, label):
    want = ref[label]['logits'][:, -1]
    for r in runs[label]:
        assert r['prefill'].shape == want.shape
        assert SR.rel(r['prefill'].numpy(), want) <= 1e-5


@pytest.mark.parametrize('label', LABELS)
def test_every_gradient_leaf_is_the_references_block(runs, ref, inputs,
                                                     label):
    """No cotangent counted twice: the router (model-invariant, gathered
    over 'data' under FSDP), the experts' and the shared expert's blocks
    each match the reference's, with no factor of 2 or 4."""
    cfg, shape = inputs[label]['cfg'], FAMILIES[label][2]
    for r in runs[label]:
        assert abs(float(r['loss']) / ref[label]['loss'] - 1) <= 1e-5
        _blocks_close(r['grads'], ref[label], 'grads', cfg, shape,
                      r['coords'])


def test_one_train_step_matches_the_reference_step(runs, ref, inputs):
    cfg, shape = inputs[PHI]['cfg'], FAMILIES[PHI][2]
    want = ref[PHI]
    for r in runs[PHI]:
        assert abs(float(r['step']['loss']) / want['step_loss'] - 1) <= 1e-5
        assert abs(float(r['step']['grad_norm']) / want['grad_norm']
                   - 1) <= 1e-5
        SR.assert_blocks_close(r['step']['params'], want['step'], cfg, shape,
                               r['coords'], 1e-4)


@pytest.mark.parametrize('label', LABELS)
def test_hvp_columns_are_the_references_blocks(runs, ref, inputs, label):
    """Each rank's blocks of the HVP columns at the draw under
    ``vmap(jvp(grad))``, through the capacity path and the collectives."""
    cfg, shape = inputs[label]['cfg'], FAMILIES[label][2]
    for r in runs[label]:
        _blocks_close(r['columns'], ref[label], 'columns', cfg, shape,
                      r['coords'], lead=1)


@pytest.mark.parametrize('label', LABELS)
def test_hypergradient_matches_the_references(runs, ref, label):
    """``lm_hypergrad`` through ``flat_sharded(split=True)`` over the
    blocks (Phi's expert leaves 3-d, split on dims 1 and 2), and one
    ``build_hypergrad_step(mesh=)``, at the reference step's draw, on the
    init."""
    for r in runs[label]:
        assert SR.rel(r['hypergrad'].numpy(), ref[label]['g']) <= 1e-4
        assert SR.rel(r['hg_step'].numpy(), ref[label]['h']) <= 1e-5


@pytest.mark.parametrize('label', LABELS)
def test_decode_matches_the_reference(runs, ref, label):
    want = ref[label]['decode']['logits']
    for r in runs[label]:
        got = r['serve']['logits'].numpy()
        assert got.shape == want.shape
        for t in range(len(want)):
            assert SR.rel(got[t], want[t]) <= 1e-5, t


@pytest.mark.parametrize('arch', mesh_cases_moe.ARCHS)
def test_oracle_is_the_references_moe_ffn_under_its_mesh(pinned, arch):
    """``capacity_moe`` on 2 data shards against the reference's own
    ``moe_ffn`` under its 2 × 2 host mesh (``tests/mesh_cases_moe.py``'s
    inputs, router skewed so that replicas drop): the output, the aux
    loss and every gradient at 1e-5; top-1 Maverick's router with both
    held to the aux-held gradient (5e-3)."""
    cfg = mesh_cases_moe.config(arch, jax_side=True)
    x = mesh_cases_moe.inputs(arch)
    cot = jnp.asarray(x['cot'])

    def grads(helper):
        def f(p, xs):
            y, aux = helper(p, xs, cfg)
            return jnp.sum(y * cot) + aux, (y, aux)
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, x['params']), jnp.asarray(x['x']))

    (_, (y, aux)), g = grads(SR.capacity_moe(2))
    assert SR.rel(y, pinned[f'{arch}/y']) <= 1e-5
    assert abs(float(aux) - float(pinned[f'{arch}/aux'])) <= 1e-6
    g = jax.tree.leaves(g)
    want = [pinned[f'{arch}/grad/{i}'] for i in range(len(g))]
    held = jax.tree.leaves(grads(SR.capacity_moe(2, hold=1.0))[1])
    for i, (a, w) in enumerate(zip(g, want)):
        if i == 0 and cfg.top_k == 1:              # the router's
            assert SR.rel(a, held[0]) <= 5e-3
            assert SR.rel(w, held[0]) <= 5e-3
        else:
            assert SR.rel(a, w) <= 1e-5, i


@pytest.mark.parametrize('model', [2, 4, 8, 16])
@pytest.mark.parametrize('arch', [PHI, MAVERICK])
def test_moe_configs_split_on_model(arch, model):
    """Phi-3.5-MoE and Maverick split on 'model' axes of 2 to 16: the
    experts' d_ff over 'model', the router replicated, Maverick's 40 heads
    padded to 48 on 16; the serve step and its cache build."""
    cfg = get_config(arch)
    mesh = SR.mesh_at((1, model), {'data': 0, 'model': 0})
    check_splittable(cfg, mesh)
    ffn = split_specs(cfg, mesh)['blocks'][0][
        f'slot{cfg.moe_every - 1}']['ffn']
    assert tuple(ffn['router']) == (None, None)
    assert tuple(ffn['w1']) == (None, None, 'model')
    assert tuple(ffn['w2']) == (None, 'model', None)
    lay = head_layout(cfg.n_heads, cfg.n_kv_heads, model, 0)
    assert lay.n_local * model == (48 if (arch, model) == (MAVERICK, 16)
                                   else cfg.n_heads)
    assert callable(build_serve_step(cfg, device='cpu', mesh=mesh))
    assert cache_split_specs(cfg, mesh, 8, 4096)['slots']['slot0']['k'][2] \
        == 'model'


def test_moe_experts_split_on_both_axes_under_fsdp():
    """Under FSDP on 2 × 2 the router is ``P('data', None)``, the experts'
    ``w1`` ``P(None, 'data', 'model')`` and ``w2`` ``P(None, 'model',
    'data')``, the shared expert's as a dense FFN's: the leaves that
    ``flat_sharded(split=True)`` fuses on dims 1 and 2."""
    cfg = get_config(MAVERICK).reduced(fsdp=True)
    ffn = split_specs(cfg, SR.mesh_at((2, 2), {'data': 0, 'model': 0}))[
        'blocks'][0]['slot1']['ffn']
    assert tuple(ffn['router']) == ('data', None)
    assert tuple(ffn['w1']) == (None, 'data', 'model')
    assert tuple(ffn['w2']) == (None, 'model', 'data')
    assert tuple(ffn['shared']['w1']) == ('data', 'model')


class _Mesh:
    """A stand-in mesh for the step builders and a one-rank split (no
    process group)."""
    axis_names = ('data', 'model')
    coords = {'data': 0, 'model': 0}

    def __init__(self, data: int = 2, model: int = 2):
        self.shape = {'data': data, 'model': model}
        self.devices = np.arange(data * model).reshape(data, model)

    def axes_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))


def test_maverick_split_training_names_adafactor():
    """Above 100B parameters the optimizer is Adafactor: Maverick's split
    train step raises, naming it; its prefill splits."""
    cfg = get_config(MAVERICK)
    mesh = _Mesh()
    with pytest.raises(NotImplementedError, match='Adafactor'):
        build_train_step(cfg, mesh=mesh)
    assert callable(build_prefill_step(cfg, device='cpu', mesh=mesh))


@pytest.mark.parametrize('arch', [PHI, MAVERICK])
def test_split_moe_runs_neither_moe_ffn_nor_ragged_nor_syncs(monkeypatch,
                                                            arch):
    """Under a ``Split`` (one rank, whole blocks) every MoE layer runs
    ``moe_split``'s capacity path: ``moe_ffn`` and ``_grouped`` (the
    ragged path) raise if reached, and inside the layer nothing reads a
    tensor on the host (``tolist``, ``item``, ``bool``, ``int``,
    ``float``)."""
    from repro_torch.models import build_model, transformer
    from repro_torch.models import moe as tmoe
    from repro_torch.models.split import make_split
    cfg = get_config(arch).reduced()
    mesh = _Mesh(1, 1)
    params = build_model(cfg, device='cpu').init(
        torch.Generator().manual_seed(0))
    split = make_split(cfg, mesh, 2)
    inside, calls = [], []

    def refused(name):
        def fn(*args, **kwargs):
            raise AssertionError(f'{name} reached under a Split')
        return fn

    def host(name, real):
        def fn(self, *args, **kwargs):
            if inside:
                raise AssertionError(f'{name} inside the split MoE layer')
            return real(self, *args, **kwargs)
        return fn

    def split_layer(*args, **kwargs):
        inside.append(True)
        try:
            calls.append(1)
            return tmoe.moe_split(*args, **kwargs)
        finally:
            inside.pop()

    for name in ('tolist', 'item', '__bool__', '__int__', '__float__'):
        monkeypatch.setattr(torch.Tensor, name,
                            host(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(transformer, 'moe_ffn', refused('moe_ffn'))
    monkeypatch.setattr(tmoe, 'moe_ffn', refused('moe_ffn'))
    monkeypatch.setattr(tmoe, '_grouped', refused('the ragged path'))
    monkeypatch.setattr(transformer, 'moe_split', split_layer)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    logits, aux = transformer.forward(cfg, params, tokens, split=split)
    assert len(calls) == cfg.n_layers // cfg.moe_every
    assert logits.shape == (2, 8, cfg.padded_vocab) and aux.ndim == 0
