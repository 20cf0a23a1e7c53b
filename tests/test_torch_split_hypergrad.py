"""HVP columns and the hypergradient of reduced Yi-9B split on a mesh of
gloo ranks (1 × 2, 2 × 2 with ``fsdp``, 1 × 4 with the KV heads whole),
against the reference's unsplit pieces on the same weights, batches and
column draw (k = 4 at an injected draw, ``column_chunk=2``, ρ = 1e-2).

Every column passes through the model's collectives: ``vmap(jvp(grad))``
runs through the split model, and each rank computes only its blocks of
each column (the draw is over the whole leaves, in JAX's order, the same
on every rank). Tolerances: each rank's block of each column within 1e-4
relative L2 of the reference's ``extract_columns``; the hypergradient
(``lm_hypergrad`` through ``flat_sharded`` over the blocks) within 1e-4 of
Eq. 3 from the reference's pieces, and one ``build_hypergrad_step``
within 1e-5 of ``h − 1e-2·g`` there. An apply hands back this rank's
blocks with no gather: its only collectives are the k-output passes'
``psum``s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mesh_cases_split as cases
import split_reference as SR
import torch_train_reference as TR
from repro.core.hvp import extract_columns as jextract_columns
from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.launch.train import build_losses
from torch_threads import torch_thread_cap  # noqa: F401

SHAPES = sorted(cases.SHAPES)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    return {label: SR.run_ranks(tmp_path_factory, 'hypergrad', label, *spec)
            for label, spec in cases.SHAPES.items()}


@pytest.fixture(scope='module')
def ref(runs):
    x = next(iter(runs.values()))[1]
    jcfg, cfg = SR.configs()
    jp = jax.tree.map(jnp.asarray, x['params'])
    h = jnp.asarray(x['h0'])
    jib = {k: jnp.asarray(v) for k, v in x['batch'].items()}
    job = {k: jnp.asarray(v) for k, v in x['outer'].items()}
    draw = jax.tree.map(jnp.asarray, x['draw'])
    inner, _ = build_losses(jcfg)
    hvp = jmake_hvp(inner, jp, {'domain_logits': h}, jib)
    cols = jax.jit(lambda: jextract_columns(hvp, JIndexer(jp), draw,
                                            cases.CHUNK))()
    g = TR.eq3(jcfg, jp, x['h0'], jib, job, draw, cases.K, cases.RHO,
               cases.CHUNK)
    return {'columns': TR.port_columns(cols, cfg), 'eq3': g, 'h0': x['h0'],
            'p': int(sum(np.prod(a.shape) for a in jax.tree.leaves(jp)))}


@pytest.mark.parametrize('label', SHAPES)
def test_hvp_columns_are_the_references_blocks(runs, ref, label):
    ranks, _ = runs[label]
    shape, fsdp = cases.SHAPES[label]
    cfg = SR.configs(fsdp)[1]
    for r in ranks:
        SR.assert_blocks_close(r['columns'], ref['columns'], cfg, shape,
                               r['coords'], 1e-4, lead=1)


@pytest.mark.parametrize('label', SHAPES)
def test_hypergradient_matches_eq3_from_the_references_pieces(runs, ref,
                                                               label):
    for r in runs[label][0]:
        assert SR.rel(r['hypergrad'].numpy(), ref['eq3']) <= 1e-4
        want = ref['h0'] - 1e-2 * ref['eq3']
        assert SR.rel(r['step'].numpy(), want) <= 1e-5


@pytest.mark.parametrize('label', SHAPES)
def test_apply_hands_back_blocks_with_no_gather(runs, ref, label):
    """u comes back in the blocks' shapes; an apply's collectives are its
    k-output passes' psums only (no 'gather' of whole leaves), and the
    sketch's rows are this rank's p_local of the whole model's p."""
    for r in runs[label][0]:
        assert r['u_shapes'] == r['shapes']
        assert r['apply_counts'].get('gather', 0) == 0
        assert set(r['apply_counts']) == {'psum'}
        assert r['total'] == ref['p']
        assert r['p_local'] == sum(int(np.prod(s)) for s in r['shapes'])
