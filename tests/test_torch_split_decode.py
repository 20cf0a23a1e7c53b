"""Decode over a model split on a mesh of gloo ranks: reduced Yi-9B (4
heads, 2 KV heads, d 64, 2 layers) served by ``build_serve_step(mesh=)``
against the reference's unsplit ``decode_step`` on the same weights and
tokens, the reference running in the pytest process.

The KV cache's sequence (``SMAX`` = 16) is split over 'model'
(``cache_specs``): 12 teacher-forced steps from an empty cache cross the
blocks of two ranks on 1 × 2 and of three on 1 × 4, and a last step at
``pos = SMAX`` writes past the end (clamped onto the last entry of the last
rank's block, as the reference's ``dynamic_update_slice`` clamps). Meshes:
1 × 2, 2 × 2 with ``fsdp`` (the batch of 4 over 'data', every weight
gathered over 'data' on use), 1 × 4 (the 2 KV heads stay whole in the
weights; the cache holds every KV head of its block) and 2 × 2 at B = 1,
where the batch axes do not divide the batch and drop from every cache
spec.

Tolerances (f32): each step's gathered logits 1e-5 relative L2; the
final cache (each rank's block of the reference's) 1e-6 relative L2.
Each rank holds only its ``cache_specs`` block, and every all-reduce of a
step is a (B, ·) vector whose size does not grow with the cache: the
flash-decoding reduction moves (B, H) statistics and (B, H, hd) partial
outputs only.
"""
import numpy as np
import pytest

import mesh_cases_split as cases
import split_reference as SR
from repro_torch.distributed.sharding import P, local_shape, spec_leaves
from repro_torch.models.split import cache_split_specs
from torch_threads import torch_thread_cap  # noqa: F401

ARCH = 'yi_9b'
#: label: (mesh shape, fsdp, batch)
MESHES = {'1x2': ((1, 2), False, 4), '2x2_fsdp': ((2, 2), True, 4),
          '1x4': ((1, 4), False, 4), '2x2_b1': ((2, 2), False, 1)}
LABELS = sorted(MESHES)


def _cfg(fsdp: bool):
    return SR.family_configs(ARCH, {'fsdp': fsdp})


@pytest.fixture(scope='module')
def params():
    return SR.family_params(ARCH, {})


@pytest.fixture(scope='module')
def runs(tmp_path_factory, params):
    out = {}
    for label, (shape, fsdp, B) in MESHES.items():
        steps = SR.decode_inputs(_cfg(fsdp)[1], B, seed=B)
        out[label] = SR.run_family_ranks(
            tmp_path_factory, 'decode', label, arch=ARCH,
            over={'fsdp': fsdp}, shape=shape, params=params,
            steps=[SR.torch.from_numpy(s) for s in steps])
    return out


@pytest.fixture(scope='module')
def ref(params):
    jcfg = _cfg(False)[0]
    return {B: SR.reference_decode(jcfg, params, SR.decode_inputs(
        _cfg(False)[1], B, seed=B)) for B in (1, 4)}


def _specs(label, coords):
    shape, fsdp, B = MESHES[label]
    return cache_split_specs(_cfg(fsdp)[1], SR.mesh_at(shape, coords), B,
                             cases.SMAX)


@pytest.mark.parametrize('label', LABELS)
def test_each_steps_gathered_logits_match_the_reference(runs, ref, label):
    want = ref[MESHES[label][2]]['logits']
    for r in runs[label]:
        got = r['logits'].numpy()
        assert got.shape == want.shape
        for t in range(len(want)):
            assert SR.rel(got[t], want[t]) <= 1e-5, (t, r['coords'])


@pytest.mark.parametrize('label', LABELS)
def test_the_cache_is_the_references_block(runs, ref, label):
    shape, _, B = MESHES[label]
    want = ref[B]['cache']
    for r in runs[label]:
        specs = _specs(label, r['coords'])
        assert int(r['cache']['pos']) == cases.SMAX + 1
        for slot, sc in r['cache']['slots'].items():
            for n in ('k', 'v'):
                w = SR.cache_block(want['slots'][slot][n],
                                   specs['slots'][slot][n], shape,
                                   r['coords'])
                assert SR.rel(sc[n].numpy(), w) <= 1e-6, (slot, n)


@pytest.mark.parametrize('label', LABELS)
def test_each_rank_holds_only_its_cache_specs_block(runs, label):
    """The sequence over 'model' (a quarter on 1 × 4), the batch over
    'data' where it divides the batch."""
    shape, fsdp, B = MESHES[label]
    cfg = _cfg(fsdp)[1]
    for r in runs[label]:
        mesh = SR.mesh_at(shape, r['coords'])
        specs = _specs(label, r['coords'])
        k = r['cache']['slots']['slot0']['k']
        assert tuple(k.shape) == local_shape(
            (cfg.n_blocks, B, cases.SMAX, cfg.n_kv_heads, cfg.head_dim),
            specs['slots']['slot0']['k'], mesh)
        assert k.shape[2] == cases.SMAX // shape[1]
        assert k.shape[1] == (B // shape[0] if r['batch_axes'] else B)


def _used_weight_sizes(label, params, coords) -> set:
    """The sizes of the parameter blocks as FSDP's gather on use makes
    them: each leaf's block over 'model' only."""
    shape, fsdp, _ = MESHES[label]
    cfg = _cfg(fsdp)[1]
    mesh = SR.mesh_at(shape, coords)
    out = set()
    for leaf, spec in zip(SR.jax.tree.leaves(SR.port_whole(params, cfg)),
                          SR.specs_at(cfg, shape, coords)):
        only = P(*[e if e == 'model' else None for e in spec])
        out.add(int(np.prod(local_shape(tuple(leaf.shape), only, mesh))))
    return out


@pytest.mark.parametrize('label', LABELS)
def test_no_decode_collective_carries_a_cache_block(runs, params, label):
    """Every all-reduce of the steps (the embedding's and the FFN's sums,
    the new token's heads, the softmax statistics, the partial outputs,
    the logits) is a (B, ·) vector of at most B · max(V_padded,
    (H + 2·KV)·hd, d) entries, whatever the cache's length, or (under
    ``fsdp``) a weight's gather on use: none carries a block of the
    cache."""
    shape, fsdp, B = MESHES[label]
    cfg = _cfg(fsdp)[1]
    bound = B * max(cfg.padded_vocab, cfg.d_model,
                    (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim)
    for r in runs[label]:
        weights = (_used_weight_sizes(label, params, r['coords']) if fsdp
                   else set())
        big = [n for n in r['sizes'] if n > bound]
        assert r['sizes'] and set(big) <= weights, big
        assert {'pmax', 'psum', 'gather'} <= set(r['counts'])


def test_b1_drops_the_batch_axes(runs):
    """B = 1 on 2 × 2: the batch axes leave every cache spec (the
    reference's long-context rule) and every rank holds the one row."""
    for r in runs['2x2_b1']:
        assert r['batch_axes'] == ()
        specs = _specs('2x2_b1', r['coords'])
        for s in spec_leaves(specs):
            assert 'data' not in s, s
        assert specs['slots']['slot0']['k'][2] == 'model'
    other = _specs('2x2_fsdp', runs['2x2_fsdp'][0]['coords'])
    assert other['slots']['slot0']['k'][1] == 'data'
    assert np.all([r['cache']['slots']['slot0']['k'].shape[1] == 1
                   for r in runs['2x2_b1']])
