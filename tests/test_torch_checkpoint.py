"""The port's checkpoints and parameter digest against the reference's.

``params_digest`` must give the reference's string for the same numpy
values (it keys the serving tier's sketch cache in both packages), and a
checkpoint written by one package must restore in the other, bitwise: the
on-disk format (``step_<n>/arrays.npz``, ``manifest.json`` with a crc32 per
leaf, ``LATEST``) is the reference's. bf16 leaves: the port reads a bf16
file the reference wrote by its bits (the reference's own ``restore`` of
one fails without numpy's bfloat16, ROADMAP queue 3). Also mirrored here:
the reference's ``TestParamsDigest`` and ``TestDigestDriftInvalidation``
(``tests/test_params_digest.py``), crc corruption, async saves, rotation
and stale ``.tmp`` removal. Everything is exact: no tolerance.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.checkpoint import params_digest as jdigest
from repro_torch.checkpoint import (CheckpointManager, params_digest, restore,
                                    save)
from repro_torch.convert import to_torch
from repro_torch.core.tree_util import (tree_flatten_with_path, tree_leaves,
                                        tree_map)
from repro_torch.serve.store import SketchKey, SketchStore
from torch_threads import torch_thread_cap  # noqa: F401


def _np_tree(seed=0):
    """Nested dicts and lists of f32 and int32 leaves, a 0-d leaf too."""
    rng = np.random.RandomState(seed)
    return {'layers': [{'w': rng.randn(3, 4).astype(np.float32),
                        'b': rng.randn(4).astype(np.float32)},
                       {'w': rng.randn(4, 2).astype(np.float32),
                        'b': np.zeros(2, np.float32)}],
            'step': np.array(7, np.int32),
            'nested': {'s': np.float32(2.5),
                       'ids': np.arange(5, dtype=np.int32)}}


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the digest: the reference's string
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('seed', [0, 1])
def test_digest_equals_the_reference(seed):
    tree = _np_tree(seed)
    assert params_digest(to_torch(tree)) == jdigest(tree)
    assert params_digest(tree) == jdigest(tree)          # numpy leaves too


def test_paths_render_as_the_reference_renders_them():
    tree = _np_tree()
    want = ['/'.join(str(getattr(p, 'key', getattr(p, 'idx', p)))
                     for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = ['/'.join(path) for path, _ in tree_flatten_with_path(tree)[0]]
    assert got == want


def test_digest_of_a_bf16_leaf_hashes_its_raw_values():
    """A bf16 leaf digests as dtype 'bfloat16' over its 2-byte values, as
    the reference's does (numpy's bfloat16 is loaded with jax)."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jtree = {'w': jnp.asarray(x, jnp.bfloat16)}
    tree = {'w': torch.from_numpy(x).to(torch.bfloat16)}
    assert params_digest(tree) == jdigest(jtree)
    assert params_digest(tree) != params_digest({'w': torch.from_numpy(x)})


class TestParamsDigest:
    """The reference's cases (tests/test_params_digest.py) on the port."""

    def _tree(self):
        return {'w': torch.arange(6.0).reshape(2, 3), 'b': torch.zeros(3),
                'nested': {'s': torch.tensor(2.5)}}

    def test_deterministic(self):
        assert params_digest(self._tree()) == params_digest(self._tree())
        assert len(params_digest(self._tree())) == 16

    def test_insertion_order_irrelevant(self):
        a = {'w': torch.ones(2), 'b': torch.zeros(3)}
        b = {'b': torch.zeros(3), 'w': torch.ones(2)}
        assert params_digest(a) == params_digest(b)

    def test_byte_sensitivity(self):
        t = self._tree()
        bumped = dict(t, w=t['w'].clone())
        bumped['w'][0, 1] += 1e-6
        assert params_digest(t) != params_digest(bumped)

    def test_dtype_sensitivity(self):
        assert (params_digest({'x': torch.zeros(4, dtype=torch.float32)})
                != params_digest({'x': torch.zeros(4, dtype=torch.int32)}))

    def test_shape_sensitivity(self):
        x = torch.arange(6.0)
        assert (params_digest({'x': x})
                != params_digest({'x': x.reshape(2, 3)}))

    def test_path_sensitivity(self):
        assert (params_digest({'a': torch.ones(2)})
                != params_digest({'b': torch.ones(2)}))

    def test_numpy_and_tensors_agree(self):
        assert (params_digest({'w': torch.arange(4.0)})
                == params_digest({'w': np.arange(4.0, dtype=np.float32)}))


class TestDigestDriftInvalidation:
    def _stocked_store(self, digest):
        store = SketchStore()
        for fp in ('nystrom/k=4', 'nystrom/k=8'):
            store.get_or_build(SketchKey(params=digest, solver=fp),
                               lambda: {'s': torch.ones(2)}, build_hvps=4)
        return store

    def test_invalidate_params_drops_all_solver_configs(self):
        d_old = params_digest({'w': torch.zeros(4)})
        store = self._stocked_store(d_old)
        assert len(store) == 2
        assert store.invalidate_params(d_old) == 2
        assert len(store) == 0
        assert store.invalidations == 2

    def test_drift_misses_instead_of_serving_stale(self):
        old = {'w': torch.zeros(4)}
        new = {'w': torch.tensor([1.0, 0.0, 0.0, 0.0])}
        d_old, d_new = params_digest(old), params_digest(new)
        assert d_old != d_new
        store = self._stocked_store(d_old)
        _, built = store.get_or_build(
            SketchKey(params=d_new, solver='nystrom/k=4'),
            lambda: {'s': torch.ones(2)})
        assert built
        assert store.invalidate_params(d_new) == 1
        assert len(store) == 2


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------
def test_round_trip_is_bitwise(tmp_path):
    tree = to_torch(_np_tree())
    save(str(tmp_path), 3, tree, extra={'note': 'x'})
    template = tree_map(torch.zeros_like, tree)
    got, manifest = restore(str(tmp_path), template)
    _assert_trees_equal(got, tree)
    assert manifest['step'] == 3 and manifest['extra'] == {'note': 'x'}
    assert params_digest(got) == params_digest(tree)


def test_reference_restores_what_the_port_saved(tmp_path):
    tree = _np_tree()
    save(str(tmp_path), 5, to_torch(tree))
    got, manifest = jmanager.restore(str(tmp_path), jax.tree.map(
        jnp.asarray, tree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    assert manifest['step'] == 5


def test_port_restores_what_the_reference_saved(tmp_path):
    tree = _np_tree()
    jmanager.save(str(tmp_path), 2, jax.tree.map(jnp.asarray, tree))
    got, _ = restore(str(tmp_path), to_torch(jax.tree.map(np.zeros_like,
                                                          tree)))
    _assert_trees_equal(got, to_torch(tree))


def _bf16_tree():
    x = (np.arange(24, dtype=np.float32).reshape(4, 6) - 11) / 3
    return x, {'w': torch.from_numpy(x).to(torch.bfloat16),
               'b': torch.from_numpy(x[0])}


def test_bf16_round_trip_is_bitwise(tmp_path):
    _, tree = _bf16_tree()
    save(str(tmp_path), 1, tree)
    with open(tmp_path / 'step_0000000001' / 'manifest.json') as f:
        assert json.load(f)['leaves']['w']['dtype'] == 'bfloat16'
    got, _ = restore(str(tmp_path), {'w': torch.zeros(4, 6,
                                                      dtype=torch.bfloat16),
                                     'b': torch.zeros(6)})
    _assert_trees_equal(got, tree)


def test_port_reads_a_bf16_file_the_reference_wrote(tmp_path):
    """The reference writes bf16 leaves through numpy's bfloat16 (``<V2``
    on disk); the port reads their bits back."""
    x, tree = _bf16_tree()
    jmanager.save(str(tmp_path), 4, {'w': jnp.asarray(x, jnp.bfloat16),
                                     'b': jnp.asarray(x[0])})
    got, _ = restore(str(tmp_path), {'w': torch.zeros(4, 6,
                                                      dtype=torch.bfloat16),
                                     'b': torch.zeros(6)})
    _assert_trees_equal(got, tree)


def test_corrupted_crc_raises(tmp_path):
    tree = to_torch(_np_tree())
    final = save(str(tmp_path), 1, tree)
    path = os.path.join(final, 'manifest.json')
    with open(path) as f:
        manifest = json.load(f)
    manifest['leaves']['step']['crc32'] ^= 1
    with open(path, 'w') as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match='corruption'):
        restore(str(tmp_path), tree)
    restore(str(tmp_path), tree, verify=False)


def test_restore_refuses_shardings_and_takes_a_device(tmp_path):
    tree = to_torch(_np_tree())
    save(str(tmp_path), 1, tree)
    with pytest.raises(NotImplementedError, match='item 12'):
        restore(str(tmp_path), tree, shardings=object())
    got, _ = restore(str(tmp_path), tree, device='cpu')
    _assert_trees_equal(got, tree)
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / 'none'), tree)


def test_async_save_rotation_and_tmp_gc(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, 'step_0000000009.tmp'))    # a crashed save
    mgr = CheckpointManager(d, keep=2, async_save=True)
    assert not any(n.endswith('.tmp') for n in os.listdir(d))
    tree = {'w': torch.zeros(3)}
    for step in range(4):
        tree['w'] += 1            # updated in place after each save returns
        mgr.save(step, tree)
    mgr.wait()
    assert sorted(n for n in os.listdir(d) if n.startswith('step_')) == [
        'step_0000000002', 'step_0000000003']
    assert mgr.latest_step() == 3
    got, manifest = mgr.restore_latest({'w': torch.zeros(3)})
    assert manifest['step'] == 3
    assert torch.equal(got['w'], torch.full((3,), 4.0))
    first, _ = restore(d, {'w': torch.zeros(3)}, step=2)
    assert torch.equal(first['w'], torch.full((3,), 3.0))


def test_async_save_error_surfaces_at_wait(tmp_path):
    d = tmp_path / 'ckpt'
    mgr = CheckpointManager(str(d), async_save=True)
    d.rmdir()
    d.write_text('')                      # the directory became a file
    mgr.save(0, {'w': torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                            # reported once
