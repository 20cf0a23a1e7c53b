"""Parity of the port's tree layer and structured indexer with the reference.

Leaf order must be JAX's (dict keys sorted, 'b' before 'w'), or every fused
buffer of the port is a permutation of the reference's. Index maps are
integer arithmetic: held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.tasks.paper import mlp_init as jmlp_init
from repro_torch.convert import indices_to_torch, to_numpy, to_torch
from repro_torch.core.backend import flatten_vec, unflatten_vec
from repro_torch.core.tree_util import (PyTreeIndexer, tree_flatten,
                                        tree_leaves, tree_map)
from repro_torch.tasks.paper import mlp_init


def test_leaf_order_matches_jax_on_mlp_params():
    jparams = jmlp_init(jax.random.PRNGKey(0), (6, 5, 3))
    tparams = to_torch(jax.tree.map(np.asarray, jparams))
    jleaves = jax.tree.leaves(jparams)
    tleaves = tree_leaves(tparams)
    assert [tuple(x.shape) for x in tleaves] == [x.shape for x in jleaves]
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tleaves[0].shape == (5,) and tleaves[1].shape == (6, 5)


def test_leaf_order_sorts_keys_not_insertion_order():
    # the port's mlp_init inserts 'w' before 'b'; JAX's order puts 'b' first
    port = mlp_init(torch.Generator().manual_seed(0), (6, 5, 3))
    assert list(port[0]) == ['w', 'b']
    assert [tuple(x.shape) for x in tree_leaves(port)] == [
        (5,), (6, 5), (3,), (5, 3)]


def test_port_mlp_init_has_reference_structure():
    ref = jax.tree.structure(jmlp_init(jax.random.PRNGKey(0), (6, 5, 3)))
    port = mlp_init(torch.Generator().manual_seed(0), (6, 5, 3))
    shapes = [tuple(x.shape) for x in tree_leaves(port)]
    assert shapes == [x.shape for x in jax.tree.leaves(
        jmlp_init(jax.random.PRNGKey(0), (6, 5, 3)))]
    assert ref.num_leaves == len(shapes)


def test_flatten_unflatten_round_trip_and_namedtuples():
    from repro_torch.optim.optimizers import AdamState
    tree = {'z': [torch.ones(2), None], 'a': AdamState(torch.zeros(3),
                                                       (torch.ones(1),))}
    leaves, treedef = tree_flatten(tree)
    assert [x.shape[0] for x in leaves] == [3, 1, 2]
    back = treedef.unflatten(leaves)
    assert isinstance(back['a'], AdamState) and back['z'][1] is None
    with pytest.raises(ValueError):
        tree_map(lambda a, b: a, {'a': torch.ones(1)}, {'b': torch.ones(1)})


def _params():
    rng = np.random.RandomState(0)
    return {'w': rng.randn(3, 4).astype(np.float32),
            'b': rng.randn(4).astype(np.float32),
            's': np.float32(1.5) * np.ones((), np.float32)}


def test_from_flat_matches_reference():
    p = _params()
    jidx = JIndexer(jax.tree.map(jnp.asarray, p)).from_flat(np.arange(17))
    tidx = PyTreeIndexer(to_torch(p)).from_flat(np.arange(17))
    np.testing.assert_array_equal(tidx['leaf'].numpy(), np.asarray(jidx['leaf']))
    np.testing.assert_array_equal(tidx['dims'].numpy(), np.asarray(jidx['dims']))


def test_one_hots_and_gather_match_reference_at_injected_draw():
    p = _params()
    jp = jax.tree.map(jnp.asarray, p)
    jix = JIndexer(jp)
    draw = jix.sample_indices(jax.random.PRNGKey(3), 6)
    tix = PyTreeIndexer(to_torch(p))
    idx = tix.sample_indices(None, 6, indices=jax.tree.map(np.asarray, draw))
    jo = jix.one_hots(draw)
    to = tix.one_hots(idx)
    for a, b in zip(tree_leaves(to), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    batched = jax.tree.map(
        lambda x: np.random.RandomState(1).randn(5, *x.shape).astype(np.float32),
        p)
    np.testing.assert_array_equal(
        tix.gather(to_torch(batched), idx).numpy(),
        np.asarray(jix.gather(jax.tree.map(jnp.asarray, batched), draw)))


def test_sample_indices_distinct_and_in_range():
    tix = PyTreeIndexer(to_torch(_params()))
    idx = tix.sample_indices(torch.Generator().manual_seed(0), 10)
    flat = set()
    offs = np.cumsum([0] + tix.sizes)
    for leaf, dims in zip(idx['leaf'].tolist(), idx['dims'].tolist()):
        shape = tix.shapes[leaf] or (1,)
        local = np.ravel_multi_index(tuple(dims[:max(1, len(tix.shapes[leaf]))]),
                                     shape)
        flat.add(int(offs[leaf] + local))
    assert len(flat) == 10 and max(flat) < tix.total


def test_injected_indices_are_validated():
    tix = PyTreeIndexer(to_torch(_params()))
    with pytest.raises(IndexError):
        tix.check({'leaf': np.array([0]), 'dims': np.array([[9, 0]])})
    with pytest.raises(ValueError):
        tix.check({'leaf': np.array([0]), 'dims': np.array([[0]])})


def test_convert_round_trip_and_flat_vector_order():
    p = _params()
    t = to_torch(p)
    back = to_numpy(t)
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])
    from repro.core.backend import flatten_vec as jflatten_vec
    np.testing.assert_array_equal(
        flatten_vec(t).numpy(),
        np.asarray(jflatten_vec(jax.tree.map(jnp.asarray, p))))
    u = unflatten_vec(flatten_vec(t), t)
    assert all(torch.equal(u[k], t[k]) for k in t)
    idx = indices_to_torch({'leaf': np.array([1]), 'dims': np.array([[0, 2]])})
    assert idx['leaf'].dtype == torch.int32
