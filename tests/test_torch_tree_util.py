"""Parity of the port's tree layer and structured indexer with the reference.

Leaf order must be JAX's (dict keys sorted, 'b' before 'w'), or every fused
buffer of the port is a permutation of the reference's. Index maps are
integer arithmetic: held exactly. The port's weighted and large-p draws come
from a ``torch.Generator``, not the reference's stream: they are checked for
their support (distinct, in range, only where the weights are positive) and
for taking the reference's own draws when injected. The p ≥ 2³¹ tree is made
of expanded views, which allocate one element each.
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
from torch_threads import torch_thread_cap  # noqa: F401


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


def _flat_of(tix, idx):
    offs = np.cumsum([0] + tix.sizes)
    out = []
    for leaf, dims in zip(idx['leaf'].tolist(), idx['dims'].tolist()):
        shape = tix.shapes[leaf] or (1,)
        out.append(int(offs[leaf] + np.ravel_multi_index(
            tuple(dims[:max(1, len(tix.shapes[leaf]))]), shape)))
    return out


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_weighted_draw_stays_on_the_weights_support(seed):
    tix = PyTreeIndexer(to_torch(_params()))
    support = [1, 4, 7, 11, 16]
    w = torch.zeros(tix.total)
    w[support] = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    gen = torch.Generator().manual_seed(seed)
    assert sorted(_flat_of(tix, tix.sample_indices(gen, 5, w))) == support
    picked = _flat_of(tix, tix.sample_indices(gen, 3, w))
    assert len(set(picked)) == 3 and set(picked) <= set(support)
    with pytest.raises(ValueError, match='weights must be'):
        tix.sample_indices(gen, 3, torch.ones(5))


def test_weighted_draw_of_the_reference_is_taken_as_injected():
    p = _params()
    jix = JIndexer(jax.tree.map(jnp.asarray, p))
    w = np.linspace(0.1, 2.0, 17).astype(np.float32)
    draw = jax.tree.map(np.asarray, jix.sample_indices(
        jax.random.PRNGKey(5), 6, jnp.asarray(w)))
    idx = PyTreeIndexer(to_torch(p)).sample_indices(
        None, 6, torch.tensor(w), indices=draw)
    np.testing.assert_array_equal(idx['leaf'].numpy(), draw['leaf'])
    np.testing.assert_array_equal(idx['dims'].numpy(), draw['dims'])


def test_prepare_draws_from_diag_weights_only_with_importance_sampling():
    from repro_torch.core.hvp import make_hvp
    from repro_torch.core.solvers import NystromIHVP
    tparams = to_torch(_params())
    tix = PyTreeIndexer(tparams)
    hvp = make_hvp(lambda t, h, b: sum((x ** 2).sum() for x in
                                       tree_leaves(t)), tparams, None, None)
    w = torch.zeros(tix.total)
    w[[2, 9, 15]] = 1.0
    weighted = NystromIHVP(k=3, importance_sampling=True, backend='flat')
    sk = weighted.prepare(hvp, tix, torch.Generator().manual_seed(0),
                          diag_weights=w)
    assert sorted(_flat_of(tix, sk.indices)) == [2, 9, 15]
    plain = NystromIHVP(k=3, backend='flat')
    a = plain.prepare(hvp, tix, torch.Generator().manual_seed(0),
                      diag_weights=w)
    b = plain.prepare(hvp, tix, torch.Generator().manual_seed(0))
    assert torch.equal(a.indices['leaf'], b.indices['leaf'])
    assert torch.equal(a.indices['dims'], b.indices['dims'])


def _huge():
    """p = 2^32 + 3 parameters, one stored element a leaf."""
    return {'a': torch.zeros(()).expand(2 ** 16, 2 ** 16),
            'b': torch.zeros(()).expand(3)}


@pytest.mark.parametrize('seed', [0, 1])
def test_large_p_draw_is_per_leaf_and_per_dimension(seed):
    tix = PyTreeIndexer(_huge())
    assert tix.total == 2 ** 32 + 3
    idx = tix.sample_indices(torch.Generator().manual_seed(seed), 16)
    leaf, dims = idx['leaf'].long(), idx['dims'].long()
    assert idx['leaf'].dtype == idx['dims'].dtype == torch.int32
    assert leaf.shape == (16,) and dims.shape == (16, 2)
    table = torch.as_tensor(tix._dim_table)[leaf]
    assert bool(((dims >= 0) & (dims < table)).all())
    again = tix.sample_indices(torch.Generator().manual_seed(seed), 16)
    assert torch.equal(again['dims'], idx['dims'])
    with pytest.raises(ValueError, match='p < 2'):
        tix.sample_indices(torch.Generator(), 4, torch.ones(3))


def test_large_p_draw_of_the_reference_is_taken_as_injected():
    shapes = {'a': jax.ShapeDtypeStruct((2 ** 16, 2 ** 16), jnp.float32),
              'b': jax.ShapeDtypeStruct((3,), jnp.float32)}
    draw = jax.tree.map(np.asarray, JIndexer(shapes).sample_indices(
        jax.random.PRNGKey(2), 8))
    idx = PyTreeIndexer(_huge()).sample_indices(None, 8, indices=draw)
    np.testing.assert_array_equal(idx['leaf'].numpy(), draw['leaf'])
    np.testing.assert_array_equal(idx['dims'].numpy(), draw['dims'])


@pytest.mark.parametrize('with_path', [False, True])
def test_flatten_leaves_no_reference_cycle(with_path):
    """A flattened tree's leaves die with their last reference, without
    the garbage collector: a walk that held them in a cycle kept a
    model's full-width parameters alive until the next collection."""
    import gc
    import weakref
    from repro_torch.core.tree_util import tree_flatten_with_path
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    tree = {'a': [leaf, (torch.ones(2),)], 'b': None}
    flatten = tree_flatten_with_path if with_path else tree_flatten
    enabled = gc.isenabled()
    gc.disable()
    try:
        out, treedef = flatten(tree)
        assert len(out) == 2 and treedef is not None
        del leaf, tree, out, treedef
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
