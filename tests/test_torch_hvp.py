"""Parity of the port's HVP substrate (``make_hvp`` + ``extract_columns``)
with the reference: the sketch C = H[:, K] and H_KK at the reference's own
index draw, on ``logreg_wd`` and on the reweighting MLP at width 16.

Tolerance: rtol 1e-4 with atol 1e-5·max|C|. An HVP is a forward and a
backward pass of the model, whose f32 sums run in another order in XLA and
in PyTorch; the difference is roundoff, a few ulp of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hvp import extract_columns as jextract
from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.tasks.paper import build_logreg_weight_decay as jbuild_logreg
from repro.tasks.paper import build_reweighting as jbuild_rw
from repro_torch.convert import to_torch
from repro_torch.core.hvp import extract_columns, make_hvp
from repro_torch.core.tree_util import PyTreeIndexer, tree_leaves
from repro_torch.tasks.paper import build_logreg_weight_decay, build_reweighting


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_close(port_tree, ref_tree):
    for a, b in zip(tree_leaves(port_tree), jax.tree.leaves(ref_tree)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))


def _logreg_point():
    jp = jbuild_logreg(D=20, n=64)
    w = np.random.RandomState(0).randn(20).astype(np.float32) * 0.3
    params = {'w': w}
    hparams = {'wd': np.random.RandomState(1).rand(20).astype(np.float32)}
    batch = _np(jp.data.train)
    return jp, build_logreg_weight_decay(D=20, n=64, device='cpu'), \
        params, hparams, batch


def _reweighting_point():
    jp = jbuild_rw(width=16)
    params = _np(jp.init_params(jax.random.PRNGKey(4)))
    hparams = _np(jp.init_hparams(jax.random.PRNGKey(5)))
    X, y = _np(jp.data.train)
    batch = (X[:128], y[:128])
    return jp, build_reweighting(width=16, device='cpu'), params, hparams, \
        batch


@pytest.mark.parametrize('point', ['logreg_wd', 'reweighting'])
@pytest.mark.parametrize('column_chunk', [None, 3])
def test_sketch_columns_and_hkk_match_reference(point, column_chunk):
    jp, tp, params, hparams, batch = (
        _logreg_point() if point == 'logreg_wd' else _reweighting_point())
    jparams = jax.tree.map(jnp.asarray, params)
    jix = JIndexer(jparams)
    draw = jix.sample_indices(jax.random.PRNGKey(7), 8)
    jhvp = jmake_hvp(jp.inner_loss, jparams, jax.tree.map(jnp.asarray, hparams),
                     jax.tree.map(jnp.asarray, batch))
    jC = jextract(jhvp, jix, draw, column_chunk)
    jH = jix.gather(jC, draw)

    tparams = to_torch(params)
    tix = PyTreeIndexer(tparams)
    idx = tix.sample_indices(None, 8, indices=_np(draw))
    hvp = make_hvp(tp.inner_loss, tparams, to_torch(hparams),
                   to_torch(batch))
    C = extract_columns(hvp, tix, idx, column_chunk)
    _assert_close(C, jC)
    _assert_close(tix.gather(C, idx), jH)


def test_port_datasets_regenerate_the_references_bit_for_bit():
    jp = jbuild_rw(width=16)
    tp = build_reweighting(width=16, device='cpu')
    for a, b in zip(tp.data.train + tp.data.val, jp.data.train + jp.data.val):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jl = jbuild_logreg(D=20, n=64)
    tl = build_logreg_weight_decay(D=20, n=64, device='cpu')
    for a, b in zip(tl.data.train + tl.data.val, jl.data.train + jl.data.val):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_hvp_matches_reference_on_a_dense_tangent():
    jp, tp, params, hparams, batch = _reweighting_point()
    v = jax.tree.map(
        lambda x: np.random.RandomState(2).randn(*x.shape).astype(np.float32),
        params)
    ref = jmake_hvp(jp.inner_loss, jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, hparams),
                    jax.tree.map(jnp.asarray, batch))(jax.tree.map(jnp.asarray, v))
    got = make_hvp(tp.inner_loss, to_torch(params), to_torch(hparams),
                   to_torch(batch))(to_torch(v))
    _assert_close(got, ref)
    assert isinstance(tree_leaves(got)[0], torch.Tensor)
