"""The LM slice's pieces against the reference at ``yi_9b.reduced()`` in
f32, on the reference's parameters (``model_params_from_jax``) and draws
(``model_indices_from_jax``), at 1e-5 relative unless stated: the training
loss and ``cross_entropy``, the Nyström sketch's HVP columns through the
transformer (``vmap(jvp(grad))`` through the embedding's backward, the
masked CE's max and where, RoPE and the causal mask), ``build_train_step``
at 1 and 2 microbatches, and ``build_hypergrad_step``. The reference's
step functions are called bare (``StepBundle.fn``): under an active mesh
they fail in jax 0.9.0 (``tests/torch_lm_reference.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_reference as R
from repro.core.hvp import extract_columns as jextract_columns
from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.data.synthetic import TokenStream as JTokenStream
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.launch.train import build_losses
from repro.models import layers as jlayers
from repro.models.transformer import train_loss as jtrain_loss
from repro_torch.configs import get_config
from repro_torch.convert import (model_indices_from_jax,
                                 model_params_from_jax, to_numpy)
from repro_torch.core import PyTreeIndexer, extract_columns, make_hvp
from repro_torch.core.tree_util import tree_leaves
from repro_torch.data import TokenStream
from repro_torch.launch.steps import (N_DOMAINS, build_train_step,
                                      domain_losses, make_optimizer)
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import train_loss
from torch_threads import torch_thread_cap  # noqa: F401

TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _unstack(tree, n_blocks, lead=0):
    """The reference's stacked ``blocks`` → the port's list (the block axis
    at ``lead``)."""
    tree = dict(tree)
    tree['blocks'] = [jax.tree.map(lambda x: np.take(x, i, axis=lead),
                                   tree['blocks']) for i in range(n_blocks)]
    return tree


def _assert_trees_close(got, want, tol=TOL):
    g, w = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    num = sum(float(np.sum((np.float64(a) - b) ** 2)) for a, b in zip(g, w))
    den = sum(float(np.sum(np.float64(b) ** 2)) for b in w)
    assert np.sqrt(num / den) <= tol


@pytest.fixture(scope='module')
def setup():
    jcfg = R.reference_config()
    cfg = get_config(R.ARCH).reduced()
    jparams = R.reference_params()
    stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=R.SEQ)
    jb = stream.batch(0, R.BATCH)
    b = {key: torch.from_numpy(np.array(v)) for key, v in jb.items()}
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jb=jb, b=b,
                params=model_params_from_jax(jparams, cfg))


def test_token_stream_is_bit_for_bit():
    for vocab, seq in ((256, 32), (64000, 16)):
        j, t = JTokenStream(vocab, seq), TokenStream(vocab, seq)
        for step in (0, 3, 10_000_005):
            for clean in (False, True):
                want = j.batch(step, 5, clean_only=clean)
                got = t.batch(step, 5, clean_only=clean)
                assert sorted(got) == sorted(want)
                for key in want:
                    assert got[key].device.type == 'cpu'
                    np.testing.assert_array_equal(got[key].numpy(),
                                                  np.asarray(want[key]))


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('masked', [False, True])
def test_train_loss_matches(setup, weighted, masked):
    rng = np.random.RandomState(1)
    jb, b = dict(setup['jb']), dict(setup['b'])
    if masked:
        mask = (rng.rand(R.BATCH, R.SEQ) < 0.7).astype(np.float32)
        jb['mask'], b['mask'] = jnp.asarray(mask), torch.from_numpy(mask)
    else:
        jb.pop('mask')
        b.pop('mask')
    w = rng.rand(R.BATCH).astype(np.float32) if weighted else None
    want = jtrain_loss(setup['jcfg'], jax.tree.map(jnp.asarray,
                                                   setup['jparams']), jb,
                       example_weights=None if w is None else jnp.asarray(w))
    got = train_loss(setup['cfg'], setup['params'], b,
                     example_weights=None if w is None
                     else torch.from_numpy(w))
    assert abs(float(got) / float(want) - 1) <= TOL


@pytest.mark.parametrize('z_loss', [0.0, 1e-4])
@pytest.mark.parametrize('masked', [False, True])
def test_cross_entropy_matches(z_loss, masked):
    rng = np.random.RandomState(2)
    logits = (3 * rng.randn(3, 7, 50)).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) < 0.5).astype(np.float32) if masked else None
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask),
                                 z_loss=z_loss)
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if mask is None
                                else torch.from_numpy(mask), z_loss=z_loss)
    assert abs(float(got) / float(want) - 1) <= TOL


def test_hvp_columns_match_through_the_index_translation(setup):
    jcfg, cfg = setup['jcfg'], setup['cfg']
    jinner = build_losses(jcfg)[0]
    inner = domain_losses(cfg)[0]
    jp = jax.tree.map(jnp.asarray, setup['jparams'])
    rng = np.random.RandomState(3)
    logits = (0.1 * rng.randn(N_DOMAINS)).astype(np.float32)
    draw = R.reference_draw(setup['jparams'], 0)
    # the draw must reach several stacked leaves, blocks beyond the first
    assert len(set(draw['leaf'].tolist())) >= 4
    jcols = jextract_columns(
        jmake_hvp(jinner, jp, {'domain_logits': jnp.asarray(logits)},
                  setup['jb']), JIndexer(jp), draw, column_chunk=R.CHUNK)
    idx = model_indices_from_jax(draw, cfg)
    got = extract_columns(
        make_hvp(inner, setup['params'],
                 {'domain_logits': torch.from_numpy(logits)}, setup['b']),
        PyTreeIndexer(setup['params']), idx, column_chunk=R.CHUNK)
    _assert_trees_close(got, _unstack(jax.tree.map(np.asarray, jcols),
                                      cfg.n_blocks, lead=1))
    # the translated draw addresses the same coordinates: H_KK agrees too
    gk = PyTreeIndexer(setup['params']).gather(got, idx).numpy()
    wk = np.asarray(JIndexer(jp).gather(jcols, draw))
    assert _rel(gk, wk) <= TOL


@pytest.mark.parametrize('microbatches', [1, 2])
def test_build_train_step_matches(setup, microbatches):
    jcfg, cfg = setup['jcfg'], setup['cfg']
    jstep = jax.jit(jbuild_train_step(jcfg, make_host_mesh(), R.BATCH,
                                      R.SEQ, microbatches=microbatches).fn)
    jp = jax.tree.map(jnp.asarray, setup['jparams'])
    jopt = make_optimizer(cfg)
    step = build_train_step(cfg, microbatches=microbatches)
    params, opt_state = setup['params'], jopt.init(setup['params'])
    from repro.launch.steps import make_optimizer as jmake_optimizer
    jopt_state = jmake_optimizer(jcfg).init(jp)
    stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=R.SEQ)
    tstream = TokenStream(vocab_size=cfg.vocab_size, seq_len=R.SEQ)
    for i in range(2):
        jp, jopt_state, _, jm = jstep(jp, jopt_state, jnp.int32(i),
                                      stream.batch(i, R.BATCH))
        params, opt_state, nxt, m = step(params, opt_state, i,
                                         tstream.batch(i, R.BATCH))
        assert nxt == i + 1
        assert abs(float(m['loss']) / float(jm['loss']) - 1) <= TOL
        assert abs(float(m['grad_norm']) / float(jm['grad_norm']) - 1) <= TOL
    want = _unstack(jax.tree.map(np.asarray, jp), cfg.n_blocks)
    _assert_trees_close(params, want)
