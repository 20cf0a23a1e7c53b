"""The port's bilevel LM trainer (``repro_torch.launch.train.train_lm``)
against the reference's loop, rebuilt outside the mesh
(``tests/torch_lm_reference.py``), at ``yi_9b.reduced()`` in f32: the
reference's initial parameters (``model_params_from_jax``) and column draws
(``model_indices_from_jax``), 6 steps, an outer step every 3, batch 4,
seq 32, Nyström k = 8, ρ = 1e-2, ``column_chunk=4``.

Tolerance 1e-4 relative on inner losses, outer values, hypergradients
(relative L2), final parameters and each outer step's move of the domain
logits where the hypergradient has signal. A domain with no example in an
outer step's inner batch gets a hypergradient of f32 rounding noise
(|g| ≤ 1e-5·max|g| on both sides), which ``adam`` normalizes to a step of
about ±0.64·lr either way: there the logits are held only to that bound. Also: the resume drill, the CLI
route and its refusals, and ``build_hypergrad_step`` (one hypergradient
step at the reference's draw over its stacked tree, 1e-5)."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_reference as R
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.data.synthetic import TokenStream as JTokenStream
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_hypergrad_step as jbuild_hypergrad_step
from repro_torch.configs import get_config
from repro_torch.convert import (model_indices_from_jax,
                                 model_params_from_jax, to_numpy, to_torch)
from repro_torch.core import config_from_cli
from repro_torch.core.tree_util import tree_leaves
from repro_torch.launch.steps import N_DOMAINS, build_hypergrad_step
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_lm
from torch_threads import torch_thread_cap  # noqa: F401

TOL = 1e-4
NOISE = 1e-5   # below NOISE·max|g| (~100 f32 ulps of the largest) is roundoff


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hg_cfg():
    return config_from_cli('nystrom', flags={},
                           defaults={'k': R.K, 'rho': R.RHO},
                           column_chunk=R.CHUNK)


def _cfg():
    return get_config(R.ARCH).reduced()


@pytest.fixture(scope='module')
def ref():
    return R.reference_run()


@pytest.fixture(scope='module')
def port(ref):
    cfg = _cfg()
    draws = {o['i']: model_indices_from_jax(o['draw'], cfg)
             for o in ref['outer']}
    return train_lm(cfg, _hg_cfg(), steps=R.STEPS, batch=R.BATCH, seq=R.SEQ,
                    outer_every=R.OUTER_EVERY, device='cpu', log_every=0,
                    params=model_params_from_jax(R.reference_params(), cfg),
                    indices=lambda i: draws[i])


def test_inner_losses_match_the_reference(port, ref):
    assert len(port.losses) == R.STEPS
    np.testing.assert_allclose(port.losses, ref['losses'], rtol=TOL)


def test_outer_values_and_hypergradients_match(port, ref):
    assert [o['i'] for o in port.outer] == [o['i'] for o in ref['outer']] \
        == [2, 5]
    for got, want in zip(port.outer, ref['outer']):
        assert abs(got['val'] / want['val'] - 1) <= TOL
        assert _rel(got['hypergrad'], want['hypergrad']) <= TOL


def test_domain_logit_moves_match_where_the_hypergradient_has_signal(
        port, ref):
    prev = (np.zeros(64), np.zeros(64))
    for n, (got, want) in enumerate(zip(port.outer, ref['outer']), 1):
        g, gw = got['hypergrad'].numpy(), want['hypergrad']
        noise = np.abs(gw) <= NOISE * np.abs(gw).max()
        # noise on one side is noise on the other
        assert (np.abs(g[noise]) <= NOISE * np.abs(g).max()).all()
        assert (~noise).any()
        logits = got['logits'].numpy()
        move, want_move = logits - prev[0], want['logits'] - prev[1]
        assert _rel(move[~noise], want_move[~noise]) <= TOL
        # elsewhere adam's steps are bounded: |Δ| ≤ 2·lr per outer step
        assert np.abs(logits - want['logits']).max() <= 2 * 1e-2 * n
        prev = (logits, want['logits'])


def test_final_parameters_match(port, ref):
    got = to_numpy(port.params)
    want = ref['params']
    for i, block in enumerate(got['blocks']):
        for name, leaf in block['slot0']['ffn'].items():
            assert _rel(leaf, want['blocks']['slot0']['ffn'][name][i]) <= TOL
        for name, leaf in block['slot0']['mixer'].items():
            assert _rel(leaf, want['blocks']['slot0']['mixer'][name][i]) \
                <= TOL
    for name in ('embed', 'unembed', 'final_norm'):
        for key, leaf in got[name].items():
            assert _rel(leaf, want[name][key]) <= TOL


def _leaves(run):
    return [x for tree in (run.params, run.opt_state, run.hparams,
                           run.outer_state) for x in tree_leaves(tree)]


def test_resume_drill_is_bitwise(tmp_path):
    """A run stopped at step 4 and resumed from its checkpoint ends where an
    uninterrupted run ends, bit for bit."""
    cfg = dict(batch=2, seq=8, outer_every=3, device='cpu', log_every=0)
    whole = train_lm(_cfg(), _hg_cfg(), steps=6, **cfg)
    first = train_lm(_cfg(), _hg_cfg(), steps=4, ckpt_dir=str(tmp_path),
                     ckpt_every=4, **cfg)
    assert len(first.losses) == 4 and len(first.outer) == 1
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        resumed = train_lm(_cfg(), _hg_cfg(), steps=6,
                           ckpt_dir=str(tmp_path), **cfg)
    assert '[train] resumed from step 4' in out.getvalue()
    assert [o['i'] for o in resumed.outer] == [5]
    assert first.losses + resumed.losses == whole.losses
    a, b = _leaves(whole), _leaves(resumed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cli_lm_route_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = train_main(['--arch', 'yi_9b', '--reduced', '--steps', '4',
                          '--outer-every', '2', '--batch', '2', '--seq', '8',
                          '--log-every', '2', '--device', 'cpu'])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith('[train] arch=yi-9b-smoke params~0.1M')
    assert sum(l.startswith('[train] step') for l in lines) == 2
    outer = [l for l in lines if l.startswith('[outer] step')]
    assert len(outer) == 2 and 'val(pre-update)=' in outer[0]
    assert 'noisy-domain weight=' in outer[0] and '(uniform=0.250)' in outer[0]
    assert lines[-1].startswith('[train] done: 4 steps, final loss')
    assert np.isfinite(run.losses).all() and len(run.outer) == 2


def test_cli_refuses_the_production_mesh():
    with pytest.raises(SystemExit, match='one card'):
        train_main(['--arch', 'yi_9b', '--reduced', '--production-mesh',
                    '--device', 'cpu'])


def test_cli_refuses_a_flag_the_solver_does_not_consume():
    with pytest.raises(ValueError, match='not consumed'):
        train_main(['--arch', 'yi_9b', '--reduced', '--solver', 'exact',
                    '--k', '4', '--steps', '1', '--device', 'cpu'])


def test_build_hypergrad_step_matches():
    jcfg, cfg = R.reference_config(), _cfg()
    jstep = jax.jit(jbuild_hypergrad_step(jcfg, make_host_mesh(), R.BATCH,
                                          R.SEQ).fn)
    jp = jax.tree.map(jnp.asarray, R.reference_params())
    stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=R.SEQ)
    ib, ob = stream.batch(1, R.BATCH), stream.batch(7, R.BATCH,
                                                    clean_only=True)
    h0 = (0.1 * np.random.RandomState(4).randn(N_DOMAINS)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jstep(jp, {'domain_logits': jnp.asarray(h0)}, ib, ob, key)
    # build_hypergrad_step's solver draws at `key` over the stacked tree
    draw = jax.tree.map(np.asarray, JIndexer(jp).sample_indices(key, 8))
    got = build_hypergrad_step(cfg)(
        model_params_from_jax(R.reference_params(), cfg),
        {'domain_logits': torch.from_numpy(h0)},
        to_torch(ib), to_torch(ob), indices=model_indices_from_jax(draw, cfg))
    step_g = (np.asarray(want['domain_logits']) - h0)
    assert _rel(got['domain_logits'].numpy() - h0, step_g) <= 1e-4
    assert _rel(got['domain_logits'].numpy(), want['domain_logits']) <= 1e-5
