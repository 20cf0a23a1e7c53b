"""Training the recurrent families on the port against the reference:
Jamba (Mamba mixers; ``reduced(n_layers=8)``, one period with its MoE
FFNs) and RWKV-6 (``reduced()``), in f32 on the reference's parameters
(``model_params_from_jax``) and on numpy batches
(``tests/torch_train_reference.py``).

- The time loops alone: the gradients of ``mamba_scan`` (x and every
  leaf) and of ``rwkv_time_mix`` (x, the incoming token-shift
  predecessor and wkv state, every leaf) against ``jax.vjp`` of the
  reference's, within 1e-5 relative L2, at S = 16 (the reference scans
  in one piece) and S = 128 (it scans by chunks of 64 under
  ``jax.checkpoint``, and the port under ``torch.utils.checkpoint``).
- Chunking moves memory, not values: at S = 256 the port's gradients by
  chunks equal those of the loop in one piece bit for bit, and the
  autograd graph saves fewer bytes (counted by
  ``torch.autograd.graph.saved_tensors_hooks``).
- ``train_loss`` within 1e-5 relative and each leaf of its gradient
  within 1e-4 at S = 128, under ``remat`` 'none', 'full' and 'dots' (the
  chunk checkpoint nested in the block's); one ``build_train_step`` step
  against the reference's step (loss and gradient norm 1e-5, parameters
  1e-4).
- At S = 16: the HVP columns (k = 4, ``column_chunk=2``:
  ``vmap(jvp(grad))`` through the time loops in one piece) within 1e-4 of
  the reference's, Jamba's through the adapter that maps its MoE HVP with
  ``jax.lax.map``; the hypergradient of ``build_hypergrad_step`` within
  1e-4 of Eq. 3 from the reference's pieces on those columns (the
  reference cannot vmap Jamba's MoE or differentiate it twice in reverse,
  and each of its compiles of these programs takes tens of seconds on a
  CPU, so each is made once).
- At ``init``'s own parameters an HVP column chunk runs (no leaf is an
  expanded view, which forward-mode AD refuses).
- ``train_lm`` and the CLI train 4 steps of each with finite losses.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_reference as R
from repro.core.hvp import extract_columns as jextract_columns
from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.launch.train import build_losses as jbuild_losses
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models.transformer import train_loss as jtrain_loss
from repro_torch.convert import model_indices_from_jax, to_torch
from repro_torch.core import (HypergradConfig, PyTreeIndexer,
                              extract_columns, make_hvp)
from repro_torch.core.tree_util import tree_flatten, tree_leaves
from repro_torch.launch.steps import (N_DOMAINS, build_hypergrad_step,
                                      build_train_step, domain_losses,
                                      loss_and_grads, make_optimizer)
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_lm
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import train_loss
from torch_threads import torch_thread_cap  # noqa: F401

B, S_ONE, S_CHUNKED, S_LONG = 2, 16, 128, 256
K, RHO, CHUNK = 4, 1e-2, 2


def _mamba(seed: int, S: int):
    """The reference's Mamba leaves (numpy), x (B, S, d) and a cotangent
    of the output."""
    jcfg = R.configs(R.JAMBA)[0]
    params = jax.tree.map(np.asarray, jssm.init_mamba(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    x, gy = (rng.randn(B, S, jcfg.d_model).astype(np.float32)
             for _ in range(2))
    return params, (x,), (gy,)


def _rwkv(seed: int, S: int):
    """The reference's RWKV-6 leaves with the constant ones (mixes, decay
    bias, bonus, group-norm scale) drawn at random so that each matters;
    x (B, S, d), the predecessor (B, d) and a wkv state; cotangents of the
    output, the last token and the new state."""
    jcfg = R.configs(R.RWKV)[0]
    params = jax.tree.map(np.asarray, jrwkv.init_rwkv_block(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for name in ('mu', 'mu_cm', 'ln_scale'):
        params[name] = rng.uniform(0.1, 0.9, params[name].shape)
    params['bonus'] = 0.3 * rng.randn(*params['bonus'].shape)
    params['w0'] = rng.uniform(-6.0, -1.0, params['w0'].shape)
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    d, H = jcfg.d_model, jcfg.d_model // 64

    def draw(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)
    inputs = (draw(B, S, d), draw(B, d), draw(B, H, 64, 64, scale=0.1))
    cotangents = (draw(B, S, d), draw(B, d), draw(B, H, 64, 64))
    return params, inputs, cotangents


def _loop_fns(loop: str):
    """(the reference's function, the port's, the setup) of a time loop,
    each taking (params, *inputs) and a ``chunk``."""
    jcfg, cfg = R.configs(R.JAMBA if loop == 'mamba' else R.RWKV)
    if loop == 'mamba':
        return (lambda p, x: jssm.mamba_scan(p, x, jcfg),
                lambda p, x, chunk=64: tssm.mamba_scan(p, x, cfg, chunk),
                _mamba)
    return (lambda p, x, prev, st: jrwkv.rwkv_time_mix(p, x, prev, st, jcfg),
            lambda p, x, prev, st, chunk=64: trwkv.rwkv_time_mix(
                p, x, prev, st, cfg, chunk),
            _rwkv)


def _port_grads(fn, params, inputs, cotangents, **kw):
    """The port's outputs and the gradients of (inputs, every leaf of
    ``params``) for the cotangents, from tensors that require grad (0 for
    the leaves of RWKV's channel mix, which the time mix does not
    read)."""
    leaves, treedef = tree_flatten(to_torch(params))
    live = [t.requires_grad_(True) for t in leaves]
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    outs = fn(treedef.unflatten(live), *xs, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, xs + live,
                                [torch.from_numpy(c) for c in cotangents],
                                materialize_grads=True)
    return outs, list(grads[:len(xs)]), treedef.unflatten(list(grads[len(xs):]))


@pytest.mark.parametrize('S', [S_ONE, S_CHUNKED])
@pytest.mark.parametrize('loop', ['mamba', 'rwkv'])
def test_time_loop_gradients_match_the_reference_vjp(loop, S):
    jfn, tfn, setup = _loop_fns(loop)
    params, inputs, cotangents = setup(3, S)

    @jax.jit
    def reference(p, inputs, cts):
        outs, vjp = jax.vjp(jfn, p, *inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return outs, vjp(cts if len(cts) > 1 else cts[0])
    jouts, (want_p, *want_x) = reference(
        jax.tree.map(jnp.asarray, params), tuple(map(jnp.asarray, inputs)),
        tuple(map(jnp.asarray, cotangents)))
    outs, got_x, got_p = _port_grads(tfn, params, inputs, cotangents)
    for got, want in zip(list(outs) + got_x, list(jouts) + want_x):
        assert R.rel(got.detach().numpy(), want) <= 1e-5
    R.assert_leaves_close(got_p, to_torch(jax.tree.map(np.asarray, want_p)),
                          1e-5)


@pytest.mark.parametrize('loop', ['mamba', 'rwkv'])
def test_chunked_loop_is_the_loop_in_one_piece_and_saves_less(loop):
    """At S = 256 the chunks of 64 under ``torch.utils.checkpoint`` give
    the outputs and gradients of the loop in one piece (``chunk=S``) bit
    for bit; the graph's saved tensors (distinct storages, counted by a
    ``saved_tensors_hooks`` around the forward; checkpoint hides a chunk's
    interior behind its own hooks) shrink by at least the per-step states
    the loop in one piece keeps."""
    _, tfn, setup = _loop_fns(loop)
    params, inputs, cotangents = setup(4, S_LONG)
    runs = {}
    for chunk in (64, S_LONG):
        saved = {}

        def pack(t, saved=saved):
            saved[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            runs[chunk] = _port_grads(tfn, params, inputs, cotangents,
                                      chunk=chunk)
        runs[chunk] += (sum(saved.values()),)
    (outs, gx, gp, kept), (outs1, gx1, gp1, kept1) = runs[64], runs[S_LONG]
    for a, b in zip(list(outs) + gx + tree_leaves(gp),
                    list(outs1) + gx1 + tree_leaves(gp1)):
        assert torch.equal(a, b)
    cfg = R.configs(R.JAMBA if loop == 'mamba' else R.RWKV)[1]
    state = 4 * B * (cfg.d_inner * cfg.d_state if loop == 'mamba'
                     else cfg.d_model * 64)
    assert kept1 - kept >= (S_LONG - S_LONG // 64) * state, (kept, kept1)


@functools.lru_cache(maxsize=None)
def _reference_loss(arch):
    """The reference's parameters, loss and gradient at S = 128 (its
    loops chunked), and the batch."""
    jcfg = R.configs(arch)[0]
    jb, b = R.both(R.numpy_batch(arch, 1, seq=S_CHUNKED))
    jp = jax.tree.map(jnp.asarray, R.reference_params(arch))
    loss, grads = jax.jit(jax.value_and_grad(
        functools.partial(jtrain_loss, jcfg)))(jp, jb)
    return jp, float(loss), grads, b


@pytest.mark.parametrize('remat', ['none', 'full', 'dots'])
@pytest.mark.parametrize('arch', R.RECURRENT)
def test_train_loss_and_gradients_match_the_reference(arch, remat):
    _, want, jgrads, b = _reference_loss(arch)
    cfg = dataclasses.replace(R.configs(arch)[1], remat=remat,
                              scan_layers=True)
    got, grads = loss_and_grads(lambda p, batch: train_loss(cfg, p, batch),
                                R.port_tree(arch, R.reference_params(arch)),
                                b)
    assert abs(float(got) / want - 1) <= 1e-5
    R.assert_leaves_close(grads, R.port_tree(arch, jgrads), 1e-4)


@pytest.mark.parametrize('arch', R.RECURRENT)
def test_build_train_step_matches_the_reference(arch):
    """One step at S = 128 against the reference's step function's body
    (``value_and_grad`` of its ``train_loss``, its optimizer's ``apply``,
    the gradient norm) on the gradient that the test above compares."""
    jcfg, cfg = R.configs(arch)
    jp, jloss, jgrads, b = _reference_loss(arch)
    opt = jmake_optimizer(jcfg)
    jp, _ = jax.jit(opt.apply)(jgrads, opt.init(jp), jp, jnp.int32(0))
    jnorm = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                        for g in jax.tree.leaves(jgrads)))
    params = R.port_tree(arch, R.reference_params(arch))
    params, _, nxt, m = build_train_step(cfg)(
        params, make_optimizer(cfg).init(params), 0, b)
    assert nxt == 1
    assert abs(float(m['loss']) / jloss - 1) <= 1e-5
    assert abs(float(m['grad_norm']) / jnorm - 1) <= 1e-5
    assert R.tree_rel(params, R.port_tree(arch, jp)) <= 1e-4


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reduced config's parameters on both sides, an inner and an
    outer batch at S = 16 and the domain logits φ = 0 (from φ = 0 the
    hypergradient step −1e-2·g keeps g's precision, which h − 1e-2·g
    would round away); the reference's HVP columns at the draw of
    ``PRNGKey(11)``, k = 4. The inner batch's two examples come from two
    domains: with one domain the weighted loss does not depend on φ and
    every hypergradient is 0 (rounding noise in the reference)."""
    jcfg, cfg = R.configs(arch)
    jib, ib = R.both(R.numpy_batch(arch, 4, seq=S_ONE, domain=True))
    job, ob = R.both(R.numpy_batch(arch, 5, seq=S_ONE, domain=True))
    assert len(set(ib['domain'].tolist())) == B
    jp = jax.tree.map(jnp.asarray, R.reference_params(arch))
    h = np.zeros(N_DOMAINS, np.float32)
    jhvp = jmake_hvp(jbuild_losses(jcfg)[0], jp,
                     {'domain_logits': jnp.asarray(h)}, jib)
    if cfg.n_experts:          # the reference's MoE cannot run under vmap
        jhvp = R.serial_columns(jhvp)
    draw = jax.tree.map(np.asarray, JIndexer(jp).sample_indices(
        jax.random.PRNGKey(11), K))
    jcols = jextract_columns(jhvp, JIndexer(jp), draw, column_chunk=CHUNK)
    return dict(jcfg=jcfg, cfg=cfg, jib=jib, ib=ib, job=job, ob=ob, h=h,
                jp=jp, draw=draw, jcols=jcols,
                idx=model_indices_from_jax(draw, cfg),
                params=R.port_tree(arch, R.reference_params(arch)))


@pytest.mark.parametrize('arch', R.RECURRENT)
def test_hvp_columns_match_the_reference(arch):
    """Also: nothing the columns build inside ``torch.func``'s transforms
    stays cached wrapped at their levels (the RoPE tables of Jamba's
    attention, first built here), and a plain step runs after them."""
    s = _setup(arch)
    tlayers._frequencies_on.cache_clear()
    inner = domain_losses(s['cfg'])[0]
    h = {'domain_logits': torch.from_numpy(s['h'])}
    cols = extract_columns(make_hvp(inner, s['params'], h, s['ib']),
                           PyTreeIndexer(s['params']), s['idx'],
                           column_chunk=CHUNK)
    assert R.tree_rel(cols, R.port_columns(s['jcols'], s['cfg'])) <= 1e-4
    cached = [t for t in (tlayers._frequencies_on(
        s['cfg'].head_dim, s['cfg'].rope_theta, torch.device('cpu')),)
        if s['cfg'].n_heads]
    assert not any(torch._C._functorch.is_functorch_wrapped_tensor(t)
                   for t in cached)
    loss, _ = loss_and_grads(inner, s['params'], h, s['ib'])
    assert torch.isfinite(loss)


@pytest.mark.parametrize('arch', R.RECURRENT)
def test_hvp_columns_run_at_a_fresh_init(arch):
    """At ``init``'s own parameters, before any update: every leaf has
    memory of its own (Mamba's ``A_log`` was an expanded view of one row,
    which forward-mode AD refuses to make dual), and an HVP column chunk
    runs through the time loops."""
    s = _setup(arch)
    params = build_model(s['cfg'], device='cpu').init(
        torch.Generator().manual_seed(0))
    assert all(0 not in t.stride() for t in tree_leaves(params))
    indexer = PyTreeIndexer(params)
    idx = indexer.sample_indices(torch.Generator().manual_seed(1), CHUNK)
    cols = extract_columns(
        make_hvp(domain_losses(s['cfg'])[0], params,
                 {'domain_logits': torch.from_numpy(s['h'])}, s['ib']),
        indexer, idx, column_chunk=CHUNK)
    assert all(bool(torch.isfinite(c).all()) for c in tree_leaves(cols))


@pytest.mark.parametrize('arch', R.RECURRENT)
def test_build_hypergrad_step_matches_eq3_from_the_reference(arch):
    """``build_hypergrad_step(k=4)`` (``column_chunk=2``) at the draw of the
    columns above, from φ = 0: the step −1e-2·g, with g within 1e-4 of
    Eq. 3 from the reference's pieces (:func:`torch_train_reference.eq3`,
    on the reference's columns above)."""
    s = _setup(arch)
    want = R.eq3(s['jcfg'], s['jp'], s['h'], s['jib'], s['job'], s['draw'],
                 K, RHO, CHUNK, columns=s['jcols'])
    got = build_hypergrad_step(s['cfg'], k=K)(
        s['params'], {'domain_logits': torch.from_numpy(s['h'])}, s['ib'],
        s['ob'], indices=s['idx'])
    assert R.rel(-got['domain_logits'].numpy() / 1e-2, want) <= 1e-4


@pytest.mark.parametrize('arch', R.RECURRENT)
def test_train_lm_and_the_cli_train(arch, capsys):
    """4 inner steps and 2 outer steps each, ``train_lm`` on the one-period
    cut and the CLI on ``--reduced``: every loss and value finite."""
    run = train_lm(R.configs(arch)[1], HypergradConfig(k=K,
                                                       column_chunk=CHUNK),
                   steps=4, batch=B, seq=S_ONE, outer_every=2, log_every=0,
                   device='cpu')
    assert len(run.losses) == 4 and len(run.outer) == 2
    assert np.all(np.isfinite(run.losses + [o['val'] for o in run.outer]))
    assert all(bool(torch.isfinite(o['hypergrad']).all()) for o in run.outer)
    capsys.readouterr()
    train_main(['--arch', arch, '--reduced', '--steps', '4',
                '--outer-every', '2', '--batch', str(B), '--seq',
                str(S_ONE), '--k', str(K), '--log-every', '1', '--device',
                'cpu'])
    out = capsys.readouterr().out
    losses = [float(line.split('loss=')[1].split()[0])
              for line in out.splitlines() if line.startswith('[train] step')]
    vals = [float(line.split('val(pre-update)=')[1].split()[0])
            for line in out.splitlines() if line.startswith('[outer]')]
    assert len(losses) == 4 and len(vals) == 2
    assert np.all(np.isfinite(losses + vals))
