"""MoE training on the port against the reference, at the ``reduced()``
configs of Phi-3.5-MoE and Llama-4 Maverick in f32, on the reference's
parameters and on numpy batches (``tests/torch_train_reference.py``).

- The grouped expert product's gradients against the VJP of the
  reference's ``_rdot``: dx and dw within 1e-5 relative L2 in f32 and
  within one bf16 ulp of the largest entry in bf16; an expert with no
  token gets an exact 0. Its serving path (``out=`` under
  ``inference_mode``) gives the training path's values bit for bit, and
  its forward-over-reverse HVP under ``torch.func.vmap`` matches the
  reference's per column (1e-5).
- The router's load-balance aux: its gradient reaches ``router`` through
  the mean probabilities alone (1e-5).
- The HVP columns (k = 4, ``column_chunk=2``) through the model, within
  1e-4 relative L2 of the reference's, taken through the adapter that
  maps the reference's HVP with ``jax.lax.map`` (its ``jax.vmap`` raises
  in ``ragged_dot``).
- The hypergradient of ``lm_hypergrad`` and ``build_hypergrad_step``
  within 1e-4 of Eq. 3 assembled from the reference's pieces: its
  ``NystromIHVP.prepare`` fed the adapter HVP, its ``apply``, and the
  mixed term forward over reverse, a coordinate of φ at a time (the
  reference's reverse-over-reverse mixed term raises in ``ragged_dot``'s
  transpose, see :func:`_eq3`).
- Under remat the routing runs again in the recompute: once in the
  forward and once in the backward a MoE layer, each with its host sync.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_train_reference as R
from repro.core.hvp import extract_columns as jextract_columns
from repro.core.hvp import make_hvp as jmake_hvp
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.launch.train import build_losses as jbuild_losses
from repro.models import moe as jmoe
from repro_torch.convert import model_indices_from_jax, model_params_from_jax
from repro_torch.core import (NystromIHVP, PyTreeIndexer, extract_columns,
                              make_hvp)
from repro_torch.core.tree_util import tree_leaves
from repro_torch.launch.steps import (N_DOMAINS, build_hypergrad_step,
                                      domain_losses, lm_hypergrad,
                                      loss_and_grads)
from repro_torch.models import moe as tmoe
from torch_threads import torch_thread_cap  # noqa: F401

K, RHO, CHUNK = 4, 1e-2, 2
SIZES = [5, 0, 7, 3]          # tokens per expert: expert 1 gets none
D, F = 16, 24


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of x (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


def _operands(seed: int = 0):
    """x (N, d), w (E, d, f) and dy (N, f) in f32, on the bf16 grid so
    that both dtypes see the same values."""
    rng = np.random.RandomState(seed)
    n = sum(SIZES)

    def draw(*shape):
        return rng.randn(*shape).astype(ml_dtypes.bfloat16).astype(
            np.float32)
    return draw(n, D), draw(len(SIZES), D, F) * D ** -0.5, draw(n, F)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_grouped_product_gradients_match_the_rdot_vjp(dtype):
    x, w, dy = _operands()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    sizes = jnp.asarray(SIZES, jnp.int32)
    # the reference's w is the weight cast to the compute dtype
    want_y, vjp = jax.vjp(lambda a, b: jmoe._rdot(a, b, sizes),
                          jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want_dx, want_dw = vjp(jnp.asarray(dy, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)      # an f32 parameter
    y = tmoe._grouped(tx, tw, SIZES, tdt)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(dy).to(tdt))
    assert y.dtype == dx.dtype == tdt and dw.dtype == torch.float32
    assert torch.equal(dw[1], torch.zeros_like(dw[1]))
    assert not np.any(_np(want_dw)[1])
    for got, want in ((y, want_y), (dx, want_dx), (dw, want_dw)):
        got, want = _np(got), _np(want)
        if dtype == 'float32':
            assert _rel(got, want) <= 1e-5
        else:
            assert np.abs(got - want).max() <= _bf16_ulp(want)


def test_grouped_product_serves_the_training_values():
    x, w, _ = _operands(1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    train = tmoe._grouped(tx, tw, SIZES, torch.float32)
    with torch.inference_mode():
        serve = tmoe._grouped(tx, tw, SIZES, torch.float32)
    assert torch.equal(serve, train)


def test_grouped_product_hvp_under_vmap_matches_the_reference():
    """Forward-over-reverse through the grouped product, two tangents
    under ``torch.func.vmap``, against the reference's ``jax.jvp`` of
    ``jax.grad`` through ``_rdot``, one tangent at a time."""
    x, w, c = _operands(2)
    sizes = jnp.asarray(SIZES, jnp.int32)
    rng = np.random.RandomState(3)
    vx = rng.randn(2, *x.shape).astype(np.float32)
    vw = rng.randn(2, *w.shape).astype(np.float32)

    def jloss(a, b):
        return 0.5 * jnp.sum((jmoe._rdot(a, b, sizes) * c) ** 2)

    def tloss(a, b):
        return 0.5 * torch.sum((tmoe._grouped(a, b, SIZES, torch.float32)
                                * torch.from_numpy(c)) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))
    tg = torch.func.grad(tloss, argnums=(0, 1))
    prim = (torch.from_numpy(x), torch.from_numpy(w))
    got = torch.func.vmap(lambda tx, tw: torch.func.jvp(
        lambda a, b: tg(a, b), prim, (tx, tw))[1])(
            torch.from_numpy(vx), torch.from_numpy(vw))
    for j in range(2):
        want = jax.jvp(jg, (jnp.asarray(x), jnp.asarray(w)),
                       (jnp.asarray(vx[j]), jnp.asarray(vw[j])))[1]
        for g, wnt in zip(got, want):
            assert _rel(_np(g[j]), _np(wnt)) <= 1e-5
        assert not np.any(_np(got[1][j])[1])      # no token, no curvature


def _moe_layer(arch):
    """(the reference's and the port's config, one MoE layer's parameters
    as numpy, tokens (N, d) f32)."""
    jcfg, cfg = R.configs(arch)
    params = jax.tree.map(np.asarray, jmoe.init_moe(
        jcfg, jax.random.PRNGKey(1)))
    x = np.random.RandomState(4).randn(40, cfg.d_model).astype(np.float32)
    return jcfg, cfg, params, x


@pytest.mark.parametrize('arch', R.MOE)
def test_router_aux_gradient_matches_the_reference(arch):
    jcfg, cfg, params, x = _moe_layer(arch)
    want = jax.grad(lambda r: jmoe._moe_local(
        dict(jax.tree.map(jnp.asarray, params), router=r),
        jnp.asarray(x), jcfg)[1])(jnp.asarray(params['router']))
    router = torch.from_numpy(params['router']).requires_grad_(True)
    tparams = dict(jax.tree.map(torch.from_numpy, params), router=router)
    _, aux = tmoe._moe_local(tparams, torch.from_numpy(x), cfg)
    (got,) = torch.autograd.grad(aux, router)
    assert _rel(_np(got), _np(want)) <= 1e-5
    # frac (the routed share) is constant: the gradient is that of
    # E · Σ frac · mean(probs) with frac held
    _, _, _, counts, _ = tmoe.route(tparams, torch.from_numpy(x), cfg)
    frac = counts.float() / counts.sum()

    def held(r):
        probs = torch.softmax(torch.from_numpy(x) @ r, dim=-1)
        return (cfg.n_experts * torch.sum(frac * probs.mean(0))
                * cfg.router_aux_coef)
    (want_held,) = torch.autograd.grad(held(router), router)
    assert _rel(_np(got), _np(want_held)) <= 1e-6


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, cfg = R.configs(arch)
    jib, ib = R.both(R.numpy_batch(arch, 8, domain=True))
    job, ob = R.both(R.numpy_batch(arch, 9, domain=True))
    h = (0.1 * np.random.RandomState(10).randn(N_DOMAINS)).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jib=jib, ib=ib, job=job, ob=ob, h=h,
                jp=jax.tree.map(jnp.asarray, R.reference_params(arch)),
                params=model_params_from_jax(R.reference_params(arch), cfg))


@pytest.mark.parametrize('arch', R.MOE)
def test_hvp_columns_match_the_reference_through_the_adapter(arch):
    s = _setup(arch)
    jinner = jbuild_losses(s['jcfg'])[0]
    jh = {'domain_logits': jnp.asarray(s['h'])}
    draw = jax.tree.map(np.asarray, JIndexer(s['jp']).sample_indices(
        jax.random.PRNGKey(11), K))
    jcols = jextract_columns(
        R.serial_columns(jmake_hvp(jinner, s['jp'], jh, s['jib'])),
        JIndexer(s['jp']), draw, column_chunk=CHUNK)
    idx = model_indices_from_jax(draw, s['cfg'])
    cols = extract_columns(
        make_hvp(domain_losses(s['cfg'])[0], s['params'],
                 {'domain_logits': torch.from_numpy(s['h'])}, s['ib']),
        PyTreeIndexer(s['params']), idx, column_chunk=CHUNK)
    assert R.tree_rel(cols, R.port_columns(jcols, s['cfg'])) <= 1e-4
    gk = PyTreeIndexer(s['params']).gather(cols, idx).numpy()
    wk = np.asarray(JIndexer(s['jp']).gather(jcols, draw))
    assert _rel(gk, wk) <= 1e-4


def _eq3(arch, draw, k: int = K, h=None):
    """The hypergradient of Eq. 3 from the reference's pieces
    (:func:`torch_train_reference.eq3`) at ``draw``, ``h`` (default the
    setup's logits)."""
    s = _setup(arch)
    return R.eq3(s['jcfg'], s['jp'], s['h'] if h is None else h, s['jib'],
                 s['job'], draw, k, RHO, CHUNK)


@pytest.mark.parametrize('arch', R.MOE)
def test_hypergradient_matches_eq3_from_the_reference_pieces(arch):
    s = _setup(arch)
    draw = jax.tree.map(np.asarray, JIndexer(s['jp']).sample_indices(
        jax.random.PRNGKey(12), K))
    want = _eq3(arch, draw)
    idx = model_indices_from_jax(draw, s['cfg'])
    inner, outer = domain_losses(s['cfg'])
    h = {'domain_logits': torch.from_numpy(s['h'])}
    solver = NystromIHVP(k=K, rho=RHO, column_chunk=CHUNK, backend='flat')
    _, hg = lm_hypergrad(solver, inner, outer, s['params'], h, s['ib'],
                         s['ob'], indices=idx)
    assert _rel(_np(hg['domain_logits']), want) <= 1e-4


@pytest.mark.parametrize('arch', R.MOE)
def test_build_hypergrad_step_takes_eq3_from_the_reference_pieces(arch):
    """``build_hypergrad_step`` (k = 8, ``column_chunk=2``) from φ = 0:
    −1e-2·g, with g within 1e-4 of Eq. 3 at the same draw (from φ = 0 the
    step keeps g's precision, which h − 1e-2·g would round away)."""
    s = _setup(arch)
    draw = jax.tree.map(np.asarray, JIndexer(s['jp']).sample_indices(
        jax.random.PRNGKey(13), 8))
    h = np.zeros(N_DOMAINS, np.float32)
    want = _eq3(arch, draw, 8, h)
    got = build_hypergrad_step(s['cfg'])(
        s['params'], {'domain_logits': torch.from_numpy(h)}, s['ib'],
        s['ob'], indices=model_indices_from_jax(draw, s['cfg']))
    assert _rel(-got['domain_logits'].numpy() / 1e-2, want) <= 1e-4


@pytest.mark.parametrize('arch', R.MOE)
def test_remat_routes_again_in_the_recompute(arch, monkeypatch):
    """Under ``remat='full'`` (with ``scan_layers``) each MoE layer routes,
    and reads its group sizes on the host, twice a training step: in the
    forward and again in the backward's recompute; without remat once.
    The gradients are the same either way."""
    s = _setup(arch)
    calls = []
    route = tmoe.route

    def counted(*args):
        calls.append(1)
        return route(*args)
    monkeypatch.setattr(tmoe, 'route', counted)
    layers = sum(f == 'moe' for _, f in s['cfg'].layer_kinds()) \
        * s['cfg'].n_blocks
    grads = {}
    for remat in ('none', 'full'):
        cfg = dataclasses.replace(s['cfg'], remat=remat, scan_layers=True)
        calls.clear()
        _, grads[remat] = loss_and_grads(
            lambda p, b: domain_losses(cfg)[0](
                p, {'domain_logits': torch.from_numpy(s['h'])}, b),
            s['params'], s['ib'])
        assert len(calls) == layers * (2 if remat == 'full' else 1)
    for a, b in zip(tree_leaves(grads['none']), tree_leaves(grads['full'])):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
