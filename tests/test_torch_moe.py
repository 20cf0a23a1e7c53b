"""Parity of the port's MoE family with the reference's.

``moe_ffn`` (the reference's ``_moe_local`` on its ``impl='ragged'`` path,
which it takes outside a mesh), the transformer ``forward`` of the two MoE
archs at ``reduced()`` size, their parameter trees, and that the training
entry points now train them. The reference's parameters are carried across by
``model_params_from_jax``; inputs are drawn with numpy from a seed.

Tolerances: relative L2 1e-5 on outputs and logits in f32, 1e-6 absolute on
the aux loss, the experts chosen equal. In bf16 the router's input may
differ by one rounding between the two sides, so a token near a tie may go
to another expert: the bf16 cases compare only the tokens whose margin
between the k-th and (k+1)-th router probability exceeds 1e-3 in the
reference (``moe_ffn``) or where both sides chose the same experts in
every MoE layer, for that token and every one before it in its sequence
(``forward``, whose flips must all be at margins below 1e-2), print how
many they left out, and hold those to 2e-2, as the dense family's
logits.
"""
import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, to_torch
from repro_torch.kernels import _lib
from repro_torch.launch.steps import build_hypergrad_step, build_step
from repro_torch.launch.steps import make_optimizer as step_optimizer
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import abstract_params, train_loss
from torch_threads import torch_thread_cap  # noqa: F401

MOE_ARCHS = ['phi35_moe_42b_a66b', 'llama4_maverick_400b_a17b']


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _reduced(arch, **kw):
    return (jax_get_config(arch).reduced(**kw),
            get_config(arch).reduced(**kw))


@pytest.fixture(scope='module', params=MOE_ARCHS)
def moe_params(request):
    """(arch, the reference's MoE params of one layer as numpy)."""
    jcfg, _ = _reduced(request.param)
    params = jmoe.init_moe(jcfg, jax.random.PRNGKey(0))
    return request.param, jax.tree.map(np.asarray, params)


def _ref_choice(params, x, cfg):
    """The reference's f32 router on x (N, d): probs and the top-k experts."""
    logits = jnp.asarray(x, jnp.float32) @ jnp.asarray(params['router'],
                                                       jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    return np.asarray(probs), np.asarray(idx)


def _both(params, x, jcfg, tcfg):
    """(reference out, aux), (port out, aux, experts) on x (N, d)."""
    want, want_aux = jmoe._moe_local(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(x), jcfg)
    tx = to_torch({'x': x})['x']
    got, aux = tmoe._moe_local(to_torch(params), tx, tcfg)
    _, _, experts, _, _ = tmoe.route(to_torch(params), tx, tcfg)
    return (np.asarray(want), float(want_aux)), (got, float(aux), experts)


def test_moe_ffn_matches_the_reference_in_f32(moe_params):
    arch, params = moe_params
    jcfg, tcfg = _reduced(arch)
    x = np.random.RandomState(1).randn(2, 24, jcfg.d_model).astype(np.float32)
    want, want_aux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(to_torch(params), torch.tensor(x), tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel_l2(_np(got), want) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    _, idx = _ref_choice(params, x.reshape(-1, jcfg.d_model), jcfg)
    _, _, experts, _, _ = tmoe.route(to_torch(params),
                                  torch.tensor(x.reshape(-1, jcfg.d_model)),
                                  tcfg)
    np.testing.assert_array_equal(experts.numpy(), idx)


def test_moe_ffn_skips_an_expert_with_no_token(moe_params):
    """Every token shifted along feature 0, and the router's weight there
    for the last expert made large and negative: it gets no token."""
    arch, params = moe_params
    jcfg, tcfg = _reduced(arch)
    params = dict(params, router=params['router'].copy())
    params['router'][0, -1] = -20.0
    x = np.random.RandomState(2).randn(40, jcfg.d_model).astype(np.float32)
    x[:, 0] += 5.0
    (want, want_aux), (got, aux, experts) = _both(params, x, jcfg, tcfg)
    counts = np.bincount(experts.numpy().reshape(-1),
                         minlength=jcfg.n_experts)
    assert counts[-1] == 0 and counts.sum() == 40 * jcfg.top_k
    np.testing.assert_array_equal(experts.numpy(),
                                  _ref_choice(params, x, jcfg)[1])
    assert _rel_l2(_np(got), want) <= 1e-5
    assert abs(aux - want_aux) <= 1e-6


def test_moe_ffn_matches_the_reference_in_bf16(moe_params):
    arch, params = moe_params
    jcfg, tcfg = _reduced(arch, compute_dtype='bfloat16')
    x = np.asarray(jnp.asarray(np.random.RandomState(3).randn(
        64, jcfg.d_model), jnp.bfloat16))
    (want, want_aux), (got, aux, experts) = _both(params, x, jcfg, tcfg)
    assert got.dtype == torch.bfloat16
    probs, idx = _ref_choice(params, x, jcfg)
    keep = _margins(probs, jcfg.top_k) > 1e-3
    print(f'{arch} bf16: {int((~keep).sum())} of {len(keep)} tokens within '
          '1e-3 of a routing tie left out')
    assert keep.sum() >= len(keep) // 2
    np.testing.assert_array_equal(experts.numpy()[keep], idx[keep])
    assert _rel_l2(_np(got)[keep], np.asarray(want, np.float32)[keep]) \
        <= 2e-2
    assert abs(aux - want_aux) <= 1e-6


def _jax_and_port_params(jcfg, tcfg):
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jparams, model_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg)


def _margins(probs: np.ndarray, k: int) -> np.ndarray:
    """Per token, the k-th largest router probability less the (k+1)-th."""
    ranked = np.sort(probs, axis=-1)[..., ::-1]
    return ranked[..., k - 1] - ranked[..., k]


@pytest.mark.parametrize('use_pallas', [True, False])
@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5),
                                       ('bfloat16', 2e-2)])
@pytest.mark.parametrize('arch', MOE_ARCHS)
def test_moe_forward_matches_the_reference(arch, dtype, tol, use_pallas,
                                           monkeypatch):
    """Both sides' routing is recorded layer by layer: the reference runs
    its blocks in a Python loop (``scan_layers=False``, the same math) so
    that its router inputs are concrete. In f32 the experts chosen are
    equal everywhere. In bf16 the router inputs differ by bf16 roundings, so a token within about 1e-2 of a tie may go to another
    expert. Every such flip must be at a token whose margin in the
    reference is below 1e-2, and the logits are compared at the tokens
    with no flip at or before them in their sequence (causal attention
    carries a flipped token's change to the tokens after it)."""
    jcfg, tcfg = _reduced(arch, compute_dtype=dtype, use_pallas=use_pallas,
                          scan_layers=False)
    jparams, tparams = _jax_and_port_params(jcfg, tcfg)
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 64))
    ref_routes, port_routes = [], []
    route = tmoe.route

    def port_recording(params, xt, cfg):
        out = route(params, xt, cfg)
        port_routes.append(np.sort(out[2].numpy(), axis=-1))
        return out

    ffn = jmoe.moe_ffn

    def ref_recording(params, x, cfg):
        probs, idx = _ref_choice(params, np.asarray(
            x, np.float32).reshape(-1, cfg.d_model), cfg)
        ref_routes.append((_margins(probs, cfg.top_k), np.sort(idx, axis=-1)))
        return ffn(params, x, cfg)

    monkeypatch.setattr(tmoe, 'route', port_recording)
    monkeypatch.setattr(jmoe, 'moe_ffn', ref_recording)
    want, want_aux = jax_build_model(jcfg).forward(jparams,
                                                   jnp.asarray(tokens))
    _lib.reset_launches()
    got, aux = build_model(tcfg, device='cpu').forward(
        tparams, torch.tensor(tokens))
    assert set(_lib.LAUNCHES.values()) == {0}       # CPU: plain versions
    assert got.shape == (2, 64, tcfg.padded_vocab)
    assert got.dtype == tlayers.cdtype(tcfg)
    n_moe = sum(f == 'moe' for _, f in tcfg.layer_kinds()) * tcfg.n_blocks
    assert len(port_routes) == len(ref_routes) == n_moe
    flipped = np.zeros(128, bool)
    for (margin, ref_idx), port_idx in zip(ref_routes, port_routes):
        flip = (ref_idx != port_idx).any(-1)
        assert (margin[flip] < 1e-2).all(), margin[flip]
        flipped |= flip
    keep = ~np.logical_or.accumulate(flipped.reshape(2, 64), axis=1)
    print(f'{arch} {dtype} forward: {int(flipped.sum())} routing flips, '
          f'{int((~keep).sum())} of {keep.size} tokens left out with the '
          'tokens after them')
    if dtype == 'float32':
        assert not flipped.any()
    assert keep.sum() >= keep.size // 4
    want = np.asarray(want, np.float32)
    assert _rel_l2(_np(got)[keep], want[keep]) <= tol
    assert abs(float(aux) - float(want_aux)) <= (1e-6 if dtype == 'float32'
                                                 else 1e-3)


def _shapes(tree, prefix=''):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f'{prefix}/{key}').items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype))}


@pytest.mark.parametrize('arch', MOE_ARCHS)
def test_moe_trees_carry_across_block_by_block(arch):
    """The reference's stacked MoE leaves (router, experts (n_blocks, E,
    d, f), shared expert) split by block onto the port's tree: names,
    shapes and values."""
    jcfg, tcfg = _reduced(arch)
    jparams = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(1)))
    tparams = model_params_from_jax(jparams, tcfg)
    want = {k: (v[0][1:], v[1]) for k, v in _shapes(jparams['blocks']).items()}
    port = abstract_params(tcfg)
    for b, block in enumerate(tparams['blocks']):
        shapes = {k: (v[0], v[1].replace('torch.', ''))
                  for k, v in _shapes(block).items()}
        assert shapes == want
        assert _shapes(block) == _shapes(port['blocks'][b])
        for i, (_, ffn) in enumerate(tcfg.layer_kinds()):
            for name in ('router', 'w1', 'w3', 'w2'):
                if ffn == 'moe':
                    np.testing.assert_array_equal(
                        block[f'slot{i}']['ffn'][name].numpy(),
                        jparams['blocks'][f'slot{i}']['ffn'][name][b])
    moe_slots = [i for i, (_, f) in enumerate(tcfg.layer_kinds())
                 if f == 'moe']
    ffn = tparams['blocks'][0][f'slot{moe_slots[0]}']['ffn']
    assert ffn['w1'].shape == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    assert ('shared' in ffn) == tcfg.shared_expert


@pytest.mark.parametrize('arch', MOE_ARCHS)
def test_moe_init_draws_each_expert_in_the_param_dtype(arch):
    tcfg = get_config(arch).reduced(param_dtype='bfloat16')
    params = build_model(tcfg, device='cpu').init(
        torch.Generator().manual_seed(0))
    slot = [i for i, (_, f) in enumerate(tcfg.layer_kinds()) if f == 'moe'][0]
    ffn = params['blocks'][0][f'slot{slot}']['ffn']
    assert {t.dtype for t in ffn.values() if torch.is_tensor(t)} == {
        torch.bfloat16}
    w1 = ffn['w1'].float()
    assert float(w1.abs().max()) <= 3 * tcfg.d_model ** -0.5 + 1e-2
    assert not torch.equal(w1[0], w1[1])           # experts drawn apart
    assert float(ffn['router'].float().abs().max()) \
        <= 3 * tcfg.d_model ** -0.5 + 1e-2


@pytest.mark.parametrize('arch', MOE_ARCHS)
def test_moe_training_entry_points_train(arch):
    """The entry points that refused MoE train it now: ``train_lm`` and the
    CLI's LM route on ``TokenStream`` batches (finite losses, outer steps
    logged), ``build_train_step`` and ``build_hypergrad_step`` on a
    ``make_batch_sds`` batch. Serving is unchanged. Their values against
    the reference are in ``tests/test_torch_train_{families,moe}.py``."""
    cfg = get_config(arch).reduced()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = train_main(['--arch', arch, '--reduced', '--steps', '4',
                          '--outer-every', '2', '--batch', '2', '--seq', '8',
                          '--log-every', '2', '--device', 'cpu'])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f'[train] arch={cfg.name}')
    assert sum(line.startswith('[outer] step') for line in lines) == 2
    assert lines[-1].startswith('[train] done: 4 steps, final loss')
    assert np.isfinite(run.losses).all() and len(run.outer) == 2
    assert all(bool(torch.isfinite(o['hypergrad']).all()) for o in run.outer)
    params = build_model(cfg, device='cpu').init(
        torch.Generator().manual_seed(0))
    batch = {'inputs': torch.randint(0, cfg.vocab_size, (2, 8),
                                     generator=torch.Generator().manual_seed(1)),
             'labels': torch.randint(0, cfg.vocab_size, (2, 8),
                                     generator=torch.Generator().manual_seed(2)),
             'domain': torch.tensor([3, 5])}
    step = build_step(cfg, 'train')
    _, _, nxt, m = step(params, step_optimizer(cfg).init(params), 0, batch)
    assert nxt == 1 and math.isfinite(float(m['loss']))
    assert float(m['grad_norm']) > 0
    h = build_hypergrad_step(cfg, k=4)(
        params, {'domain_logits': torch.zeros(64)}, batch, batch,
        rng=torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(h['domain_logits']).all())
    assert float(train_loss(cfg, params, batch)) > 0
    build_step(cfg, 'prefill', device='cpu')       # serving as before
    build_step(cfg, 'decode', device='cpu')
