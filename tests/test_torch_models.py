"""Parity of the port's dense transformer with the reference's.

The reference's parameters (``init`` with a JAX key) are carried across by
``model_params_from_jax``; tokens are drawn with numpy from a seed. Both
sides run at ``cfg.reduced()`` size with B = 2, S = 64 > ``attn_chunk`` =
32, so attention takes the chunked twin (``use_pallas=False``) or the flash
kernel (``use_pallas=True``: Pallas in interpret mode on the reference's
side, the plain versions on the port's), and RMSNorm the plain path or the
kernel.

Tolerances, relative L2 of the logits: 1e-5 in f32 (the two sides round the
same f32 operations in different orders); 2e-2 in bf16, where either side
rounds each matmul's output to bf16 from its own f32 sum (the Pallas and
XLA paths of the reference itself differ by 7e-3 there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import _param_sds
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro_torch.configs import ALIASES, SHAPES, get_config
from repro_torch.configs import ARCHS as ALL_ARCHS
from repro_torch.convert import model_params_from_jax, to_torch
from repro_torch.kernels import _lib
from repro_torch.launch.steps import build_prefill_step, serve_params
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from torch_threads import torch_thread_cap  # noqa: F401

ARCHS = ['yi_9b', 'qwen2_7b']
#: every arch ``get_config`` returns: all ten of the reference's
CONFIG_ARCHS = ARCHS + ['llama3_405b', 'mistral_large_123b',
                        'phi35_moe_42b_a66b', 'llama4_maverick_400b_a17b',
                        'jamba_v01_52b', 'rwkv6_1b6', 'seamless_m4t_large_v2',
                        'qwen2_vl_7b']


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _reduced(arch, **kw):
    return (jax_get_config(arch).reduced(**kw),
            get_config(arch).reduced(**kw))


@pytest.mark.parametrize('arch', CONFIG_ARCHS)
def test_configs_equal_the_reference(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    for name in ('padded_vocab', 'group_size', 'block_period', 'n_blocks'):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    assert tcfg.layer_kinds() == jcfg.layer_kinds()
    assert tcfg.param_count() == jcfg.param_count()


def test_unported_archs_point_to_the_roadmap():
    """All ten archs are served (by id and by hyphenated alias); only an
    unknown id raises, naming the known ones."""
    assert sorted(ALL_ARCHS) == sorted(CONFIG_ARCHS)
    for arch in ALL_ARCHS:
        assert get_config(arch) is get_config(arch.replace('_', '-'))
        build_model(get_config(arch).reduced(), device='cpu')
    with pytest.raises(KeyError, match='unknown') as err:
        get_config('gpt5')
    assert all(alias in str(err.value) for alias in ALIASES)
    assert [s.name for s in SHAPES] == ['train_4k', 'prefill_32k',
                                        'decode_32k', 'long_500k']


def test_init_checks_the_generators_device():
    from repro_torch.models.transformer import init_params
    cfg = get_config('yi_9b').reduced()
    with pytest.raises(ValueError, match='generator on cpu'):
        init_params(cfg, torch.Generator(), device='meta')
    params = init_params(cfg, torch.Generator().manual_seed(0), device='cpu')
    assert params['embed']['table'].device.type == 'cpu'


def test_every_config_trains():
    """All ten configs pass the training entry points at ``reduced()``
    size: ``build_train_step`` takes one step, ``build_hypergrad_step``
    builds, on a batch in ``make_batch_sds``'s layout (B = 1, S = 4); the
    loss and the gradient norm are finite. The recurrent mixers (Jamba's
    Mamba, RWKV-6) train too; parity with the reference is in
    ``tests/test_torch_train_*.py``."""
    from repro_torch.launch.steps import (build_hypergrad_step,
                                          build_train_step, make_batch_sds,
                                          make_optimizer)
    assert sorted(CONFIG_ARCHS) == sorted(ALL_ARCHS)
    for arch in CONFIG_ARCHS:
        cfg = get_config(arch).reduced()
        gen = torch.Generator().manual_seed(0)
        params = build_model(cfg, device='cpu').init(gen)
        batch = {}
        for name, sds in make_batch_sds(cfg, 1, 4).items():
            if name == 'mask':
                batch[name] = torch.ones(sds.shape)
            elif sds.dtype.is_floating_point:
                batch[name] = torch.randn(sds.shape, generator=gen).to(
                    sds.dtype)
            else:
                batch[name] = torch.randint(0, 4, sds.shape, generator=gen,
                                            dtype=sds.dtype)
        _, _, step, m = build_train_step(cfg)(
            params, make_optimizer(cfg).init(params), 0, batch)
        assert step == 1, arch
        assert np.isfinite(float(m['loss'])), arch
        assert np.isfinite(float(m['grad_norm'])), arch
        assert callable(build_hypergrad_step(cfg)), arch


@pytest.mark.parametrize('theta', [10_000.0, 1_000_000.0])
def test_rope_matches_the_reference(theta):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 40, 3, 128).astype(np.float32)
    pos = rng.randint(0, 32768, size=(2, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        tlayers.rope_frequencies(128, theta).numpy(),
        np.asarray(jlayers.rope_frequencies(128, theta)))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.tensor(x), tlayers.rope_tables(
        torch.tensor(pos), 128, theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_mlp_and_padded_unembed_match_the_reference():
    jcfg, tcfg = _reduced('yi_9b', vocab_size=250)
    assert tcfg.padded_vocab == 256
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 64).astype(np.float32)
    w = {'w1': rng.randn(64, 128), 'w3': rng.randn(64, 128),
         'w2': rng.randn(128, 64)}
    w = {k: (v / 8).astype(np.float32) for k, v in w.items()}
    table = rng.randn(256, 64).astype(np.float32)
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                       jnp.asarray(x), jcfg)
    got = tlayers.mlp(to_torch(w), torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(jlayers.unembed({'table': jnp.asarray(table)},
                                      jnp.asarray(x), jcfg))
    got = tlayers.unembed({'table': torch.tensor(table)}, torch.tensor(x),
                          tcfg).numpy()
    assert (got[..., 250:] == np.finfo(np.float32).min).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('causal', [True, False])
def test_attention_twins_match_the_reference(causal):
    """_full_attention and _chunked_attention (S = 96, chunk 32) on the
    same q, k, v."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 96, 4, 16).astype(np.float32) for _ in range(3))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        tattn._full_attention(tq, tk, tv, causal, 0.25).numpy(),
        np.asarray(jattn._full_attention(jq, jk, jv, causal, 0.25)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tattn._chunked_attention(tq, tk, tv, causal, 0.25, 32).numpy(),
        np.asarray(jattn._chunked_attention(jq, jk, jv, causal, 0.25, 32)),
        rtol=1e-5, atol=1e-5)


def _jax_and_port_params(jcfg, tcfg):
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jparams, model_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg)


@pytest.mark.parametrize('use_pallas', [True, False])
@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5),
                                       ('bfloat16', 2e-2)])
@pytest.mark.parametrize('arch', ARCHS)
def test_forward_matches_the_reference(arch, dtype, tol, use_pallas):
    jcfg, tcfg = _reduced(arch, compute_dtype=dtype, use_pallas=use_pallas)
    jparams, tparams = _jax_and_port_params(jcfg, tcfg)
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 64))
    want, _ = jax_build_model(jcfg).forward(jparams, jnp.asarray(tokens))
    _lib.reset_launches()
    got, aux = build_model(tcfg, device='cpu').forward(
        tparams, torch.tensor(tokens))
    assert set(_lib.LAUNCHES.values()) == {0}       # CPU: plain versions
    assert got.shape == (2, 64, tcfg.padded_vocab) and float(aux) == 0.0
    assert got.dtype == tlayers.cdtype(tcfg)
    assert _rel_l2(_np(got), want) <= tol


@pytest.mark.parametrize('arch', ARCHS)
def test_prefill_step_after_serve_params_matches_the_reference(arch):
    """Serving: params cast to bf16 at load, bf16 compute, flash and
    RMSNorm kernels on the path; the next-token logits."""
    jcfg, tcfg = _reduced(arch, compute_dtype='bfloat16', use_pallas=True)
    jparams, tparams = _jax_and_port_params(jcfg, tcfg)
    sds = _param_sds(jcfg, serve=True)
    jparams = jax.tree.map(lambda p, s: p.astype(s.dtype), jparams, sds)
    tparams = serve_params(tparams)
    assert {p.dtype for p in jax.tree.leaves(jparams)} == {
        jnp.dtype(jnp.bfloat16)}
    tokens = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 64))
    logits, _ = jax_build_model(jcfg).forward(jparams, jnp.asarray(tokens))
    want = logits[:, -1, :]
    got = build_prefill_step(tcfg, device='cpu')(
        tparams, {'inputs': torch.tensor(tokens)})
    assert got.shape == (2, tcfg.padded_vocab)
    assert _rel_l2(_np(got), want) <= 2e-2


def _shapes(tree, prefix=''):
    """{'path/to/leaf': shape} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f'{prefix}/{key}').items()}
    return {prefix: tuple(tree.shape)}


def test_init_draws_the_reference_shapes_in_the_param_dtype():
    """The port's per-layer blocks have the reference's stacked shapes
    without their leading n_blocks axis."""
    jcfg, tcfg = _reduced('qwen2_7b', param_dtype='bfloat16')
    jtree = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    params = build_model(tcfg, device='cpu').init(
        torch.Generator().manual_seed(0))
    assert len(params['blocks']) == tcfg.n_blocks
    want = {k: v[1:] for k, v in _shapes(jtree['blocks']).items()}
    for block in params['blocks']:
        assert _shapes(block) == want
    rest = {k: v for k, v in jtree.items() if k != 'blocks'}
    assert _shapes({k: v for k, v in params.items() if k != 'blocks'}) \
        == _shapes(rest)
    leaves = [t for b in params['blocks'] for s in b.values()
              for sub in s.values() for t in sub.values()]
    assert {t.dtype for t in leaves} == {torch.bfloat16}
    wq = params['blocks'][0]['slot0']['mixer']['wq'].float()
    assert float(wq.abs().max()) <= 3 * 64 ** -0.5 + 1e-2   # ±3σ truncation


def test_bf16_arrays_carry_across_bit_for_bit():
    x = jax.random.normal(jax.random.PRNGKey(5), (7, 33)).astype(jnp.bfloat16)
    t = to_torch({'x': np.asarray(x)})['x']
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
