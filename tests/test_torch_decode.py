"""Parity of the port's decode path with the reference's.

``init_cache`` against the reference's ``jax.eval_shape`` of its own;
``decode_step`` over 6 inputs from an empty cache (B = 2, ``max_len`` = 8)
against the reference's under one ``jax.jit`` per arch, for all ten archs
at ``reduced()`` size in f32; the port's decode against its own
``forward``; ``build_serve_step`` / ``build_step``; and the cache's
carriage across packages (``cache_from_jax``, ``cache_to_numpy``).

Inputs are tokens, or (B, 1, d) embeddings where the arch takes them
(Qwen2-VL). An encoder-decoder (SeamlessM4T) first encodes ``cross_len``
frames and fills the cross cache on each side (``fill_cross_cache``); its
decode unembeds through ``embed`` where its ``forward`` uses ``unembed``
(the reference's own choice), so its decode is held against a forward
whose ``unembed`` is its ``embed``. Mamba's and RWKV's recurrent states
ride in the cache beside the attention k and v.

Tolerances, relative L2: 1e-5 on the logits (the two sides round the same
f32 operations in different orders; the port contracts each KV head of
the cache where it lies instead of repeating the heads), 1e-6 on the
carried-back k and v (their entries are single projections), 1e-5 on the
carried-back recurrent states (sums over the steps, as the logits are),
1e-5 between the port's decode and its own forward.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.transformer import fill_cross_cache as jax_fill_cross_cache
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 model_params_from_jax)
from repro_torch.kernels import _lib
from repro_torch.launch.steps import build_serve_step, build_step
from repro_torch.models import build_model
from torch_threads import torch_thread_cap  # noqa: F401

B, T, MAX_LEN = 2, 6, 8


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _leaves(tree, prefix=''):
    """{'path/to/leaf': leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f'{prefix}/{key}').items()}
    return {prefix: tree}


def decode_inputs(cfg, seed: int, batch: int = B, length: int = T):
    """(inputs, encoder frames or None) drawn with numpy from ``seed``:
    (batch, length) tokens, or (batch, length, d) f32 embeddings where the
    arch takes embeddings; an encoder-decoder's (batch, cross_len, d)
    frames."""
    rng = np.random.RandomState(seed)
    if cfg.embed_inputs or cfg.is_encdec:
        inputs = rng.randint(0, cfg.vocab_size, (batch, length))
    else:
        inputs = rng.randn(batch, length, cfg.d_model).astype(np.float32)
    enc = (rng.randn(batch, cfg.cross_len, cfg.d_model).astype(np.float32)
           if cfg.is_encdec else None)
    return inputs, enc


def empty_caches(jcfg, jparams, model, params, enc, batch: int = B,
                 max_len: int = MAX_LEN):
    """Both sides' empty decode caches, an encoder-decoder's cross cache
    filled from the same frames ``enc`` on each side."""
    jmodel = jax_build_model(jcfg)
    jcache = jmodel.init_cache(batch, max_len)
    cache = model.init_cache(batch, max_len)
    if enc is not None:
        jcache = jax_fill_cross_cache(jcfg, jparams, jcache, jmodel.encode(
            jparams, jnp.asarray(enc)))
        cache = model.fill_cross_cache(params, cache, model.encode(
            params, torch.tensor(enc)))
    return jcache, cache


def decode_table(cfg, params: dict) -> dict:
    """``params`` whose ``forward`` unembeds through the table decode uses:
    an encoder-decoder's decode reads ``embed``, its forward ``unembed``."""
    return dict(params, unembed=params['embed']) if cfg.is_encdec else params


@pytest.fixture(scope='module', params=ARCHS)
def decoded(request):
    """Both sides' decode of the same 6 inputs from an empty cache: the
    configs, the port's parameters, inputs and encoder frames, each side's
    logits at every step and cache after the last, and the reference's
    cache after 3."""
    arch = request.param
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    inputs, enc = decode_inputs(jcfg, 5)
    model = build_model(tcfg, device='cpu')
    jcache, cache = empty_caches(jcfg, jparams, model, tparams, enc)
    step = jax.jit(jmodel.decode_step)
    want, mid = [], None
    for t in range(T):
        logits, jcache = step(jparams, jnp.asarray(inputs[:, t:t + 1]),
                              jcache)
        want.append(np.asarray(logits))
        if t == T // 2 - 1:
            mid = jax.tree.map(np.asarray, jcache)
    got = []
    _lib.reset_launches()
    for t in range(T):
        logits, cache = model.decode_step(tparams, torch.tensor(
            inputs[:, t:t + 1]), cache)
        got.append(logits)
    assert set(_lib.LAUNCHES.values()) == {0}
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, params=tparams,
                inputs=inputs, enc=enc, want=np.concatenate(want, 1),
                got=torch.cat(got, 1), jcache=jax.tree.map(np.asarray, jcache),
                cache=cache, mid=mid)


def test_decode_step_matches_the_reference(decoded):
    got, want = decoded['got'], decoded['want']
    assert tuple(got.shape) == (B, T, decoded['tcfg'].padded_vocab)
    assert _rel_l2(got.numpy(), want) <= 1e-5


def test_decode_cache_matches_the_reference(decoded):
    ported = _leaves(cache_to_numpy(decoded['cache']))
    ref = _leaves(decoded['jcache'])
    assert sorted(ported) == sorted(ref)
    assert int(ported['/pos']) == int(ref['/pos']) == T
    for path, leaf in ref.items():
        if path != '/pos':
            assert ported[path].shape == leaf.shape
            kv = path.endswith(('/k', '/v'))
            if kv and path.startswith('/slots'):
                assert np.abs(leaf[:, :, T:]).max() == 0    # never written
            # a recurrent state sums over the steps: the logits' tolerance
            assert _rel_l2(ported[path], leaf) <= (1e-6 if kv else 1e-5), path


def test_decode_continues_from_the_references_cache(decoded):
    """The reference's cache after 3 inputs, carried across, then the
    port's decode of the last 3."""
    tcfg, tokens = decoded['tcfg'], decoded['inputs']
    cache = cache_from_jax(decoded['mid'])
    assert int(cache['pos']) == T // 2 and cache['pos'].dtype == torch.int32
    step = build_serve_step(tcfg, device='cpu')
    got = []
    for t in range(T // 2, T):
        logits, cache = step(decoded['params'],
                             torch.tensor(tokens[:, t:t + 1]), cache)
        got.append(logits)
    assert int(cache['pos']) == T
    assert _rel_l2(torch.cat(got, 1).numpy(),
                   decoded['want'][:, T // 2:]) <= 1e-5


def test_decode_reproduces_the_ports_own_forward(decoded):
    cfg, enc = decoded['tcfg'], decoded['enc']
    logits, _ = build_model(cfg, device='cpu').forward(
        decode_table(cfg, decoded['params']),
        torch.tensor(decoded['inputs']),
        enc_inputs=None if enc is None else torch.tensor(enc))
    V = cfg.vocab_size       # past it the pad logits (finfo.min) overflow L2
    assert _rel_l2(decoded['got'].numpy()[..., :V],
                   logits.numpy()[..., :V]) <= 1e-5


@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
@pytest.mark.parametrize('arch', ARCHS)
def test_init_cache_has_the_references_layout(arch, dtype):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jd = None if dtype is None else jnp.bfloat16
    td = None if dtype is None else torch.bfloat16
    want = _leaves(jax.eval_shape(functools.partial(
        jax_build_model(jcfg).init_cache, 3, 12, dtype=jd)))
    got = _leaves(build_model(tcfg, device='cpu').init_cache(3, 12, td))
    assert sorted(got) == sorted(want)
    for path, sds in want.items():
        assert tuple(got[path].shape) == sds.shape, path
        assert str(got[path].dtype).replace('torch.', '') == str(sds.dtype)
        assert not got[path].any()


def test_serve_step_and_build_step_on_the_cpu():
    cfg = get_config('llama4_maverick_400b_a17b').reduced()
    model = build_model(cfg, device='cpu')
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 4),
                           generator=torch.Generator().manual_seed(1))
    serve = build_step(cfg, 'decode', device='cpu')
    prefill = build_step(cfg, 'prefill', device='cpu')
    cache = model.init_cache(3, 4)
    k0 = cache['slots']['slot0']['k']
    outs = []
    for t in range(4):
        logits, cache = serve(params, tokens[:, t:t + 1], cache)
        assert logits.shape == (3, 1, cfg.padded_vocab)
        outs.append(logits)
    assert cache['slots']['slot0']['k'] is k0          # written in place
    assert int(cache['pos']) == 4
    last = prefill(params, {'inputs': tokens})
    assert torch.allclose(outs[-1][:, 0], last, rtol=1e-5, atol=1e-5)
    # past the end the write lands on the last entry, as the reference's
    # dynamic_update_slice clamps it
    logits, cache = serve(params, tokens[:, :1], cache)
    assert torch.isfinite(logits).all() and int(cache['pos']) == 5
    with pytest.raises(ValueError, match='unknown step kind'):
        build_step(cfg, 'generate')


def test_cache_carries_across_bit_for_bit():
    jcfg = jax_get_config('yi_9b').reduced(compute_dtype='bfloat16')
    jcache = jax_build_model(jcfg).init_cache(2, 5)
    key = jax.random.PRNGKey(7)
    jcache = jax.tree.map(
        lambda a: (jax.random.normal(key, a.shape).astype(a.dtype)
                   if a.ndim else a + 3), jcache)
    ref = jax.tree.map(np.asarray, jcache)
    cache = cache_from_jax(ref)
    k = cache['slots']['slot0']['k']
    assert k.dtype == torch.bfloat16 and int(cache['pos']) == 3
    back = cache_to_numpy(cache)
    for path, leaf in _leaves(ref).items():
        got = _leaves(back)[path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      leaf.reshape(-1).view(np.uint8))
    # and the reference takes it back
    again = jax.tree.map(jnp.asarray, back)
    assert again['slots']['slot0']['k'].dtype == jnp.bfloat16
