"""Parity of the port's encoder-decoder family (SeamlessM4T-large-v2) with
the reference's.

``cross_attention_cache`` and ``cross_attention`` (no mask, no RoPE, the
chunked path past ``attn_chunk``), ``encode`` (non-causal attention over
(B, T, d) frames), ``fill_cross_cache``, the model's ``forward`` and its
prefill step with ``enc_inputs``, and bf16 ``decode_step`` against a
filled cross cache, at ``reduced()`` size with the reference's parameters
carried across by ``model_params_from_jax`` and frames drawn with numpy
from a seed. ``decode_step`` in f32, its cache and ``init_cache``'s
layout are in ``tests/test_torch_decode.py``.

Two reference caveats (``ROADMAP.md`` queue 3) are pinned here: its
decode unembeds through ``embed`` where its ``forward`` uses ``unembed``,
so for this arch decode and forward differ in both packages; and its
``fill_cross_cache`` without ``scan_layers`` keeps block 0's K and V
only, where the port gives every block its own, as the reference's
default (``scan_layers``) branch does.

Tolerances, relative L2: 1e-5 in f32, 2e-2 in bf16.
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
from repro.models.transformer import fill_cross_cache as jax_fill_cross_cache
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, to_torch
from repro_torch.kernels import _lib
from repro_torch.launch.steps import build_prefill_step, serve_params
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from torch_threads import torch_thread_cap  # noqa: F401

ARCH = 'seamless_m4t_large_v2'
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
TOLS = [('float32', 1e-5), ('bfloat16', 2e-2)]


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _reduced(**kw):
    return (jax_get_config(ARCH).reduced(**kw),
            get_config(ARCH).reduced(**kw))


def _frames(cfg, B: int, T: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(B, T, cfg.d_model).astype(
        np.float32)


def _model_params(**kw):
    jcfg, tcfg = _reduced(**kw)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, model_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg)


@pytest.mark.parametrize('S,T', [(64, 96), (5, 16), (1, 64)])
@pytest.mark.parametrize('dtype,tol', TOLS)
def test_cross_attention_matches_the_reference(dtype, tol, S, T):
    """S decoder queries over T encoder states: the chunked path where
    either passes ``attn_chunk`` (32 here), the full one below it, and a
    decode step's single query."""
    jcfg, tcfg = _reduced(compute_dtype=dtype)
    params = jax.tree.map(np.asarray, jattn.init_attention(
        jcfg, jax.random.PRNGKey(2), cross=True))
    assert 'bq' not in params
    jp, tp = jax.tree.map(jnp.asarray, params), to_torch(params)
    enc = _frames(jcfg, 2, T, 3)
    x = _frames(jcfg, 2, S, 4)
    jk, jv = jattn.cross_attention_cache(jp, jnp.asarray(enc).astype(dtype),
                                         jcfg)
    tk, tv = tattn.cross_attention_cache(
        tp, torch.tensor(enc).to(DTYPES[dtype]), tcfg)
    assert tk.shape == (2, T, tcfg.n_kv_heads, tcfg.head_dim)
    assert _rel_l2(_np(tk), _np(jk)) <= tol
    assert _rel_l2(_np(tv), _np(jv)) <= tol
    want = jattn.cross_attention(jp, jnp.asarray(x).astype(dtype), jk, jv,
                                 jcfg)
    got = tattn.cross_attention(tp, torch.tensor(x).to(DTYPES[dtype]), tk,
                                tv, tcfg)
    assert got.shape == (2, S, 64) and got.dtype == DTYPES[dtype]
    assert _rel_l2(_np(got), _np(want)) <= tol


@pytest.mark.parametrize('dtype,tol', TOLS)
def test_encode_matches_the_reference(dtype, tol):
    """The serving path: kernels D and E (non-causal) where
    ``use_pallas``, their plain versions on the CPU; ``forward`` below
    runs the encoder with ``use_pallas`` on and off."""
    jcfg, tcfg, jparams, tparams = _model_params(compute_dtype=dtype,
                                                 use_pallas=True)
    enc = _frames(jcfg, 2, 64, 5)
    want = jax_build_model(jcfg).encode(jparams, jnp.asarray(enc))
    _lib.reset_launches()
    got = build_model(tcfg, device='cpu').encode(tparams, torch.tensor(enc))
    assert set(_lib.LAUNCHES.values()) == {0}        # CPU: plain versions
    assert got.shape == (2, 64, 64) and got.dtype == DTYPES[dtype]
    assert _rel_l2(_np(got), _np(want)) <= tol


def test_encode_is_not_causal():
    """An encoder state depends on the frames after it."""
    _, tcfg, _, tparams = _model_params()
    enc = torch.tensor(_frames(tcfg, 1, 16, 6))
    model = build_model(tcfg, device='cpu')
    later = enc.clone()
    later[:, -1] += 1.0
    a, b = model.encode(tparams, enc), model.encode(tparams, later)
    assert not torch.allclose(a[:, 0], b[:, 0])


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f'{prefix}/{key}').items()}
    return {prefix: tree}


def test_fill_cross_cache_matches_the_reference():
    """Every decoder block's K and V, in the cache's dtype (bf16 here);
    frames of ``cross_len`` are written in place, others replace the
    pair."""
    jcfg, tcfg, jparams, tparams = _model_params()
    jmodel, model = jax_build_model(jcfg), build_model(tcfg, device='cpu')
    enc = _frames(jcfg, 2, jcfg.cross_len, 7)
    jout = jmodel.encode(jparams, jnp.asarray(enc))
    tout = model.encode(tparams, torch.tensor(enc))
    want = jax_fill_cross_cache(jcfg, jparams, jmodel.init_cache(
        2, 8, dtype=jnp.bfloat16), jout)
    cache = model.init_cache(2, 8, torch.bfloat16)
    k0 = cache['cross']['k']
    got = model.fill_cross_cache(tparams, cache, tout)
    assert got['cross']['k'] is k0                   # written in place
    for path, leaf in _leaves(jax.tree.map(np.asarray, want)).items():
        mine = _leaves(got)[path]
        assert tuple(mine.shape) == leaf.shape, path
        if path.startswith('/cross'):
            assert mine.dtype == torch.bfloat16
            assert _rel_l2(_np(mine), _np(leaf)) <= 2e-2, path
    # every block its own, block 1 is not block 0
    assert not torch.equal(got['cross']['k'][0], got['cross']['k'][1])
    longer = _frames(jcfg, 2, 2 * jcfg.cross_len, 8)
    again = model.fill_cross_cache(tparams, cache, model.encode(
        tparams, torch.tensor(longer)))
    assert again['cross']['k'].shape[2] == 2 * jcfg.cross_len
    assert again['cross']['k'] is not k0


def test_reference_fill_without_scan_layers_keeps_block_0_only():
    """The reference caveat: its non-scan branch returns one block's K/V
    (block 0's) for the whole decoder."""
    jcfg, _ = _reduced(scan_layers=False)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    enc = jnp.asarray(_frames(jcfg, 2, jcfg.cross_len, 9))
    cache = jax_fill_cross_cache(jcfg, jparams, jmodel.init_cache(2, 8),
                                 jmodel.encode(jparams, enc))
    assert jcfg.n_blocks == 2 and cache['cross']['k'].shape[0] == 1


@pytest.mark.parametrize('use_pallas', [True, False])
@pytest.mark.parametrize('dtype,tol', TOLS)
def test_seamless_forward_matches_the_reference(dtype, tol, use_pallas):
    jcfg, tcfg, jparams, tparams = _model_params(compute_dtype=dtype,
                                                 use_pallas=use_pallas)
    tokens = np.random.RandomState(10).randint(0, jcfg.vocab_size, (2, 64))
    enc = _frames(jcfg, 2, 64, 11)
    want, _ = jax_build_model(jcfg).forward(jparams, jnp.asarray(tokens),
                                            enc_inputs=jnp.asarray(enc))
    got, _ = build_model(tcfg, device='cpu').forward(
        tparams, torch.tensor(tokens), enc_inputs=torch.tensor(enc))
    assert got.shape == (2, 64, tcfg.padded_vocab)
    assert got.dtype == DTYPES[dtype]
    assert _rel_l2(_np(got), _np(want)) <= tol
    with pytest.raises(ValueError, match='enc_inputs'):
        build_model(tcfg, device='cpu').forward(tparams,
                                                torch.tensor(tokens))


def test_seamless_prefill_step_matches_the_reference():
    """Serving: bf16 weights, kernels D and E on the encoder's and the
    decoder's self-attention (their plain versions on the CPU), the
    encoder's frames in the batch; the next-token logits."""
    jcfg, tcfg, jparams, tparams = _model_params(compute_dtype='bfloat16',
                                                 use_pallas=True)
    sds = _param_sds(jcfg, serve=True)
    jparams = jax.tree.map(lambda p, s: p.astype(s.dtype), jparams, sds)
    tokens = np.random.RandomState(12).randint(0, jcfg.vocab_size, (2, 64))
    enc = _frames(jcfg, 2, 64, 13)
    logits, _ = jax_build_model(jcfg).forward(
        jparams, jnp.asarray(tokens), enc_inputs=jnp.asarray(enc))
    got = build_prefill_step(tcfg, device='cpu')(
        serve_params(tparams), {'inputs': torch.tensor(tokens),
                                'enc_inputs': torch.tensor(enc)})
    assert got.shape == (2, tcfg.padded_vocab)
    assert _rel_l2(_np(got), _np(logits[:, -1, :])) <= 2e-2


def _decode(jcfg, tcfg, jparams, tparams, tokens, enc):
    """Both sides' decode of ``tokens`` against the cross cache filled from
    ``enc``; the reference's under ``jax.jit``. Returns (reference logits,
    port logits) as numpy."""
    B, T = tokens.shape
    jmodel, model = jax_build_model(jcfg), build_model(tcfg, device='cpu')
    jcache = jax_fill_cross_cache(jcfg, jparams, jmodel.init_cache(B, T),
                                  jmodel.encode(jparams, jnp.asarray(enc)))
    cache = model.fill_cross_cache(tparams, model.init_cache(B, T),
                                   model.encode(tparams, torch.tensor(enc)))
    step = jax.jit(jmodel.decode_step)
    want, got = [], []
    for t in range(T):
        logits, jcache = step(jparams, jnp.asarray(tokens[:, t:t + 1]),
                              jcache)
        want.append(_np(logits))
        logits, cache = model.decode_step(tparams, torch.tensor(
            tokens[:, t:t + 1]), cache)
        got.append(_np(logits))
    return np.concatenate(want, 1), np.concatenate(got, 1)


def test_seamless_bf16_decode_matches_the_reference():
    jcfg, tcfg, jparams, tparams = _model_params(compute_dtype='bfloat16')
    tokens = np.random.RandomState(14).randint(0, jcfg.vocab_size, (2, 8))
    want, got = _decode(jcfg, tcfg, jparams, tparams, tokens,
                        _frames(jcfg, 2, jcfg.cross_len, 15))
    assert _rel_l2(got, want) <= 2e-2


def test_decode_unembeds_through_another_table_than_forward():
    """The reference caveat, in both packages: decode's logits are the
    forward's hidden state through ``embed``, not ``unembed``."""
    jcfg, tcfg, jparams, tparams = _model_params()
    tokens = np.random.RandomState(16).randint(0, jcfg.vocab_size, (2, 6))
    enc = _frames(jcfg, 2, jcfg.cross_len, 17)
    want, got = _decode(jcfg, tcfg, jparams, tparams, tokens, enc)
    assert _rel_l2(got, want) <= 1e-5
    ref_fwd, _ = jax_build_model(jcfg).forward(jparams, jnp.asarray(tokens),
                                               enc_inputs=jnp.asarray(enc))
    model = build_model(tcfg, device='cpu')
    port_fwd, _ = model.forward(tparams, torch.tensor(tokens),
                                enc_inputs=torch.tensor(enc))
    assert _rel_l2(want, _np(ref_fwd)) > 0.5       # another table
    assert _rel_l2(got, _np(port_fwd)) > 0.5
    same, _ = model.forward(dict(tparams, unembed=tparams['embed']),
                            torch.tensor(tokens),
                            enc_inputs=torch.tensor(enc))
    assert _rel_l2(got, _np(same)) <= 1e-5


def test_non_encdec_models_have_no_encoder():
    model = build_model(get_config('yi_9b').reduced(), device='cpu')
    assert model.encode is None and model.fill_cross_cache is None
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_enc_layers=0)
    assert build_model(cfg, device='cpu').encode is None


@pytest.mark.parametrize('arch', ['seamless_m4t_large_v2', 'jamba_v01_52b'])
def test_model_trees_and_draws_carry_across(arch):
    """``model_params_from_jax`` splits the reference's stacked ``blocks``
    (and ``enc_blocks``) into the port's lists, leaf for leaf; a column
    draw over the reference's stacked tree, carried by
    ``model_indices_from_jax``, addresses the same values in the port's
    tree (the encoder's blocks, and Jamba's Mamba and MoE leaves)."""
    from repro.core.tree_util import PyTreeIndexer as JIndexer
    from repro_torch.convert import model_indices_from_jax
    from repro_torch.core.tree_util import (tree_flatten,
                                            tree_flatten_with_path)
    from repro_torch.models.transformer import abstract_params
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    meta = abstract_params(tcfg)
    shapes = [[(path, tuple(x.shape)) for path, x in
               tree_flatten_with_path(tree)[0]] for tree in (tparams, meta)]
    assert shapes[0] == shapes[1]
    if tcfg.is_encdec:
        assert len(tparams['enc_blocks']) == tcfg.n_enc_layers
    draw = JIndexer(jparams).sample_indices(jax.random.PRNGKey(1), 64)
    idx = model_indices_from_jax(jax.tree.map(np.asarray, draw), tcfg)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    tleaves, _ = tree_flatten(tparams)
    for j, (lid, dims) in enumerate(zip(np.asarray(draw['leaf']),
                                        np.asarray(draw['dims']))):
        want = jleaves[lid][tuple(dims[:jleaves[lid].ndim])]
        leaf = tleaves[int(idx['leaf'][j])]
        got = leaf[tuple(int(d) for d in idx['dims'][j][:leaf.ndim])]
        assert float(got) == float(want)
