"""Parity of the port's M-RoPE family (Qwen2-VL-7B's backbone) with the
reference's.

``apply_mrope`` (the port's ``mrope_tables`` under ``apply_rope``) on
non-degenerate (t, h, w) ids, where it differs from plain RoPE, and on
text ids, where it is plain RoPE bit for bit; then the model's
``forward`` over (B, S, d) embedding inputs with such ids, the prefill
step (serving weights in bf16, kernels D and E on the path), and bf16
``decode_step`` fed (B, 1, d) embeddings, at ``reduced()`` size with the
reference's parameters carried across by ``model_params_from_jax``.
Decode broadcasts its position to all three components, as the reference
does, so decode agrees with ``forward`` only at text ids; ``decode_step``
in f32, its cache and ``init_cache``'s layout are in
``tests/test_torch_decode.py``.

Tolerances, relative L2: 1e-5 in f32 (1e-4 elementwise on the rotation
at positions up to 32768, as ``test_rope_matches_the_reference``), 2e-2
in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import _param_sds
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import _lib
from repro_torch.launch.steps import (build_prefill_step, build_step,
                                      serve_params)
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from torch_threads import torch_thread_cap  # noqa: F401

ARCH = 'qwen2_vl_7b'
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


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


def _vision_ids(B: int, S: int, seed: int) -> np.ndarray:
    """(B, 3, S) int32 (t, h, w) ids: a run of text, an image grid whose
    h and w ids differ from t, then text again, as Qwen2-VL lays them
    out."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((B, 3, S), np.int32)
    for b in range(B):
        start = rng.randint(2, S // 4)
        side = 4
        n = side * side
        ids[b, :, :start] = np.arange(start)
        ids[b, 0, start:start + n] = start
        ids[b, 1, start:start + n] = start + np.repeat(np.arange(side), side)
        ids[b, 2, start:start + n] = start + np.tile(np.arange(side), side)
        ids[b, :, start + n:] = start + side + np.arange(S - start - n)
    return ids


@pytest.mark.parametrize('hd,sections,theta', [
    (128, (16, 24, 24), 1_000_000.0), (16, (2, 3, 3), 1_000_000.0)])
def test_mrope_matches_the_reference(hd, sections, theta):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 40, 3, hd).astype(np.float32)
    pos = rng.randint(0, 32768, size=(2, 3, 40)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta,
                               sections)
    got = tlayers.apply_rope(torch.tensor(x), tlayers.mrope_tables(
        torch.tensor(pos), hd, theta, sections))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # differs from plain RoPE at these ids
    plain = tlayers.apply_rope(torch.tensor(x), tlayers.rope_tables(
        torch.tensor(pos[:, 0]), hd, theta))
    assert not torch.allclose(got, plain, atol=1e-3)


def test_mrope_at_text_ids_is_plain_rope_bit_for_bit():
    pos = torch.randint(0, 4096, (2, 1, 17),
                        generator=torch.Generator().manual_seed(1))
    m = tlayers.mrope_tables(pos.expand(2, 3, 17), 128, 1e6, (16, 24, 24))
    r = tlayers.rope_tables(pos[:, 0], 128, 1e6)
    assert all(torch.equal(a, b) for a, b in zip(m, r))


def _model_params(**kw):
    jcfg, tcfg = _reduced(**kw)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, model_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg)


def _embeddings(cfg, B: int, S: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)


@pytest.mark.parametrize('use_pallas', [True, False])
@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5),
                                       ('bfloat16', 2e-2)])
def test_qwen2_vl_forward_matches_the_reference(dtype, tol, use_pallas):
    jcfg, tcfg, jparams, tparams = _model_params(compute_dtype=dtype,
                                                 use_pallas=use_pallas)
    assert 'embed' not in tparams                    # embedding inputs
    emb, ids = _embeddings(jcfg, 2, 64, 3), _vision_ids(2, 64, 4)
    want, _ = jax_build_model(jcfg).forward(jparams, jnp.asarray(emb),
                                            positions=jnp.asarray(ids))
    _lib.reset_launches()
    got, _ = build_model(tcfg, device='cpu').forward(
        tparams, torch.tensor(emb), positions=torch.tensor(ids))
    assert set(_lib.LAUNCHES.values()) == {0}        # CPU: plain versions
    assert got.shape == (2, 64, tcfg.padded_vocab)
    assert got.dtype == DTYPES[dtype]
    assert _rel_l2(_np(got), _np(want)) <= tol
    # the default ids are text ids, not these
    text, _ = build_model(tcfg, device='cpu').forward(tparams,
                                                      torch.tensor(emb))
    assert _rel_l2(_np(text), _np(want)) > 5e-2


def test_qwen2_vl_prefill_step_matches_the_reference():
    """Serving: weights cast to bf16 at load, kernels D and E on the path
    (their plain versions on the CPU), embeddings and (t, h, w) ids in
    the batch; the next-token logits."""
    jcfg, tcfg, jparams, tparams = _model_params(compute_dtype='bfloat16',
                                                 use_pallas=True)
    sds = _param_sds(jcfg, serve=True)
    jparams = jax.tree.map(lambda p, s: p.astype(s.dtype), jparams, sds)
    emb, ids = _embeddings(jcfg, 2, 64, 5), _vision_ids(2, 64, 6)
    logits, _ = jax_build_model(jcfg).forward(jparams, jnp.asarray(emb),
                                              positions=jnp.asarray(ids))
    got = build_prefill_step(tcfg, device='cpu')(
        serve_params(tparams), {'inputs': torch.tensor(emb),
                                'positions': torch.tensor(ids)})
    assert got.shape == (2, tcfg.padded_vocab)
    assert _rel_l2(_np(got), _np(logits[:, -1, :])) <= 2e-2


def test_qwen2_vl_bf16_decode_of_embeddings_matches_the_reference():
    """8 (B, 1, d) bf16 embeddings a step from an empty cache, B = 2,
    through ``build_step('decode')``; the reference's decode under
    ``jax.jit``."""
    B, T = 2, 8
    jcfg, tcfg, jparams, tparams = _model_params(compute_dtype='bfloat16')
    emb = _embeddings(jcfg, B, T, 7)
    jmodel = jax_build_model(jcfg)
    jcache = jmodel.init_cache(B, T)
    step = jax.jit(jmodel.decode_step)
    serve = build_step(tcfg, 'decode', device='cpu')
    cache = build_model(tcfg, device='cpu').init_cache(B, T)
    want, got = [], []
    for t in range(T):
        x = emb[:, t:t + 1]
        logits, jcache = step(jparams, jnp.asarray(x).astype(jnp.bfloat16),
                              jcache)
        want.append(_np(logits))
        logits, cache = serve(tparams, torch.tensor(x).bfloat16(), cache)
        got.append(_np(logits))
    assert int(cache['pos']) == T
    assert _rel_l2(np.concatenate(got, 1), np.concatenate(want, 1)) <= 2e-2
