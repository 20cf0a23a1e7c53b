"""Parity of the port's Mamba family (``models/ssm.py``, Jamba-v0.1) with
the reference's.

The module functions (``init_mamba``, ``mamba_scan``, ``mamba_decode``)
on the reference's parameters, inputs and states drawn with numpy from a
seed; then Jamba's ``forward`` and ``decode_step`` at ``reduced()`` size
(two blocks of 7 Mamba layers, 1 attention layer, 4 MoE FFNs) with the
reference's parameters carried across by ``model_params_from_jax``.
``decode_step`` in f32 over all ten archs, its cache and ``init_cache``'s
layout are in ``tests/test_torch_decode.py``.

Tolerances, relative L2: 1e-5 in f32, 2e-2 in bf16 for one layer. Jamba's
``reduced()`` model is 16 random layers deep, and there the reference's
own bf16 logits are 2.3e-2 from its f32-compute logits on the same
weights, without a single routing flip (a one-ulp difference in one layer
grows about twofold a layer): no bf16 implementation can be held within
2e-2 of it. So in bf16 the port is held to be as close to the f32-compute
logits as the reference's bf16 logits are (at most 1.25 times their
distance), and within twice that distance of the reference's bf16
logits, at the tokens where neither bf16 side chose other experts than
the f32 side in any MoE layer, at or before the token (``ROADMAP.md``
queue 3, reference caveats). At one period (8 layers) the port's bf16
logits are held within 2e-2 of the reference's. The f32-compute logits
are the port's, which are the reference's within 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, to_torch
from repro_torch.kernels import _lib
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from torch_threads import torch_thread_cap  # noqa: F401

ARCH = 'jamba_v01_52b'
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


def _mamba_params(jcfg):
    params = jax.tree.map(np.asarray, jssm.init_mamba(
        jcfg, jax.random.PRNGKey(1)))
    return jax.tree.map(jnp.asarray, params), to_torch(params)


def test_init_mamba_has_the_references_leaves():
    jcfg, tcfg = _reduced()
    want = jax.eval_shape(functools.partial(jssm.init_mamba, jcfg),
                          jax.random.PRNGKey(0))
    got = tssm.init_mamba(tcfg, torch.Generator().manual_seed(0),
                          torch.float32)
    meta = tssm.init_mamba(tcfg, None, torch.float32)
    assert sorted(got) == sorted(want) == sorted(meta)
    for name, sds in want.items():
        assert tuple(got[name].shape) == sds.shape == tuple(meta[name].shape)
        assert meta[name].device.type == 'meta'
    ref = jax.tree.map(np.asarray, jssm.init_mamba(jcfg,
                                                   jax.random.PRNGKey(0)))
    for name in ('conv_b', 'A_log', 'D'):           # the deterministic ones
        np.testing.assert_array_equal(got[name].numpy(), ref[name])
    # dt = softplus(dt_proj_b) lies in [1e-3, 1e-1], as the reference's
    dt = torch.nn.functional.softplus(got['dt_proj_b'])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5), ('bfloat16', 2e-2)])
def test_mamba_scan_matches_the_reference(dtype, tol):
    jcfg, tcfg = _reduced(compute_dtype=dtype)
    jp, tp = _mamba_params(jcfg)
    x = np.random.RandomState(0).randn(2, 64, jcfg.d_model).astype(
        np.float32)
    want = jssm.mamba_scan(jp, jnp.asarray(x).astype(dtype), jcfg)
    got = tssm.mamba_scan(tp, torch.tensor(x).to(DTYPES[dtype]), tcfg)
    assert got.dtype == DTYPES[dtype] and got.shape == (2, 64, 64)
    assert _rel_l2(_np(got), _np(want)) <= tol


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5), ('bfloat16', 2e-2)])
def test_mamba_decode_matches_the_reference(dtype, tol):
    """One step from a random state: the output and both new states."""
    jcfg, tcfg = _reduced(compute_dtype=dtype)
    jp, tp = _mamba_params(jcfg)
    rng = np.random.RandomState(1)
    x = rng.randn(3, 1, jcfg.d_model).astype(np.float32)
    state = {'conv': rng.randn(3, jcfg.d_conv - 1, jcfg.d_inner),
             'ssm': 0.1 * rng.randn(3, jcfg.d_inner, jcfg.d_state)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want, wstate = jssm.mamba_decode(jp, jnp.asarray(x).astype(dtype),
                                     jax.tree.map(jnp.asarray, state), jcfg)
    got, gstate = tssm.mamba_decode(tp, torch.tensor(x).to(DTYPES[dtype]),
                                    to_torch(state), tcfg)
    assert got.shape == (3, 1, 64) and got.dtype == DTYPES[dtype]
    assert _rel_l2(_np(got), _np(want)) <= tol
    for name in ('conv', 'ssm'):
        assert gstate[name].dtype == torch.float32
        assert _rel_l2(_np(gstate[name]), _np(wstate[name])) <= tol


def test_mamba_decode_steps_reproduce_the_scan():
    """Decode from the zero state, a token at a time, is the scan."""
    _, tcfg = _reduced()
    _, tp = _mamba_params(_reduced()[0])
    x = torch.tensor(np.random.RandomState(2).randn(2, 12, 64).astype(
        np.float32))
    want = tssm.mamba_scan(tp, x, tcfg)
    state = tssm.init_mamba_state(tcfg, 2)
    got = []
    for t in range(12):
        out, state = tssm.mamba_decode(tp, x[:, t:t + 1], state, tcfg)
        got.append(out)
    assert _rel_l2(_np(torch.cat(got, 1)), _np(want)) <= 1e-5


def _jamba_params(**kw):
    """The reference's Jamba at ``reduced(**kw)`` with its blocks in a
    Python loop (``scan_layers=False``, the same math), so that its MoE
    layers see concrete inputs; and the port's, carried across."""
    jcfg, tcfg = _reduced(scan_layers=False, **kw)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, model_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg)


@pytest.mark.parametrize('use_pallas', [True, False])
def test_jamba_forward_matches_the_reference_in_f32(use_pallas):
    jcfg, tcfg, jparams, tparams = _jamba_params(use_pallas=use_pallas)
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 64))
    want, want_aux = jax_build_model(jcfg).forward(jparams,
                                                   jnp.asarray(tokens))
    _lib.reset_launches()
    got, aux = build_model(tcfg, device='cpu').forward(
        tparams, torch.tensor(tokens))
    assert set(_lib.LAUNCHES.values()) == {0}       # CPU: plain versions
    assert got.shape == (2, 64, tcfg.padded_vocab)
    assert _rel_l2(_np(got), _np(want)) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-6


class _Routes:
    """The experts each MoE layer chose, sorted, on either side, in call
    order: the reference's from its router on the layer's input, the
    port's from ``route``."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        ffn, route = jmoe.moe_ffn, tmoe.route

        def ref_recording(params, x, cfg):
            xt = jnp.asarray(np.asarray(x, np.float32).reshape(
                -1, cfg.d_model))
            probs = jax.nn.softmax(xt @ jnp.asarray(params['router'],
                                                    jnp.float32), axis=-1)
            self.ref.append(np.sort(np.asarray(
                jax.lax.top_k(probs, cfg.top_k)[1]), axis=-1))
            return ffn(params, x, cfg)

        def port_recording(params, xt, cfg):
            out = route(params, xt, cfg)
            self.port.append(np.sort(out[2].numpy(), axis=-1))
            return out

        monkeypatch.setattr(jmoe, 'moe_ffn', ref_recording)
        monkeypatch.setattr(tmoe, 'route', port_recording)

    def take(self, side: str) -> list:
        log = getattr(self, side)
        out = list(log)
        log.clear()
        return out


def _flipped(want: list, got: list, B: int, S: int) -> np.ndarray:
    """(B, S): the token chose other experts in some MoE layer in ``got``
    than in ``want``. A forward logs each MoE layer once over all B·S
    tokens; a decode logs each layer at each step over B tokens, step by
    step."""
    flips = np.zeros((B, S), bool)
    n_layers = len(want) // S if len(want[0]) == B else len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        flip = (w != g).any(-1)
        if len(w) == B:
            flips[:, i // n_layers] |= flip
        else:
            flips |= flip.reshape(B, S)
    return flips


def _as_accurate(label, f32, ref, port, flips, bound=None) -> None:
    """The port's bf16 logits are as close to the reference's f32-compute
    ones as the reference's bf16 logits are (≤ 1.25×), over the tokens
    with no routing flip at or before them in their sequence (at least 8:
    at this size most tokens sit near a tie in some layer); and they are
    within ``bound`` of the reference's bf16 logits there, or, without
    one, within twice the reference's own distance from f32 compute."""
    keep = ~np.logical_or.accumulate(flips, axis=1)
    assert keep.sum() >= 8, keep.sum()
    V = 256        # the reduced vocab
    ref_err = _rel_l2(ref[keep][..., :V], f32[keep][..., :V])
    port_err = _rel_l2(port[keep][..., :V], f32[keep][..., :V])
    gap = _rel_l2(port[keep][..., :V], ref[keep][..., :V])
    print(f'{label}: bf16 vs f32 compute over {int(keep.sum())} of '
          f'{keep.size} tokens: reference {ref_err:.3e}, port {port_err:.3e}'
          f', port vs reference {gap:.3e}')
    assert port_err <= 1.25 * ref_err
    assert gap <= (2 * ref_err if bound is None else bound)


def _jamba_bf16_forward(monkeypatch, **kw):
    """The bf16 forward of both sides and the port's f32-compute forward
    at ``reduced(**kw)``, B = 2, S = 64: (f32, ref, port, flips)."""
    jcfg, tcfg, jparams, tparams = _jamba_params(compute_dtype='bfloat16',
                                                 use_pallas=True, **kw)
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 64))
    routes = _Routes(monkeypatch)
    f32, _ = build_model(dataclasses.replace(tcfg, compute_dtype='float32'),
                         device='cpu').forward(tparams, torch.tensor(tokens))
    f32_routes = routes.take('port')
    ref, _ = jax_build_model(jcfg).forward(jparams, jnp.asarray(tokens))
    port, _ = build_model(tcfg, device='cpu').forward(
        tparams, torch.tensor(tokens))
    assert port.dtype == torch.bfloat16
    flips = (_flipped(f32_routes, routes.take('ref'), 2, 64)
             | _flipped(f32_routes, routes.take('port'), 2, 64))
    return _np(f32), _np(ref), _np(port), flips


def _jamba_bf16_decode(monkeypatch, **kw):
    """8 tokens decoded from an empty cache, B = 2, by both sides in bf16
    and by the port in f32 compute, at ``reduced(**kw)``: (f32, ref, port,
    flips)."""
    B, T = 2, 8
    jcfg, tcfg, jparams, tparams = _jamba_params(compute_dtype='bfloat16',
                                                 **kw)
    tokens = np.random.RandomState(4).randint(0, jcfg.vocab_size, (B, T))
    routes = _Routes(monkeypatch)

    def port_decode(cfg):
        model = build_model(cfg, device='cpu')
        cache = model.init_cache(B, T)
        out = []
        for t in range(T):
            logits, cache = model.decode_step(tparams, torch.tensor(
                tokens[:, t:t + 1]), cache)
            out.append(_np(logits))
        return np.concatenate(out, 1), routes.take('port')

    f32, f32_routes = port_decode(dataclasses.replace(
        tcfg, compute_dtype='float32'))
    port, port_routes = port_decode(tcfg)
    model = jax_build_model(jcfg)
    cache = model.init_cache(B, T)
    ref = []
    for t in range(T):
        logits, cache = model.decode_step(
            jparams, jnp.asarray(tokens[:, t:t + 1]), cache)
        ref.append(_np(logits))
    flips = (_flipped(f32_routes, routes.take('ref'), B, T)
             | _flipped(f32_routes, port_routes, B, T))
    return f32, np.concatenate(ref, 1), port, flips


def test_jamba_bf16_forward_is_as_close_to_f32_as_the_reference(
        monkeypatch):
    """The serving path (``use_pallas``: kernels D and E, on the CPU their
    plain versions) against the port's f32-compute forward, which is the
    reference's within 1e-5 (the f32 test above), and against the
    reference's bf16 forward (2.805e-2 apart, 1.23 times the reference's
    own 2.276e-2 from f32 compute)."""
    _as_accurate('jamba forward', *_jamba_bf16_forward(monkeypatch))


def test_jamba_bf16_decode_is_as_close_to_f32_as_the_reference(monkeypatch):
    """Against the port's f32-compute decode (the reference's within 1e-5,
    ``tests/test_torch_decode.py``) and the reference's bf16 decode
    (2.285e-2 apart, 1.14 times the reference's own 2.006e-2 from f32
    compute)."""
    _as_accurate('jamba decode', *_jamba_bf16_decode(monkeypatch))


def test_jamba_one_period_bf16_forward_matches_the_reference(monkeypatch):
    """At one period (8 layers: 7 Mamba, 1 attention, 4 MoE FFNs, phase
    21's depth on the card) the bf16 serving forward is held within 2e-2
    of the reference's bf16 forward."""
    _as_accurate('jamba forward, one period',
                 *_jamba_bf16_forward(monkeypatch, n_layers=8), bound=2e-2)


def test_jamba_one_period_bf16_decode_matches_the_reference(monkeypatch):
    """At one period the bf16 decode is held within 2e-2 of the
    reference's bf16 decode."""
    _as_accurate('jamba decode, one period',
                 *_jamba_bf16_decode(monkeypatch, n_layers=8), bound=2e-2)


def test_jamba_decode_state_does_not_grow_with_the_context():
    """Mamba's state is O(1) in the sequence length: only the attention
    slot's k and v grow with ``max_len``."""
    cfg = get_config(ARCH).reduced()
    small = build_model(cfg, device='cpu').init_cache(2, 8)
    large = build_model(cfg, device='cpu').init_cache(2, 64)
    for name, slot in small['slots'].items():
        for leaf, x in slot.items():
            grows = leaf in ('k', 'v')
            assert (large['slots'][name][leaf].shape != x.shape) == grows
            if not grows:
                assert x.dtype == torch.float32
