"""RWKV-6 "Finch" block: the port of ``repro/models/rwkv.py``'s
``init_rwkv_block``, ``_shift``, ``_time_mix_streams``, ``_wkv_step``,
``rwkv_time_mix``, ``rwkv_channel_mix`` and ``init_rwkv_state``.

Data-dependent decay linear attention (a per-channel, per-token decay
w_t from a low-rank MLP of the input) and the channel mix, with the
reference's static token-shift mixes. Heads are fixed at 64 dims. The wkv
state (B, H, 64, 64), keyed [k, v], is f32; the time loop carries it one
token at a time, as the reference's ``lax.scan`` does. Where the
reference chunks the loop (``S % chunk == 0 and S > chunk``) under
``jax.checkpoint``, the port runs each chunk under
``torch.utils.checkpoint`` in an autograd pass that records a graph, the
state threading through the chunks, as ``ssm.py`` does its scan: the same
values, O(S/chunk) saved states. Decode is the S = 1 case of
:func:`rwkv_time_mix` and :func:`rwkv_channel_mix`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, dense_init, records_graph

HEAD = 64          # RWKV-6's fixed head width
LORA = 64          # rank of the decay MLP
CHUNK = 64         # the reference's time-loop chunk


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD


def init_rwkv_block(cfg: ModelConfig, generator: torch.Generator | None,
                    dtype: torch.dtype) -> dict:
    """The reference's leaves, shapes and scales (``None``: unfilled
    ``meta`` tensors)."""
    d, f, H = cfg.d_model, cfg.d_ff, _n_heads(cfg)
    dev = 'meta' if generator is None else generator.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def dense(shape, scale=None):
        return dense_init(generator, shape, dtype, scale=scale)

    return {
        # time mix
        'mu': full((5, d), 0.5),           # shift mixes of r, k, v, g, w
        'w_lora_a': dense((d, LORA)),
        'w_lora_b': dense((LORA, d), scale=1e-2),
        'w0': full((d,), -5.0),            # decay bias (slow decay)
        'bonus': full((H, HEAD), 0.0),     # the current token's bonus "u"
        'wr': dense((d, d)), 'wk': dense((d, d)), 'wv': dense((d, d)),
        'wg': dense((d, d)), 'wo': dense((d, d)),
        'ln_scale': full((H, HEAD), 1.0),  # per-head group norm
        # channel mix
        'mu_cm': full((2, d), 0.5),
        'ck': dense((d, f)), 'cv': dense((f, d)), 'cr': dense((d, d)),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t−1}, with ``prev`` (B, d) before t = 0."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix_streams(params, x: torch.Tensor, x_prev: torch.Tensor,
                      cfg: ModelConfig):
    """r, k, v, w as (B, S, H, 64) and the gate g (B, S, d); w ∈ (0, 1)
    in f32, the rest in the compute dtype."""
    ct = cdtype(cfg)
    B, S, _ = x.shape
    xs = _shift(x, x_prev)
    mu = params['mu'].to(ct)
    mix = [x + (xs - x) * mu[i] for i in range(5)]
    r = mix[0] @ params['wr'].to(ct)
    k = mix[1] @ params['wk'].to(ct)
    v = mix[2] @ params['wv'].to(ct)
    g = F.silu(mix[3] @ params['wg'].to(ct))
    w_raw = params['w0'].float() + (
        torch.tanh(mix[4] @ params['w_lora_a'].to(ct)).float()
        @ params['w_lora_b'].float())
    w = torch.exp(-torch.exp(w_raw))                         # (B, S, d)

    def heads(t):
        return t.reshape(B, S, _n_heads(cfg), HEAD)
    return heads(r), heads(k), heads(v), g, heads(w)


def _wkv_step(state: torch.Tensor, r, k, v, w, bonus_k):
    """One token. state: (B, H, 64, 64) keyed [k, v]; r and v (B, H, 1,
    64), k, w and ``bonus_k`` = bonus·k (B, H, 64, 1), f32. Returns
    (state, y (B, H, 1, 64)): y = r·(state + bonus_k⊗v), then
    state·w + k⊗v."""
    y = r @ torch.addcmul(state, bonus_k, v)
    return torch.addcmul(state * w, k, v), y


def _wkv(r, k, v, w, bonus_k, state: torch.Tensor, chunk: int = CHUNK):
    """The time loop over (B, S, H, 64) f32 streams from ``state``:
    :func:`_wkv_step` a token at a time, four launches a step; by chunks
    of ``chunk`` tokens under ``torch.utils.checkpoint`` where the
    reference chunks and a graph is recorded (the module's docstring).
    Each stream is copied once, time-major and shaped for its step, as the
    reference's scan takes its inputs time-major. Returns (y (B, S, H,
    64), the final state)."""
    def steps(t, dim):
        return t.transpose(0, 1).unsqueeze(dim).contiguous()
    streams = (steps(r, -2), steps(k, -1), steps(v, -2), steps(w, -1),
               steps(bonus_k, -1))
    S = r.shape[1]
    if not (S % chunk == 0 and S > chunk
            and records_graph(state, *streams)):
        state, y = _wkv_steps(state, *streams)
        return y.transpose(1, 2), state
    ys = []
    for t in range(0, S, chunk):
        state, y = checkpoint(_wkv_steps, state,
                              *(x[t:t + chunk] for x in streams),
                              use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=-2).transpose(1, 2), state


def _wkv_steps(state: torch.Tensor, r, k, v, w, bonus_k):
    """:func:`_wkv`'s steps over time-major streams (s, B, H, …) from
    ``state``. Returns (the last state, y (B, H, s, 64))."""
    ys = []
    for r_t, k_t, v_t, w_t, bk_t in zip(r.unbind(0), k.unbind(0),
                                        v.unbind(0), w.unbind(0),
                                        bonus_k.unbind(0)):
        state, y = _wkv_step(state, r_t, k_t, v_t, w_t, bk_t)
        ys.append(y)
    return state, torch.cat(ys, dim=-2)


def rwkv_time_mix(params, x: torch.Tensor, x_prev: torch.Tensor,
                  state: torch.Tensor, cfg: ModelConfig,
                  chunk: int = CHUNK):
    """x: (B, S, d); ``x_prev`` (B, d) the token before x; ``state`` the
    wkv state (B, H, 64, 64) f32, not written; ``chunk`` as in
    :func:`_wkv`. Returns (out (B, S, d), x's last token, the new
    state)."""
    ct = cdtype(cfg)
    B, S, d = x.shape
    r, k, v, g, w = _time_mix_streams(params, x, x_prev, cfg)
    r, k, v = r.float(), k.float(), v.float()
    bonus_k = torch.exp(params['bonus'].float()) * k
    y, state = _wkv(r, k, v, w, bonus_k, state, chunk)       # (B, S, H, 64)
    # per-head group norm in f32, then the gate and the output projection
    var, mean = torch.var_mean(y, dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5) * params['ln_scale'].float()
    y = (y.reshape(B, S, d).to(ct) * g) @ params['wo'].to(ct)
    return y, x[:, -1, :], state


def rwkv_channel_mix(params, x: torch.Tensor, x_prev: torch.Tensor,
                     cfg: ModelConfig):
    """x: (B, S, d), ``x_prev`` (B, d). Returns (out (B, S, d), x's last
    token)."""
    ct = cdtype(cfg)
    xs = _shift(x, x_prev)
    mu = params['mu_cm'].to(ct)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(F.relu(xk @ params['ck'].to(ct)))
    r = torch.sigmoid(xr @ params['cr'].to(ct))
    return r * (k @ params['cv'].to(ct)), x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The decode carry of a block: the token-shift predecessors of the
    time and channel mixes (B, d) and the wkv state (B, H, 64, 64), f32
    zeros. Forward starts every block from these zeros."""
    H = _n_heads(cfg)
    return {'tm_prev': torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                                   device=device),
            'cm_prev': torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                                   device=device),
            'wkv': torch.zeros((batch, H, HEAD, HEAD), dtype=torch.float32,
                               device=device)}
