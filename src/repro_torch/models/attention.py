"""GQA attention for training-shaped, prefill and decode passes: the port
of ``repro/models/attention.py``'s ``multihead_attention``,
``decode_attention`` and ``init_kv_cache`` on one card.

Three regimes, one math, dispatched as in the reference:

* ``use_pallas`` and ``S > cfg.attn_chunk`` → kernel E
  (:func:`repro_torch.kernels.ops.flash_attention`);
* ``S > cfg.attn_chunk`` otherwise        → :func:`_chunked_attention`, the
  plain online-softmax twin of the kernel, a loop over blocks;
* ``S ≤ cfg.attn_chunk``                  → :func:`_full_attention`, a plain
  softmax einsum.

Kernel E reads the KV heads in place (query head h reads KV head
h // group); the two plain paths repeat them to the query-head count first,
as the reference does.

Decode (:func:`decode_attention`) is one query against a KV cache of
``Smax`` entries, all of them read every step (the mask keeps the first
``pos + 1``), as in the reference. It writes the new key and value into the
cache in place at the 0-d device tensor ``pos``, never reading it on the
host, and contracts q viewed as (B, KV, group, hd) with each KV head of the
cache where it lies, one matmul per KV head, instead of repeating the
cache's heads: the products are the reference's, only their summation
order may differ. Under M-RoPE the decode position is ``pos`` on all three
components, as in the reference.

Cross-attention (:func:`cross_attention_cache`, :func:`cross_attention`)
is the encoder-decoder's decoder → encoder attention: no mask, no RoPE,
and plain in the reference (``_chunked_attention`` past ``attn_chunk``,
``_full_attention`` below it), so plain here too: it never takes kernel
E.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import expand_kv
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, cdtype, dense_init, rope_for

NEG_INF = -1e30


# --------------------------------------------------------------------- params
def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   dtype: torch.dtype, cross: bool = False) -> dict:
    """wq, wk, wv, wo, and the q/k/v biases where ``cfg.qkv_bias`` and
    not ``cross`` (a cross-attention has none, as in the reference)."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {'wq': dense_init(generator, (d, H * hd), dtype),
         'wk': dense_init(generator, (d, KV * hd), dtype),
         'wv': dense_init(generator, (d, KV * hd), dtype),
         'wo': dense_init(generator, (H * hd, d), dtype)}
    if cfg.qkv_bias and not cross:
        for name, n in (('bq', H), ('bk', KV), ('bv', KV)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=(
                'meta' if generator is None else generator.device))
    return p


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig, rope,
                 n_heads: int | None = None, n_kv: int | None = None):
    """q: (B, S, H, hd), k/v: (B, S, KV, hd), RoPE applied to q and k.
    ``n_heads``/``n_kv``: the heads that ``params`` hold (a rank's share on
    a split model; default the config's)."""
    ct = cdtype(cfg)
    B, S, _ = x.shape
    q = x @ params['wq'].to(ct)
    k = x @ params['wk'].to(ct)
    v = x @ params['wv'].to(ct)
    if 'bq' in params:
        q = q + params['bq'].to(ct)
        k = k + params['bk'].to(ct)
        v = v + params['bv'].to(ct)
    q = q.view(B, S, n_heads or cfg.n_heads, cfg.head_dim)
    k = k.view(B, S, n_kv or cfg.n_kv_heads, cfg.head_dim)
    v = v.view(B, S, n_kv or cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, rope), apply_rope(k, rope), v


def local_kv_heads(cfg: ModelConfig, model: int, rank: int):
    """The KV heads that rank ``rank``'s q heads read on a 'model' axis of
    ``model`` ranks where the KV weights stay whole (``KV % model != 0``):
    ``(lo, hi)`` when those heads are a run that kernel E's GQA rule
    (query head h reads KV head h // (H_local // KV_local)) maps right, or
    the list of one KV head per local q head otherwise (then read with a
    group of 1)."""
    h_local = cfg.n_heads // model
    h0, group = rank * h_local, cfg.group_size
    reads = [(h0 + i) // group for i in range(h_local)]
    lo, hi = reads[0], reads[-1] + 1
    n = hi - lo
    if h_local % n == 0 and all(r - lo == i // (h_local // n)
                                for i, r in enumerate(reads)):
        return lo, hi
    return reads


def _split_qkv(params, x: torch.Tensor, cfg: ModelConfig, rope, split):
    """This rank's q heads and the KV heads they read, from the residual
    stream entering the rank's heads. Where the KV weights stay whole
    (``KV % model != 0``) k and v are sliced to those heads, a strided
    view, so that kernel E reads the right ones."""
    m = split.model
    h_local = cfg.n_heads // m
    kv_split = cfg.n_kv_heads % m == 0
    n_kv = cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads
    q, k, v = _project_qkv(params, split.to_model(x), cfg, rope,
                           n_heads=h_local, n_kv=n_kv)
    if not kv_split:
        heads = local_kv_heads(cfg, m, split.model_rank)
        if isinstance(heads, tuple):
            k, v = k[:, :, heads[0]:heads[1]], v[:, :, heads[0]:heads[1]]
        else:
            at = torch.tensor(heads, device=k.device)
            k, v = k.index_select(2, at), v.index_select(2, at)
    return q, k, v


# ------------------------------------------------------------- core attention
def _full_attention(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """(B, S, H, hd) × (B, T, H, hd); materialises (B, H, S, T). The scores
    are rounded to the compute dtype before the f32 softmax, and the
    probabilities after it, as in the reference."""
    logits = torch.einsum('bshd,bthd->bhst', q, k).float() * scale
    if causal:
        S, T = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((S, T), dtype=torch.bool,
                          device=q.device).tril(T - S)
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum('bhst,bthd->bshd', w, v)


def _chunked_attention(q, k, v, causal: bool, scale: float,
                       chunk: int) -> torch.Tensor:
    """Online-softmax attention over (chunk × chunk) blocks with running
    (max, sum, acc) statistics in f32; the probabilities are rounded to the
    compute dtype before P·V, as in the reference. Under the causal mask
    (top-left, ``qpos >= kpos``) a key block wholly past a query block adds
    exactly nothing in the reference (its probabilities are exp(−1e30 − m)
    = 0 and its rescale exp(0) = 1), so it is skipped here."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    qc, kc = min(chunk, S), min(chunk, T)
    if S % qc or T % kc:
        raise ValueError(f'sequence must divide attn_chunk: S={S}, T={T}, '
                         f'chunk={chunk}')
    out = torch.empty_like(q)
    kpos_all = torch.arange(T, device=q.device)
    for q0 in range(0, S, qc):
        qb = q[:, q0:q0 + qc].transpose(1, 2)                   # (B,H,qc,hd)
        qpos = torch.arange(q0, q0 + qc, device=q.device)
        m = torch.full((B, H, qc), NEG_INF, device=q.device)
        l = torch.zeros((B, H, qc), device=q.device)
        acc = torch.zeros((B, H, qc, hd), device=q.device)
        for k0 in range(0, T, kc):
            if causal and k0 > q0 + qc - 1:
                break
            kb = k[:, k0:k0 + kc].transpose(1, 2)
            vb = v[:, k0:k0 + kc].transpose(1, 2)
            logits = torch.einsum('bhqd,bhkd->bhqk', qb, kb).float() * scale
            if causal:
                keep = qpos[:, None] >= kpos_all[None, k0:k0 + kc]
                logits = logits.masked_fill(~keep, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                'bhqk,bhkd->bhqd', p.to(qb.dtype), vb).float()
            m = m_new
        out[:, q0:q0 + qc] = (acc / l.clamp(min=1e-30)[..., None]).to(
            q.dtype).transpose(1, 2)
    return out


def multihead_attention(params, x: torch.Tensor, cfg: ModelConfig, *,
                        rope: tuple[torch.Tensor, torch.Tensor],
                        causal: bool = True, split=None) -> torch.Tensor:
    """Self-attention of x (B, S, d) → (B, S, d); ``rope`` is the (cos, sin)
    pair of :func:`~repro_torch.models.layers.rope_for` at x's
    positions. ``split`` (a :class:`~repro_torch.models.split.Split`):
    ``params`` are this rank's heads as read (``Split.use``), H/model q
    heads, ``wo`` row-parallel and its products summed over 'model'."""
    B, S, _ = x.shape
    if split is None:
        q, k, v = _project_qkv(params, x, cfg, rope)
    else:
        q, k, v = _split_qkv(params, x, cfg, rope, split)
    group = q.shape[2] // k.shape[2]
    scale = cfg.head_dim ** -0.5
    if cfg.use_pallas and S > cfg.attn_chunk:
        out = ops.flash_attention(q, k, v, causal=causal, scale=scale)
    else:
        k, v = expand_kv(k, group), expand_kv(v, group)
        if S > cfg.attn_chunk:
            out = _chunked_attention(q, k, v, causal, scale, cfg.attn_chunk)
        else:
            out = _full_attention(q, k, v, causal, scale)
    out = out.reshape(B, S, -1) @ params['wo'].to(cdtype(cfg))
    return out if split is None else split.model_sum(out)


# ------------------------------------------------------------------ decoding
def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Zeroed cache ``{'k', 'v'}`` (layers, B, Smax, KV, hd) and a 0-d int32
    ``pos``, on ``device`` (the reference's layout; the caller resolves the
    device)."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {'k': torch.zeros(shape, dtype=dtype, device=device),
            'v': torch.zeros(shape, dtype=dtype, device=device),
            'pos': torch.zeros((), dtype=torch.int32, device=device)}


def decode_rope(cfg: ModelConfig, pos: torch.Tensor, batch: int):
    """The (cos, sin) tables at the 0-d device position ``pos`` for
    ``batch`` sequences; under M-RoPE ``pos`` is every component, as in
    the reference's decode."""
    positions = pos.to(torch.int32).expand(batch, 1)
    if cfg.mrope:
        positions = positions[:, None, :].expand(batch, 3, 1)
    return rope_for(cfg, positions)


def decode_attention(params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, rope=None):
    """One decode token. x: (B, 1, d); cache_k/v: (B, Smax, KV, hd), written
    in place at ``pos`` (a 0-d device tensor; past the end the write lands
    on the last entry, as ``dynamic_update_slice`` clamps); ``rope``: the
    (cos, sin) tables at ``pos`` (made here when not given). Returns
    (out (B, 1, d), cache_k, cache_v)."""
    B, Smax = x.shape[0], cache_k.shape[1]
    if rope is None:
        rope = decode_rope(cfg, pos, B)
    q, k_new, v_new = _project_qkv(params, x, cfg, rope)
    at = torch.clamp(pos.long(), max=Smax - 1).reshape(1)
    cache_k.index_copy_(1, at, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v_new.to(cache_v.dtype))
    out = _decode_core(q, cache_k.to(q.dtype), cache_v.to(q.dtype), pos, cfg)
    return (out.reshape(B, 1, -1) @ params['wo'].to(cdtype(cfg)),
            cache_k, cache_v)


def _decode_core(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q (B, 1, H, hd) against every entry of kc/vc (B, Smax, KV, hd), the
    ones past ``pos`` masked: the scores in the compute dtype, then f32
    times the scale, the f32 softmax cast back, and P·V. Returns
    (B, KV, group, hd), query head h = KV head · group + g."""
    B, Smax, KV = q.shape[0], kc.shape[1], cfg.n_kv_heads
    qg = q.view(B, KV, cfg.n_heads // KV, cfg.head_dim)      # (B, KV, g, hd)
    # (B, KV, g, Smax): each KV head's keys read where they lie
    logits = torch.stack([qg[:, j] @ kc[:, :, j].transpose(1, 2)
                          for j in range(KV)], dim=1).float()
    logits = logits * cfg.head_dim ** -0.5
    valid = torch.arange(Smax, device=q.device) <= pos
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.stack([w[:, j] @ vc[:, :, j] for j in range(KV)], dim=1)


# ------------------------------------------------------------ cross-attention
def cross_attention_cache(params, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder side's K and V, (B, T, KV, hd) each, computed once for a
    whole decode."""
    ct = cdtype(cfg)
    B, T, _ = enc_out.shape
    k = (enc_out @ params['wk'].to(ct)).view(B, T, cfg.n_kv_heads,
                                               cfg.head_dim)
    v = (enc_out @ params['wv'].to(ct)).view(B, T, cfg.n_kv_heads,
                                               cfg.head_dim)
    return k, v


def cross_attention(params, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decoder → encoder attention of x (B, S, d) over k, v (B, T, KV, hd):
    no mask, no RoPE; the plain paths, chunked past ``attn_chunk``."""
    ct = cdtype(cfg)
    B, S, _ = x.shape
    q = (x @ params['wq'].to(ct)).view(B, S, cfg.n_heads, cfg.head_dim)
    kx = expand_kv(k.to(q.dtype), cfg.group_size)
    vx = expand_kv(v.to(q.dtype), cfg.group_size)
    scale = cfg.head_dim ** -0.5
    if S > cfg.attn_chunk or kx.shape[1] > cfg.attn_chunk:
        out = _chunked_attention(q, kx, vx, False, scale, cfg.attn_chunk)
    else:
        out = _full_attention(q, kx, vx, False, scale)
    return out.reshape(B, S, -1) @ params['wo'].to(ct)
