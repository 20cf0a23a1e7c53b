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


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig, rope):
    """q: (B, S, H, hd), k/v: (B, S, KV, hd), RoPE applied to q and k."""
    ct = cdtype(cfg)
    B, S, _ = x.shape
    q = x @ params['wq'].to(ct)
    k = x @ params['wk'].to(ct)
    v = x @ params['wv'].to(ct)
    if 'bq' in params:
        q = q + params['bq'].to(ct)
        k = k + params['bk'].to(ct)
        v = v + params['bv'].to(ct)
    q = q.view(B, S, cfg.n_heads, cfg.head_dim)
    k = k.view(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.view(B, S, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, rope), apply_rope(k, rope), v


def _kv_of(lay, k, v):
    """k, v (B, T, KV, hd) cut to the KV heads the rank's q heads read
    (``lay``: its :class:`~repro_torch.models.split.HeadLayout`): a view
    where they are a run, else one KV head per q head."""
    if lay.kv_run:
        lo, hi = lay.kv[0], lay.kv[-1] + 1
        return k[:, :, lo:hi], v[:, :, lo:hi]
    at = torch.tensor(lay.kv, device=k.device)
    return k.index_select(2, at), v.index_select(2, at)


def _rows(params, names: tuple, x: torch.Tensor, cfg: ModelConfig,
          split) -> list:
    """The products of x (B, S, d) with the weights ``names`` for every
    head, whole on every rank, under the padded layout's row-parallel
    QKV (the reference's fallback specs): this rank's rows of d_model meet
    its rows of each weight, the partial products are summed over 'model'
    in one ``psum``, and each bias is added after the sum."""
    ct = cdtype(cfg)
    n = params[names[0]].shape[0]
    r0 = split.model_rank * n
    xr = split.to_model(x)[..., r0:r0 + n]
    outs = [xr @ params[w].to(ct) for w in names]
    sizes = [o.shape[-1] for o in outs]
    outs = list(split.model_sum(torch.cat(outs, -1)).split(sizes, -1))
    for i, w in enumerate(names):
        if 'b' + w[1:] in params:
            outs[i] = outs[i] + params['b' + w[1:]].to(ct)
    return outs


def _heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], -1, cfg.head_dim)


def _pad_groups(q: torch.Tensor, cfg: ModelConfig, group: int
                ) -> torch.Tensor:
    """q (B, S, H, hd) → (B, S, KV·group, hd): each KV group's heads, then
    ``group − H/KV`` zero heads."""
    B, S = q.shape[0], q.shape[1]
    KV, g = cfg.n_kv_heads, cfg.group_size
    qg = q.reshape(B, S, KV, g, cfg.head_dim)
    qg = torch.cat([qg, qg.new_zeros(B, S, KV, group - g, cfg.head_dim)], 3)
    return qg.reshape(B, S, KV * group, cfg.head_dim)


def _local_q(q: torch.Tensor, cfg: ModelConfig, split) -> torch.Tensor:
    """The rank's share of the padded heads of the whole q (B, S, H, hd)."""
    lay = split.heads(cfg)
    n0 = split.model_rank * lay.n_local
    q = split.to_model(_pad_groups(q, cfg, lay.group))
    return q[:, :, n0:n0 + lay.n_local]


def _split_q(params, x: torch.Tensor, cfg: ModelConfig, split):
    """This rank's q heads (B, S, n_local, hd), without RoPE."""
    if split.heads(cfg).padded:
        q, = _rows(params, ('wq',), x, cfg, split)
        return _local_q(_heads(q, cfg), cfg, split)
    ct = cdtype(cfg)
    q = split.to_model(x) @ params['wq'].to(ct)
    if 'bq' in params:
        q = q + params['bq'].to(ct)
    return _heads(q, cfg)


def _split_kv(params, xkv: torch.Tensor, cfg: ModelConfig, split):
    """The KV heads (B, T, ·, hd) that this rank's q heads read, without
    RoPE: the column blocks' products where 'model' divides the KV heads,
    else the whole heads (from whole weights, or the padded layout's
    rows) cut to those."""
    lay = split.heads(cfg)
    if lay.padded:
        k, v = (split.to_model(_heads(t, cfg))
                for t in _rows(params, ('wk', 'wv'), xkv, cfg, split))
        return _kv_of(lay, k, v)
    ct = cdtype(cfg)
    xkv = split.to_model(xkv)
    k, v = xkv @ params['wk'].to(ct), xkv @ params['wv'].to(ct)
    if 'bk' in params:
        k, v = k + params['bk'].to(ct), v + params['bv'].to(ct)
    k, v = _heads(k, cfg), _heads(v, cfg)
    if cfg.n_kv_heads % split.model:
        k, v = _kv_of(lay, k, v)
    return k, v


def _split_qkv(params, x: torch.Tensor, cfg: ModelConfig, rope, split):
    """This rank's q heads (:meth:`~repro_torch.models.split.Split.heads`)
    and the KV heads they read, RoPE applied, from the residual stream
    entering them. Split heads: the column blocks' products, k and v
    sliced to the heads read where the KV weights stay whole (``KV %
    model != 0``). The padded layout: the whole heads from the
    row-parallel QKV (:func:`_rows`, one ``psum`` for the three), q padded
    per KV group, and this rank's share of the padded heads and the KV
    heads they read."""
    lay = split.heads(cfg)
    if lay.padded:
        q, k, v = (_heads(t, cfg)
                   for t in _rows(params, ('wq', 'wk', 'wv'), x, cfg, split))
        q = _local_q(q, cfg, split)
        k, v = _kv_of(lay, split.to_model(k), split.to_model(v))
    else:
        q = _split_q(params, x, cfg, split)
        k, v = _split_kv(params, x, cfg, split)
    return apply_rope(q, rope), apply_rope(k, rope), v


def _split_out(out: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig,
               split) -> torch.Tensor:
    """The rank's heads' outputs (B, S, n_local·hd) through their rows of
    ``wo``, summed over 'model': ``wo`` is the rank's row block where the
    heads split, and the whole (replicated) ``wo`` under the padded
    layout, whose pad heads meet no row (zero rows, as the reference pads
    ``wo``)."""
    lay = split.heads(cfg)
    if lay.padded:
        B, S, hd = out.shape[0], out.shape[1], cfg.head_dim
        real = [(i, h) for i, h in enumerate(lay.q_heads) if h is not None]
        out = out.reshape(B, S, -1, hd)[:, :, [i for i, _ in real]]
        out = out.reshape(B, S, -1)
        wo = wo.reshape(cfg.n_heads, hd, -1)[[h for _, h in real]]
        wo = wo.reshape(len(real) * hd, -1)
    return split.model_sum(out @ wo.to(cdtype(cfg)))


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
    if split is not None:
        return _split_out(out.reshape(B, S, -1), params['wo'], cfg, split)
    return out.reshape(B, S, -1) @ params['wo'].to(cdtype(cfg))


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
                     cfg: ModelConfig, rope=None, split=None):
    """One decode token. x: (B, 1, d); cache_k/v: (B, Smax, KV, hd), written
    in place at ``pos`` (a 0-d device tensor; past the end the write lands
    on the last entry, as ``dynamic_update_slice`` clamps); ``rope``: the
    (cos, sin) tables at ``pos`` (made here when not given). Returns
    (out (B, 1, d), cache_k, cache_v).

    ``split``: ``params`` are this rank's blocks as read, and cache_k/v
    its block (B, Smax/model, KV, hd) of the cache's sequence, every KV
    head: flash-decoding (:func:`_decode_core_split`) over the blocks.
    The new token's q, k and v are made for every head on every rank
    (gathered over 'model' where the rank made its heads only: (B, 1, ·)
    vectors, never the cache); the rank whose block holds ``pos`` writes
    the new entry, with no host sync."""
    B, Smax = x.shape[0], cache_k.shape[1]
    if rope is None:
        rope = decode_rope(cfg, pos, B)
    if split is not None:
        q, k_new, v_new = _whole_new_qkv(params, x, cfg, split)
        q, k_new = apply_rope(q, rope), apply_rope(k_new, rope)
        _write_block(cache_k, k_new, pos, split)
        _write_block(cache_v, v_new, pos, split)
        out = _decode_core_split(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                                 pos, cfg, split)
        return (_decode_out(out.reshape(B, 1, -1), params['wo'], cfg, split),
                cache_k, cache_v)
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


# ------------------------------------------------------- decode, split model
def _gather_heads(parts: list, split) -> list:
    """Whole tensors (B, 1, n) from each rank's column blocks (B, 1, n /
    model) of each of ``parts``, in one all-reduce."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P
    B = parts[0].shape[0]
    flat = [t.reshape(B, 1, -1) for t in parts]
    sizes = [t.shape[-1] for t in flat]
    whole = ctx.gather(torch.cat(flat, -1)[:, :, None], P(None, None, 'model'),
                       split.mesh, axes=('model',))
    return [t.reshape(B, 1, -1) for t in whole.split(sizes, -1)]


def _whole_new_qkv(params, x: torch.Tensor, cfg: ModelConfig, split):
    """The new token's q (B, 1, H, hd), k, v (B, 1, KV, hd) for every head,
    whole on every rank, without RoPE: the padded layout's row-parallel
    products (:func:`_rows`), or the rank's heads gathered over 'model'
    (k and v computed whole where their weights are)."""
    if split.heads(cfg).padded:
        return [_heads(t, cfg)
                for t in _rows(params, ('wq', 'wk', 'wv'), x, cfg, split)]
    ct = cdtype(cfg)
    q = x @ params['wq'].to(ct)
    k, v = x @ params['wk'].to(ct), x @ params['wv'].to(ct)
    if 'bq' in params:
        q = q + params['bq'].to(ct)
        k, v = k + params['bk'].to(ct), v + params['bv'].to(ct)
    if cfg.n_kv_heads % split.model == 0:
        q, k, v = _gather_heads([q, k, v], split)
    else:
        q, = _gather_heads([q], split)
    return _heads(q, cfg), _heads(k, cfg), _heads(v, cfg)


def _write_block(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 split) -> None:
    """Write the new entry (B, 1, KV, hd) at ``pos`` into this rank's
    block (B, Sl, KV, hd) of the cache's sequence, in place: the rank
    whose block holds ``pos`` (clamped to the last entry of the last
    block, as the one-rank path clamps) writes it; the others write back
    what their block holds at the clamped local index. No host sync."""
    Sl = cache.shape[1]
    at = (torch.clamp(pos.long(), max=Sl * split.model - 1)
          - split.model_rank * Sl)
    mine = (at >= 0) & (at < Sl)
    at = at.clamp(0, Sl - 1).reshape(1)
    cache.index_copy_(1, at, torch.where(mine, new.to(cache.dtype),
                                         cache.index_select(1, at)))


def _decode_core_split(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                       pos, cfg: ModelConfig, split) -> torch.Tensor:
    """Flash-decoding over the 'model' axis: q (B, 1, H, hd), every head,
    against this rank's block kc/vc (B, Sl, KV, hd) of the sequence,
    entries past ``pos`` masked (``pos`` None: no mask, a cross cache).
    The scores in the compute dtype, then f32 times the scale; the row
    max a ``pmax`` over 'model'; the local sum of exponentials a
    ``psum``; the probabilities normalised by that global sum and cast to
    the compute dtype (as the reference casts its f32 softmax); the local
    P·V in f32, a ``psum`` in f32, rounded once. Returns (B, KV, group,
    hd), whole on every rank."""
    from repro_torch.distributed import ctx
    B, Sl, KV = q.shape[0], kc.shape[1], kc.shape[2]
    qg = q.view(B, KV, q.shape[2] // KV, cfg.head_dim)
    logits = torch.stack([qg[:, j] @ kc[:, :, j].transpose(1, 2)
                          for j in range(KV)], dim=1).float()
    logits = logits * cfg.head_dim ** -0.5
    if pos is not None:
        at = torch.arange(Sl, device=q.device) + split.model_rank * Sl
        logits = logits.masked_fill(~(at <= pos), NEG_INF)
    m = ctx.pmax(logits.amax(-1), split.mesh, ('model',))
    p = torch.exp(logits - m[..., None])
    w = (p / split.model_sum(p.sum(-1))[..., None]).to(q.dtype)
    acc = torch.stack([w[:, j].float() @ vc[:, :, j].float()
                       for j in range(KV)], dim=1)
    return split.model_sum(acc).to(q.dtype)


def _decode_out(out: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig,
                split) -> torch.Tensor:
    """The whole heads' outputs (B, 1, H·hd) through ``wo``: the rank's
    heads through its row block and a ``psum`` where the heads split;
    the replicated ``wo`` whole under the padded layout."""
    ct = cdtype(cfg)
    if split.heads(cfg).padded:
        return out @ wo.to(ct)
    n = wo.shape[0]
    r0 = split.model_rank * n
    return split.model_sum(out[..., r0:r0 + n] @ wo.to(ct))


# ------------------------------------------------------------ cross-attention
def cross_attention_cache(params, enc_out: torch.Tensor, cfg: ModelConfig,
                          split=None):
    """The encoder side's K and V, (B, T, KV, hd) each, computed once for a
    whole decode. ``split``: the KV heads this rank's q heads read
    (:func:`_split_kv`), for a prefill or a training pass; a decode's
    cross cache is :func:`cross_cache_block`."""
    if split is not None:
        return _split_kv(params, enc_out, cfg, split)
    ct = cdtype(cfg)
    B, T, _ = enc_out.shape
    k = (enc_out @ params['wk'].to(ct)).view(B, T, cfg.n_kv_heads,
                                               cfg.head_dim)
    v = (enc_out @ params['wv'].to(ct)).view(B, T, cfg.n_kv_heads,
                                               cfg.head_dim)
    return k, v


def cross_cache_block(params, specs: dict, enc_out: torch.Tensor,
                      cfg: ModelConfig, split):
    """This rank's block of a decode's cross cache: K and V (B, T/model,
    KV, hd), every KV head, of its block of the encoder states enc_out
    (B, T, d). The rank's blocks of ``wk``/``wv`` (spec tree ``specs``)
    are gathered whole (d × KV·hd each: smaller than the cache)."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import spec_axes
    ct = cdtype(cfg)
    B, T = enc_out.shape[0], enc_out.shape[1]
    n = T // split.model
    x = enc_out[:, split.model_rank * n:(split.model_rank + 1) * n]
    out = []
    for name in ('wk', 'wv'):
        w = ctx.gather(params[name], specs[name], split.mesh,
                       axes=spec_axes(specs[name], split.mesh))
        out.append((x @ w.to(ct)).view(B, n, cfg.n_kv_heads, cfg.head_dim))
    return tuple(out)


def cross_attention(params, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg: ModelConfig, split=None,
                    decode: bool = False) -> torch.Tensor:
    """Decoder → encoder attention of x (B, S, d) over k, v (B, T, KV, hd):
    no mask, no RoPE; the plain paths, chunked past ``attn_chunk``.

    ``split``: ``params`` are this rank's blocks as read. In a prefill or
    a training pass k, v are the KV heads the rank's q heads read
    (:func:`cross_attention_cache`) and the rank attends with its heads,
    ``wo`` as in :func:`multihead_attention`. In ``decode`` they are the
    rank's block (B, T/model, KV, hd) of the cross cache's sequence
    (:func:`cross_cache_block`), and the one token's every head takes
    :func:`decode_attention`'s reduction over the blocks, without the
    mask."""
    ct = cdtype(cfg)
    B, S, _ = x.shape
    if split is not None and decode:
        if split.heads(cfg).padded:
            q, = _rows(params, ('wq',), x, cfg, split)
        else:
            q, = _gather_heads([x @ params['wq'].to(ct)], split)
        out = _decode_core_split(_heads(q, cfg), k.to(ct), v.to(ct), None,
                                 cfg, split)
        return _decode_out(out.reshape(B, 1, -1), params['wo'], cfg, split)
    if split is not None:
        q = _split_q(params, x, cfg, split)
    else:
        q = (x @ params['wq'].to(ct)).view(B, S, cfg.n_heads, cfg.head_dim)
    group = q.shape[2] // k.shape[2]
    kx = expand_kv(k.to(q.dtype), group)
    vx = expand_kv(v.to(q.dtype), group)
    scale = cfg.head_dim ** -0.5
    if S > cfg.attn_chunk or kx.shape[1] > cfg.attn_chunk:
        out = _chunked_attention(q, kx, vx, False, scale, cfg.attn_chunk)
    else:
        out = _full_attention(q, kx, vx, False, scale)
    if split is not None:
        return _split_out(out.reshape(B, S, -1), params['wo'], cfg, split)
    return out.reshape(B, S, -1) @ params['wo'].to(ct)
