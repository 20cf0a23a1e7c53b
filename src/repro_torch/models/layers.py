"""Shared building blocks: dtypes, init, RMSNorm, RoPE and M-RoPE, SwiGLU
MLP and the embeddings. The port of ``repro/models/layers.py``.

Parameters are plain dicts of tensors, in the reference's orientation
(``w1`` is (d, d_ff), used as ``x @ w1``), so that weights carry across
without transposes. Compute happens in ``cfg.compute_dtype`` with the
reference's casts; parameters live in ``cfg.param_dtype`` unless the caller
of ``init`` asks for another dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def dense_init(generator: torch.Generator | None, shape, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (±3σ), drawn in f32 on the generator's
    device and cast to ``dtype`` at once. ``generator=None``: an unfilled
    ``meta`` tensor (shapes only)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device='meta')
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.mul_(std).to(dtype)


def records_graph(*tensors: torch.Tensor) -> bool:
    """An autograd pass that records a graph, outside ``torch.func``'s
    transforms (which refuse ``torch.utils.checkpoint``'s saved-tensor
    hooks), and, where ``tensors`` are given, one of them requires grad:
    where activation checkpointing can run and pays."""
    return (torch.is_grad_enabled()
            and torch._C._functorch.peek_interpreter_stack() is None
            and (not tensors or any(t.requires_grad for t in tensors)))


# ----------------------------------------------------------------- RMSNorm
def init_rmsnorm(cfg: ModelConfig, device, dtype: torch.dtype,
                 dim: int | None = None) -> dict:
    return {'scale': torch.ones((dim or cfg.d_model,), dtype=dtype,
                                device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float,
            use_pallas: bool = False) -> torch.Tensor:
    """``use_pallas`` (the reference's name) routes through kernel D."""
    return (ops.rmsnorm if use_pallas else ref.rmsnorm)(
        x, params['scale'], eps)


# ----------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float) -> torch.Tensor:
    """1 / θ^(2i/hd) in f32, on the host. The exponent is the reference's
    f32 value; θ to that power is rounded once from f64, which gives the
    reference's f32 value exactly, where f32 ``pow`` can be one ulp off
    (the error grows with the position)."""
    expo = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    powers = (np.float64(theta) ** expo.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(np.float32(1.0) / powers)


@functools.lru_cache(maxsize=None)
def _frequencies_on(head_dim: int, theta: float,
                    device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` copied to ``device`` once: a copy from the
    host each step would wait for the card's queue to drain. A plain
    tensor even when first asked for under ``inference_mode`` or inside a
    ``torch.func`` transform (which would wrap it at a level that is gone
    by the next call)."""
    with torch.inference_mode(False), torch._C._DisableFuncTorch():
        return rope_frequencies(head_dim, theta).to(device)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotation angles for positions (B, S) int, each
    (B, S, 1, hd/2) in f32. A forward takes them once and every layer's q
    and k share them."""
    freqs = _frequencies_on(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs           # (B, S, hd/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


@functools.lru_cache(maxsize=None)
def _sections_on(sections: tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """The position component (0 = t, 1 = h, 2 = w) of each of the hd/2
    frequency slots under M-RoPE's ``sections``, on ``device`` once, a
    plain tensor as :func:`_frequencies_on`'s."""
    with torch.inference_mode(False), torch._C._DisableFuncTorch():
        return torch.repeat_interleave(
            torch.arange(len(sections)), torch.tensor(sections)).to(device)


def mrope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's multimodal RoPE (the reference's ``apply_mrope``) as the
    (cos, sin) tables of :func:`rope_tables`: positions (B, 3, S) are the
    (t, h, w) ids, and the hd/2 frequency slots are split by ``sections``
    (summing to hd/2), each rotating by its own component. With all three
    components equal it is plain RoPE, bit for bit."""
    freqs = _frequencies_on(head_dim, theta, positions.device)
    sec = _sections_on(tuple(sections), positions.device)
    comp = positions.transpose(1, 2).float()                  # (B, S, 3)
    angles = comp.index_select(-1, sec) * freqs              # (B, S, hd/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rope_for(cfg: ModelConfig, positions: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables at ``positions`` for ``cfg``: M-RoPE where
    ``cfg.mrope`` (positions (B, 3, S)), else plain RoPE on (B, S)
    positions, or on the first component of (B, 3, S) ones, as the
    reference's ``_project_qkv`` does."""
    if cfg.mrope:
        return mrope_tables(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    if positions.ndim == 3:
        positions = positions[:, 0]
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def apply_rope(x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
    """x: (B, S, H, hd); rope: (cos, sin) from :func:`rope_tables`.
    Split-halves rotation, in f32, cast back to x's dtype."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- SwiGLU MLP
def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             dtype: torch.dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {'w1': dense_init(generator, (d, f), dtype),
            'w3': dense_init(generator, (d, f), dtype),
            'w2': dense_init(generator, (f, d), dtype)}


_ACTS = {'silu': F.silu, 'gelu': lambda x: F.gelu(x, approximate='tanh'),
         'relu': F.relu, 'leaky_relu': lambda x: F.leaky_relu(x, 0.01)}


def mlp(params, x: torch.Tensor, cfg: ModelConfig, split=None
        ) -> torch.Tensor:
    """SwiGLU. ``split`` (a :class:`~repro_torch.models.split.Split`):
    ``params`` are this rank's column blocks of ``w1``/``w3`` and row
    block of ``w2`` as read (``Split.use``), and the partial products are
    summed over 'model' (Megatron's column- then row-parallel FFN)."""
    ct = cdtype(cfg)
    if split is not None:
        x = split.to_model(x)
    h = _ACTS[cfg.act](x @ params['w1'].to(ct)) * (x @ params['w3'].to(ct))
    out = h @ params['w2'].to(ct)
    return out if split is None else split.model_sum(out)


# ----------------------------------------------------------------- embeddings
def init_embedding(cfg: ModelConfig, generator: torch.Generator,
                   dtype: torch.dtype) -> dict:
    return {'table': dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                dtype, scale=1.0)}


def embed(params, tokens: torch.Tensor, cfg: ModelConfig,
          split=None) -> torch.Tensor:
    """The rows of ``tokens``. ``split``: ``params['table']`` is this
    rank's block [lo, hi) of the padded vocab; the tokens inside it are
    looked up, the rest give zeros, and the rows are summed over
    'model'."""
    table = params['table'].to(cdtype(cfg))
    if split is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens.long() - split.vocab_offset(n)
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return split.model_sum(torch.where(inside[..., None], rows,
                                       torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device)))


def unembed(params, x: torch.Tensor, cfg: ModelConfig,
            split=None) -> torch.Tensor:
    """Logits against the (padded) vocab; pad slots masked to the dtype's
    lowest value. ``split``: this rank's block of the vocab, (…, V/model)
    logits, the pad slots found by their global positions."""
    if split is not None:
        x = split.to_model(x)
    logits = x @ params['table'].to(cdtype(cfg)).T
    if cfg.padded_vocab != cfg.vocab_size:
        n = logits.shape[-1]
        lo = 0 if split is None else split.vocab_offset(n)
        pad = torch.arange(lo, lo + n, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    return logits


# ----------------------------------------------------------------- loss
def split_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                     split) -> torch.Tensor:
    """The reference's token CE (``lse − the label's logit``, (B, S) f32)
    from this rank's block of the vocab's logits (…, V/model): the max is
    a ``pmax`` (it only stabilises: no gradient), the sum of exponentials
    a ``psum``, and the label's logit is taken on the shard that owns it
    and ``psum``'d, all over 'model'."""
    from repro_torch.distributed import ctx
    n = logits.shape[-1]
    lo = split.vocab_offset(n)
    is_label = (torch.arange(lo, lo + n, device=logits.device)
                == labels[..., None].long())
    m = ctx.pmax(torch.amax(logits, dim=-1).float(), split.mesh, ('model',))
    sumexp = split.model_sum(torch.sum(
        torch.exp(logits.float() - m[..., None]), dim=-1))
    ll = split.model_sum(torch.where(
        is_label, logits, torch.zeros((), dtype=logits.dtype,
                                      device=logits.device)).sum(-1).float())
    return m + torch.log(sumexp) - ll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean CE in f32 with an optional z-loss (``z_loss`` · lse², the
    logit-norm stabilizer); with ``mask``, the mean over its weight
    (at least 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is not None:
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1)
    return loss.mean()
