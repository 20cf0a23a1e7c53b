"""Dropless sort-based Mixture-of-Experts on one card: the port of
``repro/models/moe.py``'s ``init_moe``, ``moe_ffn`` and the local body
``_moe_local`` along its ``impl='ragged'`` path.

Token replicas are sorted by their expert and each expert's rows meet its
weights in one matmul, so the products are the active ones only: no
capacity, no dropped token. The reference's ``lax.ragged_dot`` (an XLA op,
not a Pallas kernel) becomes a loop over experts with ``torch.matmul``;
the group sizes that bound each expert's rows are read on the host, **one
device-to-host sync per MoE layer** (the only one: the counts are a
``scatter_add_``, where ``torch.bincount`` on the card would read its
input's maximum on the host too). An expert that gets no token is
skipped.

The products differentiate as the reference's ``_rdot`` VJP does (see
:func:`_grouped`), so MoE trains; the group sizes come from the routing,
which carries no tangent, so ``torch.func``'s HVP columns read them on the
host once a layer too. Not ported yet (``ROADMAP.md``): the fixed-capacity
path that the reference takes under a mesh (``impl='capacity'`` inside
``shard_map``), which waits for the distributed slice.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _ACTS, cdtype, dense_init, pdtype


def init_moe(cfg: ModelConfig, generator: torch.Generator | None,
             dtype: torch.dtype | None = None) -> dict:
    """Router (d, E), expert weights ``w1``/``w3`` (E, d, f) and ``w2``
    (E, f, d), and the ``shared`` expert where ``cfg.shared_expert``; the
    reference's names, shapes and scales. Each expert's slice is drawn in
    f32 and cast at once, so a bf16 init at Llama-4 Maverick's width
    (128 × 5120 × 8192) peaks near its bf16 size plus one f32 slice."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype or pdtype(cfg)

    def experts(shape):
        if generator is None:
            return torch.empty((E,) + shape, dtype=dt, device='meta')
        out = torch.empty((E,) + shape, dtype=dt, device=generator.device)
        for e in range(E):
            out[e] = dense_init(generator, shape, dt)
        return out

    p = {'router': dense_init(generator, (d, E), dt, scale=d ** -0.5),
         'w1': experts((d, f)), 'w3': experts((d, f)), 'w2': experts((f, d))}
    if cfg.shared_expert:
        p['shared'] = {'w1': dense_init(generator, (d, f), dt),
                       'w3': dense_init(generator, (d, f), dt),
                       'w2': dense_init(generator, (f, d), dt)}
    return p


def route(params, xt: torch.Tensor, cfg: ModelConfig):
    """The f32 router: probs (N, E), gate (N, k) renormalised, expert
    (N, k) chosen (descending), the replicas per expert (E,) int64 on the
    device, and the Switch load-balance aux
    E · Σ frac · mean_probs · ``router_aux_coef``."""
    E, k = cfg.n_experts, cfg.top_k
    logits = xt.float() @ params['router'].float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat = expert.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=xt.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    frac = counts.float() / flat.numel()
    aux = E * torch.sum(frac * probs.mean(0)) * cfg.router_aux_coef
    return probs, gate, expert, counts, aux


def _grouped(x: torch.Tensor, w: torch.Tensor, sizes: list[int],
             ct: torch.dtype) -> torch.Tensor:
    """Rows of x sorted by expert, ``sizes[e]`` of them for expert e, each
    group times ``w[e]`` cast to the compute dtype (``lax.ragged_dot``).

    Under ``inference_mode`` (serving) each product is written into one
    output with ``out=``. Otherwise the groups are ``split`` off x, the
    experts ``unbind`` off w, and the products joined by ``cat``, which
    autograd and ``torch.func`` differentiate: dx = dy·wᵀ per group in the
    compute dtype and dw = xᵀ·dy per group (the GEMM accumulates in f32,
    then rounds to the cast weight's dtype), the values of the reference's
    ``_rdot`` VJP; an expert without a token gets an exact zero."""
    if torch.is_inference_mode_enabled():
        out = x.new_empty((x.shape[0], w.shape[-1]))
        start = 0
        for e, n in enumerate(sizes):
            if n:
                torch.matmul(x[start:start + n], w[e].to(ct),
                             out=out[start:start + n])
            start += n
        return out
    return torch.cat([xe @ we.to(ct)
                      for xe, we in zip(torch.split(x, sizes),
                                        torch.unbind(w)) if xe.shape[0]])


def _moe_local(params, xt: torch.Tensor, cfg: ModelConfig):
    """xt (N, d) → (out (N, d) in the compute dtype, aux), the reference's
    ragged path op for op: replicas sorted by expert (stable), the expert
    products in the compute dtype, ``act(h) * g``, unsorted, combined with
    the gates in f32, plus the shared expert in f32."""
    ct = cdtype(cfg)
    N, d = xt.shape
    k = cfg.top_k
    act = _ACTS[cfg.act]
    _, gate, expert, counts, aux = route(params, xt, cfg)
    flat = expert.reshape(N * k)
    order = torch.argsort(flat, stable=True)
    inv_order = torch.argsort(order, stable=True)
    xs = xt[order // k].to(ct)                                 # (Nk, d)
    sizes = counts.tolist()                                    # host sync
    h = _grouped(xs, params['w1'], sizes, ct)
    g = _grouped(xs, params['w3'], sizes, ct)
    out_sorted = _grouped(act(h) * g, params['w2'], sizes, ct)
    out = out_sorted[inv_order].reshape(N, k, d)
    out = torch.einsum('nkd,nk->nd', out.float(), gate)
    if cfg.shared_expert:
        sp = params['shared']
        x = xt.to(ct)
        hs = act(x @ sp['w1'].to(ct)) * (x @ sp['w3'].to(ct))
        out = out + (hs @ sp['w2'].to(ct)).float()
    return out.to(ct), aux


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → (B, S, d) and the router's load-balance aux loss."""
    B, S, d = x.shape
    out, aux = _moe_local(params, x.reshape(B * S, d), cfg)
    return out.reshape(B, S, d), aux
