"""Mixture-of-Experts: the port of ``repro/models/moe.py``'s ``init_moe``,
``moe_ffn`` and the local body ``_moe_local`` along both of its paths.

**Dropless sort-based (``impl='ragged'``, one card).** Token replicas are
sorted by their expert and each expert's rows meet its weights in one
matmul, so the products are the active ones only: no capacity, no dropped
token. The reference's ``lax.ragged_dot`` (an XLA op, not a Pallas kernel)
becomes a loop over experts with ``torch.matmul``; the group sizes that
bound each expert's rows are read on the host, **one device-to-host sync
per MoE layer** (the only one: the counts are a ``scatter_add_``, where
``torch.bincount`` on the card would read its input's maximum on the host
too). An expert that gets no token is skipped. The products differentiate
as the reference's ``_rdot`` VJP does (see :func:`_grouped`), so MoE
trains; the group sizes come from the routing, which carries no tangent,
so ``torch.func``'s HVP columns read them on the host once a layer too.

**Fixed capacity (``impl='capacity'``, under a mesh).** What the reference
runs inside ``shard_map``: each expert takes at most ``cap`` replicas (all
of them while N·k ≤ 8·E, else about 1.25·N·k/E rounded up to 8), a
replica's slot is its place among its expert's replicas (a cumsum), the
kept ones are scattered into an (E, cap, d) buffer, the experts run as
three batched products, and the outputs are gathered back, the dropped
replicas giving 0. No host sync. The body runs on a rank's tokens and its
d_ff slice of the experts (the router whole) in two settings:

  * a replicated model under :func:`~repro_torch.distributed.ctx.
    activation_mesh`: ``moe_ffn`` takes the rank's blocks of the whole
    weights and tokens (the tokens over the batch axes, the experts on
    d_ff over 'model'), and gathers the tokens back;
  * a model split on the mesh (:mod:`repro_torch.models.split`):
    :func:`moe_split` runs on the rank's rows of the batch and its blocks
    as ``Split.use`` hands them, and returns the rank's rows; nothing is
    gathered.

Either way the aux statistics are averaged over the batch axes and the
row-parallel output is built in f32, summed over 'model' in f32, and cast
once. The collectives differentiate in reverse and forward mode and under
``vmap`` (:mod:`repro_torch.distributed.ctx`), so HVP columns
(``vmap(jvp(grad))``) pass through the capacity path: its routing is
integer and carries no tangent, and the scatter is a ``scatter_add`` over
a flat E·cap index.
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


def capacity(Nk: int, E: int) -> int:
    """Slots an expert has for ``Nk`` replicas over ``E`` experts: all of
    them up to 8·E replicas, else ≈ 1.25·Nk/E rounded up to 8 (at least
    8, at most Nk), the reference's formula."""
    if Nk <= 8 * E:
        return Nk
    return min(Nk, max(8, int(1.25 * Nk / E + 7) // 8 * 8))


def _moe_local(params, xt: torch.Tensor, cfg: ModelConfig, axis_names=(),
               impl: str = 'ragged', mesh=None):
    """xt (N, d) → (out (N, d) in the compute dtype, aux). ``'ragged'``: the
    reference's dropless path op for op (replicas sorted by expert, the
    expert products in the compute dtype, ``act(h) * g``, unsorted,
    combined with the gates in f32). ``'capacity'``: its fixed-capacity
    path (see the module doc). Both add the shared expert in f32.

    ``axis_names`` = (model axes, batch axes) when the body runs on a
    rank's blocks of ``mesh``: the weights are the rank's d_ff slice,
    already entering work that varies over the batch axes (the caller's
    ``pvary``, or ``Split.use``'s), the aux statistics are averaged over
    the batch axes and the output summed over the model axes. The
    residual ``xt`` and the router are invariant over the model axes;
    where they meet the rank's d_ff slice (the dispatched tokens, the
    gates, the shared expert's input), :func:`~repro_torch.distributed.
    ctx.pvary` sums their cotangents over 'model' once, as the
    reference's ``shard_map`` transposes them."""
    ct = cdtype(cfg)
    N, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    act = _ACTS[cfg.act]
    model_axes, batch_axes = axis_names or ((), ())
    if (model_axes or batch_axes) and mesh is None:
        raise ValueError(f'axis_names {axis_names} need the mesh')
    if mesh is not None:
        from repro_torch.distributed import ctx

    def to_model(x):
        return ctx.pvary(x, mesh, model_axes) if model_axes else x
    probs, gate, expert, counts, aux = route(params, xt, cfg)
    if batch_axes:
        frac = ctx.pmean(counts.float() / (N * k), mesh, batch_axes)
        mean_probs = ctx.pmean(probs.mean(0), mesh, batch_axes)
        aux = E * torch.sum(frac * mean_probs) * cfg.router_aux_coef
    if impl == 'ragged':
        flat = expert.reshape(N * k)
        order = torch.argsort(flat, stable=True)
        inv_order = torch.argsort(order, stable=True)
        xs = xt[order // k].to(ct)                             # (Nk, d)
        sizes = counts.tolist()                                # host sync
        h = _grouped(xs, params['w1'], sizes, ct)
        g = _grouped(xs, params['w3'], sizes, ct)
        out_sorted = _grouped(act(h) * g, params['w2'], sizes, ct)
        out = out_sorted[inv_order].reshape(N, k, d)
        out = torch.einsum('nkd,nk->nd', out.float(), gate)
    elif impl == 'capacity':
        Nk = N * k
        cap = capacity(Nk, E)
        flat = expert.reshape(Nk)
        onehot = torch.nn.functional.one_hot(flat, E).to(torch.int32)
        pos = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot  # pre-count
        slot = torch.gather(pos, 1, flat[:, None])[:, 0].long()
        keep = slot < cap
        # a dropped replica adds zeros to its expert's last slot
        where = flat * cap + torch.clamp(slot, max=cap - 1)    # (Nk,) in E·cap
        token_of = torch.arange(Nk, device=xt.device) // k
        xs = xt[token_of].to(ct) * keep[:, None].to(ct)
        buf = torch.zeros((E * cap, d), dtype=ct, device=xt.device)
        buf = buf.scatter_add(0, where[:, None].expand(Nk, d), xs)
        buf = to_model(buf.view(E, cap, d))
        gate = to_model(gate)
        h = torch.bmm(buf, params['w1'].to(ct))
        g = torch.bmm(buf, params['w3'].to(ct))
        y = torch.bmm(act(h) * g, params['w2'].to(ct))         # (E, cap, d)
        picked = (y.reshape(E * cap, d)[where].float()
                  * keep[:, None].float())
        out = torch.einsum('nkd,nk->nd', picked.reshape(N, k, d), gate)
    else:
        raise ValueError(f"impl must be 'ragged' or 'capacity', got {impl!r}")
    if cfg.shared_expert:
        sp = params['shared']
        x = to_model(xt.to(ct))
        hs = act(x @ sp['w1'].to(ct)) * (x @ sp['w3'].to(ct))
        out = out + (hs @ sp['w2'].to(ct)).float()
    if model_axes:
        # the row-parallel second product: one sum over the model axes, f32
        out = ctx.psum(out, mesh, model_axes)
    return out.to(ct), aux


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → (B, S, d) and the router's load-balance aux loss.

    Without a current mesh: the dropless ``ragged`` path. Under one
    (:func:`~repro_torch.distributed.ctx.activation_mesh`): the
    ``capacity`` path on this rank's blocks, with the reference's specs —
    the tokens over the batch axes where N divides, the experts on d_ff
    over 'model' where d_ff divides, the router replicated — and the
    tokens gathered back whole."""
    from repro_torch.core.tree_util import tree_map
    from repro_torch.distributed.ctx import current_mesh
    B, S, d = x.shape
    N = B * S
    xt = x.reshape(N, d)
    mesh = current_mesh()
    if mesh is None:
        out, aux = _moe_local(params, xt, cfg)
        return out.reshape(B, S, d), aux

    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P
    batch_axes = tuple(a for a in ('pod', 'data') if a in mesh.axis_names)
    if N % mesh.axes_size(batch_axes) != 0:
        batch_axes = ()
    model_axes = (('model',) if 'model' in mesh.axis_names
                  and cfg.d_ff % mesh.shape['model'] == 0 else ())
    tok_spec = P(batch_axes if batch_axes else None, None)
    m0 = model_axes[0] if model_axes else None
    w_col, w_row = P(None, None, m0), P(None, m0, None)
    pspec = {'router': P(None, None), 'w1': w_col, 'w3': w_col, 'w2': w_row}
    if cfg.shared_expert:
        pspec['shared'] = {'w1': P(None, m0), 'w3': P(None, m0),
                           'w2': P(m0, None)}

    def body(p_, x_):
        # the blocks of the whole weights are invariant over the batch axes
        p_ = tree_map(lambda w: ctx.pvary(w, mesh, batch_axes), p_)
        return _moe_local(p_, x_, cfg, (model_axes, batch_axes),
                          impl='capacity', mesh=mesh)

    out, aux = ctx.shard_map(body, mesh, in_specs=(pspec, tok_spec),
                             out_specs=(tok_spec, P()))(params, xt)
    return ctx.gather(out, tok_spec, mesh).reshape(B, S, d), aux


def moe_split(params, x: torch.Tensor, cfg: ModelConfig, split):
    """x (B_local, S, d), this rank's rows of the batch with the whole d →
    (this rank's rows of the output, the aux loss), over a model split on
    the mesh (``split``, a :class:`~repro_torch.models.split.Split`).

    ``params`` are the rank's blocks as ``Split.use`` reads them: the
    router whole (gathered over 'data' under FSDP), entering the batch
    axes only; the experts' and the shared expert's d_ff slices over
    'model'. The ``capacity`` body runs on the rank's B_local·S tokens
    (the capacity comes from that N), as the reference's ``shard_map``
    body runs on its token shard: replicas past it drop, the aux
    statistics are averaged over ``split.batch_axes`` and the output is
    summed over 'model' in f32. Nothing is gathered, and nothing reads
    the host."""
    B, S, d = x.shape
    model_axes = ('model',) if 'model' in split.mesh.axis_names else ()
    out, aux = _moe_local(params, x.reshape(B * S, d), cfg,
                          (model_axes, split.batch_axes), impl='capacity',
                          mesh=split.mesh)
    return out.reshape(B, S, d), aux
