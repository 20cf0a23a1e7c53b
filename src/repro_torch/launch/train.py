"""The training CLI of the port: the bilevel LM trainer, and the problem
routes (registered problems through ``solve()``, influence problems through
``influence()`` or the serving tier, the multi-level engine's graphs
through ``Engine.solve``).

The counterpart of ``repro/launch/train.py``, on one card or over a
model split on a mesh of ranks:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi_9b --reduced \\
      --steps 6 --outer-every 3 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --problem reweighting \\
      --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --problem influence \\
      --serve --queries 8
  PYTHONPATH=src python -m repro_torch.launch.train --problem distill_hpo \\
      --steps 3 --log-every 1

Without ``--problem`` it trains a transformer with §5.4's per-domain data
reweighting (:func:`train_lm`): AdamW inner steps on the weighted token CE,
and every ``--outer-every`` steps a Nyström hypergradient of a clean
batch's loss with respect to the domain logits, through the implicit map
at the warm-started parameters. ``--ckpt-dir`` checkpoints and resumes.
Launched in a world of several ranks (``torchrun --nproc-per-node N``:
the CLI joins the group, each rank on a card of its own over NCCL, or on
the CPU over gloo under ``--device cpu``), the LM route makes
``make_host_mesh()``, as the reference does, or ``make_production_mesh()``
under ``--production-mesh`` (which needs a world of 256 or 512 ranks), and
trains the model split on it (:mod:`repro_torch.models.split`: the dense
GQA family; the rest raises):

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch yi_9b \
      --reduced --steps 4 --outer-every 2 --batch 4 --seq 32 --device cpu

``--serve`` stands up the serving tier (:mod:`repro_torch.serve`) and
answers ``--queries`` queries twice, cold (the first flush builds the
sketch into the store) and warm (every flush hits the store: zero build
HVPs), printing each pass's latency and cache statistics. Runs on the card
unless ``--device cpu``. The backend is the reference's default
(``tree``); the kernels serve through ``HypergradConfig(backend='cuda')``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.core.hypergrad import config_from_cli
from repro_torch.core.tree_util import tree_map


# ------------------------------------------------------------- the LM route
@dataclasses.dataclass
class LMRun:
    """What :func:`train_lm` ends with: the final parameters, optimizer
    state, hyperparameters and their optimizer's state; the inner loss of
    every step run (``losses``, host floats) and its seconds
    (``step_s``); and one record per outer step (``outer``): the loop index
    ``i``, the outer value before the update (``val``), the hypergradient
    (``hypergrad``), the domain logits after the update (``logits``), the
    noisy-domain weight, and the seconds of the sketch refresh
    (``build_s``: the k HVP columns and ``prepare``) and of the
    hypergradient (``grad_s``: the apply and the mixed term)."""
    params: Any
    opt_state: Any
    hparams: dict
    outer_state: Any
    losses: list
    step_s: list
    outer: list


def _whole_state(tree: dict, split, params) -> list:
    """The NamedSharding of each leaf of a checkpointed tree ``{'params',
    'opt', 'h', 'houter'}`` over a split model: the parameters' specs, the
    optimizer state's mirrored from them by structure, and the
    hyperparameters replicated."""
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.distributed.sharding import (P, NamedSharding,
                                                  spec_leaves)
    from repro_torch.models.split import state_spec_leaves
    by_key = {'params': spec_leaves(split.specs),
              'opt': state_spec_leaves(tree['opt'], params, split.specs),
              'h': [P()] * len(tree_leaves(tree['h'])),
              'houter': [P()] * len(tree_leaves(tree['houter']))}
    return [NamedSharding(split.mesh, s)
            for key in sorted(by_key) for s in by_key[key]]   # leaf order


def _gathered(tree: dict, shardings: list) -> dict:
    """Every leaf of ``tree`` whole (one ``gather`` a split leaf), for the
    reference's checkpoint format."""
    from repro_torch.core.tree_util import tree_flatten
    from repro_torch.distributed import ctx
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([
        ctx.gather(x, s.spec, s.mesh) if any(e is not None for e in s.spec)
        else x for x, s in zip(leaves, shardings)])


def train_lm(cfg, hg_cfg, *, steps: int, batch: int, seq: int,
             outer_every: int, ckpt_dir: str | None = None,
             ckpt_every: int = 100, log_every: int = 10, device=None,
             params=None, indices: Callable[[int], dict] | None = None,
             mesh=None) -> LMRun:
    """The bilevel LM trainer (the reference's loop).

    Inner steps: ``make_optimizer(cfg)`` on the domain-weighted token CE of
    ``TokenStream`` batches (step-indexed, prefetched on a host thread),
    warm-started across outer steps. After every ``outer_every``-th step i:
    a clean outer batch (``stream.batch(10_000_000 + i, ...,
    clean_only=True)``), the sketch refreshed by ``SketchPolicy`` at the
    last inner batch, the outer value and its hypergradient through
    ``implicit_root`` (the value taken before the update), and
    ``adam(1e-2)`` on ``domain_logits``. ``ckpt_dir``: save every
    ``ckpt_every`` steps and at the end (unless that step was just saved:
    the reference's loop saves it twice, and the second rename fails),
    and resume from the latest save.

    ``device``: the card unless ``'cpu'``. ``params``: initial parameters
    (default: ``init`` from ``torch.Generator().manual_seed(0)`` on the
    device). The sketch's column draw at step i comes from
    ``torch.Generator().manual_seed(i)``, or ``indices(i)`` when given (the
    parity tests pass the reference's draws). ``TokenStream`` gives token
    batches only, as the reference's does: an encoder-decoder or an
    embedding-input config raises ``ValueError`` (they train through
    ``build_train_step`` and ``build_hypergrad_step`` on batches in
    ``make_batch_sds``'s layout). Every token config trains here, the
    recurrent ones (Jamba, RWKV-6) too.

    ``mesh``: the model split on it (:mod:`repro_torch.models.split`):
    ``params`` (default: the same init, then this rank's blocks) and the
    optimizer state are blocks, every rank reads the same batches and takes
    its rows, the Nyström solver runs on ``flat_sharded`` over the blocks
    (``hg_cfg``'s ``sketch_dtype``), and the draws are over the whole
    model, so that a run matches one rank's at the same seeds. Checkpoints
    gather each leaf whole into the reference's format (rank 0 writes) and
    resume as blocks. Only rank 0 prints."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import SketchPolicy
    from repro_torch.data import Prefetcher, ShardedLoader, TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import (N_DOMAINS, domain_losses,
                                          lm_hypergrad, local_batch,
                                          loss_and_grads, make_optimizer,
                                          to_device)
    from repro_torch.models import build_model
    from repro_torch.models.split import make_split
    from repro_torch.optim import adam

    if cfg.is_encdec or not cfg.embed_inputs:
        raise ValueError(
            f'{cfg.name}: the LM trainer reads token batches from '
            'TokenStream, and this config takes '
            + ('encoder frames' if cfg.is_encdec else '(B, S, d) embeddings')
            + '; train it through launch.steps.build_train_step and '
            'build_hypergrad_step on batches in make_batch_sds\'s layout')
    dev = resolve_device(device)
    split = None if mesh is None else make_split(cfg, mesh, batch)
    speak = mesh is None or mesh.rank == 0
    rows = ((lambda b: to_device(b, dev)) if split is None
            else (lambda b: local_batch(b, split, dev)))

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize()

    if params is None:
        params = build_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        if split is not None:
            from repro_torch.models.split import shard_params
            params = shard_params(params, split.specs, mesh)
    inner_loss, outer_loss = domain_losses(cfg, split)
    optimizer = make_optimizer(cfg, split)
    opt_state = optimizer.init(params)
    hparams = {'domain_logits': torch.zeros((N_DOMAINS,), device=dev)}
    outer_opt = adam(1e-2)
    outer_state = outer_opt.init(hparams)

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    shardings = None
    if ckpt and split is not None:
        from repro_torch.models.transformer import abstract_params
        whole = abstract_params(cfg)
        shardings = _whole_state({'params': params, 'opt': opt_state,
                                  'h': hparams, 'houter': outer_state},
                                 split, params)

    def save(step):
        tree = {'params': params, 'opt': opt_state, 'h': hparams,
                'houter': outer_state}
        if shardings is not None:
            tree = _gathered(tree, shardings)
        if speak:
            ckpt.save(step, tree)

    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        template = {'params': params, 'opt': opt_state, 'h': hparams,
                    'houter': outer_state}
        if shardings is not None:
            template = dict(template, params=whole,
                            opt=optimizer.init(whole))
        tree, manifest = ckpt.restore_latest(
            template, shardings=shardings,
            device=None if shardings is None else dev)
        params, opt_state = tree['params'], tree['opt']
        hparams, outer_state = tree['h'], tree['houter']
        start_step = manifest['step']
        if speak:
            print(f'[train] resumed from step {start_step}')

    if split is None:
        solver = hg_cfg.build()
    else:
        from repro_torch.launch.steps import split_solver
        solver = split_solver(mesh, split.specs, hg_cfg)
    if getattr(type(solver), 'amortizable', False):
        policy = SketchPolicy(solver=solver, inner_loss=inner_loss,
                              refresh_every=hg_cfg.sketch_refresh_every)
    elif hg_cfg.sketch_refresh_every > 1:
        raise TypeError(
            f'--sketch-refresh-every={hg_cfg.sketch_refresh_every} needs an '
            f'amortizable solver; {type(solver).__name__} prepares a '
            'step-local state with nothing to reuse across outer steps')
    else:
        policy = None

    def inner_step(params, opt_state, hparams, step, b):
        loss, grads = loss_and_grads(inner_loss, params, hparams, b)
        params, opt_state = optimizer.apply(grads, opt_state, params, step)
        return params, opt_state, loss

    def outer_step(params, hparams, outer_state, i, inner_b, outer_b, rng,
                   draw, sketch_state):
        sync()
        t0 = time.perf_counter()
        if policy is not None:
            sketch_state, _ = policy.refresh(sketch_state, params, hparams,
                                             inner_b, rng, indices=draw)
        sync()
        t1 = time.perf_counter()
        val, hg = lm_hypergrad(
            solver, inner_loss, outer_loss, params, hparams, inner_b,
            outer_b, state=None if policy is None else sketch_state.sketch,
            rng=rng, indices=draw)
        sync()
        t2 = time.perf_counter()
        hparams, outer_state = outer_opt.apply(hg, outer_state, hparams, i)
        return (hparams, outer_state, val, hg, sketch_state,
                {'build_s': t1 - t0, 'grad_s': t2 - t1})

    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq)
    noisy_ids = torch.tensor(stream.noisy_domains, device=dev)
    losses, step_s, outer = [], [], []
    saved = start_step if ckpt else None   # the step last saved
    sketch_state = None
    loss = None
    t_start = time.time()
    with Prefetcher(ShardedLoader(lambda s: stream.batch(s, batch),
                                  start_step=start_step), depth=2) as loader:
        for i in range(start_step, steps):
            b = rows(next(loader))
            sync()
            t0 = time.perf_counter()
            params, opt_state, loss = inner_step(params, opt_state, hparams,
                                                 i, b)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
            if speak and log_every and (i + 1) % log_every == 0:
                rate = (i + 1 - start_step) / (time.time() - t_start)
                print(f'[train] step {i+1} loss={float(loss):.4f} '
                      f'({rate:.2f} steps/s)', flush=True)
            if (i + 1) % outer_every == 0:
                outer_b = rows(stream.batch(10_000_000 + i, batch,
                                            clean_only=True))
                if policy is not None and (sketch_state is None
                                           or policy.due(sketch_state)):
                    # a stale sketch goes before the build of the next one
                    sketch_state = policy.init_state()
                hparams, outer_state, val, hg, sketch_state, secs = \
                    outer_step(params, hparams, outer_state, i, b, outer_b,
                               torch.Generator().manual_seed(i),
                               None if indices is None else indices(i),
                               sketch_state)
                w = torch.softmax(hparams['domain_logits'], dim=-1)
                noisy = float(w[noisy_ids].sum())
                outer.append(dict(i=i, val=float(val),
                                  hypergrad=hg['domain_logits'].detach(),
                                  logits=hparams['domain_logits'].detach(),
                                  noisy_weight=noisy, **secs))
                if speak:
                    print(f'[outer] step {i+1} val(pre-update)='
                          f'{float(val):.4f} noisy-domain weight={noisy:.3f} '
                          f'(uniform={len(stream.noisy_domains) / stream.n_domains:.3f})',
                          flush=True)
            if ckpt and (i + 1) % ckpt_every == 0:
                save(i + 1)
                saved = i + 1
    if ckpt:
        if saved != steps:      # the step's directory exists otherwise
            save(steps)
        ckpt.wait()
        if mesh is not None:    # rank 0's files are whole before any reads
            import torch.distributed as dist
            dist.barrier()
    final = 'none' if loss is None else f'{float(loss):.4f}'
    if speak:
        print(f'[train] done: {steps} steps, final loss {final}')
    return LMRun(params=params, opt_state=opt_state, hparams=hparams,
                 outer_state=outer_state, losses=losses, step_s=step_s,
                 outer=outer)


def _lm_mesh(args):
    """(mesh, device, whether the CLI joined the group) of the LM route.
    In one process: no mesh, and the card unless ``--device cpu``. In a
    world of several ranks (``torchrun`` sets ``WORLD_SIZE`` and
    ``LOCAL_RANK``; the CLI joins the group unless one exists, and leaves
    it when the run ends): each rank on a card of its own,
    ``cuda:LOCAL_RANK``, joined over NCCL, or on the CPU over gloo under
    ``--device cpu``; the mesh is ``make_host_mesh()``, or
    ``make_production_mesh()`` under ``--production-mesh``."""
    import os

    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    dev = resolve_device(args.device)
    if not dist.is_initialized() and int(os.environ.get('WORLD_SIZE',
                                                        '1')) <= 1:
        if args.production_mesh:
            raise SystemExit(
                '--production-mesh needs a world of 256 (512) ranks, '
                'launched under torchrun; in one process the LM trainer runs '
                'on one card (a dry run of the production mesh on one host, '
                'launch/dryrun.py, is ROADMAP item 12, not ported)')
        return None, dev, False
    if dev.type == 'cuda' and dev.index is None:
        local = int(os.environ.get('LOCAL_RANK', '0'))
        if local >= torch.cuda.device_count():
            raise SystemExit(
                f'local rank {local} has no card of its own '
                f'({torch.cuda.device_count()} on this host): the LM route '
                'over a mesh runs one rank a card')
        dev = torch.device('cuda', local)
        torch.cuda.set_device(dev)
    joined = not dist.is_initialized()
    if joined:
        dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo')
    mesh = (make_production_mesh() if args.production_mesh
            else make_host_mesh())
    return mesh, dev, joined


def _run_lm(args):
    """No ``--problem``: the bilevel LM trainer on ``--arch``, over the
    model split on a mesh where the world has several ranks."""
    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh, dev, joined = _lm_mesh(args)
    if mesh is None or mesh.rank == 0:
        print(f'[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M '
              f'device={dev}' + ('' if mesh is None
                                 else f' mesh={dict(mesh.shape)}'))
    # registry-driven flag forwarding: explicitly passed flags the solver
    # does not consume are refused, never silently dropped
    hg_cfg = config_from_cli(
        args.solver,
        flags={'k': args.k, 'rho': args.rho,
               'sketch_refresh_every': args.sketch_refresh_every},
        defaults={'k': 8, 'rho': 1e-2},
        column_chunk=4)
    try:
        return train_lm(cfg, hg_cfg, steps=args.steps, batch=args.batch,
                        seq=args.seq, outer_every=args.outer_every,
                        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        log_every=args.log_every, device=dev, mesh=mesh)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run_graph(args):
    """``--problem <graph-name>``: a multi-level GRAPHS entry (trilevel
    chains) routed through ``Engine.solve``. ``--solver``/``--rho``/
    ``--sketch-refresh-every`` configure every edge uniformly (per-edge
    overrides are a builder-kwarg affair); ``--steps`` counts outer
    steps."""
    from repro_torch.engine import Engine, EngineConfig, get_graph
    kwargs = {'solver': args.solver}
    if args.rho is not None:
        kwargs['rho'] = args.rho
    if args.sketch_refresh_every is not None:
        kwargs['refresh_every'] = args.sketch_refresh_every
    graph = get_graph(args.problem, device=args.device, **kwargs)
    order = graph.chain_order()
    print(f'[train] graph={args.problem} levels={"<-".join(order)} '
          f'solver={args.solver} n_outer={args.steps}')
    result = Engine().solve(graph, EngineConfig(n_outer=args.steps))
    for i, loss in enumerate(result.losses):
        if i % max(1, args.log_every) == 0 or i == len(result.losses) - 1:
            print(f'[engine] outer {i}: top_loss={loss:.6f}')
    bills = ' '.join(f'{e}={n}' for e, n in result.edge_hvps.items())
    print(f'[train] done: graph={args.problem} hvps={result.hvp_count} '
          f'({bills}) wall_s={result.seconds:.1f}')
    return result


def _run_problem(args):
    """``--problem <name>``: resolve the registry entry and drive it through
    the problem API. An :class:`~repro_torch.core.problem.InfluenceProblem`
    routes to ``influence()`` (or, with ``--serve``, the serving tier)
    instead of ``solve()``; a multi-level graph name (``repro_torch.engine``
    GRAPHS registry) routes to ``Engine.solve`` — ``--steps`` then counts
    training (resp. outer) steps and ``--queries``/``--top-k`` size the
    query block and the result."""
    from repro_torch.core.problem import (InfluenceProblem, get_problem,
                                          influence, solve)
    from repro_torch.engine import GRAPHS
    if args.problem in GRAPHS:
        return _run_graph(args)
    hg_cfg = config_from_cli(
        args.solver,
        flags={'k': args.k, 'rho': args.rho,
               'sketch_refresh_every': args.sketch_refresh_every},
        defaults={'k': 8, 'rho': 1e-2})
    problem = get_problem(args.problem, device=args.device)
    if isinstance(problem, InfluenceProblem):
        if args.serve:
            return _serve_problem(problem, hg_cfg, args)
        queries = problem.reference['queries'](args.queries)
        print(f'[train] influence problem={problem.name} '
              f'solver={args.solver} m={args.queries} top_k={args.top_k}')
        result = influence(problem, hg_cfg, queries, top_k=args.top_k,
                           train_steps=args.steps, device=args.device)
        for q in range(result.scores.shape[0]):
            pairs = ' '.join(
                f'{int(i)}:{float(s):+.4f}'
                for s, i in zip(result.scores[q], result.indices[q]))
            print(f'[influence] query {q}: {pairs}')
        print(f'[train] done: problem={problem.name} '
              f'hvps={result.hvp_count} wall_s={result.seconds:.1f}')
        return result
    print(f'[train] problem={problem.name} solver={args.solver} '
          f'n_outer={args.steps}')
    result = solve(problem, hg_cfg, n_outer=args.steps,
                   log_every=args.log_every, device=args.device)
    metrics = ' '.join(f'{k}={v:.4f}' for k, v in result.metrics.items())
    print(f'[train] done: problem={problem.name} '
          f'outer_loss={result.history["outer_loss"][-1]:.4f} '
          f'hvps={result.hvp_count} wall_s={result.seconds:.1f} {metrics}')
    return result


def _serve_problem(problem, hg_cfg, args):
    """``--problem influence --serve``: stand up the serving tier instead
    of a one-shot ``influence()`` call. Trains once, calibrates the
    batcher's block size from a warm-up sweep, then answers ``--queries``
    queries twice, a cold pass (the first flush builds the sketch into the
    store) and a warm pass (every flush hits the store, zero build HVPs),
    and prints each pass's service statistics. ``max_delay = 0``: every
    query is flushed as it arrives. Returns the service and, by pass
    (``'cold'``, ``'warm'``), its responses in query order, its
    ``stats()`` and the store's hit rate over the pass."""
    from repro_torch.serve import InfluenceService, SketchStore

    store = SketchStore()
    service = InfluenceService(problem, hg_cfg, store=store,
                               top_k=args.top_k, train_steps=args.steps,
                               max_delay=0.0)
    print(f'[serve] influence problem={problem.name} solver={args.solver} '
          f'queries={args.queries} top_k={args.top_k}')
    rates = service.warmup()
    print(f'[serve] calibrated block_size={service.batcher.block_size} '
          + ' '.join(f'm={m}:{r:.1f}q/s' for m, r in sorted(rates.items())))
    pool = problem.reference['queries'](args.queries)
    passes = {}
    for phase in ('cold', 'warm'):
        if phase == 'cold':
            store.clear()                      # forget the warm-up's sketch
        service.reset_metrics()                # per-pass latency/HVP stats
        hits0, misses0 = store.hits, store.misses
        tickets = []
        for q in range(args.queries):
            tickets.append(service.submit(tree_map(lambda x: x[q], pool)))
            service.pump()
        service.flush()
        responses = [service.result(t) for t in tickets]
        for q, resp in enumerate(responses):
            pairs = ' '.join(f'{int(i)}:{float(s):+.4f}'
                             for s, i in zip(resp.scores, resp.indices))
            print(f'[serve:{phase}] query {q} ({resp.latency_s*1e3:.1f}ms '
                  f'm={resp.batched_m} hit={resp.cache_hit}): {pairs}')
        s = service.stats()
        lookups = (store.hits - hits0) + (store.misses - misses0)
        rate = (store.hits - hits0) / lookups if lookups else 0.0
        print(f'[serve:{phase}] p50={s["latency_p50_ms"]:.1f}ms '
              f'p95={s["latency_p95_ms"]:.1f}ms '
              f'hvps={s["build_hvps"] + s["fallback_hvps"]} '
              f'hit_rate={rate:.2f}')
        passes[phase] = {'responses': responses, 'stats': s,
                         'hit_rate': rate}
    return service, passes


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Train a transformer with bilevel data reweighting, or '
                    'run a registered problem, on the port (repro_torch).')
    ap.add_argument('--arch', default='yi_9b',
                    help='the LM trainer\'s architecture (repro_torch.configs:'
                         ' a token-input one, e.g. yi_9b | qwen2_7b | '
                         'phi35_moe_42b_a66b | jamba_v01_52b | rwkv6_1b6)')
    ap.add_argument('--reduced', action='store_true',
                    help='tiny same-family config (CPU smoke / CI)')
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--outer-every', type=int, default=50,
                    help='inner steps between Nyström hypergradient updates')
    ap.add_argument('--problem', default=None,
                    help='a registered problem (repro_torch.core PROBLEMS, '
                         'e.g. reweighting | distillation | logreg_wd | '
                         'influence) through solve()/influence(), or a '
                         'multi-level graph (repro_torch.engine GRAPHS: '
                         'distill_hpo | reweight_maml) through Engine.solve, '
                         'instead of the LM trainer; --steps then counts '
                         'outer (resp. training) steps')
    ap.add_argument('--solver', default='nystrom')
    ap.add_argument('--k', type=int, default=None,
                    help='sketch rank / iterations (default 8)')
    ap.add_argument('--rho', type=float, default=None,
                    help='damping (default 1e-2)')
    ap.add_argument('--sketch-refresh-every', type=int, default=None,
                    help='outer steps between sketch rebuilds (default 1 = '
                         'fresh every outer step; N>1 reuses the sketch for '
                         'N-1 steps, saving k HVPs each)')
    ap.add_argument('--queries', type=int, default=8,
                    help='influence problems: query-block width m')
    ap.add_argument('--top-k', type=int, default=10,
                    help='influence problems: top-k examples per query')
    ap.add_argument('--serve', action='store_true',
                    help='influence problems: stand up the serving tier '
                         '(sketch store + query batcher, repro_torch.serve) '
                         'and answer --queries queries cold then warm, '
                         'printing latency/cache stats, instead of one '
                         'influence() call')
    ap.add_argument('--ckpt-dir', default=None)
    ap.add_argument('--ckpt-every', type=int, default=100)
    ap.add_argument('--production-mesh', action='store_true',
                    help='the LM route over make_production_mesh() (a world '
                         'of 256 or 512 ranks under torchrun) instead of '
                         'make_host_mesh()')
    ap.add_argument('--log-every', type=int, default=10)
    ap.add_argument('--device', default=None,
                    help="where to run: the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.problem is None:
        return _run_lm(args)
    return _run_problem(args)


if __name__ == '__main__':
    main()
