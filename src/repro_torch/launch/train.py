"""The problem routes of the training CLI: registered problems through
``solve()``, influence problems through ``influence()`` or the serving
tier, and the multi-level engine's graphs through ``Engine.solve``.

The counterpart of ``repro/launch/train.py``'s ``--problem`` routes:

  PYTHONPATH=src python -m repro_torch.launch.train --problem reweighting \\
      --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --problem influence \\
      --serve --queries 8
  PYTHONPATH=src python -m repro_torch.launch.train --problem distill_hpo \\
      --steps 3 --log-every 1

``--serve`` stands up the serving tier (:mod:`repro_torch.serve`) and
answers ``--queries`` queries twice, cold (the first flush builds the
sketch into the store) and warm (every flush hits the store: zero build
HVPs), printing each pass's latency and cache statistics. Runs on the card
unless ``--device cpu``. Not ported: the LM training pipeline (no
``--problem``; ROADMAP item 12): it exits with a message.
"""
from __future__ import annotations

import argparse

from repro_torch.core.hypergrad import config_from_cli
from repro_torch.core.tree_util import tree_map

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
        description='Run a registered problem of the port (repro_torch).')
    ap.add_argument('--arch', default=None,
                    help='the LM training pipeline: ROADMAP item 12, not '
                         'ported')
    ap.add_argument('--problem', default=None,
                    help='a registered problem (repro_torch.core PROBLEMS, '
                         'e.g. reweighting | distillation | logreg_wd | '
                         'influence) through solve()/influence(), or a '
                         'multi-level graph (repro_torch.engine GRAPHS: '
                         'distill_hpo | reweight_maml) through Engine.solve; '
                         '--steps then counts outer (resp. training) steps. '
                         'The LM pipeline (no --problem) is not ported')
    ap.add_argument('--solver', default='nystrom')
    ap.add_argument('--k', type=int, default=None,
                    help='sketch rank / iterations (default 8)')
    ap.add_argument('--rho', type=float, default=None,
                    help='damping (default 1e-2)')
    ap.add_argument('--sketch-refresh-every', type=int, default=None,
                    help='outer steps between sketch rebuilds (default 1 = '
                         'fresh every outer step; N>1 reuses the sketch for '
                         'N-1 steps, saving k HVPs each)')
    ap.add_argument('--steps', type=int, default=200)
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
    ap.add_argument('--log-every', type=int, default=10)
    ap.add_argument('--device', default=None,
                    help="where to run: the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.problem is None:
        raise SystemExit(
            'the LM training pipeline (--arch) is ROADMAP item 12, which the '
            'port does not have yet; pass --problem to run a registered '
            'problem')
    return _run_problem(args)


if __name__ == '__main__':
    main()
