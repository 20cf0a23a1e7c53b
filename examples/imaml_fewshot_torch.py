"""iMAML few-shot meta-learning (paper §5.3, Tab. 3) on the PyTorch port.

Per-task hypergradients are ``torch.func.grad`` through the adaptation map
(``implicit_root`` over 10 proximal SGD steps), and a meta-batch of tasks is
``torch.func.vmap`` over it: ``solve(problem, config, vmap_tasks=N)``.
``--shared-sketch`` prepares one Nyström sketch per meta-batch at the
meta-init on the pooled support sets (k HVPs a meta-step instead of N·k; on
the card its backward passes run as one block apply through kernels A and
C). Each method is meta-trained, then adapted on held-out episodes and
scored on their query sets. Runs on the CUDA card; ``--device cpu`` runs on
the CPU.

    python examples/imaml_fewshot_torch.py --episodes 64 --meta-batch 8
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / 'src'))

from repro_torch.core import (HypergradConfig, sgd_solver,  # noqa: E402
                              solve)
from repro_torch.tasks import build_imaml, mlp_apply     # noqa: E402

CONFIGS = {   # Tab. 3: k = l = 10, rho = alpha = 1e-2
    'nystrom': dict(solver='nystrom', k=10, rho=1e-2),
    'cg': dict(solver='cg', k=10, rho=1e-2),
    'neumann': dict(solver='neumann', k=10, alpha=1e-2),
}


def evaluate(problem, meta, n_eval: int) -> float:
    """Adapt the meta-init on held-out episodes' support sets; the mean
    query accuracy."""
    d = problem.defaults
    adapt = sgd_solver(problem.inner_loss, d['steps_per_outer'],
                       d['inner_lr'])
    sampler = problem.reference['sampler']
    accs = []
    for ep in range(n_eval):
        sx, sy, qx, qy = sampler.episode(10_000 + ep, test=True)
        params = adapt(meta, (sx, sy))
        accs.append(float((mlp_apply(params, qx).argmax(-1) == qy)
                          .float().mean()))
    return sum(accs) / len(accs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--episodes', type=int, default=64,
                    help='meta-training episodes per method')
    ap.add_argument('--meta-batch', type=int, default=8,
                    help='tasks per vmapped meta-step')
    ap.add_argument('--n-eval', type=int, default=20)
    ap.add_argument('--shared-sketch', action='store_true',
                    help='one Nyström sketch per meta-batch')
    ap.add_argument('--backend', default='cuda',
                    help="nystrom's contraction backend: tree | flat | cuda")
    ap.add_argument('--methods', default='nystrom,cg,neumann')
    ap.add_argument('--width', type=int, default=64)
    ap.add_argument('--image-size', type=int, default=20)
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    problem = build_imaml(width=args.width, image_size=args.image_size,
                          device=args.device)
    n_outer = max(1, args.episodes // args.meta_batch)
    accs = {}
    for method in args.methods.split(','):
        fields = dict(CONFIGS[method])
        if method == 'nystrom':
            fields['backend'] = args.backend
        shared = args.shared_sketch and method == 'nystrom'
        t0 = time.perf_counter()
        res = solve(problem, HypergradConfig(**fields), n_outer=n_outer,
                    vmap_tasks=args.meta_batch, shared_sketch=shared,
                    device=args.device)
        accs[method] = evaluate(problem, res.hparams, args.n_eval)
        print(f'{method}: {n_outer} meta-steps of {args.meta_batch} tasks '
              f'(shared sketch {shared}) in {time.perf_counter() - t0:.2f} s,'
              f' {res.hvp_count} HVPs, query loss '
              f"{res.history['outer_loss'][0]:.4f} -> "
              f"{res.history['outer_loss'][-1]:.4f}; 1-shot test accuracy "
              f'{accs[method]:.3f}', flush=True)
    return accs


if __name__ == '__main__':
    main()
