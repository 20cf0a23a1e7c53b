"""Quickstart (paper §5.1) on the PyTorch port: per-parameter weight-decay
HPO on logistic regression. The inner training run is an ``implicit_root``
solution map, and the hypergradient is plain ``torch.func.grad`` through it
(the map's backward pass runs the Nyström IHVP). Runs on the CUDA card,
through the hand-written kernels with ``--backend cuda``; ``--device cpu``
runs on the CPU.

    python examples/quickstart_torch.py [--solver cg|neumann|nystrom|exact]
        [--backend tree|flat|cuda] [--device cpu] [--legacy-check]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / 'src'))

import torch                                             # noqa: E402
from torch.func import grad, grad_and_value              # noqa: E402

from repro_torch.core import (config_from_cli, hypergradient,  # noqa: E402
                              implicit_root, sgd_solver,
                              unrolled_hypergradient)
from repro_torch.core.tree_util import tree_leaves       # noqa: E402
from repro_torch.optim import momentum                   # noqa: E402
from repro_torch.tasks import build_logreg_weight_decay  # noqa: E402

INNER_LR = 0.1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--solver', default='nystrom',
                    choices=['nystrom', 'cg', 'neumann', 'exact'])
    ap.add_argument('--k', type=int, default=None,
                    help='sketch rank / iterations (default 5)')
    ap.add_argument('--rho', type=float, default=None,
                    help='damping (default 1e-2)')
    ap.add_argument('--backend', default=None,
                    help="nystrom's contraction backend: tree | flat | cuda")
    ap.add_argument('--outer-steps', type=int, default=10)
    ap.add_argument('--inner-steps', type=int, default=100)
    ap.add_argument('--dim', type=int, default=100,
                    help='features D (the paper: 100)')
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the CPU (default: the CUDA card)")
    ap.add_argument('--legacy-check', action='store_true',
                    help='also check one hypergradient against hypergradient()'
                         ' and the exact solver against the unrolled oracle')
    args = ap.parse_args(argv)

    problem = build_logreg_weight_decay(D=args.dim, device=args.device)
    # flags the solver does not consume are refused, never dropped
    hypergrad = config_from_cli(
        args.solver, flags={'k': args.k, 'rho': args.rho,
                            'backend': args.backend},
        defaults={'k': 5, 'rho': 1e-2})
    # the §5.1 reset protocol: the inner run starts from zero each time
    inner_solver = sgd_solver(problem.inner_loss, args.inner_steps, INNER_LR,
                              init=lambda phi, b: {'w': torch.zeros_like(
                                  phi['wd'])})
    solve = implicit_root(inner_solver, problem.inner_loss, hypergrad)
    train, val = problem.data.train, problem.data.val
    opt = momentum(0.1, 0.9)

    def objective(phi, rng=None):
        return problem.outer_loss(solve(phi, train, rng=rng), phi, val)

    phi = problem.init_hparams(torch.Generator().manual_seed(0))
    ost = opt.init(phi)
    for i in range(args.outer_steps):
        g, loss = grad_and_value(objective)(
            phi, torch.Generator().manual_seed(i))
        phi, ost = opt.apply(g, ost, phi, i)
        print(f'[quickstart] outer {i + 1}/{args.outer_steps} '
              f'val={float(loss):.4f} (pre-update)', flush=True)

    if args.legacy_check:
        rng = lambda: torch.Generator().manual_seed(1234)  # noqa: E731
        theta = inner_solver(phi, train)
        new = grad(objective)(phi, rng())
        legacy = hypergradient(problem.inner_loss, problem.outer_loss, theta,
                               phi, train, val, hypergrad.build(), rng())
        dev = max(float((a - b).abs().max()) for a, b in
                  zip(tree_leaves(legacy), tree_leaves(new)))
        print(f'[quickstart] hypergradient() max deviation: {dev:.2e}')
        # the map's backward pass against an independent oracle that
        # differentiates through the inner unroll (the exact solver isolates
        # the plumbing from the sketch's truncation error)
        exact = implicit_root(inner_solver, problem.inner_loss,
                              config_from_cli('exact',
                                              flags={'rho': args.rho},
                                              defaults={'rho': 1e-2}))
        via_exact = grad(lambda p: problem.outer_loss(
            exact(p, train), p, val))(phi)
        oracle = unrolled_hypergradient(
            problem.inner_loss, problem.outer_loss, theta, phi, train, val,
            steps=args.inner_steps, lr=INNER_LR)
        rel = (max(float((a - b).abs().max()) for a, b in
                   zip(tree_leaves(oracle), tree_leaves(via_exact)))
               / max(float(x.abs().max()) for x in tree_leaves(oracle)))
        print(f'[quickstart] implicit map (exact solver) vs unrolled oracle: '
              f'relative deviation {rel:.2e}')

    theta = inner_solver(phi, train)
    final = float(problem.outer_loss(theta, phi, val))
    print(f'final validation loss: {final:.4f} (solver={args.solver})')
    return final


if __name__ == '__main__':
    main()
