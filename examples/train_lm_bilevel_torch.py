"""End-to-end example on the PyTorch port: train an LM with bilevel data
reweighting (§5.4 at LM scale).

The corpus is a domain mixture where two domains are pure noise; every
``--outer-every`` steps a Nyström-IHVP hypergradient updates per-domain
loss weights against a clean validation stream. Runs on the CUDA card
unless ``--device cpu``. Defaults are CPU-sized (the reduced Yi-family
model, a few hundred steps):

  python examples/train_lm_bilevel_torch.py --device cpu --steps 12 \\
      --outer-every 6

Kill it mid-run and relaunch with the same ``--ckpt-dir`` to resume from
the last checkpoint. The CLI's backend is the reference's default
(``tree``); ``repro_torch.launch.train.train_lm`` takes any
``HypergradConfig``, e.g. ``backend='cuda'`` for the hand-written kernels.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / 'src'))

from repro_torch.launch import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='yi_9b')
    ap.add_argument('--no-reduced', action='store_true')
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--outer-every', type=int, default=50)
    ap.add_argument('--ckpt-dir', default=None)
    ap.add_argument('--device', default=None,
                    help="where to run: the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)

    argv = ['--arch', args.arch, '--steps', str(args.steps),
            '--batch', str(args.batch), '--seq', str(args.seq),
            '--outer-every', str(args.outer_every)]
    if not args.no_reduced:
        argv.append('--reduced')
    if args.ckpt_dir:
        argv += ['--ckpt-dir', args.ckpt_dir]
    if args.device:
        argv += ['--device', args.device]
    return train.main(argv)


if __name__ == '__main__':
    main()
