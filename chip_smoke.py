#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. Build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for ``sm_90a``.
3. Kernels: each of the five Nyström kernel entry points against its plain
   PyTorch version, at the main path's shapes (p = 26,122, k = 10, m = 32)
   and at one large shape (p = 2²⁴, k = 64, m = 32) with f32 and bf16
   sketches. Tolerance: rtol 1e-5 and atol 1e-5·‖ref‖∞. At the main shapes
   the reference is the plain version itself (f32). At p = 2²⁴ it is the
   plain version evaluated in f64 on the same values: over 16M rows the
   f32 rounding of cuBLAS's own sums is as large as the tolerance. Times
   are CUDA-event means over 20 launches after 3 warm-ups; ``library_ms``
   is one ``torch`` call computing the same function (a yardstick only;
   the port never calls it); ``bound_ms`` is max(FLOPs / peak, bytes /
   3.35 TB/s), each input read once and each output written once, with the
   fp32 peak of 67 TFLOP/s (989 TFLOP/s where every input is bf16); gram
   counts the k(k+1)/2 distinct entries of the symmetric CᵀC.
4. Main path: ``solve(build_reweighting(), HypergradConfig(solver='nystrom',
   k=10, backend='cuda'), n_outer=5)``, after a one-step warm-up solve that
   takes the first-call set-up; the outer loss must be finite and
   the gram, ctv and apply kernels must have launched. On the solved state
   the hypergradient through the kernels must match ``backend='flat'``
   (``torch.matmul``) to relative L2 ≤ 1e-4, and on the convex
   ``logreg_wd`` (p = 100) a full-rank sketch through the kernels must
   match the exact-IHVP oracle to ≤ 1e-4.
5. Block path: ``phi_vjp_block`` with m = 32 per-example validation
   gradients, kernels against ``backend='flat'`` (≤ 1e-4); the cross and
   block-apply kernels must have launched.

6. Where the time goes: ``solve`` again for 3 outer steps under
   ``torch.profiler``: host time and device time of the trainer's own
   phase ranges (``bilevel.inner``, ``bilevel.sketch``,
   ``bilevel.update``), and the device's busy and idle share against the
   unprofiled step of phase 4.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / 'src'
PEAK_F32 = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor cores, FLOP/s
HBM = 3.35e12         # H100 SXM HBM3, bytes/s
RHO = 1e-2
MAIN_P, MAIN_K, M = 26122, 10, 32
LARGE_P, LARGE_K = 2 ** 24, 64
REPS, WARM = 20, 3

ROWS = [  # name, CUDA kernel, source, the TPU kernel it replaces
    ('nystrom_gram', 'atb', 'src/repro_torch/csrc/atb.cu',
     'src/repro/kernels/nystrom_gram.py:58'),
    ('nystrom_cross', 'atb', 'src/repro_torch/csrc/atb.cu',
     'src/repro/kernels/nystrom_gram.py:79'),
    ('woodbury_ctv', 'ctv', 'src/repro_torch/csrc/ctv.cu',
     'src/repro/kernels/woodbury.py:44'),
    ('woodbury_apply', 'woodbury_apply', 'src/repro_torch/csrc/woodbury_apply.cu',
     'src/repro/kernels/woodbury.py:103'),
    ('woodbury_apply_block', 'woodbury_apply',
     'src/repro_torch/csrc/woodbury_apply.cu',
     'src/repro/kernels/woodbury.py:136'),
]


def fail(msg: str) -> None:
    print(f'chip_smoke: {msg}', file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn) -> float:
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / REPS


def cases(torch, ops, ref, p, k, dtype, dev):
    """Per kernel entry point: (kernel call, plain call, library call or
    None, inputs, FLOPs, bytes, every input bf16)."""
    g = torch.Generator().manual_seed(p + k)

    def rnd(*shape, dt=torch.float32):
        return torch.randn(shape, generator=g).to(dt).to(dev)

    C = rnd(p, k, dt=dtype)
    v, V = rnd(p), rnd(p, M)
    w, W = rnd(k), rnd(k, M)
    isz = C.element_size()
    f32 = dtype == torch.float32
    return {
        'nystrom_gram': (
            ops.nystrom_gram, ref.nystrom_gram,
            (lambda C: torch.mm(C.T, C)) if f32 else None, (C,),
            p * k * (k + 1), p * k * isz + 4 * k * k, not f32),  # G symmetric
        'nystrom_cross': (
            ops.nystrom_cross, ref.nystrom_cross,
            (lambda C, V: torch.mm(C.T, V)) if f32 else None, (C, V),
            2 * p * k * M, p * k * isz + 4 * p * M + 4 * k * M, False),
        'woodbury_ctv': (
            ops.woodbury_ctv, ref.woodbury_ctv,
            (lambda C, v: torch.mv(C.T, v)) if f32 else None, (C, v),
            2 * p * k, p * k * isz + 4 * p + 4 * k, False),
        'woodbury_apply': (
            lambda C, w, v: ops.woodbury_apply(C, w, v, RHO),
            lambda C, w, v: ref.woodbury_apply(C, w, v, RHO),
            (lambda C, w, v: torch.addmv(v, C, w, beta=1 / RHO,
                                         alpha=-1 / RHO ** 2)) if f32 else None,
            (C, w, v), 2 * p * k + 2 * p, p * k * isz + 4 * k + 8 * p, False),
        'woodbury_apply_block': (
            lambda C, W, V: ops.woodbury_apply(C, W, V, RHO),
            lambda C, W, V: ref.woodbury_apply(C, W, V, RHO),
            (lambda C, W, V: torch.addmm(V, C, W, beta=1 / RHO,
                                         alpha=-1 / RHO ** 2)) if f32 else None,
            (C, W, V), 2 * p * k * M + 2 * p * M,
            p * k * isz + 4 * k * M + 8 * p * M, False),
    }


def check_kernels(torch, ops, ref, p, k, dtype, dev, exact_ref: bool):
    """Hold each kernel against its plain version; time all three."""
    out = {}
    for name, (kern, plain, lib, args, flops, nbytes, bf16) in cases(
            torch, ops, ref, p, k, dtype, dev).items():
        got = kern(*args)
        want = (plain(*[a.double() for a in args]).float() if exact_ref
                else plain(*args))
        torch.cuda.synchronize()
        err = (got - want).abs()
        limit = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
        max_err = float(err.max())
        if not bool((err <= limit).all()) or not math.isfinite(max_err):
            raise AssertionError(
                f'{name} p={p} k={k} {dtype}: kernel disagrees with its plain '
                f'version, max |err| {max_err:.3e}')
        t_op, t_b = flops / (PEAK_BF16 if bf16 else PEAK_F32), nbytes / HBM
        rec = dict(max_abs_err=max_err,
                   ms=time_ms(torch, lambda: kern(*args)),
                   plain_ms=time_ms(torch, lambda: plain(*args)),
                   library_ms=(time_ms(torch, lambda: lib(*args))
                               if lib is not None else None),
                   bound_ms=max(t_op, t_b) * 1e3,
                   bound_by='operations' if t_op > t_b else 'bytes')
        lib_ms = ('-' if rec['library_ms'] is None
                  else f"{rec['library_ms']:.4f}")
        print(f"kernel {name:<21} p={p} k={k} m={M} {str(dtype)[6:]:<8} "
              f"max_err={max_err:.3e} kernel_ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} library_ms={lib_ms} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})",
              flush=True)
        out[name] = rec
        del got, want, err, limit
    torch.cuda.empty_cache()
    return out


def trace_phases(torch, solve, problem, config, step_s: float) -> None:
    """Profile ``solve`` and print, per outer step, each trainer phase's
    host and device time and the device's busy share of ``step_s`` (the
    unprofiled step). Kernels run on one stream, so their times add."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = solve(problem, config, n_outer=n)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        print('trace: the profiler recorded no device events; device time '
              'not measured', flush=True)
        return
    for phase in ('bilevel.inner', 'bilevel.sketch', 'bilevel.update'):
        ranges = [e for e in events
                  if e.name == phase and e.device_type == DeviceType.CPU]
        if len(ranges) != n:
            raise AssertionError(f'{phase}: {len(ranges)} ranges in {n} '
                                 'outer steps')
        host = sum(e.time_range.elapsed_us() for e in ranges) / 1e3 / n
        device = sum(e.device_time_total for e in ranges) / 1e3 / n
        print(f'trace: phase {phase:<14} host {host:9.3f} ms  device '
              f'{device:7.3f} ms per outer step', flush=True)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    print(f'trace: {len(kernels) / n:.0f} kernels and {busy:.3f} ms of '
          f'device time per outer step; profiled step '
          f'{traced.seconds / n * 1e3:.3f} ms, unprofiled step '
          f'{step_s * 1e3:.3f} ms: device idle '
          f'{100 * (1 - busy / (step_s * 1e3)):.1f}%', flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device: this script measures the port on a GPU')
    if not (SRC / 'repro_torch').is_dir():
        fail(f'{SRC / "repro_torch"} not found: run from a checkout')
    sys.path.insert(0, str(SRC))

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    from repro_torch.device import resolve_device
    dev = resolve_device(None)            # also switches TF32 off
    print(f'device: {smi} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} | {name} | tf32 matmul '
          f'{torch.backends.cuda.matmul.allow_tf32} cudnn '
          f'{torch.backends.cudnn.allow_tf32}', flush=True)

    # 2. build ----------------------------------------------------------------
    from repro_torch.kernels import _lib, ops, ref
    path, secs = _lib.build()
    _lib.lib()
    print(f'build: {path.name} in {secs:.1f} s', flush=True)

    # 3. kernels against their plain versions --------------------------------
    main_rec = check_kernels(torch, ops, ref, MAIN_P, MAIN_K, torch.float32,
                             dev, exact_ref=False)
    check_kernels(torch, ops, ref, MAIN_P, MAIN_K, torch.bfloat16, dev,
                  exact_ref=False)
    for dtype in (torch.float32, torch.bfloat16):
        check_kernels(torch, ops, ref, LARGE_P, LARGE_K, dtype, dev,
                      exact_ref=True)

    # 4. main path --------------------------------------------------------------
    from repro_torch.core import (ExactIHVP, HypergradConfig, PyTreeIndexer,
                                  hypergrad_at, hypergrad_error,
                                  phi_vjp_block, solve, tree_leaves,
                                  tree_map)
    from repro_torch.tasks import build_logreg_weight_decay, build_reweighting
    problem = build_reweighting()
    p = sum(x.numel() for x in tree_leaves(problem.init_params(
        torch.Generator().manual_seed(0))))
    if p != MAIN_P:
        raise AssertionError(f'reweighting has p={p}, expected {MAIN_P}')
    n_outer = 5
    config = HypergradConfig(solver='nystrom', k=10, backend='cuda')
    # one outer step first: library handles and first-call set-up land here
    warm = solve(problem, config, n_outer=1)
    _lib.reset_launches()
    res = solve(problem, config, n_outer=n_outer)
    main_launches = dict(_lib.LAUNCHES)
    losses = res.history['outer_loss']
    if len(losses) != n_outer or not all(map(math.isfinite, losses)):
        raise AssertionError(f'outer losses not finite: {losses}')
    for kname in ('nystrom_gram', 'woodbury_ctv', 'woodbury_apply'):
        if main_launches[kname] == 0:
            raise AssertionError(f'main path never launched {kname}')
    print(f'main path: solve(reweighting p={p}, nystrom k=10, cuda) '
          f'{n_outer} outer steps x 20 inner, {res.seconds / n_outer:.4f} '
          f's/outer step (first-call warm-up step {warm.seconds:.4f} s), '
          f'outer loss {[round(x, 5) for x in losses]}, '
          f"accuracy {res.metrics['accuracy']:.4f}, launches {main_launches}",
          flush=True)

    ib = problem.data.train_batch(n_outer, 128)
    ob = problem.data.val_batch(n_outer, 128)
    idx = PyTreeIndexer(res.params).sample_indices(
        torch.Generator().manual_seed(n_outer), 10)
    hg = {be: hypergrad_at(problem, HypergradConfig(k=10, backend=be),
                           res.params, res.hparams, ib, ob, indices=idx)
          for be in ('cuda', 'flat')}
    err = float(hypergrad_error(hg['cuda'], hg['flat']))
    if not err <= 1e-4:
        raise AssertionError(f'hypergradient cuda vs flat: rel L2 {err:.3e}')
    print(f'hypergrad_at cuda vs flat: rel L2 {err:.3e} (<= 1e-4)', flush=True)

    lp = build_logreg_weight_decay()
    gen = torch.Generator().manual_seed(1)
    lparams = {'w': (0.3 * torch.randn(100, generator=gen)).to(dev)}
    lh = {'wd': (0.1 * torch.rand(100, generator=gen)).to(dev)}
    l_ib, l_ob = lp.data.train_batch(0, 500), lp.data.val_batch(0, 500)
    full = hypergrad_at(lp, HypergradConfig(k=100, rho=1e-3, backend='cuda'),
                        lparams, lh, l_ib, l_ob)
    oracle = hypergrad_at(lp, ExactIHVP(rho=1e-3), lparams, lh, l_ib, l_ob)
    err = float(hypergrad_error(full, oracle))
    if not err <= 1e-4:
        raise AssertionError(f'full-rank logreg_wd vs exact: rel L2 {err:.3e}')
    print(f'full-rank logreg_wd (p=100) cuda vs exact oracle: rel L2 '
          f'{err:.3e} (<= 1e-4)', flush=True)

    # 5. block path ---------------------------------------------------------
    Xv, yv = problem.data.val_batch(n_outer + 1, M)

    def example_loss(params, x, y):
        return problem.outer_loss(params, res.hparams, (x[None], y[None]))

    G = torch.func.vmap(torch.func.grad(example_loss), in_dims=(None, 0, 0))(
        res.params, Xv, yv)
    V = tree_map(lambda g: torch.movedim(g, 0, -1).contiguous(), G)
    _lib.reset_launches()
    block = phi_vjp_block(HypergradConfig(k=10, backend='cuda').build(),
                          problem.inner_loss, res.params, res.hparams, ib, V,
                          indices=idx)
    torch.cuda.synchronize()
    block_launches = dict(_lib.LAUNCHES)
    flat = phi_vjp_block(HypergradConfig(k=10, backend='flat').build(),
                         problem.inner_loss, res.params, res.hparams, ib, V,
                         indices=idx)
    err = float(hypergrad_error(block, flat))
    if not err <= 1e-4:
        raise AssertionError(f'phi_vjp_block cuda vs flat: rel L2 {err:.3e}')
    for kname in ('nystrom_cross', 'woodbury_apply_block'):
        if block_launches[kname] == 0:
            raise AssertionError(f'block path never launched {kname}')
    print(f'block path: phi_vjp_block m={M} cuda vs flat: rel L2 {err:.3e} '
          f'(<= 1e-4), launches {block_launches}', flush=True)

    # 6. where the time goes ------------------------------------------------
    trace_phases(torch, solve, problem, config, res.seconds / n_outer)

    # 7. records ------------------------------------------------------------
    records = []
    for kname, kernel, source, replaces in ROWS:
        path_launches = (block_launches if kname in
                         ('nystrom_cross', 'woodbury_apply_block')
                         else main_launches)
        records.append(dict(name=f'{kname} ({kernel})', route='cuda',
                            source=source, replaces=replaces,
                            launches=path_launches[kname], **main_rec[kname]))
    print(smi)
    print(json.dumps({'kernels': records}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    t0 = time.perf_counter()
    main()
    print(f'chip_smoke: done in {time.perf_counter() - t0:.1f} s',
          file=sys.stderr)
