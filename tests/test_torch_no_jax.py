"""The port stands alone: every module of ``repro_torch`` (the serving
tier, checkpoints, the multi-level engine, the data loader, the LM steps,
the training CLI's LM route, the MoE layer, the decode path and the Mamba,
RWKV-6, encoder-decoder and M-RoPE families and the solver observatory
included) imports with ``jax`` and ``repro`` blocked, and its entry points
refuse to drop to the CPU on their own."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch
from torch_threads import torch_thread_cap  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / 'src'

_CHILD = r'''
import sys
sys.modules['jax'] = None
sys.modules['repro'] = None
import importlib, pkgutil, torch
import repro_torch
names = ['repro_torch'] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, 'repro_torch.')]
for name in names:
    importlib.import_module(name)
assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))
               for k, v in sys.modules.items() if v is not None)
from repro_torch.configs import get_config
from repro_torch.core import HypergradConfig, hypergrad_at, solve
from repro_torch.core import (CGIHVP, NeumannIHVP, config_from_cli,
                              gauss_newton_hvp, hessian_diagonal_estimate,
                              nystrom_inverse_dense, solver_fingerprint,
                              state_nbytes, unrolled_hypergradient)
from repro_torch.data import DistillationTask
from repro_torch.tasks import build_distillation
from repro_torch.core import (BatchSource, InfluenceProblem, InfluenceResult,
                              influence, influence_build_hvps,
                              influence_curvature_hvp, make_topk_scanner,
                              sgd_solver, tangent_apply,
                              train_influence_params)
from repro_torch.core.implicit import implicit_root
from repro_torch.data import EpisodeSource, FewShotSampler
from repro_torch.tasks import build_imaml, build_influence
assert isinstance(build_imaml(width=2, image_size=4, device='cpu').data,
                  EpisodeSource)
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_step)
from repro_torch.models import build_model
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.tasks import build_logreg_weight_decay
from repro_torch.checkpoint import (CheckpointManager, params_digest, restore,
                                    save)
from repro_torch.serve import (InfluenceService, QueryBatcher, SketchStore,
                               calibrate_block_size, sketch_key)
from repro_torch.launch.train import main as train_main
from repro_torch.engine import (GRAPHS, Engine, EngineConfig, distill_hpo,
                                engine_edge_bills, engine_hypergrad,
                                get_graph, reweight_maml)
assert sorted(GRAPHS) == ['distill_hpo', 'reweight_maml']
from repro_torch.data import Prefetcher, ShardedLoader, TokenStream
from repro_torch.launch.steps import (N_DOMAINS, build_hypergrad_step,
                                      build_train_step, make_optimizer)
from repro_torch.launch.train import train_lm
from repro_torch.bench import (DEFAULT_GRID, CompareError, RateFit,
                               build_population, compare_docs, fit_rates,
                               parse_grid, run_sweep)
problem = build_logreg_weight_decay(D=5, n=8, device='cpu')
if not torch.cuda.is_available():
    w = {'w': torch.zeros(5)}
    for name, call in [
            ('build_prefill_step',
             lambda: build_prefill_step(get_config('yi_9b').reduced())),
            ('build_model', lambda: build_model(get_config('qwen2_7b'))),
            ('build_serve_step', lambda: build_serve_step(
                get_config('phi35_moe_42b_a66b').reduced())),
            ("build_step('decode')", lambda: build_step(
                get_config('yi_9b').reduced(), 'decode')),
            ('init_cache', lambda: init_cache(
                get_config('llama4_maverick_400b_a17b').reduced(), 2, 4)),
            ('init_params', lambda: init_params(
                get_config('yi_9b').reduced(), torch.Generator())),
            *[(f'{kind} {arch}', lambda arch=arch, builder=builder: builder(
                get_config(arch).reduced()))
              for arch in ('jamba_v01_52b', 'rwkv6_1b6',
                           'seamless_m4t_large_v2', 'qwen2_vl_7b')
              for kind, builder in (('build_prefill_step',
                                     build_prefill_step),
                                    ('build_serve_step', build_serve_step))],
            ('init_cache seamless', lambda: init_cache(
                get_config('seamless_m4t_large_v2').reduced(), 2, 4)),
            ('solve', lambda: solve(problem, HypergradConfig(k=2,
                                                             backend='cuda'),
                                    n_outer=1)),
            ('build_distillation', lambda: build_distillation(image_size=4,
                                                              width=2)),
            ('build_imaml', lambda: build_imaml(width=2, image_size=4)),
            ('build_influence', lambda: build_influence(d=2, width=2)),
            ('influence', lambda: influence(
                build_influence(d=2, width=2, device='cpu'),
                HypergradConfig(k=2), (torch.zeros(1, 2),
                                       torch.zeros(1, dtype=torch.int64)))),
            ('solve(vmap_tasks)', lambda: solve(
                build_imaml(width=2, image_size=4, device='cpu'),
                HypergradConfig(k=2), n_outer=1, vmap_tasks=2)),
            ('launch.train', lambda: train_main(['--problem', 'influence',
                                                 '--serve'])),
            ('distill_hpo', lambda: distill_hpo()),
            ('get_graph', lambda: get_graph('reweight_maml')),
            ('launch.train graph', lambda: train_main(
                ['--problem', 'reweight_maml', '--steps', '1'])),
            ('train_lm', lambda: train_lm(
                get_config('yi_9b').reduced(), HypergradConfig(k=2),
                steps=1, batch=2, seq=4, outer_every=1)),
            ('launch.train lm', lambda: train_main(
                ['--arch', 'yi_9b', '--reduced', '--steps', '1'])),
            ('build_population', lambda: build_population(
                'logreg_wd:D=4:n=8', tasks=1)),
            ('run_sweep', lambda: run_sweep(('logreg_wd:D=4:n=8',), ('cg',),
                                            {'k': (2,)}, tasks=1)),
            ('hypergrad_at', lambda: hypergrad_at(
                problem, HypergradConfig(k=2, backend='cuda'), w,
                {'wd': torch.ones(5)}, problem.data.train_batch(0, 4),
                problem.data.val_batch(0, 4)))]:
        try:
            call()
        except RuntimeError as e:
            assert "device='cpu'" in str(e), e
        else:
            raise AssertionError(f'{name} ran without a card and without '
                                 "device='cpu'")
print(len(names))
'''


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, '-c', _CHILD], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    expected = 1 + len(list(pkgutil.walk_packages(repro_torch.__path__,
                                                  'repro_torch.')))
    assert int(out.stdout.split()[-1]) == expected >= 20


def test_no_source_line_imports_jax_or_repro():
    roots = [SRC / 'repro_torch', SRC.parent / 'chip_smoke.py']
    files = [f for r in roots for f in ([r] if r.is_file()
                                        else r.rglob('*.py'))]
    assert len(files) >= 20
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(('import jax', 'from jax', 'import repro ',
                                     'import repro.', 'from repro ',
                                     'from repro.')), (f, line)
