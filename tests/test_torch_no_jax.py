"""The port stands alone: every module of ``repro_torch`` imports with
``jax`` and ``repro`` blocked, and its entry points refuse to drop to the
CPU on their own."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

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
from repro_torch.core import HypergradConfig, hypergrad_at, solve
from repro_torch.tasks import build_logreg_weight_decay
problem = build_logreg_weight_decay(D=5, n=8, device='cpu')
if not torch.cuda.is_available():
    w = {'w': torch.zeros(5)}
    for name, call in [
            ('solve', lambda: solve(problem, HypergradConfig(k=2,
                                                             backend='cuda'),
                                    n_outer=1)),
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
