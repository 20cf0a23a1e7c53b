"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: ``--problem influence --serve`` answers its queries cold, then warm
with zero build HVPs and every lookup a hit; the one-shot ``influence`` and
``solve`` routes run; the route not ported (the LM pipeline) exits with
its ROADMAP item. The engine graphs' route: ``tests/test_torch_engine.py``.

The influence task runs at its full width (p = 26,122, small on a CPU) with
5 training steps and 2 queries.
"""
import re

import pytest

from repro_torch.launch.train import main
from torch_threads import torch_thread_cap  # noqa: F401

CPU = ['--device', 'cpu']


def test_serve_answers_cold_then_warm_with_zero_hvps(capsys):
    service, passes = main(['--problem', 'influence', '--serve',
                            '--queries', '2', '--steps', '5', '--k', '4',
                            *CPU])
    out = capsys.readouterr().out
    assert re.search(r'\[serve\] calibrated block_size=\d+ m=1:', out)
    for phase in ('cold', 'warm'):
        assert len(re.findall(rf'\[serve:{phase}\] query \d ', out)) == 2
    cold = re.search(r'\[serve:cold\] p50=.* hvps=(\d+) hit_rate=(\S+)', out)
    warm = re.search(r'\[serve:warm\] p50=.* hvps=(\d+) hit_rate=(\S+)', out)
    assert cold.groups() == ('4', '0.50')     # one build, then one hit
    assert warm.groups() == ('0', '1.00')
    assert service.degraded_flushes == 0
    for phase, bill, rate in (('cold', 4, 0.5), ('warm', 0, 1.0)):
        got = passes[phase]
        assert len(got['responses']) == 2
        assert got['stats']['build_hvps'] == bill
        assert got['hit_rate'] == rate


def test_oneshot_influence_and_solve_routes(capsys):
    res = main(['--problem', 'influence', '--queries', '2', '--steps', '5',
                '--k', '4', *CPU])
    assert res.hvp_count == 4 and res.scores.shape == (2, 10)
    res = main(['--problem', 'logreg_wd', '--steps', '2', '--k', '4', *CPU])
    assert res.hvp_count == 8
    out = capsys.readouterr().out
    assert '[influence] query 1:' in out
    assert 'done: problem=logreg_wd' in out


@pytest.mark.parametrize('argv,item', [
    (['--arch', 'yi_9b', '--production-mesh'], 'item 12'),
])
def test_routes_not_ported_exit_with_their_item(argv, item):
    with pytest.raises(SystemExit, match=item):
        main([*argv, *CPU])
