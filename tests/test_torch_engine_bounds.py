"""The bound of ``chip_smoke.py`` phase 17 (b)'s oracle gate, measured: on
the card the port's ``engine_hypergrad`` against its dense oracle is held
to the reference's own error at the same settings — the registered graph
at the registry defaults, ``Engine().solve`` with
``EngineConfig(n_outer=chip_smoke.ENGINE_STEPS[name])`` (2 steps of
``distill_hpo``, 3 of ``reweight_maml``), the oracle at ρ = 0 — and this
file measures that error with the reference on the CPU, to 1e-2 relative
of the constant ``chip_smoke.ENGINE_HG_BOUND`` cites.

On ``distill_hpo`` it is large (3.83 after 2 steps, about 46 after 3):
at the registry defaults the reference's full-rank sketch and its dense
oracle part ways (after 3 steps a top gradient of 4.25 against 0.0907),
so that bound holds the port to little, and on the card the binding gate
is the kernels against ``backend='flat'``. On ``reweight_maml`` it is
4.4e-4.
"""
import pytest

from torch_engine_reference import chip_bound
from torch_threads import torch_thread_cap  # noqa: F401


@pytest.mark.parametrize('name', ['reweight_maml', 'distill_hpo'])
def test_chip_bound_is_the_reference_error(name):
    err, bound = chip_bound(name)
    assert bound == pytest.approx(err, rel=1e-2)


def test_reference_distill_hpo_at_rank_10_gives_nan():
    """A reference caveat (ROADMAP queue 3): ``distill_hpo`` at
    ``k_student = k_images = 10`` with ``rho = 0.1`` and the default
    ``n_syn`` gives NaN top losses in the reference's own unrolls, which is
    why phase 17 (c) streams at ``n_syn = 2000`` and goes no wider."""
    import math

    from repro.engine import Engine as JEngine
    from repro.engine import EngineConfig as JConfig
    from repro.engine import get_graph as jget_graph
    res = JEngine().solve(jget_graph('distill_hpo', k_student=10,
                                     k_images=10, rho=0.1),
                          JConfig(n_outer=3))
    assert all(math.isnan(x) for x in res.losses)
