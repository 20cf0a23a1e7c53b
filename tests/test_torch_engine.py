"""The port's multi-level engine (``repro_torch.engine``) against the
reference's ``repro.engine``: graph validation, the bilevel adapter, the
trilevel ``reweight_maml`` solved step for step with the reference's data,
initial values and column draws injected, its hypergradients at the
reference's solved point, the exact-matched oracle, the per-edge HVP
bills, and the CLI's graph route. ``distill_hpo``:
``tests/test_torch_engine_distill.py``.

Tolerances: per-step top losses and final node values 1e-4 relative (a
3-step trilevel sweep in f32, summed in another order than XLA);
hypergradients 1e-4 relative L2; the oracle against itself bit for bit;
bills exactly.
"""
import re

import numpy as np
import pytest
import torch

from repro.engine import engine_edge_bills as jengine_edge_bills
from repro.engine import get_graph as jget_graph
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import (ExactIHVP, HypergradConfig, NystromIHVP,
                              build_hvp_bill, hypergrad_error,
                              influence_build_hvps, tree_leaves, tree_size)
from repro_torch.engine import (GRAPHS, Engine, EngineConfig, GraphError,
                                ProblemEdge, ProblemGraph, ProblemNode,
                                engine_edge_bills, engine_hypergrad,
                                engine_hypergrad_reference, from_bilevel,
                                get_graph)
from repro_torch.launch.train import main as train_main
from torch_engine_reference import DATA, REWEIGHT_KW, reference_run
from torch_threads import torch_thread_cap  # noqa: F401

TOL = 1e-4


def _rel(got, want) -> float:
    """Relative L2 of a port tree against a numpy tree of the reference."""
    a, b = (np.concatenate([np.ravel(np.asarray(x, np.float64))
                            for x in tree_leaves(t)])
            for t in (to_numpy(got), want))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# Graph validation
# ---------------------------------------------------------------------------
def _node(name):
    return ProblemNode(name=name,
                       loss=lambda own, ctx, batch: torch.sum(own ** 2),
                       init=lambda rng: torch.zeros(2))


def _graph(names, edges):
    return ProblemGraph(nodes={n: _node(n) for n in names},
                        edges=[ProblemEdge(a, b) for a, b in edges])


class TestGraphValidation:
    def test_chain_validates_and_orders(self):
        g = _graph('abc', [('a', 'b'), ('b', 'c')])
        g.validate()
        assert g.topo_order() == ['a', 'b', 'c']
        assert g.chain_order() == ['a', 'b', 'c']
        assert g.tops() == ['c']
        assert g.edge_for('b').upper == 'c'

    @pytest.mark.parametrize('names,edges,match', [
        ('a', [('a', 'ghost')], 'ghost'),
        ('ab', [('a', 'b'), ('b', 'a')], 'cycle'),
        ('abc', [('a', 'b'), ('a', 'c')], 'exactly one IHVP solver'),
        ('ab', [('a', 'a')], 'self-loop'),
        ('a', [], 'no edges'),
    ], ids=['dangling', 'cycle', 'duplicate-lower', 'self-loop', 'no-edges'])
    def test_malformed_graph_rejected(self, names, edges, match):
        with pytest.raises(GraphError, match=match):
            _graph(names, edges).validate()

    def test_non_chain_dag_validates_but_does_not_lower(self):
        g = _graph(['a', 'b', 'top'], [('a', 'top'), ('b', 'top')])
        g.validate()
        with pytest.raises(GraphError, match='not a chain'):
            g.chain_order()

    def test_registry_miss_names_known_graphs(self):
        assert sorted(GRAPHS) == ['distill_hpo', 'reweight_maml']
        with pytest.raises(ValueError, match='distill_hpo'):
            get_graph('nope')


# ---------------------------------------------------------------------------
# Bilevel adapter
# ---------------------------------------------------------------------------
class _Quad:
    """½θᵀDθ − θᵀφ: θ*(φ) = φ/d; outer ½‖θ*‖² has hypergradient φ/d²."""
    d = torch.tensor([1.0, 2.0, 4.0])

    def inner_loss(self, theta, phi, batch):
        return 0.5 * torch.sum(self.d * theta ** 2) - torch.sum(theta * phi)

    def outer_loss(self, theta, phi, batch):
        return 0.5 * torch.sum(theta ** 2)

    def init_params(self, rng):
        return torch.zeros(3)

    def init_hparams(self, rng):
        return torch.ones(3)


def test_from_bilevel_quadratic_matches_analytic():
    q = _Quad()
    g = from_bilevel(q, config=HypergradConfig(solver='exact', rho=0.0),
                     unroll_steps=200, unroll_lr=0.2)
    g.validate()
    assert g.chain_order() == ['params', 'hparams']
    phi = torch.ones(3)
    hg, _ = engine_hypergrad(g, {'params': phi / q.d, 'hparams': phi})
    torch.testing.assert_close(hg, phi / q.d ** 2, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Trilevel: reweight_maml step for step against the reference
# ---------------------------------------------------------------------------
def _port_reweight(**kw):
    return get_graph('reweight_maml', device='cpu',
                     data=DATA['reweight_maml'](**REWEIGHT_KW),
                     **REWEIGHT_KW, **kw)


@pytest.fixture(scope='module')
def reweight():
    """The reference's 3-step run and the port's, from the same data,
    initial values and column draws."""
    want = reference_run('reweight_maml', 3, 0.05,
                         tuple(REWEIGHT_KW.items()))
    g = _port_reweight()
    res = Engine().solve(g, EngineConfig(n_outer=3, outer_lr=0.05),
                         values=to_torch(want['values0']),
                         indices=want['draws'])
    return g, res, want


class TestTrilevelReweightMaml:
    def test_solves_step_for_step_as_the_reference(self, reweight):
        g, res, want = reweight
        assert len(res.losses) == 3 and all(map(np.isfinite, res.losses))
        assert res.losses[-1] < res.losses[0]
        np.testing.assert_allclose(res.losses, want['losses'], rtol=TOL)
        assert set(res.values) == {'adapted', 'meta', 'weights'}
        for name, value in want['values'].items():
            assert _rel(res.values[name], value) < TOL, name

    def test_bills_are_the_reference_bills(self, reweight):
        g, res, want = reweight
        assert res.edge_hvps == engine_edge_bills(g, n_outer=3) \
            == want['edge_hvps']
        assert res.hvp_count == sum(res.edge_hvps.values())

    def test_hypergrads_at_the_reference_point(self, reweight):
        """Full-rank sketches and the dense oracle at the reference's solved
        values: each matches the reference's to 1e-4, so their gap is the
        reference's own gap to within 2e-4. (The reference reaches about
        1.1e-3 there, past its test's 1e-3 bar: ROADMAP queue 3; the port
        is held to the reference's computed numbers, not to that bar.)"""
        g, _, want = reweight
        values = to_torch(want['values'])
        hg, _ = engine_hypergrad(g, values)
        ref, _ = engine_hypergrad_reference(g, values, rho=0.0)
        assert _rel(hg, want['hypergrad']) < TOL
        assert _rel(ref, want['oracle']) < TOL
        gap = float(hypergrad_error(hg, ref))
        assert abs(gap - _rel(to_torch(want['hypergrad']), want['oracle'])) \
            < 2 * TOL


def test_oracle_parity_is_exact_for_matched_solvers():
    """engine_hypergrad with the oracle's own solver agrees bit for bit with
    engine_hypergrad_reference."""
    g = _port_reweight()
    gen = torch.Generator().manual_seed(0)
    values = {n: g.nodes[n].init(gen) for n in g.chain_order()}
    ex = {n: ExactIHVP(rho=1e-4) for n in g.chain_order()[:-1]}
    hg, _ = engine_hypergrad(g, values, solvers=ex)
    ref, _ = engine_hypergrad_reference(g, values, rho=1e-4)
    assert float(hypergrad_error(hg, ref)) == 0.0


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------
class TestEdgeBills:
    def test_amortized_bills_are_additive(self):
        g = _port_reweight()
        bills = engine_edge_bills(g, n_outer=4)
        # full-rank defaults: k_adapted = T·d, k_meta = d; one build a step
        assert bills == {'adapted': 4 * 2 * 4, 'meta': 4 * 4}
        assert bills == jengine_edge_bills(
            jget_graph('reweight_maml', **REWEIGHT_KW), n_outer=4)

    def test_refresh_cadence_divides_builds(self):
        g = _port_reweight(refresh_every=2)
        assert engine_edge_bills(g, n_outer=4) == {'adapted': 2 * 2 * 4,
                                                   'meta': 2 * 4}

    def test_fresh_bills_multiply_down_the_chain(self):
        g = _port_reweight()
        amortized = engine_edge_bills(g, n_outer=4, amortize=True)
        fresh = engine_edge_bills(g, n_outer=4, amortize=False)
        assert fresh['meta'] == 4 * 4
        assert fresh['adapted'] > 10 * amortized['adapted']
        assert fresh == jengine_edge_bills(
            jget_graph('reweight_maml', **REWEIGHT_KW), n_outer=4,
            amortize=False)


def test_influence_and_engine_bills_share_one_definition():
    """The accounting invariant across paths: influence()'s per-build bill,
    the store's per-entry build_hvps, and the engine's per-edge bills all
    come from build_hvp_bill — k HVPs per Nyström build, p per exact column
    scan."""
    from repro_torch.core import influence
    from repro_torch.serve import SketchStore
    from repro_torch.tasks import build_influence
    problem = build_influence(d=8, width=8, device='cpu')
    params = problem.init_params(torch.Generator().manual_seed(0))
    ny = NystromIHVP(k=4, rho=1e-2)
    assert influence_build_hvps(ny, params) == build_hvp_bill(ny, params) \
        == 4
    assert (influence_build_hvps(ExactIHVP(), params)
            == build_hvp_bill(ExactIHVP(), params) == tree_size(params))
    g = from_bilevel(_Quad(), config=HypergradConfig(solver='nystrom', k=2,
                                                     rho=1e-2))
    assert engine_edge_bills(g, n_outer=5) == {'params': 5 * 2}
    store = SketchStore()
    cold = influence(problem, ny, problem.reference['queries'](1),
                     params=params, top_k=5, store=store, device='cpu')
    (entry,) = store._entries.values()
    assert entry.build_hvps == cold.hvp_count == 4


# ---------------------------------------------------------------------------
# The CLI's graph route
# ---------------------------------------------------------------------------
def test_cli_distill_hpo_prints_the_reference_bills(capsys):
    res = train_main(['--problem', 'distill_hpo', '--steps', '3',
                      '--log-every', '1', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert '[train] graph=distill_hpo levels=student<-images<-hpo' in out
    assert len(re.findall(r'\[engine\] outer \d: top_loss=', out)) == 3
    assert re.search(r'\[train\] done: graph=distill_hpo hvps=279 '
                     r'\(student=63 images=216\)', out)
    assert res.edge_hvps == {'student': 63, 'images': 216}
    assert all(map(np.isfinite, res.losses))

