"""The port's solver observatory (``repro_torch.bench``) against the
reference's (``repro.bench``), on the CPU at toy size.

Every draw is the reference's: the members' θ₀ and φ are its inits at
``fold_in(PRNGKey(seed), t)`` and ``fold_in(PRNGKey(seed), 10_000 + t)``,
the batches its ``ArraySource`` draws (``jax.random.randint`` at the step's
key, injected as ``draw``), and member t's sketch columns its
``PyTreeIndexer.sample_indices`` at ``split(fold_in(PRNGKey(seed), 777),
tasks)[t]``. The reference's per-cell hypergradients are read off the
programs its sweep compiles (its ``jax.jit`` recorded, nothing recompiled).

Tolerances: θ_T 1e-5 relative L2 per member (full-batch SGD steps in f32,
summed in another order than XLA); the oracle's and every cell's
hypergradients 1e-4 relative L2 per member (a p-column Hessian and a dense
solve, or a sketch, on top of θ_T); cell errors 1e-4 absolute + 1e-3
relative; ``hvp_count``, cell order and grid dicts exact.

The reweighting population's oracle is damped with ρ = 1 where the others
take ρ = 1e-2: its Hessian is indefinite (smallest eigenvalues −0.26 and
−0.21 at θ_T), and at ρ = 1e-2 member 0's H + ρI has an eigenvalue of
4.8e-6 (condition number 2.6e5). There the two f32 oracles differ by
2.9e-4 relative L2, and by 2.1e-4 even at the reference's own θ_T: the
conditioning amplifies roundoff, not a fault of the port. With ρ = 1 the
system is positive definite with condition number below 5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import build_population as jbuild_population
from repro.bench import parse_grid as jparse_grid
from repro.bench import parse_problem_spec as jparse_problem_spec
from repro.bench import parse_vary as jparse_vary
from repro.bench import run_sweep as jrun_sweep
from repro.bench import solver_grid_points as jsolver_grid_points
from repro.bench import observatory as jobservatory
from repro.core.problem import get_problem as jget_problem
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro_torch.bench import (DEFAULT_GRID, DEFAULT_PROBLEM_SPECS,
                               build_population, parse_grid,
                               parse_problem_spec, parse_vary, run_sweep,
                               solver_grid_points)
from repro_torch.bench.observatory import (DEFAULT_MAX_ORACLE_P,
                                           cell_hypergrads, measure_cell)
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.problem import _stack_draws
from repro_torch.core.tree_util import tree_leaves
from torch_threads import torch_thread_cap  # noqa: F401

SPEC = 'logreg_wd:D=8:n=60'
RW = 'reweighting:d=8:width=16'
META = 'imaml:width=8:image_size=6'
RHO = 1e-2
KS = (2, 4, 8)
SOLVERS = ('nystrom', 'cg', 'neumann', 'exact')
GRID = {'k': KS, 'rho': (RHO,)}
TASKS = 2
ORACLE_RHO = {SPEC: RHO, RW: 1.0, META: RHO}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_draw(key, batch_size, n):
    """The reference's batch draw (``ArraySource._draw``)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key),
                                         (batch_size,), 0, n))


def _rel_members(port_tree, ref_tree, tasks=TASKS):
    """Relative L2 error of each member (leading axis) of two stacked
    trees."""
    a = [x.reshape(tasks, -1) for x in tree_leaves(to_numpy(port_tree))]
    b = [np.asarray(x).reshape(tasks, -1) for x in jax.tree.leaves(ref_tree)]
    a, b = np.concatenate(a, 1), np.concatenate(b, 1)
    return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)


def _injected(spec, jbundle, seed=0):
    """The reference's draws for the port's ``build_population``."""
    name, kwargs = jparse_problem_spec(spec)
    phi = to_torch(_np(jbundle.phi))
    if name == 'imaml':
        return dict(phi=phi)
    rng = jax.random.PRNGKey(seed)
    theta0 = [jget_problem(name, **kwargs, seed=seed + t).init_params(
        jax.random.fold_in(rng, t)) for t in range(jbundle.tasks)]
    keys = jax.random.split(jax.random.fold_in(rng, 777), jbundle.tasks)

    def sketch_indices(t, k):
        return _np(JIndexer(theta0[t]).sample_indices(keys[t], k))

    return dict(theta0=to_torch(_np(jax.tree.map(
        lambda *xs: jnp.stack(xs), *theta0))), phi=phi, draw=_jax_draw,
        sketch_indices=sketch_indices)


class _RecordingJax:
    """The reference observatory's ``jax`` with ``jit`` keeping every output
    of each program it compiles, program by program."""

    def __init__(self):
        self.programs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, *args, **kwargs):
        compiled = jax.jit(fn, *args, **kwargs)
        outputs = []
        self.programs.append(outputs)

        def run(*xs):
            out = compiled(*xs)
            outputs.append(out)
            return out
        return run


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope='module')
def populations():
    """(reference bundle, port bundle) per spec, the port on the
    reference's draws."""
    out = {}
    for spec in (SPEC, RW, META):
        rho = ORACLE_RHO[spec]
        jb = jbuild_population(spec, tasks=TASKS, oracle_rho=rho)
        out[spec] = (jb, build_population(spec, tasks=TASKS, oracle_rho=rho,
                                          device='cpu',
                                          **_injected(spec, jb)))
    return out


@pytest.fixture(scope='module')
def sweeps(populations):
    """(reference cells, the reference's per-cell hypergradients, port
    cells, port bundle) of one sweep over all four solvers."""
    rec = _RecordingJax()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jobservatory, 'jax', rec)
        jcells = jrun_sweep((SPEC,), SOLVERS, GRID, tasks=TASKS,
                            oracle_rho=RHO, reps=1, seed=0)
    # programs 0-1 build the population (adaptation, oracle); then one
    # program per cell, whose first output is the cell's hypergradients
    jhg = [outputs[0] for outputs in rec.programs[2:]]
    assert len(jhg) == len(jcells)
    jb = populations[SPEC][0]
    cells = run_sweep((SPEC,), SOLVERS, GRID, tasks=TASKS, oracle_rho=RHO,
                      reps=1, seed=0, device='cpu',
                      injected={SPEC: _injected(SPEC, jb)})
    bundle = build_population(SPEC, tasks=TASKS, oracle_rho=RHO,
                              device='cpu', **_injected(SPEC, jb))
    return jcells, jhg, cells, bundle


# --------------------------------------------------------- populations
@pytest.mark.parametrize('spec', [SPEC, RW, META])
def test_population_matches_reference(populations, spec):
    """θ_T and the oracle per member; the batches bitwise; p and tasks."""
    jb, tb = populations[spec]
    assert (tb.p, tb.tasks, tb.spec) == (jb.p, jb.tasks, jb.spec)
    for a, b in zip(tree_leaves(to_numpy((tb.inner_b, tb.outer_b))),
                    jax.tree.leaves((jb.inner_b, jb.outer_b))):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert max(_rel_members(tb.theta, jb.theta)) <= 1e-5
    assert max(_rel_members(tb.reference, jb.reference)) <= 1e-4
    assert set(tb.seconds) == {'adapt', 'oracle'}


def test_meta_population_takes_the_task_batch_branch(populations):
    jb, tb = populations[META]
    (sx, _), _ = tb.inner_b, tb.outer_b
    assert sx.shape[0] == TASKS
    # every member adapts from the one meta-init
    for leaf in tree_leaves(tb.phi):
        torch.testing.assert_close(leaf[0], leaf[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match='--vary is not supported') as port:
        build_population(META, vary=('seed', (0, 1)), device='cpu')
    with pytest.raises(ValueError, match='--vary is not supported') as ref:
        jbuild_population(META, vary=('seed', (0, 1)))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize('solver,point', [
    ('nystrom', {'k': 5, 'rho': RHO}), ('cg', {'k': 5, 'rho': RHO})])
def test_meta_cells_match_reference(populations, solver, point):
    """The vmapped hypergradients of the iMAML population (per-member
    sketches under the map's task rule) against the reference's."""
    jb, tb = populations[META]
    jsolver = jobservatory.HypergradConfig(solver=solver, **point).build()
    want = jax.jit(jax.vmap(
        lambda th, ph, ib, ob, key: jobservatory.hypergrad_at(
            jb.problem, jsolver, th, ph, ib, ob, rng=key)))(
                jb.theta, jb.phi, jb.inner_b, jb.outer_b, jb.keys)
    tb = dataclasses.replace(
        tb, sketch_indices=lambda k: _stack_draws([
            _np(JIndexer(jax.tree.map(lambda x: x[t], jb.theta))
                .sample_indices(jb.keys[t], k)) for t in range(jb.tasks)]))
    got = cell_hypergrads(tb, solver, point, device='cpu')
    assert max(_rel_members(got, want)) <= 1e-4


@pytest.mark.parametrize('solver,point', [
    ('nystrom', {'k': 4, 'rho': RHO, 'backend': 'cuda'}),
    ('cg', {'k': 4, 'rho': RHO}), ('neumann', {'k': 4}),
    ('exact', {'rho': RHO})])
def test_hypergrad_at_under_vmap_is_per_member_hypergrad_at(populations,
                                                          solver, point):
    """``hypergrad_at`` composes with ``torch.func.vmap`` (it took
    ``torch.autograd.grad`` of leaves it had set ``requires_grad_`` on,
    which a functorch transform refuses): the vmapped population equals
    the members' own calls at their own column draws."""
    from torch.func import vmap
    from repro_torch.core import HypergradConfig, hypergrad_at
    from repro_torch.core.tree_util import tree_map
    tb = populations[SPEC][1]
    config = HypergradConfig(solver=solver, **point)
    idx = tb.sketch_indices(4)
    got = vmap(lambda th, ph, ib, ob, ix: hypergrad_at(
        tb.problem, config, th, ph, ib, ob, indices=ix, device='cpu'))(
            tb.theta, tb.phi, tb.inner_b, tb.outer_b, idx)
    for t in range(TASKS):
        one = hypergrad_at(tb.problem, config,
                           *(tree_map(lambda x: x[t], tree) for tree in (
                               tb.theta, tb.phi, tb.inner_b, tb.outer_b)),
                           indices={k: v[t] for k, v in idx.items()},
                           device='cpu')
        torch.testing.assert_close(got['wd'][t], one['wd'], rtol=1e-5,
                                   atol=1e-6)


def test_vary_axis_sets_population():
    bundle = build_population(RW, tasks=1, vary=('imbalance', (10, 100)),
                              batch_size=16, steps=3, device='cpu')
    assert bundle.tasks == 2
    # each member is its own variant: its data differ
    X = bundle.inner_b[0]
    assert X.shape[:2] == (2, 16) and not torch.equal(X[0], X[1])
    cell = measure_cell(bundle, 'cg', {'k': 2, 'rho': RHO}, reps=1,
                        device='cpu')
    assert cell.tasks == 2 and np.isfinite(cell.hypergrad_error)


# --------------------------------------------------------------- sweeps
def test_sweep_cells_match_reference(sweeps):
    """The same cells in the same order, the same grid dicts and bills, the
    same hypergradients and errors."""
    jcells, jhg, cells, bundle = sweeps
    assert [(c.problem, c.solver, c.grid, c.backend, c.tasks, c.hvp_count)
            for c in cells] == [
        (c.problem, c.solver, c.grid, c.backend, c.tasks, c.hvp_count)
        for c in jcells]
    for c, j, want in zip(cells, jcells, jhg):
        for field in ('hypergrad_error', 'err_max'):
            assert abs(getattr(c, field) - getattr(j, field)) <= \
                1e-4 + 1e-3 * abs(getattr(j, field)), (c, j)
        got = cell_hypergrads(bundle, c.solver, c.grid, backend=c.backend,
                              device='cpu')
        assert max(_rel_members(got, want)) <= 1e-4, c
        assert (c.collective_count, c.accum_dtype_ok) == (None, None)


def _errs(cells, solver):
    by_k = {c.grid['k']: c.hypergrad_error for c in cells
            if c.solver == solver}
    return [by_k[k] for k in KS]


def test_reference_contracts_hold_in_port(sweeps):
    """The reference's own contracts: more columns or iterations never
    hurt, the full-rank sketch and the exact solver meet the oracle, and
    the bills are analytic."""
    cells = sweeps[2]
    for solver in ('nystrom', 'cg'):
        errs = _errs(cells, solver)
        for lo, hi in zip(errs[1:], errs[:-1]):
            assert lo <= hi * 1.05 + 1e-6, (solver, errs)
    assert _errs(cells, 'cg')[-1] < _errs(cells, 'cg')[0] * 1e-2
    assert _errs(cells, 'nystrom')[-1] < 1e-4          # k = p = 8
    (exact,) = [c for c in cells if c.solver == 'exact']
    assert exact.hypergrad_error < 1e-6 and exact.err_max < 1e-6
    assert exact.hvp_count == 8
    for c in cells:
        if c.solver != 'exact':
            assert c.hvp_count == c.grid['k']
        assert c.wall_seconds > 0 and c.applies_per_sec > 0


def test_backends_record_and_agree(populations):
    """``backend`` reaches Nyström alone; tree, flat and cuda (its kernels'
    plain versions on the CPU) give the same hypergradients."""
    bundle = populations[SPEC][1]
    point = {'k': 4, 'rho': RHO}
    cells = {be: measure_cell(bundle, 'nystrom', point, backend=be, reps=1,
                              device='cpu') for be in ('tree', 'flat', 'cuda')}
    for be, cell in cells.items():
        assert cell.backend == be and cell.hvp_count == 4
        assert cell.hypergrad_error == pytest.approx(
            cells['tree'].hypergrad_error, rel=1e-3, abs=1e-6)
    hg = {be: cell_hypergrads(bundle, 'nystrom', point, backend=be,
                              device='cpu') for be in ('tree', 'flat', 'cuda')}
    for be in ('flat', 'cuda'):
        assert max(_rel_members(hg[be], to_numpy(hg['tree']))) <= 1e-5
    cell = measure_cell(bundle, 'cg', {'k': 2, 'rho': RHO}, reps=1,
                        device='cpu')
    assert cell.backend == 'tree'
    only = run_sweep((SPEC,), ('nystrom', 'cg'), {'k': (2,), 'rho': (RHO,)},
                     tasks=1, oracle_rho=RHO, reps=1, device='cpu',
                     backends=('tree', 'flat'))
    assert [(c.solver, c.backend) for c in only] == [
        ('nystrom', 'tree'), ('nystrom', 'flat'), ('cg', 'tree')]


# ------------------------------------------------------------ refusals
def test_audit_raises_before_any_measurement():
    with pytest.raises(NotImplementedError, match='item 13'):
        measure_cell(None, 'cg', {'k': 2}, audit=True)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        run_sweep(('not_a_problem',), ('not_a_solver',), audit=True)


def test_oracle_guard_refuses_large_p_with_the_reference_message():
    with pytest.raises(ValueError, match='max_oracle_p') as port:
        build_population(SPEC, tasks=1, max_oracle_p=4, device='cpu')
    with pytest.raises(ValueError, match='max_oracle_p') as ref:
        jbuild_population(SPEC, tasks=1, max_oracle_p=4)
    assert str(port.value) == str(ref.value)


def test_unknown_solver_and_problem_raise_with_the_registry():
    with pytest.raises(ValueError, match="unknown solver 'sgd'") as port:
        run_sweep((SPEC,), ('sgd',), {'k': (2,)}, tasks=1, device='cpu')
    with pytest.raises(ValueError, match="unknown solver 'sgd'") as ref:
        jrun_sweep((SPEC,), ('sgd',), {'k': (2,)}, tasks=1)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match='unknown problem') as port:
        run_sweep(('not_a_problem',), ('cg',), {'k': (2,)}, tasks=1,
                  device='cpu')
    assert 'logreg_wd' in str(port.value) and 'reweighting' in str(port.value)


def test_a_population_on_another_device_is_refused(populations):
    bundle = populations[SPEC][1]
    with pytest.raises(ValueError, match='lives on cpu'):
        measure_cell(bundle, 'cg', {'k': 2, 'rho': RHO}, device='meta')


# --------------------------------------------------------------- parsing
@pytest.mark.parametrize('text', [
    'logreg_wd:D=8:n=60', 'reweighting', 'distillation:n_per_class=1:'
    'image_size=8:width=16', 'x:a=0.5:b=true:c=name', 'logreg_wd:D8'])
def test_parse_problem_spec_matches_reference(text):
    _same(parse_problem_spec, jparse_problem_spec, text)


@pytest.mark.parametrize('text', ['k=2:4:8,rho=0.01', 'k=2:4,rho=0.01:0.1',
                                  'alpha=1e-3,', '', 'k'])
def test_parse_grid_matches_reference(text):
    _same(parse_grid, jparse_grid, text)


@pytest.mark.parametrize('text', ['imbalance=10,100', 'seed=0', 'imbalance'])
def test_parse_vary_matches_reference(text):
    _same(parse_vary, jparse_vary, text)


def _same(port_fn, ref_fn, text):
    try:
        want = ref_fn(text)
    except ValueError as e:
        with pytest.raises(ValueError) as port:
            port_fn(text)
        assert str(port.value) == str(e)
    else:
        assert port_fn(text) == want


@pytest.mark.parametrize('grid', [
    {'k': (2, 4), 'rho': (0.01, 0.1), 'alpha': (0.1,)}, {}, DEFAULT_GRID])
def test_solver_grid_points_match_reference(grid):
    for solver in SOLVERS:
        assert solver_grid_points(solver, grid) == \
            jsolver_grid_points(solver, grid)
    with pytest.raises(ValueError, match="unknown solver 'sgd'"):
        solver_grid_points('sgd', grid)


def test_defaults_are_the_reference_values():
    assert DEFAULT_PROBLEM_SPECS == jobservatory.DEFAULT_PROBLEM_SPECS
    assert DEFAULT_GRID == jobservatory.DEFAULT_GRID
    assert DEFAULT_MAX_ORACLE_P == jobservatory.DEFAULT_MAX_ORACLE_P
