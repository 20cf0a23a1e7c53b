"""The port's copies of the reference's pure-Python bench modules
(``repro_torch.bench.compare`` and ``.rates``) against the reference's, on
the same schema-v2 documents, built here or written to ``tmp_path`` here:
reports and fits must be equal field for field and string for string.
"""
import dataclasses
import json

import pytest

from repro.bench import compare as jcompare
from repro.bench import rates as jrates
from repro_torch.bench import compare, rates
from torch_threads import torch_thread_cap  # noqa: F401

MEASURED = ('wall_seconds', 'applies_per_sec', 'hypergrad_error',
            'jaccard_vs_exact', 'latency_p95_ms', 'hvp_count',
            'collective_count', 'accum_dtype_ok')


def _row(solver='nystrom', k=4, **measures):
    row = dict(problem='logreg_wd:D=8:n=60', solver=solver,
               backend='tree', grid={'k': k, 'rho': 0.01}, tasks=3,
               wall_seconds=0.02, applies_per_sec=150.0,
               hypergrad_error=1e-3, err_max=2e-3, hvp_count=k,
               jaccard_vs_exact=0.9, latency_p95_ms=4.0,
               collective_count=0, accum_dtype_ok=True)
    row.update(measures)
    return row


def _doc(rows, version=2):
    return {'name': 'observatory', 'schema_version': version, 'rows': rows}


# a change that regresses each measured field, and one that does not
WORSE = dict(wall_seconds=0.04, applies_per_sec=50.0, hypergrad_error=5e-3,
             jaccard_vs_exact=0.5, latency_p95_ms=9.0, hvp_count=5,
             collective_count=2, accum_dtype_ok=False)
BETTER = dict(wall_seconds=0.01, applies_per_sec=300.0,
              hypergrad_error=5e-4, jaccard_vs_exact=0.95,
              latency_p95_ms=2.0, hvp_count=4, collective_count=0,
              accum_dtype_ok=True)


def _both(fn_name, *args, module='compare', **kwargs):
    port = getattr({'compare': compare, 'rates': rates}[module], fn_name)
    ref = getattr({'compare': jcompare, 'rates': jrates}[module], fn_name)
    return port(*args, **kwargs), ref(*args, **kwargs)


def _same_report(port, ref):
    assert [dataclasses.asdict(d) for d in port.diffs] == \
        [dataclasses.asdict(d) for d in ref.diffs]
    assert (port.missing, port.added, port.ok) == (ref.missing, ref.added,
                                                   ref.ok)
    for verbose in (False, True):
        assert compare.format_report(port, verbose=verbose) == \
            jcompare.format_report(ref, verbose=verbose)


def test_measure_keys_are_the_reference_set():
    assert compare.MEASURE_KEYS == jcompare.MEASURE_KEYS


@pytest.mark.parametrize('field', MEASURED)
def test_a_regression_in_each_measured_field(field):
    base = _doc([_row()])
    new = _doc([_row(**{field: WORSE[field]})])
    port, ref = _both('compare_docs', base, new)
    _same_report(port, ref)
    assert [d.field for d in port.regressions] == [field]
    port, ref = _both('compare_docs', base, _doc([_row(**{field:
                                                           BETTER[field]})]))
    _same_report(port, ref)
    assert port.ok


def test_wall_fields_are_skipped_without_check_wall():
    base, new = _doc([_row()]), _doc([_row(**WORSE)])
    port, ref = _both('compare_docs', base, new, check_wall=False,
                      tol_error=0.1, atol_error=1e-7)
    _same_report(port, ref)
    assert {d.field for d in port.regressions} == {
        'hypergrad_error', 'jaccard_vs_exact', 'hvp_count',
        'collective_count', 'accum_dtype_ok'}


def test_missing_and_added_cells():
    base = _doc([_row(k=2), _row(k=4), _row(solver='cg', k=4)])
    new = _doc([_row(k=4), _row(solver='cg', k=4), _row(k=8)])
    port, ref = _both('compare_docs', base, new)
    _same_report(port, ref)
    assert len(port.missing) == 1 and 'k=2' in port.missing[0]
    assert len(port.added) == 1 and 'k=8' in port.added[0]
    assert not port.ok


def test_schema_mismatch_and_duplicate_cells_refuse_to_diff():
    for base, new in ((_doc([_row()], 1), _doc([_row()])),
                      (_doc([_row(), _row()]), _doc([_row()]))):
        with pytest.raises(compare.CompareError) as port:
            compare.compare_docs(base, new)
        with pytest.raises(jcompare.CompareError) as ref:
            jcompare.compare_docs(base, new)
        assert str(port.value) == str(ref.value)
    assert issubclass(compare.CompareError, ValueError)


def test_compare_files_reads_the_written_documents(tmp_path):
    base, new = tmp_path / 'base.json', tmp_path / 'new.json'
    base.write_text(json.dumps(_doc([_row(k=2), _row(k=4)])))
    new.write_text(json.dumps(_doc([_row(k=2, hypergrad_error=9e-3)])))
    port, ref = _both('compare_files', str(base), str(new))
    _same_report(port, ref)
    assert len(port.regressions) == 1 and len(port.missing) == 1


def _ladder(solver, errs, backend='tree', problem='logreg_wd:D=8:n=60'):
    return [dict(problem=problem, solver=solver, backend=backend,
                 grid={'k': k}, hvp_count=k, hypergrad_error=e)
            for k, e in errs]


LADDERS = (_ladder('nystrom', [(2, 0.5), (4, 0.12), (8, 0.03), (8, 0.05)])
           + _ladder('cg', [(2, 1e-2), (4, 1e-4), (8, 1e-7)])
           + _ladder('neumann', [(2, 0.9), (4, 0.8)])          # 2 bills
           + _ladder('exact', [(8, 0.0), (16, float('nan')), (0, 1.0)])
           + [dict(problem='x', solver='cg', backend='tree',
                   hypergrad_error=None, hvp_count=2)])


@pytest.mark.parametrize('min_points', [2, 3])
def test_fitted_ladders(min_points):
    port, ref = _both('fit_rates', _doc(LADDERS), module='rates',
                      min_points=min_points)
    assert [dataclasses.asdict(f) for f in port] == \
        [dataclasses.asdict(f) for f in ref]
    assert [str(f) for f in port] == [str(f) for f in ref]
    assert {f.solver for f in port} == (
        {'nystrom', 'cg', 'neumann'} if min_points == 2
        else {'nystrom', 'cg'})
    cg = [f for f in port if f.solver == 'cg'][0]
    assert cg.slope < -2.0 and cg.points == 3
    # a bare row list fits as the document does
    assert rates.fit_rates(LADDERS, min_points) == port


def test_fit_rates_file_and_format_rates(tmp_path):
    path = tmp_path / 'BENCH_observatory.json'
    path.write_text(json.dumps(_doc(LADDERS)))
    port, ref = _both('fit_rates_file', str(path), module='rates')
    assert [dataclasses.asdict(f) for f in port] == \
        [dataclasses.asdict(f) for f in ref]
    newer = rates.fit_rates(_ladder('nystrom', [(2, 0.4), (4, 0.05),
                                                (8, 0.004)])
                            + _ladder('nystrom', [(2, 0.4), (4, 0.05),
                                                  (8, 0.004)], 'flat'))
    jnewer = jrates.fit_rates(_ladder('nystrom', [(2, 0.4), (4, 0.05),
                                                  (8, 0.004)])
                              + _ladder('nystrom', [(2, 0.4), (4, 0.05),
                                                    (8, 0.004)], 'flat'))
    assert rates.format_rates(port) == jrates.format_rates(ref)
    assert rates.format_rates(port, newer) == jrates.format_rates(ref, jnewer)
    assert rates.format_rates([]) == jrates.format_rates([])
    assert rates.format_rates([], []) == jrates.format_rates([], [])
    text = rates.format_rates(port, newer)
    assert '[new ladder]' in text and '[ladder gone in new run]' in text
