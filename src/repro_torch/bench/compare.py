"""Regression diffing of two persisted BENCH_*.json runs (the port's copy
of the reference's pure-Python module; it imports neither JAX nor the
reference).

The observatory (and every other bench writing schema-v2 rows) persists a
perf trajectory; this module is what makes it *enforceable*: given a
baseline document and a new run, match cells by identity, compare the
measurement fields under configurable tolerances, and name every offender.
The functions here are pure, so tests drive them directly; the port has no
CLI over them yet.

Cell identity is every row field that is NOT a measurement — solver,
backend, problem, m, the grid dict, and any bench-specific extras — so two
runs line up cell-for-cell without a hand-maintained key list, and a new
knob added to the rows automatically splits the cells it distinguishes.

Regressions (vs the baseline cell):
  * ``wall_seconds`` above baseline by more than ``tol_wall`` (relative),
    and ``applies_per_sec`` below by the same margin — both skipped under
    ``check_wall=False`` (cross-machine comparisons, e.g. CI vs the
    committed baseline fixture);
  * ``hypergrad_error`` above baseline by more than ``tol_error`` relative
    plus ``atol_error`` absolute (the absolute floor keeps near-zero
    baselines from flagging roundoff);
  * ``hvp_count`` increased at all — the bill is analytic, so any growth
    is a real complexity regression, never noise;
  * a baseline cell missing from the new run (silent coverage loss).

Cells only the new run has are reported as additions, never failures.
Documents with different ``schema_version`` refuse to diff (a v1 baseline
cannot be compared field-for-field against v2 rows — regenerate it).
"""
from __future__ import annotations

import dataclasses
import json

# Fields that are measured outcomes rather than cell identity. Includes the
# legacy/extra measurement names some benches emit (err_max, seconds, ...)
# so they never end up splitting cell identity. The serving tier's latency/
# queue metrics are machine-varying measurements; its deterministic fields
# (phase, cache_hit_rate) are deliberately NOT listed — they are identity,
# so a changed hit rate or a vanished warm cell fails the diff as MISSING.
MEASURE_KEYS = frozenset({
    'applies_per_sec', 'wall_seconds', 'hypergrad_error', 'hvp_count',
    'err_max', 'hvps', 'sketch_mb', 'seconds', 'us_per_apply',
    'latency_mean_ms', 'latency_p50_ms', 'latency_p95_ms', 'latency_max_ms',
    'queue_depth_mean', 'queue_depth_max', 'degraded_flushes',
    'deadline_misses', 'jaccard_vs_exact',
    # program-structure audit: typed-optional, only present when the run
    # was audited
    'collective_count', 'accum_dtype_ok',
})


class CompareError(ValueError):
    """A comparison that cannot be made (schema mismatch, malformed doc) —
    distinct from a comparison that *fails* (regressions found)."""


@dataclasses.dataclass
class CellDiff:
    """One measurement delta for one matched cell."""
    cell: str          # human-readable cell identity
    field: str
    base: float
    new: float
    regressed: bool
    note: str = ''


@dataclasses.dataclass
class CompareReport:
    diffs: list[CellDiff]
    missing: list[str]             # baseline cells absent from the new run
    added: list[str]               # new-run cells absent from the baseline

    @property
    def regressions(self) -> list[CellDiff]:
        return [d for d in self.diffs if d.regressed]

    @property
    def ok(self) -> bool:
        return not self.regressions and not self.missing


def _freeze(value):
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


def _cell_key(row: dict):
    return tuple(sorted((k, _freeze(v)) for k, v in row.items()
                        if k not in MEASURE_KEYS))


def _cell_label(row: dict) -> str:
    parts = [f"problem={row.get('problem', '?')}",
             f"solver={row.get('solver', '?')}"]
    grid = row.get('grid')
    if grid:
        parts.append('grid[' + ','.join(f'{k}={v}'
                                        for k, v in sorted(grid.items()))
                     + ']')
    for k in sorted(row):
        if k in MEASURE_KEYS or k in ('problem', 'solver', 'grid'):
            continue
        parts.append(f'{k}={row[k]}')
    return ' '.join(parts)


def _index(doc: dict) -> dict:
    index = {}
    for i, row in enumerate(doc.get('rows', [])):
        key = _cell_key(row)
        if key in index:
            raise CompareError(
                f'duplicate cell in {doc.get("name", "?")!r}: '
                f'{_cell_label(row)} (rows {index[key][0]} and {i}) — '
                'cells must be unique to diff runs')
        index[key] = (i, row)
    return index


def compare_docs(base: dict, new: dict, *, tol_wall: float = 0.25,
                 tol_error: float = 0.25, atol_error: float = 1e-6,
                 check_wall: bool = True) -> CompareReport:
    """Diff two parsed BENCH documents → :class:`CompareReport`."""
    bv, nv = base.get('schema_version'), new.get('schema_version')
    if bv != nv:
        raise CompareError(
            f'schema_version mismatch: baseline is v{bv}, new run is v{nv} '
            '— rows cannot be compared field-for-field across schema '
            'versions; regenerate the baseline with the current bench')
    base_idx, new_idx = _index(base), _index(new)

    diffs: list[CellDiff] = []
    missing = [_cell_label(row) for key, (_, row) in base_idx.items()
               if key not in new_idx]
    added = [_cell_label(row) for key, (_, row) in new_idx.items()
             if key not in base_idx]

    for key, (_, b) in base_idx.items():
        if key not in new_idx:
            continue
        n = new_idx[key][1]
        cell = _cell_label(b)
        if check_wall and 'wall_seconds' in b and 'wall_seconds' in n:
            bad = n['wall_seconds'] > b['wall_seconds'] * (1 + tol_wall)
            diffs.append(CellDiff(
                cell, 'wall_seconds', b['wall_seconds'], n['wall_seconds'],
                bad, note=f'tol={tol_wall:.0%} relative'))
        if check_wall and 'applies_per_sec' in b and 'applies_per_sec' in n:
            bad = n['applies_per_sec'] < b['applies_per_sec'] / (1 + tol_wall)
            diffs.append(CellDiff(
                cell, 'applies_per_sec', b['applies_per_sec'],
                n['applies_per_sec'], bad, note=f'tol={tol_wall:.0%}'))
        if 'hypergrad_error' in b and 'hypergrad_error' in n:
            limit = b['hypergrad_error'] * (1 + tol_error) + atol_error
            diffs.append(CellDiff(
                cell, 'hypergrad_error', b['hypergrad_error'],
                n['hypergrad_error'], n['hypergrad_error'] > limit,
                note=f'limit={limit:.3e}'))
        if 'jaccard_vs_exact' in b and 'jaccard_vs_exact' in n:
            floor = b['jaccard_vs_exact'] * (1 - tol_error) - atol_error
            diffs.append(CellDiff(
                cell, 'jaccard_vs_exact', b['jaccard_vs_exact'],
                n['jaccard_vs_exact'], n['jaccard_vs_exact'] < floor,
                note=f'floor={floor:.3f} (retrieval quality vs exact)'))
        if check_wall and 'latency_p95_ms' in b and 'latency_p95_ms' in n:
            bad = n['latency_p95_ms'] > b['latency_p95_ms'] * (1 + tol_wall)
            diffs.append(CellDiff(
                cell, 'latency_p95_ms', b['latency_p95_ms'],
                n['latency_p95_ms'], bad, note=f'tol={tol_wall:.0%}'))
        if 'hvp_count' in b and 'hvp_count' in n:
            diffs.append(CellDiff(
                cell, 'hvp_count', b['hvp_count'], n['hvp_count'],
                n['hvp_count'] > b['hvp_count'],
                note='any increase regresses (analytic bill)'))
        if 'collective_count' in b and 'collective_count' in n:
            diffs.append(CellDiff(
                cell, 'collective_count', b['collective_count'],
                n['collective_count'],
                n['collective_count'] > b['collective_count'],
                note='any increase regresses (program structure)'))
        if 'accum_dtype_ok' in b and 'accum_dtype_ok' in n:
            diffs.append(CellDiff(
                cell, 'accum_dtype_ok', float(b['accum_dtype_ok']),
                float(n['accum_dtype_ok']),
                bool(b['accum_dtype_ok']) and not n['accum_dtype_ok'],
                note='True->False regresses (low-precision accumulation '
                     'crept in)'))
    return CompareReport(diffs=diffs, missing=missing, added=added)


def compare_files(base_path: str, new_path: str, **kwargs) -> CompareReport:
    with open(base_path) as f:
        base = json.load(f)
    with open(new_path) as f:
        new = json.load(f)
    return compare_docs(base, new, **kwargs)


def format_report(report: CompareReport, *, verbose: bool = False) -> str:
    """Human-readable report; regressions and missing cells always named."""
    lines = []
    for d in report.diffs:
        if d.regressed:
            lines.append(f'REGRESSION {d.cell}: {d.field} '
                         f'{d.base:.6g} -> {d.new:.6g} ({d.note})')
        elif verbose:
            lines.append(f'ok         {d.cell}: {d.field} '
                         f'{d.base:.6g} -> {d.new:.6g}')
    for cell in report.missing:
        lines.append(f'MISSING    {cell}: present in baseline, absent from '
                     'new run')
    for cell in report.added:
        lines.append(f'added      {cell}: new cell (no baseline)')
    n_reg = len(report.regressions) + len(report.missing)
    matched = len({d.cell for d in report.diffs})
    lines.append(f'compared {matched} cells: '
                 + ('clean' if report.ok else f'{n_reg} regression(s)'))
    return '\n'.join(lines)
