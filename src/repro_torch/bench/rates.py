"""Empirical convergence-rate fits over observatory ladders (the port's copy
of the reference's pure-Python module).

Grazzi et al. (2020) characterize hypergradient approximation error as a
function of inner-solver effort; the observatory measures exactly that
surface — per-cell ``hypergrad_error`` against the analytic ``hvp_count``
bill. This module compresses each **cell ladder** (the rows sharing one
(problem, solver, backend) identity and differing only in the swept effort
knob — k for Nyström, l for CG/Neumann) into a power-law fit

    log10(error) ≈ slope · log10(hvp_count) + intercept

by least squares. The slope is the empirical rate: how many decades of
accuracy one decade of HVP budget buys. A CG ladder on a well-conditioned
quadratic fits steeply negative; a Nyström ladder's slope tracks the
spectral decay the paper's bounds are written in terms of; a flat slope
on a solver that should converge is a regression worth staring at.

Fits are descriptive, not gated: ``format_rates`` prints them for two runs
side by side so a rate collapse is visible next to the report that
enforces the per-cell tolerances.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Iterable, Mapping


@dataclasses.dataclass(frozen=True)
class RateFit:
    """One fitted ladder: ``error ≈ 10^intercept · hvps^slope``."""
    problem: str
    solver: str
    backend: str
    points: int              # distinct (hvps, error) pairs behind the fit
    slope: float             # d log10(err) / d log10(hvps)
    intercept: float
    r2: float                # goodness of the log-log fit

    def __str__(self) -> str:
        return (f'{self.problem} {self.solver}/{self.backend}: '
                f'slope {self.slope:+.2f} (r²={self.r2:.3f}, '
                f'n={self.points})')


def _ladder_rows(rows: Iterable[Mapping[str, Any]]):
    """Group rows into ladders keyed by (problem, solver, backend). Rows
    without an error measurement or with a zero/invalid bill are skipped —
    they carry no rate information."""
    ladders: dict[tuple, list[tuple[float, float]]] = {}
    for row in rows:
        err = row.get('hypergrad_error')
        hvps = row.get('hvp_count')
        if err is None or hvps is None:
            continue
        err, hvps = float(err), float(hvps)
        if not (err > 0.0 and math.isfinite(err) and hvps > 0.0):
            continue
        key = (str(row.get('problem', '?')), str(row.get('solver', '?')),
               str(row.get('backend', '?')))
        ladders.setdefault(key, []).append((hvps, err))
    return ladders


def _least_squares(xs: list[float], ys: list[float]) -> tuple[float, float, float]:
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = sxy / sxx
    intercept = my - slope * mx
    ss_res = sum((y - (slope * x + intercept)) ** 2
                 for x, y in zip(xs, ys))
    ss_tot = sum((y - my) ** 2 for y in ys)
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0.0 else 1.0
    return slope, intercept, r2


def fit_rates(doc_or_rows: Mapping[str, Any] | Iterable[Mapping[str, Any]],
              min_points: int = 3) -> list[RateFit]:
    """Fit a log-error vs log-HVP-bill line per cell ladder.

    Accepts a full BENCH document (``{'rows': [...]}``) or a bare row list.
    Ladders with fewer than ``min_points`` *distinct* bills are skipped —
    two points always fit a line, which is a rate measurement in name only.
    Duplicate bills (e.g. population repeats) are averaged in log space
    before fitting. Returns fits sorted by (problem, solver, backend).
    """
    rows = doc_or_rows.get('rows', []) if isinstance(doc_or_rows, Mapping) \
        else list(doc_or_rows)
    fits = []
    for key, pairs in sorted(_ladder_rows(rows).items()):
        by_bill: dict[float, list[float]] = {}
        for hvps, err in pairs:
            by_bill.setdefault(hvps, []).append(math.log10(err))
        if len(by_bill) < min_points:
            continue
        xs = [math.log10(h) for h in sorted(by_bill)]
        ys = [sum(by_bill[h]) / len(by_bill[h]) for h in sorted(by_bill)]
        slope, intercept, r2 = _least_squares(xs, ys)
        problem, solver, backend = key
        fits.append(RateFit(problem=problem, solver=solver, backend=backend,
                            points=len(by_bill), slope=slope,
                            intercept=intercept, r2=r2))
    return fits


def fit_rates_file(path: str, min_points: int = 3) -> list[RateFit]:
    """``fit_rates`` over a persisted BENCH_*.json document."""
    with open(path) as f:
        return fit_rates(json.load(f), min_points=min_points)


def format_rates(baseline: list[RateFit], new: list[RateFit] | None = None
                 ) -> str:
    """Render fits as a report section; with two runs, matched ladders are
    printed side by side (baseline → new) so rate drift is scannable."""
    if new is None:
        lines = ['rate fits (log10 err vs log10 HVPs):']
        lines += [f'  {f}' for f in baseline] or ['  (no fittable ladders)']
        return '\n'.join(lines)
    lines = ['rate fits, baseline -> new:']
    base = {(f.problem, f.solver, f.backend): f for f in baseline}
    seen = set()
    for f in new:
        key = (f.problem, f.solver, f.backend)
        seen.add(key)
        b = base.get(key)
        if b is None:
            lines.append(f'  {f}   [new ladder]')
        else:
            lines.append(f'  {f.problem} {f.solver}/{f.backend}: '
                         f'slope {b.slope:+.2f} -> {f.slope:+.2f} '
                         f'(r² {b.r2:.3f} -> {f.r2:.3f}, n={f.points})')
    for key, b in base.items():
        if key not in seen:
            lines.append(f'  {b}   [ladder gone in new run]')
    if len(lines) == 1:
        lines.append('  (no fittable ladders)')
    return '\n'.join(lines)
