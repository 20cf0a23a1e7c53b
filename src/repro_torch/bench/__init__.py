"""repro_torch.bench — the solver observatory's measurement substrate.

Public API:
  run_sweep / SweepCell / build_population    — PROBLEMS × SOLVERS × knob-grid
                                                complexity sweeps (vmapped
                                                population axis, error vs the
                                                exact-IHVP oracle)
  parse_grid / parse_problem_spec /           — the spec mini-language
    parse_vary
  solver_grid_points                          — registry-driven grid axes (a
                                                solver sweeps exactly the
                                                knobs its SolverSpec consumes)
  compare_docs / CompareError / format_report — two-run regression diffing
  fit_rates / RateFit / format_rates          — Grazzi-style empirical rate
                                                fits (log-error vs log-HVP
                                                bill per cell ladder)

The package holds the reference's importable names; the port has no CLI
over them yet (``chip_smoke.py`` drives ``run_sweep`` directly).
"""
from repro_torch.bench.compare import (CellDiff, CompareError, CompareReport,
                                       compare_docs, format_report)
from repro_torch.bench.observatory import (DEFAULT_GRID,
                                           DEFAULT_PROBLEM_SPECS,
                                           PopulationBundle, SweepCell,
                                           build_population, parse_grid,
                                           parse_problem_spec, parse_vary,
                                           run_sweep, solver_grid_points)
from repro_torch.bench.rates import (RateFit, fit_rates, fit_rates_file,
                                     format_rates)

__all__ = [
    'CellDiff', 'CompareError', 'CompareReport', 'DEFAULT_GRID',
    'DEFAULT_PROBLEM_SPECS', 'PopulationBundle', 'RateFit', 'SweepCell',
    'build_population', 'compare_docs', 'fit_rates', 'fit_rates_file',
    'format_rates', 'format_report', 'parse_grid', 'parse_problem_spec',
    'parse_vary', 'run_sweep', 'solver_grid_points',
]
