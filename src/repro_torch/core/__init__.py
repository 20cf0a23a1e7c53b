"""repro_torch.core — the Nyström implicit differentiation, in PyTorch.

  BilevelProblem / solve / PROBLEMS              — typed problem API
  hypergrad_at / hypergrad_reference /           — per-point hypergradient +
    hypergrad_error                                exact-IHVP oracle
  implicit_root / phi_vjp_block                  — differentiable θ*(φ) map
                                                   (+ m-query cotangent block)
  NystromIHVP / ExactIHVP                        — IHVP solvers
  hypergradient                                  — Eq. 3 assembly
  BilevelTrainer / BilevelState                  — warm-start bilevel loop
  SketchPolicy / SketchState                     — sketch lifecycle
  make_hvp / extract_columns / PyTreeIndexer     — HVP substrate
"""
from repro_torch.core.backend import (BACKENDS, CudaBackend, FlatBackend,
                                      TreeBackend, flatten_sketch,
                                      flatten_vec, flatten_vecm, get_backend,
                                      unflatten_vec, unflatten_vecm)
from repro_torch.core.bilevel import BilevelState, BilevelTrainer
from repro_torch.core.hvp import extract_columns, make_hvp
from repro_torch.core.hypergrad import HypergradConfig, hypergradient
from repro_torch.core.implicit import implicit_root, phi_vjp_block
from repro_torch.core.problem import (PROBLEMS, BilevelProblem,
                                      BilevelResult, accounted_hvps,
                                      get_problem, hypergrad_at,
                                      hypergrad_error, hypergrad_reference,
                                      register_problem, solve)
from repro_torch.core.solvers import (SOLVERS, DenseFactor, ExactIHVP,
                                      NystromIHVP, NystromSketch,
                                      SketchPolicy, SketchState, SolverSpec,
                                      build_hvp_bill, query_width)
from repro_torch.core.tree_util import (PyTreeIndexer, tree_flatten,
                                        tree_leaves, tree_map, tree_norm,
                                        tree_size, tree_vdot)

__all__ = [
    'BACKENDS', 'BilevelProblem', 'BilevelResult', 'BilevelState',
    'BilevelTrainer', 'CudaBackend', 'DenseFactor', 'ExactIHVP',
    'FlatBackend', 'HypergradConfig', 'NystromIHVP', 'NystromSketch',
    'PROBLEMS', 'PyTreeIndexer', 'SOLVERS', 'SketchPolicy', 'SketchState',
    'SolverSpec', 'TreeBackend', 'accounted_hvps', 'build_hvp_bill',
    'extract_columns', 'flatten_sketch', 'flatten_vec', 'flatten_vecm',
    'get_backend', 'get_problem', 'hypergrad_at', 'hypergrad_error',
    'hypergrad_reference', 'hypergradient', 'implicit_root', 'make_hvp',
    'phi_vjp_block', 'query_width', 'register_problem',
    'solve', 'tree_flatten', 'tree_leaves', 'tree_map', 'tree_norm',
    'tree_size', 'tree_vdot', 'unflatten_vec',
    'unflatten_vecm',
]
