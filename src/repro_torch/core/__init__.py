"""repro_torch.core — the Nyström implicit differentiation, in PyTorch.

  BilevelProblem / solve / PROBLEMS              — typed problem API
    (vmap_tasks= / shared_sketch= meta path)
  BatchSource                                    — the data protocol
  InfluenceProblem / influence / InfluenceResult — influence scores, one
    make_topk_scanner / train_influence_params     sketch, streamed top-k
  hypergrad_at / hypergrad_reference /           — per-point hypergradient +
    hypergrad_error                                exact-IHVP oracle
  implicit_root / phi_vjp_block                  — differentiable θ*(φ) map
                                                   (+ m-query cotangent block)
  sgd_solver                                     — the canonical inner solver
  tangent_apply                                  — the solve as a linear op
  NystromIHVP / CGIHVP / NeumannIHVP / ExactIHVP — IHVP solvers
  nystrom_inverse_dense                          — dense Nyström oracle
  state_nbytes / solver_fingerprint /            — state size, identity
    state_template                                 and unfilled layout
  hypergradient / unrolled_hypergradient         — Eq. 3 assembly + the
                                                   unrolled oracle
  config_from_cli                                — CLI flags → config
  BilevelTrainer / BilevelState                  — warm-start bilevel loop
  SketchPolicy / SketchState                     — sketch lifecycle
  make_hvp / extract_columns / PyTreeIndexer     — HVP substrate
  gauss_newton_hvp / hessian_diagonal_estimate   — curvature helpers
"""
from repro_torch.core.backend import (BACKENDS, CudaBackend, FlatBackend,
                                      TreeBackend, flatten_sketch,
                                      flatten_vec, flatten_vecm, get_backend,
                                      unflatten_vec, unflatten_vecm)
from repro_torch.core.bilevel import BilevelState, BilevelTrainer
from repro_torch.core.hvp import (extract_columns, gauss_newton_hvp,
                                  hessian_diagonal_estimate, make_hvp)
from repro_torch.core.hypergrad import (HypergradConfig, config_from_cli,
                                        hypergradient, unrolled_hypergradient)
from repro_torch.core.implicit import (implicit_root, phi_vjp_block,
                                       sgd_solver)
from repro_torch.core.problem import (PROBLEMS, BatchSource, BilevelProblem,
                                      BilevelResult, InfluenceProblem,
                                      InfluenceResult, accounted_hvps,
                                      get_problem, hypergrad_at,
                                      hypergrad_error, hypergrad_reference,
                                      influence, influence_build_hvps,
                                      influence_curvature_hvp,
                                      make_topk_scanner, register_problem,
                                      solve, train_influence_params)
from repro_torch.core.solvers import (SOLVERS, CGIHVP, DenseFactor,
                                      ExactIHVP, IterativeOperator,
                                      NeumannIHVP, NystromIHVP, NystromSketch,
                                      SketchPolicy, SketchState, SolverSpec,
                                      build_hvp_bill, nystrom_inverse_dense,
                                      query_width, solver_fingerprint,
                                      state_nbytes, state_template,
                                      tangent_apply)
from repro_torch.core.tree_util import (PyTreeIndexer, tree_flatten,
                                        tree_flatten_with_path, tree_leaves,
                                        tree_map, tree_norm, tree_size,
                                        tree_vdot)

__all__ = [
    'BACKENDS', 'BatchSource', 'BilevelProblem', 'BilevelResult',
    'BilevelState', 'BilevelTrainer', 'CGIHVP', 'CudaBackend', 'DenseFactor', 'ExactIHVP',
    'FlatBackend', 'HypergradConfig', 'InfluenceProblem',
    'InfluenceResult', 'IterativeOperator', 'NeumannIHVP',
    'NystromIHVP', 'NystromSketch', 'PROBLEMS', 'PyTreeIndexer', 'SOLVERS',
    'SketchPolicy', 'SketchState', 'SolverSpec', 'TreeBackend',
    'accounted_hvps', 'build_hvp_bill', 'config_from_cli',
    'extract_columns', 'flatten_sketch', 'flatten_vec', 'flatten_vecm',
    'gauss_newton_hvp', 'get_backend', 'get_problem',
    'hessian_diagonal_estimate', 'hypergrad_at', 'hypergrad_error',
    'hypergrad_reference', 'hypergradient', 'implicit_root', 'influence',
    'influence_build_hvps', 'influence_curvature_hvp', 'make_hvp',
    'make_topk_scanner', 'nystrom_inverse_dense', 'phi_vjp_block',
    'query_width',
    'register_problem', 'sgd_solver', 'solve', 'solver_fingerprint',
    'state_nbytes', 'state_template', 'tangent_apply',
    'train_influence_params', 'tree_flatten', 'tree_flatten_with_path',
    'tree_leaves', 'tree_map', 'tree_norm', 'tree_size', 'tree_vdot',
    'unflatten_vec', 'unflatten_vecm', 'unrolled_hypergradient',
]
