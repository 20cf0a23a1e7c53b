"""repro_torch.engine — multi-level optimization over a problem dependency
graph (the port of ``repro.engine``; the step runs eagerly).

Public API:
  ProblemNode / ProblemEdge / ProblemGraph  — typed DAG of optimization
                                              problems (validate / topo_order)
  from_bilevel                              — wrap a BilevelProblem as a graph
  Engine / EngineConfig / EngineResult      — lower a chain and drive it
  engine_hypergrad / _reference             — top hypergradient at a point +
                                              dense multi-level oracle
  engine_edge_bills                         — analytic per-edge HVP bills
  GRAPHS / register_graph / get_graph       — registered trilevel problems
                                              (distill_hpo, reweight_maml)
"""
from repro_torch.engine.engine import (Engine, EngineConfig, EngineProgram,
                                       EngineResult, build_maps,
                                       engine_edge_bills, engine_hypergrad,
                                       engine_hypergrad_reference)
from repro_torch.engine.graph import (GraphError, ProblemEdge, ProblemGraph,
                                      ProblemNode, from_bilevel)
from repro_torch.engine.problems import (GRAPHS, distill_hpo, get_graph,
                                         register_graph, reweight_maml)

__all__ = [
    'Engine', 'EngineConfig', 'EngineProgram', 'EngineResult',
    'GRAPHS', 'GraphError', 'ProblemEdge', 'ProblemGraph', 'ProblemNode',
    'build_maps', 'distill_hpo', 'engine_edge_bills', 'engine_hypergrad',
    'engine_hypergrad_reference', 'from_bilevel', 'get_graph',
    'register_graph', 'reweight_maml',
]
