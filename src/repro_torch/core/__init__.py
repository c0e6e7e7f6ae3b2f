"""Core subgraph-enumeration library, in PyTorch (a port of ``repro.core``).

Layers:
  graph      — host graph + packed-bitmap representations (numpy)
  ordering   — RI GreatestConstraintFirst ordering (+ SI tie-break)
  domains    — RI-DS domains, numpy oracle: init, arc consistency, FC
  plan       — SearchPlan: static arrays for the engine
  frontier   — ring-buffer worker stacks: state + pop/push ops
  extend     — the expansion step (plain PyTorch, or the CUDA kernels)
  scheduler  — steal-round policy
  engine     — the round loop and steal rounds
  ref        — sequential oracle
  session    — prepared-query session API (SubgraphIndex / Query /
               Enumerator / MatchSet)
  api        — enumerate_subgraphs() one-shot wrapper
"""

from repro_torch.core.api import EnumerationResult, enumerate_subgraphs
from repro_torch.core.engine import EngineConfig, EngineResult
from repro_torch.core.graph import Graph, PackedGraph
from repro_torch.core.plan import SearchPlan, VARIANTS, build_plan
from repro_torch.core.session import (
    Enumerator,
    MatchSet,
    Query,
    SHAPE_BUCKETS,
    SubgraphIndex,
    prepare_query,
    snap_p_pad,
)

__all__ = [
    "EnumerationResult",
    "enumerate_subgraphs",
    "EngineConfig",
    "EngineResult",
    "Enumerator",
    "Graph",
    "MatchSet",
    "PackedGraph",
    "Query",
    "SHAPE_BUCKETS",
    "SearchPlan",
    "SubgraphIndex",
    "VARIANTS",
    "build_plan",
    "prepare_query",
    "snap_p_pad",
]
