"""Core subgraph-enumeration library, in PyTorch (a port of ``repro.core``).

Layers:
  graph      — host graph, packed-bitmap and CSR-plane representations (numpy)
  ordering   — RI GreatestConstraintFirst ordering (+ SI tie-break)
  domains    — RI-DS domains: numpy oracle (init, arc consistency, FC)
               and the device AC ⇄ FC fixpoint, over dense planes or CSR
  plan       — SearchPlan: static arrays for the engine
  delta      — dynamic-graph delta algebra: GraphDelta edit sets,
               edge-anchored seeding, match invalidation / dedup,
               DeltaMatchSet
  frontier   — ring-buffer worker stacks: state + pop/push ops
  extend     — the expansion step (plain PyTorch, or the CUDA kernels;
               dense bitmaps or the sparse CSR walk)
  scheduler  — steal-round policy and LPT pack balancing
  engine     — the round loop and steal rounds, over a pack of queries
  ref        — sequential oracle
  session    — prepared-query session API (SubgraphIndex / Query /
               Enumerator / MatchSet), batched preparation and packs
  api        — enumerate_subgraphs() one-shot wrapper
  multi      — enumerate_many() and run_batch() over raw plans
"""

from repro_torch.core.api import EnumerationResult, enumerate_subgraphs
from repro_torch.core.delta import DeltaMatchSet, GraphDelta
from repro_torch.core.domains import (
    DomainResult,
    compute_domains_batch,
    compute_domains_csr,
    compute_domains_device,
    compute_domains_sparse,
)
from repro_torch.core.engine import EngineConfig, EngineResult
from repro_torch.core.graph import CsrPlanes, CsrPlaneSet, Graph, PackedGraph
from repro_torch.core.plan import SearchPlan, VARIANTS, build_csr_plan, build_plan
from repro_torch.core.multi import QueryResult, enumerate_many
from repro_torch.core.scheduler import balance_assignment, imbalance
from repro_torch.core.session import (
    Enumerator,
    MatchSet,
    Query,
    SHAPE_BUCKETS,
    SubgraphIndex,
    prepare_query,
    snap_arc_pad,
    snap_batch_pad,
    snap_loop_pad,
    snap_p_pad,
)

__all__ = [
    "CsrPlaneSet",
    "CsrPlanes",
    "DeltaMatchSet",
    "DomainResult",
    "EnumerationResult",
    "enumerate_subgraphs",
    "EngineConfig",
    "EngineResult",
    "Enumerator",
    "Graph",
    "GraphDelta",
    "MatchSet",
    "PackedGraph",
    "Query",
    "QueryResult",
    "SHAPE_BUCKETS",
    "SearchPlan",
    "SubgraphIndex",
    "VARIANTS",
    "balance_assignment",
    "build_csr_plan",
    "build_plan",
    "compute_domains_batch",
    "compute_domains_csr",
    "compute_domains_device",
    "compute_domains_sparse",
    "enumerate_many",
    "imbalance",
    "prepare_query",
    "snap_arc_pad",
    "snap_batch_pad",
    "snap_loop_pad",
    "snap_p_pad",
]
