"""PyTorch / CUDA port of the subgraph-enumeration system in ``repro``.

The engine runs on an NVIDIA card (Hopper, ``sm_90a``) with hand-written
CUDA kernels in place of the JAX package's Pallas TPU kernels
(`repro_torch.kernels`).  Entry points run on the card unless the caller
passes ``device="cpu"``.  This package imports neither JAX nor ``repro``.
"""

from repro_torch.core import (  # noqa: F401
    VARIANTS,
    EngineConfig,
    EngineResult,
    EnumerationResult,
    Enumerator,
    Graph,
    MatchSet,
    PackedGraph,
    Query,
    SearchPlan,
    SubgraphIndex,
    build_plan,
    enumerate_subgraphs,
)
