"""Public one-shot API for the subgraph-enumeration core.

    from repro_torch.core import enumerate_subgraphs
    res = enumerate_subgraphs(pattern, target, variant="ri-ds-si-fc",
                              n_workers=16)          # on the CUDA card
    print(res.matches, res.states)

A wrapper over the prepared-query session API (`repro_torch.core.session`):
each call builds a throwaway :class:`~repro_torch.core.session.SubgraphIndex`
and runs one query through a process-wide
:class:`~repro_torch.core.session.Enumerator` for the engine config and
device.  For many queries against one target, use the session API directly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

from repro_torch.core.engine import EngineConfig, EngineResult
from repro_torch.core.graph import Graph, PackedGraph
from repro_torch.core.plan import SearchPlan
from repro_torch.core.session import SubgraphIndex, shared_enumerator


@dataclasses.dataclass
class EnumerationResult:
    matches: int
    states: int
    steps: int
    steals: int
    steal_rounds: int
    mean_steal_depth: float
    preprocess_s: float
    match_s: float
    engine: EngineResult
    plan: SearchPlan

    @property
    def total_s(self) -> float:
        return self.preprocess_s + self.match_s


def enumerate_subgraphs(
    pattern: Graph,
    target: Union[Graph, PackedGraph],
    variant: str = "ri-ds-si-fc",
    config: Optional[EngineConfig] = None,
    device=None,
    **config_kwargs,
) -> EnumerationResult:
    """Enumerate all non-induced subgraphs of ``target`` isomorphic to
    ``pattern``.

    Args:
      pattern: the (small) pattern graph.
      target: the target graph, or its :class:`PackedGraph`.
      variant: ``ri`` | ``ri-ds`` | ``ri-ds-si`` | ``ri-ds-si-fc`` |
        ``ri-ds-si-acfc``.
      config: engine configuration; keyword overrides accepted.
      device: where the engine runs; ``None`` is the CUDA card (raises
        without one — pass ``device="cpu"`` to run on the CPU).
    """
    cfg = config or EngineConfig(**config_kwargs)
    if config is not None and config_kwargs:
        cfg = dataclasses.replace(config, **config_kwargs)

    t0 = time.perf_counter()
    session = shared_enumerator(cfg, device)
    index = SubgraphIndex.build(target)
    query = session.prepare(pattern, variant=variant, index=index)
    t1 = time.perf_counter()

    ms = session.run(query)
    return EnumerationResult(
        matches=ms.matches,
        states=ms.states,
        steps=ms.steps,
        steals=ms.steals,
        steal_rounds=ms.steal_rounds,
        mean_steal_depth=ms.mean_steal_depth,
        preprocess_s=t1 - t0,
        match_s=ms.match_s,
        engine=ms.engine,
        plan=ms.plan,
    )
