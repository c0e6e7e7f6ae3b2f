"""Multi-query helpers over the session: a port of ``repro.core.multi``.

The LPT pack balancing and pack execution live in
:class:`repro_torch.core.session.Enumerator` (``run_batch`` / ``stream``).
:func:`enumerate_many` keeps ``repro``'s signature and returns exactly one
result per input pattern, in input order; :func:`run_batch` runs a pack of
plans the caller stacked itself and returns the pack's final
:class:`~repro_torch.core.frontier.EngineState`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core import engine as eng
from repro_torch.core.engine import EngineConfig
from repro_torch.core.extend import plan_arrays_for
from repro_torch.core.frontier import EngineState, init_state, stack_states
from repro_torch.core.graph import Graph
from repro_torch.core.plan import SearchPlan
from repro_torch.core.session import Enumerator, SubgraphIndex


@dataclasses.dataclass
class QueryResult:
    name: str
    matches: int
    states: int
    steps: int


def run_batch(plans: Sequence[SearchPlan], cfg: EngineConfig, device=None) -> EngineState:
    """Run a pack of same-shaped plans of one target on ``device`` (default:
    the CUDA card); returns the pack's final state, lane ``l`` for
    ``plans[l]`` (:func:`~repro_torch.core.engine.result_from_state` reads
    one lane).  Prefer :meth:`Enumerator.run_batch`, which adds LPT
    balancing and key grouping."""
    device = eng.resolve_device(device)
    arrays = plan_arrays_for(cfg, plans, device)
    states = stack_states([init_state(p, cfg, device) for p in plans])
    return eng._engine_loop(cfg, arrays, states)


def enumerate_many(
    patterns: Sequence[Graph],
    target: Graph,
    variant: str = "ri-ds-si-fc",
    cfg: Optional[EngineConfig] = None,
    pack_size: int = 4,
    names: Optional[Sequence[str]] = None,
    device=None,
) -> List[QueryResult]:
    """Enumerate every pattern against ``target`` in LPT-balanced packs on
    ``device`` (default: the CUDA card).

    A wrapper over :meth:`Enumerator.run_batch`; returns one
    :class:`QueryResult` per pattern, aligned with the input order."""
    cfg = cfg or EngineConfig(n_workers=8, expand_width=4)
    names = list(names or [f"q{i}" for i in range(len(patterns))])
    if len(names) != len(patterns):
        raise ValueError(
            f"names has {len(names)} entries for {len(patterns)} patterns"
        )
    session = Enumerator(SubgraphIndex.build(target), config=cfg, variant=variant,
                         device=device)
    queries = [session.prepare(p, name=n) for p, n in zip(patterns, names)]
    results = session.run_batch(queries, pack_size=pack_size)
    return [
        QueryResult(name=ms.name, matches=ms.matches, states=ms.states, steps=ms.steps)
        for ms in results
    ]
