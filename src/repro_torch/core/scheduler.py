"""Work-stealing rebalance policy — the array form of the paper's
receiver-initiated private-deque stealing.  A port of
``repro.core.scheduler``: the device policy, batched over any leading axes
(the engine plans every query of a pack at once, each within its own
workers), and the host LPT balancer that assigns queries to packs.

Every worker's plan is a pure function of the stack-occupancy vector:

  * donors: workers with more than ``keep_min`` entries donate up to
    ``steal_chunk`` entries from the **bottom** of their stacks (near-root,
    so large subtrees — the paper's steal-from-the-back heuristic).
  * receivers: workers with empty stacks (receiver-initiated).
  * matching: donated slots are compacted to a global sequence and dealt
    round-robin to receivers — slot ``s`` goes to receiver-rank
    ``s mod n_recv`` at intake position ``s div n_recv``; intake is capped
    so a donor's accepted slots are always a prefix of its donation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StealPolicy:
    steal_chunk: int = 4  # entries donated per donor per round (the paper's
    # task-group size; group size 4 was the paper's best — Fig. 4)
    keep_min: int = 2  # donors never drop below this many entries
    recv_cap: int = 4  # max entries a receiver accepts per round


def plan_steals(
    sizes: torch.Tensor, policy: StealPolicy
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute the global steal plan from the stack-occupancy vector.

    Args:
      sizes: ``[..., V]`` int32 per-worker stack sizes; each row along the
        leading axes is planned on its own.
      policy: steal policy constants.

    Returns:
      donate:     ``[..., V]`` int32 — entries each donor offers (bottom of
                  stack).
      accepted:   ``[..., V]`` int32 — entries actually taken from each donor
                  (always a prefix of its offer).
      dest_rank:  ``[..., V, steal_chunk]`` int32 — receiver *rank* for each
                  donated slot, ``-1`` if the slot is not accepted.
      dest_pos:   ``[..., V, steal_chunk]`` int32 — intake position at the
                  receiver.
    """
    v = sizes.shape[-1]
    c = policy.steal_chunk
    donate = torch.where(
        sizes > policy.keep_min, (sizes - policy.keep_min).clamp(max=c), 0
    ).to(torch.int32)
    n_recv = (sizes == 0).sum(dim=-1, keepdim=True, dtype=torch.int32)[..., None]

    # global valid-slot index, donor-major, so per-donor slots stay
    # contiguous and acceptance-by-threshold keeps a donor's slots a prefix
    slot_j = torch.arange(c, dtype=torch.int32, device=sizes.device).expand(
        sizes.shape + (c,))
    valid = slot_j < donate[..., None]
    start = torch.cumsum(donate, dim=-1).to(torch.int32) - donate  # exclusive prefix sum
    gidx = start[..., None] + slot_j
    accepted_slot = valid & (gidx < n_recv * policy.recv_cap)

    safe_recv = n_recv.clamp_min(1)
    dest_rank = torch.where(accepted_slot, gidx % safe_recv, -1).to(torch.int32)
    dest_pos = torch.where(accepted_slot, gidx // safe_recv, 0).to(torch.int32)
    accepted = accepted_slot.sum(dim=-1, dtype=torch.int32)
    return donate, accepted, dest_rank, dest_pos


def receiver_workers(sizes: torch.Tensor) -> torch.Tensor:
    """``[..., V]`` worker index per receiver rank (padded with ``-1``)."""
    v = sizes.shape[-1]
    hungry = sizes == 0
    rrank = torch.cumsum(hungry.to(torch.int32), dim=-1) - 1
    wor = torch.full(sizes.shape[:-1] + (v + 1,), -1, dtype=torch.int32,
                     device=sizes.device)
    # non-receivers write into the spare last slot, which is cut off
    wor.scatter_(-1, torch.where(hungry, rrank, v).long(),
                 torch.arange(v, dtype=torch.int32, device=sizes.device).expand(sizes.shape))
    return wor[..., :v]


# ---------------------------------------------------------------------------
# Host-side (numpy): static balanced assignment of weighted items — the
# session's LPT pack balancing.
# ---------------------------------------------------------------------------

def balance_assignment(weights: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy longest-processing-time assignment of weighted items to shards.

    Returns ``[len(weights)]`` shard ids.  LPT is a 4/3-approximation of
    makespan — adequate for batch balancing; the *dynamic* balancer (the
    engine's steal rounds) covers residual skew at runtime.
    """
    weights = np.asarray(weights, dtype=np.float64)
    order = np.argsort(-weights, kind="stable")
    load = np.zeros(n_shards, dtype=np.float64)
    out = np.zeros(len(weights), dtype=np.int32)
    for i in order:
        s = int(np.argmin(load))
        out[i] = s
        load[s] += weights[i]
    return out


def imbalance(weights: np.ndarray, assignment: np.ndarray, n_shards: int) -> float:
    """max/mean shard load — 1.0 is perfect balance."""
    load = np.bincount(assignment, weights=weights, minlength=n_shards)
    mean = load.mean()
    return float(load.max() / mean) if mean > 0 else 1.0
