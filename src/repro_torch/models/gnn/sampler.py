"""Neighbor sampling for minibatch GNN training (GraphSAGE-style), plus the
paper-derived bucket balancer for skewed batched graphs: a copy of
``repro.models.gnn.sampler`` (numpy; the same seed gives the same blocks).

``NeighborSampler`` is a real host-side (numpy) fanout sampler over CSR
adjacency: per minibatch it samples up to ``fanout[k]`` neighbors per
frontier node per hop, relabels the union subgraph to contiguous local ids,
and emits fixed-shape (padded) arrays, so every minibatch of a run has the
same shapes.

``balance_buckets`` spreads variable-size graphs/subgraphs across shards
with the scheduler's LPT policy — the work-stealing insight applied to
irregular minibatches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler import balance_assignment


@dataclasses.dataclass
class SampledBlock:
    """Padded union subgraph for one minibatch."""

    feats_idx: np.ndarray  # [n_pad] global node id per local node (-1 pad)
    src: np.ndarray  # [e_pad] local ids (pad edges point at node 0 w/ weight 0 — masked by label)
    dst: np.ndarray  # [e_pad]
    labels: np.ndarray  # [n_pad]; only seed rows carry labels, rest -1
    n_nodes: int
    n_edges: int


def block_shape(batch_nodes: int, fanout: Sequence[int]) -> Tuple[int, int]:
    """Worst-case (n_pad, e_pad) for a fanout-sampled block."""
    n = batch_nodes
    n_pad = batch_nodes
    e_pad = 0
    frontier = batch_nodes
    for f in fanout:
        e_pad += frontier * f
        frontier = frontier * f
        n_pad += frontier
    return n_pad, e_pad


class NeighborSampler:
    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        labels: np.ndarray,
        fanout: Sequence[int],
        seed: int = 0,
    ):
        self.indptr = indptr
        self.indices = indices
        self.labels = labels
        self.fanout = tuple(fanout)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        n_pad, e_pad = block_shape(len(seeds), self.fanout)
        local = {int(s): i for i, s in enumerate(seeds)}
        order: List[int] = [int(s) for s in seeds]
        src_l: List[int] = []
        dst_l: List[int] = []
        frontier = list(seeds)
        for f in self.fanout:
            nxt: List[int] = []
            for u in frontier:
                s, e = int(self.indptr[u]), int(self.indptr[u + 1])
                deg = e - s
                if deg == 0:
                    continue
                take = min(f, deg)
                picks = self.rng.choice(deg, size=take, replace=False) + s
                for p in picks:
                    v = int(self.indices[p])
                    if v not in local:
                        local[v] = len(order)
                        order.append(v)
                        nxt.append(v)
                    # message flows neighbor -> node
                    src_l.append(local[v])
                    dst_l.append(local[u])
            frontier = nxt

        n, m = len(order), len(src_l)
        feats_idx = np.full(n_pad, -1, np.int64)
        feats_idx[:n] = order
        src = np.zeros(e_pad, np.int32)
        dst = np.zeros(e_pad, np.int32)
        src[:m] = src_l
        dst[:m] = dst_l
        # padding edges become self-loops on a dummy last node so they do not
        # perturb real aggregations
        if m < e_pad and n < n_pad:
            src[m:] = n_pad - 1
            dst[m:] = n_pad - 1
        labels = np.full(n_pad, -1, np.int64)
        labels[: len(seeds)] = self.labels[np.asarray(seeds, np.int64)]
        return SampledBlock(
            feats_idx=feats_idx, src=src, dst=dst, labels=labels, n_nodes=n, n_edges=m
        )


def balance_buckets(sizes: Sequence[int], n_shards: int) -> np.ndarray:
    """Assign variable-size graphs to shards, minimizing makespan (LPT)."""
    return balance_assignment(np.asarray(sizes, np.float64), n_shards)
