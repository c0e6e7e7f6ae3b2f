"""GNN substrate: message passing over edge lists (a port of
``repro.models.gnn.common``).

Source-node features are gathered along the edge list (``index_select``),
transformed, and reduced into destinations: sums with ``index_add`` (on the
card an atomic fp32 add, so a sum's last bits vary from run to run), maxima
with ``scatter_reduce(..., "amax")`` into ``-inf``, so an empty segment is
``-inf`` as ``jax.ops.segment_max`` gives it and tied maxima share their
gradient equally.  ``repro``'s edge-sharding hints mean nothing on one card
and are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.models.common import ParamSpec, dot


@dataclasses.dataclass(frozen=True)
class GraphShape:
    """Static shape of a (possibly batched) graph input."""

    n_nodes: int
    n_edges: int
    d_feat: int
    n_graphs: int = 1  # > 1 for batched small graphs (molecule shape)
    d_edge_feat: int = 0
    with_positions: bool = False


class _SegmentSum(torch.autograd.Function):
    """``index_add`` into zeros whose backward gathers the gradient by the
    ids and keeps only them: autograd's own ``index_add`` keeps its source
    for the backward, an [E, d] message per layer (graphsage-reddit's two on
    ogb_products are 56 GB)."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
        return out.index_add_(0, segment_ids, data)

    @staticmethod
    def backward(ctx, grad):
        (segment_ids,) = ctx.saved_tensors
        return grad.index_select(0, segment_ids), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows of ``data`` summed into ``num_segments`` rows by ``segment_ids``."""
    return _SegmentSum.apply(data, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments):
    s = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
    cnt = segment_sum(ones, segment_ids, num_segments)
    return s / cnt.clamp_min(1.0)[:, None]


def segment_max(data, segment_ids, num_segments):
    """Segment maxima; an empty segment is ``-inf``."""
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    init = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    return init.scatter_reduce(0, idx, data, "amax", include_self=True)


AGGREGATORS: Dict[str, Callable] = {"sum": segment_sum, "mean": segment_mean,
                                    "max": segment_max}


def gather_src(h: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Edge-wise gather of source-node features."""
    return h.index_select(0, src)


def sym_norm_weights(src: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """GCN symmetric normalization 1/sqrt((deg(u)+1)(deg(v)+1)) per edge
    (self-loops folded into the +1)."""
    ones = torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
    deg = segment_sum(ones, dst, n_nodes) + 1.0
    return torch.rsqrt(deg.index_select(0, src)) * torch.rsqrt(deg.index_select(0, dst))


def mlp_specs(dims: Sequence[int], prefix: str,
              dtype: torch.dtype = torch.float32) -> Dict[str, ParamSpec]:
    """Param specs for a plain MLP ``dims[0] -> ... -> dims[-1]``."""
    out: Dict[str, ParamSpec] = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}_w{i}"] = ParamSpec(
            (dims[i], dims[i + 1]), (None, "tensor" if i == 0 else None), dtype
        )
        out[f"{prefix}_b{i}"] = ParamSpec((dims[i + 1],), (None,), dtype, init="zeros")
    return out


def mlp_apply(params: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
              n_layers: int, act=torch.relu, final_act: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = dot(x, params[f"{prefix}_w{i}"]) + params[f"{prefix}_b{i}"]
        if i < n_layers - 1 or final_act:
            x = act(x)
    return x


def masked_softmax_ce(logits: torch.Tensor,
                      labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy over nodes; ``labels < 0`` masked out.  Returns (the
    mean over labelled nodes, their count)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.clamp_min(0).long()[:, None])[:, 0]
    mask = (labels >= 0).float()
    count = mask.sum()
    return ((logz - gold) * mask).sum() / count.clamp_min(1.0), count
