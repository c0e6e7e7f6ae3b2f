"""Mixture-of-Experts layer: top-k routing with group-local sort dispatch (a
port of ``repro.models.moe``).

The function is ``repro``'s: routing in fp32, the top-``k`` weights
renormalised and cast to ``x``'s dtype, tokens split into :func:`n_groups`
contiguous groups of ``T // G``, each with its own per-expert capacity
:func:`capacity`; within a group a stable sort of the (token, k) pairs by
expert, token-major and k-minor, so that an expert that overflows keeps its
first ``C`` pairs in that order and drops the rest; the SwiGLU expert FFN;
the combine weighted by the top-``k`` weights.

``repro`` scatters the kept pairs into a dense ``[G, E, C, D]`` capacity
buffer (``C`` rounded up to ``capacity_round``) and runs the expert
products over all of it; at kimi-k2's width and a 4,096-token prefill that
buffer is 11.3 GB, 24× padding over its 32,768 real rows.  The port runs
the same products over the kept pairs only (:func:`dispatch`): sorted
expert-major, one product per expert that has rows.  A row's result does
not depend on the rows beside it, so the kept rows come out as
``repro``'s.  The combine inverts the sort by a gather (each token has
exactly ``k`` pairs, a dropped one reads a zero row) and adds a token's
weighted rows one by one in ascending expert order, in ``x``'s dtype:
the order in which ``repro``'s scatter-add visits them.  No atomics, so a
run on the card is deterministic.  Counting the rows per expert reads one
small tensor back to the host per call.

``repro``'s sharding hints (``constraint``) have no meaning on one card and
are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    capacity_round: int = 64  # round per-group capacity for shardability
    dispatch_groups: int = 32  # data-shard-aligned dispatch groups (pod×data)
    router_dtype: str = "float32"


def n_groups(cfg: MoEConfig, n_tokens: int) -> int:
    g = cfg.dispatch_groups
    while g > 1 and n_tokens % g:
        g //= 2
    return max(g, 1)


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Per-group expert capacity for ``n_tokens`` *per group*."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    r = cfg.capacity_round
    return max(r, ((c + r - 1) // r) * r)


class Dispatch(NamedTuple):
    """The kept (token, k) pairs of one call, expert-major.

    ``pairs``: flat pair ids ``token · k + j`` of the kept pairs, grouped by
    expert (ascending), within an expert by group and then in the group's
    sort order; ``counts``: kept pairs per expert ``[E]``; ``routed``: pairs
    routed to each expert in each group before the capacity cut ``[G, E]``;
    ``capacity``: ``C``, the per-group capacity."""

    pairs: torch.Tensor
    counts: torch.Tensor
    routed: torch.Tensor
    capacity: int


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """fp32 router logits ``[T, E]`` and the top-``k`` weights (renormalised,
    fp32) and experts ``[T, K]``, highest first; equal probabilities go to
    the lower expert first, as ``lax.top_k`` orders them."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.top_k], top_e[:, :cfg.top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, top_w, top_e


def dispatch(top_e: torch.Tensor, cfg: MoEConfig) -> Dispatch:
    """Group-local sort dispatch of ``top_e`` ``[T, K]`` (``repro``'s
    ``_dispatch_one_group`` over every group at once), compacted to the
    kept pairs."""
    t, k = top_e.shape
    e = cfg.n_experts
    g = n_groups(cfg, t)
    c = capacity(cfg, t // g)
    eg = top_e.reshape(g, -1)  # token-major, k-minor within each group
    order = torch.argsort(eg, dim=1, stable=True)
    e_sorted = eg.gather(1, order)
    routed = torch.zeros(g, e, dtype=torch.long, device=top_e.device)
    routed.scatter_add_(1, eg, torch.ones_like(eg))
    starts = routed.cumsum(1) - routed
    pos = torch.arange(eg.shape[1], device=top_e.device) - starts.gather(1, e_sorted)
    keep = pos < c
    pair = order + torch.arange(g, device=top_e.device)[:, None] * eg.shape[1]
    kept_e = e_sorted[keep]  # group-major, each group by expert
    by_expert = torch.argsort(kept_e, stable=True)
    return Dispatch(pairs=pair[keep][by_expert], counts=torch.bincount(kept_e, minlength=e),
                    routed=routed, capacity=c)


def moe_ffn(
    x: torch.Tensor,  # [T, D] flattened tokens
    router_w: torch.Tensor,  # [D, E]
    w_gate: torch.Tensor,  # [E, D, F]
    w_up: torch.Tensor,  # [E, D, F]
    w_down: torch.Tensor,  # [E, F, D]
    cfg: MoEConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [T, D] in x's dtype, aux load-balance loss, fp32).

    Each expert's weights are cast to ``x``'s dtype as it is used, so an
    fp32 ``x`` runs the whole layer in fp32 over bf16 weights."""
    t, d = x.shape
    k = cfg.top_k
    logits, top_w, top_e = route(x, router_w, cfg)
    aux = aux_load_balance_loss(logits, top_e, cfg.n_experts)
    disp = dispatch(top_e, cfg)

    # ---- expert FFN over the kept rows, one product per expert with rows ----
    rows = x[disp.pairs // k]
    out_rows = torch.zeros(rows.shape[0] + 1, d, dtype=x.dtype, device=x.device)
    start = 0
    for ei, n in enumerate(disp.counts.tolist()):
        if n:
            xe = rows[start:start + n]
            hidden = F.silu(xe @ w_gate[ei].to(x.dtype)) * (xe @ w_up[ei].to(x.dtype))
            out_rows[start:start + n] = hidden @ w_down[ei].to(x.dtype)
            start += n

    # ---- combine: invert the sort (a dropped pair reads the zero last row),
    # then add each token's k weighted rows in ascending expert order ------
    inv = torch.full((t * k,), rows.shape[0], dtype=torch.long, device=x.device)
    inv[disp.pairs] = torch.arange(rows.shape[0], device=x.device)
    by_e = top_e.argsort(dim=1)
    inv = inv.view(t, k).gather(1, by_e)
    w = top_w.to(x.dtype).gather(1, by_e)
    out = torch.zeros(t, d, dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + out_rows[inv[:, j]] * w[:, j, None]
    return out, aux


def aux_load_balance_loss(router_logits: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean fraction × mean prob)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e[:, 0], n_experts).float().mean(dim=0)
    return n_experts * (me * ce).sum()
