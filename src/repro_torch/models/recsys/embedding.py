"""Sparse embedding substrate: lookup and embedding-bag from ``index_select``
and segment sums (a port of ``repro.models.recsys.embedding``).

The gradient of a lookup is dense, ``[n_rows, dim]``, as ``jnp.take``'s is:
AdamW then decays and moves every row of the table, as in ``repro`` (a
sparse gradient would leave untouched rows alone and give another result).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import ParamSpec
from repro_torch.models.gnn.common import segment_sum


def table_spec(n_rows: int, dim: int, name: str = "table") -> ParamSpec:
    # rows over tensor (model) axis: the canonical row-wise table sharding
    return ParamSpec((n_rows, dim), ("tensor", None), torch.float32, scale=0.01)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain embedding lookup; ids any shape (negative ids read row 0),
    output ids.shape + [dim]."""
    rows = table.index_select(0, ids.clamp_min(0).reshape(-1))
    return rows.reshape(tuple(ids.shape) + (table.shape[1],))


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,  # [n_ids] flat multi-hot indices
    bag_ids: torch.Tensor,  # [n_ids] which bag each id belongs to
    n_bags: int,
    mode: str = "sum",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EmbeddingBag: ragged gather + segment reduce.

    ``ids < 0`` are padding and contribute nothing.
    """
    rows = lookup(table, ids)
    valid = (ids >= 0).to(rows.dtype)[:, None]
    if weights is not None:
        valid = valid * weights[:, None]
    rows = rows * valid
    out = segment_sum(rows, bag_ids, n_bags)
    if mode == "mean":
        cnt = segment_sum(valid[:, 0], bag_ids, n_bags)
        out = out / cnt.clamp_min(1.0)[:, None]
    elif mode != "sum":
        raise ValueError(mode)
    return out
