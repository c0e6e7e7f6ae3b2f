"""GCN (Kipf & Welling) with symmetric normalization (a port of
``repro.models.gnn.gcn``).

``H' = act( Â H W )`` with ``Â = D^{-1/2}(A + I)D^{-1/2}`` realized as
edge-gather → per-edge norm weight → segment-sum + normalized self term.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.common import ParamSpec, dot
from repro_torch.models.gnn.common import (
    gather_src,
    masked_softmax_ce,
    segment_sum,
    sym_norm_weights,
)


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    n_layers: int = 2
    d_hidden: int = 16
    aggregator: str = "mean"
    norm: str = "sym"
    dropout: float = 0.0  # inference-style determinism for benchmarks


def param_specs(cfg: GCNConfig, d_in: int, d_out: int) -> Dict[str, ParamSpec]:
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [d_out]
    specs: Dict[str, ParamSpec] = {}
    for i in range(cfg.n_layers):
        specs[f"w{i}"] = ParamSpec(
            (dims[i], dims[i + 1]), (None, "tensor" if i == 0 else None), torch.float32
        )
        specs[f"b{i}"] = ParamSpec((dims[i + 1],), (None,), torch.float32, init="zeros")
    return specs


def forward(params, cfg: GCNConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = batch["feats"]
    src, dst = batch["src"], batch["dst"]
    n = h.shape[0]
    ew = sym_norm_weights(src, dst, n)  # [E]
    ones = torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
    deg = segment_sum(ones, dst, n) + 1.0
    self_w = (1.0 / deg)[:, None]
    for i in range(cfg.n_layers):
        hw = dot(h, params[f"w{i}"])
        # the [E, d] message is not kept past its reduction
        agg = segment_sum(gather_src(hw, src) * ew[:, None], dst, n) + hw * self_w
        h = agg + params[f"b{i}"]
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def loss_fn(params, cfg: GCNConfig, batch):
    logits = forward(params, cfg, batch)
    loss, count = masked_softmax_ce(logits, batch["labels"])
    return loss, {"loss": loss, "nodes": count}
