"""GraphSAGE (mean aggregator): ``h' = act(W_self h + W_nbr mean_{u∈N(v)} h_u)``
(a port of ``repro.models.gnn.sage``).

Works both full-batch and on sampled blocks from
`repro_torch.models.gnn.sampler`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.common import ParamSpec, dot
from repro_torch.models.gnn.common import AGGREGATORS, gather_src, masked_softmax_ce


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    n_layers: int = 2
    d_hidden: int = 128
    aggregator: str = "mean"
    sample_sizes: tuple = (25, 10)
    normalize: bool = True


def param_specs(cfg: SAGEConfig, d_in: int, d_out: int) -> Dict[str, ParamSpec]:
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [d_out]
    specs: Dict[str, ParamSpec] = {}
    for i in range(cfg.n_layers):
        specs[f"w_self{i}"] = ParamSpec(
            (dims[i], dims[i + 1]), (None, "tensor" if i == 0 else None), torch.float32
        )
        specs[f"w_nbr{i}"] = ParamSpec(
            (dims[i], dims[i + 1]), (None, "tensor" if i == 0 else None), torch.float32
        )
        specs[f"b{i}"] = ParamSpec((dims[i + 1],), (None,), torch.float32, init="zeros")
    return specs


def forward(params, cfg: SAGEConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = batch["feats"]
    src, dst = batch["src"], batch["dst"]
    n = h.shape[0]
    agg_fn = AGGREGATORS[cfg.aggregator]
    for i in range(cfg.n_layers):
        # the [E, d] message is not kept past its reduction (31.7 GB at
        # layer 1 on ogb_products)
        agg = agg_fn(gather_src(h, src), dst, n)
        h = dot(h, params[f"w_self{i}"]) + dot(agg, params[f"w_nbr{i}"]) + params[f"b{i}"]
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
            if cfg.normalize:
                h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(1e-6)
    return h


def loss_fn(params, cfg: SAGEConfig, batch):
    logits = forward(params, cfg, batch)
    loss, count = masked_softmax_ce(logits, batch["labels"])
    return loss, {"loss": loss, "nodes": count}
