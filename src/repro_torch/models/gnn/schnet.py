"""SchNet: continuous-filter convolutions over radial basis expansions (a
port of ``repro.models.gnn.schnet``).

Per interaction block (Schütt et al.):
  d_ij  = ||x_i - x_j||                (edge distances from positions)
  rbf   = exp(-γ (d - μ_k)^2)          (n_rbf Gaussian bases over [0, cutoff])
  W_ij  = filter-MLP(rbf)              (continuous filter, ssp activations)
  m_i   = Σ_j (h_j W1) ⊙ W_ij          (cfconv: gather, modulate, scatter-sum)
  h_i  += W3 · ssp(W2 · m_i)           (atom-wise update, residual)

Node inputs arrive as precomputed features; a linear layer maps them to
``d_hidden``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, dot
from repro_torch.models.gnn.common import gather_src, masked_softmax_ce, segment_sum


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0


def ssp(x):
    """Shifted softplus — SchNet's activation."""
    return F.softplus(x) - math.log(2.0)


def param_specs(cfg: SchNetConfig, d_in: int, d_out: int) -> Dict[str, ParamSpec]:
    d = cfg.d_hidden
    f32 = torch.float32
    specs: Dict[str, ParamSpec] = {
        "embed_w": ParamSpec((d_in, d), (None, "tensor"), f32),
        "embed_b": ParamSpec((d,), (None,), f32, init="zeros"),
        "out_w0": ParamSpec((d, d // 2), (None, None), f32),
        "out_b0": ParamSpec((d // 2,), (None,), f32, init="zeros"),
        "out_w1": ParamSpec((d // 2, d_out), (None, None), f32),
        "out_b1": ParamSpec((d_out,), (None,), f32, init="zeros"),
    }
    for i in range(cfg.n_interactions):
        specs[f"f_w0_{i}"] = ParamSpec((cfg.n_rbf, d), (None, "tensor"), f32)
        specs[f"f_b0_{i}"] = ParamSpec((d,), (None,), f32, init="zeros")
        specs[f"f_w1_{i}"] = ParamSpec((d, d), (None, None), f32)
        specs[f"f_b1_{i}"] = ParamSpec((d,), (None,), f32, init="zeros")
        specs[f"in_w1_{i}"] = ParamSpec((d, d), (None, None), f32)
        specs[f"in_w2_{i}"] = ParamSpec((d, d), (None, None), f32)
        specs[f"in_b2_{i}"] = ParamSpec((d,), (None,), f32, init="zeros")
        specs[f"in_w3_{i}"] = ParamSpec((d, d), (None, None), f32)
        specs[f"in_b3_{i}"] = ParamSpec((d,), (None,), f32, init="zeros")
    return specs


def rbf_centres(cutoff: float, n_rbf: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n_rbf)`` in fp32, value for value, as XLA
    evaluates it: ``i · (cutoff · (1/(n_rbf-1)))`` with each product rounded
    to fp32 (XLA turns the division by the constant ``n_rbf - 1`` into a
    product with its reciprocal and reassociates), ``cutoff`` last.
    ``torch.linspace`` steps from both ends and differs in the last place,
    which ``exp(-γ (d - μ)²)`` magnifies by ``2γ|d - μ|`` (γ ≈ 894 at CFG)."""
    if n_rbf == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    delta = np.float32(cutoff) * (np.float32(1) / np.float32(n_rbf - 1))
    mu = torch.arange(n_rbf - 1, dtype=torch.float32, device=device) * torch.tensor(
        delta, dtype=torch.float32, device=device)
    return torch.cat([mu, torch.tensor([cutoff], dtype=torch.float32, device=device)])


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    mu = rbf_centres(cutoff, n_rbf, device=dist.device)
    gamma = 1.0 / (mu[1] - mu[0]) ** 2
    return torch.exp(-gamma * (dist[:, None] - mu[None, :]).square())


def forward(params, cfg: SchNetConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    src, dst = batch["src"], batch["dst"]
    n = batch["feats"].shape[0]
    pos = batch["positions"]
    h = dot(batch["feats"], params["embed_w"]) + params["embed_b"]

    diff = pos.index_select(0, src) - pos.index_select(0, dst)
    dist = torch.sqrt(diff.square().sum(dim=-1) + 1e-12)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)  # [E, n_rbf]
    # smooth cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1)) + 1.0)

    for i in range(cfg.n_interactions):
        filt = ssp(dot(rbf, params[f"f_w0_{i}"]) + params[f"f_b0_{i}"])
        filt = ssp(dot(filt, params[f"f_w1_{i}"]) + params[f"f_b1_{i}"])
        filt = filt * env[:, None]
        x = dot(h, params[f"in_w1_{i}"])
        msg = gather_src(x, src) * filt
        agg = segment_sum(msg, dst, n)
        upd = ssp(dot(agg, params[f"in_w2_{i}"]) + params[f"in_b2_{i}"])
        h = h + dot(upd, params[f"in_w3_{i}"]) + params[f"in_b3_{i}"]

    out = ssp(dot(h, params["out_w0"]) + params["out_b0"])
    return dot(out, params["out_w1"]) + params["out_b1"]


def loss_fn(params, cfg: SchNetConfig, batch):
    out = forward(params, cfg, batch)
    if "graph_ids" in batch and "graph_targets" in batch:
        # per-graph energy: sum-pool node outputs, MSE against graph targets
        g = segment_sum(out, batch["graph_ids"], batch["graph_targets"].shape[0])
        loss = (g - batch["graph_targets"]).square().mean()
        return loss, {"loss": loss}
    if "labels" in batch:
        loss, count = masked_softmax_ce(out, batch["labels"])
        return loss, {"loss": loss, "nodes": count}
    loss = (out - batch["targets"]).square().mean()
    return loss, {"loss": loss}
