"""GraphCast-style encoder–processor–decoder mesh GNN (a port of
``repro.models.gnn.graphcast``).

Three bipartite/recurrent edge sets (grid→mesh encoder, ``n_layers`` of mesh
message passing, mesh→grid decoder), each an interaction-network step:

  e'  = MLP([h_src, h_dst, e]) + e        (edge update)
  h'  = MLP([h, Σ_{e into v} e']) + h     (node update, sum aggregation)

For the weather configuration the mesh is an icosahedral refinement
(refinement 6 ⇒ 40,962 mesh nodes) and grid nodes carry ``n_vars = 227``
channels; `repro_torch.data.graphgen.icosa_mesh_shape` gives the synthetic
topology.  For the generic GNN shapes the same architecture runs with the
target graph as "grid", a quarter of its nodes as "mesh", and fanout-4
bipartite edges (`repro_torch.data.graphgen.mesh_overlay`).

The processor's parameters stay stacked ``[L, ...]`` under ``repro``'s names
and shapes (parameters carry across and checkpoints line up); its layers run
in a loop over ``l``, each under ``torch.utils.checkpoint`` while gradients
are recorded, which stands for ``repro``'s ``lax.scan`` over
``jax.checkpoint(nothing_saveable)``: a layer's activations are recomputed
in the backward pass instead of kept.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ParamSpec, dot
from repro_torch.models.gnn.common import gather_src, masked_softmax_ce, segment_sum


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    n_layers: int = 16
    d_hidden: int = 512
    mesh_refinement: int = 6
    aggregator: str = "sum"
    n_vars: int = 227
    d_edge_in: int = 4  # static edge features (displacement etc.)


F32 = torch.float32
STACK_KEYS = ("proc_edge_w0", "proc_edge_b0", "proc_edge_w1", "proc_edge_b1",
              "proc_node_w0", "proc_node_b0", "proc_node_w1", "proc_node_b1")


def _mlp2(prefix: str, d_in: int, d: int, d_out: int) -> Dict[str, ParamSpec]:
    return {
        f"{prefix}_w0": ParamSpec((d_in, d), (None, "tensor"), F32),
        f"{prefix}_b0": ParamSpec((d,), (None,), F32, init="zeros"),
        f"{prefix}_w1": ParamSpec((d, d_out), ("tensor", None), F32),
        f"{prefix}_b1": ParamSpec((d_out,), (None,), F32, init="zeros"),
    }


def _mlp2_stack(prefix: str, l: int, d_in: int, d: int, d_out: int) -> Dict[str, ParamSpec]:
    return {
        f"{prefix}_w0": ParamSpec((l, d_in, d), (None, None, "tensor"), F32),
        f"{prefix}_b0": ParamSpec((l, d), (None, None), F32, init="zeros"),
        f"{prefix}_w1": ParamSpec((l, d, d_out), (None, "tensor", None), F32),
        f"{prefix}_b1": ParamSpec((l, d_out), (None, None), F32, init="zeros"),
    }


def param_specs(cfg: GraphCastConfig, d_in: int, d_out: int) -> Dict[str, ParamSpec]:
    d = cfg.d_hidden
    specs: Dict[str, ParamSpec] = {}
    specs.update(_mlp2("embed_grid", d_in, d, d))
    specs.update(_mlp2("embed_mesh", cfg.d_edge_in, d, d))  # mesh feats = coords
    specs.update(_mlp2("embed_e_g2m", cfg.d_edge_in, d, d))
    specs.update(_mlp2("embed_e_mesh", cfg.d_edge_in, d, d))
    specs.update(_mlp2("embed_e_m2g", cfg.d_edge_in, d, d))
    specs.update(_mlp2("g2m_edge", 3 * d, d, d))
    specs.update(_mlp2("g2m_mesh", 2 * d, d, d))
    specs.update(_mlp2_stack("proc_edge", cfg.n_layers, 3 * d, d, d))
    specs.update(_mlp2_stack("proc_node", cfg.n_layers, 2 * d, d, d))
    specs.update(_mlp2("m2g_edge", 3 * d, d, d))
    specs.update(_mlp2("m2g_grid", 2 * d, d, d))
    specs.update(_mlp2("decode", d, d, d_out))
    return specs


def _mlp(p, prefix: str, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dot(x, p[f"{prefix}_w0"]) + p[f"{prefix}_b0"])
    return dot(h, p[f"{prefix}_w1"]) + p[f"{prefix}_b1"]


def _interact(p, prefix_e: str, prefix_n: str, h_src, h_dst, e, src, dst):
    """One interaction-network step over a (bipartite) edge set."""
    msg_in = torch.cat([gather_src(h_src, src), gather_src(h_dst, dst), e], dim=-1)
    e2 = _mlp(p, prefix_e, msg_in) + e
    agg = segment_sum(e2, dst, h_dst.shape[0])
    h2 = _mlp(p, prefix_n, torch.cat([h_dst, agg], dim=-1)) + h_dst
    return h2, e2


def _proc_layer(lp: Dict[str, torch.Tensor], hm, e, msrc, mdst):
    return _interact(lp, "proc_edge", "proc_node", hm, hm, e, msrc, mdst)


def forward(params, cfg: GraphCastConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    p = params
    hg = _mlp(p, "embed_grid", batch["feats"])  # grid nodes
    hm = _mlp(p, "embed_mesh", batch["mesh_feats"])  # mesh nodes
    e_g2m = _mlp(p, "embed_e_g2m", batch["g2m_efeats"])
    e_mesh = _mlp(p, "embed_e_mesh", batch["mesh_efeats"])
    e_m2g = _mlp(p, "embed_e_m2g", batch["m2g_efeats"])

    # --- encoder: grid -> mesh ---------------------------------------------
    hm, _ = _interact(p, "g2m_edge", "g2m_mesh", hg, hm, e_g2m,
                      batch["g2m_src"], batch["g2m_dst"])

    # --- processor: n_layers on the mesh graph, layer l from p[k][l] --------
    msrc, mdst = batch["mesh_src"], batch["mesh_dst"]
    remat = torch.is_grad_enabled()
    for l in range(p[STACK_KEYS[0]].shape[0]):
        lp = {k: p[k][l] for k in STACK_KEYS}
        if remat:
            hm, e_mesh = checkpoint(_proc_layer, lp, hm, e_mesh, msrc, mdst,
                                    use_reentrant=False)
        else:
            hm, e_mesh = _proc_layer(lp, hm, e_mesh, msrc, mdst)

    # --- decoder: mesh -> grid ----------------------------------------------
    hg, _ = _interact(p, "m2g_edge", "m2g_grid", hm, hg, e_m2g,
                      batch["m2g_src"], batch["m2g_dst"])
    return _mlp(p, "decode", hg)


def loss_fn(params, cfg: GraphCastConfig, batch):
    out = forward(params, cfg, batch)
    if "labels" in batch:
        loss, count = masked_softmax_ce(out, batch["labels"])
        return loss, {"loss": loss, "nodes": count}
    loss = (out - batch["targets"]).square().mean()
    return loss, {"loss": loss}
