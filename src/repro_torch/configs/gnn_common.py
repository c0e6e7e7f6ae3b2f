"""Shared cell builders, shapes, batches and the loss glue of the four GNN
architectures (a port of ``repro.configs.gnn_common``).

Shapes (every GNN arch runs all four):
  * ``full_graph_sm``  2,708 nodes / 10,556 edges / d_feat 1,433 (cora-like)
  * ``minibatch_lg``   232,965-node / 114.6M-edge graph (reddit-like), sampled
                       blocks of 1,024 seeds with fanout (15, 10); the device
                       step consumes the padded block + gathers rows from the
                       full feature table (the 114.6M edges live host-side in
                       the real `repro_torch.models.gnn.sampler.NeighborSampler`)
  * ``ogb_products``   2,449,029 nodes / 61,859,140 edges / d_feat 100,
                       full-batch training
  * ``molecule``       128 graphs × 30 nodes / 64 edges, per-graph regression

All cells are full train steps (grad + AdamW).  Node and edge counts are
padded to a multiple of 512, as ``repro`` pads them.

MODEL_FLOPS = 3 × analytic forward matmul flops (fwd + bwd ≈ 3× fwd).

:func:`make_gnn_arch` registers an architecture with one cell per shape;
a cell's abstract batch (:func:`batch_abstract`) and parameters are
``device="meta"`` tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.registry import Arch, Cell, CellBuild, round_up
from repro_torch.core.engine import resolve_device
from repro_torch.data import graphgen
from repro_torch.models.common import abstract_from_specs, init_from_specs, logical_from_specs
from repro_torch.models.gnn import sampler as sampler_mod
from repro_torch.models.gnn.common import masked_softmax_ce, segment_sum
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import make_train_step

OPT = opt_mod.AdamWConfig(lr=1e-3, total_steps=100000)

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class GnnShape:
    n_nodes: int
    n_edges: int
    d_feat: int
    d_out: int
    task: str  # node_cls | block_cls | graph_reg
    n_graphs: int = 1
    table_nodes: int = 0  # block task: full feature-table rows
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()

    def padded(self) -> "GnnShape":
        """Nodes and edges padded to 512 (so every derived GraphCast edge set,
        4n, 2n and mesh nodes n/4, divides ``repro``'s 512-way mesh), table
        rows to 16."""
        return dataclasses.replace(
            self,
            n_nodes=round_up(self.n_nodes, 512),
            n_edges=round_up(self.n_edges, 512),
            table_nodes=round_up(self.table_nodes, 16) if self.table_nodes else 0,
        )


def gnn_shapes() -> Dict[str, GnnShape]:
    n_blk, e_blk = sampler_mod.block_shape(1024, (15, 10))
    return {
        "full_graph_sm": GnnShape(2708, 10556, 1433, 7, "node_cls").padded(),
        "minibatch_lg": GnnShape(
            n_blk, e_blk, 602, 41, "block_cls",
            table_nodes=232965, batch_nodes=1024, fanout=(15, 10),
        ).padded(),
        "ogb_products": GnnShape(2449029, 61859140, 100, 47, "node_cls").padded(),
        "molecule": GnnShape(30 * 128, 64 * 128, 16, 1, "graph_reg", n_graphs=128).padded(),
    }


def batch_abstract(shape: GnnShape, with_positions: bool, with_mesh: bool):
    """The batch of ``shape`` as ``device="meta"`` tensors, and its logical
    axes (nodes on ``batch``, edges on ``edge``)."""
    n, e = shape.n_nodes, shape.n_edges
    shapes: Dict[str, Any] = {"src": ((e,), I32), "dst": ((e,), I32)}
    logical: Dict[str, Any] = {"src": ("edge",), "dst": ("edge",)}
    if shape.task == "block_cls":
        shapes["table"] = ((shape.table_nodes, shape.d_feat), F32)
        shapes["feats_idx"] = ((n,), I32)
        logical["table"] = ("tensor", None)
        logical["feats_idx"] = ("batch",)
    else:
        shapes["feats"] = ((n, shape.d_feat), F32)
        logical["feats"] = ("batch", None)
    if shape.task == "graph_reg":
        shapes["graph_ids"] = ((n,), I32)
        shapes["graph_targets"] = ((shape.n_graphs, shape.d_out), F32)
        logical["graph_ids"] = ("batch",)
        logical["graph_targets"] = ("batch", None)
    else:
        shapes["labels"] = ((n,), I32)
        logical["labels"] = ("batch",)
    if with_positions:
        shapes["positions"] = ((n, 3), F32)
        logical["positions"] = ("batch", None)
    if with_mesh:
        for key, (shp, dt) in graphgen.mesh_overlay_shapes(n).items():
            shapes[key] = (shp, getattr(torch, dt))
            logical[key] = graphgen.MESH_OVERLAY_LOGICAL[key]
    return registry.abstract_dict(shapes), logical


def batch_arrays(shape: GnnShape, with_positions: bool, with_mesh: bool,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """The numpy arrays of :func:`batch_concrete` (``repro``'s, byte for byte)."""
    base = graphgen.gnn_batch(
        shape.n_nodes, shape.n_edges, shape.d_feat,
        n_classes=shape.d_out if shape.task != "graph_reg" else 0,
        with_positions=with_positions,
        n_graphs=shape.n_graphs if shape.task == "graph_reg" else 1,
        seed=seed,
    )
    if shape.task == "block_cls":
        rng = np.random.default_rng(seed + 1)
        base["table"] = rng.normal(size=(shape.table_nodes, shape.d_feat)).astype(np.float32)
        base["feats_idx"] = rng.integers(0, shape.table_nodes, shape.n_nodes).astype(np.int32)
        base.pop("feats")
    if with_mesh:
        base.update(graphgen.mesh_overlay(shape.n_nodes, seed=seed))
    return base


def batch_concrete(shape: GnnShape, with_positions: bool, with_mesh: bool, seed: int = 0,
                   device=None) -> Dict[str, torch.Tensor]:
    """A synthetic batch of ``shape`` from ``seed`` as tensors on ``device``
    (the card by default)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(v).to(device)
            for k, v in batch_arrays(shape, with_positions, with_mesh, seed).items()}


def task_loss(forward: Callable, shape: GnnShape) -> Callable:
    """Wrap a model ``forward(params, batch)->[N, d_out]`` for the cell task:
    ``block_cls`` first gathers its node features from the table (padding
    ids, ``-1``, read row 0 and are zeroed), ``graph_reg`` sum-pools per
    graph into an MSE, the others take the masked cross entropy."""

    def loss(params, batch):
        batch = dict(batch)
        if shape.task == "block_cls":
            fidx = batch["feats_idx"]
            feats = batch["table"].index_select(0, fidx.clamp_min(0))
            batch["feats"] = feats * (fidx >= 0).to(feats.dtype)[:, None]
        out = forward(params, batch)
        if shape.task == "graph_reg":
            g = segment_sum(out, batch["graph_ids"], shape.n_graphs)
            l = (g - batch["graph_targets"]).square().mean()
            return l, {"loss": l}
        l, _ = masked_softmax_ce(out, batch["labels"])
        return l, {"loss": l}

    return loss


@dataclasses.dataclass
class GnnModelDef:
    """How one GNN architecture plugs into the shared shapes."""

    name: str
    cfg: Any
    param_specs: Callable  # (cfg, d_in, d_out) -> SpecTree
    forward: Callable  # (params, cfg, batch) -> [N, d_out]
    fwd_flops: Callable  # (cfg, shape: GnnShape) -> float
    with_positions: bool = False
    with_mesh: bool = False
    smoke_cfg: Any = None
    notes: str = ""


def build_cell(md: GnnModelDef, shape: GnnShape) -> CellBuild:
    """One train step (``OPT``) of ``md`` at its ``cfg`` on ``shape``."""
    specs = md.param_specs(md.cfg, shape.d_feat, shape.d_out)
    p_abs = abstract_from_specs(specs)
    p_log = logical_from_specs(specs)
    b_abs, b_log = batch_abstract(shape, md.with_positions, md.with_mesh)
    fwd = functools.partial(md.forward, cfg=md.cfg)
    step = make_train_step(task_loss(lambda p, b: fwd(p, batch=b), shape), OPT)
    return CellBuild(
        fn=step,
        args=(p_abs, opt_mod.abstract_state(p_abs), b_abs),
        logical=(p_log, opt_mod.state_logical(p_log), b_log),
        model_flops=3.0 * md.fwd_flops(md.cfg, shape),
        donate=(0, 1),
    )


def make_gnn_arch(md: GnnModelDef) -> Arch:
    cells = {sname: Cell(md.name, sname, "train", functools.partial(build_cell, md, shape))
             for sname, shape in gnn_shapes().items()}
    return registry.register(Arch(
        name=md.name, family="gnn", cfg=md.cfg, cells=cells,
        smoke=functools.partial(gnn_smoke, md), notes=md.notes,
    ))


SMOKE_SHAPE = GnnShape(64, 256, 8, 4, "node_cls").padded()


def gnn_smoke(md: GnnModelDef, device=None) -> Dict[str, float]:
    """One forward and one train step (``OPT``) of ``md``'s smoke config on a
    small synthetic graph on ``device`` (the card by default); asserts
    finite results.  The forward runs on the parameters before the step, as
    in ``repro``."""
    device = resolve_device(device)
    cfg = md.smoke_cfg or md.cfg
    shape = SMOKE_SHAPE
    params = init_from_specs(md.param_specs(cfg, shape.d_feat, shape.d_out), 0, device)
    batch = batch_concrete(shape, md.with_positions, md.with_mesh, seed=0, device=device)
    fwd = functools.partial(md.forward, cfg=cfg)
    with torch.no_grad():
        out = fwd(params, batch=batch)
    assert out.shape == (shape.n_nodes, shape.d_out)
    assert bool(torch.isfinite(out).all())
    step = make_train_step(task_loss(lambda p, b: fwd(p, batch=b), shape), OPT)
    _, _, metrics = step(params, opt_mod.init(params), batch)
    lv = float(metrics["loss_total"])
    assert math.isfinite(lv), f"{md.name}: non-finite loss {lv}"
    return {"loss": lv}
