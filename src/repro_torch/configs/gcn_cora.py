"""gcn-cora — 2L d_hidden=16 aggregator=mean norm=sym.  [arXiv:1609.02907; paper]"""

from repro_torch.configs.gnn_common import GnnModelDef, GnnShape, make_gnn_arch
from repro_torch.models.gnn import gcn

CFG = gcn.GCNConfig(n_layers=2, d_hidden=16, aggregator="mean", norm="sym")


def fwd_flops(cfg: gcn.GCNConfig, shape: GnnShape) -> float:
    dims = [shape.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [shape.d_out]
    f = 0.0
    for i in range(cfg.n_layers):
        f += 2.0 * shape.n_nodes * dims[i] * dims[i + 1]  # H W
        f += 2.0 * shape.n_edges * dims[i + 1]  # edge msg scale + scatter-add
    return f


MODEL = GnnModelDef(
    name="gcn-cora",
    cfg=CFG,
    param_specs=gcn.param_specs,
    forward=lambda params, cfg, batch: gcn.forward(params, cfg, batch),
    fwd_flops=fwd_flops,
    notes="Shares the segment_sum substrate with the SGE engine "
    "(DESIGN.md §4); load is regular full-batch.",
)

ARCH = make_gnn_arch(MODEL)
smoke = ARCH.smoke  # smoke(device=None): one train step of the smoke config
