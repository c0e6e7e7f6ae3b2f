"""graphcast — 16L d_hidden=512 mesh_refinement=6 aggregator=sum n_vars=227.
[arXiv:2212.12794; unverified]

Encoder-processor-decoder runs on a synthetic mesh overlay for the generic
GNN shapes (grid = target graph, mesh = N/4 subsampled nodes, fanout-4
bipartite edges, `repro_torch.data.graphgen.mesh_overlay`).
"""

from repro_torch.configs.gnn_common import GnnModelDef, GnnShape, make_gnn_arch
from repro_torch.models.gnn import graphcast

CFG = graphcast.GraphCastConfig(
    n_layers=16, d_hidden=512, mesh_refinement=6, aggregator="sum", n_vars=227
)
SMOKE = graphcast.GraphCastConfig(n_layers=2, d_hidden=32, n_vars=8)


def fwd_flops(cfg: graphcast.GraphCastConfig, shape: GnnShape) -> float:
    ng, d = shape.n_nodes, cfg.d_hidden
    nm = max(8, ng // 4)
    e1 = ng * 4  # g2m
    e2 = nm * 8  # mesh
    e3 = ng * 4  # m2g
    f = 2.0 * ng * shape.d_feat * d + 2.0 * (nm + e1 + e2 + e3) * cfg.d_edge_in * d

    def interact(e, n):
        return 2.0 * e * (3 * d * d + d * d) + 2.0 * n * (2 * d * d + d * d)

    f += interact(e1, nm)
    f += cfg.n_layers * interact(e2, nm)
    f += interact(e3, ng)
    f += 2.0 * ng * (d * d + d * shape.d_out)
    return f


MODEL = GnnModelDef(
    name="graphcast",
    cfg=CFG,
    param_specs=graphcast.param_specs,
    forward=lambda params, cfg, batch: graphcast.forward(params, cfg, batch),
    fwd_flops=fwd_flops,
    with_mesh=True,
    smoke_cfg=SMOKE,
    notes="Deep mesh processor (16 scanned layers); heaviest GNN cell.",
)

ARCH = make_gnn_arch(MODEL)
smoke = ARCH.smoke  # smoke(device=None): one train step of the smoke config
