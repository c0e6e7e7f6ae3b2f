"""schnet — n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
[arXiv:1706.08566; paper]"""

from repro_torch.configs.gnn_common import GnnModelDef, GnnShape, make_gnn_arch
from repro_torch.models.gnn import schnet

CFG = schnet.SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)
SMOKE = schnet.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=8, cutoff=5.0)


def fwd_flops(cfg: schnet.SchNetConfig, shape: GnnShape) -> float:
    n, e, d = shape.n_nodes, shape.n_edges, cfg.d_hidden
    f = 2.0 * n * shape.d_feat * d  # embed
    per = (
        2.0 * e * cfg.n_rbf * d  # filter MLP layer 0 (edge-wise)
        + 2.0 * e * d * d  # filter MLP layer 1
        + 2.0 * n * d * d  # in_w1
        + e * d  # message modulation + scatter
        + 2.0 * 2.0 * n * d * d  # in_w2, in_w3
    )
    f += cfg.n_interactions * per
    f += 2.0 * n * d * (d // 2) + 2.0 * n * (d // 2) * shape.d_out
    return f


MODEL = GnnModelDef(
    name="schnet",
    cfg=CFG,
    param_specs=schnet.param_specs,
    forward=lambda params, cfg, batch: schnet.forward(params, cfg, batch),
    fwd_flops=fwd_flops,
    with_positions=True,
    smoke_cfg=SMOKE,
    notes="Molecular continuous-filter conv; edge-wise filter MLP over "
    "300 RBFs makes this the most edge-bound GNN cell.",
)

ARCH = make_gnn_arch(MODEL)
smoke = ARCH.smoke  # smoke(device=None): one train step of the smoke config
