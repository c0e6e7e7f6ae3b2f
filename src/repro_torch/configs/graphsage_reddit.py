"""graphsage-reddit — 2L d_hidden=128 aggregator=mean sample_sizes=25-10.
[arXiv:1706.02216; paper]

The ``minibatch_lg`` shape is a padded block of the neighbor sampler
(`repro_torch.models.gnn.sampler.NeighborSampler`, fanout 15-10 per the
shape spec); skewed block sizes are spread across shards with the LPT
balancer (``balance_buckets``).
"""

from repro_torch.configs.gnn_common import GnnModelDef, GnnShape, make_gnn_arch
from repro_torch.models.gnn import sage

CFG = sage.SAGEConfig(n_layers=2, d_hidden=128, aggregator="mean", sample_sizes=(25, 10))


def fwd_flops(cfg: sage.SAGEConfig, shape: GnnShape) -> float:
    dims = [shape.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [shape.d_out]
    f = 0.0
    for i in range(cfg.n_layers):
        f += 2.0 * 2.0 * shape.n_nodes * dims[i] * dims[i + 1]  # self + nbr
        f += 2.0 * shape.n_edges * dims[i]  # mean aggregation adds
    return f


MODEL = GnnModelDef(
    name="graphsage-reddit",
    cfg=CFG,
    param_specs=sage.param_specs,
    forward=lambda params, cfg, batch: sage.forward(params, cfg, batch),
    fwd_flops=fwd_flops,
    notes="minibatch_lg uses the paper's load-balancing insight for "
    "skewed sampled blocks (DESIGN.md §4).",
)

ARCH = make_gnn_arch(MODEL)
smoke = ARCH.smoke  # smoke(device=None): one train step of the smoke config
