"""GNN models of the port (a port of ``repro.models.gnn``).

  common    — segment reductions, edge gathers, GCN weights, MLPs, the
              masked cross entropy
  gcn       — GCN with symmetric normalisation
  sage      — GraphSAGE (sum / mean / max aggregators)
  schnet    — SchNet's continuous-filter convolutions
  graphcast — GraphCast's encoder, stacked processor and decoder
  sampler   — the host-side fanout neighbour sampler and the LPT bucket
              balancer (numpy)

Message passing is torch's index ops (``index_select`` / ``index_add`` /
``scatter_reduce``) and ``torch.matmul``: ``repro`` computes these models
with XLA ops outside any Pallas kernel, so no kernel of
``repro_torch.kernels`` runs here.
"""
