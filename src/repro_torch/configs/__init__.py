"""Model configurations of the port (a port of ``repro.configs``).

  lm_common       — the LM cells' shapes and ``n_active`` (the model-FLOPs
                    convention)
  grok_1_314b     — MoE, 8 experts top-2
  kimi_k2_1t_a32b — MoE, 384 experts top-8 plus one shared expert
  minitron_8b     — dense, squared ReLU
  nemotron_4_15b  — dense, squared ReLU
  stablelm_12b    — dense, SwiGLU, head width 160
  overrides       — ``path.to.field=value`` assignments on a config
  gnn_common      — the GNN shapes (``gnn_shapes``), synthetic batches
                    (``batch_concrete``), the task losses and ``gnn_smoke``
  gcn_cora, graphsage_reddit, schnet, graphcast
                  — the GNNs: ``CFG``, ``fwd_flops``, ``MODEL`` and
                    ``smoke(device)``
  din             — the recsys model: ``CFG``, ``SMOKE_CFG``, ``OPT``,
                    ``_score_flops`` and ``smoke(device)``

Each LM module holds ``CFG`` and a CPU-sized ``SMOKE``; schnet and
graphcast have a ``SMOKE`` too.  The registry and its cell builders, the
dry-run and ``sge`` are not ported yet (ROADMAP Queue 1 items 14.3–14.5).
"""
