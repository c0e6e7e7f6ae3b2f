"""Model configurations and the cell registry of the port (a port of
``repro.configs``).

  registry        — ``Arch`` / ``Cell`` / ``CellBuild``, ``register``,
                    ``get``, ``load_all`` and ``all_cells``: 11
                    architectures, 44 cells
  lm_common       — the LM cells (``build_train`` / ``build_prefill`` /
                    ``build_decode``, ``make_lm_arch``, ``lm_smoke``) and
                    ``n_active`` (the model-FLOPs convention)
  grok_1_314b     — MoE, 8 experts top-2
  kimi_k2_1t_a32b — MoE, 384 experts top-8 plus one shared expert
  minitron_8b     — dense, squared ReLU
  nemotron_4_15b  — dense, squared ReLU
  stablelm_12b    — dense, SwiGLU, head width 160
  overrides       — ``path.to.field=value`` assignments on a config
  gnn_common      — the GNN shapes (``gnn_shapes``), abstract and synthetic
                    batches, the task losses, ``build_cell``,
                    ``make_gnn_arch`` and ``gnn_smoke``
  gcn_cora, graphsage_reddit, schnet, graphcast
                  — the GNNs: ``CFG``, ``fwd_flops``, ``MODEL``, ``ARCH``
                    and ``smoke(device)``
  din             — the recsys model: ``CFG``, ``SMOKE_CFG``, ``OPT``, its
                    four cells, ``ARCH`` and ``smoke(device)``
  sge             — the paper's own workload: one engine round per data
                    collection (four cells) and ``smoke(device)``

Each LM module holds ``CFG``, a CPU-sized ``SMOKE`` and ``ARCH``; schnet and
graphcast have a ``SMOKE`` too.  A cell's abstract arguments are
``device="meta"`` tensors.  The dry-run is not ported yet (ROADMAP Queue 1
item 14.4).
"""
