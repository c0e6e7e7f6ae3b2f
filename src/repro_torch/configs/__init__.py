"""Model configurations of the port (a port of ``repro.configs``).

  lm_common       — the LM cells' shapes and ``n_active`` (the model-FLOPs
                    convention)
  grok_1_314b     — MoE, 8 experts top-2
  kimi_k2_1t_a32b — MoE, 384 experts top-8 plus one shared expert
  minitron_8b     — dense, squared ReLU
  nemotron_4_15b  — dense, squared ReLU
  stablelm_12b    — dense, SwiGLU, head width 160
  overrides       — ``path.to.field=value`` assignments on a config

Each LM module holds ``CFG`` and a CPU-sized ``SMOKE``.  The registry, the
cell builders, the GNN and recsys configurations and the dry-run are not
ported yet (ROADMAP Queue 1 item 14).
"""
