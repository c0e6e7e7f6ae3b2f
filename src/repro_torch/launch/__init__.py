"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``):

  serve   — the always-on enumeration service under synthetic clients
  train   — LM training on synthetic token streams; the GNN and recsys
            architectures' smokes (one train step each)
  sge_run — the paper's experiment driver
  dryrun  — every registry cell's shardings and bytes per device on the
            production meshes

and the meshes they run on (`repro_torch.launch.mesh`).
"""
