"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``):

  serve  — the always-on enumeration service under synthetic clients
  train  — LM training on synthetic token streams; the GNN and recsys
           architectures' smokes (one train step each)
"""
