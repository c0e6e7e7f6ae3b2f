"""Data for the port (numpy, deterministic by seed).

  graphgen — synthetic graphs, pattern collections and LM token batches
  tokens   — the sharded on-disk token store and its resumable loader
"""
