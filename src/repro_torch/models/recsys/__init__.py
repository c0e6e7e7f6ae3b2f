"""Recsys models of the port (a port of ``repro.models.recsys``).

  embedding — table declarations, lookups, embedding bags (index ops)
  din       — the Deep Interest Network: training loss, pointwise scoring,
              one user against many candidates
"""
