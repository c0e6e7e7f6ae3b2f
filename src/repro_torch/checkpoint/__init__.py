"""Checkpoints of the port (a port of ``repro.checkpoint``).

  store   — atomic save / restore in ``repro``'s on-disk format
  reshard — ``place``: restored host tensors laid over a mesh by their
            logical axes (elastic restarts), and ``gather``
"""

from repro_torch.checkpoint import store
from repro_torch.checkpoint.reshard import gather, place

__all__ = ["store", "place", "gather"]
