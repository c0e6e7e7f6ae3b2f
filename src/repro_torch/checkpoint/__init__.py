"""Checkpoints of the port (a port of ``repro.checkpoint``).

  store — atomic save / restore in ``repro``'s on-disk format

``repro``'s elastic reshard (``reshard.place``) needs the sharding layer,
which is not ported yet (ROADMAP Queue 1 item 14.4).
"""
