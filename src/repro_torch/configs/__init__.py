"""Model configurations of the port (a port of ``repro.configs``; only the
dense LM ``minitron_8b`` so far — the registry, the other architectures and
the dry-run cells are ROADMAP Queue 1 item 14)."""
