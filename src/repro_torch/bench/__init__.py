"""``repro_torch.bench`` — import shim for the repo-root ``benchmarks/``
package (a copy of ``repro.bench``).

The benchmark scripts live next to the repo root (not under ``src/``) so
they can write ``artifacts/``.  Importing this module locates the repo
root from the package path and makes ``benchmarks`` importable from any
working directory::

    import repro_torch.bench                # side effect: root on sys.path
    from benchmarks import bench_torch_main_path

or, equivalently::

    from repro_torch.bench import benchmarks_root
"""

from __future__ import annotations

import os
import sys

# src/repro_torch/bench/__init__.py -> repo root is three levels up from here.
_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def benchmarks_root() -> str:
    """Absolute path of the repo-root ``benchmarks/`` directory."""
    return os.path.join(_ROOT, "benchmarks")


if os.path.isdir(benchmarks_root()) and _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
