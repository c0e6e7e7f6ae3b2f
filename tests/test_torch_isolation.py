"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the entry points run on the card
unless the caller asks for the CPU."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

import repro_torch  # noqa: E402
from repro_torch.core import Enumerator, Graph, enumerate_subgraphs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
# an import statement naming jax or the repro package (repro_torch is fine)
FORBIDDEN_IMPORT = re.compile(r"^\s*(from|import)\s+(jax\b|jaxlib\b|repro\b(?!_torch))", re.M)


def _modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_jax_or_repro_import_in_source(path):
    src = (ROOT / path).read_text()
    assert not FORBIDDEN_IMPORT.search(src), FORBIDDEN_IMPORT.search(src).group(0)


def test_entry_points_default_to_the_card():
    g = Graph.from_edges(3, [(0, 1), (1, 2)], undirected=True)
    if torch.cuda.is_available():
        assert Enumerator(g).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Enumerator(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enumerate_subgraphs(g, g)
    assert enumerate_subgraphs(g, g, device="cpu").matches == 2


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Alone in a directory (or without a card) the smoke script exits
    non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
