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
from repro_torch.core import (  # noqa: E402
    Enumerator,
    Graph,
    PackedGraph,
    SubgraphIndex,
    build_csr_plan,
    compute_domains_batch,
    compute_domains_csr,
    compute_domains_device,
    enumerate_many,
    enumerate_subgraphs,
)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
# an import statement naming jax or the repro package (repro_torch is fine)
FORBIDDEN_IMPORT = re.compile(r"^\s*(from|import)\s+(jax\b|jaxlib\b|repro\b(?!_torch))", re.M)


def _modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]


# every module of the port so far; the walk below must find each of them
PORT_MODULES = {
    "repro_torch", "repro_torch.core", "repro_torch.core.api", "repro_torch.core.domains",
    "repro_torch.core.delta", "repro_torch.core.engine", "repro_torch.core.extend", "repro_torch.core.frontier",
    "repro_torch.core.graph", "repro_torch.core.multi", "repro_torch.core.ordering",
    "repro_torch.core.plan", "repro_torch.core.ref", "repro_torch.core.scheduler",
    "repro_torch.core.session", "repro_torch.data", "repro_torch.data.graphgen",
    "repro_torch.kernels", "repro_torch.kernels._build", "repro_torch.kernels.candidate_mask",
    "repro_torch.kernels.csr_extend", "repro_torch.kernels.domain_ac",
    "repro_torch.kernels.extend_step",
    "repro_torch.kernels.ops", "repro_torch.kernels.popcount_reduce",
    "repro_torch.kernels.ref",
    "repro_torch.serve", "repro_torch.serve.admission", "repro_torch.serve.coalescer",
    "repro_torch.serve.metrics", "repro_torch.serve.service", "repro_torch.serve.stream",
    "repro_torch.launch", "repro_torch.launch.serve", "repro_torch.launch.sge_run",
    "repro_torch.models", "repro_torch.models.common", "repro_torch.models.attention",
    "repro_torch.models.moe", "repro_torch.models.transformer",
    "repro_torch.configs", "repro_torch.configs.lm_common", "repro_torch.configs.minitron_8b",
    "repro_torch.configs.grok_1_314b", "repro_torch.configs.kimi_k2_1t_a32b",
    "repro_torch.configs.nemotron_4_15b", "repro_torch.configs.stablelm_12b",
    "repro_torch.configs.overrides", "repro_torch.kernels.flash_attention",
    "repro_torch.train", "repro_torch.train.tree", "repro_torch.train.optimizer",
    "repro_torch.train.trainer", "repro_torch.checkpoint", "repro_torch.checkpoint.store",
    "repro_torch.data.tokens", "repro_torch.launch.train",
    "repro_torch.models.gnn", "repro_torch.models.gnn.common", "repro_torch.models.gnn.gcn",
    "repro_torch.models.gnn.sage", "repro_torch.models.gnn.schnet",
    "repro_torch.models.gnn.graphcast", "repro_torch.models.gnn.sampler",
    "repro_torch.models.recsys", "repro_torch.models.recsys.embedding",
    "repro_torch.models.recsys.din", "repro_torch.configs.gnn_common",
    "repro_torch.configs.gcn_cora", "repro_torch.configs.graphsage_reddit",
    "repro_torch.configs.schnet", "repro_torch.configs.graphcast", "repro_torch.configs.din",
    "repro_torch.configs.registry", "repro_torch.configs.sge",
    "repro_torch.distributed", "repro_torch.distributed.shardings",
    "repro_torch.distributed.compression", "repro_torch.launch.mesh",
    "repro_torch.launch.dryrun", "repro_torch.checkpoint.reshard", "repro_torch.bench",
}


def test_importing_every_module_loads_neither_jax_nor_repro():
    assert PORT_MODULES <= set(_modules()), PORT_MODULES - set(_modules())
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_domains_device(g, PackedGraph.from_graph(g))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_domains_batch([g], PackedGraph.from_graph(g))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enumerate_many([g], g)
    # the sparse path: its device fixpoint and sessions default to the card too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_domains_csr(g, g, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_csr_plan(g, g, variant="ri-ds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Enumerator(SubgraphIndex.build(g, sparse=True), step_backend="csr")
    assert enumerate_subgraphs(g, g, device="cpu").matches == 2
    assert enumerate_subgraphs(g, g, device="cpu", step_backend="csr").matches == 2


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Alone in a directory (or without a card) the smoke script exits
    non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
