"""Architecture × shape cell registry (a port of ``repro.configs.registry``).

Every architecture registers an :class:`Arch` with one :class:`Cell` per
input shape; the launcher (`repro_torch.launch.train`) and the tests walk
this registry.

A cell's ``build()`` returns the step function plus *abstract* arguments
and matching logical-axis trees.  The abstract arguments are trees of
``device="meta"`` tensors (``repro``'s ``ShapeDtypeStruct`` pytrees): they
carry shapes and dtypes and allocate nothing, so a trillion-parameter
config builds on any host.  ``fn`` runs on concrete tensors of those shapes;
``donate`` names the arguments it updates in place.  ``model_flops`` is the
analytic useful-work estimate, computed from the config's integers.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class CellBuild:
    fn: Callable
    args: Tuple[Any, ...]  # abstract args (trees of meta tensors)
    logical: Tuple[Any, ...]  # logical-axis trees matching ``args``
    model_flops: float
    note: str = ""
    donate: Tuple[int, ...] = ()


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str  # train | prefill | decode | serve | retrieval | engine
    build: Optional[Callable[[], CellBuild]]
    skip_reason: Optional[str] = None

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


@dataclasses.dataclass
class Arch:
    name: str
    family: str  # lm | gnn | recsys | sge
    cfg: Any
    cells: Dict[str, Cell]
    smoke: Callable[..., Dict[str, float]]  # smoke(device=None): a reduced run
    notes: str = ""


_REGISTRY: Dict[str, Arch] = {}

ARCH_MODULES = [
    "repro_torch.configs.grok_1_314b",
    "repro_torch.configs.kimi_k2_1t_a32b",
    "repro_torch.configs.nemotron_4_15b",
    "repro_torch.configs.minitron_8b",
    "repro_torch.configs.stablelm_12b",
    "repro_torch.configs.gcn_cora",
    "repro_torch.configs.graphcast",
    "repro_torch.configs.schnet",
    "repro_torch.configs.graphsage_reddit",
    "repro_torch.configs.din",
    "repro_torch.configs.sge",  # the paper's own workload
]


def register(arch: Arch) -> Arch:
    _REGISTRY[arch.name] = arch
    return arch


def get(name: str) -> Arch:
    load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def load_all() -> Dict[str, Arch]:
    for mod in ARCH_MODULES:
        importlib.import_module(mod)
    return dict(_REGISTRY)


def all_cells(include_skipped: bool = True) -> List[Cell]:
    out: List[Cell] = []
    for arch in load_all().values():
        for cell in arch.cells.values():
            if include_skipped or cell.build is not None:
                out.append(cell)
    return out


# ---------------------------------------------------------------------------
# helpers shared by arch config modules
# ---------------------------------------------------------------------------

def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def abstract_dict(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]):
    """``{name: (shape, dtype)}`` -> ``{name: meta tensor}``."""
    return {k: torch.empty(s, dtype=d, device="meta") for k, (s, d) in shapes.items()}
