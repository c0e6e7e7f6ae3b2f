"""Mesh construction (a port of ``repro.launch.mesh``).

The production topology keeps ``repro``'s shapes and names: one pod is
``(data=16, model=16)`` = 256 devices, multi-pod adds a leading pod axis,
``(pod=2, data=16, model=16)`` = 512.  Here it is laid over
``torch.device("meta")`` placeholders, which allocate nothing and need no
setting made before import (``repro`` forces 512 host devices through
``XLA_FLAGS`` instead); the dry-run (`repro_torch.launch.dryrun`) reads
shard shapes off it, and no engine runs on it
(`repro_torch.core.engine.coerce_mesh` refuses it).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.engine import Mesh, resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The target topology over meta placeholders: (data=16, model=16) =
    256 devices; multi-pod (pod=2, data=16, model=16) = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh((torch.device("meta"),) * math.prod(shape), axes, shape)


def make_local_mesh(axes: Sequence[str] = ("data", "model"), device=None) -> Mesh:
    """Every card on the first axis, shape ``(n, 1, …)``; with
    ``device="cpu"`` the one CPU device.  Raises where no card is present
    unless the CPU is asked for."""
    device = resolve_device(device)
    if device.type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        devices = (device,)
    return Mesh(devices, tuple(axes), (len(devices),) + (1,) * (len(axes) - 1))


def describe(mesh: Mesh) -> str:
    return f"mesh{dict(mesh.shape)} over {mesh.size} devices"
