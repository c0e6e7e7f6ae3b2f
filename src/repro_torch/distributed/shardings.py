"""Logical-axis sharding: mesh-agnostic PartitionSpecs (a port of
``repro.distributed.shardings``).

Models annotate tensors with *logical* axis names; this module maps them to
whatever mesh is in use (`repro_torch.core.engine.Mesh`).  The production
meshes (`repro_torch.launch.mesh`) are ``(data=16, model=16)`` single-pod
and ``(pod=2, data=16, model=16)`` multi-pod; a local mesh of one card maps
everything to ``None`` (replicated).

Logical axes:
  * ``batch``  — data-parallel batch dim → ``('pod', 'data')``.
  * ``fsdp``   — ZeRO-3/FSDP parameter dim → ``('pod', 'data')``.
  * ``tensor`` — tensor-parallel dim (heads / d_ff / vocab / experts / bitmap
                 words) → ``'model'``.
  * ``expert`` — expert-parallel dim → ``'model'``.
  * ``seq``    — sequence dim (KV-cache length in decode) → ``'model'``.
  * ``edge``   — GNN edge dim → ``('pod', 'data', 'model')`` (flattened).
  * ``worker`` — SGE worker dim → ``('pod', 'data')``.
  * ``query``  — independent SGE query dim → ``'pod'``.

Divisibility: an axis mapping is applied only if the dim size is divisible by
the mapped mesh-axis product; otherwise the dim is replicated, and each mesh
axis is used once per spec.  These rules read only ``mesh.shape``.

A :class:`NamedSharding` says which block of a tensor each mesh device
holds (:meth:`NamedSharding.device_index`), ``jax.sharding.NamedSharding``'s
``devices_indices_map`` in mesh order; `repro_torch.checkpoint.reshard`
places tensors by it and `repro_torch.launch.dryrun` counts bytes by it.

:func:`constraint` is the identity.  ``repro``'s hands a hint to the XLA
partitioner inside the mesh found by ``_current_mesh``; the port has no
partitioner to hint and no ambient mesh, so ``_current_mesh`` has no
counterpart, and the models drop their hints as they always have.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core.engine import Mesh
from repro_torch.train.tree import _is_namedtuple, tree_map

LogicalAxis = Optional[str]

_DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "tensor": ("model",),
    "expert": ("model",),
    "seq": ("model",),
    "edge": ("pod", "data", "model"),
    "worker": ("pod", "data"),
    "query": ("pod",),
    None: (),
}


class PartitionSpec(tuple):
    """Per dimension ``None`` (replicated), a mesh axis name, or a tuple of
    names (the dimension split over their product, the first major).
    ``PartitionSpec()`` is a scalar's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_logical_leaf(x) -> bool:
    """``repro``'s leaf rule for logical-axis trees: a plain tuple of axis
    names or ``None``s (``()`` included).  ``None`` itself is a leaf too:
    it stands beside a leaf that is not a tensor (a plan's ``deg_cap``)."""
    return x is None or (isinstance(x, tuple) and not _is_namedtuple(x)
                         and all(isinstance(e, (str, type(None))) for e in x))


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _mesh_axis_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes)


def logical_to_pspec(
    logical: Sequence[LogicalAxis],
    shape: Sequence[int],
    mesh,
    rules: Optional[dict] = None,
) -> PartitionSpec:
    """Map per-dim logical axis names to a PartitionSpec for ``mesh``.

    Drops mappings whose mesh axes are absent or whose dim size is not
    divisible by the mesh-axis product (replicates instead).
    """
    rules = rules or _DEFAULT_RULES
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {tuple(logical)} do not match shape {tuple(shape)}")
    spec = []
    used: set = set()
    for name, dim in zip(logical, shape):
        axes = tuple(a for a in rules.get(name, ()) if a in mesh.shape and a not in used)
        size = _mesh_axis_size(mesh, axes)
        if axes and size > 1 and dim % size == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            spec.append(None)
    return P(*spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh."""

    mesh: Mesh
    spec: PartitionSpec

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of the block each device holds."""
        return tuple(d // _mesh_axis_size(self.mesh, _axes(e))
                     for d, e in zip(global_shape, self._padded(global_shape)))

    def device_index(self, global_shape: Sequence[int]) -> list:
        """Each mesh device's block, in mesh order, as a tuple of slices
        (``slice(None)`` where the dimension is whole)."""
        sizes = self.mesh.axis_sizes
        out = []
        for flat in range(self.mesh.size):
            coord = dict(zip(self.mesh.axis_names, _unravel(flat, sizes)))
            idx = []
            for d, entry in zip(global_shape, self._padded(global_shape)):
                axes = _axes(entry)
                if not axes:
                    idx.append(slice(None))
                    continue
                block, n = 0, 1
                for a in axes:  # the first axis major
                    block, n = block * self.mesh.shape[a] + coord[a], n * self.mesh.shape[a]
                step = d // n
                idx.append(slice(block * step, (block + 1) * step))
            out.append(tuple(idx))
        return out

    def _padded(self, global_shape) -> tuple:
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than shape {tuple(global_shape)}")
        return tuple(self.spec) + (None,) * (len(global_shape) - len(self.spec))


def _unravel(flat: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    coord = []
    for n in reversed(sizes):
        coord.append(flat % n)
        flat //= n
    return tuple(reversed(coord))


def named_sharding(
    logical: Sequence[LogicalAxis],
    shape: Sequence[int],
    mesh: Mesh,
    rules: Optional[dict] = None,
) -> NamedSharding:
    return NamedSharding(mesh, logical_to_pspec(logical, shape, mesh, rules))


def tree_shardings(logical_tree, abstract_tree, mesh: Mesh, rules: Optional[dict] = None):
    """Zip a tree of logical-axis tuples with the matching tree of tensors
    (meta or concrete) into NamedShardings; a ``None`` logical, which
    stands beside a leaf that is not a tensor, gives ``None``."""

    def one(log, ab):
        if log is None:
            if isinstance(ab, torch.Tensor):
                raise ValueError(f"a tensor of shape {tuple(ab.shape)} has no logical axes")
            return None
        return named_sharding(log, ab.shape, mesh, rules)

    return tree_map(one, logical_tree, abstract_tree, is_leaf=is_logical_leaf)


def constraint(x: Any, logical: Sequence[LogicalAxis], mesh: Optional[Mesh] = None):
    """``repro``'s sharding hint: the identity (no partitioner to hint)."""
    return x
