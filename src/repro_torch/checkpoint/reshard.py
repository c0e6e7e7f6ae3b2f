"""Elastic re-sharding: restore a checkpoint onto a different mesh (a port
of ``repro.checkpoint.reshard``).

Checkpoints store *logical* (unsharded) arrays (`repro_torch.checkpoint.
store`), so elasticity is a placement problem, not a data problem: given
the restored host tensors and a new mesh, :func:`place` cuts each leaf
into the blocks its logical axes give on that mesh
(`repro_torch.distributed.shardings.named_sharding`) and copies each block
to its device.  A dim no longer divisible by the new axis product falls
back to replication.  :func:`gather` puts a placed leaf back together.

A placed leaf holds one shard per mesh device, in mesh order; each shard is
a contiguous copy in storage of its own, so a mesh that repeats a device
holds that device's blocks side by side, and replicated dimensions stay
whole in every shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.engine import Mesh
from repro_torch.distributed.shardings import NamedSharding, is_logical_leaf, named_sharding
from repro_torch.train.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class PlacedLeaf:
    """A tensor laid over a mesh: its global shape and dtype, its sharding
    and one shard per mesh device, in mesh order."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    shards: Tuple[torch.Tensor, ...]

    @property
    def nbytes(self) -> int:
        """The bytes the shards hold, over every device."""
        return sum(s.numel() * s.element_size() for s in self.shards)


def _place(x, logical, mesh: Mesh):
    if not isinstance(x, torch.Tensor):
        return x  # a leaf that is not a tensor (its logical is None) stays as it is
    sh = named_sharding(logical, x.shape, mesh)
    shards = []
    for dev, idx in zip(mesh.devices, sh.device_index(x.shape)):
        block = x[idx]
        shard = torch.empty(block.shape, dtype=x.dtype, device=dev)
        shard.copy_(block)
        shards.append(shard)
    return PlacedLeaf(tuple(x.shape), x.dtype, sh, tuple(shards))


def place(host_tree: Any, logical_tree: Any, mesh: Mesh):
    """Each tensor of ``host_tree`` (the tree ``store.restore`` returns,
    unflattened) laid over ``mesh`` by the logical axes of its place in
    ``logical_tree``: a tree of :class:`PlacedLeaf`."""
    return tree_map(lambda log, x: _place(x, log, mesh), logical_tree, host_tree,
                    is_leaf=is_logical_leaf)


def _gather_leaf(leaf: PlacedLeaf, device=None) -> torch.Tensor:
    out = torch.empty(leaf.shape, dtype=leaf.dtype,
                      device=device if device is not None else leaf.shards[0].device)
    seen = set()
    for shard, idx in zip(leaf.shards, leaf.sharding.device_index(leaf.shape)):
        key = tuple((s.start, s.stop) for s in idx)
        if key not in seen:  # a replicated block is copied once
            seen.add(key)
            out[idx] = shard
    return out


def gather(placed, device=None):
    """A placed leaf (or a tree of them) put back together on ``device``
    (by default its first shard's)."""
    if isinstance(placed, PlacedLeaf):
        return _gather_leaf(placed, device)
    is_placed = lambda x: isinstance(x, PlacedLeaf)  # noqa: E731
    return unflatten_like(placed, (_gather_leaf(x, device) if is_placed(x) else x
                                   for x in leaves(placed, is_placed)), is_placed)
