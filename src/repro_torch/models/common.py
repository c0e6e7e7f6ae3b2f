"""Shared model substrate: norms, activations, the matmul in the activation
dtype, parameter declarations and initialisers (a port of
``repro.models.common``).

The GNN and recsys models declare their parameters as ``ParamSpec`` trees,
as ``repro`` does, and so does the transformer: shape, logical sharding
axes (kept as plain data for the distributed layer), dtype, init and scale.
:func:`init_from_specs` draws such a tree from a ``torch.Generator``;
:func:`init_param` draws one leaf as ``ParamSpec.materialize`` does.
:func:`abstract_from_specs` gives the tree as ``device="meta"`` tensors,
which allocate nothing (``repro``'s ``ShapeDtypeStruct`` trees, the
registry's abstract arguments), and :func:`logical_from_specs` its logical
axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engine import resolve_device


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with fp32 statistics; the normed value is cast back to x's
    dtype before the gain is applied."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Primer's squared ReLU — nemotron-4's and minitron's activation."""
    r = torch.relu(x)
    return r * r


ACTIVATIONS: Dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "relu": torch.relu,
    "squared_relu": squared_relu,
}


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x``'s last axis against ``w``'s first, in the activation dtype."""
    return torch.matmul(x, w.to(x.dtype))


INIT_CHUNK = 1 << 26  # elements drawn in fp32 at a time: 256 MB


def init_param(shape: Sequence[int], init: str, dtype: torch.dtype,
               generator: torch.Generator, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """One parameter: ``zeros``, ``ones``, or (``normal``) a standard normal drawn in
    fp32, times ``scale`` (default ``1/√fan_in``, fan-in the second-to-last
    axis), then cast to ``dtype``.  The draw fills the parameter in slices of
    :data:`INIT_CHUNK` elements in storage order, so a bf16 parameter never
    has a whole fp32 copy beside it (grok-1's expert weights would need
    25.8 GB of it at 4 layers)."""
    shape = tuple(shape)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init != "normal":
        raise ValueError(f"unknown init {init!r}")
    fan_in = shape[-2] if len(shape) >= 2 else max(1, shape[-1])
    mult = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - start)
        x = torch.randn(n, generator=generator, dtype=torch.float32, device=device)
        flat[start:start + n] = x.mul_(mult)
    return out


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter declaration: shape, logical sharding axes, dtype, init
    (``normal`` | ``zeros`` | ``ones``) and scale (None: ``1/√fan_in``)."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"
    scale: Optional[float] = None

    def abstract(self) -> torch.Tensor:
        """A ``device="meta"`` tensor of the leaf's shape and dtype."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def materialize(self, generator: torch.Generator, device) -> torch.Tensor:
        return init_param(self.shape, self.init, self.dtype, generator, device, self.scale)


SpecTree = Dict[str, Any]  # nested dicts of ParamSpec


def map_specs(fn: Callable[[ParamSpec], Any], specs: SpecTree):
    """``fn`` over every ``ParamSpec`` of the tree, keeping its layout."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def abstract_from_specs(specs: SpecTree):
    """The tree as ``device="meta"`` tensors: shapes and dtypes, no storage."""
    return map_specs(ParamSpec.abstract, specs)


def logical_from_specs(specs: SpecTree):
    """The tree's logical axes, one tuple per leaf."""
    return map_specs(lambda s: s.logical, specs)


def init_from_specs(specs: SpecTree, seed_or_generator: Union[int, torch.Generator] = 0,
                    device=None):
    """Draw a ``ParamSpec`` tree on ``device`` (the card by default), leaf by
    leaf in sorted key order (JAX's flattening order) from one generator: a
    ``torch.Generator`` on that device, or one seeded with the given int.
    Same distributions as ``repro``'s ``init_from_specs``; not the same
    numbers."""
    device = resolve_device(device)
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed_or_generator))

    def draw(tree):
        if isinstance(tree, ParamSpec):
            return tree.materialize(gen, device)
        out = {k: draw(tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}

    return draw(specs)


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """A parameter tree of numpy arrays (``repro``'s parameters after
    ``jax.tree.map(np.asarray, params)``) as tensors on ``device`` (the
    card by default), in ``dtype`` or each array's own; ``router`` keeps its
    own (fp32) either way, as ``repro`` declares it.  bfloat16 arrays go
    through fp32, which is exact both ways."""
    device = resolve_device(device)

    def conv(a, key=None):
        if isinstance(a, dict):
            return {k: conv(x, k) for k, x in a.items()}
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(a)
        return t.to(device=device, dtype=t.dtype if key == "router" else dtype or t.dtype)

    return conv(tree)
