"""Shared model substrate: norms, activations, the matmul in the activation
dtype, and the parameter initialiser (the numeric half of
``repro.models.common``).

``repro`` declares parameters as ``ParamSpec`` trees that also carry
abstract shapes and logical sharding axes for its multi-device lowering.
The port keeps plain dicts of tensors and a shape table per model
(`repro_torch.models.transformer.param_shapes`); :func:`init_param` draws one
leaf as ``ParamSpec.materialize`` does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F


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
    """One parameter: ``ones``, or (``normal``) a standard normal drawn in
    fp32, times ``scale`` (default ``1/√fan_in``, fan-in the second-to-last
    axis), then cast to ``dtype``.  The draw fills the parameter in slices of
    :data:`INIT_CHUNK` elements in storage order, so a bf16 parameter never
    has a whole fp32 copy beside it (grok-1's expert weights would need
    25.8 GB of it at 4 layers)."""
    shape = tuple(shape)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else max(1, shape[-1])
    mult = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - start)
        x = torch.randn(n, generator=generator, dtype=torch.float32, device=device)
        flat[start:start + n] = x.mul_(mult)
    return out
