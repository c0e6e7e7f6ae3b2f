"""Error-feedback int8 gradient compression for bandwidth-bound DP links
(a port of ``repro.distributed.compression``).

For inter-pod data parallelism the all-reduce crosses the slowest links.
Scheme (1-bit Adam family, simplified to int8):

  1. ``e += g``                 (accumulate incoming grad into the residual)
  2. ``q = round(e / s) · s``   (per-tensor symmetric int8 quantization)
  3. ``e -= q``                 (keep the quantization error for next step)
  4. all-reduce ``q`` (int8 payload), decode.

The compression is lossless *in expectation* thanks to error feedback.
Each function is plain tensor arithmetic on the leaf's own device: an int8
payload, an fp32 scale and an fp32 residual, the same bits as ``repro``'s;
a bf16 gradient comes back as bf16.

Not wired into training: ``repro``'s docstring has ``make_train_step``
call ``compress_grads``, but ``repro.train`` has no call site, and
neither has `repro_torch.train.trainer`.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.train.tree import leaves, leaves_up_to, unflatten_like


def init_error(params) -> Any:
    return unflatten_like(params, (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                   for p in leaves(params)))


def compress(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """Returns (int8 payload, scale, new error residual)."""
    e = err + g.to(torch.float32)
    # true divisions by 0-d tensors on the leaf's device: a CUDA division by
    # a Python scalar multiplies by its reciprocal, which is not XLA's result
    scale = torch.clamp_min(e.abs().amax() / torch.tensor(127.0, device=e.device), 1e-12)
    q = torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, e - deq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, err_state):
    """Tree-wise error-feedback int8 round trip (the all-reduce between
    compression and decompression belongs to a data-parallel step)."""
    out_g, out_e = [], []
    for g, e in zip(leaves(grads), leaves_up_to(grads, err_state)):
        q, s, e2 = compress(g, e)
        out_g.append(decompress(q, s).to(g.dtype))
        out_e.append(e2)
    return unflatten_like(grads, out_g), unflatten_like(grads, out_e)
