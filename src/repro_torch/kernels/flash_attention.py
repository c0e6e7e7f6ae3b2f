"""K9, ``flash_attention``: causal attention forward, as a CUDA kernel.

``out[b, i] = Σ_{j ≤ i} softmax_j(q[b, i] · k[b, j] / √d) · v[b, j]`` over
a flattened batch·head axis: ``q`` ``[BH, S, d]``, ``k`` / ``v`` ``[BH,
S_kv, d]``, positions of both counted from 0.  The LM path's prefill
(`repro_torch.models.transformer`) runs every layer's self-attention
through it.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_kernel``), whose grid ``(BH, S/bq, S_kv/bk)``
ran in order and carried the online-softmax state in VMEM from one KV
block to the next.  The CUDA kernel (``csrc/flash_attention.cu``) gives one
256-thread block to each (bh, 64-row query tile) and loops over 64-key
tiles inside it: K and V staged in shared memory as fp32, scores, running
max and denominator in fp32, the accumulator in registers, rescaled per
tile; tiles wholly above the diagonal are skipped.  Ragged ``S`` and
``S_kv`` are masked in the kernel, so ``block_q`` / ``block_k`` (the TPU
kernel's block sizes, which had to divide the lengths) do not change the
result and are only checked.  fp32 or bf16 inputs, ``d ≤ 256``; the
output has q's dtype.  It is bound by operations:
``2 · BH · d · S · (S + 1)`` FLOPs for ``S == S_kv`` (QKᵀ and PV over the
causal triangle) at the card's dense bf16 tensor rate; this first kernel
runs fp32 FMAs on the CUDA cores.

The plain version is `repro_torch.kernels.ref.flash_attention_ref`;
`repro_torch.kernels.ops.flash_attention` picks between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref  # noqa: F401  (the plain version)

launches = 0  # kernel launches since ops.reset_launch_counts()

MAX_HEAD_DIM = 256
Q_TILE = 64  # query rows per block (csrc/flash_attention.cu kBQ)
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_void_p])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Launch the kernel on the current stream; returns ``[BH, S, d]`` in
    q's dtype.  ``block_q`` / ``block_k`` must be positive; the kernel
    tiles by itself."""
    global launches
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{name} must be float32 or bfloat16 like q, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [BH, S, d] tensor, "
                             f"got {tuple(t.shape)}")
    bh, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{bh}, S_kv, {d}]")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, {block_k}")
    if bh * -(-s // Q_TILE) >= 2**31:
        raise ValueError(f"{bh} x {s} is too many query tiles for one launch")
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    fn = _build.launcher("flash_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, k.shape[1], d,
            int(q.dtype == torch.bfloat16), 1.0 / d ** 0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {rc}")
    launches += 1
    return out
