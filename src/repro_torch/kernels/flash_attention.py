"""K9, ``flash_attention``: causal attention forward, as a CUDA kernel.

``out[b, i] = Σ_{j ≤ i} softmax_j(q[b, i] · k[b, j] / √d) · v[b, j]`` over
a flattened batch·head axis: ``q`` ``[BH, S, d]``, ``k`` / ``v`` ``[BH,
S_kv, d]``, positions of both counted from 0.  The LM path's prefill
(`repro_torch.models.transformer`) runs every layer's self-attention
through it.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_kernel``), whose grid ``(BH, S/bq, S_kv/bk)``
ran in order and carried the online-softmax state in VMEM from one KV
block to the next.  The CUDA kernels (``csrc/flash_attention.cu``) give one
block to each (bh, query tile) and loop over KV tiles inside it, with
scores, running max and denominator in fp32; tiles wholly above the
diagonal are skipped.  Ragged ``S`` and ``S_kv`` are masked in the
kernels, so ``block_q`` / ``block_k`` (the TPU kernel's block sizes, which
had to divide the lengths) do not change the result and are only checked.
fp32 or bf16 inputs, ``d ≤ 256``; the output has q's dtype.

- bf16 runs on the tensor cores: 128 query rows per block, TMA loads into
  a two-stage K/V ring, ``wgmma`` for QKᵀ and for PV, with P from
  registers in two bf16 terms (``bf16(P)`` and the rest; one term misses
  the bf16 gate where large values of v cancel) and the denominator
  summing P in fp32.  TMA needs rows of a multiple of 16 bytes, so a head
  width that is not a multiple of 8 is zero-padded here
  (:func:`pad_head_dim`) and the output sliced back; the scale stays
  ``1/√d`` of the real width.
- fp32 runs on the CUDA cores (64 × 64 tiles staged as fp32): the tensor
  cores would round fp32 inputs to TF32.

It is bound by operations: ``2 · BH · d · S · (S + 1)`` FLOPs for
``S == S_kv`` (QKᵀ and PV over the causal triangle), at the card's dense
bf16 tensor rate for bf16 and its fp32 rate for fp32.

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
Q_TILE = 64  # fewest query rows per block (csrc/flash_attention.cu: fp32 kBQ)
ROW_ALIGN = 8  # bf16 head widths per TMA row: rows of a multiple of 16 bytes
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_void_p])


def padded_head_dim(d: int) -> int:
    """The head width the bf16 kernel is given: ``d`` rounded up to a
    multiple of :data:`ROW_ALIGN`."""
    return -(-d // ROW_ALIGN) * ROW_ALIGN


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` ``[..., d]`` zero-padded to ``[..., width]``, contiguous and
    16-byte aligned, as a TMA tensor map needs it (``t`` itself when it
    already is)."""
    if t.shape[-1] != width:
        t = torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    if t.data_ptr() % 16:
        t = t.clone()
    return t


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
    if bh == 0 or s == 0:
        return torch.empty_like(q)
    scale = 1.0 / d ** 0.5
    is_bf16 = q.dtype == torch.bfloat16
    width = padded_head_dim(d) if is_bf16 else d
    if is_bf16:
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    out = torch.empty(bh, s, width, dtype=q.dtype, device=dev)
    fn = _build.launcher("flash_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, k.shape[1], width,
            int(is_bf16), scale, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {rc}")
    with _build.LAUNCH_LOCK:
        launches += 1
    return out if width == d else out[..., :d].contiguous()
