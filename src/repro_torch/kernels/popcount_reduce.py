"""K3, ``popcount_rows``: per-row popcount of packed bitmaps, as a CUDA
kernel.

``out[r] = popcount(bits[r, :])`` for an ``[n, w]`` bitmap of int32 words,
as ``[n]`` int32.  The device domain fixpoint
(`repro_torch.core.domains`) takes domain sizes with it: the empty-domain
test after every sweep and the singleton test of forward checking.

Replaces the Pallas TPU kernel ``repro/kernels/popcount_reduce.py``
(``popcount_rows``, grid over 256-row tiles padded to 128-word lanes).  The
CUDA kernel (``csrc/popcount_rows.cu``) gives one warp to each row: lanes
sum ``__popc`` over a stride of the words and a shuffle reduction adds them.
It is bound by memory: a launch reads ``n · w · 4`` bytes and writes
``4 · n``.  CUDA C++ rather than Triton only so that every kernel of the
port shares one build path.

The plain version is `repro_torch.kernels.ref.popcount_rows_ref`;
`repro_torch.kernels.ops.popcount_rows` picks between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import popcount_rows_ref  # noqa: F401  (the plain version)

launches = 0  # kernel launches since ops.reset_launch_counts()

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def popcount_rows_cuda(bits: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; ``[n, w] -> [n]`` int32."""
    global launches
    _build.check_cuda_args((bits,), ("bits",))
    if bits.dim() != 2:
        raise ValueError(f"bits must be [n, w], got {tuple(bits.shape)}")
    n, w = bits.shape
    out = torch.empty((n,), dtype=torch.int32, device=bits.device)
    if n == 0:
        return out
    fn = _build.launcher("popcount_rows", _ARGTYPES)
    rc = fn(bits.data_ptr(), out.data_ptr(), n, w,
            torch.cuda.current_stream(bits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"popcount_rows launch failed with CUDA error {rc}")
    with _build.LAUNCH_LOCK:
        launches += 1
    return out
