"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each source ``src/repro_torch/csrc/<name>.cu`` exports one C function,
``<name>_launch``, and is compiled into its own shared library for Hopper
(``sm_90a``).  Libraries go into ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of the source, the local headers it
includes (``#include "..."``, e.g. ``arc_any.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  Nothing is compiled when
a module is imported: the first launch of a kernel builds it, and
:func:`build` builds several at once, one ``nvcc`` process per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("candidate_mask", "extend_step", "popcount_rows", "adjacency_any", "arc_any_sweep",
           "csr_extend", "csr_extend_bucketed", "csr_arc_sweep", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_launchers: Dict[str, Callable] = {}
# builds and loads may be asked for from several threads at once (a
# service's dispatcher and its clients): one at a time, so a library is
# compiled once and never loaded half-written
_build_lock = threading.RLock()
# the kernel modules' launch counters are bumped under this lock: a
# service launches kernels from its dispatcher and its client threads
LAUNCH_LOCK = threading.Lock()
_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every local header it includes, directly or
    through another header (``#include "..."``, resolved beside the
    including file, as nvcc does first)."""
    out: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in out:
            continue
        out.append(path)
        todo += [path.parent / inc for inc in _LOCAL_INCLUDE.findall(path.read_text())]
    return out


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a hash
    of its :func:`sources` and the flags."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, in parallel.

    Returns the seconds each compile took (0.0 for a library that was
    already built).  ``nvcc``'s register and shared-memory report
    (``-Xptxas -v``) is kept beside each library as ``<lib>.log``.
    Raises ``RuntimeError`` with the compiler's output if any compile fails.
    """
    names = list(names)
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.is_file():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out, time.perf_counter())
        seconds = {name: 0.0 for name in names}
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            out.with_suffix(".so.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return seconds


def build_log(name: str) -> str:
    """The compiler's output from building ``name`` ('' if none kept)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.is_file() else ""


def launcher(name: str, argtypes: Sequence[type]):
    """The ``<name>_launch`` C function, building and loading it on first
    use.  Pointer and stream arguments must be declared ``c_void_p``, or
    ctypes would pass them as 32-bit ints."""
    fn = _launchers.get(name)
    if fn is None:
        with _build_lock:
            fn = _launchers.get(name)
            if fn is None:
                build([name])
                fn = getattr(ctypes.CDLL(str(library_path(name))), f"{name}_launch")
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _launchers[name] = fn
    return fn


def header_constants(text: str) -> dict:
    """The integer ``constexpr``s of a CUDA header, by name: a value is an
    integer literal or a product of literals and earlier constants."""
    out = {}
    for name, expr in re.findall(r"constexpr\s+[\w ]+?\s+(k\w+)\s*=\s*([^;]+);", text):
        val = 1
        for tok in expr.split("*"):
            tok = tok.strip().rstrip("uUlL")
            val *= out[tok] if tok in out else int(tok, 0)
        out[name] = val
    return out


def check_cuda_args(tensors, names):
    """Raise unless every tensor is a contiguous int32 CUDA tensor on one
    device (what the kernels take)."""
    dev = tensors[0].device
    for t, name in zip(tensors, names):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
