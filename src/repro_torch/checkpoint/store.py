"""Atomic checkpoints in ``repro.checkpoint.store``'s format (a port).

Layout:  ``<dir>/step_<n>/`` containing
  * ``manifest.json`` — each leaf's shape and dtype, the step, the time and
    ``process_count`` (1), written LAST: a directory without a manifest is
    an aborted write and is ignored;
  * ``arrays.npz``    — the leaves of ``{"params": ..., "opt_state": ...}``
    keyed by their JAX ``keystr`` paths (``['params']['layers']['wq']``,
    ``['opt_state'].mu['embed']``, ``['opt_state'].step``;
    `repro_torch.train.tree`).

A bfloat16 leaf is stored as ``repro`` stores it: two-byte records (npy
``descr`` ``'<V2'``) with ``"bfloat16"`` in the manifest.  ``restore`` reads
the manifest's dtype, so such a leaf comes back as a bfloat16 tensor.

Writes go to ``<dir>/.tmp_step_<n>`` and are renamed to ``step_<n>``
(atomic on POSIX), then all but the newest ``keep`` checkpoints are
removed.  ``async_write=True`` copies every leaf to host memory before
``save`` returns (training goes on updating the tensors in place), then
writes on a background thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths, unflatten_like

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_writer_lock = threading.Lock()
_writers: "set[threading.Thread]" = set()  # async writes not yet joined
_writers_lock = threading.Lock()


def _host_copy(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy (bfloat16 as its int16 bits) and
    its dtype's name."""
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _write_npz(path: str, host: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """``np.savez``'s archive, with each bfloat16 leaf's header naming
    two-byte records (``'<V2'``), as numpy writes a JAX bfloat16 array."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, name) in host.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if name == "bfloat16":
                    header = np.lib.format.header_data_from_array_1_0(arr)
                    header["descr"] = "<V2"
                    np.lib.format.write_array_header_1_0(fid, header)
                    fid.write(memoryview(arr.reshape(-1)).cast("B"))
                else:
                    np.lib.format.write_array(fid, arr)


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def save(
    base: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    keep: int = 3,
    async_write: bool = False,
    extra_meta: Optional[dict] = None,
) -> str:
    """Write an atomic checkpoint; returns the final directory path."""
    tree = {"params": params, "opt_state": opt_state}
    # snapshot to host memory synchronously (the tensors are updated in place)
    host = {k: _host_copy(v) for k, v in leaves_with_paths(tree)}
    meta = {
        "step": step,
        "time": time.time(),
        "n_leaves": len(host),
        "leaves": {
            k: {"shape": list(arr.shape), "dtype": name} for k, (arr, name) in host.items()
        },
        "process_count": 1,
        **(extra_meta or {}),
    }

    def _write():
        with _writer_lock:
            os.makedirs(base, exist_ok=True)
            tmp = os.path.join(base, f".tmp_step_{step:08d}")
            final = _step_dir(base, step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            _write_npz(os.path.join(tmp, _ARRAYS), host)
            # manifest last == completion marker
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(meta, f, indent=2)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _gc(base, keep)

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        with _writers_lock:
            _writers.add(t)
        t.start()
    else:
        _write()
    return _step_dir(base, step)


def _gc(base: str, keep: int) -> None:
    steps = list_steps(base)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


def list_steps(base: str):
    if not os.path.isdir(base):
        return []
    out = []
    for name in os.listdir(base):
        if name.startswith("step_") and os.path.exists(
            os.path.join(base, name, _MANIFEST)
        ):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(
    base: str, step: int, like_params: Any = None, like_opt: Any = None
) -> Tuple[int, Any, Any]:
    """Load a checkpoint.  With ``like_*`` trees given, each leaf is copied
    into its ``like`` leaf in place (so a resumed run holds one copy of its
    state on the card) and the ``like`` trees are returned; a ``like`` leaf
    that is not a tensor of the stored shape and the manifest's dtype is
    replaced by a new tensor in that dtype, on the ``like`` leaf's device.
    Without ``like_*``, a flat dict of CPU tensors keyed by tree path is
    returned."""
    d = _step_dir(base, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        meta = json.load(f)
    dtypes = {k: v["dtype"] for k, v in meta["leaves"].items()}
    with np.load(os.path.join(d, _ARRAYS)) as data:
        def load(key):
            return _to_tensor(data[key], dtypes[key])

        def into(like, prefix):
            out = []
            for path, leaf in leaves_with_paths(like):
                t = load(prefix + path)
                if (isinstance(leaf, torch.Tensor) and leaf.shape == t.shape
                        and leaf.dtype == t.dtype):
                    with torch.no_grad():
                        leaf.copy_(t)
                    out.append(leaf)
                else:
                    out.append(t.to(leaf.device if isinstance(leaf, torch.Tensor) else "cpu"))
            return unflatten_like(like, out)

        if like_params is None:
            return meta["step"], {k: load(k) for k in data.files}, None
        params = into(like_params, "['params']")
        opt = into(like_opt, "['opt_state']") if like_opt is not None else None
    return meta["step"], params, opt


def restore_latest(
    base: str, like_params: Any = None, like_opt: Any = None
) -> Optional[Tuple[int, Any, Any]]:
    steps = list_steps(base)
    if not steps:
        return None
    return restore(base, steps[-1], like_params, like_opt)


def wait_for_writes() -> None:
    """Barrier for in-flight async writes (tests / clean shutdown)."""
    with _writers_lock:
        pending = list(_writers)
        _writers.clear()
    for t in pending:
        t.join()
