"""K8 (the port's CSR arc sweep) of this checkout against another
checkout's, on one CUDA card, in turns.

  python3 benchmarks/bench_torch_csr_sweep.py --other PATH [--json OUT]

``PATH`` is the root of another checkout of this repository (for example a
``git archive`` of the parent commit unpacked into a directory that
``.gitignore`` lists).  The script compiles ``csr_arc_sweep`` from both
checkouts' ``src/repro_torch/csrc/`` with nvcc (``sm_90a``, the flags of
``repro_torch.kernels._build``) and loads each library under its own C
signature: the two-kernel sweep with its mask table (this tree's
``csr_arc_sweep_launch``, 15 parameters) or the one-kernel sweep of one block
per (arc, row tile) (13 parameters).  It holds each against the plain
version on every input set (0 mismatched words) and times them with CUDA
events in turns: other, this, this, other; each turn with a warm L2
(``chip_smoke.cuda_ms``) and with the L2 flushed before every call
(``chip_smoke.cuda_ms_cold``).  Input sets, built from the seeds of
``chip_smoke.py``'s phase 5:

* ``A``: target A's CSR planes (33,067 nodes, w 1,034) and the arcs of the
  phase-5 batch draw's pattern with the most arcs, masked by its final
  ``ri-ds-si-acfc`` domains (the device fixpoint's);
* ``B final``, ``B initial``, ``B zero``: target B's CSR planes (the
  power-law hub target, maximum degree 16,373) and the hub pattern's arcs,
  masked by its final ``ri-ds-si-acfc`` domains, by its initial label +
  degree domains, and by nothing (every entry read).

Prints one JSON line per turn, the bound of each input set (bytes over
3.35 TB/s, ``chip_smoke.csr_sweep_bytes``) and, last, the
card's name and power limit.  Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# PR 14's entry: seg_start, seg_len, indices, arc_row, masks, out, n_planes,
# n_t, n_idx, w, n_arcs, deg_cap, stream
_ONE_KERNEL_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def build(checkout: Path, out: Path):
    """``csr_arc_sweep`` of ``checkout`` compiled into ``out``: a function
    with the wrapper's arguments that launches it (under its own C
    signature)."""
    import torch

    from repro_torch.kernels import _build, domain_ac

    out.mkdir(parents=True, exist_ok=True)
    src = checkout / "src" / "repro_torch" / "csrc" / "csr_arc_sweep.cu"
    lib = out / "csr_arc_sweep.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{checkout}: csr_arc_sweep failed to build:\n{proc.stdout}"
                           f"{proc.stderr}")
    entry = re.search(r"csr_arc_sweep_launch\(([^)]*)\)", src.read_text()).group(1)
    fn = ctypes.CDLL(str(lib)).csr_arc_sweep_launch
    fn.restype = ctypes.c_int
    if entry.count(",") + 1 == len(_ONE_KERNEL_ARGTYPES):
        fn.argtypes = _ONE_KERNEL_ARGTYPES

        def sweep(seg_start, seg_len, indices, arc_row, masks, deg_cap):
            (n_planes, n_t), (n_arcs, w) = seg_start.shape, masks.shape
            res = torch.empty((n_arcs, n_t), dtype=torch.int32, device=masks.device)
            rc = fn(seg_start.data_ptr(), seg_len.data_ptr(), indices.data_ptr(),
                    arc_row.data_ptr(), masks.data_ptr(), res.data_ptr(), n_planes, n_t,
                    indices.shape[0], w, n_arcs, deg_cap,
                    torch.cuda.current_stream(masks.device).cuda_stream)
            if rc:
                raise RuntimeError(f"{checkout}: csr_arc_sweep failed with CUDA error {rc}")
            return res
        return sweep
    fn.argtypes = domain_ac._CSR_SWEEP_ARGTYPES

    def sweep(seg_start, seg_len, indices, arc_row, masks, deg_cap):
        _build._launchers["csr_arc_sweep"] = fn  # the wrapper launches this library
        return domain_ac.csr_arc_sweep_cuda(seg_start, seg_len, indices, arc_row, masks, deg_cap)
    return sweep


def input_sets(device) -> dict:
    """The timed sweeps: ``{label: (upload, arc_row, masks)}``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import SubgraphIndex, extend
    from repro_torch.core import domains as dom
    from repro_torch.data import graphgen

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

    target = graphgen.make_collection(**cs.SPARSE_COLLECTION)[0].target
    draw = [i for i in graphgen.make_collection(**cs.SPARSE_BATCH_COLLECTION)
            if i.target.n == target.n][:cs.SPARSE_BATCH]
    pat = max(draw, key=lambda i: dom.domain_bucket(i.pattern)[1]).pattern
    hub, hpat = cs.hub_target()
    sets = {}
    for label, (g, p) in (("A", (target, pat)), ("B", (hub, hpat))):
        index = SubgraphIndex.build(g, sparse=True)
        up = extend.upload_csr(index.csr_planes(), device)
        final = dom.compute_domains_csr(p, g, index.w, use_ac=True, use_fc=True,
                                        interleave=True, device=device).bits
        arc_row, masks = cs.sweep_arcs(p, final, index.n_edge_labels)
        if label == "A":
            sets["A"] = (up, dev(arc_row), dev(masks))
            continue
        _, initial = cs.sweep_arcs(p, dom.initial_domains_sparse(p, g, index.w),
                                   index.n_edge_labels)
        for name, m in (("final", masks), ("initial", initial), ("zero", 0 * masks)):
            sets[f"B {name}"] = (up, dev(arc_row), dev(m))
    return sets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other checkout")
    ap.add_argument("--json", type=Path, default=None, help="also write the turns here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_csr_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ref as kref

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = ROOT / "build" / "bench_csr_sweep"
    sweeps = {"this": build(ROOT, out / "this"),
              "other": build(args.other.resolve(), out / "other")}
    sets = input_sets(device)
    bounds = {}
    for label, (up, arc_row, masks) in sets.items():
        bounds[label] = cs.csr_sweep_bytes(up, arc_row, masks)
        bounds[label]["bound_ms"] = bounds[label]["bytes"] / cs.HBM_BYTES_PER_S * 1e3
    turns = []
    for turn, which in enumerate(("other", "this", "this", "other")):
        sweep = sweeps[which]
        res = dict(turn=turn, checkout=which)
        for label, (up, arc_row, masks) in sets.items():
            sargs = (*cs.csr_bounds(up), up.indices, arc_row, masks)
            got = sweep(*sargs, up.deg_cap)
            want = kref.csr_arc_sweep_ref(*sargs, deg_cap=up.deg_cap)
            torch.cuda.synchronize()
            if int((got != want).sum()):
                raise AssertionError(f"{which} disagrees with the plain version on {label}")
            res[label] = dict(ms=cs.cuda_ms(lambda: sweep(*sargs, up.deg_cap)),
                              cold_ms=cs.cuda_ms_cold(lambda: sweep(*sargs, up.deg_cap)))
        turns.append(res)
        print(json.dumps(res), flush=True)
    print(json.dumps(dict(bounds=bounds, seconds=time.perf_counter() - t0)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.json is not None:
        args.json.write_text(json.dumps(dict(turns=turns, bounds=bounds, card=smi), indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
