"""K1 and K2 (the port's dense step) of this checkout against another
checkout's, on one CUDA card, in turns.

  python3 benchmarks/bench_torch_dense_step.py --other PATH [--json OUT]

``PATH`` is the root of another checkout of this repository (for example a
``git archive`` of the parent commit unpacked into a directory that
``.gitignore`` lists).  The script compiles ``extend_step`` and
``candidate_mask`` from both checkouts' ``src/repro_torch/csrc/`` with
nvcc (``sm_90a``, the flags of ``repro_torch.kernels._build``), loads both
through ctypes under the C signatures the two share, holds each against
the plain version on every input set (0 mismatched words), and times them
with CUDA events (``chip_smoke.cuda_ms``, L2 warm) in turns: other, this,
this, other.  Input sets, each from a numpy seed:

* ``table``: b 4,096, w 393, mp 8 (``chip_smoke.kernel_inputs``), the
  kernel table's inputs;
* ``w1034``: the same recipe at w 1,034;
* mostly empty batches of 4,096 lanes at w 393, the kind phase 3's main
  path sends (about one lane in 4,096 valid): every lane empty; two lanes
  wanting a child with 2 and with 8 real parent rows; every lane a match.

Prints one JSON line per turn, the bound of each input set (bytes over
3.35 TB/s, ``chip_smoke``'s accounting) and, last, the card's name and
power limit.  Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

KERNELS = ("extend_step", "candidate_mask")


def build(checkout: Path, out: Path) -> dict:
    """Both kernels of ``checkout`` compiled into ``out``; their C entries."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import candidate_mask as cm_mod
    from repro_torch.kernels import extend_step as es_mod

    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(checkout / "src" / "repro_torch" / "csrc" / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in KERNELS}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{checkout}: {name} failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"{name}.so")), f"{name}_launch")
        fn.argtypes = list(es_mod._ARGTYPES if name == "extend_step" else cm_mod._ARGTYPES)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def input_sets(device) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs

    rng = np.random.default_rng(11)
    n_rows = 2 * cs.N_T
    table, n_p = cs.kernel_inputs(rng, 4096, (cs.N_T + 31) // 32, 8, n_rows, 32, device)
    wide, n_pw = cs.kernel_inputs(rng, 4096, 1034, 8, 2 * 33067 // 8, 32, device)
    sets = {"table": (table, n_p), "w1034": (wide, n_pw)}
    empty = {k: v.clone() for k, v in table.items()}
    empty["cand"].zero_()
    sets["all lanes empty"] = (empty, n_p)
    for n_real in (2, 8):
        x = {k: v.clone() for k, v in empty.items()}
        for lane in (7, 100):
            x["cand"][lane, 5] = 1 << 3
            x["depth"][lane] = 0
            x["row_idx"][lane] = torch.arange(8, device=device, dtype=torch.int32) * 3 + lane
            x["row_idx"][lane, n_real:] = n_rows
        sets[f"two lanes want a child, {n_real} rows"] = (x, n_p)
    matches = {k: v.clone() for k, v in empty.items()}
    matches["cand"][:, 5] = 1 << 3
    matches["depth"].fill_(n_p - 1)
    sets["every lane a match"] = (matches, n_p)
    return sets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other checkout")
    ap.add_argument("--json", type=Path, default=None, help="also write the turns here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_dense_step: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import candidate_mask as cm_mod
    from repro_torch.kernels import extend_step as es_mod

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = ROOT / "build" / "bench_dense_step"
    libs = {"this": build(ROOT, out / "this"), "other": build(args.other.resolve(), out / "other")}
    sets = input_sets(device)
    bounds = {}
    for label, (x, n_p) in sets.items():
        n_rows = x["rows"].shape[0] - 1
        bounds[label] = dict(
            extend_step=cs.extend_step_bytes(x, n_rows, n_p) / cs.HBM_BYTES_PER_S * 1e3,
            candidate_mask=cs.candidate_mask_bytes(x, n_rows) / cs.HBM_BYTES_PER_S * 1e3)
    turns = []
    for turn, which in enumerate(("other", "this", "this", "other")):
        _build._launchers.update(libs[which])  # the wrappers launch these libraries
        res = dict(turn=turn, checkout=which)
        for label, (x, n_p) in sets.items():
            case = cs.dense_step_case(x, n_p)
            if case["extend_step_mismatches"] or case["candidate_mask_mismatches"]:
                raise AssertionError(f"{which} disagrees with the plain version on {label}: {case}")
            k1, k2 = cs.dense_step_args(x, n_p)
            res[label] = dict(extend_step_ms=cs.cuda_ms(lambda: es_mod.extend_step_cuda(*k1)),
                              candidate_mask_ms=cs.cuda_ms(
                                  lambda: cm_mod.candidate_mask_cuda(*k2)))
        turns.append(res)
        print(json.dumps(res), flush=True)
    print(json.dumps(dict(bounds_ms=bounds, seconds=time.perf_counter() - t0)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.json is not None:
        args.json.write_text(json.dumps(dict(turns=turns, bounds_ms=bounds, card=smi), indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
