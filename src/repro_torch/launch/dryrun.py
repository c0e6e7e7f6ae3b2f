"""Multi-pod dry run (a port of ``repro.launch.dryrun``): every (architecture
× input shape × mesh) cell's shardings and bytes per device, from meta
tensors — nothing is allocated, on the host or on a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch din --shape serve_bulk
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --force
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Results land in artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json
(resumable — existing results are kept unless --force), beside and never
over ``repro``'s artifacts/dryrun/.

Design note
===========

``repro`` forces 512 host devices before JAX starts, lays the production
meshes over them, and lowers and compiles every cell's step with its
arguments' shardings, reading XLA's memory and cost analyses off the
compiled program.  The port has no compiler to ask.  Four decisions follow.

**What a mesh is.**  One class, `repro_torch.core.engine.Mesh`, serves the
engine and the models, as one ``jax.sharding.Mesh`` serves both in
``repro``.  It has named axes with sizes; its devices are a flat tuple in
row-major order whose length is the product of the sizes.  The default is
the 1-D ``("data",)`` mesh the engine has always sharded its workers over,
so a 1-D call is unchanged; on an N-D mesh the workers shard over the
``data`` axis and shard ``k`` runs on the first device of its data slice
(``repro``'s ``shard_map`` replicates it over the other axes).  The
production topology keeps ``repro``'s shapes and names, ``(data=16,
model=16)`` and ``(pod=2, data=16, model=16)``, laid over
``torch.device("meta")`` repeated 256 or 512 times
(`repro_torch.launch.mesh`): the counterpart of the 512 forced host
devices, with no environment variable to set before import and nothing
allocated.  No engine runs on placeholders: ``coerce_mesh`` refuses them.

**What the dry-run computes where ``repro`` compiles.**  For each cell ×
mesh and each argument leaf: its ``PartitionSpec`` from the cell's logical
axes (`repro_torch.distributed.shardings.logical_to_pspec`, ``repro``'s
rules, which read only the mesh's shape), its per-device shard shape, and
its bytes per device.  Storage is counted once: a view of another leaf
(the ``sge`` plan's ``adj_bits`` is a view of ``rows``) adds nothing.  The
record keeps ``repro``'s key names where the quantity is the same:
``memory_analysis.argument_size_in_bytes`` (the arguments' bytes per
device) and ``memory_analysis.alias_size_in_bytes`` (the donated
arguments' bytes per device).  XLA drops arguments the step never reads,
so ``repro``'s compiled figure can be smaller than this arithmetic (the
``sge`` rounds' ``order_valid``).  What only a compiler knows —
``cost_analysis``, ``output_size`` / ``temp_size``,
``collective_bytes``, ``hlo_walk``, ``op_counts``, ``hlo_lines``,
``lower_s`` / ``compile_s`` — is named under ``not_computed``.  FLOPs
counted by ``torch.utils.flop_counter`` on the meta cells are left to the
benchmark: the MoE dispatch reads a count back and an engine round syncs
with the host, and neither runs on meta tensors.

**Why not ``DeviceMesh`` / ``DTensor``.**  Both need a process group, and
the port's mesh is one process driving a tuple of devices, with no
process groups (tests run in-process under xdist).  They also cannot lay a
mesh over placeholder devices or over one device repeated, which the
dry-run and the one-card tests need.

**What ``constraint`` is.**  The identity
(`repro_torch.distributed.shardings.constraint`): there is no partitioner
to pass a hint to, and the models keep dropping their hints.

The placement that a mesh of real devices gets from the same shardings is
`repro_torch.checkpoint.reshard.place`: its shards have exactly the shard
shapes recorded here.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import List, Optional, Sequence

import torch

from repro_torch.configs import registry
from repro_torch.distributed.shardings import is_logical_leaf, named_sharding
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.train.tree import leaves_up_to, leaves_with_paths

DEFAULT_OUT = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch"
)

NOT_COMPUTED = {
    "keys": ["cost_analysis", "memory_analysis.output_size_in_bytes",
             "memory_analysis.temp_size_in_bytes",
             "memory_analysis.generated_code_size_in_bytes", "collective_bytes", "hlo_walk",
             "op_counts", "hlo_lines", "lower_s", "compile_s"],
    "why": "read off a compiled XLA program; the port lowers and compiles nothing",
}


def leaf_records(logical: Sequence, args: Sequence, mesh, donate: Sequence[int] = ()) -> List[dict]:
    """One record per tensor leaf of ``args`` (a tuple of trees) with the
    logical axes of its place in ``logical``: path, global and shard shape,
    dtype, spec, bytes per device (0 for a view of another leaf) and
    whether it is donated.  Leaves that are not tensors are skipped."""
    out = []
    for i, (log, arg) in enumerate(zip(logical, args)):
        pairs = zip(leaves_with_paths(log, is_leaf=is_logical_leaf),
                    leaves_up_to(log, arg, is_logical_leaf))
        tensors = [(p, lg, x) for (p, lg), x in pairs if isinstance(x, torch.Tensor)]
        owners = {id(x) for _, _, x in tensors}
        for path, lg, x in tensors:
            sh = named_sharding(lg, x.shape, mesh)
            shard = sh.shard_shape(x.shape)
            view = x._base is not None and id(x._base) in owners
            out.append(dict(
                path=f"[{i}]{path}", shape=list(x.shape),
                dtype=str(x.dtype).removeprefix("torch."), logical=list(lg),
                spec=[list(e) if isinstance(e, tuple) else e for e in sh.spec],
                shard_shape=list(shard), view=view, donated=i in donate,
                bytes_per_device=0 if view else math.prod(shard) * x.element_size()))
    return out


def argument_bytes(records: Sequence[dict], donated_only: bool = False) -> int:
    """The bytes per device of the records' leaves (of the donated ones)."""
    return sum(r["bytes_per_device"] for r in records if r["donated"] or not donated_only)


def run_cell(cell, mesh) -> dict:
    """Build one cell on meta tensors and record its shardings on ``mesh``."""
    t0 = time.perf_counter()
    build = cell.build()
    leaves = leaf_records(build.logical, build.args, mesh, build.donate)
    return {
        "cell": cell.name,
        "arch": cell.arch,
        "shape": cell.shape,
        "kind": cell.kind,
        "mesh": dict(mesh.shape),
        "n_devices": mesh.size,
        "model_flops": build.model_flops,
        "note": build.note,
        "build_s": time.perf_counter() - t0,
        "memory_analysis": {
            "argument_size_in_bytes": argument_bytes(leaves),
            "alias_size_in_bytes": argument_bytes(leaves, donated_only=True),
        },
        "leaves": leaves,
        "not_computed": NOT_COMPUTED,
    }


def demo_swa(outdir: str) -> int:
    """Sub-quadratic long-context demo: stablelm-12b with sliding-window
    attention at 524,288 tokens, its parameters and batch as meta tensors
    on the single-pod mesh."""
    from repro_torch.configs import overrides
    from repro_torch.configs.stablelm_12b import CFG
    from repro_torch.models import transformer as tf

    cfg = overrides.apply(CFG, ["attn_window=8192", "kv_block=4096"])
    mesh = make_production_mesh(multi_pod=False)
    batch = {k: torch.empty((1, 524288), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    b_log = {"tokens": ("batch", None), "labels": ("batch", None)}
    t0 = time.perf_counter()
    leaves = leaf_records((tf.param_logical(cfg), b_log), (tf.abstract_params(cfg), batch), mesh)
    rec = {
        "cell": "stablelm-12b-swa/long_500k (NON-SCORED demo)",
        "window": cfg.attn_window,
        "kv_block": cfg.kv_block,
        "mesh": dict(mesh.shape),
        "build_s": time.perf_counter() - t0,
        "memory_analysis": {"argument_size_in_bytes": argument_bytes(leaves)},
        "params_bytes_per_device": sum(r["bytes_per_device"] for r in leaves
                                       if r["path"].startswith("[0]")),
        "batch_bytes_per_device": sum(r["bytes_per_device"] for r in leaves
                                      if r["path"].startswith("[1]")),
        "leaves": leaves,
        "not_computed": dict(NOT_COMPUTED, why="no FLOP walk exists: the port lowers "
                             "nothing (repro walks the compiled HLO)"),
        "note": "sub-quadratic sliding-window variant; scored long_500k "
        "cells remain SKIP per the brief",
    }
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "demo_swa_long500k.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"[demo-swa] window {cfg.attn_window}: params {rec['params_bytes_per_device']} B/dev, "
          f"batch {rec['batch_bytes_per_device']} B/dev; no FLOP walk; wrote {path}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port lowers nothing, so there is no HLO")
    ap.add_argument(
        "--demo-swa", action="store_true",
        help="record the opt-in sliding-window long-context variant "
        "(stablelm-12b, 524k tokens, window 8192) — NON-SCORED demo; the "
        "assigned full-attention archs keep their mandated long_500k SKIP",
    )
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port lowers nothing, so there is no HLO to save")

    if args.demo_swa:
        return demo_swa(args.out)

    cells = registry.all_cells()
    if args.arch:
        cells = [c for c in cells if c.arch == args.arch]
    if args.shape:
        cells = [c for c in cells if c.shape == args.shape]
    if args.list:
        for c in cells:
            status = f"SKIP ({c.skip_reason})" if c.build is None else "run"
            print(f"{c.name:45s} {c.kind:10s} {status}")
        return 0

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", make_production_mesh(multi_pod=True)))

    failures = []
    for mesh_name, mesh in meshes:
        outdir = os.path.join(args.out, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        print(f"=== {mesh_name}: {describe(mesh)} ===", flush=True)
        for cell in cells:
            path = os.path.join(outdir, f"{cell.arch}__{cell.shape}.json")
            if cell.build is None:
                rec = {
                    "cell": cell.name, "arch": cell.arch, "shape": cell.shape,
                    "kind": cell.kind, "skipped": True,
                    "skip_reason": cell.skip_reason,
                }
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                print(f"[skip] {cell.name}: {cell.skip_reason[:80]}", flush=True)
                continue
            if os.path.exists(path) and not args.force:
                print(f"[cached] {cell.name}", flush=True)
                continue
            print(f"[shard] {cell.name} ...", flush=True)
            try:
                rec = run_cell(cell, mesh)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                mem = rec["memory_analysis"]
                print(f"  ok: args/dev {mem['argument_size_in_bytes']:.4e}B  "
                      f"donated/dev {mem['alias_size_in_bytes']:.4e}B  "
                      f"leaves {len(rec['leaves'])}", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures.append((mesh_name, cell.name, repr(e)))
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"  FAIL: {e!r}", flush=True)

    print(f"\ndone; {len(failures)} failures")
    for m, c, e in failures:
        print(f"  {m} {c}: {e[:120]}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
