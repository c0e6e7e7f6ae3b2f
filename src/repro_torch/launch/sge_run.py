"""Subgraph-enumeration driver — the paper's tool, end to end, on the port.

  PYTHONPATH=src python -m repro_torch.launch.sge_run --collection ppis32-like \\
      --variant ri-ds-si-fc --workers 16 --scale 0.3 --step-backend pallas
  PYTHONPATH=src python -m repro_torch.launch.sge_run --device cpu \\
      --collection pdbsv1-like --scale 0.04 --workers 4 --devices 2

Generates a collection, prepares one
:class:`~repro_torch.core.session.SubgraphIndex` per target, and runs every
pattern through a single :class:`~repro_torch.core.session.Enumerator`
session, so all instances share each target's adjacency upload.  Three
execution modes map to the session's three methods:

  * ``--mode single``   one engine run per query (default);
  * ``--mode packed``   LPT-balanced packs (``run_batch``);
  * ``--mode stream``   results printed as packs drain (``stream``; the
    serving path).

The session runs on ``--device`` (default: the CUDA card).  The step is
plain PyTorch unless ``--use-pallas`` selects the kernels: with
``--step-backend pallas`` every step is the fused ``extend_step`` kernel
(K1), with ``jnp`` the candidate AND is ``candidate_mask`` (K2), with
``csr`` (``auto`` past 32,768 target nodes) and ``partitioned`` the CSR
walk is ``csr_extend_bucketed`` (K7) or, with ``--csr-walk flat``,
``csr_extend`` (K6).  ``--sparse-index`` indexes targets CSR-only, so
dense adjacency bitmaps never exist: domains come from the CSR-native
AC/FC fixpoint on the device (``csr_arc_sweep`` and ``popcount_rows``,
K8 and K3, with ``--use-pallas``).

``--devices N`` runs the paper's worker sweep multi-device: the session's
worker stacks shard over a mesh of the first ``N`` cards, or, with
``--device cpu``, of ``N`` shards on the CPU
(`repro_torch.core.engine.Mesh`).  Asking for more cards than exist exits
with a message that names how many there are.

Reports per-instance matches / states / steps plus collection aggregates
(the shape of the paper's experiment tables), the session's upload cache
counters (where the JAX driver reports compiles), and, multi-device, the
entries stolen into each shard.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
from repro_torch.core import engine as eng
from repro_torch.data import graphgen


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--collection", default="ppis32-like",
                    choices=sorted(graphgen.COLLECTIONS))
    ap.add_argument("--variant", default="ri-ds-si-fc")
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--expand", type=int, default=4)
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--mode", choices=("single", "packed", "stream"), default="single")
    ap.add_argument("--packed", action="store_true",
                    help="deprecated alias for --mode packed")
    ap.add_argument("--pack-size", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="the device the session runs on (default: the CUDA card)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard worker stacks over N devices (0 = no mesh): the "
                    "first N cards, or N shards on the CPU with --device cpu")
    ap.add_argument("--step-backend", choices=("jnp", "pallas", "csr", "auto", "partitioned"),
                    default="jnp",
                    help="expansion-step backend: 'jnp' plain PyTorch (the "
                    "candidate_mask kernel with --use-pallas), 'pallas' the "
                    "fused extend_step kernel, 'csr' the sparse adjacency "
                    "walk, 'auto' = csr past 32,768 target nodes, "
                    "'partitioned' the out-of-core streaming walk")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the kernels: candidate_mask under 'jnp', the "
                    "CSR walk kernels under 'csr' / 'partitioned', and K8 / K3 "
                    "in the domain fixpoint of a sparse index")
    ap.add_argument("--mem-budget", type=int, default=0, metavar="BYTES",
                    help="device-memory budget for resident target planes: "
                    "partitions each target so its padded resident CSR planes "
                    "fit BYTES and streams the partitions through the device "
                    "(implies the partitioned backend); 0 = whole target resident")
    ap.add_argument("--partitions", type=int, default=0, metavar="N",
                    help="explicit target partition count for the partitioned "
                    "backend (0 = derive from --mem-budget, or 1 if neither is given)")
    ap.add_argument("--root-seeding", choices=("vertex", "edge", "auto"), default="vertex",
                    help="root frontier construction: 'vertex' the depth-0 "
                    "per-worker node split, 'edge' depth-1 seeds enumerated "
                    "from the rarest target edge class (plans are built with "
                    "seed_edge='auto'), 'auto' = edge whenever the plan "
                    "carries a seed edge")
    ap.add_argument("--csr-walk", choices=("bucketed", "flat"), default="bucketed",
                    help="CSR adjacency-walk schedule: 'bucketed' trips each "
                    "lane at its row's pow2 degree-bucket cap, 'flat' scans "
                    "every lane to the global deg_cap")
    ap.add_argument("--sparse-index", action="store_true",
                    help="build CSR-only target indexes (SubgraphIndex.build("
                    "..., sparse=True)): dense adjacency bitmaps never exist; "
                    "requires --step-backend csr, auto, or partitioned")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.sparse_index and args.step_backend in ("jnp", "pallas"):
        raise SystemExit(
            f"--sparse-index builds CSR-only plans, which the dense "
            f"'{args.step_backend}' backend cannot run; use --step-backend "
            "csr, auto, or partitioned"
        )
    mode = "packed" if args.packed else args.mode
    if args.partitions and args.step_backend != "partitioned":
        args.step_backend = "partitioned"

    device = eng.resolve_device(args.device)
    mesh = None
    if args.devices:
        count = torch.cuda.device_count()
        if device.type == "cuda" and args.devices > count:
            raise SystemExit(f"--devices {args.devices}: only {count} CUDA "
                             f"card{'s' if count != 1 else ''} on this machine")
        mesh = args.devices

    instances = graphgen.make_collection(
        args.collection, pattern_edges=(8, 16, 24), patterns_per_target=2,
        scale=args.scale, seed=args.seed,
    )
    cfg = EngineConfig(n_workers=args.workers, expand_width=args.expand,
                       step_backend=args.step_backend, use_pallas=args.use_pallas,
                       n_partitions=args.partitions, root_seeding=args.root_seeding,
                       csr_walk=args.csr_walk)
    session = Enumerator(config=cfg, variant=args.variant, mesh=mesh, device=device,
                         memory_budget_bytes=args.mem_budget or None)

    indices: dict = {}
    t0 = time.perf_counter()
    queries = []
    for inst in instances:
        key = id(inst.target)
        if key not in indices:
            indices[key] = SubgraphIndex.build(inst.target, sparse=args.sparse_index)
        queries.append(session.prepare(
            inst.pattern, name=inst.name, index=indices[key],
            seed_edge="auto" if args.root_seeding != "vertex" else None))

    matches = states = 0
    pw_steals = None

    def tally(ms):
        nonlocal matches, states, pw_steals
        matches += ms.matches
        states += ms.states
        if ms.per_worker_steals is not None:
            if pw_steals is None:
                pw_steals = ms.per_worker_steals.astype("int64").copy()
            else:
                pw_steals += ms.per_worker_steals

    if mode == "single":
        for q in queries:
            ms = session.run(q)
            print(f"{ms.name:40s} matches={ms.matches:<8d} states={ms.states:<9d} "
                  f"steps={ms.steps:<7d} steals={ms.steals:<5d} {ms.match_s:6.2f}s")
            tally(ms)
    else:  # packed in input order; stream in completion order, as a server would
        run = (session.run_batch if mode == "packed" else session.stream)
        for ms in run(queries, pack_size=args.pack_size):
            print(f"{ms.name:40s} matches={ms.matches:<8d} states={ms.states:<9d} "
                  f"steps={ms.steps}")
            tally(ms)

    total = time.perf_counter() - t0
    info = session.cache_stats()
    print(f"\n[{args.collection}/{mode}/{args.step_backend}] {len(queries)} queries, "
          f"{matches} matches, {states} states, {total:.1f}s "
          f"({states / max(total, 1e-9):.0f} states/s); "
          f"engine uploads={info['uploads']} cache_hits={info['cache_hits']}")
    if args.devices and pw_steals is not None:
        v_per_dev = session.config.n_workers // args.devices
        per_dev = pw_steals.reshape(args.devices, v_per_dev).sum(axis=1)
        print(f"mesh: {args.devices} device(s) x {v_per_dev} workers; "
              "entries stolen into each device: "
              + " ".join(f"d{i}={int(s)}" for i, s in enumerate(per_dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
