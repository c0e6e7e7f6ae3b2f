"""Phase 3's main path (``chip_smoke.run_main_path``'s six queries, through
K1 and through K2) of this checkout against another checkout's, on one
CUDA card, in turns.

  python3 benchmarks/bench_torch_main_path.py --other PATH [--reps N] [--json OUT]

``PATH`` is the root of another checkout of this repository (for example a
``git archive`` of the parent commit unpacked into a directory that
``.gitignore`` lists).  Each turn is a process of its own that runs one
checkout: it imports that checkout's ``chip_smoke`` and ``repro_torch``,
builds K1 and K2 there (``repro_torch.kernels._build``), draws phase 3's
target and patterns from ``chip_smoke.COLLECTION``, runs every query once
to warm up, then ``--reps`` times through one session at
``chip_smoke.ENGINE_KW``.  It reports each query's median ``match_s``
(host launches included: from the first launch to the read-back of the
query's counters) and the median wall time of all six.  Turns: other,
this, this, other; every turn's counters must agree.  Prints one JSON line
per turn and, last, the card's name and power limit.  Exits 2 without a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = {"K1": dict(step_backend="pallas"),
            "K2": dict(step_backend="jnp", use_pallas=True)}


def turn(checkout: Path, reps: int) -> dict:
    """One turn inside ``checkout``: per backend, each query's median
    ``match_s`` and the six queries' median wall time, in ms, and the
    queries' counters."""
    sys.path.insert(0, str(checkout))
    import torch

    import chip_smoke as cs  # puts the checkout's src/ first on the path
    from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
    from repro_torch.data import graphgen
    from repro_torch.kernels import _build

    if Path(cs.__file__).resolve().parent != checkout:
        raise RuntimeError(f"imported {cs.__file__}, not {checkout}'s chip_smoke")
    _build.build(["extend_step", "candidate_mask"])
    device = torch.device("cuda", 0)
    insts = graphgen.make_collection(**cs.COLLECTION)
    target = insts[0].target
    index = SubgraphIndex.build(target)
    patterns = [i for i in insts if i.target is target]
    out = {}
    for label, kw in BACKENDS.items():
        enum = Enumerator(index, config=EngineConfig(**cs.ENGINE_KW, **kw), variant=cs.VARIANT,
                          device=device)
        queries = [enum.prepare(inst.pattern, name=inst.name) for inst in patterns]
        for q in queries:  # warm-up: first use of each torch op on the card
            enum.run(q)
        per_query, walls = [[] for _ in queries], []
        for _ in range(reps):
            t0 = time.perf_counter()
            results = [enum.run(q) for q in queries]
            walls.append(time.perf_counter() - t0)
            for times, ms in zip(per_query, results):
                times.append(ms.match_s)
        out[label] = dict(
            query_ms=[statistics.median(t) * 1e3 for t in per_query],
            six_ms=statistics.median(walls) * 1e3,
            counters=[[ms.matches, ms.states, ms.steps, ms.steals] for ms in results])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", type=Path, default=None, help="also write the turns here")
    ap.add_argument("--turn", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_main_path: no CUDA device", file=sys.stderr)
        return 2
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.reps)), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    t0 = time.perf_counter()
    checkouts = {"other": args.other.resolve(), "this": ROOT}
    turns = []
    for i, which in enumerate(("other", "this", "this", "other")):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn",
                               str(checkouts[which]), "--reps", str(args.reps)],
                              cwd=checkouts[which], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"turn {i} ({which}) failed:\n{proc.stderr[-4000:]}")
        res = dict(turn=i, checkout=which, **json.loads(proc.stdout.strip().splitlines()[-1]))
        if turns and any(res[b]["counters"] != turns[0][b]["counters"] for b in BACKENDS):
            raise AssertionError(f"turn {i} ({which}): the queries' counters differ")
        turns.append(res)
        print(json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(seconds=time.perf_counter() - t0)), flush=True)
    if args.json is not None:
        args.json.write_text(json.dumps(dict(turns=turns, card=smi), indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
