"""Always-on enumeration service from the command line (DESIGN.md §7), on the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --use-pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Stands up one :class:`repro_torch.serve.EnumerationService` and drives it
with ``--clients`` synthetic client threads, each submitting ``--queries``
heterogeneous patterns (sizes 3–6, several tenants) and consuming its
:class:`ResultStream` handles.  With ``--csr`` (default) a share of the
queries are CSR-only plans against a second, sparser target, so the
coalescer demonstrably keeps mixed dense/CSR load in separate buckets of
one service.  On completion the script cross-checks a sample of streamed
results against standalone ``Enumerator.run``s of the same queries and
prints the service metrics snapshot (QPS, p50/p99 latency, batch
occupancy, uploads, cache hit rate).

The service runs on ``--device`` (default: the CUDA card).  The engine's
step is plain PyTorch unless ``--use-pallas`` selects the kernels: K2 for
the dense queries (``step_backend="auto"`` resolves small targets to the
dense step) and K7 for the CSR-only ones.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import List, Optional

from repro_torch.core import EngineConfig, Enumerator, Query, SubgraphIndex
from repro_torch.core.plan import build_csr_plan
from repro_torch.data import graphgen
from repro_torch.serve import EnumerationService, ServiceConfig, format_snapshot


def build_corpus(args) -> tuple:
    """One dense target + (optionally) one sparse CSR-only target, and the
    per-client query lists (round-robin heterogeneous patterns)."""
    dense_tgt = graphgen.random_graph(
        args.target_n, args.target_m, n_labels=4, seed=args.seed
    )
    index = SubgraphIndex.build(dense_tgt)
    csr_tgt = None
    if args.csr:
        csr_tgt = graphgen.random_graph(
            2 * args.target_n, 3 * args.target_n, n_labels=4, seed=args.seed + 1
        )
    queries: List[List[Query]] = []
    # prepare() only (numpy on a dense index): no engine use
    enum = Enumerator(index, config=EngineConfig(), device=args.device)
    for c in range(args.clients):
        qs: List[Query] = []
        for k in range(args.queries):
            i = c * args.queries + k
            if csr_tgt is not None and i % 4 == 3:
                pat = graphgen.extract_pattern(csr_tgt, 3 + (i % 2), seed=args.seed + 50 + i)
                plan = build_csr_plan(pat, csr_tgt, variant="ri", device=args.device)
                qs.append(Query(pattern=pat, plan=plan, variant="ri",
                                name=f"c{c}q{k}-csr", prepare_s=0.0))
            else:
                pat = graphgen.extract_pattern(dense_tgt, 3 + (i % 4), seed=args.seed + 50 + i)
                qs.append(enum.prepare(pat, name=f"c{c}q{k}"))
        queries.append(qs)
    return index, queries


def drive(svc: EnumerationService, queries: List[List[Query]],
          collect: int, timeout: float) -> List[tuple]:
    """Run one client thread per query list; returns (query, MatchSet,
    streamed-mappings) triples in submission order."""
    out: List[Optional[tuple]] = [None] * sum(len(qs) for qs in queries)
    errors: List[BaseException] = []

    def client(c: int, qs: List[Query]) -> None:
        try:
            handles = [
                svc.submit(q, tenant=f"tenant-{c % 4}", collect=collect, timeout=timeout)
                for q in qs
            ]
            for k, (q, h) in enumerate(zip(qs, handles)):
                ms = h.result(timeout=timeout)
                idx = c * len(qs) + k
                out[idx] = (q, ms, h.mappings() if collect else None)
        except BaseException as e:  # surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c, qs), daemon=True)
               for c, qs in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[0]
    assert all(r is not None for r in out), "a client dropped a result"
    return out  # type: ignore[return-value]


def verify(results: List[tuple], svc: EnumerationService, n_check: int) -> None:
    """Cross-check a sample of served results against standalone runs on
    the service's device."""
    ref = Enumerator(config=svc.enumerator.config, device=svc.enumerator.device)
    step = max(1, len(results) // max(n_check, 1))
    for q, ms, maps in results[::step][:n_check]:
        r = ref.run(q) if maps is None else ref.run(q, collect_matches=len(maps) or 1)
        assert (ms.matches, ms.states) == (r.matches, r.states), (
            f"{q.name}: served ({ms.matches}, {ms.states}) != standalone "
            f"({r.matches}, {r.states})"
        )
        if maps is not None:
            assert maps == r.mappings(), f"{q.name}: streamed mappings diverge"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus + tight timeouts (CI)")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--queries", type=int, default=None,
                    help="queries per client")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--collect", type=int, default=32,
                    help="per-worker match budget streamed back (0 = counts only)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--target-n", type=int, default=None)
    ap.add_argument("--target-m", type=int, default=None)
    ap.add_argument("--csr", action=argparse.BooleanOptionalAction, default=True,
                    help="mix CSR-only queries against a second target")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the service (default: the CUDA card)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the steps through the CUDA kernels (K2 dense, K7 CSR)")
    args = ap.parse_args(argv)
    args.clients = args.clients or (4 if args.smoke else 16)
    args.queries = args.queries or (2 if args.smoke else 4)
    args.target_n = args.target_n or (48 if args.smoke else 120)
    args.target_m = args.target_m or (3 * args.target_n)

    index, queries = build_corpus(args)
    n_total = sum(len(qs) for qs in queries)
    svc = EnumerationService(
        index,
        config=EngineConfig(n_workers=args.workers, expand_width=2,
                            step_backend="auto", use_pallas=args.use_pallas),
        service=ServiceConfig(max_lanes=args.lanes,
                              batch_window_s=args.window_ms / 1e3),
        device=args.device,
    )
    print(f"[serve] {args.clients} clients x {args.queries} queries "
          f"({n_total} total, csr={'on' if args.csr else 'off'}), "
          f"lanes={args.lanes}, window={args.window_ms}ms, "
          f"device={svc.enumerator.device}, use_pallas={args.use_pallas}")
    t0 = time.perf_counter()
    with svc:
        results = drive(svc, queries, collect=args.collect, timeout=args.timeout)
    wall = time.perf_counter() - t0
    verify(results, svc, n_check=4 if args.smoke else 8)
    stats = svc.stats()
    print(format_snapshot(stats))
    print(f"[serve] {n_total} queries in {wall:.2f}s "
          f"({n_total / wall:.1f} q/s end-to-end), "
          f"{stats['cache_uploads']:.0f} adjacency uploads, verified OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
