#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each printed as one JSON line:

1. environment — the card, its power limit, and the kernel build (every
   CUDA source under ``src/repro_torch/csrc/`` compiled with nvcc for
   ``sm_90a``, one process per source, all started together);
2. kernels — each CUDA kernel held against its plain PyTorch version on the
   card, at the main path's shapes and at ragged ones (0 mismatched words
   required), and timed with CUDA events beside the plain version and the
   least time the card could take for the same work;
3. main path — the paper's largest PPIS32-size target (12,575 nodes) and
   its six patterns through ``SubgraphIndex.build`` → ``Enumerator.prepare``
   → ``Enumerator.run`` with the fused kernel (``step_backend="pallas"``),
   with the ``candidate_mask`` kernel (``"jnp"`` + ``use_pallas``), and with
   plain PyTorch ops (``"jnp"``).  Every counter must agree across the
   three runs and with the sequential oracle, and each kernel must have
   been launched by the run that uses it.  One more warm run of each path's
   deepest query under ``torch.profiler`` gives the card's busy share and
   the kernel launches per engine step.

Then the ``{"kernels": [...]}`` summary, the card's ``nvidia-smi`` line,
and, last, ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line.  Without a CUDA card, or without the repository's
``src/`` beside it, the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# peak 32-bit rate outside the tensor cores (H100 SXM, float32 table entry);
# the kernels' bit operations run on the same CUDA-core lanes
LANE_OPS_PER_S = 67e12

# the main path: engine configuration of the paper-size cell and its target
ENGINE_KW = dict(n_workers=64, expand_width=64, steal_chunk=4, rebalance_interval=8)
N_T = 12575
COLLECTION = dict(name="ppis32-like", pattern_edges=(8, 16, 24), patterns_per_target=2,
                  scale=N_T / 800, seed=7)
VARIANT = "ri-ds-si-fc"
MAIN_MP = 8  # DEFAULT_MAX_PARENTS
MAIN_P_PAD = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device milliseconds of one call of ``fn``, over ``reps`` calls
    run back to back, after ``warmup`` untimed calls.

    A CUDA event is recorded between consecutive calls.  The card is first
    held busy (``torch.cuda._sleep``, ~50 ms) while the host enqueues every
    call, so the events time the card's work and not the host's launch gaps.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(100_000_000)
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(reps))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(rng, b, w, mp, n_rows, p_pad, device):
    """Random inputs of the kernels' shapes (numpy seed): a quarter of the
    lanes have no candidates, half the others one non-zero word at a random
    place, and a third of the parent slots are neutral."""
    import numpy as np
    import torch

    def u32(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint32)

    rows = np.concatenate([u32(n_rows, w), np.full((1, w), 0xFFFFFFFF, np.uint32)])
    row_idx = rng.integers(0, n_rows, (b, mp)).astype(np.int32)
    row_idx[rng.random((b, mp)) < 1 / 3] = n_rows
    cand = u32(b, w)
    one_word = np.arange(w)[None, :] == rng.integers(0, w, b)[:, None]
    cand = np.where((rng.random(b) < 0.5)[:, None], np.where(one_word, cand, 0), cand)
    cand[::4] = 0
    n_p = p_pad // 2 + 1
    host = dict(rows=rows, dom_bits=u32(p_pad, w),
                pos=rng.integers(0, p_pad, b).astype(np.int32), row_idx=row_idx,
                depth=rng.integers(0, n_p, b).astype(np.int32), used=u32(b, w), cand=cand)
    dev = {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)).to(device)
           for k, v in host.items()}
    return dev, n_p


def max_abs_err(a, b) -> int:
    """Largest difference of two int32 tensors read as uint32 words."""
    import torch

    if a.numel() == 0:
        return 0
    return int(((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF))
               .abs().max())


def words_bytes(n_words: int) -> int:
    return 4 * n_words


def candidate_mask_bytes(x, n_rows) -> int:
    """Bytes K2 must move for these inputs: each input read once (used,
    index arrays, the distinct dom rows and real adjacency rows the lanes
    reference) and the output written once."""
    import torch

    b, w = x["used"].shape
    mp = x["row_idx"].shape[1]
    real_rows = torch.unique(x["row_idx"][x["row_idx"] != n_rows]).numel()
    dom_rows = torch.unique(x["pos"]).numel()
    reads = words_bytes(b * w + b * (1 + mp) + (dom_rows + real_rows) * w)
    return reads + words_bytes(b * w)


def extend_step_bytes(x, n_rows, n_p) -> int:
    """Bytes K1 must move for these inputs: cand and the index arrays of
    every lane; used, the dom row and the real adjacency rows only for
    lanes that want a child (each distinct row once); cand2, child and
    meta written once."""
    import torch

    b, w = x["cand"].shape
    mp = x["row_idx"].shape[1]
    want = (x["cand"] != 0).any(dim=1) & (x["depth"] + 1 < n_p)
    ridx = x["row_idx"][want]
    real_rows = torch.unique(ridx[ridx != n_rows]).numel()
    dom_rows = torch.unique(x["pos"][want]).numel()
    n_want = int(want.sum())
    reads = words_bytes(b * w + b * (2 + mp) + n_want * w + (dom_rows + real_rows) * w)
    return reads + words_bytes(2 * b * w + 4 * b)


def op_count(x, mp_real_per_lane) -> int:
    """Bit operations on 32-bit words: per output word, one AND-NOT for
    ``¬used`` and one AND per real adjacency row."""
    b, w = x["used"].shape
    return int(b * w * (1 + mp_real_per_lane))


def check_kernels(device):
    import numpy as np
    import torch

    from repro_torch.kernels import candidate_mask as cm_mod
    from repro_torch.kernels import extend_step as es_mod
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(11)
    main = (4096, (N_T + 31) // 32, MAIN_MP, 2 * N_T, MAIN_P_PAD)
    shapes = [main, (1, 1, 1, 2, 1), (4, 33, 2, 10, 5), (16, 257, 4, 64, 8),
              (7, 33, 0, 7, 4), (1, 257, 8, 100, 16)]
    checks = []
    timing = {}
    for b, w, mp, n_rows, p_pad in shapes:
        x, n_p = kernel_inputs(rng, b, w, mp, n_rows, p_pad, device)
        km = cm_mod.candidate_mask_cuda(x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["used"])
        pm = kref.candidate_mask_ref(x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["used"])
        ke = es_mod.extend_step_cuda(x["rows"], x["dom_bits"], x["pos"], x["row_idx"],
                                     x["depth"], n_p, x["used"], x["cand"])
        pe = kref.extend_step_ref(x["rows"], x["dom_bits"], x["pos"], x["row_idx"],
                                  x["depth"], n_p, x["used"], x["cand"])
        torch.cuda.synchronize()
        case = dict(b=b, w=w, mp=mp, n_rows=n_rows, p_pad=p_pad,
                    candidate_mask_mismatches=int((km != pm).sum()),
                    extend_step_mismatches=sum(int((k != p).sum()) for k, p in zip(ke, pe)),
                    candidate_mask_err=max_abs_err(km, pm),
                    extend_step_err=max(max_abs_err(k, p) for k, p in zip(ke, pe)))
        checks.append(case)
        if (b, w, mp, n_rows, p_pad) == main:
            real = float((x["row_idx"] != n_rows).sum()) / b
            timing["candidate_mask"] = dict(
                ms=cuda_ms(lambda: cm_mod.candidate_mask_cuda(
                    x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["used"])),
                plain_ms=cuda_ms(lambda: kref.candidate_mask_ref(
                    x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["used"])),
                bytes=candidate_mask_bytes(x, n_rows), ops=op_count(x, real))
            timing["extend_step"] = dict(
                ms=cuda_ms(lambda: es_mod.extend_step_cuda(
                    x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["depth"], n_p,
                    x["used"], x["cand"])),
                plain_ms=cuda_ms(lambda: kref.extend_step_ref(
                    x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["depth"], n_p,
                    x["used"], x["cand"])),
                bytes=extend_step_bytes(x, n_rows, n_p), ops=op_count(x, real) + 2 * b * w)
        del x, km, pm, ke, pe
    return checks, timing


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def profile_query(enum, query) -> dict:
    """Device time of one warm run of ``query`` under ``torch.profiler``:
    the share of the run's wall time the card spent in kernels, and the
    kernel launches per engine step.  The profiler slows the host, so the
    share is a lower bound for the unprofiled run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if enum.device.type == "cuda":
        torch.cuda.synchronize(enum.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ms = enum.run(query)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return dict(query=query.name, device_time="not measured (no device events traced)")
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return dict(query=query.name, steps=ms.steps, profiled_wall_s=wall,
                device_busy_s=busy_us / 1e6, device_busy_share=busy_us / 1e6 / wall,
                kernel_launches=n_kernels, launches_per_step=n_kernels / ms.steps,
                top=[dict(name=e.key[:80], count=e.count, device_us=e.self_device_time_total)
                     for e in top])


def run_main_path(device):
    from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
    from repro_torch.core.ref import ref_enumerate
    from repro_torch.data import graphgen
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    insts = graphgen.make_collection(**COLLECTION)
    target = insts[0].target
    patterns = [i for i in insts if i.target is target]
    index = SubgraphIndex.build(target)
    setup = dict(phase="main_path_setup", n_t=target.n, edges=target.m // 2,
                 labels=target.n_node_labels, w=index.w, patterns=len(patterns),
                 setup_s=time.perf_counter() - t0)
    emit(setup)

    backends = {
        "pallas": dict(step_backend="pallas"),
        "jnp+use_pallas": dict(step_backend="jnp", use_pallas=True),
        "jnp": dict(step_backend="jnp"),
    }
    results, launches = {}, {}
    for label, kw in backends.items():
        enum = Enumerator(index, config=EngineConfig(**ENGINE_KW, **kw), variant=VARIANT,
                          device=device)
        queries = [enum.prepare(inst.pattern, name=inst.name) for inst in patterns]
        for q in queries:  # warm-up: first use of each torch op on the card
            enum.run(q)
        ops.reset_launch_counts()
        results[label] = [enum.run(q) for q in queries]
        launches[label] = ops.launch_counts()
        deepest = max(range(len(queries)), key=lambda i: results[label][i].states)
        emit(dict(phase="main_path", backend=label, launches=launches[label],
                  profile=profile_query(enum, queries[deepest]),
                  cache=enum.cache_stats(),
                  queries=[dict(name=ms.name, n_p=ms.plan.n_p, p_pad=ms.plan.p_pad,
                                matches=ms.matches, states=ms.states, steps=ms.steps,
                                steals=ms.steals, steal_rounds=ms.steal_rounds,
                                retries=ms.retries, prepare_s=ms.preprocess_s,
                                match_s=ms.match_s, states_per_s=ms.states / ms.match_s)
                           for ms in results[label]]))

    def counters(ms):
        return (ms.matches, ms.states, ms.steps, ms.steals, ms.steal_rounds,
                ms.per_worker_states.tolist(), ms.per_worker_matches.tolist(),
                ms.per_worker_steals.tolist())

    want = [counters(ms) for ms in results["jnp"]]
    for label, res in results.items():
        if [counters(ms) for ms in res] != want:
            raise AssertionError(f"backend {label} disagrees with the plain path")
        for ms in res:
            if ms.engine.overflow:
                raise AssertionError(f"{label} {ms.name} overflowed after its retry")
    oracle = []
    for inst, ms in zip(patterns, results["jnp"]):
        ref = ref_enumerate(inst.pattern, target, plan=ms.plan)
        oracle.append(dict(name=ms.name, matches=ref.matches, states=ref.states))
        if (ref.matches, ref.states) != (ms.matches, ms.states):
            raise AssertionError(f"{ms.name}: engine {(ms.matches, ms.states)} != "
                                 f"ref_enumerate {(ref.matches, ref.states)}")
    emit(dict(phase="oracle", agree=True, queries=oracle))
    if launches["pallas"]["extend_step"] == 0:
        raise AssertionError("the pallas run never launched extend_step")
    if launches["jnp+use_pallas"]["candidate_mask"] == 0:
        raise AssertionError("the jnp+use_pallas run never launched candidate_mask")
    return launches


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repository's src/repro_torch is missing ({e})", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build_s = _build.build()
    ptxas = {k: [ln.strip() for ln in _build.build_log(k).splitlines()
                 if "registers" in ln or "spill" in ln] for k in _build.KERNELS}
    emit(dict(phase="environment", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              build_s=build_s, build_wall_s=time.perf_counter() - t0, ptxas=ptxas))

    checks, timing = check_kernels(device)
    emit(dict(phase="kernels_vs_plain", cases=checks))
    bad = [c for c in checks if c["candidate_mask_mismatches"] or c["extend_step_mismatches"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    launches = run_main_path(device)

    meta = {
        "extend_step": dict(source="src/repro_torch/csrc/extend_step.cu",
                            replaces="src/repro/kernels/extend_step.py:125",
                            launches=launches["pallas"]["extend_step"]),
        "candidate_mask": dict(source="src/repro_torch/csrc/candidate_mask.cu",
                               replaces="src/repro/kernels/candidate_mask.py:62",
                               launches=launches["jnp+use_pallas"]["candidate_mask"]),
    }
    kernels = []
    for name, m in meta.items():
        t = timing[name]
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["ops"] / LANE_OPS_PER_S * 1e3
        err = max(c[f"{name}_err"] for c in checks)
        kernels.append(dict(
            name=name, route="cuda", source=m["source"], replaces=m["replaces"],
            launches=m["launches"], max_abs_err=err,
            mismatches=sum(c[f"{name}_mismatches"] for c in checks),
            ms=t["ms"], kernel_ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=t["bytes"], library_ms=None))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
