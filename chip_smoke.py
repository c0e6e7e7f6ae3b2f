#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each printed as one JSON line:

1. environment — the card, its power limit, and the kernel build (every
   CUDA source under ``src/repro_torch/csrc/`` compiled with nvcc for
   ``sm_90a``, one process per source, all started together);
2. kernels — each CUDA kernel held against its plain PyTorch version on the
   card, at the main path's shapes and at ragged ones (0 mismatched words
   required; K1 and K2 also at their shared kernel's boundaries: b 1, 7,
   2,115 and 16,384, mp 9 and 33, w ≡ 0, 1, 2, 3 (mod 4) with the row table
   at each word offset, every lane empty or a match, every slot neutral,
   all-zero and all-ones rows; K5 in its one-arc and its batched form, the
   latter also with pairs on planes out of range, more pairs than one mask
   chunk, and all-zero and all-ones masks and rows), and timed with CUDA
   events beside the plain version and the least time the card could take
   for the same work (K1 and K2 also with the L2 flushed before each call);
3. main path — the paper's largest PPIS32-size target (12,575 nodes) and
   its six patterns through ``SubgraphIndex.build`` → ``Enumerator.prepare``
   → ``Enumerator.run`` with the fused kernel (``step_backend="pallas"``),
   with the ``candidate_mask`` kernel (``"jnp"`` + ``use_pallas``), and with
   plain PyTorch ops (``"jnp"``).  Every counter must agree across the
   three runs and with the sequential oracle, and each kernel must have
   been launched by the run that uses it.  One more warm run of each path's
   deepest query under ``torch.profiler`` gives the card's busy share and
   the kernel launches per engine step, and one more records the arguments
   of its K1 (``pallas``) or K2 (``jnp+use_pallas``) call with the most
   valid lanes: K1 and K2 are checked on them (0 mismatched words) and
   timed, warm and cold, beside their bound and the plain version.  The
   deepest query is also prepared with ``seed_edge="auto"`` and run under
   ``root_seeding="edge"`` through K1 and through K2: both must launch
   their kernel and give the vertex-seeded run's matches and each other's
   counters; it prints the root frontier under each seeding (|dom[0]|
   roots against the seed entries), the seed edge, the host seconds of
   ``root_seed_entries`` and each run's query time;
4. batch path — the same target with 24 patterns (8 each of 8, 16 and 24
   edges), under ``ri-ds-si-fc`` and ``ri-ds-si-acfc``:
   ``Enumerator.prepare_batch`` with the device fixpoint through K5
   (``adjacency_any``, one launch per AC sweep over every live (pattern,
   arc) pair of a domain bucket: the launches must equal the fixpoint's
   sweeps) and K3 (``popcount_rows``), through plain PyTorch, and on the
   host (numpy), which must give identical domains and plans;
   ``compute_domains_device(use_pallas=True)`` per pattern through K4
   (``arc_any_sweep``) and K3, which must give the same bits; and
   ``Enumerator.stream`` in packs of 4 through K1 and through K2, whose
   every counter must equal the same query's single run, and
   ``ref_enumerate``'s matches and states.  It prints per-pattern
   preparation time (device and numpy), each pack's time, kernel launches
   per fixpoint sweep, and the card's busy share of one profiled pack.
   Then K3, K5 and K4 are checked and timed at full width on the target's
   own adjacency planes with one 48-arc pattern's real domain masks, and
   batched K5 also on the largest sweep the batch fixpoint launched;
5. sparse path — target A, PDBSv1 scale (33,067 nodes, 138 labels, w =
   1,034; six patterns of 5, 9 and 13 nodes), indexed CSR-only
   (``SubgraphIndex.build(sparse=True)``) under ``ri-ds-si-acfc`` and
   ``step_backend="auto"``, which must resolve to ``csr``:
   ``Enumerator.prepare`` runs the CSR domain fixpoint through K8
   (``csr_arc_sweep``) and K3, and ``run`` goes through K7
   (``csr_extend_bucketed``), K6 (``csr_extend``, ``csr_walk="flat"``) and
   the plain path; every counter must agree across the three, with a dense
   K1 run of the same queries, and with ``ref_enumerate``.  Then
   ``prepare_batch`` on the sparse index for 8 patterns (device fixpoint
   through K8, equal to the dense index's numpy preparation) and
   ``stream`` in packs of 4 through K7, each lane equal to its single run.
   Target B, hub-heavy (``power_law_graph``: 33,067 nodes, maximum degree
   16,373), runs one pattern under ``ri`` through K6 and K7, which must
   agree with each other and ``ref_enumerate``; each one's query time is
   printed.  The same query prepared with ``seed_edge="auto"`` runs under
   ``root_seeding="edge"`` through K6 and K7, which must launch, agree on
   every counter and give the vertex-seeded runs' and ``ref_enumerate``'s
   matches; it prints both root frontiers, the seed edge, the host
   seconds of ``root_seed_entries`` and each seeding's query time.  The
   same pattern is prepared under ``ri-ds-si-acfc`` on target
   B's CSR index through K8, whose domains must equal the plain fixpoint's.
   K6, K7 and K8 are checked (0 mismatched words) and timed at full width on
   both targets' CSR arrays (K8 on target B with the hub pattern's final and
   initial domains and with all-zero masks), and at ragged edge cases (K8
   also with rows that do not follow each other, planes out of range, more
   than 32 arcs on one plane, no arcs and hub rows);
6. LM serving path — minitron-8b at full width and depth (32 layers,
   d_model 4,096, 32 heads, 8 KV heads, d_ff 16,384, vocabulary 256,000,
   bf16, 7.73 B random parameters from a ``torch.Generator``) serves four
   requests: ``prefill`` of 4,096-token prompts into a 4,112-position
   cache, then 16 greedy ``decode_step``s.  K9 (``flash_attention``) must
   launch exactly once per layer in the prefill and never in a decode
   step, and no other kernel at all; a second prefill must give
   bit-identical logits and cache, and peak memory stay under the card's.  It prints prefill time and tokens/s,
   each decode step's time, the generated ids, peak memory and one
   ``torch.profiler`` breakdown each of a prefill and a decode step.
   Checks: K9 against its plain version on every layer's own q/k/v of a
   prefill of the same requests and at ragged and edge shapes (fp32 and
   bf16); decode against prefill (``tests/test_models_lm.py``'s gate) end
   to end at depth 1 and 2, and layer by layer from the same inputs at
   full depth, in bf16 and in fp32 (the fp32 weights after the bf16 ones
   are freed; deeper end-to-end runs are printed, not gated).  K9 is
   timed on layer 0's q/k/v beside its plain version and
   ``scaled_dot_product_attention``.

7. dynamic path — ``benchmarks/bench_incremental.py``'s regime at the
   size of PPIS32's largest target: ``power_law_graph(12575, avg_deg=4,
   alpha=2, n_labels=4, seed=7)`` with its arcs deduplicated, a dense
   index whose CSR plane set is built once, the bench's pattern rule (the
   first 4-edge ``extract_pattern`` of seeds 8–23 with 5 · 12,575 to
   120,000 matches; the 16 candidates are counted as one pack whose lanes
   stop once past 120,000) and its edit stream (1 % of the arcs per edit,
   half removals of present edges, half pattern-relevant insertions).
   Four sessions maintain the match set through five edits, each edit
   ``SubgraphIndex.update`` → ``prepare`` on the new version → the
   version's upload → ``run_delta`` → ``apply_array`` →
   ``invalidate_index`` of the retired version: through K1
   (``"pallas"``), K2 (``"jnp"`` + ``use_pallas``), K6 and K7 (``"csr"``
   flat and bucketed, on the dense index's patched CSR planes).  A sixth
   edit goes through an edge-seeded ``csr`` query (``seed_edge="auto"``,
   ``root_seeding="auto"``) beside the K1 session.  Gates: the four
   deltas agree on the added and removed mappings and every counter; each
   maintained count equals a fresh K1 run of the new version, and the
   sorted mappings equal its at the first and the last two edits; the
   edge-seeded delta equals the vertex-seeded one and its query plan is
   its seed edge's anchor plan; each kernel launches inside
   ``run_delta``; at most two uploads per layout remain after each
   ``invalidate_index``; the final indexes' bitmaps, degrees and CSR
   planes equal fresh builds.  Each edit prints the host seconds of every
   stage, the version's upload, the fresh run's, and recompute over
   delta (printed, not gated).
8. out-of-core path — ``benchmarks/bench_outofcore.py``'s regime: a
   power-law target of 33,000 nodes (average degree 4, 8 labels, seed 7)
   on a sparse ``SubgraphIndex``, its ``extract_pattern`` of 8 edges, 8
   workers of expand width 4.  ``Enumerator(memory_budget_bytes=...)``
   with a quarter of the target's padded resident plane bytes runs the
   query through K7 (``csr_walk="bucketed"``) and K6 (``"flat"``), and
   ``step_backend="partitioned", n_partitions=2`` through K7; each run
   cold, then warm, beside a monolithic ``csr`` K7 run.  Gates: the derived
   partitioning's padded resident bytes are within the budget; matches and
   states equal the monolithic run's and ``ref_enumerate``'s; flat equals
   bucketed on every counter and every ``stats`` key; ``visits``,
   ``spilled`` and ``dead_spills`` equal ``ref_enumerate_partitioned``'s;
   K6 and K7 each launch in their partitioned runs; and K6 and K7 give 0
   mismatched words against their plain versions on a recorded
   partitioned step of each walk that has lanes whose every parent is off
   the resident partition and lanes with resident and off-partition
   parents (the bench pattern's search has no lane of the first kind, so
   the step comes from a run of the pattern without one of its edges, cut
   short once the step is taken).  It prints the partition count and bytes, each run's
   scheduling statistics, seconds (cold and warm) and the host seconds of
   intake and ring drains, and the card's name and power limit.
9. service — ``repro_torch.serve.EnumerationService`` on the card, reusing
   the targets and patterns of phases 3, 4, 5 and 8.  S1: phase 3's dense
   index under ``step_backend="auto"``, ``use_pallas``, ``ri-ds-si-acfc``,
   packs of 8 lanes and a 2 ms window, serving 16 client threads of 4
   tenants.  Phase 4's 24 patterns are prepared up front by
   ``prepare_batch`` (K5 + K3); each client submits three of them
   (round-robin, so each twice) and one of phase 5's target A patterns that
   it prepares itself on target A's sparse index (K8 + K3), and one client
   also submits the smallest pattern raw, prepared by ``submit`` with
   numpy.  Once every client has submitted its first dense query and its
   CSR-only one, ``update_index`` swaps in a 1 % edit of the dense target
   (drawn as phase 7 draws its edits) and the remaining dense queries are
   prepared on the new version.  Dense packs run through K2, CSR-only ones
   through K7; even clients collect 32 mappings per worker, odd ones
   count.  S2: the same dense traffic through K1 (``"pallas"``), once
   without and once with a ``warmup_profile`` of the 24 prepared queries.
   S3: ``memory_budget_bytes`` of phase 8's budget on phase 8's target,
   ``csr_walk="flat"`` (K6), its pattern submitted twice.  Gates: every
   status ok; every served ``MatchSet`` equals a standalone
   ``Enumerator.run`` of the same query on the card on every counter (per
   worker too) and ``retries``, and its streamed chunks, concatenated,
   equal that run's mappings at the same collect budget; ``completed``
   equals the submissions; dense and CSR-only queries never share a
   coalesce key, and there are at least as many dispatches as keys; S1
   launches K2, K7, K8, K5 and K3, S2 K1, S3 K6; S2's warmed dispatches
   make no upload after ``start()``; S3 gives phase 8's monolithic
   matches and states.  It prints QPS, latency percentiles, queue wait,
   batch occupancy, dispatches, uploads and the first result's latency
   with and without the warm-up, beside the card's ``nvidia-smi`` line,
   then runs ``repro_torch.launch.serve --smoke --use-pallas`` (which
   checks its own results).
10. multi-device and the driver — worker stacks sharded over
   ``Mesh((cuda:0,) * D)`` (one process driving a tuple of devices; one
   card holds every shard), reusing the targets and queries of phases 3,
   5, 7 and 8.  10a: phase 3's six queries at D = 1, 2 and 4 through K1
   and K2, the deepest also edge-seeded at D = 2; 10b: target A's queries
   at D = 2 through K7 and K6, and target B's hub query edge-seeded at
   D = 2 through both; 10c: phase 8's query at 2 partitions at D = 1 and 2
   (K7; K6 at D = 2) and under phase 8's budget at D = 2 through K7 and
   K6; 10d: phase 7's first edit maintained by ``run_delta`` through K2 at
   D = 2; 10e: ``repro_torch.launch.sge_run`` on PDBSv1's largest targets
   (four of 33,067 nodes, CSR-only, ``ri-ds-si-acfc``, prepared through
   K8 and K3, stepped through K7) in modes ``single``, ``packed`` and
   ``stream``, and dense through K1 on a 2,400-node PDBSv1-like draw
   without and with ``--devices 1``.  Gates: every sharded run of 10a and
   10b equals the unsharded run of the same query on every counter, per
   worker too, and its match buffer; 10c's matches, states and sorted
   mappings equal phase 8's monolithic run, and D = 1 equals the unsharded
   2-partition run on every counter and ``stats`` key; 10d's added and
   removed mappings equal the unsharded maintainer's; 10e's per-query
   counters agree across modes and with standalone session runs, and
   ``--devices 1`` with the unsharded run; K1, K2, K6 and K7 launch in
   10a–10c, K8 and K3 in 10e; ``--devices`` and ``Enumerator(mesh=)`` past
   the card count are refused with the count.  With two cards or more,
   phase 3's queries also go through K1 over 2 (and 4) real cards, each
   equal to the unsharded run and to the same shards on one card, and
   phase 8's query at 2 partitions over two cards through K7, equal to two
   shards on one card on every counter and ``stats`` key, and the driver's
   dense K1 run with ``--devices`` 2 (and 4) equal to ``--devices 1`` on
   every query's counters and its entries stolen (``mesh_multi_card``);
   otherwise it prints ``{"phase":
   "mesh_multi_card", "ran": false, "count": 1}``.  It prints per D the
   launches per step, each query's seconds and the steal round's bytes,
   beside the card's ``nvidia-smi`` line.
11. LM family — the MoE and sliding-window models, each at full width,
   with random bf16 weights from a ``torch.Generator`` (drawn in slices,
   so no fp32 copy of a whole parameter), its weights freed before the
   next loads: grok-1-314b cut to 4 of 64 layers (8 experts × d_ff 32,768
   top-2; 2 × 4,096-token prompts, 16 decode steps), kimi-k2-1t-a32b cut to
   1 of 61 layers (384 experts top-8 plus one shared, d_head 112; 1 ×
   4,096, 8 steps), nemotron-4-15b (32 layers, squared ReLU) and
   stablelm-12b (40 layers, d_head 160) at full depth (2 × 4,096, 8 steps
   each).  Gates per model: K9 once per layer in the prefill, never in a
   decode step, no other kernel; finite logits; a second prefill gives
   bit-identical logits and cache; peak memory under the card's; K9 against
   its plain version on every layer's own q/k/v; every MoE layer's output
   against the same ``moe_ffn`` in fp32 from the same input (phase 6's
   bf16 tolerance); for the MoE models decode against prefill at depth 1
   and 2 with a capacity that drops nothing (kimi's depth 2 repeats its one
   layer), in bf16 where both runs route the decoded position to the same
   experts in every layer (printed with the rerouted positions otherwise)
   and with fp32 activations over the same weights (routing must agree).  It prints each model's ``reduced`` list, prefill seconds and
   tokens/s, decode ms per step, peak memory, per MoE layer the dropped-pair
   share and the largest (group, expert) counts against the capacity, one
   ``torch.profiler`` breakdown each of a prefill and a decode step, and K9
   timed at d = 112 and 160.  Then ``overrides.apply(stablelm_12b.CFG,
   ["n_layers=4", "attn_window=4096"])`` runs ``forward`` over 8,192 tokens
   (timed); gates: with the window widened to the sequence it equals the
   full causal ``forward`` (bf16 at one layer; each layer from the same
   input in bf16 and with fp32 activations; 4 layers end to end printed),
   and layer 0's
   ``windowed_attention`` equals an fp32 dense masked softmax of its q/k/v,
   four heads at a time.
12. training — ``loss_fn`` (chunked fp32 cross-entropy, checkpointed layers),
   AdamW, ``TrainLoop``, checkpoints and the driver; no kernel of K1–K9 runs
   in training (every launch count must stay 0).  12a: minitron-8b's and
   grok-1's ``SMOKE`` in fp32, parameters drawn once on the CPU and copied
   to the card, 5 ``TrainLoop`` steps at accumulation 1 and 2 on the same
   ``lm_data_iterator`` batches on the card and on the CPU: every loss, the
   first grad norm, the first step's gradients over max(1, each leaf's
   largest) and the final parameters (relative L2) within 1e-4, the
   first step's gradients leaf by leaf over each leaf's largest within 5e-4,
   the steps' update (relative L2) within 5e-3, and one AdamW update from
   the same parameters, moments and gradients within 2 ulps of the new
   parameter plus 1e-5 of each leaf's largest update.  12b:
   ``repro_torch.launch.train`` on minitron-8b for 20 steps into a
   checkpoint directory, then to 30 on it: the first run improves, the
   second restores step 20 and starts below the first on the same first
   batch, and the checkpoint restores to bf16 tensors on the card, copied
   into the tensors it was given.  12c:
   minitron-8b at full width (4 of 32 layers, ``loss_chunk`` 4,096, 2.80 B
   bf16 parameters), 8 steps of 2 × 4,096 tokens: finite losses, the first
   within 2 of ln 256,000, the last below the first plus 0.05 (the
   batches' spread), the first batch's loss lower after training than
   before, the peak memory under the card's; it prints per-step seconds,
   tokens/s, the model-FLOP rate (6 · ``n_active`` · tokens), the peak
   memory and one profiled step's busy share and top kernels.
13. GNN and recsys families — gcn-cora, graphsage-reddit, schnet,
   graphcast and din at their published ``CFG``s in fp32 (message passing
   on ``index_select`` / ``index_add``, embedding lookups, ``torch.matmul``;
   no kernel of K1–K9 runs: every launch count must stay 0).  13a: each
   GNN on ``full_graph_sm`` (3,072 nodes, 10,752 edges, d_feat 1,433) and
   DIN at 512 rows, parameters drawn once on the CPU and copied to the
   card: the forward and the loss within 1e-5 of the CPU's largest
   magnitude, every gradient leaf within 1e-4 of its largest, the
   parameters after one AdamW step within 1e-5 in relative L2, and a second
   card run against the first within the same tolerances (graphcast's 16
   processor layers with each gradient leaf within 1e-2 of its largest,
   and a TF32 control run printed beside it); then
   ``repro_torch.launch.train.main`` on each id prints a finite smoke loss.
   13b: gcn-cora and graphsage-reddit on ``ogb_products`` (2,449,408 nodes,
   61,859,328 edges), schnet and graphcast on ``minibatch_lg`` (169,984
   nodes, a 232,976-row feature table; ``ogb_products`` would need 74 /
   60 GB for one tensor), 3 AdamW steps on one batch: finite losses, the
   last below the first, the peak under the card's memory; it prints
   seconds per step, the model-FLOP rate (3 · ``fwd_flops``), the peak
   memory and the busy share and top kernels of the fullest of three
   profiled steps.  13c: DIN's
   ``train_batch`` (65,536 rows, 3 steps, the loss falls), ``serve_p99``
   (512 rows, median and p99 ms of 50 calls), ``serve_bulk`` (262,144
   rows, rows/s) and ``retrieval_cand`` (one user against 262,144
   candidates, a quarter of the cell's 1,000,000, then top 1,000; 64
   sampled candidates equal pointwise ``score`` within 1e-5).
14. registry — ``repro_torch.configs.registry`` and its cells.  14a: all
   11 architectures and 44 cells (40 assigned, the five ``long_500k``
   skipped, plus four ``sge``) built: every argument leaf a meta tensor and
   the card's allocated memory unchanged; it prints each cell's kind,
   ``model_flops`` and the bytes its arguments would hold against the
   card's memory.  14b: the four ``sge`` cells at their exact shapes (n_t
   12,575, 6,726 and 33,067, w 512, 256 and 1,152 words, 64 positions, 8
   parents, 64 × 64 lanes) on the first 8-edge pattern of the collection
   target of each size (phase 3's target, a ``graemlin32-like`` draw, phase
   5's target A): the dense plan prepared on the target packed to
   128-word rows through the device fixpoint with K4 and K3, the CSR plan
   through the CSR-native fixpoint with K8 and K3; one round of the cell's
   ``fn`` from ``init_state``, the dense cells plain, through K1 and
   through K2, the CSR cell through K7 (its own round), K6 and plain.
   Gates: the concrete plan and state have the cell's shapes; every state
   field equal across the three runs (rings read from their bases); each
   kernel launched in its run, none in the plain run; K8 and K3 in the CSR
   prepare.  14c: minitron-8b's ``prefill_32k`` cell through its ``fn`` at
   full width and depth with the batch cut from 32 to 1: K9 once per layer
   at S = 32,768 and no other kernel, finite logits, K9 on layer 0's q/k/v
   against its plain version on three heads (phase 6's bf16 tolerance); it
   prints tokens/s, peak memory and K9's time at that length beside its
   bound and ``scaled_dot_product_attention``.  14d:
   ``repro_torch.launch.train.main(["--arch", "sge"])`` on the card prints
   ``ref_enumerate``'s matches and states.
15. distributed — the distributed layer and the dry-run; no kernel
   launches (the launch counts must not change).  15a:
   ``repro_torch.launch.dryrun.run_cell`` for all 44 cells on both
   production meshes (meta placeholders): 39 records per mesh, 5 skipped,
   the card's allocated memory unchanged; it prints each cell's argument
   bytes per device on each mesh and names the cells that exceed the card's
   memory.  15b: minitron-8b at phase 12c's width (4 of 32 layers, ~2.8 B
   bf16 parameters from ``LM_SEED``) through ``checkpoint.store.save`` →
   ``store.restore`` (no ``like_*``) → ``checkpoint.place`` onto
   ``make_local_mesh()`` and onto a ``(data=2, model=2)`` mesh of four
   shards on the card: every shard of the shape
   ``named_sharding(...).shard_shape`` gives, ``gather`` bit-equal to the
   saved parameters, the resident bytes equal to the mesh's devices times
   the dry-run's bytes per device; it prints the seconds of each step.
   15c: ``distributed.compression.compress_grads`` twice over a bf16 tree
   of 15b's shapes (``DIST_GRAD_SEED``): payload, scale and residual
   bit-equal to the CPU's on every leaf of layer 0 and on a row block of
   ``embed``, and ``DIST_EF_STEPS`` steps of error feedback on ``embed``
   at full width within ``DIST_EF_TOL`` of the true gradient; it prints
   the seconds per call and the payload bytes.

Then the ``{"kernels": [...]}`` summary, the card's ``nvidia-smi`` line,
and, last, ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line.  Without a CUDA card, or without the repository's
``src/`` beside it, the script exits 2 and prints no result.

``python3 chip_smoke.py --multi-card`` runs only the build and
``mesh_multi_card`` (phase 3's and phase 8's targets built for it), on a
machine with two cards or more (it exits 2 on one).
"""

from __future__ import annotations

import contextlib
import json
import re
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
TENSOR_BF16_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate

# the main path: engine configuration of the paper-size cell and its target
ENGINE_KW = dict(n_workers=64, expand_width=64, steal_chunk=4, rebalance_interval=8)
N_T = 12575
COLLECTION = dict(name="ppis32-like", pattern_edges=(8, 16, 24), patterns_per_target=2,
                  scale=N_T / 800, seed=7, n_targets=1)
VARIANT = "ri-ds-si-fc"
# phase 4, the batch path: the same target (target 0 of the same seed) with
# 24 patterns, under both FC variants, in packs of 4
BATCH_COLLECTION = dict(COLLECTION, patterns_per_target=8)
BATCH_VARIANTS = ("ri-ds-si-fc", "ri-ds-si-acfc")
PACK_SIZE = 4
MAIN_MP = 8  # DEFAULT_MAX_PARENTS
MAIN_P_PAD = 32
# phase 5, the sparse path.  Target A: PDBSv1's largest target (33,067
# nodes, COLLECTION_NT in src/repro/configs/sge.py) with its CSR variant
# (CSR_VARIANT there); six patterns, and 8 (of a 9-pattern draw) for the
# batch half.  Target B: bench_hubheavy's hub-heavy power-law target and
# pattern (benchmarks/bench_hubheavy.py).
SPARSE_NT = 33067
SPARSE_COLLECTION = dict(name="pdbsv1-like", pattern_edges=(8, 16, 24), patterns_per_target=2,
                         scale=SPARSE_NT / 2400, seed=7, n_targets=1)
SPARSE_BATCH_COLLECTION = dict(SPARSE_COLLECTION, patterns_per_target=3)
SPARSE_BATCH = 8
SPARSE_VARIANT = "ri-ds-si-acfc"
HUB = dict(n=SPARSE_NT, avg_deg=4.0, alpha=1.5, n_labels=32, seed=7)
HUB_VARIANT = "ri"
# phase 6, the LM serving path: minitron-8b (repro_torch.configs.minitron_8b.CFG
# unless LM_CFG is set) at full width and depth in bf16, random weights from
# LM_SEED; LM_BATCH requests of LM_PROMPT tokens (lm_batch, seed
# LM_TOKEN_SEED), then LM_DECODE_STEPS greedy decode steps.  The
# decode-against-prefill checks use the first LM_CHECK_PROMPT + 1 tokens; the
# per-layer K9 check runs the plain version LM_HEAD_CHUNK heads at a time.
LM_CFG = None
LM_SEED = 0
LM_BATCH, LM_PROMPT, LM_DECODE_STEPS = 4, 4096, 16
LM_TOKEN_SEED = 7
LM_CHECK_PROMPT = 256
LM_HEAD_CHUNK = 16
# phase 11, the LM family, random weights from LM_SEED and prompts from
# LM_TOKEN_SEED as in phase 6: per configuration module, (layers kept or None
# for all, batch, decode steps); prompts of LMF_PROMPT tokens.  LMF_CFGS maps
# a module to an LMConfig in place of its CFG (CPU rehearsals).  Then
# stablelm-12b under the overrides LMF_WINDOW runs forward over one prompt of
# LMF_WINDOW_SEQ tokens, checked against a dense fp32 softmax
# LMF_WINDOW_HEADS heads at a time.  LMF_TOL: phase 6's bf16 tolerance.  K9
# is timed on layer 0's q/k/v at the head widths LMF_K9_TIMED.
LMF_MODELS = {"grok_1_314b": (4, 2, 16), "kimi_k2_1t_a32b": (1, 1, 8),
              "nemotron_4_15b": (None, 2, 8), "stablelm_12b": (None, 2, 8)}
LMF_PROMPT = 4096
LMF_CFGS = {}
LMF_WINDOW = ["n_layers=4", "attn_window=4096"]
LMF_WINDOW_SEQ = 8192
LMF_WINDOW_HEADS = 4
LMF_TOL = 2e-2
LMF_K9_TIMED = (112, 160)
# phase 12, the training path.  12a: each module of TRAIN_CHECK_CFGS's SMOKE
# in fp32, its parameters drawn once on the CPU (LM_SEED) and copied to the
# card, TRAIN_CHECK_STEPS TrainLoop steps at each accumulation of
# TRAIN_CHECK_ACCUM on the same lm_data_iterator batches (TRAIN_CHECK_BATCH ×
# TRAIN_CHECK_SEQ per microbatch, seed LM_TOKEN_SEED) on the card and on the
# CPU: losses, the first grad norm, the first step's gradients over max(1,
# each leaf's largest) and the final parameters (relative L2) within
# TRAIN_TOL, the first step's gradients leaf by leaf over each leaf's own
# largest magnitude within TRAIN_GRAD_TOL (measured up to 8.5e-5 on an
# H100), the five steps' update (parameters minus their start, relative L2)
# within TRAIN_UPDATE_TOL (measured up to 2.4e-3: a near-zero gradient whose
# sign the summation orders disagree on moves a parameter ~lr on one side
# only), and one AdamW update from the same parameters, moments and
# gradients on both, leaf by leaf beyond 2 ulps of the new parameter over
# the leaf's largest update, within TRAIN_SAME_UPDATE_TOL (an ulp of a
# parameter is up to 2e-3 of this update's size).  12b: the driver
# (repro_torch.launch.train) on minitron-8b for TRAIN_DRIVER_STEPS[0]
# steps, then again on the same checkpoint directory to
# TRAIN_DRIVER_STEPS[1].  12c: minitron-8b at full
# width under the overrides TRAIN_FULL, TRAIN_FULL_STEPS steps of
# TRAIN_FULL_BATCH × TRAIN_FULL_SEQ tokens under TRAIN_FULL_OPT.
TRAIN_CHECK_CFGS = ("minitron_8b", "grok_1_314b")
TRAIN_CHECK_STEPS = 5
TRAIN_CHECK_ACCUM = (1, 2)
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 4, 64
TRAIN_CHECK_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=5)
TRAIN_TOL = 1e-4
TRAIN_GRAD_TOL = 5e-4
TRAIN_UPDATE_TOL = 5e-3
TRAIN_SAME_UPDATE_TOL = 1e-5
TRAIN_DRIVER_STEPS = (20, 30)
TRAIN_FULL = ["n_layers=4", "loss_chunk=4096"]
TRAIN_FULL_STEPS = 8
TRAIN_FULL_BATCH, TRAIN_FULL_SEQ = 2, 4096
TRAIN_FULL_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=8)
# 12c's training losses are each on a new batch: they spread over 0.033
# (12.935 to 12.968 on an H100) while the steps lower them by less, so the
# last is held below the first plus this margin, and the first batch's loss
# evaluated again after training is held below its loss before
TRAIN_FULL_LOSS_SPREAD = 0.05
# phase 13, the GNN and recsys families, every model at its published CFG
# (fp32; no kernel of K1–K9 runs: every launch count must stay 0).  13a: each
# GNN on gnn_shapes()'s FAM_CHECK_CELL and DIN at FAM_CHECK_DIN_BATCH rows,
# parameters drawn once on the CPU (FAM_SEED) and copied to the card, the
# batch from seed FAM_SEED: the forward and the loss within FAM_TOL of the
# CPU's largest magnitude, every gradient leaf within FAM_GRAD_TOL of the
# leaf's largest, the parameters after one AdamW step (OPT) within FAM_TOL
# in relative L2; a second card run against the first within the same
# tolerances (index_add's fp32 atomics vary in the last bits).  graphcast's
# gradient leaves are held to FAM_DEEP_GRAD_TOL instead: with random weights
# its activations grow ~4-8x a layer (its loss is ~1e8 at 16 layers), and
# ulp-level differences of the atomic sums flip near-ties of a saturated
# softmax, so the card's own repeat differed by up to 3.2e-3 of a gradient
# leaf's largest on an H100 (g2m_edge_w0), while its forward, loss and
# parameters stayed within FAM_TOL.  A control run of graphcast on the card
# with TF32 products shows what a real loss of precision reads there; it is
# printed, not gated.  Then repro_torch.launch.train.main(["--arch", id,
# "--device", "cuda"]) for each id.  13b: each GNN FAM_STEPS AdamW steps
# (OPT) on one batch at its FAM_CELLS cell (the largest the card holds; the
# reason for a smaller one beside it), then FAM_PROFILES profiled steps.  13c:
# DIN's train_batch (DIN_TRAIN rows, DIN_STEPS steps on one batch), serve_p99
# (DIN_P99 rows, DIN_P99_CALLS timed calls), serve_bulk (DIN_BULK rows) and
# retrieval_cand (one user against DIN_RETRIEVAL candidates and torch.topk(·,
# DIN_TOPK); DIN_RETRIEVAL_CHECK sampled candidates against pointwise
# ``score``).  The cell's 1,000,000 candidates (DIN_RETRIEVAL_CELL) would need
# ~168 GB: a candidate took 168 kB of temporaries on an H100.
FAM_GNNS = ("gcn_cora", "graphsage_reddit", "schnet", "graphcast")
FAM_CHECK_CELL = "full_graph_sm"
FAM_CHECK_DIN_BATCH = 512
FAM_SEED = 0
FAM_TOL = 1e-5
FAM_GRAD_TOL = 1e-4
FAM_DEEP_GRAD_TOL = 1e-2
FAM_CELLS = {"gcn_cora": "ogb_products", "graphsage_reddit": "ogb_products",
             "schnet": "minibatch_lg", "graphcast": "minibatch_lg"}
FAM_STEPS = 3
FAM_PROFILES = 3
DIN_TRAIN, DIN_STEPS = 65536, 3
DIN_P99, DIN_P99_CALLS = 512, 50
DIN_BULK, DIN_BULK_CALLS = 262144, 3
DIN_RETRIEVAL_CELL, DIN_RETRIEVAL, DIN_TOPK, DIN_RETRIEVAL_CHECK = 1_000_000, 262_144, 1000, 64
# phase 14, the registry (repro_torch.configs.registry).  14a: every cell
# built, its arguments meta tensors, the card's memory untouched.  14b: the
# four sge cells at their exact shapes (n_t, w = round_up(ceil(n_t / 32),
# 128), P_PAD, MAX_PARENTS, ENGINE's lanes) on one pattern each, the first
# 8-edge pattern of the collection target of the cell's size (REG_TARGETS;
# phase 3's and phase 5's targets reused): one round from init_state, the
# dense cells plain, through K1 and through K2, the CSR cell through K7, K6
# and plain; every state field equal across the three.  The collections'
# targets carry 138-381 node labels, so such a query reaches a handful of
# states and its round is nearly empty; each cell runs again "loaded", on
# its target with the labels taken mod REG_LOADED_LABELS and an
# REG_LOADED_EDGES-edge pattern drawn from that (seed REG_LOADED_SEED),
# whose round keeps the lanes busy.  14c: minitron-8b's
# prefill_32k cell at REG_PREFILL_BATCH (the cell's batch 32 holds 137 GB of
# KV cache), K9 on layer 0's q/k/v against its plain version for the heads
# REG_K9_HEADS (one head's fp32 S x S scores are 4.3 GB) within phase 6's
# bf16 tolerance.  14d: repro_torch.launch.train.main(["--arch", "sge"]).
REG_TARGETS = {
    "sge_ppis32": "main",  # phase 3's target
    "sge_graemlin32": dict(name="graemlin32-like", pattern_edges=(8,), patterns_per_target=1,
                           scale=6726 / 500, seed=7, n_targets=1),
    "sge_pdbsv1": "sparse",  # phase 5's target A
    "sge_pdbsv1_csr": "sparse",
}
REG_LOADED_LABELS, REG_LOADED_EDGES, REG_LOADED_SEED = 4, 8, 11
REG_PREFILL_BATCH = 1
REG_PREFILL_SEQ = None  # the cell's 32,768
REG_K9_HEADS = (0, 13, 31)
REG_K9_TOL = 2e-2
# phase 15, the distributed layer and the dry-run.  15a: every registry cell
# through repro_torch.launch.dryrun.run_cell on both production meshes.  15b:
# minitron-8b at TRAIN_FULL's width drawn from LM_SEED, saved to DIST_CKPT,
# restored without like_*, placed onto make_local_mesh() and onto
# DIST_RESHARD (axes, sizes) laid over the card repeated.  15c: compress_grads
# twice over a bf16 tree of 15b's shapes drawn from DIST_GRAD_SEED; the CPU
# recomputes compress on every leaf of layer DIST_CHECK_LAYER and on the first
# DIST_EMBED_ROWS rows of embed; DIST_EF_STEPS steps of error feedback on
# embed at full width within DIST_EF_TOL (tests/test_optimizer.py's bound)
DIST_CKPT = ROOT / "build" / "dist_ckpt"
DIST_RESHARD = (("data", "model"), (2, 2))
DIST_GRAD_SEED = 3
DIST_CHECK_LAYER = 0
DIST_EMBED_ROWS = 4096
DIST_EF_STEPS, DIST_EF_TOL = 50, 1e-2
# phase 7, the dynamic path: benchmarks/bench_incremental.py's regime at the
# size of PPIS32's largest target (a power-law target of N_T nodes, average
# degree 4, 4 node labels, one edge label), its pattern rule (a 4-edge
# extract_pattern with 5 * N_T to 120,000 matches), DYN_STEPS edits of 1 % of
# the arcs each, maintained by four sessions (the step kernel each one
# launches in DYN_KERNEL_OF), then one more edit through an edge-seeded query
DYN = dict(n=N_T, avg_deg=4.0, alpha=2.0, n_labels=4, seed=7)
DYN_STEPS = 5
DYN_EDIT_FRACTION = 0.01
DYN_MIN_MATCHES, DYN_MAX_MATCHES = 5 * N_T, 120_000
DYN_MAINTAINERS = {
    "pallas": dict(step_backend="pallas"),
    "jnp+use_pallas": dict(step_backend="jnp", use_pallas=True),
    "csr flat": dict(step_backend="csr", use_pallas=True, csr_walk="flat"),
    "csr bucketed": dict(step_backend="csr", use_pallas=True),
}
DYN_KERNEL_OF = {"pallas": "extend_step", "jnp+use_pallas": "candidate_mask",
                 "csr flat": "csr_extend", "csr bucketed": "csr_extend_bucketed",
                 "edge csr bucketed": "csr_extend_bucketed"}
# phase 8, the out-of-core path: benchmarks/bench_outofcore.py's regime, a
# power-law target of 33,000 nodes (average degree 4, 8 node labels, seed 7)
# indexed CSR-only, its pattern (extract_pattern of 8 edges, seed 7), 8
# workers of expand_width 4, and a budget of a quarter of the padded resident
# bytes of the target as one partition; then OOC_N_PARTS partitions by count
OOC = dict(n=33_000, avg_deg=4.0, n_labels=8, seed=7)
OOC_PATTERN_EDGES = 8
OOC_KW = dict(n_workers=8, expand_width=4)
OOC_BUDGET_FACTOR = 4
OOC_N_PARTS = 2
# the partitioned sessions: (label, csr_walk, session keywords, the step
# kernel the walk launches)
OOC_RUNS = (("budget bucketed", "bucketed", "budget", "csr_extend_bucketed"),
            ("budget flat", "flat", "budget", "csr_extend"),
            (f"{OOC_N_PARTS} parts bucketed", "bucketed", "count", "csr_extend_bucketed"))
# phase 9, the service: phase 3's target (its dense index) serves SVC_CLIENTS
# client threads of SVC_TENANTS tenants in packs of SVC_SERVICE["max_lanes"]
# lanes.  Each client submits SVC_DENSE_PER_CLIENT of phase 4's 24 patterns
# (round-robin, prepared up front by prepare_batch on the card) and one of
# phase 5's target A patterns (prepared by the client on target A's sparse
# index), one dense query before and the others after a 1 % edit of the
# dense target (SVC_EDIT_SEED, drawn as phase 7 draws its edits); even
# clients collect SVC_COLLECT mappings per worker, odd ones count.  Then the
# same dense traffic through K1 without and with a warm-up profile, and phase
# 8's out-of-core query twice.  SVC_KERNELS gates each service's launches.
SVC_CLIENTS, SVC_TENANTS = 16, 4
SVC_DENSE_PER_CLIENT = 3
SVC_VARIANT = "ri-ds-si-acfc"
SVC_COLLECT = 32
SVC_SERVICE = dict(max_lanes=8, batch_window_s=0.002, chunk_size=256)
SVC_EDIT_SEED = 9
SVC_TIMEOUT = 180.0
SVC_KERNELS = {"S1": ("candidate_mask", "csr_extend_bucketed", "csr_arc_sweep",
                      "adjacency_any", "popcount_rows"),
               "S2": ("extend_step",), "S3": ("csr_extend",)}
# phase 10, multi-device and the driver: worker stacks sharded over
# Mesh((cuda:0,) * D) for D in MESH_SHARDS on phase 3's queries (MESH_COLLECT
# mappings per worker collected, so the match buffers compare too), D = 2 on
# phase 5's and phase 7's, D = 1 and 2 on phase 8's query (MESH_OOC_COLLECT
# holds all its mappings); then repro_torch.launch.sge_run on PDBSv1's largest
# targets CSR-only (target 0 is phase 5's target A) in each mode, and dense
# through K1 on a PDBSv1-like draw whose numpy preparation takes seconds
MESH_SHARDS = (1, 2, 4)
MESH_COLLECT = 16
MESH_OOC_COLLECT = 4096
MESH_DRIVER_SCALE = SPARSE_NT / 2400
MESH_DRIVER_SPARSE = ["--collection", "pdbsv1-like", "--scale", repr(MESH_DRIVER_SCALE),
                      "--sparse-index", "--step-backend", "csr", "--use-pallas",
                      "--variant", "ri-ds-si-acfc"]
MESH_DRIVER_DENSE = ["--collection", "pdbsv1-like", "--scale", "1.0", "--step-backend",
                     "pallas"]
# targets and patterns that earlier phases built and phases 9 and 10 reuse
SHARED = {}
# K9 edge cases (bh, S, S_kv, d, inputs): one query; ragged lengths; S > S_kv
# and S < S_kv; d of 16, 64, 80, 128 and 256; every score equal
K9_EDGES = [(4, 1, 1, 64, "random"), (3, 9, 9, 16, "random"), (2, 200, 200, 80, "random"),
            (2, 1000, 1000, 128, "random"), (2, 200, 37, 64, "random"),
            (2, 37, 200, 64, "random"), (2, 1, 1000, 16, "random"),
            (2, 1000, 1000, 128, "equal"), (1, 130, 130, 256, "random")]
# K9 cases at the bf16 route's boundaries (checked in fp32 too): head widths
# 24 and 100 (not a multiple of 64; 100 is padded to 104 by the wrapper), 112
# (kimi-k2's, through the 128-wide template) and 160 (stablelm-12b's; a
# 64-column box wholly past the width, zero-filled by TMA); one row
# past a 128-row query tile (S 4,097 and 129); a KV tile cut short (S_kv 127
# < S 300); d 256 with S 300 (64-key tiles)
K9_TC_EDGES = [(2, 300, 300, 24, "random"), (2, 300, 300, 100, "random"),
               (2, 300, 300, 112, "random"), (2, 300, 300, 160, "random"), (1, 4097, 4097, 128, "random"),
               (2, 129, 129, 128, "random"), (2, 300, 127, 128, "random"),
               (2, 300, 300, 256, "random")]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def tensor_core_instructions(name: str) -> dict:
    """Tensor-core instructions in the SASS of kernel ``name``'s library
    (``cuobjdump -sass``): ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync) lines."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return dict(cuobjdump="not found")
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout.splitlines()
    return {op: sum(f" {op}." in ln or f" {op} " in ln for ln in sass) for op in ("HGMMA", "HMMA")}


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


def cuda_ms_cold(fn, reps: int = 30, warmup: int = 3) -> float:
    """As :func:`cuda_ms`, with the L2 cache flushed before each call: a
    256 MB buffer (five times the H100's 50 MB L2) is written between calls,
    outside the events that time them."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for i in range(reps):
        flush.zero_()
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return statistics.median(start[i].elapsed_time(end[i]) for i in range(reps))


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


def offset_view(t, k: int):
    """A contiguous copy of ``t`` that starts ``k`` words past a 16-byte
    boundary."""
    buf = t.new_zeros(t.numel() + 4)
    view = buf[k:k + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def dense_step_args(x, n_p):
    """K1's and K2's arguments from :func:`kernel_inputs`' dictionary."""
    k1 = (x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["depth"], n_p, x["used"], x["cand"])
    k2 = (x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["used"])
    return k1, k2


def dense_step_case(x, n_p, **label) -> dict:
    """K1 and K2 against their plain versions on one set of inputs (0
    mismatched words required), with the lanes per block of the launch."""
    import torch

    from repro_torch.kernels import candidate_mask as cm_mod
    from repro_torch.kernels import extend_step as es_mod
    from repro_torch.kernels import ref as kref

    k1, k2 = dense_step_args(x, n_p)
    km, pm = cm_mod.candidate_mask_cuda(*k2), kref.candidate_mask_ref(*k2)
    ke, pe = es_mod.extend_step_cuda(*k1), kref.extend_step_ref(*k1)
    torch.cuda.synchronize()
    b, w = x["used"].shape
    mp = x["row_idx"].shape[1]
    return dict(b=b, w=w, mp=mp, n_rows=x["rows"].shape[0] - 1, p_pad=x["dom_bits"].shape[0],
                **label, lanes_per_block=es_mod.dense_step_layout(mp, b).lanes,
                candidate_mask_mismatches=int((km != pm).sum()),
                extend_step_mismatches=sum(int((k != p).sum()) for k, p in zip(ke, pe)),
                candidate_mask_err=max_abs_err(km, pm),
                extend_step_err=max(max_abs_err(k, p) for k, p in zip(ke, pe)))


def dense_step_timing(x, n_p, n_rows) -> dict:
    """K1 and K2 timed on one set of inputs: warm L2 (``ms``) and flushed
    before each call (``cold_ms``), beside the plain version, the bytes each
    must move and the operations, with the lanes that hold candidates."""
    from repro_torch.kernels import candidate_mask as cm_mod
    from repro_torch.kernels import extend_step as es_mod
    from repro_torch.kernels import ref as kref

    k1, k2 = dense_step_args(x, n_p)
    b, w = x["used"].shape
    real = float((x["row_idx"] != n_rows).sum()) / b
    valid = int((x["cand"] != 0).any(dim=1).sum())
    want = int(((x["cand"] != 0).any(dim=1) & (x["depth"] + 1 < n_p)).sum())
    return {
        "candidate_mask": dict(
            ms=cuda_ms(lambda: cm_mod.candidate_mask_cuda(*k2)),
            cold_ms=cuda_ms_cold(lambda: cm_mod.candidate_mask_cuda(*k2)),
            plain_ms=cuda_ms(lambda: kref.candidate_mask_ref(*k2)),
            bytes=candidate_mask_bytes(x, n_rows), ops=op_count(x, real), valid_lanes=valid),
        "extend_step": dict(
            ms=cuda_ms(lambda: es_mod.extend_step_cuda(*k1)),
            cold_ms=cuda_ms_cold(lambda: es_mod.extend_step_cuda(*k1)),
            plain_ms=cuda_ms(lambda: kref.extend_step_ref(*k1)),
            bytes=extend_step_bytes(x, n_rows, n_p), ops=op_count(x, real) + 2 * b * w,
            valid_lanes=valid, lanes_wanting_child=want),
    }


# K1 / K2 edge cases (b, w, mp, n_rows, p_pad, what), beside the shapes of
# check_kernels: b 1 and 7 (one lane per block), 2,115 and 16,384 (8 lanes
# per block; 2,115 leaves 3 in the last block), mp 9 and 33 (lanes with
# more rows than one group of a pass holds; 33 takes two trips of row
# indices), w 1,034 / 1,035 / 1,036 (many passes), and inputs with every
# lane empty, every lane a match, every slot neutral, all-zero and
# all-ones rows
DENSE_EDGES = [(1, 393, 8, 600, 32, "random"), (7, 393, 8, 600, 32, "random"),
               (2115, 393, 8, 600, 32, "random"), (16384, 393, 8, 600, 32, "random"),
               (301, 393, 9, 600, 32, "random"), (301, 393, 33, 600, 32, "random"),
               (70, 1035, 33, 300, 16, "random"), (97, 1034, 8, 300, 16, "random"),
               (4096, 393, 8, 600, 32, "all lanes empty"),
               (4096, 393, 8, 600, 32, "all lanes matches"),
               (301, 393, 8, 600, 32, "all slots neutral"), (301, 37, 8, 60, 8, "zero rows"),
               (301, 1036, 8, 60, 8, "ones rows")]


def dense_edge_inputs(rng, b, w, mp, n_rows, p_pad, what, device):
    x, n_p = kernel_inputs(rng, b, w, mp, n_rows, p_pad, device)
    if what == "all lanes empty":
        x["cand"].zero_()
    elif what == "all lanes matches":
        x["depth"].fill_(n_p - 1)
    elif what == "all slots neutral":
        x["row_idx"].fill_(n_rows)
    elif what in ("zero rows", "ones rows"):
        x["rows"][:n_rows] = 0 if what == "zero rows" else -1
    return x, n_p


def check_kernels(device):
    import numpy as np

    rng = np.random.default_rng(11)
    main = (4096, (N_T + 31) // 32, MAIN_MP, 2 * N_T, MAIN_P_PAD)
    shapes = [main, (1, 1, 1, 2, 1), (4, 33, 2, 10, 5), (16, 257, 4, 64, 8),
              (7, 33, 0, 7, 4), (1, 257, 8, 100, 16)]
    checks = []
    timing = {}
    for b, w, mp, n_rows, p_pad in shapes:
        x, n_p = kernel_inputs(rng, b, w, mp, n_rows, p_pad, device)
        checks.append(dense_step_case(x, n_p))
        if (b, w, mp, n_rows, p_pad) == main:
            timing = dense_step_timing(x, n_p, n_rows)
        del x
    for b, w, mp, n_rows, p_pad, what in DENSE_EDGES:
        x, n_p = dense_edge_inputs(rng, b, w, mp, n_rows, p_pad, what, device)
        checks.append(dense_step_case(x, n_p, inputs=what))
        del x
    # w ≡ 0, 1, 2, 3 (mod 4), the table's rows and dom rows at each of the
    # four word offsets from a 16-byte boundary, cand and used at another
    # (K1's wrapper realigns cand); rows of odd w sit at every offset
    for w in (36, 37, 38, 39, 393, 1034, 1035, 1036):
        for k in range(4):
            x, n_p = kernel_inputs(rng, 61, w, 8, 40, 8, device)
            x["rows"] = offset_view(x["rows"], k)
            x["dom_bits"] = offset_view(x["dom_bits"], (k + 1) % 4)
            x["cand"] = offset_view(x["cand"], (k + 2) % 4)
            x["used"] = offset_view(x["used"], (k + 3) % 4)
            checks.append(dense_step_case(x, n_p, inputs=f"rows at word offset {k}"))
    return checks, timing


DOMAIN_KERNELS = ("popcount_rows", "adjacency_any", "arc_any_sweep")


def domain_kernel_case(adj, arc_row, masks, pair_plane=None) -> dict:
    """K3, K5 and K4 against their plain versions on one set of inputs:
    K3 on the rows of plane ``arc_row[0]``, K5 on that plane with
    ``masks[0]`` and batched over every arc (on ``pair_plane``, default
    ``arc_row``), K4 on every arc.  Returns mismatched words and the
    largest error per kernel."""
    import torch

    from repro_torch.kernels import domain_ac, popcount_reduce
    from repro_torch.kernels import ref as kref

    plane = adj[int(arc_row[0])]
    pair_plane = arc_row if pair_plane is None else pair_plane
    pairs = {
        "popcount_rows": (popcount_reduce.popcount_rows_cuda(plane),
                          kref.popcount_rows_ref(plane)),
        "adjacency_any": (domain_ac.adjacency_any_cuda(plane, masks[0]),
                          kref.adjacency_any_ref(plane, masks[0])),
        "adjacency_any_pairs": (domain_ac.adjacency_any_pairs_cuda(adj, pair_plane, masks),
                                kref.adjacency_any_pairs_ref(adj, pair_plane, masks)),
        "arc_any_sweep": (domain_ac.arc_any_sweep_cuda(adj, arc_row, masks),
                          kref.arc_any_sweep_ref(adj, arc_row, masks)),
    }
    torch.cuda.synchronize()
    case = dict(n_planes=adj.shape[0], n_t=adj.shape[1], w=adj.shape[2], n_arcs=masks.shape[0])
    for name, (k, p) in pairs.items():
        case[f"{name}_mismatches"] = int((k != p).sum())
        case[f"{name}_err"] = max_abs_err(k, p)
    return case


def check_domain_kernels_edges(device) -> list:
    """K3, K4 and K5 at edge shapes: w ∈ {1, 33, 257, 393, 600, 12,288}
    (rows of several load passes, up to ``MAX_W``), n_t not a multiple of
    any row tile, one arc, all-zero and all-ones masks, sparse
    rows (so most rows read to their end), dense ones and all-ones rows
    (more nonzero words than a row's slots); batched K5 also with every
    plane named, a pair on a plane out of range and, at w = 393, 300 pairs
    on two planes (several mask chunks)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(12)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

    cases = []
    for n_planes, n_t, w, n_arcs, density in [(2, 1, 1, 1, 0.5), (2, 65, 1, 3, 0.5),
                                              (4, 100, 33, 1, 0.02), (2, 257, 33, 6, 0.5),
                                              (6, 1000, 257, 9, 0.002), (2, 129, 257, 48, 0.01),
                                              (3, 97, 393, 7, 0.002), (2, 300, 393, 300, 0.002),
                                              (2, 70, 600, 5, 0.01), (1, 40, 12288, 2, 0.0005)]:
        bits = rng.random((n_planes, n_t, w * 32)) < density
        adj = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)
        arc_row = rng.integers(0, n_planes, n_arcs).astype(np.int32)
        arc_row[: min(n_planes, n_arcs)] = np.arange(min(n_planes, n_arcs))
        pair_plane = arc_row.copy()
        if n_arcs > 1:
            pair_plane[-1] = n_planes  # out of range
        masks = rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32)
        masks[0] &= rng.integers(0, 2**32, w, dtype=np.uint32)  # sparser first mask
        for fill in (None, 0, 0xFFFFFFFF):
            if fill is not None:
                masks = np.full((n_arcs, w), fill, np.uint32)
            for rows in ("random",) if fill is None else ("random", "ones", "zeros"):
                a = adj if rows == "random" else np.full_like(adj, 0 if rows == "zeros" else
                                                              0xFFFFFFFF)
                cases.append(dict(domain_kernel_case(t(a), t(arc_row), t(masks), t(pair_plane)),
                                  mask="random" if fill is None else hex(fill), rows=rows))
    return cases


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


def record_step(enum, query, kernel: str) -> dict:
    """The arguments of the call of ``kernel`` (K1 ``extend_step`` or K2
    ``candidate_mask``) with the most valid lanes (lanes whose popped entry
    holds candidates) in one more run of ``query``, as
    :func:`kernel_inputs`' dictionary.  The rows and dom rows are the plan's
    own; the per-lane arguments are copies."""
    from repro_torch.core import extend
    from repro_torch.kernels import ops

    best = dict(valid=-1)
    step = dict(valid=0)  # the valid lanes of the jnp step now running
    op = getattr(ops, kernel)
    expand = extend.JnpStepBackend.expand_lanes

    def counted(self, depth, map_, used, cand):
        step["valid"] = int((cand != 0).any(dim=1).sum())
        return expand(self, depth, map_, used, cand)

    def k1(rows, dom_bits, child_pos, row_idx, depth, n_p, used, cand):
        valid = int((cand != 0).any(dim=1).sum())
        if valid > best["valid"]:
            best.update(valid=valid, n_p=n_p, x=dict(
                rows=rows, dom_bits=dom_bits, pos=child_pos.clone(), row_idx=row_idx.clone(),
                depth=depth.clone(), used=used.clone(), cand=cand.clone()))
        return op(rows, dom_bits, child_pos, row_idx, depth, n_p, used, cand)

    def k2(rows, dom_bits, pos, row_idx, used):
        if step["valid"] > best["valid"]:
            best.update(valid=step["valid"], n_p=None, x=dict(
                rows=rows, dom_bits=dom_bits, pos=pos.clone(), row_idx=row_idx.clone(),
                used=used.clone()))
        return op(rows, dom_bits, pos, row_idx, used)

    setattr(ops, kernel, k1 if kernel == "extend_step" else k2)
    extend.JnpStepBackend.expand_lanes = counted
    try:
        enum.run(query)
    finally:
        setattr(ops, kernel, op)
        extend.JnpStepBackend.expand_lanes = expand
    if best["valid"] < 0:
        raise AssertionError(f"{query.name}: no {kernel} call to record")
    return dict(best, query=query.name)


def check_real_steps(steps: dict) -> tuple:
    """K1 and K2 against their plain versions, and timed (warm and cold L2),
    on the step of phase 3's deepest query with the most valid lanes."""
    import torch

    from repro_torch.kernels import candidate_mask as cm_mod
    from repro_torch.kernels import extend_step as es_mod
    from repro_torch.kernels import ref as kref

    cases, timing = [], {}
    for name, s in steps.items():
        x, n_p = s["x"], s["n_p"]
        n_rows = x["rows"].shape[0] - 1
        b, w = x["used"].shape
        mp = x["row_idx"].shape[1]
        if name == "extend_step":
            args = (x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["depth"], n_p,
                    x["used"], x["cand"])
            kern, plain = es_mod.extend_step_cuda, kref.extend_step_ref
            nbytes = extend_step_bytes(x, n_rows, n_p)
        else:
            args = (x["rows"], x["dom_bits"], x["pos"], x["row_idx"], x["used"])
            kern, plain = cm_mod.candidate_mask_cuda, kref.candidate_mask_ref
            nbytes = candidate_mask_bytes(x, n_rows)
        got, want = kern(*args), plain(*args)
        if name == "candidate_mask":
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        cases.append({"inputs": f"real step of {s['query']}", "b": b, "w": w, "mp": mp,
                      "valid_lanes": s["valid"],
                      f"{name}_mismatches": sum(int((g != p).sum()) for g, p in zip(got, want)),
                      f"{name}_err": max(max_abs_err(g, p) for g, p in zip(got, want))})
        timing[name] = dict(valid_lanes=s["valid"], bytes=nbytes,
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                            ms=cuda_ms(lambda: kern(*args)),
                            cold_ms=cuda_ms_cold(lambda: kern(*args)),
                            plain_ms=cuda_ms(lambda: plain(*args)))
    return cases, timing


def root_frontier(vertex_plan, edge_plan, cfg) -> dict:
    """The root frontier of a query under each seeding: the vertex split's
    roots (|dom[0]|) against the edge seeding's depth-1 entries, the seed
    edge, whether the entries fit the stacks (else the engine falls back to
    the masked vertex split), and the host seconds of building them."""
    import numpy as np

    from repro_torch.core import frontier

    t0 = time.perf_counter()
    seeds = frontier.root_seed_entries(edge_plan)[0].shape[0]
    seed_s = time.perf_counter() - t0
    per_worker = -(-seeds // cfg.n_workers)
    return dict(seed_edge=list(edge_plan.seed_edge), vertex_roots=int(
        np.unpackbits(vertex_plan.dom_bits[0].view(np.uint8)).sum()), edge_seeds=int(seeds),
        seeded=per_worker <= cfg.resolved_stack_cap(edge_plan.p_pad) - 1,
        root_seed_entries_s=seed_s)


def run_edge_seeded_dense(device, index, inst, vertex) -> dict:
    """Phase 3's edge-seeded query: ``inst``'s pattern prepared with
    ``seed_edge="auto"`` and run under ``root_seeding="edge"`` through K1
    (``pallas``) and K2 (``jnp`` + ``use_pallas``); ``vertex`` is its
    vertex-seeded ``pallas`` run.  Returns each run's launch counts."""
    from repro_torch.core import EngineConfig, Enumerator

    launches, runs = {}, {}
    for label, kw in (("edge pallas", dict(step_backend="pallas")),
                      ("edge jnp+use_pallas", dict(step_backend="jnp", use_pallas=True))):
        enum = Enumerator(index, config=EngineConfig(**ENGINE_KW, **kw, root_seeding="edge"),
                          variant=VARIANT, device=device)
        q = enum.prepare(inst.pattern, name=inst.name, seed_edge="auto")
        enum.run(q)  # warm-up
        runs[label], launches[label] = _launched(lambda: enum.run(q))
    ms_k1, ms_k2 = runs["edge pallas"], runs["edge jnp+use_pallas"]
    emit(dict(phase="main_path_edge_seeded", query=inst.name, launches=launches,
              frontier=root_frontier(vertex.plan, ms_k1.plan, enum.config),
              vertex_match_s=vertex.match_s, vertex_states=vertex.states,
              vertex_steps=vertex.steps,
              runs={label: dict(matches=ms.matches, states=ms.states, steps=ms.steps,
                                steals=ms.steals, retries=ms.retries, match_s=ms.match_s)
                    for label, ms in runs.items()}))
    if not launches["edge pallas"]["extend_step"]:
        raise AssertionError("the edge-seeded pallas run never launched extend_step")
    if not launches["edge jnp+use_pallas"]["candidate_mask"]:
        raise AssertionError("the edge-seeded jnp+use_pallas run never launched candidate_mask")
    if _counters(ms_k1) != _counters(ms_k2):
        raise AssertionError("edge-seeded K1 and K2 runs disagree")
    if ms_k1.matches != vertex.matches:
        raise AssertionError(f"{inst.name}: edge-seeded matches {ms_k1.matches} != "
                             f"vertex-seeded {vertex.matches}")
    return launches


def main_target() -> tuple:
    """Phase 3's target (target 0 of :data:`COLLECTION`), its dense index
    and its six patterns (``Instance`` objects)."""
    from repro_torch.core import SubgraphIndex
    from repro_torch.data import graphgen

    insts = graphgen.make_collection(**COLLECTION)
    target = insts[0].target
    return target, SubgraphIndex.build(target), [i for i in insts if i.target is target]


def run_main_path(device):
    from repro_torch.core import EngineConfig, Enumerator
    from repro_torch.core.ref import ref_enumerate
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    target, index, patterns = main_target()
    setup = dict(phase="main_path_setup", n_t=target.n, edges=target.m // 2,
                 labels=target.n_node_labels, w=index.w, patterns=len(patterns),
                 setup_s=time.perf_counter() - t0)
    emit(setup)

    backends = {
        "pallas": dict(step_backend="pallas"),
        "jnp+use_pallas": dict(step_backend="jnp", use_pallas=True),
        "jnp": dict(step_backend="jnp"),
    }
    results, launches, real_steps = {}, {}, {}
    kernel_of = {"pallas": "extend_step", "jnp+use_pallas": "candidate_mask"}
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
        if label in kernel_of:  # a real step's arguments, for phase 2's checks and times
            real_steps[kernel_of[label]] = record_step(enum, queries[deepest], kernel_of[label])

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
    SHARED["main"] = dict(target=target, index=index, patterns=patterns)
    if launches["pallas"]["extend_step"] == 0:
        raise AssertionError("the pallas run never launched extend_step")
    if launches["jnp+use_pallas"]["candidate_mask"] == 0:
        raise AssertionError("the jnp+use_pallas run never launched candidate_mask")
    deepest = max(range(len(patterns)), key=lambda i: results["pallas"][i].states)
    launches.update(run_edge_seeded_dense(device, index, patterns[deepest],
                                          results["pallas"][deepest]))
    return launches, real_steps



# ---------------------------------------------------------------------------
# phase 4: the batch path
# ---------------------------------------------------------------------------

def _counters(ms):
    return (ms.matches, ms.states, ms.steps, ms.steals, ms.steal_rounds,
            None if ms.per_worker_states is None else ms.per_worker_states.tolist(),
            None if ms.per_worker_matches is None else ms.per_worker_matches.tolist(),
            None if ms.per_worker_steals is None else ms.per_worker_steals.tolist())


def _launched(fn):
    """Run ``fn`` with every launch count set to 0 just before; returns its
    result and the counts read just after."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    return out, ops.launch_counts()


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def profile_pack(enum, queries) -> dict:
    """One warm ``run_pack`` of ``queries`` under ``torch.profiler``: the
    card's busy share of the pack's wall time and its kernel launches per
    engine step (the pack's steps are its longest lane's)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(enum.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = enum.run_pack(queries, pack_size=PACK_SIZE)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    steps = max(ms.steps for ms in res)
    if not kernels:
        return dict(queries=[q.name for q in queries],
                    device_time="not measured (no device events traced)")
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return dict(queries=[q.name for q in queries], steps=steps, profiled_wall_s=wall,
                device_busy_s=busy_us / 1e6, device_busy_share=busy_us / 1e6 / wall,
                kernel_launches=n_kernels, launches_per_step=n_kernels / steps,
                top=[dict(name=e.key[:80], count=e.count, device_us=e.self_device_time_total)
                     for e in top])


def _largest_k5_sweep(fn):
    """Run ``fn`` with ``ops.adjacency_any_pairs`` watched; returns its
    result and the ``(plane, masks)`` of the K5 call with the most pairs
    (the tensors the fixpoint made for that sweep, which it never changes
    again)."""
    from repro_torch.kernels import ops

    biggest = {}
    k5 = ops.adjacency_any_pairs

    def watched(adj_flat, plane, masks):
        if plane.shape[0] > biggest.get("plane", plane[:0]).shape[0]:
            biggest.update(plane=plane, masks=masks)
        return k5(adj_flat, plane, masks)

    ops.adjacency_any_pairs = watched
    try:
        out = fn()
    finally:
        ops.adjacency_any_pairs = k5
    return out, biggest


def run_batch_path(device, collection=None):
    """Phase 4: ``prepare_batch`` (device fixpoint with K5 + K3, and plain)
    against the numpy preparation, the single-query sweep fixpoint (K4 +
    K3), and ``run_batch`` in packs through K1 and through K2, each pack
    lane against the same query's single run and ``ref_enumerate``.
    ``prepare_batch`` must launch K5 once per AC sweep of each domain
    bucket's fixpoint.  Returns the launch counts of the runs that use each
    kernel, and the inputs of the full-width domain-kernel check (with the
    largest K5 sweep)."""
    import numpy as np

    from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
    from repro_torch.core import domains as dom
    from repro_torch.core.plan import variant_flags
    from repro_torch.core.ref import ref_enumerate
    from repro_torch.core.session import snap_arc_pad, snap_loop_pad, snap_p_pad
    from repro_torch.data import graphgen

    t0 = time.perf_counter()
    insts = graphgen.make_collection(**(collection or BATCH_COLLECTION))
    target = insts[0].target
    insts = [i for i in insts if i.target is target]
    patterns = [i.pattern for i in insts]
    names = [i.name for i in insts]
    SHARED["batch"] = dict(patterns=patterns, names=names)
    index = SubgraphIndex.build(target)
    buckets, fixpoints = {}, set()  # pattern shapes; prepare_batch's groups
    for p in patterns:
        n_p, n_a, n_l = dom.domain_bucket(p)
        key = f"p{n_p}/arcs{n_a}/loops{n_l}"
        buckets[key] = buckets.get(key, 0) + 1
        fixpoints.add((snap_p_pad(n_p), snap_arc_pad(n_a), snap_loop_pad(n_l)))
    emit(dict(phase="batch_path_setup", n_t=target.n, w=index.w, patterns=len(patterns),
              pattern_shapes=buckets, prepare_batch_buckets=sorted(fixpoints),
              setup_s=time.perf_counter() - t0))

    def session(variant, **kw):
        return Enumerator(index, config=EngineConfig(**ENGINE_KW, **kw), variant=variant,
                          device=device)

    launches = {"prepare_batch": {}, "sweep": {}, "run_batch_pallas": {}, "run_batch_jnp": {}}
    full_width, largest = None, {}
    for variant in BATCH_VARIANTS:
        kern = session(variant, step_backend="pallas", use_pallas=True)  # K5 + K3, K1
        plain = session(variant, step_backend="pallas")  # plain fixpoint
        k2 = session(variant, step_backend="jnp", use_pallas=True)  # K2
        kern.prepare_batch(patterns[:PACK_SIZE])  # warm-up: first use of each op

        dom.reset_sweep_count()
        (qs, prep_counts), sweep_in = _largest_k5_sweep(
            lambda: _launched(lambda: kern.prepare_batch(patterns, names=names)))
        ac_sweeps = dom.ac_sweeps
        _add(launches["prepare_batch"], prep_counts)
        if not (prep_counts["adjacency_any"] and prep_counts["popcount_rows"]):
            raise AssertionError(f"{variant}: prepare_batch(use_pallas) launched {prep_counts}")
        if prep_counts["adjacency_any"] != ac_sweeps:
            raise AssertionError(f"{variant}: prepare_batch launched K5 "
                                 f"{prep_counts['adjacency_any']} times in {ac_sweeps} AC sweeps")
        if sweep_in["plane"].shape[0] > largest.get("plane", sweep_in["plane"][:0]).shape[0]:
            largest = dict(sweep_in, variant=variant)
        qs_plain, counts_plain = _launched(lambda: plain.prepare_batch(patterns, names=names))
        if any(counts_plain.values()):
            raise AssertionError(f"{variant}: the plain fixpoint launched {counts_plain}")
        qs_np = kern.prepare_batch(patterns, names=names, backend="numpy")
        for a, b, c in zip(qs, qs_plain, qs_np):
            for f in ("dom_bits", "order", "parent_pos", "parent_dir", "parent_elab"):
                if not (np.array_equal(getattr(a.plan, f), getattr(c.plan, f))
                        and np.array_equal(getattr(b.plan, f), getattr(c.plan, f))):
                    raise AssertionError(f"{variant} {a.name}: device {f} != numpy")
            if not a.satisfiable == b.satisfiable == c.satisfiable:
                raise AssertionError(f"{variant} {a.name}: satisfiable differs")

        flags = variant_flags(variant)
        flags = dict(use_ac=flags["use_ac"], use_fc=flags["use_fc"],
                     interleave=flags["interleave"])
        tgt = kern._target_domain_arrays(index)
        sweep_counts = {}
        for p, q in zip(patterns, qs_np):
            d, counts = _launched(lambda: dom.compute_domains_device(
                p, index.packed, use_pallas=True, tgt_arrays=tgt, **flags))
            _add(sweep_counts, counts)
            if d.satisfiable != q.satisfiable or not np.array_equal(d.bits, q.plan.domains.bits):
                raise AssertionError(f"{variant} {q.name}: sweep fixpoint != numpy")
        _add(launches["sweep"], sweep_counts)
        if not (sweep_counts["arc_any_sweep"] and sweep_counts["popcount_rows"]):
            raise AssertionError(f"{variant}: the sweep fixpoint launched {sweep_counts}")

        singles = [kern.run(q) for q in qs]  # also warms up the engine's ops
        packed_runs, run_counts = {}, {}
        for label, enum in (("run_batch_pallas", kern), ("run_batch_jnp", k2)):
            packed_runs[label], run_counts[label] = _launched(
                lambda: list(enum.stream(qs, pack_size=PACK_SIZE)))
            _add(launches[label], run_counts[label])
        if not run_counts["run_batch_pallas"]["extend_step"]:
            raise AssertionError("the pallas packs never launched extend_step")
        if not run_counts["run_batch_jnp"]["candidate_mask"]:
            raise AssertionError("the jnp+use_pallas packs never launched candidate_mask")
        for label, res in packed_runs.items():
            by_index = {ms.query_index: ms for ms in res}
            for i, one in enumerate(singles):
                if _counters(by_index[i]) != _counters(one):
                    raise AssertionError(f"{variant} {label} {one.name}: pack != single run")
        oracle = []
        for p, one in zip(patterns, singles):
            ref = ref_enumerate(p, target, plan=one.plan)
            oracle.append((ref.matches, ref.states))
            if (ref.matches, ref.states) != (one.matches, one.states):
                raise AssertionError(f"{one.name}: engine {(one.matches, one.states)} != "
                                     f"ref_enumerate {(ref.matches, ref.states)}")

        packs = []  # one pack's lanes share one match_s value and come out together
        for ms in packed_runs["run_batch_pallas"]:
            if packs and packs[-1]["match_s"] == ms.match_s:
                packs[-1]["queries"].append(ms.name)
            else:
                packs.append(dict(match_s=ms.match_s, queries=[ms.name]))
        deepest = sorted(range(len(qs)), key=lambda i: -singles[i].states)[:PACK_SIZE]
        emit(dict(
            phase="batch_path", variant=variant,
            prepare_s=[dict(name=q.name, device_s=q.prepare_s, numpy_s=c.prepare_s)
                       for q, c in zip(qs, qs_np)],
            prepare_batch_launches=prep_counts, sweep_launches=sweep_counts,
            prepare_batch_k5=dict(launches=prep_counts["adjacency_any"], ac_sweeps=ac_sweeps,
                                  buckets=len(fixpoints),
                                  largest_sweep_pairs=int(sweep_in["plane"].shape[0])),
            k5_launches_per_sweep=(prep_counts["adjacency_any"]
                                   / max(sweep_counts["arc_any_sweep"], 1)),
            k3_launches_per_sweep_sweep_route=(sweep_counts["popcount_rows"]
                                               / max(sweep_counts["arc_any_sweep"], 1)),
            packs_pallas=packs,
            run_batch_launches=run_counts,
            profile_pack=profile_pack(kern, [qs[i] for i in deepest]),
            queries=[dict(name=one.name, satisfiable=q.satisfiable, matches=one.matches,
                          states=one.states, steps=one.steps, single_match_s=one.match_s,
                          ref=list(o))
                     for q, one, o in zip(qs, singles, oracle)]))

        if full_width is None:  # the first pattern with 48 arcs, with its device domains
            i = next(i for i, p in enumerate(patterns)
                     if dom.domain_bucket(p)[1] == 48 and qs[i].satisfiable)
            arrs = dom.pattern_domain_arrays(patterns[i])
            bits = qs_np[i].plan.domains.bits
            full_width = dict(name=names[i], adj_flat=tgt.adj_flat,
                              arc_row=(np.clip(arrs.arc_lab, 0, index.n_edge_labels - 1) * 2
                                       + arrs.arc_dir).astype(np.int32),
                              masks=np.ascontiguousarray(bits[arrs.arc_q]))
    full_width["largest_sweep"] = largest
    return launches, full_width


def needed_words(plane, masks) -> "torch.Tensor":
    """Per mask and row, the words an any-test must read for this data:
    up to and including the first word where ``row ∧ mask`` is not zero,
    else the whole row (``[n_masks, n_t]``)."""
    import torch

    out = []
    for m in masks:
        hit = (plane & m[None, :]) != 0
        out.append(torch.where(hit.any(dim=1), hit.to(torch.int32).argmax(dim=1) + 1,
                               plane.shape[1]))
    return torch.stack(out)


def needed_tests(plane, need) -> int:
    """The (mask, word) tests a support test needs: per mask and row, the
    row's nonzero words among the first ``need`` (a zero word cannot hit)."""
    import torch

    nonzero = (plane != 0).to(torch.int32).cumsum(dim=1)  # [n_t, w]
    return int(nonzero.gather(1, (need - 1).T.long()).sum())


def pair_sweep_work(adj, plane, masks) -> dict:
    """What one K4 / batched-K5 launch must do for these inputs: each named
    plane read once, as far as the furthest-reading pair on it needs
    (``words``; ``planes`` whole planes for a full read), the masks, the
    plane ids and the flags; an AND and a test per needed (pair, nonzero
    word)."""
    n_planes, n_t, w = adj.shape
    n_pairs = masks.shape[0]
    rows = plane.tolist()
    on = sorted({r for r in rows if 0 <= r < n_planes})
    words = ops = 0
    for r in on:
        need = needed_words(adj[r], masks[[i for i, q in enumerate(rows) if q == r]])
        words += int(need.max(dim=0).values.sum())
        ops += 2 * needed_tests(adj[r], need)
    io = n_pairs * (w + 1) + n_pairs * n_t
    return dict(bytes=words_bytes(words + io), bytes_full=words_bytes(len(on) * n_t * w + io),
                bytes_plane_per_arc=words_bytes(n_pairs * n_t * w + io), ops=ops, planes=len(on))


def ptxas_lines(name: str) -> list:
    """ptxas' register and spill lines for kernel ``name``'s library."""
    from repro_torch.kernels import _build

    return [ln.strip() for ln in _build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln]


def check_domain_kernels_full(device, fw) -> tuple:
    """K3, K5 and K4 at the batch path's width on the target's own
    adjacency planes and one pattern's real domain masks (from the phase-4
    fixpoint), and batched K5 also on the largest sweep of the batch
    fixpoint (its main-path shape): 0 mismatched words, timed as K1 and K2
    are, with their bounds for this data and for a full read."""
    import torch

    from repro_torch.kernels import domain_ac, popcount_reduce
    from repro_torch.kernels import ref as kref

    adj = fw["adj_flat"]
    arc_row = torch.from_numpy(fw["arc_row"]).to(device)
    masks = torch.from_numpy(fw["masks"].view("int32")).to(device)
    big = fw["largest_sweep"]
    case = dict(domain_kernel_case(adj, arc_row, masks), pattern=fw["name"])
    k5 = domain_ac.adjacency_any_pairs_cuda(adj, big["plane"], big["masks"])
    k5_plain = kref.adjacency_any_pairs_ref(adj, big["plane"], big["masks"])
    torch.cuda.synchronize()
    case.update(largest_sweep_pairs=int(big["plane"].shape[0]),
                adjacency_any_pairs_sweep_mismatches=int((k5 != k5_plain).sum()),
                adjacency_any_pairs_sweep_err=max_abs_err(k5, k5_plain))
    n_planes, n_t, w = adj.shape
    plane0 = adj[int(fw["arc_row"][0])]
    # data-dependent reads: one-arc K5 what its arc needs; K4 and batched K5
    # each named plane once, as far as the furthest-reading pair on it needs
    k5_one_need = needed_words(plane0, masks[:1])
    k5_one_words = int(k5_one_need.sum())
    k4 = pair_sweep_work(adj, arc_row, masks)
    sweep = pair_sweep_work(adj, big["plane"], big["masks"])
    hbm_ms = 1e3 / HBM_BYTES_PER_S
    timing = {
        "popcount_rows": dict(
            ms=cuda_ms(lambda: popcount_reduce.popcount_rows_cuda(plane0)),
            plain_ms=cuda_ms(lambda: kref.popcount_rows_ref(plane0)),
            bytes=words_bytes(n_t * w + n_t), bytes_full=words_bytes(n_t * w + n_t),
            ops=2 * n_t * w),
        "adjacency_any": dict(  # the main path's form: one launch per sweep
            ms=cuda_ms(lambda: domain_ac.adjacency_any_pairs_cuda(adj, big["plane"],
                                                                  big["masks"])),
            plain_ms=cuda_ms(lambda: kref.adjacency_any_pairs_ref(adj, big["plane"],
                                                                 big["masks"]), reps=5),
            pairs=int(big["plane"].shape[0]), planes=sweep["planes"],
            bytes=sweep["bytes"], bytes_full=sweep["bytes_full"], ops=sweep["ops"],
            k4_inputs_ms=cuda_ms(lambda: domain_ac.adjacency_any_pairs_cuda(adj, arc_row, masks)),
            k4_inputs_bound_ms=k4["bytes"] * hbm_ms,
            k4_inputs_bound_full_ms=k4["bytes_full"] * hbm_ms,
            one_pair_ms=cuda_ms(lambda: domain_ac.adjacency_any_cuda(plane0, masks[0])),
            one_pair_plain_ms=cuda_ms(lambda: kref.adjacency_any_ref(plane0, masks[0])),
            one_pair_bound_ms=max(words_bytes(k5_one_words + w + n_t) * hbm_ms,
                                  2 * needed_tests(plane0, k5_one_need) / LANE_OPS_PER_S * 1e3),
            one_pair_bound_full_ms=words_bytes(n_t * w + w + n_t) * hbm_ms,
            ptxas=ptxas_lines("adjacency_any")),
        "arc_any_sweep": dict(
            ms=cuda_ms(lambda: domain_ac.arc_any_sweep_cuda(adj, arc_row, masks)),
            plain_ms=cuda_ms(lambda: kref.arc_any_sweep_ref(adj, arc_row, masks)),
            bytes=k4["bytes"], bytes_full=k4["bytes_full"],
            bytes_plane_per_arc=k4["bytes_plane_per_arc"], ops=k4["ops"],
            ptxas=ptxas_lines("arc_any_sweep")),
    }
    for name, t in timing.items():
        t["bound_full_ms"] = t["bytes_full"] * hbm_ms
    timing["arc_any_sweep"]["bound_plane_per_arc_ms"] = (
        timing["arc_any_sweep"]["bytes_plane_per_arc"] * hbm_ms)
    return case, timing


# ---------------------------------------------------------------------------
# phase 5: the sparse path (K6, K7, K8)
# ---------------------------------------------------------------------------

CSR_STEP_KERNELS = ("csr_extend", "csr_extend_bucketed")


def csr_step_inputs(rng, up, b, w, mp, p_pad, device, max_real=None):
    """Inputs of the sparse step on uploaded CSR planes ``up``: each parent
    slot a real row (plane, node) of the target — in half the lanes the
    rows of neighbours of one common node, so the segments intersect — a
    third of the slots unused, every fourth lane without parents
    (``max_real`` caps the real slots per lane); random dense domains,
    sparse used-bitmaps, candidates as in :func:`kernel_inputs`."""
    import numpy as np
    import torch

    indptr = up.indptr.cpu().numpy()
    indices = up.indices.cpu().numpy()
    n_planes, n_t = indptr.shape[0], indptr.shape[1] - 1
    plane = rng.integers(0, n_planes, (b, mp))
    node = rng.integers(0, n_t, (b, mp))
    row0 = np.diff(indptr[0])
    hubs = np.nonzero(row0 > 0)[0]
    for lane in range(0, b, 2):  # neighbours of a common node x share x
        if hubs.size:
            x = int(rng.choice(hubs))
            nbrs = indices[indptr[0, x]:indptr[0, x + 1]]
            node[lane] = rng.choice(nbrs, mp)
            plane[lane] = rng.integers(0, 2, mp)  # label 0, either direction
    seg_start = indptr[plane, node].astype(np.int32)
    seg_len = (indptr[plane, node + 1] - seg_start).astype(np.int32)
    seg_len[rng.random((b, mp)) < 1 / 3] = -1
    seg_len[::4] = -1
    if max_real is not None:
        seg_len[:, max_real:] = -1

    def u32(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint32)

    cand = u32(b, w)
    one_word = np.arange(w)[None, :] == rng.integers(0, w, b)[:, None]
    cand = np.where((rng.random(b) < 0.5)[:, None], np.where(one_word, cand, 0), cand)
    cand[::4] = 0
    n_p = p_pad // 2 + 1
    host = dict(dom_bits=u32(p_pad, w) | u32(p_pad, w), seg_start=seg_start, seg_len=seg_len,
                child_pos=rng.integers(0, p_pad, b).astype(np.int32),
                depth=rng.integers(0, n_p - 1, b).astype(np.int32),
                used=u32(b, w) & u32(b, w) & u32(b, w), cand=cand)
    x = {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)).to(device)
         for k, v in host.items()}
    x["indices"] = up.indices
    return x, n_p


CSR_ARGS = ("indices", "dom_bits", "seg_start", "seg_len", "child_pos", "depth")


def csr_pivot(lens, deg_cap, pivot="shortest"):
    """Per lane the parent slot whose segment drives the walk: the shortest
    real one (the first of equals), or with ``pivot="first"`` the first
    real one (the TPU kernels' lead); and its length cut at ``deg_cap`` (0
    without a real parent)."""
    import torch

    real = lens >= 0
    if pivot == "first":
        slot = real.to(torch.int32).argmax(dim=1)
    else:
        slot = torch.where(real, lens.clamp(0, deg_cap), deg_cap + 1).argmin(dim=1)
    n = lens.clamp(0, deg_cap).gather(1, slot[:, None])[:, 0]
    return slot, torch.where(real.any(dim=1), n, 0)


def csr_search_reads(x, want, deg_cap, pivot="shortest") -> int:
    """Index reads of the binary searches the step needs for these inputs:
    for each pivot entry (:func:`csr_pivot`) of a lane in ``want`` that
    differs from the entry before it and is set in ``base``, one search per
    other real parent in slot order, up to the first parent that lacks it;
    a search counts the reads its loop makes (one per halving, one final
    compare)."""
    import torch

    idx = x["indices"].long()
    n_idx = idx.shape[0]
    cand, used = x["cand"][want].long(), x["used"][want].long()
    dom = x["dom_bits"][x["child_pos"][want].long()].long()
    starts, lens = x["seg_start"][want].long(), x["seg_len"][want].long()
    nb, w = cand.shape
    if nb == 0:
        return 0
    dev = cand.device
    ar = torch.arange(nb, device=dev)[:, None]
    real = lens >= 0
    lead, d_len = csr_pivot(lens, deg_cap, pivot)
    d_start = starts[ar[:, 0], lead]
    first = (cand != 0).to(torch.int32).argmax(dim=1)  # want: cand is not empty
    word = cand[ar[:, 0], first] & 0xFFFFFFFF
    v = first.long() * 32 + torch.log2((word & -word).double()).long()
    k = torch.arange(max(1, int(d_len.max())), device=dev)[None, :]
    pos = (d_start[:, None] + k).clamp(0, n_idx - 1)
    u = idx[pos]
    uc = u.clamp(0, w * 32 - 1)
    base = dom.gather(1, uc >> 5) & ~used.gather(1, uc >> 5)
    alive = ((k < d_len[:, None]) & ~((k > 0) & (idx[(pos - 1).clamp_min(0)] == u))
             & (((base >> (uc & 31)) & 1) != 0) & (uc != v[:, None]))
    reads = 0
    for j in range(lens.shape[1]):
        act = alive & (real[:, j] & (lead != j))[:, None]
        if not bool(act.any()):
            continue
        lo = starts[:, j, None].expand_as(u).clone()
        end = lo + lens[:, j, None].clamp(0, deg_cap)
        hi = end.clone()
        while bool((run := act & (lo < hi)).any()):
            mid = (lo + hi) >> 1
            reads += int(run.sum())
            less = idx[mid.clamp(0, n_idx - 1)] < u
            lo = torch.where(run & less, mid + 1, lo)
            hi = torch.where(run & ~less, mid, hi)
        fin = act & (lo < end)
        reads += int(fin.sum())
        alive = alive & (~act | (fin & (idx[lo.clamp(0, n_idx - 1)] == u)))
    return reads


def csr_step_bytes(x, n_p, deg_cap, pivot="shortest") -> int:
    """Bytes K6/K7 must move for these inputs: cand, the segment bounds and
    depth/position of every lane; used and the dom row (each distinct row
    once) for lanes that want a child; of the pivot row (the shortest real
    segment, which finds the same survivors as any other; ``pivot="first"``
    counts the first real one instead) the entries the walk needs (its
    length), and the reads of the searches that :func:`csr_search_reads`
    counts; cand2, child and meta written once."""
    import torch

    b, w = x["cand"].shape
    mp = x["seg_len"].shape[1]
    want = (x["cand"] != 0).any(dim=1) & (x["depth"] + 1 < n_p)
    _, lead = csr_pivot(x["seg_len"][want], deg_cap, pivot)
    n_want = int(want.sum())
    dom_rows = torch.unique(x["child_pos"][want]).numel()
    reads = words_bytes(b * w + b * (2 * mp + 2) + n_want * w + dom_rows * w
                        + int(lead.sum()) + csr_search_reads(x, want, deg_cap, pivot))
    return reads + words_bytes(2 * b * w + 4 * b)


def csr_step_case(x, n_p, deg_cap) -> dict:
    """K6 and K7 against their plain versions on one set of inputs."""
    import torch

    from repro_torch.kernels import csr_extend as ce
    from repro_torch.kernels import ref as kref

    args = [x[k] for k in CSR_ARGS] + [n_p, x["used"], x["cand"]]
    pairs = {
        "csr_extend": (ce.csr_extend_cuda(*args, deg_cap=deg_cap),
                       kref.csr_extend_ref(*args, deg_cap=deg_cap)),
        "csr_extend_bucketed": (ce.csr_extend_bucketed_cuda(*args, deg_cap=deg_cap),
                                kref.csr_extend_bucketed_ref(*args, deg_cap=deg_cap)),
    }
    torch.cuda.synchronize()
    b, w = x["cand"].shape
    case = dict(b=b, w=w, mp=x["seg_len"].shape[1], deg_cap=deg_cap,
                lanes_with_child=int(pairs["csr_extend"][0][2][:, 3].sum()))
    for name, (k, p) in pairs.items():
        case[f"{name}_mismatches"] = sum(int((a != c).sum()) for a, c in zip(k, p))
        case[f"{name}_err"] = max(max_abs_err(a, c) for a, c in zip(k, p))
    return case


def csr_sweep_check(seg_start, seg_len, indices, arc_row, masks, deg_cap) -> dict:
    """K8 against its plain version on one set of sweep inputs (device
    tensors)."""
    import torch

    from repro_torch.kernels import domain_ac
    from repro_torch.kernels import ref as kref

    args = (seg_start, seg_len, indices, arc_row, masks)
    k = domain_ac.csr_arc_sweep_cuda(*args, deg_cap=deg_cap)
    p = kref.csr_arc_sweep_ref(*args, deg_cap=deg_cap)
    torch.cuda.synchronize()
    return dict(n_planes=seg_start.shape[0], n_t=seg_start.shape[1], w=masks.shape[1],
                n_arcs=masks.shape[0], deg_cap=deg_cap, supported=int(k.sum()),
                csr_arc_sweep_mismatches=int((k != p).sum()), csr_arc_sweep_err=max_abs_err(k, p))


def csr_bounds(up):
    """``(seg_start, seg_len)`` of an uploaded CSR target's planes."""
    return up.indptr[:, :-1].contiguous(), (up.indptr[:, 1:] - up.indptr[:, :-1]).contiguous()


def csr_sweep_case(up, n_t, arc_row, masks) -> dict:
    """K8 against its plain version on one target's CSR planes."""
    return csr_sweep_check(*csr_bounds(up), up.indices, arc_row, masks, up.deg_cap)


# K8 edge cases beyond the uploaded targets': (layout, n_planes, n_t, w,
# n_arcs, deg_cap, planes of the arcs).  Layouts: "recipe" lays rows out plane
# after plane with a sentinel tail (tests/test_torch_csr.py's
# csr_sweep_inputs); "shuffled" the same rows in another order; "overlap"
# random starts, negative ones and rows past the end of indices among them.
# Rows of every layout include some longer than csr_arc_sweep.cuh's kHubLen
# (walked by the whole block), one longer than deg_cap; arcs name planes
# in range ("in"), out of range ("out": negative and >= n_planes) or all
# one plane ("one", more than 32 arcs on it); n_t is never a multiple of the
# 256-row tile.
CSR_SWEEP_EDGES = [("recipe", 2, 1000, 33, 40, 24, "in"),
                   ("shuffled", 3, 777, 40, 70, 24, "one"),
                   ("overlap", 3, 1000, 40, 70, 700, "out"),
                   ("overlap", 2, 777, 1034, 100, 2000, "in"),
                   ("recipe", 2, 300, 5, 0, 8, "in"),
                   ("shuffled", 2, 2000, 1035, 48, 3000, "one")]


def csr_sweep_edge_inputs(rng, layout, n_planes, n_t, w, n_arcs, deg_cap, arcs):
    """Numpy inputs of one :data:`CSR_SWEEP_EDGES` case: ``(seg_start,
    seg_len, indices, arc_row, masks)``, masks random (about one bit in 8
    set).  Entries are drawn from ``[-3, w · 32 + 20)`` (some negative, some
    past the domain bitmap) and the indices end in a sentinel tail
    (``CSR_SENTINEL``)."""
    import numpy as np

    lens = rng.integers(0, min(deg_cap, 40) + 1, (n_planes, n_t))
    lens[:, 3::97] = rng.integers(513, max(514, min(deg_cap, 1900)), lens[:, 3::97].shape)
    lens[0, 5] = deg_cap + 7  # longer than the walk cap
    total = int(lens.sum())
    indices = np.full(total + deg_cap + 7, 2**31 - 1, np.int32)  # CSR_SENTINEL
    indices[:total] = rng.integers(-3, w * 32 + 20, total)
    starts = np.concatenate([[0], np.cumsum(lens.ravel())[:-1]]).reshape(n_planes, n_t)
    if layout == "shuffled":
        starts = starts.ravel()[rng.permutation(starts.size)].reshape(n_planes, n_t)
        lens = lens.ravel()[rng.permutation(lens.size)].reshape(n_planes, n_t)
    elif layout == "overlap":
        starts = rng.integers(-50, indices.size + 50, (n_planes, n_t))
    if arcs == "one":
        arc_row = np.full(n_arcs, n_planes - 1)
    elif arcs == "out":
        arc_row = rng.integers(-3, n_planes + 3, n_arcs)
    else:
        arc_row = rng.integers(0, n_planes, n_arcs)
    masks = (rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32)
             & rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32)
             & rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32))
    return (starts.astype(np.int32), lens.astype(np.int32), indices, arc_row.astype(np.int32),
            masks)


def check_csr_sweep_edges(device) -> list:
    """K8 at every :data:`CSR_SWEEP_EDGES` case with random, all-zero and
    all-ones masks, and with a walk cap of 1."""
    import numpy as np
    import torch

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

    rng = np.random.default_rng(21)
    cases = []
    for edge in CSR_SWEEP_EDGES:
        seg_start, seg_len, indices, arc_row, masks = csr_sweep_edge_inputs(rng, *edge)
        args = [dev(a) for a in (seg_start, seg_len, indices, arc_row)]
        for fill in (None, 0, 0xFFFFFFFF):
            m = masks if fill is None else np.full_like(masks, fill)
            for cap in (edge[5], 1):
                cases.append(dict(csr_sweep_check(*args, dev(m), cap), layout=edge[0],
                                  arcs=edge[6], mask="random" if fill is None else hex(fill)))
    return cases


def random_csr_upload(rng, n_planes, n_t, deg_cap, device, dup=True):
    """A random well-formed CSR target (sorted rows, some empty, some at
    ``deg_cap``, some with an adjacent duplicate entry) as
    ``extend.upload_csr`` would upload it."""
    import numpy as np

    from repro_torch.core.extend import upload_csr
    from repro_torch.core.graph import CsrPlanes

    pool = min(n_t, deg_cap + 4)
    rows, lens = [], []
    for i in range(n_planes * n_t):
        length = 0 if i % 5 == 0 else (deg_cap if i % 7 == 1 else int(rng.integers(0, deg_cap + 1)))
        r = np.sort(rng.choice(pool, size=min(length, pool), replace=False))
        if dup and r.size >= 2 and i % 3 == 0:
            r[1] = r[0]
        rows.append(r)
        lens.append(r.size)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    indptr = np.stack([ptr[p * n_t: p * n_t + n_t + 1] for p in range(n_planes)]).astype(np.int32)
    planes = CsrPlanes(n_t=n_t, indptr=indptr, indices=np.concatenate(rows).astype(np.int32),
                       deg_cap=max(lens))
    return upload_csr(planes, device)


def hub_step_inputs(rng, b, w, hub_len, device):
    """Sparse-step inputs around hub rows: one plane of ``n_t = 32 · w``
    nodes whose rows 0 and 1 are hubs (``hub_len`` and ``hub_len // 2``
    sorted ids, several times the kernels' long-walk threshold) and whose
    other rows are short (0-12 ids, mostly drawn from hub 0, some with an
    adjacent duplicate).  Lanes cycle through the parent slot orders (hub,
    short), (short, hub), (hub, hub), (hub), (short, short) and (unused,
    hub); random dense domains, sparse used-bitmaps, cand as in
    :func:`csr_step_inputs`."""
    import numpy as np
    import torch

    from repro_torch.core.extend import upload_csr
    from repro_torch.core.graph import CsrPlanes

    n_t = 32 * w
    hub0 = np.sort(rng.choice(n_t, hub_len, replace=False))
    hub1 = np.sort(rng.choice(n_t, hub_len // 2, replace=False))
    rows = [hub0, hub1]
    for i in range(2, n_t):
        k = int(rng.integers(0, 13))
        r = np.sort(rng.choice(hub0 if i % 3 else n_t, size=k, replace=False))
        if r.size >= 2 and i % 5 == 0:
            r[1] = r[0]
        rows.append(r)
    lens = [r.size for r in rows]
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    up = upload_csr(CsrPlanes(n_t=n_t, indptr=ptr[None, :], indices=np.concatenate(rows)
                              .astype(np.int32), deg_cap=max(lens)), device)
    short = rng.integers(2, n_t, (b, 2))
    orders = [(0, short[:, 0]), (short[:, 0], 0), (0, 1), (0, -1), (short[:, 0], short[:, 1]),
              (-1, 0)]
    node = np.zeros((b, 2), np.int64)
    for lane in range(b):
        a, c = orders[lane % len(orders)]
        node[lane] = [a if np.isscalar(a) else a[lane], c if np.isscalar(c) else c[lane]]
    seg_start = ptr[node.clip(0)].astype(np.int32)
    seg_len = np.where(node >= 0, ptr[node.clip(0) + 1] - ptr[node.clip(0)], -1).astype(np.int32)

    def u32(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint32)

    cand = u32(b, w)
    one_word = np.arange(w)[None, :] == rng.integers(0, w, b)[:, None]
    cand = np.where((rng.random(b) < 0.5)[:, None], np.where(one_word, cand, 0), cand)
    cand[5::7] = 0
    n_p = 5
    host = dict(dom_bits=u32(8, w) | u32(8, w) | u32(8, w), seg_start=seg_start, seg_len=seg_len,
                child_pos=rng.integers(0, 8, b).astype(np.int32),
                depth=np.where(np.arange(b) % 11 == 10, n_p - 1, rng.integers(0, n_p - 1, b))
                .astype(np.int32), used=u32(b, w) & u32(b, w) & u32(b, w), cand=cand)
    x = {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)).to(device)
         for k, v in host.items()}
    x["indices"] = up.indices
    return x, n_p, up.deg_cap


def check_sparse_kernels_edges(device) -> list:
    """K6, K7 and K8 at edge shapes: w ∈ {1, 2, 3, 33, 35, 1,034, 1,035},
    mp = 0, lanes without parents, zero-length rows, rows with duplicate
    entries, a walk cap below the longest row (K8), 70,000 arcs in one
    sweep (K8); for K6/K7 also b = 1 and 7 (one lane per block), b = 4,097
    and 2,115 (8 lanes per block and a partial last block), cand and used as
    views off a 16-byte boundary, and hub rows driving or searched in either
    slot order (the block-wide walk), at 8 lanes per block with long and
    short lanes sharing full blocks and the partial last one."""
    import numpy as np
    import torch

    from repro_torch.kernels import csr_extend as ce

    rng = np.random.default_rng(13)
    cases = []
    for n_planes, n_t, w, deg_cap, b, mp in [(2, 20, 1, 8, 7, 2), (2, 30, 1, 8, 5, 0),
                                             (4, 200, 33, 16, 33, 3), (2, 1000, 33, 24, 64, 8),
                                             (2, 1500, 1034, 32, 96, 4), (2, 60, 1034, 8, 4, 0),
                                             (2, 50, 2, 8, 9, 2), (2, 90, 3, 8, 13, 3),
                                             (3, 1100, 35, 40, 70, 4), (2, 2000, 1035, 24, 96, 3),
                                             (2, 300, 33, 16, 1, 2), (2, 300, 1034, 16, 7, 3),
                                             (2, 1500, 1034, 32, 4097, 4)]:
        up = random_csr_upload(rng, n_planes, n_t, deg_cap, device)
        x, n_p = csr_step_inputs(rng, up, b, w, mp, 8, device)
        cases.append(csr_step_case(x, n_p, up.deg_cap))
        n_arcs = int(rng.integers(1, 9))
        arc_row = torch.from_numpy(rng.integers(0, n_planes, n_arcs).astype(np.int32)).to(device)
        for fill in (None, 0, 0xFFFFFFFF):
            m = (rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32) if fill is None
                 else np.full((n_arcs, w), fill, np.uint32))
            masks = torch.from_numpy(m.view(np.int32)).to(device)
            cases.append(dict(csr_sweep_case(up, n_t, arc_row, masks),
                              mask="random" if fill is None else hex(fill)))
        cut = up._replace(deg_cap=max(1, up.deg_cap // 2))  # rows longer than the walk cap
        cases.append(dict(csr_sweep_case(cut, n_t, arc_row, masks), mask="cut"))
    # cand and used one word past a 16-byte boundary (the wrapper realigns them)
    up = random_csr_upload(rng, 2, 500, 24, device)
    x, n_p = csr_step_inputs(rng, up, 40, 35, 3, 8, device)
    for k in ("cand", "used"):
        x[k] = torch.cat([x[k].new_zeros(1), x[k].flatten()])[1:].view(x[k].shape)
    cases.append(dict(csr_step_case(x, n_p, up.deg_cap), inputs="offset views"))
    # hub rows of 1,100 / 550 and 1,200 / 600 entries in either slot, at w 35
    # and 1,035 (one lane per block) and at w 35 with b = 2,115 (8 lanes per
    # block, 3 in the last one)
    for w, b, hub_len in ((35, 60, 1100), (1035, 97, 1200), (35, 2115, 1100)):
        x, n_p, cap = hub_step_inputs(rng, b, w, hub_len, device)
        cases.append(dict(csr_step_case(x, n_p, cap), inputs="hub rows",
                          lanes_per_block=ce.csr_step_layout(w, 2, b).lanes))
    # more arcs than one grid dimension's 65,535 blocks, in one launch
    up = random_csr_upload(rng, 3, 40, 8, device)
    n_arcs = 70_000
    arc_row = torch.from_numpy(rng.integers(0, 3, n_arcs).astype(np.int32)).to(device)
    m = rng.integers(0, 2**32, (n_arcs, 2), dtype=np.uint32) & rng.integers(
        0, 2**32, (n_arcs, 2), dtype=np.uint32)
    cases.append(dict(csr_sweep_case(up, 40, arc_row, torch.from_numpy(m.view(np.int32)).to(
        device)), mask="many arcs"))
    return cases + check_csr_sweep_edges(device)


def hub_target() -> tuple:
    """Target B and its pattern: ``bench_hubheavy``'s power-law target
    (:data:`HUB`) and the pattern ``extract_pattern`` grows from its
    80th-highest-degree node (6 nodes asked for)."""
    import numpy as np

    from repro_torch.data import graphgen

    hub = graphgen.power_law_graph(HUB["n"], avg_deg=HUB["avg_deg"], alpha=HUB["alpha"],
                                   n_labels=HUB["n_labels"], seed=HUB["seed"])
    hdeg = hub.out_degrees() + hub.in_degrees()
    return hub, graphgen.extract_pattern(hub, 6, seed=HUB["seed"],
                                         start=int(np.argsort(hdeg)[-80]))


def run_sparse_path(device):
    """Phase 5 on targets A and B; returns the launch counts of the runs
    that use K6, K7 and K8 and the inputs of their full-width checks."""
    import numpy as np

    from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
    from repro_torch.core import domains as dom
    from repro_torch.core import extend
    from repro_torch.core.ref import ref_enumerate
    from repro_torch.data import graphgen

    launches = {"prepare": {}, "run_bucketed": {}, "run_flat": {}, "prepare_batch": {},
                "stream": {}, "hub_bucketed": {}, "hub_flat": {}, "hub_edge_flat": {},
                "hub_edge_bucketed": {}, "hub_prepare": {}}

    # ---- target A: PDBSv1 scale ------------------------------------------
    t0 = time.perf_counter()
    insts = graphgen.make_collection(**SPARSE_COLLECTION)
    target = insts[0].target
    insts = [i for i in insts if i.target is target]
    index = SubgraphIndex.build(target, sparse=True)
    SHARED["sparse"] = dict(index=index, patterns=[i.pattern for i in insts],
                            names=[i.name for i in insts], target=target)
    planes = index.csr_planes()
    deg = np.diff(planes.indptr, axis=1)
    emit(dict(phase="sparse_setup", target="A", n_t=target.n, arcs=target.m,
              labels=target.n_node_labels, w=index.w, nnz=planes.nnz,
              max_degree=int(deg.max()), deg_cap_padded=extend._pad_deg_cap(planes.deg_cap),
              patterns=[i.pattern.n for i in insts], setup_s=time.perf_counter() - t0))

    def session(idx, variant, **kw):
        return Enumerator(idx, config=EngineConfig(**ENGINE_KW, **kw), variant=variant,
                          device=device)

    paths = {
        "bucketed": session(index, SPARSE_VARIANT, step_backend="auto", use_pallas=True),
        "flat": session(index, SPARSE_VARIANT, step_backend="auto", use_pallas=True,
                        csr_walk="flat"),
        "plain": session(index, SPARSE_VARIANT, step_backend="auto"),
    }
    queries, results = {}, {}
    for label, enum in paths.items():
        qs, counts = _launched(lambda: [enum.prepare(i.pattern, name=i.name) for i in insts])
        if label == "bucketed":
            launches["prepare"] = counts
            if not (counts["csr_arc_sweep"] and counts["popcount_rows"]):
                raise AssertionError(f"the sparse prepare launched {counts}")
        for q in qs:
            if extend.resolve_step_backend_for_plan(enum.config, q.plan) != "csr":
                raise AssertionError(f"{q.name}: step_backend='auto' did not resolve to csr")
            enum.run(q)  # warm-up: first use of each op on the card
        queries[label] = qs
        results[label], counts = _launched(lambda: [enum.run(q) for q in qs])
        if label != "plain":
            launches[f"run_{label}"] = counts
        deepest = max(range(len(qs)), key=lambda k: results[label][k].states)
        emit(dict(phase="sparse_path", target="A", path=label, launches=counts,
                  profile=profile_query(enum, qs[deepest]),
                  queries=[dict(name=ms.name, n_p=ms.plan.n_p, matches=ms.matches,
                                states=ms.states, steps=ms.steps, prepare_s=q.prepare_s,
                                match_s=ms.match_s, states_per_s=ms.states / ms.match_s)
                           for q, ms in zip(qs, results[label])]))
    if not launches["run_bucketed"]["csr_extend_bucketed"]:
        raise AssertionError("the bucketed run never launched csr_extend_bucketed")
    if not launches["run_flat"]["csr_extend"]:
        raise AssertionError("the flat run never launched csr_extend")

    dense_index = SubgraphIndex.build(target)
    dense = session(dense_index, SPARSE_VARIANT, step_backend="pallas")
    dqs = [dense.prepare(i.pattern, name=i.name) for i in insts]
    for q in dqs:
        dense.run(q)
    dres, dcounts = _launched(lambda: [dense.run(q) for q in dqs])
    if not dcounts["extend_step"]:
        raise AssertionError("the dense run never launched extend_step")
    emit(dict(phase="sparse_path", target="A", path="dense K1",
              adjacency_bytes=int(dense_index.packed.adj_bits.nbytes), launches=dcounts,
              queries=[dict(name=ms.name, matches=ms.matches, states=ms.states,
                            match_s=ms.match_s, prepare_s=q.prepare_s)
                       for q, ms in zip(dqs, dres)]))
    for k, dq in enumerate(dqs):
        for label in paths:
            q = queries[label][k]
            if not np.array_equal(q.plan.dom_bits, dq.plan.dom_bits) \
                    or q.plan.satisfiable != dq.plan.satisfiable:
                raise AssertionError(f"{label} {q.name}: CSR domains != numpy")
    want = [_counters(ms) for ms in dres]
    for label, res in results.items():
        if [_counters(ms) for ms in res] != want:
            raise AssertionError(f"sparse path {label} disagrees with the dense K1 run")
    oracle = []
    for inst, ms in zip(insts, results["bucketed"]):
        ref = ref_enumerate(inst.pattern, target, plan=ms.plan)
        oracle.append(dict(name=ms.name, matches=ref.matches, states=ref.states))
        if (ref.matches, ref.states) != (ms.matches, ms.states):
            raise AssertionError(f"{ms.name}: engine {(ms.matches, ms.states)} != "
                                 f"ref_enumerate {(ref.matches, ref.states)}")
    emit(dict(phase="sparse_oracle", target="A", agree=True, queries=oracle))

    # ---- target A: the batch half ----------------------------------------
    binsts = [i for i in graphgen.make_collection(**SPARSE_BATCH_COLLECTION)
              if i.target.n == target.n][:SPARSE_BATCH]
    if any(not np.array_equal(i.target.src, target.src) for i in binsts):
        raise AssertionError("the batch draw's target differs from target A")
    pats, names = [i.pattern for i in binsts], [i.name for i in binsts]
    kern = paths["bucketed"]
    (bqs, counts) = _launched(lambda: kern.prepare_batch(pats, names=names))
    launches["prepare_batch"] = counts
    if not counts["csr_arc_sweep"]:
        raise AssertionError(f"the sparse prepare_batch launched {counts}")
    host = dense.prepare_batch(pats, names=names, backend="numpy")
    for a, h in zip(bqs, host):
        if not (extend.is_csr_only(a.plan) and a.satisfiable == h.satisfiable
                and np.array_equal(a.plan.dom_bits, h.plan.dom_bits)
                and np.array_equal(a.plan.order, h.plan.order)):
            raise AssertionError(f"{a.name}: the K8 batch fixpoint != numpy")
    singles = [kern.run(q) for q in bqs]
    packed, counts = _launched(lambda: list(kern.stream(bqs, pack_size=PACK_SIZE)))
    launches["stream"] = counts
    if not counts["csr_extend_bucketed"]:
        raise AssertionError("the sparse packs never launched csr_extend_bucketed")
    by_index = {ms.query_index: ms for ms in packed}
    for i, one in enumerate(singles):
        if _counters(by_index[i]) != _counters(one):
            raise AssertionError(f"sparse pack lane {one.name} != its single run")
    packs = []
    for ms in packed:
        if packs and packs[-1]["match_s"] == ms.match_s:
            packs[-1]["queries"].append(ms.name)
        else:
            packs.append(dict(match_s=ms.match_s, queries=[ms.name]))
    emit(dict(phase="sparse_batch", target="A", patterns=len(pats),
              prepare_batch_launches=launches["prepare_batch"], stream_launches=counts,
              prepare_s=[dict(name=q.name, device_s=q.prepare_s, numpy_s=h.prepare_s)
                         for q, h in zip(bqs, host)],
              packs=packs,
              queries=[dict(name=one.name, matches=one.matches, states=one.states,
                            single_match_s=one.match_s) for one in singles]))

    # the full-width K8 check: the deepest acfc pattern's arcs and domains
    i = max(range(len(bqs)), key=lambda k: dom.domain_bucket(pats[k])[1])
    arc_row, masks = sweep_arcs(pats[i], host[i].plan.domains.bits, index.n_edge_labels)
    sweep = dict(name=names[i], upload=kern._csr_upload(index.fingerprint, index.csr_planes),
                 n_t=target.n, arc_row=arc_row, masks=masks)

    # ---- target B: hub-heavy ---------------------------------------------
    t0 = time.perf_counter()
    hub, hpat = hub_target()
    hindex = SubgraphIndex.build(hub, sparse=True)
    SHARED["hub"] = dict(index=hindex, pattern=hpat)
    hplanes = hindex.csr_planes()
    hrow = np.diff(hplanes.indptr, axis=1)
    emit(dict(phase="sparse_setup", target="B", n_t=hub.n, arcs=hub.m, w=hindex.w,
              nnz=hplanes.nnz, max_degree=int(hrow.max()), median_degree=float(np.median(hrow)),
              p99_degree=float(np.percentile(hrow, 99)),
              deg_cap_padded=extend._pad_deg_cap(hplanes.deg_cap),
              pattern_nodes=hpat.n, pattern_edges=hpat.m, setup_s=time.perf_counter() - t0))
    hres = {}
    for label, walk in (("hub_flat", "flat"), ("hub_bucketed", "bucketed")):
        enum = session(hindex, HUB_VARIANT, step_backend="csr", use_pallas=True, csr_walk=walk)
        q = enum.prepare(hpat, name=f"hub/{walk}")
        enum.run(q)  # warm-up
        ms, counts = _launched(lambda: enum.run(q))
        launches[label] = counts
        hres[label] = ms
        emit(dict(phase="sparse_path", target="B", path=walk, launches=counts,
                  matches=ms.matches, states=ms.states, steps=ms.steps, match_s=ms.match_s,
                  states_per_s=ms.states / ms.match_s, profile=profile_query(enum, q)))
    if not (launches["hub_flat"]["csr_extend"]
            and launches["hub_bucketed"]["csr_extend_bucketed"]):
        raise AssertionError(f"target B launches: {launches['hub_flat']}, "
                             f"{launches['hub_bucketed']}")
    if _counters(hres["hub_flat"]) != _counters(hres["hub_bucketed"]):
        raise AssertionError("target B: the flat and bucketed walks disagree")
    ref = ref_enumerate(hpat, hub, plan=hres["hub_flat"].plan)
    if (ref.matches, ref.states) != (hres["hub_flat"].matches, hres["hub_flat"].states):
        raise AssertionError(f"target B: engine != ref_enumerate {(ref.matches, ref.states)}")
    emit(dict(phase="sparse_oracle", target="B", agree=True, matches=ref.matches,
              states=ref.states,
              flat_over_bucketed=hres["hub_flat"].match_s / hres["hub_bucketed"].match_s))

    # target B under edge seeding: the same query's rarest edge class as
    # depth-1 root entries, through K6 and K7
    eres = {}
    for label, walk in (("hub_edge_flat", "flat"), ("hub_edge_bucketed", "bucketed")):
        enum = session(hindex, HUB_VARIANT, step_backend="csr", use_pallas=True, csr_walk=walk,
                       root_seeding="edge")
        q = enum.prepare(hpat, name=f"hub-edge/{walk}", seed_edge="auto")
        enum.run(q)  # warm-up
        ms, counts = _launched(lambda: enum.run(q))
        launches[label] = counts
        eres[label] = ms
        emit(dict(phase="sparse_path", target="B", path=f"edge {walk}", launches=counts,
                  frontier=root_frontier(hres[f"hub_{walk}"].plan, q.plan, enum.config),
                  matches=ms.matches, states=ms.states, steps=ms.steps, steals=ms.steals,
                  steal_rounds=ms.steal_rounds, match_s=ms.match_s,
                  vertex_match_s=hres[f"hub_{walk}"].match_s,
                  states_per_s=ms.states / ms.match_s, profile=profile_query(enum, q)))
    if not (launches["hub_edge_flat"]["csr_extend"]
            and launches["hub_edge_bucketed"]["csr_extend_bucketed"]):
        raise AssertionError(f"target B edge-seeded launches: {launches['hub_edge_flat']}, "
                             f"{launches['hub_edge_bucketed']}")
    if _counters(eres["hub_edge_flat"]) != _counters(eres["hub_edge_bucketed"]):
        raise AssertionError("target B: the edge-seeded flat and bucketed walks disagree")
    if eres["hub_edge_flat"].matches != ref.matches:
        raise AssertionError(f"target B: edge-seeded matches {eres['hub_edge_flat'].matches} "
                             f"!= vertex-seeded and ref_enumerate's {ref.matches}")

    # target B's CSR fixpoint under ri-ds-si-acfc: through K8 and plain
    preps = {}
    for label, kw in (("kernels", dict(use_pallas=True)), ("plain", {})):
        enum = session(hindex, SPARSE_VARIANT, step_backend="csr", **kw)
        preps[label], counts = _launched(lambda: enum.prepare(hpat, name="hub/acfc"))
        if label == "kernels":
            launches["hub_prepare"] = counts
    if not launches["hub_prepare"]["csr_arc_sweep"]:
        raise AssertionError(f"target B's acfc prepare launched {launches['hub_prepare']}")
    got, want = preps["kernels"], preps["plain"]
    if got.plan.satisfiable != want.plan.satisfiable \
            or not np.array_equal(got.plan.dom_bits, want.plan.dom_bits):
        raise AssertionError("target B: the K8 fixpoint's domains != the plain fixpoint's")
    emit(dict(phase="sparse_prepare", target="B", variant=SPARSE_VARIANT,
              launches=launches["hub_prepare"], satisfiable=bool(got.plan.satisfiable),
              prepare_s=got.prepare_s, plain_prepare_s=want.prepare_s,
              domain_sizes=[int(np.unpackbits(r.view(np.uint8)).sum())
                            for r in want.plan.domains.bits]))
    hub_row, hub_final = sweep_arcs(hpat, want.plan.domains.bits, hindex.n_edge_labels)
    _, hub_initial = sweep_arcs(hpat, dom.initial_domains_sparse(hpat, hub, hindex.w),
                                hindex.n_edge_labels)
    return launches, dict(
        A=kern._csr_upload(index.fingerprint, index.csr_planes), A_w=index.w,
        B=extend.upload_csr(hplanes, device), B_w=hindex.w, sweep=sweep,
        hub_sweeps=dict(arc_row=hub_row, final=hub_final, initial=hub_initial,
                        zero=np.zeros_like(hub_final)))


def sweep_arcs(pattern, bits, n_elab) -> tuple:
    """One sweep's K8 inputs for ``pattern``: each arc's plane
    (``domains._device_fixpoint``'s ``arc_row``) and the domain ``bits`` of
    its other end as its mask, numpy ``(arc_row [n_arcs], masks [n_arcs,
    w])``."""
    import numpy as np

    from repro_torch.core import domains as dom

    arrs = dom.pattern_domain_arrays(pattern)
    n_arcs = int(arrs.arc_valid.sum())
    arc_row = (np.clip(arrs.arc_lab, 0, n_elab - 1) * 2 + arrs.arc_dir)[:n_arcs]
    return arc_row.astype(np.int32), np.ascontiguousarray(bits[arrs.arc_q[:n_arcs]])


def needed_entries(up, arc_row, masks) -> tuple:
    """The CSR entries K8 must read for this data, per arc and row up to and
    including the first entry whose bit is set in the arc's mask, else
    ``min(len, deg_cap)``: ``(read_once, per_arc)``, where ``read_once``
    takes, per named plane and row, the most any arc on that plane reads,
    and ``per_arc`` sums over every arc."""
    import torch

    indices = up.indices
    n_idx = indices.shape[0]
    w = masks.shape[1]
    ok = (indices >= 0) & (indices < w * 32)
    u = indices.clamp(0, w * 32 - 1)
    per_arc, furthest = 0, {}
    for a in range(masks.shape[0]):
        r = int(arc_row[a])
        lo = up.indptr[r, :-1].long()
        hi = torch.minimum(lo + (up.indptr[r, 1:] - up.indptr[r, :-1]).clamp(
            max=up.deg_cap).long(), torch.full_like(lo, n_idx))
        hits = ok & (((masks[a][(u // 32).long()] >> (u % 32)) & 1) != 0)
        c = torch.zeros(n_idx + 1, dtype=torch.int64, device=indices.device)
        c[1:] = torch.cumsum(hits, dim=0)
        first = torch.searchsorted(c, c[lo] + 1)  # c[first] == c[lo] + 1: one past the hit
        n = torch.where(c[hi] > c[lo], first - lo, hi - lo)
        per_arc += int(n.sum())
        furthest[r] = n if r not in furthest else torch.maximum(furthest[r], n)
    return sum(int(n.sum()) for n in furthest.values()), per_arc


def csr_sweep_bytes(up, arc_row, masks) -> dict:
    """What K8 must move on one target's CSR planes for these arcs: each
    named plane's bounds and the entries the furthest-reading arc on it
    needs, read once, the masks and ``arc_row``, the flags (``bytes``); the
    same with every arc re-reading its plane (``bytes_plane_per_arc``); and,
    beside them, the mask table's bytes, written once and read once
    (``table_bytes``)."""
    import torch

    n_arcs, w = masks.shape
    n_t = up.indptr.shape[1] - 1
    once, per_arc = needed_entries(up, arc_row, masks)
    planes = len(set(arc_row.tolist()))
    arcs_bytes = words_bytes(n_arcs * (w + 1) + n_arcs * n_t)  # masks, arc_row, flags
    n_planes = up.indptr.shape[0]
    keys = arc_row.clamp(-1, n_planes).masked_fill(arc_row < 0, n_planes).long()
    groups = sum(int(((torch.bincount(keys[c:c + 64]) + 31) // 32).sum())  # per 64-arc chunk,
                 for c in range(0, n_arcs, 64))  # as csr_arc_sweep.cuh groups them
    return dict(bytes=words_bytes(planes * 2 * n_t + once) + arcs_bytes,
                bytes_plane_per_arc=words_bytes(n_arcs * 2 * n_t + per_arc) + arcs_bytes,
                table_bytes=2 * words_bytes(groups * 32 * w), ops=2 * per_arc,
                entries_read_once=once, entries_per_arc=per_arc, planes=planes, arcs=n_arcs)


def csr_sweep_timing(up, arc_row, masks, plain=False) -> dict:
    """K8 on one target's CSR planes, timed with a warm and a flushed L2
    (the plain version too if ``plain``), beside :func:`csr_sweep_bytes`."""
    from repro_torch.kernels import domain_ac
    from repro_torch.kernels import ref as kref

    args = (*csr_bounds(up), up.indices, arc_row, masks)

    def k8():
        return domain_ac.csr_arc_sweep_cuda(*args, deg_cap=up.deg_cap)

    t = dict(ms=cuda_ms(k8), cold_ms=cuda_ms_cold(k8), **csr_sweep_bytes(up, arc_row, masks))
    # the device kernels of 20 calls as the profiler traces them: launches and
    # mean device time of each
    prof = profile_call(lambda: [k8() for _ in range(20)])
    t["kernel_trace"] = {re.search(r"csr_sweep::(\w+)", e["name"]).group(1):
                         dict(launches=e["count"], mean_us=e["device_us"] / e["count"])
                         for e in prof.get("top", []) if "csr_sweep::" in e["name"]}
    if plain:
        t["plain_ms"] = cuda_ms(lambda: kref.csr_arc_sweep_ref(*args, deg_cap=up.deg_cap),
                                reps=10)
        t["bound_plane_per_arc_ms"] = t["bytes_plane_per_arc"] / HBM_BYTES_PER_S * 1e3
        t["ptxas"] = ptxas_lines("csr_arc_sweep")
    return t


def check_sparse_kernels_full(device, fw) -> tuple:
    """K6 and K7 at b = 4,096, w = 1,034 on target A's and (b = 512, two
    real parents) target B's CSR planes; K8 on target A's planes with one
    pattern's real domain masks (from the phase-5 fixpoint) and on target
    B's with the hub pattern's arcs (its final and its initial domains, and
    all-zero masks).  0 mismatched words required; timed as the other
    kernels are."""
    import numpy as np
    import torch

    from repro_torch.kernels import csr_extend as ce
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(14)
    cases, timing = [], {}
    xa, n_p = csr_step_inputs(rng, fw["A"], 4096, fw["A_w"], MAIN_MP, MAIN_P_PAD, device)
    cases.append(dict(csr_step_case(xa, n_p, fw["A"].deg_cap), target="A"))
    xb, n_pb = csr_step_inputs(rng, fw["B"], 512, fw["B_w"], MAIN_MP, MAIN_P_PAD, device,
                               max_real=2)
    cases.append(dict(csr_step_case(xb, n_pb, fw["B"].deg_cap), target="B"))
    args = [xa[k] for k in CSR_ARGS] + [n_p, xa["used"], xa["cand"]]
    cap = fw["A"].deg_cap
    step_bytes = csr_step_bytes(xa, n_p, cap)
    first_bytes = csr_step_bytes(xa, n_p, cap, pivot="first")
    b, w = xa["cand"].shape
    for name, kern, plain in (
            ("csr_extend", ce.csr_extend_cuda, kref.csr_extend_ref),
            ("csr_extend_bucketed", ce.csr_extend_bucketed_cuda, kref.csr_extend_bucketed_ref)):
        timing[name] = dict(ms=cuda_ms(lambda: kern(*args, deg_cap=cap)),
                            plain_ms=cuda_ms(lambda: plain(*args, deg_cap=cap), reps=10),
                            bytes=step_bytes, bytes_first_parent=first_bytes, ops=3 * b * w)
    bargs = [xb[k] for k in CSR_ARGS] + [n_pb, xb["used"], xb["cand"]]
    for name, kern in (("csr_extend", ce.csr_extend_cuda),
                       ("csr_extend_bucketed", ce.csr_extend_bucketed_cuda)):
        timing[name]["target_b_ms"] = cuda_ms(lambda: kern(*bargs, deg_cap=fw["B"].deg_cap),
                                              reps=10)
        timing[name]["target_b_bytes"] = csr_step_bytes(xb, n_pb, fw["B"].deg_cap)
        timing[name]["target_b_bound_ms"] = (timing[name]["target_b_bytes"] / HBM_BYTES_PER_S
                                             * 1e3)
        timing[name]["target_b_bytes_first_parent"] = csr_step_bytes(
            xb, n_pb, fw["B"].deg_cap, pivot="first")

    sw = fw["sweep"]
    arc_row = torch.from_numpy(sw["arc_row"]).to(device)
    masks = torch.from_numpy(sw["masks"].view(np.int32)).to(device)
    cases.append(dict(csr_sweep_case(sw["upload"], sw["n_t"], arc_row, masks), target="A",
                      pattern=sw["name"]))
    timing["csr_arc_sweep"] = csr_sweep_timing(sw["upload"], arc_row, masks, plain=True)
    # target B: the hub pattern's arcs with its final acfc domains, its
    # initial label + degree domains, and no domain bit at all
    hs = fw["hub_sweeps"]
    hub_row = torch.from_numpy(hs["arc_row"]).to(device)
    for name in ("final", "initial", "zero"):
        hub_masks = torch.from_numpy(hs[name].view(np.int32)).to(device)
        cases.append(dict(csr_sweep_case(fw["B"], fw["B"].indptr.shape[1] - 1, hub_row,
                                         hub_masks), target="B", masks=name))
        tb = csr_sweep_timing(fw["B"], hub_row, hub_masks)
        tb["bound_ms"] = tb["bytes"] / HBM_BYTES_PER_S * 1e3
        timing["csr_arc_sweep"][f"target_b_{name}"] = tb
    return cases, timing


# ---------------------------------------------------------------------------
# phase 6: the LM serving path
# ---------------------------------------------------------------------------

def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the card's
    busy share of it, its kernel launches and the kernels that took the
    most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return dict(device_time="not measured (no device events traced)")
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return dict(profiled_wall_s=wall, device_busy_s=busy_us / 1e6,
                device_busy_share=busy_us / 1e6 / wall,
                kernel_launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:80], count=e.count, device_us=e.self_device_time_total,
                          share=e.self_device_time_total / busy_us) for e in top])


def k9_case(got, q, k, v, tol: float, chunk: int = 0) -> dict:
    """K9's output ``got`` against the plain version on the same inputs,
    ``chunk`` rows of the batch·head axis at a time (all at once if 0): an
    element is off when ``|got - plain| > tol + tol · |plain|``."""
    from repro_torch.kernels import ref as kref

    chunk = chunk or q.shape[0]
    bad, err, worst, num, den = 0, 0.0, 0.0, 0.0, 0.0
    for i in range(0, q.shape[0], chunk):
        p = kref.flash_attention_ref(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk]).float()
        g = got[i:i + chunk].float()
        d = (g - p).abs()
        lim = tol + tol * p.abs()
        bad += int((d > lim).sum())
        err = max(err, float(d.max()))
        worst = max(worst, float((d / lim).max()))
        num += float(((g - p) ** 2).sum())
        den += float((p ** 2).sum())
    return dict(flash_attention_mismatches=bad, flash_attention_err=err, worst_over_tol=worst,
                rel_l2=(num / den) ** 0.5 if den else 0.0, tol=tol)


def check_flash_edges(device) -> list:
    """K9 against its plain version at ragged and edge shapes, fp32 (tol
    1e-5: both sum in fp32, in other orders) and bf16 (tol 2e-2: both round
    one fp32 result to bf16, which may land a unit in the last place apart)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(16)
    cases = []
    for bh, s, s_kv, d, kind in K9_EDGES + K9_TC_EDGES:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.from_numpy(rng.normal(size=(bh, n, d)).astype(np.float32))
                       .to(device=device, dtype=dtype) for n in (s, s_kv, s_kv))
            if kind == "equal":  # every score 0: uniform weights over each causal prefix
                q = torch.zeros_like(q)
            got = fa.flash_attention_cuda(q, k, v)
            torch.cuda.synchronize()
            cases.append(dict(k9_case(got, q, k, v, tol), bh=bh, s=s, s_kv=s_kv, d=d,
                              dtype=str(dtype), kind=kind))
    return cases


def k9_timing(q, k, v) -> dict:
    """K9, its plain version and ``scaled_dot_product_attention`` (the
    yardstick, never called by the port) on one layer's q/k/v, with the
    work counted for the bound: QKᵀ and PV over the causal triangle.  K9 is
    timed on its bf16 route (``ms``, the served dtype) and on its fp32 route
    (``fp32_ms``, the same values in fp32), each beside its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as kref

    bh, s, d = q.shape
    s_kv = k.shape[1]
    pairs = sum(min(i + 1, s_kv) for i in range(s))  # (query, key) pairs with key <= query
    ops = 4 * bh * d * pairs
    rate = TENSOR_BF16_PER_S if q.dtype == torch.bfloat16 else LANE_OPS_PER_S
    q32, k32, v32 = q.float(), k.float(), v.float()
    fp32_ms = cuda_ms(lambda: fa.flash_attention_cuda(q32, k32, v32), reps=5, warmup=1)
    del q32, k32, v32
    return dict(ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=10),
                plain_ms=cuda_ms(lambda: kref.flash_attention_ref(q, k, v), reps=3, warmup=1),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True)),
                bytes=q.element_size() * (2 * q.numel() + 2 * k.numel()),
                ops=ops, ops_per_s=rate, ops_bound_ms=ops / rate * 1e3,
                fp32_ms=fp32_ms, fp32_bound_ms=ops / LANE_OPS_PER_S * 1e3,
                shape=[bh, s, s_kv, d], dtype=str(q.dtype))


def _depth(params, cfg, n: int):
    """The first ``n`` layers of a model (views of its parameters)."""
    import dataclasses

    return (dict(params, layers={k: w[:n] for k, w in params["layers"].items()}),
            dataclasses.replace(cfg, n_layers=n))


def decode_vs_prefill(params, cfg, toks, n: int, tol: float, gate="elementwise") -> dict:
    """The logits after ``n + 1`` tokens, from a prefill of all of them and
    from a prefill of ``n`` then one decode step (``tests/test_models_lm.py``'s
    gate).  ``gate``: ``"elementwise"`` — no element with ``|step - full| >
    tol + tol · |full|``, as that test asserts; ``"rel_l2"`` — ``‖step -
    full‖₂ <= tol · ‖full‖₂``; ``None`` — measured only."""
    from repro_torch.models import transformer as tf

    full, _ = tf.prefill(params, cfg, toks[:, :n + 1], max_len=n + 1)
    _, cache = tf.prefill(params, cfg, toks[:, :n], max_len=n + 1)
    step, _ = tf.decode_step(params, cfg, cache, toks[:, n:n + 1], n)
    d = (step - full).abs()
    res = dict(layers=cfg.n_layers, dtype=str(cfg.dtype), batch=int(toks.shape[0]), prompt=n,
               gate=gate, tol=tol, mismatches=int((d > tol + tol * full.abs()).sum()),
               max_abs_err=float(d.max()), logits_abs_max=float(full.abs().max()),
               rel_l2=float((step - full).norm() / full.norm()),
               argmax_equal=bool((step.argmax(-1) == full.argmax(-1)).all()),
               finite=bool(full.isfinite().all() and step.isfinite().all()))
    res["ok"] = res["finite"] and (gate is None or (
        res["mismatches"] == 0 if gate == "elementwise" else res["rel_l2"] <= tol))
    return res


def decode_vs_prefill_per_layer(params, cfg, toks, n: int, tol: float) -> dict:
    """:func:`decode_vs_prefill` one layer at a time, each from the same input:
    layer ``l`` takes the hidden states the full prefill gives it and runs
    once over all ``n + 1`` positions (K9) and once as a prefill of ``n``
    then a decode step over the cache it wrote.  Position ``n``'s outputs
    and the caches must agree to ``tol`` of the layer's largest output, so
    a difference cannot grow through later layers as it does end to end."""
    import torch

    from repro_torch.models import transformer as tf

    h = tf._embed(params, cfg, toks[:, :n + 1])
    b = h.shape[0]
    pos = torch.arange(n + 1, device=h.device).expand(b, n + 1)

    def zero_cache():
        shape = (b, n + 1, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=h.device),
                torch.zeros(shape, dtype=cfg.dtype, device=h.device))

    out_err, cache_err = [], []
    for i in range(cfg.n_layers):
        lp = tf.layer_params(params, i)
        full, _, full_cache = tf._layer(cfg, h, lp, pos, zero_cache(), 0)
        inc_cache = zero_cache()
        tf._layer(cfg, h[:, :n], lp, pos[:, :n], inc_cache, 0)
        step, _, _ = tf._layer(cfg, h[:, n:], lp, pos[:, n:], inc_cache, n)
        scale = float(full[:, n].abs().max())
        out_err.append(float((step[:, 0] - full[:, n]).abs().max()) / scale)
        cache_err.append(max(float((a.float() - c.float()).abs().max() / c.float().abs().max())
                             for a, c in zip(inc_cache, full_cache)))
        h = full
    return dict(layers=cfg.n_layers, dtype=str(cfg.dtype), batch=b, prompt=n,
                gate="per_layer", tol=tol, ok=max(out_err + cache_err) <= tol,
                max_out_err_over_scale=max(out_err), max_cache_err_over_scale=max(cache_err),
                out_err_over_scale=out_err)


def serve_lm(params, cfg, toks, n_dec: int, device) -> dict:
    """Serve ``toks`` [B, S]: a warm-up prefill and decode step, then a
    prefill timed with the kernel launch counts set to 0 just before and
    read just after, a second prefill that must give bit-identical logits
    and cache, ``n_dec`` greedy decode steps (timed, counted) and one
    ``torch.profiler`` breakdown each of a prefill and a decode step.
    Gates: finite fp32 logits of shape [B, V]; K9 once per layer in the
    prefill and no other kernel, none in a decode step; peak memory (since
    the caller's ``reset_peak_memory_stats``) under the card's.  Returns the
    measurements."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    b, s = toks.shape
    max_len = s + n_dec
    logits, cache = tf.prefill(params, cfg, toks, max_len=max_len)
    tf.decode_step(params, cfg, cache, logits.argmax(-1)[:, None], s)
    del logits, cache

    torch.cuda.synchronize(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, cfg, toks, max_len=max_len)
    torch.cuda.synchronize(device)
    prefill_s = time.perf_counter() - t0
    prefill_counts = ops.launch_counts()
    again, cache2 = tf.prefill(params, cfg, toks, max_len=max_len)
    identical = bool(torch.equal(logits, again)) and all(
        torch.equal(x, y) for x, y in zip(cache, cache2))
    del again, cache2
    ops.reset_launch_counts()
    ids = [logits.argmax(-1)]
    step_ms = []
    finite = bool(logits.isfinite().all())
    for i in range(n_dec):
        t0 = time.perf_counter()
        logits, cache = tf.decode_step(params, cfg, cache, ids[-1][:, None], s + i)
        ids.append(logits.argmax(-1))
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(logits.isfinite().all())
    decode_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    total = torch.cuda.get_device_properties(device).total_memory
    if tuple(logits.shape) != (b, cfg.vocab_size) or logits.dtype != torch.float32 or not finite:
        raise AssertionError(f"{cfg.name} logits: {tuple(logits.shape)} {logits.dtype} "
                             f"finite={finite}")
    want_prefill = dict.fromkeys(prefill_counts, 0)
    want_prefill["flash_attention"] = cfg.n_layers
    if prefill_counts != want_prefill or any(decode_counts.values()):
        raise AssertionError(f"{cfg.name} launches: prefill {prefill_counts}, "
                             f"{n_dec} decode steps {decode_counts}")
    if not identical:
        raise AssertionError(f"{cfg.name}: a repeated prefill gave other logits or cache")
    if peak >= total:
        raise AssertionError(f"{cfg.name}: peak {peak} bytes >= the card's {total}")
    return dict(prefill_s=prefill_s, prefill_tokens_per_s=b * s / prefill_s,
                decode_ms_per_step=step_ms, decode_ms_median=statistics.median(step_ms),
                decode_tokens_per_s=b * 1e3 / statistics.median(step_ms),
                generated=torch.stack(ids, dim=1).tolist(), peak_memory_gb=peak / 1e9,
                card_memory_gb=total / 1e9, repeat_prefill_identical=identical,
                prefill_launches=prefill_counts, decode_launches=decode_counts,
                prefill_profile=profile_call(lambda: tf.prefill(params, cfg, toks,
                                                                max_len=max_len)),
                decode_profile=profile_call(lambda: tf.decode_step(
                    params, cfg, cache, ids[-1][:, None], max_len - 1)))


def run_lm_path(device):
    """Phase 6: minitron-8b at full width and depth serves ``LM_BATCH``
    requests (prefill of ``LM_PROMPT`` tokens, ``LM_DECODE_STEPS`` greedy
    decode steps) with K9 in every prefill layer; then the checks.  Returns
    the serving run's launch counts, the K9 timing and the check cases."""
    import dataclasses

    import torch

    from repro_torch.configs import minitron_8b
    from repro_torch.data import graphgen
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    cfg = LM_CFG or minitron_8b.CFG
    b, s, n_dec = LM_BATCH, LM_PROMPT, LM_DECODE_STEPS
    max_len = s + n_dec
    reduced = [
        f"prefill batch {minitron_8b.PREFILL_SHAPE['batch']} -> {b}, "
        f"seq {minitron_8b.PREFILL_SHAPE['seq']} -> {s} (PREFILL_SHAPE)",
        f"decode batch {minitron_8b.DECODE_SHAPE['batch']} -> {b}, "
        f"cache {minitron_8b.DECODE_SHAPE['seq']} -> {max_len} (DECODE_SHAPE: "
        f"{minitron_8b.DECODE_SHAPE['batch']} x {minitron_8b.DECODE_SHAPE['seq']} positions of "
        f"cache need a sharded pod)",
        "random weights (seed 0), random prompts (lm_batch seed 7)"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=LM_SEED, device=device)
    torch.cuda.synchronize(device)
    emit(dict(phase="lm_setup", model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
              n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
              vocab=cfg.vocab_size, dtype=str(cfg.dtype), params=cfg.param_count(),
              weights_gb=sum(w.numel() * w.element_size() for w in
                             [params["embed"], params["final_norm"], params["lm_head"],
                              *params["layers"].values()]) / 1e9,
              init_s=time.perf_counter() - t0, batch=b, prompt=s, decode_steps=n_dec,
              max_len=max_len, reduced=reduced))
    toks = torch.from_numpy(graphgen.lm_batch(b, s, cfg.vocab_size, seed=LM_TOKEN_SEED)
                            ["tokens"]).to(device)

    served = serve_lm(params, cfg, toks, n_dec, device)
    emit(dict(phase="lm_path", **served))
    prefill_counts, decode_counts = served["prefill_launches"], served["decode_launches"]

    # K9 against its plain version on every layer's own q/k/v (a prefill of
    # the same requests with each K9 call checked), then timed on layer 0's
    per_layer, first = [], {}
    flash = ops.flash_attention

    def checked(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        per_layer.append(k9_case(out, q, k, v, 2e-2, chunk=LM_HEAD_CHUNK))
        first.setdefault("qkv", (q, k, v))
        return out

    ops.flash_attention = checked
    try:
        tf.prefill(params, cfg, toks, max_len=max_len)
    finally:
        ops.flash_attention = flash
    timing = k9_timing(*first.pop("qkv"))
    cases = [dict(c, layer=i, kind="lm_layer") for i, c in enumerate(per_layer)]
    cases += check_flash_edges(device)

    # decode against prefill, bf16 on the 4 requests and fp32 on the first
    # (the bf16 weights freed first): end to end at depth 1 and 2, and layer
    # by layer from the same inputs at full depth.  Deeper end-to-end runs
    # are measured, not gated: at random init attention is nearly one-hot
    # and rounding differences grow layer over layer (PERF.md §6).
    n = LM_CHECK_PROMPT
    lm_checks = [decode_vs_prefill(*_depth(params, cfg, 1), toks, n, 2e-2),
                 decode_vs_prefill(*_depth(params, cfg, 2), toks, n, 2e-2, gate="rel_l2"),
                 decode_vs_prefill_per_layer(params, cfg, toks, n, 2e-2)]
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = tf.init_params(cfg32, seed=LM_SEED, device=device)
    lm_checks += [decode_vs_prefill(*_depth(params, cfg32, depth), toks[:1], n, 2e-2,
                                    gate="elementwise" if depth <= 2 else None)
                  for depth in sorted({1, 2, 4, 8, cfg.n_layers}) if depth <= cfg.n_layers]
    lm_checks.append(decode_vs_prefill_per_layer(params, cfg32, toks[:1], n, 1e-4))
    del params
    torch.cuda.empty_cache()
    emit(dict(phase="lm_checks", k9_per_layer=[
        {k: c[k] for k in ("flash_attention_err", "rel_l2", "worst_over_tol")} for c in cases
        if c["kind"] == "lm_layer"], k9_edges=[c for c in cases if c["kind"] != "lm_layer"],
        decode_vs_prefill=lm_checks, k9_timing=timing))
    bad = [c for c in cases if c["flash_attention_mismatches"]]
    if bad:
        raise AssertionError(f"K9 disagrees with its plain version: {bad}")
    bad = [c for c in lm_checks if not c["ok"]]
    if bad:
        raise AssertionError(f"decode disagrees with prefill: {bad}")
    return dict(prefill=prefill_counts, decode=decode_counts), timing, cases


# ---------------------------------------------------------------------------
# phase 7: the dynamic path (SubgraphIndex.update, run_delta, invalidate_index)
# ---------------------------------------------------------------------------

def dyn_build_stream(tgt, pat, n_steps: int, seed: int, fraction: float):
    """benchmarks/bench_incremental.py's ``build_stream``: ``n_steps``
    batched edits, each touching ``fraction`` of the arcs, half removals of
    present edges and half pattern-relevant insertions (endpoint and edge
    labels drawn from the pattern's edges), always both arcs of an edge."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pe = sorted(set(zip(pat.labels[pat.src].tolist(), pat.labels[pat.dst].tolist(),
                        pat.edge_labels.tolist())))
    by_label = {l: np.nonzero(tgt.labels == l)[0] for l in {x for (a, b, _) in pe for x in (a, b)}}
    present = set(zip(tgt.src.tolist(), tgt.dst.tolist(), tgt.edge_labels.tolist()))
    k = max(4, int(len(present) * fraction))
    steps = []
    for _ in range(n_steps):
        pres_list = sorted((u, v, l) for (u, v, l) in present if u < v)
        rem_idx = rng.choice(len(pres_list), size=k // 4, replace=False)
        rems = []
        for i in rem_idx:
            u, v, l = pres_list[i]
            rems += [(u, v, l), (v, u, l)]
        adds = []
        while len(adds) < k - len(rems):
            la, lb, el = pe[int(rng.integers(len(pe)))]
            u = int(rng.choice(by_label[la]))
            v = int(rng.choice(by_label[lb]))
            t, tr = (u, v, int(el)), (v, u, int(el))
            if u != v and t not in present and t not in adds:
                adds += [t, tr]
        steps.append((adds, rems))
        present -= set(rems)
        present |= set(adds)
    return steps


def dyn_capped_counts(enum, queries, cap: int) -> list:
    """Each query's match count, or None once it passes ``cap``: the
    queries run as one pack (one coalesce key) on ``enum``'s step path, and
    a lane freezes as soon as its count passes ``cap`` (a count only
    grows, so it would pass it in the full run too).  A lane that
    overflowed its stacks is re-run alone, with the session's retry."""
    from repro_torch.core import engine as eng
    from repro_torch.core.frontier import init_state, stack_states

    cfg = enum.config
    state = stack_states([init_state(q.plan, cfg, enum.device) for q in queries])
    body = eng.make_round_fn(cfg, enum._plan_arrays(queries, cfg))
    while True:
        active = ((state.size.sum(dim=-1) > 0) & ~state.overflow
                  & (state.matches.sum(dim=-1) <= cap))
        on = active.cpu().numpy()
        if not on.any():
            break
        state = body(state, None if on.all() else active)
    counts = state.matches.sum(dim=-1).tolist()
    overflow = state.overflow.tolist()
    out = []
    for q, m, ov in zip(queries, counts, overflow):
        if ov:
            m = enum.run(q).matches
        out.append(None if m > cap else m)
    return out


def dyn_pick_pattern(enum, tgt, seed: int, min_matches: int, max_matches: int):
    """benchmarks/bench_incremental.py's ``pick_pattern`` rule: the first
    4-edge ``extract_pattern`` of seeds ``seed + 1 .. seed + 16`` whose match
    count lies in ``[min_matches, max_matches]``, else the densest one
    within ``max_matches``.  The candidates are counted together
    (:func:`dyn_capped_counts`), then the chosen one is run."""
    from repro_torch.data import graphgen

    seeds = list(range(seed + 1, seed + 17))
    pats = [graphgen.extract_pattern(tgt, 4, seed=s) for s in seeds]
    qs = [enum.prepare(p) for p in pats]
    groups = {}
    for i, q in enumerate(qs):
        groups.setdefault(enum.coalesce_key(q), []).append(i)
    counts = [None] * len(qs)
    for idxs in groups.values():
        for i, m in zip(idxs, dyn_capped_counts(enum, [qs[i] for i in idxs], max_matches)):
            counts[i] = m
    within = [i for i, m in enumerate(counts) if m is not None]
    if not within:
        raise AssertionError(f"no extracted pattern had <= {max_matches} matches")
    first = [i for i in within if counts[i] >= min_matches]
    pick = first[0] if first else max(within, key=lambda i: (counts[i], -i))
    ms = enum.run(qs[pick])
    if ms.matches != counts[pick]:
        raise AssertionError(f"pattern seed {seeds[pick]}: {ms.matches} matches alone, "
                             f"{counts[pick]} in the pack")
    return pats[pick], qs[pick], ms, seeds[pick], dict(zip(seeds, counts))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dyn_sorted_mappings(enum, query):
    """A fresh run of ``query`` with a match ring that holds every worker's
    matches: its counters, seconds of the counting run, and its sorted
    node-indexed mappings as an ``[M, n_p]`` int64 array."""
    import numpy as np

    from repro_torch.core.delta import as_node_mappings

    _sync(enum.device)
    t0 = time.perf_counter()
    ms = enum.run(query)
    _sync(enum.device)
    run_s = time.perf_counter() - t0
    top = int(ms.per_worker_matches.max()) if ms.matches else 1
    full = enum.run(query, collect_matches=1 << max(top - 1, 1).bit_length())
    rows = np.asarray(sorted(as_node_mappings(full)), dtype=np.int64)
    return ms, run_s, rows.reshape(-1, query.pattern.n)


def dyn_step(label, enum, index, pat, cur, adds, rems, seed_edge=None) -> dict:
    """One maintainer's step: ``update``, ``prepare`` on the new version, the
    version's upload, ``run_delta`` (its launches counted alone),
    ``apply_array`` and ``invalidate_index`` of the retired version, each
    timed on the host (the card synchronised around device work)."""
    from repro_torch.core.delta import build_anchor_seeds
    from repro_torch.kernels import ops

    dev = enum.device
    t0 = time.perf_counter()
    new_index, delta = index.update(add_edges=adds, remove_edges=rems)
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = enum.prepare(pat, index=new_index, seed_edge=seed_edge)
    prepare_s = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    if enum.config.step_backend == "csr":
        enum._csr_upload(new_index.fingerprint, new_index.csr_planes)
    else:
        enum._adjacency_rows(new_index.fingerprint, new_index.packed.adj_bits)
    _sync(dev)
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    anchors = list(enum._anchor_plans(q))
    anchor_plans_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_seeds = sum(int(build_anchor_seeds(ap, a, delta.added)[0].shape[0]) for a, ap in anchors)
    seeds_s = time.perf_counter() - t0
    hits = enum.cache_stats()["cache_hits"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dm = enum.run_delta(q, cur, delta)
    _sync(dev)
    run_delta_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    if enum.cache_stats()["cache_hits"] == hits and dm.n_anchors:
        raise AssertionError(f"{label}: run_delta did not read the version's upload")
    t0 = time.perf_counter()
    new_cur = dm.apply_array(cur)
    apply_s = time.perf_counter() - t0
    dropped = enum.invalidate_index(delta.old_fingerprint)
    kept = dict(rows=len(enum._rows), csr=len(enum._csr))
    if max(kept.values()) > 2:
        raise AssertionError(f"{label}: more than two uploads per layout remain: {kept}")
    if host_seeds != dm.n_seeds:
        raise AssertionError(f"{label}: host seeds {host_seeds} != run_delta's {dm.n_seeds}")
    return dict(index=new_index, query=q, dm=dm, cur=new_cur, launches=launches,
                row=dict(added=len(dm.added), removed=len(dm.removed), n_old=dm.n_old,
                         matches=dm.matches, seeds=dm.n_seeds, anchors=dm.n_anchors,
                         states=dm.states, retries=dm.retries, update_s=update_s,
                         prepare_s=prepare_s, upload_s=upload_s, anchor_plans_s=anchor_plans_s,
                         seeds_s=seeds_s, run_delta_s=run_delta_s, apply_array_s=apply_s,
                         dropped_uploads=dropped, uploads_kept=kept,
                         launches={k: v for k, v in launches.items() if v}))


def _dm_key(dm):
    return (dm.added, dm.removed, dm.n_old, dm.states, dm.n_seeds, dm.n_anchors, dm.retries)


def run_dynamic_path(device):
    """Phase 7; returns each maintainer's ``run_delta`` launch counts."""
    import numpy as np

    from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
    from repro_torch.core.delta import apply_delta, as_mapping_array
    from repro_torch.data import graphgen

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tgt = apply_delta(graphgen.power_law_graph(DYN["n"], avg_deg=DYN["avg_deg"],
                                               alpha=DYN["alpha"], n_labels=DYN["n_labels"],
                                               seed=DYN["seed"]))
    index0 = SubgraphIndex.build(tgt)
    index0.plane_set()  # built once, so every update patches it
    setup_s = time.perf_counter() - t0

    def session(**kw):
        return Enumerator(index0, config=EngineConfig(**ENGINE_KW, **kw), variant=VARIANT,
                          device=device)

    maint = {label: session(**kw) for label, kw in DYN_MAINTAINERS.items()}
    k1 = maint["pallas"]
    t0 = time.perf_counter()
    pat, _, ms0, pat_seed, candidates = dyn_pick_pattern(k1, tgt, DYN["seed"],
                                                         DYN_MIN_MATCHES, DYN_MAX_MATCHES)
    pick_s = time.perf_counter() - t0
    steps = dyn_build_stream(tgt, pat, DYN_STEPS + 1, DYN["seed"], DYN_EDIT_FRACTION)
    emit(dict(phase="dynamic_setup", n_t=tgt.n, arcs=tgt.m, w=index0.w,
              edge_labels=index0.n_edge_labels, adj_bytes=index0.packed.adj_bits.nbytes,
              candidate_matches=candidates, pattern_seed=pat_seed, pattern_nodes=pat.n,
              pattern_arcs=pat.m,
              matches=ms0.matches, states=ms0.states, arcs_per_step=len(steps[0][0])
              + len(steps[0][1]), setup_s=setup_s, pick_pattern_s=pick_s))

    cur0 = as_mapping_array(ms0)
    SHARED["dyn"] = dict(index=index0, pattern=pat, edit=steps[0], cur=cur0)
    state = {label: dict(index=index0, cur=cur0) for label in maint}
    launches = {label: {} for label in maint}
    g = tgt
    for i in range(DYN_STEPS):
        adds, rems = steps[i]
        out = {}
        for label, enum in maint.items():
            st = state[label]
            out[label] = dyn_step(label, enum, st["index"], pat, st["cur"], adds, rems)
            st["index"], st["cur"] = out[label]["index"], out[label]["cur"]
            _add(launches[label], out[label]["launches"])
        g = apply_delta(g, added=adds, removed=rems)
        want = _dm_key(out["pallas"]["dm"])
        for label, o in out.items():
            if _dm_key(o["dm"]) != want:
                raise AssertionError(f"step {i}: {label}'s delta differs from the pallas one")
            if o["index"].fingerprint != out["pallas"]["index"].fingerprint:
                raise AssertionError(f"step {i}: {label}'s index version differs")
        check = i in (0, DYN_STEPS - 1)
        if check:
            fresh, fresh_s, rows = dyn_sorted_mappings(k1, out["pallas"]["query"])
        else:
            _sync(device)
            t0 = time.perf_counter()
            fresh = k1.run(out["pallas"]["query"])
            _sync(device)
            fresh_s = time.perf_counter() - t0
        for label, o in out.items():
            if len(o["cur"]) != fresh.matches:
                raise AssertionError(f"step {i}: {label} maintains {len(o['cur'])} matches, "
                                     f"a fresh K1 run finds {fresh.matches}")
            if check and not np.array_equal(o["cur"], rows):
                raise AssertionError(f"step {i}: {label}'s maintained mappings differ from "
                                     "a fresh run's")
            o["row"]["recompute_over_delta"] = fresh_s / (o["row"]["update_s"]
                                                          + o["row"]["run_delta_s"])
        emit(dict(phase="dynamic_path", step=i, version=out["pallas"]["index"].version,
                  arcs_added=len(out["pallas"]["dm"].delta.added),
                  arcs_removed=len(out["pallas"]["dm"].delta.removed),
                  fresh_matches=fresh.matches, fresh_states=fresh.states, fresh_steps=fresh.steps,
                  fresh_run_s=fresh_s, mappings_checked=check,
                  maintainers={label: o["row"] for label, o in out.items()}))

    # one more step: the same edit through an edge-seeded csr query and the
    # vertex-seeded pallas maintainer
    g_last = g
    adds, rems = steps[DYN_STEPS]
    st = state["pallas"]
    edge = Enumerator(st["index"], config=EngineConfig(
        **ENGINE_KW, **DYN_MAINTAINERS["csr bucketed"], root_seeding="auto"),
        variant=VARIANT, device=device)
    e = dyn_step("edge csr bucketed", edge, st["index"], pat, st["cur"], adds, rems,
                 seed_edge="auto")
    v = dyn_step("pallas", k1, st["index"], pat, st["cur"], adds, rems)
    launches["edge csr bucketed"] = e["launches"]
    _add(launches["pallas"], v["launches"])
    g = apply_delta(g, added=adds, removed=rems)
    fresh, fresh_s, rows = dyn_sorted_mappings(k1, v["query"])
    seed = e["query"].plan.seed_edge
    anchors = dict(edge._anchor_plans(e["query"]))
    if seed is None or anchors[seed] is not e["query"].plan:
        raise AssertionError("the edge-seeded query's plan is not its seed edge's anchor plan")
    if (e["dm"].added, e["dm"].removed) != (v["dm"].added, v["dm"].removed):
        raise AssertionError("the edge-seeded delta's added / removed differ from the "
                             "vertex-seeded one's")
    for label, o in (("edge csr bucketed", e), ("pallas", v)):
        if not np.array_equal(o["cur"], rows):
            raise AssertionError(f"edge step: {label}'s maintained mappings differ from a "
                                 "fresh run's")
        o["row"]["recompute_over_delta"] = fresh_s / (o["row"]["update_s"]
                                                      + o["row"]["run_delta_s"])
    emit(dict(phase="dynamic_path", step=DYN_STEPS, version=v["index"].version,
              seed_edge=list(seed), arcs_added=len(v["dm"].delta.added),
              arcs_removed=len(v["dm"].delta.removed), fresh_matches=fresh.matches,
              fresh_states=fresh.states, fresh_steps=fresh.steps, fresh_run_s=fresh_s,
              mappings_checked=True,
              maintainers={"edge csr bucketed": e["row"], "pallas": v["row"]}))

    # every maintained index equals a fresh build of the edited graph: the
    # four maintainers' after the stream, the edge step's after one more edit
    for graph, indexes in ((g_last, [state[label]["index"] for label in maint]),
                           (g, [v["index"], e["index"]])):
        fresh_index = SubgraphIndex.build(graph)
        want = fresh_index.csr_planes()
        for idx in indexes:
            for f in ("adj_bits", "deg_out", "deg_in"):
                if not np.array_equal(getattr(idx.packed, f), getattr(fresh_index.packed, f)):
                    raise AssertionError(f"the updated index's {f} differs from a fresh build")
            got = idx.csr_planes()
            if not (np.array_equal(got.indptr, want.indptr)
                    and np.array_equal(got.indices, want.indices)):
                raise AssertionError("the updated index's CSR planes differ from a fresh build")

    for label, kernel in DYN_KERNEL_OF.items():
        if not launches[label].get(kernel):
            raise AssertionError(f"the {label} run_delta calls never launched {kernel}")
    emit(dict(phase="dynamic_done", launches=launches,
              dynamic_path_s=time.perf_counter() - t_phase))
    return launches


# ---------------------------------------------------------------------------
# phase 8: the out-of-core path (memory_budget_bytes, step_backend="partitioned")
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def part_probe():
    """Within the block, each ``engine.run_partitioned`` call appends its
    ``stats`` to ``probe["stats"]``, and the host seconds of its intake
    (``_intake_chunk``) and ring drains (``_drain_spill``) add up in
    ``probe["intake_s"]`` / ``probe["drain_s"]``."""
    from repro_torch.core import engine

    probe = dict(stats=[], intake_s=0.0, drain_s=0.0)
    orig = {name: getattr(engine, name)
            for name in ("run_partitioned", "_intake_chunk", "_drain_spill")}

    def run_partitioned(*args, **kw):
        kw["stats"] = stats = {}
        out = orig["run_partitioned"](*args, **kw)
        probe["stats"].append(stats)
        return out

    def timed(name, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig[name](*args, **kw)
            finally:
                probe[key] += time.perf_counter() - t0
        return call

    engine.run_partitioned = run_partitioned
    engine._intake_chunk = timed("_intake_chunk", "intake_s")
    engine._drain_spill = timed("_drain_spill", "drain_s")
    try:
        yield probe
    finally:
        for name, fn in orig.items():
            setattr(engine, name, fn)


class _Recorded(Exception):
    """Ends a run whose step inputs :func:`record_part_step` has taken."""


def record_part_step(enum, query, kernel: str, max_calls: int = 4000):
    """The arguments of a call of ``kernel`` (K6 ``csr_extend`` or K7
    ``csr_extend_bucketed``) in a run of ``query`` under the partitioned
    session ``enum`` with both kinds of lanes the partitioned step brings:
    lanes that want a child whose every real parent is off the resident
    partition, and lanes with resident and off-partition parents.  Of the
    first such call and the 256 calls after it, the one with the most
    valid lanes, as ``{"x": inputs, "n_p", "deg_cap", "valid", "all_off",
    "mixed"}`` with copies of the per-lane arguments; then the run is cut
    short.  None if the first ``max_calls`` calls have no such call."""
    from repro_torch.core import extend
    from repro_torch.kernels import ops

    seg = {}
    segments = extend.PartitionedCsrStepBackend._segments
    op = getattr(ops, kernel)
    best = dict(valid=-1, calls=0, first=None)

    def seg_rec(self, row, map2):
        out = segments(self, row, map2)
        seg["pending"] = out[2]
        return out

    def rec(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p, used, cand, deg_cap):
        best["calls"] += 1
        valid = (cand != 0).any(dim=1)
        off = valid & (depth + 1 < n_p) & (seg["pending"] != 0)
        resident = (seg_len >= 0).any(dim=1)
        all_off, mixed = int((off & ~resident).sum()), int((off & resident).sum())
        n_valid = int(valid.sum())
        if all_off and mixed and n_valid > best["valid"]:
            best.update(valid=n_valid, n_p=n_p, deg_cap=deg_cap, all_off=all_off, mixed=mixed,
                        first=best["first"] or best["calls"],
                        x=dict(indices=indices, dom_bits=dom_bits, seg_start=seg_start.clone(),
                               seg_len=seg_len.clone(), child_pos=child_pos.clone(),
                               depth=depth.clone(), used=used.clone(), cand=cand.clone()))
        if best["calls"] >= (best["first"] + 256 if best["first"] else max_calls):
            raise _Recorded
        return op(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p, used, cand,
                  deg_cap=deg_cap)

    setattr(ops, kernel, rec)
    extend.PartitionedCsrStepBackend._segments = seg_rec
    try:
        enum.run(query)
    except _Recorded:
        pass
    finally:
        setattr(ops, kernel, op)
        extend.PartitionedCsrStepBackend._segments = segments
    return best if best["valid"] >= 0 else None


def pattern_minus_edge(pattern, k: int):
    """``pattern`` without its ``k``-th undirected edge (both arcs), or None
    if that disconnects it: a pattern with every occurrence of
    ``pattern`` among its own."""
    import numpy as np

    from repro_torch.core import Graph

    pairs = sorted({(min(u, v), max(u, v)) for u, v in zip(pattern.src.tolist(),
                                                            pattern.dst.tolist()) if u != v})
    if k >= len(pairs):
        return None
    cut = pairs[k]
    keep = [i for i, (u, v) in enumerate(zip(pattern.src.tolist(), pattern.dst.tolist()))
            if (min(u, v), max(u, v)) != cut]
    g = Graph.from_edges(pattern.n, [(int(pattern.src[i]), int(pattern.dst[i])) for i in keep],
                         labels=pattern.labels, edge_labels=pattern.edge_labels[keep])
    seen, todo = {0}, [0]
    while todo:
        u = todo.pop()
        for v in np.concatenate([g.out_neighbors(u), g.in_neighbors(u)]).tolist():
            if v not in seen:
                seen.add(v)
                todo.append(v)
    return g if len(seen) == g.n else None


def check_part_steps(steps: dict) -> tuple:
    """K6 and K7 against their plain versions on each recorded partitioned
    step (:func:`record_part_step`, keyed by walk), and timed on it beside
    the plain version and the bound."""
    from repro_torch.kernels import csr_extend as ce
    from repro_torch.kernels import ref as kref

    cases, timing = [], {}
    for walk, s in steps.items():
        x, n_p, cap = s["x"], s["n_p"], s["deg_cap"]
        cases.append(dict(csr_step_case(x, n_p, cap), inputs=f"partitioned {walk} step",
                          query=s["query"], valid_lanes=s["valid"],
                          lanes_all_parents_off=s["all_off"], lanes_mixed_parents=s["mixed"]))
        args = [x[k] for k in CSR_ARGS] + [n_p, x["used"], x["cand"]]
        nbytes = csr_step_bytes(x, n_p, cap)
        for name, kern, plain in (
                ("csr_extend", ce.csr_extend_cuda, kref.csr_extend_ref),
                ("csr_extend_bucketed", ce.csr_extend_bucketed_cuda,
                 kref.csr_extend_bucketed_ref)):
            timing.setdefault(name, {})[walk] = dict(
                valid_lanes=s["valid"], b=int(x["cand"].shape[0]), w=int(x["cand"].shape[1]),
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ms=cuda_ms(lambda: kern(*args, deg_cap=cap)),
                plain_ms=cuda_ms(lambda: plain(*args, deg_cap=cap), reps=10))
    return cases, timing


def _counter_key(ms):
    return _counters(ms) + (ms.mean_steal_depth, ms.mean_expand_depth)


def run_outofcore_path(device, smi: str):
    """Phase 8; returns the launch counts of its runs, and K6 / K7 checked
    and timed on recorded partitioned steps."""
    import numpy as np

    from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
    from repro_torch.core import extend
    from repro_torch.core.ref import ref_enumerate, ref_enumerate_partitioned
    from repro_torch.data import graphgen

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    target = graphgen.power_law_graph(OOC["n"], avg_deg=OOC["avg_deg"],
                                      n_labels=OOC["n_labels"], seed=OOC["seed"])
    pattern = graphgen.extract_pattern(target, OOC_PATTERN_EDGES, seed=OOC["seed"])
    index = SubgraphIndex.build(target, sparse=True)
    planes = index.csr_planes()
    setup_s = time.perf_counter() - t0

    def session(walk="bucketed", **kw):
        return Enumerator(index, config=EngineConfig(**OOC_KW, use_pallas=True, csr_walk=walk),
                          device=device, **kw)

    def timed_run(enum, query):
        _sync(device)
        t0 = time.perf_counter()
        ms = enum.run(query)
        _sync(device)
        return ms, time.perf_counter() - t0

    mono = session(step_backend="csr")
    t0 = time.perf_counter()
    q = mono.prepare(pattern, name="outofcore")
    prepare_s = time.perf_counter() - t0
    whole = extend.part_resident_nbytes(extend.plan_partitions(q.plan, 1))
    budget = whole // OOC_BUDGET_FACTOR
    pp = extend.plan_partitions_budget(q.plan, budget)
    resident = extend.part_resident_nbytes(pp)
    if resident > budget:
        raise AssertionError(f"the derived partitioning holds {resident} bytes > budget {budget}")
    emit(dict(phase="outofcore_setup", n_t=target.n, arcs=target.m, nnz=planes.nnz,
              max_degree=int(np.diff(planes.indptr, axis=1).max()), pattern_nodes=pattern.n,
              pattern_arcs=pattern.m, plane_bytes=planes.nbytes, whole_resident_bytes=whole,
              budget_bytes=budget, n_parts=pp.n_parts, resident_bytes=resident,
              per_part_nbytes=[p.nbytes for p in pp.parts], cut_edges=pp.cut_edges,
              setup_s=setup_s, prepare_s=prepare_s))

    launches = {}
    (mono_cold, mono_cold_s), counts = _launched(lambda: timed_run(mono, q))
    _add(launches, counts)
    (want, mono_warm_s), counts = _launched(lambda: timed_run(mono, q))
    _add(launches, counts)
    if _counters(want) != _counters(mono_cold):
        raise AssertionError("the monolithic csr run is not deterministic")
    ref = ref_enumerate(pattern, target, plan=q.plan)
    if (ref.matches, ref.states) != (want.matches, want.states):
        raise AssertionError(f"monolithic csr {(want.matches, want.states)} != ref_enumerate "
                             f"{(ref.matches, ref.states)}")
    SHARED["ooc"] = dict(index=index, pattern=pattern, budget=budget, matches=want.matches,
                         states=want.states)
    emit(dict(phase="outofcore_path", run="monolithic csr bucketed", launches=counts,
              matches=want.matches, states=want.states, steps=want.steps, cold_s=mono_cold_s,
              warm_s=mono_warm_s))

    results, stats, oracles = {}, {}, {}
    sessions = {}
    for label, walk, mode, kernel in OOC_RUNS:
        kw = (dict(memory_budget_bytes=budget) if mode == "budget"
              else dict(step_backend="partitioned", n_partitions=OOC_N_PARTS))
        enum = sessions[label] = session(walk, **kw)
        if enum.config.step_backend != "partitioned":
            raise AssertionError(f"{label}: the session's backend is {enum.config.step_backend}")
        n_parts = enum._partition_count(enum.config, q.plan)
        runs = {}
        for when in ("cold", "warm"):
            with part_probe() as probe:
                (ms, run_s), counts = _launched(lambda: timed_run(enum, q))
            _add(launches, counts)
            if not counts[kernel]:
                raise AssertionError(f"{label} ({when}) never launched {kernel}: {counts}")
            (st,) = probe["stats"]
            runs[when] = dict(ms=ms, stats=st, run_s=run_s, intake_s=probe["intake_s"],
                              drain_s=probe["drain_s"], launches=counts)
        if _counter_key(runs["cold"]["ms"]) != _counter_key(runs["warm"]["ms"]) \
                or runs["cold"]["stats"] != runs["warm"]["stats"]:
            raise AssertionError(f"{label}: the warm run differs from the cold one")
        ms, st = runs["warm"]["ms"], runs["warm"]["stats"]
        if (ms.matches, ms.states) != (want.matches, want.states):
            raise AssertionError(f"{label}: {(ms.matches, ms.states)} != the monolithic run's "
                                 f"{(want.matches, want.states)}")
        if st["n_parts"] != n_parts or (mode == "budget" and st["n_parts"] != pp.n_parts):
            raise AssertionError(f"{label}: ran {st['n_parts']} partitions, not {n_parts}")
        if n_parts not in oracles:
            oracles[n_parts] = ref_enumerate_partitioned(pattern, target, n_parts, plan=q.plan)
        orc = oracles[n_parts]
        got = (ms.matches, ms.states, st["visits"], st["spilled"], st["dead_spills"])
        if got != (orc.matches, orc.states, orc.visits, orc.spilled, orc.dead_spills):
            raise AssertionError(f"{label}: (matches, states, visits, spilled, dead_spills) "
                                 f"{got} != ref_enumerate_partitioned's "
                                 f"{(orc.matches, orc.states, orc.visits, orc.spilled, orc.dead_spills)}")
        results[label], stats[label] = ms, st
        emit(dict(phase="outofcore_path", run=label, csr_walk=walk, **{
            k: st[k] for k in ("n_parts", "visits", "legs", "rounds", "spilled", "dead_spills",
                               "max_pool", "cut_edges", "resident_plane_bytes",
                               "final_stack_cap", "final_spill_cap")},
            matches=ms.matches, states=ms.states, steps=ms.steps, steals=ms.steals,
            steal_rounds=ms.steal_rounds,
            **{f"{when}_{k}": r[k] for when, r in runs.items()
               for k in ("run_s", "intake_s", "drain_s", "launches")},
            monolithic_cold_s=mono_cold_s, monolithic_warm_s=mono_warm_s,
            warm_over_monolithic=runs["warm"]["run_s"] / mono_warm_s))
    flat, bucketed = "budget flat", "budget bucketed"
    if _counter_key(results[flat]) != _counter_key(results[bucketed]) \
            or stats[flat] != stats[bucketed]:
        raise AssertionError("the flat and bucketed partitioned runs disagree")

    # the recorded steps: the bench pattern's search never meets a lane whose
    # every parent is off the partition (each live entry keeps a resident
    # parent that its children share), so they come from partitioned runs of
    # the pattern without one of its edges (the first such pattern whose runs
    # under both walks give a step with both kinds of lanes), cut short once
    # the step is taken
    steps, tried = {}, []
    for k in range(pattern.m):
        pat = pattern_minus_edge(pattern, k)
        if pat is None:
            continue
        rq = mono.prepare(pat, name=f"outofcore minus edge {k}")
        for label, walk, mode, kernel in OOC_RUNS:
            if mode == "budget":
                step = record_part_step(sessions[label], rq, kernel)
                if step is not None:
                    steps[walk] = dict(step, query=rq.name)
        tried.append(dict(query=rq.name, arcs=pat.m, walks=sorted(steps)))
        if len(steps) == 2:
            break
        steps = {}
    if len(steps) != 2:
        raise AssertionError(f"no partitioned step with lanes whose every parent is off the "
                             f"partition and lanes with mixed parents: {tried}")
    cases, timing = check_part_steps(steps)
    emit(dict(phase="outofcore_steps", cases=cases, timing=timing, queries_tried=tried,
              oracle=dict(matches=ref.matches, states=ref.states,
                          partitioned={n: dict(visits=o.visits, spilled=o.spilled,
                                               dead_spills=o.dead_spills)
                                       for n, o in oracles.items()}),
              nvidia_smi=smi, outofcore_path_s=time.perf_counter() - t_phase))
    if any(v for c in cases for k, v in c.items() if k.endswith("_mismatches")):
        raise AssertionError(f"K6 / K7 disagree on a partitioned step: {cases}")
    return launches, cases, timing


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 9: the service (repro_torch.serve)
# ---------------------------------------------------------------------------

def svc_drive(svc, clients, between=None):
    """Drive ``svc`` with one thread per entry of ``clients``, a ``(before,
    after)`` pair: ``before`` is a list of submissions, ``after`` a function
    returning one.  A submission is a dict with ``query`` (a prepared Query,
    a raw pattern that ``submit`` prepares, or a function that prepares one
    on the client thread), ``name``, ``collect``, ``tenant`` and ``index``
    (the index version a raw pattern is prepared against).  Each client
    submits ``before``, waits for every other client (the last to arrive
    runs ``between``), submits ``after``, then reads each stream's terminal
    status and chunks.  Returns the submissions, each with its query,
    ``status`` and ``chunks``, and the seconds from the start to the last
    client's end."""
    import threading

    barrier = threading.Barrier(len(clients), action=between)
    records = [[] for _ in clients]
    errors = []

    def submit(sub):
        q = sub["query"]
        if callable(q):
            q = q()  # prepared on this client thread
        rec = dict(sub, query=q)
        rec["handle"] = svc.submit(q, tenant=sub["tenant"], name=sub["name"],
                                   collect=sub["collect"], timeout=SVC_TIMEOUT)
        return rec

    def client(c):
        try:
            before, after = clients[c]
            records[c] += [submit(sub) for sub in before]
            barrier.wait(SVC_TIMEOUT)
            records[c] += [submit(sub) for sub in after()]
            for rec in records[c]:
                rec["status"] = rec["handle"].status(timeout=SVC_TIMEOUT)
                rec["chunks"] = rec["handle"].chunks(timeout=SVC_TIMEOUT)
        except BaseException as e:  # raised after the join
            errors.append(e)
            barrier.abort()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SVC_TIMEOUT)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a service client did not finish")
    return [rec for recs in records for rec in recs], wall


def svc_check(label, records, ref, variant) -> None:
    """Gate each served query against a standalone ``ref.run`` of it at the
    same collect budget: every status ok, every counter (per worker too) and
    ``retries`` equal, and the streamed chunks, concatenated, equal to the
    standalone run's mappings (no chunk in counting mode)."""
    from repro_torch.core import Query

    standalone = {}
    for rec in records:
        st = rec["status"]
        if not st.ok:
            raise AssertionError(f"{label} {rec['name']}: served with an error: {st.error}")
        q = rec["query"]
        if not isinstance(q, Query):  # a raw pattern, prepared by submit()
            q = rec["query"] = Query(pattern=q, plan=st.matchset.plan, variant=variant,
                                     name=rec["name"], prepare_s=0.0, index=rec["index"])
        key = (id(q.plan), rec["collect"])
        if key not in standalone:
            standalone[key] = ref.run(q, collect_matches=rec["collect"])
        one = standalone[key]
        if _counters(st.matchset) != _counters(one) or st.retries != st.matchset.retries \
                or st.matchset.retries != one.retries:
            raise AssertionError(f"{label} {rec['name']}: served {_counters(st.matchset)} "
                                 f"(retries {st.retries}) != standalone {_counters(one)}")
        got = [m for chunk in rec["chunks"] for m in chunk.mappings]
        if got != (one.mappings() if rec["collect"] else []):
            raise AssertionError(f"{label} {rec['name']}: streamed chunks != the standalone "
                                 f"run's mappings at collect {rec['collect']}")


def svc_summary(svc, records, wall) -> dict:
    """The printed (not gated) numbers of one service run."""
    st = svc.stats()
    lat = [rec["status"].latency_s for rec in records]
    return dict(submitted=st["submitted"], completed=st["completed"], wall_s=wall,
                qps=len(records) / wall, window_qps=st["qps"],
                latency_p50_s=st["latency_p50_s"], latency_p99_s=st["latency_p99_s"],
                latency_max_s=st["latency_max_s"], first_latency_s=min(lat),
                queue_wait_p50_s=st["queue_wait_p50_s"], queue_wait_p99_s=st["queue_wait_p99_s"],
                batch_occupancy=st["batch_occupancy"], dispatches=st["dispatches"],
                chunks=st["chunks"], retries=st["retries"], cache_uploads=st["cache_uploads"],
                cache_hits=st["cache_hits"], cache_invalidated=st["cache_invalidated"],
                warmup_uploads=st["warmup_uploads"])


def _svc_gate_launches(label, counts) -> None:
    missing = [k for k in SVC_KERNELS.get(label, ()) if not counts[k]]
    if missing:
        raise AssertionError(f"service {label} never launched {missing}: {counts}")


def run_service_path(device, smi: str) -> dict:
    """Phase 9: three services on the card.  S1 serves mixed dense and
    CSR-only load on phase 3's target through K2 and K7 (phase 4's patterns
    prepared up front through K5 and K3, phase 5's by the clients through
    K8 and K3) across a live 1 % edit of the dense target; S2 the dense
    traffic alone through K1, without and with a warm-up profile; S3 phase
    8's query under its memory budget through K6.  Returns the launch
    counts of the three."""
    import io

    from repro_torch.core import EngineConfig, Enumerator
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import EnumerationService, ServiceConfig

    t_phase = time.perf_counter()
    main, batch, sparse, ooc = (SHARED[k] for k in ("main", "batch", "sparse", "ooc"))
    index0, pats, names = main["index"], batch["patterns"], batch["names"]
    n_dense = len(pats)
    launches = {}
    total = {}

    def dense_at(c, j):
        return (c * SVC_DENSE_PER_CLIENT + j) % n_dense

    # ---- S1: mixed dense and CSR-only load, a live index update ----------
    cfg1 = EngineConfig(**ENGINE_KW, step_backend="auto", use_pallas=True)
    small = min(range(n_dense), key=lambda i: (pats[i].n, pats[i].m))
    ((adds, rems),) = dyn_build_stream(main["target"], pats[small], 1, SVC_EDIT_SEED,
                                       DYN_EDIT_FRACTION)
    svc = EnumerationService(index0, config=cfg1, variant=SVC_VARIANT,
                             service=ServiceConfig(**SVC_SERVICE), device=device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pre = svc.enumerator.prepare_batch(pats, names=[f"{n}/v0" for n in names])
    pre_s = time.perf_counter() - t0
    post = {}

    def swap():  # run by the last client to reach the barrier
        t = time.perf_counter()
        post["delta"] = svc.update_index(add_edges=adds, remove_edges=rems)
        post["index"] = svc.enumerator.index
        t1 = time.perf_counter()
        post["queries"] = svc.enumerator.prepare_batch(
            pats, names=[f"{n}/v1" for n in names], index=post["index"])
        post["update_s"], post["prepare_batch_s"] = t1 - t, time.perf_counter() - t1

    def s1_client(c):
        collect, tenant = (SVC_COLLECT if c % 2 == 0 else 0), f"t{c % SVC_TENANTS}"

        def sub(query, name, kind, index=None):
            return dict(query=query, name=name, kind=kind, index=index, collect=collect,
                        tenant=tenant)

        i0 = dense_at(c, 0)
        p = sparse["patterns"][c % len(sparse["patterns"])]
        before = [sub(pre[i0], f"c{c}/{pre[i0].name}", "dense"),
                  sub(lambda p=p: svc.enumerator.prepare(p, variant=SVC_VARIANT,
                                                         index=sparse["index"],
                                                         name=f"c{c}/csr"),
                      f"c{c}/csr", "csr")]
        if c == 1:  # one raw pattern: submit() prepares it on this thread
            before.append(sub(pats[small], f"c{c}/{names[small]}/raw", "raw", index0))

        def after():
            return [sub(post["queries"][i], f"c{c}/{post['queries'][i].name}", "dense")
                    for i in (dense_at(c, j) for j in range(1, SVC_DENSE_PER_CLIENT))]

        return before, after

    try:
        svc.start()
        records, wall = svc_drive(svc, [s1_client(c) for c in range(SVC_CLIENTS)], swap)
    finally:
        svc.stop(drain=True)
    launches["S1"] = ops.launch_counts()
    _add(total, launches["S1"])
    _svc_gate_launches("S1", launches["S1"])
    s1 = svc_summary(svc, records, wall)
    if s1["completed"] != len(records) or s1["submitted"] != len(records):
        raise AssertionError(f"S1: {s1['completed']} completed of {len(records)} submitted")
    if post["delta"].is_empty or post["index"] is index0:
        raise AssertionError("S1: the update did not swap the index")
    svc_check("S1", records, Enumerator(config=cfg1, variant=SVC_VARIANT, device=device),
              SVC_VARIANT)
    keys = {}
    for rec in records:
        key = svc.enumerator.coalesce_key(rec["query"], svc._cfg_for(rec["collect"]))
        keys.setdefault(key + (rec["collect"],), set()).add(rec["kind"])
    if any(len(kinds - {"raw"}) > 1 for kinds in keys.values()) or len(keys) < 2:
        raise AssertionError(f"S1: dense and CSR-only queries shared a coalesce key: {keys}")
    if s1["dispatches"] < len(keys):
        raise AssertionError(f"S1: {s1['dispatches']} dispatches for {len(keys)} keys")
    versions = {rec["query"].index_fingerprint for rec in records if rec["kind"] != "csr"}
    emit(dict(phase="service", service="S1", launches=launches["S1"], nvidia_smi=smi,
              queries=len(records), dense=sum(r["kind"] == "dense" for r in records),
              csr=sum(r["kind"] == "csr" for r in records),
              raw=sum(r["kind"] == "raw" for r in records), coalesce_keys=len(keys),
              dense_versions=len(versions), prepare_batch_s=pre_s,
              prepare_batch_s_per_pattern=pre_s / n_dense,
              update=dict(added=len(post["delta"].added), removed=len(post["delta"].removed),
                          update_s=post["update_s"], prepare_batch_s=post["prepare_batch_s"]),
              csr_prepare_s=[r["query"].prepare_s for r in records if r["kind"] == "csr"],
              cache=svc.enumerator.cache_stats(), **s1))

    # ---- S2: the dense traffic alone through K1, cold and warmed ---------
    cfg2 = EngineConfig(**ENGINE_KW, step_backend="pallas")
    ref2 = Enumerator(config=cfg2, variant=SVC_VARIANT, device=device)
    s2, launches["S2"] = {}, {}
    for label, profile in (("cold", ()), ("warm", tuple(pre))):
        svc = EnumerationService(index0, config=cfg2, variant=SVC_VARIANT, device=device,
                                 service=ServiceConfig(**SVC_SERVICE, warmup_profile=profile))

        def s2_client(c):
            collect = SVC_COLLECT if c % 2 == 0 else 0
            return ([dict(query=pre[i], name=f"c{c}/{pre[i].name}", kind="dense", index=None,
                          collect=collect, tenant=f"t{c % SVC_TENANTS}")
                     for i in (dense_at(c, j) for j in range(SVC_DENSE_PER_CLIENT))],
                    lambda: [])

        ops.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            svc.start()
            start_s = time.perf_counter() - t0
            uploads_started = svc.enumerator.cache_stats()["uploads"]
            records, wall = svc_drive(svc, [s2_client(c) for c in range(SVC_CLIENTS)])
        finally:
            svc.stop(drain=True)
        counts = ops.launch_counts()
        _add(launches["S2"], counts)
        uploads_stopped = svc.enumerator.cache_stats()["uploads"]
        s2[label] = dict(svc_summary(svc, records, wall), start_s=start_s,
                         uploads_after_start=uploads_started,
                         uploads_at_stop=uploads_stopped, launches=counts)
        if s2[label]["completed"] != len(records):
            raise AssertionError(f"S2 {label}: {s2[label]['completed']} of {len(records)}")
        if profile and uploads_stopped != uploads_started:
            raise AssertionError(f"S2 warm: the dispatches uploaded {uploads_stopped - uploads_started}"
                                 " times after the warm-up")
        svc_check(f"S2 {label}", records, ref2, SVC_VARIANT)
    _add(total, launches["S2"])
    _svc_gate_launches("S2", launches["S2"])
    emit(dict(phase="service", service="S2", nvidia_smi=smi, launches=launches["S2"], **s2))

    # ---- S3: out-of-core, phase 8's query under its budget through K6 ----
    cfg3 = EngineConfig(**OOC_KW, use_pallas=True, csr_walk="flat")
    svc = EnumerationService(ooc["index"], config=cfg3, device=device,
                             service=ServiceConfig(memory_budget_bytes=ooc["budget"]))

    def s3_client(c):
        return ([dict(query=ooc["pattern"], name=f"outofcore/{c}", kind="raw",
                      index=ooc["index"], collect=SVC_COLLECT if c == 0 else 0, tenant="t0")],
                lambda: [])

    ops.reset_launch_counts()
    try:
        svc.start()
        records, wall = svc_drive(svc, [s3_client(c) for c in range(2)])
    finally:
        svc.stop(drain=True)
    launches["S3"] = ops.launch_counts()
    _add(total, launches["S3"])
    _svc_gate_launches("S3", launches["S3"])
    svc_check("S3", records, Enumerator(config=cfg3, memory_budget_bytes=ooc["budget"],
                                        device=device), svc.enumerator.variant)
    for rec in records:
        ms = rec["status"].matchset
        if (ms.matches, ms.states) != (ooc["matches"], ooc["states"]):
            raise AssertionError(f"S3 {rec['name']}: {(ms.matches, ms.states)} != phase 8's "
                                 f"monolithic {(ooc['matches'], ooc['states'])}")
    emit(dict(phase="service", service="S3", nvidia_smi=smi, launches=launches["S3"],
              budget_bytes=ooc["budget"], matches=ooc["matches"], states=ooc["states"],
              **svc_summary(svc, records, wall)))

    # ---- the port's service CLI, its own checks inside -------------------
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve_cli.main(["--smoke", "--use-pallas"])
    if rc != 0:
        raise AssertionError(f"repro_torch.launch.serve --smoke exited {rc}")
    emit(dict(phase="service_cli", argv="--smoke --use-pallas",
              seconds=time.perf_counter() - t0, output=out.getvalue().splitlines()[-6:],
              service_path_s=time.perf_counter() - t_phase, nvidia_smi=smi))
    return total


# ---------------------------------------------------------------------------
# phase 10: multi-device work stealing and the paper's driver
# ---------------------------------------------------------------------------

def mesh_counters(ms):
    """Every counter of a run, per worker too, and its match buffer."""
    buf = ms.engine.match_buf
    return _counters(ms) + (None if buf is None else buf.tolist(),)


def steal_round_bytes(cfg, plan) -> int:
    """Bytes one sharded steal round gathers to a device: every worker's
    occupancy and its bottom ``steal_chunk`` entries (depth, mapping, used
    and candidate words)."""
    v, c = cfg.n_workers, cfg.steal_chunk
    used = plan.w if cfg.store_used else 1
    return 4 * (v + v * c * (1 + plan.p_pad + used + plan.w))


def _gate_equal(label, got, want) -> None:
    if mesh_counters(got) != mesh_counters(want):
        raise AssertionError(f"{label}: the sharded run differs from the unsharded one: "
                             f"{_counters(got)[:5]} != {_counters(want)[:5]}")


def mesh_dense(device, mesh_of, smi) -> dict:
    """10a: phase 3's target and six queries at each D through K1 and K2,
    each equal to the unsharded run; the deepest also edge-seeded at D = 2.
    Returns the launch counts."""
    from repro_torch.core import EngineConfig, Enumerator

    main = SHARED["main"]
    index, patterns = main["index"], main["patterns"]
    launches, rows = {}, []
    deepest = None
    for label, kw in (("pallas", dict(step_backend="pallas")),
                      ("jnp+use_pallas", dict(step_backend="jnp", use_pallas=True))):
        cfg = EngineConfig(**ENGINE_KW, **kw)
        base = Enumerator(index, config=cfg, variant=VARIANT, device=device)
        qs = [base.prepare(inst.pattern, name=inst.name) for inst in patterns]
        want = [base.run(q, collect_matches=MESH_COLLECT) for q in qs]
        if deepest is None:
            deepest = max(range(len(qs)), key=lambda i: want[i].states)
        for d in MESH_SHARDS:
            enum = Enumerator(index, config=cfg, variant=VARIANT, mesh=mesh_of(d))
            enum.run(qs[deepest])  # warm-up: the first use of the shards' ops
            got, counts = _launched(lambda: [enum.run(q, collect_matches=MESH_COLLECT)
                                             for q in qs])
            _add(launches, counts)
            for q, g, w in zip(qs, got, want):
                _gate_equal(f"10a {label} D={d} {q.name}", g, w)
            prof = profile_query(enum, qs[deepest]) if label == "pallas" else None
            rows.append(dict(path=label, shards=d, launches=counts,
                             steal_round_bytes=steal_round_bytes(enum.config, qs[deepest].plan),
                             match_s=[g.match_s for g in got],
                             unsharded_match_s=[w.match_s for w in want],
                             launches_per_step=None if prof is None
                             else prof.get("launches_per_step"), profile=prof))
    emit(dict(phase="mesh_dense", nvidia_smi=smi, query_names=[i.name for i in patterns],
              states=[w.states for w in want], steps=[w.steps for w in want],
              steals=[w.steals for w in want], runs=rows))

    inst = patterns[deepest]
    edge = {}
    for label, kw in (("edge pallas", dict(step_backend="pallas")),
                      ("edge jnp+use_pallas", dict(step_backend="jnp", use_pallas=True))):
        cfg = EngineConfig(**ENGINE_KW, **kw, root_seeding="edge")
        base = Enumerator(index, config=cfg, variant=VARIANT, device=device)
        q = base.prepare(inst.pattern, name=inst.name, seed_edge="auto")
        want = base.run(q, collect_matches=MESH_COLLECT)
        enum = Enumerator(index, config=cfg, variant=VARIANT, mesh=mesh_of(2))
        got, counts = _launched(lambda: enum.run(q, collect_matches=MESH_COLLECT))
        _add(launches, counts)
        _gate_equal(f"10a {label} D=2", got, want)
        edge[label] = dict(launches=counts, matches=got.matches, states=got.states,
                           steals=got.steals, match_s=got.match_s, unsharded_s=want.match_s)
    emit(dict(phase="mesh_dense_edge_seeded", query=inst.name, runs=edge))
    return launches


def mesh_sparse(device, mesh_of) -> dict:
    """10b: phase 5's target A queries at D = 2 through K7 and K6, and
    target B's hub query edge-seeded at D = 2 through both, each equal to
    the unsharded run.  Returns the launch counts."""
    from repro_torch.core import EngineConfig, Enumerator

    sparse, hub = SHARED["sparse"], SHARED["hub"]
    launches, rows = {}, []
    for walk in ("bucketed", "flat"):
        cfg = EngineConfig(**ENGINE_KW, step_backend="csr", use_pallas=True, csr_walk=walk)
        base = Enumerator(sparse["index"], config=cfg, variant=SPARSE_VARIANT, device=device)
        qs = [base.prepare(p, name=n) for p, n in zip(sparse["patterns"], sparse["names"])]
        want = [base.run(q, collect_matches=MESH_COLLECT) for q in qs]
        enum = Enumerator(sparse["index"], config=cfg, variant=SPARSE_VARIANT, mesh=mesh_of(2))
        got, counts = _launched(lambda: [enum.run(q, collect_matches=MESH_COLLECT)
                                         for q in qs])
        _add(launches, counts)
        for q, g, w in zip(qs, got, want):
            _gate_equal(f"10b target A {walk} {q.name}", g, w)
        rows.append(dict(target="A", walk=walk, shards=2, launches=counts,
                         states=[g.states for g in got], steps=[g.steps for g in got],
                         match_s=[g.match_s for g in got],
                         unsharded_match_s=[w.match_s for w in want]))
        cfg = EngineConfig(**ENGINE_KW, step_backend="csr", use_pallas=True, csr_walk=walk,
                           root_seeding="edge")
        base = Enumerator(hub["index"], config=cfg, variant=HUB_VARIANT, device=device)
        q = base.prepare(hub["pattern"], name=f"hub-edge/{walk}", seed_edge="auto")
        want = base.run(q, collect_matches=MESH_COLLECT)
        enum = Enumerator(hub["index"], config=cfg, variant=HUB_VARIANT, mesh=mesh_of(2))
        got, counts = _launched(lambda: enum.run(q, collect_matches=MESH_COLLECT))
        _add(launches, counts)
        _gate_equal(f"10b target B edge {walk}", got, want)
        rows.append(dict(target="B edge-seeded", walk=walk, shards=2, launches=counts,
                         states=got.states, steps=got.steps, steals=got.steals,
                         match_s=got.match_s, unsharded_match_s=want.match_s))
    emit(dict(phase="mesh_sparse", runs=rows))
    return launches


def mesh_outofcore(device, mesh_of) -> dict:
    """10c: phase 8's query at 2 partitions at D = 1 and 2 and under phase
    8's budget at D = 2, through K7 and K6: matches, states and sorted
    mappings equal the monolithic run's, and D = 1 equals the unsharded
    2-partition run on every counter and ``stats`` key.  Returns the
    launch counts."""
    from repro_torch.core import EngineConfig, Enumerator
    from repro_torch.core import engine as eng

    ooc = SHARED["ooc"]
    mono = Enumerator(ooc["index"], config=EngineConfig(**OOC_KW, step_backend="csr",
                                                        use_pallas=True), device=device)
    q = mono.prepare(ooc["pattern"], name="outofcore")
    whole = mono.run(q, collect_matches=MESH_OOC_COLLECT)
    maps = sorted(whole.mappings())
    if (whole.matches, whole.states) != (ooc["matches"], ooc["states"]) or len(maps) != whole.matches:
        raise AssertionError(f"10c: the monolithic run {(whole.matches, whole.states)} != "
                             f"phase 8's {(ooc['matches'], ooc['states'])}")
    launches, rows, results = {}, [], {}
    # the monolithic run sharded: phase 8's query steals, so the exchange
    # moves entries between shards
    for d in (2, 4):
        enum = Enumerator(ooc["index"], config=mono.config, mesh=mesh_of(d))
        got, counts = _launched(lambda: enum.run(q, collect_matches=MESH_OOC_COLLECT))
        _add(launches, counts)
        _gate_equal(f"10c monolithic D={d}", got, whole)
        rows.append(dict(run=f"monolithic D={d}", walk="bucketed", launches=counts,
                         matches=got.matches, states=got.states, steps=got.steps,
                         steals=got.steals, steal_rounds=got.steal_rounds,
                         match_s=got.match_s, unsharded_match_s=whole.match_s))

    def part_run(label, walk, mesh):
        cfg = EngineConfig(**OOC_KW, step_backend="partitioned", use_pallas=True, csr_walk=walk,
                           n_partitions=OOC_N_PARTS, collect_matches=MESH_OOC_COLLECT)
        stats = {}
        _sync(device)
        t0 = time.perf_counter()
        r, counts = _launched(lambda: eng.run_partitioned(q.plan, cfg, mesh=mesh, device=device,
                                                          stats=stats))
        _sync(device)
        return r, stats, counts, time.perf_counter() - t0

    for label, walk, d in (("unsharded", "bucketed", None), ("D=1", "bucketed", 1),
                           ("D=2", "bucketed", 2), ("D=2 flat", "flat", 2)):
        r, stats, counts, secs = part_run(label, walk, None if d is None else mesh_of(d))
        _add(launches, counts)
        results[label] = (r, stats)
        got = sorted(tuple(int(x) for x in row[:whole.plan.n_p])
                     for row in r.match_buf.reshape(-1, r.match_buf.shape[-1])
                     if (row[:whole.plan.n_p] >= 0).all())
        if (r.matches, r.states) != (whole.matches, whole.states) or got != maps:
            raise AssertionError(f"10c {OOC_N_PARTS} partitions {label}: "
                                 f"{(r.matches, r.states)} != {(whole.matches, whole.states)}")
        rows.append(dict(run=f"{OOC_N_PARTS} partitions {label}", walk=walk, launches=counts,
                         matches=r.matches, states=r.states, steps=r.steps, steals=r.steals,
                         steal_rounds=r.steal_rounds, stats=stats, seconds=secs))
    r1, s1 = results["D=1"]
    r0, s0 = results["unsharded"]
    if _counters_of(r1) != _counters_of(r0) or s1 != s0:
        raise AssertionError("10c: D = 1 differs from the unsharded 2-partition run")
    for walk in ("bucketed", "flat"):
        enum = Enumerator(ooc["index"], config=EngineConfig(**OOC_KW, use_pallas=True,
                                                            csr_walk=walk),
                          memory_budget_bytes=ooc["budget"], mesh=mesh_of(2))
        qb = enum.prepare(ooc["pattern"], name="outofcore-budget")
        _sync(device)
        t0 = time.perf_counter()
        ms, counts = _launched(lambda: enum.run(qb, collect_matches=MESH_OOC_COLLECT))
        _sync(device)
        secs = time.perf_counter() - t0
        _add(launches, counts)
        if (ms.matches, ms.states) != (whole.matches, whole.states) or sorted(
                ms.mappings()) != maps:
            raise AssertionError(f"10c budget {walk} D=2: {(ms.matches, ms.states)}")
        rows.append(dict(run=f"budget {walk} D=2", walk=walk, launches=counts,
                         matches=ms.matches, states=ms.states, steps=ms.steps, steals=ms.steals,
                         seconds=secs))
    emit(dict(phase="mesh_outofcore", monolithic=dict(matches=whole.matches,
                                                      states=whole.states), runs=rows))
    return launches


def _counters_of(r):
    return (r.matches, r.states, r.steps, r.steals, r.steal_rounds,
            r.per_worker_states.tolist(), r.per_worker_matches.tolist(),
            r.per_worker_steals.tolist())


def mesh_dynamic(device, mesh_of) -> dict:
    """10d: phase 7's rule pattern through phase 7's first 1 % edit,
    maintained by ``run_delta`` through K2 at D = 2 beside the unsharded
    maintainer: the added and removed mappings must be equal.  Returns the
    launch counts."""
    from repro_torch.core import EngineConfig, Enumerator

    dyn = SHARED["dyn"]
    adds, rems = dyn["edit"]
    new_index, delta = dyn["index"].update(add_edges=adds, remove_edges=rems)
    cfg = EngineConfig(**ENGINE_KW, step_backend="jnp", use_pallas=True)
    out, launches = {}, {}
    for label, mesh in (("unsharded", None), ("D=2", mesh_of(2))):
        enum = Enumerator(dyn["index"], config=cfg, variant=VARIANT, mesh=mesh, device=device)
        q = enum.prepare(dyn["pattern"], index=new_index)
        _sync(device)
        t0 = time.perf_counter()
        dm, counts = _launched(lambda: enum.run_delta(q, dyn["cur"], delta))
        _sync(device)
        _add(launches, counts)
        out[label] = dict(dm=dm, launches=counts, run_delta_s=time.perf_counter() - t0)
    a, b = out["unsharded"]["dm"], out["D=2"]["dm"]
    if (sorted(a.added), sorted(a.removed)) != (sorted(b.added), sorted(b.removed)):
        raise AssertionError("10d: the sharded run_delta differs from the unsharded one")
    emit(dict(phase="mesh_dynamic", arcs=len(adds) + len(rems),
              runs={k: dict(added=len(v["dm"].added), removed=len(v["dm"].removed),
                            states=v["dm"].states, seeds=v["dm"].n_seeds,
                            anchors=v["dm"].n_anchors, launches=v["launches"],
                            run_delta_s=v["run_delta_s"]) for k, v in out.items()}))
    return launches


_DRIVER_LINE = re.compile(r"^(\S+)\s+matches=(\d+)\s+states=(\d+)\s+steps=(\d+)")
_DRIVER_STEALS = re.compile(r"^(\S+)\s+matches=\d+\s+states=\d+\s+steps=\d+\s+steals=(\d+)")
_DRIVER_MESH = re.compile(r"entries stolen into each device: (.*)$", re.M)


def run_driver(argv) -> tuple:
    """``repro_torch.launch.sge_run.main(argv)`` with its standard output
    captured: the per-query ``(matches, states, steps)``, the output, the
    seconds and the launch counts."""
    import io

    from repro_torch.launch import sge_run

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, counts = _launched(lambda: sge_run.main(argv))
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"sge_run {argv} exited {rc}")
    out = buf.getvalue()
    per_query = {}
    for line in out.splitlines():
        m = _DRIVER_LINE.match(line)
        if m:
            per_query[m.group(1)] = tuple(int(x) for x in m.groups()[1:])
    return per_query, out, secs, counts


def mesh_driver(device) -> dict:
    """10e: the paper's driver on the card: PDBSv1's largest targets
    CSR-only through K8 and K3 (preparation) and K7 in each mode, a dense
    K1 run with and without ``--devices 1``, each query equal across modes
    and to a standalone session run, and ``--devices`` past the card count
    refused.  Returns the launch counts."""
    import functools

    import torch

    from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
    from repro_torch.data import graphgen

    launches, rows = {}, []
    make = graphgen.make_collection
    # each driver call draws the same collection: draw it once
    graphgen.make_collection = functools.lru_cache(maxsize=4)(make)
    try:
        by_run = {}
        for label, argv in (("sparse single", MESH_DRIVER_SPARSE + ["--mode", "single"]),
                            ("sparse packed", MESH_DRIVER_SPARSE + ["--mode", "packed"]),
                            ("sparse stream", MESH_DRIVER_SPARSE + ["--mode", "stream"]),
                            ("dense", MESH_DRIVER_DENSE),
                            ("dense --devices 1", MESH_DRIVER_DENSE + ["--devices", "1"])):
            per_query, out, secs, counts = run_driver(argv + ["--device", str(device)])
            _add(launches, counts)
            by_run[label] = per_query
            rows.append(dict(run=label, queries=len(per_query), seconds=secs, launches=counts,
                             totals=out.strip().splitlines()[-1]))
            kernels = (("csr_arc_sweep", "popcount_rows", "csr_extend_bucketed")
                       if label.startswith("sparse") else ("extend_step",))
            if not per_query or not all(counts.get(k) for k in kernels):
                raise AssertionError(f"10e {label}: {len(per_query)} queries, launches {counts}")
    finally:
        graphgen.make_collection = make
    # standalone session runs of the sparse queries (the driver's defaults:
    # 16 workers of expand width 4) on a draw of their own, which no driver
    # run has touched
    insts = graphgen.make_collection("pdbsv1-like", pattern_edges=(8, 16, 24),
                                     patterns_per_target=2, scale=MESH_DRIVER_SCALE, seed=7)
    enum = Enumerator(config=EngineConfig(n_workers=16, expand_width=4, step_backend="csr",
                                          use_pallas=True),
                      variant=SPARSE_VARIANT, device=device)
    indices, standalone = {}, {}
    for inst in insts:
        idx = indices.get(id(inst.target))
        if idx is None:
            idx = indices[id(inst.target)] = SubgraphIndex.build(inst.target, sparse=True)
        ms = enum.run(enum.prepare(inst.pattern, name=inst.name, index=idx))
        standalone[inst.name] = (ms.matches, ms.states, ms.steps)
    for label in ("sparse single", "sparse packed", "sparse stream"):
        if by_run[label] != standalone:
            raise AssertionError(f"10e {label}: the driver's queries != standalone runs")
    if by_run["dense"] != by_run["dense --devices 1"]:
        raise AssertionError("10e: --devices 1 differs from the unsharded dense run")
    count = torch.cuda.device_count()
    try:
        run_driver(MESH_DRIVER_DENSE + ["--devices", str(count + 1)])
    except SystemExit as e:
        refused = str(e)
    else:
        raise AssertionError(f"10e: --devices {count + 1} was not refused")
    if f"only {count} CUDA card" not in refused:
        raise AssertionError(f"10e: the refusal does not name the card count: {refused!r}")
    emit(dict(phase="mesh_driver", runs=rows, refused=refused,
              standalone_queries=len(standalone)))
    return launches


def mesh_multi_card(device, smi: str) -> dict:
    """Worker stacks over real cards (two or more): phase 3's queries
    through K1 over ``D`` cards (2, and 4 where there are four), each equal
    to the unsharded run and to ``D`` shards on one card, and phase 8's
    query at 2 partitions over two cards through K7, equal to two shards
    on one card on every counter and ``stats`` key, and monolithic through
    K7 over 2 (and 4) cards, equal to the unsharded run (this query
    steals, so entries cross cards), and the driver over 2 (and 4) cards
    (:func:`mesh_multi_card_driver`).  Prints each query's seconds on
    cards, on one card and unsharded.  Returns the launch counts."""
    import torch

    from repro_torch.core import EngineConfig, Enumerator
    from repro_torch.core import engine as eng

    count = torch.cuda.device_count()
    main, ooc = SHARED["main"], SHARED["ooc"]
    cards = [torch.device("cuda", i) for i in range(count)]
    cfg = EngineConfig(**ENGINE_KW, step_backend="pallas")
    base = Enumerator(main["index"], config=cfg, variant=VARIANT, device=device)
    qs = [base.prepare(inst.pattern, name=inst.name) for inst in main["patterns"]]
    for q in qs:  # warm-up
        base.run(q)
    want = [base.run(q, collect_matches=MESH_COLLECT) for q in qs]
    launches, rows = {}, []
    for d in [d for d in (2, 4) if d <= count]:
        got = {}
        for label, mesh in (("cards", eng.Mesh(tuple(cards[:d]))),
                            ("one card", eng.Mesh((device,) * d))):
            enum = Enumerator(main["index"], config=cfg, variant=VARIANT, mesh=mesh)
            enum.run(qs[0])  # warm-up: the first use of each card's ops
            got[label], counts = _launched(lambda: [enum.run(q, collect_matches=MESH_COLLECT)
                                                    for q in qs])
            _add(launches, counts)
            for q, g, w in zip(qs, got[label], want):
                _gate_equal(f"multi-card {label} D={d} {q.name}", g, w)
        rows.append(dict(shards=d, steals=[w.steals for w in want],
                         cards_match_s=[g.match_s for g in got["cards"]],
                         one_card_match_s=[g.match_s for g in got["one card"]],
                         unsharded_match_s=[w.match_s for w in want]))

    mono = Enumerator(ooc["index"], config=EngineConfig(**OOC_KW, step_backend="csr",
                                                        use_pallas=True), device=device)
    oq = mono.prepare(ooc["pattern"], name="outofcore")
    plan = oq.plan
    mono.run(oq)  # warm-up
    owant = mono.run(oq, collect_matches=MESH_OOC_COLLECT)
    csr_rows = []
    for d in [d for d in (2, 4) if d <= count]:
        enum = Enumerator(ooc["index"], config=mono.config, mesh=eng.Mesh(tuple(cards[:d])))
        enum.run(oq)  # warm-up
        got, counts = _launched(lambda: enum.run(oq, collect_matches=MESH_OOC_COLLECT))
        _add(launches, counts)
        _gate_equal(f"multi-card csr D={d}", got, owant)
        csr_rows.append(dict(shards=d, steals=got.steals, steal_rounds=got.steal_rounds,
                             cards_match_s=got.match_s, unsharded_match_s=owant.match_s))
    pcfg = EngineConfig(**OOC_KW, step_backend="partitioned", use_pallas=True,
                        n_partitions=OOC_N_PARTS, collect_matches=MESH_OOC_COLLECT)
    part = {}
    for label, mesh in (("cards", eng.Mesh(tuple(cards[:2]))),
                        ("one card", eng.Mesh((device, device)))):
        stats = {}
        _sync(device)
        t0 = time.perf_counter()
        r, counts = _launched(lambda: eng.run_partitioned(plan, pcfg, mesh=mesh, stats=stats))
        _sync(device)
        _add(launches, counts)
        part[label] = (r, stats, time.perf_counter() - t0)
    (r2, s2, t2), (r1, s1, t1) = part["cards"], part["one card"]
    if _counters_of(r2) != _counters_of(r1) or s2 != s1 \
            or r2.match_buf.tolist() != r1.match_buf.tolist():
        raise AssertionError("the partitioned run over two cards differs from two shards on one")
    driver = mesh_multi_card_driver(device, count, launches)
    if not (launches.get("extend_step") and launches.get("csr_extend_bucketed")):
        raise AssertionError(f"the multi-card runs launched {launches}")
    emit(dict(phase="mesh_multi_card", ran=True, count=count, nvidia_smi=smi,
              query_names=[q.name for q in qs], dense=rows, csr=csr_rows,
              partitioned=dict(matches=r2.matches, states=r2.states, steps=r2.steps,
                               steals=r2.steals, cards_s=t2, one_card_s=t1),
              driver=driver, launches={k: v for k, v in launches.items() if v}))
    return launches


def mesh_multi_card_driver(device, count: int, launches: dict) -> list:
    """The paper's driver over real cards: the dense K1 run of 10e with
    ``--devices 1`` and with ``--devices D`` (2, and 4 where there are
    four), each query's matches, states, steps and steals equal, and the
    entries stolen into the cards summing to the one-device total (this
    collection steals).  Adds its launches to ``launches``; returns a row
    per run."""
    def steals_of(out):
        per_query = {m.group(1): int(m.group(2))
                     for m in map(_DRIVER_STEALS.match, out.splitlines()) if m}
        per_dev = [int(x.split("=")[1]) for x in _DRIVER_MESH.search(out).group(1).split()]
        return per_query, per_dev

    rows, want = [], None
    for d in [d for d in (1, 2, 4) if d <= count]:
        per_query, out, secs, counts = run_driver(MESH_DRIVER_DENSE
                                                  + ["--devices", str(d), "--device", str(device)])
        _add(launches, counts)
        q_steals, per_dev = steals_of(out)
        rows.append(dict(devices=d, queries=len(per_query), seconds=secs,
                         steals_into_device=per_dev, launches={k: v for k, v in counts.items() if v}))
        if not counts.get("extend_step") or len(per_dev) != d:
            raise AssertionError(f"driver --devices {d}: launches {counts}, devices {per_dev}")
        got = (per_query, q_steals, sum(per_dev))
        if want is None:
            want = got
            if not per_query or not want[2] or want[2] != sum(q_steals.values()):
                raise AssertionError(f"driver --devices 1: {len(per_query)} queries, "
                                     f"{want[2]} entries stolen, per query {q_steals}")
        elif got != want:
            raise AssertionError(f"driver --devices {d} over cards differs from --devices 1")
    return rows


def multi_card_main(device, smi: str) -> int:
    """``python3 chip_smoke.py --multi-card``: on a machine with two cards
    or more, the kernel build and :func:`mesh_multi_card` alone (phase 3's
    and phase 8's targets built for it), ending in ``{"ok": true, ...}``."""
    import torch

    from repro_torch.core import SubgraphIndex
    from repro_torch.data import graphgen

    count = torch.cuda.device_count()
    if count < 2:
        print(f"chip_smoke: --multi-card needs two cards or more, found {count}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    target, index, patterns = main_target()
    SHARED["main"] = dict(target=target, index=index, patterns=patterns)
    ooc = graphgen.power_law_graph(OOC["n"], avg_deg=OOC["avg_deg"], n_labels=OOC["n_labels"],
                                   seed=OOC["seed"])
    SHARED["ooc"] = dict(index=SubgraphIndex.build(ooc, sparse=True),
                         pattern=graphgen.extract_pattern(ooc, OOC_PATTERN_EDGES,
                                                          seed=OOC["seed"]))
    emit(dict(phase="multi_card_setup", count=count, setup_s=time.perf_counter() - t0))
    mesh_multi_card(device, smi)
    for line in subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines():
        print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": count}})
    return 0


def run_mesh_path(device, smi: str) -> dict:
    """Phase 10: multi-device work stealing (10a–10d) and the paper's
    driver (10e), reusing the targets and queries of phases 3, 5, 7 and 8.
    Returns the launch counts of its runs, per kernel."""
    import torch

    from repro_torch.core import Enumerator
    from repro_torch.core import engine as eng

    t_phase = time.perf_counter()

    def mesh_of(d):
        return eng.Mesh((device,) * d)

    total = {}
    parts = {}
    for name, fn in (("10a", lambda: mesh_dense(device, mesh_of, smi)),
                     ("10b", lambda: mesh_sparse(device, mesh_of)),
                     ("10c", lambda: mesh_outofcore(device, mesh_of)),
                     ("10d", lambda: mesh_dynamic(device, mesh_of)),
                     ("10e", lambda: mesh_driver(device))):
        t0 = time.perf_counter()
        parts[name] = dict(launches=fn(), seconds=time.perf_counter() - t0)
        _add(total, parts[name]["launches"])
    need = {"10a": ("extend_step", "candidate_mask"), "10b": ("csr_extend", "csr_extend_bucketed"),
            "10c": ("csr_extend", "csr_extend_bucketed"), "10d": ("candidate_mask",),
            "10e": ("csr_arc_sweep", "popcount_rows", "csr_extend_bucketed", "extend_step")}
    for name, kernels in need.items():
        for k in kernels:
            if not parts[name]["launches"].get(k):
                raise AssertionError(f"phase {name} never launched {k}")

    count = torch.cuda.device_count()
    if count >= 2:
        _add(total, mesh_multi_card(device, smi))
    else:
        emit(dict(phase="mesh_multi_card", ran=False, count=count))
    try:
        Enumerator(SHARED["main"]["index"], mesh=count + 1)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"Enumerator(mesh={count + 1}) was not refused")
    emit(dict(phase="mesh_done", nvidia_smi=smi, refused=refused,
              parts={k: dict(seconds=v["seconds"],
                             launches={n: c for n, c in v["launches"].items() if c})
                     for k, v in parts.items()},
              mesh_path_s=time.perf_counter() - t_phase))
    return total


# ---------------------------------------------------------------------------
# phase 11: the LM family (MoE and sliding-window attention)
# ---------------------------------------------------------------------------

def _depth_tied(params, cfg, n: int):
    """:func:`_depth`, or, for a model of one loaded layer, ``n`` layers that
    all are that layer (views: no copy of its weights)."""
    import dataclasses

    if n <= cfg.n_layers:
        return _depth(params, cfg, n)
    if cfg.n_layers != 1:
        raise ValueError(f"cannot tie {cfg.n_layers} layers into {n}")
    return (dict(params, layers={k: w.expand(n, *w.shape[1:])
                                 for k, w in params["layers"].items()}),
            dataclasses.replace(cfg, n_layers=n))


def _fp32_activations(params):
    """A MoE model's parameters for an fp32 run over the same values: every
    weight but the routed experts' cast to fp32 (``moe_ffn`` casts each
    expert's weights to the activation dtype as it uses them)."""
    return dict(params, layers={k: w if k.startswith("we_") else w.float()
                                for k, w in params["layers"].items()})


def moe_decode_vs_prefill(params, cfg, toks, n: int, tol: float, gate="elementwise") -> dict:
    """:func:`decode_vs_prefill` for a MoE model, with the experts that each
    layer routes the decoded position to in both runs.  Routing is a
    discontinuous function of the layer's input: where rounding moves the
    router's top-k set, the two runs compute different functions, so the
    gate holds only where every layer's sets agree (``routing_equal``)."""
    from repro_torch.models import moe as moe_mod

    sets = []
    inner = moe_mod.moe_ffn

    def recording(x, router_w, *w, **kw):
        sets.append(moe_mod.route(x, router_w, w[-1])[2].sort(dim=1).values)
        return inner(x, router_w, *w, **kw)

    moe_mod.moe_ffn = recording
    try:
        res = decode_vs_prefill(params, cfg, toks, n, tol, gate=gate)
    finally:
        moe_mod.moe_ffn = inner
    layers, b = cfg.n_layers, int(toks.shape[0])
    full, step = sets[:layers], sets[2 * layers:]
    differ = [int((f.view(b, n + 1, -1)[:, n] != st).any(dim=1).sum())
              for f, st in zip(full, step)]
    res.update(routing_equal=not any(differ), positions_rerouted_per_layer=differ)
    if not res["routing_equal"]:
        res["ok"] = None  # measured, not gated: the two runs routed apart
    return res


def moe_layer_case(out, ref, disp, t: int, k: int, tol: float) -> dict:
    """A MoE layer's bf16 output against the same function in fp32, and its
    dispatch: pairs dropped and the largest (group, expert) counts against
    the capacity ``C``."""
    d = (out.float() - ref).abs()
    routed = disp.routed
    return dict(moe_mismatches=int((d > tol + tol * ref.abs()).sum()), moe_err=float(d.max()),
                rel_l2=float((out.float() - ref).norm() / ref.norm()), tol=tol,
                tokens=t, pairs=t * k, kept=int(disp.pairs.numel()),
                dropped_share=1.0 - disp.pairs.numel() / (t * k), groups=int(routed.shape[0]),
                capacity=disp.capacity, max_routed=int(routed.max()),
                max_kept=int(routed.clamp(max=disp.capacity).max()),
                experts_with_rows=int((disp.counts > 0).sum()))


def serve_family_model(device, smi: str, name: str) -> tuple:
    """One model of phase 11 serves ``LMF_MODELS[name]`` (layers kept, batch,
    decode steps): a prefill of ``LMF_PROMPT``-token prompts timed with the
    launch counts, a second prefill that must give bit-identical logits and
    cache, greedy decode steps, profiles of a prefill and a decode step; then
    a checked prefill (every K9 call against its plain version, every MoE
    layer against itself in fp32 with its dispatch printed) and, for MoE,
    decode against prefill at depth 1 and 2 with a capacity that drops
    nothing.  Returns (launch counts, check cases, K9 timing on layer 0's
    q/k/v or None)."""
    import dataclasses
    import importlib

    import torch

    from repro_torch.configs import lm_common
    from repro_torch.data import graphgen
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    full = LMF_CFGS.get(name) or importlib.import_module(f"repro_torch.configs.{name}").CFG
    depth, b, n_dec = LMF_MODELS[name]
    cfg = dataclasses.replace(full, n_layers=depth) if depth else full
    s = LMF_PROMPT
    max_len = s + n_dec
    reduced = ([f"layers {full.n_layers} -> {cfg.n_layers} (full width)"]
               if cfg.n_layers < full.n_layers else []) + [
        f"prefill batch {lm_common.PREFILL_SHAPE['batch']} -> {b}, "
        f"seq {lm_common.PREFILL_SHAPE['seq']} -> {s} (PREFILL_SHAPE)",
        f"decode batch {lm_common.DECODE_SHAPE['batch']} -> {b}, "
        f"cache {lm_common.DECODE_SHAPE['seq']} -> {max_len} (DECODE_SHAPE)",
        f"random weights (seed {LM_SEED}), random prompts (lm_batch seed {LM_TOKEN_SEED})"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    held_gb = torch.cuda.memory_allocated(device) / 1e9
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=LM_SEED, device=device)
    torch.cuda.synchronize(device)
    weights = [params["embed"], params["final_norm"], params["lm_head"],
               *params["layers"].values()]
    emit(dict(phase="lm_family_setup", model=cfg.name, n_layers=cfg.n_layers,
              d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, d_ff=cfg.d_ff, activation=cfg.activation,
              moe=dataclasses.asdict(cfg.moe) if cfg.moe else None, vocab=cfg.vocab_size,
              dtype=str(cfg.dtype), params=cfg.param_count(),
              active_params=cfg.active_param_count(), n_active=lm_common.n_active(cfg),
              weights_gb=sum(w.numel() * w.element_size() for w in weights) / 1e9,
              embeddings_gb=sum(params[k].numel() * params[k].element_size()
                                for k in ("embed", "lm_head")) / 1e9,
              held_before_gb=held_gb, init_s=time.perf_counter() - t0,
              init_peak_gb=torch.cuda.max_memory_allocated(device) / 1e9, batch=b, prompt=s,
              decode_steps=n_dec, max_len=max_len, reduced=reduced, nvidia_smi=smi))
    del weights
    toks = torch.from_numpy(graphgen.lm_batch(b, s, cfg.vocab_size, seed=LM_TOKEN_SEED)
                            ["tokens"]).to(device)

    served = serve_lm(params, cfg, toks, n_dec, device)
    emit(dict(phase="lm_family_path", model=cfg.name, **served, nvidia_smi=smi))
    prefill_counts, decode_counts = served["prefill_launches"], served["decode_launches"]

    # a checked prefill: K9 on every layer's own q/k/v, every MoE layer in fp32
    k9_layers, moe_layers, first = [], [], {}
    flash, moe_ffn = ops.flash_attention, moe_mod.moe_ffn

    def checked_flash(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        k9_layers.append(k9_case(out, q, k, v, LMF_TOL, chunk=LM_HEAD_CHUNK))
        first.setdefault("qkv", (q, k, v))
        return out

    def checked_moe(x, router_w, w_gate, w_up, w_down, mcfg):
        out, aux = moe_ffn(x, router_w, w_gate, w_up, w_down, mcfg)
        ref, _ = moe_ffn(x.float(), router_w, w_gate, w_up, w_down, mcfg)
        disp = moe_mod.dispatch(moe_mod.route(x, router_w, mcfg)[2], mcfg)
        moe_layers.append(moe_layer_case(out, ref, disp, x.shape[0], mcfg.top_k, LMF_TOL))
        return out, aux

    ops.flash_attention, moe_mod.moe_ffn = checked_flash, checked_moe
    try:
        tf.prefill(params, cfg, toks, max_len=max_len)
    finally:
        ops.flash_attention, moe_mod.moe_ffn = flash, moe_ffn
    timing = k9_timing(*first.pop("qkv")) if cfg.head_dim in LMF_K9_TIMED else None
    cases = [dict(c, layer=i, kind="lm_family_layer", model=cfg.name)
             for i, c in enumerate(k9_layers)]
    # decode against prefill with a capacity that drops nothing, at depth 1
    # and 2: bf16 (gated where both runs route alike), then fp32 activations
    # over the same weight values (gated: rounding then moves no router)
    dvp = []
    if cfg.moe:
        m = cfg.moe
        drop_free = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        for dtype, p in ((cfg.dtype, params), (torch.float32, _fp32_activations(params))):
            c = dataclasses.replace(drop_free, dtype=dtype)
            for depth, gate in ((1, "elementwise"), (2, "rel_l2" if dtype != torch.float32
                                                     else "elementwise")):
                res = moe_decode_vs_prefill(*_depth_tied(p, c, depth), toks, LM_CHECK_PROMPT,
                                            LMF_TOL, gate=gate)
                if dtype == torch.float32 and not res["routing_equal"]:
                    res["ok"] = False
                dvp.append(dict(res, capacity_factor=m.n_experts / m.top_k,
                                tied_layers=depth > cfg.n_layers))
            del p
    emit(dict(phase="lm_family_checks", model=cfg.name, nvidia_smi=smi,
              k9_per_layer=[{k: c[k] for k in ("flash_attention_err", "rel_l2", "worst_over_tol")}
                            for c in cases],
              moe_per_layer=moe_layers, decode_vs_prefill=dvp, k9_timing=timing))
    del params, toks, first
    torch.cuda.empty_cache()
    bad = [c for c in cases if c["flash_attention_mismatches"]]
    if bad:
        raise AssertionError(f"{cfg.name}: K9 disagrees with its plain version: {bad}")
    if len(k9_layers) != cfg.n_layers or len(moe_layers) != (cfg.n_layers if cfg.moe else 0):
        raise AssertionError(f"{cfg.name}: checked {len(k9_layers)} K9 calls and "
                             f"{len(moe_layers)} MoE layers of {cfg.n_layers}")
    bad = [c for c in moe_layers if c["moe_mismatches"]]
    if bad:
        raise AssertionError(f"{cfg.name}: a MoE layer disagrees with itself in fp32: {bad}")
    bad = [c for c in dvp if c["ok"] is False]
    if bad:
        raise AssertionError(f"{cfg.name}: decode disagrees with prefill: {bad}")
    return dict(prefill=prefill_counts, decode=decode_counts), cases, timing


def windowed_reference(q, k, v, window: int, heads: int):
    """Sliding-window attention as an fp32 dense masked softmax, ``heads``
    query heads at a time: query ``i`` sees keys ``i - window`` to ``i``."""
    import torch

    b, s, h, dh = q.shape
    g = h // k.shape[2]
    pos = torch.arange(s, device=q.device)
    rel = pos[:, None] - pos[None, :]
    mask = (rel >= 0) & (rel <= window)
    out = torch.empty(b, s, h, dh, dtype=torch.float32, device=q.device)
    for h0 in range(0, h, heads):
        idx = torch.arange(h0, min(h0 + heads, h), device=q.device)
        qh = q[:, :, idx].float()
        kh, vh = k[:, :, idx // g].float(), v[:, :, idx // g].float()
        sc = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / dh ** 0.5
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, idx] = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out


def run_window(device, smi: str) -> dict:
    """Phase 11's sliding window: ``overrides.apply(stablelm_12b.CFG,
    LMF_WINDOW)`` runs ``forward`` over one prompt of ``LMF_WINDOW_SEQ``
    tokens (timed).  Gates: with the window widened to the sequence,
    ``forward`` equals the full causal ``forward`` (bf16 at one layer,
    ``LMF_TOL`` in relative L2; each layer from the same input, in bf16
    within ``LMF_TOL`` and with fp32 activations within 1e-4 of the layer's
    largest output; both at full depth end to end are printed);
    layer 0's ``windowed_attention`` equals an fp32 dense masked softmax of
    the same q/k/v (elementwise ``LMF_TOL``); no kernel launches."""
    import dataclasses

    import torch

    from repro_torch.configs import overrides, stablelm_12b
    from repro_torch.data import graphgen
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    base = LMF_CFGS.get("stablelm_12b") or stablelm_12b.CFG
    cfg = overrides.apply(base, LMF_WINDOW)
    s = LMF_WINDOW_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    params = tf.init_params(cfg, seed=LM_SEED, device=device)
    toks = torch.from_numpy(graphgen.lm_batch(1, s, cfg.vocab_size, seed=LM_TOKEN_SEED)
                            ["tokens"]).to(device)
    captured = {}
    windowed = tf.windowed_attention

    def capture(q, k, v, **kw):
        out = windowed(q, k, v, **kw)
        captured.setdefault("layer0", (q, k, v, out))
        return out

    tf.windowed_attention = capture
    try:
        tf.forward(params, cfg, toks)  # warm-up
        torch.cuda.synchronize(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hidden, _ = tf.forward(params, cfg, toks)
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        tf.windowed_attention = windowed
    finite = bool(hidden.isfinite().all())
    del hidden
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tf.forward(params, dataclasses.replace(cfg, attn_window=0), toks)
    torch.cuda.synchronize(device)
    causal_s = time.perf_counter() - t0

    def widened_vs_causal(p, c, gate):
        """``forward`` with the window widened to S against the full causal
        ``forward`` (``windowed_attention`` against ``blockwise_attention``)."""
        widened, _ = tf.forward(p, dataclasses.replace(c, attn_window=s), toks)
        causal, _ = tf.forward(p, dataclasses.replace(c, attn_window=0), toks)
        d = (widened.float() - causal.float()).abs()
        res = dict(layers=c.n_layers, dtype=str(c.dtype), gate=gate, tol=LMF_TOL,
                   rel_l2=float(d.norm() / causal.float().norm()), max_abs_err=float(d.max()),
                   mismatches=int((d > LMF_TOL + LMF_TOL * causal.float().abs()).sum()),
                   finite=bool(widened.isfinite().all() and causal.isfinite().all()))
        res["ok"] = res["finite"] and (gate is None or res["rel_l2"] <= LMF_TOL)
        return res

    def widened_per_layer(p, c, tol):
        """Each layer run once windowed (window widened to S) and once
        causal from the same input, the causal output feeding the next: the
        largest difference over the layer's largest output must stay within
        ``tol``, so a difference cannot grow through later layers."""
        h = tf._embed(p, c, toks)
        pos = torch.arange(s, device=h.device).expand(1, s)
        errs = []
        for i in range(c.n_layers):
            lp = tf.layer_params(p, i)
            win, _, _ = tf._layer(dataclasses.replace(c, attn_window=s), h, lp, pos)
            h, _, _ = tf._layer(dataclasses.replace(c, attn_window=0), h, lp, pos)
            errs.append(float((win.float() - h.float()).abs().max() / h.float().abs().max()))
        return dict(layers=c.n_layers, dtype=str(c.dtype), gate="per_layer", tol=tol,
                    err_over_scale=errs, ok=max(errs) <= tol)

    # bf16 and fp32 activations over the same weight values: one layer of
    # forward and each layer from the same input gated (phase 6's per-layer
    # tolerances), forward at full depth measured: at random init attention
    # is nearly one-hot (scores of std ~160), so rounding that moves a
    # near-tie grows layer over layer, as in phase 6's deeper decode runs
    widen = [widened_vs_causal(*_depth(params, cfg, 1), "rel_l2"),
             widened_vs_causal(params, cfg, None), widened_per_layer(params, cfg, LMF_TOL)]
    params = dict(params, layers={k: w.float() for k, w in params["layers"].items()})
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    widen += [widened_vs_causal(params, cfg32, None), widened_per_layer(params, cfg32, 1e-4)]
    widen[1]["finite"] = widen[1]["finite"] and finite
    q, k, v, out = captured.pop("layer0")
    ref = windowed_reference(q, k, v, cfg.attn_window, LMF_WINDOW_HEADS)
    d = (out.float() - ref).abs()
    layer0 = dict(mismatches=int((d > LMF_TOL + LMF_TOL * ref.abs()).sum()),
                  max_abs_err=float(d.max()), rel_l2=float((out.float() - ref).norm() / ref.norm()),
                  tol=LMF_TOL, shape=list(q.shape), kv_heads=int(k.shape[2]))
    res = dict(phase="lm_family_window", model=cfg.name, overrides=LMF_WINDOW,
               n_layers=cfg.n_layers, attn_window=cfg.attn_window, seq=s,
               reduced=[f"layers {base.n_layers} -> {cfg.n_layers} (repro's overrides example)",
                        f"one prompt of {s} tokens", f"random weights (seed {LM_SEED})"],
               forward_s=window_s, forward_tokens_per_s=s / window_s, causal_forward_s=causal_s,
               launches=counts, widened_vs_causal=widen, layer0_vs_dense_fp32=layer0,
               peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9, nvidia_smi=smi)
    emit(res)
    del params, q, k, v, out, ref
    torch.cuda.empty_cache()
    if any(c["ok"] is False for c in widen):
        raise AssertionError(f"windowed forward with window >= S != causal forward: {widen}")
    if layer0["mismatches"]:
        raise AssertionError(f"windowed_attention != the dense masked softmax: {layer0}")
    if any(counts.values()):
        raise AssertionError(f"the windowed forward launched kernels: {counts}")
    return res


def run_lm_family_path(device, smi: str) -> tuple:
    """Phase 11: each model of ``LMF_MODELS`` served in turn (its weights
    freed before the next loads), then the sliding window.  Returns the K9
    launches of the served prefills, the check cases and the K9 timings at
    the head widths of ``LMF_K9_TIMED``."""
    t_phase = time.perf_counter()
    launches, cases, timing = 0, [], {}
    for name in LMF_MODELS:
        t0 = time.perf_counter()
        counts, model_cases, t = serve_family_model(device, smi, name)
        launches += counts["prefill"]["flash_attention"] + counts["decode"]["flash_attention"]
        cases += model_cases
        if t is not None:
            timing[f"head_dim_{t['shape'][-1]}"] = t
        emit(dict(phase="lm_family_model_done", model=name, seconds=time.perf_counter() - t0))
    run_window(device, smi)
    emit(dict(phase="lm_family_done", k9_launches=launches, nvidia_smi=smi,
              lm_family_path_s=time.perf_counter() - t_phase))
    return launches, cases, timing


# ---------------------------------------------------------------------------
# phase 12: the training path (loss_fn, AdamW, TrainLoop, checkpoints, driver)
# ---------------------------------------------------------------------------

class RecordingStep:
    """A ``TrainStep`` whose metrics (as floats) are kept, step by step."""

    def __init__(self, step):
        self.step, self.metrics = step, []

    def grads(self, params, batch):
        return self.step.grads(params, batch)

    def apply(self, params, opt_state, grads, metrics):
        out = self.step.apply(params, opt_state, grads, metrics)
        self.metrics.append({k: float(v) for k, v in out[2].items()})
        return out


def _train_batches(cfg, batch: int, seq: int, accum: int, device):
    from repro_torch.launch.train import lm_data_iterator

    for b in lm_data_iterator(cfg, batch * accum, seq, seed=LM_TOKEN_SEED, device=device):
        yield {k: v.reshape(accum, batch, seq) for k, v in b.items()} if accum > 1 else b


def _rel_err(a, b, floor: float = 1.0) -> float:
    """Largest difference over the reference's largest magnitude (at least
    ``floor``)."""
    import torch

    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return float((a - b).abs().max() / max(floor, float(b.abs().max())))


def _tree_rel_l2(a: dict, b: dict) -> float:
    """L2 norm of the difference of two flat trees over the reference's."""
    diff = sum(float((a[k].double().cpu() - v.double().cpu()).square().sum()) for k, v in b.items())
    return (diff / sum(float(v.double().square().sum()) for v in b.values())) ** 0.5


def _same_update_err(opt_cfg, params, state, grads, device) -> Tuple[dict, dict]:
    """One AdamW update (``optimizer.update``) on the CPU and on the card
    from the same parameters, moments and gradients.  Each leaf's largest
    difference of the two new parameters beyond 2 ulps of the CPU's (the
    fp32 rounding of ``p - lr · (...)``, where an ulp of a cosine or power in
    ``lr`` and the bias corrections can flip it) over the leaf's largest
    update; and the raw difference over the largest update, printed."""
    import math

    import torch

    from repro_torch.train import optimizer as opt
    from repro_torch.train.tree import leaves_with_paths, tree_map

    start = dict(leaves_with_paths(params))
    new = {}
    for dev in ("cpu", device):
        p, s, g = (tree_map(lambda x: x.to(dev, copy=True), t) for t in (params, state, grads))
        opt.update(opt_cfg, g, s, p)
        new[str(dev)] = {k: x.cpu() for k, x in leaves_with_paths(p)}
    cpu, card = new["cpu"], new[str(device)]
    beyond, raw = {}, {}
    for k, want in cpu.items():
        scale = max(1e-12, float((want - start[k]).abs().max()))
        diff = (card[k] - want).abs()
        ulp = torch.nextafter(want.abs(), torch.tensor(math.inf)) - want.abs()
        beyond[k] = float((diff - 2 * ulp).clamp_min(0).max()) / scale
        raw[k] = float(diff.max()) / scale
    return beyond, raw


def train_card_vs_cpu(device, name: str, accum: int) -> dict:
    """12a: ``name``'s SMOKE in fp32 trained on the card and on the CPU from
    the same parameters on the same batches.  Gated: every step's loss, the
    first grad norm, the first step's gradients (from the same parameters)
    leaf by leaf over the larger of 1 and the leaf's largest magnitude, and
    the final parameters in relative L2 over the tree within ``TRAIN_TOL``;
    the first step's gradients leaf by leaf over each leaf's own largest
    magnitude within ``TRAIN_GRAD_TOL``; the update the steps made (final parameters minus
    the start) in relative L2 within ``TRAIN_UPDATE_TOL``; and one AdamW
    update from the CPU run's final parameters and moments with its first
    gradients, made on both, leaf by leaf beyond the rounding of the new
    parameter within ``TRAIN_SAME_UPDATE_TOL`` (``_same_update_err``).
    AdamW's first steps move each parameter by about ``lr`` in the sign of
    its gradient, so a gradient near zero whose sign the two summation
    orders disagree on moves a parameter by ~``lr`` on one side only: the
    largest elementwise parameter difference, and the later steps' grad
    norms (which then also see a MoE near-tie rerouted), are printed, not
    gated."""
    import dataclasses
    import importlib

    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import LoopConfig, TrainLoop, make_train_step
    from repro_torch.train.tree import leaves_with_paths, tree_map

    cfg = dataclasses.replace(importlib.import_module(f"repro_torch.configs.{name}").SMOKE,
                              dtype=torch.float32)
    opt_cfg = opt.AdamWConfig(**TRAIN_CHECK_OPT)
    init = tf.init_params(cfg, seed=LM_SEED, device="cpu")
    runs = {}
    for dev in ("cpu", device):
        params = tree_map(lambda p: p.to(dev, copy=True), init)
        step = RecordingStep(make_train_step(lambda p, b: tf.loss_fn(p, cfg, b), opt_cfg, accum))
        first = next(_train_batches(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, accum, dev))
        g0 = step.grads(params, first)[0]
        loop = TrainLoop(step, LoopConfig(total_steps=TRAIN_CHECK_STEPS, log_every=1),
                         log=lambda *_: None)
        t0 = time.perf_counter()
        params, state, hist = loop.run(params, opt.init(params), _train_batches(
            cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, accum, dev))
        runs[str(dev)] = dict(hist=hist, metrics=step.metrics, grads0_tree=g0,
                              grads0={k: g.cpu() for k, g in leaves_with_paths(g0)},
                              params_tree=params, state=state,
                              params={k: p.cpu() for k, p in leaves_with_paths(params)},
                              seconds=time.perf_counter() - t0)
    cpu, card = runs["cpu"], runs[str(device)]
    start = dict(leaves_with_paths(init))
    grad_err = {k: _rel_err(card["grads0"][k], g, floor=1e-8) for k, g in cpu["grads0"].items()}
    grad_unit = {k: _rel_err(card["grads0"][k], g) for k, g in cpu["grads0"].items()}
    param_err = {k: _rel_err(card["params"][k], p) for k, p in cpu["params"].items()}
    same_update, same_update_raw = _same_update_err(opt_cfg, cpu["params_tree"], cpu["state"],
                                   cpu["grads0_tree"], device)
    norms = [(a["grad_norm"], b["grad_norm"]) for a, b in zip(card["metrics"], cpu["metrics"])]
    res = dict(model=cfg.name, accum=accum, steps=TRAIN_CHECK_STEPS, dtype="float32",
               batch=TRAIN_CHECK_BATCH, seq=TRAIN_CHECK_SEQ, opt=TRAIN_CHECK_OPT, tol=TRAIN_TOL,
               grad_tol=TRAIN_GRAD_TOL, update_tol=TRAIN_UPDATE_TOL,
               same_update_tol=TRAIN_SAME_UPDATE_TOL,
               loss_card=card["hist"], loss_cpu=cpu["hist"],
               grad_norm_card=[a for a, _ in norms], grad_norm_cpu=[b for _, b in norms],
               loss_rel_err=max(abs(a - b) / abs(b) for a, b in zip(card["hist"], cpu["hist"])),
               first_grads_err=max(grad_err.values()),
               first_grads_err_leaf=max(grad_err, key=grad_err.get),
               first_grads_err_over_max_1=max(grad_unit.values()),
               first_grad_norm_rel_err=abs(norms[0][0] - norms[0][1]) / norms[0][1],
               param_rel_l2=_tree_rel_l2(card["params"], cpu["params"]),
               update_rel_l2=_tree_rel_l2({k: card["params"][k] - start[k] for k in start},
                                          {k: cpu["params"][k] - start[k] for k in start}),
               same_update_err=max(same_update.values()),
               same_update_err_leaf=max(same_update, key=same_update.get),
               printed=dict(
                   same_update_err_with_rounding=max(same_update_raw.values()),
                   grad_norm_rel_err=max(abs(a - b) / b for a, b in norms),
                   param_max_err=max(param_err.values()),
                   param_max_err_leaf=max(param_err, key=param_err.get)),
               card_s=card["seconds"], cpu_s=cpu["seconds"])
    res["ok"] = (len(card["hist"]) == len(cpu["hist"]) == TRAIN_CHECK_STEPS
                 and max(res["loss_rel_err"], res["first_grads_err_over_max_1"],
                         res["first_grad_norm_rel_err"], res["param_rel_l2"]) <= TRAIN_TOL
                 and res["first_grads_err"] <= TRAIN_GRAD_TOL
                 and res["update_rel_l2"] <= TRAIN_UPDATE_TOL
                 and res["same_update_err"] <= TRAIN_SAME_UPDATE_TOL)
    return res


_TRAIN_LINE = re.compile(r"^\[train\] (\S+): loss (\S+) -> (\S+) \((improved|NOT improved)\)$",
                         re.M)


def train_driver(device) -> dict:
    """12b: ``repro_torch.launch.train.main`` on minitron-8b for
    ``TRAIN_DRIVER_STEPS[0]`` steps with a checkpoint directory, then again
    to ``TRAIN_DRIVER_STEPS[1]`` on the same directory; the second run must
    restore the first's last step, and its first loss (the stream's first
    batch, on the trained parameters) must be below the first run's (the
    same batch, on the initial ones).  The checkpoint restores to bf16."""
    import io
    import shutil

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.configs import minitron_8b
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt

    ck = ROOT / "build" / "train_driver_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    runs = []
    for steps in TRAIN_DRIVER_STEPS:
        argv = ["--arch", "minitron-8b", "--steps", str(steps), "--ckpt-dir", str(ck)]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, counts = _launched(lambda: launch.main(argv + ["--device", str(device)]))
        out = buf.getvalue()
        m = _TRAIN_LINE.search(out)
        runs.append(dict(argv=argv, rc=rc, seconds=time.perf_counter() - t0, launches=counts,
                         first_loss=float(m.group(2)) if m else None,
                         last_loss=float(m.group(3)) if m else None,
                         verdict=m.group(4) if m else None,
                         restored=re.findall(r"restored checkpoint at step (\d+)", out),
                         tail=out.splitlines()[-3:]))
    like = tf.init_params(minitron_8b.SMOKE, seed=0, device=device)
    head0 = like["lm_head"].clone()
    step, params, state = store.restore_latest(str(ck), like_params=like, like_opt=opt.init(like))
    dtypes = sorted({str(p.dtype) for p in [params["embed"], params["final_norm"],
                                            params["lm_head"], *params["layers"].values()]})
    moved = not torch.equal(params["lm_head"], head0)
    shutil.rmtree(ck, ignore_errors=True)
    first, second = runs
    res = dict(runs=runs, restored_step=step, restored_dtypes=dtypes,
               restored_device=str(params["embed"].device), restored_opt_step=int(state.step),
               restored_params_trained=moved)
    res["ok"] = (all(r["rc"] == 0 and r["verdict"] for r in runs)
                 and first["verdict"] == "improved"
                 and second["restored"] == [str(TRAIN_DRIVER_STEPS[0])]
                 and second["first_loss"] < first["first_loss"]
                 and step == TRAIN_DRIVER_STEPS[1] and dtypes == ["torch.bfloat16"] and moved)
    return res


def train_full_width(device, smi: str) -> dict:
    """12c: minitron-8b at full width (``TRAIN_FULL``) trained
    ``TRAIN_FULL_STEPS`` steps by ``TrainLoop``: per-step seconds, tokens/s
    and model-FLOP rate, the peak memory, and one more step profiled.
    Gates: finite losses, the first ``lm_loss`` within 2 of ln V, the last
    loss below the first plus ``TRAIN_FULL_LOSS_SPREAD``, the peak under the
    card's memory, and the first batch's loss lower after training than
    before it.  Each step sees a new
    batch of uniformly drawn sequences, so the training losses move by
    about the batch-to-batch spread in 8 steps; the first batch, trained on
    once and evaluated again, shows that the steps lower the loss of what
    they were taken on."""
    import itertools
    import math

    import torch

    from repro_torch.configs import lm_common, minitron_8b, overrides
    from repro_torch.launch.train import lm_data_iterator
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import LoopConfig, TrainLoop, make_train_step

    base = minitron_8b.CFG
    cfg = overrides.apply(base, TRAIN_FULL)
    tokens = TRAIN_FULL_BATCH * TRAIN_FULL_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    params = tf.init_params(cfg, seed=LM_SEED, device=device)
    state = opt.init(params)
    torch.cuda.synchronize(device)
    state_gb = torch.cuda.memory_allocated(device) / 1e9
    step = RecordingStep(make_train_step(lambda p, b: tf.loss_fn(p, cfg, b),
                                         opt.AdamWConfig(**TRAIN_FULL_OPT)))
    stamps = []

    def log(msg):  # called after each step's update: the card is synchronised
        torch.cuda.synchronize(device)
        stamps.append(time.perf_counter())

    def first_batch_loss():
        with torch.no_grad():
            return float(tf.loss_fn(params, cfg, first)[1]["lm_loss"])

    data = lm_data_iterator(cfg, TRAIN_FULL_BATCH, TRAIN_FULL_SEQ, seed=LM_TOKEN_SEED,
                            device=device)
    first = next(data)
    first_before = first_batch_loss()
    loop = TrainLoop(step, LoopConfig(total_steps=TRAIN_FULL_STEPS, log_every=1), log=log)
    t0 = time.perf_counter()
    (params, state, hist), counts = _launched(
        lambda: loop.run(params, state, itertools.chain([first], data)))
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    peak = torch.cuda.max_memory_allocated(device)
    first_after = first_batch_loss()
    flops = 6 * lm_common.n_active(cfg) * tokens
    steady = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    # a batch of its own: the loop's prefetch thread may still be drawing from ``data``
    batch = next(lm_data_iterator(cfg, TRAIN_FULL_BATCH, TRAIN_FULL_SEQ, seed=LM_TOKEN_SEED + 1,
                                  device=device))
    profile = profile_call(lambda: step.step(params, state, batch))
    first_lm = step.metrics[0]["lm_loss"]
    res = dict(model=cfg.name, overrides=TRAIN_FULL, n_layers=cfg.n_layers, d_model=cfg.d_model,
               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, dtype=str(cfg.dtype), loss_chunk=cfg.loss_chunk,
               params=cfg.param_count(), n_active=lm_common.n_active(cfg),
               batch=TRAIN_FULL_BATCH, seq=TRAIN_FULL_SEQ, opt=TRAIN_FULL_OPT,
               reduced=[f"layers {base.n_layers} -> {cfg.n_layers} (full width)",
                        f"batch {lm_common.TRAIN_SHAPE['batch']} -> {TRAIN_FULL_BATCH}, seq "
                        f"{lm_common.TRAIN_SHAPE['seq']} (TRAIN_SHAPE)",
                        f"loss_chunk {base.loss_chunk} -> {cfg.loss_chunk} (tiling only)",
                        f"random weights (seed {LM_SEED}), lm_data_iterator seed "
                        f"{LM_TOKEN_SEED}", "no checkpoint"],
               losses=hist, lm_loss_first=first_lm, ln_vocab=math.log(cfg.vocab_size),
               first_batch_loss_before=first_before, first_batch_loss_after=first_after,
               grad_norms=[m["grad_norm"] for m in step.metrics],
               step_s=step_s, steady_step_s=steady, tokens_per_s=tokens / steady,
               model_flops_per_step=flops, model_tflop_per_s=flops / steady / 1e12,
               state_gb=state_gb, peak_memory_gb=peak / 1e9,
               card_memory_gb=torch.cuda.get_device_properties(device).total_memory / 1e9,
               launches=counts, profile=profile, nvidia_smi=smi)
    res["ok"] = (len(hist) == TRAIN_FULL_STEPS and all(math.isfinite(x) for x in hist)
                 and abs(first_lm - res["ln_vocab"]) < 2.0
                 and hist[-1] < hist[0] + TRAIN_FULL_LOSS_SPREAD
                 and first_after < first_before
                 and peak < torch.cuda.get_device_properties(device).total_memory)
    del params, state, batch
    torch.cuda.empty_cache()
    return res


def run_train_path(device, smi: str) -> dict:
    """Phase 12: 12a the card against the CPU, 12b the driver, 12c full
    width.  No kernel of K1–K9 runs in training (``forward`` attends with the
    plain ``blockwise_attention``); every launch count must stay 0."""
    t_phase = time.perf_counter()
    checks = []
    for name in TRAIN_CHECK_CFGS:
        for accum in TRAIN_CHECK_ACCUM:
            res, counts = _launched(lambda: train_card_vs_cpu(device, name, accum))
            checks.append(dict(res, launches=counts))
    emit(dict(phase="train_card_vs_cpu", cases=checks, nvidia_smi=smi))
    driver = train_driver(device)
    emit(dict(phase="train_driver", **driver, nvidia_smi=smi))
    full = train_full_width(device, smi)
    emit(dict(phase="train_full_width", **full))
    launched = {k: v for r in checks + driver["runs"] + [full]
                for k, v in r["launches"].items() if v}
    emit(dict(phase="train_done", launches=launched, nvidia_smi=smi,
              train_path_s=time.perf_counter() - t_phase))
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"training on the card != on the CPU: "
                             f"{[c for c in checks if not c['ok']]}")
    if not driver["ok"]:
        raise AssertionError(f"the training driver's restart failed its gates: {driver}")
    if not full["ok"]:
        raise AssertionError(f"full-width training failed its gates: {full}")
    if launched:
        raise AssertionError(f"the training path launched kernels: {launched}")
    return full


# ---------------------------------------------------------------------------
# phase 13: the GNN and recsys families
# ---------------------------------------------------------------------------

def _fam_compare(a: dict, b: dict) -> dict:
    """Run ``a`` against run ``b`` (the reference): the forward and the loss
    over the reference's largest magnitude, each gradient leaf over its own
    largest, the parameters after the step in relative L2."""
    grad = {k: _rel_err(a["grads"][k], g, floor=1e-30) for k, g in b["grads"].items()}
    return dict(forward_err=_rel_err(a["out"], b["out"], floor=1e-30),
                loss_err=abs(a["loss"] - b["loss"]) / max(1e-30, abs(b["loss"])),
                grad_err=max(grad.values()), grad_err_leaf=max(grad, key=grad.get),
                param_rel_l2=_tree_rel_l2(a["params"], b["params"]))


def _fam_ok(cmp: dict, grad_tol: float) -> bool:
    return (max(cmp["forward_err"], cmp["loss_err"], cmp["param_rel_l2"]) <= FAM_TOL
            and cmp["grad_err"] <= grad_tol)


def family_card_vs_cpu(device, label: str, specs, loss_fn, fwd_fn, batch_cpu, opt_cfg,
                       grad_tol: float = FAM_GRAD_TOL, tf32_control: bool = False) -> dict:
    """13a for one model: the forward (no gradients), the loss and every
    gradient, and one AdamW step, from parameters drawn once on the CPU, on
    the CPU and twice on the card; with ``tf32_control``, once more on the
    card with TF32 products, compared with the CPU and printed."""
    import torch

    from repro_torch.models.common import init_from_specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step

    init = init_from_specs(specs, FAM_SEED, "cpu")

    def run(dev) -> dict:
        params = {k: v.to(dev, copy=True) for k, v in init.items()}
        batch = {k: v.to(dev) for k, v in batch_cpu.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fwd_fn(params, batch).cpu()
        step = make_train_step(loss_fn, opt_cfg)
        grads, metrics = step.grads(params, batch)
        loss = float(metrics["loss_total"])
        grads_cpu = {k: g.cpu() for k, g in grads.items()}
        step.apply(params, opt.init(params), grads, metrics)
        res = dict(out=out, loss=loss, grads=grads_cpu,
                   params={k: p.cpu() for k, p in params.items()},
                   seconds=time.perf_counter() - t0)
        del params, batch, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return res

    runs = {key: run(dev) for key, dev in (("cpu", torch.device("cpu")), ("card", device),
                                           ("card2", device))}
    vs_cpu = _fam_compare(runs["card"], runs["cpu"])
    spread = _fam_compare(runs["card2"], runs["card"])
    res = dict(model=label, loss_card=runs["card"]["loss"], loss_cpu=runs["cpu"]["loss"],
               card_vs_cpu=vs_cpu, card_vs_card=spread, tol=FAM_TOL, grad_tol=grad_tol,
               cpu_s=runs["cpu"]["seconds"], card_s=runs["card"]["seconds"],
               ok=_fam_ok(vs_cpu, grad_tol) and _fam_ok(spread, grad_tol))
    if tf32_control:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            res["tf32_control_vs_cpu"] = _fam_compare(run(device), runs["cpu"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return res


def family_checks(device) -> list:
    """13a: every GNN at CFG on ``FAM_CHECK_CELL`` and DIN at CFG on
    ``FAM_CHECK_DIN_BATCH`` rows, the card against the CPU."""
    import importlib

    import torch

    from repro_torch.configs import din as din_cfg
    from repro_torch.configs import gnn_common
    from repro_torch.models.recsys import din as din_mod

    shape = gnn_common.gnn_shapes()[FAM_CHECK_CELL]
    out = []
    for name in FAM_GNNS:
        md = importlib.import_module(f"repro_torch.configs.{name}").MODEL
        arrays = gnn_common.batch_arrays(shape, md.with_positions, md.with_mesh, seed=FAM_SEED)
        deep = name == "graphcast"
        res = family_card_vs_cpu(
            device, md.name, md.param_specs(md.cfg, shape.d_feat, shape.d_out),
            gnn_common.task_loss(lambda p, b, f=md.forward, c=md.cfg: f(p, c, b), shape),
            lambda p, b, f=md.forward, c=md.cfg: f(p, c, b),
            {k: torch.from_numpy(v) for k, v in arrays.items()}, gnn_common.OPT,
            grad_tol=FAM_DEEP_GRAD_TOL if deep else FAM_GRAD_TOL, tf32_control=deep)
        res.update(cell=FAM_CHECK_CELL, nodes=shape.n_nodes, edges=shape.n_edges,
                   d_feat=shape.d_feat, d_out=shape.d_out,
                   n_layers=getattr(md.cfg, "n_layers", None))
        out.append(res)
    cfg = din_cfg.CFG
    res = family_card_vs_cpu(
        device, "din", din_mod.param_specs(cfg), lambda p, b: din_mod.loss_fn(p, cfg, b),
        lambda p, b: din_mod.score(p, cfg, b),
        din_cfg.batch_tensors(cfg, FAM_CHECK_DIN_BATCH, seed=FAM_SEED, device="cpu"),
        din_cfg.OPT)
    res.update(batch=FAM_CHECK_DIN_BATCH)
    out.append(res)
    return out


_SMOKE_LINE = re.compile(r"^\[train\] (\S+) smoke: \{'loss': (\S+)\}$", re.M)


def family_driver(device) -> list:
    """13a: ``repro_torch.launch.train.main`` on each GNN and recsys id on
    the card: each prints a finite smoke loss."""
    import io
    import math

    from repro_torch.configs import registry
    from repro_torch.launch import train as launch

    runs = []
    for arch in [a.name for a in registry.load_all().values() if a.family in ("gnn", "recsys")]:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = launch.main(["--arch", arch, "--device", "cuda"])
        m = _SMOKE_LINE.search(buf.getvalue())
        loss = float(m.group(2)) if m and m.group(1) == arch else None
        runs.append(dict(arch=arch, rc=rc, loss=loss, seconds=time.perf_counter() - t0,
                         ok=rc == 0 and loss is not None and math.isfinite(loss)))
    return runs


def _memory_gb(device) -> dict:
    import torch

    return dict(peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                card_memory_gb=torch.cuda.get_device_properties(device).total_memory / 1e9)


def _train_steps(step, params, state, batch, n: int, device) -> Tuple[list, list]:
    """``n`` steps on ``batch``: their losses and seconds (each ended by a
    device sync)."""
    import torch

    losses, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        losses.append(float(m["loss_total"]))
        torch.cuda.synchronize(device)
        secs.append(time.perf_counter() - t0)
    return losses, secs


def gnn_full_width(device, smi: str, name: str, arrays_of) -> dict:
    """13b: GNN ``name`` at its published CFG on its ``FAM_CELLS`` cell,
    ``FAM_STEPS`` AdamW steps (OPT) on one batch, then ``FAM_PROFILES``
    steps profiled.  Gates: finite losses, the last below the first, the peak
    under the card's memory."""
    import importlib
    import math

    import torch

    from repro_torch.configs import gnn_common
    from repro_torch.models.common import init_from_specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step

    mod = importlib.import_module(f"repro_torch.configs.{name}")
    md, cfg = mod.MODEL, mod.MODEL.cfg
    cell = FAM_CELLS[name]
    shapes = gnn_common.gnn_shapes()
    shape = shapes[cell]
    reduced = [f"random weights (seed {FAM_SEED}), synthetic batch (seed {FAM_SEED})",
               f"{FAM_STEPS} steps on one batch"]
    if cell != "ogb_products":
        big = shapes["ogb_products"]
        need = (big.n_edges * cfg.n_rbf * 4 if name == "schnet"
                else 4 * big.n_nodes * 3 * cfg.d_hidden * 4)
        what = ("the [E, n_rbf] fp32 RBF" if name == "schnet"
                else "the g2m edge MLP's [4n, 3d] fp32 input")
        reduced.append(f"cell ogb_products -> {cell}: {what} alone is {need / 1e9:.1f} GB there")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in arrays_of(cell, md.with_positions, md.with_mesh).items()}
    params = init_from_specs(md.param_specs(cfg, shape.d_feat, shape.d_out), FAM_SEED, device)
    state = opt.init(params)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated(device) / 1e9
    step = make_train_step(gnn_common.task_loss(lambda p, b: md.forward(p, cfg, b), shape),
                           gnn_common.OPT)
    (losses, step_s), counts = _launched(
        lambda: _train_steps(step, params, state, batch, FAM_STEPS, device))
    mem = _memory_gb(device)
    steady = statistics.median(step_s[1:])
    flops = 3.0 * mod.fwd_flops(cfg, shape)
    profile, pcounts = _launched(lambda: _profile_steps(lambda: step(params, state, batch)))
    _add(counts, pcounts)
    res = dict(model=md.name, cell=cell, nodes=shape.n_nodes, edges=shape.n_edges,
               d_feat=shape.d_feat, d_out=shape.d_out, task=shape.task,
               table_nodes=shape.table_nodes, cfg=str(cfg), reduced=reduced,
               params=sum(p.numel() for p in params.values()), setup_s=setup_s,
               losses=losses, step_s=step_s, steady_step_s=steady,
               model_flops_per_step=flops, model_tflop_per_s=flops / steady / 1e12,
               state_gb=state_gb, **mem, launches=counts, profile=profile, nvidia_smi=smi)
    res["ok"] = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                 and mem["peak_memory_gb"] < mem["card_memory_gb"])
    del params, state, batch, step
    torch.cuda.empty_cache()
    return res


def _profile_steps(fn, n: int = FAM_PROFILES) -> dict:
    """``profile_call`` of ``n`` separate calls of ``fn``: the one that traced
    the most device time, and every call's busy share beside it.  A trace
    can lose kernels and read low (one step of gcn-cora read 49 %, 99 % and
    50 % busy in three traces on an H100, its profiled wall time within 1 %
    of the unprofiled step's), but it adds none."""
    runs = [profile_call(fn) for _ in range(n)]
    if any("device_busy_s" not in r for r in runs):
        return runs[0]
    return dict(max(runs, key=lambda r: r["device_busy_s"]),
                busy_shares=[r["device_busy_share"] for r in runs])


def _timed_calls(fn, n: int, device, warmup: int = 1) -> list:
    """Seconds of ``n`` calls of ``fn``, each ended by a device sync."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        out.append(time.perf_counter() - t0)
    return out


def din_full_width(device, smi: str) -> dict:
    """13c: DIN at its published CFG: ``train_batch`` (``DIN_STEPS`` AdamW
    steps on one batch of ``DIN_TRAIN`` rows, then ``FAM_PROFILES`` profiled),
    ``serve_p99``, ``serve_bulk`` and ``retrieval_cand``.  Gates: the
    training loss falls, finite scores, the peak under the card's memory,
    the retrieval's sampled candidates equal to pointwise ``score``, its
    top-k the largest scores."""
    import math

    import torch

    from repro_torch.configs import din as din_cfg
    from repro_torch.models.common import init_from_specs
    from repro_torch.models.recsys import din as din_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step

    cfg = din_cfg.CFG
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    params = init_from_specs(din_mod.param_specs(cfg), FAM_SEED, device)
    state = opt.init(params)
    batch = din_cfg.batch_tensors(cfg, DIN_TRAIN, seed=FAM_SEED, device=device)
    torch.cuda.synchronize(device)
    state_gb = torch.cuda.memory_allocated(device) / 1e9
    step = make_train_step(lambda p, b: din_mod.loss_fn(p, cfg, b), din_cfg.OPT)
    losses, step_s = _train_steps(step, params, state, batch, DIN_STEPS, device)
    train_mem = _memory_gb(device)
    profile = _profile_steps(lambda: step(params, state, batch))
    flops = 3.0 * din_cfg._score_flops(cfg, DIN_TRAIN)
    steady = statistics.median(step_s[1:])
    train = dict(batch=DIN_TRAIN, losses=losses, step_s=step_s, steady_step_s=steady,
                 rows_per_s=DIN_TRAIN / steady, model_flops_per_step=flops,
                 model_tflop_per_s=flops / steady / 1e12, state_gb=state_gb,
                 **train_mem, profile=profile)
    del state, batch, step
    torch.cuda.empty_cache()

    def score_fn(b):
        return lambda: din_mod.score(params, cfg, b)

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats(device)
        p99_batch = din_cfg.batch_tensors(cfg, DIN_P99, seed=FAM_SEED + 1, device=device)
        p99_batch.pop("click")
        p99_s = _timed_calls(score_fn(p99_batch), DIN_P99_CALLS, device, warmup=3)
        p99_scores = din_mod.score(params, cfg, p99_batch)
        serve_p99 = dict(batch=DIN_P99, calls=DIN_P99_CALLS,
                         median_ms=statistics.median(p99_s) * 1e3,
                         p99_ms=sorted(p99_s)[math.ceil(0.99 * len(p99_s)) - 1] * 1e3,
                         finite=bool(torch.isfinite(p99_scores).all()))
        bulk = din_cfg.batch_tensors(cfg, DIN_BULK, seed=FAM_SEED + 2, device=device)
        bulk.pop("click")
        bulk_s = _timed_calls(score_fn(bulk), DIN_BULK_CALLS, device)
        bulk_scores = din_mod.score(params, cfg, bulk)
        serve_bulk = dict(batch=DIN_BULK, seconds=bulk_s,
                          rows_per_s=DIN_BULK / statistics.median(bulk_s),
                          model_tflop_per_s=din_cfg._score_flops(cfg, DIN_BULK)
                          / statistics.median(bulk_s) / 1e12,
                          finite=bool(torch.isfinite(bulk_scores).all()), **_memory_gb(device))
        del bulk, bulk_scores
        torch.cuda.empty_cache()
        retrieval = din_retrieval(device, params, cfg, p99_batch)
    res = dict(model="din", cfg=str(cfg), params=sum(p.numel() for p in params.values()),
               train_batch=train, serve_p99=serve_p99, serve_bulk=serve_bulk,
               retrieval_cand=retrieval, nvidia_smi=smi,
               reduced=[f"random weights (seed {FAM_SEED}), synthetic batches (din_batch seeds "
                        f"{FAM_SEED}-{FAM_SEED + 2})", f"{DIN_STEPS} steps on one batch"]
               + retrieval["reduced"])
    res["ok"] = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                 and train["peak_memory_gb"] < train["card_memory_gb"]
                 and serve_p99["finite"] and serve_bulk["finite"]
                 and serve_bulk["peak_memory_gb"] < serve_bulk["card_memory_gb"]
                 and retrieval["ok"])
    del params
    torch.cuda.empty_cache()
    return res


def din_retrieval(device, params, cfg, batch) -> dict:
    """``retrieval_cand``: the user of ``batch``'s first row against
    ``DIN_RETRIEVAL`` random candidates, then ``torch.topk``.  Gated:
    ``DIN_RETRIEVAL_CHECK`` sampled candidates' scores against pointwise
    ``score`` of the same (user, item) pairs within ``FAM_TOL`` of their
    largest magnitude; the top-k values the largest scores, in order; the
    peak under the card's memory."""
    import torch

    from repro_torch.models.recsys import din as din_mod

    user = {k: batch[k][:1] for k in ("hist_items", "hist_cats", "hist_len", "dense")}
    gen = torch.Generator(device=device)
    gen.manual_seed(FAM_SEED + 3)
    nc = DIN_RETRIEVAL
    b = dict(user, cand_items=torch.randint(0, cfg.n_items, (nc,), generator=gen,
                                            device=device, dtype=torch.int32),
             cand_cats=torch.randint(0, cfg.n_cats, (nc,), generator=gen,
                                     device=device, dtype=torch.int32))

    def retrieve():
        scores = din_mod.score_candidates(params, cfg, b)
        return scores, torch.topk(scores, min(DIN_TOPK, scores.shape[0]))

    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    secs = _timed_calls(retrieve, 3, device)
    scores, (top_v, top_i) = retrieve()
    mem = _memory_gb(device)
    per_cand = (torch.cuda.max_memory_allocated(device) - base) / nc
    reduced = [f"candidates {DIN_RETRIEVAL_CELL:,} -> {nc:,}: {per_cand:.0f} bytes of "
               f"temporaries per candidate would need {DIN_RETRIEVAL_CELL * per_cand / 1e9:.1f} GB"]
    pick = torch.randperm(nc, generator=gen, device=device)[:DIN_RETRIEVAL_CHECK]
    n = len(pick)
    point = din_mod.score(params, cfg, {
        "hist_items": user["hist_items"].expand(n, -1).contiguous(),
        "hist_cats": user["hist_cats"].expand(n, -1).contiguous(),
        "hist_len": user["hist_len"].expand(n).contiguous(),
        "dense": user["dense"].expand(n, -1).contiguous(),
        "target_item": b["cand_items"][pick], "target_cat": b["cand_cats"][pick]})
    err = _rel_err(scores[pick], point, floor=1e-30)
    kth = float(torch.kthvalue(scores.float().cpu(), nc - len(top_v) + 1).values)
    top_ok = (bool(torch.equal(top_v, scores[top_i])) and bool((top_v[:-1] >= top_v[1:]).all())
              and float(top_v[-1]) >= kth)
    res = dict(candidates=nc, topk=len(top_v), bytes_per_candidate=per_cand, seconds=secs,
               median_ms=statistics.median(secs) * 1e3,
               candidates_per_s=nc / statistics.median(secs), **mem,
               pointwise_err=err, pointwise_checked=n, tol=FAM_TOL,
               topk_ok=top_ok, finite=bool(torch.isfinite(scores).all()), reduced=reduced)
    res["ok"] = (err <= FAM_TOL and top_ok and res["finite"]
                 and mem["peak_memory_gb"] < mem["card_memory_gb"])
    return res


def run_family_path(device, smi: str) -> dict:
    """Phase 13: 13a the card against the CPU and the driver's smokes, 13b
    the GNNs at full width, 13c DIN at full width.  No kernel of K1–K9 runs
    (every launch count must stay 0)."""
    from repro_torch.configs import gnn_common

    t_phase = time.perf_counter()
    checks, counts = _launched(lambda: family_checks(device))
    driver, dcounts = _launched(lambda: family_driver(device))
    _add(counts, dcounts)
    emit(dict(phase="family_card_vs_cpu", cases=checks, driver=driver, launches=counts,
              nvidia_smi=smi, seconds=time.perf_counter() - t_phase))
    cache = {}

    def arrays_of(cell, pos, mesh):  # gcn and graphsage share ogb_products' batch
        key = (cell, pos, mesh)
        if key not in cache:
            cache.clear()
            cache[key] = gnn_common.batch_arrays(gnn_common.gnn_shapes()[cell], pos, mesh,
                                                 seed=FAM_SEED)
        return cache[key]

    full = []
    for name in FAM_GNNS:
        res = gnn_full_width(device, smi, name, arrays_of)
        emit(dict(phase="family_gnn_full_width", **res))
        full.append(res)
    cache.clear()
    din, din_counts = _launched(lambda: din_full_width(device, smi))
    emit(dict(phase="family_din_full_width", **din, launches=din_counts))
    launched = {k: v for c in [counts, din_counts] + [r["launches"] for r in full]
                for k, v in c.items() if v}
    emit(dict(phase="family_done", launches=launched, nvidia_smi=smi,
              family_path_s=time.perf_counter() - t_phase))
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"the GNN / recsys families on the card != on the CPU: "
                             f"{[c for c in checks if not c['ok']]}")
    if not all(r["ok"] for r in driver):
        raise AssertionError(f"the training driver's smokes failed: {driver}")
    if not all(r["ok"] for r in full):
        raise AssertionError(f"a GNN at full width failed its gates: "
                             f"{[r['model'] for r in full if not r['ok']]}")
    if not din["ok"]:
        raise AssertionError(f"DIN at full width failed its gates: {din}")
    if launched:
        raise AssertionError(f"the GNN / recsys path launched kernels: {launched}")
    return din


# ---------------------------------------------------------------------------
# phase 14: the registry (repro_torch.configs.registry) and its cells
# ---------------------------------------------------------------------------

def registry_cells(device) -> dict:
    """14a: every cell of the registry built; every argument leaf must be a
    meta tensor and the card's allocated memory unchanged.  Prints each
    cell's kind, ``model_flops`` and the bytes its arguments would hold
    against the card's memory."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.train.tree import leaves

    card = torch.cuda.get_device_properties(device).total_memory
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    archs = registry.load_all()
    rows, concrete = [], []
    t0 = time.perf_counter()
    for cell in registry.all_cells():
        row = dict(cell=cell.name, kind=cell.kind)
        if cell.build is None:
            rows.append(dict(row, skip_reason=cell.skip_reason))
            continue
        b = cell.build()
        tensors = [x for x in leaves(b.args) if isinstance(x, torch.Tensor)]
        concrete += [cell.name for x in tensors if not x.is_meta]
        arg_bytes = sum(x.numel() * x.element_size() for x in tensors if x._base is None)
        rows.append(dict(row, model_flops=b.model_flops, arg_bytes=arg_bytes,
                         arg_share_of_card=arg_bytes / card, fits_card=arg_bytes <= card,
                         donate=list(b.donate), note=b.note))
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    after = torch.cuda.memory_allocated(device)
    built = [r for r in rows if "skip_reason" not in r]
    out = dict(archs=len(archs), cells=len(rows), built=len(built),
               skipped=[r["cell"] for r in rows if "skip_reason" in r],
               sge=sum(r["cell"].startswith("sge/") for r in rows),
               card_memory_bytes=card, allocated_before=before, allocated_after=after,
               build_s=build_s, rows=rows)
    if (out["archs"], out["cells"], out["built"], out["sge"]) != (11, 44, 39, 4):
        raise AssertionError(f"the registry has {out['archs']} archs, {out['cells']} cells, "
                             f"{out['built']} buildable, {out['sge']} sge cells")
    if concrete or after != before:
        raise AssertionError(f"a cell build made a concrete tensor: {concrete}, allocated "
                             f"{before} -> {after} bytes")
    return out


def _ring_read(x, base):
    """A ``[V, S, ...]`` ring read from each worker's ``base`` (on the card)."""
    import torch

    s_cap = x.shape[1]
    idx = (base[:, None] + torch.arange(s_cap, device=x.device)) % s_cap
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.ndim - 2)).expand_as(x))


def _round_state(st) -> dict:
    """A pack of one's ``EngineState`` fields, rings read from their bases
    (``base`` itself left out)."""
    rings = ("st_depth", "st_map", "st_used", "st_cand")
    return {name: _ring_read(x[0], st.base[0]) if name in rings else x[0]
            for name, x in zip(st._fields, st) if name != "base"}


def registry_round(fn, arrays, plan, cfg, device) -> tuple:
    """One warm-up round of ``fn`` from ``init_state``, then one from a fresh
    state with the launch counts set to 0 just before and read just after:
    (its state fields, seconds, launches)."""
    import torch

    from repro_torch.core.frontier import init_state
    from repro_torch.kernels import ops

    fn(arrays, init_state(plan, cfg, device))  # the first use of each op on the card
    st = init_state(plan, cfg, device)
    torch.cuda.synchronize(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = fn(arrays, st)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return _round_state(st), seconds, ops.launch_counts()


def _tensor_shapes(tree) -> list:
    import torch

    from repro_torch.train.tree import leaves

    return [list(x.shape) for x in leaves(tree) if isinstance(x, torch.Tensor)]


def registry_sge_cell(device, name: str, cell, loaded: bool) -> tuple:
    """14b for one ``sge`` cell: its target and pattern (``loaded``: the
    target's labels taken mod :data:`REG_LOADED_LABELS` and a pattern drawn
    from that), the plan at the cell's shapes (prepared through K4 + K3
    dense, K8 + K3 on CSR planes), and the round three ways.  Returns (the
    printed row, launches, failed gates)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import sge
    from repro_torch.core import engine as eng
    from repro_torch.core import extend
    from repro_torch.core.domains import compute_domains_device
    from repro_torch.core.frontier import init_state
    from repro_torch.core.graph import PackedGraph
    from repro_torch.core.plan import build_csr_plan, build_plan, variant_flags
    from repro_torch.data import graphgen

    t0 = time.perf_counter()
    src = REG_TARGETS[name]
    if src == "main":
        target, pattern = SHARED["main"]["target"], SHARED["main"]["patterns"][0].pattern
    elif src == "sparse":
        target, pattern = SHARED["sparse"]["target"], SHARED["sparse"]["patterns"][0]
    else:
        inst = graphgen.make_collection(**src)[0]
        target, pattern = inst.target, inst.pattern
    planes = SHARED["sparse"]["index"].csr_planes() if src == "sparse" else None
    if loaded:
        target = dataclasses.replace(
            target, labels=(target.labels % REG_LOADED_LABELS).astype(np.int32))
        pattern = graphgen.extract_pattern(target, REG_LOADED_EDGES, seed=REG_LOADED_SEED)
        planes = None
    csr = name.endswith("_csr")
    n_t = sge.COLLECTION_NT[name[:-4] if csr else name]
    w = sge._w_for(n_t)
    if target.n != n_t:
        raise AssertionError(f"{name}: the target has {target.n} nodes, the cell {n_t}")
    b = cell.build()
    replace = dataclasses.replace
    if csr:
        cfg = replace(sge.ENGINE, step_backend="csr", use_pallas=True)
        n_elab = target.n_edge_labels
        plan, prep_counts = _launched(lambda: build_csr_plan(
            pattern, target, variant=sge.CSR_VARIANT, p_pad=sge.P_PAD,
            max_parents=sge.MAX_PARENTS, w=w, use_pallas=True, planes=planes, device=device))
        want_plan = extend.abstract_csr_plan_arrays(n_t, w, sge.P_PAD, sge.MAX_PARENTS,
                                                    n_elab=n_elab)
        plain = replace(cfg, use_pallas=False)
        runs = {"K7": (b.fn, "csr_extend_bucketed"),
                "K6": (sge.build_csr_round(n_t, replace(sge.ENGINE, csr_walk="flat")).fn,
                       "csr_extend"),
                "plain": (lambda p, s: eng.make_round_fn(plain, p)(s), None)}
        prep_kernels = ("csr_arc_sweep", "popcount_rows")
    else:
        cfg = sge.ENGINE
        packed = PackedGraph.from_graph(target, pad_words_to=128)
        n_elab = packed.n_edge_labels
        flags = variant_flags(VARIANT)

        def prepare():
            domains = compute_domains_device(pattern, packed, use_ac=flags["use_ac"],
                                             use_fc=flags["use_fc"],
                                             interleave=flags["interleave"],
                                             use_pallas=True, device=device)
            return build_plan(pattern, packed, VARIANT, p_pad=sge.P_PAD,
                              max_parents=sge.MAX_PARENTS, domains=domains)

        plan, prep_counts = _launched(prepare)
        want_plan = extend.abstract_plan_arrays(n_t, w, sge.P_PAD, sge.MAX_PARENTS,
                                                n_elab=n_elab)
        runs = {"plain": (b.fn, None),
                "K1": (sge.build_round(n_t, replace(sge.ENGINE, step_backend="pallas")).fn,
                       "extend_step"),
                "K2": (sge.build_round(n_t, replace(sge.ENGINE, use_pallas=True)).fn,
                       "candidate_mask")}
        prep_kernels = ()
    arrays = extend.plan_arrays_for(cfg, [plan], device)
    got_plan, cell_plan = _tensor_shapes(arrays), _tensor_shapes(want_plan)
    if csr:  # the indices' length follows the target's nnz and longest row
        got_plan = [s for f, s in zip(arrays._fields, got_plan) if f != "indices"]
        cell_plan = [s for f, s in zip(want_plan._fields, cell_plan) if f != "indices"]
    got_state = _tensor_shapes(init_state(plan, cfg, device))
    row = dict(cell=name, case="loaded" if loaded else "collection", n_t=n_t, w=w,
               node_labels=target.n_node_labels, plan_w=plan.w, p_pad=plan.p_pad, n_p=plan.n_p,
               max_parents=plan.max_parents, n_elab=n_elab, cell_n_elab=1,
               pattern_nodes=pattern.n, pattern_arcs=pattern.m,
               lanes=[cfg.n_workers, cfg.expand_width],
               variant=sge.CSR_VARIANT if csr else VARIANT, prepare_launches=prep_counts,
               note=b.note, model_flops=b.model_flops,
               plan_shapes_equal=got_plan == cell_plan,
               state_shapes_equal=got_state == _tensor_shapes(b.args[1]))
    if csr:
        row.update(deg_cap=arrays.deg_cap, cell_deg_cap=b.args[0].deg_cap,
                   indices=arrays.indices.numel(), cell_indices=b.args[0].indices.numel())
    row["setup_s"] = time.perf_counter() - t0
    launches = dict(prep_counts)
    ref, rounds = None, {}
    for label, (fn, kernel) in runs.items():
        state, seconds, counts = registry_round(fn, arrays, plan, cfg, device)
        _add(launches, counts)
        rounds[label] = dict(seconds=seconds, launches={k: v for k, v in counts.items() if v},
                             states=int(state["states"].sum()),
                             matches=int(state["matches"].sum()), steps=int(state["steps"]),
                             kernel=kernel, kernel_launched=bool(kernel and counts[kernel]),
                             any_launch=any(counts.values()))
        if ref is None:
            ref = state
        else:
            rounds[label]["differing_fields"] = [
                f for f in ref if not torch.equal(ref[f], state[f])]
        del state
    row["rounds"] = rounds
    del ref, arrays, plan
    torch.cuda.empty_cache()
    bad = [f"{label}: {r['differing_fields']}" for label, r in rounds.items()
           if r.get("differing_fields")]
    bad += [f"{label} launched no {r['kernel']}" for label, r in rounds.items()
            if r["kernel"] and not r["kernel_launched"]]
    bad += [f"the plain round launched {r['launches']}" for label, r in rounds.items()
            if not r["kernel"] and r["any_launch"]]
    bad += [f"the prepare launched no {k}" for k in prep_kernels if not prep_counts[k]]
    if not (row["plan_shapes_equal"] and row["state_shapes_equal"]):
        bad.append(f"the concrete plan {got_plan} / state {got_state} != the cell's "
                   f"{cell_plan} / {_tensor_shapes(b.args[1])}")
    if not any(r["states"] for r in rounds.values()):
        bad.append("the round reached no state")
    return row, launches, bad


def registry_prefill_32k(device, smi: str) -> tuple:
    """14c: minitron-8b's ``prefill_32k`` cell through its ``fn`` at full
    width and depth, batch cut to :data:`REG_PREFILL_BATCH`: K9 once per
    layer at S = 32,768, finite logits; then K9 on layer 0's q/k/v against
    its plain version on :data:`REG_K9_HEADS` and timed beside
    ``scaled_dot_product_attention``.  Returns (the printed result, K9
    launches in the timed prefill, K9's timing at that length, the cases)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import lm_common, minitron_8b, registry
    from repro_torch.data import graphgen
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.models import transformer as tf

    cfg = LM_CFG or minitron_8b.CFG
    cell = registry.get(minitron_8b.CFG.name).cells["prefill_32k"]
    seq = REG_PREFILL_SEQ or lm_common.PREFILL_SHAPE["seq"]
    b = lm_common.build_prefill(cfg, REG_PREFILL_BATCH, seq)
    cache_gb = 2 * cfg.n_layers * seq * cfg.n_kv_heads * cfg.head_dim * 2 / 1e9
    reduced = [f"prefill_32k batch {lm_common.PREFILL_SHAPE['batch']} -> {REG_PREFILL_BATCH} "
               f"(the KV cache alone: {cache_gb * lm_common.PREFILL_SHAPE['batch']:.1f} GB at "
               f"batch {lm_common.PREFILL_SHAPE['batch']}, {cache_gb * REG_PREFILL_BATCH:.1f} GB "
               f"at {REG_PREFILL_BATCH})",
               "random weights (seed 0), a random prompt (lm_batch seed 7)"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=LM_SEED, device=device)
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    if _tensor_shapes(params) != _tensor_shapes(b.args[0]):
        raise AssertionError(f"{cfg.name}'s parameters differ from the cell's")
    toks = torch.from_numpy(graphgen.lm_batch(REG_PREFILL_BATCH, seq, cfg.vocab_size,
                                              seed=LM_TOKEN_SEED)["tokens"]).to(device)
    first = {}
    flash = ops.flash_attention

    def capture(q, k, v, **kw):
        first.setdefault("qkv", (q, k, v))
        return flash(q, k, v, **kw)

    ops.flash_attention = capture
    try:
        runs = []
        for _ in range(2):  # the first call also warms each op at these shapes
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            logits, cache = b.fn(params, toks)
            torch.cuda.synchronize(device)
            runs.append(dict(seconds=time.perf_counter() - t1, launches=ops.launch_counts()))
            finite = bool(torch.isfinite(logits).all())
            shape = list(logits.shape)
            del logits, cache
    finally:
        ops.flash_attention = flash
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    del params
    torch.cuda.empty_cache()
    q, k, v = first.pop("qkv")
    got = fa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize(device)
    cases = [dict(k9_case(got[h:h + 1], q[h:h + 1], k[h:h + 1], v[h:h + 1], REG_K9_TOL),
                  head=h, s=seq, kind="prefill_32k_layer0") for h in REG_K9_HEADS]
    del got
    bh, s, d = q.shape
    pairs = s * (s + 1) // 2  # (query, key) pairs with key <= query
    ops_n = 4 * bh * d * pairs
    t_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    timing = dict(ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=5, warmup=1),
                  library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                      q[None], k[None], v[None], is_causal=True), reps=5, warmup=1),
                  plain_ms_one_head=cuda_ms(lambda: kref.flash_attention_ref(
                      q[:1], k[:1], v[:1]), reps=3, warmup=1),
                  bytes=t_bytes, ops=ops_n,
                  bound_ms=max(t_bytes / HBM_BYTES_PER_S, ops_n / TENSOR_BF16_PER_S) * 1e3,
                  bound_by="bytes" if t_bytes / HBM_BYTES_PER_S >= ops_n / TENSOR_BF16_PER_S
                  else "operations", shape=[bh, s, s, d], dtype=str(q.dtype))
    del q, k, v
    torch.cuda.empty_cache()
    timed = runs[-1]
    out = dict(model=cfg.name, cell=cell.name, cell_batch=lm_common.PREFILL_SHAPE["batch"],
               batch=REG_PREFILL_BATCH, seq=seq, n_layers=cfg.n_layers, reduced=reduced,
               init_s=init_s, runs=runs, tokens_per_s=REG_PREFILL_BATCH * seq / timed["seconds"],
               model_flops=b.model_flops,
               model_flop_rate=b.model_flops / timed["seconds"],
               logits_shape=shape, logits_finite=finite, peak_memory_gb=peak_gb,
               card_memory_gb=torch.cuda.get_device_properties(device).total_memory / 1e9,
               k9_cases=cases, k9_timing=timing, nvidia_smi=smi)
    bad = [f"K9 launched {r['launches']['flash_attention']} times, not {cfg.n_layers}"
           for r in runs if r["launches"]["flash_attention"] != cfg.n_layers]
    bad += [f"another kernel launched: {r['launches']}" for r in runs
            if any(v for n, v in r["launches"].items() if n != "flash_attention")]
    if not finite or shape != [REG_PREFILL_BATCH, cfg.vocab_size]:
        bad.append(f"logits {shape}, finite {finite}")
    bad += [f"K9 head {c['head']} disagrees with its plain version: {c}" for c in cases
            if c["flash_attention_mismatches"]]
    return out, timed["launches"]["flash_attention"], timing, cases, bad


_SGE_SMOKE_LINE = re.compile(r"^\[train\] sge smoke: (\{.*\})$", re.M)


def registry_driver(device) -> dict:
    """14d: ``repro_torch.launch.train.main(["--arch", "sge"])`` on the card:
    its matches and states against ``ref_enumerate`` on the smoke's own
    target and pattern."""
    import ast
    import io

    from repro_torch.core.ref import ref_enumerate
    from repro_torch.data import graphgen
    from repro_torch.launch import train as launch

    buf = io.StringIO()
    t0 = time.perf_counter()
    (rc, counts) = _launched(lambda: _main_quiet(launch, buf))
    seconds = time.perf_counter() - t0
    m = _SGE_SMOKE_LINE.search(buf.getvalue())
    got = ast.literal_eval(m.group(1)) if m else None
    tgt = graphgen.random_graph(48, 160, n_labels=4, seed=3)
    ref = ref_enumerate(graphgen.extract_pattern(tgt, 5, seed=4), tgt, variant="ri-ds-si-fc")
    ok = (rc == 0 and got is not None and (got["matches"], got["states"]) ==
          (float(ref.matches), float(ref.states)))
    return dict(argv=["--arch", "sge"], rc=rc, smoke=got, ref=dict(matches=ref.matches,
                states=ref.states), seconds=seconds, launches={k: v for k, v in counts.items()
                                                               if v}, ok=ok)


def _main_quiet(launch, buf) -> int:
    with contextlib.redirect_stdout(buf):
        return launch.main(["--arch", "sge"])


def run_registry_path(device, smi: str) -> tuple:
    """Phase 14: 14a the cells built on meta tensors, 14b the four ``sge``
    cells at their exact shapes, 14c minitron-8b's ``prefill_32k`` cell at
    batch 1, 14d the driver's ``sge`` smoke.  Returns (launches per kernel,
    K9's timing at S = 32,768, the K9 cases)."""
    from repro_torch.configs import registry

    t_phase = time.perf_counter()
    cells = registry_cells(device)
    emit(dict(phase="registry_cells", nvidia_smi=smi, **cells))
    launches, bad = {}, []
    for name, cell in registry.get("sge").cells.items():
        for loaded in (False, True):
            row, counts, cell_bad = registry_sge_cell(device, name, cell, loaded)
            emit(dict(phase="registry_sge", nvidia_smi=smi, **row))
            _add(launches, counts)
            bad += [f"{name} {row['case']}: {b}" for b in cell_bad]
    if bad:
        raise AssertionError(f"the sge cells failed their gates: {bad}")
    prefill, k9, k9_timing_, k9_cases, bad = registry_prefill_32k(device, smi)
    emit(dict(phase="registry_prefill_32k", **prefill))
    if bad:
        raise AssertionError(f"minitron-8b's prefill_32k cell failed its gates: {bad}")
    _add(launches, {"flash_attention": k9})
    driver = registry_driver(device)
    emit(dict(phase="registry_driver", **driver))
    if not driver["ok"]:
        raise AssertionError(f"the driver's sge smoke failed: {driver}")
    emit(dict(phase="registry_done", launches=launches, nvidia_smi=smi,
              registry_path_s=time.perf_counter() - t_phase))
    return launches, k9_timing_, k9_cases


# ---------------------------------------------------------------------------
# phase 15: the distributed layer and the dry-run
# ---------------------------------------------------------------------------

def _cuda_s(device, fn):
    """``fn()`` and its seconds, the card synchronised before and after."""
    import torch

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def dist_dryrun(device) -> dict:
    """15a: every cell through ``dryrun.run_cell`` on both production
    meshes; the card's allocated memory must not move.  Prints each cell's
    argument bytes per device on each mesh against the card's memory."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import describe, make_production_mesh

    card = torch.cuda.get_device_properties(device).total_memory
    meshes = {"single": make_production_mesh(multi_pod=False),
              "multi": make_production_mesh(multi_pod=True)}
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    rows = []
    for cell in registry.all_cells():
        row = dict(cell=cell.name, kind=cell.kind)
        if cell.build is None:
            rows.append(dict(row, skip_reason=cell.skip_reason))
            continue
        for name, mesh in meshes.items():
            mem = dryrun.run_cell(cell, mesh)["memory_analysis"]
            row[f"{name}_arg_bytes_per_device"] = mem["argument_size_in_bytes"]
            row[f"{name}_donated_bytes_per_device"] = mem["alias_size_in_bytes"]
        rows.append(row)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    after = torch.cuda.memory_allocated(device)
    run = [r for r in rows if "skip_reason" not in r]
    over = {name: [r["cell"] for r in run if r[f"{name}_arg_bytes_per_device"] > card]
            for name in meshes}
    out = dict(meshes={k: describe(m) for k, m in meshes.items()}, cells=len(rows),
               records_per_mesh=len(run), skipped=[r["cell"] for r in rows if "skip_reason" in r],
               wall_s=wall, card_memory_bytes=card, allocated_before=before,
               allocated_after=after, over_card=over, rows=rows)
    if (len(rows), len(run)) != (44, 39) or after != before:
        raise AssertionError(f"15a: {len(rows)} cells, {len(run)} recorded, allocated "
                             f"{before} -> {after} bytes")
    return out


def dist_reshard(device, smi: str) -> dict:
    """15b: minitron-8b at ``TRAIN_FULL``'s width saved, restored without
    ``like_*`` and placed onto the local mesh and onto ``DIST_RESHARD`` on
    the card.  Gates: shard shapes, ``gather`` bit-equal, resident bytes =
    mesh devices × the dry-run's bytes per device."""
    import shutil

    import torch

    from repro_torch.checkpoint import gather, place, store
    from repro_torch.checkpoint.reshard import PlacedLeaf
    from repro_torch.configs import minitron_8b, overrides
    from repro_torch.core.engine import Mesh
    from repro_torch.distributed.shardings import is_logical_leaf, named_sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves, leaves_with_paths, unflatten_like

    cfg = overrides.apply(minitron_8b.CFG, TRAIN_FULL)
    logical = tf.param_logical(cfg)
    torch.cuda.empty_cache()
    params = tf.init_params(cfg, seed=LM_SEED, device=device)
    shutil.rmtree(DIST_CKPT, ignore_errors=True)
    DIST_CKPT.mkdir(parents=True)
    disk_free = shutil.disk_usage(DIST_CKPT).free
    t0 = time.perf_counter()
    store.save(str(DIST_CKPT), 1, params)
    save_s = time.perf_counter() - t0
    ckpt_bytes = sum(f.stat().st_size for f in DIST_CKPT.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    step, flat, _ = store.restore(str(DIST_CKPT), 1)
    restore_s = time.perf_counter() - t0
    host = unflatten_like(params, [flat["['params']" + p] for p, _ in leaves_with_paths(params)])
    del flat
    is_placed = lambda x: isinstance(x, PlacedLeaf)  # noqa: E731
    bad, placements = [], []
    for label, mesh in (("local", make_local_mesh()),
                        ("data2_model2", Mesh((device,) * 4, *DIST_RESHARD))):
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        placed, place_s = _cuda_s(device, lambda: place(host, logical, mesh))
        after = torch.cuda.memory_allocated(device)
        resident = sum(x.nbytes for x in leaves(placed, is_placed))
        per_device = dryrun.argument_bytes(dryrun.leaf_records((logical,), (params,), mesh))
        n_shards = sum(len(x.shards) for x in leaves(placed, is_placed))
        shapes_ok, equal = True, True
        t0 = time.perf_counter()
        for (path, want), leaf, log in zip(leaves_with_paths(params), leaves(placed, is_placed),
                                           leaves(logical, is_logical_leaf)):
            shard = named_sharding(log, want.shape, mesh).shard_shape(want.shape)
            shapes_ok &= all(tuple(s.shape) == shard and s.device == device
                             for s in leaf.shards)
            got = gather(leaf)
            equal &= torch.equal(got.view(torch.int16), want.view(torch.int16))
            del got
        gather_s = time.perf_counter() - t0
        row = dict(mesh=label, shape=mesh.shape, devices=[str(d) for d in mesh.devices],
                   place_s=place_s, gather_check_s=gather_s, shards=n_shards,
                   resident_bytes=resident, dryrun_bytes_per_device=per_device,
                   dryrun_resident_bytes=mesh.size * per_device,
                   allocated_delta_bytes=after - before, shard_shapes_ok=shapes_ok,
                   gather_bit_equal=equal)
        placements.append(row)
        # each shard is an allocation of its own: the allocator rounds each
        # up, by at most 1 MiB (a block it does not split) plus 512 bytes
        if not (shapes_ok and equal and resident == mesh.size * per_device
                and 0 <= after - before - resident <= n_shards * ((1 << 20) + 512)):
            bad.append(row)
        del placed
    shutil.rmtree(DIST_CKPT, ignore_errors=True)
    out = dict(model=cfg.name, overrides=TRAIN_FULL, params=cfg.param_count(),
               dtype=str(cfg.dtype), param_bytes=sum(x.numel() * x.element_size()
                                                     for x in leaves(params)),
               step=step, ckpt_bytes=ckpt_bytes, disk_free_bytes=disk_free, save_s=save_s,
               restore_s=restore_s, placements=placements, nvidia_smi=smi)
    del params, host
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"15b: a placement failed its gates: {bad}")
    return out


def _same_bits(a, b) -> bool:
    """``a`` and ``b`` hold the same bits (floats compared as int32 words)."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def dist_compression(device, smi: str) -> dict:
    """15c: ``compress_grads`` twice over a bf16 tree of 15b's shapes; the
    sampled leaves recomputed on the CPU bit for bit; error feedback over
    ``DIST_EF_STEPS`` steps on ``embed`` at full width."""
    import torch

    from repro_torch.configs import minitron_8b, overrides
    from repro_torch.distributed import compression as comp
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves, leaves_with_paths, unflatten_like

    cfg = overrides.apply(minitron_8b.CFG, TRAIN_FULL)
    shapes = leaves_with_paths(tf.abstract_params(cfg))
    gen = torch.Generator(device=device)
    gen.manual_seed(DIST_GRAD_SEED)
    grads = unflatten_like(tf.abstract_params(cfg), [
        torch.randn(x.shape, generator=gen, device=device, dtype=torch.bfloat16)
        for _, x in shapes])
    err = comp.init_error(grads)
    torch.cuda.empty_cache()
    calls = []
    for _ in range(2):
        (dec, err), s = _cuda_s(device, lambda: comp.compress_grads(grads, err))
        calls.append(s)
        del dec
    elements = sum(x.numel() for x in leaves(grads))
    # the sampled leaves: every leaf of one layer and a row block of embed
    samples = [(f"{p}[{DIST_CHECK_LAYER}]", (DIST_CHECK_LAYER,))
               for p, _ in shapes if p.startswith("['layers']")]
    samples.append((f"['embed'][:{DIST_EMBED_ROWS}]", (slice(0, DIST_EMBED_ROWS),)))
    g_of = dict(leaves_with_paths(grads))
    e_of = dict(leaves_with_paths(err))
    cases, t0 = [], time.perf_counter()
    for name, idx in samples:
        path = name[:name.rindex("[")]
        g, e = g_of[path][idx], e_of[path][idx]
        card = comp.compress(g, e)
        host = comp.compress(g.cpu(), e.cpu())
        equal = [_same_bits(a, b) for a, b in zip(card, host)]
        cases.append(dict(leaf=name, elements=g.numel(), payload_equal=equal[0],
                          scale_equal=equal[1], residual_equal=equal[2],
                          scale=float(card[1])))
    check_s = time.perf_counter() - t0
    del err, g_of, e_of
    # error feedback on one full-width leaf: the decoded mean tracks g
    g_true = grads["embed"]
    del grads
    torch.cuda.empty_cache()
    e = torch.zeros(g_true.shape, dtype=torch.float32, device=device)
    total = torch.zeros_like(e)
    t0 = time.perf_counter()
    for _ in range(DIST_EF_STEPS):
        q, s, e = comp.compress(g_true, e)
        total += comp.decompress(q, s)
    torch.cuda.synchronize(device)
    ef_s = time.perf_counter() - t0
    ef_err = float((total / DIST_EF_STEPS - g_true.float()).abs().max())
    out = dict(leaves=len(shapes), elements=elements, grad_dtype="bfloat16",
               payload_bytes=elements, scale_bytes=4 * len(shapes),
               residual_bytes=4 * elements, compress_grads_s=calls,
               check_cases=cases, check_s=check_s, ef_leaf="['embed']",
               ef_shape=list(g_true.shape), ef_steps=DIST_EF_STEPS, ef_max_abs_err=ef_err,
               ef_tol=DIST_EF_TOL, ef_s_per_step=ef_s / DIST_EF_STEPS, nvidia_smi=smi)
    del e, total, g_true
    torch.cuda.empty_cache()
    if not all(c["payload_equal"] and c["scale_equal"] and c["residual_equal"] for c in cases):
        raise AssertionError(f"15c: the card's compression differs from the CPU's: {cases}")
    if not ef_err <= DIST_EF_TOL:
        raise AssertionError(f"15c: error feedback off by {ef_err} > {DIST_EF_TOL}")
    return out


def run_distributed_path(device, smi: str) -> dict:
    """Phase 15: 15a the dry-run, 15b the checkpoint placed onto two
    meshes, 15c compression.  No kernel launches: the counts must not move."""
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    counts = ops.launch_counts()
    emit(dict(phase="dist_dryrun", nvidia_smi=smi, **dist_dryrun(device)))
    emit(dict(phase="dist_reshard", **dist_reshard(device, smi)))
    emit(dict(phase="dist_compression", **dist_compression(device, smi)))
    after = ops.launch_counts()
    emit(dict(phase="dist_done", launches_before=counts, launches_after=after, nvidia_smi=smi,
              dist_path_s=time.perf_counter() - t_phase))
    if after != counts:
        raise AssertionError(f"phase 15 launched kernels: {counts} -> {after}")
    return after


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
    # the plain versions' fp32 products run in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build_s = _build.build()
    ptxas = {k: [ln.strip() for ln in _build.build_log(k).splitlines()
                 if "registers" in ln or "spill" in ln or "Potential Performance Loss" in ln]
             for k in _build.KERNELS}
    k9_sass = tensor_core_instructions("flash_attention")
    emit(dict(phase="environment", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              build_s=build_s, build_wall_s=time.perf_counter() - t0, ptxas=ptxas,
              flash_attention_sass=k9_sass))
    if k9_sass.get("HGMMA") == 0:
        raise AssertionError(f"K9's bf16 route has no wgmma (HGMMA) in its SASS: {k9_sass}")
    if "--multi-card" in sys.argv[1:]:
        return multi_card_main(device, smi)

    checks, timing = check_kernels(device)
    checks += check_domain_kernels_edges(device)
    checks += check_sparse_kernels_edges(device)
    emit(dict(phase="kernels_vs_plain", cases=checks))
    bad = [c for c in checks if any(v for k, v in c.items() if k.endswith("_mismatches"))]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    launches, real_steps = run_main_path(device)
    real_cases, real_timing = check_real_steps(real_steps)
    emit(dict(phase="dense_step_real_inputs", cases=real_cases, timing=real_timing))
    if any(v for c in real_cases for k, v in c.items() if k.endswith("_mismatches")):
        raise AssertionError(f"K1 / K2 disagree on a real step's inputs: {real_cases}")
    checks += real_cases
    for name, rt in real_timing.items():
        timing[name].update({f"real_step_{k}": v for k, v in rt.items()})
    t0 = time.perf_counter()
    batch_launches, full_width = run_batch_path(device)
    full_case, full_timing = check_domain_kernels_full(device, full_width)
    emit(dict(phase="domain_kernels_full_width", case=full_case, timing=full_timing,
              batch_path_s=time.perf_counter() - t0))
    if any(v for k, v in full_case.items() if k.endswith("_mismatches")):
        raise AssertionError(f"domain kernels disagree at full width: {full_case}")
    checks.append(full_case)
    timing.update(full_timing)

    t0 = time.perf_counter()
    sparse_launches, sparse_fw = run_sparse_path(device)
    sparse_cases, sparse_timing = check_sparse_kernels_full(device, sparse_fw)
    emit(dict(phase="sparse_kernels_full_width", cases=sparse_cases, timing=sparse_timing,
              sparse_path_s=time.perf_counter() - t0))
    if any(v for c in sparse_cases for k, v in c.items() if k.endswith("_mismatches")):
        raise AssertionError(f"sparse kernels disagree at full width: {sparse_cases}")
    checks += sparse_cases
    timing.update(sparse_timing)
    phase5 = {}
    for counts in sparse_launches.values():
        _add(phase5, counts)

    t0 = time.perf_counter()
    lm_launches, k9_timing_, k9_cases = run_lm_path(device)
    emit(dict(phase="lm_done", lm_path_s=time.perf_counter() - t0))
    checks += k9_cases
    timing["flash_attention"] = k9_timing_

    dyn = run_dynamic_path(device)

    ooc, ooc_cases, ooc_timing = run_outofcore_path(device, smi)
    checks += ooc_cases
    for name, by_walk in ooc_timing.items():
        timing[name].update({f"partitioned_step_{walk}": t for walk, t in by_walk.items()})

    svc = run_service_path(device, smi)

    mesh = run_mesh_path(device, smi)

    lmf_launches, lmf_cases, lmf_timing = run_lm_family_path(device, smi)
    checks += lmf_cases
    for key, t in lmf_timing.items():
        timing["flash_attention"].update({f"{key}_{k}": t[k] for k in (
            "ms", "plain_ms", "library_ms", "fp32_ms", "ops_bound_ms", "bytes", "ops")})
        timing["flash_attention"][f"{key}_shape"] = t["shape"]

    run_train_path(device, smi)

    run_family_path(device, smi)

    reg_launches, k9_long, reg_cases = run_registry_path(device, smi)
    checks += reg_cases
    timing["flash_attention"].update({f"prefill_32k_{k}": v for k, v in k9_long.items()})

    run_distributed_path(device, smi)

    meta = {
        "extend_step": dict(source="src/repro_torch/csrc/extend_step.cu",
                            header="src/repro_torch/csrc/dense_step.cuh",
                            replaces="src/repro/kernels/extend_step.py:125",
                            launches=launches["pallas"]["extend_step"]
                            + launches["edge pallas"]["extend_step"]
                            + dyn["pallas"]["extend_step"] + svc["extend_step"]
                            + mesh.get("extend_step", 0)),
        "candidate_mask": dict(source="src/repro_torch/csrc/candidate_mask.cu",
                               header="src/repro_torch/csrc/dense_step.cuh",
                               replaces="src/repro/kernels/candidate_mask.py:62",
                               launches=launches["jnp+use_pallas"]["candidate_mask"]
                               + launches["edge jnp+use_pallas"]["candidate_mask"]
                               + dyn["jnp+use_pallas"]["candidate_mask"]
                               + svc["candidate_mask"] + mesh.get("candidate_mask", 0)),
        "popcount_rows": dict(source="src/repro_torch/csrc/popcount_rows.cu",
                              replaces="src/repro/kernels/popcount_reduce.py:31",
                              launches=batch_launches["prepare_batch"]["popcount_rows"]
                              + svc["popcount_rows"] + mesh.get("popcount_rows", 0)),
        "adjacency_any": dict(source="src/repro_torch/csrc/adjacency_any.cu",
                              header="src/repro_torch/csrc/arc_any.cuh",
                              replaces="src/repro/kernels/domain_ac.py:58",
                              launches=batch_launches["prepare_batch"]["adjacency_any"]
                              + svc["adjacency_any"]),
        "arc_any_sweep": dict(source="src/repro_torch/csrc/arc_any_sweep.cu",
                              header="src/repro_torch/csrc/arc_any.cuh",
                              replaces="src/repro/kernels/domain_ac.py:92",
                              launches=batch_launches["sweep"]["arc_any_sweep"]),
        "csr_extend": dict(source="src/repro_torch/csrc/csr_extend.cu",
                           header="src/repro_torch/csrc/csr_extend.cuh",
                           replaces="src/repro/kernels/csr_extend.py:129",
                           launches=phase5["csr_extend"] + dyn["csr flat"]["csr_extend"]
                           + ooc["csr_extend"] + svc["csr_extend"]
                           + mesh.get("csr_extend", 0)),
        "csr_extend_bucketed": dict(source="src/repro_torch/csrc/csr_extend_bucketed.cu",
                                    header="src/repro_torch/csrc/csr_extend.cuh",
                                    replaces="src/repro/kernels/csr_extend.py:319",
                                    launches=phase5["csr_extend_bucketed"]
                                    + dyn["csr bucketed"]["csr_extend_bucketed"]
                                    + dyn["edge csr bucketed"]["csr_extend_bucketed"]
                                    + ooc["csr_extend_bucketed"]
                                    + svc["csr_extend_bucketed"]
                                    + mesh.get("csr_extend_bucketed", 0)),
        "csr_arc_sweep": dict(source="src/repro_torch/csrc/csr_arc_sweep.cu",
                              header="src/repro_torch/csrc/csr_arc_sweep.cuh",
                              replaces="src/repro/kernels/domain_ac.py:165",
                              launches=phase5["csr_arc_sweep"] + svc["csr_arc_sweep"]
                              + mesh.get("csr_arc_sweep", 0)),
        "flash_attention": dict(source="src/repro_torch/csrc/flash_attention.cu",
                                replaces="src/repro/kernels/flash_attention.py:67",
                                launches=lm_launches["prefill"]["flash_attention"]
                                + lm_launches["decode"]["flash_attention"] + lmf_launches),
    }

    for name, m in meta.items():  # phase 14's launches
        m["launches"] += reg_launches.get(name, 0)

    def own(name, key, suffix):  # K5's cases include its batched form's
        return key == name + suffix or (key.startswith(name + "_pairs") and key.endswith(suffix))

    kernels = []
    for name, m in meta.items():
        t = timing[name]
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["ops"] / t.get("ops_per_s", LANE_OPS_PER_S) * 1e3
        extra = {k: v for k, v in t.items()
                 if k.startswith(("bound_", "bytes_", "target_b_", "entries_", "fp32_",
                                  "one_pair_", "k4_inputs_", "ptxas", "pairs", "planes",
                                  "cold_", "real_step_", "valid_", "lanes_", "table_",
                                  "kernel_trace", "partitioned_step_", "head_dim_",
                                  "prefill_32k_"))}
        if "header" in m:
            extra["header"] = m["header"]
        kernels.append(dict(
            name=name, route="cuda", source=m["source"], replaces=m["replaces"],
            launches=m["launches"],
            max_abs_err=max(v for c in checks for k, v in c.items() if own(name, k, "_err")),
            mismatches=sum(v for c in checks for k, v in c.items()
                           if own(name, k, "_mismatches")),
            ms=t["ms"], kernel_ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=t["bytes"], library_ms=t.get("library_ms"), **extra))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
