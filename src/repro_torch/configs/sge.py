"""sge — the paper's own workload as registry cells (a port of
``repro.configs.sge``; beyond the 40 assigned cells).

One cell per data collection, sized to the collection's largest target graph
(Table 1 of the paper), running **one engine round** (``rebalance_interval``
expansion steps + one steal round):

  * ``sge_ppis32``     n_t = 12,575  (dense PPI)
  * ``sge_graemlin32`` n_t =  6,726  (dense microbial)
  * ``sge_pdbsv1``     n_t = 33,067  (large sparse)
  * ``sge_pdbsv1_csr`` n_t = 33,067 on CSR planes (``ri-ds-si-acfc``)

Bitmap words are padded to multiples of 128 (``repro``'s tensor-axis rule),
so a cell's ``w`` is wider than the index's own: a concrete run at the
cell's shapes packs its target with ``PackedGraph.from_graph(
pad_words_to=128)`` and builds its plan with ``p_pad=P_PAD,
max_parents=MAX_PARENTS``.  The abstract state is a pack of one
(`repro_torch.core.frontier.abstract_engine_state`).  The dense cells run
``ENGINE`` as ``repro`` does (``step_backend="jnp"``: plain PyTorch); the
CSR cell's step is the sparse walk with ``use_pallas``, so on the card its
round goes through K7 (``csr_walk="bucketed"``).

MODEL_FLOPS: useful bitwise word-lane ops per round =
``R · V · E · W · (max_parents + 3)`` (dom ∧ ¬used ∧ parents, push/pop
bookkeeping excluded), counted at 1 op per 32-bit word-lane.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

from repro_torch.configs import registry
from repro_torch.configs.registry import Arch, Cell, CellBuild, round_up
from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex
from repro_torch.core import engine as eng
from repro_torch.core import extend, frontier
from repro_torch.core.ref import ref_enumerate
from repro_torch.data import graphgen

P_PAD = 64  # pattern positions
MAX_PARENTS = 8
ENGINE = EngineConfig(
    n_workers=64,
    expand_width=64,
    steal_chunk=4,  # the paper's best task-group size (Fig. 4)
    rebalance_interval=8,
    store_used=True,
)

COLLECTION_NT = {
    "sge_ppis32": 12575,
    "sge_graemlin32": 6726,
    "sge_pdbsv1": 33067,
}

# The genuinely-sparse pdbsv1-class cell: same n_t, but the adjacency is
# CSR planes sized for a mean degree of ~8 — the dense cells above carry
# [n_elab, 2, n_t, w] bitmaps (~273 MB at this n_t per label plane pair),
# which the csr step backend never materializes.
SPARSE_AVG_DEG = 8
SPARSE_DEG_CAP = 512
# The CSR cell runs the paper's strongest variant: its AC ⇄ FC domains come
# from the CSR-native fixpoint — no dense adjacency exists at any point of
# preprocessing or enumeration.
CSR_VARIANT = "ri-ds-si-acfc"


def _w_for(n_t: int) -> int:
    return round_up((n_t + 31) // 32, 128)


def build_round(n_t: int, cfg: EngineConfig = ENGINE) -> CellBuild:
    w = _w_for(n_t)
    plan_abs = extend.abstract_plan_arrays(n_t, w, P_PAD, MAX_PARENTS)
    state_abs = frontier.abstract_engine_state(cfg, w, P_PAD)

    def round_fn(plan, state):
        return eng.make_round_fn(cfg, plan)(state)

    flops = (
        cfg.rebalance_interval
        * cfg.n_workers
        * cfg.expand_width
        * w
        * (MAX_PARENTS + 3)
    )
    return CellBuild(
        fn=round_fn,
        args=(plan_abs, state_abs),
        logical=(extend.PLAN_LOGICAL, frontier.STATE_LOGICAL),
        model_flops=float(flops),
        note=f"one engine round; n_t={n_t} w={w} V={cfg.n_workers} E={cfg.expand_width}",
        donate=(1,),
    )


def build_csr_round(n_t: int, cfg: EngineConfig = ENGINE) -> CellBuild:
    """One engine round through the sparse CSR step — the >33k-node regime
    where the dense cells' ``[n_t, w]`` bitmap rows stop fitting."""
    cfg = dataclasses.replace(cfg, step_backend="csr", use_pallas=True)
    w = _w_for(n_t)
    nnz = 2 * n_t * SPARSE_AVG_DEG  # out + in planes
    plan_abs = extend.abstract_csr_plan_arrays(
        n_t, w, P_PAD, MAX_PARENTS, nnz=nnz, deg_cap=SPARSE_DEG_CAP,
    )
    state_abs = frontier.abstract_engine_state(cfg, w, P_PAD)

    def round_fn(plan, state):
        return eng.make_round_fn(cfg, plan)(state)

    # per lane per step: deg_cap-wide driver gather + dedupe, MAX_PARENTS
    # binary searches of log2(deg_cap) compares each, and the w-word
    # base/scatter work — all counted at 1 op per 32-bit word-lane.
    log_deg = max(1, (SPARSE_DEG_CAP - 1).bit_length())
    per_lane = SPARSE_DEG_CAP * (2 + MAX_PARENTS * log_deg) + 2 * w
    flops = (
        cfg.rebalance_interval * cfg.n_workers * cfg.expand_width * per_lane
    )
    return CellBuild(
        fn=round_fn,
        args=(plan_abs, state_abs),
        logical=(extend.CSR_PLAN_LOGICAL, frontier.STATE_LOGICAL),
        model_flops=float(flops),
        note=(
            f"one csr engine round ({CSR_VARIANT}, CSR-native domains); "
            f"n_t={n_t} nnz={nnz} "
            f"deg_cap={SPARSE_DEG_CAP} V={cfg.n_workers} E={cfg.expand_width}"
        ),
        donate=(1,),
    )


def smoke(device=None) -> Dict[str, float]:
    """End-to-end enumeration on a generated PPI-like instance through the
    session API on ``device`` (the card by default), verified against the
    sequential oracle; a second same-bucket query must reuse the session's
    one upload, and a one-device mesh, the csr step and a CSR-only index
    under ``CSR_VARIANT`` must give the same matches."""
    device = eng.resolve_device(device)
    cfg = EngineConfig(n_workers=4, expand_width=4)
    tgt = graphgen.random_graph(48, 160, n_labels=4, seed=3)
    session = Enumerator(SubgraphIndex.build(tgt), config=cfg, device=device)
    pat = graphgen.extract_pattern(tgt, 5, seed=4)
    res = session.run(session.prepare(pat, name="smoke0"))
    ref = ref_enumerate(pat, tgt, variant="ri-ds-si-fc")
    assert res.matches == ref.matches and res.states == ref.states, (
        res.matches, res.states, ref.matches, ref.states,
    )
    assert res.matches >= 1  # extracted patterns always occur
    pat2 = graphgen.extract_pattern(tgt, 6, seed=5)
    session.run(session.prepare(pat2, name="smoke1"))
    info = session.cache_stats()
    assert info["uploads"] == 1 and info["cache_hits"] >= 1, info
    # the mesh-sharded path on one device must be bit-identical
    sharded = Enumerator(SubgraphIndex.build(tgt), config=cfg, mesh=eng.Mesh((device,)))
    res_sh = sharded.run(sharded.prepare(pat, name="smoke0-sharded"))
    assert (res_sh.matches, res_sh.states) == (res.matches, res.states), (
        res_sh.matches, res_sh.states, res.matches, res.states,
    )
    # the sparse CSR backend must reproduce the dense result bit for bit
    csr = Enumerator(SubgraphIndex.build(tgt), device=device,
                     config=dataclasses.replace(cfg, step_backend="csr"))
    res_csr = csr.run(csr.prepare(pat, name="smoke0-csr"))
    assert (res_csr.matches, res_csr.states) == (res.matches, res.states), (
        res_csr.matches, res_csr.states, res.matches, res.states,
    )
    # the CSR-only pipeline: a sparse index under the full ri-ds-si-acfc
    # variant, domains from the CSR-native AC ⇄ FC fixpoint, and the match
    # set equal to the dense session's
    sparse = Enumerator(SubgraphIndex.build(tgt, sparse=True), variant=CSR_VARIANT,
                        device=device, config=dataclasses.replace(cfg, step_backend="csr"))
    res_sp = sparse.run(sparse.prepare(pat, name="smoke0-sparse"))
    assert res_sp.matches == res.matches, (res_sp.matches, res.matches)
    return {
        "matches": float(res.matches),
        "states": float(res.states),
        "engine_uploads": float(info["uploads"]),
    }


ARCH = registry.register(
    Arch(
        name="sge",
        family="sge",
        cfg=ENGINE,
        cells={
            **{
                name: Cell("sge", name, "engine", functools.partial(build_round, nt))
                for name, nt in COLLECTION_NT.items()
            },
            "sge_pdbsv1_csr": Cell(
                "sge", "sge_pdbsv1_csr", "engine",
                functools.partial(build_csr_round, COLLECTION_NT["sge_pdbsv1"]),
            ),
        },
        smoke=smoke,
        notes="The paper's contribution itself; see DESIGN.md §2 for the "
        "work-stealing → SPMD mapping.",
    )
)
