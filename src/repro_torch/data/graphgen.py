"""Synthetic SGE collections and model inputs: a copy of
``repro.data.graphgen`` (``random_graph``, ``power_law_graph``,
``extract_pattern``, ``make_collection``; ``gnn_batch``, the GraphCast
``mesh_overlay`` and its shapes, ``lm_batch``, ``din_batch``,
``icosa_mesh_shape``), all numpy.

Scaled analogues of the paper's three data sets (Table 1), with patterns
extracted as connected subgraphs (so each has at least one match), sized by
edge count as in the paper.  Same seeds, same graphs and arrays as
``repro``: the tests and ``chip_smoke.py`` rely on that.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Graph

def random_graph(
    n: int,
    m: int,
    n_labels: int,
    label_dist: str = "uniform",
    n_edge_labels: int = 1,
    undirected: bool = True,
    seed: int = 0,
) -> Graph:
    rng = np.random.default_rng(seed)
    edges = set()
    tries = 0
    while len(edges) < m and tries < 50 * m:
        u, v = rng.integers(0, n, 2)
        tries += 1
        if u == v:
            continue
        key = (int(u), int(v))
        if key in edges or (undirected and (int(v), int(u)) in edges):
            continue
        edges.add(key)
    edges = sorted(edges)
    if label_dist == "normal":
        raw = rng.normal(n_labels / 2.0, n_labels / 6.0, n)
        labels = np.clip(np.round(raw), 0, n_labels - 1).astype(np.int32)
    else:
        labels = rng.integers(0, n_labels, n).astype(np.int32)
    elabels = rng.integers(0, n_edge_labels, len(edges)).astype(np.int32)
    return Graph.from_edges(n, edges, labels=labels, edge_labels=elabels, undirected=undirected)


def power_law_graph(
    n: int,
    avg_deg: float = 4.0,
    alpha: float = 2.0,
    n_labels: int = 8,
    n_edge_labels: int = 1,
    undirected: bool = True,
    seed: int = 0,
) -> Graph:
    """Random graph with power-law degree skew — the ``n_t ≫ lanes``
    sparse regime the CSR step backend targets.

    Endpoints are sampled with probability ∝ ``rank^-alpha`` (ranks
    permuted over node ids), so a few hubs carry long neighbor rows while
    the tail is near-isolated; ``avg_deg`` fixes the expected mean degree.
    Duplicate pairs and self-loops are dropped, labels are uniform.
    """
    rng = np.random.default_rng(seed)
    m_target = max(1, int(n * avg_deg / 2))
    w = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    w = rng.permutation(w)
    # 30% uniform floor: pure rank^-alpha mass concentrates on a handful of
    # hubs, whose pairings saturate under dedup and starve the edge budget;
    # the floor keeps tail pairs flowing while hubs stay hubs.
    p = 0.7 * w / w.sum() + 0.3 / n
    seen = set()
    edges: List[Tuple[int, int]] = []
    tries = 0
    # heavy-tailed weights resample hub-hub duplicates often; keep drawing
    # until the edge budget is met (the yield per round shrinks as hub pairs
    # saturate, so the bound is generous)
    while len(edges) < m_target and tries < 64:
        tries += 1
        k = 2 * (m_target - len(edges)) + 16
        us = rng.choice(n, size=k, p=p)
        vs = rng.choice(n, size=k, p=p)
        for u, v in zip(us.tolist(), vs.tolist()):
            if u == v:
                continue
            key = (min(u, v), max(u, v)) if undirected else (u, v)
            if key in seen:
                continue
            seen.add(key)
            edges.append((u, v))
            if len(edges) >= m_target:
                break
    return Graph.from_edges(
        n,
        edges,
        labels=rng.integers(0, n_labels, n).astype(np.int32),
        edge_labels=rng.integers(0, n_edge_labels, len(edges)).astype(np.int32),
        undirected=undirected,
    )


def extract_pattern(g: Graph, n_edges: int, seed: int = 0,
                    start: Optional[int] = None) -> Graph:
    """Random connected subgraph with ~n_edges edges (paper pattern style);
    guarantees at least one isomorphic occurrence in ``g``."""
    rng = np.random.default_rng(seed)
    start = int(rng.integers(g.n)) if start is None else int(start)
    nodes = [start]
    node_set = {start}
    kept: List[Tuple[int, int, int]] = []

    def count_directed() -> int:
        return len(kept)

    while count_directed() < n_edges:
        grown = False
        rng.shuffle(nodes)
        for u in list(nodes):
            nbrs = g.neighbors(u)
            rng.shuffle(nbrs)
            for v in nbrs:
                v = int(v)
                if v in node_set:
                    continue
                node_set.add(v)
                nodes.append(v)
                grown = True
                break
            if grown:
                break
        if not grown:
            break
        # collect all induced edges among chosen nodes
        kept = [
            (int(u), int(v), int(l))
            for u, v, l in zip(g.src, g.dst, g.edge_labels)
            if int(u) in node_set and int(v) in node_set
        ]
        if len(kept) >= n_edges:
            break
    kept = [
        (int(u), int(v), int(l))
        for u, v, l in zip(g.src, g.dst, g.edge_labels)
        if int(u) in node_set and int(v) in node_set
    ]
    idx = {u: i for i, u in enumerate(sorted(node_set))}
    edges = [(idx[u], idx[v]) for u, v, _ in kept]
    elabels = [l for _, _, l in kept]
    labels = g.labels[sorted(node_set)]
    return Graph.from_edges(len(idx), edges, labels=labels, edge_labels=elabels)


@dataclasses.dataclass
class Instance:
    target: Graph
    pattern: Graph
    name: str


# name: (n_targets, n, m, nodes_per_label, label_dist) at scale=1.0.
# The nodes/label ratio controls search-space hardness at reduced scale
# (calibrated so the scale=0.5 corpus lands at 10^5–10^6 states per
# collection with clear long/short instance spread — see EXPERIMENTS.md
# §Methodology).  PPIS32-like keeps the paper's skewed (normal) label
# distribution; rare tail labels are what give forward checking its
# singleton domains.
COLLECTIONS = {
    "ppis32-like": (4, 800, 10000, 33, "normal"),
    "graemlin32-like": (4, 500, 7000, 31, "uniform"),
    "pdbsv1-like": (4, 2400, 7200, 240, "uniform"),
}


def make_collection(
    name: str,
    pattern_edges: Sequence[int] = (4, 8, 16, 32),
    patterns_per_target: int = 3,
    scale: float = 1.0,
    seed: int = 0,
    n_targets: Optional[int] = None,
) -> List[Instance]:
    """Scaled-down analogue of one of the paper's collections.

    ``n_targets`` keeps only the first targets (default: all of the
    collection's); each target and its patterns depend only on ``seed`` and
    the target's position, so they are the same either way."""
    all_targets, n, m, npl, dist = COLLECTIONS[name]
    out: List[Instance] = []
    for t in range(all_targets if n_targets is None else min(n_targets, all_targets)):
        tn = max(32, int(n * scale))
        tm = max(tn, int(m * scale))
        n_labels = max(2, round(tn / npl))
        g = random_graph(tn, tm, n_labels, dist, seed=seed * 1000 + t)
        # rare-label node (smallest label class): half the patterns start
        # there, giving the FC singleton conditions the paper's skewed-label
        # collections exhibit
        label_counts = np.bincount(g.labels, minlength=n_labels)
        label_counts = np.where(label_counts == 0, 1 << 30, label_counts)
        rare_nodes = np.nonzero(g.labels == int(np.argmin(label_counts)))[0]
        k = 0
        for pe in pattern_edges:
            for r in range(patterns_per_target):
                start = int(rare_nodes[r % len(rare_nodes)]) if (
                    r % 2 == 1 and len(rare_nodes)
                ) else None
                p = extract_pattern(g, pe, seed=seed * 10000 + t * 100 + k,
                                    start=start)
                if p.m > 0:
                    out.append(Instance(target=g, pattern=p, name=f"{name}/t{t}/e{pe}/r{r}"))
                k += 1
    return out


def lm_batch(batch: int, seq: int, vocab: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random token ids ``[batch, seq]`` (int32) and next-token labels (the
    last one -1), from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    return {"tokens": toks, "labels": labels}


# ---------------------------------------------------------------------------
# model-input synthesis (GNN, GraphCast mesh, DIN)
# ---------------------------------------------------------------------------

def gnn_batch(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    n_classes: int = 0,
    with_positions: bool = False,
    n_graphs: int = 1,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {
        "feats": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "src": rng.integers(0, n_nodes, n_edges).astype(np.int32),
        "dst": rng.integers(0, n_nodes, n_edges).astype(np.int32),
    }
    if n_classes > 0:
        out["labels"] = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    if with_positions:
        out["positions"] = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 3.0
    if n_graphs > 1:
        per = n_nodes // n_graphs
        out["graph_ids"] = np.minimum(np.arange(n_nodes) // per, n_graphs - 1).astype(np.int32)
        out["graph_targets"] = rng.normal(size=(n_graphs, 1)).astype(np.float32)
        out.pop("labels", None)
    return out


def mesh_overlay_shapes(
    n_nodes: int, d_edge: int = 4, fanout: int = 4
) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Shape/dtype spec of the GraphCast mesh hierarchy (no allocation)."""
    nm = max(8, n_nodes // 4)
    eg2m = n_nodes * fanout
    em = nm * 8
    em2g = n_nodes * fanout
    return {
        "mesh_feats": ((nm, d_edge), "float32"),
        "g2m_src": ((eg2m,), "int32"),
        "g2m_dst": ((eg2m,), "int32"),
        "g2m_efeats": ((eg2m, d_edge), "float32"),
        "mesh_src": ((em,), "int32"),
        "mesh_dst": ((em,), "int32"),
        "mesh_efeats": ((em, d_edge), "float32"),
        "m2g_src": ((em2g,), "int32"),
        "m2g_dst": ((em2g,), "int32"),
        "m2g_efeats": ((em2g, d_edge), "float32"),
    }


MESH_OVERLAY_LOGICAL = {
    "mesh_feats": ("batch", None),
    "g2m_src": ("edge",),
    "g2m_dst": ("edge",),
    "g2m_efeats": ("edge", None),
    "mesh_src": ("edge",),
    "mesh_dst": ("edge",),
    "mesh_efeats": ("edge", None),
    "m2g_src": ("edge",),
    "m2g_dst": ("edge",),
    "m2g_efeats": ("edge", None),
}


def mesh_overlay(
    n_nodes: int, d_edge: int = 4, fanout: int = 4, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Synthetic mesh hierarchy for GraphCast-style cells: mesh nodes a
    quarter of the grid's, fanout-4 bipartite edges."""
    rng = np.random.default_rng(seed)
    nm = max(8, n_nodes // 4)
    eg2m = n_nodes * fanout
    em = nm * 8
    em2g = n_nodes * fanout
    return {
        "mesh_feats": rng.normal(size=(nm, d_edge)).astype(np.float32),
        "g2m_src": rng.integers(0, n_nodes, eg2m).astype(np.int32),
        "g2m_dst": rng.integers(0, nm, eg2m).astype(np.int32),
        "g2m_efeats": rng.normal(size=(eg2m, d_edge)).astype(np.float32),
        "mesh_src": rng.integers(0, nm, em).astype(np.int32),
        "mesh_dst": rng.integers(0, nm, em).astype(np.int32),
        "mesh_efeats": rng.normal(size=(em, d_edge)).astype(np.float32),
        "m2g_src": rng.integers(0, nm, em2g).astype(np.int32),
        "m2g_dst": rng.integers(0, n_nodes, em2g).astype(np.int32),
        "m2g_efeats": rng.normal(size=(em2g, d_edge)).astype(np.float32),
    }


def din_batch(
    batch: int, seq_len: int, n_items: int, n_cats: int, d_dense: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "hist_items": rng.integers(0, n_items, (batch, seq_len)).astype(np.int32),
        "hist_cats": rng.integers(0, n_cats, (batch, seq_len)).astype(np.int32),
        "hist_len": rng.integers(1, seq_len + 1, batch).astype(np.int32),
        "target_item": rng.integers(0, n_items, batch).astype(np.int32),
        "target_cat": rng.integers(0, n_cats, batch).astype(np.int32),
        "dense": rng.normal(size=(batch, d_dense)).astype(np.float32),
        "click": rng.integers(0, 2, batch).astype(np.int32),
    }


def icosa_mesh_shape(refinement: int) -> Tuple[int, int]:
    """(n_mesh_nodes, n_mesh_edges_directed) of an icosahedral refinement."""
    n = 10 * 4**refinement + 2
    e = 2 * (30 * 4**refinement)
    return n, e
