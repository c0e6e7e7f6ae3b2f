"""Graph representations for subgraph enumeration (host side, numpy).

A copy of the dense half of ``repro.core.graph``, kept here so that the
port imports nothing of the JAX package:

* :class:`Graph` — a labeled directed graph (undirected graphs store both
  arcs).  Preprocessing (ordering, domains) and the sequential oracle read it.
* :class:`PackedGraph` — the packed-bitmap adjacency the engine runs on.
  Row ``u`` of plane ``[l, 0]`` has bit ``v`` set iff the edge ``(u, v)``
  with label ``l`` exists; plane ``[l, 1]`` holds the reverse direction.

Bitmaps here are ``uint32`` words; the engine carries the same bits as
``int32`` tensors (`repro_torch.core.extend.make_plan_arrays`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

WORD_BITS = 32


def n_words(n: int) -> int:
    """Number of uint32 words needed to hold ``n`` bits."""
    return max(1, (n + WORD_BITS - 1) // WORD_BITS)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed, node- and edge-labeled graph (host side, numpy).

    Undirected graphs are represented by storing both arcs.
    """

    n: int
    src: np.ndarray  # [m] int32
    dst: np.ndarray  # [m] int32
    labels: np.ndarray  # [n] int32 node labels
    edge_labels: np.ndarray  # [m] int32

    @staticmethod
    def from_edges(
        n: int,
        edges: Sequence[Tuple[int, int]],
        labels: Optional[Sequence[int]] = None,
        edge_labels: Optional[Sequence[int]] = None,
        undirected: bool = False,
    ) -> "Graph":
        edges = list(edges)
        if undirected:
            edges = edges + [(v, u) for (u, v) in edges]
            if edge_labels is not None:
                edge_labels = list(edge_labels) + list(edge_labels)
        m = len(edges)
        src = np.asarray([e[0] for e in edges], dtype=np.int32)
        dst = np.asarray([e[1] for e in edges], dtype=np.int32)
        if labels is None:
            labels = np.zeros(n, dtype=np.int32)
        if edge_labels is None:
            edge_labels = np.zeros(m, dtype=np.int32)
        g = Graph(
            n=n,
            src=src,
            dst=dst,
            labels=np.asarray(labels, dtype=np.int32),
            edge_labels=np.asarray(edge_labels, dtype=np.int32),
        )
        g.validate()
        return g

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_node_labels(self) -> int:
        return int(self.labels.max()) + 1 if self.n else 0

    @property
    def n_edge_labels(self) -> int:
        return int(self.edge_labels.max()) + 1 if self.m else 1

    def validate(self) -> None:
        if self.m and not (
            self.src.min() >= 0 and self.src.max() < self.n
            and self.dst.min() >= 0 and self.dst.max() < self.n
        ):
            raise ValueError("edge endpoint out of range [0, n)")
        if self.labels.shape != (self.n,) or self.edge_labels.shape != (self.m,):
            raise ValueError("labels must be [n] and edge_labels [m]")

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int32)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n).astype(np.int32)

    def degrees(self) -> np.ndarray:
        """Total degree (in + out); for undirected graphs this double counts,
        which is consistent as long as it is used consistently."""
        return self.out_degrees() + self.in_degrees()

    def out_neighbors(self, u: int) -> np.ndarray:
        return self.dst[self.src == u]

    def in_neighbors(self, u: int) -> np.ndarray:
        return self.src[self.dst == u]

    def neighbors(self, u: int) -> np.ndarray:
        return np.unique(np.concatenate([self.out_neighbors(u), self.in_neighbors(u)]))

    def adjacency_bitmaps(self, w: Optional[int] = None) -> np.ndarray:
        """Packed adjacency bitmaps ``[n_edge_labels, 2, n, w]`` uint32.

        ``[l, 0, u]`` row: bit ``v`` set iff ``(u, v) in E`` with label ``l``
        ``[l, 1, u]`` row: bit ``v`` set iff ``(v, u) in E`` with label ``l``
        """
        w = w or n_words(self.n)
        nl = self.n_edge_labels
        bits = np.zeros((nl, 2, self.n, w), dtype=np.uint32)
        word = (self.dst // WORD_BITS).astype(np.int64)
        bit = np.uint32(1) << (self.dst % WORD_BITS).astype(np.uint32)
        np.bitwise_or.at(bits, (self.edge_labels, 0, self.src, word), bit)
        word_in = (self.src // WORD_BITS).astype(np.int64)
        bit_in = np.uint32(1) << (self.src % WORD_BITS).astype(np.uint32)
        np.bitwise_or.at(bits, (self.edge_labels, 1, self.dst, word_in), bit_in)
        return bits


@dataclasses.dataclass(frozen=True)
class PackedGraph:
    """Packed form of a target graph.

    Attributes:
      n: number of target nodes.
      w: number of uint32 words per node bitmap row (``>= ceil(n/32)``).
      adj_bits: ``[n_edge_labels, 2, n, w]`` uint32 adjacency bitmaps.
      labels: ``[n]`` int32.
      deg_out / deg_in: ``[n]`` int32.
    """

    n: int
    w: int
    adj_bits: np.ndarray
    labels: np.ndarray
    deg_out: np.ndarray
    deg_in: np.ndarray

    @staticmethod
    def from_graph(g: Graph, w: Optional[int] = None, pad_words_to: int = 1) -> "PackedGraph":
        w = w or n_words(g.n)
        if pad_words_to > 1:
            w = ((w + pad_words_to - 1) // pad_words_to) * pad_words_to
        return PackedGraph(
            n=g.n,
            w=w,
            adj_bits=g.adjacency_bitmaps(w),
            labels=g.labels.copy(),
            deg_out=g.out_degrees(),
            deg_in=g.in_degrees(),
        )

    @property
    def n_edge_labels(self) -> int:
        return int(self.adj_bits.shape[0])


def bitmap_from_indices(idx: np.ndarray, n: int, w: Optional[int] = None) -> np.ndarray:
    """Pack node indices into a ``[w]`` uint32 bitmap."""
    w = w or n_words(n)
    out = np.zeros(w, dtype=np.uint32)
    idx = np.asarray(idx, dtype=np.int64)
    np.bitwise_or.at(out, idx // WORD_BITS, np.uint32(1) << (idx % WORD_BITS).astype(np.uint32))
    return out


def bitmap_to_indices(bits: np.ndarray) -> np.ndarray:
    """Unpack a ``[w]`` uint32 bitmap into sorted node indices."""
    b = np.asarray(bits, dtype=np.uint32)
    set_bits = (b[:, None] >> np.arange(WORD_BITS, dtype=np.uint32)) & np.uint32(1)
    wi, bi = np.nonzero(set_bits)
    return (wi * WORD_BITS + bi).astype(np.int64)


def popcount(bits: np.ndarray) -> np.ndarray:
    """Per-row popcount of a uint32 bitmap array (last axis reduced)."""
    b = np.asarray(bits, dtype=np.uint32)
    b = b - ((b >> 1) & np.uint32(0x55555555))
    b = (b & np.uint32(0x33333333)) + ((b >> 2) & np.uint32(0x33333333))
    b = (b + (b >> 4)) & np.uint32(0x0F0F0F0F)
    return ((b * np.uint32(0x01010101)) >> 24).astype(np.int64).sum(axis=-1)
