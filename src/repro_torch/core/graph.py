"""Graph representations for subgraph enumeration (host side, numpy).

A copy of ``repro.core.graph``, kept here so that the port imports nothing
of the JAX package:

* :class:`Graph` — a labeled directed graph (undirected graphs store both
  arcs).  Preprocessing (ordering, domains) and the sequential oracle read it.
* :class:`PackedGraph` — the packed-bitmap adjacency the dense engine runs
  on.  Row ``u`` of plane ``[l, 0]`` has bit ``v`` set iff the edge
  ``(u, v)`` with label ``l`` exists; plane ``[l, 1]`` holds the reverse
  direction.
* :class:`CsrPlanes` — the same adjacency as sorted, deduplicated CSR rows
  per ``(edge_label, direction)`` plane: the layout of the sparse engine
  (``step_backend="csr"``), ``O(nnz + n_planes · n_t)`` words instead of
  the bitmaps' ``O(n_planes · n_t · w)``.
* :class:`PartitionedPlanes` — contiguous row ranges of those planes, the
  out-of-core layout (``step_backend="partitioned"``): one range's rows are
  on the device at a time.

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

    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Out-adjacency CSR: (indptr [n+1], indices [m], edge_labels [m]).

        ``indices`` are sorted within each row (by destination, then edge
        label for parallel edges); duplicate edges are kept — this is an
        edge-list CSR, and :meth:`csr_planes` dedupes.
        """
        order = np.lexsort((self.edge_labels, self.dst, self.src))
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        if self.m:
            np.add.at(indptr, self.src.astype(np.int64) + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, self.dst[order], self.edge_labels[order]

    def csr_planes(self, n_elab: Optional[int] = None) -> "CsrPlanes":
        """Per-``(edge_label, direction)`` canonical CSR adjacency planes —
        the sparse twin of :meth:`adjacency_bitmaps` (see :class:`CsrPlanes`).

        Plane ``l*2 + 0`` row ``u`` lists ``v`` with ``(u, v) ∈ E`` label
        ``l``; plane ``l*2 + 1`` row ``u`` lists ``v`` with ``(v, u) ∈ E``.
        Rows are sorted ascending and deduplicated, so each plane is bit for
        bit the dense bitmap's support.
        """
        nl = n_elab if n_elab is not None else self.n_edge_labels
        if self.m and int(self.edge_labels.max()) >= nl:
            raise ValueError(
                f"edge label {int(self.edge_labels.max())} >= n_elab={nl}"
            )
        n = self.n
        # flat row keys: (elab * 2 + dir) * n + row_node
        out_key = (self.edge_labels.astype(np.int64) * 2 + 0) * n + self.src
        in_key = (self.edge_labels.astype(np.int64) * 2 + 1) * n + self.dst
        keys = np.concatenate([out_key, in_key])
        cols = np.concatenate([self.dst, self.src]).astype(np.int64)
        order = np.lexsort((cols, keys))
        keys, cols = keys[order], cols[order]
        if keys.size:
            keep = np.ones(keys.size, dtype=bool)
            keep[1:] = (keys[1:] != keys[:-1]) | (cols[1:] != cols[:-1])
            keys, cols = keys[keep], cols[keep]
        return _assemble_csr_planes(keys, cols, 2 * nl, n)

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

    def partition(
        self,
        n_parts: Optional[int] = None,
        max_bytes: Optional[int] = None,
        n_elab: Optional[int] = None,
    ) -> "PartitionedPlanes":
        """Degree-aware contiguous CSR partitioning of this graph's canonical
        adjacency planes (see :func:`partition_csr_planes`).  Exactly one of
        ``n_parts=`` / ``max_bytes=`` selects the partition count."""
        return partition_csr_planes(
            self.csr_planes(n_elab), n_parts=n_parts, max_bytes=max_bytes
        )


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


@dataclasses.dataclass(frozen=True)
class CsrPlanes:
    """Canonical per-``(edge_label, direction)`` CSR adjacency (host numpy)
    — the layout behind the engine's ``step_backend="csr"``.

    One flat ``indices`` array holds every plane's rows back to back;
    ``indptr[p, t]`` / ``indptr[p, t + 1]`` bound row ``t`` of plane
    ``p = elab * 2 + dir`` as **global** offsets into ``indices`` (so
    ``indptr[p, n_t] == indptr[p + 1, 0]``).  Rows are sorted ascending and
    deduplicated; an isolated vertex is a zero-length run.
    """

    n_t: int
    indptr: np.ndarray  # [n_planes, n_t + 1] int32, global offsets
    indices: np.ndarray  # [nnz] int32, sorted + deduped per row
    deg_cap: int  # max row length over all planes

    @property
    def n_planes(self) -> int:
        return int(self.indptr.shape[0])

    @property
    def n_edge_labels(self) -> int:
        return self.n_planes // 2

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.indptr.nbytes + self.indices.nbytes)


@dataclasses.dataclass(frozen=True)
class CsrPlaneSet:
    """Per-plane CSR adjacency with independently owned buffers: plane
    ``p = elab * 2 + dir`` owns ``indptrs[p]`` (``[n_t + 1]`` int64,
    plane-local offsets) and ``indices[p]`` (``[nnz_p]`` int32), sorted and
    deduplicated per row.  ``SubgraphIndex.update`` patches it through
    :meth:`grown` and :meth:`patched`, which rebuild only the planes an
    edit touches and **share every other plane's arrays by reference**;
    :meth:`to_planes` concatenates back to the flat :class:`CsrPlanes`
    without re-sorting."""

    n_t: int
    indptrs: Tuple[np.ndarray, ...]
    indices: Tuple[np.ndarray, ...]

    @property
    def n_planes(self) -> int:
        return len(self.indptrs)

    @property
    def nnz(self) -> int:
        return sum(int(ix.shape[0]) for ix in self.indices)

    @staticmethod
    def from_bitmaps(adj_bits: np.ndarray) -> "CsrPlaneSet":
        """Split the canonical flat planes of ``adj_bits`` into per-plane
        buffers (row content bit-identical to :func:`csr_planes_from_bitmaps`)."""
        flat = csr_planes_from_bitmaps(adj_bits)
        base = flat.indptr.astype(np.int64)
        indptrs, indices = [], []
        for p in range(flat.n_planes):
            ptr = base[p]
            indptrs.append(np.ascontiguousarray(ptr - ptr[0]))
            indices.append(np.ascontiguousarray(flat.indices[ptr[0] : ptr[-1]]))
        return CsrPlaneSet(n_t=flat.n_t, indptrs=tuple(indptrs), indices=tuple(indices))

    def grown(self, n_planes: int) -> "CsrPlaneSet":
        """Append empty planes up to ``n_planes`` (existing buffers shared)."""
        if n_planes <= self.n_planes:
            return self
        extra = n_planes - self.n_planes
        empty_ptr = np.zeros(self.n_t + 1, dtype=np.int64)
        empty_idx = np.zeros(0, dtype=np.int32)
        return CsrPlaneSet(
            n_t=self.n_t,
            indptrs=self.indptrs + tuple(empty_ptr for _ in range(extra)),
            indices=self.indices + tuple(empty_idx for _ in range(extra)),
        )

    def patched(self, plane_rows: dict) -> "CsrPlaneSet":
        """New plane set with ``plane_rows[p][row] = sorted indices`` spliced
        in.  Only planes appearing in ``plane_rows`` get new buffers; every
        other plane's ``(indptr, indices)`` arrays are reused as-is."""
        indptrs = list(self.indptrs)
        indices = list(self.indices)
        for p, rows in plane_rows.items():
            if not rows:
                continue
            ptr, idx = indptrs[p], indices[p]
            lens = np.diff(ptr)
            pieces = []
            prev_end = 0
            for r in sorted(rows):
                s, e = int(ptr[r]), int(ptr[r + 1])
                new_row = np.asarray(rows[r], dtype=np.int32)
                pieces.append(idx[prev_end:s])
                pieces.append(new_row)
                prev_end = e
                lens[r] = new_row.shape[0]
            pieces.append(idx[prev_end:])
            new_ptr = np.zeros(self.n_t + 1, dtype=np.int64)
            np.cumsum(lens, out=new_ptr[1:])
            indptrs[p] = new_ptr
            indices[p] = np.concatenate(pieces) if pieces else idx
        return CsrPlaneSet(n_t=self.n_t, indptrs=tuple(indptrs), indices=tuple(indices))

    def to_planes(self) -> CsrPlanes:
        """Concatenate to the canonical flat :class:`CsrPlanes` layout (rows
        are already canonical; only the global offsets are recomputed)."""
        offsets = np.zeros(self.n_planes + 1, dtype=np.int64)
        np.cumsum([ix.shape[0] for ix in self.indices], out=offsets[1:])
        indptr = np.stack(
            [self.indptrs[p] + offsets[p] for p in range(self.n_planes)]
        ).astype(np.int32)
        flat = (
            np.concatenate(self.indices)
            if self.n_planes
            else np.zeros(0, dtype=np.int32)
        )
        deg_cap = max(
            (int(np.diff(ptr).max()) for ptr in self.indptrs if ptr.shape[0] > 1),
            default=0,
        )
        return CsrPlanes(
            n_t=self.n_t, indptr=indptr, indices=flat.astype(np.int32), deg_cap=deg_cap
        )


@dataclasses.dataclass(frozen=True)
class PartitionedPlanes:
    """A contiguous row partitioning of :class:`CsrPlanes`, the out-of-core
    target layout behind ``step_backend="partitioned"``.

    Partition ``p`` owns global rows ``[node_start[p], node_start[p+1])`` of
    every adjacency plane.  Each entry of ``parts`` is a :class:`CsrPlanes`
    over **local** rows (``n_t`` = partition size, global row ``v`` is local
    row ``v - node_start[p]``) whose ``indices`` keep **global** column ids.
    Boundary (cut) arcs are not replicated into neighbouring partitions: an
    extension that needs a non-resident row is parked in the spill frontier
    until its partition is swapped in.  Only one partition's planes need be
    on the device at a time, so peak plane memory is
    ``max_resident_nbytes`` instead of the whole target's ``nbytes``.
    """

    n_t: int
    node_start: np.ndarray  # [n_parts + 1] int64, node_start[0]=0, [-1]=n_t
    parts: Tuple[CsrPlanes, ...]  # local rows, global columns
    cut_per_part: np.ndarray  # [n_parts] int64 out-arcs leaving the partition

    @property
    def n_parts(self) -> int:
        return len(self.parts)

    @property
    def n_planes(self) -> int:
        return self.parts[0].n_planes if self.parts else 0

    @property
    def cut_edges(self) -> int:
        """Total boundary arcs (row and column in different partitions),
        counted once per out-plane entry."""
        return int(self.cut_per_part.sum())

    @property
    def deg_cap(self) -> int:
        return max((p.deg_cap for p in self.parts), default=0)

    @property
    def max_local(self) -> int:
        """Largest partition row count (pads the shared plan-array shape)."""
        return max((p.n_t for p in self.parts), default=0)

    @property
    def max_nnz(self) -> int:
        return max((p.nnz for p in self.parts), default=0)

    def part_of(self, nodes: np.ndarray) -> np.ndarray:
        """Owning partition id per global node id."""
        return np.searchsorted(self.node_start, np.asarray(nodes), side="right") - 1

    def resident_nbytes(self, pid: int) -> int:
        """Plane bytes resident while partition ``pid`` is swapped in."""
        return self.parts[pid].nbytes

    @property
    def max_resident_nbytes(self) -> int:
        return max((p.nbytes for p in self.parts), default=0)


def _slice_planes(planes: CsrPlanes, lo: int, hi: int) -> CsrPlanes:
    """Rows ``[lo, hi)`` of every plane as a local-row :class:`CsrPlanes`.

    Each plane's rows are contiguous in the flat ``indices`` array, so the
    slice is one run per plane, rebased to partition-local offsets.
    """
    n_loc = hi - lo
    ptr = planes.indptr
    new_ptr = np.zeros((planes.n_planes, n_loc + 1), dtype=np.int64)
    pieces = []
    off = 0
    for p in range(planes.n_planes):
        s, e = int(ptr[p, lo]), int(ptr[p, hi])
        pieces.append(planes.indices[s:e])
        new_ptr[p] = ptr[p, lo : hi + 1].astype(np.int64) - s + off
        off += e - s
    indices = (
        np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.int32)
    ).astype(np.int32)
    deg_cap = int(np.diff(new_ptr, axis=1).max()) if n_loc else 0
    return CsrPlanes(
        n_t=n_loc, indptr=new_ptr.astype(np.int32), indices=indices, deg_cap=deg_cap
    )


def _partition_points(planes: CsrPlanes, n_parts: int) -> np.ndarray:
    """Degree-aware contiguous split: node boundaries chosen so the
    cumulative row weight (nnz across planes + indptr words) is balanced
    per part."""
    n_t = planes.n_t
    n_parts = max(1, min(n_parts, max(n_t, 1)))
    if n_t == 0:
        return np.zeros(n_parts + 1, dtype=np.int64)
    row_nnz = np.diff(planes.indptr.astype(np.int64), axis=1).sum(axis=0)
    weight = row_nnz + planes.n_planes  # + per-row indptr cost
    cum = np.cumsum(weight)
    targets = cum[-1] * (np.arange(1, n_parts, dtype=np.float64) / n_parts)
    cuts = np.searchsorted(cum, targets, side="left") + 1
    starts = np.concatenate([[0], cuts, [n_t]]).astype(np.int64)
    # monotone and in range; equal neighbours give empty (zero-row)
    # partitions, which are valid
    return np.maximum.accumulate(np.clip(starts, 0, n_t))


def partition_csr_planes(
    planes: CsrPlanes,
    n_parts: Optional[int] = None,
    max_bytes: Optional[int] = None,
) -> PartitionedPlanes:
    """Partition :class:`CsrPlanes` into contiguous degree-balanced row
    ranges (see :class:`PartitionedPlanes`).

    Exactly one of ``n_parts`` / ``max_bytes`` selects the partition count:
    ``max_bytes`` picks the smallest count whose largest partition's resident
    plane bytes fit the budget.  Boundary arcs are never replicated (on
    expander-like graphs the cut is ``O(nnz)``, which would void the memory
    bound); ``cut_per_part`` counts them for planning reports.
    """
    if (n_parts is None) == (max_bytes is None):
        raise ValueError("pass exactly one of n_parts= / max_bytes=")
    if n_parts is not None:
        if n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        candidates = [n_parts]
    else:
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        first = max(1, -(-planes.nbytes // max_bytes))  # ceil
        candidates = range(first, max(planes.n_t, 1) + 1)

    result = None
    for cand in candidates:
        starts = _partition_points(planes, cand)
        parts = tuple(
            _slice_planes(planes, int(starts[i]), int(starts[i + 1]))
            for i in range(len(starts) - 1)
        )
        result = (starts, parts)
        if max_bytes is None or max(p.nbytes for p in parts) <= max_bytes:
            break
    starts, parts = result
    if max_bytes is not None and max(p.nbytes for p in parts) > max_bytes:
        raise ValueError(
            f"cannot fit any partitioning under max_bytes={max_bytes}: "
            f"smallest achievable resident set is {max(p.nbytes for p in parts)} B"
        )

    # cut accounting: out-plane entries whose column leaves the row's range
    cut = np.zeros(len(parts), dtype=np.int64)
    for pid, part in enumerate(parts):
        lo, hi = int(starts[pid]), int(starts[pid + 1])
        for p in range(0, part.n_planes, 2):  # out planes only (dir == 0)
            s, e = int(part.indptr[p, 0]), int(part.indptr[p, part.n_t])
            cols = part.indices[s:e]
            cut[pid] += int(np.count_nonzero((cols < lo) | (cols >= hi)))
    return PartitionedPlanes(
        n_t=planes.n_t, node_start=starts, parts=parts, cut_per_part=cut
    )


def _assemble_csr_planes(
    row_keys: np.ndarray, cols: np.ndarray, n_planes: int, n_t: int
) -> CsrPlanes:
    """:class:`CsrPlanes` from sorted, deduped flat row keys
    ``plane * n_t + row`` and their columns — shared by both builders
    (:meth:`Graph.csr_planes`, :func:`csr_planes_from_bitmaps`) so they stay
    bit-identical."""
    counts = np.bincount(row_keys, minlength=n_planes * n_t).astype(np.int64)
    flat_ptr = np.zeros(n_planes * n_t + 1, dtype=np.int64)
    np.cumsum(counts, out=flat_ptr[1:])
    if n_t:
        # overlapping [n_planes, n_t + 1] view: row p = flat_ptr[p*n : p*n+n+1]
        indptr = np.stack(
            [flat_ptr[p * n_t : p * n_t + n_t + 1] for p in range(n_planes)]
        ).astype(np.int32)
        deg_cap = int(counts.max()) if counts.size else 0
    else:
        indptr = np.zeros((n_planes, 1), dtype=np.int32)
        deg_cap = 0
    return CsrPlanes(
        n_t=n_t, indptr=indptr, indices=cols.astype(np.int32), deg_cap=deg_cap
    )


def csr_planes_from_bitmaps(adj_bits: np.ndarray) -> CsrPlanes:
    """Dense ``[n_elab, 2, n_t, w]`` adjacency bitmaps as :class:`CsrPlanes`
    (bit for bit the same adjacency relation), so the CSR step backend can
    run any dense-built plan."""
    ne, two, n_t, w = adj_bits.shape
    flat = np.ascontiguousarray(adj_bits.reshape(ne * two * n_t, w))
    # uint32 LSB-first bit unpacking: little-endian byte view + little bitorder
    expanded = np.unpackbits(
        flat.astype("<u4").view(np.uint8).reshape(flat.shape[0], w * 4),
        axis=1, bitorder="little",
    )
    rows, cols = np.nonzero(expanded[:, : max(n_t, 1)])
    return _assemble_csr_planes(rows, cols, ne * two, n_t)


def deg_bucket_caps(deg_cap: int, base: int = 8) -> Tuple[int, ...]:
    """Pow2 ladder of per-bucket degree caps covering rows up to ``deg_cap``:
    ``(base, 2·base, 4·base, …)`` until the last cap reaches ``deg_cap``.
    The bucketed CSR walk caps each lane at its row's bucket."""
    base = max(1, base)
    caps = [base]
    while caps[-1] < deg_cap:
        caps.append(caps[-1] * 2)
    return tuple(caps)


def deg_bucket_index(deg: np.ndarray, caps: Sequence[int]) -> np.ndarray:
    """Bucket index per row length (``deg == 0`` maps to bucket 0)."""
    caps = np.asarray(caps, dtype=np.int64)
    return np.searchsorted(caps, np.maximum(np.asarray(deg, dtype=np.int64), 1),
                           side="left").astype(np.int64)


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
