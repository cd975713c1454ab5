"""Edge×haplotype genotype matrix construction.

A re-design of the reference's packed bit matrix
(/root/reference/src/matrix.{hpp,cpp}) and its VCF ingestion loop
(``make_edge_matrix``, snarl_analyzer.cpp:190-260): one matrix per
chromosome, rows keyed by graph edges (oriented node pairs), columns =
haplotypes (2 per sample).  Instead of per-bit scalar writes we set whole
(edge-rows × haplotype-columns) blocks per VCF record with vectorized numpy
writes; the matrix ships to the device as float32 where path membership
becomes one batched matmul/segment-sum instead of the reference's innermost
bit-scan loop (``identify_path``, snarl_analyzer.cpp:315-356).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from stoat_tpu.io.snarl_file import Edge, NodeTraversal, parse_path_string
from stoat_tpu.io.vcf import VcfRecord

__all__ = ["EdgeHaplotypeMatrix", "decompose_path_str_to_edges"]


def decompose_path_str_to_edges(path_str: str) -> List[Edge]:
    """``>123>213<234`` -> [((123,F),(213,F)), ((213,F),(234,T))]
    (snarl_analyzer.cpp:277-303)."""
    nodes = parse_path_string(path_str)
    return [(nodes[i], nodes[i + 1]) for i in range(len(nodes) - 1)]


class EdgeHaplotypeMatrix:
    """Dense boolean edge×haplotype matrix with edge-row interning.

    Row growth uses amortized doubling like the reference (matrix.cpp:59-64);
    ``shrink()`` trims to the populated rows (matrix.cpp:86-91).
    """

    def __init__(self, n_haplotypes: int, initial_rows: int = 256):
        self.n_haplotypes = n_haplotypes
        self.edge_to_row: Dict[Edge, int] = {}
        self._data = np.zeros((max(initial_rows, 1), n_haplotypes), dtype=bool)

    @property
    def n_rows(self) -> int:
        return len(self.edge_to_row)

    def _ensure_rows(self, needed: int) -> None:
        if needed > self._data.shape[0]:
            new_rows = self._data.shape[0]
            while new_rows < needed:
                new_rows *= 2
            grown = np.zeros((new_rows, self.n_haplotypes), dtype=bool)
            grown[: self._data.shape[0]] = self._data
            self._data = grown

    def intern_edge(self, edge: Edge) -> int:
        row = self.edge_to_row.get(edge)
        if row is None:
            row = len(self.edge_to_row)
            self.edge_to_row[edge] = row
            self._ensure_rows(row + 1)
        return row

    def find_edge(self, edge: Edge) -> int:
        """Row index or -1 (reference returns size_t::max; matrix.cpp)."""
        return self.edge_to_row.get(edge, -1)

    def add_record(self, rec: VcfRecord) -> None:
        """Ingest one VCF record: set every edge of each called allele's
        traversal for the corresponding haplotype column
        (snarl_analyzer.cpp:237-253)."""
        if not rec.at_paths:
            return
        alleles = rec.alleles
        for allele_idx, path_str in enumerate(rec.at_paths):
            cols = np.nonzero(alleles == allele_idx)[0]
            if cols.size == 0:
                continue
            edges = decompose_path_str_to_edges(path_str)
            if not edges:
                continue
            rows = np.array([self.intern_edge(e) for e in edges],
                            dtype=np.int64)
            self._data[np.ix_(rows, cols)] = True

    def resolve_edges(self, quads: np.ndarray) -> np.ndarray:
        """Vectorized [N,4] -> row indices (int64, -1 = unknown edge)."""
        d = self.edge_to_row
        return np.array(
            [d.get(((int(q[0]), bool(q[1])), (int(q[2]), bool(q[3]))), -1)
             for q in quads], np.int64).reshape(-1)

    def edges_array(self) -> np.ndarray:
        """[E, 4] uint64 (a_id, a_rev, b_id, b_rev) rows in row order
        (the native resolver's table input)."""
        out = np.zeros((self.n_rows, 4), np.uint64)
        for (a, b), row in self.edge_to_row.items():
            out[row, 0], out[row, 1] = a[0], a[1]
            out[row, 2], out[row, 3] = b[0], b[1]
        return out

    def shrink(self) -> np.ndarray:
        """Return the populated [n_edges, n_haplotypes] boolean matrix."""
        return self._data[: self.n_rows]

    @classmethod
    def from_records(cls, records: Iterable[VcfRecord],
                     n_haplotypes: int,
                     initial_rows: int = 256) -> "EdgeHaplotypeMatrix":
        m = cls(n_haplotypes, initial_rows)
        for rec in records:
            m.add_record(rec)
        return m


def encode_edge_keys(quads: np.ndarray) -> Optional[np.ndarray]:
    """Pack [N,4] (a_id, a_rev, b_id, b_rev) rows into single uint64 keys.

    Returns None when node ids exceed 31 bits (callers fall back to dict
    lookups).  The encoding matches vg handles: (id<<1|rev) per side."""
    if quads.size == 0:
        return np.zeros(0, np.uint64)
    q = quads.astype(np.uint64, copy=False)
    if int(q[:, [0, 2]].max()) >= (1 << 31):
        return None
    return (((q[:, 0] << np.uint64(1)) | q[:, 1]) << np.uint64(32)) \
        | ((q[:, 2] << np.uint64(1)) | q[:, 3])


class PrebuiltEdgeMatrix:
    """Adapter over a matrix + edge rows built by the native C++ core.

    ``edges`` may be the legacy {Edge: row} dict or an [E,4] uint64 array
    (a_id, a_rev, b_id, b_rev) straight from the C ABI — the array form
    skips building a Python dict per chromosome (it is only materialized
    lazily if scalar ``find_edge``/``edge_to_row`` access is needed) and
    enables O(N log E) vectorized batch resolution in the packing step."""

    def __init__(self, matrix: np.ndarray, edges):
        self._matrix = matrix
        self.n_haplotypes = matrix.shape[1]
        if isinstance(edges, dict):
            self._edge_dict: Optional[Dict[Edge, int]] = edges
            self._edges_arr = None
        else:
            self._edge_dict = None
            self._edges_arr = np.asarray(edges, np.uint64).reshape(-1, 4)
        self._sorted_keys: Optional[np.ndarray] = None
        self._sort_order: Optional[np.ndarray] = None

    @property
    def n_rows(self) -> int:
        return self._matrix.shape[0]

    @property
    def edge_to_row(self) -> Dict[Edge, int]:
        if self._edge_dict is None:
            self._edge_dict = {
                ((int(e[0]), bool(e[1])), (int(e[2]), bool(e[3]))): i
                for i, e in enumerate(self._edges_arr)
            }
        return self._edge_dict

    def find_edge(self, edge: Edge) -> int:
        return self.edge_to_row.get(edge, -1)

    def resolve_edges(self, quads: np.ndarray) -> np.ndarray:
        """Vectorized [N,4] -> row indices (int64, -1 = unknown edge)."""
        n = quads.shape[0]
        if n == 0:
            return np.zeros(0, np.int64)
        keys = encode_edge_keys(quads)
        table = None
        if keys is not None and self._edges_arr is not None:
            if self._sorted_keys is None:
                table = encode_edge_keys(self._edges_arr)
                if table is not None:
                    self._sort_order = np.argsort(table).astype(np.int64)
                    self._sorted_keys = table[self._sort_order]
            table = self._sorted_keys
        if keys is None or table is None:
            # huge node ids: dict fallback
            d = self.edge_to_row
            return np.array(
                [d.get(((int(q[0]), bool(q[1])), (int(q[2]), bool(q[3]))),
                       -1) for q in quads], np.int64)
        if len(table) == 0:
            return np.full(n, -1, np.int64)
        pos = np.searchsorted(table, keys)
        pos_c = np.minimum(pos, len(table) - 1)
        found = table[pos_c] == keys
        return np.where(found, self._sort_order[pos_c], np.int64(-1))

    def shrink(self) -> np.ndarray:
        return self._matrix


class PackedEdgeMatrix(PrebuiltEdgeMatrix):
    """Bit-packed chromosome matrix straight from the native core.

    Holds the uint32 [E+1, W] word matrix (32 haplotypes/word, little bit
    order, trailing all-ones AND-identity row — the exact device layout of
    pipeline/packed.py) so the packed analysis pipeline uploads it with no
    host repack.  The dense bool view is unpacked lazily only if a legacy
    caller asks for it."""

    def __init__(self, words: np.ndarray, n_haplotypes: int, edges):
        self.words = np.asarray(words, np.uint32)
        self.n_haplotypes = n_haplotypes
        if isinstance(edges, dict):
            self._edge_dict = edges
            self._edges_arr = None
        else:
            self._edge_dict = None
            self._edges_arr = np.asarray(edges, np.uint64).reshape(-1, 4)
        self._sorted_keys = None
        self._sort_order = None
        self._dense: Optional[np.ndarray] = None

    @property
    def n_rows(self) -> int:
        return self.words.shape[0] - 1

    def shrink(self) -> np.ndarray:
        if self._dense is None:
            from stoat_tpu.pipeline.packed import unpack_words_to_dense
            self._dense = unpack_words_to_dense(self.words,
                                                self.n_haplotypes)
        return self._dense
