"""Bit-packed membership path for large cohorts.

The default membership op (pipeline/membership.py) gathers float32 rows of
the [E, H] edge matrix — 4 bytes per haplotype bit.  At biobank scale that
is the difference between fitting and not fitting: 16k edges × 200k
haplotypes is 12.8 GB as f32 but 100 MB bit-packed, and the per-path
gather traffic shrinks by the same 32×.

This module packs the edge matrix into uint32 words (32 haplotypes per
word, little bit order: bit j of word w = haplotype 32·w+j) and computes
membership as a bitwise AND-reduction over each path's edge rows —
exactly identify_path's "every edge bit set" semantics
(/root/reference/src/snarl_analyzer.cpp:343-354) evaluated 32 haplotypes
per word.  Carrier counts for the binary pipeline then come
straight off the packed words via population counts, never materializing
a [P, H] float matrix.

The device implementation (``membership_words``) is pure XLA: a K-step
AND-accumulation of [P, W] gathers.  It should be bound by memory
bandwidth; its share of the GPU's HBM bandwidth is not measured yet.

Padding contract: edge-row index ``E`` (one past the real rows) is the
AND identity — the packed table carries an extra all-ones row at the
bottom, and per-path edge lists are padded with ``E``.  Zero-edge valid
paths therefore match every haplotype (vacuous AND, as in the
reference); ``path_valid`` masking and the tail-bit mask (haplotypes
beyond H in the last word) are applied after the reduction.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

from stoat_tpu import jaxconfig  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "pack_matrix_words",
    "pack_path_edge_idx",
    "pack_hap_mask_words",
    "tail_mask_words",
    "membership_words",
    "packed_binary_counts",
    "unpack_membership",
]

_WORD = 32


def _n_words(n_haplotypes: int) -> int:
    return max((n_haplotypes + _WORD - 1) // _WORD, 1)


def pack_matrix_words(matrix: np.ndarray) -> np.ndarray:
    """Pack a bool [E, H] edge matrix into uint32 [E+1, W] words.

    The appended final row is all-ones: the AND identity used as the
    padding target by ``pack_path_edge_idx``.
    """
    E, H = matrix.shape
    W = _n_words(H)
    u8 = np.packbits(np.asarray(matrix, bool), axis=1, bitorder="little")
    buf = np.zeros((E + 1, W * 4), np.uint8)
    buf[:E, : u8.shape[1]] = u8
    buf[E, :] = 0xFF
    return buf.view("<u4").reshape(E + 1, W)


def pack_hap_mask_words(mask: np.ndarray, n_words: int) -> np.ndarray:
    """Pack a bool [H] haplotype mask into uint32 [W] words."""
    u8 = np.packbits(np.asarray(mask, bool), bitorder="little")
    buf = np.zeros(n_words * 4, np.uint8)
    buf[: u8.shape[0]] = u8
    return buf.view("<u4")


def tail_mask_words(n_haplotypes: int, n_words: int) -> np.ndarray:
    """uint32 [W] mask with exactly the first ``n_haplotypes`` bits set."""
    return pack_hap_mask_words(np.ones(n_haplotypes, bool), n_words)


def unpack_words_to_dense(words: np.ndarray,
                          n_haplotypes: int) -> np.ndarray:
    """Dense bool [E, H] from uint32 [E+1, W] words (identity row
    dropped); the one shared host unpack (three hand-rolled copies used
    to disagree on the E == 0 edge case)."""
    E = int(words.shape[0]) - 1
    if E <= 0:
        return np.zeros((0, n_haplotypes), bool)
    return np.unpackbits(
        np.ascontiguousarray(words[:E]).view(np.uint8).reshape(E, -1),
        axis=1, bitorder="little")[:, :n_haplotypes].astype(bool)


def upload_pheno_mask_words(binary_phenotype: np.ndarray,
                            n_haplotypes: int, n_words: int):
    """(g1_words, tail) device pair for a per-sample binary phenotype
    expanded to diploid haplotype pairs — the ONE place the haplotype-
    expansion convention lives for the packed binary kernels."""
    g1 = jnp.asarray(pack_hap_mask_words(
        np.repeat(np.asarray(binary_phenotype).astype(bool), 2), n_words))
    tail = jnp.asarray(tail_mask_words(n_haplotypes, n_words))
    return g1, tail


def pack_path_edge_idx(coo_path: np.ndarray, coo_row: np.ndarray,
                       path_valid: np.ndarray, n_rows: int,
                       min_k: int = 1) -> np.ndarray:
    """Convert the COO (path, edge-row) list into padded [P, K] indices.

    K = max edges on any valid path (≥ ``min_k``); padding entries point
    at row ``n_rows`` — the all-ones AND-identity row appended by
    ``pack_matrix_words``.  COO entries on invalid paths (these are
    exactly the pack-time padding entries; real unresolved-edge paths
    had their entries dropped during packing) are discarded so they
    cannot inflate K.
    """
    P = path_valid.shape[0]
    real = path_valid[coo_path]
    cp = coo_path[real].astype(np.int64)
    cr = coo_row[real].astype(np.int32)
    counts = np.bincount(cp, minlength=P)
    K = max(min_k, int(counts.max()) if counts.size else min_k)
    # round K to a power of two: chunks of one chromosome then share the
    # [P, K] shape and the jitted membership graph compiles once (padding
    # gathers all hit the same AND-identity row)
    k2 = 1
    while k2 < K:
        k2 *= 2
    K = k2
    idx = np.full((P, K), n_rows, np.int32)
    order = np.argsort(cp, kind="stable")
    cp, cr = cp[order], cr[order]
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    col = np.arange(cp.shape[0]) - starts[cp]
    idx[cp, col] = cr
    return idx


@jax.jit
def _expand_idx_device(base, delta):
    steps = jnp.cumsum(delta.astype(jnp.int32), axis=1)
    return jnp.concatenate([base[:, None], base[:, None] + steps], axis=1)


@jax.jit
def _expand_idx_device_db(base0, base_delta, delta):
    base = jnp.concatenate(
        [base0, base0 + jnp.cumsum(base_delta.astype(jnp.int32))])
    steps = jnp.cumsum(delta.astype(jnp.int32), axis=1)
    return jnp.concatenate([base[:, None], base[:, None] + steps], axis=1)


def _narrow(arr: np.ndarray):
    """Smallest of int8/int16/int32 holding ``arr`` exactly."""
    lo = int(arr.min(initial=0))
    hi = int(arr.max(initial=0))
    if -128 <= lo and hi <= 127:
        return arr.astype(np.int8)
    if -32768 <= lo and hi <= 32767:
        return arr.astype(np.int16)
    return arr.astype(np.int32)


def upload_path_idx(idx: np.ndarray, n_rows: int):
    """Upload the [P, K] path→edge-row index, delta-compressed.

    The int32 indices are the second-largest per-chromosome transfer
    after the packed words.  Compression first rewrites pad entries (row
    ``n_rows``, the all-ones AND-identity appended by pack_matrix_words)
    to REPEAT the previous column — `a & a = a`, so membership is
    value-identical — then ships the per-path deltas at the narrowest
    width that holds them (int8 usually: a path's edges land on
    consecutive VCF-order rows) and the path-to-path BASE deltas the
    same way (paths arrive in row order), reconstructing on device with
    two cumsums.  Falls back widthwise as needed; returns a device
    int32 [P, K] array in every case.
    """
    idx = np.asarray(idx, np.int32)
    P, K = idx.shape
    if K < 2 or P == 0:
        return jnp.asarray(idx)
    filled = idx.copy()
    for k in range(1, K):
        col = filled[:, k]
        np.copyto(col, filled[:, k - 1], where=col == n_rows)
    delta = _narrow(np.diff(filled, axis=1))
    base = filled[:, 0]
    base_delta = _narrow(np.diff(base))
    if base_delta.itemsize < 4:
        return _expand_idx_device_db(jnp.asarray(base[:1]),
                                     jnp.asarray(base_delta),
                                     jnp.asarray(delta))
    return _expand_idx_device(jnp.asarray(base), jnp.asarray(delta))


@jax.jit
def _decode_sidx_u16(enc):
    dec = enc.astype(jnp.int32)
    return jnp.where(dec == 65535, jnp.int32(-1), dec)


@partial(jax.jit, static_argnames=("pmax",))
def _decode_sidx_counts(counts_u8, pmax: int):
    c = counts_u8.astype(jnp.int32)
    starts = jnp.cumsum(c) - c
    j = jnp.arange(pmax, dtype=jnp.int32)
    return jnp.where(j[None, :] < c[:, None],
                     starts[:, None] + j[None, :], jnp.int32(-1))


def upload_snarl_path_idx(sidx: np.ndarray):
    """Upload the [S, Pmax] snarl→path-index table.

    The tables.py layout assigns flat path indices CONSECUTIVELY across
    the chunk's snarls (``arange`` scattered by snarl), so the whole
    table is a function of the per-snarl path counts: ship one uint8
    per snarl and rebuild on device with a cumsum (8x fewer bytes than
    the u16 ship, 64x fewer than int32).  The reconstruction is
    verified against the host table (cheap numpy) and falls back to the
    u16/int32 ship on any mismatch — exactness never depends on the
    layout assumption."""
    sidx = np.asarray(sidx)
    S, pmax = sidx.shape if sidx.ndim == 2 else (0, 0)
    if S and pmax < 255:
        counts = (sidx >= 0).sum(axis=1).astype(np.uint8)
        c = counts.astype(np.int64)
        starts = np.cumsum(c) - c
        j = np.arange(pmax)
        rebuilt = np.where(j[None, :] < c[:, None],
                           starts[:, None] + j[None, :], -1)
        if np.array_equal(rebuilt, sidx):
            return _decode_sidx_counts(jnp.asarray(counts), pmax)
    if (sidx.size and int(sidx.max(initial=0)) < 65535
            and int(sidx.min(initial=0)) >= -1):
        enc = np.where(sidx < 0, 65535, sidx).astype(np.uint16)
        return _decode_sidx_u16(jnp.asarray(enc))
    return jnp.asarray(sidx, jnp.int32)


@partial(jax.jit, static_argnames=("n",))
def _unpack_bool_bits(u8, n: int):
    bits = (u8[:, None] >> jnp.arange(8, dtype=jnp.uint8)) & jnp.uint8(1)
    return bits.reshape(-1)[:n] != 0


def gather_dedup(uniq_dev, flags_np: np.ndarray, n: int):
    """Rebuild [n, W] rows from consecutive-dedup unique rows + host
    bool "new row" flags: the flags ride as packed bits and the inverse
    index is a device cumsum (the one shared implementation behind the
    streamed and whole-matrix dedup uploads)."""
    fu8 = jnp.asarray(np.packbits(flags_np, bitorder="little"))
    new = _unpack_bool_bits(fu8, n)
    inv = jnp.cumsum(new.astype(jnp.int32)) - 1
    return jnp.take(uniq_dev, inv, axis=0)


def upload_bool_bits(mask: np.ndarray):
    """Upload a bool [N] mask as packed bits (8x fewer bytes than the
    1-byte-per-bool jnp.asarray ship); returns a device bool [N]."""
    mask = np.asarray(mask, bool)
    n = int(mask.shape[0])
    if n < 4096:
        return jnp.asarray(mask)
    return _unpack_bool_bits(
        jnp.asarray(np.packbits(mask, bitorder="little")), n)


def membership_words_body(words, idx):
    """Un-jitted body of ``membership_words`` (traced directly by the
    fused chunk analyzers to avoid nested-pjit call boundaries)."""
    K = idx.shape[1]

    def step(k, acc):
        return acc & jnp.take(words, idx[:, k], axis=0)

    init = jnp.take(words, idx[:, 0], axis=0)                # [P, W]
    return jax.lax.fori_loop(1, K, step, init)


@jax.jit
def membership_words(words, idx):
    """[P, W] packed membership: bitwise AND over each path's edge rows.

    Runs as a K-step AND-accumulation (one [P, W] gather per step) rather
    than one [P, K, W] gather + reduce: XLA materializes the latter's
    intermediate, which OOMs at biobank shapes (e.g. 26 GB at P=64k,
    K=16, H=200k), while the loop keeps only the [P, W] accumulator live.

    Args:
      words: [E+1, W] uint32 — packed matrix, last row all-ones.
      idx:   [P, K] int32 — edge rows per path, padded with E.
    """
    return membership_words_body(words, idx)


@jax.jit
def packed_binary_counts(mem_words, path_valid, tail, g1_words):
    """Per-path (g0, g1) carrier counts from packed membership words.

    g1 = carriers among case haplotypes (``g1_words`` packed mask),
    g0 = carriers among the rest; equivalent to the f32 path's
    ``membership @ pheno_onehot`` matmuls but via population counts.
    """
    mem = jnp.where(path_valid[:, None], mem_words & tail[None, :],
                    jnp.uint32(0))
    g1 = jnp.sum(jax.lax.population_count(mem & g1_words[None, :]),
                 axis=-1)
    g_all = jnp.sum(jax.lax.population_count(mem), axis=-1)
    return (g_all - g1).astype(jnp.float64), g1.astype(jnp.float64)


def unpack_membership_body(mem_words, path_valid, n_haplotypes: int):
    """Un-jitted body of ``unpack_membership`` (see membership_words_body)."""
    P, W = mem_words.shape
    shifts = jnp.arange(_WORD, dtype=jnp.uint32)
    bits = (mem_words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    full = bits.reshape(P, W * _WORD)[:, :n_haplotypes] != 0
    return full & path_valid[:, None]


@partial(jax.jit, static_argnames=("n_haplotypes",))
def unpack_membership(mem_words, path_valid, n_haplotypes: int):
    """Expand packed membership words to the bool [P, H] matrix.

    Used by the quantitative path when the packed gather is preferred:
    the expensive per-edge gather runs at 1 bit/haplotype, only the
    final membership expands to H lanes.
    """
    return unpack_membership_body(mem_words, path_valid, n_haplotypes)
