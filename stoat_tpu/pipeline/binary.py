"""Binary-trait association pipeline (chi² + Fisher exact).

Batched equivalent of BinarySnarlAnalyzer::analyze_and_write_snarl
(/root/reference/src/snarl_analyzer.cpp:358-390) plus the table helpers
(binary_table.cpp:19-44, snarl_analyzer.cpp:686-732):

  per snarl:
    g0/g1[path]   = control/case carrier counts over haplotypes
    total_sum     = sum of all counts (over ALL paths, pre-filter)
    drop columns with g0+g1 == 0
    filter if  total_sum//2 < min_individuals  (integer division!)
            or total_sum < min_haplotypes
            or kept columns < 2
            or fewer than 2 columns with maf > maf_threshold,
               where maf = min(g1/colsum, 1 - g1/colsum)
    kept == 2 -> chi2_2x2 + Fisher exact; kept > 2 -> chi2_2xN, Fisher NA

Everything from carrier counting to the p-values runs in one jitted batch
over all snarls of a chromosome.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

from stoat_tpu import jaxconfig  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from stoat_tpu.pipeline.membership import path_membership
from stoat_tpu.pipeline import packed as _pk
from stoat_tpu.pipeline.packed import upload_bool_bits as _upload_bool_bits
from stoat_tpu.stats.chi2 import (chi2_2x2_stat, chi2_2xn_stat,
                                  finish_chi2_pvalues)
from stoat_tpu.stats.fisher import fisher_exact_2x2
from stoat_tpu.tables import PackedChromosome

__all__ = ["binary_tables_device", "binary_tables_device_packed",
           "binary_analyze_chromosome"]

# Above this many haplotypes the bit-packed membership path is used:
# the f32 edge matrix and its per-path gather traffic are 32x larger
# than the packed words, which starts to dominate HBM at cohort scale.
PACKED_HAPLOTYPE_THRESHOLD = 8192


@partial(jax.jit, static_argnames=("num_paths", "tails"))
def binary_tables_device(matrix_f32, coo_path, coo_row, n_edges_per_path,
                         path_valid, snarl_path_idx, pheno_hap,
                         min_individuals, min_haplotypes, maf_threshold,
                         num_paths: int, tails: bool = True):
    """Device graph: membership -> per-path g0/g1 -> per-snarl tables ->
    filtration -> chi2/Fisher p-values.

    Returns dict of per-snarl arrays (see keys below).  With
    ``tails=False`` the chi² tail is left unevaluated (raw statistic/df
    returned instead of ``p_chi2``) so shard_map callers can finish it
    outside the shard via ``finish_chi2_pvalues``.
    """
    membership = path_membership(
        matrix_f32, coo_path, coo_row, n_edges_per_path, path_valid,
        num_paths).astype(jnp.float32)                       # [P, H]

    # Carrier counts per path: one matmul against the phenotype one-hot.
    # Precision: default (TF32-eligible on the GPU); 0/1 operands are
    # exact in TF32 and the f32 sums are exact below 2^24 haplotypes.
    g1_path = membership @ pheno_hap                          # [P]
    g0_path = membership @ (1.0 - pheno_hap)                  # [P]

    return _binary_from_path_counts(
        g0_path, g1_path, snarl_path_idx, min_individuals,
        min_haplotypes, maf_threshold, tails=tails)


@partial(jax.jit, static_argnames=("tails",))
def binary_tables_device_packed(words, path_idx, path_valid, tail,
                                g1_words, snarl_path_idx, min_individuals,
                                min_haplotypes, maf_threshold,
                                tails: bool = True):
    """Packed-words variant: 1 bit/haplotype end to end.

    Membership is a bitwise AND-reduce over each path's edge rows;
    carrier counts are population counts against the packed phenotype
    mask (pipeline/packed.py).  Identical outputs to
    ``binary_tables_device`` (pinned by tests), ~32x less HBM traffic.
    ``tails=False`` defers the chi² tail exactly as in the dense entry
    (for shard_map callers; see finish_chi2_pvalues).
    """
    mem_words = _pk.membership_words(words, path_idx)         # [P, W]
    g0_path, g1_path = _pk.packed_binary_counts(
        mem_words, path_valid, tail, g1_words)
    return _binary_from_path_counts(
        g0_path, g1_path, snarl_path_idx, min_individuals,
        min_haplotypes, maf_threshold, tails=tails)


def _binary_from_path_counts(g0_path, g1_path, snarl_path_idx,
                             min_individuals, min_haplotypes,
                             maf_threshold, tails: bool = True):
    idx = snarl_path_idx                                      # [S, Pmax]
    col_mask = idx >= 0
    safe_idx = jnp.where(col_mask, idx, 0)
    g0 = jnp.where(col_mask, jnp.take(g0_path, safe_idx), 0.0)
    g1 = jnp.where(col_mask, jnp.take(g1_path, safe_idx), 0.0)
    g0 = g0.astype(jnp.float64)
    g1 = g1.astype(jnp.float64)

    total_sum = jnp.sum(g0 + g1, axis=-1)                     # [S]

    keep = col_mask & ((g0 + g1) != 0)                        # kept columns
    k = jnp.sum(keep, axis=-1)                                # [S]

    # MAF filter over kept columns (snarl_analyzer.cpp:705-732): the
    # per-column frequency is group1's share of the column.
    colsum = g0 + g1
    safe_colsum = jnp.where(colsum == 0, 1.0, colsum)
    freq1 = g1 / safe_colsum
    maf = jnp.minimum(freq1, 1.0 - freq1)
    maf_count = jnp.sum(keep & (maf > maf_threshold), axis=-1)

    filtered = (
        (jnp.floor_divide(total_sum, 2) < min_individuals)
        | (total_sum < min_haplotypes)
        | (k < 2)
        | (maf_count < 2)
    )

    # Order kept columns first (stable, preserving original order) so the
    # first two kept columns feed the 2x2 tests.
    order = jnp.argsort(~keep, axis=-1, stable=True)          # [S, Pmax]
    g0_sorted = jnp.take_along_axis(g0, order, axis=-1)
    g1_sorted = jnp.take_along_axis(g1, order, axis=-1)
    a, b = g0_sorted[:, 0], g0_sorted[:, 1]
    c, d = g1_sorted[:, 0], g1_sorted[:, 1]

    stat2, inv2, zexp2 = chi2_2x2_stat(a, b, c, d)
    p_fisher = fisher_exact_2x2(a, b, c, d)
    statn, dfn, invn = chi2_2xn_stat(g0, g1, keep)

    is_2x2 = k == 2
    chi2_stat = jnp.where(is_2x2, stat2, statn)
    chi2_df = jnp.where(is_2x2, 1.0, dfn)
    chi2_invalid = jnp.where(is_2x2, inv2, invn)
    chi2_zexp = is_2x2 & zexp2
    p_fisher = jnp.where(is_2x2, p_fisher, jnp.nan)

    out = {
        "filtered": filtered,
        "keep": keep,
        "g0": g0,
        "g1": g1,
        "p_fisher": p_fisher,
    }
    if tails:
        out["p_chi2"] = finish_chi2_pvalues(
            chi2_stat, chi2_df, chi2_invalid, chi2_zexp)
    else:
        out["chi2_stat"] = chi2_stat
        out["chi2_df"] = chi2_df
        out["chi2_invalid"] = chi2_invalid
        out["chi2_zexp"] = chi2_zexp
    return out


def binary_analyze_chromosome(packed: PackedChromosome,
                              binary_phenotype: np.ndarray,
                              min_individuals: int, min_haplotypes: int,
                              maf_threshold: float,
                              device_matrix=None,
                              use_packed: bool | None = None,
                              pheno_device=None,
                              block: bool = True
                              ) -> Dict[str, np.ndarray]:
    """Host wrapper: build the phenotype one-hot and run the device graph.

    ``device_matrix`` lets the caller upload the chromosome's edge matrix
    once and reuse it across snarl chunks (f32 [E, H] for the dense path,
    uint32 [E+1, W] packed words for the packed path).  ``use_packed``
    forces a path; by default cohorts over PACKED_HAPLOTYPE_THRESHOLD
    haplotypes take the bit-packed one.  ``pheno_device`` optionally
    supplies the per-run (g1_words, tail) device arrays so the packed
    phenotype masks upload once per run, not per chunk.  ``block=False``
    returns raw device arrays (no host copies) — the pipelined writer
    wire-packs them into one transfer (fetch.flatten_result).
    """
    H = packed.n_haplotypes
    if use_packed is None:
        if device_matrix is not None:
            # a caller-cached matrix decides the path by its dtype
            use_packed = device_matrix.dtype == jnp.uint32
        else:
            # native-ingested chromosomes arrive bit-packed — use them
            # as-is; otherwise pack once the cohort is large enough to
            # pay for the host repack
            use_packed = (packed.words is not None
                          or H >= PACKED_HAPLOTYPE_THRESHOLD)
    if use_packed:
        if device_matrix is None or device_matrix.dtype != jnp.uint32:
            device_matrix = jnp.asarray(packed.packed_words())
        W = int(device_matrix.shape[1])
        path_idx = packed.path_edge_idx()
        if pheno_device is not None:
            g1_words, tail = pheno_device
        else:
            g1_words, tail = _pk.upload_pheno_mask_words(
                binary_phenotype, H, W)
        out = binary_tables_device_packed(
            device_matrix,
            _pk.upload_path_idx(path_idx, int(device_matrix.shape[0]) - 1),
            _upload_bool_bits(packed.path_valid),
            tail,
            g1_words,
            _pk.upload_snarl_path_idx(packed.snarl_path_idx),
            jnp.float64(min_individuals),
            jnp.float64(min_haplotypes),
            jnp.float64(maf_threshold),
        )
        from stoat_tpu.pipeline.fetch import fetch_all
        return fetch_all(out) if block else out

    pheno_hap = np.repeat(binary_phenotype.astype(np.float32), 2)
    out = binary_tables_device(
        device_matrix if device_matrix is not None
        else jnp.asarray(packed.dense_matrix(), jnp.float32),
        jnp.asarray(packed.coo_path),
        jnp.asarray(packed.coo_row),
        jnp.asarray(packed.n_edges_per_path),
        _upload_bool_bits(packed.path_valid),
        jnp.asarray(packed.snarl_path_idx),
        jnp.asarray(pheno_hap),
        jnp.float64(min_individuals),
        jnp.float64(min_haplotypes),
        jnp.float64(maf_threshold),
        num_paths=int(packed.n_edges_per_path.shape[0]),
    )
    from stoat_tpu.pipeline.fetch import fetch_all
    return fetch_all(out) if block else out
