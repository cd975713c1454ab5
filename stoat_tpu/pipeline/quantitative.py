"""Quantitative / binary+covariate / eQTL table pipeline.

Batched equivalent of create_quantitative_table + filtration + column
merging + the regression dispatch (/root/reference/src/quantitative_table.cpp,
snarl_analyzer.cpp:392-539,541-684):

  per snarl:
    dosage[sample, path] = # haplotypes of the sample taking the path
    drop empty columns (no carriers)
    rows = samples carrying any kept path; dosages normalized to fractions
           of the row sum (quantitative_table.cpp:87-101)
    filter if kept cols < 2, used rows < min_individuals, total normalized
           mass < min_haplotypes, or < 2 columns with maf > threshold
    merge identical columns by summation when >= 3 kept columns
           (snarl_analyzer.cpp:620-674)
    drop the last merged column (intercept collinearity guard, :676-684)
    OLS [1 | dosages | covariates]  (quantitative mode, eQTL)
    IRLS [1 | dosages]              (binary+covariate mode — the reference
           never adds covariates to the logistic design, see
           stoat_tpu.stats.logreg docstring)

Reference edge case: if merging collapses everything to a single column,
``remove_last_columns`` leaves an empty design and the C++ reads
``p_values[0]`` of an empty vector (undefined behaviour,
stats_test.cpp:487).  We return NA for those snarls instead.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

from stoat_tpu import jaxconfig  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from stoat_tpu.pipeline.packed import upload_bool_bits as _upload_bool_bits

from stoat_tpu.pipeline.fetch import fetch_all
from stoat_tpu.pipeline.membership import path_membership
from stoat_tpu.stats.linreg import linear_regression_batch
from stoat_tpu.stats.logreg import logistic_regression_batch
from stoat_tpu.tables import PackedChromosome

__all__ = [
    "quantitative_design_device",
    "quantitative_design_packed",
    "quantitative_analyze_chromosome",
    "binary_covar_analyze_chromosome",
    "eqtl_design_for_chromosome",
]


@partial(jax.jit, static_argnames=("num_paths", "with_covar", "all_rows"))
def quantitative_design_device(matrix_f32, coo_path, coo_row,
                               n_edges_per_path, path_valid, snarl_path_idx,
                               covar, min_individuals, min_haplotypes,
                               maf_threshold, num_paths: int,
                               with_covar: bool, all_rows: bool = False):
    """Build per-snarl padded design matrices + filtration flags on device.

    Returns dict with:
      X:            [S, N, PT] float64 padded design (rows zeroed if unused)
      used:         [S, N] bool
      ncols:        [S] int32 actual design width
      filtered:     [S] bool
      degenerate:   [S] bool (no variant columns survive — reference UB)
      allele_paths: [S, Pmax] int32 carrier counts per original path
    """
    membership = path_membership(
        matrix_f32, coo_path, coo_row, n_edges_per_path, path_valid,
        num_paths)                                            # [P, H] bool
    return _design_from_membership(
        membership, snarl_path_idx, covar, min_individuals,
        min_haplotypes, maf_threshold, with_covar=with_covar,
        all_rows=all_rows)


def _design_packed_body(words, path_idx, path_valid, snarl_path_idx,
                        covar, min_individuals, min_haplotypes,
                        maf_threshold, n_haplotypes: int,
                        with_covar: bool, all_rows: bool = False):
    """Un-jitted body of ``quantitative_design_packed``.

    The fused chunk analyzer traces this directly: calling the jitted
    wrapper inside another jit keeps a pjit call boundary whose dead
    outputs (X, norm — [S, N, P] f64, hundreds of MB per chunk) are NOT
    eliminated; tracing the plain body lets unused dict entries vanish
    from the jaxpr entirely."""
    from stoat_tpu.pipeline import packed as _pk
    mem_words = _pk.membership_words_body(words, path_idx)    # [P, W]
    membership = _pk.unpack_membership_body(mem_words, path_valid,
                                            n_haplotypes)     # [P, H]
    return _design_from_membership(
        membership, snarl_path_idx, covar, min_individuals,
        min_haplotypes, maf_threshold, with_covar=with_covar,
        all_rows=all_rows)


@partial(jax.jit,
         static_argnames=("n_haplotypes", "with_covar", "all_rows"))
def quantitative_design_packed(words, path_idx, path_valid, snarl_path_idx,
                               covar, min_individuals, min_haplotypes,
                               maf_threshold, n_haplotypes: int,
                               with_covar: bool, all_rows: bool = False):
    """Packed-words variant of ``quantitative_design_device``.

    Membership is a bitwise AND-reduce over each path's edge rows of the
    bit-packed [E+1, W] word matrix (1 bit/haplotype — 32x less gather
    traffic than the f32 path); only the final [P, H] membership expands
    to haplotype lanes before the dosage fold.  Identical outputs to the
    dense entry (pinned by tests)."""
    return _design_packed_body(
        words, path_idx, path_valid, snarl_path_idx, covar,
        min_individuals, min_haplotypes, maf_threshold,
        n_haplotypes=n_haplotypes, with_covar=with_covar,
        all_rows=all_rows)


def _design_from_membership(membership, snarl_path_idx, covar,
                            min_individuals, min_haplotypes, maf_threshold,
                            with_covar: bool, all_rows: bool):
    """Shared design assembly from the [P, H] membership matrix.

    Dtype strategy: every [S, N, P]-sized intermediate stays float32 —
    diploid dosage counts are integers ≤ 2, exact in f32 — and float64
    appears only in the final X scale and the MAF statistics.
    Exactness of the scale: norm = count · (1/row_sum) in f64 equals the
    reference's count/row_sum division BIT-FOR-BIT because count ∈
    {0, 1, 2} (×1 trivial, ×2 is an exact power-of-two scale)."""
    counts_path = jnp.sum(membership, axis=1).astype(jnp.int32)   # [P]
    m_f32 = membership.astype(jnp.float32)
    # haplotypes (2i, 2i+1) collapse to a per-sample dosage count
    dosage = m_f32[:, 0::2] + m_f32[:, 1::2]                  # [P, N]

    idx = snarl_path_idx                                      # [S, Pmax]
    S, Pmax = idx.shape
    N = dosage.shape[1]
    col_exists = idx >= 0
    safe_idx = jnp.where(col_exists, idx, 0)

    allele_paths = jnp.where(col_exists, jnp.take(counts_path, safe_idx), 0)
    D = jnp.take(dosage, safe_idx, axis=0)                    # [S, Pmax, N]
    D = jnp.where(col_exists[:, :, None], D, 0.0)
    D = jnp.transpose(D, (0, 2, 1))                           # [S,N,Pmax] f32

    kept = col_exists & (allele_paths > 0)                    # [S, Pmax]
    Dk = jnp.where(kept[:, None, :], D, 0.0)                  # f32 ints

    used = jnp.any(Dk > 0, axis=-1)                           # [S, N]
    row_sum = jnp.sum(Dk, axis=-1)                            # f32 ints
    # per-row reciprocal: the ONE f64 division (0 for unused rows)
    recip = jnp.where(row_sum == 0, 0.0,
                      1.0 / row_sum.astype(jnp.float64))      # [S, N]

    n_used = jnp.sum(used, axis=-1)
    # each used row's normalized fractions sum to 1 exactly in the
    # count·recip formulation, so total mass == used-row count
    total_sum = n_used.astype(jnp.float64)
    # column mass in f64 via a contraction (not [S,N,P] elementwise);
    # f64 contractions never run in TF32
    colsum = jnp.einsum("snp,sn->sp", Dk.astype(jnp.float64), recip)
    kept_count = jnp.sum(kept, axis=-1)

    safe_total = jnp.where(total_sum == 0, 1.0, total_sum)
    freq = colsum / safe_total[:, None]
    maf = jnp.minimum(freq, 1.0 - freq)
    maf_count = jnp.sum(kept & (maf > maf_threshold), axis=-1)

    filtered = (
        (kept_count < 2)
        | (n_used < min_individuals)
        | (total_sum < min_haplotypes)
        | (maf_count < 2)
    )

    # ---- identical-column merge (>= 3 kept columns) --------------------
    # eq[s,i,j]: columns i and j agree on every used row.  Normalized
    # columns are equal iff the integer dosage-count columns are equal
    # (rows share their row_sum), so the test is an exact small-integer
    # matmul: ||d_i - d_j||^2 == 0, O(S·P^2) memory instead of an
    # [S,N,P,P] broadcast.  Precision: default (TF32-eligible on the
    # GPU).  Operands are integers ≤ 2, which TF32's 10-bit mantissa
    # holds exactly, and f32 accumulation is exact below 2^24 (inner
    # products ≤ 4N): exact for N < 4M samples.
    G = jnp.einsum("snp,snq->spq", Dk, Dk)                    # exact ints
    gd = jnp.diagonal(G, axis1=1, axis2=2)
    dist2 = gd[:, :, None] + gd[:, None, :] - 2.0 * G
    eq = (dist2 == 0.0) & kept[:, :, None] & kept[:, None, :]
    arange = jnp.arange(Pmax)
    big = Pmax + 1
    rep = jnp.min(jnp.where(eq, arange[:, None], big), axis=1)  # [S, Pmax]
    do_merge = (kept_count >= 3)[:, None]
    rep = jnp.where(do_merge, rep, jnp.where(kept, arange[None, :], big))

    # merged counts: integer column sums.  Precision: default (TF32-
    # eligible); operands are counts ≤ 2 and 0/1 one-hots, exact in TF32,
    # sums exact below 2^24 (N < 4M samples).
    group = (rep[:, None, :] == arange[None, :, None])        # [S, Pi, Pj]
    merged_cnt = jnp.einsum("snj,sij->sni", Dk,
                            group.astype(jnp.float32))        # [S,N,Pmax]
    is_rep = kept & (rep == arange[None, :])

    # ---- drop the last (merged) column ---------------------------------
    rev_last = jnp.argmax(jnp.flip(is_rep, axis=-1), axis=-1)
    last_rep = Pmax - 1 - rev_last                            # [S]
    any_rep = jnp.any(is_rep, axis=-1)
    var_cols = is_rep & (arange[None, :] != last_rep[:, None])
    k3 = jnp.sum(var_cols, axis=-1)                           # [S]
    degenerate = any_rep & (k3 == 0)

    # ---- assemble X = [1 | variant cols | covariates] ------------------
    # Variant columns gather as a tiny one-hot batched matmul over the
    # merged COUNT columns (f32), scaled once into f64; the intercept and
    # covariate columns overlay by slot type.  Precision: default (TF32-
    # eligible); merged counts (≤ 2 per path, ≤ 8 per merged column)
    # times 0/1 one-hots are exact in TF32 and in f32 accumulation.
    C = covar.shape[1] if with_covar else 0
    PT = 1 + Pmax + C
    t = jnp.arange(PT)[None, :]                               # [1, PT]
    k3b = k3[:, None]
    order = jnp.argsort(~var_cols, axis=-1, stable=True)      # [S, Pmax]
    var_slot = jnp.clip(t - 1, 0, Pmax - 1)
    var_src = jnp.take_along_axis(order, var_slot, axis=-1)   # [S, PT]
    is_var = (t >= 1) & (t - 1 < k3b)                         # [S, PT]
    onehot = ((var_src[:, None, :] == arange[:, None])
              & is_var[:, None, :])                           # [S, Pmax, PT]
    Xvar = jnp.einsum("snj,sjt->snt", merged_cnt,
                      onehot.astype(jnp.float32))             # [S, N, PT]
    X = Xvar.astype(jnp.float64) * recip[:, :, None]
    X = X.at[:, :, 0].set(1.0)                                # intercept
    if with_covar:
        # covariate columns live at slots k3 + 1 .. k3 + C
        cov_idx = t - 1 - k3b                                 # [S, PT]
        is_cov = (cov_idx >= 0) & (cov_idx < C) & ~is_var & (t >= 1)
        covmask = ((cov_idx[:, :, None] == jnp.arange(C)[None, None, :])
                   & is_cov[:, :, None])                      # [S, PT, C]
        Xcov = jnp.einsum("nc,stc->snt",
                          jnp.asarray(covar, jnp.float64),
                          covmask.astype(jnp.float64))
        X = jnp.where(is_cov[:, None, :], Xcov, X)
    if not all_rows:
        # OLS semantics: samples with no allele call are dropped per snarl
        # (rows zeroed).  all_rows=True keeps every sample (EMMAX designs
        # for the LMM: uncalled genotype = 0, intercept/covars intact).
        X = jnp.where(used[:, :, None], X, 0.0)
    ncols = (1 + k3 + C).astype(jnp.int32)

    # -T table view: computed here but DCE'd from the jaxpr whenever the
    # caller does not consume it (count·recip == count/row_sum exactly,
    # see docstring)
    norm = Dk.astype(jnp.float64) * recip[:, :, None]

    return {
        "X": X,
        "used": used,
        "ncols": ncols,
        "filtered": filtered,
        "degenerate": degenerate,
        "allele_paths": allele_paths,
        "norm": norm,
        "kept": kept,
    }


def _design_for(packed: PackedChromosome, covar: Optional[np.ndarray],
                min_individuals: int, min_haplotypes: int,
                maf_threshold: float, with_covar: bool,
                device_matrix=None, all_rows: bool = False):
    C = 0 if covar is None else covar.shape[1]
    covar_in = (np.zeros((packed.n_haplotypes // 2, 0))
                if covar is None else covar)
    # Packed-words path when the chromosome arrived bit-packed from the
    # native core (or the caller cached uint32 words on device); dense f32
    # otherwise.  Value-identical (pinned by tests).  The upload-arg
    # assembly lives in ONE place (_packed_args).
    args = _packed_args(packed, covar, device_matrix)
    if args is not None:
        words, idx, valid, sidx, covar_d = args
        return quantitative_design_packed(
            words, idx, valid, sidx, covar_d,
            jnp.float64(min_individuals),
            jnp.float64(min_haplotypes),
            jnp.float64(maf_threshold),
            n_haplotypes=packed.n_haplotypes,
            with_covar=with_covar and C > 0,
            all_rows=all_rows,
        )
    return quantitative_design_device(
        device_matrix if device_matrix is not None
        else jnp.asarray(packed.matrix, jnp.float32),
        jnp.asarray(packed.coo_path),
        jnp.asarray(packed.coo_row),
        jnp.asarray(packed.n_edges_per_path),
        _upload_bool_bits(packed.path_valid),
        jnp.asarray(packed.snarl_path_idx),
        jnp.asarray(covar_in, jnp.float64),
        jnp.float64(min_individuals),
        jnp.float64(min_haplotypes),
        jnp.float64(maf_threshold),
        num_paths=int(packed.n_edges_per_path.shape[0]),
        with_covar=with_covar and C > 0,
        all_rows=all_rows,
    )


@partial(jax.jit, static_argnames=("n_haplotypes", "with_covar",
                                   "return_tables", "kind"))
def _fused_packed_analysis(words, path_idx, path_valid, snarl_path_idx,
                           covar, pheno, min_individuals, min_haplotypes,
                           maf_threshold, n_haplotypes: int,
                           with_covar: bool, return_tables: bool,
                           kind: str):
    """One-dispatch chunk analysis: design + regression + NA masking.

    Fusing matters twice: XLA dead-code-eliminates the big design
    intermediates from the executable's OUTPUTS when -T is off (X and
    norm are [S, N, P] f64 — hundreds of MB at chunk scale that would
    otherwise be materialized as unused output buffers), and the chunk
    costs one dispatch instead of a chain of five."""
    d = _design_packed_body(
        words, path_idx, path_valid, snarl_path_idx, covar,
        min_individuals, min_haplotypes, maf_threshold,
        n_haplotypes=n_haplotypes, with_covar=with_covar,
        all_rows=False)
    used = d["used"]
    y = pheno[None, :] * used
    nan = jnp.nan
    deg = d["degenerate"]
    # __wrapped__: trace the regression bodies directly (same nested-pjit
    # boundary consideration as _design_packed_body)
    if kind == "logistic":
        p, beta, se = logistic_regression_batch.__wrapped__(
            d["X"], y, used, d["ncols"])
        r2 = None
    else:
        from stoat_tpu.stats.linreg import (finish_linear_pvalues,
                                            linear_regression_stats_batch)
        t1, df_res, beta, se, r2 = \
            linear_regression_stats_batch.__wrapped__(
                d["X"], y, used, d["ncols"])
        p = finish_linear_pvalues.__wrapped__(t1, df_res)
    out = {
        "filtered": d["filtered"],
        "allele_paths": d["allele_paths"],
        "p": jnp.where(deg, nan, p),
        "beta": jnp.where(deg, nan, beta),
        "se": jnp.where(deg, nan, se),
    }
    if r2 is not None:
        out["r2"] = jnp.where(deg, nan, r2)
    if return_tables:
        out.update(norm=d["norm"], used=used, kept=d["kept"])
    return out


def _fused_dual_body(words, path_idx, path_valid, snarl_path_idx,
                     tail, g1_words, covar, pheno_q, min_individuals,
                     min_haplotypes, maf_threshold,
                     n_haplotypes: int, tails: bool = True,
                     with_covar: bool = False):
    """Shared body of the fused dual program (see _fused_dual_analysis).

    ``tails=False`` defers BOTH special-function tails — the chi²
    igammac and the linear-regression betainc — for shard_map callers
    (parallel/sharded.dual_analyze_sharded): they compile
    pathologically slowly under manual partitioning, so the raw
    statistics ship out and the tails finish on gathered arrays."""
    from stoat_tpu.pipeline import packed as _pk
    from stoat_tpu.pipeline.binary import _binary_from_path_counts
    from stoat_tpu.stats.linreg import (finish_linear_pvalues,
                                        linear_regression_stats_batch)

    mem_words = _pk.membership_words_body(words, path_idx)
    g0p, g1p = _pk.packed_binary_counts.__wrapped__(
        mem_words, path_valid, tail, g1_words)
    out = _binary_from_path_counts(
        g0p, g1p, snarl_path_idx, min_individuals, min_haplotypes,
        maf_threshold, tails=tails)

    membership = _pk.unpack_membership_body(mem_words, path_valid,
                                            n_haplotypes)
    d = _design_from_membership(
        membership, snarl_path_idx, covar, min_individuals,
        min_haplotypes, maf_threshold, with_covar=with_covar,
        all_rows=False)
    used = d["used"]
    y = pheno_q[None, :] * used
    t1, df_res, beta, se, r2 = linear_regression_stats_batch.__wrapped__(
        d["X"], y, used, d["ncols"])
    nan = jnp.nan
    deg = d["degenerate"]
    out.update({
        "q_filtered": d["filtered"],
        "q_allele_paths": d["allele_paths"],
        "q_beta": jnp.where(deg, nan, beta),
        "q_se": jnp.where(deg, nan, se),
        "q_r2": jnp.where(deg, nan, r2),
    })
    if tails:
        p = finish_linear_pvalues.__wrapped__(t1, df_res)
        out["q_p"] = jnp.where(deg, nan, p)
    else:
        out["q_t1"] = t1
        out["q_df_res"] = df_res
        out["q_deg"] = deg
    return out


@partial(jax.jit, static_argnames=("n_haplotypes", "with_covar"))
def _fused_dual_analysis(words, path_idx, path_valid, snarl_path_idx,
                         tail, g1_words, covar, pheno_q, min_individuals,
                         min_haplotypes, maf_threshold,
                         n_haplotypes: int, with_covar: bool = False):
    """Binary chi²/Fisher AND quantitative OLS in ONE dispatch.

    The dual-phenotype run's device program: the packed membership
    AND-reduce — the single most expensive device stage — is computed
    once and feeds both the binary popcount tables and the quantitative
    design.  Quantitative outputs carry a ``q_`` prefix so both result
    sets ride one wire pack (one device→host copy per chunk)."""
    return _fused_dual_body(
        words, path_idx, path_valid, snarl_path_idx, tail, g1_words,
        covar, pheno_q, min_individuals, min_haplotypes, maf_threshold,
        n_haplotypes=n_haplotypes, tails=True, with_covar=with_covar)


class PrefixView:
    """Writer-facing view exposing ``q_``-prefixed dual-run keys under
    their plain names (shares the underlying FlatResult's single
    materialized wire array)."""

    def __init__(self, res, prefix: str = "q_"):
        self._res = res
        self._prefix = prefix

    def __getitem__(self, key):
        return self._res[self._prefix + key]

    def __contains__(self, key):
        return (self._prefix + key) in self._res


def _packed_args(packed: PackedChromosome, covar, device_matrix,
                 force_pack: bool = False):
    """Device args for the fused packed path, or None (dense fallback).

    ``force_pack``: pack a dense-source chromosome on host instead of
    returning None — for callers whose device program exists only in
    the packed-words form (the fused dual)."""
    from stoat_tpu.pipeline import packed as _pk
    if device_matrix is not None and device_matrix.dtype == jnp.uint32:
        words = device_matrix
    elif packed.words is not None or force_pack:
        words = jnp.asarray(packed.packed_words())
    else:
        return None
    covar_in = (np.zeros((packed.n_haplotypes // 2, 0))
                if covar is None else covar)
    return (words,
            _pk.upload_path_idx(packed.path_edge_idx(),
                                int(words.shape[0]) - 1),
            _upload_bool_bits(packed.path_valid),
            _pk.upload_snarl_path_idx(packed.snarl_path_idx),
            jnp.asarray(covar_in, jnp.float64))


def lmm_analyze_chromosome(packed: PackedChromosome,
                           lmm_ctx,
                           covar: Optional[np.ndarray],
                           min_individuals: int,
                           min_haplotypes: int,
                           maf_threshold: float,
                           device_matrix=None,
                           return_tables: bool = False,
                           block: bool = True
                           ) -> Dict[str, np.ndarray]:
    """Kinship-corrected GLS per snarl (EMMAX; stats/lmm.py).

    Same table construction and filtration as the OLS path, but EMMAX
    designs keep every sample (all_rows=True) and the solve runs on rows
    rotated by the dataset-level variance structure."""
    from stoat_tpu.stats.lmm import lmm_regression_batch

    design = _design_for(packed, covar, min_individuals, min_haplotypes,
                         maf_threshold, with_covar=True,
                         device_matrix=device_matrix, all_rows=True)
    p, beta, se, r2 = lmm_regression_batch(
        design["X"], lmm_ctx, design["ncols"])
    nan = jnp.nan
    degenerate = design["degenerate"]
    out = {
        "filtered": design["filtered"],
        "allele_paths": design["allele_paths"],
        "p": jnp.where(degenerate, nan, p),
        "beta": jnp.where(degenerate, nan, beta),
        "se": jnp.where(degenerate, nan, se),
        "r2": jnp.where(degenerate, nan, r2),
    }
    if return_tables:
        out.update(norm=design["norm"], used=design["used"],
                   kept=design["kept"])
    return fetch_all(out) if block else out


def quantitative_analyze_chromosome(packed: PackedChromosome,
                                    phenotype: np.ndarray,
                                    covar: Optional[np.ndarray],
                                    min_individuals: int,
                                    min_haplotypes: int,
                                    maf_threshold: float,
                                    device_matrix=None,
                                    return_tables: bool = False,
                                    block: bool = True
                                    ) -> Dict[str, np.ndarray]:
    """OLS per snarl.  Returns per-snarl arrays incl. formatted inputs."""
    C = 0 if covar is None else covar.shape[1]
    args = _packed_args(packed, covar, device_matrix)
    if args is not None:
        out = _fused_packed_analysis(
            *args, jnp.asarray(phenotype, jnp.float64),
            jnp.float64(min_individuals), jnp.float64(min_haplotypes),
            jnp.float64(maf_threshold),
            n_haplotypes=packed.n_haplotypes, with_covar=C > 0,
            return_tables=return_tables, kind="linear")
        return fetch_all(out) if block else out
    design = _design_for(packed, covar, min_individuals, min_haplotypes,
                         maf_threshold, with_covar=True,
                         device_matrix=device_matrix)
    used = design["used"]
    y = jnp.asarray(phenotype, jnp.float64)[None, :] * used
    p, beta, se, r2 = linear_regression_batch(
        design["X"], y, used, design["ncols"])
    nan = jnp.nan
    degenerate = design["degenerate"]
    out = {
        "filtered": design["filtered"],
        "allele_paths": design["allele_paths"],
        "p": jnp.where(degenerate, nan, p),
        "beta": jnp.where(degenerate, nan, beta),
        "se": jnp.where(degenerate, nan, se),
        "r2": jnp.where(degenerate, nan, r2),
    }
    if return_tables:
        out.update(norm=design["norm"], used=used, kept=design["kept"])
    return fetch_all(out) if block else out


def binary_covar_analyze_chromosome(packed: PackedChromosome,
                                    binary_phenotype: np.ndarray,
                                    covar: Optional[np.ndarray],
                                    min_individuals: int,
                                    min_haplotypes: int,
                                    maf_threshold: float,
                                    device_matrix=None,
                                    return_tables: bool = False,
                                    block: bool = True
                                    ) -> Dict[str, np.ndarray]:
    """IRLS logistic per snarl (covariates ignored in the model, as in the
    reference — see module docstring)."""
    args = _packed_args(packed, None, device_matrix)
    if args is not None:
        out = _fused_packed_analysis(
            *args, jnp.asarray(binary_phenotype.astype(np.float64)),
            jnp.float64(min_individuals), jnp.float64(min_haplotypes),
            jnp.float64(maf_threshold),
            n_haplotypes=packed.n_haplotypes, with_covar=False,
            return_tables=return_tables, kind="logistic")
        return fetch_all(out) if block else out
    design = _design_for(packed, covar, min_individuals, min_haplotypes,
                         maf_threshold, with_covar=False,
                         device_matrix=device_matrix)
    used = design["used"]
    y = jnp.asarray(binary_phenotype.astype(np.float64))[None, :] * used
    p, beta, se = logistic_regression_batch(
        design["X"], y, used, design["ncols"])
    nan = jnp.nan
    degenerate = design["degenerate"]
    out = {
        "filtered": design["filtered"],
        "allele_paths": design["allele_paths"],
        "p": jnp.where(degenerate, nan, p),
        "beta": jnp.where(degenerate, nan, beta),
        "se": jnp.where(degenerate, nan, se),
    }
    if return_tables:
        out.update(norm=design["norm"], used=used, kept=design["kept"])
    return fetch_all(out) if block else out


def eqtl_design_for_chromosome(packed: PackedChromosome,
                               covar: Optional[np.ndarray],
                               min_individuals: int, min_haplotypes: int,
                               maf_threshold: float, device_matrix=None):
    """Shared design for the eQTL mode; the caller pairs snarls with genes
    and runs OLS per (snarl, gene)."""
    design = _design_for(packed, covar, min_individuals, min_haplotypes,
                         maf_threshold, with_covar=True,
                         device_matrix=device_matrix)
    return design


def eqtl_regress_pairs(design, pair_snarl: np.ndarray,
                       expr: np.ndarray) -> Dict[str, np.ndarray]:
    """OLS for (snarl, gene) pairs.

    Args:
      design: output of eqtl_design_for_chromosome (device arrays).
      pair_snarl: [B] snarl row per pair.
      expr: [B, N] expression phenotype per pair (gene rows already
        gathered on host).
    """
    ps = jnp.asarray(pair_snarl)
    X = design["X"][ps]
    used = design["used"][ps]
    ncols = design["ncols"][ps]
    degenerate = design["degenerate"][ps]
    y = jnp.asarray(expr, jnp.float64) * used
    p, beta, se, r2 = linear_regression_batch(X, y, used, ncols)
    nan = jnp.nan
    out = {
        "p": jnp.where(degenerate, nan, p),
        "beta": jnp.where(degenerate, nan, beta),
        "se": jnp.where(degenerate, nan, se),
        "r2": jnp.where(degenerate, nan, r2),
    }
    return fetch_all(out)
