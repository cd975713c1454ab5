"""Permutation testing for GWAS (beyond the reference).

Empirical and family-wise-corrected p-values by phenotype permutation —
the classic answer to "are these asymptotic tails trustworthy on MY
cohort?".  The reference cannot offer this (its per-snarl scalar loop
makes K permutations K× the full run); here each chunk's packed
membership is computed ONCE on device and whole batches of permuted
phenotypes ride the same program, so 1,000 permutations cost ~60 extra
dispatches of counts + statistics (throughput on the GPU: not measured).

Method (Westfall–Young **min-P**):
  * per-permutation statistic = the ASYMPTOTIC p-value of the same test
    the main pipeline reports (chi² 2×2/2×N for binary, the OLS t test
    for quantitative), with the pipeline's exact filtration
    (pipeline/binary.py `_binary_from_path_counts` is reused directly).
    p-values are pivotal across snarls — raw chi²/|t| statistics are
    NOT comparable when degrees of freedom differ per snarl (a max-stat
    family would be dominated by high-df snarls).
  * per-snarl df is permutation-invariant (path coverage totals don't
    change under relabeling), so per-snarl empirical ranks by p equal
    ranks by statistic.
  * permutations relabel at the SAMPLE level (diploid haplotype pairs
    move together), one global relabeling per permutation shared by
    every chromosome AND both phenotypes of a dual run (one VCF pass
    serves `-b` and `-q` together).
  * per-snarl empirical p:  (1 + #{k : p_k[s] ≤ p_obs[s]}) / (K + 1)
  * family-wise (FWER) p:   (1 + #{k : min_s p_k[s] ≤ p_obs[s]}) / (K+1)
    with the min over ALL tested snarls genome-wide.
  * filtered / invalid / non-finite tables score p = +inf (never
    significant, never contribute to the null minimum).

Quantitative covariates are handled by **Freedman–Lane** residual
permutation: the reduced model ``y ~ [1 | covariates]`` is fit once
globally, permuted phenotypes are ``ŷ_reduced + P·residuals``, and the
per-snarl test is the covariate-including OLS — the same adjusted test
the main pipeline reports.  With no covariates this reduces exactly to
plain label permutation (the reduced fit is the constant mean, which is
permutation-invariant).

Binary covariates run the covariate-ADJUSTED **score test**: fit the
reduced logistic ``y ~ [1 | covariates]`` once, then per snarl
T = Uᵀ V⁻¹ U with U = Dᵀ(y − p̂) over the variant dosage columns D and
V the efficient information (covariate-projected); permutations permute
the reduced-model residuals (only the U matmul re-runs per
permutation).  The null respects the covariates — calibration on a
confounded cohort is pinned by tests.  Note P_ASY here is the adjusted
score-test p, deliberately NOT the main table's Wald p: the reference's
logistic ignores covariates entirely (stats_test.cpp:59-62, shadowed
locals — faithfully reproduced in stats/logreg.py), so the adjusted
permutation is the one place a confounded binary cohort gets a valid
answer.  Kinship (LMM) remains unadjusted (callers are warned).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from stoat_tpu import jaxconfig  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["binary_permutation_stats", "quantitative_permutation_stats",
           "run_permutation_test", "permutation_indices",
           "permutation_masks"]


def _sanitize_p(p, bad):
    """Filtered/invalid/non-finite → +inf (never significant, never in
    the null minimum); clip real p into [0, 1]."""
    p = jnp.clip(p, 0.0, 1.0)
    return jnp.where(bad | ~jnp.isfinite(p), jnp.inf, p)


@jax.jit
def _perm_binary_pvalues(mem_words, path_valid, tail, masks,
                         snarl_path_idx, min_individuals, min_haplotypes,
                         maf_threshold):
    """[K, S] asymptotic chi² p-values for K packed phenotype masks
    against one chunk's (shared) packed membership — the EXACT
    filtration/statistic of the asymptotic pipeline
    (binary._binary_from_path_counts; unused outputs are DCE'd)."""
    from stoat_tpu.pipeline import packed as _pk
    from stoat_tpu.pipeline.binary import _binary_from_path_counts
    from stoat_tpu.stats.special import chi2_sf

    def one(mask):
        g0p, g1p = _pk.packed_binary_counts.__wrapped__(
            mem_words, path_valid, tail, mask)
        out = _binary_from_path_counts(
            g0p, g1p, snarl_path_idx, min_individuals, min_haplotypes,
            maf_threshold, tails=False)
        p = chi2_sf(out["chi2_stat"], out["chi2_df"])
        bad = (out["filtered"] | out["chi2_invalid"] | out["chi2_zexp"])
        return _sanitize_p(p, bad)

    return jax.vmap(one)(masks)


@jax.jit
def _perm_quant_pvalues(X, used, ncols, bad, phenos):
    """[K, S] asymptotic OLS-t p-values for K permuted quantitative
    phenotypes against ONE precomputed design (X is phenotype-
    independent, so the expensive design assembly happens once)."""
    from stoat_tpu.stats.linreg import (finish_linear_pvalues,
                                        linear_regression_stats_batch)

    def one(ph):
        y = ph[None, :] * used
        t1, df_res, _b, _se, _r2 = \
            linear_regression_stats_batch.__wrapped__(X, y, used, ncols)
        p = finish_linear_pvalues.__wrapped__(t1, df_res)
        return _sanitize_p(p, bad)

    return jax.vmap(one)(phenos)


def logistic_null_context(pheno_bin: np.ndarray, covar):
    """Reduced-model logistic fit ``y ~ [1 | covariates]`` (host f64
    IRLS, tiny ridge for stability).  Returns (Z, w, e): the reduced
    design, the working weights p̂(1-p̂), and the response residuals
    y − p̂ — the ingredients of the covariate-adjusted score test."""
    y = np.asarray(pheno_bin, np.float64)
    C = (np.zeros((y.shape[0], 0))
         if covar is None else np.asarray(covar, np.float64))
    Z = np.concatenate([np.ones((y.shape[0], 1)), C], axis=1)
    beta = np.zeros(Z.shape[1])
    for _ in range(50):
        eta = Z @ beta
        p = 1.0 / (1.0 + np.exp(-eta))
        w = np.clip(p * (1.0 - p), 1e-8, None)
        H = Z.T @ (w[:, None] * Z) + 1e-8 * np.eye(Z.shape[1])
        step = np.linalg.solve(H, Z.T @ (y - p))
        beta = beta + step
        if np.max(np.abs(step)) < 1e-10:
            break
    p = 1.0 / (1.0 + np.exp(-(Z @ beta)))
    w = np.clip(p * (1.0 - p), 1e-8, None)
    return Z, w, y - p


def _ldlt_ill(Dpiv):
    """Per-batch flag: any LDLT pivot tiny relative to the largest —
    the factorization substitutes safe pivots (D==0 → 1), so garbage
    inverses come out FINITE; conditioning must be judged from the
    pivots themselves, never from isfinite on the result."""
    a = jnp.abs(Dpiv)
    amax = jnp.maximum(jnp.max(a, axis=1), 1e-300)
    return jnp.min(a, axis=1) <= 1e-10 * amax


def _score_test_precompute(X, used, ncols, Z, w):
    """Permutation-invariant pieces of the covariate-adjusted logistic
    score test, per snarl: the variant-column design D (slots 1..ncols-1
    of the with_covar=False quantitative design) and the inverse
    efficient information V⁻¹ = (DᵀWD − DᵀWZ (ZᵀWZ)⁻¹ ZᵀWD)⁻¹ with W
    restricted to each snarl's used samples.  Returns (D, Vinv, df,
    extra_bad); ``extra_bad`` flags snarls whose ZᵀWZ or efficient
    information is ill-conditioned (pivot test — one such snarl would
    otherwise get a garbage astronomical T and poison the genome-wide
    min-P null)."""
    from stoat_tpu.stats.linalg import ldlt_factor, ldlt_inverse, \
        ldlt_solve

    S, N, PT = X.shape
    t = jnp.arange(PT)
    varmask = (t[None, :] >= 1) & (t[None, :] < ncols[:, None])  # [S,PT]
    D = X * varmask[:, None, :]
    wt = w[None, :] * used                                   # [S, N]
    DW = D * wt[:, :, None]
    Vfull = jnp.einsum("snp,snq->spq", DW, D)
    A = jnp.einsum("snp,nc->spc", DW, Z)                     # DᵀWZ
    G = jnp.einsum("sn,nc,nd->scd", wt, Z, Z)                # ZᵀWZ
    _Lg, Dg = ldlt_factor(G)
    bad_g = _ldlt_ill(Dg)
    GinvAt = ldlt_solve(G, jnp.swapaxes(A, 1, 2))            # [S, C, P]
    V = Vfull - jnp.einsum("spc,scq->spq", A, GinvAt)
    # pad non-variant diagonal with 1 so the LDLT stays regular; the
    # padded block inverts to I and never touches T (U is 0 there)
    pad = (~varmask).astype(jnp.float64)
    Vp = V + jnp.einsum("sp,pq->spq", pad, jnp.eye(PT))
    _Lv, Dv = ldlt_factor(Vp)
    Vinv = ldlt_inverse(Vp)
    extra_bad = (bad_g | _ldlt_ill(Dv)
                 | ~jnp.isfinite(jnp.sum(Vinv, axis=(1, 2))))
    df = (ncols - 1).astype(jnp.float64)
    return D, Vinv, df, extra_bad


@jax.jit
def _score_precompute_jit(X, used, ncols, bad, Z, w):
    """One device pass for the permutation-invariant score pieces."""
    D, Vinv, df, extra_bad = _score_test_precompute(X, used, ncols, Z, w)
    return D, Vinv, jnp.maximum(df, 1.0), bad | extra_bad | (df < 1)


@jax.jit
def _perm_score_pvalues(D, used, Vinv, df, allbad, e_batch):
    """[K, S] covariate-adjusted score-test p-values: T = Uᵀ V⁻¹ U with
    U = Dᵀ(used ⊙ e_k) — the invariants (D, V⁻¹) come precomputed from
    _score_precompute_jit, so only the cheap U matmul and the chi² tail
    run per permutation block."""
    from stoat_tpu.stats.special import chi2_sf

    def one(e):
        U = jnp.einsum("snp,sn->sp", D, used * e[None, :])
        T = jnp.einsum("sp,spq,sq->s", U, Vinv, U)
        p = chi2_sf(jnp.maximum(T, 0.0), df)
        return _sanitize_p(p, allbad | ~jnp.isfinite(T))

    return jax.vmap(one)(e_batch)


def permutation_indices(n_samples: int, n_perms: int,
                        seed: int) -> np.ndarray:
    """[n_perms, n_samples] sample-level permutation index matrix,
    deterministic in ``seed`` — the ONE rng protocol every permutation
    consumer derives from."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_samples)
                     for _ in range(n_perms)])


def permutation_masks(pheno_bin: np.ndarray, n_perms: int, seed: int,
                      n_words: int,
                      perm_idx: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """[n_perms, W] uint32 packed case masks built ON TOP of
    :func:`permutation_indices` (haplotype pairs move together)."""
    from stoat_tpu.pipeline import packed as _pk

    pheno = np.asarray(pheno_bin).astype(bool)
    if perm_idx is None:
        perm_idx = permutation_indices(pheno.shape[0], n_perms, seed)
    out = np.empty((perm_idx.shape[0], n_words), np.uint32)
    for i, idx in enumerate(perm_idx):
        out[i] = _pk.pack_hap_mask_words(np.repeat(pheno[idx], 2),
                                         n_words)
    return out


class _ChunkDevice:
    """Shared per-chunk device inputs (membership computed once)."""

    def __init__(self, packed, device_matrix):
        from stoat_tpu.pipeline import packed as _pk

        words = (device_matrix if device_matrix is not None
                 else jnp.asarray(packed.packed_words()))
        self.W = int(words.shape[1])
        idx_dev = _pk.upload_path_idx(packed.path_edge_idx(),
                                      int(words.shape[0]) - 1)
        self.mem = _pk.membership_words(words, idx_dev)
        self.valid = _pk.upload_bool_bits(packed.path_valid)
        self.sidx = _pk.upload_snarl_path_idx(packed.snarl_path_idx)
        self.tail = jnp.asarray(
            _pk.tail_mask_words(packed.n_haplotypes, self.W))
        self.packed = packed


def _binary_chunk(dev: "_ChunkDevice", pheno, masks, th,
                  perm_chunk: int = 16):
    from stoat_tpu.pipeline import packed as _pk

    obs_mask = _pk.pack_hap_mask_words(
        np.repeat(np.asarray(pheno).astype(bool), 2), dev.W)
    obs = np.asarray(_perm_binary_pvalues(
        dev.mem, dev.valid, dev.tail, jnp.asarray(obs_mask[None, :]),
        dev.sidx, *th))[0]
    return obs, _batched(lambda block: _perm_binary_pvalues(
        dev.mem, dev.valid, dev.tail, jnp.asarray(block), dev.sidx,
        *th), masks, perm_chunk, obs.shape[0])


def freedman_lane_phenos(pheno_q: np.ndarray, covar,
                         perm_idx: np.ndarray) -> np.ndarray:
    """[K, N] Freedman–Lane permuted phenotypes: reduced-model fit
    (``y ~ [1 | covariates]``, ordinary least squares on host) plus
    permuted residuals.  With no covariates this is exactly plain label
    permutation (the reduced fit is the permutation-invariant mean).

    Approximation note: the reduced model is fit on ALL samples once
    (the standard whole-sample Freedman–Lane), while each snarl's OLS
    runs on its called-sample subset — for snarls with very low call
    rates whose callers have skewed covariates, permuted residuals can
    retain some within-subset covariate signal, so the adjusted null is
    approximate exactly where data are sparsest."""
    y = np.asarray(pheno_q, np.float64)
    C = (np.zeros((y.shape[0], 0))
         if covar is None else np.asarray(covar, np.float64))
    Z = np.concatenate([np.ones((y.shape[0], 1)), C], axis=1)
    beta, *_ = np.linalg.lstsq(Z, y, rcond=None)
    fit = Z @ beta
    resid = y - fit
    return fit[None, :] + resid[perm_idx]


def _logistic_chunk(dev: "_ChunkDevice", ctx, perm_idx, th,
                    perm_chunk: int = 16, e_perm=None):
    """(obs p, perm p) for the covariate-adjusted binary mode: the
    score test with reduced-model (``y ~ [1|covariates]``) residual
    permutation.  ``ctx`` = logistic_null_context output; the
    permutation-invariant D/V⁻¹ compute once per chunk and only the U
    matmul runs per block.  ``e_perm`` ([K, N] permuted residuals) is
    chunk-invariant: callers hoist it when looping."""
    from stoat_tpu.pipeline import packed as _pk
    from stoat_tpu.pipeline.quantitative import _design_from_membership

    Z, w, e = ctx
    packed = dev.packed
    membership = _pk.unpack_membership(dev.mem, dev.valid,
                                       packed.n_haplotypes)
    covar0 = jnp.zeros((packed.n_haplotypes // 2, 0), jnp.float64)
    d = _design_from_membership(membership, dev.sidx, covar0, *th,
                                with_covar=False, all_rows=False)
    bad = d["filtered"] | d["degenerate"]
    D, Vinv, df, allbad = _score_precompute_jit(
        d["X"], d["used"], d["ncols"], bad,
        jnp.asarray(Z, jnp.float64), jnp.asarray(w, jnp.float64))
    used = d["used"]
    obs = np.asarray(_perm_score_pvalues(
        D, used, Vinv, df, allbad,
        jnp.asarray(e[None, :], jnp.float64)))[0]
    if e_perm is None:
        e_perm = e[perm_idx]                               # [K, N]
    return obs, _batched(lambda block: _perm_score_pvalues(
        D, used, Vinv, df, allbad, jnp.asarray(block, jnp.float64)),
        e_perm, perm_chunk, obs.shape[0])


def _quant_chunk(dev: "_ChunkDevice", pheno_q, perm_idx, th,
                 perm_chunk: int = 8, covar=None, phenos=None):
    from stoat_tpu.pipeline import packed as _pk
    from stoat_tpu.pipeline.quantitative import _design_from_membership

    packed = dev.packed
    membership = _pk.unpack_membership(dev.mem, dev.valid,
                                       packed.n_haplotypes)
    n_samples = packed.n_haplotypes // 2
    covar_in = jnp.asarray(
        np.zeros((n_samples, 0)) if covar is None else covar,
        jnp.float64)
    with_covar = int(covar_in.shape[1]) > 0
    d = _design_from_membership(membership, dev.sidx, covar_in, *th,
                                with_covar=with_covar, all_rows=False)
    X, used, ncols = d["X"], d["used"], d["ncols"]
    bad = d["filtered"] | d["degenerate"]
    ph = np.asarray(pheno_q, np.float64)
    obs = np.asarray(_perm_quant_pvalues(
        X, used, ncols, bad, jnp.asarray(ph[None, :])))[0]
    if phenos is None:      # chunk-invariant: callers hoist when looping
        phenos = freedman_lane_phenos(ph, covar, perm_idx)
    return obs, _batched(lambda block: _perm_quant_pvalues(
        X, used, ncols, bad, jnp.asarray(block)), phenos,
        perm_chunk, obs.shape[0])


def _batched(fn, items: np.ndarray, chunk: int, S: int) -> np.ndarray:
    """Run ``fn`` over ``items`` in fixed-size blocks (one compiled
    shape), concatenating [K, S] results."""
    K = items.shape[0]
    outs = []
    for lo in range(0, K, chunk):
        hi = min(K, lo + chunk)
        block = items[lo:hi]
        if hi - lo < chunk:
            pad = np.repeat(block[-1:], chunk - (hi - lo), axis=0)
            block = np.concatenate([block, pad], axis=0)
        outs.append(np.asarray(fn(block))[: hi - lo])
    return (np.concatenate(outs, axis=0) if outs
            else np.zeros((0, S)))


def binary_permutation_stats(packed, pheno_bin, masks, min_individuals,
                             min_haplotypes, maf_threshold,
                             device_matrix=None, perm_chunk: int = 16):
    """(obs p [S], perm p [K, S]) for one snarl chunk (binary chi²)."""
    th = (jnp.float64(min_individuals), jnp.float64(min_haplotypes),
          jnp.float64(maf_threshold))
    return _binary_chunk(_ChunkDevice(packed, device_matrix), pheno_bin,
                         masks, th, perm_chunk)


def quantitative_permutation_stats(packed, pheno_q, perm_idx,
                                   min_individuals, min_haplotypes,
                                   maf_threshold, device_matrix=None,
                                   perm_chunk: int = 8, covariate=None):
    """(obs p [S], perm p [K, S]) for one snarl chunk (OLS t;
    Freedman-Lane when ``covariate`` is given)."""
    th = (jnp.float64(min_individuals), jnp.float64(min_haplotypes),
          jnp.float64(maf_threshold))
    return _quant_chunk(_ChunkDevice(packed, device_matrix), pheno_q,
                        perm_idx, th, perm_chunk, covar=covariate)


def run_permutation_test(vcf_path: str, snarls_chr: Dict[str, List],
                         output_tsv: Optional[str] = None,
                         pheno_bin: Optional[np.ndarray] = None,
                         n_perms: int = 1000, seed: int = 0,
                         min_individuals: int = 3,
                         min_haplotypes: int = 5,
                         maf_threshold: float = 0.05,
                         snarl_chunk_size: int = 8192,
                         quantitative_phenotype: Optional[np.ndarray]
                         = None,
                         output_tsv_quant: Optional[str] = None,
                         covariate: Optional[np.ndarray] = None,
                         use_mesh: Optional[bool] = None) -> int:
    """Genome-wide permutation pass.

    With BOTH phenotypes supplied, ONE VCF pass (and one membership
    computation per chunk) serves both — the dual-run discipline of
    run_vcf_analysis.  Writes per-snarl rows of the observed asymptotic
    p (``P_ASY``), the empirical p, and the min-P FWER p.  Returns the
    number of tested (non-filtered) snarls across all outputs.

    ``use_mesh``: shard the snarl axis over all visible devices
    (parallel/sharded.py binary_perm_pvalues_sharded /
    quant_perm_pvalues_sharded); default automatic — on when more than
    one device is attached.  Output parity across mesh shapes is pinned
    by tests."""
    import logging

    import jax as _jax

    from stoat_tpu import writer as Wr
    from stoat_tpu.pipeline.runner import (assemble_words_device,
                                           iter_chromosome_matrices)
    from stoat_tpu.tables import pack_chromosome_chunks

    logger = logging.getLogger("stoat")
    if use_mesh is None:
        use_mesh = _jax.device_count() > 1
    mesh = None
    if use_mesh:
        from stoat_tpu.parallel import make_snarl_mesh
        mesh = make_snarl_mesh()
        logger.info("Permutations: sharding snarls over %d devices",
                    _jax.device_count())
    jobs = []   # (kind, output path, phenotype)
    if pheno_bin is not None:
        if output_tsv is None:
            raise ValueError("output_tsv required for the binary pass")
        # with covariates, the binary pass runs the covariate-ADJUSTED
        # score test (reduced-model residual permutation) — the null
        # respects the covariates, unlike the unadjusted chi²
        kind = "binary" if covariate is None else "binary_score"
        jobs.append((kind, output_tsv, np.asarray(pheno_bin)))
    if quantitative_phenotype is not None:
        q_out = output_tsv_quant or output_tsv
        if q_out is None or (pheno_bin is not None
                             and output_tsv_quant is None):
            raise ValueError("output_tsv_quant required when both "
                             "phenotypes run")
        jobs.append(("quantitative", q_out,
                     np.asarray(quantitative_phenotype)))
    if not jobs:
        raise ValueError("a binary or quantitative phenotype is required")

    n_samples = len(jobs[0][2])
    n_hap = 2 * n_samples
    perm_idx = permutation_indices(n_samples, n_perms, seed)
    masks = None
    fl_phenos = None      # [K, N] Freedman-Lane matrix, computed once
    score_ctx = None      # (Z, w, e) reduced logistic fit, computed once
    score_eperm = None    # [K, N] permuted residuals, computed once
    th = (min_individuals, min_haplotypes, maf_threshold)

    # per job: rows (chrom, snarl, obs p, exceed count), null min [K]
    state = {kind: {"rows": [], "null_min": np.full(n_perms, np.inf)}
             for kind, _o, _p in jobs}

    def _accumulate(kind, chrom, snarls_sub, obs, perm):
        """The one Westfall–Young accounting path (min-P) shared by the
        mesh and single-device branches (byte parity between them is
        pinned by tests)."""
        st = state[kind]
        exc = np.sum(perm <= obs[None, :], axis=0)
        if obs.shape[0]:
            st["null_min"] = np.minimum(
                st["null_min"], perm.min(axis=1, initial=np.inf))
        st["rows"].extend((chrom, sn, float(obs[i]), int(exc[i]))
                          for i, sn in enumerate(snarls_sub))

    matrices = iter_chromosome_matrices(vcf_path, n_hap, snarls_chr,
                                        stream_device_words=mesh is None)
    for chrom, matrix in matrices:
        if chrom not in snarls_chr:
            continue
        if mesh is not None:
            # mesh path: the snarl axis shards over devices in blocks of
            # snarl_chunk_size per device (the same working-set bound as
            # the single-device path — an unchunked chromosome would
            # blow device memory on the [S_local, N, P] quant design);
            # the observed phenotype rides as batch row 0 so every
            # value (incl. P_ASY) comes from the same sharded program,
            # and one ShardedPermState per block serves every job (one
            # upload of the words/tables, invariants computed once).
            from stoat_tpu.parallel import (ShardedPermState,
                                            binary_perm_pvalues_sharded,
                                            logistic_score_perm_sharded,
                                            quant_perm_pvalues_sharded,
                                            shard_packed_chromosome)
            import jax as _jx
            n_dev = _jx.device_count()
            snarls_all = snarls_chr[chrom]
            batches = {}    # per-kind hoisted [1+K, ...] perm batches
            for blo in range(0, max(len(snarls_all), 1),
                             snarl_chunk_size * n_dev):
                sub = snarls_all[blo:blo + snarl_chunk_size * n_dev]
                if not sub:
                    break
                sharded = shard_packed_chromosome(sub, matrix, n_dev)
                pstate = ShardedPermState(sharded, mesh)
                Wm = sharded.words.shape[1]
                for kind, _out, pheno in jobs:
                    if kind == "binary":
                        if masks is None:
                            masks = permutation_masks(
                                pheno, n_perms, seed, Wm, perm_idx)
                        if "binary" not in batches:
                            from stoat_tpu.pipeline import packed as _pk
                            obs_mask = _pk.pack_hap_mask_words(
                                np.repeat(
                                    np.asarray(pheno).astype(bool), 2),
                                Wm)
                            batches["binary"] = np.concatenate(
                                [obs_mask[None, :], masks])
                        all_p = binary_perm_pvalues_sharded(
                            sharded, batches["binary"], mesh, *th,
                            state=pstate)
                    elif kind == "binary_score":
                        if score_ctx is None:
                            score_ctx = logistic_null_context(pheno,
                                                              covariate)
                        Zc, wc, ec = score_ctx
                        if "binary_score" not in batches:
                            batches["binary_score"] = np.concatenate(
                                [ec[None, :], ec[perm_idx]])
                        all_p = logistic_score_perm_sharded(
                            sharded, Zc, wc, batches["binary_score"],
                            mesh, *th, state=pstate)
                    else:
                        if fl_phenos is None:
                            fl_phenos = freedman_lane_phenos(
                                pheno, covariate, perm_idx)
                        if "quantitative" not in batches:
                            batches["quantitative"] = np.concatenate(
                                [np.asarray(pheno, np.float64)[None, :],
                                 fl_phenos])
                        all_p = quant_perm_pvalues_sharded(
                            sharded, batches["quantitative"], covariate,
                            mesh, *th, state=pstate)
                    _accumulate(kind, chrom, sharded.snarls,
                                all_p[0], all_p[1:])
            continue
        device_matrix = (assemble_words_device(matrix)
                         if getattr(matrix, "words", None) is not None
                         else None)  # Python-reader fallback: dense
        for packed in pack_chromosome_chunks(snarls_chr[chrom], matrix,
                                             snarl_chunk_size):
            dev = _ChunkDevice(packed, device_matrix)
            thj = (jnp.float64(th[0]), jnp.float64(th[1]),
                   jnp.float64(th[2]))
            for kind, _out, pheno in jobs:
                if kind == "binary":
                    if masks is None:
                        masks = permutation_masks(pheno, n_perms, seed,
                                                  dev.W, perm_idx)
                    obs, perm = _binary_chunk(dev, pheno, masks, thj)
                elif kind == "binary_score":
                    if score_ctx is None:
                        score_ctx = logistic_null_context(pheno,
                                                          covariate)
                        score_eperm = score_ctx[2][perm_idx]
                    obs, perm = _logistic_chunk(dev, score_ctx,
                                                perm_idx, thj,
                                                e_perm=score_eperm)
                else:
                    if fl_phenos is None:
                        fl_phenos = freedman_lane_phenos(
                            pheno, covariate, perm_idx)
                    obs, perm = _quant_chunk(dev, pheno, perm_idx, thj,
                                             covar=covariate,
                                             phenos=fl_phenos)
                S = len(packed.snarls)
                _accumulate(kind, chrom, packed.snarls, obs[:S],
                            perm[:, :S])

    n_tested = 0
    for kind, out_path, _pheno in jobs:
        st = state[kind]
        null_sorted = np.sort(st["null_min"])
        stat_col = "P_ASY"
        with open(out_path, "w", newline="") as fh:
            fh.write(f"#CHR\tSTART_POS\tEND_POS\tSNARL\t{stat_col}\t"
                     "P_EMP\tP_FWER\n")
            for chrom, sn, obs_p, exc in st["rows"]:
                if not np.isfinite(obs_p):
                    fh.write(f"{chrom}\t{sn.start_pos}\t{sn.end_pos}\t"
                             f"{sn.snarl_id_str}\tNA\tNA\tNA\n")
                    continue
                n_tested += 1
                p_emp = (1 + exc) / (n_perms + 1)
                fw = int(np.searchsorted(null_sorted, obs_p,
                                         side="right"))
                p_fwer = (1 + fw) / (n_perms + 1)
                fh.write(f"{chrom}\t{sn.start_pos}\t{sn.end_pos}\t"
                         f"{sn.snarl_id_str}\t{Wr.format_p(obs_p)}\t"
                         f"{Wr.format_p(p_emp)}\t{Wr.format_p(p_fwer)}\n")
        logger.info("Permutation test (%s): %d permutations -> %s",
                    kind, n_perms, out_path)
    return n_tested
