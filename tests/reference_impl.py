"""Independent scalar re-implementation of the reference pipeline semantics.

Written directly from the C++ sources (binary_table.cpp, quantitative_table
.cpp, snarl_analyzer.cpp, stats_test.cpp) using numpy/scipy — deliberately
naive and per-snarl, serving as the cross-validation oracle for the batched
device pipeline (the same role tests/regression/ plays for the reference).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.stats

from stoat_tpu.corrections import adjusted_holm
from stoat_tpu.io.snarl_file import SnarlData, path_to_edges


def identify_path(edges, edge_matrix, M: np.ndarray, ncols: int) -> List[int]:
    rows = []
    for e in edges:
        if e[0][0] == 0 or e[1][0] == 0:
            continue
        r = edge_matrix.find_edge(e)
        if r < 0:
            return []
        rows.append(r)
    return [c for c in range(ncols)
            if all(M[r, c] for r in rows)]


def chi2_p(g0: List[float], g1: List[float]) -> float:
    g0 = np.asarray(g0, float)
    g1 = np.asarray(g1, float)
    colsum = g0 + g1
    if colsum.sum() == 0 or g0.sum() == 0 or g1.sum() == 0 or np.any(colsum == 0):
        return np.nan
    stat, p, _, _ = scipy.stats.chi2_contingency(np.stack([g0, g1]),
                                                 correction=False)
    return p


def fisher_p(a, b, c, d) -> float:
    if (a + b == 0) or (c + d == 0) or (a + c == 0) or (b + d == 0):
        return np.nan
    _, p = scipy.stats.fisher_exact([[a, b], [c, d]])
    return p


def binary_reference(snarl: SnarlData, edge_matrix, M: np.ndarray,
                     phenotype: np.ndarray, min_individuals: int,
                     min_haplotypes: int, maf_threshold: float):
    """Returns None if filtered, else (p_fisher, p_chi2, g0_kept, g1_kept)."""
    ncols = M.shape[1]
    P = len(snarl.paths)
    g0 = np.zeros(P)
    g1 = np.zeros(P)
    total = 0
    for i, path in enumerate(snarl.paths):
        cols = identify_path(path_to_edges(path), edge_matrix, M, ncols)
        for idx in cols:
            if phenotype[idx // 2]:
                g1[i] += 1
            else:
                g0[i] += 1
            total += 1
    keep = (g0 + g1) != 0
    g0k, g1k = g0[keep], g1[keep]
    if (total // 2 < min_individuals or total < min_haplotypes
            or len(g0k) < 2):
        return None
    colsum = g0k + g1k
    freq1 = g1k / colsum
    maf = np.minimum(freq1, 1 - freq1)
    if np.sum(maf > maf_threshold) < 2:
        return None
    if len(g0k) == 2:
        pf = fisher_p(g0k[0], g0k[1], g1k[0], g1k[1])
        pc = chi2_p(g0k, g1k)
    else:
        pf = np.nan
        pc = chi2_p(g0k, g1k)
    return pf, pc, g0k, g1k


def quantitative_table(snarl: SnarlData, edge_matrix, M: np.ndarray,
                       n_samples: int):
    """create_quantitative_table semantics.  Returns (df, used_idx,
    allele_paths) where df rows follow ascending used-sample order."""
    ncols_h = M.shape[1]
    P = len(snarl.paths)
    allele_paths = np.zeros(P, int)
    genotypes = np.zeros((n_samples, 0))
    kept_cols: List[int] = []
    used: set = set()
    cols_data = []
    for col, path in enumerate(snarl.paths):
        hits = identify_path(path_to_edges(path), edge_matrix, M, ncols_h)
        if not hits:
            continue
        kept_cols.append(col)
        allele_paths[col] = len(hits)
        colvec = np.zeros(n_samples)
        for idx in hits:
            colvec[idx // 2] += 1
            used.add(idx // 2)
        cols_data.append(colvec)
    if cols_data:
        genotypes = np.stack(cols_data, axis=1)
    used_idx = sorted(used)
    df = []
    for i in used_idx:
        row = genotypes[i]
        s = row.sum()
        df.append(np.where(row > 0, row / (s if s else 1), 0.0))
    df = np.array(df) if df else np.zeros((0, len(cols_data)))
    return df, used_idx, allele_paths


def filtration_quantitative(df: np.ndarray, min_individuals: int,
                            min_haplotypes: int, maf: float) -> bool:
    if df.size == 0 or df.shape[1] < 2 or df.shape[0] < min_individuals:
        return True
    total = df.sum()
    if total < min_haplotypes:
        return True
    freq = df.sum(axis=0) / total
    m = np.minimum(freq, 1 - freq)
    return int(np.sum(m > maf)) < 2


def combine_identical_columns(df: np.ndarray) -> np.ndarray:
    n_rows, n_cols = df.shape
    if n_cols < 3:
        return df
    merged = [False] * n_cols
    new_cols = []
    for i in range(n_cols):
        if merged[i]:
            continue
        col = df[:, i].copy()
        for j in range(i + 1, n_cols):
            if merged[j]:
                continue
            if np.array_equal(df[:, j], df[:, i]):
                col += df[:, j]
                merged[j] = True
        new_cols.append(col)
    return np.stack(new_cols, axis=1)


def ols_reference(df: np.ndarray, y: np.ndarray,
                  covar: Optional[np.ndarray]):
    """stats_test.cpp:423-506 (first-variant-column report)."""
    n = df.shape[0]
    parts = [np.ones((n, 1)), df]
    if covar is not None and covar.shape[1] > 0:
        parts.append(covar)
    X = np.concatenate(parts, axis=1)
    XtX = X.T @ X
    XtXinv = np.linalg.inv(XtX)
    beta = XtXinv @ (X.T @ y)
    resid = y - X @ beta
    rss = float(resid @ resid)
    tss = float(((y - y.mean()) ** 2).sum())
    r2 = 1 - rss / tss
    df_res = max(n - X.shape[1] + 1, 1)
    mse = rss / df_res
    se = np.sqrt(np.diag(XtXinv) * mse)
    t = beta / se
    if not np.isfinite(t[1]):
        p = 1.0
    else:
        p = 2 * scipy.stats.t.sf(abs(t[1]), df_res)
    return p, beta[1], se[1], r2


def irls_reference(df: np.ndarray, y: np.ndarray):
    """stats_test.cpp:49-176 — covariates never enter the design."""
    n = df.shape[0]
    X = np.concatenate([np.ones((n, 1)), df], axis=1)
    pdim = X.shape[1]
    beta = np.zeros(pdim)
    beta_old = beta.copy()
    converged = False
    for _ in range(100):
        z = X @ beta
        prob = 1 / (1 + np.exp(-z))
        w = np.clip(prob * (1 - prob), 1e-8, 1.0)
        H = (X * w[:, None]).T @ X + 1e-4 * np.eye(pdim)
        g = X.T @ (y - prob) - 1e-4 * beta
        beta = beta + np.linalg.solve(H, g)
        if np.linalg.norm(beta - beta_old) < 1e-6:
            converged = True
            break
        beta_old = beta.copy()
    if not converged:
        return None
    z = X @ beta
    prob = 1 / (1 + np.exp(-z))
    w = np.clip(prob * (1 - prob), 1e-8, 1.0)
    H = (X * w[:, None]).T @ X + 1e-4 * np.eye(pdim)
    cov = np.linalg.inv(H)
    se = np.sqrt(np.diag(cov))
    pvals = np.array([2 * (1 - scipy.stats.norm.cdf(abs(beta[i] / se[i])))
                      for i in range(1, pdim)])
    if len(pvals) > 1:
        adj = adjusted_holm(pvals)
        k = int(np.argmin(adj))
        return adj[k], beta[k + 1], se[k + 1]
    return pvals[0], beta[1], se[1]


def quantitative_reference(snarl: SnarlData, edge_matrix, M: np.ndarray,
                           phenotype: np.ndarray,
                           covar: Optional[np.ndarray],
                           min_individuals: int, min_haplotypes: int,
                           maf_threshold: float):
    """Full quantitative per-snarl path.  None if filtered; "degenerate"
    when no variant column survives (reference UB)."""
    n_samples = len(phenotype)
    df, used_idx, allele_paths = quantitative_table(
        snarl, edge_matrix, M, n_samples)
    if filtration_quantitative(df, min_individuals, min_haplotypes,
                               maf_threshold):
        return None
    df = combine_identical_columns(df)
    df = df[:, :-1]  # remove_last_columns
    if df.shape[1] == 0:
        return "degenerate"
    y = phenotype[used_idx]
    cv = covar[used_idx] if covar is not None else None
    p, b, s, r2 = ols_reference(df, y, cv)
    return p, b, s, r2, allele_paths


def binary_covar_reference(snarl: SnarlData, edge_matrix, M: np.ndarray,
                           phenotype_bool: np.ndarray,
                           min_individuals: int, min_haplotypes: int,
                           maf_threshold: float):
    n_samples = len(phenotype_bool)
    df, used_idx, allele_paths = quantitative_table(
        snarl, edge_matrix, M, n_samples)
    if filtration_quantitative(df, min_individuals, min_haplotypes,
                               maf_threshold):
        return None
    df = combine_identical_columns(df)
    df = df[:, :-1]
    if df.shape[1] == 0:
        return "degenerate"
    y = phenotype_bool[used_idx].astype(float)
    res = irls_reference(df, y)
    if res is None:
        return ("NA", allele_paths)
    p, b, s = res
    return p, b, s, allele_paths
