"""Batched closed-form OLS linear regression with masked rows/columns.

Vectorized re-design of LinearRegression::linear_regression
(/root/reference/src/stats_test.cpp:383-506).  One call solves a whole batch
of per-snarl regressions: design matrices are padded to a common column count
and sample rows are masked (excluded rows have all-zero X rows and y = 0, so
they contribute nothing to the normal equations — exactly equivalent to the
reference's compacted per-snarl tables).

Replicated semantics:
  - X = [intercept | path dosages | covariates]     (stats_test.cpp:440-453)
  - XtX^-1 via LDLT solve, falling back to an SVD pseudo-inverse with
    absolute singular-value tolerance 1e-6 when any LDLT pivot |D| < 1e-10
    (stats_test.cpp:383-421; we use an unpivoted LDLT recursion — Eigen's is
    pivoted, but the |D|min magnitudes agree for the PSD XtX seen here)
  - df_res = max(n - p + 1, 1)                      (stats_test.cpp:467-468)
  - p-value: two-tailed Student-t of the FIRST variant column only; NaN/inf
    t-statistics map to p = 1.0                     (stats_test.cpp:479-487)
  - returns (p, beta[1], se[1], r2)
"""

from __future__ import annotations

from stoat_tpu import jaxconfig  # noqa: F401

import jax
import jax.numpy as jnp
from jax import lax

from stoat_tpu.stats.special import student_t_sf2
from stoat_tpu.stats.linalg import (ldlt_factor, ldlt_solve, sym_pinv)

__all__ = ["linear_regression_batch", "linear_regression_stats_batch",
           "finish_linear_pvalues"]

_LDLT_TOL = 1e-10  # stats_test.cpp:401
_PINV_TOL = 1e-6   # stats_test.cpp:386


# Up to this design width the regression runs fully unrolled on [B]- and
# [B, N]-shaped arrays instead of [B, P, P] matrix forms and sequential
# LDLT/solve loops over nearly-empty P x P tiles.
_UNROLL_P_MAX = 8


def _ols_unrolled_body(X, y, row_mask, ncols):
    """Unrolled small-P OLS: every intermediate is [B] or [B, N]."""
    X = jnp.asarray(X, jnp.float64)
    y = jnp.asarray(y, jnp.float64)
    row_mask = jnp.asarray(row_mask, bool)
    B, N, P = X.shape

    cols = [X[:, :, j] for j in range(P)]
    real = [j < ncols for j in range(P)]                 # [B] bool each

    # normal equations (padded col j: X col is all-zero; diagonal gets +1
    # exactly like the matrix path's pad_diag)
    XtX = [[None] * P for _ in range(P)]
    for i in range(P):
        for j in range(i, P):
            s = jnp.sum(cols[i] * cols[j], axis=-1)
            if i == j:
                s = s + jnp.where(real[i], 0.0, 1.0)
            XtX[i][j] = XtX[j][i] = s
    Xty = [jnp.sum(cols[j] * y, axis=-1) for j in range(P)]

    # unpivoted LDL^T, unrolled (same recursion as ldlt_factor)
    L = [[None] * P for _ in range(P)]
    D = [None] * P
    for j in range(P):
        dj = XtX[j][j]
        for k in range(j):
            dj = dj - L[j][k] * L[j][k] * D[k]
        D[j] = dj
        dj_safe = jnp.where(dj == 0.0, 1.0, dj)
        for i in range(j + 1, P):
            s = XtX[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k] * D[k]
            L[i][j] = s / dj_safe

    bad = jnp.zeros((B,), bool)
    for j in range(P):
        bad = bad | (real[j] & ((jnp.abs(D[j]) < _LDLT_TOL)
                                | ~jnp.isfinite(D[j])))

    # inverse columns via solves against the identity
    D_safe = [jnp.where(D[j] == 0.0, 1.0, D[j]) for j in range(P)]
    inv = [[None] * P for _ in range(P)]
    for m in range(P):
        z = [None] * P
        for i in range(P):
            s = jnp.full((B,), 1.0) if i == m else jnp.zeros((B,))
            for k in range(i):
                s = s - L[i][k] * z[k]
            z[i] = s
        x = [None] * P
        for t in range(P - 1, -1, -1):
            s = z[t] / D_safe[t]
            for k in range(t + 1, P):
                s = s - L[k][t] * x[k]
            x[t] = s
        for i in range(P):
            inv[i][m] = x[i]

    # rank-deficient rows: pseudo-inverse fallback, cond-gated
    # (rare; see linear_regression_stats_batch)
    def with_pinv():
        A = jnp.stack([jnp.stack(row, axis=-1) for row in XtX], axis=-2)
        pinv = sym_pinv(A, tol=_PINV_TOL)
        return [[jnp.where(bad, pinv[:, i, m], inv[i][m])
                 for m in range(P)] for i in range(P)]

    inv = lax.cond(jnp.any(bad), with_pinv, lambda: inv)

    beta = [sum(inv[i][m] * Xty[m] for m in range(P)) for i in range(P)]
    y_pred = cols[0] * beta[0][:, None]
    for j in range(1, P):
        y_pred = y_pred + cols[j] * beta[j][:, None]
    resid = jnp.where(row_mask, y - y_pred, 0.0)
    rss = jnp.sum(resid * resid, axis=-1)

    n_used = jnp.sum(row_mask, axis=-1).astype(jnp.float64)
    n_safe = jnp.where(n_used == 0, 1.0, n_used)
    y_mean = jnp.sum(jnp.where(row_mask, y, 0.0), axis=-1) / n_safe
    tss = jnp.sum(jnp.where(row_mask, (y - y_mean[:, None]) ** 2, 0.0),
                  axis=-1)
    r2 = 1.0 - rss / tss

    df_res = jnp.maximum(n_used - ncols.astype(jnp.float64) + 1.0, 1.0)
    mse = rss / df_res

    beta1 = beta[1]
    se1 = jnp.sqrt(inv[1][1] * mse)
    t1 = beta1 / se1
    return t1, df_res, beta1, se1, r2


@jax.jit
def linear_regression_stats_batch(X, y, row_mask, ncols):
    """Batched OLS returning (t1, df_res, beta1, se1, r2) — everything but
    the t-tail evaluation.

    Split out because ``lax.betainc``'s internal continued-fraction
    while_loop cannot run inside ``shard_map`` (its carry initialisation is
    not varying-aware); the sharded pipeline computes these statistics per
    shard and applies :func:`finish_linear_pvalues` on the gathered result.
    """
    if X.shape[2] <= _UNROLL_P_MAX:
        return _ols_unrolled_body(X, y, row_mask, ncols)
    X = jnp.asarray(X, jnp.float64)
    y = jnp.asarray(y, jnp.float64)
    row_mask = jnp.asarray(row_mask, bool)
    B, N, P = X.shape

    col_idx = jnp.arange(P)
    real_col = col_idx[None, :] < ncols[:, None]  # [B, P]
    pad_diag = jnp.where(real_col, 0.0, 1.0)

    XtX = jnp.einsum("bnp,bnq->bpq", X, X)
    XtX = XtX + pad_diag[:, :, None] * jnp.eye(P)[None]

    # LDLT-against-identity is exactly what Eigen does in the reference.
    L, D = ldlt_factor(XtX)
    bad_d = real_col & ((jnp.abs(D) < _LDLT_TOL) | ~jnp.isfinite(D))
    rank_deficient = jnp.any(bad_d, axis=-1)

    eye = jnp.broadcast_to(jnp.eye(P, dtype=X.dtype), (B, P, P))
    Z = ldlt_solve(XtX, eye)
    # The pseudo-inverse fallback runs only when some snarl is actually
    # rank-deficient (lax.cond on the batch-wide predicate; deficiency
    # is rare in real cohorts).
    XtXinv = lax.cond(
        jnp.any(rank_deficient),
        lambda: jnp.where(rank_deficient[:, None, None],
                          sym_pinv(XtX, tol=_PINV_TOL), Z),
        lambda: Z)

    Xty = jnp.einsum("bnp,bn->bp", X, y)
    beta = jnp.einsum("bpq,bq->bp", XtXinv, Xty)

    y_pred = jnp.einsum("bnp,bp->bn", X, beta)
    resid = jnp.where(row_mask, y - y_pred, 0.0)
    rss = jnp.sum(resid * resid, axis=-1)

    n_used = jnp.sum(row_mask, axis=-1).astype(jnp.float64)
    n_safe = jnp.where(n_used == 0, 1.0, n_used)
    y_mean = jnp.sum(jnp.where(row_mask, y, 0.0), axis=-1) / n_safe
    tss = jnp.sum(jnp.where(row_mask, (y - y_mean[:, None]) ** 2, 0.0), axis=-1)
    r2 = 1.0 - rss / tss

    df_res = jnp.maximum(n_used - ncols.astype(jnp.float64) + 1.0, 1.0)
    mse = rss / df_res

    se = jnp.sqrt(jnp.diagonal(XtXinv, axis1=1, axis2=2) * mse[:, None])
    beta1 = beta[:, 1]
    se1 = se[:, 1]
    t1 = beta1 / se1
    return t1, df_res, beta1, se1, r2


@jax.jit
def finish_linear_pvalues(t1, df_res):
    """Two-tailed Student-t p with NaN/inf -> 1.0 (stats_test.cpp:479-485)."""
    p = student_t_sf2(jnp.abs(t1), df_res)
    return jnp.where(jnp.isfinite(t1), p, 1.0)


@jax.jit
def linear_regression_batch(X, y, row_mask, ncols):
    """Batched OLS over padded design matrices.

    Args:
      X: [B, N, P] float64 — rows for excluded samples must be all-zero
         (including the intercept column); padded columns all-zero.
      y: [B, N] float64 — 0 for excluded rows.
      row_mask: [B, N] bool — True for included samples.
      ncols: [B] int — actual number of design columns (incl. intercept).

    Returns (p, beta1, se1, r2): each [B] float64.  The caller is
    responsible for NA-masking snarls that were filtered out entirely.
    """
    t1, df_res, beta1, se1, r2 = linear_regression_stats_batch(
        X, y, row_mask, ncols)
    return finish_linear_pvalues(t1, df_res), beta1, se1, r2
