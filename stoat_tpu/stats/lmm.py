"""Linear mixed model (kinship-corrected GWAS) — beyond-parity feature.

The reference DECLARES an LMM and parses kinship matrices but never
implements the model: ``LMM`` is a commented-out stub
(/root/reference/src/stats_test.hpp:115-125) and the parsed
``KinshipMatrix`` (src/arg_parser.cpp:444-475) is dead.  stoat-tpu keeps
that behavior by default (parse + warn) and adds a real mixed model behind
``--lmm``.

Method: EMMA/EMMAX (Kang et al. 2008, 2010), the standard exact-eigen
approach — and a natural fit for batched device code, because the
per-snarl solve becomes a batched *rotated OLS* on the existing kernel:

  y = X b + u + e,   u ~ N(0, sg^2 K),  e ~ N(0, se^2 I),  delta = se^2/sg^2

  1. once per dataset (host, f64 numpy): eigendecompose K = U S U^T
  2. null model: REML-profile delta on a log10 grid + golden-section
     refinement (a scalar optimization — host numpy)
  3. per snarl (device, batched): GLS == OLS on rows rotated by
     W = diag(1/sqrt(S + delta)) U^T; the whole chromosome's snarl batch
     goes through ``linear_regression_stats_batch`` unchanged.

EMMAX semantics: every phenotyped sample stays in every test (samples
without an allele call contribute genotype 0), unlike the OLS path which
drops them per snarl — the rotation mixes rows, so per-snarl dropping is
not defined.  Reported R^2 is on the rotated (whitened) scale.

REML log-likelihood (profile form; n samples, q null-model columns):
  LL(delta) = 0.5 [ (n-q) ln((n-q)/(2 pi)) - (n-q) - (n-q) ln R(delta)
                    - sum_i ln(S_i + delta) - ln det(X~' W X~)
                    + ln det(X' X) ]
with R(delta) the weighted null-model RSS after rotation.  Validated in
tests against an independent unrotated evaluation using dense solves on
Sigma = K + delta I.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from stoat_tpu import jaxconfig  # noqa: F401

import jax.numpy as jnp

from stoat_tpu.stats.linreg import (linear_regression_stats_batch,
                                    finish_linear_pvalues)

__all__ = ["LmmContext", "fit_null_reml", "lmm_regression_batch",
           "reml_loglik"]

_DELTA_GRID = np.logspace(-5.0, 5.0, 121)
_GOLDEN_ITERS = 60


@dataclass
class LmmContext:
    """Dataset-level LMM state shared by every snarl test."""

    rot: np.ndarray        # [N, N]  W = diag(1/sqrt(S+delta)) U^T
    y_rot: np.ndarray      # [N]     rotated phenotype
    delta: float           # se^2 / sg^2 at the REML optimum
    sigma_g2: float
    sigma_e2: float
    loglik: float          # REML LL at the optimum

    @property
    def heritability(self) -> float:
        """Pseudo-heritability h^2 = sg^2/(sg^2+se^2) = 1/(1+delta)."""
        return 1.0 / (1.0 + self.delta)


def _solve_spd(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve with a pseudo-inverse fallback for singular designs
    (collinear/constant covariate columns) — the OLS path survives
    exactly this via its LDLT tolerance + SVD fallback
    (stats_test.cpp:398-421); the LMM null fit must not crash either."""
    try:
        return np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return np.linalg.pinv(A) @ b


def reml_loglik(delta: float, S: np.ndarray, yt: np.ndarray,
                X0t: np.ndarray, logdet_XtX: float) -> float:
    """REML profile log-likelihood at ``delta`` (rotated inputs)."""
    n = yt.shape[0]
    q = X0t.shape[1]
    w = 1.0 / (S + delta)
    XtWX = X0t.T @ (w[:, None] * X0t)
    beta = _solve_spd(XtWX, X0t.T @ (w * yt))
    r = yt - X0t @ beta
    R = float(np.sum(w * r * r))
    _sign, logdet_XtWX = np.linalg.slogdet(XtWX)
    nq = n - q
    return 0.5 * (nq * np.log(nq / (2.0 * np.pi)) - nq - nq * np.log(R)
                  - float(np.sum(np.log(S + delta))) - logdet_XtWX
                  + logdet_XtX)


def fit_null_reml(phenotype: np.ndarray, kinship: np.ndarray,
                  covar: Optional[np.ndarray] = None) -> LmmContext:
    """Fit the null model y = [1|covars] b + u + e by REML over delta.

    ``kinship`` must already be ordered to the phenotype's samples.
    """
    y = np.asarray(phenotype, np.float64)
    n = y.shape[0]
    K = np.asarray(kinship, np.float64)
    if K.shape != (n, n):
        raise ValueError(f"kinship is {K.shape}, expected ({n}, {n})")
    K = 0.5 * (K + K.T)
    S, U = np.linalg.eigh(K)
    S = np.clip(S, 0.0, None)

    X0 = np.ones((n, 1))
    if covar is not None and covar.size:
        X0 = np.concatenate([X0, np.asarray(covar, np.float64)], axis=1)
    yt = U.T @ y
    X0t = U.T @ X0
    _s, logdet_XtX = np.linalg.slogdet(X0.T @ X0)

    lls = np.array([reml_loglik(d, S, yt, X0t, logdet_XtX)
                    for d in _DELTA_GRID])
    best = int(np.argmax(lls))
    lo = _DELTA_GRID[max(best - 1, 0)]
    hi = _DELTA_GRID[min(best + 1, len(_DELTA_GRID) - 1)]

    # golden-section refine in log space
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = np.log(lo), np.log(hi)
    c = b - phi * (b - a)
    d = a + phi * (b - a)
    fc = reml_loglik(np.exp(c), S, yt, X0t, logdet_XtX)
    fd = reml_loglik(np.exp(d), S, yt, X0t, logdet_XtX)
    for _ in range(_GOLDEN_ITERS):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = reml_loglik(np.exp(c), S, yt, X0t, logdet_XtX)
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = reml_loglik(np.exp(d), S, yt, X0t, logdet_XtX)
    delta = float(np.exp(0.5 * (a + b)))
    ll = reml_loglik(delta, S, yt, X0t, logdet_XtX)

    w = 1.0 / (S + delta)
    XtWX = X0t.T @ (w[:, None] * X0t)
    beta = _solve_spd(XtWX, X0t.T @ (w * yt))
    r = yt - X0t @ beta
    R = float(np.sum(w * r * r))
    sigma_g2 = R / (n - X0.shape[1])
    rot = (np.sqrt(w)[:, None] * U.T)

    return LmmContext(rot=rot, y_rot=rot @ y, delta=delta,
                      sigma_g2=sigma_g2, sigma_e2=delta * sigma_g2,
                      loglik=float(ll))


def lmm_regression_batch(X: jnp.ndarray, ctx: LmmContext,
                         ncols: jnp.ndarray
                         ) -> Tuple[jnp.ndarray, ...]:
    """Batched per-snarl GLS via rotated OLS.

    Args:
      X: [S, N, PT] float64 — EMMAX designs over ALL samples (intercept 1
         everywhere, genotype 0 where uncalled; padded columns all-zero).
      ctx: dataset-level rotation (fit_null_reml).
      ncols: [S] actual design widths.
    Returns (p, beta1, se1, r2) each [S] float64.
    """
    rot = jnp.asarray(ctx.rot, jnp.float64)
    Xr = jnp.einsum("mn,snp->smp", rot, jnp.asarray(X, jnp.float64))
    S_, N, _ = Xr.shape
    yr = jnp.broadcast_to(jnp.asarray(ctx.y_rot, jnp.float64)[None, :],
                          (S_, N))
    mask = jnp.ones((S_, N), bool)
    t1, df_res, beta1, se1, r2 = linear_regression_stats_batch(
        Xr, yr, mask, ncols)
    p = finish_linear_pvalues(t1, df_res)
    return p, beta1, se1, r2
