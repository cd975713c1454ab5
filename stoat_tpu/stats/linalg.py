"""Float64 dense linear algebra for small batched matrices.

  - ``ldlt_factor`` / ``ldlt_solve``: unpivoted LDL^T — the same family as
    Eigen's LDLT used by the reference (stats_test.cpp:398-421,106-135);
    solving against the identity reproduces the reference's
    ``ldlt.solve(I)`` inverse.  This is the output-parity contract of the
    regressions, so it is written out step by step rather than taken from
    a library factorization with other pivoting and rounding.
  - ``sym_pinv``: the SVD pseudo-inverse fallback for rank-deficient
    designs (XtX is symmetric, so its SVD is its eigendecomposition up to
    signs), on ``jnp.linalg.eigh``.

Matrices are [B, P, P] with P small (design-matrix width).
"""

from __future__ import annotations

from stoat_tpu import jaxconfig  # noqa: F401

import jax.numpy as jnp
from jax import lax

__all__ = ["ldlt_factor", "ldlt_solve", "ldlt_inverse", "sym_pinv"]


def ldlt_factor(A):
    """Unpivoted LDL^T of batched symmetric [B, P, P].  Returns (L, D)."""
    B, P, _ = A.shape
    idx = jnp.arange(P)

    def body(j, carry):
        L, D = carry
        mask_k = idx < j
        Lj = L[:, j, :]                                  # [B, P]
        dj = A[:, j, j] - jnp.sum(
            jnp.where(mask_k, Lj * Lj * D, 0.0), axis=-1)
        D = D.at[:, j].set(dj)
        cross = jnp.einsum(
            "bik,bk->bi",
            jnp.where(mask_k[None, None, :], L, 0.0),
            jnp.where(mask_k[None, :], Lj * D, 0.0))
        dj_safe = jnp.where(dj == 0.0, 1.0, dj)
        col = (A[:, :, j] - cross) / dj_safe[:, None]
        rows_below = idx > j
        L = L.at[:, :, j].set(jnp.where(rows_below[None, :], col, L[:, :, j]))
        L = L.at[:, j, j].set(1.0)
        return L, D

    # initial carries derive from A so shard_map varying types match
    L0 = A * 0.0
    D0 = A[:, :, 0] * 0.0
    return lax.fori_loop(0, P, body, (L0, D0))


def _forward_sub_unit(L, B):
    """Solve L z = B with unit-lower L; B is [Bn, P, M]."""
    P = L.shape[1]

    def body(i, Z):
        acc = jnp.einsum("bk,bkm->bm",
                         jnp.where(jnp.arange(P) < i, L[:, i, :], 0.0), Z)
        return Z.at[:, i, :].set(B[:, i, :] - acc)

    Z0 = B * 0.0
    return lax.fori_loop(0, P, body, Z0)


def _backward_sub_unitT(L, B):
    """Solve L^T x = B with unit-lower L; B is [Bn, P, M]."""
    P = L.shape[1]

    def body(t, X):
        i = P - 1 - t
        # L^T[i, k] = L[k, i] for k > i
        acc = jnp.einsum("bk,bkm->bm",
                         jnp.where(jnp.arange(P) > i, L[:, :, i], 0.0), X)
        return X.at[:, i, :].set(B[:, i, :] - acc)

    X0 = B * 0.0
    return lax.fori_loop(0, P, body, X0)


def ldlt_solve(A, B):
    """Solve A X = B for symmetric A via unpivoted LDL^T.

    A: [Bn, P, P]; B: [Bn, P, M].  Returns X [Bn, P, M].
    """
    # tie the RHS to A's sharding (an unvarying identity RHS under
    # shard_map would mismatch the varying loop carries)
    B = B + A[:, :, :1] * 0.0
    L, D = ldlt_factor(A)
    Z = _forward_sub_unit(L, B)
    D_safe = jnp.where(D == 0.0, 1.0, D)
    W = Z / D_safe[:, :, None]
    return _backward_sub_unitT(L, W)


def ldlt_inverse(A):
    """A^{-1} via LDL^T against the identity (Eigen ``ldlt.solve(I)``)."""
    B, P, _ = A.shape
    eye = jnp.broadcast_to(jnp.eye(P, dtype=A.dtype), (B, P, P))
    return ldlt_solve(A, eye)


def sym_pinv(A, tol: float = 1e-6):
    """Moore-Penrose pseudo-inverse of batched symmetric A with an absolute
    singular-value tolerance (stats_test.cpp:383-396 applied to XtX).

    For symmetric A the SVD is the eigendecomposition up to signs; XLA
    lowers the batched f64 ``eigh`` to cuSOLVER on the GPU and LAPACK on
    the CPU."""
    w, V = jnp.linalg.eigh(A)
    winv = jnp.where(jnp.abs(w) > tol, 1.0 / jnp.where(w == 0, 1.0, w), 0.0)
    return jnp.einsum("bip,bp,bjp->bij", V, winv, V)
