"""Small batched linear algebra (stoat_tpu/stats/linalg.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from stoat_tpu.stats.linalg import ldlt_inverse, sym_pinv


def _rank_deficient_xtx(rng, batch, p):
    """XtX of designs whose last column repeats an earlier one."""
    X = rng.standard_normal((batch, 50, p))
    X[:, :, -1] = X[:, :, rng.integers(0, p - 1)]
    return np.einsum("bnp,bnq->bpq", X, X)


@pytest.mark.parametrize("p", [3, 4, 5, 6, 7, 8])
def test_sym_pinv_matches_numpy_on_rank_deficient(p):
    rng = np.random.default_rng(p)
    A = _rank_deficient_xtx(rng, 16, p)
    got = np.asarray(sym_pinv(jnp.asarray(A), tol=1e-6))
    for b in range(A.shape[0]):
        # absolute singular-value cut at 1e-6, as stats_test.cpp:386
        want = np.linalg.pinv(A[b], rcond=1e-6 / np.linalg.norm(A[b], 2))
        np.testing.assert_allclose(got[b], want, rtol=1e-8, atol=1e-12)


def test_ldlt_inverse_matches_numpy():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8, 40, 5))
    A = np.einsum("bnp,bnq->bpq", X, X)
    np.testing.assert_allclose(np.asarray(ldlt_inverse(jnp.asarray(A))),
                               np.linalg.inv(A), rtol=1e-10, atol=1e-12)
