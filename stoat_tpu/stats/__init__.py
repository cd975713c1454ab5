"""Batched JAX statistics kernels — the numerics engine of stoat-tpu.

Every kernel is a pure, jit-able function over dense padded batches of
contingency tables / design matrices, replacing the reference's per-snarl
scalar C++ loops (/root/reference/src/stats_test.cpp) with vectorized XLA
code.  All statistics run in float64 (x64 mode) because the output contract
is 4-significant-digit string parity with the C++/Boost/Eigen oracle.

NA conventions: kernels return NaN where the reference returns the string
"NA"; the formatting layer maps NaN -> "NA".
"""

from stoat_tpu import jaxconfig  # noqa: F401  (must run before kernel imports)

from stoat_tpu.stats.chi2 import chi2_2x2, chi2_2xn
from stoat_tpu.stats.fisher import fisher_exact_2x2
from stoat_tpu.stats.linreg import linear_regression_batch
from stoat_tpu.stats.logreg import logistic_regression_batch

__all__ = [
    "chi2_2x2",
    "chi2_2xn",
    "fisher_exact_2x2",
    "linear_regression_batch",
    "logistic_regression_batch",
]
