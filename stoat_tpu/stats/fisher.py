"""Batched two-sided Fisher's exact test for 2x2 tables.

A vectorized re-design of the reference's PLINK-style relative-probability
scan (FisherKhi2::fastFishersExactTest, /root/reference/src/stats_test.cpp:
264-360).  The algorithm walks the hypergeometric distribution along the
table diagonal using multiplicative recurrences relative to the observed
table's probability (anchored at kExactTestBias), summing every table whose
probability does not exceed the observed one; the p-value is
``tprob / (cprob + tprob)``.

The reference's three sequential ``while`` loops (with early breaks on
underflow past the bias and on no-progress additions) are reproduced
branch-for-branch as ``lax.while_loop``s, vmapped over the batch.  Under
vmap, each lane performs exactly the same f64 multiply/add sequence as the
scalar code, so the p-values match the C++ oracle bit-for-bit (pinned by
tests/unittest/binary_test_unit.cpp:18-29,113-114).

Output conventions: NaN = "NA" (a zero row or column), 0.0 / 1.0 early
exits format naturally to "0" / "1" via set_precision.
"""

from __future__ import annotations

from stoat_tpu import jaxconfig  # noqa: F401

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["fisher_exact_2x2"]

# PLINK's constants with maximum usable double precision
# (stats_test.hpp:59-60).
_EPS2 = 9.094947017729282e-13
_BIAS = 1.0339757656912846e-25
_DBL_MAX = 1.7976931348623157e308


def _fisher_single(m11, m12, m21, m22):
    """Scalar (traceable) Fisher exact p; vmapped over the batch."""
    na = ((m11 + m12) == 0) | ((m21 + m22) == 0) | ((m11 + m21) == 0) | ((m12 + m22) == 0)

    # Canonicalize: left of center, m12 <= m21, m11 <= m22
    # (stats_test.cpp:279-299).
    m12, m21 = jnp.minimum(m12, m21), jnp.maximum(m12, m21)
    m11, m22 = jnp.minimum(m11, m22), jnp.maximum(m11, m22)
    swap_cols = (m11 * m22) > (m12 * m21)
    m11, m12 = jnp.where(swap_cols, m12, m11), jnp.where(swap_cols, m11, m12)
    m21, m22 = jnp.where(swap_cols, m22, m21), jnp.where(swap_cols, m21, m22)

    f = jnp.float64
    # Derive "constants" from the (possibly shard-varying) inputs so that
    # while_loop carries keep consistent varying-axis types under shard_map.
    zero = m11 * 0.0
    izero = zero.astype(jnp.int32)
    tprob0 = zero + (1.0 - _EPS2) * _BIAS

    # ---- Phase 1: scan right tail until prob drops below bias ----------
    # state: (cur11, cur12, cur21, cur22, cur_prob, cprob, tprob, status)
    # status: 0 = still scanning, 1 = broke via underflow-past-bias,
    #         2 = overflow ("0" early exit), 3 = loop exhausted (cur12<=0.5)
    def p1_cond(s):
        return (s[7] == 0) & (s[1] > 0.5)

    def p1_body(s):
        c11, c12, c21, c22, prob, cprob, tprob, status = s
        c11n = c11 + 1.0
        c22n = c22 + 1.0
        # ratio FIRST, then multiply — the reference's exact FP op
        # order (cur_prob *= (cur12*cur21)/(cur11*cur22)); the other
        # grouping rounds differently and overflows ~6 decimal orders
        # earlier on extreme tables
        probn = prob * ((c12 * c21) / (c11n * c22n))
        c12n = c12 - 1.0
        c21n = c21 - 1.0
        # the reference's `cur_prob > DBL_MAX`, written as "no longer
        # finite or above DBL_MAX": the inputs are positive and finite,
        # so a NaN here can only come from the overflow step
        overflow = ~jnp.isfinite(probn) | (probn > _DBL_MAX)
        under = probn < _BIAS
        tprobn = jnp.where(under, tprob + probn, tprob)
        cprobn = jnp.where(under | overflow, cprob, cprob + probn)
        statusn = jnp.where(overflow, jnp.int32(2),
                            jnp.where(under, jnp.int32(1), jnp.int32(0)))
        return (c11n, c12n, c21n, c22n, probn, cprobn, tprobn, statusn)

    s = (f(m11), f(m12), f(m21), f(m22), tprob0, zero, tprob0, izero)
    s = lax.while_loop(p1_cond, p1_body, s)
    c11, c12, c21, c22, prob, cprob, tprob, status = s

    overflow_zero = status == 2
    # cprob == 0 -> "1" (stats_test.cpp:322-324).  This happens when the
    # first phase immediately underflowed or never ran.
    early_one = (status != 2) & (cprob == 0.0)

    # ---- Phase 2: keep scanning right tail, adding into tprob ----------
    def p2_cond(s):
        return (s[7] == 0) & (s[1] > 0.5)

    def p2_body(s):
        c11, c12, c21, c22, prob, cprob, tprob, status = s
        c11n = c11 + 1.0
        c22n = c22 + 1.0
        probn = prob * ((c12 * c21) / (c11n * c22n))
        c12n = c12 - 1.0
        c21n = c21 - 1.0
        tprobn = tprob + probn
        stalled = tprobn <= tprob
        return (c11n, c12n, c21n, c22n, probn, cprob, tprobn,
                jnp.where(stalled, jnp.int32(1), status))

    # Phase 2 only runs if phase 1 exited via the underflow break (the
    # reference falls through with the same cur* state); if phase 1 simply
    # exhausted cur12, the loop body never runs either way.
    s2 = (c11, c12, c21, c22, prob, cprob, tprob,
          jnp.where(status == 1, jnp.int32(0), jnp.int32(1)))
    s2 = lax.while_loop(p2_cond, p2_body, s2)
    tprob = jnp.where(status == 1, s2[6], tprob)

    # ---- Phase 3: left tail from the original (canonical) table --------
    # do-while over cur11 > 0.5 with a no-progress early return
    # (stats_test.cpp:339-357).
    def p3_cond(s):
        c11, c12, c21, c22, prob, tprob, done, first, preaddp = s
        return (done == 0) & ((first == 1) | (c11 > 0.5))

    def p3_body(s):
        c11, c12, c21, c22, prob, tprob, done, first, preaddp = s
        c12n = c12 + 1.0
        c21n = c21 + 1.0
        probn = prob * ((c11 * c22) / (c12n * c21n))
        c11n = c11 - 1.0
        c22n = c22 - 1.0
        pre = tprob
        tprobn = tprob + probn
        stalled = tprobn <= pre
        return (c11n, c12n, c21n, c22n, probn, tprobn,
                jnp.where(stalled, izero + 1, izero),
                izero, jnp.where(stalled, pre, preaddp))

    run_p3 = m11 > 0
    s3 = (f(m11), f(m12), f(m21), f(m22), tprob0, tprob,
          jnp.where(run_p3, izero, izero + 1),
          izero + 1, zero)
    s3 = lax.while_loop(p3_cond, p3_body, s3)
    tprob3, stalled3, preaddp3 = s3[5], s3[6] == 1, s3[8]

    # If phase 3 stalled, return preaddp/(cprob+preaddp); else
    # tprob/(cprob+tprob) with the final (possibly phase-3-updated) tprob.
    tprob_final = jnp.where(run_p3, tprob3, tprob)
    stalled_exit = run_p3 & stalled3
    num = jnp.where(stalled_exit, preaddp3, tprob_final)
    p = num / (cprob + num)

    p = jnp.where(early_one, 1.0, p)
    p = jnp.where(overflow_zero, 0.0, p)
    return jnp.where(na, jnp.nan, p)


@jax.jit
def fisher_exact_2x2(m11, m12, m21, m22):
    """Two-sided Fisher exact p-values for batched 2x2 tables.

    Args: equal-shaped arrays of non-negative counts.
    Returns float64 p-values; NaN = "NA".
    """
    m11 = jnp.asarray(m11, jnp.float64)
    m12 = jnp.asarray(m12, jnp.float64)
    m21 = jnp.asarray(m21, jnp.float64)
    m22 = jnp.asarray(m22, jnp.float64)
    if m11.ndim == 0:
        return _fisher_single(m11, m12, m21, m22)
    flat = [x.reshape(-1) for x in (m11, m12, m21, m22)]
    out = jax.vmap(_fisher_single)(*flat)
    return out.reshape(m11.shape)
