"""Path-membership resolution on device — the pipeline's hottest op.

The reference's innermost loop tests, for every snarl path, whether each of
the 2N haplotype columns has every path edge set (identify_path,
snarl_analyzer.cpp:315-356): O(paths × edges × 2N) scalar bit reads.

Here the whole chromosome resolves at once: gather the edge-matrix rows
referenced by any path (COO), segment-sum them per path, and compare with
each path's edge count — one gather + segment-sum + compare, all dense.
float32 is exact for these small-integer counts.
"""

from __future__ import annotations

from stoat_tpu import jaxconfig  # noqa: F401

import jax
import jax.numpy as jnp
from functools import partial

__all__ = ["path_membership"]


@partial(jax.jit, static_argnames=("num_paths",))
def path_membership(matrix_f32, coo_path, coo_row, n_edges_per_path,
                    path_valid, num_paths: int):
    """Compute the [P, H] boolean path×haplotype membership matrix.

    Args:
      matrix_f32: [E, H] float32 edge×haplotype 0/1 matrix.
      coo_path, coo_row: [nnz] int32 — (flat path, edge row) references.
      n_edges_per_path: [P] int32 — resolvable (non-star) edges per path.
      path_valid: [P] bool — False if the path referenced a missing edge.
      num_paths: static P.

    A zero-edge valid path matches every haplotype (vacuous AND, matching
    identify_path's semantics for all-star paths); an invalid path matches
    none.
    """
    gathered = jnp.take(matrix_f32, coo_row, axis=0)          # [nnz, H]
    counts = jax.ops.segment_sum(gathered, coo_path,
                                 num_segments=num_paths)       # [P, H]
    full = counts == n_edges_per_path[:, None].astype(counts.dtype)
    return full & path_valid[:, None]
