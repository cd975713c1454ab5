"""SPMD execution: snarl-sharded meshes and sharded analysis dispatch.

The reference's only parallelism is OpenMP threads over snarls
(/root/reference/src/snarl_analyzer.cpp:165).  The equivalent here is
data parallelism over the snarl axis: a 1-D device mesh, the edge×haplotype
matrix and phenotype replicated, per-shard p-value/stat arrays gathered back
to host 0 for output and BH post-processing (SURVEY.md §5.8).
"""

from stoat_tpu.parallel.mesh import (
    make_snarl_mesh,
    shard_packed_chromosome,
    ShardedChromosome,
)
from stoat_tpu.parallel.sharded import (ShardedPermState,
                                        binary_analyze_sharded,
                                        binary_covar_analyze_sharded,
                                        binary_perm_pvalues_sharded,
                                        dual_analyze_sharded,
                                        eqtl_regress_pairs_sharded,
                                        lmm_analyze_sharded,
                                        logistic_score_perm_sharded,
                                        quant_perm_pvalues_sharded,
                                        quantitative_analyze_sharded)

__all__ = [
    "make_snarl_mesh",
    "shard_packed_chromosome",
    "ShardedChromosome",
    "binary_analyze_sharded",
    "binary_covar_analyze_sharded",
    "dual_analyze_sharded",
    "lmm_analyze_sharded",
    "quantitative_analyze_sharded",
    "eqtl_regress_pairs_sharded",
    "binary_perm_pvalues_sharded",
    "quant_perm_pvalues_sharded",
    "logistic_score_perm_sharded",
    "ShardedPermState",
]
