"""stoat-tpu: a JAX + C++ pangenome association-testing engine.

A from-scratch re-design of the capabilities of Pa-Tou/stoat (snarl-tree
orchestrated GWAS on variation graphs) built on JAX/XLA.  Instead of
the reference's per-snarl scalar loops (C++/OpenMP, see
/root/reference/src/snarl_analyzer.cpp:165), stoat-tpu batches thousands of
snarls into dense padded tensors and runs the whole statistics engine —
chi-squared, Fisher's exact test, OLS linear regression, IRLS logistic
regression — as vectorized XLA programs on the GPU, sharded data-parallel
over snarls across a device mesh when several cards are visible.

Layering (bottom to top):

- ``stoat_tpu.formatting`` / ``stoat_tpu.corrections``: numeric-string and
  multiple-testing contracts (exact parity with the reference's
  ``set_precision`` / Holm / BH; utils.cpp:5-87, post_processing.cpp:7-38).
- ``stoat_tpu.stats``: batched JAX statistics kernels (the numerics oracle;
  stats_test.cpp).
- ``stoat_tpu.io``: host-side parsers (snarl TSV, VCF, phenotype, covariate,
  eQTL; arg_parser.cpp, snarl_data_t.cpp:8-112).
- ``stoat_tpu.matrix`` / ``stoat_tpu.tables``: edge×haplotype genotype matrix
  construction and batched per-snarl table building (matrix.cpp,
  snarl_analyzer.cpp:190-356).
- ``stoat_tpu.pipeline``: end-to-end analyzers for binary / binary+covariate /
  quantitative / eQTL modes (snarl_analyzer.cpp:358-539).
- ``stoat_tpu.parallel``: mesh construction and snarl-sharded SPMD execution.
- ``stoat_tpu.cli``: a stoat-compatible command-line interface
  (subcommands ``vcf``, ``graph``, ``BHcorrect``, ``version``; main.cpp).
"""

__version__ = "0.3.0"
