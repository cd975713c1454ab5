"""End-to-end analysis pipelines (binary / binary+covar / quantitative /
eQTL), the batched device equivalents of the reference's SnarlAnalyzer
subclasses (/root/reference/src/snarl_analyzer.cpp:358-539)."""
