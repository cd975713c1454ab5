"""stoat-compatible command-line interface.

Subcommands mirror /root/reference/src/main.cpp:47-84:
  vcf        — VCF-based GWAS (binary / quantitative / eQTL ± covariates)
               and snarl-path decomposition
  graph      — path-based association directly from graph haplotypes
  BHcorrect  — standalone Benjamini–Hochberg correction of a results TSV
  version    — print the version

Flags, defaults, and valid argument combinations follow
subcommand/vcf.cpp:53-261 (including the code default MAF 0.05 — the
reference's help text says 0.01 but the code says 0.05, vcf.cpp:46,69).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
from typing import List, Optional

__version__ = "0.3.0"

logger = logging.getLogger("stoat")

from stoat_tpu.logsetup import TRACE

_LOG_LEVELS = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO,
               3: logging.DEBUG, 4: TRACE}


def _setup_logging(verbosity: int) -> None:
    logging.basicConfig(
        level=_LOG_LEVELS.get(verbosity, logging.WARNING),
        format="[%(levelname)s] %(message)s", force=True)


def _check_file(path: str) -> str:
    """arg_parser.cpp:421-442."""
    if not os.path.isfile(path):
        raise SystemExit(f"File {path} does not exist.")
    return path


def _set_threads(n: int) -> None:
    """-t/--thread -> native-core worker count (vcf.cpp:179-184; the
    reference's omp_set_num_threads).  0 leaves the cores' default
    (all hardware threads)."""
    if n >= 1:
        os.environ["STOAT_THREADS"] = str(n)


def main_vcf(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="stoat vcf", add_help=True)
    ap.add_argument("-p", "--graph", metavar="FILE")
    ap.add_argument("-d", "--dist", metavar="FILE")
    ap.add_argument("-v", "--vcf", metavar="FILE")
    ap.add_argument("-s", "--snarl", metavar="FILE")
    ap.add_argument("-r", "--chr", dest="chr_file", metavar="FILE")
    ap.add_argument("-b", "--binary", metavar="FILE")
    ap.add_argument("-q", "--quantitative", metavar="FILE")
    ap.add_argument("-e", "--eqtl", metavar="FILE")
    # parsed-but-unused, mirroring the reference: vcf.cpp:89,120 parses
    # --make-bed and never reads it anywhere (a dead flag kept for
    # command-line parity)
    ap.add_argument("-m", "--make-bed", action="store_true")
    ap.add_argument("-c", "--covariate", metavar="FILE")
    ap.add_argument("-C", "--covar-name", metavar="NAME")
    ap.add_argument("-k", "--kinship", metavar="FILE")
    ap.add_argument("--permutations", type=int, default=0,
                    metavar="N",
                    help="run an N-permutation Westfall-Young min-P test "
                         "after the GWAS (empirical + FWER p-values into "
                         "{binary,quantitative}_permutation_vcf.tsv; "
                         "chi2 for -b, OLS t for -q, and with -c a "
                         "covariate-ADJUSTED score test for -b / "
                         "Freedman-Lane for -q — an extension "
                         "the reference lacks)")
    ap.add_argument("--perm-seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted run: chromosomes already "
                         "checkpointed in <output>.progress are skipped, "
                         "a partially-written chromosome is rewritten "
                         "(extension over the reference's snarl-cache-"
                         "only checkpointing, vcf.cpp:317-319)")
    ap.add_argument("--lmm", action="store_true",
                    help="kinship mixed model (EMMAX) for quantitative "
                         "traits — beyond the reference, whose LMM is a "
                         "stub; requires -k and -q")
    ap.add_argument("-g", "--gaf", action="store_true")
    ap.add_argument("-I", "--min-individuals", type=int, default=3)
    ap.add_argument("-H", "--min-haplotypes", type=int, default=5)
    ap.add_argument("-i", "--children", type=int, default=50)
    ap.add_argument("-y", "--cycle", type=int, default=1)
    ap.add_argument("-l", "--path-length", type=int, default=10000)
    ap.add_argument("-G", "--gene-position", metavar="FILE")
    ap.add_argument("-w", "--windows-gene", type=int, default=1000000)
    ap.add_argument("-T", "--table-threshold", type=float, default=-1)
    ap.add_argument("-M", "--maf", type=float, default=0.05)
    ap.add_argument("-t", "--thread", type=int, default=0,
                    help="native-core worker threads (0 = all cores; the reference defaults to 1)")
    ap.add_argument("-V", "--verbose", type=int, default=1)
    ap.add_argument("-o", "--output", default="output")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _set_threads(args.thread)

    # threshold validation (vcf.cpp:130-178)
    if args.min_individuals < 2:
        raise SystemExit("Error: [stoat vcf] min_individuals threshold must be > 1")
    if args.min_haplotypes < 2:
        raise SystemExit("Error: [stoat vcf] min_haplotypes threshold must be > 1")
    if args.children < 2:
        raise SystemExit("Error: [stoat vcf] Children threshold must be > 1")
    if args.cycle < 1:
        raise SystemExit("Error: [stoat vcf] Cycle threshold must be > 0")
    if args.path_length < 2:
        raise SystemExit("Error: [stoat vcf] Path length threshold must be > 1")
    if args.windows_gene < 1:
        raise SystemExit("Error: [stoat vcf] Windows gene threshold must be > 0")
    if args.table_threshold != -1 and not (0 < args.table_threshold <= 1):
        raise SystemExit("Error: [stoat vcf] Table threshold must be in (0,1]")
    if not (0 <= args.maf <= 1):
        raise SystemExit("Error: [stoat vcf] MAF must be in [0,1]")

    for path in (args.graph, args.dist, args.vcf, args.snarl, args.chr_file,
                 args.binary, args.quantitative, args.eqtl, args.covariate,
                 args.kinship, args.gene_position):
        if path:
            _check_file(path)

    covar_names = args.covar_name.split(",") if args.covar_name else []
    if args.covariate and not covar_names:
        logger.error("[stoat vcf] If --covariate path is provided you must "
                     "add the column name(s), using --covar-name")
        return 1
    if bool(args.eqtl) != bool(args.gene_position):
        logger.error("[stoat vcf] eqtl phenotype file and gene position "
                     "file must be provided together")
        return 1

    phenotype_count = sum(bool(p) for p in
                          (args.binary, args.quantitative, args.eqtl))
    has_decomposition_inputs = bool(args.graph) and bool(args.dist)
    only_snarl_parsing = False
    both_phenotypes = bool(args.binary) and bool(args.quantitative) \
        and not args.eqtl
    if ((args.snarl or has_decomposition_inputs) and args.vcf
            and (phenotype_count == 1 or both_phenotypes)):
        # GWAS (cases 1 & 2, vcf.cpp:237-240).  Extension beyond the
        # reference: -b AND -q together run BOTH analyses in one pass
        # (one VCF ingest, one device matrix upload) — the reference
        # requires one run per phenotype.
        pass
    elif (has_decomposition_inputs and not args.vcf and not args.snarl
          and phenotype_count == 0):
        only_snarl_parsing = True  # case 3
    else:
        logger.error(
            "[stoat vcf] Invalid argument combination provided.\n"
            "There are only 3 ways to launch stoat vcf:\n"
            "Case 1 (GWAS only): snarl_path + vcf_path + phenotype (+ optional file)\n"
            "Case 2 (GWAS + snarl path decomposition): graph_path + dist_path + vcf_path + phenotype (+ optional file)\n"
            "Case 3 (snarl path decomposition): graph_path + dist_path")
        return 1

    if args.gaf and (not args.binary or not args.graph):
        logger.error("[stoat vcf] GAF file can be generated only with binary "
                     "phenotype AND with the graph graph")
        return 1

    os.makedirs(args.output, exist_ok=True)
    regression_dir = os.path.join(args.output, "regression")
    if args.table_threshold != -1:
        os.makedirs(regression_dir, exist_ok=True)

    t_start = time.time()

    from stoat_tpu.io import (parse_binary_pheno, parse_chromosome_reference,
                              parse_covariates, parse_kinship_matrix,
                              parse_qtl_gene_file, parse_quantitative_pheno,
                              parse_snarl_path)
    from stoat_tpu.io.vcf import VcfReader

    list_samples: List[str] = []
    if not only_snarl_parsing:
        header_reader = VcfReader(args.vcf)
        list_samples = header_reader.samples
        header_reader.close()

    covariate = None
    if args.covariate:
        covariate = parse_covariates(args.covariate, covar_names, list_samples)

    binary_phenotype = quantitative_phenotype = eqtl_phenotype = None
    mode = None
    if args.binary:
        binary_phenotype, list_samples = parse_binary_pheno(
            args.binary, list_samples)
        mode = "binary_covar" if covariate is not None else "binary"
    if args.quantitative and (mode is None or both_phenotypes):
        quantitative_phenotype = parse_quantitative_pheno(
            args.quantitative, list_samples)
        if mode is None:
            mode = "quantitative"
    elif args.eqtl:
        eqtl_phenotype = parse_qtl_gene_file(
            args.eqtl, args.gene_position, list_samples)
        mode = "eqtl"

    lmm_ctx = None
    if args.kinship and args.lmm:
        # Beyond-parity: a real EMMAX mixed model (stats/lmm.py).  The
        # reference's LMM is a stub (stats_test.hpp:115-125).
        if mode != "quantitative":
            raise SystemExit("Error: [stoat vcf] --lmm requires a "
                             "quantitative phenotype (-q)")
        kin = parse_kinship_matrix(args.kinship)
        missing = [s for s in list_samples if s not in kin.ids]
        if missing:
            raise SystemExit(f"Error: [stoat vcf] kinship matrix is "
                             f"missing samples: {missing[:5]}...")
        order = [kin.ids.index(s) for s in list_samples]
        K = kin.matrix[np.ix_(order, order)]
        from stoat_tpu.stats.lmm import fit_null_reml
        lmm_ctx = fit_null_reml(quantitative_phenotype, K, covariate)
        mode = "lmm"
        logger.info("LMM null model: delta=%.4g sg2=%.4g se2=%.4g "
                    "h2=%.3f REML=%.3f", lmm_ctx.delta, lmm_ctx.sigma_g2,
                    lmm_ctx.sigma_e2, lmm_ctx.heritability, lmm_ctx.loglik)
    elif args.kinship:
        parse_kinship_matrix(args.kinship)  # parsed; LMM off by default
        logger.warning("Kinship matrix parsed but unused (parity with the "
                       "reference stub, stats_test.hpp:115-125). Pass "
                       "--lmm with -q to run the mixed model.")
    elif args.lmm:
        raise SystemExit("Error: [stoat vcf] --lmm requires a kinship "
                         "matrix (-k)")

    ref_chr = (parse_chromosome_reference(args.chr_file)
               if args.chr_file else set())

    # Load or compute the snarl decomposition
    if args.snarl:
        snarls_chr = parse_snarl_path(args.snarl)
    else:
        logger.info("Starting snarl decomposition... ")
        t0 = time.time()
        from stoat_tpu.graph import decompose_to_snarl_file
        snarls_chr = decompose_to_snarl_file(
            args.graph, args.dist, args.output, ref_chr,
            children_threshold=args.children,
            path_length_threshold=args.path_length,
            cycle_threshold=args.cycle)
        logger.info("Snarl time decomposition : %.3f s", time.time() - t0)
        if only_snarl_parsing:
            return 0

    t_gwas = time.time()
    logger.info("Starting GWAS analysis...")
    output_tsv = os.path.join(
        args.output,
        "binary_table_vcf.tsv" if mode in ("binary", "binary_covar")
        else ("quantitative_table_vcf.tsv" if mode == "quantitative"
              else ("lmm_table_vcf.tsv" if mode == "lmm"
                    else "eqtl_table_vcf.tsv")))

    secondary = None
    if both_phenotypes:
        secondary = {
            "mode": "quantitative",
            "output_tsv": os.path.join(args.output,
                                       "quantitative_table_vcf.tsv"),
            "quantitative_phenotype": quantitative_phenotype,
        }
        logger.info("Dual-phenotype run: binary -> %s, quantitative -> %s",
                    output_tsv, secondary["output_tsv"])

    from stoat_tpu.pipeline.runner import run_vcf_analysis
    run_vcf_analysis(
        args.vcf, snarls_chr, output_tsv, mode,
        binary_phenotype=binary_phenotype,
        quantitative_phenotype=quantitative_phenotype,
        eqtl_map=eqtl_phenotype,
        covariate=covariate,
        secondary=secondary,
        maf_threshold=args.maf,
        table_threshold=args.table_threshold,
        min_individuals=args.min_individuals,
        min_haplotypes=args.min_haplotypes,
        windows_gene_threshold=args.windows_gene,
        regression_dir=regression_dir,
        sample_names=list_samples,
        lmm_ctx=lmm_ctx,
        resume=args.resume,
    )

    if args.permutations > 0 and mode == "eqtl":
        logger.warning("--permutations: eQTL mode has no eligible "
                       "phenotype (binary/quantitative only); skipping.")
    elif args.permutations > 0 and (binary_phenotype is not None
                                    or quantitative_phenotype is not None):
        from stoat_tpu.pipeline.permutation import run_permutation_test
        if covariate is not None and binary_phenotype is not None:
            logger.info(
                "--permutations: binary + covariates runs the "
                "covariate-ADJUSTED score test (reduced-model residual "
                "permutation) — P_ASY is the adjusted score-test p, not "
                "the covariate-free Wald p of the main table "
                "(the reference's logistic ignores covariates, "
                "stats_test.cpp:59-62).")
        if lmm_ctx is not None:
            logger.warning(
                "--permutations: the permuted statistic is plain OLS — "
                "kinship is NOT modeled, so the permutation P_ASY will "
                "differ from the LMM table's p-values and the FWER "
                "applies to the unrelated-sample analysis only.")
        run_permutation_test(
            args.vcf, snarls_chr,
            output_tsv=(os.path.join(args.output,
                                     "binary_permutation_vcf.tsv")
                        if binary_phenotype is not None else None),
            pheno_bin=binary_phenotype,
            quantitative_phenotype=quantitative_phenotype,
            output_tsv_quant=(os.path.join(
                args.output, "quantitative_permutation_vcf.tsv")
                if quantitative_phenotype is not None else None),
            n_perms=args.permutations, seed=args.perm_seed,
            min_individuals=args.min_individuals,
            min_haplotypes=args.min_haplotypes,
            maf_threshold=args.maf, covariate=covariate)

    if args.gaf and mode == "binary":
        from stoat_tpu.gaf import gaf_creation
        # magic-dispatched load: -p may be GFA or any vg binary
        # container (.hg/.pg/.gbz), like every other graph input
        from stoat_tpu.graph.formats import load_graph
        output_gaf = os.path.join(args.output, "binary_table_vcf.gaf")
        gfa = load_graph(args.graph, ref_chr or None)
        node_lengths = {nid: gfa.node_length(nid)
                        for nid in gfa.node_ids()}
        gaf_creation(output_tsv, snarls_chr, node_lengths, output_gaf)
    elif args.gaf:
        logger.warning(
            "-g/--gaf: GAF emission needs the pure binary mode (it "
            "consumes the GROUP_PATHS column, absent from the %s "
            "layout); skipping.", mode)

    t_end = time.time()
    logger.info("GWAS time analysis : %.3f s", t_end - t_gwas)
    logger.info("Total time : %.3f s", t_end - t_start)
    return 0


def main_bh_correct(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="stoat BHcorrect")
    ap.add_argument("-t", "--tsv", required=True)
    ap.add_argument("-p", "--p-col", type=int, required=True,
                    help="1-indexed p-value column")
    ap.add_argument("-a", "--adjusted-col", type=int, required=True,
                    help="1-indexed adjusted-p column")
    ap.add_argument("-v", "--top-variant",
                    default="top_variant.tsv")
    ap.add_argument("-o", "--output", default="output")
    ap.add_argument("-V", "--verbose", type=int, default=1)
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _check_file(args.tsv)
    os.makedirs(args.output, exist_ok=True)

    from stoat_tpu.post import add_bh_adjusted_column
    add_bh_adjusted_column(
        args.tsv, args.output,
        os.path.join(args.output, args.top_variant),
        args.p_col - 1, args.adjusted_col - 1)
    return 0


def main_graph(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="stoat graph")
    ap.add_argument("-p", "--graph", required=True)
    ap.add_argument("-d", "--dist", required=True)
    ap.add_argument("-b", "--binary", required=True)
    ap.add_argument("-T", "--test", dest="test_method", default="chi2",
                    choices=["exact", "chi2"])
    ap.add_argument("-O", "--output-format", default="tsv",
                    choices=["tsv", "fasta"])
    ap.add_argument("-l", "--allele-size-limit", type=int, default=0)
    ap.add_argument("-r", "--reference-sample", default="")
    ap.add_argument("-t", "--thread", type=int, default=0,
                    help="native-core worker threads (0 = all cores; the reference defaults to 1)")
    ap.add_argument("-V", "--verbose", type=int, default=1)
    ap.add_argument("-o", "--output", default="output")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _set_threads(args.thread)
    for path in (args.graph, args.dist, args.binary):
        _check_file(path)
    os.makedirs(args.output, exist_ok=True)

    from stoat_tpu.graph import run_graph_association
    return run_graph_association(
        graph_path=args.graph, dist_path=args.dist,
        binary_path=args.binary, test_method=args.test_method,
        output_format=args.output_format,
        allele_size_limit=args.allele_size_limit,
        reference_sample=args.reference_sample, output_dir=args.output)


def main_simulate(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="stoat simulate")
    ap.add_argument("-o", "--output", default="simulated")
    ap.add_argument("-n", "--samples", type=int, default=200)
    ap.add_argument("-s", "--snarls", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--effect-fraction", type=float, default=0.2)
    ap.add_argument("--effect-shift", type=float, default=0.35)
    args = ap.parse_args(argv)
    from stoat_tpu.simulate import generate_dataset
    files = generate_dataset(args.output, args.samples, args.snarls,
                             args.seed, effect_fraction=args.effect_fraction,
                             effect_shift=args.effect_shift)
    for key, path in files.items():
        print(f"{key}\t{path}")
    return 0


def main_truth(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="stoat truth")
    ap.add_argument("-r", "--results", required=True,
                    help="results TSV from stoat vcf")
    ap.add_argument("-f", "--freq", required=True,
                    help="truth allele-frequency TSV")
    ap.add_argument("-p", "--p-threshold", type=float, default=0.05)
    ap.add_argument("-t", "--freq-threshold", type=float, default=0.2)
    args = ap.parse_args(argv)
    _check_file(args.results)
    _check_file(args.freq)
    from stoat_tpu.simulate import verify_truth
    import json
    print(json.dumps(verify_truth(args.results, args.freq,
                                  args.p_threshold, args.freq_threshold)))
    return 0


def print_help() -> None:
    sys.stderr.write(
        "usage: stoat <command> [options]\n\n"
        "commands:\n"
        "  vcf        run VCF-based GWAS / snarl decomposition\n"
        "  graph      run graph-path-based association\n"
        "  BHcorrect  Benjamini-Hochberg correction of a results TSV\n"
        "  simulate   generate a simulated dataset with truth labels\n"
        "  truth      precision/recall of results vs simulated truth\n"
        "  plot       QQ/Manhattan/boxplot/histogram/scatter/report plots\n"
        "  version    print version\n")


def main_plot(argv: List[str]) -> int:
    """QQ/Manhattan plots from a results TSV and per-snarl boxplots from
    -T table dumps (plot_script/qq_mahanttan_plot.py + box_plox.R)."""
    ap = argparse.ArgumentParser(prog="stoat plot", add_help=True)
    ap.add_argument("kind", choices=["qq", "manhattan", "boxplot",
                                     "histogram", "scatter", "report"])
    ap.add_argument("-t", "--tsv", metavar="FILE",
                    help="results TSV (qq/manhattan)")
    ap.add_argument("-c", "--column", metavar="NAME",
                    help="p-value column (default: the mode's P column)")
    ap.add_argument("-d", "--tables", metavar="DIR",
                    help="-T per-snarl table directory (boxplot)")
    ap.add_argument("-p", "--phenotype", metavar="FILE",
                    help="FID/IID/PHENO phenotype file (boxplot)")
    ap.add_argument("-o", "--output", required=True,
                    help="output PNG (qq/manhattan/histogram/scatter) "
                         "or directory (boxplot/report)")
    ap.add_argument("--x-col", type=int, default=0,
                    help="x column index (scatter) / value column "
                         "(histogram)")
    ap.add_argument("--y-col", type=int, default=1,
                    help="y column index (scatter)")
    ap.add_argument("--color-col", type=int, default=-1,
                    help="coloring column index (scatter)")
    ap.add_argument("--bins", type=int, default=50,
                    help="bin count (histogram)")
    ap.add_argument("--log-y", action="store_true")
    args = ap.parse_args(argv)

    from stoat_tpu import plots
    if args.kind == "boxplot":
        if not args.tables or not args.phenotype:
            ap.error("boxplot requires -d/--tables and -p/--phenotype")
        written = plots.snarl_boxplots(args.phenotype, args.tables,
                                       args.output)
        logger.info("Wrote %d boxplots to %s", len(written), args.output)
        return 0
    if not args.tsv:
        ap.error(f"{args.kind} requires -t/--tsv")
    _check_file(args.tsv)
    if args.kind == "qq":
        plots.qq_plot(args.tsv, args.output, args.column)
    elif args.kind == "manhattan":
        plots.manhattan_plot(args.tsv, args.output, args.column)
    elif args.kind == "histogram":
        plots.histogram_plot(args.tsv, args.output, column=args.x_col,
                             bins=args.bins, log_y=args.log_y)
    elif args.kind == "scatter":
        plots.scatter_plot(args.tsv, args.output, x_col=args.x_col,
                           y_col=args.y_col, color_col=args.color_col,
                           log_y=args.log_y)
    else:
        written = plots.report_plots(args.tsv, args.output, args.column)
        logger.info("Wrote %d report plots to %s", len(written),
                    args.output)
        return 0
    logger.info("Wrote %s", args.output)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print_help()
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "vcf":
        return main_vcf(rest)
    if cmd == "graph":
        return main_graph(rest)
    if cmd == "BHcorrect":
        return main_bh_correct(rest)
    if cmd == "simulate":
        return main_simulate(rest)
    if cmd == "truth":
        return main_truth(rest)
    if cmd == "plot":
        return main_plot(rest)
    if cmd == "version":
        print(f"stoat-tpu {__version__}")
        return 0
    if cmd in ("-h", "--help", "help"):
        print_help()
        return 0
    sys.stderr.write(f"unknown command: {cmd}\n")
    print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
