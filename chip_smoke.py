#!/usr/bin/env python
"""End-to-end smoke run of stoat-tpu on an NVIDIA GPU.

Drives ``stoat vcf``, ``stoat graph`` and ``stoat BHcorrect`` in this one
process, through ``stoat_tpu.cli.main``, at the width of the 1000 Genomes
high-coverage cohort (3,202 samples = 6,404 haplotypes; Byrska-Bishop et
al., Cell 2022), and checks every phase against a plain reference:

  1. vcf -b -q          fused dual pass, 2 chromosomes x 32,768 snarls
  2. vcf -q -c -C       OLS with covariates, same data
  3. vcf -b -c -C       IRLS logistic, first 8,192 snarls of one chromosome
  4. vcf -e -G          eQTL pairs, same 8,192 snarls
  5. vcf -q -k --lmm    EMMAX mixed model, same 8,192 snarls
  6. vcf -b -q --permutations 64, same 8,192 snarls
  7. graph -T chi2      100,000 bubbles x 50 sample paths (bench.py's graph)
  8. BHcorrect          on phase 1's binary table

Phases 1-5 are compared on 256 seeded snarls per chromosome and mode with
the scalar twins of ``tests/reference_impl.py``; phase 6 with the same run
on the CPU backend (on 1,024 snarls); phase 7 with ``reference_impl.chi2_p``
recomputed from GROUP_PATHS; phase 8 with a scalar Benjamini-Hochberg.
Output strings must match; a differing string passes only as a "flip": the
card's value rounds like a value within a relative 1e-9 of the reference
(the last-ulp differences of CUDA's f64 exp/log/lgamma can straddle a
4-digit rounding boundary).

Precision: the genotype contractions that are allowed TF32 (default
precision) multiply integers <= 2 or 0/1 one-hots, which TF32's 10-bit
mantissa holds exactly; their f32 sums are exact below 2**24, so the counts
are exact for cohorts under 4M samples.  Every statistic contraction is f64,
which never runs in TF32.

Usage:
    python chip_smoke.py [--seed N]
    python chip_smoke.py --four-cards     # snarl mesh vs one device

Exits non-zero, printing no result line, when JAX finds no GPU, when the
native cores do not load, or when any phase fails.  A passing run ends with
one JSON line: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-9
THRESHOLDS = (3, 5, 0.05)   # the CLI defaults -I, -H, -M


@dataclass(frozen=True)
class Sizes:
    n_samples: int = 3202
    snarls_per_chrom: int = 32768
    n_chroms: int = 2
    subset: int = 8192        # phases 3-6: leading snarls of one chromosome
    perm_check: int = 1024    # phase 6: snarls of the GPU-vs-CPU comparison
    n_check: int = 256        # reference snarls per chromosome and mode
    perms: int = 64
    graph_snarls: int = 100000
    graph_samples: int = 50
    kinship_rank: int = 100


@dataclass
class Tally:
    """Comparison counts of one phase."""

    compared: int = 0
    flips: int = 0
    mismatches: List[str] = field(default_factory=list)

    def check(self, what: str, got: Optional[str], want) -> None:
        """``want``: the reference value (float, unrounded) or exact str."""
        self.compared += 1
        kind = classify(got, want)
        if kind == "flip":
            self.flips += 1
        elif kind == "mismatch":
            self.mismatches.append(f"{what}: got {got!r}, want {want!r}")


@dataclass
class PhaseResult:
    name: str
    wall_s: float
    tally: Tally
    peak_bytes: Optional[int]
    note: str = ""


def fmt(x: float) -> str:
    """A statistic as the writer renders it (NaN -> NA)."""
    from stoat_tpu.formatting import set_precision
    x = float(x)
    return "NA" if x != x else set_precision(x)


def classify(got: Optional[str], want) -> str:
    """'ok' | 'flip' | 'mismatch' for one output cell against its reference.

    A flip is a string that differs from the reference's rounding but
    equals the rounding of a value within a relative REL_TOL of it."""
    if isinstance(want, str) or got is None:
        return "ok" if got == want else "mismatch"
    want = float(want)
    if got == fmt(want):
        return "ok"
    if want == want and got in (fmt(want * (1.0 - REL_TOL)),
                                fmt(want * (1.0 + REL_TOL))):
        return "flip"
    return "mismatch"


# ---------------------------------------------------------------- data ----

def _head_subset(src: Dict, dst_dir: str, n: int) -> Dict:
    """The first ``n`` snarls (VCF records and snarl rows) of ``src``,
    sharing its phenotype, covariate and gene files."""
    os.makedirs(dst_dir, exist_ok=True)
    out = dict(src)
    for key, name in (("vcf", "test.vcf"), ("snarl", "snarl_analyse.tsv")):
        out[key] = os.path.join(dst_dir, name)
        with open(src[key]) as fin, open(out[key], "w") as fout:
            kept = 0
            for line in fin:
                if line.startswith("#") or key == "snarl" and \
                        line.startswith("CHR\t"):
                    fout.write(line)
                    continue
                if kept == n:
                    break
                fout.write(line)
                kept += 1
    return out


def _write_kinship(path: str, samples: List[str], rank: int, seed: int):
    """A seeded genetic-relationship-like matrix (unit diagonal, rank
    ``rank``) in the ``-k`` format: a header of sample ids, then one row
    per sample led by its id."""
    rng = np.random.default_rng(seed)
    n = len(samples)
    g = rng.standard_normal((n, rank))
    k = g @ g.T / rank
    d = np.sqrt(np.diag(k))
    k /= np.outer(d, d)
    with open(path, "w") as fh:
        fh.write("id\t" + "\t".join(samples) + "\n")
        for s, row in zip(samples, k):
            fh.write(s + "\t" + "\t".join(map("{:.6f}".format, row)) + "\n")


def make_data(work: str, sizes: Sizes, seed: int) -> Dict:
    """Every input of the smoke, generated from ``seed`` under ``work``."""
    import bench
    from fixtures import make_fixture

    full = make_fixture(os.path.join(work, "full"),
                        n_samples=sizes.n_samples,
                        n_snarls=sizes.snarls_per_chrom * sizes.n_chroms,
                        seed=seed, n_chroms=sizes.n_chroms)
    data = {"full": full,
            "sub": _head_subset(full, os.path.join(work, "sub"),
                                sizes.subset),
            "perm": _head_subset(full, os.path.join(work, "perm"),
                                 sizes.perm_check)}
    data["kinship"] = os.path.join(work, "kinship.tsv")
    _write_kinship(data["kinship"], full["samples"], sizes.kinship_rank,
                   seed + 1)
    gdir = os.path.join(work, "graph")
    os.makedirs(gdir, exist_ok=True)
    gfa, pheno, *_ = bench.make_graph_workload(
        gdir, np.random.default_rng(seed + 2),
        n_snarls=sizes.graph_snarls, n_samples=sizes.graph_samples)
    dist = os.path.join(gdir, "graph.dist")   # -d is required, not read
    open(dist, "w").close()
    data["graph"] = {"gfa": gfa, "pheno": pheno, "dist": dist}
    return data


# ----------------------------------------------------------- references ---

def _read_rows(path: str, key_cols=(3,)) -> Dict:
    with open(path) as fh:
        fh.readline()
        rows = [line.rstrip("\n").split("\t") for line in fh if line.strip()]
    return {tuple(r[c] for c in key_cols) if len(key_cols) > 1
            else r[key_cols[0]]: r for r in rows}


class Reference:
    """Scalar-reference inputs for a set of sampled snarls: their parsed
    snarl records, an edge matrix built from their VCF records alone (each
    record's edges are its own), phenotypes and covariates."""

    def __init__(self, paths: Dict, wanted: Dict[str, List[str]]):
        from stoat_tpu.io.phenotype import (parse_binary_pheno,
                                            parse_covariates,
                                            parse_qtl_gene_file,
                                            parse_quantitative_pheno)
        from stoat_tpu.io.snarl_file import parse_snarl_path
        from stoat_tpu.io.vcf import VcfReader
        from stoat_tpu.matrix import EdgeHaplotypeMatrix

        ids = {i for v in wanted.values() for i in v}
        mini = paths["vcf"] + ".reference.vcf"
        with open(paths["vcf"]) as fin, open(mini, "w") as fout:
            for line in fin:
                if line.startswith("#") or \
                        line.split("\t", 3)[2] in ids:
                    fout.write(line)
        reader = VcfReader(mini)
        self.samples = list(reader.samples)
        self.matrix = {}
        for chrom, records in reader.chromosome_chunks():
            m = EdgeHaplotypeMatrix(2 * len(self.samples))
            for rec in records:
                m.add_record(rec)
            self.matrix[chrom] = (m, m.shrink())
        reader.close()
        os.remove(mini)
        by_id = {s.snarl_id_str: (c, s)
                 for c, lst in parse_snarl_path(paths["snarl"]).items()
                 for s in lst}
        self.snarls = {mode: [by_id[i] for i in lst]
                       for mode, lst in wanted.items()}
        self.pheno_bin, _ = parse_binary_pheno(paths["binary"],
                                               list(self.samples))
        self.pheno_q = parse_quantitative_pheno(paths["quantitative"],
                                                list(self.samples))
        self.covar = parse_covariates(paths["covariate"], ["AGE", "SEX"],
                                      list(self.samples))
        self.genes = parse_qtl_gene_file(paths["qtl"],
                                         paths["gene_position"],
                                         list(self.samples))


def pick_snarls(snarl_path: str, n: int, rng) -> List[str]:
    """``n`` seeded snarl ids per chromosome of a snarl file."""
    from stoat_tpu.io.snarl_file import parse_snarl_path
    out = []
    for snarls in parse_snarl_path(snarl_path).values():
        take = rng.choice(len(snarls), min(n, len(snarls)), replace=False)
        out += [snarls[i].snarl_id_str for i in sorted(take)]
    return out


def _check_presence(t: Tally, sid: str, rows: Dict, present: bool) -> bool:
    t.check(f"{sid} row", "present" if sid in rows else "absent",
            "present" if present else "absent")
    return present and sid in rows


def _cpu_fisher(tables: List) -> List[float]:
    """The repository's Fisher kernel evaluated on the CPU backend."""
    import jax
    from stoat_tpu.stats.fisher import fisher_exact_2x2
    if not tables:
        return []
    t = np.asarray(tables, np.float64)
    with jax.default_device(jax.devices("cpu")[0]):
        return [float(v) for v in np.asarray(
            fisher_exact_2x2(t[:, 0], t[:, 1], t[:, 2], t[:, 3]))]


def check_binary(t: Tally, ref: Reference, mode: str, rows: Dict) -> None:
    import reference_impl as R
    fisher_cells = []
    for chrom, snarl in ref.snarls[mode]:
        em, M = ref.matrix[chrom]
        sid = snarl.snarl_id_str
        got = R.binary_reference(snarl, em, M, ref.pheno_bin, *THRESHOLDS)
        if not _check_presence(t, sid, rows, got is not None):
            continue
        _pf, pc, g0k, g1k = got
        row = rows[sid]
        t.check(f"{sid} PATH_LENGTHS", row[4], snarl.type_var_str)
        t.check(f"{sid} P_CHI2", row[6], pc)
        t.check(f"{sid} GROUP_PATHS", row[7], ",".join(
            f"{int(a)}:{int(b)}" for a, b in zip(g0k, g1k)))
        if len(g0k) == 2:
            fisher_cells.append((sid, row[5], [g0k[0], g0k[1],
                                               g1k[0], g1k[1]]))
        else:
            t.check(f"{sid} P_FISHER", row[5], "NA")
    # P_FISHER: the PLINK scan on the card against the same scan on the
    # CPU backend (exact), and against scipy's exact test, which sums by
    # another rule: agreement to 1e-4 relative (as tests/ pin it) beyond
    # the 4-digit rounding of the cell
    cpu = _cpu_fisher([c[2] for c in fisher_cells])
    for (sid, cell, table), want in zip(fisher_cells, cpu):
        t.check(f"{sid} P_FISHER", cell, want)
        scipy_p = R.fisher_p(*table)
        got = float("nan") if cell == "NA" else float(cell)
        rounding = 0.5 * 10.0 ** (np.floor(np.log10(abs(got))) - 3) \
            if got else 0.0
        if not abs(got - scipy_p) <= 1e-4 * abs(scipy_p) + rounding:
            t.mismatches.append(f"{sid} P_FISHER {cell} vs scipy {scipy_p}")


def check_quantitative(t: Tally, ref: Reference, mode: str, rows: Dict,
                       covar: bool) -> None:
    import reference_impl as R
    for chrom, snarl in ref.snarls[mode]:
        em, M = ref.matrix[chrom]
        sid = snarl.snarl_id_str
        got = R.quantitative_reference(
            snarl, em, M, ref.pheno_q, ref.covar if covar else None,
            *THRESHOLDS)
        if not _check_presence(t, sid, rows, got is not None):
            continue
        row = rows[sid]
        if got == "degenerate":
            t.check(f"{sid} P", row[5], "NA")
            continue
        p, b, s, r2, allele_paths = got
        for name, col, want in (("P", 5, p), ("RSQUARE", 6, r2),
                                ("BETA", 7, b), ("SE", 8, s)):
            t.check(f"{sid} {name}", row[col], want)
        t.check(f"{sid} ALLELE_PATHS", row[9],
                ",".join(str(int(x)) for x in allele_paths))


def check_binary_covar(t: Tally, ref: Reference, rows: Dict) -> None:
    import reference_impl as R
    for chrom, snarl in ref.snarls["logistic"]:
        em, M = ref.matrix[chrom]
        sid = snarl.snarl_id_str
        got = R.binary_covar_reference(snarl, em, M, ref.pheno_bin,
                                       *THRESHOLDS)
        if not _check_presence(t, sid, rows, got is not None):
            continue
        row = rows[sid]
        if got == "degenerate" or got[0] == "NA":
            t.check(f"{sid} P", row[5], "NA")
            continue
        p, b, s, allele_paths = got
        for name, col, want in (("P", 5, p), ("BETA", 6, b), ("SE", 7, s)):
            t.check(f"{sid} {name}", row[col], want)
        t.check(f"{sid} ALLELE_PATHS", row[8],
                ",".join(str(int(x)) for x in allele_paths))


def _variant_design(snarl, em, M, n_samples):
    """(df, used_idx, allele_paths) after filtration, merge and last-column
    drop, or the reason there is none: None (filtered) / 'degenerate'."""
    import reference_impl as R
    df, used_idx, allele_paths = R.quantitative_table(snarl, em, M,
                                                      n_samples)
    if R.filtration_quantitative(df, *THRESHOLDS):
        return None
    df = R.combine_identical_columns(df)[:, :-1]
    if df.shape[1] == 0:
        return "degenerate"
    return df, used_idx, allele_paths


def check_eqtl(t: Tally, ref: Reference, rows: Dict,
               window: int = 1000000) -> None:
    import reference_impl as R
    n = len(ref.samples)
    for chrom, snarl in ref.snarls["eqtl"]:
        em, M = ref.matrix[chrom]
        sid = snarl.snarl_id_str
        design = _variant_design(snarl, em, M, n)
        lo = snarl.start_pos - window if snarl.start_pos > window else 0
        hi = snarl.end_pos + window
        for g in ref.genes.get(chrom, []):
            if g.end_pos < lo or g.start_pos > hi:
                continue
            key = (sid, g.gene_name)
            t.check(f"{key} row", "present" if key in rows else "absent",
                    "absent" if design is None else "present")
            if design is None or key not in rows:
                continue
            row = rows[key]
            if design == "degenerate":
                t.check(f"{key} P", row[6], "NA")
                continue
            df, used_idx, _ = design
            p, b, s, r2 = R.ols_reference(df, g.sample_expression[used_idx],
                                          None)
            for name, col, want in (("P", 6, p), ("RSQUARE", 7, r2),
                                    ("BETA", 8, b), ("SE", 9, s)):
                t.check(f"{key} {name}", row[col], want)


def check_lmm(t: Tally, ref: Reference, rows: Dict, kinship: str) -> None:
    """Dense GLS on Sigma = K + delta I per snarl (the comparison of
    tests/test_lmm.py), with delta from the REML null fit."""
    import scipy.stats
    from stoat_tpu.io.phenotype import parse_kinship_matrix
    from stoat_tpu.stats.lmm import fit_null_reml

    kin = parse_kinship_matrix(kinship)
    order = [kin.ids.index(s) for s in ref.samples]
    K = kin.matrix[np.ix_(order, order)]
    y = ref.pheno_q
    n = len(y)
    delta = fit_null_reml(y, K).delta
    Si = np.linalg.inv(0.5 * (K + K.T) + delta * np.eye(n))
    for chrom, snarl in ref.snarls["lmm"]:
        em, M = ref.matrix[chrom]
        sid = snarl.snarl_id_str
        design = _variant_design(snarl, em, M, n)
        if not _check_presence(t, sid, rows, design is not None):
            continue
        row = rows[sid]
        if design == "degenerate":
            t.check(f"{sid} P", row[5], "NA")
            continue
        df, used_idx, allele_paths = design
        X = np.zeros((n, 1 + df.shape[1]))
        X[:, 0] = 1.0
        X[used_idx, 1:] = df
        XtSiX = X.T @ Si @ X
        inv = np.linalg.inv(XtSiX)
        beta = inv @ (X.T @ Si @ y)
        r = y - X @ beta
        dof = max(n - X.shape[1] + 1, 1)
        se1 = np.sqrt(inv[1, 1] * (r @ Si @ r) / dof)
        tstat = beta[1] / se1
        p = 2 * scipy.stats.t.sf(abs(tstat), dof) if np.isfinite(tstat) \
            else 1.0
        for name, col, want in (("P", 5, p), ("BETA", 7, beta[1]),
                                ("SE", 8, se1)):
            t.check(f"{sid} {name}", row[col], want)
        t.check(f"{sid} ALLELE_PATHS", row[9],
                ",".join(str(int(x)) for x in allele_paths))


def check_same_tables(t: Tally, got_dir: str, want_dir: str,
                      names: List[str]) -> None:
    """Two runs' TSVs, cell by cell, rows keyed by SNARL."""
    for name in names:
        got = _read_rows(os.path.join(got_dir, name))
        want = _read_rows(os.path.join(want_dir, name))
        t.check(f"{name} snarls", str(sorted(got)), str(sorted(want)))
        for sid, row in want.items():
            t.check(f"{name} {sid}", "\t".join(got.get(sid, [])),
                    "\t".join(row))


def check_graph(t: Tally, table: str, n_check: int, rng) -> int:
    import reference_impl as R
    rows = list(_read_rows(table).values())
    for i in sorted(rng.choice(len(rows), min(n_check, len(rows)),
                               replace=False)):
        row = rows[i]
        pairs = [tuple(map(int, g.split(":"))) for g in row[7].split(",")]
        want = R.chi2_p([a for a, _ in pairs], [b for _, b in pairs])
        t.check(f"{row[3]} P_CHI2", row[6], want)
    return len(rows)


def check_bh(t: Tally, before: str, after: str, col: int) -> None:
    """Scalar Benjamini-Hochberg of ``before``'s column against
    ``after``'s (post_processing.cpp:7-38: NA parses as 1)."""
    from stoat_tpu.formatting import string_to_pvalue
    src = list(_read_rows(before).values())
    out = _read_rows(after)
    p = [string_to_pvalue(r[col]) for r in src]
    n = len(p)
    order = sorted(range(n), key=lambda i: p[i])
    adj = [0.0] * n
    running = 1.0
    for rank in range(n, 0, -1):
        i = order[rank - 1]
        running = min(running, p[i] * n / rank)
        adj[i] = min(running, 1.0)
    t.check("rows", str(len(out)), str(n))
    for r, a in zip(src, adj):
        t.check(f"{r[3]} adjusted", out.get(r[3], [None] * (col + 1))[col],
                a)


# --------------------------------------------------------------- phases ---

def _peak_bytes() -> Optional[int]:
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def run_cli(argv: List[str]) -> float:
    """Wall seconds of one in-process ``stoat`` command."""
    from stoat_tpu.cli import main as cli_main
    t0 = time.perf_counter()
    rc = cli_main(argv)
    wall = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"stoat {' '.join(argv)} exited {rc}")
    return wall


@contextlib.contextmanager
def default_device(platform: str):
    """Make ``platform``'s first device the default of every thread (the
    runner ingests and uploads on worker threads)."""
    import jax
    jax.config.update("jax_default_device", jax.devices(platform)[0])
    try:
        yield
    finally:
        jax.config.update("jax_default_device", None)


def _vcf(paths: Dict, out: str, *flags: str) -> List[str]:
    return ["vcf", "-s", paths["snarl"], "-v", paths["vcf"], *flags,
            "-o", out]


def run_phases(data: Dict, sizes: Sizes, seed: int, work: str,
               log=print) -> List[PhaseResult]:
    """Every phase in order; each result is logged as soon as it exists."""
    full, sub, perm = data["full"], data["sub"], data["perm"]
    rng = np.random.default_rng(seed + 3)
    wanted = {
        "binary": pick_snarls(full["snarl"], sizes.n_check, rng),
        "quantitative": pick_snarls(full["snarl"], sizes.n_check, rng),
        "covar": pick_snarls(full["snarl"], sizes.n_check, rng),
        "logistic": pick_snarls(sub["snarl"], sizes.n_check, rng),
        "eqtl": pick_snarls(sub["snarl"], sizes.n_check, rng),
        "lmm": pick_snarls(sub["snarl"], sizes.n_check, rng),
    }
    ref = Reference(full, wanted)
    out = functools.partial(os.path.join, work, "out")
    results: List[PhaseResult] = []

    def phase(name, wall, tally, note=""):
        res = PhaseResult(name, wall, tally, _peak_bytes(), note)
        results.append(res)
        log(res)

    # 1. fused dual pass, full data
    wall = run_cli(_vcf(full, out("dual"), "-b", full["binary"],
                        "-q", full["quantitative"]))
    t = Tally()
    check_binary(t, ref, "binary",
                 _read_rows(out("dual", "binary_table_vcf.tsv")))
    check_quantitative(t, ref, "quantitative",
                       _read_rows(out("dual", "quantitative_table_vcf.tsv")),
                       covar=False)
    phase("1 vcf -b -q (fused dual)", wall, t)

    # 2. OLS with covariates, full data
    covar = ("-c", full["covariate"], "-C", "AGE,SEX")
    wall = run_cli(_vcf(full, out("ols"), "-q", full["quantitative"],
                        *covar))
    t = Tally()
    check_quantitative(t, ref, "covar",
                       _read_rows(out("ols", "quantitative_table_vcf.tsv")),
                       covar=True)
    phase("2 vcf -q -c (OLS + covariates)", wall, t)

    # 3. IRLS logistic regression
    wall = run_cli(_vcf(sub, out("logistic"), "-b", sub["binary"], *covar))
    t = Tally()
    check_binary_covar(t, ref,
                       _read_rows(out("logistic", "binary_table_vcf.tsv")))
    phase("3 vcf -b -c (IRLS logistic)", wall, t)

    # 4. eQTL
    wall = run_cli(_vcf(sub, out("eqtl"), "-e", sub["qtl"],
                        "-G", sub["gene_position"]))
    t = Tally()
    check_eqtl(t, ref, _read_rows(out("eqtl", "eqtl_table_vcf.tsv"),
                                  key_cols=(3, 5)))
    phase("4 vcf -e -G (eQTL)", wall, t)

    # 5. EMMAX
    wall = run_cli(_vcf(sub, out("lmm"), "-q", sub["quantitative"],
                        "-k", data["kinship"], "--lmm"))
    t = Tally()
    check_lmm(t, ref, _read_rows(out("lmm", "lmm_table_vcf.tsv")),
              data["kinship"])
    phase("5 vcf -q -k --lmm (EMMAX)", wall, t)

    # 6. permutations: timed on the subset, compared GPU vs CPU backend
    perm_flags = ("-b", sub["binary"], "-q", sub["quantitative"],
                  "--permutations", str(sizes.perms))
    wall = run_cli(_vcf(sub, out("perm"), *perm_flags))
    small = ("-b", perm["binary"], "-q", perm["quantitative"],
             "--permutations", str(sizes.perms))
    run_cli(_vcf(perm, out("perm_small"), *small))
    with default_device("cpu"):
        run_cli(_vcf(perm, out("perm_small_cpu"), *small))
    t = Tally()
    check_same_tables(t, out("perm_small"), out("perm_small_cpu"),
                      ["binary_table_vcf.tsv", "quantitative_table_vcf.tsv",
                       "binary_permutation_vcf.tsv",
                       "quantitative_permutation_vcf.tsv"])
    phase(f"6 vcf -b -q --permutations {sizes.perms}", wall, t,
          f"compared on {sizes.perm_check} snarls with the CPU backend")

    # 7. graph mode
    g = data["graph"]
    wall = run_cli(["graph", "-p", g["gfa"], "-d", g["dist"],
                    "-b", g["pheno"], "-T", "chi2", "-O", "tsv",
                    "-r", "ref", "-o", out("graph")])
    t = Tally()
    n_rows = check_graph(t, out("graph", "binary_table_graph.tsv"),
                         sizes.n_check, rng)
    phase("7 graph -T chi2", wall, t, f"{n_rows} snarls written")

    # 8. BH correction of phase 1's binary table (P_CHI2 adjusted in place)
    bh_in = out("bh", "binary_table_vcf.tsv")
    os.makedirs(out("bh"), exist_ok=True)
    shutil.copyfile(out("dual", "binary_table_vcf.tsv"), bh_in)
    wall = run_cli(["BHcorrect", "-t", bh_in, "-p", "7", "-a", "7",
                    "-o", out("bh")])
    t = Tally()
    check_bh(t, out("dual", "binary_table_vcf.tsv"), bh_in, 6)
    phase("8 BHcorrect", wall, t)
    return results


@contextlib.contextmanager
def one_device():
    """Route the CLI's runner calls through one device (no snarl mesh)."""
    from stoat_tpu.pipeline import permutation, runner
    saved = runner.run_vcf_analysis, permutation.run_permutation_test
    runner.run_vcf_analysis = functools.partial(saved[0], use_mesh=False)
    permutation.run_permutation_test = functools.partial(saved[1],
                                                         use_mesh=False)
    try:
        yield
    finally:
        runner.run_vcf_analysis, permutation.run_permutation_test = saved


def tail_compile_seconds(n: int) -> Dict[str, float]:
    """Compile seconds of the unsharded chi² (gammaincc) and Student-t
    (betainc) tails at batch length ``n``, persistent cache off."""
    import jax
    import jax.numpy as jnp
    from stoat_tpu.stats.chi2 import finish_chi2_pvalues
    from stoat_tpu.stats.linreg import finish_linear_pvalues

    def spec(n, dtype=jnp.float64):
        return jax.ShapeDtypeStruct((n,), dtype)

    out = {}
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        for name, fn, args in (
                ("chi2_gammaincc", finish_chi2_pvalues,
                 (spec(n), spec(n), spec(n, bool), spec(n, bool))),
                ("t_betainc", finish_linear_pvalues, (spec(n), spec(n)))):
            lowered = jax.jit(lambda *a, f=fn: f(*a)).lower(*args)
            t0 = time.perf_counter()
            lowered.compile()
            out[name] = time.perf_counter() - t0
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
    return out


def run_four_cards(data: Dict, sizes: Sizes, work: str,
                   log=print) -> List[PhaseResult]:
    """Phases 1, 2 and 6 through the default snarl mesh, then through one
    device; the two sets of tables must be identical."""
    import jax
    full, sub = data["full"], data["sub"]
    out = functools.partial(os.path.join, work, "out")
    compile_s = tail_compile_seconds(8192)      # the runner's chunk length
    log("unsharded tail compile seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in compile_s.items()))
    runs = (
        ("1 vcf -b -q (fused dual)", full,
         ("-b", full["binary"], "-q", full["quantitative"]),
         ["binary_table_vcf.tsv", "quantitative_table_vcf.tsv"]),
        ("2 vcf -q -c (OLS + covariates)", full,
         ("-q", full["quantitative"], "-c", full["covariate"],
          "-C", "AGE,SEX"),
         ["quantitative_table_vcf.tsv"]),
        (f"6 vcf -b -q --permutations {sizes.perms}", sub,
         ("-b", sub["binary"], "-q", sub["quantitative"],
          "--permutations", str(sizes.perms)),
         ["binary_table_vcf.tsv", "quantitative_table_vcf.tsv",
          "binary_permutation_vcf.tsv",
          "quantitative_permutation_vcf.tsv"]),
    )
    results = []
    for i, (name, paths, flags, tables) in enumerate(runs):
        mesh_wall = run_cli(_vcf(paths, out(f"mesh{i}"), *flags))
        with one_device():
            one_wall = run_cli(_vcf(paths, out(f"one{i}"), *flags))
        t = Tally()
        check_same_tables(t, out(f"mesh{i}"), out(f"one{i}"), tables)
        res = PhaseResult(name, mesh_wall, t, _peak_bytes(),
                          f"mesh over {jax.device_count()} devices; one "
                          f"device {one_wall:.3f} s")
        results.append(res)
        log(res)
    return results


# ----------------------------------------------------------------- main ---

def phase_logger(card: str):
    """A ``log`` for the phase runners: prints each PhaseResult (or plain
    message) as it arrives."""
    def log(item) -> None:
        print(item if isinstance(item, str) else _describe(item, card),
              flush=True)
    return log


def _describe(res: PhaseResult, card: str) -> str:
    peak = ("not available" if res.peak_bytes is None
            else f"{res.peak_bytes / 2**30:.3f} GiB")
    text = (f"phase {res.name}: wall {res.wall_s:.3f} s (first run, compile "
            f"included); compared {res.tally.compared} cells, "
            f"{len(res.tally.mismatches)} mismatches, {res.tally.flips} "
            f"flips within {REL_TOL:g} relative; peak device memory so far "
            f"{peak}; card {card}")
    if res.note:
        text += f"; {res.note}"
    for m in res.tally.mismatches[:10]:
        text += f"\n    mismatch {m}"
    return text


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run phases 1, 2 and 6 through the snarl mesh "
                         "over every visible card and through one device")
    args = ap.parse_args(argv)

    if not args.four_cards:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        # phase 6 compares with the CPU backend
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    for p in (HERE, os.path.join(HERE, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)

    import logging
    logging.basicConfig(level=logging.WARNING,
                        format="[%(levelname)s] %(message)s")
    import jax

    import stoat_tpu.jaxconfig  # noqa: F401
    from stoat_tpu import native

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform})",
              file=sys.stderr)
        return 2
    lib, glib = native.get_lib(), native.get_graph_lib()
    if lib is None or glib is None:
        print("chip_smoke: native cores did not load (VCF core: "
              f"{lib is not None}, graph core: {glib is not None}); see "
              "the compiler output above", file=sys.stderr)
        return 3
    count = len(jax.devices())
    if args.four_cards and count < 2:
        print(f"chip_smoke: --four-cards needs several cards, found {count}",
              file=sys.stderr)
        return 4

    import bench
    cards = bench.card_lines()
    card = cards[0]
    import jaxlib
    for line in cards:
        print(f"card (nvidia-smi name, power.limit): {line}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"device_kind {dev.device_kind}, {count} device(s), native VCF "
          f"core loaded, native graph core loaded", flush=True)

    sizes = Sizes()
    work = tempfile.mkdtemp(prefix="stoat_chip_smoke_")
    try:
        t0 = time.perf_counter()
        data = make_data(work, sizes, args.seed)
        print(f"data: {sizes.n_samples} samples x {sizes.n_chroms} "
              f"chromosomes x {sizes.snarls_per_chrom} snarls, graph "
              f"{sizes.graph_snarls} bubbles x {sizes.graph_samples} "
              f"samples, made in {time.perf_counter() - t0:.3f} s "
              f"(host)", flush=True)

        log = phase_logger(card)
        if args.four_cards:
            results = run_four_cards(data, sizes, work, log)
        else:
            results = run_phases(data, sizes, args.seed, work, log)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failed = [r.name for r in results if r.tally.mismatches
              or not r.tally.compared]
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
