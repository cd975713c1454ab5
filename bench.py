#!/usr/bin/env python
"""Benchmark: snarls tested per second on one GPU (binary chi²+Fisher and
quantitative OLS pipelines), per BASELINE.md.

Prints exactly one JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...,
   "platform": "gpu", "device_kind": ..., "device_count": N, "card": [...]}
Stops with a non-zero exit when JAX's first device is not a GPU.

Workload: a generated VCF (200 samples — the reference's simulated test
scale — × N_SNARLS snarls with 2-4 allele paths each) ingested through the
real pipeline (native C++ VCF core → bit-packed words → packed device
kernels — the production path of pipeline/runner.py).  Two timings:

  * device analysis (``value``): the per-chromosome analysis step alone
    (binary tables + chi²/Fisher and the quantitative design + OLS),
    mirroring the reference's own phase split ("Matrix time construction"
    vs "Snarl time analysis", snarl_analyzer.cpp:158-179).  Each timed
    step ends by fetching one scalar reduction of its outputs to the
    host.  The headline rate runs PERM_BATCH complete dual analyses with
    DISTINCT circularly-permuted phenotypes in one dispatch (the shape
    of permutation-testing workloads; no result is reusable between
    iterations, so XLA cannot fold them).  The two-dispatch rate (one
    binary and one quantitative dispatch, each fetched) ships alongside
    as ``single_dispatch_snarls_per_s``.
  * ``end_to_end_snarls_per_s``: wall clock of the full pipelined flow —
    snarl-path tokenize on a background thread overlapped with native VCF
    ingestion, then packing, both device dispatches, and the result
    fetches — the overlap structure of run_vcf_analysis minus TSV
    formatting/writing.

  * ``full_run_snarls_per_s``: the wall an actual `stoat vcf` user
    experiences — ``run_vcf_analysis`` from VCF path to finished TSV
    (ingest, pack, dispatch, device→host fetch, C++ row formatting, TSV
    write), one binary run + one quantitative run over a 4-chromosome
    workload, pipelined across chromosomes and chunks by the runner.

Baseline: a single-core scalar per-snarl C++ loop replicating the
reference's per-snarl algorithm (native/baseline_core.cpp) — the honest
stand-in for single-core C++ `stoat`; its per-snarl cost is measured on a
subsample and extrapolated.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import numpy as np

import stoat_tpu.jaxconfig  # noqa: F401  (x64 + compilation cache)
import jax
import jax.numpy as jnp

N_SAMPLES = 200
# Per-chromosome snarl count.  Large enough that throughput (ingest
# bandwidth, device compute) dominates the measurement rather than
# per-chunk dispatch and copy latencies.
N_SNARLS = 32768
N_CHROMS = 4             # full-run workload: realistic multi-chromosome
BASELINE_SAMPLE = 2000   # bigger sample = less timer noise per rep
PERM_BATCH = 4   # analyses per amortized device probe (see run_device)
SEED = 42


def make_vcf_workload(tmpdir, rng, n_snarls=N_SNARLS, n_samples=N_SAMPLES,
                      n_chroms=N_CHROMS):
    """Generate a snarl file + VCF like the simulated reference datasets.

    ``n_chroms`` chromosomes × ``n_snarls`` snarls each: the device/e2e
    phases measure one chromosome's pipeline pass; the full-run metric
    runs the whole file through run_vcf_analysis."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from fixtures import make_fixture
    return make_fixture(tmpdir, n_samples=n_samples,
                        n_snarls=n_snarls * n_chroms, seed=SEED,
                        n_chroms=n_chroms)


def ingest_once(paths, snarls_chr, quad_cache_holder=None, upload=None):
    """One pipelined ingest+pack pass (the runner's per-chromosome flow).

    ``upload(matrix)`` optionally starts the device words transfer
    between ingest and pack (the runner does the same), so the largest
    per-chromosome transfer streams while the host packs; the handle is
    stashed as ``packed.words_device`` for device_args.
    Returns (packed, matrix, t_ingest, t_pack)."""
    from stoat_tpu.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu.tables import pack_chromosome, tokenize_chromosome

    t0 = time.perf_counter()
    gen = iter_chromosome_matrices(paths["vcf"], 2 * N_SAMPLES, snarls_chr)
    chrom, matrix = next(gen)
    gen.close()  # single-chromosome workload: release the native reader
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = upload(matrix) if upload is not None else None
    cache = (quad_cache_holder.get(chrom)
             if quad_cache_holder is not None
             else tokenize_chromosome(snarls_chr[chrom]))
    packed = pack_chromosome(snarls_chr[chrom], matrix, cache=cache)
    if dev is not None:
        packed.words_device = dev
    t_pack = time.perf_counter() - t0
    return packed, matrix, t_ingest, t_pack


def device_args(packed):
    """Upload the packed-words analysis inputs (production path:
    delta-compressed idx + u16 snarl map, pipeline/packed.py)."""
    from stoat_tpu.pipeline import packed as _pk

    words = getattr(packed, "words_device", None)
    if words is None:
        words = jnp.asarray(packed.packed_words())
    W = int(words.shape[1])
    path_idx = _pk.upload_path_idx(packed.path_edge_idx(),
                                   int(words.shape[0]) - 1)
    valid = _pk.upload_bool_bits(packed.path_valid)
    sidx = _pk.upload_snarl_path_idx(packed.snarl_path_idx)
    tail = jnp.asarray(_pk.tail_mask_words(packed.n_haplotypes, W))
    return words, path_idx, valid, sidx, tail, W


def make_steps(packed, pheno_bin, pheno_q):
    """Compute-only probes for the device-analysis metric.

    Each probe fetches one scalar reduction of the pipeline's outputs,
    which waits for the device while keeping bulk transfers out of the
    device timing."""
    from stoat_tpu.pipeline import packed as _pk
    from stoat_tpu.pipeline.binary import binary_tables_device_packed
    from stoat_tpu.pipeline.quantitative import _fused_packed_analysis

    words, path_idx, valid, sidx, tail, W = device_args(packed)
    g1_words = jnp.asarray(_pk.pack_hap_mask_words(
        np.repeat(pheno_bin.astype(bool), 2), W))
    th = (jnp.float64(3), jnp.float64(5), jnp.float64(0.05))
    covar0 = jnp.zeros((N_SAMPLES, 0), jnp.float64)
    pheno_qd = jnp.asarray(pheno_q, jnp.float64)
    n_haps = packed.n_haplotypes

    # compute-only probes: one scalar reduction per pipeline, fetched
    @jax.jit
    def _probe_binary():
        out = binary_tables_device_packed(
            words, path_idx, valid, tail, g1_words, sidx, *th)
        return (jnp.nansum(out["p_fisher"]) + jnp.nansum(out["p_chi2"])
                + jnp.sum(out["g0"]))

    @jax.jit
    def _probe_quant():
        out = _fused_packed_analysis(
            words, path_idx, valid, sidx, covar0, pheno_qd, *th,
            n_haplotypes=n_haps, with_covar=False,
            return_tables=False, kind="linear")
        return jnp.nansum(out["p"]) + jnp.nansum(out["beta"])

    def probe_binary():
        return float(np.asarray(_probe_binary()))

    def probe_quant():
        return float(np.asarray(_probe_quant()))

    # Batched probe: PERM_BATCH complete dual analyses over distinct
    # (circularly permuted) phenotypes in one dispatch with one fetched
    # scalar — the shape of permutation-testing workloads, with no result
    # reuse between iterations (each mask differs, so XLA cannot CSE).
    from stoat_tpu.pipeline.quantitative import _fused_dual_body
    g1_variants = [jnp.asarray(_pk.pack_hap_mask_words(
        np.repeat(np.roll(pheno_bin.astype(bool), i), 2), W))
        for i in range(PERM_BATCH)]
    phq_variants = [jnp.asarray(np.roll(pheno_q, i), jnp.float64)
                    for i in range(PERM_BATCH)]

    @jax.jit
    def _probe_perm():
        acc = jnp.float64(0)
        for gw, pq in zip(g1_variants, phq_variants):
            out = _fused_dual_body(
                words, path_idx, valid, sidx, tail, gw, covar0, pq,
                *th, n_haplotypes=n_haps, tails=True)
            acc += jnp.nansum(out["p_chi2"]) + jnp.nansum(out["q_p"])
        return acc

    def probe_perm():
        return float(np.asarray(_probe_perm()))

    return probe_binary, probe_quant, probe_perm


def _settle(seconds=0.3):
    """Sleep between repetitions so the JAX runtime's post-dispatch
    background work (buffer cleanup) does not land in the next
    repetition's host-phase timing."""
    time.sleep(seconds)


def run_device(packed, pheno_bin, pheno_q, repeats=4):
    """Device-analysis time: scalar probes of both pipelines; 8 bytes
    come back to the host per step.

    Returns (t_both, t_perm_each): the two-dispatch time (binary probe +
    quantitative probe) and the per-analysis time from the
    PERM_BATCH-permutation dual probe (one fetch over PERM_BATCH complete
    binary+quantitative analyses)."""
    probe_binary, probe_quant, probe_perm = make_steps(
        packed, pheno_bin, pheno_q)
    probe_binary()                         # compile + warm
    probe_quant()
    probe_perm()

    times = []
    perm_times = []
    for _ in range(repeats):
        _settle(0.1)
        t0 = time.perf_counter()
        probe_binary()
        probe_quant()
        times.append(time.perf_counter() - t0)
        _settle(0.1)
        t0 = time.perf_counter()
        probe_perm()
        perm_times.append(time.perf_counter() - t0)
    return min(times), min(perm_times) / PERM_BATCH


def _Tokenizer(snarls_chr):
    """The runner's production background tokenizer (no bench twin)."""
    from stoat_tpu.pipeline.runner import _QuadTokenizer
    return _QuadTokenizer(snarls_chr)


def run_end_to_end(paths, snarls_chr, pheno_bin, pheno_q, repeats=8,
                   chunk=8192):
    """Wall clock of the full pipelined flow, results on host at stop
    (compile already warm).  This is the runner's production
    dual-phenotype structure: native ingest with the chromosome words
    upload started immediately, then the snarl axis processed in chunks
    — chunk k+1 packs and uploads on the host while chunk k's fused
    binary+quantitative program (runner._analyze_dual_fused: shared
    packed membership, ONE dispatch, ONE wire pack) computes on device,
    and the wire fetches drain behind the later chunks' compute.  Timing
    stops when every chunk's result bytes are on the host."""
    from stoat_tpu.pipeline import packed as _pk
    from stoat_tpu.pipeline.fetch import flatten_result
    from stoat_tpu.pipeline.quantitative import _fused_dual_analysis
    from stoat_tpu.pipeline.runner import iter_chromosome_matrices
    from stoat_tpu.tables import pack_chromosome_chunks

    chrom0 = next(iter(snarls_chr))
    snarls = snarls_chr[chrom0]
    th = (jnp.float64(3), jnp.float64(5), jnp.float64(0.05))
    covar0 = jnp.zeros((N_SAMPLES, 0), jnp.float64)
    pheno_qd = jnp.asarray(pheno_q, jnp.float64)
    times = []
    for rep in range(repeats + 1):           # rep 0 = untimed warm
        _settle()
        t0 = time.perf_counter()
        tok = _Tokenizer(snarls_chr)         # overlaps the native ingest
        gen = iter_chromosome_matrices(paths["vcf"], 2 * N_SAMPLES,
                                       snarls_chr,
                                       stream_device_words=True)
        chrom, matrix = next(gen)
        gen.close()
        from stoat_tpu.pipeline.runner import assemble_words_device
        words = assemble_words_device(matrix)   # big upload already done
        W = int(words.shape[1])
        n_hap = 2 * N_SAMPLES
        tail = jnp.asarray(_pk.tail_mask_words(n_hap, W))
        g1_words = jnp.asarray(_pk.pack_hap_mask_words(
            np.repeat(pheno_bin.astype(bool), 2), W))
        results = []
        for packed in pack_chromosome_chunks(snarls, matrix, chunk,
                                             quad_cache=tok.get(chrom)):
            idx = _pk.upload_path_idx(packed.path_edge_idx(),
                                      int(words.shape[0]) - 1)
            out = _fused_dual_analysis(
                words, idx, _pk.upload_bool_bits(packed.path_valid),
                _pk.upload_snarl_path_idx(packed.snarl_path_idx), tail,
                g1_words, covar0, pheno_qd, *th, n_haplotypes=n_hap)
            results.append(flatten_result(out))
        for fr in results:
            # materialize BOTH wire arrays: the f64 stats AND the u32
            # counts pack (g0 lives there) — the production writer needs
            # every byte, so the timer must not stop before the u32
            # transfer lands
            fr["p_chi2"], fr["q_p"], fr["g0"]
        if rep > 0:                           # rep 0 absorbs compiles
            times.append(time.perf_counter() - t0)
    return min(times)


PERMS = 256   # permutations for the --permutations subsystem metric


def run_perm(packed, pheno_bin, pheno_q, repeats=2):
    """Throughput of the --permutations subsystem (beyond-reference):
    PERMS Westfall–Young permutations of BOTH phenotypes over one
    32k-snarl chunk through the production entry points
    (binary_permutation_stats / quantitative_permutation_stats — packed
    membership computed once, mask/phenotype batches ride it).  All
    [K, S] p-value arrays are numpy on return (bytes on host), so the
    timing includes the result fetches.  Returns permuted snarl-tests
    per second: PERMS × S × 2 phenotypes / wall."""
    import jax.numpy as jnp

    from stoat_tpu.pipeline.permutation import (
        binary_permutation_stats, freedman_lane_phenos,
        permutation_indices, permutation_masks,
        quantitative_permutation_stats)

    S = packed.n_snarls
    W = (packed.n_haplotypes + 31) // 32
    perm_idx = permutation_indices(N_SAMPLES, PERMS, SEED)
    masks = permutation_masks(pheno_bin, PERMS, SEED, W, perm_idx)
    device_words = jnp.asarray(packed.packed_words())

    def once():
        binary_permutation_stats(packed, pheno_bin, masks, 3, 5, 0.05,
                                 device_matrix=device_words)
        quantitative_permutation_stats(packed, pheno_q, perm_idx, 3, 5,
                                       0.05, device_matrix=device_words)

    once()                                    # warm (jit compiles)
    best = float("inf")
    for _ in range(repeats):
        _settle()
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    return 2 * PERMS * S / best


def _pack_for_baseline(packed, edge_matrix, zero_row: int):
    """Per-path edge-row lists + per-snarl path offsets for the C++ loop.

    A path with an edge missing from the matrix gets the all-zero
    ``zero_row``: the reference's identify_path ABORTS such paths (no
    carriers, snarl_analyzer.cpp:334-336), and silently skipping the
    edge instead (the pre-round-5 behavior) made the baseline measure a
    cheaper, different computation."""
    from stoat_tpu.io.snarl_file import path_to_edges
    path_rows = []
    row_offsets = [0]
    snarl_offsets = [0]
    for snarl in packed.snarls:
        for path in snarl.paths:
            start = len(path_rows)
            for e in path_to_edges(path):
                if e[0][0] == 0 or e[1][0] == 0:
                    continue
                r = edge_matrix.find_edge(e)
                if r < 0:
                    del path_rows[start:]
                    path_rows.append(zero_row)   # no carriers
                    break
                path_rows.append(r)
            row_offsets.append(len(path_rows))
        snarl_offsets.append(snarl_offsets[-1] + len(snarl.paths))
    return (np.array(path_rows, np.int32),
            np.array(row_offsets, np.int64),
            np.array(snarl_offsets, np.int64))


def run_baseline(packed, edge_matrix, pheno_bin, pheno_q,
                 sample=BASELINE_SAMPLE):
    """Single-core C++ per-snarl loop (the reference's algorithm shape,
    dependency-free C++17; see native/baseline_core.cpp).  Falls back to
    the Python scalar oracle when the toolchain is missing."""
    sample = min(sample, packed.n_snarls)
    # Every input is prepared before the timer starts (the bool->uint8
    # matrix conversion is a large numpy copy).  The appended all-zero row is the no-carriers target for paths
    # with unresolved edges (see _pack_for_baseline).
    dense = np.ascontiguousarray(
        np.vstack([packed.dense_matrix(),
                   np.zeros((1, packed.n_haplotypes), bool)]), np.uint8)
    path_rows, row_offsets, snarl_offsets = _pack_for_baseline(
        packed, edge_matrix, dense.shape[0] - 1)
    pheno_u8 = pheno_bin.astype(np.uint8)
    try:
        from stoat_tpu.native import run_baseline_cpp
        n_paths_sample = int(snarl_offsets[sample])
        rows_s = path_rows[: int(row_offsets[n_paths_sample])]
        offs_s = row_offsets[: n_paths_sample + 1]
        soffs_s = snarl_offsets[: sample + 1]
        run_baseline_cpp(dense, rows_s, offs_s, soffs_s, pheno_u8,
                         pheno_q, 3, 5, 0.05)          # warm
        times = []
        for _ in range(3):  # best-of-3: fair to the baseline under load
            _settle()
            t0 = time.perf_counter()
            run_baseline_cpp(dense, rows_s, offs_s, soffs_s, pheno_u8,
                             pheno_q, 3, 5, 0.05)
            times.append(time.perf_counter() - t0)
        return 2 * sample / min(times), "cpp_single_core"
    except (RuntimeError, OSError):
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        import reference_impl as R
        t0 = time.perf_counter()
        for snarl in packed.snarls[:sample]:
            R.binary_reference(snarl, edge_matrix, dense,
                               pheno_bin.astype(bool), 3, 5, 0.05)
            R.quantitative_reference(snarl, edge_matrix, dense,
                                     pheno_q, None, 3, 5, 0.05)
        dt = time.perf_counter() - t0
        return 2 * sample / dt, "python_scalar"


def run_full(paths, snarls_chr, pheno_bin, pheno_q, tmpdir, repeats=3):
    """Wall of the complete CLI flow: run_vcf_analysis → finished TSV.

    One binary + one quantitative run over the full multi-chromosome
    workload — ingest, pack, dispatch, device→host fetch, C++ row
    formatting, and TSV writes all included (the runner pipelines chunk
    N's fetch/format/write behind chunk N+1's dispatch and the next
    chromosome's ingest)."""
    from stoat_tpu.pipeline.runner import run_vcf_analysis
    samples = list(paths["samples"])
    out_b = os.path.join(tmpdir, "bench_binary.tsv")
    out_q = os.path.join(tmpdir, "bench_quant.tsv")

    def bin_run():
        run_vcf_analysis(paths["vcf"], snarls_chr, out_b, "binary",
                         binary_phenotype=pheno_bin,
                         sample_names=samples, use_mesh=False,
                         snarl_chunk_size=16384)

    def quant_run():
        run_vcf_analysis(paths["vcf"], snarls_chr, out_q, "quantitative",
                         quantitative_phenotype=pheno_q,
                         sample_names=samples, use_mesh=False,
                         snarl_chunk_size=16384)

    def dual_run():
        # the dual-phenotype extension: both analyses in ONE pass (one
        # ingest, one device-matrix upload per chromosome)
        run_vcf_analysis(
            paths["vcf"], snarls_chr, out_b, "binary",
            binary_phenotype=pheno_bin, sample_names=samples,
            use_mesh=False, snarl_chunk_size=16384,
            secondary={"mode": "quantitative", "output_tsv": out_q,
                       "quantitative_phenotype": pheno_q})

    bin_run()
    quant_run()                      # warm (jit compiles, page cache)
    dual_run()                       # the fused dual shape too
    tb_times = []
    tq_times = []
    dual_times = []
    for _ in range(repeats):
        _settle()
        t0 = time.perf_counter()
        bin_run()
        tb_times.append(time.perf_counter() - t0)
        _settle()
        t0 = time.perf_counter()
        quant_run()
        tq_times.append(time.perf_counter() - t0)
        _settle()
        t0 = time.perf_counter()
        dual_run()
        dual_times.append(time.perf_counter() - t0)
    # independent best-of per run type (the same best-of semantics as
    # every other metric)
    t_full = min(tb_times) + min(tq_times)
    n_total = sum(len(s) for s in snarls_chr.values())
    return (2 * n_total / t_full, t_full,
            2 * n_total / min(dual_times), min(dual_times))


#  Matches the BASELINE.md graph-mode measurement scale (100k snarls ×
#  50 samples) so graph_vs_baseline compares like for like — the
#  single-core baseline loop is markedly faster at small scales (cache
#  residency + fewer samples per partition refinement).
GRAPH_SNARLS = 100000
GRAPH_SAMPLES = 50


def make_graph_workload(outdir, rng, n_snarls=GRAPH_SNARLS,
                        n_samples=GRAPH_SAMPLES):
    """GFA of ``n_snarls`` biallelic bubbles with ``n_samples`` sample
    paths + binary phenotype — the `stoat graph` workload shape.  Also
    returns the flat step arrays the single-core baseline consumes."""
    gfa = os.path.join(outdir, "graph.gfa")
    pheno_path = os.path.join(outdir, "graph_pheno.tsv")
    node = 1
    chain = []
    with open(gfa, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for _ in range(n_snarls):
            a, m1, m2 = node, node + 1, node + 2
            fh.write(f"S\t{a}\tAAAA\nS\t{m1}\tC\nS\t{m2}\tG\n")
            fh.write(f"L\t{a}\t+\t{m1}\t+\t0M\nL\t{a}\t+\t{m2}\t+\t0M\n")
            fh.write(f"L\t{m1}\t+\t{a+3}\t+\t0M\n"
                     f"L\t{m2}\t+\t{a+3}\t+\t0M\n")
            chain.append((a, m1, m2))
            node += 3
        fh.write(f"S\t{node}\tTTTT\n")
        ref = []
        for a, m1, _ in chain:
            ref += [f"{a}+", f"{m1}+"]
        ref.append(f"{node}+")
        fh.write("P\tref\t" + ",".join(ref) + "\t*\n")
        allele_pick = rng.random((n_samples, n_snarls)) < 0.5
        steps_flat = []
        offsets = [0]
        for s in range(n_samples):
            toks = []
            for k, (a, m1, m2) in enumerate(chain):
                mid = m1 if allele_pick[s, k] else m2
                toks += [f"{a}+", f"{mid}+"]
                steps_flat += [a << 1, mid << 1]
            toks.append(f"{node}+")
            steps_flat.append(node << 1)
            offsets.append(len(steps_flat))
            fh.write(f"P\ts{s}#0#chr\t" + ",".join(toks) + "\t*\n")
    with open(pheno_path, "w") as fh:
        fh.write("FID\tIID\tPHENO\n")
        for s in range(n_samples):
            fh.write(f"s{s}\ts{s}\t{1 + s % 2}\n")
    start_handles = np.array([a << 1 for a, _m1, _m2 in chain], np.uint64)
    # 1 = case, matching the TSV (sample s is case when 1 + s % 2 == 2)
    pheno_paths = np.array([s % 2 for s in range(n_samples)],
                           np.uint8)
    return (gfa, pheno_path, np.array(steps_flat, np.uint64),
            np.array(offsets, np.int64), start_handles, pheno_paths)


def run_graph_bench(tmpdir, rng, repeats=5):
    """`stoat graph` end-to-end (GFA -> finished TSV) vs the single-core
    C++ per-snarl baseline (walk-set partition + chi2,
    partitioner.cpp:36-268 + graph_path_association_finder.cpp:119-156).
    The end-to-end number includes GFA load, snarl finding, partitioning,
    device chi²/Fisher, and the TSV write; the baseline gets its graph
    handed over as in-memory arrays (a generous baseline)."""
    from stoat_tpu.graph.association import run_graph_association
    from stoat_tpu.native import run_baseline_graph_cpp

    gdir = os.path.join(tmpdir, "graph")
    os.makedirs(gdir, exist_ok=True)
    gfa, pheno_path, steps, offsets, starts, pheno = \
        make_graph_workload(gdir, rng)
    out = os.path.join(gdir, "out")
    os.makedirs(out, exist_ok=True)
    run_graph_association(gfa, "", pheno_path, "chi2", "tsv", 0, "ref",
                          out)                       # warm (jit, caches)
    # both sides best-of-N with a settle between reps: host background
    # load swings either side run to run, and the RATIO is the number of
    # record
    t_best = float("inf")
    for _ in range(repeats):
        _settle(0.6)
        t0 = time.perf_counter()
        run_graph_association(gfa, "", pheno_path, "chi2", "tsv", 0,
                              "ref", out)
        t_best = min(t_best, time.perf_counter() - t0)
    t_base = float("inf")
    for _ in range(repeats):          # best-of-N, like our side
        _settle(0.6)
        t0 = time.perf_counter()
        n_base = run_baseline_graph_cpp(steps, offsets, starts, pheno)
        t_base = min(t_base, time.perf_counter() - t0)
    base_rate = n_base / t_base if t_base > 0 else float("nan")
    return GRAPH_SNARLS / t_best, base_rate


def card_lines():
    """``nvidia-smi`` name and power limit, one entry per card."""
    import subprocess
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]


def main():
    import atexit
    import shutil

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("bench.py measures the GPU; JAX's first device "
                         f"is {dev.platform}")
    rng = np.random.default_rng(SEED)
    tmpdir = tempfile.mkdtemp(prefix="stoat_bench_")
    atexit.register(shutil.rmtree, tmpdir, True)   # ~60 MB per run
    # Two workloads: a single-chromosome VCF for the device/e2e phase
    # metrics (comparable with earlier rounds; no cross-chromosome
    # readahead in the measurement) and a 4-chromosome VCF for the
    # full-run metric (the realistic GWAS shape the runner pipelines).
    os.makedirs(os.path.join(tmpdir, "one"), exist_ok=True)
    os.makedirs(os.path.join(tmpdir, "full"), exist_ok=True)
    paths = make_vcf_workload(os.path.join(tmpdir, "one"), rng, n_chroms=1)
    paths_full = make_vcf_workload(os.path.join(tmpdir, "full"), rng)

    from stoat_tpu.io.phenotype import (parse_binary_pheno,
                                        parse_quantitative_pheno)
    from stoat_tpu.io.snarl_file import parse_snarl_path
    pheno_bin, samples = parse_binary_pheno(paths["binary"],
                                            list(paths["samples"]))
    pheno_q = parse_quantitative_pheno(paths["quantitative"], samples)
    snarls_one = parse_snarl_path(paths["snarl"])
    snarls_chr = parse_snarl_path(paths_full["snarl"])

    # warm pass: page cache, native build, jit compiles
    packed, matrix, t_ingest, t_pack = ingest_once(paths, snarls_one)
    t_analysis, t_each = run_device(packed, pheno_bin, pheno_q)

    # measured phases (best-of-4, fair under host load)
    for _ in range(3):
        _settle()
        packed, matrix, t_i2, t_p2 = ingest_once(paths, snarls_one)
        t_ingest = min(t_ingest, t_i2)
        t_pack = min(t_pack, t_p2)

    t_e2e = run_end_to_end(paths, snarls_one, pheno_bin, pheno_q)

    pheno_bin_f, samples_f = parse_binary_pheno(
        paths_full["binary"], list(paths_full["samples"]))
    pheno_q_f = parse_quantitative_pheno(paths_full["quantitative"],
                                         samples_f)
    full_rate, t_full, dual_rate, t_dual = run_full(
        paths_full, snarls_chr, pheno_bin_f, pheno_q_f, tmpdir)

    snarls_tested = 2 * packed.n_snarls
    # headline device rate: one fetch per PERM_BATCH complete dual
    # analyses; the two-dispatch time ships alongside as
    # single_dispatch_snarls_per_s
    device_rate = snarls_tested / t_each
    device_rate_2disp = snarls_tested / t_analysis
    e2e_rate = snarls_tested / t_e2e

    baseline_rate, baseline_kind = run_baseline(packed, matrix, pheno_bin,
                                                pheno_q)

    perm_rate = run_perm(packed, pheno_bin, pheno_q)

    graph_rate, graph_base_rate = run_graph_bench(tmpdir, rng)

    print(json.dumps({
        "metric": "snarls_tested_per_s_per_chip",
        "value": round(device_rate, 1),
        "unit": "snarls/s",
        "vs_baseline": round(device_rate / baseline_rate, 2),
        "baseline_kind": baseline_kind,
        "end_to_end_snarls_per_s": round(e2e_rate, 1),
        "end_to_end_vs_baseline": round(e2e_rate / baseline_rate, 2),
        "full_run_snarls_per_s": round(full_rate, 1),
        "full_run_vs_baseline": round(full_rate / baseline_rate, 2),
        "full_run_s": round(t_full, 4),
        "dual_run_snarls_per_s": round(dual_rate, 1),
        "dual_run_vs_baseline": round(dual_rate / baseline_rate, 2),
        "dual_run_s": round(t_dual, 4),
        "e2e_s": round(t_e2e, 4),
        "ingest_s": round(t_ingest, 4),
        "pack_s": round(t_pack, 4),
        "analysis_s": round(t_analysis, 4),
        "analysis_each_s": round(t_each, 4),
        "single_dispatch_snarls_per_s": round(device_rate_2disp, 1),
        "baseline_snarls_per_s": round(baseline_rate, 1),
        "perm_snarl_tests_per_s": round(perm_rate, 1),
        "perm_vs_baseline_full_runs": round(
            perm_rate / baseline_rate, 2),
        "n_perms": PERMS,
        "graph_snarls_per_s": round(graph_rate, 1),
        "graph_vs_baseline": round(graph_rate / graph_base_rate, 2),
        "graph_baseline_snarls_per_s": round(graph_base_rate, 1),
        "n_snarls": int(packed.n_snarls),
        "n_chroms": N_CHROMS,
        "n_samples": N_SAMPLES,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
        "card": card_lines(),
    }))


if __name__ == "__main__":
    main()
