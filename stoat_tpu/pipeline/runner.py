"""VCF-mode orchestration: stream → pack → device batch → TSV.

Equivalent of SnarlAnalyzer::process_snarls_by_chromosome_chunk
(/root/reference/src/snarl_analyzer.cpp:110-188): the VCF is read one
chromosome at a time (only that chromosome's edge matrix is resident),
every snarl of the chromosome is analyzed in one batched device dispatch,
and rows stream to the output TSV in snarl-file order (deterministic —
the reference's OpenMP ordering is nondeterministic, but its own system
tests compare order-insensitively keyed by SNARL,
tests/system/compare_files_utils.cpp:226-252).
"""

from __future__ import annotations

import logging
import os
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np

from stoat_tpu.formatting import is_pvalue_significant, pair_to_string
from stoat_tpu.io.phenotype import QtlData
from stoat_tpu.io.snarl_file import SnarlData
from stoat_tpu.io.vcf import VcfReader
from stoat_tpu.matrix import EdgeHaplotypeMatrix
from stoat_tpu.pipeline.binary import binary_analyze_chromosome
from stoat_tpu.pipeline.quantitative import (
    binary_covar_analyze_chromosome,
    eqtl_design_for_chromosome,
    eqtl_regress_pairs,
    quantitative_analyze_chromosome,
)
from stoat_tpu import writer as W

logger = logging.getLogger("stoat")

__all__ = ["run_vcf_analysis", "found_gene_snarl", "iter_chromosome_matrices"]


def iter_chromosome_matrices(vcf_path: str, n_haplotypes: int,
                             snarls_chr: Dict[str, List[SnarlData]],
                             use_native: bool = True,
                             stream_device_words: bool = False,
                             stream_skip=()):
    """Yield (chrom, edge-matrix object) per chromosome.

    Prefers the native C++ core (stoat_tpu.native) — the reference's
    [native-critical] ingestion path — and falls back to the pure-Python
    reader when the toolchain is unavailable.

    ``stream_device_words``: start the device upload of each
    chromosome's packed word rows INCREMENTALLY while the C++ core is
    still parsing (the words upload is the largest per-chromosome
    transfer; overlapping it with the parse hides one of the two).  The
    uploaded slices are stashed on the matrix as ``words_device_parts``
    for assemble_words_device.
    """
    if use_native:
        yielded_any = False
        try:
            from stoat_tpu.native import NativeVcfMatrixReader
            from stoat_tpu.matrix import PackedEdgeMatrix
            reader = NativeVcfMatrixReader(vcf_path)
            on_rows = None
            parts: List = []
            if stream_device_words:
                import jax.numpy as _jnp
                skip = set(stream_skip)
                prev_row: Dict[str, np.ndarray] = {}

                def on_rows(arr, lo, hi, chrom):
                    # upload the slice now AND keep the host copy:
                    # a later record can OR carrier bits into an
                    # already-shipped row (records sharing an edge
                    # across parse batches), so assemble_words_device
                    # diffs each kept copy against the final words and
                    # patches stale rows on device (exactness pinned by
                    # tests).  ``stream_skip`` (e.g. --resume's
                    # completed chromosomes) suppresses the wasted
                    # uploads of chromosomes the caller will discard.
                    #
                    # The uplink rides DEDUPLICATED: consecutive
                    # identical rows (every private edge of one allele
                    # path carries the same haplotype bit pattern, so
                    # a record's rows arrive in runs) collapse to one
                    # shipped row + a 1-bit "new row" flag kept on
                    # host; assemble_words_device reconstructs the full
                    # matrix on device via cumsum+gather.
                    if chrom in skip or chrom not in snarls_chr:
                        return
                    if arr.shape[0] == 0:
                        return
                    prev = prev_row.get(chrom)
                    new = np.empty(arr.shape[0], bool)
                    new[0] = prev is None or bool(np.any(arr[0] != prev))
                    if arr.shape[0] > 1:
                        np.any(arr[1:] != arr[:-1], axis=1, out=new[1:])
                    prev_row[chrom] = arr[-1].copy()
                    parts.append((_jnp.asarray(arr[new]), new, arr, lo,
                                  hi))
            try:
                for chrom, words, n_haps, edges in reader.chunks_packed(
                        on_rows=on_rows):
                    yielded_any = True
                    matrix = PackedEdgeMatrix(words, n_haps, edges)
                    matrix.n_records, matrix.n_with_at = \
                        getattr(reader, "last_counts", (-1, -1))
                    matrix.resolve_idx_native = \
                        getattr(reader, "last_resolver", None)
                    if stream_device_words:
                        matrix.words_device_parts = parts[:]
                        parts.clear()
                    yield chrom, matrix
            finally:
                # also runs on GeneratorExit when a consumer abandons the
                # generator early — the producer thread must not leak
                reader.close()
            return
        except (RuntimeError, OSError) as e:
            if yielded_any:
                # chromosomes already went downstream: falling back to
                # the Python reader would RE-YIELD them from the top of
                # the VCF and duplicate output rows — fail instead
                raise
            logger.warning("native VCF core unavailable (%s); using the "
                           "Python reader", e)

    reader = VcfReader(vcf_path)
    try:
        for chrom, records in reader.chromosome_chunks():
            matrix = EdgeHaplotypeMatrix(
                n_haplotypes,
                initial_rows=max(4 * len(snarls_chr.get(chrom, [])), 64))
            n_records = n_with_at = 0
            for rec in records:
                n_records += 1
                n_with_at += 1 if rec.at_paths else 0
                matrix.add_record(rec)
            matrix.n_records, matrix.n_with_at = n_records, n_with_at
            yield chrom, matrix
    finally:
        reader.close()


def _progress_path(data_path: str) -> str:
    return data_path + ".progress"


def _read_progress(data_path: str) -> Dict[str, int]:
    """{chrom: byte offset after its last row} in completion order."""
    out: Dict[str, int] = {}
    try:
        with open(_progress_path(data_path)) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    try:
                        out[parts[0]] = int(parts[1])
                    except ValueError:
                        pass
    except OSError:
        pass
    return out


def _record_progress(fh, data_path: str, chrom: str):
    """Durable per-chromosome checkpoint (crash resume, --resume).

    Runs on the writer thread AFTER every one of the chromosome's row
    writes (FIFO queue): fsync the data file, then append
    ``chrom<TAB>offset`` to the sidecar — a chromosome is resumable only
    once its rows are actually on disk."""
    fh.flush()
    buf = getattr(fh, "buffer", None)
    if buf is not None:
        off = buf.tell()
    else:
        off = fh.tell()
    os.fsync(fh.fileno())
    with open(_progress_path(data_path), "a") as pf:
        pf.write(f"{chrom}\t{off}\n")
        pf.flush()
        os.fsync(pf.fileno())
    return 0


def assemble_words_device(matrix):
    """Device words array for a natively-ingested chromosome.

    When the iterator streamed incremental row uploads
    (``words_device_parts``), the parts arrive DEDUPLICATED (only rows
    differing from their predecessor were shipped, plus a host-side
    "new row" bool per row); reconstruction concatenates the unique
    rows on device, expands the packed flag bits, and gathers
    ``unique[cumsum(new)-1]`` — then appends the all-ones AND-identity
    row and PATCHES any row the parser mutated after it was shipped: a
    record later in the chromosome can OR carrier bits into an existing
    row when its traversal shares an edge with an earlier record, so
    each streamed slice's retained host copy is diffed against the
    final ``matrix.words`` and stale rows are scatter-updated on device
    (a handful of rows in practice, zero for disjoint-edge records).
    Value-identical to uploading ``matrix.words`` whole — pinned by
    tests — but the big transfer already happened during the parse, with
    repeated rows sent once."""
    import jax.numpy as jnp
    parts = getattr(matrix, "words_device_parts", None)
    if parts:
        final = matrix.words              # [E+1, W], identity row last
        # Coverage check: on_rows runs inside a ctypes callback, where a
        # raised exception (e.g. a failed slice upload) is printed and
        # SWALLOWED — a dropped slice would
        # silently shift every later row index.  Any gap → full upload.
        expect = 0
        ok = True
        for _d, _f, _h, lo, hi in parts:
            if lo != expect:
                ok = False
                break
            expect = hi
        if not ok or expect != final.shape[0] - 1:
            logger.warning(
                "streamed word slices do not cover the chromosome "
                "(%d/%d rows) — falling back to a whole-matrix upload",
                expect, final.shape[0] - 1)
            return upload_words_dedup(final)
        fix_rows = []
        uniq_parts = []
        flag_parts = []
        for dev_u, new, host, lo, hi in parts:
            uniq_parts.append(dev_u)
            flag_parts.append(new)
            want = final[lo:hi]
            # memcmp fast path first: parts are usually byte-identical
            # (stale rows need cross-batch edge sharing), and the
            # equality scan is cheaper than materializing the row-wise
            # != reduction
            if np.array_equal(host, want):
                continue
            stale = np.flatnonzero(np.any(host != want, axis=1))
            if stale.size:
                fix_rows.append(stale + lo)
        from stoat_tpu.pipeline.packed import gather_dedup
        W = int(final.shape[1])
        flags = (np.concatenate(flag_parts) if len(flag_parts) > 1
                 else flag_parts[0])
        n = int(flags.shape[0])           # == E rows (excl. identity)
        uniq = (jnp.concatenate(uniq_parts, axis=0)
                if len(uniq_parts) > 1 else uniq_parts[0])
        body = gather_dedup(uniq, flags, n)
        ident = jnp.full((1, W), 0xFFFFFFFF, jnp.uint32)
        words = jnp.concatenate([body, ident], axis=0)
        if fix_rows:
            idx = np.concatenate(fix_rows)
            words = words.at[jnp.asarray(idx)].set(
                jnp.asarray(final[idx]))
        return words
    return upload_words_dedup(matrix.words)


def upload_words_dedup(words_np: np.ndarray):
    """Upload a host [R, W] words array with consecutive duplicate rows
    elided (see assemble_words_device); value-identical to
    ``jnp.asarray(words_np)`` but fewer bytes for VCF-shaped matrices
    (runs of identical rows per allele path)."""
    import jax.numpy as jnp

    from stoat_tpu.pipeline.packed import gather_dedup
    n = int(words_np.shape[0])
    if n < 16:
        return jnp.asarray(words_np)
    new = np.empty(n, bool)
    new[0] = True
    np.any(words_np[1:] != words_np[:-1], axis=1, out=new[1:])
    n_uniq = int(np.count_nonzero(new))
    if n_uniq > 0.85 * n:                 # incompressible; ship raw
        return jnp.asarray(words_np)
    return gather_dedup(jnp.asarray(words_np[new]), new, n)


def _prefetched(gen, depth: int = 1):
    """Run a generator on a background thread, ``depth`` items ahead.

    Used to overlap the next chromosome's native VCF ingestion (ctypes
    releases the GIL inside the C++ core) with the current chromosome's
    packing, device dispatch, and TSV writing — the reference runs these
    phases strictly serially (snarl_analyzer.cpp:110-188)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


class _QuadTokenizer:
    """Tokenizes every chromosome's snarl paths on a background thread.

    The path-string tokenize (tables.tokenize_chromosome) depends only on
    the snarl file, so it runs concurrently with the first chromosome's
    VCF ingestion; ``get`` blocks until that chromosome's cache is ready
    (in practice it already is)."""

    def __init__(self, snarls_chr: Dict[str, List[SnarlData]]):
        import threading

        from stoat_tpu.tables import tokenize_chromosome
        self._tokenize = tokenize_chromosome
        self._results: Dict[str, object] = {}
        self._events = {c: threading.Event() for c in snarls_chr}
        self._snarls_chr = snarls_chr
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        for chrom, snarls in self._snarls_chr.items():
            try:
                self._results[chrom] = self._tokenize(snarls)
            except Exception:                      # fall back in-line
                self._results[chrom] = None
            self._events[chrom].set()

    def get(self, chrom: str):
        event = self._events.get(chrom)
        if event is None:
            return None
        event.wait()
        return self._results.get(chrom)


class _PipelinedWriter:
    """Serial executor for result fetch+format+write work.

    The reference's analysis loop serializes test → format → write per
    snarl (snarl_analyzer.cpp:165-188, omp critical on the stream); here
    chunk N's device→host fetch, C++ row formatting, and TSV write run on
    this thread while the main thread dispatches chunk N+1 and the next
    chromosome ingests — the tail never blocks the pipeline.  Work items
    execute strictly FIFO, so output order stays deterministic."""

    def __init__(self, maxsize: int = 8):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.filtered: Dict[str, int] = {}
        self._errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._errors:
                continue            # drain after failure (no deadlock)
            fn, tag = item
            try:
                got = fn()
                if got:
                    self.filtered[tag] = self.filtered.get(tag, 0) + got
            except BaseException as e:
                self._errors.append(e)

    def count(self, tag: str = "primary") -> int:
        return self.filtered.get(tag, 0)

    def submit(self, fn, tag: str = "primary") -> None:
        if self._errors:
            raise self._errors[0]
        self._q.put((fn, tag))

    def close(self) -> Dict[str, int]:
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise self._errors[0]
        return self.filtered


def found_gene_snarl(gene_position: List[QtlData], start_pos: int,
                     end_pos: int, window: int) -> List[int]:
    """Genes overlapping [start-window, end+window]
    (snarl_analyzer.cpp:471-491)."""
    lo = start_pos - window if start_pos > window else 0
    hi = end_pos + window
    return [i for i, g in enumerate(gene_position)
            if not (g.end_pos < lo or g.start_pos > hi)]


def run_vcf_analysis(
    vcf_path: str,
    snarls_chr: Dict[str, List[SnarlData]],
    output_tsv: str,
    mode: str,                       # binary | binary_covar | quantitative | eqtl
    binary_phenotype: Optional[np.ndarray] = None,
    quantitative_phenotype: Optional[np.ndarray] = None,
    eqtl_map: Optional[Dict[str, List[QtlData]]] = None,
    covariate: Optional[np.ndarray] = None,
    maf_threshold: float = 0.05,
    table_threshold: float = -1,
    min_individuals: int = 3,
    min_haplotypes: int = 5,
    windows_gene_threshold: int = 1000000,
    regression_dir: str = "",
    sample_names: Optional[List[str]] = None,
    snarl_chunk_size: int = 8192,
    use_mesh: Optional[bool] = None,
    lmm_ctx=None,
    secondary: Optional[Dict] = None,
    resume: bool = False,
) -> int:
    """Run the full GWAS over a VCF.  Returns total snarls filtered.

    ``use_mesh``: shard the snarl axis over all visible devices via
    shard_map (binary/covar/quantitative modes).  Default: automatic —
    enabled when more than one device is attached.

    ``secondary``: test a SECOND phenotype in the same pass — one VCF
    ingest, one device matrix upload, both analyses per chunk (a
    capability the reference lacks: it requires one run per phenotype,
    vcf.cpp:237-255).  A dict with keys ``mode`` (binary/binary_covar/
    quantitative/lmm), ``output_tsv``, and the mode's phenotype inputs
    (``binary_phenotype``/``quantitative_phenotype``/``lmm_ctx``).
    Single-device modes only (no mesh, no eQTL).
    """
    import jax as _jax
    # The dual-phenotype pass shards over the mesh only for its fused
    # combination (binary + quantitative, no -T tables); other secondary
    # shapes run the single-device pipelined path.
    dual_mesh_ok = (secondary is not None and mode == "binary"
                    and secondary.get("mode") == "quantitative"
                    and table_threshold == -1)
    if use_mesh is None:
        use_mesh = _jax.device_count() > 1
        if secondary is not None and use_mesh and not dual_mesh_ok:
            logger.info("Dual-phenotype run: using the single-device "
                        "pipelined path")
            use_mesh = False
    mesh = None
    if use_mesh:
        from stoat_tpu.parallel import make_snarl_mesh
        mesh = make_snarl_mesh()
        logger.info("Sharding snarls over %d devices", _jax.device_count())
    header_reader = VcfReader(vcf_path)
    samples = sample_names or header_reader.samples
    header_reader.close()
    n_hap = 2 * len(samples)

    total_filtered = 0
    total_analyzed = 0
    if secondary is not None and mode == "eqtl":
        raise ValueError("secondary phenotype runs do not support eQTL "
                         "primaries")
    if secondary is not None and use_mesh and not dual_mesh_ok:
        raise ValueError(
            "mesh-sharded secondary runs support only the fused binary "
            "primary + quantitative secondary without -T tables")
    if secondary is not None:
        _validate_secondary(secondary)

    def _write_header(fh, m):
        if m == "binary":
            W.write_binary_header(fh)
        elif m == "binary_covar":
            W.write_binary_covar_header(fh)
        elif m in ("quantitative", "lmm"):
            W.write_quantitative_header(fh)
        elif m == "eqtl":
            W.write_eqtl_header(fh)
        else:
            raise ValueError(f"unknown mode {m}")

    # --resume: per-chromosome checkpointing via a ``.progress`` sidecar
    # (chrom + byte offset, fsynced after the chromosome's rows — see
    # _record_progress).  A chromosome counts as complete only when every
    # output file of the run has it; each file truncates back to the last
    # jointly-complete offset so a partial chromosome is rewritten whole.
    # This extends the reference's only checkpoint (the snarl_analyse.tsv
    # cache, vcf.cpp:317-319) to the analysis phase itself.
    resume_done: List[str] = []
    if resume:
        prim_prog = _read_progress(output_tsv)
        sec_prog = (_read_progress(secondary["output_tsv"])
                    if secondary is not None else None)
        for c in prim_prog:
            if sec_prog is None or c in sec_prog:
                resume_done.append(c)
            else:
                break
        if resume_done:
            logger.info("Resume: %d chromosome(s) already complete (%s)",
                        len(resume_done), ", ".join(resume_done))

    def _open_output(path, m, prog):
        if resume_done and prog is not None:
            off = prog[resume_done[-1]]
            fh = open(path, "r+", newline="")
            fh.seek(off)
            fh.truncate()
            return fh
        try:
            os.remove(_progress_path(path))
        except OSError:
            pass
        fh = open(path, "w", newline="")
        _write_header(fh, m)
        return fh

    sec_fh = None
    with _open_output(output_tsv, mode,
                      prim_prog if resume else None) as outf:
        if secondary is not None:
            sec_fh = _open_output(secondary["output_tsv"],
                                  secondary["mode"],
                                  sec_prog if resume else None)

        # Overlap host phases: the next chromosome ingests on a prefetch
        # thread while this one packs/dispatches/writes, the path
        # tokenizes run ahead on their own thread (see _QuadTokenizer),
        # and result fetch+format+write drain on the pipelined writer
        # thread behind the dispatches (mode-specific; eQTL's
        # data-dependent gene pairing keeps its original inline flow).
        matrices = _prefetched(
            iter_chromosome_matrices(
                vcf_path, n_hap, snarls_chr,
                stream_device_words=mesh is None,
                stream_skip=resume_done))
        tokenizer = _QuadTokenizer(snarls_chr)
        writer = None if mode == "eqtl" else _PipelinedWriter()
        pheno_device = None   # per-run packed phenotype masks (binary)
        while True:
            t0 = time.time()
            try:
                chrom, matrix = next(matrices)
            except StopIteration:
                break
            if chrom not in snarls_chr:
                logger.warning("Chromosome %s not found in snarl paths "
                               "file. Skipping.", chrom)
                continue
            if chrom in resume_done:
                logger.info("Resume: chromosome %s already complete; "
                            "skipping.", chrom)
                continue
            logger.info("Analysing chr : %s", chrom)
            t1 = time.time()
            logger.info("Matrix time construction in chr %s : %.3f s",
                        chrom, t1 - t0)

            snarls = snarls_chr[chrom]
            # Degenerate-input diagnostics: a header-only output with no
            # explanation is a support ticket, not a result.
            n_rec = getattr(matrix, "n_records", -1)
            n_at = getattr(matrix, "n_with_at", -1)
            if n_rec == 0:
                logger.warning(
                    "Chromosome %s: the VCF contains no records for this "
                    "chromosome; all %d snarls will be filtered.",
                    chrom, len(snarls))
            elif n_at == 0:
                logger.warning(
                    "Chromosome %s: 0 of %d VCF records carry a usable "
                    "AT INFO field (vg deconstruct emits it; plain VCFs "
                    "do not) — no genotype matrix can be built and all "
                    "%d snarls will be filtered.",
                    chrom, n_rec, len(snarls))
            elif matrix.n_rows == 0:
                logger.warning(
                    "Chromosome %s: %d/%d AT-carrying records produced "
                    "no matrix rows (no called alleles?); all %d snarls "
                    "will be filtered.", chrom, n_at, n_rec, len(snarls))
            import jax.numpy as jnp
            # Chunk the snarl axis so one chromosome's batch stays within
            # device memory regardless of scale (SURVEY.md §5.7: the
            # reference's analog is per-chromosome matrix residency).
            # The quantitative design is [chunk, samples, paths] f64, so
            # large cohorts shrink the chunk: rows are capped so that
            # rows x samples x 96 bytes stays under 2e9.  The cap is a
            # fixed bound, not derived from the card or measured.
            n_samples_total = len(samples)
            effective_chunk = snarl_chunk_size
            if mode != "binary" and n_samples_total > 0:
                budget_rows = max(int(2e9 // (n_samples_total * 8 * 12)),
                                  256)
                effective_chunk = min(snarl_chunk_size, budget_rows)
            filtered = 0
            chunk_mesh = mesh
            chr_state: Dict[str, int] = {}
            if writer is not None:
                writer.submit(lambda st=chr_state: st.__setitem__(
                    "start", writer.count()))
            from stoat_tpu.tables import pack_chromosome_chunks
            device_matrix = None
            if (chunk_mesh is None or mode == "eqtl") and \
                    getattr(matrix, "words", None) is not None:
                # the chromosome words transfer (the largest
                # per-chromosome transfer) either already streamed
                # during the parse (words_device_parts) or starts NOW
                # and overlaps the host packing
                device_matrix = assemble_words_device(matrix)
            for packed in pack_chromosome_chunks(
                    snarls, matrix, effective_chunk,
                    quad_cache=tokenizer.get(chrom)):
                if mode == "binary" and pheno_device is None and (
                        chunk_mesh is None):
                    # per-run constants: the packed phenotype masks are
                    # identical for every chunk and chromosome (W is a
                    # function of the cohort) — upload once
                    from stoat_tpu.pipeline import packed as _pkmod
                    Ww = max((n_hap + 31) // 32, 1)
                    from stoat_tpu.pipeline.binary import \
                        PACKED_HAPLOTYPE_THRESHOLD as _PHT
                    if packed.words is not None or \
                            packed.n_haplotypes >= _PHT:
                        pheno_device = _pkmod.upload_pheno_mask_words(
                            binary_phenotype, n_hap, Ww)
                if device_matrix is None and (chunk_mesh is None
                                              or mode == "eqtl"):
                    # upload the (possibly empty-padded) chromosome matrix
                    # once; all chunks share it.  Native-ingested
                    # chromosomes arrive bit-packed (32 haplotypes/uint32
                    # — 32x less HBM and upload than f32; pipeline/
                    # packed.py) and every mode consumes the words
                    # directly; the Python-reader path packs on host at
                    # cohort scale, else ships dense f32.
                    from stoat_tpu.pipeline.binary import \
                        PACKED_HAPLOTYPE_THRESHOLD
                    if (packed.words is not None or
                            packed.n_haplotypes >=
                            PACKED_HAPLOTYPE_THRESHOLD):
                        device_matrix = upload_words_dedup(
                            packed.packed_words())
                    else:
                        device_matrix = jnp.asarray(packed.matrix,
                                                    jnp.float32)

                if chunk_mesh is not None and sec_fh is not None:
                    # mesh-sharded fused dual: one shard_map per chunk
                    # computes both result sets (shared membership)
                    from stoat_tpu.pipeline.quantitative import PrefixView
                    res, holder = _analyze_sharded(
                        chunk_mesh, packed, "dual", binary_phenotype,
                        secondary["quantitative_phenotype"], covariate,
                        min_individuals, min_haplotypes, maf_threshold,
                        matrix)
                    writer.submit(partial(
                        _write_rows, outf, chrom, holder, res, "binary",
                        table_threshold, regression_dir, samples))
                    writer.submit(partial(
                        _write_rows, sec_fh, chrom, holder,
                        PrefixView(res), "quantitative", table_threshold,
                        regression_dir, samples), tag="secondary")
                elif chunk_mesh is not None and mode != "eqtl":
                    res, holder = _analyze_sharded(
                        chunk_mesh, packed, mode, binary_phenotype,
                        quantitative_phenotype, covariate,
                        min_individuals, min_haplotypes, maf_threshold,
                        matrix, lmm_ctx=lmm_ctx,
                        return_tables=table_threshold != -1)
                    writer.submit(partial(
                        _write_rows, outf, chrom, holder, res, mode,
                        table_threshold, regression_dir, samples))
                elif mode == "eqtl":
                    filtered += _write_eqtl(
                        outf, chrom, packed, eqtl_map.get(chrom, []),
                        covariate, min_individuals, min_haplotypes,
                        maf_threshold, windows_gene_threshold,
                        table_threshold, regression_dir, samples,
                        device_matrix, mesh=chunk_mesh)
                elif (sec_fh is not None and mode == "binary"
                      and secondary["mode"] == "quantitative"
                      and table_threshold == -1
                      and _dual_fused_args(packed, device_matrix)
                      is not None):
                    # Fused dual dispatch: ONE device program computes
                    # the shared packed membership once and both result
                    # sets ride one wire pack (one fetch per chunk).
                    # The secondary phenotype comes from the ``secondary``
                    # dict (the documented contract above), NOT the
                    # primary ``quantitative_phenotype`` arg, which is
                    # None in a binary-mode run.
                    res = _analyze_dual_fused(
                        packed, binary_phenotype,
                        secondary["quantitative_phenotype"],
                        min_individuals, min_haplotypes, maf_threshold,
                        device_matrix, pheno_device,
                        covariate=covariate)
                    writer.submit(partial(
                        _write_chunk, outf, chrom, packed, res, "binary",
                        table_threshold, regression_dir, samples))

                    def _write_q(sec_fh=sec_fh, chrom=chrom,
                                 packed=packed, res=res):
                        from stoat_tpu.pipeline.quantitative import \
                            PrefixView
                        return _write_chunk(
                            sec_fh, chrom, packed, PrefixView(res),
                            "quantitative", table_threshold,
                            regression_dir, samples)
                    writer.submit(_write_q, tag="secondary")
                else:
                    # single-device path: dispatch now, let the writer
                    # thread fetch+format+write behind the pipeline
                    res = _analyze_chunk(
                        mode, packed, binary_phenotype,
                        quantitative_phenotype, covariate,
                        min_individuals, min_haplotypes, maf_threshold,
                        table_threshold, device_matrix, lmm_ctx,
                        pheno_device)
                    writer.submit(partial(
                        _write_chunk, outf, chrom, packed, res, mode,
                        table_threshold, regression_dir, samples))
                    if sec_fh is not None:
                        res2 = _analyze_chunk(
                            secondary["mode"], packed,
                            secondary.get("binary_phenotype"),
                            secondary.get("quantitative_phenotype"),
                            covariate, min_individuals, min_haplotypes,
                            maf_threshold, table_threshold,
                            device_matrix, secondary.get("lmm_ctx"),
                            None)
                        writer.submit(partial(
                            _write_chunk, sec_fh, chrom, packed, res2,
                            secondary["mode"], table_threshold,
                            regression_dir, samples), tag="secondary")

            total_analyzed += len(snarls)
            t2 = time.time()
            if writer is None:
                total_filtered += filtered
                if filtered == len(snarls) and snarls:
                    logger.warning(
                        "Chromosome %s: all %d snarls were filtered "
                        "(min-individuals/min-haplotypes/MAF thresholds, "
                        "or the snarl paths reference edges absent from "
                        "the VCF's AT traversals).", chrom, filtered)
                logger.info("Number of snarl filtered in chr %s : %d",
                            chrom, filtered)
                logger.info("Snarl time analysis in chr %s : %.3f s",
                            chrom, t2 - t1)
                logger.info("Total time for chr %s : %.3f s",
                            chrom, t2 - t0)
            else:
                # log from the writer thread once this chromosome's rows
                # are on disk (FIFO order keeps the counts exact)
                def _chr_done(chrom=chrom, n=len(snarls), t0=t0, t1=t1,
                              st=chr_state):
                    f = writer.count() - st.get("start", 0)
                    if f == n and n:
                        logger.warning(
                            "Chromosome %s: all %d snarls were filtered "
                            "(min-individuals/min-haplotypes/MAF "
                            "thresholds, or the snarl paths reference "
                            "edges absent from the VCF's AT traversals).",
                            chrom, f)
                    t2 = time.time()
                    logger.info("Number of snarl filtered in chr %s : %d",
                                chrom, f)
                    logger.info("Snarl time analysis in chr %s : %.3f s",
                                chrom, t2 - t1)
                    logger.info("Total time for chr %s : %.3f s",
                                chrom, t2 - t0)
                    return 0
                writer.submit(_chr_done)
            # durable per-chromosome checkpoint, recorded strictly after
            # this chromosome's rows (FIFO writer) — secondary first so
            # a crash between the two markers re-runs the chromosome
            if writer is not None:
                if sec_fh is not None:
                    writer.submit(partial(
                        _record_progress, sec_fh,
                        secondary["output_tsv"], chrom))
                writer.submit(partial(_record_progress, outf,
                                      output_tsv, chrom))
            else:
                _record_progress(outf, output_tsv, chrom)

        if writer is not None:
            counts = writer.close()
            total_filtered += counts.get("primary", 0)
            if secondary is not None:
                logger.info("Secondary mode: %d snarls filtered",
                            counts.get("secondary", 0))
        if sec_fh is not None:
            sec_fh.close()
    logger.info("Total number of snarl filtered : %d", total_filtered)
    if total_analyzed and total_filtered == total_analyzed:
        logger.warning(
            "All %d snarls across every chromosome were filtered — the "
            "output table has a header and no rows. Check that the VCF "
            "carries AT INFO fields matching the snarl file's paths and "
            "that the filter thresholds fit the cohort size.",
            total_analyzed)
    return total_filtered


class _SnarlHolder:
    """Minimal writer-facing view of a snarl chunk."""

    def __init__(self, snarls):
        self.snarls = snarls


def _analyze_sharded(mesh, packed, mode, binary_phenotype,
                     quantitative_phenotype, covariate, min_individuals,
                     min_haplotypes, maf_threshold, matrix, lmm_ctx=None,
                     return_tables: bool = False):
    """Dispatch a chunk through the shard_map analyzers."""
    import jax as _jax
    from stoat_tpu.parallel import (binary_analyze_sharded,
                                    binary_covar_analyze_sharded,
                                    dual_analyze_sharded,
                                    lmm_analyze_sharded,
                                    quantitative_analyze_sharded,
                                    shard_packed_chromosome)
    n_dev = _jax.device_count()
    sharded = shard_packed_chromosome(packed.snarls, matrix, n_dev)
    if mode == "dual":
        res = dual_analyze_sharded(
            sharded, binary_phenotype, quantitative_phenotype, mesh,
            min_individuals, min_haplotypes, maf_threshold,
            covariate=covariate)
    elif mode == "binary":
        res = binary_analyze_sharded(
            sharded, binary_phenotype, mesh, min_individuals,
            min_haplotypes, maf_threshold)
    elif mode == "binary_covar":
        res = binary_covar_analyze_sharded(
            sharded, binary_phenotype, mesh, min_individuals,
            min_haplotypes, maf_threshold, return_tables=return_tables)
    elif mode == "lmm":
        res = lmm_analyze_sharded(
            sharded, lmm_ctx, covariate, mesh, min_individuals,
            min_haplotypes, maf_threshold, return_tables=return_tables)
    else:
        res = quantitative_analyze_sharded(
            sharded, quantitative_phenotype, covariate, mesh,
            min_individuals, min_haplotypes, maf_threshold,
            return_tables=return_tables)
    return res, _SnarlHolder(packed.snarls)


def _write_rows(outf, chrom, holder, res, mode, table_threshold,
                regression_dir, samples) -> int:
    """Write rows from sharded results (incl. -T per-sample tables when
    the analyzer returned them)."""
    snarls = holder.snarls
    if mode == "binary":
        return W.write_binary_rows_batch(outf, chrom, snarls, res)
    if "norm" not in res:
        return W.write_quant_rows_batch(outf, chrom, snarls, res,
                                        has_r2=mode != "binary_covar")
    # -T table dumps: per-row path (needs per-snarl significance checks)
    filtered = 0
    for s, snarl in enumerate(snarls):
        if res["filtered"][s]:
            filtered += 1
            continue
        p_str = W.format_p(res["p"][s])
        _maybe_write_table(res, s, snarl, p_str, table_threshold,
                           regression_dir, samples)
        allele_paths = res["allele_paths"][s][: snarl.n_paths]
        if mode == "binary_covar":
            W.write_binary_covar_row(
                outf, chrom, snarl, snarl.type_var_str,
                p_str, W.format_p(res["beta"][s]),
                W.format_p(res["se"][s]), allele_paths)
        else:
            W.write_quantitative_row(
                outf, chrom, snarl, snarl.type_var_str,
                p_str, W.format_p(res["r2"][s]),
                W.format_p(res["beta"][s]), W.format_p(res["se"][s]),
                allele_paths)
    return filtered


def _analyze_chunk(mode, packed, binary_phenotype, quantitative_phenotype,
                   covariate, min_individuals, min_haplotypes,
                   maf_threshold, table_threshold, device_matrix, lmm_ctx,
                   pheno_device):
    """Dispatch one chunk's device analysis; returns a FlatResult — all
    per-snarl outputs wire-packed into ONE device array with its host
    copy started: one device→host copy per chunk instead of one per
    output array."""
    from stoat_tpu.pipeline.fetch import flatten_result
    wide = packed.n_haplotypes >= (1 << 16)
    if mode == "binary":
        out = binary_analyze_chromosome(
            packed, binary_phenotype, min_individuals, min_haplotypes,
            maf_threshold, device_matrix=device_matrix,
            pheno_device=pheno_device, block=False)
    elif mode == "binary_covar":
        out = binary_covar_analyze_chromosome(
            packed, binary_phenotype, covariate, min_individuals,
            min_haplotypes, maf_threshold, device_matrix=device_matrix,
            return_tables=table_threshold != -1, block=False)
    elif mode == "quantitative":
        out = quantitative_analyze_chromosome(
            packed, quantitative_phenotype, covariate, min_individuals,
            min_haplotypes, maf_threshold, device_matrix=device_matrix,
            return_tables=table_threshold != -1, block=False)
    else:
        from stoat_tpu.pipeline.quantitative import lmm_analyze_chromosome
        out = lmm_analyze_chromosome(
            packed, lmm_ctx, covariate, min_individuals, min_haplotypes,
            maf_threshold, device_matrix=device_matrix,
            return_tables=table_threshold != -1, block=False)
    return flatten_result(out, wide=wide)


def _validate_secondary(secondary: Dict) -> None:
    """Fail fast on a malformed ``secondary`` dict (the documented
    contract in run_vcf_analysis's docstring) instead of crashing with
    ``jnp.asarray(None)`` deep inside a device dispatch."""
    if "mode" not in secondary or "output_tsv" not in secondary:
        raise ValueError(
            "secondary dict must carry 'mode' and 'output_tsv' keys; "
            f"got keys {sorted(secondary)}")
    sec_mode = secondary["mode"]
    pheno_key = {
        "binary": "binary_phenotype",
        "binary_covar": "binary_phenotype",
        "quantitative": "quantitative_phenotype",
        "lmm": "lmm_ctx",
    }.get(sec_mode)
    if pheno_key is None:
        raise ValueError(
            f"secondary mode {sec_mode!r} is not one of binary/"
            "binary_covar/quantitative/lmm")
    if secondary.get(pheno_key) is None:
        raise ValueError(
            f"secondary mode {sec_mode!r} requires a non-None "
            f"{pheno_key!r} entry in the secondary dict")


def _dual_fused_args(packed, device_matrix):
    """True when the fused dual (binary+quantitative) kernel applies:
    the chromosome is in the packed-words layout."""
    if device_matrix is not None:
        import jax.numpy as jnp
        return True if device_matrix.dtype == jnp.uint32 else None
    return True if packed.words is not None else None


def _analyze_dual_fused(packed, binary_phenotype, quantitative_phenotype,
                        min_individuals, min_haplotypes, maf_threshold,
                        device_matrix, pheno_device, covariate=None):
    """One-dispatch binary+quantitative chunk analysis (shared packed
    membership); returns a FlatResult carrying both result sets."""
    import jax.numpy as jnp

    from stoat_tpu.pipeline import packed as _pk
    from stoat_tpu.pipeline.fetch import flatten_result
    from stoat_tpu.pipeline.quantitative import (_fused_dual_analysis,
                                                 _packed_args)

    # one shared upload-arg assembly with the quantitative fused path
    # (quantitative._packed_args); the caller's gating guarantees the
    # packed layout, so args is never None here
    words, idx, valid, sidx, covar_d = _packed_args(
        packed, covariate, device_matrix, force_pack=True)
    with_covar = covariate is not None and covariate.shape[1] > 0
    W = int(words.shape[1])
    if pheno_device is not None:
        g1_words, tail = pheno_device
    else:
        g1_words, tail = _pk.upload_pheno_mask_words(
            binary_phenotype, packed.n_haplotypes, W)
    out = _fused_dual_analysis(
        words, idx, valid, sidx, tail, g1_words, covar_d,
        jnp.asarray(quantitative_phenotype, jnp.float64),
        jnp.float64(min_individuals), jnp.float64(min_haplotypes),
        jnp.float64(maf_threshold),
        n_haplotypes=packed.n_haplotypes, with_covar=with_covar)
    return flatten_result(out, wide=packed.n_haplotypes >= (1 << 16))


def _write_chunk(outf, chrom, packed, res, mode, table_threshold,
                 regression_dir, samples) -> int:
    """Fetch+format+write one chunk's rows (runs on the writer thread)."""
    prof = os.environ.get("STOAT_PROFILE") == "1"
    if prof:
        t0 = time.perf_counter()
        res["filtered" if mode == "binary" else "p"]  # materialize wire
        t1 = time.perf_counter()
    if mode == "binary":
        n = W.write_binary_rows_batch(outf, chrom, packed.snarls, res)
    else:
        n = _write_quant_family(outf, chrom, packed, res, table_threshold,
                                regression_dir, samples,
                                has_r2=mode in ("quantitative", "lmm"))
    if prof:
        t2 = time.perf_counter()
        logger.warning("[prof] %s chunk drain: fetch=%.0fms fmt+write=%.0fms",
                       mode, (t1 - t0) * 1e3, (t2 - t1) * 1e3)
    return n


def _maybe_write_table(res, s, snarl, p_str, table_threshold, regression_dir,
                       samples) -> None:
    """Dump the per-snarl sample×path table for significant hits
    (snarl_analyzer.cpp:418-421; writer.cpp:181-208)."""
    if table_threshold == -1 or not is_pvalue_significant(table_threshold,
                                                          p_str):
        return
    used = res["used"][s]
    kept = res["kept"][s]
    table = res["norm"][s][used][:, kept]
    used_samples = [name for name, u in zip(samples, used) if u]
    out_path = os.path.join(regression_dir,
                            pair_to_string(snarl.snarl_ids) + ".tsv")
    W.write_significant_table(out_path, table, snarl.path_strings,
                              used_samples)


def _write_quant_family(outf, chrom, packed, res, table_threshold,
                        regression_dir, samples, has_r2: bool) -> int:
    """Shared writer for the quantitative-layout modes.

    Fast path: one C++ batch-format call per chunk.  With -T on, the
    per-row loop runs instead (it interleaves significant-table dumps)."""
    if table_threshold == -1:
        return W.write_quant_rows_batch(outf, chrom, packed.snarls, res,
                                        has_r2=has_r2)
    filtered = 0
    for s, snarl in enumerate(packed.snarls):
        if res["filtered"][s]:
            filtered += 1
            continue
        p_str = W.format_p(res["p"][s])
        _maybe_write_table(res, s, snarl, p_str, table_threshold,
                           regression_dir, samples)
        allele_paths = res["allele_paths"][s][: snarl.n_paths]
        if has_r2:
            W.write_quantitative_row(
                outf, chrom, snarl, snarl.type_var_str, p_str,
                W.format_p(res["r2"][s]), W.format_p(res["beta"][s]),
                W.format_p(res["se"][s]), allele_paths)
        else:
            W.write_binary_covar_row(
                outf, chrom, snarl, snarl.type_var_str, p_str,
                W.format_p(res["beta"][s]), W.format_p(res["se"][s]),
                allele_paths)
    return filtered


def _write_eqtl(outf, chrom, packed, gene_list, covariate, min_individuals,
                min_haplotypes, maf_threshold, window, table_threshold,
                regression_dir, samples, device_matrix=None,
                mesh=None) -> int:
    design = eqtl_design_for_chromosome(
        packed, covariate, min_individuals, min_haplotypes, maf_threshold,
        device_matrix=device_matrix)
    filtered_arr = np.asarray(design["filtered"])
    used_arr = np.asarray(design["used"])
    allele_arr = np.asarray(design["allele_paths"])

    pair_snarl: List[int] = []
    pair_gene: List[int] = []
    filtered = 0
    for s, snarl in enumerate(packed.snarls):
        if filtered_arr[s]:
            filtered += 1
            continue
        for g in found_gene_snarl(gene_list, snarl.start_pos, snarl.end_pos,
                                  window):
            pair_snarl.append(s)
            pair_gene.append(g)

    if pair_snarl:
        expr = np.stack([gene_list[g].sample_expression for g in pair_gene])
        if mesh is not None:
            from stoat_tpu.parallel import eqtl_regress_pairs_sharded
            res = eqtl_regress_pairs_sharded(design, np.array(pair_snarl),
                                             expr, mesh)
        else:
            res = eqtl_regress_pairs(design, np.array(pair_snarl), expr)
        for b, (s, g) in enumerate(zip(pair_snarl, pair_gene)):
            snarl = packed.snarls[s]
            p_str = W.format_p(res["p"][b])
            allele_paths = allele_arr[s][: snarl.n_paths]
            W.write_eqtl_row(
                outf, chrom, snarl, snarl.type_var_str,
                gene_list[g].gene_name, p_str, W.format_p(res["r2"][b]),
                W.format_p(res["beta"][b]), W.format_p(res["se"][b]),
                allele_paths)
    return filtered
