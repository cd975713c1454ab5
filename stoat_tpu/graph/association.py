"""Graph-mode association: partition samples by their walks through each
snarl and test partitions against the phenotype.

Re-implementation of the reference's graph pipeline on GFA-embedded paths:
  - PathPartitioner::get_walk_sets (partitioner.cpp:36-268): iteratively
    refine sample sets by the ordered multiset of outgoing edges each
    sample#haplotype path takes from the snarl start bound and — for
    irregular snarls — from every child in both directions.
  - AssociationFinder::test_snarls (graph_path_association_finder.cpp:
    29-199): walk the snarl tree top-down; ``exact`` writes only snarls
    whose partition equals a phenotype set (and stops descending);
    ``chi2`` always writes, testing per-partition case/control counts
    with the batched chi²/Fisher kernels.
  - TSV rows reuse the binary writer with "min,max" snarl lengths as
    PATH_LENGTHS; ``fasta`` mode emits one representative sample sequence
    per partition (writer.cpp:89-178).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from stoat_tpu.graph.gfa import GfaGraph, GfaPath, Handle, flip, load_gfa
from stoat_tpu.graph.snarls import Snarl, SnarlForest, find_snarls
from stoat_tpu.io.phenotype import parse_binary_pheno
from stoat_tpu import writer as W

logger = logging.getLogger("stoat")

__all__ = ["PathPartitioner", "run_graph_association", "test_snarls"]


class PathPartitioner:
    """Walk-set sample partitioning over GFA paths."""

    def __init__(self, g: GfaGraph, paths: Sequence[GfaPath]):
        self.g = g
        # (sample, haplotype) -> list of step lists (one per path)
        self.sample_paths: List[Tuple[Tuple[str, int], List[Handle],
                                      List[int]]] = []
        # node id -> [(path index, step index), ...] built LAZILY: the
        # native partitioner (graph_core) builds its own index, so the
        # Python dict (seconds at 100k-snarl scale) is only paid when the
        # Python refinement actually runs (irregular snarls, TRACE)
        self.__node_steps: Optional[Dict[int,
                                         List[Tuple[int, int]]]] = None
        for pi, p in enumerate(paths):
            offsets = []
            pos = 0
            for step in p.steps:
                offsets.append(pos)
                pos += g.node_length(step[0])
            self.sample_paths.append(((p.sample, p.haplotype), p.steps,
                                      offsets))

    @property
    def _node_steps(self) -> Dict[int, List[Tuple[int, int]]]:
        if self.__node_steps is None:
            index: Dict[int, List[Tuple[int, int]]] = {}
            for pi, (_key, steps, _off) in enumerate(self.sample_paths):
                for si, step in enumerate(steps):
                    index.setdefault(step[0], []).append((pi, si))
            self.__node_steps = index
        return self.__node_steps

    def _outgoing_edge_lists(self, handle: Handle) -> List[Optional[tuple]]:
        """Per sample path: the ordered tuple of edges leaving ``handle``
        (partitioner.cpp:91-198), or None if the path avoids this node."""
        per_path: Dict[int, List[Tuple[int, Tuple[int, bool]]]] = {}
        for pi, i in self._node_steps.get(handle[0], ()):
            _key, steps, offsets = self.sample_paths[pi]
            st = steps[i]
            go_forwards = st[1] == handle[1]
            j = i + 1 if go_forwards else i - 1
            if j < 0 or j >= len(steps):
                continue
            nxt = steps[j]
            per_path.setdefault(pi, []).append(
                (offsets[i], (nxt[0], nxt[1])))
        out: List[Optional[tuple]] = []
        for pi in range(len(self.sample_paths)):
            crossings = per_path.get(pi)
            if crossings:
                crossings.sort(key=lambda x: x[0])
                out.append(tuple(e for _off, e in crossings))
            else:
                out.append(None)
        return out

    def partition_samples_in_snarl(self, forest: SnarlForest,
                                   snarl_idx: int,
                                   regular: bool) -> List[Set[str]]:
        snarl = forest.snarls[snarl_idx]
        n = len(self.sample_paths)
        old_sets = [0] * n
        set_count = 1

        def refine(handle: Handle) -> None:
            nonlocal old_sets, set_count
            edge_lists = self._outgoing_edge_lists(handle)
            inter: Dict[tuple, int] = {}
            inter_sets = [0] * n
            next_inter = 1
            for i, el in enumerate(edge_lists):
                if el is None:
                    continue
                if el not in inter:
                    inter[el] = next_inter
                    next_inter += 1
                inter_sets[i] = inter[el]
            mapping: Dict[Tuple[int, int], int] = {(0, 0): 0}
            new_count = 1
            new_sets = [0] * n
            for i in range(n):
                key = (old_sets[i], inter_sets[i])
                if key not in mapping:
                    mapping[key] = new_count
                    new_count += 1
                new_sets[i] = mapping[key]
            old_sets = new_sets
            set_count = new_count

        refine(snarl.start)

        if not regular:
            # every child unit, both directions
            view_children = self._child_handles(forest, snarl_idx)
            for h in view_children:
                refine(h)

        sets: List[Set[str]] = [set() for _ in range(set_count - 1)]
        for i, (key, _steps, _off) in enumerate(self.sample_paths):
            if old_sets[i] != 0:
                sets[old_sets[i] - 1].add(key[0])
        return [s for s in sets if s]

    def _child_handles(self, forest: SnarlForest,
                       snarl_idx: int) -> List[Handle]:
        snarl = forest.snarls[snarl_idx]
        hidden: Set[int] = set()
        chain_handles: List[Handle] = []
        for chain in forest.chains_of_parent(snarl_idx):
            first = forest.snarls[chain[0]]
            last = forest.snarls[chain[-1]]
            for si in chain:
                s = forest.snarls[si]
                hidden |= set(s.interior_nodes)
                hidden.add(s.start_node)
                hidden.add(s.end_node)
            chain_handles.append(last.end)            # rightward
            chain_handles.append(flip(first.start))   # leftward
        handles: List[Handle] = []
        for nid in sorted(set(snarl.interior_nodes) - hidden):
            handles.append((nid, False))
            handles.append((nid, True))
        handles.extend(chain_handles)
        return handles


class _NativePartitions:
    """Per-snarl walk-set partition counts from the native core.

    Precomputes the start-bound refinement for EVERY snarl in one
    parallel native pass (graph_core.cpp stoat_graph_partitions) — the
    graph-mode hot loop that is otherwise a per-snarl Python walk.
    Valid exactly for REGULAR snarls (start-edge refinement only);
    irregular snarls fall back to the Python partitioner."""

    def __init__(self, forest: SnarlForest, partitioner: PathPartitioner,
                 case_set: Set[str], control_set: Set[str]):
        from stoat_tpu.native import graph_partitions_native

        names = sorted({key[0] for key, _s, _o in
                        partitioner.sample_paths})
        name_to_id = {n: i for i, n in enumerate(names)}
        steps: List[int] = []
        offsets = [0]
        path_sample = []
        for key, psteps, _off in partitioner.sample_paths:
            steps.extend((st[0] << 1) | int(st[1]) for st in psteps)
            offsets.append(len(steps))
            path_sample.append(name_to_id[key[0]])
        starts = np.array([(s.start[0] << 1) | int(s.start[1])
                           for s in forest.snarls], np.uint64)
        sample_case = np.array([n in case_set for n in names], np.uint8)
        got = graph_partitions_native(
            np.array(steps, np.uint64), np.array(offsets, np.int64),
            np.array(path_sample, np.int32), len(names), starts,
            sample_case)
        if got is None:
            raise RuntimeError("native graph core unavailable")
        self.offs, self.n_case, self.n_ctrl, self.rep = got
        self.names = names
        self.n_case_total = sum(1 for n in names if n in case_set)
        self.n_ctrl_total = len(names) - self.n_case_total

    def counts(self, snarl_idx: int):
        """[(n_in_case, n_in_control, rep_sample_name), ...] in the
        Python partitioner's set order."""
        lo, hi = int(self.offs[snarl_idx]), int(self.offs[snarl_idx + 1])
        return [(int(self.n_case[i]), int(self.n_ctrl[i]),
                 self.names[int(self.rep[i])]) for i in range(lo, hi)]


def _is_regular_snarl(g: GfaGraph, forest: SnarlForest,
                      snarl_idx: int) -> bool:
    """Heuristic mirror of bdsg's is_regular_snarl: every interior node
    connects only the start bound to the end bound, forward-only."""
    snarl = forest.snarls[snarl_idx]
    if forest.snarls[snarl_idx].children:
        return False
    bounds = {snarl.start_node, snarl.end_node}
    for nid in snarl.interior_nodes:
        for orient in (False, True):
            for nxt in g.successors((nid, orient)):
                if nxt[0] not in bounds and nxt[0] not in snarl.interior_nodes:
                    return False
                if nxt[0] in snarl.interior_nodes:
                    return False  # child-child edge -> irregular
    # reversals at the bounds make a snarl irregular
    for h in (snarl.start, flip(snarl.end)):
        for nxt in g.successors(h):
            if nxt[0] == h[0]:
                return False
    return True


def _snarl_min_max_len(g: GfaGraph, forest: SnarlForest,
                       snarl_idx: int) -> Tuple[int, int]:
    """Min/max interior sequence length over SIMPLE start→end traversals.

    Matches SnarlDistanceIndex::{minimum,maximum}_length semantics (the
    reference prints these as PATH_LENGTHS, graph_path_association_finder
    .cpp:63-71): boundary nodes excluded, loops not unrolled — pinned by
    graph_simu_test.cpp (loop_with_indel 6_1 -> "3,4")."""
    snarl = forest.snarls[snarl_idx]
    interior = snarl.interior_nodes
    end_node = snarl.end_node
    best_min, best_max = None, None
    budget = 200000
    stack = [(snarl.start, frozenset(), 0)]
    while stack and budget > 0:
        budget -= 1
        h, visited, total = stack.pop()
        for v in g.successors(h):
            if v[0] == end_node:
                best_min = total if best_min is None else min(best_min,
                                                              total)
                best_max = total if best_max is None else max(best_max,
                                                              total)
            elif v[0] in interior and v[0] not in visited:
                stack.append((v, visited | {v[0]},
                              total + g.node_length(v[0])))
    if best_min is None:
        return 0, 0
    return best_min, best_max


def test_snarls(g: GfaGraph, forest: SnarlForest,
                partitioner: PathPartitioner,
                case_set: Set[str], control_set: Set[str],
                test_method: str, output_format: str,
                allele_size_limit: int, reference_sample: str,
                out_fh) -> int:
    """Walk the snarl tree and run the association tests.  Returns the
    number of snarls written."""
    from stoat_tpu.stats import chi2_2x2, chi2_2xn, fisher_exact_2x2
    from stoat_tpu.io.snarl_file import SnarlData
    from stoat_tpu.graph.decompose import _reference_offsets

    if output_format == "tsv":
        W.write_binary_header(out_fh)

    ref_names = {reference_sample} if reference_sample else set()
    ref_offsets = _reference_offsets(g, ref_names)

    def coordinates(snarl: Snarl) -> Tuple[str, int, int]:
        for chrom, offs in ref_offsets.items():
            if snarl.start_node in offs and snarl.end_node in offs:
                a = offs[snarl.start_node]
                b = offs[snarl.end_node]
                if a > b:
                    a, b = b, a
                    first, last = snarl.end_node, snarl.start_node
                else:
                    first, last = snarl.start_node, snarl.end_node
                return chrom, a + g.node_length(first), b
        return "NA", 0, 0

    # Collect candidate snarls in tree order (stack of top-levels and
    # conditional descent, graph_path_association_finder.cpp:37-50).
    pending: List[Tuple[str, object]] = []  # ("write_test", data)
    n_written = 0
    stack = sorted(forest.top_level(), reverse=True)
    rows = []
    from stoat_tpu.logsetup import TRACE
    # One parallel native pass computes every regular snarl's walk-set
    # partition counts up front (the per-snarl Python refinement was the
    # graph-mode hot loop: 11x slower than one C++ core at 100k snarls —
    # measured).  TRACE keeps the Python path (it dumps the full sets).
    native_parts = None
    if not logger.isEnabledFor(TRACE) and forest.snarls:
        try:
            native_parts = _NativePartitions(forest, partitioner,
                                             case_set, control_set)
        except (RuntimeError, OSError, ImportError) as e:
            logger.debug("native partitioner unavailable (%s)", e)
    while stack:
        i = stack.pop()
        snarl = forest.snarls[i]
        mn, mx = _snarl_min_max_len(g, forest, i)
        if mx < allele_size_limit:
            continue
        path_lengths = f"{mn},{mx}"
        regular = _is_regular_snarl(g, forest, i)
        if native_parts is not None and regular:
            # (n_in_case, n_in_control, representative sample)
            parts = native_parts.counts(i)
        else:
            partitions = partitioner.partition_samples_in_snarl(
                forest, i, regular)
            # trace-level partition dump (graph_path_association_finder
            # .cpp:55,80-95 logs the same shape at LOG_TRACE)
            if logger.isEnabledFor(TRACE):
                logger.trace("Test snarl %s", snarl.id_str)
                for part in partitions:
                    logger.trace("\tPARTITION")
                    for sample in sorted(part):
                        logger.trace("\t\t%s", sample)
            parts = [(sum(1 for s in p if s in case_set),
                      sum(1 for s in p if s in control_set),
                      sorted(p)[0]) for p in partitions]
        descend = True
        if len(parts) > 1:
            if test_method == "exact":
                samples_to_write: Dict[str, bool] = {}
                matched = False
                for nc, nt, rep in parts:
                    # partition == case/control set <=> it contains every
                    # member of that set and nothing else (partitions only
                    # hold phenotype samples)
                    hit = ((nt == 0 and nc == len(case_set)) or
                           (nc == 0 and nt == len(control_set)))
                    if hit:
                        matched = True
                        descend = False
                        if output_format == "fasta":
                            samples_to_write[rep] = True
                    elif output_format == "fasta":
                        samples_to_write[rep] = False
                if matched:
                    if output_format == "tsv":
                        chrom, a, b = coordinates(snarl)
                        rows.append((chrom, a, b, snarl.id_str,
                                     path_lengths, None, None, "NA",
                                     snarl.depth))
                    else:
                        _write_fasta_partitions(
                            g, forest, i, samples_to_write, out_fh,
                            partitioner, reference_sample)
                    n_written += 1
            else:
                g0 = [nc for nc, _nt, _r in parts]
                g1 = [nt for _nc, nt, _r in parts]
                chrom, a, b = coordinates(snarl)
                group_paths = W.format_group_paths(g0, g1)
                rows.append((chrom, a, b, snarl.id_str, path_lengths,
                             (tuple(g0), tuple(g1)), None, group_paths,
                             snarl.depth))
                n_written += 1
                if output_format == "fasta":
                    samples_to_write = {rep: True
                                        for _nc, _nt, rep in parts}
                    _write_fasta_partitions(g, forest, i, samples_to_write,
                                            out_fh, partitioner,
                                            reference_sample)
        if descend:
            for c in sorted(snarl.children, reverse=True):
                stack.append(c)

    # Batch the statistical tests on device (chi2/Fisher kernels).  Both
    # axes pad to powers of two, which keeps the set of compiled shapes
    # small; the persistent compilation cache (jaxconfig) then serves
    # each shape across runs.
    if output_format == "tsv":
        tested = [r for r in rows if r[5] is not None]
        if tested:
            from stoat_tpu.tables import next_pow2
            Pmax = next_pow2(max(2, max(len(r[5][0]) for r in tested)))
            B = len(tested)
            B_pad = next_pow2(B)
            G0 = np.zeros((B_pad, Pmax))
            G1 = np.zeros((B_pad, Pmax))
            mask = np.zeros((B_pad, Pmax), bool)
            for bi, r in enumerate(tested):
                k = len(r[5][0])
                G0[bi, :k] = r[5][0]
                G1[bi, :k] = r[5][1]
                mask[bi, :k] = True
            k_arr = mask.sum(axis=1)
            p22 = np.asarray(chi2_2x2(G0[:, 0], G0[:, 1], G1[:, 0],
                                      G1[:, 1]))[:B]
            pf = np.asarray(fisher_exact_2x2(G0[:, 0], G0[:, 1], G1[:, 0],
                                             G1[:, 1]))[:B]
            pn = np.asarray(chi2_2xn(G0, G1, mask))[:B]
            ti = 0
            for r in rows:
                chrom, a, b, sid, pl, counts, _pf, gp, depth = r
                if counts is None:
                    out_fh.write(f"{chrom}\t{a}\t{b}\t{sid}\t{pl}\tNA\tNA\t"
                                 f"{gp}\t{depth}\n")
                    continue
                if k_arr[ti] == 2:
                    chi_s, fis_s = W.format_p(p22[ti]), W.format_p(pf[ti])
                else:
                    chi_s, fis_s = W.format_p(pn[ti]), "NA"
                out_fh.write(f"{chrom}\t{a}\t{b}\t{sid}\t{pl}\t{fis_s}\t"
                             f"{chi_s}\t{gp}\t{depth}\n")
                ti += 1
        else:
            for r in rows:
                chrom, a, b, sid, pl, _c, _f, gp, depth = r
                out_fh.write(f"{chrom}\t{a}\t{b}\t{sid}\t{pl}\tNA\tNA\t"
                             f"{gp}\t{depth}\n")
    return n_written


def _write_fasta_partitions(g: GfaGraph, forest: SnarlForest, snarl_idx: int,
                            samples_to_write: Dict[str, bool], out_fh,
                            partitioner: PathPartitioner,
                            reference_sample: str = "") -> None:
    """FASTA output: the sequence each chosen sample takes through the
    snarl, headers ``>snarl:a-b|<ref range>|<sample range>``
    (writer.cpp:89-178)."""
    snarl = forest.snarls[snarl_idx]
    name = f"snarl:{snarl.start_node}-{snarl.end_node}"
    bounds = {snarl.start_node, snarl.end_node}
    interior = snarl.interior_nodes

    def traversals(steps):
        """All [i, j] step pairs where a path crosses the snarl: both ends
        on boundary nodes (either direction), every step between strictly
        interior.  A sample looping back through the snarl yields one
        record per crossing (graph_simu_test.cpp:393-410 pins two records
        for path1 through loop_with_indel's 2-4)."""
        idxs = [i for i, st in enumerate(steps) if st[0] in bounds]
        for i, j in zip(idxs, idxs[1:]):
            if all(steps[k][0] in interior for k in range(i + 1, j)):
                yield i, j

    # reference range through the snarl ("NOREF:?:?" when absent,
    # writer.cpp:106)
    ref_coordinates = "NOREF:?:?"
    for path in g.paths:
        if reference_sample and path.sample != reference_sample and \
                path.name != reference_sample:
            continue
        if not reference_sample and not path.is_reference:
            continue
        pos = 0
        offs = []
        for st in path.steps:
            offs.append(pos)
            pos += g.node_length(st[0])
        for si, ei in traversals(path.steps):
            start_off = offs[si] + g.node_length(path.steps[si][0])
            ref_coordinates = f"{path.name}:{start_off}-{offs[ei]}"
            break
        if ref_coordinates != "NOREF:?:?":
            break

    for key, steps, offsets in partitioner.sample_paths:
        sample = key[0]
        if samples_to_write and sample not in samples_to_write:
            continue
        for si, ei in traversals(steps):
            seq = "".join(g.node_seq(steps[i]) for i in range(si + 1, ei))
            start_off = offsets[si] + g.node_length(steps[si][0])
            end_off = offsets[ei]
            out_fh.write(f">{name}|{ref_coordinates}|"
                         f"{sample}:{start_off}-{end_off}\n")
            for i in range(0, len(seq), 80):
                out_fh.write(seq[i:i + 80] + "\n")
            if len(seq) == 0:
                out_fh.write("\n")


_GRAPH_STATS_CACHE: Dict[str, object] = {}


def _graph_stats_fused(G0, G1, mask):
    """chi² 2×2 + Fisher + chi² 2×N in one jitted device dispatch
    (compiled once per shape via the module cache)."""
    import jax

    fn = _GRAPH_STATS_CACHE.get("fn")
    if fn is None:
        from stoat_tpu.stats import chi2_2x2, chi2_2xn, fisher_exact_2x2

        @jax.jit
        def fn(G0d, G1d, maskd):
            return (chi2_2x2(G0d[:, 0], G0d[:, 1], G1d[:, 0], G1d[:, 1]),
                    fisher_exact_2x2(G0d[:, 0], G0d[:, 1], G1d[:, 0],
                                     G1d[:, 1]),
                    chi2_2xn(G0d, G1d, maskd))

        _GRAPH_STATS_CACHE["fn"] = fn
    return fn(G0, G1, mask)


def _batch_test_and_write(blob, kinds, part_offs, g0, g1, out_fh) -> None:
    """Device-batched chi²/Fisher over the native prepare's partition
    counts + row splice-and-write (the tail of test_snarls' TSV path,
    byte-identical)."""
    from stoat_tpu.stats import chi2_2x2, chi2_2xn, fisher_exact_2x2
    from stoat_tpu.tables import next_pow2

    n_rows = len(kinds)
    tested = np.flatnonzero(kinds == 1)
    B = len(tested)
    p22 = pf = pn = np.zeros(0)
    k_arr = np.zeros(0, np.int64)
    if B:
        # ragged -> padded [B, Pmax] via one vectorized scatter
        lo = part_offs[tested]
        hi = part_offs[tested + 1]
        k_arr = hi - lo
        Pmax = next_pow2(max(2, int(k_arr.max())))
        B_pad = next_pow2(B)
        # counts are per-partition sample tallies: ship the smallest
        # sufficient dtype up the (bandwidth-bound) device link; the
        # kernels promote to f64 on device
        big = max(int(g0.max(initial=0)), int(g1.max(initial=0))) >= 65536
        dt = np.int64 if big else np.uint16
        G0 = np.zeros((B_pad, Pmax), dt)
        G1 = np.zeros((B_pad, Pmax), dt)
        mask = np.zeros((B_pad, Pmax), bool)
        col = np.arange(Pmax)
        mask[:B] = col[None, :] < k_arr[:, None]
        flat_src = (lo[:, None] + col[None, :])[mask[:B]]
        G0[:B][mask[:B]] = g0[flat_src]
        G1[:B][mask[:B]] = g1[flat_src]
        # ONE device dispatch for all three statistics + overlapped
        # fetches
        outs = _graph_stats_fused(G0, G1, mask)
        for o in outs:
            copy = getattr(o, "copy_to_host_async", None)
            if copy is not None:
                copy()
        p22, pf, pn = (np.asarray(o)[:B] for o in outs)
    from stoat_tpu.native import graph_format_rows_native
    text = graph_format_rows_native(blob, kinds, p22, pf, pn,
                                    (k_arr == 2).astype(np.uint8))
    if text is not None:
        out_fh.write(text.decode())
        return
    rows = blob.split(b"\0")[:n_rows]
    ti = 0
    for i, row in enumerate(rows):
        if kinds[i] == 0:
            out_fh.write(row.decode() + "\n")
            continue
        prefix, suffix = row.split(b"\x01", 1)
        if k_arr[ti] == 2:
            chi_s, fis_s = W.format_p(p22[ti]), W.format_p(pf[ti])
        else:
            chi_s, fis_s = W.format_p(pn[ti]), "NA"
        out_fh.write(f"{prefix.decode()}\t{fis_s}\t{chi_s}\t"
                     f"{suffix.decode()}\n")
        ti += 1


def _run_graph_association_native(graph_path: str, fmt: str,
                                  binary_path: str, test_method: str,
                                  output_format: str,
                                  allele_size_limit: int,
                                  reference_sample: str,
                                  output_dir: str) -> Optional[int]:
    """The production `stoat graph` fast path: one native call does the
    snarl finding + partitioning + tree walk (graph_core.cpp
    stoat_graph_assoc / stoat_graph_assoc_mem).  GFA graphs load inside
    the native core; the reference's binary containers (.hg/.pg/.gbz,
    loaded by VPKG at graph.cpp:217-224) decode through the Python
    format readers and hand the graph over as flat arrays.  TSV rows
    get the device-batched chi²/Fisher splice; FASTA text comes back
    complete from the native walk.  Returns None when the native core
    is unavailable (caller falls back to the Python path)."""
    from stoat_tpu.native import graph_assoc_mem_native, graph_assoc_native

    samples: List[str] = []
    pheno, samples = parse_binary_pheno(binary_path, samples)
    refs = {reference_sample} if reference_sample else None
    if fmt == "gfa":
        got = graph_assoc_native(graph_path, refs, samples,
                                 pheno.astype(np.uint8), test_method,
                                 allele_size_limit,
                                 output_format=output_format)
    elif fmt in ("hg", "pg", "gbz"):
        from stoat_tpu.graph.formats import load_graph
        g = load_graph(graph_path, refs)
        got = graph_assoc_mem_native(g, refs, samples,
                                     pheno.astype(np.uint8), test_method,
                                     allele_size_limit,
                                     output_format=output_format)
    else:
        return None
    if got is None:
        return None
    blob, kinds, part_offs, g0, g1, n_snarls = got
    if output_format == "fasta":
        out_path = os.path.join(output_dir, "binary_output.fasta")
        with open(out_path, "wb") as fh:
            fh.write(blob)
        logger.info("Wrote FASTA for %d snarls to %s", n_snarls, out_path)
        return 0
    out_path = os.path.join(output_dir, "binary_table_graph.tsv")
    with open(out_path, "w") as fh:
        W.write_binary_header(fh)
        _batch_test_and_write(blob, kinds, part_offs, g0, g1, fh)
    logger.info("Wrote %d snarls to %s", len(kinds), out_path)
    return 0


def run_graph_association(graph_path: str, dist_path: str, binary_path: str,
                          test_method: str, output_format: str,
                          allele_size_limit: int, reference_sample: str,
                          output_dir: str) -> int:
    """CLI entry for ``stoat graph`` (graph.cpp:52-290)."""
    from stoat_tpu.graph.formats import sniff_graph_format
    from stoat_tpu.logsetup import TRACE
    if dist_path:
        logger.warning(
            "-d/--dist: the SnarlDistanceIndex file %s is accepted for "
            "stoat interface parity but NOT read — the snarl tree is "
            "recomputed from the graph itself (snarl ids may differ in "
            "orientation from the reference's .dist-derived ids; see "
            "DESIGN.md §7).", dist_path)
    if (not logger.isEnabledFor(TRACE)
            and os.environ.get("STOAT_GRAPH_PYTHON") != "1"):
        try:
            res = _run_graph_association_native(
                graph_path, sniff_graph_format(graph_path), binary_path,
                test_method, output_format, allele_size_limit,
                reference_sample, output_dir)
        except RuntimeError as e:
            if "No graph paths" in str(e):   # graph.cpp-style soft error
                logger.error("%s", e)
                return 1
            raise SystemExit(str(e))
        if res is not None:
            return res
        logger.debug("native graph core unavailable; Python path")
    refs = {reference_sample} if reference_sample else None
    # format detected by content, like the reference's VPKG dispatch
    # (register_io.cpp:20-26; graph/formats.py)
    from stoat_tpu.graph.formats import load_graph
    try:
        g = load_graph(graph_path, refs)
    except RuntimeError as e:
        raise SystemExit(str(e))
    forest = find_snarls(g)

    samples: List[str] = []
    pheno, samples = parse_binary_pheno(binary_path, samples)
    case_set = {s for s, v in zip(samples, pheno) if v}
    control_set = {s for s, v in zip(samples, pheno) if not v}

    wanted = case_set | control_set
    sample_paths = [p for p in g.paths if p.sample in wanted]
    if not sample_paths:
        logger.error("No graph paths match the phenotype samples")
        return 1
    partitioner = PathPartitioner(g, sample_paths)

    # Contract filenames (graph_simu_test.cpp:38,72)
    out_name = ("binary_table_graph.tsv" if output_format == "tsv"
                else "binary_output.fasta")
    out_path = os.path.join(output_dir, out_name)
    with open(out_path, "w") as fh:
        n = test_snarls(g, forest, partitioner, case_set, control_set,
                        test_method, output_format, allele_size_limit,
                        reference_sample, fh)
    logger.info("Wrote %d snarls to %s", n, out_path)
    return 0
