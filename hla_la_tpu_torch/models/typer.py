"""HLA typing engine (reference L4: hla/HLATyper.{h,cpp}, 4,512 LoC).

Pipeline per locus (HLATyper::HLATypeInference, HLATyper.cpp:933-2810):
  1. load + combine exon allele matrices, cluster identical exon sequences;
  2. convert read alignments to exon-position pileups (oneExonPosition);
  3. read/allele filters (strand, insert size, mapQ, weightedOK, filterFirst20,
     high-coverage and strand-bias allele filters);
  4. per-cluster x per-read log-likelihoods — lowered to ONE matmul over
     one-hot channel encodings (ops/pair_ll.cluster_read_ll);
  5. diploid pair likelihoods over all cluster pairs — the O(C^2 R) reduction
     (ops/pair_ll.pair_ll_reduction; kernel K3 on the card);
  6. posteriors -> bestGuess alleles (marginal for allele 1, conditional for
     allele 2 with min-mismatch tie-break);
  7. QC columns + G-group translation + output files
     (R1_bestguess.txt, R1_bestguess_G.txt, R1_PP_<locus>_pairs.txt,
      R1_columnIncompatibilities_<locus>.txt, R1_pileup_<locus>.txt,
      R1_readIDs_<locus>.txt, histogram_matchesPerRead.txt,
      summaryStatistics.txt, R1_parameters.txt).

The counterpart of ``hla_la_tpu/models/typer.py`` with one explicit
``device`` in place of its ``backend`` switch: steps 4 and 5 always take
the dense one-hot products and the pair reduction on that device (the
reference's sparse-delta host form of step 4 is not on this path).  Loci are
typed serially, or fanned out over worker processes that each run the same
``_type_locus`` on that device (``type_all(n_workers=, worker_pool=)``); with
a mesh (``sharded=``) the pair reduction is split over its ranks.
"""

from __future__ import annotations

import math
import os
import sys
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..graph.package import GraphPackage
from ..io.fastq import FastqRead
from ..ops.pair_ll import (cluster_onehot, cluster_read_ll,
                           pair_ll_reduction, pair_min_mismatch_row, CH_GAP,
                           CH_OTHER)
from ..sim.read_sim import revcomp
from ..utils.config import LOCI_2_EXONS, LOCI_FOR_TYPING, TyperConfig
from ..utils.phred import phred_to_p_correct_table
from ..utils.timing import log_progress
from .aligner import AlignedPair
from .alignment import (GraphAlignment, alignment_fraction_ok,
                        alignment_weighted_ok_fraction, fraction_ok_batch,
                        pair_distance_graph_levels, strands_valid,
                        weighted_ok_fractions_batch)

GAP = ord("_")
_BASE_CH = {"A": 0, "C": 1, "G": 2, "T": 3}


class _AsyncOutput:
    """Deferred writes for the big per-locus text artifacts (pileup, PP
    pairs dump — ~180 MB + ~120 MB per locus at IMGT scale): the build/
    write runs on a background thread and overlaps the GIL-releasing
    native pair reduction and BLAS phases of the same/next locus.  All
    threads are joined (and the first error re-raised, fail-loud) at
    flush(), called before type_all returns — output bytes are identical
    to the inline path."""

    def __init__(self, max_pending: int = 4):
        self._threads: list[threading.Thread] = []
        self._errors: list[BaseException] = []
        self._max = max_pending

    def submit(self, fn):
        if len(self._threads) >= self._max:   # bound buffered-body RSS
            self._threads.pop(0).join()

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in flush
                self._errors.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._threads.append(t)

    def flush(self, raising: bool = True):
        """Join all writers.  Re-raises the first deferred write error
        unless ``raising=False`` — callers in a ``finally`` with a primary
        exception already propagating pass False so the flush error is
        logged instead of masking the original failure."""
        while self._threads:
            self._threads.pop(0).join()
        if self._errors:
            if raising:
                raise self._errors[0]
            log_progress(f"WARNING deferred output write failed during "
                         f"error unwind: {self._errors[0]!r}")


@dataclass(slots=True)
class ExonObs:
    """oneExonPosition equivalent (hla/oneExonPosition.h:15-46)."""
    graph_level: int
    position_in_exon: int
    genotype: str            # '_' or one-or-more bases (insertions appended)
    qualities: bytes
    mapq: float
    mapq_position: float
    read_id: str
    paired_read_id: str
    this_weighted_ok: float
    paired_weighted_ok: float
    pairs_strands_distance: float
    alignment_cols_nongap: int
    running_novel_gap: int
    reverse: bool
    from_first_read: bool


class _ObsSoA:
    """Flat struct-of-arrays view over a locus's per-read observation
    lists: built in ONE pass, after which every per-obs filter/count
    (filterFirst20, allele filters, the used-observation gate, tensor
    build, column QC) runs vectorised instead of re-walking ExonObs
    objects (the reference walks its oneExonPosition vectors per filter,
    HLATyper.cpp:1403-1880)."""
    __slots__ = ("flat", "read_idx", "pos", "gid", "keys", "mqp", "w",
                 "wok", "rev", "ffr", "q0", "run_novel", "name_id",
                 "genotypes", "geno_ids", "names", "name_ids", "n_reads",
                 "n_obs", "G",
                 # array-built (vectorised) extras; None on the legacy path
                 "qid", "quals", "mate_id", "read_mate0",
                 "m_name", "m_pname", "m_mapq", "m_wok_this", "m_wok_paired",
                 "m_dist", "m_colsng")

    def __init__(self, reads_obs: list[list[ExonObs]]):
        self.qid = self.quals = self.mate_id = self.read_mate0 = None
        self.m_name = self.m_pname = self.m_mapq = None
        self.m_wok_this = self.m_wok_paired = None
        self.m_dist = self.m_colsng = None
        geno_ids: dict[str, int] = {}
        name_ids: dict[str, int] = {}
        gsd, nsd = geno_ids.setdefault, name_ids.setdefault
        flat: list[ExonObs] = []
        read_idx: list[int] = []
        pos: list[int] = []
        gid: list[int] = []
        nid: list[int] = []
        mqp: list[float] = []
        w: list[float] = []
        wok: list[float] = []
        rev: list[bool] = []
        ffr: list[bool] = []
        q0: list[int] = []
        rnov: list[int] = []
        for ri, obs in enumerate(reads_obs):
            flat.extend(obs)
            read_idx.extend([ri] * len(obs))
            for o in obs:
                pos.append(o.position_in_exon)
                gid.append(gsd(o.genotype, len(geno_ids)))
                nid.append(nsd(o.read_id, len(name_ids)))
                mqp.append(o.mapq_position)
                tw = o.this_weighted_ok
                w.append((tw + o.paired_weighted_ok) / 2.0)
                wok.append(tw)
                rev.append(o.reverse)
                ffr.append(o.from_first_read)
                q = o.qualities
                q0.append(q[0] if q else 0)
                rnov.append(o.running_novel_gap)
        self.flat = flat
        self.read_idx = np.asarray(read_idx, dtype=np.int64)
        self.pos = np.asarray(pos, dtype=np.int64)
        self.gid = np.asarray(gid, dtype=np.int64)
        self.name_id = np.asarray(nid, dtype=np.int64)
        self.mqp = np.asarray(mqp, dtype=np.float64)
        self.w = np.asarray(w, dtype=np.float64)
        self.wok = np.asarray(wok, dtype=np.float64)
        self.rev = np.asarray(rev, dtype=bool)
        self.ffr = np.asarray(ffr, dtype=bool)
        self.q0 = np.asarray(q0, dtype=np.int64)
        self.run_novel = np.asarray(rnov, dtype=np.int64)
        self.genotypes = list(geno_ids)
        self.geno_ids = geno_ids
        self.names = list(name_ids)
        self.name_ids = name_ids
        self.n_reads = len(reads_obs)
        self.n_obs = len(flat)
        self.G = max(len(geno_ids), 1)
        self.keys = self.pos * self.G + self.gid

    @classmethod
    def from_arrays(cls, *, read_idx, pos, gid, qid, name_id, mqp, w, wok,
                    rev, ffr, q0, run_novel, mate_id, read_mate0,
                    genotypes, geno_ids, quals, names, name_ids,
                    m_name, m_pname, m_mapq, m_wok_this, m_wok_paired,
                    m_dist, m_colsng, n_reads):
        """Vectorised construction: every column arrives as a ready array
        (assembled by HLATyper._collect_locus_obs from cached chain
        records) — no ExonObs objects exist on this path.  `flat` is None;
        per-obs strings resolve via `genotypes[gid]` / `quals[qid]` and the
        mate tables (`mate_id` indexes m_*)."""
        self = cls.__new__(cls)
        self.flat = None
        self.read_idx = read_idx
        self.pos = pos
        self.gid = gid
        self.qid = qid
        self.name_id = name_id
        self.mqp = mqp
        self.w = w
        self.wok = wok
        self.rev = rev
        self.ffr = ffr
        self.q0 = q0
        self.run_novel = run_novel
        self.mate_id = mate_id
        self.read_mate0 = read_mate0
        self.genotypes = genotypes
        self.geno_ids = geno_ids
        self.quals = quals
        self.names = names
        self.name_ids = name_ids
        self.m_name = m_name
        self.m_pname = m_pname
        self.m_mapq = m_mapq
        self.m_wok_this = m_wok_this
        self.m_wok_paired = m_wok_paired
        self.m_dist = m_dist
        self.m_colsng = m_colsng
        self.n_reads = n_reads
        self.n_obs = len(pos)
        self.G = max(len(genotypes), 1)
        self.keys = self.pos * self.G + self.gid
        return self

    def ignored_key_array(self, ignore_alleles: dict[int, set[str]]):
        """(pos, genotype) pairs of `ignore_alleles` as sorted int keys
        (only interned genotypes can match an observation)."""
        gi = self.geno_ids
        G = self.G
        # gi may be the run-global (live) table: ids >= G were interned
        # after this locus's SoA and can never match an obs key (and would
        # collide with other positions' key ranges) — skip them
        ks = [p * G + i
              for p, gs in ignore_alleles.items()
              for i in (gi[g] for g in gs if g in gi) if i < G]
        if not ks:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.asarray(ks, dtype=np.int64))

    def ignored_name_id_array(self, ignore_read_ids: set[str]):
        ni = self.name_ids
        ids = [ni[n] for n in ignore_read_ids if n in ni]
        if not ids:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.asarray(ids, dtype=np.int64))

    def base_used_mask(self, ignore_read_ids, ignore_alleles, minq):
        """Observations passing the mapQ/allele/read gates (the obs_used
        predicate minus the long-read novel-gap clause)."""
        m = self.mqp >= minq
        ik = self.ignored_key_array(ignore_alleles)
        if ik.size:
            m &= ~np.isin(self.keys, ik)
        inid = self.ignored_name_id_array(ignore_read_ids)
        if inid.size:
            m &= ~np.isin(self.name_id, inid)
        return m


@dataclass
class LocusResult:
    locus: str
    allele1_id: str
    allele2_id: str
    q1_allele1: float
    q1_allele2: float
    q2: float
    allele1_g: str = ""
    allele2_g: str = ""
    g1_perfect: bool = True
    g2_perfect: bool = True
    avg_coverage: float = 0.0
    first_decile_coverage: float = 0.0
    min_coverage: float = 0.0
    prop_kmers_covered_1: float = -1.0
    prop_kmers_covered_2: float = -1.0
    avg_column_error: float = 0.0
    n_columns_unaccounted: int = 0
    n_clusters: int = 0
    n_reads_used: int = 0

    def alleles_g_or_raw(self) -> tuple[str, str]:
        return (self.allele1_g or self.allele1_id,
                self.allele2_g or self.allele2_id)


class HLATyper:
    def __init__(self, pkg: GraphPackage, cfg: TyperConfig | None = None,
                 g_nomenclature_path: str | None = None, *,
                 device: str | torch.device, sharded=None):
        self.pkg = pkg
        self.cfg = cfg or TyperConfig()
        self.device = resolve(device)
        self.sharded = sharded      # a parallel.mesh.Mesh or None
        # K3 launches made by typing workers for this typer, by kernel
        self.worker_launches = {"K3": 0}
        self.segment_files = pkg.segment_files()
        self.graph_genes = self._discover_genes()
        # gene-segment columns only, not the full 3M-entry map of a
        # real-PRG-scale package
        gene_segs = [fn for fn in self.segment_files
                     if len(fn.split("_")) >= 6 and fn.split("_")[1] == "gene"]
        self.locus_to_level = pkg.segment_levels(gene_segs)
        self.loci = [l for l in LOCI_FOR_TYPING if l in self.graph_genes]
        self.g_path = g_nomenclature_path
        self._alleles_to_g: dict[str, str] | None = None
        self._g_loci: set[str] = set()
        # run-global intern tables for observation genotype strings and
        # quality bytes: chain records carry integer ids so per-locus
        # observation SoAs assemble as pure array concatenation (no
        # per-observation Python objects on the hot path)
        self._geno_ids: dict[str, int] = {}
        self._geno_list: list[str] = []
        self._qual_ids: dict[bytes, int] = {}
        self._qual_list: list[bytes] = []
        # persistent single-char/byte intern luts (byte value -> table id),
        # filled lazily, instead of a per-chain re-derivation (np.unique +
        # a python loop, twice per chain)
        self._lut_g = np.full(256, -1, dtype=np.int64)
        self._lut_q = np.full(256, -1, dtype=np.int64)
        self._qid_empty = -1            # id of b"" once interned
        self._intern_token = object()   # invalidates _records caches that
        # were interned against a different typer's tables
        # reusable f32 scratch for the per-locus likelihood tensors, in
        # place of fresh 100MB+ allocations per locus/chunk (one pool per
        # typing process)
        self._scratch_bufs: dict[str, np.ndarray] = {}

    def _scratch(self, key: str, shape: tuple[int, ...]) -> np.ndarray:
        """Persistent f32 scratch view, grown as needed and reused across
        loci (NOT zeroed — callers that need zeros must .fill(0))."""
        n = int(np.prod(shape)) if shape else 1
        buf = self._scratch_bufs.get(key)
        if buf is None or buf.size < n:
            buf = np.empty(max(n, 1), dtype=np.float32)
            self._scratch_bufs[key] = buf
        return buf[:n].reshape(shape)

    # ------------------------------------------------------------- discovery
    def _discover_genes(self) -> dict[str, dict[str, str]]:
        """{locus: {exon_id ('exon_2'): segment filename}} from segments.txt
        (find_file_for_exon semantics, HLATyper.cpp:3129-3190: filename parts
        <n>_gene_<locus>_<n>_exon_<k>.txt, locus may carry an HLA- prefix)."""
        out: dict[str, dict[str, str]] = {}
        for fn in self.segment_files:
            parts = fn.split("_")
            if len(parts) < 6 or parts[1] != "gene":
                continue
            locus = parts[2]
            if locus.startswith("HLA-"):
                locus = locus[4:]
            if parts[4] == "exon":
                exon_n = parts[5][:-4] if parts[5].endswith(".txt") else parts[5]
                out.setdefault(locus, {})[f"exon_{exon_n}"] = fn
        return out

    # ------------------------------------------------------- G nomenclature
    def _load_g(self) -> dict[str, str]:
        """Parse the IPD-IMGT/HLA G-group nomenclature file (hla_nom_g.txt
        format: 'LOCUS*;a1/a2/...;GCODE;', read_G_alleles HLATyper.cpp:
        4153-4209).  Search order: explicit path, graph dir, cwd."""
        if self._alleles_to_g is not None:
            return self._alleles_to_g
        candidates = [self.g_path] if self.g_path else []
        candidates += [os.path.join(self.pkg.dir, "hla_nom_g.txt"),
                       "hla_nom_g.txt"]
        path = next((p for p in candidates if p and os.path.exists(p)), None)
        m: dict[str, str] = {}
        if path:
            with open(path) as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#"):
                        continue
                    comp = line.split(";")
                    locus_star = comp[0]
                    if not locus_star.endswith("*"):
                        continue
                    self._g_loci.add(locus_star[:-1])
                    g_code = comp[-1] if comp[-1] else comp[1]
                    g_code = locus_star + g_code
                    for a in comp[1].split("/"):
                        m[locus_star + a] = g_code
        self._alleles_to_g = m
        return m

    def translate_to_g(self, alleles: list[str]) -> tuple[str, bool]:
        """translate_allele_list_to_G_allele (HLATyper.cpp:4095-4152)."""
        m = self._load_g()
        groups: dict[str, int] = {}
        for a in alleles:
            g = m.get(a)
            if g is None:
                continue
            groups[g] = groups.get(g, 0) + 1
        if not groups:
            return ";".join(alleles), False
        if len(groups) == 1:
            return next(iter(groups)), True
        best = max(groups.items(), key=lambda kv: kv[1])
        return best[0], False

    def can_translate_locus(self, locus: str) -> bool:
        self._load_g()
        return locus in self._g_loci

    # ---------------------------------------------------------------- typing
    def type_all(self, raw_pairs: list[tuple[FastqRead, FastqRead]],
                 aligned_pairs: list[AlignedPair],
                 raw_unpaired: list[FastqRead],
                 aligned_unpaired: list[GraphAlignment],
                 insert_mean: float, insert_sd: float,
                 output_dir: str, long_reads_mode: str = "",
                 n_workers: int = 1, worker_pool=None) -> list[LocusResult]:
        os.makedirs(output_dir, exist_ok=True)
        cfg = self.cfg.for_long_reads() if long_reads_mode else self.cfg
        long_reads = bool(long_reads_mode)

        kmer_counts = self._read_kmer_index(raw_pairs, raw_unpaired, cfg)
        self._setup_pair_ranges(aligned_pairs, aligned_unpaired)
        self._write_summary_statistics(raw_pairs, aligned_pairs, raw_unpaired,
                                       aligned_unpaired, insert_mean,
                                       insert_sd, output_dir, cfg)
        self._pair_quality = (self._compute_pair_quality(
            aligned_pairs, insert_mean, insert_sd, cfg)
            if aligned_pairs else None)

        results: list[LocusResult] = []
        hist_path = os.path.join(output_dir, "histogram_matchesPerRead.txt")
        per_locus = None
        if (n_workers > 1 or worker_pool is not None) and len(self.loci) > 1:
            per_locus = self._type_loci_parallel(
                raw_pairs, aligned_pairs, raw_unpaired, aligned_unpaired,
                insert_mean, insert_sd, output_dir, cfg, long_reads,
                kmer_counts, n_workers, worker_pool)
        self._async_out = _AsyncOutput()
        try:
            with open(hist_path, "w") as hist_fh:
                hist_fh.write("Locus\tLevelValue\n")
                for locus in self.loci:
                    if per_locus is not None:
                        r, hist_text = per_locus[locus]
                        hist_fh.write(hist_text)
                    else:
                        log_progress(f"HLATypeInference: locus {locus}")
                        r = self._type_locus(locus, raw_pairs, aligned_pairs,
                                             raw_unpaired, aligned_unpaired,
                                             insert_mean, insert_sd,
                                             output_dir, cfg, long_reads,
                                             kmer_counts, hist_fh)
                    if r is not None:
                        results.append(r)
        finally:
            aout, self._async_out = self._async_out, None
            aout.flush(raising=sys.exc_info()[0] is None)

        self._pair_ranges = None     # only valid for this read set
        self._pair_quality = None
        self._pair_strand_ok = None
        self._pair_level_dist = None
        self._write_bestguess(results, output_dir, cfg)
        with open(os.path.join(output_dir, "R1_parameters.txt"), "w") as fh:
            fh.write(f"Loci = {','.join(self.loci)}\n")
            fh.write("veryConservativeReadLikelihoods = 1\n")
        return results

    def _compute_pair_quality(self, aligned_pairs, insert_mean, insert_sd,
                              cfg: TyperConfig):
        """Per-pair quality predicate + weightedOK fractions, computed ONCE
        for the whole run (HLATyper.cpp:1403-1430 applies the identical
        locus-independent checks inside every locus loop).  Needed for the
        full read set because every OK pair writes read/readPair histogram
        lines for every locus, whether or not it overlaps the locus's
        exons.  Returns (ok [N] bool, w1 [N], w2 [N])."""
        n = len(aligned_pairs)
        if n == 0:
            return np.zeros(n, dtype=bool), np.zeros(0), np.zeros(0)
        pack = getattr(aligned_pairs, "pack", None)
        if pack is not None and "wok" in pack:
            # packed SoA: the worker-computed fractions/mapQs read straight
            # off the pack (bit-identical — the worker runs the same batch
            # functions the legacy path's caches come from)
            w1, w2 = pack["wok"][0::2], pack["wok"][1::2]
            mapq1 = pack["mapq"][0::2]
        else:
            w1 = weighted_ok_fractions_batch(
                [ap.chain1 for ap in aligned_pairs])
            w2 = weighted_ok_fractions_batch(
                [ap.chain2 for ap in aligned_pairs])
            mapq1 = np.fromiter((ap.chain1.mapq for ap in aligned_pairs),
                                np.float64, n)
        thr = cfg.min_both_reads_weighted_ok
        rng = cfg.insert_size_sd_range * insert_sd
        so = getattr(self, "_pair_strand_ok", None)
        if so is None or len(so) != n:   # direct _type_locus callers
            so = np.fromiter((strands_valid(ap.chain1, ap.chain2)
                              for ap in aligned_pairs), np.bool_, n)
            dist = np.fromiter(
                (pair_distance_graph_levels(ap.chain1, ap.chain2)
                 for ap in aligned_pairs), np.int64, n)
        else:
            dist = self._pair_level_dist
        ok = (so
              & (np.abs(dist - insert_mean) <= rng)
              & (mapq1 >= cfg.minimum_mapping_quality)
              & (w1 >= thr) & (w2 >= thr))
        return ok, w1, w2

    def _setup_pair_ranges(self, aligned_pairs, aligned_unpaired):
        """Per-chain level ranges, computed once: loci only visit overlapping
        pairs (the IntervalTree pre-filter role, HLATyper.cpp:259-267).
        Also derives the vectorised strand-validity and pair-distance arrays
        (alignerBase.cpp:213-288 semantics) shared by summaryStatistics and
        the pair-quality predicate (no per-pair python loops)."""
        n = len(aligned_pairs)
        def _levels(chains):
            f = np.fromiter(((c.first_level() if c is not None else -1)
                             for c in chains), np.int64, len(chains))
            l = np.fromiter(((c.last_level() if c is not None else -1)
                             for c in chains), np.int64, len(chains))
            return f, l
        pack = getattr(aligned_pairs, "pack", None)
        if pack is not None:
            # packed SoA fast path: the per-chain ranges/orientations are
            # already flat arrays (chain j of pair i at index 2i+j)
            pf, pl = pack["first_lv"], pack["last_lv"]
            pr_f1, pr_l1 = pf[0::2], pl[0::2]
            pr_f2, pr_l2 = pf[1::2], pl[1::2]
            r1, r2 = pack["reverse"][0::2], pack["reverse"][1::2]
        else:
            pr_f1, pr_l1 = _levels([ap.chain1 for ap in aligned_pairs])
            pr_f2, pr_l2 = _levels([ap.chain2 for ap in aligned_pairs])
            r1 = np.fromiter((ap.chain1.reverse for ap in aligned_pairs),
                             np.bool_, n)
            r2 = np.fromiter((ap.chain2.reverse for ap in aligned_pairs),
                             np.bool_, n)
        un_f, un_l = _levels(aligned_unpaired)
        self._pair_ranges = (pr_f1, pr_l1, pr_f2, pr_l2, un_f, un_l)
        self._pair_strand_ok = ((pr_f1 != -1) & (pr_f2 != -1) & (r1 != r2)
                                & np.where(~r1, pr_f1 < pr_f2,
                                           pr_l1 > pr_l2))
        self._pair_level_dist = np.where(pr_f1 < pr_f2, pr_f2 - pr_l1 - 1,
                                         pr_f1 - pr_l2 - 1)

    # ------------------------------------------------------------- per locus
    def _type_loci_parallel(self, raw_pairs, aligned_pairs, raw_unpaired,
                            aligned_unpaired, insert_mean, insert_sd,
                            output_dir, cfg, long_reads, kmer_counts,
                            n_workers, worker_pool=None):
        """Per-locus typing fan-out over worker processes (the reference
        types loci serially; loci are independent given the alignments).
        `worker_pool`: a live ParallelAligner whose warm workers (package
        already in memory) are reused; without one, fresh workers are
        spawned — worth it only when serial typing would take minutes.
        Returns {locus: (LocusResult|None, hist_text)}, or None when the
        fan-out is not worth it or cannot start (too few reads or loci, no
        file-backed __main__): the caller then types serially.  A failure
        INSIDE a worker (a CUDA error, a failed build or launch) is not
        such a case: it propagates and ends the run."""
        from .parallel_host import pack_aligned_pairs, spawn_safe
        # per-worker fixed costs (HLATyper init, kmer-index IPC; plus a
        # package reload for fresh workers) only amortise at WGS scale
        # (~1M MHC reads / several loci) — below that serial typing wins
        min_reads = getattr(self.cfg, "min_reads_for_typing_workers", 50_000)
        min_loci = getattr(self.cfg, "min_loci_for_typing_workers", 4)
        if len(aligned_pairs) + len(aligned_unpaired) < min_reads \
                or len(self.loci) < min_loci:
            return None
        if worker_pool is None and not spawn_safe():
            return None
        import multiprocessing as mp
        n = min(n_workers if worker_pool is None else worker_pool.n_workers,
                len(self.loci))
        chunks = [self.loci[i::n] for i in range(n)]
        # ship only the alignments overlapping each chunk's gene ranges —
        # at WGS scale most reads are outside any given locus, and the IPC
        # of the full alignment set dominates otherwise
        # spill the k-mer count index to disk and ship the PATH: its sorted
        # code arrays cover every input read (hundreds of MB at WGS scale)
        # and would otherwise be pickled into each worker's args
        kc_arg = kmer_counts
        kc_path = None
        if kmer_counts is not None and len(kmer_counts.codes):
            import tempfile
            fd, kc_path = tempfile.mkstemp(suffix=".npz",
                                           prefix="hla_kmercounts_")
            os.close(fd)
            with open(kc_path, "wb") as fh:
                np.savez(fh, codes=kmer_counts.codes,
                         counts=kmer_counts.counts, k=kmer_counts.k)
            kc_arg = kc_path
        # full-set histogram fractions: every OK pair's lines must appear
        # for every locus, but workers only receive gene-range subsets
        hist_w = (np.zeros(0), np.zeros(0))
        if getattr(self, "_pair_quality", None) is not None:
            ok_a, w1_a, w2_a = self._pair_quality
            oki = np.nonzero(ok_a)[0]
            hist_w = (w1_a[oki], w2_a[oki])
        args = []
        for chunk in chunks:
            sel = self._subset_for_loci(chunk, raw_pairs, aligned_pairs,
                                        raw_unpaired, aligned_unpaired)
            (sub_raw_pairs, sub_aligned, sub_rawu, sub_unal) = sel
            # packed input subsets are already SoA — ship the arrays as-is
            packed = (sub_aligned.pack if hasattr(sub_aligned, "pack")
                      else pack_aligned_pairs(sub_aligned))
            # raw reads ship as THREE joined strings per side, not a tuple
            # per read: pickling millions of small tuples/strings made the
            # fan-out slower than serial at WGS scale
            raw1 = _pack_reads(r1 for r1, _ in sub_raw_pairs)
            raw2 = _pack_reads(r2 for _, r2 in sub_raw_pairs)
            rawu = _pack_reads(sub_rawu)
            unal = _pack_optional_chains(sub_unal)
            args.append((self.pkg.dir, str(self.device), self.cfg, self.g_path,
                         chunk, packed, raw1, raw2, rawu, unal,
                         insert_mean, insert_sd, output_dir, cfg,
                         long_reads, kc_arg, hist_w))
        if worker_pool is None and self.device.type == "cuda":
            # one build, here, before any worker asks for the library
            from .. import _build
            _build.library()
        try:
            if worker_pool is not None:
                chunk_results = worker_pool.pool.map(_typing_worker, args)
            else:
                ctx = mp.get_context("spawn")
                with ctx.Pool(n, initializer=_typing_worker_init) as pool:
                    chunk_results = pool.map(_typing_worker, args)
        finally:
            if kc_path is not None and os.path.exists(kc_path):
                os.unlink(kc_path)
        out = {}
        for res, launches in chunk_results:
            self.worker_launches["K3"] += launches
            for locus, r, hist_text in res:
                out[locus] = (r, hist_text)
        if set(out) != set(self.loci):
            raise RuntimeError(
                f"typing workers returned {sorted(out)}, expected "
                f"{sorted(self.loci)}")
        return out

    def _combined_exon_matrix(self, locus: str):
        """Combined exon allele matrix: returns (graph_levels [J],
        exon_index [J], exon_pos [J], {allele: combined string})
        (HLATyper.cpp:1186-1320)."""
        exon_ids = [e for e in LOCI_2_EXONS.get(locus, [])
                    if e in self.graph_genes[locus]]
        assert exon_ids, f"no exon files for locus {locus}"
        levels: list[int] = []
        exon_idx: list[int] = []
        exon_pos: list[int] = []
        combined: dict[str, str] = {}
        for ei, exon_id in enumerate(exon_ids):
            fn = self.graph_genes[locus][exon_id]
            cols, rows = self.pkg.read_segment(fn)
            first_level = self.locus_to_level[cols[0]]
            last_level = self.locus_to_level[cols[-1]]
            assert last_level - first_level + 1 == len(cols)
            for li, cname in enumerate(cols):
                assert self.locus_to_level[cname] == first_level + li
                levels.append(first_level + li)
                exon_idx.append(ei)
                exon_pos.append(li)
            for allele, vals in rows.items():
                if ":" not in allele:
                    continue
                seq = "".join(vals)
                if len(seq) != len(cols) or any(len(v) != 1 for v in vals):
                    # Documented contract (COMPONENTS.md): one character per
                    # segment-matrix cell.  The reference concatenates cells
                    # blindly (HLATyper.cpp:1285-1297) so a multi-char cell
                    # silently SHIFTS every downstream column->position
                    # mapping — we fail loudly with the exact cell instead.
                    # Per-cell check, not aggregate length: compensating
                    # errors (an empty cell + a 2-char cell in one row)
                    # keep the total length but still corrupt positions.
                    bad = next((i for i, v in enumerate(vals)
                                if len(v) != 1), None)
                    col = cols[bad] if bad is not None else "?"
                    raise ValueError(
                        f"multi-character segment-matrix cell: file {fn}, "
                        f"allele {allele}, column {bad} ({col}), cell "
                        f"{vals[bad] if bad is not None else '?'!r} — one "
                        "char per cell is required (the reference would "
                        "positionally corrupt here, HLATyper.cpp:1285-1297)")
                if ei == 0:
                    combined[allele] = seq
                else:
                    assert allele in combined, (locus, allele)
                    combined[allele] += seq
        return (np.asarray(levels), np.asarray(exon_idx),
                np.asarray(exon_pos), combined)

    def _cluster_alleles(self, combined: dict[str, str]):
        """(cluster sequences, clusters as allele lists, allele->cluster)."""
        seq_to_cluster: dict[str, int] = {}
        clusters: list[list[str]] = []
        cluster_seqs: list[str] = []
        allele_to_cluster: dict[str, int] = {}
        for allele in combined:  # dict preserves file order
            seq = combined[allele]
            ci = seq_to_cluster.get(seq)
            if ci is None:
                ci = len(clusters)
                seq_to_cluster[seq] = ci
                clusters.append([])
                cluster_seqs.append(seq)
            clusters[ci].append(allele)
            allele_to_cluster[allele] = ci
        return cluster_seqs, clusters, allele_to_cluster

    def _chain_records(self, al: GraphAlignment) -> dict:
        """Per-chain record arrays, computed ONCE (vectorised) and cached on
        the chain: one record per level-bearing column, with trailing
        insertion columns folded into the record (genotype string, qualities),
        running-novel-gap lengths and per-record mapQ.  The per-locus pileup
        extraction then just slices the level range (the reference recomputes
        the full column walk per locus, HLATyper.cpp:3192-3566)."""
        cached = getattr(al, "_records", None)
        if cached is not None and cached.get("token") is self._intern_token:
            return cached
        seq_c, graph_c, levels_arr = al.seq_c, al.graph_c, al.levels
        n_cols = al.n_columns
        # native fast path (hla_chain_record): bit-identical record arrays
        # when every single-byte genotype/quality is already interned; a
        # chain needing a NEW intern (or b"" itself) runs the python body
        # so the run-global intern-table order stays canonical
        mqa = al.mapq_per_pos
        if (self._qid_empty >= 0 and native.available()
                and seq_c.dtype == np.uint8 and seq_c.flags.c_contiguous
                and graph_c.dtype == np.uint8
                and graph_c.flags.c_contiguous
                and al.seq_qual.dtype == np.uint8
                and al.seq_qual.flags.c_contiguous
                and levels_arr.dtype == np.int64
                and levels_arr.flags.c_contiguous
                and (mqa is None or (isinstance(mqa, np.ndarray)
                                     and mqa.dtype == np.float64
                                     and mqa.flags.c_contiguous))):
            n_rec = int((levels_arr >= 0).sum())
            scr = getattr(self, "_cr_scratch", None)
            if scr is None:
                scr = self._cr_scratch = {}
            res = native.chain_record(seq_c, graph_c, levels_arr,
                                      al.seq_qual, mqa, self._lut_g,
                                      self._lut_q, self._qid_empty, n_rec,
                                      scratch=scr)
            if res is not None:
                (lv_o, worst_o, gid_o, qid_o, q0_o, mqp_o, rn_o, cng,
                 ins_idx) = res
                if len(ins_idx):
                    # rare: records with trailing insertion columns — the
                    # same multi-byte intern loop as the python body
                    rec_cols = np.nonzero(levels_arr >= 0)[0]
                    g_ids, g_list = self._geno_ids, self._geno_list
                    q_ids, q_list = self._qual_ids, self._qual_list
                    for i in ins_idx.tolist():
                        c = int(rec_cols[i])
                        c_next = int(rec_cols[i + 1]) \
                            if i + 1 < n_rec else n_cols
                        g = bytes(seq_c[c + 1:c_next]).decode()
                        q = bytes(al.seq_qual[c + 1:c_next])
                        if seq_c[c] != GAP:
                            g = chr(seq_c[c]) + g
                            q = bytes([al.seq_qual[c]]) + q
                        worst_o[i] = min(q) if q else 0
                        gi = g_ids.get(g)
                        if gi is None:
                            gi = g_ids[g] = len(g_list)
                            g_list.append(g)
                        qi = q_ids.get(q)
                        if qi is None:
                            qi = q_ids[q] = len(q_list)
                            q_list.append(q)
                        gid_o[i] = gi
                        qid_o[i] = qi
                        q0_o[i] = q[0] if q else 0
                rec = dict(levels=lv_o, worst_q=worst_o, gid=gid_o,
                           qid=qid_o, q0=q0_o, mapq_pos=mqp_o,
                           run_novel=rn_o, cols_nongap=cng,
                           token=self._intern_token)
                al._records = rec
                return rec
        # the reference's expression is the typo
        # `(seq != "_") || (seq != "_")` (HLATyper.cpp:3235, 3610), which
        # reduces to seq-non-gap alone — reproduced verbatim so the pileup
        # "alignmentLength" field matches reference output byte-for-byte
        cols_nongap = int((seq_c != GAP).sum())

        # running novel gap lengths, both directions (HLATyper.cpp:3237-3290)
        reset = (seq_c != GAP) & (graph_c != GAP)
        novel = (~reset) & ~((seq_c == GAP) & (graph_c == GAP))
        inc = novel.astype(np.int64)

        def run_dir(inc_, reset_):
            cs = np.cumsum(inc_)
            base = np.maximum.accumulate(np.where(reset_, cs, 0))
            return cs - base
        fwd = run_dir(inc, reset)
        bwd = run_dir(inc[::-1], reset[::-1])[::-1]
        run_novel = np.maximum(fwd, bwd)

        mq = al.mapq_per_pos if al.mapq_per_pos is not None \
            else np.ones(n_cols)

        rec_cols = np.nonzero(levels_arr >= 0)[0]
        n_rec = len(rec_cols)
        # trailing insertion count per record = -1 columns until next record
        nxt = np.concatenate([rec_cols[1:], [n_cols]])
        n_ins = (nxt - rec_cols - 1).astype(np.int64)
        seq_at = seq_c[rec_cols]
        is_del = seq_at == GAP

        worst_q = np.where(is_del, 0, al.seq_qual[rec_cols]
                           ).astype(np.uint8)
        # fast path: no trailing insertions (the overwhelming majority).
        # Only interned ids live on the record — the per-record python
        # string/bytes lists (~160 per chain, ~8.7M items per IMGT-scale
        # run) exist nowhere on the hot path; the legacy ExonObs path
        # reconstructs them from the intern tables on demand.
        chars = bytes(seq_at).decode()
        qual_all = bytes(al.seq_qual[rec_cols])
        # intern genotype strings / quality bytes into the run-global
        # tables (single-char fast path via 256-entry luts; insertion
        # records fixed up in the rare-case loop below)
        g_ids, g_list = self._geno_ids, self._geno_list
        q_ids, q_list = self._qual_ids, self._qual_list

        def intern_g(g: str) -> int:
            i = g_ids.get(g)
            if i is None:
                i = g_ids[g] = len(g_list)
                g_list.append(g)
            return i

        def intern_q(q: bytes) -> int:
            i = q_ids.get(q)
            if i is None:
                i = q_ids[q] = len(q_list)
                q_list.append(q)
            return i

        lut_g, lut_q = self._lut_g, self._lut_q
        gid = lut_g[seq_at]
        if gid.min(initial=0) < 0:      # unseen byte(s): register + redo
            for b in np.unique(seq_at[gid < 0]).tolist():
                lut_g[b] = intern_g(chr(b))
            gid = lut_g[seq_at]
        qual_at = al.seq_qual[rec_cols]
        qid = lut_q[qual_at]
        if qid.min(initial=0) < 0:
            for b in np.unique(qual_at[qid < 0]).tolist():
                lut_q[b] = intern_q(bytes([b]))
            qid = lut_q[qual_at]
        if self._qid_empty < 0:
            self._qid_empty = intern_q(b"")
        qid[is_del] = self._qid_empty
        q0 = np.where(is_del, 0, qual_at).astype(np.int64)
        for i in np.nonzero(n_ins > 0)[0]:
            c = rec_cols[i]
            ins_cols = np.arange(c + 1, c + 1 + n_ins[i])
            g = bytes(seq_c[ins_cols]).decode()
            q = bytes(al.seq_qual[ins_cols])
            if not is_del[i]:
                g = chars[i] + g
                q = qual_all[i:i + 1] + q
            # else: leading '_' absorbed by the insertion (reference
            # removes it, HLATyper.cpp:3345-3357)
            worst_q[i] = min(q) if q else 0
            gid[i] = intern_g(g)
            qid[i] = intern_q(q)
            q0[i] = q[0] if q else 0
        rec = dict(
            levels=levels_arr[rec_cols],
            worst_q=worst_q,
            gid=gid,
            qid=qid,
            q0=q0,
            mapq_pos=np.asarray(mq)[rec_cols],
            run_novel=run_novel[rec_cols],
            cols_nongap=cols_nongap,
            token=self._intern_token,
        )
        al._records = rec
        return rec

    def _alignment_to_obs(self, al: GraphAlignment, read: FastqRead,
                          paired_al: GraphAlignment | None,
                          paired_read: FastqRead | None,
                          lv_min: int, lv_max: int,
                          level_to_pos: dict[int, int]) -> list[ExonObs]:
        """oneReadAlignment_2_exonPositions_{paired,unpaired}
        (HLATyper.cpp:3192-3566), built from the cached per-chain records."""
        first, last = al.first_level(), al.last_level()
        if first == -1 or not (first <= lv_max and last >= lv_min):
            return []
        this_wok = alignment_weighted_ok_fraction(al)
        if paired_al is not None:
            paired_wok = alignment_weighted_ok_fraction(paired_al)
            strands_distance = float(pair_distance_graph_levels(al, paired_al))
        else:
            paired_wok = this_wok
            strands_distance = 0.0

        rec = self._chain_records(al)
        lv = rec["levels"]
        lo = int(np.searchsorted(lv, lv_min))
        hi = int(np.searchsorted(lv, lv_max, side="right"))
        out: list[ExonObs] = []
        paired_name = paired_read.name if paired_read else read.name
        lv_l = lv[lo:hi].tolist()
        mqp_l = rec["mapq_pos"][lo:hi].tolist()
        rn_l = rec["run_novel"][lo:hi].tolist()
        # reconstruct the per-record strings from the intern tables (the
        # hot path carries only ids; this legacy ExonObs path is kept for
        # the field-for-field parity lock, tests/test_obs_vectorized.py)
        g_list, q_list = self._geno_list, self._qual_list
        geno = [g_list[j] for j in rec["gid"].tolist()]
        quals = [q_list[j] for j in rec["qid"].tolist()]
        mapq, name, cols_ng = al.mapq, read.name, rec["cols_nongap"]
        rev, ffr = al.reverse, al.from_first_read
        get_pos = level_to_pos.get
        append = out.append
        for k, l in enumerate(lv_l):
            pos = get_pos(l)
            if pos is None:
                continue
            i = lo + k
            append(ExonObs(l, pos, geno[i], quals[i], mapq, mqp_l[k],
                           name, paired_name, this_wok, paired_wok,
                           strands_distance, cols_ng, rn_l[k], rev, ffr))
        return out

    @staticmethod
    def _remove_double_positions(obs: list[ExonObs]) -> list[ExonObs]:
        """Keep one record per graph level: best worst-quality
        (removeDoublePositionsFromRead, HLATyper.cpp:2850-2920)."""
        by_level: dict[int, ExonObs] = {}
        order: list[int] = []
        for o in obs:
            worst = min(o.qualities) if o.qualities else 0
            cur = by_level.get(o.graph_level)
            if cur is None:
                by_level[o.graph_level] = o
                order.append(o.graph_level)
            else:
                cur_worst = min(cur.qualities) if cur.qualities else 0
                if worst > cur_worst:
                    by_level[o.graph_level] = o
        return [by_level[lv] for lv in sorted(order)]

    def _locus_level_range(self, locus) -> tuple[int, int] | None:
        """Graph-level span of a locus's typed exon segments, from the
        segment headers only (no allele matrix load)."""
        lo, hi = None, None
        for fn in self.graph_genes.get(locus, {}).values():
            path = os.path.join(self.pkg.dir, "PRG", fn)
            with open(path) as fh:
                cols = fh.readline().split()[1:]
            for c in cols:
                lv = self.locus_to_level.get(c)
                if lv is None:
                    continue
                lo = lv if lo is None else min(lo, lv)
                hi = lv if hi is None else max(hi, lv)
        if lo is None:
            return None
        return lo, hi

    def _subset_for_loci(self, loci, raw_pairs, aligned_pairs, raw_unpaired,
                         aligned_unpaired):
        """Alignments/reads overlapping any of `loci`'s gene ranges
        (requires _setup_pair_ranges to have run)."""
        ranges = [r for r in (self._locus_level_range(l) for l in loci)
                  if r is not None]
        if not ranges or getattr(self, "_pair_ranges", None) is None:
            return raw_pairs, aligned_pairs, raw_unpaired, aligned_unpaired
        f1, l1, f2, l2, uf, ul = self._pair_ranges
        n = len(aligned_pairs)
        keep_p = np.zeros(n, dtype=bool)
        nu = len(aligned_unpaired)
        keep_u = np.zeros(nu, dtype=bool)
        for lo, hi in ranges:
            keep_p |= (((f1[:n] <= hi) & (l1[:n] >= lo) & (f1[:n] >= 0))
                       | ((f2[:n] <= hi) & (l2[:n] >= lo) & (f2[:n] >= 0)))
            if nu:
                keep_u |= (uf[:nu] <= hi) & (ul[:nu] >= lo) & (uf[:nu] >= 0)
        pi = np.nonzero(keep_p)[0]
        ui = np.nonzero(keep_u)[0]
        sub_aligned = (aligned_pairs.subset(pi)
                       if hasattr(aligned_pairs, "subset")
                       else [aligned_pairs[i] for i in pi])
        return ([raw_pairs[i] for i in pi], sub_aligned,
                [raw_unpaired[i] for i in ui],
                [aligned_unpaired[i] for i in ui])

    def _collect_locus_obs(self, raw_pairs, aligned_pairs, raw_unpaired,
                           aligned_unpaired, ov, pq, levels, lv_min, lv_max,
                           cfg) -> _ObsSoA:
        """Vectorised oneReadAlignment_2_exonPositions_{paired,unpaired} +
        removeDoublePositionsFromRead over a whole locus
        (HLATyper.cpp:3192-3566 and 2850-2920): per-mate slices of the
        cached chain records concatenate into flat arrays; the per-(read,
        level) best-worst-quality merge is ONE lexsort.  Replaces the
        per-ExonObs object path on the hot path (byte-identical outputs —
        the object path survives as `_alignment_to_obs` for the parity
        test)."""
        levels = np.asarray(levels, dtype=np.int64)
        pos_of_level = np.full(lv_max - lv_min + 1, -1, dtype=np.int64)
        pos_of_level[levels - lv_min] = np.arange(len(levels),
                                                  dtype=np.int64)

        seg_lv, seg_gid, seg_qid, seg_q0 = [], [], [], []
        seg_worst, seg_rn, seg_mqp = [], [], []
        counts: list[int] = []
        m_name: list[str] = []
        m_pname: list[str] = []
        m_mapq: list = []
        m_wok_t: list[float] = []
        m_wok_p: list[float] = []
        m_dist: list[float] = []
        m_colsng: list[int] = []
        m_rev: list[bool] = []
        m_ffr: list[bool] = []
        m_slot: list[int] = []
        slot = 0

        def add_mate(al, read_name, paired_name, wok_t, wok_p, dist):
            fl = al.first_level()
            if fl == -1 or not (fl <= lv_max and al.last_level() >= lv_min):
                return
            rec = self._chain_records(al)
            lv = rec["levels"]
            lo = int(np.searchsorted(lv, lv_min))
            hi = int(np.searchsorted(lv, lv_max, side="right"))
            if hi <= lo:
                return
            seg_lv.append(lv[lo:hi])
            seg_gid.append(rec["gid"][lo:hi])
            seg_qid.append(rec["qid"][lo:hi])
            seg_q0.append(rec["q0"][lo:hi])
            seg_worst.append(rec["worst_q"][lo:hi])
            seg_rn.append(rec["run_novel"][lo:hi])
            seg_mqp.append(rec["mapq_pos"][lo:hi])
            counts.append(hi - lo)
            m_name.append(read_name)
            m_pname.append(paired_name)
            m_mapq.append(al.mapq)
            m_wok_t.append(wok_t)
            m_wok_p.append(wok_p)
            m_dist.append(dist)
            m_colsng.append(rec["cols_nongap"])
            m_rev.append(al.reverse)
            m_ffr.append(al.from_first_read)
            m_slot.append(slot)

        if aligned_pairs:
            ok_a, w1_a, w2_a = pq
            for i in np.nonzero(ov & ok_a)[0].tolist():
                r1, r2 = raw_pairs[i]
                ap = aligned_pairs[i]
                c1, c2 = ap.chain1, ap.chain2
                dist = float(pair_distance_graph_levels(c1, c2))
                add_mate(c1, r1.name, r2.name, float(w1_a[i]),
                         float(w2_a[i]), dist)
                add_mate(c2, r2.name, r1.name, float(w2_a[i]),
                         float(w1_a[i]), dist)
                slot += 1
        if getattr(self, "_pair_ranges", None) is not None and raw_unpaired:
            _, _, _, _, uf, ul = self._pair_ranges
            n = len(aligned_unpaired)
            ovu = (uf[:n] <= lv_max) & (ul[:n] >= lv_min) & (uf[:n] >= 0)
            unpaired_iter = [(raw_unpaired[i], aligned_unpaired[i])
                             for i in np.nonzero(ovu)[0]]
        else:
            unpaired_iter = list(zip(raw_unpaired, aligned_unpaired))
        for r, al in unpaired_iter:
            if al is None:
                continue
            if (al.mapq >= cfg.minimum_mapping_quality
                    and al.n_columns >= cfg.min_alignment_length_unpaired):
                w = alignment_weighted_ok_fraction(al)
                add_mate(al, r.name, r.name, w, w, 0.0)
                slot += 1

        genotypes, geno_ids = self._geno_list, self._geno_ids
        quals = self._qual_list
        if not counts:
            e64 = np.empty(0, dtype=np.int64)
            ef = np.empty(0, dtype=np.float64)
            eb = np.empty(0, dtype=bool)
            return _ObsSoA.from_arrays(
                read_idx=e64, pos=e64, gid=e64, qid=e64, name_id=e64,
                mqp=ef, w=ef, wok=ef, rev=eb, ffr=eb, q0=e64,
                run_novel=e64, mate_id=e64, read_mate0=e64,
                genotypes=genotypes, geno_ids=geno_ids, quals=quals,
                names=[], name_ids={},
                m_name=m_name, m_pname=m_pname, m_mapq=m_mapq,
                m_wok_this=m_wok_t, m_wok_paired=m_wok_p, m_dist=m_dist,
                m_colsng=m_colsng, n_reads=0)

        lv_c = np.concatenate(seg_lv)
        gid_c = np.concatenate(seg_gid)
        qid_c = np.concatenate(seg_qid)
        q0_c = np.concatenate(seg_q0)
        worst_c = np.concatenate(seg_worst).astype(np.int64)
        rn_c = np.concatenate(seg_rn)
        mqp_c = np.concatenate(seg_mqp)
        cnt = np.asarray(counts, dtype=np.int64)
        mate_c = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
        slot_c = np.asarray(m_slot, dtype=np.int64)[mate_c]

        pos_c = pos_of_level[lv_c - lv_min]
        v = pos_c >= 0
        if not v.all():
            lv_c, gid_c, qid_c, q0_c = lv_c[v], gid_c[v], qid_c[v], q0_c[v]
            worst_c, rn_c, mqp_c = worst_c[v], rn_c[v], mqp_c[v]
            mate_c, slot_c, pos_c = mate_c[v], slot_c[v], pos_c[v]

        # one obs per (read, level), best worst-quality wins, earliest wins
        # ties (chain1's segment precedes chain2's in concatenation order —
        # the sequential merge's replace-only-if-strictly-greater rule).
        # Single composite-key stable sort (faster than a 4-key lexsort): key =
        # (slot, level-lv_min, 255-worst) packed into 63 bits; stability
        # supplies the original-order tie-break
        lv_rel = lv_c - lv_min
        span = lv_max - lv_min + 1
        # `slot` (the final counter) bounds the max packed slot value —
        # NOT len(m_slot): slot also increments for pairs whose mates
        # contributed zero in-range obs, so raw values can exceed it.
        if slot * span < (1 << 55):
            comp = (slot_c * span + lv_rel) * 256 + (255 - worst_c)
            order = np.argsort(comp, kind="stable")
            comp_key = comp >> 8
            keep = np.r_[True, np.diff(comp_key[order]) != 0]
        else:                        # overflow-proof fallback
            n = len(lv_c)
            order = np.lexsort((np.arange(n), -worst_c, lv_c, slot_c))
            slot_s = slot_c[order]
            lv_s = lv_c[order]
            keep = np.r_[True, (slot_s[1:] != slot_s[:-1])
                         | (lv_s[1:] != lv_s[:-1])]
        sel = order[keep]            # final obs order: (read asc, level asc)
        slot_sel = slot_c[sel]
        new_read = np.r_[True, slot_sel[1:] != slot_sel[:-1]]
        read_idx = np.cumsum(new_read.astype(np.int64)) - 1
        n_reads = int(read_idx[-1]) + 1 if len(sel) else 0
        mate_sel = mate_c[sel]
        read_mate0 = mate_sel[np.flatnonzero(new_read)]

        name_ids: dict[str, int] = {}
        nsd = name_ids.setdefault
        mate_nid = np.fromiter((nsd(nm, len(name_ids)) for nm in m_name),
                               np.int64, len(m_name))
        wok_t_arr = np.asarray(m_wok_t, dtype=np.float64)
        wok_p_arr = np.asarray(m_wok_p, dtype=np.float64)
        return _ObsSoA.from_arrays(
            read_idx=read_idx, pos=pos_c[sel], gid=gid_c[sel],
            qid=qid_c[sel], name_id=mate_nid[mate_sel], mqp=mqp_c[sel],
            w=((wok_t_arr + wok_p_arr) / 2.0)[mate_sel],
            wok=wok_t_arr[mate_sel],
            rev=np.asarray(m_rev, dtype=bool)[mate_sel],
            ffr=np.asarray(m_ffr, dtype=bool)[mate_sel],
            q0=q0_c[sel], run_novel=rn_c[sel], mate_id=mate_sel,
            read_mate0=read_mate0,
            genotypes=genotypes, geno_ids=geno_ids, quals=quals,
            names=list(name_ids), name_ids=name_ids,
            m_name=m_name, m_pname=m_pname, m_mapq=m_mapq,
            m_wok_this=m_wok_t, m_wok_paired=m_wok_p, m_dist=m_dist,
            m_colsng=m_colsng, n_reads=n_reads)

    def _type_locus(self, locus, raw_pairs, aligned_pairs, raw_unpaired,
                    aligned_unpaired, insert_mean, insert_sd, output_dir,
                    cfg: TyperConfig, long_reads: bool,
                    kmer_counts: dict, hist_fh) -> LocusResult | None:
        levels, exon_idx, exon_pos, combined = self._combined_exon_matrix(locus)
        if not combined:
            return None
        lv_min, lv_max = int(levels.min()), int(levels.max())
        cluster_seqs, clusters, allele_to_cluster = \
            self._cluster_alleles(combined)
        C = len(cluster_seqs)
        J = len(levels)

        # ---- pileups per read (pair mates merged; reference 1386-1500)
        # quality predicate + weightedOK fractions are locus-independent —
        # computed once per run (type_all / the typing worker)
        pq = getattr(self, "_pair_quality", None)
        if pq is None and aligned_pairs:
            pq = self._compute_pair_quality(aligned_pairs, insert_mean,
                                            insert_sd, cfg)
        if getattr(self, "_pair_ranges", None) is not None and raw_pairs:
            f1, l1, f2, l2, _, _ = self._pair_ranges
            n = len(aligned_pairs)
            ov = (((f1[:n] <= lv_max) & (l1[:n] >= lv_min) & (f1[:n] >= 0))
                  | ((f2[:n] <= lv_max) & (l2[:n] >= lv_min) & (f2[:n] >= 0)))
        else:
            ov = np.ones(len(aligned_pairs), dtype=bool)
        # every quality-OK pair writes its histogram lines for this locus —
        # the reference emits them OUTSIDE the has-exon-positions check
        # (HLATyper.cpp:1426-1430), so pairs with no overlap with this
        # locus's exons still appear.  In the per-locus worker fan-out the
        # full-set fractions arrive via _hist_override (workers only hold
        # the gene-range read subset).
        hist = getattr(self, "_hist_override", None)
        if hist is None and pq is not None:
            ok_a, w1_a, w2_a = pq
            oki = np.nonzero(ok_a)[0]
            hist = (w1_a[oki], w2_a[oki])
        if hist is not None:
            # the weightedOK fractions are heavily quantised (most reads sit
            # at a handful of values): format each distinct (w1, w2) pair's
            # 3-line block once and emit by index, not once per pair
            key = np.asarray(hist[0]) + 1j * np.asarray(hist[1])
            uv, inv = np.unique(key, return_inverse=True)
            blocks = [f"{locus}\tread{w1}\n{locus}\tread{w2}\n"
                      f"{locus}\treadPair{(w1 + w2) / 2}\n"
                      for w1, w2 in zip(uv.real.tolist(), uv.imag.tolist())]
            hist_fh.write("".join([blocks[i] for i in inv.tolist()]))
        soa = self._collect_locus_obs(raw_pairs, aligned_pairs, raw_unpaired,
                                      aligned_unpaired, ov, pq, levels,
                                      lv_min, lv_max, cfg)

        # ---- filters ----------------------------------------------------
        ignore_read_ids: set[str] = set()
        ignore_alleles: dict[int, set[str]] = {}
        if cfg.filter_first20 and not long_reads:
            n_erased = self._filter_first20(None, ignore_read_ids,
                                            ignore_alleles, cfg, soa=soa)
            if n_erased:
                log_progress(
                    f"  WARNING {locus}: filterFirst20 removed an allele "
                    f"carrying >={cfg.filter_first20_erasure_warn_frac:.0%} "
                    f"of observations at {n_erased} position(s) — possible "
                    f"novel allele with uniformly down-weighted reads "
                    f"(inspect R1_pileup_{locus}.txt)")
        counts_post, strand_freqs, read1_freqs = self._allele_filters(
            None, ignore_read_ids, ignore_alleles, cfg, long_reads,
            soa=soa)

        # ---- final pileup ------------------------------------------------
        kept_mask = soa.base_used_mask(
            ignore_read_ids, ignore_alleles,
            cfg.minimum_per_position_mapping_quality) \
            if soa.n_obs else np.zeros(0, dtype=bool)
        used_mask = kept_mask & (soa.run_novel < 2) if long_reads \
            else kept_mask
        used_idx = np.nonzero(used_mask)[0]
        utilized_reads = {soa.names[i]
                          for i in np.unique(soa.name_id[used_idx]).tolist()}
        # per-obs histogram lines (chain-constant value -> cached string)
        wcache: dict[float, str] = {}
        parts: list[str] = []
        for v in soa.wok[used_idx].tolist():
            s = wcache.get(v)
            if s is None:
                s = wcache[v] = f"{locus}\tbase{v}\n"
            parts.append(s)
        hist_fh.write("".join(parts))
        self._write_pileup(locus, soa, used_idx, exon_idx, exon_pos,
                           strand_freqs, read1_freqs, output_dir)
        with open(os.path.join(output_dir, f"R1_readIDs_{locus}.txt"),
                  "w") as fh:
            for rid in sorted(utilized_reads):
                fh.write(rid + "\n")

        # ---- likelihood tensors ------------------------------------------
        p_ins = 0.075 if long_reads else 0.001
        R = soa.n_reads
        # chunk reads so the [Rc, J, 6] contribution tensors stay bounded
        # (~200 MB) even for very wide typed segments
        chunk = max(16, int(2e8 / max(J * 24, 1)))
        onehot = cluster_onehot(cluster_seqs)

        # all big tensors come from the per-typer scratch pool and outputs
        # are written straight into [C, R] column slices, in place of
        # fresh 100MB+ allocations per call
        LLmat = self._scratch("LL", (C, R))
        MMmat = self._scratch("MM", (C, R))
        used_count = 0
        for lo in range(0, R, chunk):
            hi2 = min(lo + chunk, R)
            rr = None if (lo, hi2) == (0, R) else (lo, hi2)
            Rc = hi2 - lo
            tshape = (Rc, J, 6)
            contrib, mismatch, used_c = self._build_read_tensors(
                None, J, cfg, ignore_read_ids, ignore_alleles,
                long_reads, p_ins, soa=soa, kept_mask=kept_mask,
                read_range=rr,
                out=(self._scratch("contrib", tshape),
                     self._scratch("mismatch", tshape)))
            used_count += used_c
            LLmat[:, lo:hi2], MMmat[:, lo:hi2] = cluster_read_ll(
                onehot, contrib, mismatch, device=self.device)
        log_progress(f"  {locus}: {C} clusters x {R} reads")
        dump_dir = os.environ.get("HLA_LLMAT_DUMP")
        if dump_dir:      # kernel-tuning diagnostic: the real LL matrix
            np.save(os.path.join(dump_dir, f"LLmat_{locus}.npy"), LLmat)
            if soa.n_obs:   # each read's first typed-segment position
                first = np.r_[True, soa.read_idx[1:] != soa.read_idx[:-1]]
                np.save(os.path.join(dump_dir, f"readpos_{locus}.npy"),
                        soa.pos[first])

        # ---- pair reduction ----------------------------------------------
        pair_LL = pair_ll_reduction(LLmat, device=self.device,
                                    sharded=self.sharded)
        iu = np.triu_indices(C)
        pair_vals = pair_LL[iu]                    # ordered (c1 <= c2)
        max_ll = float(pair_vals.max()) if len(pair_vals) else 0.0
        P = np.exp(pair_vals - max_ll)
        s = P.sum()
        P = P / s if s > 0 else np.full_like(P, 1.0 / len(P))

        # marginal per-cluster posterior (HLATyper.cpp:2489-2517)
        marg = np.zeros(C)
        np.add.at(marg, iu[0], P)
        sec = iu[1] != iu[0]
        np.add.at(marg, iu[1][sec], P[sec])
        best1 = int(np.argmax(marg))

        # conditional second allele (2519-2538); triangular index of the
        # (a<=b) pair in row-major upper-triangle order
        def tri_idx(a, b):
            return a * C - (a * (a - 1)) // 2 + (b - a)
        c2s = np.arange(C)
        a_arr = np.minimum(best1, c2s)
        b_arr = np.maximum(best1, c2s)
        cand_P = P[tri_idx(a_arr, b_arr)]
        best2_p = float(cand_P.max())
        mm_min_row = pair_min_mismatch_row(MMmat, best1)
        tie = np.nonzero(cand_P == best2_p)[0]
        best2 = int(tie[np.argmax(-mm_min_row[tie])])

        mism_rowsums = MMmat.sum(axis=1)
        mism_avg = 0.5 * (mism_rowsums[iu[0]] + mism_rowsums[iu[1]])

        # ---- outputs: pair posterior dump --------------------------------
        # LL descending, ties by ascending Mismatches_avg (the reference's
        # sort comparator, HLATyper.cpp:2382-2404; its std::sort leaves
        # deeper ties unspecified — lexsort is stable and far faster than
        # the structured argsort on the 2.4M-pair IMGT-scale dump)
        order = np.lexsort((mism_avg, -pair_vals))
        cluster_ids = [";".join(sorted(c)) for c in clusters]
        pp_path = os.path.join(output_dir, f"R1_PP_{locus}_pairs.txt")
        iu0_o, iu1_o = iu[0][order], iu[1][order]
        P_o, LL_o, MM_o = P[order], pair_vals[order], mism_avg[order]

        def write_pp():
            with open(pp_path, "wb") as fh:
                fh.write(b"ClusterID\tP\tLL\tMismatches_avg\n")
                # native bulk formatter (hla_format_pairs): threaded C++
                # CPython-repr layout, byte-identical to the python path
                # below (locked by tests/test_native_parity.py + the
                # snapshot suite)
                body = native.format_pairs(
                    iu0_o, iu1_o, P_o, LL_o, MM_o,
                    [s.encode() for s in cluster_ids])
                if body is not None:
                    fh.write(body)
                    return
                # chunked bulk formatting: at IMGT scale this file is
                # C(C+1)/2 ~ 2.4M lines (~120 MB), too many for a per-line
                # write loop.  .tolist() floats repr identically to the
                # scalar f-string (same shortest-round-trip algorithm)
                for lo in range(0, len(order), 262144):
                    hi = lo + 262144
                    fh.write("".join(
                        f"{cluster_ids[a]}/{cluster_ids[b]}\t{p}\t{v}\t{m}\n"
                        for a, b, p, v, m in zip(
                            iu0_o[lo:hi].tolist(), iu1_o[lo:hi].tolist(),
                            P_o[lo:hi].tolist(), LL_o[lo:hi].tolist(),
                            MM_o[lo:hi].tolist())).encode())

        aout = getattr(self, "_async_out", None)
        if aout is not None:
            aout.submit(write_pp)       # overlaps QC + the next locus
        else:
            write_pp()

        # ---- QC ----------------------------------------------------------
        allele1_id = cluster_ids[best1]
        allele2_id = cluster_ids[best2]
        allele1_one = sorted(clusters[best1])[0]
        allele2_one = sorted(clusters[best2])[0]
        qc = self._column_qc(locus, cluster_seqs[best1], cluster_seqs[best2],
                             soa, used_idx, counts_post, exon_idx, exon_pos,
                             kmer_counts, combined[allele1_one],
                             combined[allele2_one], cfg, output_dir)

        res = LocusResult(
            locus=locus,
            allele1_id=allele1_id, allele2_id=allele2_id,
            q1_allele1=float(marg[best1]), q1_allele2=best2_p,
            q2=float(-mm_min_row[best2]),
            avg_coverage=used_count / J if J else 0.0,
            first_decile_coverage=qc["decile"],
            min_coverage=qc["min_cov"],
            prop_kmers_covered_1=qc["kmers1"],
            prop_kmers_covered_2=qc["kmers2"],
            avg_column_error=qc["avg_err"],
            n_columns_unaccounted=qc["unaccounted"],
            n_clusters=C, n_reads_used=R,
        )
        if self.can_translate_locus(locus):
            res.allele1_g, res.g1_perfect = self.translate_to_g(
                sorted(clusters[best1]))
            res.allele2_g, res.g2_perfect = self.translate_to_g(
                sorted(clusters[best2]))
        return res

    # -------------------------------------------------------------- tensors
    def _build_read_tensors(self, reads_obs, J, cfg, ignore_read_ids,
                            ignore_alleles, long_reads, p_ins,
                            soa: _ObsSoA | None = None, kept_mask=None,
                            read_range=None, transposed=False, out=None):
        """[R, J, 6] log-likelihood contribution and mismatch tensors
        (the matmul lowering of HLATyper.cpp:2089-2276).

        `soa`/`kept_mask`: precomputed flat view + filter mask for the FULL
        read set; `read_range=(lo, hi)` restricts to a read-index window
        (tensor row r = read lo+r), for the chunked wide-segment path.
        `transposed=True` builds the [J*6, R] layout the sparse-delta
        cluster LL kernel consumes (rows contiguous over reads).
        `out=(contrib, mismatch)`: preallocated scratch of the right shape
        (zeroed here) — avoids per-chunk fresh-allocation page-fault churn."""
        log_ins_act = math.log(p_ins) + math.log(0.25)
        log_del = math.log(p_ins)
        log_mm = math.log(1.0 - 2 * p_ins)
        table = phred_to_p_correct_table(conservative_cap=0.999, floor=None)

        if soa is None:
            soa = _ObsSoA(reads_obs)
            kept_mask = None
        if kept_mask is None:
            kept_mask = soa.base_used_mask(
                ignore_read_ids, ignore_alleles,
                cfg.minimum_per_position_mapping_quality) \
                if soa.n_obs else np.zeros(0, dtype=bool)
        if read_range is None:
            lo, hi = 0, soa.n_reads
        else:
            lo, hi = read_range
        sel = kept_mask
        if read_range is not None:
            sel = sel & (soa.read_idx >= lo) & (soa.read_idx < hi)
        R = hi - lo
        shape = (J * 6, R) if transposed else (R, J, 6)
        if out is not None:
            contrib, mismatch = out
            assert contrib.shape == shape and mismatch.shape == shape
            contrib.fill(0)
            mismatch.fill(0)
        else:
            contrib = np.zeros(shape, dtype=np.float32)
            mismatch = np.zeros(shape, dtype=np.float32)
        # flatten: (r, j) is unique per obs (one obs per level after
        # removeDoublePositions), so scatter is plain fancy indexing
        r_idx = soa.read_idx[sel] - lo
        used = len(r_idx)
        if used == 0:
            return contrib, mismatch, used
        j_idx = soa.pos[sel]
        if transposed:
            j6 = j_idx * 6

            def put_c(chn, vals):
                contrib[j6 + chn, r_idx] += vals

            def put_m(chn, vals):
                mismatch[j6 + chn, r_idx] += vals
        else:
            def put_c(chn, vals):
                contrib[r_idx, j_idx, chn] += vals

            def put_m(chn, vals):
                mismatch[r_idx, j_idx, chn] += vals
        genos_tbl = soa.genotypes
        gap_tbl = np.asarray([g == "_" for g in genos_tbl], dtype=bool)
        first_tbl = np.asarray([0 if g == "_" else ord(g[0])
                                for g in genos_tbl], dtype=np.int64)
        ldiff_tbl = np.asarray([len(g) - 1 for g in genos_tbl],
                               dtype=np.float64)
        garr = soa.gid[sel]
        if native.available():
            # native per-obs channel writer: all float values come from
            # f64 tables computed HERE in numpy (one f64 add + f32 cast in
            # C++), so the cells are bit-identical to the scatter path
            # below (locked by tests/test_native_parity.py)
            chf_tbl = np.full(len(genos_tbl), -1, dtype=np.int8)
            for b, ch in _BASE_CH.items():
                chf_tbl[first_tbl == ord(b)] = ch
            sing_tbl = (ldiff_tbl == 0).astype(np.uint8)
            tail_tbl = ldiff_tbl * log_ins_act
            chgap_tbl = (1.0 + ldiff_tbl) * log_ins_act
            pc_t = table.astype(np.float64)
            pc_t = np.where(pc_t <= 0, 0.001, pc_t)
            vmatch_q = log_mm + np.log(pc_t)
            vmis_q = log_mm + np.log((1.0 - pc_t) / 3.0)
            if native.build_read_tensors(
                    r_idx, j_idx, garr, soa.q0[sel], gap_tbl, chf_tbl,
                    sing_tbl, tail_tbl, chgap_tbl, vmatch_q, vmis_q,
                    log_del, R, J, transposed, contrib, mismatch):
                return contrib, mismatch, used
        is_gap = gap_tbl[garr]
        first = first_tbl[garr]
        l_diff = ldiff_tbl[garr]
        q0 = soa.q0[sel]
        p_c = table[q0].astype(np.float64)
        p_c = np.where(p_c <= 0, 0.001, p_c)
        v_match = np.where(is_gap, log_del, log_mm + np.log(p_c))
        v_mismatch = np.where(is_gap, log_del,
                              log_mm + np.log((1.0 - p_c) / 3.0))
        tail = l_diff * log_ins_act
        put_c(CH_GAP, np.where(
            is_gap, 0.0, (1.0 + l_diff) * log_ins_act).astype(np.float32))
        single = (l_diff == 0) & ~is_gap
        for base, ch in _BASE_CH.items():
            m = (~is_gap) & (first == ord(base))
            put_c(ch, (np.where(m, v_match, v_mismatch)
                       + tail).astype(np.float32))
            put_m(ch, ((~is_gap) & ~(single & (first == ord(base)))
                       ).astype(np.float32))
        put_c(CH_OTHER, (v_mismatch + tail).astype(np.float32))
        put_m(CH_OTHER, (~is_gap).astype(np.float32))
        put_m(CH_GAP, (~is_gap).astype(np.float32))
        return contrib, mismatch, used

    # -------------------------------------------------------------- filters
    def _filter_first20(self, reads_obs, ignore_read_ids, ignore_alleles,
                        cfg: TyperConfig, soa: _ObsSoA | None = None):
        """'filterFirst20' top-N-by-quality allele plausibility filter
        (HLATyper.cpp:1509-1719).  Note the reference divides the top-N count
        by the *boolean* filterFirst20 (==1), so an allele passes iff it
        appears in the top N at all; replicated (vectorised: a stable
        per-position sort by descending weight, then key-membership
        arithmetic).

        Deliberate deviation at WEIGHT TIES: every observation tying the
        N-th-ranked weight counts as top-N.  The reference's std::sort
        comparator uses weight alone (HLATyper.cpp:1560-1565), so its tie
        order is unspecified; a stable insertion-order top-N is strictly
        worse — when >= N observations tie (common at weightedOK == 1.0
        with clean reads), whichever haplotype's reads happen to come
        first in input order monopolise the top N and the OTHER TRUE
        ALLELE is erased at every distinguishing position (confident
        false-homozygous calls; caught by the randomized CLI soak,
        regression test test_typer.py::
        test_filter_first20_tied_weights_keep_both_alleles).  With
        distinct weights the behaviour is unchanged."""
        if soa is None:
            soa = _ObsSoA(reads_obs)
        n = cfg.filter_first20_n
        m = soa.mqp >= cfg.minimum_per_position_mapping_quality
        if not m.any():
            return 0
        pos = soa.pos[m]
        wv = soa.w[m]
        rid = soa.read_idx[m]
        key = soa.keys[m]
        order = np.lexsort((np.arange(len(wv)), -wv, pos))
        spos = pos[order]
        sw = wv[order]
        grp_start = np.flatnonzero(np.r_[True, spos[1:] != spos[:-1]])
        grp_cnt = np.diff(np.r_[grp_start, len(spos)])
        eligible = grp_cnt >= n
        if not eligible.any():
            return 0
        elig_row = np.repeat(eligible, grp_cnt)
        skey = key[order]
        # per-group weight of the N-th ranked obs; ties with it are top-N
        nth_idx = np.minimum(grp_start + (n - 1), len(sw) - 1)
        thr_row = np.repeat(sw[nth_idx], grp_cnt)
        topn_keys = np.unique(skey[elig_row & (sw >= thr_row)])
        kicked_row = elig_row & ~np.isin(skey, topn_keys)
        if not kicked_row.any():
            return 0
        uk, k_inv, k_cnt = np.unique(skey[kicked_row], return_inverse=True,
                                     return_counts=True)
        G = soa.G
        genotypes = soa.genotypes
        for k in uk.tolist():
            ignore_alleles.setdefault(k // G, set()).add(genotypes[k % G])
        # observability (outputs unchanged): a kicked allele that carried a
        # large share of its position's observations is the signature of a
        # novel allele whose reads are uniformly down-weighted by their own
        # novel mismatches — the reference filter silently erases it and
        # the final call can be a confident wrong homozygote (found by the
        # randomized heldout soak, seeds 33696/33706)
        upos_vals = spos[grp_start]
        gidx = np.searchsorted(upos_vals, uk // G)
        share = k_cnt / grp_cnt[gidx]
        n_erased_big = int(np.unique(
            (uk // G)[share >= cfg.filter_first20_erasure_warn_frac]).size)
        # a read is kicked out when more than `kickout_limit` of its
        # observations carry a robustly-kicked (count >= 2) genotype
        robust = kicked_row.copy()
        robust[kicked_row] = k_cnt[k_inv] >= 2
        per_read = np.bincount(rid[order][robust], minlength=soa.n_reads)
        for ri in np.nonzero(per_read > cfg.filter_first20_kickout_limit)[0]:
            if soa.read_mate0 is not None:
                mid = int(soa.read_mate0[ri])
                ignore_read_ids.add(soa.m_name[mid])
                ignore_read_ids.add(soa.m_pname[mid])
            elif reads_obs[ri]:
                ignore_read_ids.add(reads_obs[ri][0].read_id)
                ignore_read_ids.add(reads_obs[ri][0].paired_read_id)
        return n_erased_big

    def _allele_filters(self, reads_obs, ignore_read_ids, ignore_alleles,
                        cfg: TyperConfig, long_reads: bool,
                        soa: _ObsSoA | None = None):
        """Low-frequency and strand-bias allele filters
        (HLATyper.cpp:1721-1880).  Counting is vectorised per unique
        (position, genotype) key; only the output-dict assembly loops, once
        per unique key instead of once per observation."""
        counts_post: dict[int, dict[str, int]] = {}
        strand_freqs: dict[int, dict[str, float]] = {}
        read1_freqs: dict[int, dict[str, float]] = {}
        if soa is None:
            soa = _ObsSoA(reads_obs)
        if soa.n_obs == 0:
            return counts_post, strand_freqs, read1_freqs
        m = soa.base_used_mask(ignore_read_ids, ignore_alleles,
                               cfg.minimum_per_position_mapping_quality)
        if not m.any():
            return counts_post, strand_freqs, read1_freqs
        uk, inv = np.unique(soa.keys[m], return_inverse=True)
        cnt = np.bincount(inv)
        fwd = np.bincount(inv, weights=~soa.rev[m]).astype(np.int64)
        r1 = np.bincount(inv, weights=soa.ffr[m]).astype(np.int64)
        G = soa.G
        upos = uk // G
        # per-position coverage totals, broadcast back per key
        pidx = np.cumsum(np.r_[False, upos[1:] != upos[:-1]])
        ptot = np.bincount(pidx, weights=cnt).astype(np.int64)
        tot_per_key = ptot[pidx]

        genotypes = soa.genotypes
        hc_min = cfg.high_coverage_min_coverage
        hc_freq = cfg.high_coverage_min_allele_freq
        hc_filter = cfg.high_coverage_filter_alleles
        lr_filter = long_reads and cfg.long_reads_filter_strand
        lr_min = cfg.long_reads_filter_strand_min_allele_coverage
        lr_freq = cfg.long_reads_filter_strand_min_strand_freq
        for i, k in enumerate(uk.tolist()):
            p = k // G
            g = genotypes[k % G]
            n = int(cnt[i])
            total = int(tot_per_key[i])
            if total >= hc_min:
                if n / total < hc_freq and hc_filter:
                    ignore_alleles.setdefault(p, set()).add(g)
                else:
                    counts_post.setdefault(p, {})[g] = n
            f = int(fwd[i])
            r = n - f
            min_strand = min(f, r) / n if n else 0.0
            strand_freqs.setdefault(p, {})[g] = min_strand
            read1_freqs.setdefault(p, {})[g] = int(r1[i]) / n if n else 0.0
            if lr_filter and n >= lr_min and min_strand < lr_freq:
                ignore_alleles.setdefault(p, set()).add(g)
        return counts_post, strand_freqs, read1_freqs

    # ------------------------------------------------------------------- QC
    def _column_qc(self, locus, seq1, seq2, soa, used_idx, counts_post,
                   exon_idx, exon_pos, kmer_counts, comb1, comb2, cfg,
                   output_dir):
        """Column coverage / incompatibility QC (vectorised over the used
        observations; a pileup genotype is incompatible when it differs
        from both called alleles' column characters)."""
        J = len(seq1)
        pos_used = soa.pos[used_idx]
        gid_used = soa.gid[used_idx]
        per_col_total = np.bincount(pos_used, minlength=J)
        cov = per_col_total.astype(float)
        cov_sorted = np.sort(cov)
        decile = float(cov_sorted[int(len(cov_sorted) / 10.0)]) \
            if len(cov_sorted) else 0.0
        min_cov = float(cov_sorted[0]) if len(cov_sorted) else 0.0

        # called alleles' per-column characters -> interned genotype ids
        # (a multi-base observation can never equal a single column char)
        lut = np.full(256, -1, dtype=np.int64)
        for g, i in soa.geno_ids.items():
            if len(g) == 1:
                lut[ord(g)] = i
        col1 = lut[np.frombuffer(seq1.encode(), dtype=np.uint8)]
        col2 = lut[np.frombuffer(seq2.encode(), dtype=np.uint8)]
        incomp = ((gid_used != col1[pos_used])
                  & (gid_used != col2[pos_used]))
        per_col_incomp = np.bincount(pos_used[incomp], minlength=J)
        total_alleles = int(len(pos_used))
        incompatible = int(incomp.sum())

        unaccounted = 0
        for j, alleles in counts_post.items():
            a1, a2 = seq1[j], seq2[j]
            tot = sum(alleles.values())
            if tot >= cfg.unaccounted_min_coverage:
                for g, n in alleles.items():
                    if g in (a1, a2):
                        continue
                    if n / tot >= cfg.unaccounted_min_allele_fraction:
                        unaccounted += 1
        avg_err = incompatible / total_alleles if total_alleles else 0.0

        with open(os.path.join(output_dir,
                               f"R1_columnIncompatibilities_{locus}.txt"),
                  "w") as fh:
            fh.write("Column\tCoverage\tExpectedIncompatible\t"
                     "ObservedIncompatible\tp\n")
            # coverage/observed values repeat across the J columns: format
            # (and chi2) each distinct (coverage, observed) row tail once
            key = per_col_total.astype(np.int64) * (
                int(per_col_incomp.max()) + 1 if J else 1) + per_col_incomp
            uv, inv = np.unique(key, return_inverse=True)
            span = int(per_col_incomp.max()) + 1 if J else 1
            tails = []
            for kv in uv.tolist():
                tot, observed = kv // span, kv % span
                expected = avg_err * tot
                p = 1.0
                if observed > expected and expected > 0:
                    p = _chi2_p1([tot - observed, observed],
                                 [tot - expected, expected])
                tails.append(f"\t{tot}\t{expected}\t{observed}\t{p}\n")
            fh.write("".join(
                [f"{j}{tails[i]}" for j, i in enumerate(inv.tolist())]))

        exon_arr = np.asarray(exon_idx)

        def kmer_presence(combined: str) -> float:
            k = cfg.k_for_kmer_index
            # split by exon, drop gaps, count k-mers present in the read
            # index (vectorised split, no per-char python loop)
            total = present = 0
            arr = np.frombuffer(combined.encode(), dtype=np.uint8)
            keep = arr != ord("_")
            for e in np.unique(exon_arr).tolist():
                s = bytes(arr[(exon_arr == e) & keep]).decode()
                n = max(len(s) - k + 1, 0)
                total += n
                if n:
                    cnt, valid = kmer_counts.counts_for(s)
                    present += int(((cnt > 0) & valid).sum())
            return present / total if total else -1.0

        return dict(decile=decile, min_cov=min_cov, avg_err=avg_err,
                    unaccounted=unaccounted,
                    kmers1=kmer_presence(comb1), kmers2=kmer_presence(comb2))

    # -------------------------------------------------------------- outputs
    def _write_pileup(self, locus, soa: _ObsSoA, used_idx, exon_idx,
                      exon_pos, strand_freqs, read1_freqs, output_dir):
        """Build + write R1_pileup_<locus>.txt (HLATyper.cpp:1940-2010
        layout).  When an _AsyncOutput is active (type_all / the typing
        worker), the build+write runs on a background thread.  The three
        run-global tables the build reads (intern'd genotype/quality
        lists + the pos-str cache) keep growing on the caller thread for
        later loci, so the async path hands the thread SNAPSHOTS of the
        prefixes it needs (shallow pointer copies) — no
        reliance on GIL list semantics (safe on free-threaded builds)."""
        # str(i) cache lives on the typer (reclaimed with it, unlike a
        # module global) and is shared across this run's loci
        ep_a0 = np.asarray(exon_pos)
        pos_str = getattr(self, "_pos_str_cache", None)
        if pos_str is None:
            pos_str = self._pos_str_cache = []
        need = int(ep_a0.max()) + 1 if len(ep_a0) else 0
        while len(pos_str) < need:
            pos_str.extend(map(str, range(len(pos_str), need)))
        aout = getattr(self, "_async_out", None)
        if aout is not None:
            pos_snap = pos_str[:need]
            geno_snap = list(soa.genotypes)
            qual_snap = list(soa.quals)
            aout.submit(lambda: self._build_pileup(
                locus, soa, used_idx, exon_idx, exon_pos, strand_freqs,
                read1_freqs, output_dir, pos_snap, geno_snap, qual_snap))
        else:
            self._build_pileup(locus, soa, used_idx, exon_idx, exon_pos,
                               strand_freqs, read1_freqs, output_dir,
                               pos_str, soa.genotypes, soa.quals)

    def _build_pileup(self, locus, soa: _ObsSoA, used_idx, exon_idx,
                      exon_pos, strand_freqs, read1_freqs, output_dir,
                      pos_str, geno_list, qual_list):
        path = os.path.join(output_dir, f"R1_pileup_{locus}.txt")
        with open(path, "w") as fh:
            J = len(exon_idx)
            ei_a = np.asarray(exon_idx)
            ep_a = np.asarray(exon_pos)
            ei = ei_a.tolist()
            ep = ep_a.tolist()
            # uncovered-column runs (the bulk of a real-PRG-scale gene) are
            # emitted as one str.join chunk per (exon, consecutive-position)
            # run — per-column f-strings over ~600k columns/locus were the
            # dominant pileup cost.  Chunks carry internal newlines; the
            # final "\n".join reproduces the per-line layout byte-for-byte.
            run_breaks = ((np.flatnonzero((np.diff(ei_a) != 0)
                                          | (np.diff(ep_a) != 1)) + 1)
                          .tolist() if J > 1 else [])
            import bisect as _bisect

            def zero_chunk(a, b):
                parts = []
                u = a
                bi = _bisect.bisect_right(run_breaks, a)
                while u < b:
                    v = run_breaks[bi] if bi < len(run_breaks) else J
                    if v > b:
                        v = b
                    et = str(ei[u]) + "\t"
                    p0 = ep[u]
                    parts.append(et + ("\t0\n" + et).join(
                        pos_str[p0:p0 + (v - u)]) + "\t0")
                    u = v
                    bi += 1
                return "\n".join(parts)

            # group used observations by exon position (stable: obs order
            # within a position = flat obs order, as the dict-append path
            # produced)
            pos_u = soa.pos[used_idx]
            ordu = np.argsort(pos_u, kind="stable")
            su = used_idx[ordu]
            pos_s = pos_u[ordu]
            if len(pos_s):
                starts = np.flatnonzero(np.r_[True, pos_s[1:] != pos_s[:-1]])
                ends = np.r_[starts[1:], len(pos_s)].tolist()
                covered = pos_s[starts].tolist()
                starts = starts.tolist()
            else:
                starts, ends, covered = [], [], []
            gid_l = soa.gid[su].tolist()
            qid_l = soa.qid[su].tolist()
            mqp_l = soa.mqp[su].tolist()
            mid_l = soa.mate_id[su].tolist()
            m_name, m_pname, m_mapq = soa.m_name, soa.m_pname, soa.m_mapq
            m_wt, m_wp = soa.m_wok_this, soa.m_wok_paired
            m_dist, m_cng = soa.m_dist, soa.m_colsng
            lines: list[str] = []
            # chain-constant fragments cached ONCE per mate for the whole
            # locus (a read covers O(read length) columns; per-column caches
            # rebuilt every fragment ~200x)
            frag_cache: dict[int, tuple[str, str]] = {}
            mqp_cache: dict[float, str] = {}
            q1_cache = [str(i) for i in range(256)]
            prev = 0
            for gi_, j in enumerate(covered):
                if j > prev:
                    lines.append(zero_chunk(prev, j))
                prev = j + 1
                a, b = starts[gi_], ends[gi_]
                fields = [str(ei[j]), str(ep[j]), str(b - a)]
                # per-read entries (reference pileup detail,
                # HLATyper.cpp:1940-2010): genotype (qualities)
                # [pairsDistance | alignmentLength | mapQ_position |
                #  mapQ mapQ | weightedOK weightedOK | readIDs] —
                # everything except genotype/qualities/mapQ_position is
                # chain-constant, so those fragments are cached per mate
                entries = []
                by_allele: dict[str, list[int]] = {}
                for t in range(a, b):
                    mid = mid_l[t]
                    frag = frag_cache.get(mid)
                    if frag is None:
                        frag = frag_cache[mid] = (
                            f") [pairsDistance {m_dist[mid]} | "
                            f"alignmentLength {m_cng[mid]} | ",
                            f" | {m_mapq[mid]} {m_mapq[mid]} | "
                            f"{m_wt[mid]} {m_wp[mid]} | "
                            f"{m_name[mid]} {m_pname[mid]}]")
                    g = geno_list[gid_l[t]]
                    q = qual_list[qid_l[t]]
                    quals = (q1_cache[q[0]] if len(q) == 1
                             else ", ".join(map(str, q)))
                    mq = mqp_l[t]
                    mqs = mqp_cache.get(mq)
                    if mqs is None:
                        mqs = mqp_cache[mq] = str(mq)
                    entries.append(g + " (" + quals + frag[0] + mqs
                                   + frag[1])
                    by_allele.setdefault(g, []).append(m_cng[mid])
                fields.append(", ".join(entries))
                summary = []
                for g, lens in sorted(by_allele.items()):
                    sf = strand_freqs.get(j, {}).get(g, 0.0)
                    r1f = read1_freqs.get(j, {}).get(g, 0.0)
                    summary.append(
                        f"{g}x{len(lens)}"
                        f"[{sum(lens) / len(lens):.1f};{sf};{r1f}]")
                fields.append("".join(summary))
                lines.append("\t".join(fields))
            if J > prev:
                lines.append(zero_chunk(prev, J))
            fh.write("\n".join(lines))
            if lines:
                fh.write("\n")

    def _write_bestguess(self, results: list[LocusResult], output_dir,
                         cfg: TyperConfig):
        unacc = ("NColumns_UnaccountedAllele_fGT"
                 f"{cfg.unaccounted_min_allele_fraction}")
        header = ("Locus\tChromosome\tAllele\tQ1\tQ2\tAverageCoverage\t"
                  "CoverageFirstDecile\tMinimumCoverage\t"
                  f"proportionkMersCovered\tLocusAvgColumnError\t{unacc}")
        with open(os.path.join(output_dir, "R1_bestguess.txt"), "w") as fh:
            fh.write(header + "\n")
            for r in results:
                common = (f"{r.avg_coverage}\t{r.first_decile_coverage}\t"
                          f"{r.min_coverage}")
                fh.write(f"{r.locus}\t1\t{r.allele1_id}\t{r.q1_allele1}\t"
                         f"{r.q2}\t{common}\t{r.prop_kmers_covered_1}\t"
                         f"{r.avg_column_error}\t{r.n_columns_unaccounted}\n")
                fh.write(f"{r.locus}\t2\t{r.allele2_id}\t{r.q1_allele2}\t"
                         f"{r.q2}\t{common}\t{r.prop_kmers_covered_2}\t"
                         f"{r.avg_column_error}\t{r.n_columns_unaccounted}\n")
        with open(os.path.join(output_dir, "R1_bestguess_G.txt"), "w") as fh:
            fh.write(header + "\tperfectG\n")
            for r in results:
                if not r.allele1_g and not r.allele2_g:
                    continue
                common = (f"{r.avg_coverage}\t{r.first_decile_coverage}\t"
                          f"{r.min_coverage}")
                fh.write(f"{r.locus}\t1\t{r.allele1_g}\t{r.q1_allele1}\t"
                         f"{r.q2}\t{common}\t{r.prop_kmers_covered_1}\t"
                         f"{r.avg_column_error}\t{r.n_columns_unaccounted}\t"
                         f"{int(r.g1_perfect)}\n")
                fh.write(f"{r.locus}\t2\t{r.allele2_g}\t{r.q1_allele2}\t"
                         f"{r.q2}\t{common}\t{r.prop_kmers_covered_2}\t"
                         f"{r.avg_column_error}\t{r.n_columns_unaccounted}\t"
                         f"{int(r.g2_perfect)}\n")

    def _write_summary_statistics(self, raw_pairs, aligned_pairs, raw_unpaired,
                                  aligned_unpaired, insert_mean, insert_sd,
                                  output_dir, cfg):
        """summaryStatistics.txt (HLATyper.cpp:1030-1125)."""
        # vectorised over the strand/distance arrays from _setup_pair_ranges
        valid = self._pair_strand_ok
        dists = self._pair_level_dist[valid]
        n_valid = int(valid.sum())
        n_valid_dist = int((np.abs(dists - insert_mean)
                            <= 5 * insert_sd).sum())
        # per-chain OK fractions, vectorised over ALL chains
        frac_sum = 0.0
        n_perfect = 0
        n_one_perfect = 0
        if aligned_pairs:
            pack = getattr(aligned_pairs, "pack", None)
            if pack is not None and "fok" in pack:
                # packed SoA: worker-computed, interleaved [c1,c2,...] —
                # exactly the order the legacy chains list flattens to
                frac = pack["fok"]
            else:
                chains = [c for ap in aligned_pairs
                          for c in (ap.chain1, ap.chain2)]
                # cache-aware batch (worker-unpacked chains arrive with
                # _frac_ok precomputed from the packed arrays)
                frac = fraction_ok_batch(chains)
            # sequential (f1+f2) accumulation keeps the byte-stable output
            frac_l = frac.tolist()
            frac_sum = 0.0
            for i in range(0, len(frac_l), 2):
                frac_sum += frac_l[i] + frac_l[i + 1]
            perfect = frac == 1.0
            n_perfect = int(perfect.sum())
            n_one_perfect = int((perfect[0::2] | perfect[1::2]).sum())
        n_pairs = len(aligned_pairs)
        with open(os.path.join(output_dir, "summaryStatistics.txt"), "w") as fh:
            fh.write("\nRead alignment statistics:\n")
            fh.write(f"\t - Total number (paired) alignments:                 {n_pairs}\n")
            pct = lambda a, b: f"{(a / b * 100) if b else 0:.2f}"
            fh.write(f"\t\t - Alignment pairs with strands OK:                  {n_valid} ({pct(n_valid, n_pairs)}%)\n")
            fh.write(f"\t\t - Alignment pairs with strands OK && distance OK:   {n_valid_dist} ({pct(n_valid_dist, n_pairs)}%)\n")
            mean_d = float(np.mean(dists)) if len(dists) else 0.0
            med_d = float(np.median(dists)) if len(dists) else 0.0
            fh.write(f"\t\t - Alignment pairs with strands OK, mean distance:   {mean_d}\n")
            fh.write(f"\t\t - Alignment pairs with strands OK, median distance: {med_d}\n")
            avg_frac = frac_sum / (2 * n_pairs) if n_pairs else 0.0
            fh.write(f"\t\t - Alignment pairs, average fraction alignment OK:   {avg_frac}\n")
            fh.write(f"\t\t - Alignment pairs, at least one alignment perfect:   {n_one_perfect}\n")
            fh.write(f"\t\t - Single alignments, perfect (total):   {n_perfect} ({n_pairs * 2})\n")
            n_unp = len(aligned_unpaired)
            unp_frac = [alignment_fraction_ok(a) for a in aligned_unpaired
                        if a is not None]
            n_unp_perfect = sum(1 for f in unp_frac if f == 1)
            avg_unp = (sum(unp_frac) / len(unp_frac)) if unp_frac else 0.0
            n_long_enough = sum(
                1 for a in aligned_unpaired
                if a is not None and a.n_columns >= cfg.min_alignment_length_unpaired)
            fh.write(f"\t - Total number (unpaired) alignments:                 {n_unp}\n")
            fh.write(f"\t\t - Alignment pairs, average fraction alignment OK:   {avg_unp}\n")
            fh.write(f"\t\t - Single alignments, perfect (total):   {n_unp_perfect} ({n_unp * 2})\n")
            fh.write(f"\t\t - Alignments with length >= {cfg.min_alignment_length_unpaired}:   {n_long_enough}\n")

    # --------------------------------------------------------------- k-mers
    def _read_kmer_index(self, raw_pairs, raw_unpaired, cfg):
        """Canonical 31-mer counts over all input reads
        (HLATyper.cpp:999-1028) — vectorised 2-bit encoding with a
        bit-twiddled reverse complement; sorted-array storage."""
        k = cfg.k_for_kmer_index
        seqs = []
        for r1, r2 in raw_pairs:
            seqs.append(r1.seq)
            seqs.append(r2.seq)
        for r in raw_unpaired:
            seqs.append(r.seq)
        return KmerCountIndex.build(seqs, k)


def _canonical(kmer: str) -> str:
    """Canonical k-mer = lexicographic min of (kmer, revcomp)
    (kMer_canonical_representation, HLATyper.cpp:4211-4256)."""
    rc = revcomp(kmer)
    return kmer if kmer <= rc else rc


def _revcomp_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2-bit-packed k-mer codes (uint64), vectorised."""
    x = (~codes).astype(np.uint64)          # complement: A<->T, C<->G
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    m8 = np.uint64(0x00FF00FF00FF00FF)
    m16 = np.uint64(0x0000FFFF0000FFFF)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    x = ((x & m8) << np.uint64(8)) | ((x >> np.uint64(8)) & m8)
    x = ((x & m16) << np.uint64(16)) | ((x >> np.uint64(16)) & m16)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    return x >> np.uint64(64 - 2 * k)


class KmerCountIndex:
    """Canonical k-mer -> count, stored as sorted uint64 code arrays."""

    def __init__(self, codes_sorted: np.ndarray, counts: np.ndarray, k: int):
        self.codes = codes_sorted
        self.counts = counts
        self.k = k

    @classmethod
    def build(cls, seqs: list[str], k: int) -> "KmerCountIndex":
        from .. import native
        from ..mapping.kmer_index import encode_kmers
        if not seqs:
            return cls(np.zeros(0, np.uint64), np.zeros(0, np.int64), k)
        cat = np.frombuffer(("\x00".join(seqs)).encode(), dtype=np.uint8)
        if native.available():
            res = native.kmer_count_build(cat, k)
            if res is not None:
                return cls(res[0], res[1], k)
        canon = None
        if native.available():
            res = native.encode_kmers(cat, k, canonical=True)
            if res is not None:
                codes, valid = res
                canon = codes[valid]
        if canon is None:
            codes, valid = encode_kmers(cat, k)
            canon = np.minimum(codes, _revcomp_codes(codes, k))[valid]
        if len(canon) == 0:
            return cls(np.zeros(0, np.uint64), np.zeros(0, np.int64), k)
        # np.unique(return_counts=True) is much slower than a plain sort
        # on uint64 (it bypasses the vectorised sort); count runs manually
        s = np.sort(canon)
        change = np.empty(len(s), dtype=bool)
        change[0] = True
        np.not_equal(s[1:], s[:-1], out=change[1:])
        idx = np.flatnonzero(change)
        counts = np.diff(np.append(idx, len(s)))
        return cls(s[idx], counts.astype(np.int64), k)

    def counts_for(self, seq: str) -> tuple[np.ndarray, np.ndarray]:
        """(count, valid) per k-mer of `seq` (invalid = non-ACGT k-mers)."""
        from ..mapping.kmer_index import encode_kmers
        codes, valid = encode_kmers(
            np.frombuffer(seq.encode(), dtype=np.uint8), self.k)
        if len(self.codes) == 0:
            return np.zeros(len(codes), dtype=np.int64), valid
        canon = np.minimum(codes, _revcomp_codes(codes, self.k))
        idx = np.minimum(np.searchsorted(self.codes, canon),
                         len(self.codes) - 1)
        hit = (self.codes[idx] == canon) & valid
        return np.where(hit, self.counts[idx], 0), valid

    def get(self, kmer: str, default: int = 0) -> int:
        c, v = self.counts_for(kmer)
        return int(c[0]) if len(c) and v[0] else default


def _chi2_p1(observed: list[float], expected: list[float]) -> float:
    """Chi-square goodness-of-fit p-value with df=1
    (simpleChiSq, HLATyper.cpp uses boost chi_squared(1))."""
    stat = 0.0
    for o, e in zip(observed, expected):
        if e <= 0:
            return 1.0
        stat += (o - e) ** 2 / e
    # survival function of chi2(1): erfc(sqrt(x/2))
    return math.erfc(math.sqrt(stat / 2.0))


def _pack_reads(reads) -> tuple[int, str, str, str]:
    """(n, names, seqs, quals) with newline-joined fields — one string per
    field instead of one tuple per read (FASTQ/BAM names/sequences cannot
    contain newlines)."""
    names, seqs, quals = [], [], []
    for r in reads:
        names.append(r.name)
        seqs.append(r.seq)
        quals.append(r.qual)
    return (len(names), "\n".join(names), "\n".join(seqs),
            "\n".join(quals))


def _unpack_reads(t) -> list:
    from ..io.fastq import FastqRead
    n, names, seqs, quals = t
    if n == 0:
        return []
    return [FastqRead(*z) for z in zip(names.split("\n"), seqs.split("\n"),
                                       quals.split("\n"))]


def _pack_optional_chains(chains):
    """(total, non-None indices, packed arrays) for a list that may hold
    None entries (unpaired alignments)."""
    from .parallel_host import pack_unpaired_chains
    idx = [i for i, c in enumerate(chains) if c is not None]
    return (len(chains), idx,
            pack_unpaired_chains([chains[i] for i in idx]) if idx else None)


def _unpack_optional_chains(t) -> list:
    from .parallel_host import unpack_chains
    total, idx, packed = t
    out = [None] * total
    if packed is not None:
        for i, c in zip(idx, unpack_chains(packed)):
            out[i] = c
    return out


def _typing_worker_init():
    os.environ["HLA_LA_IN_WORKER"] = "1"
    torch.set_num_threads(1)


_KC_CACHE: dict[str, "KmerCountIndex"] = {}


def _load_spilled_kmer_counts(path: str) -> "KmerCountIndex":
    kc = _KC_CACHE.get(path)
    if kc is None:
        with np.load(path) as z:
            kc = KmerCountIndex(z["codes"], z["counts"], int(z["k"]))
        _KC_CACHE.clear()
        _KC_CACHE[path] = kc
    return kc


def _typing_worker(args):
    (pkg_dir, device, base_cfg, g_path, loci, packed, raw1, raw2, rawu,
     packed_unal, insert_mean, insert_sd, output_dir, cfg, long_reads,
     kmer_counts, hist_w) = args
    import io

    from ..graph.package import GraphPackage

    # reuse the worker's already-loaded package when running inside the
    # alignment worker pool (avoids a multi-GB package reload per worker at
    # real-PRG scale)
    if isinstance(kmer_counts, str):
        # spilled index: load once per worker process (see the spill in
        # _type_loci_parallel)
        kmer_counts = _load_spilled_kmer_counts(kmer_counts)
    from ..ops.cuda_pair import pair_ll_diff_cuda
    from . import parallel_host as ph
    launches_before = pair_ll_diff_cuda.launches
    pkg = None
    if ph._WORKER_ALIGNER is not None \
            and ph._WORKER_ALIGNER.pkg.dir == pkg_dir:
        pkg = ph._WORKER_ALIGNER.pkg
    if pkg is None:
        pkg = GraphPackage(pkg_dir)
    typer = HLATyper(pkg, base_cfg,
                     g_nomenclature_path=g_path, device=device)
    # wrap, don't unpack: the worker's typing loop reads the SoA arrays
    # directly and materialises objects only for locus-overlapping chains
    from .parallel_host import PackedAlignedPairs
    aligned_pairs = PackedAlignedPairs(packed)
    raw_pairs = list(zip(_unpack_reads(raw1), _unpack_reads(raw2)))
    raw_unpaired = _unpack_reads(rawu)
    aligned_unpaired = _unpack_optional_chains(packed_unal)
    typer._setup_pair_ranges(aligned_pairs, aligned_unpaired)
    typer._pair_quality = (typer._compute_pair_quality(
        aligned_pairs, insert_mean, insert_sd, cfg)
        if aligned_pairs else None)
    typer._hist_override = hist_w   # full-set fractions for the histogram
    typer._async_out = _AsyncOutput()
    out = []
    try:
        for locus in loci:
            log_progress(f"HLATypeInference: locus {locus}")
            fh = io.StringIO()
            r = typer._type_locus(locus, raw_pairs, aligned_pairs,
                                  raw_unpaired, aligned_unpaired,
                                  insert_mean, insert_sd, output_dir, cfg,
                                  long_reads, kmer_counts, fh)
            out.append((locus, r, fh.getvalue()))
    finally:
        aout, typer._async_out = typer._async_out, None
        aout.flush(raising=sys.exc_info()[0] is None)
    return out, pair_ll_diff_cuda.launches - launches_before
