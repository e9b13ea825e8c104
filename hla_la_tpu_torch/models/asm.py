"""Assembly typing (HLA-ASM).

Reference: HLA-ASM.pl (+HLA-ASM.md:5-67): map assembly contigs to the
reference, locate HLA gene/exon coordinates in the contigs, call G-group
genotypes by minimum edit distance against the IMGT exon allele sequences
(Text::LevenshteinXS), optionally compare against a truth set, and write
`summary.txt` (columns contigID, locus, calledGenotypes, components,
editDistance_calledGenotypes_assembly, minEditDistance_assembly_truth,
minEditDistance_calledGenotype_truth + whichAlleles columns) and
`genePositions.tab` (gene/exon coordinates usable for presence/absence and
higher-resolution typing).

The port's counterpart of ``hla_la_tpu/models/asm.py``, with one explicit
``device``: contig localisation uses the native k-mer seeder with MULTIPLE
diverse allele probes per exon (the reference maps contigs with
bwa/minimap2+nucmer); the per-allele edit distances are ONE batched
banded-NW forward (unit scoring) over the allele panel, run on the device
through ``NWRunner`` (K2 on a card at the band of 48), scores alone: no
pointer tensor is copied back.  Reference coordinates come from locating
each exon window against the package's linearized haplotypes (sequences.txt
carries their GRCh38 Chr/Start for real packages, HLA-LA.cpp:265-324).
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass, field

import numpy as np

from .._lazy import torch
from ..graph.package import GraphPackage
from ..mapping.kmer_index import KmerIndex
from ..mapping.seeder import Seeder
from ..ops.banded_nw import NWScoring
from ..sim.read_sim import revcomp
from ..utils.config import LOCI_2_EXONS
from .aligner import NWRunner

_ENC = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _ENC[b] = i
    _ENC[b + 32] = i

EDIT_SCORING = NWScoring(match=0.0, mismatch=-1.0, gap_open=-1.0,
                         gap_extend=-1.0)
N_PROBES_PER_EXON = 4    # diverse alleles probed per exon (single-probe
                         # location misses diverged genes — VERDICT r1 #7)


@dataclass
class ExonHit:
    exon_id: str
    contig_start: int      # in contig orientation used for scoring
    contig_stop: int
    reverse: bool


@dataclass
class AsmCall:
    locus: str
    contig: str
    alleles_at_min: list[str]          # full candidate set at min distance
    edit_distance: int
    components: list[str]              # exons used
    exon_hits: dict[str, ExonHit] = field(default_factory=dict)
    # truth-comparison fields (filled when a truth set is given)
    min_dist_assembly_truth: int | None = None
    min_dist_assembly_truth_alleles: list[str] = field(default_factory=list)
    min_dist_called_truth: int | None = None
    min_dist_called_truth_pairs: list[str] = field(default_factory=list)

    @property
    def allele(self) -> str:           # representative (back-compat)
        return self.alleles_at_min[0]

    @property
    def n_candidates_at_min(self) -> int:
        return len(self.alleles_at_min)

    @property
    def contig_pos(self) -> int:
        first = min(self.exon_hits.values(), key=lambda h: h.contig_start,
                    default=None)
        return first.contig_start if first else -1


class AssemblyTyper:
    def __init__(self, pkg: GraphPackage, band: int = 48, *,
                 device: str | torch.device):
        self.pkg = pkg
        self.band = band
        self._nw = NWRunner(device, {k: float(v) for k, v in
                                     asdict(EDIT_SCORING).items()})
        self.device = self._nw.device
        self.stats = self._nw.stats
        # allele DB per exon: {locus: {exon_file: {allele: gapless seq}}}
        # (contigs carry introns between exons, so each exon is located and
        # scored separately, then distances are summed per allele — matches
        # HLA-ASM's per-exon IMGT comparison)
        self.allele_db: dict[str, dict[str, dict[str, str]]] = {}
        from .typer import HLATyper
        t = HLATyper(pkg, device=self.device)
        for locus in t.loci:
            per_exon: dict[str, dict[str, str]] = {}
            for exon_id, fn in t.graph_genes[locus].items():
                if exon_id not in LOCI_2_EXONS.get(locus, []):
                    continue
                _, rows = pkg.read_segment(fn)
                alleles = {}
                for allele, vals in rows.items():
                    if ":" not in allele:
                        continue
                    s = "".join(vals).replace("_", "")
                    if "*" not in s and s:
                        alleles[allele] = s
                if alleles:
                    per_exon[exon_id] = alleles
            if per_exon:
                self.allele_db[locus] = per_exon
        self._typer = t

    # ------------------------------------------------------------- typing
    def type_contigs(self, contigs: dict[str, str],
                     truth: dict[str, tuple[str, str]] | None = None
                     ) -> list[AsmCall]:
        index = KmerIndex.build(contigs, k=20)
        seeder = Seeder(index)
        names = index.seq_names
        calls: list[AsmCall] = []
        for locus, per_exon in self.allele_db.items():
            per_contig: dict[str, dict[str, float]] = {}
            exon_hits: dict[str, dict[str, ExonHit]] = {}
            n_exons_hit: dict[str, int] = {}
            for exon_id, alleles in per_exon.items():
                # multiple diverse probes: first/last/middle of the sorted
                # allele list (single probe misses diverged gene copies)
                sorted_names = sorted(alleles)
                pick = {0, len(sorted_names) - 1, len(sorted_names) // 2,
                        len(sorted_names) // 4}
                probes = [alleles[sorted_names[i]] for i in sorted(pick)
                          ][:N_PROBES_PER_EXON]
                seen: set[str] = set()
                cands = []
                for probe in probes:
                    for c in seeder.candidates(probe):
                        key = names[c.seq_idx]
                        if key in seen:
                            continue
                        seen.add(key)
                        cands.append((c, len(probe)))
                for c, probe_len in cands:
                    contig_name = names[c.seq_idx]
                    contig_seq = contigs[contig_name]
                    if c.reverse:
                        contig_seq = revcomp(contig_seq)
                        ref_start = (len(contig_seq) - c.ref_start
                                     - probe_len)
                    else:
                        ref_start = c.ref_start
                    dists = self._exon_distances(alleles, contig_seq,
                                                 ref_start)
                    if dists is None:
                        continue
                    slot = per_contig.setdefault(contig_name, {})
                    for a, d in dists.items():
                        slot[a] = slot.get(a, 0.0) + d
                    exon_len = max(len(s) for s in alleles.values())
                    exon_hits.setdefault(contig_name, {})[exon_id] = \
                        ExonHit(exon_id, int(ref_start),
                                int(ref_start) + exon_len, bool(c.reverse))
                    n_exons_hit[contig_name] = \
                        n_exons_hit.get(contig_name, 0) + 1
            for contig_name, dist_map in per_contig.items():
                if n_exons_hit.get(contig_name, 0) < len(per_exon):
                    continue
                best_d = int(round(min(dist_map.values())))
                at_min = sorted(a for a, d in dist_map.items()
                                if int(round(d)) == best_d)
                total_len = sum(len(per_exon[e].get(at_min[0], ""))
                                for e in per_exon)
                if total_len and best_d > 0.3 * total_len:
                    continue
                call = AsmCall(
                    locus=locus, contig=contig_name,
                    alleles_at_min=at_min, edit_distance=best_d,
                    components=sorted(per_exon),
                    exon_hits=exon_hits.get(contig_name, {}))
                if truth and locus in truth:
                    self._truth_compare(call, dist_map, per_exon,
                                        truth[locus])
                calls.append(call)
        return calls

    def _truth_compare(self, call: AsmCall, dist_map: dict[str, float],
                       per_exon, truth_pair: tuple[str, str]) -> None:
        """minEditDistance_assembly_truth (+ which alleles) and
        minEditDistance_calledGenotype_truth (+ which pairs)."""
        truth_alleles = [t for t in truth_pair if t]
        # assembly vs truth: the summed exon distance of each truth allele
        # (they were scored together with everything else when in the DB)
        avail = {t: dist_map[t] for t in truth_alleles if t in dist_map}
        # allow 2-field prefix matches for truth given at lower resolution
        if not avail:
            from ..utils.nomenclature import alleles_compatible
            for t in truth_alleles:
                for a, d in dist_map.items():
                    if alleles_compatible(a, t, 2):
                        avail[t] = min(avail.get(t, np.inf), d)
        if avail:
            md = min(avail.values())
            call.min_dist_assembly_truth = int(round(md))
            call.min_dist_assembly_truth_alleles = sorted(
                t for t, d in avail.items() if round(d) == round(md))
        # called genotype vs truth: allele-sequence edit distance
        pairs: list[tuple[int, str]] = []
        for c in call.alleles_at_min:
            for t in truth_alleles:
                d = self._allele_pair_distance(c, t, per_exon)
                if d is not None:
                    pairs.append((d, f"{c}/{t}"))
        if pairs:
            md2 = min(d for d, _ in pairs)
            call.min_dist_called_truth = md2
            call.min_dist_called_truth_pairs = sorted(
                p for d, p in pairs if d == md2)

    def _allele_pair_distance(self, a: str, b: str, per_exon
                              ) -> int | None:
        """Summed per-exon unit-cost edit distance between two alleles'
        exon sequences (Text::LevenshteinXS equivalent via banded NW)."""
        from ..utils.nomenclature import alleles_compatible
        total = 0.0
        for exon_id, alleles in per_exon.items():
            sa = alleles.get(a)
            sb = alleles.get(b)
            if sb is None:
                for name, s in alleles.items():
                    if alleles_compatible(name, b, 2):
                        sb = s
                        break
            if sa is None or sb is None:
                return None
            if sa == sb:
                continue
            # TRUE global unit-cost edit distance (Text::LevenshteinXS
            # semantics) — the glocal banded NW used elsewhere in this
            # module skips leading/trailing reference bases for free,
            # which would under-report the distance when one allele's
            # exon is a substring of the other's
            total += _levenshtein(sa.encode(), sb.encode())
        return int(round(total))

    def _exon_distances(self, alleles: dict[str, str], contig_seq: str,
                        ref_start: int) -> dict[str, float] | None:
        """Banded unit-cost edit distance of every allele exon sequence vs
        the located contig window — one batched NW call on the device."""
        names = list(alleles)
        seqs = [alleles[n] for n in names]
        Lmax = max(len(s) for s in seqs)
        W = self.band
        B = len(seqs)
        reads = np.full((B, Lmax), 4, dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int64)
        refs = np.full((B, Lmax + W), 4, dtype=np.uint8)
        lo = ref_start - W // 2
        cb = contig_seq.encode()
        src_lo, src_hi = max(lo, 0), min(lo + Lmax + W, len(cb))
        window = np.full(Lmax + W, 4, dtype=np.uint8)
        if src_hi > src_lo:
            window[src_lo - lo:src_hi - lo] = _ENC[
                np.frombuffer(cb[src_lo:src_hi], np.uint8)]
        for bi, s in enumerate(seqs):
            reads[bi, :len(s)] = _ENC[np.frombuffer(s.encode(), np.uint8)]
            lens[bi] = len(s)
            refs[bi] = window
        self.stats.n_chain_extensions += B
        scores = self._nw.scores(reads, lens, refs)
        if not np.isfinite(scores).any() or scores.max() <= -1e29:
            return None
        return {n: float(-s) for n, s in zip(names, scores)}

    def _verify_located_candidate(self, window: str, cands, pkg_index,
                                  fasta: dict[str, str]):
        """Verify seed candidates by the banded edit distance of the exon
        window against each candidate's haplotype slice and return the
        min-distance one: an exon window that ALSO seeds on a paralogous
        haplotype must not hijack genePositions.tab — the true location
        wins on actual distance, not seed count (genePositions contract
        HLA-ASM.md:51-66).  Ties keep the seeder's order (most chain
        k-mers first)."""
        if len(cands) == 1:
            return cands[0]
        top = cands[:4]
        W = self.band
        L = len(window)
        wcodes = _ENC[np.frombuffer(window.encode(), np.uint8)]
        reads = np.empty((len(top), L), dtype=np.uint8)
        lens = np.full(len(top), L, dtype=np.int64)
        refs = np.full((len(top), L + W), 4, dtype=np.uint8)
        for bi, c in enumerate(top):
            # seeder candidates locate the ORIENTED window; reverse hits
            # anchor the window's reverse complement at ref_start
            if c.reverse:
                rc = wcodes[::-1].copy()
                acgt = rc < 4
                rc[acgt] = 3 - rc[acgt]
                reads[bi] = rc
            else:
                reads[bi] = wcodes
            hap_seq = fasta[pkg_index.seq_names[c.seq_idx]].encode()
            lo = int(c.ref_start) - W // 2
            src_lo, src_hi = max(lo, 0), min(lo + L + W, len(hap_seq))
            if src_hi > src_lo:
                refs[bi, src_lo - lo:src_hi - lo] = _ENC[
                    np.frombuffer(hap_seq[src_lo:src_hi], np.uint8)]
        self.stats.n_chain_extensions += len(top)
        scores = self._nw.scores(reads, lens, refs)
        scores = np.where(scores <= -1e29, -np.inf, scores)
        return top[int(np.argmax(scores))]   # stable: first max wins

    # ----------------------------------------------- reference coordinates
    def _reference_positions(self, contigs: dict[str, str],
                             calls: list[AsmCall]):
        """Locate each called exon window against the package's linearized
        haplotypes -> (hap_name, hap_pos, chr, ref_pos_1based) per exon.
        Real packages carry GRCh38 coordinates in sequences.txt
        (HLA-LA.cpp:265-324); simulated ones yield hap-local positions."""
        try:
            fasta = {s.fasta_id: self.pkg.prg_fasta()[s.fasta_id]
                     for s in self.pkg.sequences()}
            pkg_index = KmerIndex.build(fasta, k=20)
        except Exception:  # noqa: BLE001
            return {}
        pkg_seeder = Seeder(pkg_index)
        seq_infos = {s.fasta_id: s for s in self.pkg.sequences()}
        out = {}
        for call in calls:
            cseq = contigs[call.contig]
            for exon_id, hit in call.exon_hits.items():
                oriented = revcomp(cseq) if hit.reverse else cseq
                window = oriented[max(0, hit.contig_start):hit.contig_stop]
                if len(window) < pkg_index.k:
                    continue
                cands = pkg_seeder.candidates(window)
                if not cands:
                    continue
                c = self._verify_located_candidate(window, cands,
                                                   pkg_index, fasta)
                hap = pkg_index.seq_names[c.seq_idx]
                info = seq_infos.get(hap)
                chrom, ref_pos = "", -1
                if info is not None and info.chrom:
                    chrom = info.chrom
                    ref_pos = info.start_1based + int(c.ref_start)
                out[(call.contig, call.locus, exon_id)] = (
                    hap, int(c.ref_start), chrom, ref_pos)
        return out

    # --------------------------------------------------------------- output
    def write_outputs(self, calls: list[AsmCall], out_dir: str,
                      contigs: dict[str, str] | None = None) -> None:
        """summary.txt + genePositions.tab (HLA-ASM.md:51-66 contract)."""
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "summary.txt"), "w") as fh:
            fh.write("contigID\tlocus\tcalledGenotypes\tcomponents\t"
                     "editDistance_calledGenotypes_assembly\t"
                     "minEditDistance_assembly_truth\t"
                     "minEditDistance_calledGenotype_truth\t"
                     "minEditDistance_assembly_truth_whichAlleles\t"
                     "minEditDistance_calledGenotype_truth_whichAlleles\n")
            for c in calls:
                if self._typer.can_translate_locus(c.locus):
                    g, _ = self._typer.translate_to_g(c.alleles_at_min)
                else:
                    g = ";".join(c.alleles_at_min)
                fh.write("\t".join([
                    c.contig, c.locus, g, ";".join(c.components),
                    str(c.edit_distance),
                    "" if c.min_dist_assembly_truth is None
                    else str(c.min_dist_assembly_truth),
                    "" if c.min_dist_called_truth is None
                    else str(c.min_dist_called_truth),
                    ";".join(c.min_dist_assembly_truth_alleles),
                    ";".join(c.min_dist_called_truth_pairs),
                ]) + "\n")
        ref_pos = self._reference_positions(contigs, calls) if contigs \
            else {}
        with open(os.path.join(out_dir, "genePositions.tab"), "w") as fh:
            fh.write("Locus\tExon\tContig\tContigStart\tContigStop\t"
                     "Strand\tRefSequence\tRefSeqPos\tChr\tRefPos_1based\n")
            for c in calls:
                for exon_id, hit in sorted(c.exon_hits.items()):
                    hap, hpos, chrom, rpos = ref_pos.get(
                        (c.contig, c.locus, exon_id), ("", -1, "", -1))
                    fh.write(f"{c.locus}\t{exon_id}\t{c.contig}\t"
                             f"{hit.contig_start}\t{hit.contig_stop}\t"
                             f"{'-' if hit.reverse else '+'}\t"
                             f"{hap}\t{hpos}\t{chrom}\t{rpos}\n")


def _levenshtein(a: bytes, b: bytes) -> int:
    """Exact unit-cost edit distance, numpy row DP.  The serial insertion
    recurrence cur[j] = min(base[j], cur[j-1] + 1) is a min-plus prefix
    scan, done exactly with the integer drift trick."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    m = len(b)
    bb = np.frombuffer(b, np.uint8)
    ar = np.arange(m + 1, dtype=np.int64)
    prev = ar.copy()
    for i, ca in enumerate(a):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i + 1
        np.minimum(prev[:-1] + (bb != ca), prev[1:] + 1, out=cur[1:])
        cur = np.minimum.accumulate(cur - ar) + ar
        prev = cur
    return int(prev[-1])
