"""Cohort validation harness.

Reference: HLAtypeinference_validation.pl — compares inferred vs truth HLA
types across cohorts simultaneously at 2-digit (1 field), 4-digit
(2 fields), and G-group resolution (per-locus N / CallRate / Accuracy,
lines 1150-1190); groups calls into quality-calibration baskets (lines
357-371, 555-581); tracks per-allele correct/incorrect counts
(reference_predictions / imputations_predictions); and, for each discordant
sample x locus, performs a pileup-based error analysis — inferred vs
apparently-true allele exon sequences aligned column by column against the
read pileup (lines 826-1000, output temp/hla_validation/pileup_*).  Plus
the batch drivers Perl/applyToAllBAMs.pl / validationBAMs.txt.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .graph.package import GraphPackage
from .utils.nomenclature import (allele_list_compatible, read_truth_file)
from .utils.timing import log_progress

RESOLUTIONS = (("2digit", 1), ("4digit", 2), ("G", 4))


@dataclass
class LocusStats:
    n_samples: int = 0
    n_called: int = 0            # alleles with a non-empty call
    n_alleles: int = 0           # 2 * samples with truth
    correct: dict[str, int] = field(default_factory=dict)  # res -> count


@dataclass
class CohortReport:
    # resolution (nomenclature fields) for calibration, per-allele stats
    # and discordance detection; the summary still reports every
    # RESOLUTIONS column (--resolution from the CLI)
    primary_resolution: int = 2
    per_locus: dict[str, LocusStats] = field(default_factory=dict)
    # calibration: bucket -> [(q, correct?)], at primary resolution
    calibration: list[tuple[float, bool]] = field(default_factory=list)
    # (locus, allele) -> {"correct": n, "incorrect": n}, both directions
    called_stats: dict[tuple[str, str], dict[str, int]] = \
        field(default_factory=dict)
    truth_stats: dict[tuple[str, str], dict[str, int]] = \
        field(default_factory=dict)
    discordant: list[tuple[str, str, tuple, tuple]] = \
        field(default_factory=list)     # (sample, locus, called, truth)
    n_samples: int = 0

    def accuracy(self, res: str = "4digit") -> float:
        tot = sum(s.n_alleles for s in self.per_locus.values())
        cor = sum(s.correct.get(res, 0) for s in self.per_locus.values())
        return cor / tot if tot else 0.0

    # alias used by the CLI
    @property
    def total_accuracy(self) -> float:
        return self.accuracy("4digit")

    def add_sample(self, sample_id: str,
                   inferred: dict[str, tuple[str, str, float, float]],
                   truth: dict[str, tuple[str, str]]) -> None:
        self.n_samples += 1
        for locus, (t1, t2) in truth.items():
            st = self.per_locus.setdefault(locus, LocusStats())
            st.n_samples += 1
            st.n_alleles += 2
            called = inferred.get(locus)
            if called is None:
                continue
            c1, c2, q1, q2 = called
            st.n_called += int(bool(c1)) + int(bool(c2))
            for res_name, res in RESOLUTIONS:
                straight = (allele_list_compatible(c1, t1, res)
                            + allele_list_compatible(c2, t2, res))
                crossed = (allele_list_compatible(c1, t2, res)
                           + allele_list_compatible(c2, t1, res))
                n_corr = max(straight, crossed)
                st.correct[res_name] = st.correct.get(res_name, 0) + n_corr
            # calibration + per-allele stats at the primary resolution,
            # best assignment
            pr = self.primary_resolution
            straight = (allele_list_compatible(c1, t1, pr),
                        allele_list_compatible(c2, t2, pr))
            crossed = (allele_list_compatible(c1, t2, pr),
                       allele_list_compatible(c2, t1, pr))
            pairing = (list(zip((c1, c2), (t1, t2), straight))
                       if sum(straight) >= sum(crossed)
                       else list(zip((c1, c2), (t2, t1), crossed)))
            for (c, t, ok), q in zip(pairing, (q1, q2)):
                self.calibration.append((q, bool(ok)))
                key = "correct" if ok else "incorrect"
                self.called_stats.setdefault((locus, c), {}).setdefault(
                    key, 0)
                self.called_stats[(locus, c)][key] += 1
                self.truth_stats.setdefault((locus, t), {}).setdefault(
                    key, 0)
                self.truth_stats[(locus, t)][key] += 1
            if sum(x[2] for x in pairing) < 2:
                self.discordant.append((sample_id, locus, (c1, c2),
                                        (t1, t2)))

    # ----------------------------------------------------------- outputs
    def write_summary(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("Locus\tN\tCallRate\t"
                     + "\t".join(f"Accuracy_{r}" for r, _ in RESOLUTIONS)
                     + "\n")
            for locus in sorted(self.per_locus):
                st = self.per_locus[locus]
                cr = st.n_called / st.n_alleles if st.n_alleles else 0.0
                accs = [st.correct.get(r, 0) / st.n_alleles
                        if st.n_alleles else 0.0 for r, _ in RESOLUTIONS]
                fh.write(f"{locus}\t{st.n_samples}\t{cr:.4f}\t"
                         + "\t".join(f"{a:.4f}" for a in accs) + "\n")
            fh.write("TOTAL\t{}\t\t".format(self.n_samples)
                     + "\t".join(f"{self.accuracy(r):.4f}"
                                 for r, _ in RESOLUTIONS) + "\n")

    def write_calibration(self, path: str) -> None:
        """Quality-calibration table: Q1 buckets vs empirical accuracy
        (the calibration_baskets of the reference, lines 357-371)."""
        buckets = [(0.0, 0.5), (0.5, 0.8), (0.8, 0.9), (0.9, 0.99),
                   (0.99, 1.0001)]
        with open(path, "w") as fh:
            fh.write("QualityBucket\tN\tMeanQ\tEmpiricalAccuracy\n")
            for lo, hi in buckets:
                sel = [(q, ok) for q, ok in self.calibration
                       if lo <= q < hi]
                if not sel:
                    fh.write(f"[{lo},{hi})\t0\t\t\n")
                    continue
                mq = sum(q for q, _ in sel) / len(sel)
                acc = sum(ok for _, ok in sel) / len(sel)
                fh.write(f"[{lo},{hi})\t{len(sel)}\t{mq:.4f}\t{acc:.4f}\n")

    def write_allele_stats(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("Direction\tLocus\tAllele\tCorrect\tIncorrect\n")
            for name, stats in (("called", self.called_stats),
                                ("truth", self.truth_stats)):
                for (locus, allele), d in sorted(stats.items()):
                    fh.write(f"{name}\t{locus}\t{allele}\t"
                             f"{d.get('correct', 0)}\t"
                             f"{d.get('incorrect', 0)}\n")


def read_sample_sheet(path: str) -> list[tuple[str, str]]:
    """validationBAMs.txt -> [(sampleID, bamPath)].  Two formats:

    - simple: 'sampleID <whitespace> bamPath' lines
    - the reference's cohort sheet (validationBAMs.txt, parsed by
      Perl/applyToAllBAMs.pl:28-70): tab-separated 'cohort TAB path
      [TAB label]'; the sample ID is the explicit label when given
      (Platinum rows) else '<cohort>_<basename stem>' (the 1000G
      convention); a leading empty cohort field means
      'TAB sampleID TAB path'.
    """
    out = []
    with open(path) as fh:
        for line in fh:
            raw = line.rstrip("\r\n")
            if not raw.strip() or raw.lstrip().startswith("#"):
                continue
            if "\t" in raw:
                f = [x.strip() for x in raw.split("\t")]
                low = (f[1] if len(f) > 1 else "").lower()
                if f[0] == "" and len(f) >= 3 and f[2]:
                    out.append((f[1], f[2]))      # '' TAB sample TAB path
                    continue
                # the cohort sheet always carries >= 3 columns (label /
                # technology, possibly empty); a plain 2-field tab row is
                # the simple 'sampleID TAB path' format and must keep its
                # sample ID (and any spaces in either field) verbatim
                if len(f) == 2 and f[0] and f[1]:
                    out.append((f[0], f[1]))
                    continue
                if len(f) >= 3 and (low.endswith(".bam")
                                    or low.endswith(".cram")):
                    label = f[2] if len(f) > 2 and f[2] else ""
                    if not label:
                        stem = os.path.basename(f[1]).split(".")[0]
                        if stem == "merged":
                            # generic per-sample dirs (.../SRR702070/
                            # merged.bam): the directory carries the ID
                            stem = os.path.basename(
                                os.path.dirname(f[1]))
                        label = f"{f[0]}_{stem}"
                    out.append((label, f[1]))
                    continue
            f = raw.split()
            if len(f) >= 2 and f[0].lower() not in ("sampleid",
                                                    "individualid"):
                out.append((f[0], f[1]))
    return out


def read_bestguess_with_q(path: str) -> dict[str, tuple[str, str, float,
                                                        float]]:
    """R1_bestguess(_G).txt -> {locus: (allele1, allele2, q1, q2)}."""
    out: dict[str, dict[int, tuple[str, float]]] = {}
    with open(path) as fh:
        fh.readline()
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 4:
                continue
            try:
                q = float(f[3])
            except ValueError:
                q = 0.0
            out.setdefault(f[0], {})[int(f[1])] = (f[2], q)
    return {loc: (d.get(1, ("", 0.0))[0], d.get(2, ("", 0.0))[0],
                  d.get(1, ("", 0.0))[1], d.get(2, ("", 0.0))[1])
            for loc, d in out.items()}


# ------------------------------------------------- pileup error analysis
def _load_pileup(path: str) -> dict[tuple[str, int], tuple[int, str]]:
    """R1_pileup_<locus>.txt -> {(exon_idx, exon_pos): (coverage, detail)}
    (load_pileup, HLAtypeinference_validation.pl:1524-1558)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 3:
                continue
            detail = f[3] if len(f) > 3 else ""
            out[(f[0], int(f[1]))] = (int(f[2]), detail)
    return out


def _find_allele_row(rows: dict[str, list[str]], allele: str
                     ) -> list[str] | None:
    """Exact row, else any member of a ';'/G ambiguity list, else a row
    sharing the first two fields (twoValidationAlleles_2_proper_names
    semantics, reference lines 1589-1694)."""
    for cand in allele.split(";"):
        if cand in rows:
            return rows[cand]
    for cand in allele.split(";"):
        for name, row in rows.items():
            if allele_list_compatible(name, cand, 2):
                return row
    return None


def pileup_error_analysis(pkg: GraphPackage, sample_out: str, locus: str,
                          called: tuple[str, str], truth: tuple[str, str],
                          out_path: str, typer=None, *, device) -> int:
    """Column-by-column comparison of inferred vs apparently-true allele
    exon sequences, annotated with the read pileup, for a discordant call
    (reference lines 882-1000).  Returns the number of columns where the
    inferred and true genotypes disagree (and writes them).  Without a
    `typer`, one is made on `device`."""
    from .models.typer import HLATyper
    from .utils.config import LOCI_2_EXONS
    if typer is None:
        typer = HLATyper(pkg, device=device)
    seg_map = typer.graph_genes.get(locus, {})
    # the typer's pileup enumerates only the TYPED exons, in LOCI_2_EXONS
    # order (typer._combined_exon_matrix) — mirror that exactly, or
    # coverage would be read from the wrong exon on multi-exon real loci
    typed_exons = [(e, seg_map[e]) for e in LOCI_2_EXONS.get(locus, [])
                   if e in seg_map] or sorted(seg_map.items())
    pileup_path = os.path.join(sample_out, "hla", f"R1_pileup_{locus}.txt")
    pileup = _load_pileup(pileup_path) if os.path.exists(pileup_path) else {}
    n_diff = 0
    with open(out_path, "w") as fh:
        fh.write(f"{locus}\tInferred: {called[0]} / {called[1]}\t"
                 f"Truth: {truth[0]} / {truth[1]}\n")
        fh.write("Exon\tPos\tInferred1\tInferred2\tTrue1\tTrue2\t"
                 "Coverage\tPileup\n")
        for exon_ord, (exon_id, fn) in enumerate(typed_exons):
            cols, rows = pkg.read_segment(fn)
            inf = [_find_allele_row(rows, a) for a in called]
            tru = [_find_allele_row(rows, a) for a in truth]
            if any(x is None for x in inf + tru):
                fh.write(f"# {exon_id}: allele rows not all present "
                         f"(inferred {called}, truth {truth})\n")
                continue
            for j in range(len(cols)):
                gi = (inf[0][j], inf[1][j])
                gt = (tru[0][j], tru[1][j])
                if sorted(gi) == sorted(gt):
                    continue
                n_diff += 1
                # pileup rows key exons by their 0-based ordinal within
                # the locus (typer's exon_idx), positions per-exon
                cov, detail = pileup.get((str(exon_ord), j), (0, ""))
                fh.write(f"{exon_id}\t{j}\t{gi[0]}\t{gi[1]}\t{gt[0]}\t"
                         f"{gt[1]}\t{cov}\t{detail}\n")
    return n_diff


def validate_cohort(pkg: GraphPackage, samples: list[tuple[str, str]],
                    truth_path: str, out_dir: str, device,
                    resolution: int = 2, use_g: bool = True,
                    n_hosts: int = 1, host_idx: int = 0,
                    ref: str | None = None,
                    sharded=None) -> CohortReport | None:
    """`device`: where each sample is typed and where the typer of the
    pileup analysis is made.
    `sharded`: a parallel.mesh.Mesh; every rank of it calls this with the
    same arguments and each sample is typed on all of them (the reference's
    backend="sharded").  Rank 0 alone writes and returns the report; the
    other ranks return None.
    n_hosts/host_idx: deterministic sample-sheet sharding for multi-host
    cohort runs (the reference's per-sample job arrays,
    Perl/applyToAllBAMs.pl + makefile_cluster3): host i processes samples
    i, i+n, i+2n, ...; each host writes its own report files.
    `ref`: reference FASTA for CRAM sample sheets (decode reference)."""
    from .io.bam import bam_to_fastq_pairs, extract_reads, is_cram
    from .models.pipeline import run_hla_typing

    if n_hosts > 1:
        samples = samples[host_idx::n_hosts]
        log_progress(f"host {host_idx}/{n_hosts}: {len(samples)} samples")
    truth_all = read_truth_file(truth_path)
    report = CohortReport(primary_resolution=resolution)
    writes = sharded is None or sharded.rank == 0
    if writes:
        os.makedirs(out_dir, exist_ok=True)
    cram_ref = None
    for sample_id, bam in samples:
        if sample_id not in truth_all:
            log_progress(f"{sample_id}: no truth, skipping")
            continue
        log_progress(f"validating {sample_id} <- {bam}")
        if is_cram(bam) and cram_ref is None and ref:
            from .io.fasta import read_fasta
            cram_ref = read_fasta(ref)     # shared across the cohort
        by_name, _contigs = extract_reads(bam, None,
                                          cram_reference=cram_ref)
        pairs, unpaired = bam_to_fastq_pairs(by_name)
        sample_out = os.path.join(out_dir, sample_id)
        # the sample's full read set, exactly like the production CLI
        # path (cli.py action_hla) — dropping unpaired reads here would
        # validate a different pipeline than the one shipped
        run_hla_typing(pkg, pairs=pairs, unpaired=unpaired,
                       output_dir=sample_out, device=device, sharded=sharded)
        if not writes:
            continue
        # G calls where available, with a PER-LOCUS fall-back to the raw
        # calls (the G writer skips loci with no G-group table; those
        # must not score as no-calls)
        inferred = read_bestguess_with_q(
            os.path.join(sample_out, "hla", "R1_bestguess.txt"))
        g_path = os.path.join(sample_out, "hla", "R1_bestguess_G.txt")
        if use_g and os.path.exists(g_path):
            inferred.update(read_bestguess_with_q(g_path))
        report.add_sample(sample_id, inferred, truth_all[sample_id])

    if not writes:
        return None
    suffix = f"_host{host_idx}" if n_hosts > 1 else ""
    report.write_summary(os.path.join(out_dir,
                                      f"validation_report{suffix}.txt"))
    report.write_calibration(os.path.join(
        out_dir, f"validation_calibration{suffix}.txt"))
    report.write_allele_stats(os.path.join(
        out_dir, f"validation_allele_stats{suffix}.txt"))
    # pileup-based error analysis of every discordant call (one shared
    # typer: per-call init re-reads the segment DB)
    shared_typer = None
    if report.discordant:
        from .models.typer import HLATyper
        shared_typer = HLATyper(pkg, device=device)
    for sample_id, locus, called, truth in report.discordant:
        out_path = os.path.join(out_dir,
                                f"pileup_analysis_{sample_id}_{locus}.txt")
        try:
            n = pileup_error_analysis(pkg, os.path.join(out_dir, sample_id),
                                      locus, called, truth, out_path,
                                      typer=shared_typer, device=device)
            log_progress(f"discordant {sample_id}/{locus}: {n} "
                         f"disagreeing columns -> {out_path}")
        except FileNotFoundError as e:
            # expected on sheets whose sample dirs were pruned or whose
            # locus has no segment files; anything else (e.g. a corrupted
            # pileup file -> ValueError) is a genuine bug and must raise
            log_progress(f"pileup analysis skipped for {sample_id}/{locus}:"
                         f" {e}")
    return report
