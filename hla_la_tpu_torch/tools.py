"""Data-ops toolbox — equivalents of the reference's Perl/ scripts
(SURVEY.md §2.2): downsampleBAM, reduceBAM2PRG, truthToVCF,
amendSecondaryAlignmentSequences, analyseGeneCoverage, compareUtilizedReads.
Batch-over-cohort drivers (applyToAllBAMs) live in validation.py.
"""

from __future__ import annotations

import os

import numpy as np

from .graph.package import GraphPackage
from .io.bam import (BamReader, BamRecord, BamWriter, FLAG_SECONDARY,
                     FLAG_SUPPLEMENTARY)


def downsample_bam(in_path: str, out_path: str, fraction: float,
                   seed: int = 0) -> tuple[int, int]:
    """Keep each read *pair* with probability `fraction` (downsampleBAM.pl).
    Name-hash based so both mates survive together.  Returns (kept, total)."""
    rd = BamReader(in_path)
    w = BamWriter(out_path, rd.references, rd.header_text)
    import zlib
    rng_salt = (seed * 2654435761 + 1) & 0xFFFFFFFF
    kept = total = 0
    for rec in rd:
        total += 1
        # content-based hash: builtin hash() is salted per process
        # (PYTHONHASHSEED), which would make the subsample irreproducible
        h = zlib.crc32(rec.name.encode(), rng_salt)
        if (h % 10_000) / 10_000.0 < fraction:
            w.write(rec)
            kept += 1
    w.close()
    rd.close()
    return kept, total


def reduce_bam_to_prg(in_path: str, pkg: GraphPackage, out_path: str,
                      more_reference_dirs: list[str] = ()) -> int:
    """Keep only reads overlapping the PRG's known regions (+ unmapped)
    (reduceBAM2PRG.pl).  Returns number of records written."""
    from .io.bam import extract_reads
    # header only: stream (native would inflate the whole file)
    rd = BamReader(in_path, use_native=False)
    contigs = rd.contigs()
    references, header_text = rd.references, rd.header_text
    rd.close()
    spec = pkg.match_known_reference(contigs, list(more_reference_dirs))
    regions = None
    if spec is not None:
        regions = []
        for cid, rec in pkg.known_references(list(more_reference_dirs))[spec].items():
            if rec.get("ExtractCompleteContig") in ("1", "yes"):
                regions.append((cid, 0, 0))
            elif rec.get("PartialExtraction_Start"):
                regions.append((cid, int(rec["PartialExtraction_Start"]) - 1,
                                int(rec["PartialExtraction_Stop"])))
    else:
        import sys
        print(f"WARNING: {in_path}: BAM reference not in knownReferences — "
              "keeping ALL reads (nothing to reduce against)",
              file=sys.stderr, flush=True)
    by_name, _ = extract_reads(in_path, regions, with_tags=True)
    w = BamWriter(out_path, references, header_text)
    n = 0
    for recs in by_name.values():
        for r in recs:
            w.write(r)
            n += 1
    w.close()
    return n


def amend_secondary_alignment_sequences(in_path: str, out_path: str) -> int:
    """Fill SEQ/QUAL of secondary records from the primary record of the same
    read (amendSecondaryAlignmentSequences.pl; bwa writes secondary records
    with '*' sequences).  Returns number amended."""
    rd = BamReader(in_path)
    primaries: dict[tuple[str, bool], BamRecord] = {}
    records = list(rd)
    for r in records:
        if not (r.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) and r.seq:
            primaries[(r.name, r.is_read1)] = r
    w = BamWriter(out_path, rd.references, rd.header_text)
    amended = 0
    from .sim.read_sim import revcomp
    for r in records:
        if (r.flag & FLAG_SECONDARY) and not r.seq:
            p = primaries.get((r.name, r.is_read1))
            if p is not None:
                seq, qual = p.seq, p.qual
                if p.is_reverse != r.is_reverse:
                    seq = revcomp(seq)
                    qual = qual[::-1]
                r.seq = seq
                r.qual = qual
                amended += 1
        w.write(r)
    w.close()
    rd.close()
    return amended


def truth_to_vcf(reference_row: str, hap1: str, hap2: str, contig: str,
                 out_path: str) -> int:
    """Aligned haplotype rows (gapped MSA, '_' = gap) vs the reference row ->
    minimal VCF of SNPs and indels (truthToVCF.pl role).  Returns number of
    records."""
    assert len(reference_row) == len(hap1) == len(hap2)
    n = 0
    with open(out_path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={contig}>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 "SAMPLE\n")
        L = len(reference_row)
        ref_before = 0   # ref bases consumed before column i
        i = 0
        while i < L:
            concordant = (reference_row[i] == hap1[i] == hap2[i])
            if concordant:
                if reference_row[i] != "_":
                    ref_before += 1
                i += 1
                continue
            # variant run: until the next fully-concordant non-gap column
            j = i
            while j < L and not (reference_row[j] == hap1[j] == hap2[j]
                                 != "_"):
                j += 1
            run_ref = reference_row[i:j].replace("_", "")
            run_a1 = hap1[i:j].replace("_", "")
            run_a2 = hap2[i:j].replace("_", "")
            pos = ref_before + 1       # 1-based start of run in ref coords
            if not run_ref or not run_a1 or not run_a2:
                # indel: left-anchor with N (no access to flanking base
                # here).  The anchor stands for the reference base BEFORE
                # the event, so the record position moves to that base
                # (pos = ref_before); at the very start of the contig the
                # unanchored pos = 1 is kept (right-anchored edge case)
                run_ref = "N" + run_ref
                run_a1 = "N" + run_a1
                run_a2 = "N" + run_a2
                if ref_before >= 1:
                    pos = ref_before
            alts: list[str] = []
            gt = []
            for a in (run_a1, run_a2):
                if a == run_ref:
                    gt.append("0")
                else:
                    if a not in alts:
                        alts.append(a)
                    gt.append(str(alts.index(a) + 1))
            fh.write(f"{contig}\t{pos}\t.\t{run_ref}\t"
                     f"{','.join(alts) if alts else '.'}\t.\tPASS\t.\tGT\t"
                     f"{gt[0]}|{gt[1]}\n")
            n += 1
            ref_before += len(reference_row[i:j].replace("_", ""))
            i = j
        return n


def read_pgf_loci(path: str) -> dict[str, dict]:
    """Parse the PGF reference-haplotype table (Perl/PGF_loci_and_alleles
    .txt, consumed by the reference's truthToVCF.pl:107-137): per locus the
    allele carried by the PGF haplotype GRCh38 embeds, its strand, and the
    0-based B37/B38 coordinate spans.  Keys are the table's locus names
    (e.g. 'HLA-A'); values carry allele/strand/b37/b38."""
    out: dict[str, dict] = {}
    with open(path) as fh:
        header = fh.readline().rstrip("\r\n").split("\t")
        idx = {k: i for i, k in enumerate(header)}
        for need in ("Locus", "PGFAllele", "Strand",
                     "FirstBase_B37_0based", "LastBase_B37_0based",
                     "FirstBase_B38_0based", "LastBase_B38_0based"):
            if need not in idx:
                raise ValueError(f"PGF table: missing column {need}")
        for line in fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            f = line.split("\t")
            allele = f[idx["PGFAllele"]]
            if "*" not in allele:
                raise ValueError(f"PGF table: bad allele {allele!r}")
            b37 = (int(f[idx["FirstBase_B37_0based"]]),
                   int(f[idx["LastBase_B37_0based"]]))
            b38 = (int(f[idx["FirstBase_B38_0based"]]),
                   int(f[idx["LastBase_B38_0based"]]))
            if not (b37[0] < b37[1] and b38[0] < b38[1]):
                raise ValueError(f"PGF table: bad span for {allele}")
            out[f[idx["Locus"]]] = {
                "allele": allele,
                "strand": f[idx["Strand"]],
                "b37": b37,
                "b38": b38,
            }
    return out


def analyse_gene_coverage(output_dir: str) -> dict[str, dict]:
    """Per-gene coverage summary from R1_pileup_<locus>.txt files
    (analyseGeneCoverage.pl role)."""
    out = {}
    for fn in sorted(os.listdir(output_dir)):
        if not fn.startswith("R1_pileup_") or not fn.endswith(".txt"):
            continue
        locus = fn[len("R1_pileup_"):-4]
        covs = []
        with open(os.path.join(output_dir, fn)) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) >= 3:
                    covs.append(int(f[2]))
        if covs:
            arr = np.asarray(covs)
            out[locus] = dict(mean=float(arr.mean()),
                              median=float(np.median(arr)),
                              minimum=int(arr.min()),
                              zero_columns=int((arr == 0).sum()),
                              n_columns=len(arr))
    return out


def compare_utilized_reads(dir_a: str, dir_b: str) -> dict[str, dict]:
    """Diff the R1_readIDs_<locus>.txt files of two runs
    (compareUtilizedReads.pl role)."""
    def load(d):
        out = {}
        for fn in os.listdir(d):
            if fn.startswith("R1_readIDs_") and fn.endswith(".txt"):
                locus = fn[len("R1_readIDs_"):-4]
                with open(os.path.join(d, fn)) as fh:
                    out[locus] = {l.strip() for l in fh if l.strip()}
        return out

    a = load(dir_a)
    b = load(dir_b)
    report = {}
    for locus in sorted(set(a) | set(b)):
        sa = a.get(locus, set())
        sb = b.get(locus, set())
        report[locus] = dict(only_a=len(sa - sb), only_b=len(sb - sa),
                             shared=len(sa & sb))
    return report


def extract_kmer_counts(reads, exon_sequences: dict[str, str],
                        k: int = 31) -> dict[str, dict[str, int]]:
    """Per-exon k-mer counts over input reads (extractkMerCounts.pl role,
    HLA-LA.pl:543-552): for each named exon sequence, how often each of its
    k-mers occurs in the read set."""
    from .models.typer import _canonical
    read_counts: dict[str, int] = {}
    for r in reads:
        s = r.seq if hasattr(r, "seq") else r
        for i in range(len(s) - k + 1):
            mer = _canonical(s[i:i + k])
            read_counts[mer] = read_counts.get(mer, 0) + 1
    out: dict[str, dict[str, int]] = {}
    for name, seq in exon_sequences.items():
        seq = seq.replace("_", "")
        counts = {}
        for i in range(len(seq) - k + 1):
            mer = seq[i:i + k]
            counts[mer] = read_counts.get(_canonical(mer), 0)
        out[name] = counts
    return out


def graph_from_mfa(mfa_path: str, out_dir: str,
                   compile_now: bool = True):
    """Build a complete graph package from a multiple-FASTA alignment
    (Perl/graphFromMFA.pl role: MFA columns become PRG levels; '-'/'.'
    gap characters are normalised to '_').  Every MFA row becomes both a
    linearized haplotype (for seeding) and a segment allele (for typing)."""
    import numpy as np

    from .graph.package import write_package
    from .graph.prg import prg_from_haplotypes
    from .io.fasta import read_fasta

    rows = read_fasta(mfa_path)
    if not rows:
        raise ValueError(f"no sequences in {mfa_path}")
    names = list(rows)
    aligned = [rows[n].upper().replace("-", "_").replace(".", "_")
               for n in names]
    L = len(aligned[0])
    if any(len(a) != L for a in aligned):
        raise ValueError("MFA rows must be equal length (aligned)")
    prg = prg_from_haplotypes(aligned)
    hap_seqs = {}
    for n, a in zip(names, aligned):
        arr = np.frombuffer(a.encode(), dtype=np.uint8)
        lv = np.nonzero(arr != ord("_"))[0].astype(np.int64)
        hap_seqs[n] = (a.replace("_", ""), lv)
    segments = [("segment_MFA.txt", [f"L{i}" for i in range(L)],
                 {n: list(a) for n, a in zip(names, aligned)})]
    return write_package(out_dir, prg, segments, hap_seqs,
                         compile_now=compile_now)


def find_gene_reads_in_bam(bam_path: str, panel_fasta: str, k: int = 31,
                           min_kmers: int = 3) -> dict[str, int]:
    """Count BAM reads that carry k-mers of each panel sequence
    (Perl/findKIRinBAM.pl role).  A read is attributed to every panel
    sequence for which it shares >= min_kmers canonical k-mers."""
    from .io.bam import extract_reads
    from .io.fasta import read_fasta
    from .models.typer import KmerCountIndex

    panel = read_fasta(panel_fasta)
    indexes = {name: KmerCountIndex.build([seq.replace("_", "")], k)
               for name, seq in panel.items()}
    hits = {name: 0 for name in panel}
    by_name, _contigs = extract_reads(bam_path, None)
    for recs in by_name.values():
        for rec in recs:
            for name, idx in indexes.items():
                c, valid = idx.counts_for(rec.seq)
                if int(((c > 0) & valid).sum()) >= min_kmers:
                    hits[name] += 1
    return hits


def rename_bam_contigs(in_path: str, out_path: str,
                       mapping: dict[str, str]) -> int:
    """Rewrite a BAM with renamed reference contigs
    (Perl/convertBAM_1000G_to_Primary.pl role: 1000G-style names ->
    primary-assembly names).  Contigs absent from `mapping` keep their
    name.  Returns the number of records written."""
    from .io.bam import BamReader, BamWriter

    rd = BamReader(in_path)
    refs = [(mapping.get(name, name), length)
            for name, length in rd.references]
    # keep the text header (@RG/@PG/@CO, sort order), renaming @SQ SN:
    # fields to stay consistent with the renamed binary references
    header = rd.header_text
    if header:
        out_lines = []
        for line in header.splitlines():
            if line.startswith("@SQ"):
                fields = line.split("\t")
                for fi, f in enumerate(fields):
                    if f.startswith("SN:"):
                        fields[fi] = "SN:" + mapping.get(f[3:], f[3:])
                line = "\t".join(fields)
            out_lines.append(line)
        header = "\n".join(out_lines)
        if rd.header_text.endswith("\n"):
            header += "\n"
    w = BamWriter(out_path, refs, header)
    n = 0
    for rec in rd:
        w.write(rec)
        n += 1
    w.close()
    rd.close()
    return n


def sample_reference_genomes(pkg: GraphPackage, n_samples: int = 8,
                             seed: int = 0) -> list[str]:
    """Write sampled reference-genome subsets into the package
    (sampleReferenceGenome.pl role, lines 59-86: sample 1 keeps every
    PRG-related sequence; samples 2..n keep each sequence with probability
    2/(n-1)).  Writes sampledReferenceGenomes/<i>.fa plus the
    sampledReferenceGenomes.txt list; returns the FASTA paths."""
    import numpy as np

    from .io.fasta import write_fasta

    rng = np.random.default_rng(seed)
    fasta = pkg.prg_fasta()
    seqs = {info.chrom or info.fasta_id: fasta[info.fasta_id]
            for info in pkg.sequences()}
    out_dir = os.path.join(pkg.dir, "sampledReferenceGenomes")
    os.makedirs(out_dir, exist_ok=True)
    prop = 2.0 / max(n_samples - 1, 1)
    paths = []
    with open(os.path.join(pkg.dir, "sampledReferenceGenomes.txt"),
              "w") as lst:
        for i in range(1, n_samples + 1):
            if i == 1:
                chosen = dict(seqs)
            else:
                chosen = {k: v for k, v in seqs.items()
                          if rng.random() <= prop}
            path = os.path.join(out_dir, f"{i}.fa")
            write_fasta(path, chosen)
            lst.write(path + "\n")
            paths.append(path)
    return paths


def compare_tool_calls(our_calls_path: str, other_calls_path: str,
                       truth_path: str, out_path: str,
                       other_name: str = "external") -> dict:
    """Side-by-side concordance of this framework's calls vs an external
    tool's calls against a shared truth table — the role of the reference's
    forPaper/runxHLA.pl + runAllxHLA.pl competitor comparison (SURVEY §2.2)
    without shelling out to the competitor (its calls file is the input).

    Calls files: either R1_bestguess(_G).txt format or the truth-table
    format (IndividualID + two columns per locus).  Returns {tool: {res:
    accuracy}} and writes a per-locus comparison table."""
    from .utils.nomenclature import (allele_list_compatible,
                                     read_inferred_bestguess,
                                     read_truth_file)

    def load_calls(path):
        with open(path) as fh:
            head = fh.readline()
        if head.startswith("Locus\t"):
            return {"sample": read_inferred_bestguess(path)}
        return {sid: d for sid, d in read_truth_file(path).items()}

    truth = read_truth_file(truth_path)
    ours = load_calls(our_calls_path)
    other = load_calls(other_calls_path)
    resolutions = (("2digit", 1), ("4digit", 2), ("G", 4))
    stats = {"ours": {}, other_name: {}}
    rows = []
    for tool, calls in (("ours", ours), (other_name, other)):
        per_res_ok = {r: 0 for r, _ in resolutions}
        n_total = 0
        for sid, per_locus_truth in truth.items():
            called = calls.get(sid) or (calls.get("sample")
                                        if len(calls) == 1 else None)
            if called is None:
                continue
            for locus, (t1, t2) in per_locus_truth.items():
                if locus not in called:
                    continue
                c1, c2 = called[locus][:2]
                n_total += 2
                row = [tool, sid, locus, c1, c2, t1, t2]
                for res_name, res in resolutions:
                    straight = (allele_list_compatible(c1, t1, res)
                                + allele_list_compatible(c2, t2, res))
                    crossed = (allele_list_compatible(c1, t2, res)
                               + allele_list_compatible(c2, t1, res))
                    ok = max(straight, crossed)
                    per_res_ok[res_name] += ok
                    row.append(str(ok))
                rows.append(row)
        stats[tool] = {r: (per_res_ok[r] / n_total if n_total else 0.0)
                       for r, _ in resolutions}
    with open(out_path, "w") as fh:
        fh.write("Tool\tSample\tLocus\tCall1\tCall2\tTruth1\tTruth2\t"
                 "OK_2digit\tOK_4digit\tOK_G\n")
        for row in rows:
            fh.write("\t".join(row) + "\n")
        for tool in ("ours", other_name):
            fh.write(f"TOTAL_{tool}\t\t\t\t\t\t\t"
                     + "\t".join(f"{stats[tool][r]:.4f}"
                                 for r, _ in resolutions) + "\n")
    return stats


def import_xhla(report_json: str, out_path: str,
                full_tsv: str | None = None,
                out_path_highres: str | None = None) -> dict[str, list[str]]:
    """Convert raw xHLA output into bestguess-format call files so
    `compare_tool_calls` / the validation harness can score the competitor
    (forPaper/runxHLA.pl:125-207 — the format-conversion half; the
    docker-execution half is environment-specific and out of scope).

    `report_json`: xHLA's report-<sample>-hla.json; the "alleles" array
    holds up to two four-digit alleles per locus.  `full_tsv` (xHLA --full
    mode, <sample>.hla.full): header-keyed TSV whose `type` column must
    repeat the report alleles in order and whose `full` column carries the
    high-resolution extension; written to `out_path_highres`.

    Returns {locus: [allele, ...]} from the normal-resolution report.
    """
    import json
    import re

    with open(report_json) as fh:
        doc = json.load(fh)

    def find_alleles(node):
        if isinstance(node, dict):
            v = node.get("alleles")
            if isinstance(v, list) and all(isinstance(x, str) for x in v):
                return v
            for child in node.values():
                got = find_alleles(child)
                if got is not None:
                    return got
        elif isinstance(node, list):
            for child in node:
                got = find_alleles(child)
                if got is not None:
                    return got
        return None

    alleles = find_alleles(doc)
    if alleles is None:
        raise ValueError(f"no \"alleles\" array in {report_json}")
    by_locus: dict[str, list[str]] = {}
    lines = []
    for allele in alleles:
        m = re.match(r"^(\w+)\*(.+)$", allele)
        if not m:
            raise ValueError(f"unparseable xHLA allele {allele!r}")
        locus = m.group(1)
        by_locus.setdefault(locus, []).append(allele)
        if len(by_locus[locus]) > 2:
            raise ValueError(f">2 alleles for locus {locus}")
        lines.append((locus, len(by_locus[locus]), allele))
    header = "Locus\tChromosome\tAllele\tQ1\tQ2\n"
    with open(out_path, "w") as fh:
        fh.write(header)
        for locus, chrom, allele in lines:
            fh.write(f"{locus}\t{chrom}\t{allele}\t1\t1\n")

    if full_tsv is None:
        return by_locus
    if out_path_highres is None:
        raise ValueError("out_path_highres required with full_tsv")
    n_per_locus: dict[str, int] = {}
    hr_lines = []
    with open(full_tsv) as fh:
        head = fh.readline().rstrip("\n").split("\t")
        for raw in fh:
            f = raw.rstrip("\n").split("\t")
            if len(f) < 2:
                continue
            row = dict(zip(head, f))
            m = re.match(r"^(\w+)\*(.+)$", row["type"])
            if not m:
                raise ValueError(f"unparseable type {row['type']!r}")
            locus = m.group(1)
            n = n_per_locus[locus] = n_per_locus.get(locus, 0) + 1
            want = by_locus.get(locus, [])
            if n > len(want) or row["type"] != want[n - 1]:
                raise ValueError(f"{full_tsv}: high-res row {row['type']} "
                                 f"does not match report allele #{n} at "
                                 f"{locus}")
            if not row["full"].startswith(row["type"]):
                raise ValueError(f"full {row['full']!r} does not extend "
                                 f"type {row['type']!r}")
            hr_lines.append((locus, n, row["full"]))
    with open(out_path_highres, "w") as fh:
        fh.write(header)
        for locus, chrom, allele in hr_lines:
            fh.write(f"{locus}\t{chrom}\t{allele}\t1\t1\n")
    return by_locus


# ------------------------------------------------------- remap-and-reduce
def _mapq_phred(p: float) -> int:
    """Posterior -> phred-scaled MAPQ (capped 60, samtools convention)."""
    import math
    if p >= 1.0:
        return 60
    return max(0, min(60, int(round(-10.0 * math.log10(max(1e-6, 1.0 - p))))))


def _alignment_cigar(al) -> tuple[int, int, list[tuple[int, int]]] | None:
    """GraphAlignment columns -> (lead clip, trail clip, CIGAR) in
    PRG-level coordinates: one reference position per graph level, so
    graph-gap columns and windowed level jumps are deletions.  Returns
    None when no reference-consuming op survives (defensive)."""
    from .models.alignment import GAP
    lvl = al.levels
    m = al.seq_c != GAP
    keep = m | (lvl >= 0)
    op = np.where(m & (lvl >= 0), 0, np.where(m, 1, 2))[keep]
    lv = lvl[keep]
    cigar: list[tuple[int, int]] = []

    def push(opc: int, ln: int) -> None:
        if ln <= 0:
            return
        if cigar and cigar[-1][1] == opc:
            cigar[-1] = (cigar[-1][0] + ln, opc)
        else:
            cigar.append((ln, opc))

    nn = lv >= 0
    jumps = np.diff(lv[nn]) > 1 if nn.sum() > 1 else np.zeros(0, bool)
    if jumps.any():
        prev = None
        for o, l in zip(op.tolist(), lv.tolist()):
            if l >= 0 and prev is not None and l > prev + 1:
                push(2, l - prev - 1)      # D over jumped levels
            push(int(o), 1)
            if l >= 0:
                prev = l
    else:
        cuts = np.flatnonzero(np.diff(op) != 0) + 1
        for seg in np.split(op, cuts):
            push(int(seg[0]), len(seg))
    # normalise edge insertions into soft clips (writer-side hygiene)
    n_clip_lead = n_clip_trail = 0
    while cigar and cigar[0][1] == 2:
        cigar.pop(0)
    while cigar and cigar[-1][1] == 2:
        cigar.pop()
    if cigar and cigar[0][1] == 1:
        n_clip_lead = cigar.pop(0)[0]
    if cigar and cigar[-1][1] == 1:
        n_clip_trail = cigar.pop()[0]
    if not cigar:
        return None
    return n_clip_lead, n_clip_trail, cigar


def _alignment_to_record(al, fq, flag: int, mate=None) -> "BamRecord | None":
    """GraphAlignment -> BamRecord on the PRG pseudo-contig (ref_id 0)."""
    from .io.bam import (FLAG_MATE_REVERSE, FLAG_REVERSE, revcomp)
    from .models.alignment import GAP
    oriented = revcomp(fq.seq) if al.reverse else fq.seq
    oriented_q = fq.qual[::-1] if al.reverse else fq.qual
    got = _alignment_cigar(al)
    if got is None:
        return None
    clip_lead, clip_trail, cigar = got
    n_read_in_cigar = sum(ln for ln, opc in cigar if opc in (0, 1))
    aligned_s = bytes(al.seq_c[al.seq_c != GAP]).decode()
    off = oriented.find(aligned_s)
    if off < 0:
        return None
    lead = off + clip_lead
    trail = len(oriented) - lead - n_read_in_cigar
    if trail < 0:
        return None
    full = ([(lead, 4)] if lead else []) + cigar \
        + ([(trail, 4)] if trail else [])
    if al.reverse:
        flag |= FLAG_REVERSE
    if mate is not None and mate.reverse:
        flag |= FLAG_MATE_REVERSE
    pos = al.first_level()
    mate_pos = mate.first_level() if mate is not None else -1
    if mate is not None:
        lo = min(pos, mate_pos)
        hi = max(al.last_level(), mate.last_level()) + 1
        tlen = (hi - lo) if pos <= mate_pos else -(hi - lo)
    else:
        tlen = 0
    return BamRecord(name=fq.name, flag=flag, ref_id=0, pos=pos,
                     mapq=_mapq_phred(al.mapq), cigar=full, seq=oriented,
                     qual=oriented_q, mate_ref_id=(0 if mate is not None
                                                   else -1),
                     mate_pos=mate_pos, tlen=tlen)


def remap_and_reduce(in_path: str, pkg: GraphPackage, out_path: str,
                     more_reference_dirs: list[str] = (),
                     cram_reference=None, *, device) -> tuple[int, int]:
    """Extract the PRG-relevant reads from a WGS BAM/CRAM, realign them to
    the PRG with the production aligner, and write a coordinate-sorted BAM
    on the PRG-linearized pseudo-contig (one position per graph level) —
    the remapAndReduce.pl workflow (Perl/remapAndReduce.pl: extraction →
    external remap → reduceBAM2PRG) with our own graph aligner as the
    remapper and no cluster scaffolding.  The aligner's NW jobs run on
    `device`, and its statistics are logged.  Returns
    (aligned pairs written, aligned unpaired written)."""
    from .io.bam import (FLAG_PAIRED, FLAG_READ1, FLAG_READ2, extract_reads,
                         estimate_insert_size_from_bam, is_cram,
                         record_to_fastq)
    from .models.aligner import ReadAligner
    from .utils.timing import log_progress

    if is_cram(in_path):
        from .io.cram import CramReader
        cr = CramReader(in_path, reference=cram_reference)
        contigs = cr.contigs()
        cr.close()
    else:
        rd = BamReader(in_path, use_native=False)
        contigs = rd.contigs()
        rd.close()
    spec = pkg.match_known_reference(contigs, list(more_reference_dirs))
    regions = None
    if spec is not None:
        regions = []
        for cid, rec in pkg.known_references(
                list(more_reference_dirs))[spec].items():
            if rec.get("ExtractCompleteContig") in ("1", "yes"):
                regions.append((cid, 0, 0))
            elif rec.get("PartialExtraction_Start"):
                regions.append((cid, int(rec["PartialExtraction_Start"]) - 1,
                                int(rec["PartialExtraction_Stop"])))
    by_name, _ = extract_reads(in_path, regions,
                               cram_reference=cram_reference)
    pairs, unpaired = [], []
    for name, recs in by_name.items():
        prim = [r for r in recs
                if not (r.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY))]
        r1 = next((r for r in prim if r.is_read1), None)
        r2 = next((r for r in prim if not r.is_read1), None)
        if r1 is not None and r2 is not None:
            pairs.append((record_to_fastq(r1), record_to_fastq(r2)))
        elif prim:
            unpaired.append(record_to_fastq(prim[0]))
    try:
        ins_mean, ins_sd = estimate_insert_size_from_bam(
            in_path, cram_reference=cram_reference)
    except Exception:
        ins_mean, ins_sd = 300.0, 100.0
    aligner = ReadAligner(pkg, device=device)
    aligned = aligner.align_pairs(pairs, ins_mean, ins_sd) if pairs else []
    unal = aligner.align_unpaired(unpaired) if unpaired else []
    log_progress(aligner.stats.report())
    fq_of = {p[0].name: p for p in pairs}
    records = []
    n_pairs = n_un = 0
    for ap in aligned:
        if ap is None:
            continue
        fq1, fq2 = fq_of[ap.read_id]
        b1 = _alignment_to_record(ap.chain1, fq1,
                                  FLAG_PAIRED | FLAG_READ1, ap.chain2)
        b2 = _alignment_to_record(ap.chain2, fq2,
                                  FLAG_PAIRED | FLAG_READ2, ap.chain1)
        if b1 is not None and b2 is not None:
            records += [b1, b2]
            n_pairs += 1
    for fq, al in zip(unpaired, unal):
        if al is None:
            continue
        rec = _alignment_to_record(al, fq, 0)
        if rec is not None:
            records.append(rec)
            n_un += 1
    records.sort(key=lambda r: r.pos)
    n_levels = pkg.prg().n_levels
    w = BamWriter(out_path, [("PRG", n_levels)],
                  "@HD\tVN:1.6\tSO:coordinate\n"
                  f"@SQ\tSN:PRG\tLN:{n_levels}\n")
    for r in records:
        w.write(r)
    w.close()
    return n_pairs, n_un


def downsample_wgs_bams(inputs: list[str], out_dir: str,
                        target_gigabases: float, seed: int = 0
                        ) -> list[tuple[str, str, float, int, int]]:
    """Batch-downsample WGS BAMs to a sequencing-depth target expressed in
    gigabases (downsample_WGS_BAMs.pl: targetGigabases = 15x * 3.2 Gb,
    minus the site-specific qsub scaffolding).  Per input: stream-count
    sequenced bases of primary records, keep pairs with probability
    target/total via the reproducible name-hash sampler.  Returns
    [(in, out, fraction, kept, total_records)]."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for path in inputs:
        rd = BamReader(path)
        total_bases = 0
        for rec in rd:
            if not (rec.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)):
                total_bases += len(rec.seq)
        rd.close()
        frac = min(1.0, target_gigabases * 1e9 / total_bases) \
            if total_bases else 1.0
        base = os.path.basename(path)
        stem = base[:base.rfind(".")] if "." in base else base
        dst = os.path.join(out_dir, f"d_{stem}.bam")
        kept, total = downsample_bam(path, dst, frac, seed=seed)
        out.append((path, dst, frac, kept, total))
    return out
