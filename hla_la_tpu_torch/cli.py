"""Command-line interface of the port: ``--action HLA`` on paired short
reads from ``--FASTQ1/--FASTQ2``, unpaired reads from ``--FASTQU``, or reads
extracted from a ``--BAM`` (or CRAM with ``--ref``), and on long reads with
``--longReads ont2d|pacbio``, with the device work on ``--device`` (default
``cuda``; there is no silent fallback to the CPU).

The input rules are the reference CLI's (``hla_la_tpu/cli.py:199-269``):
reads of a BAM are extracted by the knownReferences match; those whose mate
was not extracted are typed as unpaired; in long-read mode every pair is
flattened into unpaired reads and reads over 50 kb are split.  Not ported
yet: other actions (they exit non-zero).

  python -m hla_la_tpu_torch --action HLA --FASTQ1 R_1.fq --FASTQ2 R_2.fq \\
      --graph /path/to/graphdir --sampleID S1 --workingDir out/ --device cuda
  python -m hla_la_tpu_torch --action HLA --FASTQU long.fq --longReads ont2d \\
      --graph /path/to/graphdir --sampleID S1 --workingDir out/ --device cuda
"""

from __future__ import annotations

import argparse
import os
import sys

from .graph.package import GraphPackage
from .io.bam import BamReader, bam_to_fastq_pairs, extract_reads, is_cram
from .io.cram import CramReader
from .io.fasta import read_fasta
from .io.fastq import FastqRead, read_fastq
from .models.pipeline import pair_up_fastq, run_hla_typing
from .utils.config import RunConfig, TyperConfig
from .utils.timing import log_progress


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hla_la_tpu_torch",
                                 description=__doc__)
    ap.add_argument("--action", default="HLA")
    ap.add_argument("--BAM")
    ap.add_argument("--FASTQ1")
    ap.add_argument("--FASTQ2")
    ap.add_argument("--FASTQU")
    ap.add_argument("--graph", help="graph package directory")
    ap.add_argument("--sampleID", default="sample")
    ap.add_argument("--workingDir", default=".")
    ap.add_argument("--longReads", default="",
                    choices=["", "ont2d", "pacbio"])
    ap.add_argument("--outputDirectory", default=None)
    ap.add_argument("--moreReferencesDir", default=None)
    ap.add_argument("--ref", help="reference genome FASTA (required to "
                    "decode reference-based CRAM input)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.action != "HLA":
        print(f"--action {args.action}: not yet ported (only HLA)",
              file=sys.stderr)
        return 2
    return action_hla(args)


def _require_graph(args):
    if not args.graph or not os.path.isdir(args.graph):
        raise SystemExit(f"--graph directory required (got {args.graph!r})")
    return GraphPackage(args.graph)


def _regions_from_spec(pkg, spec_path: str):
    """knownReferences spec rows -> extraction regions (HLA-LA.pl:374-412).

    Parses the spec file directly: the matched spec may live in a
    --moreReferencesDir outside the package."""
    spec = pkg.known_references([os.path.dirname(spec_path)])[spec_path]
    regions = []
    include_unmapped = False
    for cid, rec in spec.items():
        if cid == "*":
            # the idxstats unmapped pseudo-contig: ExtractCompleteContig=1
            # means "also extract unmapped reads" (HLA-LA.pl:336-340, 415)
            include_unmapped = rec.get("ExtractCompleteContig") in ("1", "yes")
            continue
        if rec.get("ExtractCompleteContig") in ("1", "yes"):
            regions.append((cid, 0, 0))
        else:
            start = rec.get("PartialExtraction_Start") or ""
            stop = rec.get("PartialExtraction_Stop") or ""
            if start and stop:
                regions.append((cid, int(start) - 1, int(stop)))
    return regions, include_unmapped


def _split_long_reads(reads, chunk: int = 50000):
    """Reads >50kb are split into 50kb chunks (HLA-LA.pl:503-524)."""
    out = []
    for r in reads:
        if len(r.seq) <= chunk:
            out.append(r)
            continue
        for i in range(0, len(r.seq), chunk):
            out.append(FastqRead(f"{r.name}:::chunk{i // chunk}",
                                 r.seq[i:i + chunk], r.qual[i:i + chunk]))
    return out


def _read_input(args, pkg):
    """(pairs, unpaired) from --FASTQ1/--FASTQ2 and --FASTQU, or extracted
    from --BAM with the reads whose mate was not extracted as unpaired; in
    long-read mode every pair is flattened into unpaired reads and reads
    over 50 kb are split (``hla_la_tpu/cli.py:199-269``)."""
    for p in (args.BAM, args.FASTQ1, args.FASTQ2, args.FASTQU, args.ref):
        if p and not os.path.exists(p):
            raise SystemExit(f"input file not found: {p}")
    pairs, unpaired = [], []
    if args.BAM:
        pairs, unpaired = _extract_bam(args, pkg)
    else:
        if args.FASTQ1 and args.FASTQ2:
            pairs = pair_up_fastq(args.FASTQ1, args.FASTQ2)
        if args.FASTQU:
            unpaired = list(read_fastq(args.FASTQU))
    if args.longReads:
        unpaired += [r for p in pairs for r in p]
        pairs = []
        unpaired = _split_long_reads(unpaired)
    if not pairs and not unpaired:
        raise SystemExit("no input reads (--BAM or --FASTQ1/--FASTQ2/"
                         "--FASTQU)")
    if unpaired and not args.longReads:
        min_len = TyperConfig().min_alignment_length_unpaired
        n_short = sum(len(r.seq) < min_len for r in unpaired)
        if n_short > len(unpaired) // 2:
            log_progress(
                f"WARNING: {n_short}/{len(unpaired)} unpaired reads are "
                f"shorter than the {min_len}bp unpaired minimum "
                f"(HLATyper.cpp:1032) and will produce no typing "
                f"observations — short reads must be PAIRED "
                f"(--FASTQ1/--FASTQ2); use --longReads for long-read "
                f"input")
    return pairs, unpaired


def _extract_bam(args, pkg):
    """(pairs, unpaired) extracted from --BAM by the knownReferences
    match, as the reference CLI does (``hla_la_tpu/cli.py:203-239``)."""
    log_progress(f"extracting reads from {args.BAM}")
    cram_reference = None
    if is_cram(args.BAM):
        if args.ref:
            cram_reference = read_fasta(args.ref)
        cram_reference = CramReader(args.BAM, reference=cram_reference)
        contigs = cram_reference.contigs()
    else:
        contigs = BamReader(args.BAM, use_native=False).contigs()
    # knownReferences specs end with samtools idxstats' `*  0` line
    idx_contigs = dict(contigs)
    idx_contigs.setdefault("*", 0)
    more = [args.moreReferencesDir] if args.moreReferencesDir else []
    spec_path = pkg.match_known_reference(idx_contigs, more)
    if spec_path is None and "*" not in contigs:
        spec_path = pkg.match_known_reference(contigs, more)
    regions, include_unmapped = None, True
    if spec_path is not None:
        log_progress(f"matched known reference {spec_path}")
        regions, include_unmapped = _regions_from_spec(pkg, spec_path)
    else:
        log_progress("WARNING: BAM reference not in knownReferences — "
                     "extracting ALL reads")
    by_name, _ = extract_reads(args.BAM, regions,
                               include_unmapped=include_unmapped,
                               cram_reference=cram_reference)
    return bam_to_fastq_pairs(by_name)


def action_hla(args) -> int:
    pkg = _require_graph(args)
    out_dir = args.outputDirectory or os.path.join(args.workingDir,
                                                   args.sampleID)
    os.makedirs(out_dir, exist_ok=True)
    pairs, unpaired = _read_input(args, pkg)
    cfg = RunConfig(graph_dir=args.graph, sample_id=args.sampleID,
                    working_dir=args.workingDir, long_reads=args.longReads)
    res = run_hla_typing(pkg, pairs=pairs, unpaired=unpaired,
                         output_dir=out_dir, cfg=cfg, device=args.device)
    log_progress(f"typing complete: {len(res.results)} loci -> "
                 f"{out_dir}/hla/R1_bestguess.txt")
    for r in res.results:
        a1, a2 = r.alleles_g_or_raw()
        print(f"{r.locus}\t{a1}\t{a2}\tQ1={r.q1_allele1:.4f}/"
              f"{r.q1_allele2:.4f}")
    return 0
