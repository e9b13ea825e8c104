"""Command-line interface of the port: ``--action HLA`` on paired short
reads, from ``--FASTQ1/--FASTQ2`` or from a ``--BAM`` (or CRAM with
``--ref``), with the device work on ``--device`` (default ``cuda``; there is
no silent fallback to the CPU).

Read extraction, the knownReferences match and FASTQ pairing are the
reference CLI's own helpers (``hla_la_tpu/cli.py:162-310``); reads of a BAM
whose mate was not extracted are typed as unpaired, as there.  Not ported
yet: other actions (they exit non-zero), long reads and unpaired FASTQ
input (``--longReads`` and ``--FASTQU`` are not options).

  python -m hla_la_tpu_torch --action HLA --FASTQ1 R_1.fq --FASTQ2 R_2.fq \\
      --graph /path/to/graphdir --sampleID S1 --workingDir out/ --device cuda
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hla_la_tpu_torch",
                                 description=__doc__)
    ap.add_argument("--action", default="HLA")
    ap.add_argument("--BAM")
    ap.add_argument("--FASTQ1")
    ap.add_argument("--FASTQ2")
    ap.add_argument("--graph", help="graph package directory")
    ap.add_argument("--sampleID", default="sample")
    ap.add_argument("--workingDir", default=".")
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


def _read_input(args, pkg):
    """(pairs, unpaired) from --FASTQ1/--FASTQ2, or extracted from --BAM
    with the reads whose mate was not extracted as unpaired
    (``hla_la_tpu/cli.py:199-257``, short reads only)."""
    from hla_la_tpu.cli import _regions_from_spec
    from hla_la_tpu.io.bam import BamReader, bam_to_fastq_pairs, \
        extract_reads, is_cram
    from hla_la_tpu.models.pipeline import pair_up_fastq
    from hla_la_tpu.utils.timing import log_progress

    for p in (args.BAM, args.FASTQ1, args.FASTQ2, args.ref):
        if p and not os.path.exists(p):
            raise SystemExit(f"input file not found: {p}")
    if not args.BAM:
        if not (args.FASTQ1 and args.FASTQ2):
            raise SystemExit("no input reads (--BAM or --FASTQ1/--FASTQ2)")
        return pair_up_fastq(args.FASTQ1, args.FASTQ2), []
    log_progress(f"extracting reads from {args.BAM}")
    cram_reference = None
    if is_cram(args.BAM):
        if args.ref:
            from hla_la_tpu.io.fasta import read_fasta
            cram_reference = read_fasta(args.ref)
        from hla_la_tpu.io.cram import CramReader
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
    from hla_la_tpu.cli import _require_graph
    from hla_la_tpu.utils.config import RunConfig
    from hla_la_tpu.utils.timing import log_progress

    from .models.pipeline import run_hla_typing

    pkg = _require_graph(args)
    out_dir = args.outputDirectory or os.path.join(args.workingDir,
                                                   args.sampleID)
    os.makedirs(out_dir, exist_ok=True)
    pairs, unpaired = _read_input(args, pkg)
    if not pairs and not unpaired:
        raise SystemExit("no reads in the input")
    cfg = RunConfig(graph_dir=args.graph, sample_id=args.sampleID,
                    working_dir=args.workingDir)
    res = run_hla_typing(pkg, pairs=pairs, unpaired=unpaired,
                         output_dir=out_dir, cfg=cfg, device=args.device)
    log_progress(f"typing complete: {len(res.results)} loci -> "
                 f"{out_dir}/hla/R1_bestguess.txt")
    for r in res.results:
        a1, a2 = r.alleles_g_or_raw()
        print(f"{r.locus}\t{a1}\t{a2}\tQ1={r.q1_allele1:.4f}/"
              f"{r.q1_allele2:.4f}")
    return 0
