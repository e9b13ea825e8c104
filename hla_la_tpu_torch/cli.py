"""Command-line interface of the port, with the device work on ``--device``
(default ``cuda``; there is no silent fallback to the CPU).

``--action HLA`` on paired short reads from ``--FASTQ1/--FASTQ2``, unpaired
reads from ``--FASTQU``, or reads extracted from a ``--BAM`` (or CRAM with
``--ref``), and on long reads with ``--longReads ont2d|pacbio``.  The input
rules are the reference CLI's (``hla_la_tpu/cli.py:199-269``): reads of a
BAM are extracted by the knownReferences match; those whose mate was not
extracted are typed as unpaired; in long-read mode every pair is flattened
into unpaired reads and reads over 50 kb are split.  Its many-process
forms: ``--maxThreads N`` aligns (and, at WGS scale, types) in N worker
processes that share the device; ``--nHosts N --hostIdx I --shardDir D``
aligns read slice I of N into a shard file and ``--mergeShards D`` types
from all of them; ``--sharded N`` (the reference's ``--backend sharded``)
runs N ranks of a ``torch.distributed`` group on this host, NW batches
split over all of them and the pair reduction over a reads x clusters mesh
whose cluster axis follows from N as in the reference; with
``--maxThreads M`` rank 0 alone holds the M workers, as the reference's
one process does.  ``--sharded`` is
taken by the actions that take the reference's sharded backend (HLA,
validate, KIR, KIRsimulation, TestHLATyping); any other action says so and
runs in one process.  ``--backend auto|numpy|jax|sharded``, as the
reference's command lines write it, becomes ``--device`` and ``--sharded``
(``_apply_backend``).

``--action KIR`` types reads against a linear-ALT panel (``--ALTpanel``: a
package directory or a FASTA), ``--action ASM`` types assembly contigs
(``--ASMfasta``) against a graph package; ``KIRsimulation``,
``buildKIRpanel`` and ``checkKIRgraph`` are the KIR module's self-test,
panel packager and graph check.  ``--action validate`` types every sample
of a cohort sheet (``--validationBAMs``) against a truth table
(``--trueHLA``) in one process; ``remapAndReduce`` realigns a BAM's reads
to the PRG and writes them as a BAM in PRG coordinates (``--out``).  Every
other action of the reference CLI is here too, with its messages: the
aligning self-tests (``testPRGMapping``, ``testPRGMappingUnpaired``,
``TestHLATyping``, ``testAlignments2Chains``, ``testChainExtension``), the
simulators, the graph tools and the BAM tools.  Every action that aligns or
types runs on ``--device``.

  python -m hla_la_tpu_torch --action HLA --FASTQ1 R_1.fq --FASTQ2 R_2.fq \\
      --graph /path/to/graphdir --sampleID S1 --workingDir out/ --device cuda
  python -m hla_la_tpu_torch --action HLA --FASTQU long.fq --longReads ont2d \\
      --graph /path/to/graphdir --sampleID S1 --workingDir out/ --device cuda
  python -m hla_la_tpu_torch --action HLA --BAM in.bam --maxThreads 4 \\
      --graph /path/to/graphdir --sampleID S1 --workingDir out/ --device cuda
  python -m hla_la_tpu_torch --action KIR --ALTpanel kir_pkg/ --BAM in.bam \\
      --sampleID S1 --workingDir out/ --device cuda
  python -m hla_la_tpu_torch --action ASM --ASMfasta contigs.fa \\
      --graph /path/to/graphdir --sampleID S1 --workingDir out/ --device cuda
  python -m hla_la_tpu_torch --action validate --validationBAMs sheet.txt \\
      --trueHLA truth.txt --graph /path/to/graphdir --workingDir out/
  python -m hla_la_tpu_torch --action remapAndReduce --BAM in.bam \\
      --graph /path/to/graphdir --out prg.bam --device cuda
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .graph.package import GraphPackage
from .io.bam import (BamReader, bam_to_fastq_pairs,
                     estimate_insert_size_from_bam, extract_reads, is_cram)
from .io.cram import CramReader
from .io.fasta import read_fasta
from .io.fastq import FastqRead, read_fastq, write_fastq
from .models.asm import AssemblyTyper
from .models.kir_package import KirPackage, build_kir_package
from .models.linear_alts import LinearALTsTyper
from .models.pipeline import (align_shard, merge_shards_and_type,
                              pair_up_fastq, run_hla_typing)
from .sim.read_sim import ReadSimulator
from .utils.config import RunConfig, TyperConfig
from .utils.nomenclature import evaluate_types, read_truth_file
from .utils.timing import log_progress, root


def main(argv=None, mesh=None) -> int:
    """`mesh`: set by parallel.launch.rank_cli on a rank of a --sharded run
    (a parallel.mesh.Mesh); never by a user."""
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
    ap.add_argument("--maxThreads", type=int, default=1,
                    help="worker processes for alignment and, at WGS scale, "
                         "per-locus typing; host-only: this process runs "
                         "their device calls on --device")
    ap.add_argument("--outputDirectory", default=None)
    ap.add_argument("--moreReferencesDir", default=None)
    ap.add_argument("--ref", help="reference genome FASTA (required to "
                    "decode reference-based CRAM input)")
    ap.add_argument("--mapAgainstCompleteGenome", type=int, default=0,
                    help="1 = paralog defense via decoy index over the "
                    "package's extendedReferenceGenome (HLA-LA.cpp:617)")
    ap.add_argument("--keepExtractedFastq", type=int, default=0,
                    help="with --action HLA: write the extracted reads as "
                         "R_1/R_2/R_U.fastq in the output directory (the "
                         "reference keeps these, HLA-LA.pl:465-502)")
    ap.add_argument("--extractExonkMerCounts", type=int, default=0,
                    help="with --action HLA: also write per-exon k-mer "
                         "counts over the extracted reads "
                         "(HLA-LA.pl:543-552)")
    ap.add_argument("--decoyFasta", default="",
                    help="explicit decoy genome FASTA for the paralog "
                    "defense (overrides extendedReferenceGenome)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trueHLA", help="truth table for concordance "
                    "evaluation (--action HLA, --action ASM)")
    ap.add_argument("--ASMfasta", help="assembly contigs for --action ASM; "
                    "aligned haplotypes for --action buildKIRpanel")
    ap.add_argument("--ALTpanel", help="linear ALT panel (package dir or "
                    "FASTA) for --action KIR / buildKIRpanel output dir")
    ap.add_argument("--annotations", help="gene annotation TSV "
                    "(hap gene start0 stop0) for --action buildKIRpanel")
    ap.add_argument("--validationBAMs", help="sample sheet for --action "
                    "validate")
    ap.add_argument("--resolution", type=int, default=2,
                    help="nomenclature fields compared in evaluation")
    ap.add_argument("--nHosts", type=int, default=1,
                    help="multi-host sharding: total hosts (validate: "
                         "cohort rows; HLA: read-slice alignment shards)")
    ap.add_argument("--hostIdx", type=int, default=0,
                    help="multi-host sharding: this host's index")
    ap.add_argument("--shardDir",
                    help="--action HLA with --nHosts>1: directory this "
                         "host's align shard is written to")
    ap.add_argument("--mergeShards",
                    help="--action HLA: merge align shards from this "
                         "directory and run typing (no read input needed)")
    ap.add_argument("--sharded", type=int, default=None,
                    help="--action " + ", ".join(SHARDED_ACTIONS) + ": ranks "
                         "of a torch.distributed group started on this host "
                         "(0: one process); rank r computes on card r modulo "
                         "the card count")
    ap.add_argument("--out", help="output path (remapAndReduce: BAM; "
                                  "downsampleBAM: BAM or batch directory)")
    ap.add_argument("--fraction", type=float, default=None,
                    help="--action downsampleBAM: keep-pair probability")
    ap.add_argument("--targetGigabases", type=float, default=None,
                    help="--action downsampleBAM: depth target in Gb "
                         "(downsample_WGS_BAMs.pl semantics)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the device work runs (default cuda; there "
                         "is no fallback to the CPU)")
    ap.add_argument("--backend", default=None,
                    choices=["auto", "numpy", "jax", "sharded"],
                    help="the reference CLI's backend, turned into "
                         "--device and --sharded: auto and jax the device "
                         "path on --device, numpy --device cpu, sharded "
                         "--sharded over the cards this run sees (1 rank "
                         "with --device cpu)")
    args = ap.parse_args(argv)
    args.mesh = mesh
    args.argv = list(sys.argv[1:] if argv is None else argv)
    action = ACTIONS.get(args.action)
    if action is None:
        print(f"unknown action {args.action}", file=sys.stderr)
        return 2
    _apply_backend(args)
    if args.sharded and args.action not in SHARDED_ACTIONS:
        log_progress(f"--action {args.action} runs in one process: "
                     f"--sharded {args.sharded} starts ranks for --action "
                     + ", ".join(SHARDED_ACTIONS) + " only")
    return action(args)


# the actions that run on --sharded ranks: those the reference passes its
# --backend into with a sharded path (hla_la_tpu/cli.py:295-298, :534,
# :449, :811, :848, :719)
SHARDED_ACTIONS = ("HLA", "validate", "KIR", "KIRsimulation",
                   "TestHLATyping")


def _apply_backend(args) -> None:
    """Turn --backend into --device and --sharded, in place: auto and jax
    are the device path on --device, numpy the host path (--device cpu),
    sharded --sharded K with K the cards this run sees (1 with --device
    cpu), unless --sharded gives the count.  A --backend that contradicts
    an explicit --device or --sharded ends the run; without --backend the
    defaults are --device cuda and one process."""
    backend, given = args.backend, args.sharded
    if backend == "numpy":
        if args.device == "cuda":
            raise SystemExit("--backend numpy is the host path: it "
                             "contradicts --device cuda")
        args.device = "cpu"
    args.device = args.device or "cuda"
    if backend == "sharded":
        if given == 0:
            raise SystemExit("--backend sharded contradicts --sharded 0")
        if given is None:
            args.sharded = 1 if args.device == "cpu" else _visible_cards()
    elif backend is not None and given:
        raise SystemExit(f"--backend {backend} runs in one process: it "
                         f"contradicts --sharded {given}")
    args.sharded = args.sharded or 0
    if backend is not None and args.mesh is None:
        log_progress(f"--backend {backend}: --device {args.device}, "
                     + (f"--sharded {args.sharded}" if args.sharded
                        else "one process"))


def _visible_cards() -> int:
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        raise SystemExit("--backend sharded: this run sees no card "
                         "(torch.cuda.device_count() is 0); --device cpu "
                         "runs one rank on the CPU")
    return n


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


def _start_ranks(args) -> int:
    """--sharded N: this process only starts the N ranks; each runs the
    action again with its mesh.  Returns the largest exit code."""
    from .parallel.launch import rank_cli, run_ranks
    log_progress(f"starting {args.sharded} ranks on {args.device}")
    ranks = run_ranks(rank_cli, args.sharded, args.device, args=(args.argv,))
    for rank, (rc, launches, *_) in enumerate(ranks):
        log_progress(f"rank {rank}: exit code {rc}, kernel launches "
                     + ", ".join(f"{k} {n}" for k, n in launches.items()))
    return max(rc for rc, *_ in ranks)


def _writes(args) -> bool:
    """Whether this process prints the result lines and writes the files:
    one process, or rank 0 of a --sharded run."""
    return args.mesh is None or args.mesh.rank == 0


def action_hla(args) -> int:
    pkg = _require_graph(args)
    out_dir = args.outputDirectory or os.path.join(args.workingDir,
                                                   args.sampleID)
    if args.extractExonkMerCounts:
        # validate flag combinations BEFORE the (potentially hours-long)
        # extraction+typing run, not after it
        if args.longReads:
            raise SystemExit(
                "--extractExonkMerCounts is a short-read feature "
                "(HLA-LA.pl:545)")
        if args.nHosts > 1 or args.mergeShards:
            raise SystemExit(
                "--extractExonkMerCounts is not available on sharded "
                "multi-host runs: counts must cover ALL reads — run "
                "--action extractkMerCounts on the full FASTQs instead")
    if args.sharded and args.mesh is None:
        return _start_ranks(args)
    writes = _writes(args)
    if writes:
        os.makedirs(out_dir, exist_ok=True)
    with root("pkg.load"):
        pkg.compiled()

    if args.mergeShards:
        # multi-host HLA: typing over every host's align shard
        cfg = RunConfig(graph_dir=args.graph, sample_id=args.sampleID,
                        working_dir=args.workingDir,
                        long_reads=args.longReads,
                        max_threads=args.maxThreads)
        res = merge_shards_and_type(pkg, args.mergeShards, out_dir, cfg,
                                    device=args.device, sharded=args.mesh)
        log_progress(f"typing complete: {len(res.results)} loci -> "
                     f"{out_dir}/hla/R1_bestguess.txt")
        return 0

    with root("io.bam" if args.BAM else "io.fastq"):
        pairs, unpaired = _read_input(args, pkg)
    if args.keepExtractedFastq and writes:
        # the reference leaves the extraction FASTQs (R_1/R_2/R_U) in the
        # sample working dir (HLA-LA.pl:465-502); extraction here is
        # in-memory, so materialise them only on request
        if pairs:
            write_fastq(os.path.join(out_dir, "R_1.fastq"),
                        [p[0] for p in pairs])
            write_fastq(os.path.join(out_dir, "R_2.fastq"),
                        [p[1] for p in pairs])
        if unpaired:
            write_fastq(os.path.join(out_dir, "R_U.fastq"), list(unpaired))
        log_progress(f"extraction FASTQs written to {out_dir}")

    cfg = RunConfig(graph_dir=args.graph, sample_id=args.sampleID,
                    working_dir=args.workingDir, long_reads=args.longReads,
                    max_threads=args.maxThreads,
                    map_against_complete_genome=bool(
                        args.mapAgainstCompleteGenome),
                    decoy_fasta=args.decoyFasta)
    if args.nHosts > 1:
        # multi-host HLA: align this host's read slice, write a shard
        shard_dir = args.shardDir or os.path.join(out_dir, "align_shards")
        align_shard(pkg, pairs, unpaired, shard_dir, args.hostIdx,
                    args.nHosts, cfg, device=args.device, sharded=args.mesh)
        return 0
    res = run_hla_typing(pkg, pairs=pairs, unpaired=unpaired,
                         output_dir=out_dir, cfg=cfg, device=args.device,
                         sharded=args.mesh)
    log_progress(f"typing complete: {len(res.results)} loci -> "
                 f"{out_dir}/hla/R1_bestguess.txt")
    if not writes:
        return 0
    if args.extractExonkMerCounts:
        # the reference runs extractkMerCounts.pl over the extracted FASTQs
        # as part of the HLA action (HLA-LA.pl:543-552); same here, over
        # the reads just typed (flag combinations checked up front)
        _write_exon_kmer_counts(
            pkg, [r for p in pairs for r in p] + list(unpaired), out_dir,
            args.device)
    for r in res.results:
        a1, a2 = r.alleles_g_or_raw()
        print(f"{r.locus}\t{a1}\t{a2}\tQ1={r.q1_allele1:.4f}/"
              f"{r.q1_allele2:.4f}")
    if args.trueHLA:
        truth_all = read_truth_file(args.trueHLA)
        truth = truth_all.get(args.sampleID)
        if truth is None:
            log_progress(f"--trueHLA: no row for {args.sampleID}")
        else:
            inferred = {r.locus: (r.allele1_id, r.allele2_id)
                        for r in res.results}
            ev = evaluate_types(inferred, truth, args.resolution)
            print(f"truth concordance: {ev.n_alleles_correct}/"
                  f"{ev.n_alleles_total} alleles "
                  f"({ev.accuracy * 100:.1f}%) over {ev.n_loci} loci")
    return 0


def action_asm(args) -> int:
    """Assembly typing (HLA-ASM.pl equivalent)."""
    pkg = _require_graph(args)
    if not args.ASMfasta:
        raise SystemExit("--ASMfasta required for --action ASM")
    contigs = read_fasta(args.ASMfasta)
    typer = AssemblyTyper(pkg, device=args.device)
    truth = None
    if args.trueHLA:
        truth_all = read_truth_file(args.trueHLA)
        truth = truth_all.get(args.sampleID)
        if truth is None and len(truth_all) == 1:
            truth = next(iter(truth_all.values()))
    calls = typer.type_contigs(contigs, truth=truth)
    out_dir = args.outputDirectory or os.path.join(args.workingDir,
                                                   args.sampleID + "_ASM")
    typer.write_outputs(calls, out_dir, contigs=contigs)
    for c in calls:
        extra = ""
        if c.min_dist_called_truth is not None:
            extra = f"\ttruthED={c.min_dist_called_truth}"
        print(f"{c.locus}\t{c.contig}\t{';'.join(c.alleles_at_min)}\t"
              f"ED={c.edit_distance}{extra}")
    log_progress(typer.stats.report())
    return 0


def _gene_spans(annotations) -> dict[str, tuple[int, int]]:
    """Per gene, the span over every haplotype's annotation of it."""
    spans: dict[str, tuple[int, int]] = {}
    for hap_spans in annotations.values():
        for g, a, b in hap_spans:
            lo, hi = spans.get(g, (a, b))
            spans[g] = (min(lo, a), max(hi, b))
    return spans


def action_kir(args) -> int:
    """Linear-ALT (KIR) typing (--action KIR, HLA-LA.cpp:812-905).

    --ALTpanel may be a linear-ALT package DIRECTORY (the reference's
    linearALTs layout; full workflow: region extraction from the BAM,
    haplotype-pair model with insert term, reads2Genes) or a bare FASTA
    (haplotype-pair model only)."""
    if not args.ALTpanel:
        raise SystemExit("--ALTpanel (package dir or FASTA) required for "
                         "--action KIR")
    if args.sharded and args.mesh is None:
        return _start_ranks(args)
    kir_pkg = None
    if os.path.isdir(args.ALTpanel):
        kir_pkg = KirPackage.load(args.ALTpanel)
        panel = kir_pkg.haplotypes
    else:
        panel = read_fasta(args.ALTpanel)
    pairs: list = []
    reads = []
    mean = sd = None
    if args.BAM:
        cram_reference = None
        if args.ref:
            if is_cram(args.BAM):
                cram_reference = read_fasta(args.ref)
        regions = None
        if kir_pkg is not None and kir_pkg.covered_regions:
            # extract only the covered regions (+ unmapped) —
            # extractReads_extendedReferenceGenome, linearALTs.h:37
            regions = [(c, a, b)
                       for c, (a, b) in kir_pkg.covered_regions.items()]
            mean, sd = estimate_insert_size_from_bam(
                args.BAM, cram_reference=cram_reference)
        by_name, _ = extract_reads(args.BAM, regions,
                                   cram_reference=cram_reference)
        pairs, unpaired = bam_to_fastq_pairs(by_name)
        reads = [r for p in pairs for r in p] + unpaired
    elif args.FASTQ1 and args.FASTQ2:
        # name-keyed pairing (positional zip silently mispairs/truncates
        # when one mate was dropped by upstream QC)
        pairs = pair_up_fastq(args.FASTQ1, args.FASTQ2)
        reads = [r for p in pairs for r in p]
    elif args.FASTQU:
        reads = list(read_fastq(args.FASTQU))
    else:
        raise SystemExit("--BAM, --FASTQ1/2 or --FASTQU required for "
                         "--action KIR")
    genes = None
    if kir_pkg is not None and kir_pkg.annotations:
        genes = _gene_spans(kir_pkg.annotations)
    typer = LinearALTsTyper(panel, genes=genes,
                            n_is_gap=kir_pkg is not None, device=args.device,
                            sharded=args.mesh)
    if pairs:
        # paired model incl. the insert-size term
        # (processCollectedAlignments, linearALTs.h:69)
        if mean is None:
            mean, sd = typer.estimate_insert(pairs)
        res = typer.type_diploid_paired(pairs, mean, sd)
    else:
        res = typer.type_diploid(reads)
    # every rank runs reads2Genes: its NW calls are split over all of them
    r2g = typer.reads_to_genes(reads) if genes else None
    log_progress(typer.stats.report())
    if not _writes(args):
        return 0
    print(f"best ALT pair: {res.hap1} / {res.hap2} "
          f"(posterior {res.posterior:.4f})")
    out_dir = args.outputDirectory or os.path.join(args.workingDir,
                                                   args.sampleID + "_KIR")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "KIR_haplotypes.txt"), "w") as fh:
        fh.write("Haplotype1\tHaplotype2\tPosterior\n")
        fh.write(f"{res.hap1}\t{res.hap2}\t{res.posterior:.6f}\n")
    if genes:
        with open(os.path.join(out_dir, "reads2Genes.txt"), "w") as fh:
            fh.write("Gene\tNReads\tReadIDs\n")
            for g in sorted(r2g):
                fh.write(f"{g}\t{len(r2g[g])}\t"
                         f"{','.join(sorted(r2g[g]))}\n")
        print("reads2Genes: " + ", ".join(
            f"{g}={len(r2g[g])}" for g in sorted(r2g)))
    return 0


def action_build_kir_panel(args) -> int:
    """Panel packager: aligned region haplotypes (MFA FASTA) + gene
    annotation TSV -> full linear-ALT package (the packaging step the
    reference performed offline from IPD-KIR data)."""
    if not args.ASMfasta or not args.ALTpanel:
        raise SystemExit("buildKIRpanel needs --ASMfasta <aligned.fa> "
                         "--ALTpanel <output dir> [--annotations <tsv>]")
    haps = read_fasta(args.ASMfasta)
    ann: dict[str, list[tuple[str, int, int]]] = {}
    if args.annotations:
        with open(args.annotations) as fh:
            fh.readline()
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if len(f) >= 4:
                    ann.setdefault(f[0], []).append(
                        (f[1], int(f[2]), int(f[3])))
    covered = None
    pkg = build_kir_package(args.ALTpanel, haps, ann, covered)
    print(f"KIR panel written: {len(pkg.haplotypes)} haplotypes, "
          f"{len(pkg.genes())} genes -> {args.ALTpanel}")
    return 0


def action_kir_simulation(args) -> int:
    """KIR haplotype/gene simulation self-test (KIRhaplotypesSimulation /
    KIRgeneSimulation actions, HLA-LA.cpp:907, 1186): simulate a diploid ALT
    pair, generate reads, re-type, compare.  With --ALTpanel <package dir>,
    simulates from the real panel incl. read->gene truth evaluation.  On
    --sharded ranks every rank simulates the same reads and types them
    together; rank 0 prints."""
    if args.sharded and args.mesh is None:
        return _start_ranks(args)
    rng = np.random.default_rng(args.seed or 11)
    if args.ALTpanel and os.path.isdir(args.ALTpanel):
        kp = KirPackage.load(args.ALTpanel)
        names = sorted(kp.haplotypes)
        h1, h2 = (names[int(rng.integers(len(names)))],
                  names[int(rng.integers(len(names)))])
        rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                           fragment_sd=30)
        reads, true_gene = [], {}
        spans = {h: kp.annotations.get(h, []) for h in (h1, h2)}
        for h in (h1, h2):
            seq = kp.haplotypes[h]
            for p in rs.simulate_pairs_from_string(
                    seq, np.arange(len(seq)), 8.0, name_prefix=h):
                for r in (p.r1, p.r2):
                    reads.append(r.to_fastq())
                    for g, a, b in spans[h]:
                        if r.start_pos < b and r.start_pos + len(r.seq) > a:
                            true_gene.setdefault(r.name, set()).add(g)
        typer = LinearALTsTyper(kp.haplotypes,
                                genes=_gene_spans(kp.annotations),
                                n_is_gap=True, device=args.device,
                                sharded=args.mesh)
        res = typer.type_diploid(reads)
        # read->gene truth evaluation (reads2Genes,
        # HLA-LA.cpp:907-1186 simulation comparisons)
        r2g = typer.reads_to_genes(reads)
        if not _writes(args):
            return 0
        ok = {res.hap1, res.hap2} == {h1, h2}
        print(f"simulated {h1}/{h2}; called {res.hap1}/{res.hap2} "
              f"({'OK' if ok else 'MISMATCH'}, posterior "
              f"{res.posterior:.4f})")
        n_ok = n_tot = 0
        for g, read_names in r2g.items():
            for rn in read_names:
                if rn in true_gene:
                    n_tot += 1
                    n_ok += int(g in true_gene[rn])
        acc = n_ok / n_tot if n_tot else 1.0
        print(f"reads2Genes accuracy: {acc:.4f} ({n_ok}/{n_tot})")
        return 0 if ok and acc >= 0.9 else 1
    L = 2000
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, L))
    panel = {}
    for hi in range(6):
        s = list(base)
        for _ in range(30):
            p = int(rng.integers(0, L))
            s[p] = "ACGT"[int(rng.integers(0, 4))]
        panel[f"KIR_ALT{hi}"] = "".join(s)
    h1, h2 = "KIR_ALT1", "KIR_ALT4"
    rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                       fragment_sd=30)
    reads = []
    for h in (h1, h2):
        seq = panel[h]
        for p in rs.simulate_pairs_from_string(seq, np.arange(len(seq)), 10.0,
                                               name_prefix=h):
            reads += [p.r1.to_fastq(), p.r2.to_fastq()]
    typer = LinearALTsTyper(panel, device=args.device, sharded=args.mesh)
    res = typer.type_diploid(reads)
    if not _writes(args):
        return 0
    ok = {res.hap1, res.hap2} == {h1, h2}
    print(f"simulated {h1}/{h2}; called {res.hap1}/{res.hap2} "
          f"({'OK' if ok else 'MISMATCH'}, posterior {res.posterior:.4f})")
    return 0 if ok else 1


def action_check_kir_graph(args) -> int:
    """Structure + haplotype-path checks on a (KIR) graph package
    (checkKIRgraph, HLA-LA.cpp:1149-1185)."""
    pkg = _require_graph(args)
    prg = pkg.prg()
    prg.check_structure()
    bad = []
    for info in pkg.sequences():
        seq = pkg.prg_fasta()[info.fasta_id]
        levels = pkg.translation(info.prg_id)
        if len(seq) != len(levels):
            bad.append(info.fasta_id)
    print(f"graph OK: {prg.n_levels} levels, {prg.n_nodes} nodes; "
          f"{len(pkg.sequences())} haplotypes"
          + (f"; BROKEN translations: {bad}" if bad else ""))
    return 1 if bad else 0


def action_test_binary(args) -> int:
    print("hla-la-tpu binary functional!")
    return 0


def action_prepare_graph(args) -> int:
    pkg = _require_graph(args)
    from .utils.timing import log_progress
    log_progress("prepareGraph: parsing graph.txt and compiling dense arrays")
    c = pkg.prepare()
    log_progress(f"prepareGraph: done — {c.n_levels} levels, {c.n_nodes} "
                 f"nodes, {len(c.edge_from)} edges, {len(c.jump_from)} "
                 f"gap-jump paths -> {pkg.serialized_path}")
    return 0


def action_check_presence(args) -> int:
    """Check that sequences are emittable paths of the graph
    (testCheckPresence / checkSeq actions, HLA-LA.cpp:152, 1106-1148).
    Sequences come from --FASTQU (FASTA also accepted via --ASMfasta)."""
    pkg = _require_graph(args)
    prg = pkg.prg()
    seqs: dict[str, str] = {}
    if args.ASMfasta:
        from .io.fasta import read_fasta
        seqs.update(read_fasta(args.ASMfasta))
    if args.FASTQU:
        from .io.fastq import read_fastq
        seqs.update({r.name: r.seq for r in read_fastq(args.FASTQU)})
    if not seqs:
        # default self-test: simulated haplotypes must be graph paths
        import numpy as np
        rng = np.random.default_rng(args.seed or 1)
        ok = True
        for s, _, _ in prg.simulate_random_paths(10, rng):
            ok &= prg.path_emits(s)
        print("simulated-path presence check:", "OK" if ok else "FAILED")
        return 0 if ok else 1
    rc = 0
    for name, s in seqs.items():
        present = prg.path_emits(s)
        print(f"{name}\t{'present' if present else 'ABSENT'}")
        rc |= 0 if present else 1
    return rc


def action_global_alignment(args) -> int:
    """Chain-enriched global alignment of one query sequence against one
    reference (globalAlignment.pl equivalent).  --ASMfasta = query FASTA,
    --ref = reference FASTA, --outputDirectory/--workingDir for output."""
    from .io.fasta import read_fasta
    from .mapping.global_align import write_global_alignment
    if not args.ASMfasta or not args.ref:
        raise SystemExit("globalAlignment needs --ASMfasta <query.fa> "
                         "--ref <reference.fa>")
    query = next(iter(read_fasta(args.ASMfasta).values()))
    reference = next(iter(read_fasta(args.ref).values()))
    out = os.path.join(args.outputDirectory or args.workingDir,
                       "globalAlignment.txt")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    mism, strand = write_global_alignment(out, query, reference)
    print(f"globalAlignment: {mism} mismatches, strand {strand} -> {out}")
    return 0


def action_validate(args) -> int:
    """Cohort validation (HLAtypeinference_validation.pl equivalent): the
    samples of --validationBAMs typed one after the other, on --device;
    --nHosts/--hostIdx select cohort rows; --maxThreads is taken and, as
    in the reference, not used.  With --sharded N every sample is typed on
    N ranks (the reference's --backend sharded); rank 0 alone writes the
    report and prints the cohort accuracy."""
    from .validation import read_sample_sheet, validate_cohort
    pkg = _require_graph(args)
    if not args.validationBAMs or not args.trueHLA:
        raise SystemExit("--validationBAMs and --trueHLA required")
    if args.maxThreads > 1 and args.mesh is None:
        # the reference takes the flag and ignores it here
        # (hla_la_tpu/cli.py:524-535): each sample is typed in one process
        log_progress(f"--action validate types each sample in one process: "
                     f"--maxThreads {args.maxThreads} starts no workers")
    if args.sharded and args.mesh is None:
        return _start_ranks(args)
    samples = read_sample_sheet(args.validationBAMs)
    out_dir = args.outputDirectory or os.path.join(args.workingDir,
                                                   "validation")
    report = validate_cohort(pkg, samples, args.trueHLA, out_dir,
                             args.device,
                             resolution=args.resolution,
                             n_hosts=args.nHosts, host_idx=args.hostIdx,
                             ref=args.ref, sharded=args.mesh)
    if report is None:          # a rank other than 0 of a sharded run
        return 0
    print(f"cohort accuracy: {report.total_accuracy * 100:.2f}% over "
          f"{report.n_samples} samples "
          f"({len(report.discordant)} discordant calls)")
    return 0


def action_simulate(args) -> int:
    from .sim.graph_sim import simulate_prg_package
    from .sim.read_sim import ReadSimulator, write_levels_file
    from .io.fastq import write_fastq

    rng = np.random.default_rng(args.seed or 0)
    out = args.workingDir
    sim = simulate_prg_package(rng)
    pkg = sim.write_package(os.path.join(out, "simulated_graph"))
    rs = ReadSimulator(rng)
    h1, h2 = 1, 2
    pairs = []
    for h in (h1, h2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 15.0,
                                               name_prefix=f"hap{h}")
    write_fastq(os.path.join(out, "R_1.fq"), [p.r1.to_fastq() for p in pairs])
    write_fastq(os.path.join(out, "R_2.fq"), [p.r2.to_fastq() for p in pairs])
    write_levels_file(os.path.join(out, "R_1.fq.levels"),
                      [p.r1 for p in pairs])
    write_levels_file(os.path.join(out, "R_2.fq.levels"),
                      [p.r2 for p in pairs])
    print(f"simulated package + {len(pairs)} read pairs (diploid "
          f"haplotypes {h1}/{h2}) in {out}")
    return 0


def action_test_prg_mapping(args) -> int:
    """Simulation round-trip (testPRGMapping, HLA-LA.cpp:1533-1621)."""
    from .graph.package import GraphPackage
    from .models.aligner import ReadAligner
    from .sim.graph_sim import simulate_prg_package
    from .sim.read_sim import ReadSimulator
    from .sim.truth import TrueReadLevels
    from .utils.timing import Timer

    rng = np.random.default_rng(args.seed or 99)
    sim = simulate_prg_package(rng)
    pkg = sim.write_package(os.path.join(args.workingDir, "testPRG_graph"))
    rs = ReadSimulator(rng)
    seq, levels = sim.linearized(1)
    pairs = rs.simulate_pairs_from_string(seq, levels, 10.0)
    truth = TrueReadLevels({})
    for p in pairs:
        truth.truth[p.r1.name + "/1"] = p.r1.levels
        truth.truth[p.r2.name + "/2"] = p.r2.levels
    aligner = ReadAligner(pkg, device=args.device)
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    with Timer() as t:
        aligned = aligner.align_pairs(fq, 110, 35, truth=truth)
    acc = truth.accuracy()
    rate = t.rate(2 * len(pairs))
    print(f"testPRGMapping: {len(aligned)}/{len(pairs)} pairs aligned, "
          f"per-base truth accuracy {acc:.4f}, {rate:.1f} reads/s")
    assert acc > 0.9, "accuracy regression"
    print("OK")
    return 0


def action_test_prg_mapping_unpaired(args) -> int:
    """Unpaired simulation round-trip (testPRGMappingUnpaired,
    HLA-LA.cpp:1386-1532)."""
    from .models.aligner import ReadAligner
    from .sim.graph_sim import simulate_prg_package
    from .sim.read_sim import ReadSimulator
    from .sim.truth import TrueReadLevels

    rng = np.random.default_rng(args.seed or 13)
    sim = simulate_prg_package(rng)
    pkg = sim.write_package(os.path.join(args.workingDir,
                                         "testPRGunpaired_graph"))
    rs = ReadSimulator(rng)
    seq, levels = sim.linearized(2)
    reads = rs.simulate_unpaired_from_string(seq, levels, 6.0,
                                             read_length=150)
    truth = TrueReadLevels({r.name: r.levels for r in reads})
    aligner = ReadAligner(pkg, device=args.device)
    # unpaired mapping test: no min-length gate here (HLA typing applies it)
    out = aligner.align_unpaired([r.to_fastq() for r in reads], truth=truth)
    n_ok = sum(1 for a in out if a is not None)
    acc = truth.accuracy()
    print(f"testPRGMappingUnpaired: {n_ok}/{len(reads)} aligned, "
          f"per-base truth accuracy {acc:.4f}")
    assert acc > 0.9
    print("OK")
    return 0


def action_simulate_from_genome(args) -> int:
    """Simulate paired reads from a plain FASTA (simulateFromNormalGenome,
    HLA-LA.cpp:1893)."""
    from .io.fasta import read_fasta
    from .io.fastq import write_fastq
    from .sim.read_sim import ReadSimulator, write_levels_file

    if not args.ASMfasta:
        raise SystemExit("--ASMfasta <genome.fa> required")
    rng = np.random.default_rng(args.seed or 5)
    genome = read_fasta(args.ASMfasta)
    rs = ReadSimulator(rng)
    pairs = []
    for name, seq in genome.items():
        pairs += rs.simulate_pairs_from_string(
            seq, np.arange(len(seq)), 2.0, name_prefix=name)
    out = args.outputDirectory or args.workingDir
    os.makedirs(out, exist_ok=True)
    write_fastq(os.path.join(out, "R_1.fq"), [p.r1.to_fastq() for p in pairs])
    write_fastq(os.path.join(out, "R_2.fq"), [p.r2.to_fastq() for p in pairs])
    write_levels_file(os.path.join(out, "R_1.fq.levels"),
                      [p.r1 for p in pairs])
    write_levels_file(os.path.join(out, "R_2.fq.levels"),
                      [p.r2 for p in pairs])
    print(f"simulated {len(pairs)} pairs from {len(genome)} contigs -> {out}")
    return 0


def action_test_hla_typing(args) -> int:
    """Simulate individual -> type -> compare (TestHLATyping,
    HLA-LA.cpp:1262-1340).  On --sharded ranks every rank simulates the
    same individual (rank 0 writes the package where one process does, the
    others into a directory of their own) and types it with the others;
    rank 0 prints."""
    from .models.pipeline import _rank_output_dir, run_hla_typing
    from .sim.graph_sim import simulate_prg_package
    from .sim.read_sim import ReadSimulator

    if args.sharded and args.mesh is None:
        return _start_ranks(args)
    rng = np.random.default_rng(args.seed or 7)
    sim = simulate_prg_package(rng)
    with _rank_output_dir(os.path.join(args.workingDir, "testTyping_graph"),
                          args.mesh) as graph_dir:
        pkg = sim.write_package(graph_dir)
        rs = ReadSimulator(rng)
        h1, h2 = 1, 3
        pairs = []
        for h in (h1, h2):
            seq, levels = sim.linearized(h)
            pairs += rs.simulate_pairs_from_string(seq, levels, 15.0,
                                                   name_prefix=f"hap{h}")
        fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
        out_dir = os.path.join(args.workingDir, "testTyping_out")
        res = run_hla_typing(pkg, pairs=fq, output_dir=out_dir,
                             device=args.device, sharded=args.mesh)
    if not _writes(args):
        return 0
    want = {f"{h1 + 1:02d}", f"{h2 + 1:02d}"}
    n_ok = 0
    for r in res.results:
        called = {a.split("*")[1].split(":")[0]
                  for aid in (r.allele1_id, r.allele2_id)
                  for a in aid.split(";")}
        ok = called == want
        n_ok += ok
        print(f"{r.locus}: called {sorted(called)} truth {sorted(want)} "
              f"{'OK' if ok else 'MISMATCH'}")
    assert n_ok == len(res.results), "typing mismatch"
    print("OK")
    return 0


def _write_exon_kmer_counts(pkg, reads, out_dir: str, device) -> str:
    """Per-exon k-mer counts over `reads` -> <out_dir>/kMerCounts.txt
    (extractkMerCounts.pl role, HLA-LA.pl:543-552); the typer that finds
    the exons is made on `device`."""
    from .models.typer import HLATyper
    from .tools import extract_kmer_counts
    typer = HLATyper(pkg, device=device)
    exon_seqs: dict[str, str] = {}
    for locus, exon_map in typer.graph_genes.items():
        for exon_id, fn in exon_map.items():
            _, rows = pkg.read_segment(fn)
            for allele, vals in rows.items():
                if ":" in allele:
                    exon_seqs[f"{locus}_{exon_id}"] = "".join(vals)
                    break
    counts = extract_kmer_counts(reads, exon_seqs)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "kMerCounts.txt")
    with open(path, "w") as fh:
        fh.write("Exon\tkMer\tCount\n")
        for name, kmers in sorted(counts.items()):
            for mer, n in kmers.items():
                fh.write(f"{name}\t{mer}\t{n}\n")
    print(f"wrote {path} ({sum(len(v) for v in counts.values())} k-mers "
          f"over {len(counts)} exons)")
    return path


def action_extract_kmer_counts(args) -> int:
    """Per-exon k-mer counts over input reads (extractkMerCounts.pl,
    HLA-LA.pl:543-552)."""
    from .io.fastq import read_fastq
    pkg = _require_graph(args)
    reads = []
    for p in (args.FASTQ1, args.FASTQ2, args.FASTQU):
        if p:
            reads += list(read_fastq(p))
    if not reads:
        raise SystemExit("need --FASTQ1/--FASTQ2/--FASTQU")
    _write_exon_kmer_counts(pkg, reads,
                            args.outputDirectory or args.workingDir,
                            args.device)
    return 0


def action_graph_from_mfa(args) -> int:
    """Build a graph package from a multiple-FASTA alignment
    (Perl/graphFromMFA.pl equivalent).  --ASMfasta = input MFA,
    --graph = output package directory."""
    if not args.ASMfasta or not args.graph:
        raise SystemExit("graphFromMFA needs --ASMfasta <mfa> --graph <out>")
    from .tools import graph_from_mfa
    pkg = graph_from_mfa(args.ASMfasta, args.graph)
    prg = pkg.prg()
    print(f"graph package written to {args.graph}: {prg.n_levels} levels, "
          f"{prg.n_nodes} nodes, {prg.n_edges} edges")
    return 0


def action_find_kir_in_bam(args) -> int:
    """Per-panel-sequence read hit counts (Perl/findKIRinBAM.pl equivalent).
    --BAM = input, --ALTpanel = gene panel FASTA."""
    if not args.BAM or not args.ALTpanel:
        raise SystemExit("findKIRinBAM needs --BAM and --ALTpanel")
    from .tools import find_gene_reads_in_bam
    hits = find_gene_reads_in_bam(args.BAM, args.ALTpanel)
    for name in sorted(hits):
        print(f"{name}\t{hits[name]}")
    return 0


def action_test_alignments2chains(args) -> int:
    """Projection self-test (testAlignments2Chains, HLA-LA.cpp:1622-1732):
    simulate reads, align, and check every produced chain is concordant with
    its read sequence and has nondecreasing graph levels."""
    from .models.aligner import ReadAligner
    from .sim.graph_sim import simulate_prg_package
    from .sim.read_sim import ReadSimulator, revcomp

    rng = np.random.default_rng(args.seed or 5)
    sim = simulate_prg_package(rng, backbone_length=3000, n_haplotypes=6)
    pkg = sim.write_package(os.path.join(args.workingDir, "a2c_graph"))
    rs = ReadSimulator(rng, read_length=100, fragment_mean=280,
                      fragment_sd=25, with_error=False)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        # distinct prefixes: identical default names would collide in
        # by_name and pair chains with the wrong haplotype's reads
        pairs += rs.simulate_pairs_from_string(seq, levels, 6.0,
                                               name_prefix=f"a2c{h}")
    aligner = ReadAligner(pkg, device=args.device)
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    out = aligner.align_pairs(fq, 280, 25)
    n_checked = 0
    by_name = {r1.name: (r1, r2) for (r1, r2) in fq}
    from .sim.read_sim import revcomp
    for ap in out:
        r1, r2 = by_name[ap.read_id]
        for chain, read in ((ap.chain1, r1), (ap.chain2, r2)):
            lv = chain.levels[chain.levels >= 0]
            assert (np.diff(lv) >= 0).all(), "levels must be nondecreasing"
            # the chain must be concordant with its read sequence
            # (checkChainConcordanceWithSequence, HLA-LA.cpp:1622-1732)
            oriented = revcomp(read.seq) if chain.reverse else read.seq
            chain.check_concordance(oriented)
            n_checked += 1
    print(f"testAlignments2Chains: {n_checked} chains checked, "
          f"{len(out)}/{len(pairs)} pairs aligned — OK")
    return 0


def action_test_chain_extension(args) -> int:
    """Graph-DP chain extension self-test (testChainExtension,
    HLA-LA.cpp:1733-1861): truncate simulated alignments and verify the
    graph realigner extends them back to full length with a valid path."""
    from .models.aligner import ReadAligner
    from .models.graph_fallback import GraphRealigner
    from .sim.graph_sim import simulate_prg_package
    from .sim.read_sim import ReadSimulator

    rng = np.random.default_rng(args.seed or 6)
    sim = simulate_prg_package(rng, backbone_length=1500, n_haplotypes=4)
    pkg = sim.write_package(os.path.join(args.workingDir, "ce_graph"))
    rs = ReadSimulator(rng, read_length=90, fragment_mean=250,
                      fragment_sd=20, with_error=False)
    seq, levels = sim.linearized(1)
    pairs = rs.simulate_pairs_from_string(seq, levels, 4.0)
    aligner = ReadAligner(pkg, device=args.device)
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    out = aligner.align_pairs(fq, 250, 20)
    realigner = GraphRealigner(pkg.compiled(), aligner.hap_seqs,
                               aligner.hap_levels)
    n_ext = 0
    by_name = {r1.name: (r1, r2) for (r1, r2) in fq}
    for ap in out:   # align_pairs returns a FILTERED list: map by name
        r1, r2 = by_name[ap.read_id]
        chain = ap.chain1
        hap_idx = (aligner.prg_ids.index(chain.seq_idx)
                   if chain.seq_idx in aligner.prg_ids else -1)
        if hap_idx < 0:
            continue
        oriented = (r1.seq if not chain.reverse
                    else r1.seq.translate(str.maketrans("ACGT", "TGCA"))[::-1])
        qual = r1.qual if not chain.reverse else r1.qual[::-1]
        re_al = realigner.realign(chain, hap_idx, oriented, qual, False)
        if re_al is not None:
            n_ext += 1
    print(f"testChainExtension: {n_ext} chains re-extended via graph DP — OK")
    return 0


def action_remap_and_reduce(args) -> int:
    """Extract + remap + reduce a WGS BAM/CRAM to a PRG-coordinate BAM
    (Perl/remapAndReduce.pl workflow with the graph aligner as remapper)."""
    _require_graph(args)
    if not args.BAM or not args.out:
        raise SystemExit("remapAndReduce needs --BAM <in.bam|in.cram> "
                         "--graph <pkg> --out <out.bam>")
    from .graph.package import GraphPackage
    from .io.fasta import read_fasta
    from .tools import remap_and_reduce
    cram_ref = read_fasta(args.ref) if args.ref else None
    n_pairs, n_un = remap_and_reduce(args.BAM, GraphPackage(args.graph),
                                     args.out, cram_reference=cram_ref,
                                     device=args.device)
    print(f"remapAndReduce: {n_pairs} pairs + {n_un} unpaired reads "
          f"remapped to PRG coordinates -> {args.out}")
    return 0


def action_downsample_bam(args) -> int:
    """Downsample a BAM by pair fraction (downsampleBAM.pl) or to a
    gigabase depth target (downsample_WGS_BAMs.pl)."""
    if not args.BAM or not args.out:
        raise SystemExit("downsampleBAM needs --BAM <in.bam> --out <path> "
                         "and --fraction or --targetGigabases")
    if (args.fraction is None) == (args.targetGigabases is None):
        raise SystemExit("downsampleBAM needs exactly one of --fraction / "
                         "--targetGigabases")
    if args.fraction is not None:
        from .tools import downsample_bam
        kept, total = downsample_bam(args.BAM, args.out, args.fraction,
                                     seed=args.seed)
        print(f"downsampleBAM: kept {kept}/{total} records -> {args.out}")
    else:
        from .tools import downsample_wgs_bams
        res = downsample_wgs_bams([args.BAM], args.out,
                                  args.targetGigabases, seed=args.seed)
        _, dst, frac, kept, total = res[0]
        print(f"downsampleBAM: fraction {frac:.4f}, kept {kept}/{total} "
              f"records -> {dst}")
    return 0


ACTIONS = {"HLA": action_hla, "prepareGraph": action_prepare_graph,
           "testBinary": action_test_binary, "simulate": action_simulate,
           "testPRGMapping": action_test_prg_mapping,
           "testPRGMappingUnpaired": action_test_prg_mapping_unpaired,
           "simulateFromNormalGenome": action_simulate_from_genome,
           "TestHLATyping": action_test_hla_typing,
           "checkSequencePresence": action_check_presence,
           "ASM": action_asm, "KIR": action_kir, "validate": action_validate,
           "extractkMerCounts": action_extract_kmer_counts,
           "KIRsimulation": action_kir_simulation,
           "buildKIRpanel": action_build_kir_panel,
           "globalAlignment": action_global_alignment,
           "graphFromMFA": action_graph_from_mfa,
           "findKIRinBAM": action_find_kir_in_bam,
           "oneSimulationFromPRG": action_simulate,
           "checkKIRgraph": action_check_kir_graph,
           "testAlignments2Chains": action_test_alignments2chains,
           "testChainExtension": action_test_chain_extension,
           "remapAndReduce": action_remap_and_reduce,
           "downsampleBAM": action_downsample_bam}
