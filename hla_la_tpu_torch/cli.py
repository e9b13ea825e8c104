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
whose cluster axis follows from N as in the reference.

``--action KIR`` types reads against a linear-ALT panel (``--ALTpanel``: a
package directory or a FASTA), ``--action ASM`` types assembly contigs
(``--ASMfasta``) against a graph package; ``KIRsimulation``,
``buildKIRpanel`` and ``checkKIRgraph`` are the KIR module's self-test,
panel packager and graph check.  Not ported yet: other actions (they exit
non-zero).

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
from .utils.timing import log_progress


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
                         "per-locus typing; each holds a context on "
                         "--device")
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
                         "(HLA-LA.pl:543-552); not ported yet, refused")
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
    ap.add_argument("--resolution", type=int, default=2,
                    help="nomenclature fields compared in evaluation")
    ap.add_argument("--nHosts", type=int, default=1,
                    help="--action HLA: total hosts of a read-slice "
                         "alignment run")
    ap.add_argument("--hostIdx", type=int, default=0,
                    help="--action HLA with --nHosts>1: this host's index")
    ap.add_argument("--shardDir",
                    help="--action HLA with --nHosts>1: directory this "
                         "host's align shard is written to")
    ap.add_argument("--mergeShards",
                    help="--action HLA: merge align shards from this "
                         "directory and run typing (no read input needed)")
    ap.add_argument("--sharded", type=int, default=0,
                    help="--action HLA: ranks of a torch.distributed group "
                         "started on this host (0: one process); rank r "
                         "computes on card r modulo the card count")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.mesh = mesh
    args.argv = list(sys.argv[1:] if argv is None else argv)
    action = ACTIONS.get(args.action)
    if action is None:
        print(f"--action {args.action}: not yet ported (only "
              f"{', '.join(ACTIONS)})", file=sys.stderr)
        return 2
    return action(args)


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
        raise SystemExit(
            "--extractExonkMerCounts needs tools.extract_kmer_counts, which "
            "this package does not hold yet; run the reference package's "
            "--action extractkMerCounts on the extracted FASTQs "
            "(--keepExtractedFastq 1) instead")
    if args.sharded and args.mesh is None:
        # this process only starts the ranks; each runs this action again
        # with its mesh
        from .parallel.launch import rank_cli, run_ranks
        log_progress(f"starting {args.sharded} ranks on {args.device}")
        ranks = run_ranks(rank_cli, args.sharded, args.device,
                          args=(args.argv,))
        for rank, (rc, launches) in enumerate(ranks):
            log_progress(f"rank {rank}: exit code {rc}, kernel launches "
                         + ", ".join(f"{k} {n}" for k, n in launches.items()))
        return max(rc for rc, _ in ranks)
    writes = args.mesh is None or args.mesh.rank == 0
    if writes:
        os.makedirs(out_dir, exist_ok=True)

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
                            n_is_gap=kir_pkg is not None, device=args.device)
    if pairs:
        # paired model incl. the insert-size term
        # (processCollectedAlignments, linearALTs.h:69)
        if mean is None:
            mean, sd = typer.estimate_insert(pairs)
        res = typer.type_diploid_paired(pairs, mean, sd)
    else:
        res = typer.type_diploid(reads)
    print(f"best ALT pair: {res.hap1} / {res.hap2} "
          f"(posterior {res.posterior:.4f})")
    out_dir = args.outputDirectory or os.path.join(args.workingDir,
                                                   args.sampleID + "_KIR")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "KIR_haplotypes.txt"), "w") as fh:
        fh.write("Haplotype1\tHaplotype2\tPosterior\n")
        fh.write(f"{res.hap1}\t{res.hap2}\t{res.posterior:.6f}\n")
    if genes:
        r2g = typer.reads_to_genes(reads)
        with open(os.path.join(out_dir, "reads2Genes.txt"), "w") as fh:
            fh.write("Gene\tNReads\tReadIDs\n")
            for g in sorted(r2g):
                fh.write(f"{g}\t{len(r2g[g])}\t"
                         f"{','.join(sorted(r2g[g]))}\n")
        print("reads2Genes: " + ", ".join(
            f"{g}={len(r2g[g])}" for g in sorted(r2g)))
    log_progress(typer.stats.report())
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
    simulates from the real panel incl. read->gene truth evaluation."""
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
                                n_is_gap=True, device=args.device)
        res = typer.type_diploid(reads)
        ok = {res.hap1, res.hap2} == {h1, h2}
        print(f"simulated {h1}/{h2}; called {res.hap1}/{res.hap2} "
              f"({'OK' if ok else 'MISMATCH'}, posterior "
              f"{res.posterior:.4f})")
        # read->gene truth evaluation (reads2Genes,
        # HLA-LA.cpp:907-1186 simulation comparisons)
        r2g = typer.reads_to_genes(reads)
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
    typer = LinearALTsTyper(panel, device=args.device)
    res = typer.type_diploid(reads)
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


ACTIONS = {"HLA": action_hla, "ASM": action_asm, "KIR": action_kir,
           "KIRsimulation": action_kir_simulation,
           "buildKIRpanel": action_build_kir_panel,
           "checkKIRgraph": action_check_kir_graph}
