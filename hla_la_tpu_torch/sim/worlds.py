"""Simulated typing worlds for driving the port end to end.

A world is a graph package plus reads sequenced from two planted
haplotypes, made with the package's simulators (``graph_sim``,
``read_sim``): a PRG panel whose gene loci carry `n_alleles` alleles each,
and reads from haplotypes 1 and 2.  The planted alleles are the truth a
run's calls are held to.  Worlds are cached in a directory keyed on their
parameters.

- ``typing_world``: the recipe of ``stress_imgt.py``, targeted deep paired
  100 bp reads over each gene window (two loci, or with ``IMGT4_GENES``
  the four of ``--loci4``); ``imgt_long_reads``: the long reads that its
  ``--long`` mode draws over such a world's gene windows;
- ``e2e_world``: ``tpu_e2e.py``'s small world, paired reads along the whole
  of two haplotypes of a 20,000-level panel;
- ``long_read_world``: unpaired 10 kb reads with ONT-like indels over a
  whole 24,000-column panel whose genes are class-I sized;
- ``kir_world``: a linear-ALT package of 32 aligned haplotypes of a
  150 kb region with 14 genes, one of them absent from some haplotypes,
  and a BAM of paired 100 bp reads from two planted haplotypes, for
  ``--action KIR``;
- ``asm_world``: ``typing_world``'s graph package and an assembly of two
  contigs cut from the two planted haplotypes, for ``--action ASM``;
- ``ambiguous_world``: ``typing_world`` at a coverage so low that a locus is
  called with a Q1 well inside (0, 1): the world that makes the 1e-3 bar on
  Q1/Q2 between two devices bind (``ambiguous_q1`` asserts the range);
- ``decoy_world``: reads of the two planted haplotypes mixed with reads of
  a mutated paralog of gene A that lives outside the PRG, and the decoy
  genome FASTA that ``--decoyFasta`` takes (the recipe of the reference's
  ``tests/test_decoy.py``);
- ``cohort_world``: a cohort of two samples on ``typing_world``'s package
  for ``--action validate``: S1 is ``typing_world``'s reads, S2 reads of
  haplotypes 3 and 4 at the same coverage (``second_sample``), each in a
  BAM (``world_bam`` writes a world's reads into one, with a matching
  knownReferences spec in the package); its truth table holds the planted
  alleles except one deliberately wrong allele of S2 at locus B;
- ``bench_world``, ``wgs_world`` and ``long_bench_reads``: the real-PRG-scale
  worlds of ``bench.py``, ``stress_wgs.py`` and ``stress_long.py``, each made
  with the same calls, in the same order, from the same seed as that script
  (a 3,000,000-level panel of 8 haplotypes; genes A and B, or the 17 loci of
  ``LOCI_FOR_TYPING``; paired 101 bp reads over the whole of haplotypes 1
  and 2, or ONT-like long reads over two gene windows).  `n_levels` cuts
  the backbone for tests.

  world = long_read_world("build/worlds")
  cli.main(["--action", "HLA", *world.cli_args(), "--graph", world.graph])
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from ..graph.package import GraphPackage
from ..io.bam import (FLAG_PAIRED, FLAG_READ1, FLAG_READ2, FLAG_REVERSE,
                      BamRecord, BamWriter)
from ..io.fasta import write_fasta
from ..io.fastq import FastqRead, read_fastq, write_fastq
from ..models.kir_package import build_kir_package
from ..utils.config import LOCI_FOR_TYPING
from .graph_sim import simulate_prg_package
from .read_sim import ReadSimulator, revcomp

# stress_imgt.py's world: two class-I-sized loci (J = 540 typed columns
# each), 2,200 alleles per locus, 1,250x targeted coverage per haplotype
IMGT_GENES = {"A": (0.10, 0.37), "B": (0.50, 0.77)}
IMGT_BACKBONE = 4000
IMGT_ALLELES = 2200
IMGT_COVERAGE = 1250.0
IMGT_SEED = 161803
TRUTH_HAPS = (1, 2)
# stress_imgt.py --loci4: four class-I-sized loci on a backbone of 8,000,
# over the typing fan-out's real gate (50,000 aligned reads, 4 loci)
IMGT4_GENES = {"A": (0.05, 0.185), "B": (0.29, 0.425),
               "C": (0.53, 0.665), "DQB1": (0.76, 0.895)}
IMGT4_BACKBONE = 8000
# stress_imgt.py --long: ONT-like unpaired reads of log-normal length
# (median 2,600) clipped to [1,500, 3,800] at 35x over each gene window
# (+-600 columns), with 0.5% insertions and 0.5% deletions
IMGT_LONG_MEDIAN = 2600
IMGT_LONG_SIGMA = 0.25
IMGT_LONG_CLIP = (1500, 3800)
IMGT_LONG_COVERAGE = 35.0
IMGT_LONG_INDEL = 0.005
IMGT_LONG_FLANK = 600
# tpu_e2e.py's small world: a 20,000-level panel of 6 haplotypes with its
# default genes A and B, paired 100 bp reads at 20x per haplotype along
# the whole of haplotypes 1 and 2
E2E_SEED = 30303
E2E_BACKBONE = 20_000
E2E_HAPLOTYPES = 6
E2E_COVERAGE = 20.0

# the cohort world: S2's haplotypes, the locus at which its truth table
# names a wrong allele, and the one contig of every world's BAM (a
# knownReferences spec in the package extracts all of it)
SECOND_SAMPLE_HAPS = (3, 4)
WRONG_LOCUS = "B"
BAM_CONTIG = ("chr6", 100000)

# the long-read world: each gene spans 0.045 of a 24,000-column backbone,
# 1,080 columns like a ~3.5 kb class-I gene, so J = 540 typed columns as in
# the IMGT world; 10 kb reads at 30x per haplotype with 1% insertions and
# 1% deletions, as ONT R10-era data has
LONG_GENES = {"A": (0.20, 0.245), "B": (0.60, 0.645)}
LONG_BACKBONE = 24000
LONG_READ_LENGTH = 10000
LONG_COVERAGE = 30.0
LONG_INDEL_RATE = 0.01
LONG_SEED = 271828

# the KIR world: the KIR region of the leukocyte receptor complex at the
# scale of an IPD-KIR-style panel: 32 haplotypes of a 150 kb region, 14
# genes of 9 kb, each haplotype with its own SNPs; every fourth haplotype
# lacks one gene (a gene-sized aligned deletion: presence/absence
# variation).  Paired 100 bp reads with substitution errors at 15x from each
# of two planted haplotypes, one of them with the deletion, in a BAM whose
# contig carries
# the region at KIR_REGION_START, plus reads outside the covered region.
KIR_GENES = ("KIR3DL3", "KIR2DS2", "KIR2DL2", "KIR2DL5B", "KIR2DS3",
             "KIR2DP1", "KIR2DL1", "KIR3DP1", "KIR2DL4", "KIR3DL1",
             "KIR2DL5A", "KIR2DS5", "KIR2DS1", "KIR3DL2")
KIR_HAPLOTYPES = 32
KIR_LENGTH = 150000
KIR_SNP_RATE = 0.03
KIR_COVERAGE = 15.0
KIR_DELETED_GENE = 6            # index into KIR_GENES
KIR_TRUTH_HAPS = (9, 19)        # 19 % 4 == 3: carries the deletion
KIR_CONTIG = ("chr19", 58617616)
KIR_REGION_START = 54000000
KIR_SEED = 314159

# the ambiguous world: 60 alleles per locus and half a read pair's worth of
# coverage per haplotype, so that the second allele of locus A is called
# with a Q1 near 0.24 (the other Q1 of the world stay near 1)
AMBIGUOUS_WORLD = {"n_alleles": 60, "coverage": 0.5}
AMBIGUOUS_Q1 = (0.05, 0.95)

# the decoy world: gene A of haplotype 1, mutated at 4%, between two random
# flanks on a contig of a decoy genome; reads at 10x from the paralog and
# at 12x from each planted haplotype
DECOY_BACKBONE = 2400
DECOY_DIVERGENCE = 0.04
DECOY_FLANK = 3000
DECOY_SEED = 99

# the real-PRG-scale worlds (bench.py, stress_wgs.py, stress_long.py): a
# 3,000,000-level panel of 8 haplotypes with SNPs at 1%; paired 101 bp reads
# (fragments of 320 +- 30) over the whole of haplotypes 1 and 2.  The bench
# world holds genes A and B at 1% of the backbone each and reads at 1x per
# haplotype (~30k pairs); the WGS world all 17 typed loci at 0.4% each and
# reads at half the diploid coverage per haplotype (~180k pairs at 12x).
# The long reads are ONT-like reads of the bench panel over two windows of
# 5% around genes A and B: log-normal lengths in [2 kb, 48 kb] at 25x per
# window and haplotype, plus two of 60-90 kb each, with 0.5% insertions and
# 0.5% deletions; reads past LONG_SPLIT are cut into chunks of that length
REAL_SCALE_LEVELS = 3_000_000
BENCH_SEED = 31337
BENCH_GENES = {"A": (0.30, 0.31), "B": (0.60, 0.61)}
BENCH_COVERAGE = 1.0
WGS_SEED = 271828
WGS_GENES = {loc: (0.05 + i * 0.053, 0.05 + i * 0.053 + 0.004)
             for i, loc in enumerate(LOCI_FOR_TYPING)}
WGS_COVERAGE = 12.0
LONG_BENCH_WINDOWS = ((0.28, 0.33), (0.58, 0.63))
LONG_BENCH_COVERAGE = 25.0
LONG_BENCH_INDEL = 0.005
LONG_SPLIT = 50_000

# the assembly world: substitutions per contig, outside the exons
ASM_SUBSTITUTIONS = 5
ASM_SEED = 141421


@dataclasses.dataclass(frozen=True)
class TypingWorld:
    graph: str                          # graph package directory
    fastq1: str
    fastq2: str
    truth: dict[str, list[str]]         # locus -> planted alleles

    def cli_args(self) -> list[str]:
        return ["--FASTQ1", self.fastq1, "--FASTQ2", self.fastq2]


@dataclasses.dataclass(frozen=True)
class CohortSample:
    sample_id: str
    bam: str
    truth: dict[str, list[str]]         # locus -> planted alleles


@dataclasses.dataclass(frozen=True)
class CohortWorld:
    graph: str                          # graph package directory
    sheet: str                          # the --validationBAMs sample sheet
    true_hla: str                       # truth table for --trueHLA
    samples: tuple[CohortSample, ...]
    wrong: tuple[str, str, str]         # (sample, locus, allele) named in
    #                                     the truth table in place of a
    #                                     planted allele

    def cli_args(self) -> list[str]:
        return ["--validationBAMs", self.sheet, "--trueHLA", self.true_hla,
                "--graph", self.graph]


@dataclasses.dataclass(frozen=True)
class DecoyWorld:
    graph: str                          # graph package directory
    fastq1: str
    fastq2: str
    decoy_fasta: str                    # the genome that holds the paralog
    truth: dict[str, list[str]]         # locus -> planted alleles
    n_paralog_pairs: int                # pairs named "para..."

    def cli_args(self) -> list[str]:
        return ["--FASTQ1", self.fastq1, "--FASTQ2", self.fastq2,
                "--decoyFasta", self.decoy_fasta]


@dataclasses.dataclass(frozen=True)
class LongReadWorld:
    graph: str                          # graph package directory
    fastq: str                          # unpaired long reads
    truth: dict[str, list[str]]         # locus -> planted alleles

    def cli_args(self) -> list[str]:
        return ["--FASTQU", self.fastq, "--longReads", "ont2d"]


@dataclasses.dataclass(frozen=True)
class KirWorld:
    panel: str                          # linear-ALT package directory
    bam: str
    read_genes: str     # TSV: read name, the genes the read's span overlaps
    truth: list[str]                    # the two planted haplotypes
    n_pairs: int

    def cli_args(self) -> list[str]:
        return ["--ALTpanel", self.panel, "--BAM", self.bam]

    def true_genes(self) -> dict[str, set[str]]:
        """Read name -> genes; the mates of a pair share their name."""
        out: dict[str, set[str]] = {}
        with open(self.read_genes) as fh:
            for line in fh:
                name, genes = line.rstrip("\n").split("\t")
                out.setdefault(name, set()).update(genes.split(","))
        return out


@dataclasses.dataclass(frozen=True)
class AsmWorld:
    graph: str                          # graph package directory
    fasta: str                          # the assembly's contigs
    true_hla: str                       # truth table for --trueHLA
    truth: dict[str, dict[str, str]]    # contig -> locus -> planted allele
    strands: dict[str, str]             # contig -> "+" or "-"

    def cli_args(self) -> list[str]:
        return ["--ASMfasta", self.fasta, "--trueHLA", self.true_hla]


@dataclasses.dataclass(frozen=True)
class RealScaleWorld:
    graph: str                          # graph package directory
    fastq1: str
    fastq2: str
    truth: dict[str, list[str]]         # locus -> planted alleles
    n_levels: int                       # backbone length of the panel
    truth_levels: str | None = None     # per-base truth levels of the reads

    def pairs(self) -> list:
        """The read pairs as (FastqRead, FastqRead), in the order drawn."""
        return list(zip(read_fastq(self.fastq1), read_fastq(self.fastq2)))


@dataclasses.dataclass(frozen=True)
class LongBenchReads:
    graph: str                          # the bench panel's package
    fastq: str                          # unpaired long reads, not split
    truth_levels: str                   # per-base truth levels of the reads
    truth: dict[str, list[str]]         # locus -> planted alleles


def save_levels(path: str, levels: dict[str, np.ndarray]) -> None:
    """Per-read truth levels (read name -> level per base) in one file."""
    names = list(levels)
    np.savez(path, names=np.asarray(names, dtype=str),
             lengths=np.asarray([len(levels[n]) for n in names],
                                dtype=np.int64),
             levels=(np.concatenate([levels[n] for n in names])
                     if names else np.zeros(0, np.int64)).astype(np.int64))


def load_levels(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        parts = np.split(z["levels"], np.cumsum(z["lengths"])[:-1])
        return dict(zip(z["names"].tolist(), parts))


def _cached(root: str, make_world, build):
    """The world cached in `root`, or a new one: `make_world(truth)` names
    the world's files under `root`, and `build(world)` writes them and
    returns (truth, summary)."""
    done = os.path.join(root, "world.json")
    if os.path.exists(done):
        with open(done) as fh:
            return make_world(json.load(fh)["truth"])
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    truth, summary = build(make_world(None))
    with open(done, "w") as fh:
        json.dump({**summary, "truth": truth}, fh, indent=1)
    return make_world(truth)


def _panel_sim(rng, backbone: int, genes: dict, n_alleles: int):
    """A panel of 8 haplotypes with `genes`; the first alleles of each
    locus are the panel haplotypes' exons.  The panel is the first thing
    drawn from `rng`, so one seed gives one panel."""
    return simulate_prg_package(rng, backbone_length=backbone,
                                n_haplotypes=8, snp_rate=0.01, genes=genes,
                                n_gene_alleles=n_alleles,
                                allele_snp_rate=0.02)


def _planted(sim, haps) -> dict[str, list[str]]:
    """Locus -> the alleles of haplotypes `haps`."""
    return {locus: [list(alleles)[h] for h in haps]
            for locus, alleles in sim.gene_alleles.items()}


def _panel(rng, backbone: int, genes: dict, n_alleles: int, graph: str):
    """_panel_sim's panel, written to `graph`, and its truth: the alleles
    of haplotypes TRUTH_HAPS."""
    sim = _panel_sim(rng, backbone, genes, n_alleles)
    sim.write_package(graph)
    return sim, _planted(sim, TRUTH_HAPS)


def _gene_window_pairs(rng, sim, genes: dict, haps, coverage: float):
    """Paired 100 bp reads at `coverage` per haplotype of `haps` over each
    gene window (+-300 columns)."""
    rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                       fragment_sd=25, with_error=True)
    windows = []
    for locus in genes:
        cols = [i for i, n in enumerate(sim.column_names)
                if f"_gene_{locus}_" in n]
        windows.append((min(cols) - 300, max(cols) + 300))
    pairs = []
    for h in haps:
        seq, levels = sim.linearized(h)
        for gi, (lo, hi) in enumerate(windows):
            sel = np.nonzero((levels >= lo) & (levels <= hi))[0]
            pairs += rs.simulate_pairs_from_string(
                seq[sel[0]:sel[-1] + 1], levels[sel[0]:sel[-1] + 1],
                coverage, name_prefix=f"h{h}g{gi}")
    return pairs


def _write_bam(path: str, pairs) -> None:
    """FASTQ read pairs as mate records on BAM_CONTIG, written to a
    temporary file that is then renamed to `path`."""
    writer = BamWriter(path + ".part", [BAM_CONTIG])
    for r1, r2 in pairs:
        for mate, r in ((FLAG_READ1, r1), (FLAG_READ2, r2)):
            writer.write(BamRecord(name=r.name, flag=FLAG_PAIRED | mate,
                                   ref_id=0, pos=0, mapq=60,
                                   cigar=[(len(r.seq), 0)], seq=r.seq,
                                   qual=r.qual))
    writer.close()
    os.replace(path + ".part", path)


def _write_bam_spec(graph: str) -> None:
    """The knownReferences spec that matches every world's BAM: all of
    BAM_CONTIG is extracted."""
    path = os.path.join(graph, "knownReferences", "worlds_bam.txt")
    with open(path, "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"{BAM_CONTIG[0]}\t{BAM_CONTIG[1]}\t1\t\t\n")


def typing_world(out_dir: str, n_alleles: int = IMGT_ALLELES,
                 coverage: float = IMGT_COVERAGE,
                 backbone: int = IMGT_BACKBONE,
                 genes: dict = IMGT_GENES) -> TypingWorld:
    """Build (or reuse from `out_dir`) a world on a `backbone`-column panel
    with `genes`, `n_alleles` alleles per locus and paired 100 bp reads at
    `coverage` per haplotype over each gene window (+-300 columns), from
    haplotypes 1 and 2."""
    root = os.path.join(out_dir, f"b{backbone}_a{n_alleles}_c{coverage:g}")
    if genes != IMGT_GENES:
        root += "_" + "-".join(genes)

    def make_world(truth):
        return TypingWorld(graph=os.path.join(root, "pkg"),
                           fastq1=os.path.join(root, "R_1.fq"),
                           fastq2=os.path.join(root, "R_2.fq"), truth=truth)

    def build(world):
        rng = np.random.default_rng(IMGT_SEED)
        sim, truth = _panel(rng, backbone, genes, n_alleles, world.graph)
        pairs = _gene_window_pairs(rng, sim, genes, TRUTH_HAPS, coverage)
        write_fastq(world.fastq1, [p.r1.to_fastq() for p in pairs])
        write_fastq(world.fastq2, [p.r2.to_fastq() for p in pairs])
        return truth, {"seed": IMGT_SEED, "backbone": backbone,
                       "alleles": n_alleles, "coverage": coverage,
                       "genes": genes, "pairs": len(pairs)}

    return _cached(root, make_world, build)


def imgt_long_reads(world: TypingWorld) -> LongReadWorld:
    """Build (or reuse from beside `world`'s reads) the long reads that
    ``stress_imgt.py --long`` draws for a typing_world: the panel drawn
    again from IMGT_SEED (not written: `world`'s package is it), then, on
    the same generator, over each gene window (+-IMGT_LONG_FLANK columns) of
    haplotypes 1 and 2, reads of log-normal length clipped to
    IMGT_LONG_CLIP until IMGT_LONG_COVERAGE times the window is reached,
    with IMGT_LONG_INDEL insertions and deletions
    (``stress_imgt.py:231-267``)."""
    root = os.path.dirname(world.graph)
    with open(os.path.join(root, "world.json")) as fh:
        made = json.load(fh)
    genes = made.get("genes", IMGT_GENES)
    long_root = os.path.join(root, "long")

    def make_world(truth):
        return LongReadWorld(graph=world.graph,
                             fastq=os.path.join(long_root, "R_U.fq"),
                             truth=truth)

    def build(out):
        rng = np.random.default_rng(IMGT_SEED)
        sim = _panel_sim(rng, made["backbone"], genes, made["alleles"])
        rs = ReadSimulator(rng, insertion_rate=IMGT_LONG_INDEL,
                           deletion_rate=IMGT_LONG_INDEL)
        windows = []
        for locus in genes:
            cols = [i for i, n in enumerate(sim.column_names)
                    if f"_gene_{locus}_" in n]
            windows.append((min(cols) - IMGT_LONG_FLANK,
                            max(cols) + IMGT_LONG_FLANK))
        reads = []
        for h in TRUTH_HAPS:
            seq, levels = sim.linearized(h)
            for gi, (lo, hi) in enumerate(windows):
                sel = np.nonzero((levels >= lo) & (levels <= hi))[0]
                src = seq[sel[0]:sel[-1] + 1]
                slv = levels[sel[0]:sel[-1] + 1]
                made_bases, i = 0, 0
                while made_bases < IMGT_LONG_COVERAGE * len(src):
                    L = int(np.clip(rng.lognormal(np.log(IMGT_LONG_MEDIAN),
                                                  IMGT_LONG_SIGMA),
                                    IMGT_LONG_CLIP[0],
                                    min(IMGT_LONG_CLIP[1], len(src) - 1)))
                    rs.read_length = L
                    start = int(rng.integers(0, max(1, len(src) - L)))
                    r = rs._sequence_read(src, slv, start)
                    if r is None:
                        continue
                    reads.append(FastqRead(f"lr_h{h}g{gi}:::{i}", r[0], r[1]))
                    made_bases += L
                    i += 1
        write_fastq(out.fastq, reads)
        return _planted(sim, TRUTH_HAPS), {
            "seed": IMGT_SEED, "reads": len(reads),
            "bases": sum(len(r.seq) for r in reads)}

    return _cached(long_root, make_world, build)


def e2e_world(out_dir: str, backbone: int = E2E_BACKBONE) -> TypingWorld:
    """Build (or reuse from `out_dir`) tpu_e2e.py's world: a `backbone`
    panel of E2E_HAPLOTYPES haplotypes with SNPs at 1% and its default
    genes, and paired 100 bp reads (fragments of 300 +- 25, with errors) at
    E2E_COVERAGE per haplotype along the whole of haplotypes 1 and 2
    (``tpu_e2e.py:89-100``)."""
    root = os.path.join(out_dir, f"e2e_b{backbone}")

    def make_world(truth):
        return TypingWorld(graph=os.path.join(root, "pkg"),
                           fastq1=os.path.join(root, "R_1.fq"),
                           fastq2=os.path.join(root, "R_2.fq"), truth=truth)

    def build(world):
        rng = np.random.default_rng(E2E_SEED)
        sim = simulate_prg_package(rng, backbone_length=backbone,
                                   n_haplotypes=E2E_HAPLOTYPES,
                                   snp_rate=0.01)
        rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                           fragment_sd=25, with_error=True)
        pairs = []
        for h in TRUTH_HAPS:
            seq, levels = sim.linearized(h)
            pairs += rs.simulate_pairs_from_string(seq, levels,
                                                   E2E_COVERAGE,
                                                   name_prefix=f"h{h}")
        sim.write_package(world.graph)
        write_fastq(world.fastq1, [p.r1.to_fastq() for p in pairs])
        write_fastq(world.fastq2, [p.r2.to_fastq() for p in pairs])
        return _planted(sim, TRUTH_HAPS), {
            "seed": E2E_SEED, "backbone": backbone, "pairs": len(pairs)}

    return _cached(root, make_world, build)


def world_bam(world: TypingWorld) -> str:
    """`world`'s read pairs in a BAM beside its FASTQ files (written once),
    and the knownReferences spec that matches it in the world's package."""
    path = os.path.join(os.path.dirname(world.fastq1), "reads.bam")
    if not os.path.exists(path):
        _write_bam(path, zip(read_fastq(world.fastq1),
                             read_fastq(world.fastq2)))
    _write_bam_spec(world.graph)
    return path


def second_sample(out_dir: str, n_alleles: int = IMGT_ALLELES,
                  coverage: float = IMGT_COVERAGE,
                  backbone: int = IMGT_BACKBONE) -> CohortSample:
    """Build (or reuse from `out_dir`) a second sample for the package of
    typing_world(out_dir, n_alleles, coverage, backbone): the same panel,
    drawn again from IMGT_SEED and not written, and reads of haplotypes
    SECOND_SAMPLE_HAPS drawn as typing_world draws those of TRUTH_HAPS, in
    a BAM.  Its truth also holds, under "wrong", the first allele of
    WRONG_LOCUS that neither planted allele matches at two fields and
    whose exons differ from theirs (so that no call can hold it)."""
    from ..utils.nomenclature import allele_list_compatible
    root = os.path.join(out_dir, f"b{backbone}_a{n_alleles}_c{coverage:g}_"
                                 f"h{''.join(map(str, SECOND_SAMPLE_HAPS))}")

    def make_world(truth):
        return CohortSample(sample_id="S2", bam=os.path.join(root, "S2.bam"),
                            truth=truth)

    def build(world):
        rng = np.random.default_rng(IMGT_SEED)
        sim = _panel_sim(rng, backbone, IMGT_GENES, n_alleles)
        pairs = _gene_window_pairs(rng, sim, IMGT_GENES, SECOND_SAMPLE_HAPS,
                                   coverage)
        _write_bam(world.bam, [(p.r1.to_fastq(), p.r2.to_fastq())
                               for p in pairs])
        truth = _planted(sim, SECOND_SAMPLE_HAPS)
        alleles = sim.gene_alleles[WRONG_LOCUS]
        truth["wrong"] = next(
            a for a, seq in alleles.items()
            if not any(allele_list_compatible(a, p, 2)
                       or seq == alleles[p] for p in truth[WRONG_LOCUS]))
        return truth, {"seed": IMGT_SEED, "haplotypes":
                       list(SECOND_SAMPLE_HAPS), "pairs": len(pairs)}

    return _cached(root, make_world, build)


def cohort_world(out_dir: str, n_alleles: int = IMGT_ALLELES,
                 coverage: float = IMGT_COVERAGE,
                 backbone: int = IMGT_BACKBONE) -> CohortWorld:
    """typing_world's package with two samples, S1 (typing_world's reads,
    through world_bam) and S2 (second_sample), a sample sheet and a truth
    table that names second_sample's "wrong" allele in place of S2's
    second planted allele at WRONG_LOCUS."""
    typing = typing_world(out_dir, n_alleles, coverage, backbone)
    s1 = CohortSample("S1", world_bam(typing), typing.truth)
    s2 = second_sample(out_dir, n_alleles, coverage, backbone)
    wrong = s2.truth["wrong"]
    s2 = dataclasses.replace(s2, truth={
        lc: a for lc, a in s2.truth.items() if lc != "wrong"})
    root = os.path.join(out_dir, f"cohort_b{backbone}_a{n_alleles}_"
                                 f"c{coverage:g}")
    os.makedirs(root, exist_ok=True)
    world = CohortWorld(graph=typing.graph,
                        sheet=os.path.join(root, "validationBAMs.txt"),
                        true_hla=os.path.join(root, "trueHLA.txt"),
                        samples=(s1, s2), wrong=("S2", WRONG_LOCUS, wrong))
    loci = sorted(typing.truth)
    with open(world.sheet, "w") as fh:
        fh.writelines(f"{s.sample_id}\t{s.bam}\n" for s in world.samples)
    with open(world.true_hla, "w") as fh:
        fh.write("IndividualID\t" + "\t".join(
            lc for lc in loci for _ in range(2)) + "\n")
        for s in world.samples:
            row = [a for lc in loci for a in s.truth[lc]]
            if s.sample_id == "S2":
                row[2 * loci.index(WRONG_LOCUS) + 1] = wrong
            fh.write(s.sample_id + "\t" + "\t".join(row) + "\n")
    return world


def ambiguous_world(out_dir: str) -> TypingWorld:
    """typing_world at AMBIGUOUS_WORLD's size: at least one allele is called
    with a Q1 inside AMBIGUOUS_Q1 (hold a run to it with ambiguous_q1)."""
    return typing_world(out_dir, **AMBIGUOUS_WORLD)


def ambiguous_q1(bestguess_rows) -> list[float]:
    """The Q1 values strictly inside AMBIGUOUS_Q1 among the rows of a
    R1_bestguess.txt table (header included); raises when there is none,
    so that the world cannot quietly become certain."""
    lo, hi = AMBIGUOUS_Q1
    q1 = [float(r[3]) for r in bestguess_rows[1:]]
    inside = [q for q in q1 if lo < q < hi]
    if not inside:
        raise AssertionError(f"no Q1 inside ({lo}, {hi}): {q1}")
    return inside


def decoy_world(out_dir: str) -> DecoyWorld:
    """Build (or reuse from `out_dir`) the paralog world: a 5-haplotype
    panel, a decoy genome with a DECOY_DIVERGENCE-mutated copy of
    haplotype 1's gene A, and paired 100 bp reads of haplotypes 1 and 2
    followed by those of the paralog ("para..." names)."""
    root = os.path.join(out_dir, f"decoy_b{DECOY_BACKBONE}")

    def make_world(truth):
        return DecoyWorld(graph=os.path.join(root, "pkg"),
                          fastq1=os.path.join(root, "R_1.fq"),
                          fastq2=os.path.join(root, "R_2.fq"),
                          decoy_fasta=os.path.join(root, "decoy.fa"),
                          truth=truth and truth["alleles"],
                          n_paralog_pairs=truth and truth["paralog_pairs"])

    def build(world):
        rng = np.random.default_rng(DECOY_SEED)
        sim = simulate_prg_package(rng, backbone_length=DECOY_BACKBONE,
                                   n_haplotypes=5, snp_rate=0.012)
        sim.write_package(world.graph)
        hap1, lv1 = sim.linearized(1)
        gene_cols = [i for i, n in enumerate(sim.column_names)
                     if "_gene_A_" in n]
        in_gene = (lv1 >= min(gene_cols)) & (lv1 <= max(gene_cols))
        para = [b for b, keep in zip(hap1, in_gene) if keep]
        for i in range(len(para)):
            if rng.random() < DECOY_DIVERGENCE:
                para[i] = "ACGT"[("ACGT".index(para[i])
                                  + int(rng.integers(1, 4))) % 4]

        def random_seq(n):
            return "".join(rng.choice(list("ACGT"), n))

        flank = random_seq(DECOY_FLANK)
        contig = flank + "".join(para) + random_seq(DECOY_FLANK)
        write_fasta(world.decoy_fasta, {"chr11_paralog": contig,
                                        "chr2_random": random_seq(5000)})
        rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                           fragment_sd=25, with_error=True)
        para_pairs = [
            p for p in rs.simulate_pairs_from_string(
                contig, np.full(len(contig), -1, dtype=np.int64), 10.0,
                name_prefix="para")
            if len(flank) - 200 < p.r1.start_pos < len(flank) + len(para)]
        pairs = []
        for h in TRUTH_HAPS:
            seq, levels = sim.linearized(h)
            pairs += rs.simulate_pairs_from_string(seq, levels, 12.0,
                                                   name_prefix=f"true{h}")
        pairs += para_pairs
        write_fastq(world.fastq1, [p.r1.to_fastq() for p in pairs])
        write_fastq(world.fastq2, [p.r2.to_fastq() for p in pairs])
        alleles = {locus: [list(sim.gene_alleles[locus])[h]
                           for h in TRUTH_HAPS] for locus in sim.gene_alleles}
        return ({"alleles": alleles, "paralog_pairs": len(para_pairs)},
                {"seed": DECOY_SEED, "backbone": DECOY_BACKBONE,
                 "divergence": DECOY_DIVERGENCE, "pairs": len(pairs)})

    return _cached(root, make_world, build)


def long_read_world(out_dir: str, n_alleles: int = IMGT_ALLELES,
                    coverage: float = LONG_COVERAGE,
                    backbone: int = LONG_BACKBONE,
                    read_length: int = LONG_READ_LENGTH) -> LongReadWorld:
    """Build (or reuse from `out_dir`) a world on a `backbone`-column panel
    with `n_alleles` alleles per locus and unpaired `read_length` reads at
    `coverage` per haplotype along the whole of haplotypes 1 and 2, with
    sequencing errors and LONG_INDEL_RATE insertions and deletions."""
    genes = LONG_GENES
    root = os.path.join(out_dir, f"long_b{backbone}_a{n_alleles}_"
                                 f"c{coverage:g}_r{read_length}")

    def make_world(truth):
        return LongReadWorld(graph=os.path.join(root, "pkg"),
                             fastq=os.path.join(root, "R_U.fq"), truth=truth)

    def build(world):
        rng = np.random.default_rng(LONG_SEED)
        sim, truth = _panel(rng, backbone, genes, n_alleles, world.graph)
        rs = ReadSimulator(rng, insertion_rate=LONG_INDEL_RATE,
                           deletion_rate=LONG_INDEL_RATE, with_error=True)
        reads = []
        for h in TRUTH_HAPS:
            seq, levels = sim.linearized(h)
            reads += rs.simulate_unpaired_from_string(
                seq, levels, coverage, read_length=read_length,
                name_prefix=f"h{h}")
        write_fastq(world.fastq, [r.to_fastq() for r in reads])
        return truth, {"seed": LONG_SEED, "backbone": backbone,
                       "alleles": n_alleles, "coverage": coverage,
                       "read_length": read_length,
                       "indel_rate": LONG_INDEL_RATE, "reads": len(reads)}

    return _cached(root, make_world, build)


def kir_world(out_dir: str, length: int = KIR_LENGTH,
              coverage: float = KIR_COVERAGE,
              n_haplotypes: int = KIR_HAPLOTYPES) -> KirWorld:
    """Build (or reuse from `out_dir`) a linear-ALT package of
    `n_haplotypes` aligned haplotypes of `length` columns and a BAM of
    paired 100 bp reads at `coverage` from each of the two planted
    haplotypes, placed on KIR_CONTIG inside the package's covered region
    (with TLEN set), and 200 reads far outside it."""
    root = os.path.join(out_dir, f"kir_h{n_haplotypes}_l{length}_"
                                 f"c{coverage:g}")
    planted = [f"KIR_ALT{h:02d}" for h in KIR_TRUTH_HAPS]

    def make_world(truth):
        return KirWorld(panel=os.path.join(root, "panel"),
                        bam=os.path.join(root, "in.bam"),
                        read_genes=os.path.join(root, "read_genes.tsv"),
                        truth=truth and truth["haplotypes"],
                        n_pairs=truth and truth["pairs"])

    def build(world):
        rng = np.random.default_rng(KIR_SEED)
        base = rng.integers(0, 4, length).astype(np.uint8)
        slot = length // len(KIR_GENES)
        spans = [(g, i * slot + slot // 10, i * slot + slot * 7 // 10)
                 for i, g in enumerate(KIR_GENES)]
        gone = spans[KIR_DELETED_GENE]
        acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
        haps, ann = {}, {}
        for h in range(n_haplotypes):
            codes = base.copy()
            snp = rng.random(length) < KIR_SNP_RATE
            codes[snp] = (codes[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
            row = acgt[codes]
            name = f"KIR_ALT{h:02d}"
            ann[name] = list(spans)
            if h % 4 == 3:
                row[gone[1]:gone[2]] = ord("-")
                ann[name].remove(gone)
            haps[name] = row.tobytes().decode()
        stop = KIR_REGION_START + length
        build_kir_package(world.panel, haps, ann,
                          {KIR_CONTIG[0]: (KIR_REGION_START, stop)})
        # substitution errors alone: the simulator draws a read with an
        # indel base by base, which at this many reads would take most of
        # the build
        rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                           fragment_sd=30, insertion_rate=0.0,
                           deletion_rate=0.0, with_error=True)
        writer = BamWriter(world.bam, [KIR_CONTIG])
        n_pairs = 0
        with open(world.read_genes, "w") as fh:
            for name in planted:
                aligned = np.frombuffer(haps[name].encode(), dtype=np.uint8)
                to_panel = np.flatnonzero(aligned != ord("-"))
                seq = aligned[to_panel].tobytes().decode()
                pairs = rs.simulate_pairs_from_string(
                    seq, np.arange(len(seq)), coverage, name_prefix=name)
                n_pairs += len(pairs)
                for p in pairs:
                    tlen = (abs(p.r2.start_pos - p.r1.start_pos)
                            + len(p.r2.seq))
                    for mate, r, tl in ((FLAG_READ1, p.r1, tlen),
                                        (FLAG_READ2, p.r2, -tlen)):
                        # a BAM holds a reverse-strand read as its
                        # reverse complement, flagged
                        sq, q, flag = r.seq, r.qual, FLAG_PAIRED | mate
                        if r.reverse:
                            sq, q = revcomp(sq), q[::-1]
                            flag |= FLAG_REVERSE
                        writer.write(BamRecord(
                            name=r.name, flag=flag, ref_id=0,
                            pos=KIR_REGION_START + max(r.start_pos, 0),
                            mapq=60, cigar=[(len(sq), 0)], seq=sq, qual=q,
                            tlen=tl))
                        a = to_panel[max(r.start_pos, 0)]
                        b = to_panel[min(r.start_pos + len(r.seq),
                                         len(seq)) - 1] + 1
                        genes = [g for g, lo, hi in ann[name]
                                 if a < hi and b > lo]
                        if genes:
                            fh.write(f"{r.name}\t{','.join(genes)}\n")
        for j in range(200):        # dropped at extraction
            sq = acgt[rng.integers(0, 4, 100)].tobytes().decode()
            writer.write(BamRecord(name=f"far{j}", flag=0, ref_id=0,
                                   pos=stop + 1000000 + 50 * j, mapq=60,
                                   cigar=[(100, 0)], seq=sq, qual="I" * 100))
        writer.close()
        truth = {"haplotypes": planted, "pairs": n_pairs}
        return truth, {"seed": KIR_SEED, "haplotypes": n_haplotypes,
                       "length": length, "coverage": coverage,
                       "snp_rate": KIR_SNP_RATE}

    return _cached(root, make_world, build)


def asm_world(out_dir: str, n_alleles: int = IMGT_ALLELES,
              coverage: float = IMGT_COVERAGE,
              backbone: int = IMGT_BACKBONE) -> AsmWorld:
    """Build (or reuse from `out_dir`) an assembly for the graph package of
    typing_world(out_dir, n_alleles, coverage, backbone): one contig per
    planted haplotype, cut from the package's linearized haplotypes, the
    second one reverse-complemented, each with ASM_SUBSTITUTIONS
    substitutions at least 60 bases away from every exon; and the truth
    table that ``--trueHLA`` takes."""
    typing = typing_world(out_dir, n_alleles, coverage, backbone)
    root = os.path.join(os.path.dirname(typing.graph), "asm")

    def make_world(truth):
        return AsmWorld(graph=typing.graph,
                        fasta=os.path.join(root, "contigs.fa"),
                        true_hla=os.path.join(root, "trueHLA.txt"),
                        truth=truth and truth["alleles"],
                        strands=truth and truth["strands"])

    def build(world):
        rng = np.random.default_rng(ASM_SEED)
        pkg = GraphPackage(world.graph)
        exon_levels = np.asarray(sorted(pkg.segment_levels(
            [fn for fn in pkg.segment_files() if "_exon_" in fn]).values()))
        by_id = {s.fasta_id: s for s in pkg.sequences()}
        contigs, alleles, strands = {}, {}, {}
        for i, h in enumerate(TRUTH_HAPS):
            info = by_id[f"PRG_hap_{h}"]
            seq = list(pkg.prg_fasta()[info.fasta_id])
            levels = pkg.translation(info.prg_id)
            nearest = np.abs(levels[:, None] - exon_levels[None, :]).min(1)
            free = np.flatnonzero(nearest > 60)
            for p in rng.choice(free, ASM_SUBSTITUTIONS, replace=False):
                seq[p] = "ACGT"[("ACGT".index(seq[p])
                                 + int(rng.integers(1, 4))) % 4]
            name = f"contig_hap{h}"
            strands[name] = "-" if i else "+"
            contigs[name] = revcomp("".join(seq)) if i else "".join(seq)
            alleles[name] = {locus: planted[i]
                             for locus, planted in typing.truth.items()}
        write_fasta(world.fasta, contigs)
        loci = sorted(typing.truth)
        with open(world.true_hla, "w") as fh:
            fh.write("IndividualID\t" + "\t".join(
                lc for lc in loci for _ in range(2)) + "\n")
            fh.write("S1\t" + "\t".join(
                a for lc in loci for a in typing.truth[lc]) + "\n")
        return ({"alleles": alleles, "strands": strands},
                {"seed": ASM_SEED, "substitutions": ASM_SUBSTITUTIONS})

    return _cached(root, make_world, build)


def _real_scale_panel(rng, n_levels: int, genes: dict):
    return simulate_prg_package(rng, backbone_length=n_levels,
                                n_haplotypes=8, snp_rate=0.01, genes=genes)


def _whole_haplotype_pairs(rng, sim, coverage: float):
    """Paired 101 bp reads at `coverage` along the whole of each of
    haplotypes TRUTH_HAPS."""
    rs = ReadSimulator(rng, read_length=101, fragment_mean=320,
                       fragment_sd=30, with_error=True)
    pairs = []
    for h in TRUTH_HAPS:
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, coverage,
                                               name_prefix=f"h{h}")
    return pairs


def _real_scale_world(root: str, seed: int, n_levels: int, genes: dict,
                      coverage: float, keep_levels: bool) -> RealScaleWorld:
    def make_world(truth):
        return RealScaleWorld(
            graph=os.path.join(root, "pkg"),
            fastq1=os.path.join(root, "R_1.fq"),
            fastq2=os.path.join(root, "R_2.fq"), truth=truth,
            n_levels=n_levels,
            truth_levels=(os.path.join(root, "levels.npz") if keep_levels
                          else None))

    def build(world):
        rng = np.random.default_rng(seed)
        sim = _real_scale_panel(rng, n_levels, genes)
        sim.write_package(world.graph)
        pairs = _whole_haplotype_pairs(rng, sim, coverage)
        write_fastq(world.fastq1, [p.r1.to_fastq() for p in pairs])
        write_fastq(world.fastq2, [p.r2.to_fastq() for p in pairs])
        if keep_levels:
            levels = {}
            for p in pairs:
                levels[p.r1.name + "/1"] = p.r1.levels
                levels[p.r2.name + "/2"] = p.r2.levels
            save_levels(world.truth_levels, levels)
        return _planted(sim, TRUTH_HAPS), {
            "seed": seed, "backbone": n_levels, "loci": len(genes),
            "coverage": coverage, "pairs": len(pairs)}

    return _cached(root, make_world, build)


def bench_world(out_dir: str, n_levels: int = REAL_SCALE_LEVELS
                ) -> RealScaleWorld:
    """Build (or reuse from `out_dir`) bench.py's world: an `n_levels`
    panel with genes A and B, paired reads at BENCH_COVERAGE per haplotype
    along the whole of haplotypes 1 and 2, and their truth levels
    (``bench.py:57-87``)."""
    return _real_scale_world(os.path.join(out_dir, f"bench_b{n_levels}"),
                             BENCH_SEED, n_levels, BENCH_GENES,
                             BENCH_COVERAGE, keep_levels=True)


def wgs_world(out_dir: str, coverage: float = WGS_COVERAGE,
              n_levels: int = REAL_SCALE_LEVELS) -> RealScaleWorld:
    """Build (or reuse from `out_dir`) stress_wgs.py's world: an `n_levels`
    panel with the 17 loci of LOCI_FOR_TYPING and paired reads at
    `coverage` / 2 per haplotype along the whole of haplotypes 1 and 2
    (``stress_wgs.py:42-84``)."""
    return _real_scale_world(
        os.path.join(out_dir, f"wgs_b{n_levels}_c{coverage:g}"), WGS_SEED,
        n_levels, WGS_GENES, coverage / 2, keep_levels=False)


def long_bench_reads(out_dir: str, n_levels: int = REAL_SCALE_LEVELS,
                     coverage: float = LONG_BENCH_COVERAGE
                     ) -> LongBenchReads:
    """Build (or reuse from `out_dir`) stress_long.py's long reads of
    bench_world's panel, drawn from BENCH_SEED after the panel as that
    script draws them (``stress_long.py:55-107``): over each window of
    LONG_BENCH_WINDOWS of haplotypes 1 and 2, reads of log-normal length in
    [2 kb, 48 kb] until `coverage` times the window is reached, half of
    them reverse-complemented, then two reads of 60-90 kb.  Truth levels
    are kept per read in its sequencing orientation.  The panel is drawn
    here again and written beside the reads: the package is bench_world's,
    byte for byte, without the bench world's short reads."""
    root = os.path.join(out_dir, f"bench_b{n_levels}_long_c{coverage:g}")

    def make_world(truth):
        return LongBenchReads(graph=os.path.join(root, "pkg"),
                              fastq=os.path.join(root, "R_U.fq"),
                              truth_levels=os.path.join(root, "levels.npz"),
                              truth=truth)

    def build(out):
        truth, reads = _long_bench_reads(n_levels, coverage, out.graph)
        write_fastq(out.fastq, [r.to_fastq() for r in reads])
        save_levels(out.truth_levels, {r.name: r.levels for r in reads})
        return truth, {"seed": BENCH_SEED, "backbone": n_levels,
                       "coverage": coverage, "reads": len(reads),
                       "bases": sum(len(r.seq) for r in reads)}

    return _cached(root, make_world, build)


def _long_bench_reads(n_levels: int, coverage: float, graph: str) -> tuple:
    """(planted alleles, reads) of long_bench_reads; the panel's package is
    written to `graph` (writing draws nothing)."""
    from .read_sim import SimulatedRead
    rng = np.random.default_rng(BENCH_SEED)
    sim = _real_scale_panel(rng, n_levels, BENCH_GENES)
    sim.write_package(graph)
    rs = ReadSimulator(rng, insertion_rate=LONG_BENCH_INDEL,
                       deletion_rate=LONG_BENCH_INDEL)
    reads = []
    for h in TRUTH_HAPS:
        seq, levels = sim.linearized(h)
        n = len(seq)
        for wi, (flo, fhi) in enumerate(LONG_BENCH_WINDOWS):
            src = seq[int(flo * n):int(fhi * n)]
            slv = levels[int(flo * n):int(fhi * n)]
            target = coverage * len(src)
            made = 0
            i = 0
            while made < target:
                L = int(np.clip(rng.lognormal(np.log(12000), 0.7),
                                2000, 48000))
                start = int(rng.integers(0, max(1, len(src) - L)))
                rs.read_length = L
                r = rs._sequence_read(src, slv, start)
                if r is None:
                    continue
                rev = bool(rng.random() < 0.5)
                name = f"ont_h{h}_w{wi}:::{i}"
                if rev:
                    reads.append(SimulatedRead(name, revcomp(r[0]),
                                               r[1][::-1], r[2][::-1],
                                               True, start))
                else:
                    reads.append(SimulatedRead(name, r[0], r[1], r[2],
                                               False, start))
                made += L
                i += 1
            # two reads past LONG_SPLIT per window and haplotype
            for j in range(2):
                L = int(rng.integers(60_000, 90_000))
                start = int(rng.integers(0, max(1, len(src) - L)))
                rs.read_length = L
                r = rs._sequence_read(src, slv, start)
                if r is not None:
                    reads.append(SimulatedRead(
                        f"ont_h{h}_w{wi}_xl:::{j}", r[0], r[1], r[2],
                        False, start))
    return _planted(sim, TRUTH_HAPS), reads


def split_levels(levels: dict[str, np.ndarray],
                 chunk: int = LONG_SPLIT) -> dict[str, np.ndarray]:
    """Truth levels of reads cut as the CLI cuts reads past `chunk` bases
    (``cli._split_long_reads``): chunk i of read r is r:::chunk<i>."""
    out = {}
    for name, lv in levels.items():
        if len(lv) <= chunk:
            out[name] = lv
            continue
        for i in range(0, len(lv), chunk):
            out[f"{name}:::chunk{i // chunk}"] = lv[i:i + chunk]
    return out
