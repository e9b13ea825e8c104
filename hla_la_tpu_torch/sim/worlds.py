"""Simulated typing worlds for driving the port end to end.

A world is a graph package plus reads sequenced from two planted
haplotypes, made with the package's simulators (``graph_sim``,
``read_sim``): a PRG panel whose gene loci carry `n_alleles` alleles each,
and reads from haplotypes 1 and 2.  The planted alleles are the truth a
run's calls are held to.  Worlds are cached in a directory keyed on their
parameters.

- ``typing_world``: the recipe of ``stress_imgt.py``, targeted deep paired
  100 bp reads over each gene window;
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
  ``tests/test_decoy.py``).

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
from ..io.fastq import write_fastq
from ..models.kir_package import build_kir_package
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


def _panel(rng, backbone: int, genes: dict, n_alleles: int, graph: str):
    """A panel of 8 haplotypes with `genes`, written to `graph`, and its
    truth: the first alleles of each locus are the panel haplotypes'
    exons."""
    sim = simulate_prg_package(rng, backbone_length=backbone, n_haplotypes=8,
                               snp_rate=0.01, genes=genes,
                               n_gene_alleles=n_alleles,
                               allele_snp_rate=0.02)
    sim.write_package(graph)
    truth = {locus: [list(sim.gene_alleles[locus])[h] for h in TRUTH_HAPS]
             for locus in genes}
    return sim, truth


def typing_world(out_dir: str, n_alleles: int = IMGT_ALLELES,
                 coverage: float = IMGT_COVERAGE,
                 backbone: int = IMGT_BACKBONE) -> TypingWorld:
    """Build (or reuse from `out_dir`) a world on a `backbone`-column panel
    with `n_alleles` alleles per locus and paired 100 bp reads at
    `coverage` per haplotype over each gene window (+-300 columns), from
    haplotypes 1 and 2."""
    genes = IMGT_GENES
    root = os.path.join(out_dir, f"b{backbone}_a{n_alleles}_c{coverage:g}")

    def make_world(truth):
        return TypingWorld(graph=os.path.join(root, "pkg"),
                           fastq1=os.path.join(root, "R_1.fq"),
                           fastq2=os.path.join(root, "R_2.fq"), truth=truth)

    def build(world):
        rng = np.random.default_rng(IMGT_SEED)
        sim, truth = _panel(rng, backbone, genes, n_alleles, world.graph)
        rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                           fragment_sd=25, with_error=True)
        windows = []
        for locus in genes:
            cols = [i for i, n in enumerate(sim.column_names)
                    if f"_gene_{locus}_" in n]
            windows.append((min(cols) - 300, max(cols) + 300))
        pairs = []
        for h in TRUTH_HAPS:
            seq, levels = sim.linearized(h)
            for gi, (lo, hi) in enumerate(windows):
                sel = np.nonzero((levels >= lo) & (levels <= hi))[0]
                pairs += rs.simulate_pairs_from_string(
                    seq[sel[0]:sel[-1] + 1], levels[sel[0]:sel[-1] + 1],
                    coverage, name_prefix=f"h{h}g{gi}")
        write_fastq(world.fastq1, [p.r1.to_fastq() for p in pairs])
        write_fastq(world.fastq2, [p.r2.to_fastq() for p in pairs])
        return truth, {"seed": IMGT_SEED, "backbone": backbone,
                       "alleles": n_alleles, "coverage": coverage,
                       "pairs": len(pairs)}

    return _cached(root, make_world, build)


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
