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
  whole 24,000-column panel whose genes are class-I sized.

  world = long_read_world("build/worlds")
  cli.main(["--action", "HLA", *world.cli_args(), "--graph", world.graph])
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from ..io.fastq import write_fastq
from .graph_sim import simulate_prg_package
from .read_sim import ReadSimulator

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


@dataclasses.dataclass(frozen=True)
class TypingWorld:
    graph: str                          # graph package directory
    fastq1: str
    fastq2: str
    truth: dict[str, list[str]]         # locus -> planted alleles

    def cli_args(self) -> list[str]:
        return ["--FASTQ1", self.fastq1, "--FASTQ2", self.fastq2]


@dataclasses.dataclass(frozen=True)
class LongReadWorld:
    graph: str                          # graph package directory
    fastq: str                          # unpaired long reads
    truth: dict[str, list[str]]         # locus -> planted alleles

    def cli_args(self) -> list[str]:
        return ["--FASTQU", self.fastq, "--longReads", "ont2d"]


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
