"""Simulated typing worlds for driving the port end to end.

A world is a graph package plus paired FASTQ reads sequenced from two
planted haplotypes, made with the reference's simulators
(``hla_la_tpu/sim``) after the recipe of ``stress_imgt.py``: a PRG panel
whose gene loci carry `n_alleles` alleles each, and targeted deep reads over
each gene window.  The planted alleles are the truth a run's calls are held
to.  Worlds are cached in a directory keyed on their parameters.

  world = typing_world("build/worlds")        # stress_imgt's IMGT scale
  python -m hla_la_tpu_torch --action HLA --FASTQ1 world.fastq1 ...
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from hla_la_tpu.io.fastq import write_fastq
from hla_la_tpu.sim.graph_sim import simulate_prg_package
from hla_la_tpu.sim.read_sim import ReadSimulator

# stress_imgt.py's world: two class-I-sized loci (J = 540 typed columns
# each), 2,200 alleles per locus, 1,250x targeted coverage per haplotype
IMGT_GENES = {"A": (0.10, 0.37), "B": (0.50, 0.77)}
IMGT_BACKBONE = 4000
IMGT_ALLELES = 2200
IMGT_COVERAGE = 1250.0
IMGT_SEED = 161803
TRUTH_HAPS = (1, 2)


@dataclasses.dataclass(frozen=True)
class TypingWorld:
    graph: str                          # graph package directory
    fastq1: str
    fastq2: str
    truth: dict[str, list[str]]         # locus -> planted alleles


def typing_world(out_dir: str, n_alleles: int = IMGT_ALLELES,
                 coverage: float = IMGT_COVERAGE,
                 backbone: int = IMGT_BACKBONE) -> TypingWorld:
    """Build (or reuse from `out_dir`) a world on a `backbone`-column panel
    with `n_alleles` alleles per locus and paired 100 bp reads at
    `coverage` per haplotype over each gene window (+-300 columns), from
    haplotypes 1 and 2."""
    genes = IMGT_GENES
    root = os.path.join(out_dir, f"b{backbone}_a{n_alleles}_c{coverage:g}")
    done = os.path.join(root, "world.json")

    def world_with(truth):
        return TypingWorld(graph=os.path.join(root, "pkg"),
                           fastq1=os.path.join(root, "R_1.fq"),
                           fastq2=os.path.join(root, "R_2.fq"), truth=truth)

    if os.path.exists(done):
        with open(done) as fh:
            return world_with(json.load(fh)["truth"])

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(IMGT_SEED)
    sim = simulate_prg_package(rng, backbone_length=backbone, n_haplotypes=8,
                               snp_rate=0.01, genes=genes,
                               n_gene_alleles=n_alleles,
                               allele_snp_rate=0.02)
    # the first alleles of each locus are the panel haplotypes' exons
    world = world_with({locus: [list(sim.gene_alleles[locus])[h]
                                for h in TRUTH_HAPS] for locus in genes})
    sim.write_package(world.graph)
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
    with open(done, "w") as fh:
        json.dump({"seed": IMGT_SEED, "backbone": backbone,
                   "alleles": n_alleles, "coverage": coverage,
                   "pairs": len(pairs), "truth": world.truth}, fh, indent=1)
    return world
