"""KIR / linear-ALT data-package support.

The reference's linearALTs module reads a panel directory
(linearALTs.cpp:38-72):

  equalLengthHaplotypesBlock/haplotypes.fa            equal-length ALTs
  equalLengthHaplotypesBlock/haplotypes_information.txt
  equalLengthHaplotypesBlock/haplotypes.annotation    per-position gene labels
  extendedGenome_coveredRegions.txt                   BAM extraction regions
  regionalHaplotypesWithExplicitGenes/sequenceIDs.txt (+ genes.fa)
  geneGraph/                                          gene PRG package

The reference ships no packager (the KIR panel was prepared offline from
IPD-KIR data).  Here both directions exist: `build_kir_package` turns a set
of ALIGNED region haplotypes + gene annotations into the full layout
(including the gene PRG built with the standard package writer), and
`KirPackage` loads it for the `--action KIR` workflow
(HLA-LA.cpp:812-905)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import read_fasta, write_fasta

GAPS = ("-", "_", ".")


@dataclass
class KirPackage:
    dir: str
    haplotypes: dict[str, str] = field(default_factory=dict)  # equal length
    annotations: dict[str, list[tuple[str, int, int]]] = \
        field(default_factory=dict)      # hap -> [(gene, start0, stop0)]
    covered_regions: dict[str, tuple[int, int]] = field(default_factory=dict)
    gene_seqs: dict[str, str] = field(default_factory=dict)  # fastaID -> seq
    gene_of_fasta_id: dict[str, str] = field(default_factory=dict)

    @classmethod
    def load(cls, directory: str) -> "KirPackage":
        blk = os.path.join(directory, "equalLengthHaplotypesBlock")
        haps = read_fasta(os.path.join(blk, "haplotypes.fa"))
        lens = {len(s) for s in haps.values()}
        assert len(lens) == 1, "ALT haplotypes must be equal length"
        ann: dict[str, list[tuple[str, int, int]]] = {}
        ann_path = os.path.join(blk, "haplotypes.annotation")
        if os.path.exists(ann_path):
            with open(ann_path) as fh:
                fh.readline()
                for line in fh:
                    f = line.rstrip("\n").split("\t")
                    if len(f) >= 4:
                        ann.setdefault(f[0], []).append(
                            (f[1], int(f[2]), int(f[3])))
        covered: dict[str, tuple[int, int]] = {}
        cov_path = os.path.join(directory,
                                "extendedGenome_coveredRegions.txt")
        if os.path.exists(cov_path):
            with open(cov_path) as fh:
                fh.readline()
                for line in fh:
                    f = line.rstrip("\n").split("\t")
                    if len(f) >= 3:
                        covered[f[0]] = (int(f[1]), int(f[2]))
        genes_dir = os.path.join(directory,
                                 "regionalHaplotypesWithExplicitGenes")
        gene_seqs: dict[str, str] = {}
        gene_of: dict[str, str] = {}
        ids_path = os.path.join(genes_dir, "sequenceIDs.txt")
        if os.path.exists(ids_path):
            gene_seqs = read_fasta(os.path.join(genes_dir, "genes.fa"))
            with open(ids_path) as fh:
                fh.readline()
                for line in fh:
                    f = line.rstrip("\n").split("\t")
                    if len(f) >= 2:
                        gene_of[f[0]] = f[1]
        return cls(directory, haps, ann, covered, gene_seqs, gene_of)

    @property
    def gene_graph_dir(self) -> str:
        return os.path.join(self.dir, "geneGraph")

    def genes(self) -> list[str]:
        return sorted({g for spans in self.annotations.values()
                       for g, _, _ in spans})


def build_kir_package(out_dir: str,
                      aligned_haplotypes: dict[str, str],
                      gene_annotations: dict[str, list[tuple[str, int,
                                                             int]]],
                      covered_regions: dict[str, tuple[int, int]]
                      | None = None) -> KirPackage:
    """FASTA(-alignment) -> full linear-ALT package.

    aligned_haplotypes: equal-length ALIGNED sequences ('-'/'_' gaps
    allowed; gaps become N in the equal-length block, matching the
    reference's proportionN tolerance, linearALTs.cpp:78).
    gene_annotations: per haplotype, gene spans in ALIGNMENT coordinates.
    """
    lens = {len(s) for s in aligned_haplotypes.values()}
    assert len(lens) == 1, "input haplotypes must be aligned (equal length)"
    blk = os.path.join(out_dir, "equalLengthHaplotypesBlock")
    os.makedirs(blk, exist_ok=True)

    equal = {}
    for name, s in aligned_haplotypes.items():
        t = s.upper()
        for g in GAPS:
            t = t.replace(g, "N")
        equal[name] = t
    write_fasta(os.path.join(blk, "haplotypes.fa"), equal)
    with open(os.path.join(blk, "haplotypes_information.txt"), "w") as fh:
        fh.write("haplotypeID\tlength\n")
        for name, s in equal.items():
            fh.write(f"{name}\t{len(s)}\n")
    with open(os.path.join(blk, "haplotypes.annotation"), "w") as fh:
        fh.write("haplotypeID\tgene\tstart0\tstop0\n")
        for name, spans in gene_annotations.items():
            for gene, a, b in spans:
                fh.write(f"{name}\t{gene}\t{a}\t{b}\n")
    with open(os.path.join(out_dir, "extendedGenome_coveredRegions.txt"),
              "w") as fh:
        fh.write("contigID\tstart0\tstop0\n")
        for contig, (a, b) in (covered_regions or {}).items():
            fh.write(f"{contig}\t{a}\t{b}\n")

    # explicit gene sequences (gapless) per haplotype
    genes_dir = os.path.join(out_dir, "regionalHaplotypesWithExplicitGenes")
    os.makedirs(genes_dir, exist_ok=True)
    gene_seqs: dict[str, str] = {}
    gene_of: dict[str, str] = {}
    per_gene_aligned: dict[str, dict[str, str]] = {}
    for name, spans in gene_annotations.items():
        for gene, a, b in spans:
            aligned = aligned_haplotypes[name][a:b]
            gapless = aligned
            for g in GAPS:
                gapless = gapless.replace(g, "")
            if not gapless:
                continue
            fasta_id = f"{name}__{gene}"
            gene_seqs[fasta_id] = gapless
            gene_of[fasta_id] = gene
            per_gene_aligned.setdefault(gene, {})[name] = aligned
    write_fasta(os.path.join(genes_dir, "genes.fa"), gene_seqs)
    with open(os.path.join(genes_dir, "sequenceIDs.txt"), "w") as fh:
        fh.write("fastaID\tgene\thaplotypeID\n")
        for fasta_id, gene in gene_of.items():
            fh.write(f"{fasta_id}\t{gene}\t{fasta_id.split('__')[0]}\n")

    # gene PRG package: one gene segment per KIR gene over the aligned
    # haplotype block (the reference's geneGraph PRG)
    _build_gene_graph(os.path.join(out_dir, "geneGraph"),
                      aligned_haplotypes, gene_annotations)
    return KirPackage.load(out_dir)


def _build_gene_graph(graph_dir: str, aligned_haplotypes, gene_annotations):
    from ..graph.package import write_package
    from ..graph.prg import prg_from_haplotypes

    names = sorted(aligned_haplotypes)
    rows = [aligned_haplotypes[n].upper().replace("-", "_").replace(".", "_")
            for n in names]
    n_cols = len(rows[0])
    # column names: gene segments carved where ANY haplotype has the gene
    # (deterministic: annotations visited in sorted order — column
    # ownership must not depend on dict iteration order)
    gene_cols = np.zeros(n_cols, dtype=object)
    gene_cols[:] = ""
    for name in sorted(gene_annotations):
        for gene, a, b in sorted(gene_annotations[name]):
            for j in range(a, b):
                if not gene_cols[j]:
                    gene_cols[j] = gene
    segs: list[tuple[str, int, int]] = []
    j = 0
    seg_idx = 0
    # a gene whose columns are interrupted (overlapping annotations) gets
    # one segment PER RUN with distinct exon ordinals — duplicate
    # "exon_2" keys would silently shadow all but the last run in
    # _discover_genes-style consumers
    gene_runs: dict[str, int] = {}
    while j < n_cols:
        g = gene_cols[j]
        j2 = j
        while j2 < n_cols and gene_cols[j2] == g:
            j2 += 1
        if g:
            run = gene_runs.get(g, 0)
            gene_runs[g] = run + 1
            segs.append((f"{seg_idx}_gene_{g}_{seg_idx}_exon_{2 + run}.txt",
                         j, j2))
        else:
            segs.append((f"{seg_idx}_nongene_{seg_idx}.txt", j, j2))
        seg_idx += 1
        j = j2
    column_names = []
    for fn, a, b in segs:
        base = fn[:-4]
        column_names += [f"{base}_{k}" for k in range(b - a)]
    prg = prg_from_haplotypes(rows, column_names)
    segments = []
    for fn, a, b in segs:
        cols = column_names[a:b]
        seg_rows = {}
        parts = fn.split("_")
        if parts[1] == "gene":
            gene = parts[2]
            # allele rows named <gene>*<nn>:01 — only for haplotypes whose
            # annotation says they CARRY this gene over this span; KIR
            # presence/absence variation means other haplotypes' gap/N
            # columns here encode gene absence, not a phantom allele
            for hi, n in enumerate(names):
                carries = any(g2 == gene and a2 < b and b2 > a
                              for g2, a2, b2 in gene_annotations.get(n, []))
                if not carries:
                    continue
                allele = f"{gene}*{hi + 1:02d}:01"
                seg_rows[allele] = list(rows[hi][a:b])
        for hi, n in enumerate(names):
            seg_rows.setdefault(n, list(rows[hi][a:b]))
        segments.append((fn, cols, seg_rows))
    hap_seqs = {}
    for hi, n in enumerate(names):
        seq = []
        levels = []
        for j, ch in enumerate(rows[hi]):
            if ch != "_":
                seq.append(ch)
                levels.append(j)
        hap_seqs[n] = ("".join(seq), np.asarray(levels, dtype=np.int64))
    write_package(graph_dir, prg, segments, hap_seqs)
