"""Random PRG simulator (reference: Graph/graphSimulator/simpleGraphSimulator,
simpleGraphSimulator.h:21-54).

Generates a panel of aligned haplotypes over a random backbone with
configurable SNP / deletion / insertion densities, builds the PRG from the
panel, and can emit a complete fake graph package (`storeLikeRealPRG`
equivalent) — including gene segment files so the full typing engine runs on
simulated data with known truth.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..graph.package import GraphPackage, write_package
from ..graph.prg import PRG, prg_from_haplotypes

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class SimulatedPRG:
    prg: PRG
    haplotypes: list[str]             # aligned, with '_' gaps; [H][n_columns]
    haplotype_names: list[str]
    column_names: list[str]           # graph locus IDs, one per column
    gene_segments: list[tuple[str, list[str], dict[str, list[str]]]]
    gene_alleles: dict[str, dict[str, str]] = field(default_factory=dict)
    # {locus: {allele_name: combined exon sequence (aligned, with gaps)}}

    @property
    def n_columns(self) -> int:
        return len(self.column_names)

    def linearized(self, h: int) -> tuple[str, np.ndarray]:
        """Haplotype h without gaps + graph level per base."""
        seq = []
        levels = []
        for i, c in enumerate(self.haplotypes[h]):
            if c != "_":
                seq.append(c)
                levels.append(i)
        return "".join(seq), np.asarray(levels, dtype=np.int64)

    def write_package(self, graph_dir: str, compile_now: bool = True) -> GraphPackage:
        hap_seqs = {}
        for hi, name in enumerate(self.haplotype_names):
            seq, levels = self.linearized(hi)
            hap_seqs[name] = (seq, levels)
        return write_package(graph_dir, self.prg, self.gene_segments, hap_seqs,
                             compile_now=compile_now)


def _mutate_panel(rng: np.random.Generator, backbone: np.ndarray, n_hap: int,
                  snp_rate: float, del_rate: float, ins_rate: float,
                  mean_indel_len: float) -> list[np.ndarray]:
    """Aligned panel from a backbone: SNPs, deletion runs ('_'), and insertion
    columns (backbone gets '_', a subset of haplotypes gets bases)."""
    L = len(backbone)
    cols: list[np.ndarray] = []  # each [n_hap+1] uint8, row 0 = backbone
    hap_del_until = np.zeros(n_hap, dtype=np.int64)
    pos = 0
    while pos < L:
        # insertion event before this column?
        if rng.random() < ins_rate:
            ins_len = max(1, int(rng.geometric(1.0 / mean_indel_len)))
            carriers = rng.random(n_hap) < 0.5
            if carriers.any():
                for _ in range(ins_len):
                    col = np.full(n_hap + 1, ord("_"), dtype=np.uint8)
                    col[1:][carriers] = BASES[rng.integers(0, 4, int(carriers.sum()))]
                    cols.append(col)
        col = np.empty(n_hap + 1, dtype=np.uint8)
        col[0] = backbone[pos]
        for h in range(n_hap):
            if hap_del_until[h] > pos:
                col[h + 1] = ord("_")
            elif rng.random() < del_rate:
                run = max(1, int(rng.geometric(1.0 / mean_indel_len)))
                hap_del_until[h] = pos + run
                col[h + 1] = ord("_")
            elif rng.random() < snp_rate:
                col[h + 1] = BASES[(np.searchsorted(BASES, backbone[pos]) +
                                    rng.integers(1, 4)) % 4]
            else:
                col[h + 1] = backbone[pos]
        cols.append(col)
        pos += 1
    panel = np.stack(cols, axis=1)  # [n_hap+1, n_cols]
    return [panel[i] for i in range(n_hap + 1)]


def simulate_prg_package(rng: np.random.Generator,
                         n_haplotypes: int = 6,
                         backbone_length: int = 2400,
                         snp_rate: float = 0.01,
                         del_rate: float = 0.002,
                         ins_rate: float = 0.002,
                         mean_indel_len: float = 2.0,
                         genes: dict[str, tuple[float, float]] | None = None,
                         n_gene_alleles: int = 12,
                         allele_snp_rate: float = 0.02,
                         allele_names: dict[str, list[str]] | None = None,
                         ) -> SimulatedPRG:
    """Simulate a PRG panel plus gene segment files.

    `genes` maps locus name -> (start_frac, stop_frac) of the backbone to call
    a gene; each gene gets two exon segments (exon_2, exon_3) with
    `n_gene_alleles` allele rows derived from the panel haplotypes by extra
    SNP mutation (so the allele DB is a superset of what reads can express).
    """
    if genes is None:
        genes = {"A": (0.15, 0.45), "B": (0.55, 0.85)}

    backbone = BASES[rng.integers(0, 4, backbone_length)]
    rows = _mutate_panel(rng, backbone, n_haplotypes, snp_rate, del_rate,
                         ins_rate, mean_indel_len)
    haplotypes = ["".join(map(chr, r)) for r in rows]
    n_cols = len(haplotypes[0])
    hap_names = [f"PRG_hap_{i}" for i in range(len(haplotypes))]

    # assign columns to segments: for each gene, carve exon_2/exon_3 segment
    # column ranges out of [start, stop); remaining columns become generic
    # "before/between/after" segments
    col_of_frac = lambda f: int(f * n_cols)
    seg_bounds: list[tuple[str, int, int]] = []  # (segname, lo, hi)
    cursor = 0
    seg_idx = 0
    gene_exon_cols: dict[str, list[tuple[str, int, int]]] = {}
    for locus, (f0, f1) in sorted(genes.items(), key=lambda kv: kv[1][0]):
        lo, hi = col_of_frac(f0), col_of_frac(f1)
        assert lo >= cursor, "genes must not overlap"
        if lo > cursor:
            seg_bounds.append((f"{seg_idx}_nongene_{seg_idx}.txt", cursor, lo))
            seg_idx += 1
        # split gene into intron_1 | exon_2 | intron_2 | exon_3
        q = np.linspace(lo, hi, 5).astype(int)
        parts = [("intron_1", q[0], q[1]), ("exon_2", q[1], q[2]),
                 ("intron_2", q[2], q[3]), ("exon_3", q[3], q[4])]
        gene_exon_cols[locus] = []
        for part, a, b in parts:
            fn = f"{seg_idx}_gene_{locus}_{seg_idx}_{part}.txt"
            seg_bounds.append((fn, a, b))
            if part.startswith("exon"):
                gene_exon_cols[locus].append((fn, a, b))
            seg_idx += 1
        cursor = hi
    if cursor < n_cols:
        seg_bounds.append((f"{seg_idx}_nongene_{seg_idx}.txt", cursor, n_cols))
        seg_idx += 1

    column_names = []
    for name, lo, hi in seg_bounds:
        base = name[:-4]
        for k in range(hi - lo):
            column_names.append(f"{base}_{k}")
    assert len(column_names) == n_cols

    # gene allele DB: first alleles are the panel haplotypes' exon slices
    # (typable truth), the rest are extra mutated alleles
    gene_alleles: dict[str, dict[str, str]] = {}
    segments: list[tuple[str, list[str], dict[str, list[str]]]] = []
    for locus, exon_list in gene_exon_cols.items():
        alleles: dict[str, str] = {}
        for ai in range(n_gene_alleles):
            if ai < len(haplotypes):
                combined = "".join(
                    haplotypes[ai][a:b] for _, a, b in exon_list)
            else:
                src = haplotypes[int(rng.integers(len(haplotypes)))]
                combined = "".join(src[a:b] for _, a, b in exon_list)
                chars = list(combined)
                for i, c in enumerate(chars):
                    if c != "_" and rng.random() < allele_snp_rate:
                        chars[i] = chr(BASES[(np.searchsorted(BASES, ord(c)) +
                                              rng.integers(1, 4)) % 4])
                combined = "".join(chars)
            names_for = (allele_names or {}).get(locus)
            name = (names_for[ai] if names_for and ai < len(names_for)
                    else f"{locus}*{ai + 1:02d}:01")
            alleles[name] = combined
        gene_alleles[locus] = alleles

    for name, lo, hi in seg_bounds:
        cols = column_names[lo:hi]
        parts = name[:-4].split("_")
        if parts[1] == "gene" and "exon" in name:
            locus = parts[2]
            exon_list = gene_exon_cols[locus]
            # which exon slice of the combined allele string is this file?
            offset = 0
            rows_out: dict[str, list[str]] = {}
            for fn, a, b in exon_list:
                if fn == name:
                    for allele, combined in gene_alleles[locus].items():
                        rows_out[allele] = list(combined[offset:offset + (b - a)])
                    break
                offset += b - a
            # also include the panel haplotypes as non-colon rows (the real
            # files carry reference haplotypes too; typer skips names w/o ':')
            for hi_, hname in enumerate(hap_names):
                rows_out[hname.replace(":", "")] = list(
                    haplotypes[hi_][lo:hi])
            segments.append((name, cols, rows_out))
        else:
            rows_out = {hname: list(haplotypes[hi_][lo:hi])
                        for hi_, hname in enumerate(hap_names)}
            segments.append((name, cols, rows_out))

    prg = prg_from_haplotypes(haplotypes, column_names)
    return SimulatedPRG(prg=prg, haplotypes=haplotypes,
                        haplotype_names=hap_names, column_names=column_names,
                        gene_segments=segments, gene_alleles=gene_alleles)
