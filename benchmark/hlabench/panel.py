"""The deployment's installed graph, drawn from a configuration's panel_seed.

A numpy rewrite, frozen here, of the port's panel simulator
(``hla_la_tpu_torch/sim/graph_sim.py``, itself after the reference's
``simpleGraphSimulator``): a random backbone, 8 haplotypes mutated from it
by SNPs, deletion runs and insertion columns, and gene loci whose exons 2
and 3 carry an allele database.  The first alleles of each locus are the
exons of the panel's rows (backbone first, then the haplotypes), so reads of
two haplotypes have a known pair of alleles at every locus; the rest are
copies of random rows with extra SNPs.

``Panel`` is plain numpy and is all the harness's reference needs.
``ensure_installed`` writes it once into a fixed directory of the checkout,
keyed on the configuration file's bytes, as a user installs
PRG_MHC_GRCh38_withIMGT once: the raw panel (``panel.npz``,
``panel.json``) and the graph package that the port's own installer
(``graph/package.py::write_package`` with ``prepare``) makes of it.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import shutil
from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
GAP = ord("_")
EXONS = ("exon_2", "exon_3")


@dataclass
class Panel:
    rows: np.ndarray                    # [H, n_cols] uint8 ('_' for gaps);
    #                                     row 0 is the backbone
    column_names: list[str]
    segments: list[tuple[str, int, int]]        # (file name, lo, hi)
    exon_cols: dict[str, list[tuple[str, int, int]]]    # locus -> exons
    allele_names: dict[str, list[str]]          # locus -> names
    allele_seqs: dict[str, np.ndarray]          # locus -> [A, exon cols]

    @property
    def n_rows(self) -> int:
        return self.rows.shape[0]

    def linearized(self, h: int) -> tuple[np.ndarray, np.ndarray]:
        """Row h without gaps (uint8 bases) and the column of each base."""
        levels = np.nonzero(self.rows[h] != GAP)[0]
        return self.rows[h][levels], levels.astype(np.int64)

    def gene_window(self, locus: str, flank: int) -> tuple[int, int]:
        """Columns of `locus`'s gene (introns and exons) +- `flank`."""
        lo = min(a for _, a, _ in self._gene_parts(locus))
        hi = max(b for _, _, b in self._gene_parts(locus)) - 1
        return lo - flank, hi + flank

    def _gene_parts(self, locus: str):
        key = f"_gene_{locus}_"
        return [s for s in self.segments if key in s[0]]

    def truth(self, haps: tuple[int, int]) -> dict[str, list[str]]:
        """Locus -> the alleles planted by reads of rows `haps`."""
        return {locus: [names[h] for h in haps]
                for locus, names in self.allele_names.items()}


def mutate_panel(rng: np.random.Generator, backbone: np.ndarray, n_hap: int,
                 snp_rate: float, del_rate: float, ins_rate: float,
                 mean_indel_len: float) -> np.ndarray:
    """[n_hap + 1, n_cols] aligned panel, row 0 the backbone.  Before each
    backbone column an insertion run may open (backbone gap, random bases
    in a random half of the haplotypes); at each backbone column a
    haplotype may open a deletion run, or else carry a SNP.  Deletion runs
    that overlap merge."""
    L = len(backbone)
    at = np.nonzero(rng.random(L) < ins_rate)[0]
    lens = np.maximum(1, rng.geometric(1.0 / mean_indel_len, len(at)))
    carriers = rng.random((len(at), n_hap)) < 0.5
    keep = carriers.any(axis=1)
    at, lens, carriers = at[keep], lens[keep], carriers[keep]
    n_cols = L + int(lens.sum())
    # column of backbone position p: p plus the insertion columns before
    # it; a run opened at p sits right before p's column
    ins_before = np.zeros(L, dtype=np.int64)
    np.add.at(ins_before, at, lens)
    bb_col = np.arange(L) + np.cumsum(ins_before)
    rows = np.full((n_hap + 1, n_cols), GAP, dtype=np.uint8)
    rows[0, bb_col] = backbone
    if len(at):
        run_of = np.repeat(np.arange(len(at)), lens)
        first = bb_col[at] - lens
        ins_cols = np.repeat(first, lens) + (
            np.arange(len(run_of)) - np.repeat(np.cumsum(lens) - lens, lens))
        bases = BASES[rng.integers(0, 4, (len(run_of), n_hap))]
        rows[1:, ins_cols] = np.where(carriers[run_of], bases, GAP).T
    code = np.searchsorted(BASES, backbone)
    for h in range(n_hap):
        starts = np.nonzero(rng.random(L) < del_rate)[0]
        runs = np.maximum(1, rng.geometric(1.0 / mean_indel_len, len(starts)))
        edge = np.zeros(L + 1, dtype=np.int64)
        np.add.at(edge, starts, 1)
        np.add.at(edge, np.minimum(starts + runs, L), -1)
        deleted = np.cumsum(edge)[:L] > 0
        snp = (rng.random(L) < snp_rate) & ~deleted
        hap = backbone.copy()
        hap[snp] = BASES[(code[snp] + rng.integers(1, 4, int(snp.sum()))) % 4]
        hap[deleted] = GAP
        rows[h + 1, bb_col] = hap
    return rows


def _segments(n_cols: int, genes: dict[str, list[float]]):
    """Segment files over the columns: each gene's window split into
    intron_1 | exon_2 | intron_2 | exon_3, other columns as non-gene
    segments in between (graph_sim.py's layout)."""
    bounds, exon_cols = [], {}
    cursor = idx = 0
    for locus, (f0, f1) in sorted(genes.items(), key=lambda kv: kv[1][0]):
        lo, hi = int(f0 * n_cols), int(f1 * n_cols)
        if lo < cursor:
            raise ValueError("genes overlap")
        if lo > cursor:
            bounds.append((f"{idx}_nongene_{idx}.txt", cursor, lo))
            idx += 1
        q = np.linspace(lo, hi, 5).astype(int)
        exon_cols[locus] = []
        for part, a, b in zip(("intron_1", "exon_2", "intron_2", "exon_3"),
                              q[:-1], q[1:]):
            name = f"{idx}_gene_{locus}_{idx}_{part}.txt"
            bounds.append((name, int(a), int(b)))
            if part in EXONS:
                exon_cols[locus].append((name, int(a), int(b)))
            idx += 1
        cursor = hi
    if cursor < n_cols:
        bounds.append((f"{idx}_nongene_{idx}.txt", cursor, n_cols))
    return bounds, exon_cols


def simulate_panel(cfg: dict) -> Panel:
    """The configuration's panel, drawn from its panel_seed alone."""
    rng = np.random.default_rng(int(cfg["panel_seed"]))
    backbone = BASES[rng.integers(0, 4, int(cfg["n_levels"]))]
    rows = mutate_panel(rng, backbone, int(cfg["n_haplotypes"]),
                        cfg["snp_rate"], cfg["del_rate"], cfg["ins_rate"],
                        cfg["mean_indel_len"])
    n_cols = rows.shape[1]
    segments, exon_cols = _segments(n_cols, cfg["genes"])
    names: list[str] = []
    for name, lo, hi in segments:
        base = name[:-4]
        names += [f"{base}_{k}" for k in range(hi - lo)]
    n_alleles = int(cfg["alleles_per_locus"])
    allele_names, allele_seqs = {}, {}
    for locus, exons in exon_cols.items():
        own = np.concatenate([rows[:, a:b] for _, a, b in exons], axis=1)
        n_extra = max(0, n_alleles - len(own))
        src = rng.integers(0, len(own), n_extra)
        extra = own[src].copy()
        mut = (rng.random(extra.shape) < cfg["allele_snp_rate"]) \
            & (extra != GAP)
        code = np.searchsorted(BASES, np.where(mut, extra, BASES[0]))
        extra[mut] = BASES[(code[mut]
                            + rng.integers(1, 4, int(mut.sum()))) % 4]
        allele_seqs[locus] = np.concatenate([own, extra])[:n_alleles]
        allele_names[locus] = [f"{locus}*{a + 1:02d}:01"
                               for a in range(n_alleles)]
    return Panel(rows, names, segments, exon_cols, allele_names, allele_seqs)


# ------------------------------------------------------------ installation
def cache_root(checkout: str) -> str:
    """The fixed directory inside the checkout that holds installed
    panels."""
    return os.path.join(checkout, "build", "benchmark", "panels")


def config_key(cfg_path: str) -> str:
    with open(cfg_path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()[:16]


def _row_str(row: np.ndarray) -> str:
    return row.tobytes().decode()


def _write_package(panel: Panel, graph_dir: str) -> None:
    """The panel as a graph package, made by the port's own installer."""
    from hla_la_tpu_torch.graph.package import write_package
    from hla_la_tpu_torch.graph.prg import prg_from_haplotypes
    haps = [_row_str(r) for r in panel.rows]
    hap_names = [f"PRG_hap_{i}" for i in range(panel.n_rows)]
    seg_rows = []
    for name, lo, hi in panel.segments:
        cols = panel.column_names[lo:hi]
        rows: dict[str, list[str]] = {}
        parts = name[:-4].split("_")
        if parts[1] == "gene" and "exon" in name:
            locus = parts[2]
            off = 0
            for fn, a, b in panel.exon_cols[locus]:
                if fn == name:
                    break
                off += b - a
            for allele, seq in zip(panel.allele_names[locus],
                                   panel.allele_seqs[locus]):
                rows[allele] = list(_row_str(seq[off:off + hi - lo]))
        for hname, h in zip(hap_names, haps):
            rows[hname] = list(h[lo:hi])
        seg_rows.append((name, cols, rows))
    hap_seqs = {}
    for i, hname in enumerate(hap_names):
        seq, levels = panel.linearized(i)
        hap_seqs[hname] = (seq.tobytes().decode(), levels)
    prg = prg_from_haplotypes(haps, panel.column_names)
    write_package(graph_dir, prg, seg_rows, hap_seqs, compile_now=True)


def save_panel(panel: Panel, path_dir: str) -> None:
    np.savez(os.path.join(path_dir, "panel.npz"), rows=panel.rows,
             **{f"alleles_{k}": v for k, v in panel.allele_seqs.items()})
    with open(os.path.join(path_dir, "panel.json"), "w") as fh:
        json.dump({"segments": panel.segments, "exon_cols": panel.exon_cols,
                   "allele_names": panel.allele_names}, fh)


def load_panel(path_dir: str) -> Panel:
    """The raw panel of an installed configuration, without its column
    names (reads and truth need none)."""
    with open(os.path.join(path_dir, "panel.json")) as fh:
        meta = json.load(fh)
    with np.load(os.path.join(path_dir, "panel.npz")) as z:
        rows = z["rows"]
        seqs = {k[len("alleles_"):]: z[k] for k in z.files
                if k.startswith("alleles_")}
    return Panel(rows, [], [tuple(s) for s in meta["segments"]],
                 {k: [tuple(e) for e in v]
                  for k, v in meta["exon_cols"].items()},
                 meta["allele_names"], seqs)


@contextlib.contextmanager
def _locked(path: str):
    with open(path, "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        yield


def ensure_installed(cfg_path: str, cfg: dict, root: str) -> str:
    """The directory of the installed configuration (``pkg/`` the graph
    package, ``panel.*`` the raw panel), built on first use under a lock
    and published by a rename, so a cut build is never taken for one."""
    name = os.path.splitext(os.path.basename(cfg_path))[0]
    final = os.path.join(root, f"{name}-{config_key(cfg_path)}")
    if os.path.exists(os.path.join(final, "done")):
        return final
    os.makedirs(root, exist_ok=True)
    with _locked(final + ".lock"):
        if os.path.exists(os.path.join(final, "done")):
            return final
        part = final + ".part"
        shutil.rmtree(part, ignore_errors=True)
        shutil.rmtree(final, ignore_errors=True)
        os.makedirs(part)
        panel = simulate_panel(cfg)
        save_panel(panel, part)
        _write_package(panel, os.path.join(part, "pkg"))
        open(os.path.join(part, "done"), "w").close()
        os.replace(part, final)
    return final
