"""Graph data-package reader/writer (the on-disk contract, SURVEY.md §1.1).

Layout relative to the package dir (same as the reference's downloaded
`graphs/PRG_MHC_GRCh38_withIMGT`):

  PRG/graph.txt            — the PRG (the graph.prg format)
  PRG/segments.txt         — ordered list of segment file names
  PRG/<segment files>      — space-separated allele matrices
                             (header `IndividualID <locusID>...`, then one row
                             per known allele; HLATyper.cpp:1198-1299)
  sequences.txt            — TSV SequenceID Name FASTAID Chr Start_1based
                             Stop_1based (processBAM.cpp:1209-1393)
  translation/<id>.txt     — one int (graph level) per line per base of
                             linearized sequence <id> (processBAM.cpp:4389)
  mapping_PRGonly/referenceGenome.fa — linearized PRG haplotypes (bwa remap
                             target in the reference, HLA-LA.cpp:617)
  extendedReferenceGenome/extendedReferenceGenome.fa (optional)
  knownReferences/*.txt    — known BAM reference specs (README.md:190-212)
  serializedGRAPH.npz      — compiled dense arrays (our replacement for the
                             Boost serializedGRAPH archives)
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.fasta import read_fasta, write_fasta
from .compile import CompiledPRG, compile_prg
from .prg import PRG


class LevelIndex:
    """Maps a graph level to its position on each underlying linearized
    sequence (dict-like: `index.get(level)` -> {prg_id: pos} or None).
    Small graphs are fully materialised; big graphs use per-query
    searchsorted with an LRU cache (anchor levels repeat heavily)."""

    def __init__(self, translations: dict[int, np.ndarray],
                 materialize_limit: int = 5_000_000):
        self.translations = translations
        total = sum(len(t) for t in translations.values())
        self._dense: dict[int, dict[int, int]] | None = None
        if total <= materialize_limit:
            dense: dict[int, dict[int, int]] = {}
            for sid, t in translations.items():
                for pos, lv in enumerate(t.tolist()):
                    dense.setdefault(int(lv), {})[sid] = pos
            self._dense = dense
        self._cache: dict[int, dict[int, int] | None] = {}

    def get(self, level: int, default=None):
        if self._dense is not None:
            return self._dense.get(level, default)
        level = int(level)
        if level in self._cache:
            out = self._cache[level]
            return out if out is not None else default
        out = None
        for sid, t in self.translations.items():
            i = int(np.searchsorted(t, level))
            if i < len(t) and t[i] == level:
                if out is None:
                    out = {}
                out[sid] = i
        if len(self._cache) > 200_000:
            self._cache.clear()
        self._cache[level] = out
        return out if out is not None else default

    def warm(self, levels) -> None:
        """Batch-resolve many levels at once: one searchsorted per
        translation for the whole query set (S x log instead of S x log per
        level).  No-op for materialised small graphs."""
        if self._dense is not None:
            return
        want = sorted({int(l) for l in levels
                       if int(l) >= 0 and int(l) not in self._cache})
        if not want:
            return
        arr = np.asarray(want, dtype=np.int64)
        found: dict[int, dict[int, int]] = {}
        for sid, t in self.translations.items():
            i = np.searchsorted(t, arr)
            ok = (i < len(t))
            hit = np.zeros(len(arr), dtype=bool)
            hit[ok] = t[i[ok]] == arr[ok]
            for j in np.nonzero(hit)[0]:
                found.setdefault(want[int(j)], {})[sid] = int(i[j])
        if len(self._cache) > 200_000:
            self._cache.clear()
        for l in want:
            self._cache[l] = found.get(l)

    def __contains__(self, level: int) -> bool:
        return self.get(level) is not None


@dataclass
class SequenceInfo:
    prg_id: int
    name: str
    fasta_id: str
    chrom: str           # "" for PRG-only haplotypes
    start_1based: int    # position in extended reference (0 if standalone)
    stop_1based: int


class GraphPackage:
    def __init__(self, graph_dir: str):
        self.dir = graph_dir
        self._prg: PRG | None = None
        self._compiled: CompiledPRG | None = None
        self._graph_loci: list[str] | None = None
        self._segment_spans: list[tuple[str, int, int]] | None = None
        self._sequences: list[SequenceInfo] | None = None
        self._translations: dict[int, np.ndarray] = {}
        self._prg_fasta: dict[str, str] | None = None
        self._level_to_seqpos: dict[int, dict[int, int]] | None = None

    # ------------------------------------------------------------------ PRG
    @property
    def graph_txt(self) -> str:
        return os.path.join(self.dir, "PRG", "graph.txt")

    @property
    def serialized_path(self) -> str:
        return os.path.join(self.dir, "serializedGRAPH.npz")

    def prg(self) -> PRG:
        if self._prg is None:
            self._prg = PRG.from_file(self.graph_txt)
        return self._prg

    def compiled(self) -> CompiledPRG:
        """Load the compiled cache iff newer than graph.txt, else recompile
        (mirrors the serializedGRAPH freshness rule, processBAM.cpp:37-53)."""
        if self._compiled is None:
            sp = self.serialized_path
            if (os.path.exists(sp)
                    and os.path.getmtime(sp) >= os.path.getmtime(self.graph_txt)):
                self._compiled = CompiledPRG.load(sp)
            else:
                self._compiled = compile_prg(self.prg())
                try:
                    # persist so later processes skip the graph.txt parse
                    # (the serializedGRAPH role, HLA-LA.cpp:1355-1384)
                    self._compiled.save(sp)
                except OSError:
                    pass
        return self._compiled

    def prepare(self) -> CompiledPRG:
        """The `--action prepareGraph` equivalent: compile and cache."""
        c = compile_prg(self.prg())
        c.save(self.serialized_path)
        self._compiled = c
        return c

    # ------------------------------------------------------------- loci map
    def graph_loci(self) -> list[str]:
        """Ordered graph column (locus) names across all segments
        (Graph::readGraphLoci, Graph.cpp:2563-2613)."""
        if self._graph_loci is None:
            loci: list[str] = []
            spans: list[tuple[str, int, int]] = []
            seg_file = os.path.join(self.dir, "PRG", "segments.txt")
            with open(seg_file) as fh:
                segments = [l.strip() for l in fh if l.strip()]
            for seg in segments:
                with open(os.path.join(self.dir, "PRG", seg)) as fh:
                    header = fh.readline().rstrip("\n").split(" ")
                assert header[0] == "IndividualID", seg
                spans.append((seg, len(loci), len(header) - 1))
                loci.extend(header[1:])
            self._graph_loci = loci
            self._segment_spans = spans
        return self._graph_loci

    def locus_to_level(self) -> dict[str, int]:
        return {name: i for i, name in enumerate(self.graph_loci())}

    def segment_levels(self, segfiles) -> dict[str, int]:
        """{column name: graph level} restricted to the given segment
        files.  The full map over every column (`locus_to_level`) costs
        seconds and hundreds of MB per process at real-PRG scale (3M
        levels) — it dominated each typing worker's wall time; the typer
        only needs the gene segments' columns."""
        self.graph_loci()
        want = set(segfiles)
        loci = self._graph_loci
        out: dict[str, int] = {}
        for seg, start, n in self._segment_spans:
            if seg in want:
                for i in range(start, start + n):
                    out[loci[i]] = i
        return out

    def segment_files(self) -> list[str]:
        with open(os.path.join(self.dir, "PRG", "segments.txt")) as fh:
            return [l.strip() for l in fh if l.strip()]

    def read_segment(self, filename: str) -> tuple[list[str], dict[str, list[str]]]:
        """Returns (column locus names, {alleleID: per-column strings})."""
        path = os.path.join(self.dir, "PRG", filename)
        with open(path) as fh:
            header = fh.readline().rstrip("\n").split(" ")
            assert header[0] == "IndividualID"
            cols = header[1:]
            rows: dict[str, list[str]] = {}
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                f = line.split(" ")
                assert len(f) == len(header), (filename, len(f), len(header))
                rows[f[0]] = f[1:]
        return cols, rows

    # ----------------------------------------------------------- sequences
    def sequences(self) -> list[SequenceInfo]:
        if self._sequences is None:
            out = []
            with open(os.path.join(self.dir, "sequences.txt")) as fh:
                header = fh.readline().rstrip("\n").split("\t")
                idx = {h: i for i, h in enumerate(header)}
                for line in fh:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    f = line.split("\t")
                    out.append(SequenceInfo(
                        prg_id=int(f[idx["SequenceID"]]),
                        name=f[idx["Name"]],
                        fasta_id=f[idx["FASTAID"]],
                        chrom=f[idx["Chr"]] if "Chr" in idx else "",
                        start_1based=int(f[idx["Start_1based"]] or 0) if "Start_1based" in idx else 0,
                        stop_1based=int(f[idx["Stop_1based"]] or 0) if "Stop_1based" in idx else 0,
                    ))
            self._sequences = out
        return self._sequences

    def translation(self, prg_id: int) -> np.ndarray:
        """Graph level per base of linearized sequence prg_id
        (processBAM::_loadMapping)."""
        if prg_id not in self._translations:
            path = os.path.join(self.dir, "translation", f"{prg_id}.txt")
            self._translations[prg_id] = np.loadtxt(path, dtype=np.int64, ndmin=1)
        return self._translations[prg_id]

    def level_to_seqpos(self) -> "LevelIndex":
        """graph level -> {prg_id: position} lookups, used for insert-size
        distances in underlying-sequence coordinates
        (graphLevel_2_underlyingSequencePositions, processBAM.cpp:3434).
        Backed by per-sequence searchsorted over the (strictly increasing)
        translation arrays — O(#sequences · log L) per query and no
        per-level python dict (the real MHC graph has ~3.3M levels)."""
        if self._level_to_seqpos is None:
            self._level_to_seqpos = LevelIndex(
                {s.prg_id: self.translation(s.prg_id)
                 for s in self.sequences()})
        return self._level_to_seqpos

    def prg_fasta(self) -> dict[str, str]:
        """The PRG-only linearized reference (seeding target)."""
        if self._prg_fasta is None:
            self._prg_fasta = read_fasta(
                os.path.join(self.dir, "mapping_PRGonly", "referenceGenome.fa"))
        return self._prg_fasta

    def extended_reference_path(self) -> str | None:
        """Whole genome + PRG contigs (mapAgainstCompleteGenome target,
        processBAM.cpp:69-86): extendedReferenceGenome/*.fa in the package,
        or the pointer file extendedReferenceGenomePath.txt."""
        p = os.path.join(self.dir, "extendedReferenceGenome",
                         "extendedReferenceGenome.fa")
        if os.path.exists(p):
            return p
        ptr = os.path.join(self.dir, "extendedReferenceGenomePath.txt")
        if os.path.exists(ptr):
            with open(ptr) as fh:
                path = fh.read().strip()
            if path and os.path.exists(path):
                return path
        return None

    # ------------------------------------------------------ knownReferences
    def known_references(self, more_dirs: list[str] = ()) -> dict[str, dict]:
        """Parse knownReferences/*.txt (+ extra dirs): each file is a TSV with
        header contigID contigLength ExtractCompleteContig
        PartialExtraction_Start PartialExtraction_Stop (README.md:190-212)."""
        out = {}
        dirs = [os.path.join(self.dir, "knownReferences"), *more_dirs]
        for d in dirs:
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if not fn.endswith(".txt"):
                    continue
                path = os.path.join(d, fn)
                contigs = {}
                with open(path) as fh:
                    header = fh.readline().rstrip("\n").split("\t")
                    for line in fh:
                        line = line.rstrip("\n")
                        if not line:
                            continue
                        f = dict(zip(header, line.split("\t")))
                        contigs[f["contigID"]] = f
                out[path] = contigs
        return out

    def match_known_reference(self, bam_contigs: dict[str, int],
                              more_dirs: list[str] = ()) -> str | None:
        """Find the unique knownReferences spec whose (contigID, length) set
        exactly matches the BAM header (HLA-LA.pl:259-373).  Returns the spec
        path or None."""
        matches = []
        for path, contigs in self.known_references(more_dirs).items():
            spec = {}
            for cid, rec in contigs.items():
                try:
                    spec[cid] = int(rec["contigLength"])
                except (ValueError, KeyError):
                    # malformed row (e.g. a line of bare tabs in the shipped
                    # Additional_B38_3.txt): HLA-LA.pl counts it as a
                    # contig that can never match, making the spec
                    # unmatchable (HLA-LA.pl:315-359) — mirror that
                    spec = None
                    break
            if spec is not None and spec == bam_contigs:
                matches.append(path)
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            raise RuntimeError(f"ambiguous knownReferences match: {matches}")
        return None


# --------------------------------------------------------------------- write
def write_package(graph_dir: str, prg: PRG,
                  segments: list[tuple[str, list[str], dict[str, list[str]]]],
                  haplotype_seqs: dict[str, tuple[str, np.ndarray]],
                  known_references: dict[str, dict[str, int]] | None = None,
                  compile_now: bool = True) -> GraphPackage:
    """Write a complete graph package (the simulator's storeLikeRealPRG
    equivalent, simpleGraphSimulator.h:21-54).

    segments: ordered (filename, column_names, {allele: per-col strings}).
    haplotype_seqs: {fasta_id: (sequence_without_gaps, level_per_base)}.
    """
    os.makedirs(os.path.join(graph_dir, "PRG"), exist_ok=True)
    os.makedirs(os.path.join(graph_dir, "translation"), exist_ok=True)
    os.makedirs(os.path.join(graph_dir, "mapping_PRGonly"), exist_ok=True)
    os.makedirs(os.path.join(graph_dir, "knownReferences"), exist_ok=True)

    prg.to_file(os.path.join(graph_dir, "PRG", "graph.txt"))

    with open(os.path.join(graph_dir, "PRG", "segments.txt"), "w") as fh:
        for name, _, _ in segments:
            fh.write(name + "\n")
    for name, cols, rows in segments:
        with open(os.path.join(graph_dir, "PRG", name), "w") as fh:
            fh.write("IndividualID " + " ".join(cols) + "\n")
            for allele, vals in rows.items():
                assert len(vals) == len(cols)
                fh.write(allele + " " + " ".join(vals) + "\n")

    fasta = {}
    with open(os.path.join(graph_dir, "sequences.txt"), "w") as fh:
        fh.write("SequenceID\tName\tFASTAID\tChr\tStart_1based\tStop_1based\n")
        for i, (fasta_id, (seq, levels)) in enumerate(haplotype_seqs.items()):
            assert len(seq) == len(levels)
            fh.write(f"{i}\t{fasta_id}\t{fasta_id}\t\t\t\n")
            # one int per line, identical bytes to np.savetxt(fmt="%d") but
            # faster (savetxt formats row-by-row through asarray/join; it
            # was the second-largest write_package cost at 3M levels)
            lv_arr = np.asarray(levels, dtype=np.int64)
            with open(os.path.join(graph_dir, "translation",
                                   f"{i}.txt"), "w") as tfh:
                if len(lv_arr):
                    tfh.write("\n".join(map(str, lv_arr.tolist())))
                    tfh.write("\n")
            fasta[fasta_id] = seq
    write_fasta(os.path.join(graph_dir, "mapping_PRGonly", "referenceGenome.fa"),
                fasta)

    if known_references:
        with open(os.path.join(graph_dir, "knownReferences",
                               "simulated.txt"), "w") as fh:
            fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                     "PartialExtraction_Start\tPartialExtraction_Stop\n")
            for cid, length in known_references.items():
                fh.write(f"{cid}\t{length}\t1\t\t\n")

    pkg = GraphPackage(graph_dir)
    if compile_now:
        pkg.prepare()
    return pkg
