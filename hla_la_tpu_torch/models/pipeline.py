"""End-to-end HLA typing workflow on the port's device (reference L5:
alignReads_and_inferHLA, processBAM.cpp:1788-1923 + the HLA action,
HLA-LA.cpp:577-811): the counterpart of ``hla_la_tpu/models/pipeline.py``.

Input: paired FASTQ (short reads) or unpaired FASTQ (long-read mode) already
extracted from a BAM/CRAM (see cli.py for extraction), plus a graph package.
Output: the reference-compatible result-file set in the working directory.

The device path is the serial path: one aligner and one typer in this
process.  The reference's worker-process engines (alignment workers, per-
locus typing workers, align shards) are host-only and not part of the port
yet, so ``cfg.max_threads`` starts no workers here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..graph.package import GraphPackage
from ..io.fastq import FastqRead, read_fastq
from ..utils.config import RunConfig
from ..utils.timing import Timer, log_progress
from .aligner import AlignedPair, ReadAligner
from .typer import HLATyper, LocusResult


@dataclass
class PipelineResult:
    results: list[LocusResult]
    n_pairs_input: int
    n_pairs_aligned: int
    reads_per_sec: float
    insert_mean: float
    insert_sd: float


def pair_up_fastq(fq1: str, fq2: str) -> list[tuple[FastqRead, FastqRead]]:
    r1 = list(read_fastq(fq1))
    r2 = {r.name: r for r in read_fastq(fq2)}
    out = []
    for a in r1:
        b = r2.get(a.name)
        if b is not None:
            out.append((a, b))
    return out


def build_decoy(pkg: GraphPackage, cfg: RunConfig):
    """Decoy k-mer index for the paralog defense (mapAgainstCompleteGenome
    equivalent).  Source: cfg.decoy_fasta if given, else the package's
    extendedReferenceGenome (minus PRG_* contigs) when
    cfg.map_against_complete_genome is set.  Returns DecoyIndex or None."""
    from ..mapping.decoy import DecoyIndex
    path = None
    if cfg.decoy_fasta:
        path = cfg.decoy_fasta
    elif cfg.map_against_complete_genome:
        path = pkg.extended_reference_path()
        if path is None:
            log_progress("WARNING: mapAgainstCompleteGenome requested but "
                         "the package has no extendedReferenceGenome — "
                         "paralog defense disabled")
            return None
    if path is None:
        return None
    from ..io.fasta import read_fasta
    cache = os.path.join(pkg.dir, "mapping_PRGonly", "decoyIndex_k20.npz")
    return DecoyIndex.from_fasta(read_fasta(path), cache_path=cache,
                                 source_path=path)


def _align_all(engine, pairs, unpaired, insert_mean, insert_sd, batch_size,
               truth=None):
    """Batched alignment of all pairs + unpaired reads; returns the aligned
    subset and the kept raw reads."""
    aligned_pairs: list[AlignedPair] = []
    kept_pairs: list[tuple[FastqRead, FastqRead]] = []
    aligned_unpaired = []
    kept_unpaired: list[FastqRead] = []
    bs = batch_size
    for lo in range(0, len(pairs), bs):
        batch = pairs[lo:lo + bs]
        out = engine.align_pairs(batch, insert_mean, insert_sd, truth=truth)
        by_id = {p.read_id: p for p in out}
        for pr in batch:
            ap = by_id.get(pr[0].name)
            if ap is not None:
                aligned_pairs.append(ap)
                kept_pairs.append(pr)
    for lo in range(0, len(unpaired), bs):
        batch = unpaired[lo:lo + bs]
        out = engine.align_unpaired(batch, truth=truth)
        for r, al in zip(batch, out):
            if al is not None:
                aligned_unpaired.append(al)
                kept_unpaired.append(r)
    return aligned_pairs, kept_pairs, aligned_unpaired, kept_unpaired


def run_hla_typing(pkg: GraphPackage,
                   pairs: list[tuple[FastqRead, FastqRead]] | None = None,
                   unpaired: list[FastqRead] | None = None,
                   output_dir: str = ".",
                   cfg: RunConfig | None = None,
                   device: str | torch.device = "cuda",
                   truth=None) -> PipelineResult:
    dev = resolve(device)
    cfg = cfg or RunConfig()
    if cfg.max_threads > 1:
        log_progress(f"device {dev}: maxThreads {cfg.max_threads} starts no "
                     "worker processes (the device path is serial)")
    pairs = pairs or []
    unpaired = unpaired or []
    os.makedirs(output_dir, exist_ok=True)

    decoy = build_decoy(pkg, cfg)
    if decoy is not None:
        log_progress("paralog defense active (decoy k-mer index, "
                     f"{len(decoy.index.seq_names)} decoy contigs)")
    aligner = ReadAligner(pkg, cfg, decoy=decoy, device=dev)

    insert_mean, insert_sd = 300.0, 100.0
    if pairs:
        log_progress("estimating insert size distribution")
        insert_mean, insert_sd = aligner.estimate_insert_size(pairs)
        log_progress(f"insert size estimate: mean {insert_mean}, sd {insert_sd}")

    with Timer("align") as t_align:
        aligned_pairs, kept_pairs, aligned_unpaired, kept_unpaired = \
            _align_all(aligner, pairs, unpaired, insert_mean, insert_sd,
                       cfg.batch_size, truth)
    n_reads = 2 * len(pairs) + len(unpaired)
    rps = t_align.rate(n_reads)
    log_progress(f"aligned {len(aligned_pairs)}/{len(pairs)} pairs + "
                 f"{len(aligned_unpaired)}/{len(unpaired)} unpaired "
                 f"in {t_align.elapsed:.3f} s on {dev} ({rps:.1f} reads/s)")

    # end-of-alignment statistics (reference prints aligner::statistics,
    # processBAM.cpp:1860)
    aligner.stats.n_align_calls += len(aligned_pairs)
    log_progress(aligner.stats.report())

    # typing outputs go into <outputDirectory>/hla/ like the reference
    # (outputDirectory_for_HLA, processBAM.cpp:1805); the coverage track
    # stays at the top level
    with Timer("type") as t_type:
        _write_reads_per_level(aligned_pairs, aligned_unpaired, pkg,
                               output_dir)
        typer = HLATyper(pkg, cfg.typer, device=dev)
        results = typer.type_all(kept_pairs, aligned_pairs, kept_unpaired,
                                 aligned_unpaired, insert_mean, insert_sd,
                                 os.path.join(output_dir, "hla"),
                                 long_reads_mode=cfg.long_reads)
    log_progress(f"typed {len(results)} loci in {t_type.elapsed:.3f} s "
                 f"on {dev}")
    return PipelineResult(results, len(pairs), len(aligned_pairs), rps,
                          insert_mean, insert_sd)


def _write_reads_per_level(aligned_pairs, aligned_unpaired, pkg, output_dir):
    """Coverage track `reads_per_level.txt` (processBAM.cpp:1902-1913)."""
    n_levels = pkg.compiled().n_levels
    counts = np.zeros(n_levels, dtype=np.int64)
    chains = [c for ap in aligned_pairs for c in (ap.chain1, ap.chain2)]
    chains += [c for c in aligned_unpaired if c is not None]
    for ch in chains:
        lv = ch.levels[ch.levels >= 0]
        if len(lv):
            counts[lv.astype(np.int64)] += 1
    with open(os.path.join(output_dir, "reads_per_level.txt"), "w") as fh:
        for lv, n in enumerate(counts.tolist()):
            fh.write(f"{lv}\t{n}\n")
