"""End-to-end HLA typing workflow on the port's device (reference L5:
alignReads_and_inferHLA, processBAM.cpp:1788-1923 + the HLA action,
HLA-LA.cpp:577-811): the counterpart of ``hla_la_tpu/models/pipeline.py``.

Input: paired FASTQ (short reads) or unpaired FASTQ (long-read mode) already
extracted from a BAM/CRAM (see cli.py for extraction), plus a graph package.
Output: the reference-compatible result-file set in the working directory.

Three ways through it, all ending in the one ``_type_and_write``:
``run_hla_typing`` in one process, or with ``cfg.max_threads`` worker
processes that each hold a context on the device (models/parallel_host.py);
``align_shard`` + ``merge_shards_and_type`` for one sample's alignment split
over hosts; and ``sharded=`` a rank's mesh, where the same entry point runs
on every rank of a ``torch.distributed`` group (parallel/mesh.py): host
stages are repeated on every rank, NW batches are split over all ranks and
the pair reduction over the mesh's two axes, and rank 0 alone writes the
result files.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
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


@contextlib.contextmanager
def _rank_output_dir(output_dir: str, sharded):
    """`output_dir` itself without a mesh and on its rank 0; on any other
    rank a temporary directory, removed afterwards: rank 0 alone writes the
    result files."""
    if sharded is None or sharded.rank == 0:
        yield output_dir
    else:
        with tempfile.TemporaryDirectory(prefix="hla_rank_") as scratch_dir:
            yield scratch_dir


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
    subset, the kept raw reads, and each kept read's index in the input
    (used by align shards to restore the global order on merge)."""
    aligned_pairs: list[AlignedPair] = []
    packed_batches = []   # PackedAlignedPairs per batch (parallel engine)
    kept_pairs: list[tuple[FastqRead, FastqRead]] = []
    kept_pair_idx: list[int] = []
    aligned_unpaired = []
    kept_unpaired: list[FastqRead] = []
    kept_unpaired_idx: list[int] = []
    bs = batch_size
    for lo in range(0, len(pairs), bs):
        batch = pairs[lo:lo + bs]
        out = engine.align_pairs(batch, insert_mean, insert_sd, truth=truth)
        if hasattr(out, "pack"):
            # packed SoA result: restore input order via the id arrays,
            # no object materialisation
            by_id = {nm: j for j, nm in enumerate(out.read_ids)}
            sel = []
            for k, pr in enumerate(batch):
                j = by_id.get(pr[0].name)
                if j is not None:
                    sel.append(j)
                    kept_pairs.append(pr)
                    kept_pair_idx.append(lo + k)
            if len(sel) == len(out) and sel == list(range(len(out))):
                # common case: every pair aligned, already in input order
                # — skip the identity-permutation copy (from_chunks will
                # copy once at the end anyway)
                packed_batches.append(out)
            else:
                packed_batches.append(
                    out.subset(np.asarray(sel, np.int64)))
            continue
        by_id = {p.read_id: p for p in out}
        for k, pr in enumerate(batch):
            ap = by_id.get(pr[0].name)
            if ap is not None:
                aligned_pairs.append(ap)
                kept_pairs.append(pr)
                kept_pair_idx.append(lo + k)
    if packed_batches:
        from .parallel_host import PackedAlignedPairs
        assert not aligned_pairs   # one engine → one representation
        aligned_pairs = PackedAlignedPairs.from_chunks(
            [p.pack for p in packed_batches])
    for lo in range(0, len(unpaired), bs):
        batch = unpaired[lo:lo + bs]
        out = engine.align_unpaired(batch, truth=truth)
        for k, (r, al) in enumerate(zip(batch, out)):
            if al is not None:
                aligned_unpaired.append(al)
                kept_unpaired.append(r)
                kept_unpaired_idx.append(lo + k)
    return (aligned_pairs, kept_pairs, aligned_unpaired, kept_unpaired,
            kept_pair_idx, kept_unpaired_idx)


def run_hla_typing(pkg: GraphPackage,
                   pairs: list[tuple[FastqRead, FastqRead]] | None = None,
                   unpaired: list[FastqRead] | None = None,
                   output_dir: str = ".",
                   cfg: RunConfig | None = None,
                   device: str | torch.device = "cuda",
                   truth=None, sharded=None) -> PipelineResult:
    """`sharded`: a parallel.mesh.Mesh.  Every rank of it calls this with
    the same input; NW batches and the pair reduction are split over the
    ranks, and only rank 0 writes into `output_dir` (the other ranks type
    into a temporary directory that is removed)."""
    dev = resolve(device if sharded is None else sharded.device)
    cfg = cfg or RunConfig()
    pairs = pairs or []
    unpaired = unpaired or []
    with _rank_output_dir(output_dir, sharded) as out_dir:
        return _run_hla_typing(pkg, pairs, unpaired, out_dir, cfg, dev,
                               truth, sharded)


def _run_hla_typing(pkg, pairs, unpaired, output_dir, cfg, dev, truth,
                    sharded) -> PipelineResult:
    os.makedirs(output_dir, exist_ok=True)

    decoy = build_decoy(pkg, cfg)
    if decoy is not None:
        log_progress("paralog defense active (decoy k-mer index, "
                     f"{len(decoy.index.seq_names)} decoy contigs)")
    aligner = ReadAligner(pkg, cfg, decoy=decoy, device=dev, sharded=sharded)

    insert_mean, insert_sd = 300.0, 100.0
    if pairs:
        log_progress("estimating insert size distribution")
        insert_mean, insert_sd = aligner.estimate_insert_size(pairs)
        log_progress(f"insert size estimate: mean {insert_mean}, sd {insert_sd}")

    par = None
    if sharded is not None and cfg.max_threads > 1:
        log_progress("sharded run: the ranks are the processes; maxThreads "
                     f"{cfg.max_threads} starts no workers")
    elif cfg.max_threads > 1 and (len(pairs) + len(unpaired)) > 512:
        from .parallel_host import ParallelAligner, spawn_safe
        if spawn_safe():
            log_progress(f"aligning with {cfg.max_threads} worker processes "
                         f"on {dev}")
            par = ParallelAligner(
                pkg.dir, cfg.max_threads, long_reads=cfg.long_reads,
                decoy_fasta=cfg.decoy_fasta,
                map_complete=cfg.map_against_complete_genome, device=dev)
        else:
            log_progress("worker processes unavailable (no file-backed "
                         "__main__); aligning serially")

    with Timer("align") as t:
        engine = par if par is not None else aligner
        (aligned_pairs, kept_pairs, aligned_unpaired, kept_unpaired,
         _kp_idx, _ku_idx) = _align_all(engine, pairs, unpaired,
                                        insert_mean, insert_sd,
                                        cfg.batch_size, truth)
    n_reads = 2 * len(pairs) + len(unpaired)
    rps = t.rate(n_reads)
    log_progress(f"aligned {len(aligned_pairs)}/{len(pairs)} pairs + "
                 f"{len(aligned_unpaired)}/{len(unpaired)} unpaired "
                 f"in {t.elapsed:.3f} s on {dev} ({rps:.1f} reads/s)")

    # end-of-alignment statistics (reference prints aligner::statistics,
    # processBAM.cpp:1860); the workers' counters are summed into them
    if par is not None:
        from .parallel_host import add_counters, stats_counters
        add_counters(aligner.stats, stats_counters(par.stats))
    aligner.stats.n_align_calls += len(aligned_pairs)
    log_progress(aligner.stats.report())

    try:
        # the warm alignment workers (package in memory, a context on the
        # device) also serve per-locus typing — no reload cost
        with Timer("type") as t_type:
            results = _type_and_write(pkg, cfg, dev, aligned_pairs,
                                      kept_pairs, aligned_unpaired,
                                      kept_unpaired, insert_mean, insert_sd,
                                      output_dir, worker_pool=par,
                                      sharded=sharded)
        log_progress(f"typed {len(results)} loci in {t_type.elapsed:.3f} s "
                     f"on {dev}")
    finally:
        if par is not None:
            par.close()
    return PipelineResult(results, len(pairs), len(aligned_pairs), rps,
                          insert_mean, insert_sd)


def _type_and_write(pkg, cfg, device, aligned_pairs, kept_pairs,
                    aligned_unpaired, kept_unpaired, insert_mean, insert_sd,
                    output_dir, worker_pool=None, sharded=None):
    """The post-alignment tail shared by run_hla_typing and
    merge_shards_and_type — one definition so the multi-host merge path
    cannot silently drift from the single-host one (its byte-identity
    guarantee depends on this).  Typing outputs go into
    <outputDirectory>/hla/ like the reference (outputDirectory_for_HLA,
    processBAM.cpp:1805); the coverage track stays at the top level."""
    _write_reads_per_level(aligned_pairs, aligned_unpaired, pkg, output_dir)
    hla_dir = os.path.join(output_dir, "hla")
    typer = HLATyper(pkg, cfg.typer, device=device, sharded=sharded)
    results = typer.type_all(kept_pairs, aligned_pairs, kept_unpaired,
                             aligned_unpaired, insert_mean, insert_sd,
                             hla_dir, long_reads_mode=cfg.long_reads,
                             n_workers=(1 if sharded is not None
                                        else cfg.max_threads),
                             worker_pool=worker_pool)
    from .parallel_host import kernel_launches
    log_progress("kernel launches in this process: " + ", ".join(
        f"{k} {n}" for k, n in kernel_launches().items())
        + "; in typing workers: " + ", ".join(
            f"{k} {n}" for k, n in typer.worker_launches.items()))
    return results


def _shard_path(shard_dir: str, host_idx: int, n_hosts: int) -> str:
    return os.path.join(shard_dir, f"align_shard_{host_idx}of{n_hosts}.npz")


def align_shard(pkg: GraphPackage, pairs, unpaired, shard_dir: str,
                host_idx: int, n_hosts: int,
                cfg: RunConfig | None = None,
                device: str | torch.device = "cuda", sharded=None) -> str:
    """Host `host_idx` of an `n_hosts` HLA run: align the deterministic
    1/N input slice (pairs[i::N]) and write the alignments + kept raw
    reads as a shard file.  The insert-size distribution is estimated from
    the FULL input sample (identical on every host), so a merged run is
    byte-identical to a single-host run.  SURVEY §2.3's multi-host input
    sharding: alignment (the dominant cost) scales across hosts; typing
    runs once at merge (merge_shards_and_type)."""
    from .parallel_host import (add_counters, pack_aligned_pairs,
                                pack_unpaired_chains, stats_counters)
    dev = resolve(device if sharded is None else sharded.device)
    cfg = cfg or RunConfig()
    if not (0 <= host_idx < n_hosts):
        raise ValueError(f"hostIdx {host_idx} outside 0..{n_hosts - 1}")
    os.makedirs(shard_dir, exist_ok=True)
    decoy = build_decoy(pkg, cfg)
    aligner = ReadAligner(pkg, cfg, decoy=decoy, device=dev, sharded=sharded)
    insert_mean, insert_sd = 300.0, 100.0
    if pairs:
        insert_mean, insert_sd = aligner.estimate_insert_size(pairs)
        log_progress(f"insert size estimate (full input): "
                     f"mean {insert_mean}, sd {insert_sd}")
    my_pairs = pairs[host_idx::n_hosts]
    my_unpaired = unpaired[host_idx::n_hosts]
    log_progress(f"host {host_idx}/{n_hosts}: aligning {len(my_pairs)} "
                 f"pairs + {len(my_unpaired)} unpaired")
    par = None
    if sharded is None and cfg.max_threads > 1 \
            and (len(my_pairs) + len(my_unpaired)) > 512:
        from .parallel_host import ParallelAligner, spawn_safe
        if spawn_safe():
            par = ParallelAligner(
                pkg.dir, cfg.max_threads, long_reads=cfg.long_reads,
                decoy_fasta=cfg.decoy_fasta,
                map_complete=cfg.map_against_complete_genome, device=dev)
    try:
        with Timer("align") as t:
            engine = par if par is not None else aligner
            (aligned_pairs, kept_pairs, aligned_unpaired, kept_unpaired,
             kp_idx, ku_idx) = _align_all(engine, my_pairs, my_unpaired,
                                          insert_mean, insert_sd,
                                          cfg.batch_size)
    finally:
        if par is not None:
            par.close()
    n_reads = 2 * len(my_pairs) + len(my_unpaired)
    log_progress(f"host {host_idx}: aligned {len(aligned_pairs)} pairs + "
                 f"{len(aligned_unpaired)} unpaired "
                 f"in {t.elapsed:.3f} s on {dev} "
                 f"({t.rate(n_reads):.1f} reads/s)")
    if par is not None:
        add_counters(aligner.stats, stats_counters(par.stats))
    log_progress(aligner.stats.report())
    if sharded is not None and sharded.rank != 0:
        return _shard_path(shard_dir, host_idx, n_hosts)
    d = (aligned_pairs.pack if hasattr(aligned_pairs, "pack")
         else pack_aligned_pairs(aligned_pairs))
    du = pack_unpaired_chains(aligned_unpaired)
    blob = {f"p_{k}": v for k, v in d.items()}
    blob.update({f"u_{k}": v for k, v in du.items()})
    # original input positions (global index = host_idx + local * n_hosts)
    blob["p_orig_idx"] = np.asarray(
        [host_idx + i * n_hosts for i in kp_idx], dtype=np.int64)
    blob["u_orig_idx"] = np.asarray(
        [host_idx + i * n_hosts for i in ku_idx], dtype=np.int64)
    for pre, reads in (("r1", [p[0] for p in kept_pairs]),
                       ("r2", [p[1] for p in kept_pairs]),
                       ("ru", kept_unpaired)):
        blob[f"{pre}_names"] = "\n".join(r.name for r in reads)
        blob[f"{pre}_seqs"] = "\n".join(r.seq for r in reads)
        blob[f"{pre}_quals"] = "\n".join(r.qual for r in reads)
    blob["meta"] = np.asarray([host_idx, n_hosts, len(pairs),
                               len(unpaired)], dtype=np.int64)
    blob["insert"] = np.asarray([insert_mean, insert_sd])
    path = _shard_path(shard_dir, host_idx, n_hosts)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **blob)
    log_progress(f"wrote {path}")
    return path


def merge_shards_and_type(pkg: GraphPackage, shard_dir: str,
                          output_dir: str, cfg: RunConfig | None = None,
                          device: str | torch.device = "cuda",
                          sharded=None) -> PipelineResult:
    """Merge every host's align shard (restoring the single-host input
    order via the stored original indices) and run typing once.  Outputs
    are byte-identical to a single-host `run_hla_typing` on the same
    input."""
    dev = resolve(device if sharded is None else sharded.device)
    with _rank_output_dir(output_dir, sharded) as out_dir:
        return _merge_shards_and_type(pkg, shard_dir, out_dir,
                                      cfg or RunConfig(), dev, sharded)


def _merge_shards_and_type(pkg, shard_dir, output_dir, cfg, dev, sharded
                           ) -> PipelineResult:
    from .parallel_host import unpack_chains
    import glob as _glob
    files = sorted(_glob.glob(os.path.join(shard_dir, "align_shard_*.npz")))
    if not files:
        raise SystemExit(f"no align_shard_*.npz in {shard_dir}")
    shards = []
    for f in files:
        with np.load(f, allow_pickle=False) as z:
            shards.append({k: (str(z[k]) if z[k].dtype.kind == "U" else z[k])
                           for k in z.files})
    n_hosts = int(shards[0]["meta"][1])
    seen = sorted(int(s["meta"][0]) for s in shards)
    if seen != list(range(n_hosts)):
        raise SystemExit(f"incomplete shard set in {shard_dir}: have hosts "
                         f"{seen}, expected 0..{n_hosts - 1}")
    ins = shards[0]["insert"]
    counts = shards[0]["meta"][2:4]
    for s in shards[1:]:
        # every shard stores the FULL input's pair/unpaired counts and the
        # full-input insert estimate — all must agree or the shards were
        # built from different inputs (the insert check alone is vacuous
        # for unpaired-only runs, where every host stores the default)
        if not np.array_equal(s["insert"], ins) \
                or not np.array_equal(s["meta"][2:4], counts):
            raise SystemExit("shards disagree on the input (read counts or "
                             "insert-size estimate) — were they built from "
                             "the same input?")
    insert_mean, insert_sd = float(ins[0]), float(ins[1])

    def reads_of(s, pre):
        names = s[f"{pre}_names"].split("\n") if s[f"{pre}_names"] else []
        seqs = s[f"{pre}_seqs"].split("\n") if s[f"{pre}_seqs"] else []
        quals = s[f"{pre}_quals"].split("\n") if s[f"{pre}_quals"] else []
        return [FastqRead(n, sq, q) for n, sq, q in zip(names, seqs, quals)]

    from .parallel_host import PackedAlignedPairs
    pair_packs, pair_idx, pair_reads = [], [], []
    unp_items = []
    for s in shards:
        pair_packs.append(
            {k[2:]: v for k, v in s.items() if k.startswith("p_")
             and not k.startswith("p_orig")})
        pair_idx.append(np.asarray(s["p_orig_idx"], dtype=np.int64))
        pair_reads += list(zip(reads_of(s, "r1"), reads_of(s, "r2")))
        chains = unpack_chains(
            {k[2:]: v for k, v in s.items() if k.startswith("u_")
             and not k.startswith("u_orig")})
        for idx, al, r in zip(s["u_orig_idx"], chains, reads_of(s, "ru")):
            unp_items.append((int(idx), al, r))
    # restore the single-host input order with ONE array permutation over
    # the concatenated packs (no per-pair object round-trip)
    merged = PackedAlignedPairs.from_chunks(pair_packs)
    perm = np.argsort(np.concatenate(pair_idx)
                      if pair_idx else np.zeros(0, np.int64), kind="stable")
    aligned_pairs = merged.subset(perm)
    kept_pairs = [pair_reads[i] for i in perm.tolist()]
    unp_items.sort(key=lambda x: x[0])
    aligned_unpaired = [x[1] for x in unp_items]
    kept_unpaired = [x[2] for x in unp_items]
    log_progress(f"merged {len(files)} shards: {len(aligned_pairs)} pairs "
                 f"+ {len(aligned_unpaired)} unpaired")

    os.makedirs(output_dir, exist_ok=True)
    with Timer("type") as t_type:
        results = _type_and_write(pkg, cfg, dev, aligned_pairs, kept_pairs,
                                  aligned_unpaired, kept_unpaired,
                                  insert_mean, insert_sd, output_dir,
                                  sharded=sharded)
    log_progress(f"typed {len(results)} loci in {t_type.elapsed:.3f} s "
                 f"on {dev}")
    n_in = int(shards[0]["meta"][2])
    return PipelineResult(results, n_in, len(aligned_pairs), 0.0,
                          insert_mean, insert_sd)


def _write_reads_per_level(aligned_pairs, aligned_unpaired, pkg, output_dir):
    """Coverage track `reads_per_level.txt` (processBAM.cpp:1902-1913)."""
    n_levels = pkg.compiled().n_levels
    counts = np.zeros(n_levels, dtype=np.int64)
    pack = getattr(aligned_pairs, "pack", None)
    if pack is not None:
        # packed SoA: the column levels are already one flat array.  The
        # per-chain loop's `counts[lv] += 1` increments each level AT MOST
        # ONCE per chain (numpy fancy-index buffering) — reproduce that by
        # dedup'ing (chain, level) keys before the scatter-add
        lv_all = pack["levels"]
        ncol = pack["n_cols"]
        chain_id = np.repeat(np.arange(len(ncol), dtype=np.int64), ncol)
        m = lv_all >= 0
        key = np.unique(chain_id[m] * np.int64(n_levels) + lv_all[m])
        # bincount, not np.add.at: the deduped keys are unique so this is
        # a plain histogram (~10x faster at tens of millions of columns)
        counts += np.bincount(key % np.int64(n_levels),
                              minlength=n_levels).astype(np.int64)
        chains = []
    else:
        chains = [c for ap in aligned_pairs for c in (ap.chain1, ap.chain2)]
    chains += [c for c in aligned_unpaired if c is not None]
    for ch in chains:
        lv = ch.levels[ch.levels >= 0]
        if len(lv):
            counts[lv.astype(np.int64)] += 1
    with open(os.path.join(output_dir, "reads_per_level.txt"), "w") as fh:
        for lv, n in enumerate(counts.tolist()):
            fh.write(f"{lv}\t{n}\n")
