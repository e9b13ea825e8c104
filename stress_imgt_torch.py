#!/usr/bin/env python
"""IMGT-scale typing stress of the PyTorch/CUDA port: the twin of
stress_imgt.py.

    python3 stress_imgt_torch.py [--loci4] [--long] [--sharded]
        [--skip-kernels] [--full-numpy] [--fresh] [--device cuda|cpu]

The world is stress_imgt.py's (``hla_la_tpu_torch.sim.typing_world``): a
panel with 2,200 distinct alleles per class-I-sized locus (J = 540 typed
columns) and paired 100 bp reads at 1,250x per haplotype over each gene
window, from haplotypes 1 and 2: loci A and B on a backbone of 4,000, or
with ``--loci4`` loci A, B, C and DQB1 on a backbone of 8,000 (~83,000
pairs, over the typing fan-out's real gate of 50,000 aligned reads and 4
loci).  It is built once and cached under build/stress_imgt/ (``--fresh``
builds it again).  All pairs are aligned by min(CPUs, 8) worker processes
after a warm-up of 64 pairs, then typed twice: serially in this process,
and with the per-locus fan-out over min(loci, CPUs) fresh typing workers
(with two loci the fan-out's gate is lowered to two, as the script lowers
it; with four it is not touched).

Checks, as stress_imgt.py's: per locus the planted allele of each
haplotype in a called cluster with Q1 > 0.9, C >= 2,000, R at or above
5,000 per typed exon, and the full C(C+1)/2 pair dump; peak RSS under
12 GB; every file of the fan-out byte-identical to the serial run's; also
every NW job on the device.  Then, unless ``--skip-kernels``, the pair
reduction at the run's largest (C, R): K3 (cold and warm, by CUDA events
on the card), the host's native kernel and the numpy reduction on a slice
of NUMPY_SLICE_R reads (its time extrapolated to R, unless
``--full-numpy``), held to each other.  ``--sharded``: the same reduction
on SHARDED_RANKS ranks, model 2 x data 4 (gloo when the ranks outnumber the
cards), held to the one-device K3 and to native.

``--long``: stress_imgt.py's long reads of the world
(``sim.imgt_long_reads``: ONT-like reads of 1.5-3.8 kb at 35x over each
gene window, 0.5% insertions and deletions), aligned in long-read mode
(band 256, K2) by the workers and typed in long-read mode: at least 90% of
the reads aligned, the planted alleles in the called clusters at C >=
2,000, every NW job on the device.

Prints the card's name and power limit first, then after the checks
``STRESS_IMGT OK`` (``STRESS_IMGT_LONG OK``) and one JSON line.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "stress_imgt")
N_ALLELES = 2200
COVERAGE = 1250.0
BACKBONE = 4000                 # two loci
BACKBONE4 = 8000                # --loci4
MAX_WORKERS = 8
WARMUP_PAIRS = 64
# the inner mate distance in graph levels: fragment 300 - 2 x 100
INSERT = (100, 25)
LONG_INSERT = (300.0, 25.0)     # what the script's long mode passes
# the typer's configuration; None: its defaults, with the fan-out's real
# gate (tests lower the gate to drive the fan-out on a cut world)
TYPER_CFG = None
C_MIN = 2000
READS_PER_EXON = 5_000          # R floor per typed exon of a locus
RSS_MAX_GB = 12.0
NUMPY_SLICE_R = 512             # reads of the numpy reduction's slice
SHARDED_RANKS = 8               # model 2 x data 4
LONG_ALIGNED_MIN = 0.9
PAIR_RTOL, PAIR_ATOL = 1e-6, 1e-2
SLICE_ATOL = 1e-4               # K3 against numpy on the slice


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def imgt_world(loci4: bool):
    """stress_imgt.py's world (two loci, or the four of --loci4)."""
    from hla_la_tpu_torch.sim import typing_world
    from hla_la_tpu_torch.sim.worlds import IMGT4_GENES, IMGT_GENES
    return typing_world(CACHE, N_ALLELES, COVERAGE,
                        BACKBONE4 if loci4 else BACKBONE,
                        IMGT4_GENES if loci4 else IMGT_GENES)


def _nw_jobs(stats, device) -> tuple[int, int]:
    dev = str(device).split(":")[0]
    return stats.n_chain_extensions, stats.extras.get(f"nw_jobs_on_{dev}", 0)


def _same_files(a: str, b: str) -> int:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)), "output file sets differ"
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return len(match)


def stress_imgt(world, device, n_workers: int, out_root: str) -> dict:
    """Align `world` in `n_workers` workers on `device`, type it serially
    into `out_root`/out and with the per-locus fan-out into
    `out_root`/out_fanout, and assert stress_imgt.py's checks.  Returns the
    walls, the launches, C x R per locus and the typing workers' runs."""
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.io.fastq import read_fastq
    from hla_la_tpu_torch.models.parallel_host import (ParallelAligner,
                                                        kernel_launches)
    from hla_la_tpu_torch.models.typer import HLATyper
    from hla_la_tpu_torch.utils.config import LOCI_2_EXONS, TyperConfig

    fq = list(zip(read_fastq(world.fastq1), read_fastq(world.fastq2)))
    loci = sorted(world.truth)
    log(f"{len(fq)} read pairs, {len(loci)} loci x {N_ALLELES} alleles")
    bc.zero_launches()
    t0 = time.time()
    engine = ParallelAligner(world.graph, n_workers, device=device)
    try:
        engine.align_pairs(fq[:WARMUP_PAIRS], *INSERT)     # warm-up
        t_ready = time.time() - t0
        t0 = time.time()
        aligned = engine.align_pairs(fq, *INSERT)
        bc.sync(device)
        t_align = time.time() - t0
        stats = engine.stats
    finally:
        engine.close()
    log(f"align: {t_align:.3f}s = {2 * len(fq) / t_align:.0f} reads/s "
        f"({len(aligned)}/{len(fq)} pairs; pool and warm-up {t_ready:.1f}s)")
    aligned_ids = set(aligned.read_ids)
    kept = [p for p in fq if p[0].name in aligned_ids]
    jobs, on_dev = _nw_jobs(stats, device)
    assert jobs > 0 and on_dev == jobs, \
        f"{on_dev} of {jobs} NW jobs ran on {device}"

    pkg = GraphPackage(world.graph)
    out_s, out_f = (os.path.join(out_root, d) for d in ("out", "out_fanout"))
    for d in (out_s, out_f):
        shutil.rmtree(d, ignore_errors=True)
    rss_before = bc.rss_gb()
    k3 = kernel_launches()["K3"]
    t0 = time.time()
    cfg = TYPER_CFG or TyperConfig()
    res = HLATyper(pkg, cfg, device=device).type_all(
        kept, aligned, [], [], float(INSERT[0]), float(INSERT[1]), out_s,
        n_workers=1)
    bc.sync(device)
    t_type = time.time() - t0
    k3_serial = kernel_launches()["K3"] - k3
    log(f"typing (serial): {t_type:.3f}s; peak RSS {bc.rss_gb():.2f} GB "
        f"(was {rss_before:.2f} before typing)")

    # ---- checks -----------------------------------------------------
    by_locus = {r.locus: r for r in res}
    for locus in loci:
        r = by_locus[locus]
        # identical-exon decoys legitimately merge into the truth cluster:
        # each planted allele must be IN a called cluster
        called = [set(r.allele1_id.split(";")), set(r.allele2_id.split(";"))]
        for want in world.truth[locus]:
            assert any(want in c for c in called), (locus, want, called)
        assert r.q1_allele1 > 0.9 and r.q1_allele2 > 0.9, \
            (locus, r.q1_allele1, r.q1_allele2)
        assert r.n_clusters >= C_MIN, (locus, r.n_clusters)
        floor = READS_PER_EXON * len(LOCI_2_EXONS.get(locus, ["e2", "e3"]))
        assert r.n_reads_used >= floor, (locus, r.n_reads_used, floor)
        n_pairs = r.n_clusters * (r.n_clusters + 1) // 2
        with open(os.path.join(out_s, f"R1_PP_{locus}_pairs.txt")) as fh:
            n_lines = sum(1 for _ in fh)
        assert n_lines == n_pairs + 1, (locus, n_lines, n_pairs)
        log(f"{locus}: C={r.n_clusters}, R={r.n_reads_used}, calls "
            f"{r.allele1_id.split(';')[0]}/{r.allele2_id.split(';')[0]}, "
            f"{n_pairs} pairs dumped")
    peak = bc.rss_gb()
    assert peak < RSS_MAX_GB, f"peak RSS {peak:.2f} GB — tiling regressed"

    # ---- per-locus fan-out: byte-identical ----------------------------
    typer = HLATyper(pkg, cfg, device=device)
    n_fan = min(len(loci), os.cpu_count() or 2)
    gate_lowered = len(loci) < typer.cfg.min_loci_for_typing_workers
    if gate_lowered:
        # two loci: engage the path as stress_imgt.py does, through the
        # loci gate alone (the production gate needs >= 4 loci)
        typer.cfg = replace(typer.cfg, min_loci_for_typing_workers=len(loci))
    k3 = kernel_launches()["K3"]
    t0 = time.time()
    typer.type_all(kept, aligned, [], [], float(INSERT[0]),
                   float(INSERT[1]), out_f, n_workers=n_fan)
    bc.sync(device)
    t_fan = time.time() - t0
    k3_fan_parent = kernel_launches()["K3"] - k3
    n_files = _same_files(out_s, out_f)
    # under the gate the typer types serially, as the script's would: the
    # record says whether the fan-out ran, and in how many workers
    runs = typer.worker_runs
    pids = {run["pid"] for run in runs}
    dev = str(device).split(":")[0]
    # the workers are host-only: every K3 launch of the fan-out is this
    # process's device server's, made for them
    assert k3_fan_parent == typer.served_launches["K3"], \
        (f"fan-out: K3 launched {k3_fan_parent} times here, "
         f"{typer.served_launches['K3']} of them for the workers")
    assert not any(run["cuda_initialized"] for run in runs), runs
    k3_ms = [ms for run in runs for ms in run["k3_ms"]]
    log(f"fan-out: {t_fan:.3f}s vs serial {t_type:.3f}s; {n_files} output "
        f"files byte-identical; "
        + (f"ran in {len(pids)} workers, ready after "
           f"{sorted(round(r['ready_s'], 2) for r in runs)} s"
           + (f", K3 per launch for them {[round(m, 3) for m in k3_ms]} ms"
              if k3_ms else "")
           if runs else f"did not run: {len(aligned)} aligned pairs and "
           f"{len(loci)} loci against the gate "
           f"{cfg.min_reads_for_typing_workers} / "
           f"{typer.cfg.min_loci_for_typing_workers}"))
    C_max = max(r.n_clusters for r in res)
    R_max = max(r.n_reads_used for r in res)
    return {"pairs": len(fq), "pairs_aligned": len(aligned),
            "align_workers": n_workers, "pool_ready_s": t_ready,
            "align_s": t_align, "reads_per_s": 2 * len(fq) / t_align,
            "type_serial_s": t_type, "type_fanout_s": t_fan,
            "fanout_ran": bool(runs), "typing_workers": len(pids),
            "fanout_gate_lowered": gate_lowered,
            "fanout_gate": [typer.cfg.min_reads_for_typing_workers,
                            typer.cfg.min_loci_for_typing_workers],
            "typing_worker_runs": runs, "files": n_files,
            "peak_rss_gb": peak, "C_max": C_max, "R_max": R_max,
            "launches_parent": {"K1": kernel_launches()["K1"],
                                "K3_serial": k3_serial,
                                "K3_fanout": k3_fan_parent},
            "launches_workers": {
                "K1": stats.extras.get("served_launches_K1", 0),
                "K3": typer.served_launches["K3"]},
            # the host-only workers: each one's CUDA state after its last
            # align and type task, and what the align pool's device server
            # ran for them
            "workers_cuda_initialized": (
                [r["cuda_initialized"] for r in engine.workers.values()]
                + [r["cuda_initialized"] for r in runs]),
            "workers_torch_imported": (
                [r["torch_imported"] for r in engine.workers.values()]
                + [r["torch_imported"] for r in runs]),
            "served": engine.server.served,
            "n_chain_extensions": jobs, f"nw_jobs_on_{dev}": on_dev,
            "loci": {r.locus: [r.n_clusters, r.n_reads_used] for r in res},
            "calls": {r.locus: [r.allele1_id, r.allele2_id] for r in res}}


def reduction_input(C: int, R: int) -> np.ndarray:
    """The script's log-likelihood matrix for the kernel section."""
    rng = np.random.default_rng(5)
    return rng.normal(-40.0, 8.0, (C, R)).astype(np.float64)


def _k3_ms(L32, device) -> tuple[np.ndarray, float]:
    """(K3's pair matrix of L32 on `device`, its milliseconds: by CUDA
    events on a card, else by the host clock)."""
    import torch

    from hla_la_tpu_torch.ops.pair_ll import pair_ll_reduction
    if torch.device(device).type != "cuda":
        t0 = time.time()
        out = pair_ll_reduction(L32, device)
        return out, (time.time() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    out = pair_ll_reduction(L32, device)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_pair_reduction(L: np.ndarray, device, full_numpy: bool = False
                        ) -> tuple[dict, np.ndarray]:
    """The C^2 reduction of L at the run's shape: K3 (with its input copy
    and its rank-1 term) cold and warm, the host's native kernel, and numpy
    on a slice of NUMPY_SLICE_R reads (extrapolated: it is linear in R),
    held to each other.  Returns (the times, K3's matrix)."""
    from hla_la_tpu_torch import native
    from hla_la_tpu_torch.ops.pair_ll import (pair_ll_reduction,
                                              pair_ll_reduction_numpy)
    C, R = L.shape
    cells = C * C * R
    rec = {"C": C, "R": R}
    out, rec["k3_cold_ms"] = _k3_ms(L, device)
    out, rec["k3_warm_ms"] = _k3_ms(L, device)
    rec["k3_gcells_per_s"] = cells / (rec["k3_warm_ms"] * 1e-3) / 1e9
    log(f"pair reduction K3 on {device}: {rec['k3_warm_ms']:.3f} ms warm "
        f"({rec['k3_cold_ms']:.3f} ms cold) = {rec['k3_gcells_per_s']:.1f} "
        f"Gcells/s at C={C}, R={R}")
    if native.available():
        t0 = time.time()
        out_native = native.pair_ll(L)
        rec["native_s"] = time.time() - t0
        d = np.abs(out - out_native)
        rec["k3_vs_native_max_abs"] = float(d.max())
        log(f"pair reduction native (host): {rec['native_s']:.3f}s = "
            f"{cells / rec['native_s'] / 1e9:.2f} Gcells/s; |K3 - native| "
            f"max {d.max():.4g}")
        assert np.allclose(out, out_native, rtol=PAIR_RTOL,
                           atol=PAIR_ATOL), _first_miss(out, out_native,
                                                        "K3/native")

    r_slice = R if full_numpy else min(R, NUMPY_SLICE_R)
    t0 = time.time()
    out_np = pair_ll_reduction_numpy(L[:, :r_slice])
    t_slice = time.time() - t0
    rec.update(numpy_slice_R=r_slice, numpy_slice_s=t_slice,
               numpy_s=t_slice * (R / r_slice),
               numpy_s_is="measured" if r_slice == R
               else f"extrapolated from R={r_slice}")
    log(f"pair reduction numpy: {rec['numpy_s']:.1f}s ({rec['numpy_s_is']}; "
        f"{C * C * r_slice / t_slice / 1e9:.3f} Gcells/s)")
    out_slice = pair_ll_reduction(L[:, :r_slice], device)
    rec["k3_vs_numpy_slice_max_abs"] = float(np.abs(out_slice - out_np).max())
    assert np.allclose(out_slice, out_np, rtol=PAIR_RTOL, atol=SLICE_ATOL), \
        _first_miss(out_slice, out_np, "K3/numpy on the slice", SLICE_ATOL)
    log("K3/numpy parity OK on the timed slice")
    return rec, out


def _first_miss(got: np.ndarray, want: np.ndarray, what: str,
                atol: float = PAIR_ATOL) -> str:
    """Where `got` leaves rtol PAIR_RTOL / `atol` of `want`: the count of
    cells and the first of them, with both values."""
    bad = np.argwhere(~np.isclose(got, want, rtol=PAIR_RTOL, atol=atol))
    i, j = bad[0]
    return (f"{what} mismatch at {len(bad)} cells; first [{i}, {j}]: "
            f"{got[i, j]!r} against {want[i, j]!r}")


def time_sharded_reduction(L: np.ndarray, device, ranks: int = None
                           ) -> tuple[dict, np.ndarray]:
    """The model-axis-sharded C^2 reduction of L on `ranks` ranks (default
    SHARDED_RANKS; model 2 x data 4 at 8) through
    ``parallel/launch.run_ranks``, twice in one start of the ranks (cold
    and warm), held to the one-device K3 and to native at rtol 1e-6 /
    atol 1e-2.  Returns (the walls, per-rank launches and tile ranges, and
    the backend; the sharded matrix)."""
    import torch

    from hla_la_tpu_torch import native
    from hla_la_tpu_torch.parallel import launch, mesh
    from hla_la_tpu_torch.ops.pair_ll import pair_ll_reduction
    ranks = ranks or SHARDED_RANKS
    C, R = L.shape
    n_model = mesh.model_axis(ranks)
    cards = torch.cuda.device_count() if torch.device(
        device).type == "cuda" else 0
    backend = "nccl" if 0 < ranks <= cards else "gloo"
    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "L.npy")
        np.save(path, L)
        got = launch.run_ranks(launch.rank_timed_pair_reduction, ranks,
                               device, (path,))
    wall = time.time() - t0
    out = got[0]["pair"]
    rec = {"ranks": ranks, "mesh": f"{ranks // n_model}x{n_model}",
           "backend": backend, "cards": cards, "wall_s": wall,
           "cold_s": max(g["cold_s"] for g in got),
           "warm_s": max(g["warm_s"] for g in got),
           "per_rank": [{k: g[k] for k in ("rank", "tile_range", "reads",
                                           "launches", "k3_ms")}
                        for g in got]}
    rec["gcells_per_s"] = C * C * R / rec["warm_s"] / 1e9
    one, _ = _k3_ms(L, device)
    d = np.abs(out - one)
    rec["vs_one_device_max_abs"] = float(d.max())
    assert np.allclose(out, one, rtol=PAIR_RTOL, atol=PAIR_ATOL), \
        _first_miss(out, one, "sharded/one-device")
    msg = f"|sharded - one device| max {d.max():.3g}"
    if native.available():
        out_native = native.pair_ll(L)
        d = np.abs(out - out_native)
        rec["vs_native_max_abs"] = float(d.max())
        assert np.allclose(out, out_native, rtol=PAIR_RTOL,
                           atol=PAIR_ATOL), \
            _first_miss(out, out_native, "sharded/native")
        msg += f"; |sharded - native| max {d.max():.3g}"
    shared = ", ranks share the card" if backend == "gloo" and cards else ""
    log(f"sharded C^2 at C={C}, R={R} on {ranks} ranks ({rec['mesh']}, "
        f"{backend}{shared}): "
        f"{rec['warm_s']:.3f}s warm ({rec['cold_s']:.3f}s cold), "
        f"{wall:.1f}s with the ranks' start; {msg}")
    if backend == "gloo":
        log("context: ranks share " + ("one card" if cards else "the host")
            + " and their collectives cross the host: the number above is "
            "a correctness run, not scaling across cards")
    return rec, out


def stress_long(world, device, n_workers: int, out_root: str) -> dict:
    """stress_imgt.py --long: the world's long reads aligned by
    `n_workers` workers in long-read mode and typed in long-read mode into
    `out_root`/out_long; asserts its checks.  Returns what the JSON line
    prints."""
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.io.fastq import read_fastq
    from hla_la_tpu_torch.models.parallel_host import (ParallelAligner,
                                                        kernel_launches)
    from hla_la_tpu_torch.models.typer import HLATyper
    from hla_la_tpu_torch.sim import imgt_long_reads

    t0 = time.time()
    reads = imgt_long_reads(world)
    fq = list(read_fastq(reads.fastq))
    lens = [len(r.seq) for r in fq]
    log(f"{len(fq)} long reads, {sum(lens) / 1e6:.2f} Mb, ready in "
        f"{time.time() - t0:.1f}s")
    bc.zero_launches()
    t0 = time.time()
    engine = ParallelAligner(world.graph, n_workers, long_reads="ont2d",
                             device=device)
    try:
        t_pool = time.time() - t0
        t0 = time.time()
        unal = engine.align_unpaired(fq)
        bc.sync(device)
        t_align = time.time() - t0
        stats = engine.stats
    finally:
        engine.close()
    kept = [(r, a) for r, a in zip(fq, unal) if a is not None]
    log(f"align (long, unpaired): {t_align:.3f}s, {len(kept)}/{len(fq)} "
        f"aligned (pool {t_pool:.1f}s)")
    assert len(kept) >= LONG_ALIGNED_MIN * len(fq), (len(kept), len(fq))
    jobs, on_dev = _nw_jobs(stats, device)
    assert jobs > 0 and on_dev == jobs, \
        f"{on_dev} of {jobs} NW jobs ran on {device}"

    out_dir = os.path.join(out_root, "out_long")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    res = HLATyper(GraphPackage(world.graph), device=device).type_all(
        [], [], [r for r, _ in kept], [a for _, a in kept],
        *LONG_INSERT, out_dir,
        long_reads_mode="ont2d")
    bc.sync(device)
    t_type = time.time() - t0
    by_locus = {r.locus: r for r in res}
    for locus, planted in sorted(reads.truth.items()):
        r = by_locus[locus]
        called = [set(r.allele1_id.split(";")), set(r.allele2_id.split(";"))]
        for want in planted:
            assert any(want in c for c in called), (locus, want, called)
        assert r.n_clusters >= C_MIN, (locus, r.n_clusters)
        log(f"{locus}: C={r.n_clusters}, R={r.n_reads_used}, calls "
            f"{r.allele1_id.split(';')[0]}/{r.allele2_id.split(';')[0]} "
            f"(long mode)")
    dev = str(device).split(":")[0]
    log(f"SUMMARY(long): align {t_align:.3f}s, typing {t_type:.3f}s, peak "
        f"RSS {bc.rss_gb():.2f} GB")
    return {"reads": len(fq), "mb": sum(lens) / 1e6,
            "longest_read": max(lens), "aligned": len(kept),
            "align_workers": n_workers, "pool_s": t_pool,
            "align_s": t_align, "type_s": t_type,
            "peak_rss_gb": bc.rss_gb(),
            "launches_workers": {
                "K2": stats.extras.get("served_launches_K2", 0)},
            "launches_parent": {"K2": kernel_launches()["K2"],
                                "K3": kernel_launches()["K3"]},
            "workers_cuda_initialized": [
                r["cuda_initialized"] for r in engine.workers.values()],
            "workers_torch_imported": [
                r["torch_imported"] for r in engine.workers.values()],
            "served": engine.server.served,
            "n_chain_extensions": jobs, f"nw_jobs_on_{dev}": on_dev,
            "loci": {r.locus: [r.n_clusters, r.n_reads_used] for r in res},
            "calls": {r.locus: [r.allele1_id, r.allele2_id] for r in res}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for flag in ("--loci4", "--long", "--sharded", "--skip-kernels",
                 "--full-numpy", "--fresh"):
        ap.add_argument(flag, action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.models.parallel_host import spawn_safe

    card = bc.start(args.device)
    assert spawn_safe(), "the worker pool needs a file-backed __main__"
    if args.fresh:
        shutil.rmtree(CACHE, ignore_errors=True)
    t0 = time.time()
    world = imgt_world(args.loci4)
    log(f"world ready in {time.time() - t0:.1f}s: {world.graph}")
    n_workers = min(os.cpu_count() or 1, MAX_WORKERS)
    out_root = os.path.dirname(world.graph)
    head = {"genes": sorted(world.truth), "alleles": N_ALLELES,
            "device": args.device, "card": card}
    if args.long:
        st = stress_long(world, args.device, n_workers, out_root)
        print("STRESS_IMGT_LONG OK", flush=True)
        print(json.dumps({"mode": "long", **head, **st}), flush=True)
        return 0
    st = stress_imgt(world, args.device, n_workers, out_root)
    L = None
    if args.sharded or not args.skip_kernels:
        L = reduction_input(st["C_max"], st["R_max"])
    if args.sharded:
        st["sharded"], _ = time_sharded_reduction(L, args.device)
    if not args.skip_kernels:
        st["pair_reduction"], _ = time_pair_reduction(L, args.device,
                                                      args.full_numpy)
    log(f"SUMMARY: align {st['align_s']:.3f}s, typing "
        f"{st['type_serial_s']:.3f}s serial / {st['type_fanout_s']:.3f}s "
        f"fan-out, C={st['C_max']}, R={st['R_max']}, peak RSS "
        f"{st['peak_rss_gb']:.2f} GB")
    print("STRESS_IMGT OK", flush=True)
    print(json.dumps({"mode": "loci4" if args.loci4 else "default", **head,
                      **st}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
