#!/usr/bin/env python
"""Real-PRG-scale benchmark of the PyTorch/CUDA port: the twin of bench.py.

    python3 bench_torch.py [--device cuda|cpu] [--workers N]

The world is bench.py's (``hla_la_tpu_torch.sim.bench_world``): a
3,000,000-level panel of 8 haplotypes with genes A and B and ~30k paired
101 bp reads from haplotypes 1 and 2, built once and cached under
build/real_scale/.  The reads are aligned by min(CPUs, 8) worker processes
(``ParallelAligner``: host-only workers whose NW calls this process's
device server runs on the card) and typed by ``HLATyper.type_all`` with the
warm workers as its pool; with ``--workers 1`` all of it runs in this
process (``ReadAligner``), as bench.py chooses its engine, which is the run
to profile by layer (``python -m cProfile -s cumtime bench_torch.py
--workers 1``).  After a warm-up on 64 pairs come ALIGN_WARMUP
excluded and ALIGN_REPS measured full-size align passes, then TYPE_WARMUP
and TYPE_REPS type passes.

Prints the card's name and power limit first.  Gates, as bench.py's: the
alignments' truth accuracy over 0.95 and the calls exactly the planted
alleles at A and B; a broken pipeline prints no numbers.  The last stdout
line is one JSON object (median and best end-to-end reads/s, the window's
reads over all its seconds, per-rep seconds, the engine's start and the
warm-up passes, the calls, launches of K1 and K3 made for the workers by the
device server and in this process in all, the NW jobs on the card); the
GPU probe (``gpu_check.run``) follows on stderr.
The kernels are built first, outside every timed window.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "real_scale")
N_LEVELS = 3_000_000
MAX_WORKERS = 8
MAX_TYPING_WORKERS = 4
WARMUP_PAIRS = 64
INSERT = (113, 27)              # bench.py's insert statistics
ALIGN_WARMUP, ALIGN_REPS = 2, 5
TYPE_WARMUP, TYPE_REPS = 2, 5
ACCURACY_MIN = 0.95


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def bench(world, device, n_workers: int, align_reps=None,
          type_reps=None) -> dict:
    """bench.py's measurement on `world` (a sim.RealScaleWorld) on
    `device`: (warm-up, measured) align passes in `n_workers` workers,
    then type passes with them as the typing pool (default: the module's
    ALIGN_* and TYPE_* counts).  Asserts the gates; returns the per-rep
    seconds, the calls, the truth accuracy and the launches (K1 and K3
    made for the workers by this process's device server, and all of this
    process's)."""
    align_reps = align_reps or (ALIGN_WARMUP, ALIGN_REPS)
    type_reps = type_reps or (TYPE_WARMUP, TYPE_REPS)
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.models.aligner import ReadAligner
    from hla_la_tpu_torch.models.parallel_host import (ParallelAligner,
                                                        kernel_launches)
    from hla_la_tpu_torch.models.typer import HLATyper
    from hla_la_tpu_torch.sim import TrueReadLevels, load_levels

    fq = world.pairs()
    truth = TrueReadLevels(load_levels(world.truth_levels))
    log(f"real-scale: {world.n_levels} levels, {len(fq)} read pairs")
    bc.zero_launches()
    pkg = GraphPackage(world.graph)
    t0 = time.time()
    # bench.py's engine choice: a worker pool, or this process alone
    engine = (ParallelAligner(world.graph, n_workers, device=device)
              if n_workers > 1 else ReadAligner(pkg, device=device))
    pool = engine if n_workers > 1 else None
    try:
        engine.align_pairs(fq[:WARMUP_PAIRS], *INSERT)
        init_s = time.time() - t0
        log(f"{n_workers} worker process(es); init and warm-up "
            f"{init_s:.1f}s")
        align_s, align_cpu, aligned = [], [], None
        warm_s = {"align_s": [], "type_s": []}
        warm, reps = align_reps
        for rep in range(warm + reps):
            t0, c0 = time.time(), bc.cpu_now()
            aligned = engine.align_pairs(fq, *INSERT,
                                         truth=truth if rep == 0 else None)
            dt, dc = time.time() - t0, bc.cpu_now() - c0
            log(f"align rep {rep}{' (warm-up, excluded)' if rep < warm else ''}"
                f": {dt:.3f}s wall / {dc:.3f}s cpu = {2 * len(fq) / dt:.0f} "
                f"reads/s")
            if rep >= warm:
                align_s.append(dt)
                align_cpu.append(dc)
            else:
                warm_s["align_s"].append(dt)
        accuracy = truth.accuracy()
        log(f"aligned {len(aligned)}/{len(fq)} pairs, truth accuracy "
            f"{accuracy:.4f}")

        typer = HLATyper(pkg, device=device)
        aligned_ids = (set(aligned.read_ids) if pool is not None
                       else {ap.read_id for ap in aligned})
        kept = [p for p in fq if p[0].name in aligned_ids]
        type_s, type_cpu, res = [], [], None
        warm, reps = type_reps
        for rep in range(warm + reps):
            t0, c0 = time.time(), bc.cpu_now()
            with tempfile.TemporaryDirectory() as td:
                res = typer.type_all(kept, aligned, [], [], float(INSERT[0]),
                                     float(INSERT[1]), td,
                                     n_workers=min(n_workers,
                                                   MAX_TYPING_WORKERS),
                                     worker_pool=pool)
            bc.sync(device)
            dt, dc = time.time() - t0, bc.cpu_now() - c0
            log(f"type rep {rep}{' (warm-up, excluded)' if rep < warm else ''}"
                f": {dt:.3f}s wall / {dc:.3f}s cpu")
            if rep >= warm:
                type_s.append(dt)
                type_cpu.append(dc)
            else:
                warm_s["type_s"].append(dt)
        stats = engine.stats
    finally:
        if pool is not None:
            pool.close()
    calls = {r.locus: (r.allele1_id, r.allele2_id) for r in res}
    log(f"calls {calls}")
    # the gates: numbers of a broken pipeline mean nothing
    assert accuracy > ACCURACY_MIN, \
        f"alignment truth accuracy regressed: {accuracy:.4f}"
    for locus, planted in world.truth.items():
        assert set(calls.get(locus, ())) == set(planted), \
            f"typing regression at {locus}: {calls.get(locus)} != {planted}"
    dev = str(device).split(":")[0]
    jobs = stats.n_chain_extensions
    on_dev = stats.extras.get(f"nw_jobs_on_{dev}", 0)
    assert jobs > 0 and on_dev == jobs, \
        f"{on_dev} of {jobs} NW jobs ran on {dev}"
    here = kernel_launches()
    return {"align_s": align_s, "align_cpu_s": align_cpu, "type_s": type_s,
            "type_cpu_s": type_cpu, "init_s": init_s, "warm_s": warm_s,
            "n_reads": 2 * len(fq),
            "pairs_aligned": len(aligned), "truth_accuracy": accuracy,
            "calls": calls,
            "launches_workers": {
                "K1": stats.extras.get("served_launches_K1", 0),
                "K3": typer.served_launches["K3"]},
            "launches_parent": {"K1": here["K1"], "K3": here["K3"]},
            # the host-only workers: each one's CUDA state after its last
            # align and type task, and what the device server ran for them
            "workers_cuda_initialized": (
                [r["cuda_initialized"] for r in pool.workers.values()]
                + [r["cuda_initialized"] for r in typer.worker_runs]
                if pool is not None else []),
            "workers_torch_imported": (
                [r["torch_imported"] for r in pool.workers.values()]
                + [r["torch_imported"] for r in typer.worker_runs]
                if pool is not None else []),
            "served": pool.server.served if pool is not None else None,
            "n_chain_extensions": jobs, f"nw_jobs_on_{dev}": on_dev,
            "loci": {r.locus: (r.n_clusters, r.n_reads_used) for r in res}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workers", type=int,
                    default=min(os.cpu_count() or 1, MAX_WORKERS),
                    help="align worker processes; 1: this process alone")
    args = ap.parse_args(argv)
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.models.parallel_host import spawn_safe
    from hla_la_tpu_torch.sim import bench_world

    t_start = time.time()
    card = bc.start(args.device)
    n_workers = max(1, args.workers)
    assert n_workers == 1 or spawn_safe(), \
        "the worker pool needs a file-backed __main__"
    t0 = time.time()
    world = bench_world(CACHE, N_LEVELS)
    log(f"world ready in {time.time() - t0:.1f}s: {world.graph}")
    st = bench(world, args.device, n_workers)
    med_a, med_t = float(np.median(st["align_s"])), float(
        np.median(st["type_s"]))
    best_a, best_t = min(st["align_s"]), min(st["type_s"])
    mean_a, mean_t = (float(np.mean(st[k])) for k in ("align_s", "type_s"))
    n = st["n_reads"]
    print(json.dumps({
        "metric": "e2e_reads_per_sec_real_prg_scale",
        "value": round(n / (med_a + med_t), 1), "unit": "reads/s",
        "median": round(n / (med_a + med_t), 1),
        "best": round(n / (best_a + best_t), 1),
        # all the window's work over all its time: n reads per rep over
        # the mean align pass plus the mean type pass (with as many align
        # as type reps, n x reps / (sum align_s + sum type_s)); a stall in
        # any measured pass moves it, where it moves no median
        "window_reads_per_s": round(n / (mean_a + mean_t), 1),
        "align_reads_per_s": {"median": round(n / med_a, 1),
                              "best": round(n / best_a, 1)},
        "window": (f"median of {ALIGN_REPS} measured reps after "
                   f"{ALIGN_WARMUP} full-size warm-up reps (align) / "
                   f"{TYPE_REPS} after {TYPE_WARMUP} (type)"),
        "reps": {k: [round(x, 3) for x in st[k]]
                 for k in ("align_s", "align_cpu_s", "type_s",
                           "type_cpu_s")},
        # outside the window: the engine's start with its 64-pair warm-up,
        # and the excluded full-size passes
        "init_s": round(st["init_s"], 3),
        "warmup_reps": {k: [round(x, 3) for x in v]
                        for k, v in st["warm_s"].items()},
        "n_reads": n, "n_levels": world.n_levels, "workers": n_workers,
        "pairs_aligned": st["pairs_aligned"],
        "truth_accuracy": round(st["truth_accuracy"], 6),
        "calls": st["calls"],
        "launches_workers": st["launches_workers"],
        "launches_parent": st["launches_parent"],
        "workers_cuda_initialized": st["workers_cuda_initialized"],
        "workers_torch_imported": st["workers_torch_imported"],
        "served": st["served"],
        "n_chain_extensions": st["n_chain_extensions"],
        f"nw_jobs_on_{args.device}": st[f"nw_jobs_on_{args.device}"],
        "device": args.device, "card": card}), flush=True)
    if args.device == "cuda":
        # the GPU probe after the result line, as bench.py orders its
        # kernel diagnostics
        from hla_la_tpu_torch import gpu_check
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gpu_check.run()
        log(f"gpu_check (rc={rc}): {buf.getvalue().strip()}")
    log(f"total bench time {time.time() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
