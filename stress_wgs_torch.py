#!/usr/bin/env python
"""Platinum-WGS-scale stress of the PyTorch/CUDA port: the twin of
stress_wgs.py.

    python3 stress_wgs_torch.py [--coverage 12] [--fresh] [--device cuda|cpu]

The world is stress_wgs.py's (``hla_la_tpu_torch.sim.wgs_world``): a
3,000,000-level panel with all 17 typed loci and paired 101 bp reads from
haplotypes 1 and 2 at the diploid coverage given (~180k pairs at 12x),
built once and cached under build/real_scale/ (``--fresh`` builds it
again).  All pairs are aligned by min(CPUs, 8) worker processes, then typed
twice: serially in this process, and with the per-locus fan-out
(``HLATyper._type_loci_parallel``, which engages at 50,000 aligned reads and
4 loci) over the warm workers.

Checks, as stress_wgs.py's: the calls exact at every locus; every file of
the fan-out output byte-identical to the serial output; every NW job on the
device.  Prints the card's name and power limit first, then after the
checks ``STRESS_WGS OK`` and one JSON line: align s, reads/s, serial and
fan-out type s, K1 and K3 launches in this process and those of them made
for the workers (the workers are host-only: this process's device server
runs their device calls), and C x R per locus.  The kernels are built
first, outside every timed window.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "real_scale")
N_LEVELS = 3_000_000
MAX_WORKERS = 8
MAX_TYPING_WORKERS = 4
WARMUP_PAIRS = 64
# the inner mate distance in graph levels: fragment 320 - 2 x 101
INSERT = (118, 30)
# the typer's configuration; None: its defaults, with the fan-out's real
# gate (tests lower the gate to drive the fan-out on a cut world)
TYPER_CFG = None


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def stress_wgs(world, device, n_workers: int, out_root: str) -> dict:
    """Align `world` (a sim.RealScaleWorld) in `n_workers` workers on
    `device`, type it serially and with the fan-out into `out_root`/
    out_serial and out_fanout, and assert stress_wgs.py's checks.  Returns
    the walls, the launches and C x R per locus."""
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.models.parallel_host import (ParallelAligner,
                                                        kernel_launches)
    from hla_la_tpu_torch.models.typer import HLATyper
    from hla_la_tpu_torch.utils.config import TyperConfig

    cfg = TYPER_CFG or TyperConfig()
    fq = world.pairs()
    log(f"{len(fq)} read pairs, {len(world.truth)} loci, {world.n_levels} "
        f"levels")
    bc.zero_launches()
    engine = ParallelAligner(world.graph, n_workers, device=device)
    try:
        engine.align_pairs(fq[:WARMUP_PAIRS], *INSERT)     # warm-up
        t0 = time.time()
        aligned = engine.align_pairs(fq, *INSERT)
        bc.sync(device)
        t_align = time.time() - t0
        log(f"align: {t_align:.3f}s = {2 * len(fq) / t_align:.0f} reads/s "
            f"({len(aligned)}/{len(fq)} pairs aligned)")
        aligned_ids = set(aligned.read_ids)
        kept = [p for p in fq if p[0].name in aligned_ids]
        pkg = GraphPackage(world.graph)
        out_s, out_f = (os.path.join(out_root, d)
                        for d in ("out_serial", "out_fanout"))
        for d in (out_s, out_f):
            shutil.rmtree(d, ignore_errors=True)

        k3 = kernel_launches()["K3"]
        t0 = time.time()
        res_s = HLATyper(pkg, cfg, device=device).type_all(
            kept, aligned, [], [], float(INSERT[0]), float(INSERT[1]), out_s,
            n_workers=1)
        bc.sync(device)
        t_serial = time.time() - t0
        k3_serial = kernel_launches()["K3"] - k3
        log(f"typing serial: {t_serial:.3f}s")

        k3 = kernel_launches()["K3"]
        n_typing = min(n_workers, MAX_TYPING_WORKERS)
        typer = HLATyper(pkg, cfg, device=device)
        t0 = time.time()
        typer.type_all(kept, aligned, [], [], float(INSERT[0]),
                       float(INSERT[1]), out_f, n_workers=n_typing,
                       worker_pool=engine)
        bc.sync(device)
        t_fan = time.time() - t0
        k3_fan_parent = kernel_launches()["K3"] - k3
        log(f"typing fan-out ({engine.n_workers} workers): {t_fan:.3f}s "
            f"({t_serial / t_fan:.2f}x)")
        stats = engine.stats
    finally:
        engine.close()

    # 1. exact calls at every locus
    calls = {r.locus: {r.allele1_id, r.allele2_id} for r in res_s}
    for locus, planted in world.truth.items():
        assert calls.get(locus) == set(planted), \
            f"{locus}: {calls.get(locus)} != {set(planted)}"
    log(f"calls exact at all {len(world.truth)} loci")
    # 2. fan-out output byte-identical to serial
    files = sorted(os.listdir(out_s))
    assert files == sorted(os.listdir(out_f)), "output file sets differ"
    bad = [f for f in files
           if not filecmp.cmp(os.path.join(out_s, f),
                              os.path.join(out_f, f), shallow=False)]
    assert not bad, f"fan-out output differs from serial: {bad}"
    log(f"fan-out byte-identical to serial across {len(files)} files")
    # 3. the fan-out's gate was passed, its K3 ran for the workers, and
    # every NW job ran on the device
    engaged = (len(aligned) >= cfg.min_reads_for_typing_workers
               and len(typer.loci) >= cfg.min_loci_for_typing_workers)
    k3_workers = typer.served_launches["K3"]
    dev = str(device).split(":")[0]
    assert engaged, f"{len(aligned)} aligned pairs: under the fan-out's gate"
    # the workers are host-only: this process's device server made every
    # K3 launch of the fan-out, for them
    assert k3_fan_parent == k3_workers and (dev != "cuda" or k3_workers > 0), \
        f"fan-out: K3 for the workers {k3_workers}, here {k3_fan_parent}"
    jobs = stats.n_chain_extensions
    on_dev = stats.extras.get(f"nw_jobs_on_{dev}", 0)
    assert jobs > 0 and on_dev == jobs, \
        f"{on_dev} of {jobs} NW jobs ran on {dev}"
    return {"pairs": len(fq), "pairs_aligned": len(aligned),
            "align_s": t_align, "reads_per_s": 2 * len(fq) / t_align,
            "type_serial_s": t_serial, "type_fanout_s": t_fan,
            "typing_workers": engine.n_workers, "files": len(files),
            "fanout_gate": [cfg.min_reads_for_typing_workers,
                            cfg.min_loci_for_typing_workers],
            "launches_parent": {"K1": kernel_launches()["K1"],
                                "K3_serial": k3_serial,
                                "K3_fanout": k3_fan_parent},
            "launches_workers": {
                "K1": stats.extras.get("served_launches_K1", 0),
                "K3": k3_workers},
            # the host-only workers: each one's CUDA state after its last
            # align and type task, and what the device server ran for them
            "workers_cuda_initialized": (
                [r["cuda_initialized"] for r in engine.workers.values()]
                + [r["cuda_initialized"] for r in typer.worker_runs]),
            "workers_torch_imported": (
                [r["torch_imported"] for r in engine.workers.values()]
                + [r["torch_imported"] for r in typer.worker_runs]),
            "served": engine.server.served,
            "n_chain_extensions": jobs, f"nw_jobs_on_{dev}": on_dev,
            "loci": {r.locus: [r.n_clusters, r.n_reads_used]
                     for r in res_s}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coverage", type=float, default=12.0)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.models.parallel_host import spawn_safe
    from hla_la_tpu_torch.sim import wgs_world

    card = bc.start(args.device)
    assert spawn_safe(), "the worker pool needs a file-backed __main__"
    root = os.path.join(CACHE, f"wgs_b{N_LEVELS}_c{args.coverage:g}")
    if args.fresh:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    world = wgs_world(CACHE, args.coverage, N_LEVELS)
    log(f"world ready in {time.time() - t0:.1f}s: {world.graph}")
    n_workers = min(os.cpu_count() or 1, MAX_WORKERS)
    st = stress_wgs(world, args.device, n_workers,
                    os.path.join(CACHE, "wgs_runs"))
    best_type = min(st["type_serial_s"], st["type_fanout_s"])
    log(f"e2e platinum-scale: "
        f"{2 * st['pairs'] / (st['align_s'] + best_type):.0f} reads/s")
    print("STRESS_WGS OK", flush=True)
    print(json.dumps({"coverage": args.coverage, "n_levels": world.n_levels,
                      "workers": n_workers, **st, "device": args.device,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
