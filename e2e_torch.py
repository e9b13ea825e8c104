#!/usr/bin/env python
"""One recorded end-to-end run of the PyTorch/CUDA port on the card: the
twin of tpu_e2e.py.

    python3 e2e_torch.py [--out build/e2e_torch.json] [--force]
        [--device cuda|cpu]

First the health gate: ``hla_la_tpu_torch.gpu_check.run`` holds K1 to its
plain version on the card and times it (exit 1 on a parity failure; exit 2
when the card reads DEGRADED, unless ``--force``, which records the run
with its timings marked as taken on a degraded card).  Then the full
pipeline (``run_hla_typing``: align + type) on tpu_e2e.py's small world
(``sim.e2e_world``: a 20,000-level panel of 6 haplotypes, paired 100 bp
reads at 20x along haplotypes 1 and 2, ~4,000 pairs) three times: on the
CPU (the plain kernels, the port's host run), then on the device cold and
warm.  The calls must be identical and Q1 within 1e-3.  Last, the pair
reduction K3 at PAIR_SHAPE (C = 2,200, R = 16,384, the IMGT-scale working
point), its input moved to the device once, timed cold and warm (CUDA
events on the card).

Prints the card's name and power limit first and the record as one JSON
line last; the record also goes to ``--out``.  With ``--device cpu`` the
gate is not run (it needs a card) and every run is on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "e2e_torch")
BACKBONE = 20_000
PAIR_SHAPE = (2200, 16384)
Q_TOL = 1e-3


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def health_gate(force: bool) -> tuple[int, dict]:
    """(exit code, what the record keeps) of the GPU probe: 0 to go on."""
    from hla_la_tpu_torch import gpu_check
    buf = io.StringIO()
    stats: dict = {}
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = gpu_check.run(stats=stats)
    out = buf.getvalue().strip()
    log(f"gpu_check ({time.time() - t0:.0f}s): {out}")
    keep = {"chip_health": out, "kernel_gcells_per_s": stats.get("gcells"),
            "forced_on_degraded_chip": False}
    if rc != 0:
        log("kernel parity FAILED — aborting")
        return 1, keep
    if not stats.get("healthy"):
        if not force:
            log("card DEGRADED — run again later (exit 2)")
            return 2, keep
        log("card DEGRADED but --force given: recording a correctness-only "
            "run (timings taken on a degraded card)")
        keep["forced_on_degraded_chip"] = True
    return 0, keep


def pair_timing(device) -> dict:
    """K3 at PAIR_SHAPE on L moved to `device` once: cold and warm times
    (CUDA events on a card, the host clock on the CPU) and Gcells/s."""
    import torch

    from hla_la_tpu_torch.device import to_device
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda
    from hla_la_tpu_torch.ops.pair_ll import _pair_ll_diff
    C, R = PAIR_SHAPE
    L = np.random.default_rng(0).normal(-40, 8, (C, R)).astype(np.float32)
    Ld = to_device(L, device)
    on_card = Ld.is_cuda

    def once() -> float:
        if not on_card:
            t0 = time.time()
            _pair_ll_diff(Ld)
            return time.time() - t0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        _pair_ll_diff(Ld)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    before = pair_ll_diff_cuda.launches
    cold = once()
    warm = once()
    rec = {"pair_C": C, "pair_R": R, "pair_cold_s": cold, "pair_s": warm,
           "pair_launches": pair_ll_diff_cuda.launches - before,
           "pair_gcells_per_s": C * C * R / warm / 1e9,
           "pair_timed_by": "CUDA events" if on_card else "host clock"}
    log(f"IMGT-scale C^2 on {device} (C={C}, R={R}): {warm:.4f}s = "
        f"{rec['pair_gcells_per_s']:.1f} Gcells/s (cold {cold:.4f}s)")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "e2e_torch.json"))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.io.fastq import read_fastq
    from hla_la_tpu_torch.models.parallel_host import kernel_launches
    from hla_la_tpu_torch.models.pipeline import run_hla_typing
    from hla_la_tpu_torch.sim import e2e_world

    card = bc.start(args.device)
    gate = {"chip_health": "not run (no card: --device cpu)",
            "kernel_gcells_per_s": None, "forced_on_degraded_chip": False}
    if args.device == "cuda":
        rc, gate = health_gate(args.force)
        if rc:
            return rc

    world = e2e_world(CACHE, BACKBONE)
    fq = list(zip(read_fastq(world.fastq1), read_fastq(world.fastq2)))
    pkg = GraphPackage(world.graph)
    log(f"world: {BACKBONE} levels, {len(fq)} pairs")
    out_root = os.path.join(CACHE, "runs")
    walls, results = {}, {}
    bc.zero_launches()
    for tag, device in (("host", "cpu"), ("device_cold", args.device),
                        ("device_warm", args.device)):
        t0 = time.time()
        results[tag] = run_hla_typing(
            pkg, pairs=fq, output_dir=os.path.join(out_root, tag),
            device=device).results
        bc.sync(device)
        walls[tag] = time.time() - t0
        log(f"{tag} e2e on {device}: {walls[tag]:.3f}s")

    # the device runs' kernel launches (the host run launches none)
    launches, largest = kernel_launches(), bc.largest_launches()
    calls = {tag: sorted((r.locus, r.allele1_id, r.allele2_id) for r in res)
             for tag, res in results.items()}
    assert calls["host"] == calls["device_cold"] == calls["device_warm"], \
        f"host vs device calls differ: {calls}"
    dq = max(abs(getattr(a, q) - getattr(b, q))
             for tag in ("device_cold", "device_warm")
             for a, b in zip(results["host"], results[tag])
             for q in ("q1_allele1", "q1_allele2"))
    assert dq <= Q_TOL, f"Q1 host vs device differ by {dq}"
    log(f"calls identical host vs device: {calls['host']}; max |dQ1| {dq:.3g}")

    record = {
        "date": time.strftime("%Y-%m-%d %H:%M"), **gate,
        "world": {"levels": BACKBONE, "pairs": len(fq),
                  "loci": len(world.truth)},
        "host_e2e_s": walls["host"],
        "device_e2e_cold_s": walls["device_cold"],
        "device_e2e_warm_s": walls["device_warm"],
        "reads_per_s_device_warm": 2 * len(fq) / walls["device_warm"],
        "calls_identical": True, "max_abs_dq1": dq,
        "launches_device_runs": launches, "largest_launches": largest,
        "calls": [list(c) for c in calls["device_warm"]],
        "note": "a small world: host stages (seeding, backtrace, typing) "
                "take most of each run's wall on every device; this records "
                "correctness and the kernel's speed, not peak throughput",
        **pair_timing(args.device),
        "device": args.device, "card": card,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    log(f"recorded -> {args.out}")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
