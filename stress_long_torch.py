#!/usr/bin/env python
"""Long-read (ONT) typing stress of the PyTorch/CUDA port at real-PRG
scale: the twin of stress_long.py.

    python3 stress_long_torch.py [--fresh] [--device cuda|cpu]

The package is bench.py's 3,000,000-level panel and the reads are
stress_long.py's (``hla_la_tpu_torch.sim.long_bench_reads``, which draws the
panel again and writes its package beside the reads): ONT-like unpaired
reads of log-normal length in [2 kb, 48 kb] at 25x over two 5% windows
around genes A and B of both planted haplotypes, with 0.5% insertions and
0.5% deletions, plus two reads of 60-90 kb per window and haplotype.  Both
are built once and cached under build/real_scale/ (``--fresh`` draws them
again).  Reads past 50 kb are
cut into 50 kb chunks as the CLI cuts them (``cli._split_long_reads``), and
the chunks go through the production path: ``run_hla_typing`` with
``RunConfig(long_reads="ont2d", max_threads=4)`` (the unpaired model, the
aligner's band of 256 on K2, alignment in 4 worker processes).

Checks, as stress_long.py's: splitting engaged on at least 4 reads over
50 kb, the planted alleles called at A and B, the per-base truth-level
accuracy over 0.9; also every NW job on the device.  Prints the card's name
and power limit first, then after the checks ``STRESS_LONG OK`` and one
JSON line: wall, peak RSS, chunks, Mb, K2 launches (made for the host-only
workers by this process's device server, and all of this process's) and
the longest NW job's L, and K3 launches.  The kernels are
built first, outside every timed window.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "real_scale")
N_LEVELS = 3_000_000
COVERAGE = 25.0
MIN_LONG = 4                    # reads over the split length, at least
ACCURACY_MIN = 0.9


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def stress_long(reads, device, out_dir: str) -> dict:
    """Split `reads` (a sim.LongBenchReads), type them on `device` through
    run_hla_typing in long-read mode with 4 workers into `out_dir`, and
    assert stress_long.py's checks.  Returns what the JSON line prints."""
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.cli import _split_long_reads
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.io.fastq import read_fastq
    from hla_la_tpu_torch.models.parallel_host import kernel_launches
    from hla_la_tpu_torch.models.pipeline import run_hla_typing
    from hla_la_tpu_torch.sim import (TrueReadLevels, load_levels,
                                      split_levels)
    from hla_la_tpu_torch.sim.worlds import LONG_SPLIT
    from hla_la_tpu_torch.utils.config import RunConfig

    fq = list(read_fastq(reads.fastq))
    lens = np.asarray([len(r.seq) for r in fq])
    log(f"{len(fq)} reads, {lens.sum() / 1e6:.1f} Mb, lengths p10/p50/p90 "
        f"= {np.percentile(lens, [10, 50, 90]).astype(int)}, max "
        f"{lens.max()}")
    n_xl = int((lens > LONG_SPLIT).sum())
    assert n_xl >= MIN_LONG, f"{n_xl} reads over {LONG_SPLIT} bases"
    split = _split_long_reads(fq, LONG_SPLIT)
    assert len(split) > len(fq), "splitting did not engage"
    log(f"split {n_xl} reads over {LONG_SPLIT} bases -> "
        f"{len(split) - len(fq)} extra chunks")
    truth = TrueReadLevels(split_levels(load_levels(reads.truth_levels)))

    pkg = GraphPackage(reads.graph)
    shutil.rmtree(out_dir, ignore_errors=True)
    bc.zero_launches()
    sink = io.StringIO()
    t0 = time.time()
    with bc.logged(sink):
        res = run_hla_typing(pkg, unpaired=split, output_dir=out_dir,
                             cfg=RunConfig(long_reads="ont2d",
                                           max_threads=4),
                             device=device, truth=truth)
    bc.sync(device)
    wall = time.time() - t0
    acc = truth.accuracy()
    here = kernel_launches()
    text = sink.getvalue()
    log(f"e2e (align + type, production path): {wall:.1f}s, peak RSS "
        f"{bc.rss_gb():.2f} GB, truth per-base level accuracy {acc:.4f} "
        f"over {truth.total / 1e6:.1f}M bases")

    calls = {r.locus: (r.allele1_id, r.allele2_id) for r in res.results}
    log(f"calls: {calls}")
    for locus, planted in reads.truth.items():
        got = {a for aid in calls[locus] for a in aid.split(";")}
        assert set(planted) <= got, (locus, planted, got)
    assert acc > ACCURACY_MIN, f"long-read truth accuracy {acc:.4f}"
    assert os.path.exists(os.path.join(out_dir, "hla",
                                       "R1_parameters.txt"))
    dev = str(device).split(":")[0]
    jobs = bc.counter(text, "n_chain_extensions")
    on_dev = bc.counter(text, f"nw_jobs_on_{dev}")
    assert jobs > 0 and on_dev == jobs, \
        f"{on_dev} of {jobs} NW jobs ran on {dev}"
    workers = "aligning with 4 worker processes" in text
    k2_workers = bc.counter(text, "served_launches_K2")
    assert dev != "cuda" or here["K2"] > 0, "K2 never launched"
    return {"wall_s": wall, "peak_rss_gb": bc.rss_gb(), "reads": len(fq),
            "reads_over_split": n_xl, "chunks": len(split),
            "mb": float(lens.sum() / 1e6), "truth_accuracy": acc,
            "align_workers": 4 if workers else 0,
            "launches_workers": {"K2": k2_workers},
            # the host-only workers (ready and after their last task) and
            # what the device server ran for them, from the run's log
            "workers_cuda_initialized": [
                c == "True" for c in bc.worker_lines(text)["workers_cuda"]],
            "workers_torch_imported": [
                c == "True" for c in bc.worker_lines(text)["workers_torch"]],
            "served": bc.worker_lines(text)["server"],
            "launches_parent": {"K2": here["K2"], "K3": here["K3"]},
            # an unpaired read's NW jobs each span the whole read
            # (ReadAligner._make_jobs), so the longest job is the longest
            # chunk that went to the aligner
            "longest_nw_job_L": max(len(r.seq) for r in split),
            "n_chain_extensions": jobs, f"nw_jobs_on_{dev}": on_dev,
            "calls": calls,
            "loci": {r.locus: [r.n_clusters, r.n_reads_used]
                     for r in res.results}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.sim import long_bench_reads

    card = bc.start(args.device)
    t0 = time.time()
    if args.fresh:
        shutil.rmtree(os.path.join(CACHE, f"bench_b{N_LEVELS}_long_c"
                                          f"{COVERAGE:g}"), ignore_errors=True)
    reads = long_bench_reads(CACHE, N_LEVELS, COVERAGE)
    log(f"package and reads ready in {time.time() - t0:.1f}s: {reads.fastq}")
    st = stress_long(reads, args.device, os.path.join(CACHE, "long_run"))
    log(f"SUMMARY: {st['chunks']} chunks ({st['mb']:.1f} Mb), e2e "
        f"{st['wall_s']:.1f}s, accuracy {st['truth_accuracy']:.4f}, exact "
        f"calls at both loci, peak RSS {st['peak_rss_gb']:.2f} GB")
    print("STRESS_LONG OK", flush=True)
    print(json.dumps({"n_levels": N_LEVELS, "coverage": COVERAGE, **st,
                      "device": args.device, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
