"""Worker-count sweep of the PyTorch/CUDA port's ``--action HLA`` on one
NVIDIA GPU: the IMGT-scale short-read world of chip_smoke.py's phase (e)
typed by the port's CLI with ``--maxThreads`` 4, 2 and 8 and then in one
process, all in one call so that the walls share a host and a card.

    python3 bench_workers.py [--workers 4,2,8] [--tree DIR]
    python3 bench_workers.py --imports

The workers are host-only: this process's device server runs their NW
calls on the card.  Every run must put every NW job on the card and write
every file of the one-process run, byte for byte.  Prints the card's name
and power limit, then per run: align s, type s, the whole CLI's wall, the
kernels' launches in this process, each worker's seconds until it was
ready, the most CUDA contexts nvidia-smi listed while the pool was up, and
the seconds this process spent unpickling what came through its
connections (the pool's results, in the pool's result thread beside the
device server's thread) and joining the chunks.  The kernels are built
first, outside every timed run.  ``--tree DIR`` measures the port of
another checkout (a parent commit unpacked there) the same way, to compare
two commits in one call: only its CLI is called, and only lines that both
trees log are read.
``--imports`` times what a process pays before it works, in fresh
processes, one and four at once: the interpreter, numpy, ``import torch``,
the port's CLI with torch blocked (what a host-only worker imports), and
torch with a CUDA context.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import shutil
import subprocess
import sys
import time

import chip_smoke as c

DEVICE = "cuda"     # every run's; a rehearsal on the CPU sets "cpu"


@contextlib.contextmanager
def parent_unpack_timer():
    """Seconds this process spends unpickling what comes through its
    connections (the pool's results; the device server's small request
    headers) and in PackedAlignedPairs.from_chunks while the block runs."""
    import multiprocessing.connection as connection

    from hla_la_tpu_torch.models import parallel_host as ph

    spent = {"unpickle_s": 0.0, "from_chunks_s": 0.0}
    pickler = connection._ForkingPickler
    from_chunks = ph.PackedAlignedPairs.from_chunks.__func__

    def loads(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return pickler.loads(*args, **kwargs)
        finally:
            spent["unpickle_s"] += time.perf_counter() - t0

    def timed_from_chunks(cls, packs):
        t0 = time.perf_counter()
        try:
            return from_chunks(cls, packs)
        finally:
            spent["from_chunks_s"] += time.perf_counter() - t0

    connection._ForkingPickler = type("TimedPickler", (pickler,),
                                      {"loads": staticmethod(loads)})
    ph.PackedAlignedPairs.from_chunks = classmethod(timed_from_chunks)
    try:
        yield spent
    finally:
        connection._ForkingPickler = pickler
        ph.PackedAlignedPairs.from_chunks = classmethod(from_chunks)


IMPORTS = {
    "the interpreter": "pass",
    "numpy": "import numpy",
    "torch": "import torch",
    "the port's CLI, torch blocked": (
        "import sys; sys.modules['torch'] = None; "
        "import hla_la_tpu_torch.cli, hla_la_tpu_torch.models.parallel_host"),
    "torch and a CUDA context": (
        "import torch; torch.zeros(1, device='cuda'); "
        "torch.cuda.synchronize()"),
}


def time_imports() -> None:
    """Seconds from start to exit of fresh processes that run each of
    IMPORTS, one alone and four at once."""
    for n in (1, 4):
        for what, code in IMPORTS.items():
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, "-c", code])
                     for _ in range(n)]
            if any(p.wait() for p in procs):
                c.fail(f"{what}: a process failed")
            print(f"{n} process(es): {what} {time.perf_counter() - t0:.2f} s")


def run(world, out_dir: str, n: int) -> dict:
    """The CLI on `world` with `n` workers (1: one process), its log read
    for what every tree logs."""
    from hla_la_tpu_torch.cli import main as port_main
    from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--action", "HLA", *world.cli_args(), "--graph", world.graph,
            "--sampleID", "S1", "--outputDirectory", out_dir, "--device",
            DEVICE] + (["--maxThreads", str(n)] if n > 1 else [])
    banded_nw_cuda.launches = pair_ll_diff_cuda.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    watch = (c.compute_apps_watch() if DEVICE == "cuda"
             else contextlib.nullcontext({"before": [], "most": 0}))
    with parent_unpack_timer() as spent, watch as apps, \
            c.captured_stderr(log):
        rc = port_main(argv)
    if DEVICE == "cuda":
        c.sync()
    wall = time.perf_counter() - t0
    text = log.getvalue()
    m_al = re.search(r"aligned \d+/(\d+) pairs .* in ([0-9.]+) s on", text)
    m_ty = re.search(r"typed \d+ loci in ([0-9.]+) s", text)
    jobs = re.search(r"n_chain_extensions: (\d+)", text)
    on_card = re.search(rf"nw_jobs_on_{DEVICE}: (\d+)", text)
    if rc != 0 or not (m_al and m_ty and jobs and on_card) \
            or jobs.group(1) != on_card.group(1):
        c.fail(f"{n} worker(s): rc {rc}, not every NW job on {DEVICE}")
    return {"dir": out_dir, "wall_s": wall, "pairs": int(m_al.group(1)),
            "align_s": float(m_al.group(2)), "type_s": float(m_ty.group(1)),
            "nw_jobs": int(jobs.group(1)),
            "launches": {"K1": banded_nw_cuda.launches,
                         "K3": pair_ll_diff_cuda.launches},
            "ready_s": sorted(float(x) for x in re.findall(
                r"alignment worker \d+ ready\D.*? ([0-9.]+) s after the pool "
                r"was made", text)),
            "contexts": (len(apps["before"]), apps["most"]),
            "ready_lines": [line.split("] ", 1)[-1]
                            for line in text.splitlines()
                            if re.search(r"alignment worker \d+ ready", line)],
            **spent}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workers", default="4,2,8",
                    help="worker counts, run in this order before the "
                         "one-process run")
    ap.add_argument("--tree", default=None,
                    help="the checkout whose hla_la_tpu_torch runs "
                         "(default: this one)")
    ap.add_argument("--imports", action="store_true",
                    help="time the imports alone, then stop")
    args = ap.parse_args()
    if args.imports:
        print(c.toolchain())
        time_imports()
        return 0
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    from hla_la_tpu_torch import _build
    from hla_la_tpu_torch.device import resolve
    from hla_la_tpu_torch.sim import typing_world

    resolve("cuda")
    print(c.toolchain())
    print(f"the port of {os.path.dirname(os.path.abspath(_build.__file__))}")
    _build.library()
    world = typing_world(c.WORLD_DIR)
    tag = "parent" if args.tree else "this"
    runs = os.path.join(c.WORLD_DIR, "runs")
    results = {}
    for n in [int(x) for x in args.workers.split(",")] + [1]:
        res = run(world, os.path.join(runs, f"sweep_{tag}{n}"), n)
        results[n] = res
        print(f"{n} worker(s): align {res['align_s']:.3f} s, type "
              f"{res['type_s']:.3f} s, whole CLI {res['wall_s']:.3f} s; "
              f"{res['nw_jobs']} NW jobs, all on the card; launches here "
              f"{res['launches']}; unpickled the pool's results for "
              f"{res['unpickle_s']:.3f} s, joined the chunks in "
              f"{res['from_chunks_s']:.3f} s")
        if n > 1:
            print(f"  {len(res['ready_s'])} workers ready {res['ready_s']} s "
                  f"after the pool was made; nvidia-smi listed "
                  f"{res['contexts'][0]} context(s) before the pool, at most "
                  f"{res['contexts'][1]} while it was up:\n    "
                  + "\n    ".join(res["ready_lines"]))
    one = results.pop(1)
    for n, res in results.items():
        files = c.same_files(res["dir"], one["dir"], f"--maxThreads {n}")
        print(f"--maxThreads {n}: {files} files byte-equal to the one-process "
              f"run; whole CLI {res['wall_s']:.3f} s against "
              f"{one['wall_s']:.3f} s ({res['wall_s'] / one['wall_s']:.2f} "
              f"times), align {res['align_s']:.3f} against "
              f"{one['align_s']:.3f} s, type {res['type_s']:.3f} against "
              f"{one['type_s']:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
