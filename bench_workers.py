"""Worker-count sweep of the PyTorch/CUDA port's ``--action HLA`` on one
NVIDIA GPU: the IMGT-scale short-read world of chip_smoke.py's phase (e)
typed by the port's CLI with ``--maxThreads`` 4, 2 and 8 and then in one
process, all in one call so that the walls share a host and a card.

    python3 bench_workers.py [--workers 4,2,8]

Every run must put every NW job on the card and write every file of the
one-process run, byte for byte.  Prints the card's name and power limit,
then per run: align s, type s, the whole CLI's wall and the kernels'
launches (chip_smoke.report_run), and the seconds until the workers were
ready.  The kernels are built first, outside every timed run.
"""

from __future__ import annotations

import argparse
import os

import chip_smoke as c


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workers", default="4,2,8",
                    help="worker counts, run in this order before the "
                         "one-process run")
    args = ap.parse_args()
    from hla_la_tpu_torch import _build
    from hla_la_tpu_torch.device import resolve
    from hla_la_tpu_torch.sim import typing_world

    resolve("cuda")
    print(c.toolchain())
    _build.library()
    world = typing_world(c.WORLD_DIR)
    runs = os.path.join(c.WORLD_DIR, "runs")
    results = {}
    for n in [int(x) for x in args.workers.split(",")] + [1]:
        extra = ("--maxThreads", str(n)) if n > 1 else ()
        res = c.run_port("cuda", world, os.path.join(runs, f"sweep{n}"),
                         extra)
        results[n] = res
        c.report_run(f"{n} worker(s)" if n > 1 else "one process", res)
        if n > 1:
            ready = [r[0] for r in res["workers_ready"]]
            print(f"  {len(ready)} workers ready {min(ready):.1f}-"
                  f"{max(ready):.1f} s after the pool was made; K1 launches "
                  f"in the workers {res['worker_launches'].get('K1', 0)}")
    one = results.pop(1)
    for n, res in results.items():
        files = c.same_files(res["dir"], one["dir"], f"--maxThreads {n}")
        print(f"--maxThreads {n}: {files} files byte-equal to the one-process "
              f"run; whole CLI {res['wall_s']:.3f} s against "
              f"{one['wall_s']:.3f} s ({res['wall_s'] / one['wall_s']:.2f} "
              f"times), align {res['align_s']:.3f} against "
              f"{one['align_s']:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
