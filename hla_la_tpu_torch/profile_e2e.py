"""Device-time profile of one run of the port's CLI.

  python -m hla_la_tpu_torch.profile_e2e [--trace trace.json] \\
      -- --action HLA --FASTQ1 R_1.fq --FASTQ2 R_2.fq --graph g ...

Runs the CLI once to warm up (kernel build, first launches, allocator),
then again under ``torch.profiler`` with CPU and CUDA activity.  Prints the
profiled run's wall time, the device time summed over every device event
(kernels, copies, memsets), the busy share (device time / wall; the port
launches on one stream, so events do not overlap), and the device time and
count per event name; writes the Chrome trace to ``--trace``.

torch is imported inside the functions: a ``--maxThreads`` run's workers
re-import this module as their main module, and stay host-only only if it
imports no torch.
"""

from __future__ import annotations

import argparse
import sys
import time

from .cli import main as cli_main


def device_summary(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, count) per device event name (kernels, copies,
    memsets), largest first.  Host ops such as aten::copy_ are left out:
    their device time is that of the events they launched."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(prog="hla_la_tpu_torch.profile_e2e")
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args(argv[:cut])
    cli_argv = argv[cut + 1:]      # the CLI's default device is cuda

    if cli_main(cli_argv) != 0:
        raise SystemExit("warm-up run failed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli_main(cli_argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit("profiled run failed")
    rows = device_summary(prof)
    busy = sum(ms for _, ms, _ in rows) / 1e3
    print(f"profiled port run: wall {wall:.3f} s, device time {busy:.3f} s, "
          f"busy share {busy / wall:.4f}, idle share {1 - busy / wall:.4f}")
    for name, ms, n in rows:
        if ms > 0:
            print(f"{ms:12.3f} ms  x {n:5d}  {name[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
