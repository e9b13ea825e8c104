"""Device-time profile of one run of the port's CLI.

  python -m hla_la_tpu_torch.profile_e2e [--trace trace.json] \\
      -- --action HLA --FASTQ1 R_1.fq --FASTQ2 R_2.fq --graph g ...

Runs the CLI once to warm up (kernel build, first launches, allocator),
then again under ``torch.profiler`` with CPU and CUDA activity.  Prints the
profiled run's wall time, the device time summed over every device event
(kernels, copies, memsets), the busy share (device time / wall; the port
launches on one stream, so events do not overlap), and the device time and
count per event name.  Then the port's spans (``utils/timing.py``; the
profiler turns them on): count, total and self seconds by span name, and
the seconds in which the device was idle by the innermost span open at the
time, with the ten longest idle gaps, the device's events placed on the
spans' clock through the anchor ``hla.clock``.  ``--trace`` writes the
Chrome trace with every span beside the device's events, this process's
and the worker processes', placed through the same anchor.

torch is imported inside the functions: a ``--maxThreads`` run's workers
re-import this module as their main module, and stay host-only only if it
imports no torch.
"""

from __future__ import annotations

import argparse
import sys
import time

from .cli import main as cli_main
from .utils import timing


def device_summary(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, count) per device event name (kernels, copies,
    memsets), largest first.  Host ops such as aten::copy_ are left out:
    their device time is that of the events they launched."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def device_events(prof) -> list[tuple[float, float, str]]:
    """(start s, end s, name) of each device event, on the profiler's
    time base."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def clock_offset(prof, records) -> tuple[float, float] | None:
    """timing.anchor_offset from the profiler's ``hla.clock`` event: the
    seconds to add to a profiler time to put it on the spans' clock, and
    the anchor's width; None without an anchor."""
    starts = [e.time_range.start / 1e6 for e in prof.events()
              if e.name == timing.ANCHOR]
    if not starts or not any(r.name == timing.ANCHOR for r in records):
        return None
    return timing.anchor_offset(records, starts[0])


def span_report(events, records, lo: float, hi: float) -> list[str]:
    """The span table and the idle seconds by innermost span, as printed
    lines; `events` (start s, end s, name) and [lo, hi] on the spans'
    clock."""
    lines = ["spans: count, total s, self s (children in the same "
             "thread left out)"]
    for name, n, total, own in timing.span_table(records):
        lines.append(f"{n:6d} {total:12.3f} {own:12.3f}  {name}")
    idle = timing.idle_by_span(events, records, lo, hi)
    lines.append("device idle s by innermost open span")
    lines += [f"{s:12.3f}  {name}" for name, s in idle["by_span"]]
    lines.append("longest idle gaps (s, innermost span at the middle)")
    lines += [f"{s:12.3f}  {name}" for name, s in idle["gaps"]]
    return lines


def add_spans_to_trace(path: str, records) -> int:
    """Write the spans into the Chrome trace at `path`, placed through the
    anchor's event in that trace; the number written."""
    import json
    import os
    with open(path) as fh:
        trace = json.load(fh)
    ev = trace["traceEvents"] if isinstance(trace, dict) else trace
    ts = [e["ts"] for e in ev if e.get("name") == timing.ANCHOR
          and e.get("ph") == "X"]
    anchor = [r for r in records if r.name == timing.ANCHOR]
    if not ts or not anchor:
        return 0
    off_us = float(ts[0]) - (anchor[0].t0 + anchor[0].t1) / 2e3
    added = [r for r in records if r.name != timing.ANCHOR]
    for pid in sorted({r.pid for r in added} - {os.getpid()}):
        ev.append({"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": f"worker process {pid}"}})
    ev += [{"ph": "X", "cat": "hla_span", "name": r.name, "pid": r.pid,
            "tid": r.tid % 2**31, "ts": r.t0 / 1e3 + off_us,
            "dur": (r.t1 - r.t0) / 1e3, "args": dict(r.attrs)}
           for r in added]
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return len(added)


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
        t1 = time.perf_counter()
    wall = t1 - t0
    if rc != 0:
        raise SystemExit("profiled run failed")
    rows = device_summary(prof)
    busy = sum(ms for _, ms, _ in rows) / 1e3
    print(f"profiled port run: wall {wall:.3f} s, device time {busy:.3f} s, "
          f"busy share {busy / wall:.4f}, idle share {1 - busy / wall:.4f}")
    for name, ms, n in rows:
        if ms > 0:
            print(f"{ms:12.3f} ms  x {n:5d}  {name[:90]}")
    records = timing.spans()
    offset = clock_offset(prof, records)
    if offset is not None:
        print(f"anchor {timing.ANCHOR}: width {offset[1] * 1e6:.1f} us")
        events = [(s + offset[0], e + offset[0], n)
                  for s, e, n in device_events(prof)]
        print("\n".join(span_report(events, records, t0, t1)))
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"{add_spans_to_trace(args.trace, records)} spans written "
              f"to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
