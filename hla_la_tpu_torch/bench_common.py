"""What the real-scale twins (``bench_torch.py``, ``stress_wgs_torch.py``,
``stress_long_torch.py``) and the smoke run share: the card's name and
power limit, process CPU time and peak memory, the kernels built before any
timed window, the launch counters of this process zeroed, and the run's log
caught while it is still echoed."""

from __future__ import annotations

import contextlib
import io
import re
import resource
import subprocess
import sys

import torch

from .device import resolve


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if resolve(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def start(device) -> str:
    """Resolve `device`, print the card's line (first, on stdout) and build
    the kernels there, outside every timed window.  Returns the line."""
    dev = resolve(device)
    line = card_line(dev)
    print(line, flush=True)
    if dev.type == "cuda":
        from . import _build
        _build.library()
    return line


def cpu_now() -> float:
    """Process CPU seconds, self and reaped children (utime + stime): a
    pool's workers count only once they are reaped, so for a live pool this
    is the parent's work."""
    a = resource.getrusage(resource.RUSAGE_SELF)
    b = resource.getrusage(resource.RUSAGE_CHILDREN)
    return a.ru_utime + a.ru_stime + b.ru_utime + b.ru_stime


def rss_gb() -> float:
    """Peak resident memory of this process in GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _wrappers() -> dict:
    from .ops.cuda_nw import banded_nw_cuda
    from .ops.cuda_nw_long import banded_nw_long_cuda
    from .ops.cuda_pair import pair_ll_diff_cuda
    return {"K1": banded_nw_cuda, "K2": banded_nw_long_cuda,
            "K3": pair_ll_diff_cuda}


def zero_launches() -> None:
    """Set every kernel wrapper's launch count in this process to 0, and
    forget its largest launch."""
    for fn in _wrappers().values():
        fn.launches = 0
        fn.largest = (0,) * len(fn.largest)


def largest_launches() -> dict:
    """Kernel -> the shape of its launch with the most cells in this
    process since the counts were zeroed ([B, L, W] of K1 and K2, [C, R]
    of K3), for the kernels launched."""
    return {k: list(fn.largest[1:]) for k, fn in _wrappers().items()
            if fn.largest[0]}


class Tee(io.TextIOBase):
    """A text stream that writes to each of `streams`."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


@contextlib.contextmanager
def logged(sink: io.StringIO):
    """What this process writes to sys.stderr goes into `sink` too (the
    run's statistics, with the workers' counters summed, are logged here)."""
    with contextlib.redirect_stderr(Tee(sys.stderr, sink)):
        yield


def counter(log: str, key: str) -> int:
    """The last value logged for statistics counter `key` (0 if none)."""
    found = re.findall(rf"^\s*{re.escape(key)}: (\d+)$", log, re.M)
    return int(found[-1]) if found else 0


def worker_lines(text: str) -> dict:
    """What a run's log says of its alignment workers and of the device
    server that ran their device calls: each worker's ready split
    (seconds after the pool was made; process start and imports, the
    connection to the server, package and aligner), pid, whether it had
    imported torch and its CUDA state when ready, and both again after its
    last task, the NW jobs they
    sent, and the server's own count of requests, NW jobs and launches."""
    ready = re.findall(
        r"alignment worker (\d+) ready, host-only, served on \S+ ([0-9.]+) "
        r"s after the pool was made: process start and imports ([0-9.]+) "
        r"s, connection to the device server ([0-9.]+) s, package and "
        r"aligner ([0-9.]+) s; torch imported: (\w+), CUDA initialised: "
        r"(\w+)", text)
    server = re.search(
        r"device server on \S+: (\d+) requests from (\d+) workers, (\d+) "
        r"NW jobs, launches K1 (\d+), K2 (\d+), K3 (\d+)", text)
    jobs = re.search(r"served_nw_jobs: (\d+)", text)
    return {
        "workers_ready": [tuple(float(x) for x in m[1:5]) for m in ready],
        "worker_pids": [int(m[0]) for m in ready],
        "workers_torch": [m[5] for m in ready] + re.findall(
            r"after its last task \(torch imported: (\w+)\)", text),
        "workers_cuda": [m[6] for m in ready] + re.findall(
            r"alignment worker \d+: CUDA initialised (\w+) after its last "
            r"task", text),
        "served_nw_jobs": int(jobs.group(1)) if jobs else 0,
        "server": ({"requests": int(server.group(1)),
                    "workers": int(server.group(2)),
                    "nw_jobs": int(server.group(3)),
                    "launches": dict(zip(("K1", "K2", "K3"),
                                         map(int, server.groups()[3:])))}
                   if server else None)}


def sync(device) -> None:
    if resolve(device).type == "cuda":
        torch.cuda.synchronize()
