"""One run of one cell: set-up, the measured window, the check, the result.

Set-up is everything before the window's first sample: imports and the
CUDA context, the kernels from the port's build cache, the port's host
library (built on a checkout's first run, before the warm-up, so that the
warm-up's pace leaves the build out), the configuration's installed panel
(built on a checkout's first run), the graph package loaded once, one
warm-up sample that is not counted, and the window's samples drawn from
``--seed``: ``HEADROOM`` times as many as the window holds at the
warm-up's pace.  The window is a closed loop: one lab
pipeline typing one sample after another through ``run_hla_typing``, a
new sample started while less than ``--seconds`` have passed; it ends
when the last sample finishes.  A window that uses up its samples before
``--seconds`` gives no result.  Each sample types into a directory of its
own under the run's ``TMPDIR``, removed after it.  A configuration with
``long_reads`` types unpaired long reads: each sample's reads are cut by
the port's own ``cli._split_long_reads`` at its own length (50 kb,
HLA-LA.pl:503-524) inside the sample's time, as the CLI cuts them, and
typed with ``RunConfig(long_reads=...)``.
"""

from __future__ import annotations

import io
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from multiprocessing import resource_tracker

import torch

from . import check, panel as panel_mod, probes as probes_mod
from . import reads as reads_mod, trace as trace_mod
from .spec import Bench

ALIGNED = re.compile(r"aligned \d+/\d+ pairs .* in ([0-9.]+) s on ")
TYPED = re.compile(r"typed \d+ loci in ([0-9.]+) s on ")
BLOCKED = ("jax", "jaxlib", "flax", "hla_la_tpu")


class NoCard(RuntimeError):
    pass


class OutOfSamples(RuntimeError):
    """The window needed more samples than set-up drew: no result."""


# samples drawn: enough for window samples this many times faster than
# the warm-up.  The warm-up carries every first call's cost: on one H100 a
# 1.6-1.7 s imgt2-wgs30x-1proc sample took 3.6 s as the warm-up, past
# what twice its pace left room for
HEADROOM = 3.0


def samples_needed(seconds: float, warm_s: float) -> int:
    """Samples to draw for a window of `seconds` after a warm-up sample
    of `warm_s`."""
    return math.ceil(HEADROOM * seconds / max(warm_s, 1e-3))


class LogTap(io.TextIOBase):
    """``sys.stderr`` while the harness runs: passes every line on and
    keeps each with the time it was written."""

    def __init__(self, out):
        self.out = out
        self.lines: list[tuple[float, str]] = []

    def write(self, s: str) -> int:
        self.out.write(s)
        if s.strip():
            self.lines.append((time.perf_counter(), s))
        return len(s)

    def flush(self) -> None:
        self.out.flush()


def process_age_s() -> float:
    """Seconds since this process started (/proc)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def children() -> list[int]:
    """Pids whose parent is this process."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                if int(fh.read().rsplit(")", 1)[1].split()[1]) == me:
                    out.append(int(d))
        except (OSError, ValueError, IndexError):
            continue
    return out


def reap(timeout_s: float = 30.0) -> list[int]:
    """Stop multiprocessing's resource tracker, wait for every child to
    end, and end any left after `timeout_s`; the pids that had to be
    ended."""
    tracker = getattr(resource_tracker, "_resource_tracker", None)
    if tracker is not None and hasattr(tracker, "_stop"):
        tracker._stop()
    deadline = time.monotonic() + timeout_s
    ended = []
    while True:
        left = children()
        for pid in left:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                done = pid
            if done:
                left.remove(pid)
        if not left:
            return ended
        if time.monotonic() > deadline:
            for pid in left:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            return left
        time.sleep(0.1)


def _phases(lines, t0: float, t1: float, align_s, type_s):
    """(start, end, name) of a sample's host phases, from the times of its
    "aligned" and "typed" lines."""
    t_a = next((t for t, s in reversed(lines) if ALIGNED.search(s)), None)
    t_t = next((t for t, s in reversed(lines) if TYPED.search(s)), None)
    if t_a is None or t_t is None:
        return [(t0, t1, "sample")]
    return [(t0, t_a - align_s, "prepare: aligner, insert size, pool start"),
            (t_a - align_s, t_a, "align"),
            (t_a, t_t - type_s, "alignment statistics"),
            (t_t - type_s, t_t, "type and write"),
            (t_t, t1, "pool close")]


def _last(regex, lines):
    for _, s in reversed(lines):
        m = regex.search(s)
        if m:
            return float(m.group(1))
    return None


class Cell:
    """A cell set up for typing: its files, the card (unless `device` is
    cpu), the port's kernels and entry point, the installed panel, the
    graph package loaded once, and the probes in the port's place.
    Raises NoCard when `device` is cuda and the cell's cards are not
    there."""

    def __init__(self, workload: str, checkout: str, device: str = "cuda",
                 bench_dir: str | None = None):
        self.bench = Bench(checkout, *([bench_dir] if bench_dir else []))
        self.cell = self.bench.workload(workload)
        self.cfg, cfg_path = self.bench.config(self.cell["config"])
        self.traffic = self.bench.traffic(self.cell["traffic"])
        self.limits = self.bench.limits(self.cell["name"])
        self.device = device
        if device == "cuda":
            if not torch.cuda.is_available():
                raise NoCard("torch.cuda.is_available() is False")
            if torch.cuda.device_count() < int(self.cell["chips"]):
                raise NoCard(f"{torch.cuda.device_count()} card(s), the "
                             f"cell asks for {self.cell['chips']}")
            torch.cuda.init()
            from hla_la_tpu_torch import _build
            _build.library()
        from hla_la_tpu_torch import native
        native.available()
        from hla_la_tpu_torch.graph.package import GraphPackage
        from hla_la_tpu_torch.utils.config import RunConfig
        inst = panel_mod.ensure_installed(cfg_path, self.cfg,
                                          panel_mod.cache_root(checkout))
        self.panel = panel_mod.load_panel(inst)
        self.pkg = GraphPackage(os.path.join(inst, "pkg"))
        self.rcfg = RunConfig(graph_dir=self.pkg.dir, sample_id="S1",
                              max_threads=int(self.traffic["max_threads"]),
                              long_reads=self.cfg.get("long_reads", ""))
        self.probes = probes_mod.Probes()

    def sample(self, seed: int, index: int):
        return reads_mod.draw_sample(self.panel, self.cfg, self.traffic,
                                     seed, index)

    def type_sample(self, sample):
        """run_hla_typing on `sample`, its long reads cut first, into a
        directory of the run's TMPDIR that is removed after it."""
        from hla_la_tpu_torch.io.fastq import FastqRead
        from hla_la_tpu_torch.models.pipeline import run_hla_typing
        pairs = [(FastqRead(n, a, qa), FastqRead(n, b, qb))
                 for n, a, qa, b, qb in zip(sample.names, sample.seq1,
                                            sample.qual1, sample.seq2,
                                            sample.qual2)]
        unpaired = [FastqRead(n, s, q) for n, s, q in zip(
            sample.u_names, sample.u_seq, sample.u_qual)]
        if unpaired:
            from hla_la_tpu_torch.cli import _split_long_reads
            unpaired = _split_long_reads(unpaired)
        out = tempfile.mkdtemp(prefix="hlabench_",
                               dir=tempfile.gettempdir())
        try:
            return run_hla_typing(self.pkg, pairs, unpaired, out, self.rcfg,
                                  device=self.device)
        finally:
            shutil.rmtree(out, ignore_errors=True)

    def sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def close(self) -> None:
        """The program's state goes, before the reference runs on the
        card."""
        self.probes.remove()
        self.pkg = None
        if self.device == "cuda":
            torch.cuda.empty_cache()


def calls_of(sample, res) -> dict:
    return {"truth": sample.truth,
            "called": {r.locus: [r.allele1_id, r.allele2_id]
                       for r in res.results}}


def run(workload: str, seed: int, seconds: float, traced: bool,
        checkout: str, device: str = "cuda", bench_dir: str | None = None
        ) -> dict:
    """One run; the result's fields, ``checks`` last."""
    t_start = time.perf_counter() - process_age_s()
    cell = Cell(workload, checkout, device, bench_dir)
    bench, probes = cell.bench, cell.probes
    tap = LogTap(sys.stderr)
    type_sample, sync = cell.type_sample, cell.sync

    real_stderr, sys.stderr = sys.stderr, tap
    try:
        t0 = time.perf_counter()
        type_sample(cell.sample(seed, 0))       # warm-up, not counted
        sync()
        samples = [cell.sample(seed, i) for i in range(
            1, samples_needed(seconds, time.perf_counter() - t0) + 1)]
        # the window's first sample (drawn from the seed, as every sample
        # is) is compared launch by launch; every sample's calls are
        cap = probes_mod.Capture(seed)
        records, calls, attempted, failed = [], [], 0, 0
        tracer = None
        if traced:
            probes.set_timing(True)
            tracer = trace_mod.Traced(device)
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        for sample in samples:
            if time.perf_counter() - t_w0 >= seconds:
                break
            attempted += 1
            probes.set_capture(cap if sample.index == 1 else None)
            mark = len(tap.lines)
            t0 = time.perf_counter()
            try:
                res = type_sample(sample)
                ok = True
            except Exception:       # noqa: BLE001 -- a failed sample
                failed += 1
                ok, res = False, None
                traceback.print_exc()
            sync()
            t1 = time.perf_counter()
            probes.set_capture(None)
            lines = tap.lines[mark:]
            align_s, type_s = _last(ALIGNED, lines), _last(TYPED, lines)
            records.append({"index": sample.index, "ok": ok,
                            "wall_s": t1 - t0, "align_s": align_s,
                            "type_s": type_s, "t0": t0, "t1": t1,
                            "lines": lines})
            if ok:
                calls.append(calls_of(sample, res))
        window_s = time.perf_counter() - t_w0
        if attempted == len(samples) and window_s < seconds:
            probes.remove()
            raise OutOfSamples(
                f"the {len(samples)} samples drawn from the warm-up's wall "
                f"were used up {window_s:.1f} s into a window of {seconds} s")
        if tracer is not None:
            tracer.stop()
            probes.set_timing(False)
        peak = (int(torch.cuda.max_memory_allocated()) if device == "cuda"
                else 0)
    finally:
        sys.stderr = real_stderr
    done = sum(r["ok"] for r in records)
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": {
                  "platform": "gpu" if device == "cuda" else device,
                  "kind": (torch.cuda.get_device_name(0)
                           if device == "cuda" else "cpu"),
                  "count": int(cell.cell["chips"]),
                  "memory_peak_bytes": peak}}
    if traced:
        record = _traced_record(records, window_s, t_w0, tracer, probes,
                                device)
        result["device"]["busy_s"] = record["busy_s"]
        result["device"]["window_s"] = window_s
        result["breakdown"] = record.pop("breakdown")
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"]).read(record)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
    else:
        e2e = end_to_end(window_s, done, setup_s)
        for m in bench.end_to_end(workload):
            if e2e.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}
    del samples, records, type_sample
    cell.close()
    t_check = time.perf_counter()
    found = check.numbers(cap.k1, cap.k3, calls, device=device, ll=cap.ll,
                          k2=cap.k2)
    print(f"the check took {time.perf_counter() - t_check:.3f} s; K2's "
          f"reference {found['k2_reference_s']:.3f} s on "
          f"{found['k2_jobs_compared']} jobs of {cap.k2_launches} launches"
          f", up to {max((j['len'] for j in cap.k2), default=0)} rows",
          file=sys.stderr)
    ok, rows = check.judge(found, cell.limits)
    result["correct"] = bool(ok and failed == 0 and done > 0)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result


def end_to_end(window_s: float, done: int, setup_s: float) -> dict:
    """sample_s: the window's seconds over the samples it completed."""
    return {"sample_s": window_s / done if done else None,
            "setup_s": setup_s}


def _traced_record(records, window_s, t_w0, tracer, probes, device):
    """What the per-layer readers read: the samples, the device's busy
    seconds, each K1/K2/K3 launch's shape and device seconds."""
    events = tracer.device_events()
    lo = t_w0 - tracer.t0
    hi = lo + window_s
    phases = []
    for r in records:
        for a, b, name in _phases(r["lines"], r["t0"], r["t1"],
                                  r["align_s"] or 0.0, r["type_s"] or 0.0):
            phases.append((a - tracer.t0, b - tracer.t0, name))
    launches = {k: [(*shape, s.elapsed_time(e) / 1e3)
                    for shape, (s, e) in p.timed]
                for k, p in (("K1", probes.k1), ("K2", probes.k2),
                             ("K3", probes.k3))}
    sm_count, max_mhz = None, None
    if device == "cuda":
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, check=True).stdout
        max_mhz = float(out.strip().splitlines()[0])
    return {"samples": [{k: r[k] for k in ("ok", "wall_s", "align_s",
                                             "type_s")} for r in records],
            "window_s": window_s,
            "busy_s": trace_mod.busy_s(events, lo, hi),
            "launches": launches, "sm_count": sm_count,
            "max_sm_mhz": max_mhz,
            "breakdown": {
                "device_ops": trace_mod.device_ops(
                    [e for e in events if lo <= e[0] < hi]),
                "idle_gaps": trace_mod.idle_gaps(events, lo, hi, phases)}}


def jax_loaded() -> list[str]:
    """Modules of JAX or of the JAX package that this process holds,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BLOCKED})
