"""The port's spans, as the per-layer readers read them.

The port records spans in ``hla_la_tpu_torch/utils/timing.py``: each has a
name, a start and an end (``time.perf_counter_ns``, one clock for the
parent and its worker processes), a parent, the sample it belongs to (one
id for every span of one ``run_hla_typing`` call), a pid and attributes.
Tracing is decided at each sample's root span: on while the profiler runs,
and the buffer is cleared where it turns on.  So after ``Traced.stop()``
the buffer holds exactly the window's spans: the warm-up sample, typed
with the profiler off, left none.

A program that records no spans (a tree before them) gives an empty list,
and every reader then None.  A record that holds ``"spans"`` (the readers'
tests) is read in place of the port's buffer.
"""

from __future__ import annotations

ROOT = "run_hla_typing"


def records(record: dict) -> list:
    """The window's spans."""
    if "spans" in record:
        return list(record["spans"])
    from hla_la_tpu_torch.utils import timing
    spans = getattr(timing, "spans", None)
    return list(spans()) if spans is not None else []


def _by_sample(record: dict) -> tuple[list, dict]:
    """The window's roots, and its spans by sample."""
    rs = records(record)
    by: dict = {}
    for r in rs:
        by.setdefault(r.sample, []).append(r)
    return [r for r in rs if r.name == ROOT], by


def mean_seconds(record: dict, names: tuple[str, ...]) -> float | None:
    """Seconds of the spans `names` per sample (summed over every process
    and thread, so spans that ran at once add up), mean over the window's
    roots; None where the window holds no such span."""
    roots, by = _by_sample(record)
    if not roots or not any(r.name in names for s in by.values()
                            for r in s):
        return None
    return sum((r.t1 - r.t0) for root in roots for r in by[root.sample]
               if r.name in names) / 1e9 / len(roots)


def mean_attr(record: dict, name: str, attr: str) -> float | None:
    """An integer attribute of the spans `name`, in nanoseconds, summed per
    sample: seconds, mean over the window's roots."""
    roots, by = _by_sample(record)
    if not roots or not any(r.name == name for s in by.values() for r in s):
        return None
    return sum(r.attrs.get(attr, 0) for root in roots
               for r in by[root.sample] if r.name == name) / 1e9 / len(roots)


def pool_ready(record: dict) -> float | None:
    """Per sample that started a pool: from pool.start's start to the end
    of the last worker.init of that sample (the workers that sent their
    start back, with their first task's result); mean, seconds."""
    roots, by = _by_sample(record)
    vals = []
    for root in roots:
        start = [r.t0 for r in by[root.sample] if r.name == "pool.start"]
        ready = [r.t1 for r in by[root.sample] if r.name == "worker.init"]
        if start and ready:
            vals.append((max(ready) - min(start)) / 1e9)
    return sum(vals) / len(vals) if vals else None
