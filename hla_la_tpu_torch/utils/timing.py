"""Progress logging, throughput counters and spans.

The reference prints timestamped progress lines (Utilities::timestamp used
throughout processBAM.cpp) and keeps an aligner::statistics counter struct
(mapper/aligner/statistics.h).  This module provides the same observability
surface for the port's pipeline, and records spans.

A span is a named interval of the work: ``span(name, **attrs)`` records the
name, its start and end on ``clock()`` (``time.perf_counter_ns``:
CLOCK_MONOTONIC on Linux, one clock for every process of a host), its
parent span, the sample (one id for every span of one ``run_hla_typing``
call), the pid and thread, and integer or string attributes: the counters
at that boundary.  Spans are kept in memory (``spans()``).

Tracing is decided once per sample, at its root span (``root``): on while
the torch profiler is active in this process or inside ``tracing()``, off
otherwise.  Off, ``span`` returns one shared no-op object and records
nothing.  The buffer is cleared when tracing goes from off to on.  While
the profiler is active, the first traced root records the anchor
``hla.clock``: a zero-length ``record_function`` between two reads of
``clock()``, through which the spans of every process of the host are
placed on the profiler's timeline (``anchor_offset``).  The spans are not
``record_function`` ranges themselves: under CUDA activity the profiler
turns a range that encloses launches into a device-side annotation event,
which would count as device time wherever device events are summed.

Worker processes: a task carries ``carry()`` (nothing when tracing is
off), the worker runs it inside ``task(*carried)`` and sends ``drain()``
back with its result; the parent adds those spans with ``add``.

No torch at module level: the host-only workers import this module.
"""

from __future__ import annotations

import bisect
import heapq
import itertools
import os
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple


def timestamp() -> str:
    return time.strftime("[%Y-%m-%d %H:%M:%S]")


def log_progress(msg: str, *, file=None) -> None:
    print(f"{timestamp()} {msg}", file=file or sys.stderr, flush=True)


@dataclass
class Stats:
    """Alignment-run counters (reference: aligner::statistics, statistics.h:16-58)."""

    n_align_calls: int = 0
    considered_chains: int = 0
    considered_chain_pairs: int = 0
    n_chain_extensions: int = 0
    selected_columns_total: int = 0
    selected_columns_from_seed: int = 0
    extras: dict = field(default_factory=dict)

    def bump(self, key: str, n: int = 1) -> None:
        self.extras[key] = self.extras.get(key, 0) + n

    def report(self) -> str:
        lines = ["Alignment statistics:"]
        for k in ("n_align_calls", "considered_chains", "considered_chain_pairs",
                  "n_chain_extensions", "selected_columns_total",
                  "selected_columns_from_seed"):
            lines.append(f"  {k}: {getattr(self, k)}")
        for k, v in sorted(self.extras.items()):
            lines.append(f"  {k}: {v}")
        return "\n".join(lines)


# ------------------------------------------------------------------ spans
clock = time.perf_counter_ns
ANCHOR = "hla.clock"


class Record(NamedTuple):
    """One finished span; times in ``clock()`` nanoseconds."""
    name: str
    t0: int
    t1: int
    id: int
    parent: int | None
    sample: int | None
    pid: int
    tid: int
    attrs: dict


_on = False             # this sample is traced (decided at its root)
_last = False           # the previous root's decision
_anchored = False       # the buffer holds an anchor
_forced = 0             # depth of tracing() contexts
_sample: int | None = None
_buffer: list[Record] = []
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _new_id() -> int:
    return (os.getpid() << 32) | next(_ids)


def _record_function(name: str) -> None:
    """A zero-length ``record_function`` range, where the profiler is
    on."""
    rf = sys.modules["torch"].autograd.profiler.record_function(name)
    rf.__enter__()
    rf.__exit__(None, None, None)


class _Noop:
    """What ``span`` returns while tracing is off: one shared object."""
    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


class Span:
    """An open span; recorded when it closes."""
    __slots__ = ("name", "attrs", "parent", "id", "t0", "sample", "_root")

    def __init__(self, name: str, parent: int | None, attrs: dict,
                 is_root: bool = False):
        self.name, self.parent, self.attrs = name, parent, attrs
        self._root = is_root

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        st = _stack()
        if self.parent is None:
            self.parent = st[-1].id if st else getattr(_local, "base", None)
        self.id = _new_id()
        self.sample = _sample
        st.append(self)
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        global _on, _sample
        t1 = clock()
        _stack().pop()
        _buffer.append(Record(self.name, self.t0, t1, self.id, self.parent,
                              self.sample, os.getpid(),
                              threading.get_ident(), self.attrs))
        if self._root:
            _on, _sample = False, None
        return False


def span(name: str, parent: int | None = None, **attrs):
    """A span of the traced sample: a context manager.  `parent` defaults
    to the innermost open span of this thread.  With tracing off, the one
    shared no-op object."""
    if not _on:
        return NOOP
    return Span(name, parent, attrs)


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def root(name: str, **attrs):
    """The span of one sample (or of a stage outside any sample, such as
    the CLI's input parsing), where tracing is decided; inside another
    span of this thread, an ordinary span."""
    global _on, _last, _sample, _anchored
    if _stack():
        return span(name, **attrs)
    prof = _profiling()
    on = bool(_forced) or prof
    if on and not _last:
        clear()
    _last = on
    if not on:
        return NOOP
    _on, _sample = True, _new_id()
    if prof and not _anchored:
        # a profiler's first ranges take milliseconds: warm it up so that
        # the anchor's own range is narrow
        for _ in range(3):
            _record_function(ANCHOR + ".warm")
        a = clock()
        _record_function(ANCHOR)
        b = clock()
        _buffer.append(Record(ANCHOR, a, b, _new_id(), None, _sample,
                              os.getpid(), threading.get_ident(), {}))
        _anchored = True
    return Span(name, None, attrs, is_root=True)


@contextmanager
def tracing():
    """Trace every sample that starts inside, with or without the
    profiler (tests, and the cost of tracing itself)."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def current(name: str | None = None) -> int | None:
    """The id of the innermost open span of this thread (of that name)."""
    for sp in reversed(_stack()):
        if name is None or sp.name == name:
            return sp.id
    return None if name else getattr(_local, "base", None)


def annotate(name: str, **attrs) -> None:
    """Attributes of the innermost open span `name` of this thread, known
    only inside it; nothing while tracing is off."""
    for sp in reversed(_stack()):
        if sp.name == name:
            sp.set(**attrs)
            return


def context(outermost: bool = False) -> tuple | None:
    """What a worker task or a device-server header carries: (sample,
    parent span id), the parent the innermost open span of this thread
    (`outermost`: the outermost, the sample's root); None while tracing is
    off."""
    if not _on:
        return None
    st = _stack()
    if outermost and st:
        return (_sample, st[0].id)
    return (_sample, current())


def carry() -> tuple:
    """What a task carries beyond its arguments: ``(context(),)`` while
    tracing is on, else nothing."""
    ctx = context()
    return () if ctx is None else (ctx,)


class task:
    """A worker's task under the caller's `ctx` (``context()``, as
    ``carry()`` sends it): traced when given, its spans the children of
    ctx's span."""

    def __init__(self, ctx: tuple | None = None):
        self.ctx = ctx

    def __enter__(self):
        global _on, _sample
        if self.ctx is not None:
            _on, _sample = True, self.ctx[0]
            _local.base = self.ctx[1]
        return self

    def __exit__(self, *exc):
        global _on, _sample
        if self.ctx is not None:
            _on, _sample, _local.base = False, None, None
        return False


def record(name: str, t0: int, t1: int, parent: int | None = None,
           **attrs) -> int | None:
    """A span whose times were taken apart (``clock()`` ns); its id, or
    None while tracing is off."""
    if not _on:
        return None
    sid = _new_id()
    _buffer.append(Record(name, t0, t1, sid,
                          current() if parent is None else parent, _sample,
                          os.getpid(), threading.get_ident(), attrs))
    return sid


def drain() -> list[Record]:
    """This process's spans, taken out of the buffer (a worker's, sent back
    with its result)."""
    out = _buffer[:]
    del _buffer[:len(out)]
    return out


def add(records) -> None:
    """Spans of another process, into this process's buffer."""
    if records:
        _buffer.extend(records)


def spans() -> list[Record]:
    return list(_buffer)


def clear() -> None:
    global _anchored
    _buffer.clear()
    _anchored = False


# -------------------------------------------------- reading the spans
def anchor_offset(records, clock_start_s: float) -> tuple[float, float]:
    """(offset, width) in seconds: a ``clock()`` time t (s) lies at
    t - offset on the profiler's time base, within the anchor's width,
    given `clock_start_s`, the start of the profiler's ``hla.clock``
    event on that base."""
    a = next(r for r in records if r.name == ANCHOR)
    return (a.t0 + a.t1) / 2e9 - clock_start_s, (a.t1 - a.t0) / 1e9


def span_table(records) -> list[tuple[str, int, float, float]]:
    """(name, count, total s, self s) by span name, largest total first;
    self time leaves out the children in the same process and thread."""
    child: dict[int, int] = {}
    by_id = {r.id: r for r in records}
    for r in records:
        p = by_id.get(r.parent)
        if p is not None and (p.pid, p.tid) == (r.pid, r.tid):
            child[p.id] = child.get(p.id, 0) + (r.t1 - r.t0)
    rows: dict[str, list] = {}
    for r in records:
        if r.name == ANCHOR:
            continue
        row = rows.setdefault(r.name, [0, 0, 0])
        row[0] += 1
        row[1] += r.t1 - r.t0
        row[2] += max(0, r.t1 - r.t0 - child.get(r.id, 0))
    return sorted(((n, c, t / 1e9, s / 1e9) for n, (c, t, s) in rows.items()),
                  key=lambda row: -row[2])


def _depths(records) -> dict[int, int]:
    by_id = {r.id: r for r in records}
    depth: dict[int, int] = {}
    for r in records:
        chain, cur = [], r
        while cur is not None and cur.id not in depth:
            chain.append(cur)
            cur = by_id.get(cur.parent)
        d = depth[cur.id] if cur is not None else -1
        for c in reversed(chain):
            d += 1
            depth[c.id] = d
    return depth


def idle_by_span(device_events, records, lo: float, hi: float,
                 top: int = 10) -> dict:
    """The seconds of [lo, hi] in which no device event ran, by the
    innermost span open at the time (the deepest; of equal depth, the
    latest started; in any process), and the `top` longest idle gaps, each
    named by the innermost span at its middle.  `device_events` (start s,
    end s, name) and [lo, hi] on the spans' clock, in seconds (see
    ``anchor_offset``)."""
    busy: list[list[float]] = []
    for s, e, _ in sorted(device_events):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    # the innermost span over each stretch between span boundaries: a
    # sweep with a heap of the open spans, deepest and latest on top
    spans_ = [r for r in records if r.name != ANCHOR
              and r.t1 / 1e9 > lo and r.t0 / 1e9 < hi]
    depth = _depths(spans_)
    edges = sorted([(max(r.t0 / 1e9, lo), 1, i) for i, r in enumerate(spans_)]
                   + [(min(r.t1 / 1e9, hi), 0, i)
                      for i, r in enumerate(spans_)])
    stretches, heap, ended, t_prev = [], [], set(), lo
    for t, opens, i in edges + [(hi, 0, -1)]:
        if t > t_prev:
            while heap and heap[0][2] in ended:
                heapq.heappop(heap)
            stretches.append((t_prev, t, spans_[heap[0][2]].name
                              if heap else "outside any span"))
            t_prev = t
        if i < 0:
            continue
        if opens:
            r = spans_[i]
            heapq.heappush(heap, (-depth[r.id], -r.t0, i))
        else:
            ended.add(i)
    starts = [a for a, _, _ in stretches]

    def name_at(t: float) -> str:
        k = bisect.bisect_right(starts, t) - 1
        return stretches[k][2] if k >= 0 else "outside any span"

    by: dict[str, float] = {}
    for a, b in gaps:
        k = max(0, bisect.bisect_right(starts, a) - 1)
        while k < len(stretches) and stretches[k][0] < b:
            c0, c1, name = stretches[k]
            o = min(b, c1) - max(a, c0)
            if o > 0:
                by[name] = by.get(name, 0.0) + o
            k += 1
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"by_span": sorted(by.items(), key=lambda kv: -kv[1]),
            "gaps": [[name_at((a + b) / 2), b - a] for a, b in gaps[:top]]}


class Timer:
    """Context-manager wall-clock timer for throughput self-measurement
    (reference prints 'protoSeeds per s', processBAM.cpp:1889-1898), and a
    span of its label while tracing is on."""

    def __init__(self, label: str = ""):
        self.label = label
        self.elapsed = 0.0

    def __enter__(self):
        self._span = span(self.label).__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        return False

    def rate(self, n: int) -> float:
        return n / self.elapsed if self.elapsed > 0 else float("inf")
