"""The traced window: ``torch.profiler`` over the window's samples.

Device events (kernels, copies, memsets; the port launches on one stream)
give the seconds in which the card was busy, the operations that took most
time, and the idle gaps between them, each named by the host phase that was
running at its middle.  The phases come from the port's own log lines: a
sample's "aligned ... in X s" and "typed N loci in Y s" lines end the align
and type phases, and their seconds place the starts.
"""

from __future__ import annotations

import time

NAME_CHARS = 120


class Traced:
    def __init__(self, device: str = "cuda"):
        from torch.profiler import ProfilerActivity, profile
        self.cuda = device == "cuda"
        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + [ProfilerActivity.CUDA] * self.cuda)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def _sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def stop(self) -> None:
        self._sync()
        self.prof.__exit__(None, None, None)

    def device_events(self) -> list[tuple[float, float, str]]:
        """(start, end, name) of each device event, seconds after the
        profiler started."""
        from torch.autograd import DeviceType
        return sorted((e.time_range.start / 1e6, e.time_range.end / 1e6,
                       e.name) for e in self.prof.events()
                      if e.device_type == DeviceType.CUDA)


def merged(events, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    out: list[list[float]] = []
    for s, e, _ in sorted(events):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(events, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(events, lo, hi))


def device_ops(events, top: int = 10) -> list[list]:
    by: dict[str, float] = {}
    for s, e, name in events:
        by[name[:NAME_CHARS]] = by.get(name[:NAME_CHARS], 0.0) + (e - s)
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]


def phase_at(phases, t: float) -> str:
    for s, e, name in phases:
        if s <= t < e:
            return name
    return "between samples"


def idle_gaps(events, lo: float, hi: float, phases, top: int = 10
              ) -> list[list]:
    """The longest stretches of [lo, hi] with no device event, each named
    by the phase at its middle; `phases` in the events' time base."""
    busy = merged(events, lo, hi)
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[phase_at(phases, 0.5 * (a + b)), b - a] for a, b in gaps[:top]]
