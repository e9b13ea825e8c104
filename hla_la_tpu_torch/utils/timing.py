"""Progress logging and throughput counters.

The reference prints timestamped progress lines (Utilities::timestamp used
throughout processBAM.cpp) and keeps an aligner::statistics counter struct
(mapper/aligner/statistics.h).  This module provides the same observability
surface for the TPU pipeline.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


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


class Timer:
    """Context-manager wall-clock timer for throughput self-measurement
    (reference prints 'protoSeeds per s', processBAM.cpp:1889-1898)."""

    def __init__(self, label: str = ""):
        self.label = label
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    def rate(self, n: int) -> float:
        return n / self.elapsed if self.elapsed > 0 else float("inf")
