"""Ground-truth alignment evaluation (reference: simulator/trueReadLevels).

Loads per-base graph-level truth (`.levels` files) and scores produced
alignments base-by-base into (total, correct) counters
(trueReadLevels.h:22-41; called per aligned pair, processBAM.cpp:3555-3561).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TrueReadLevels:
    truth: dict[str, np.ndarray]   # read name -> level per base (sequencing
                                   # orientation; -1 = inserted base)
    tolerance: int = 0
    total: int = 0
    correct: int = 0
    per_read: dict[str, tuple[int, int]] = field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str, tolerance: int = 0) -> "TrueReadLevels":
        from .read_sim import read_levels_file
        return cls(read_levels_file(path), tolerance)

    def evaluate(self, read_name: str, aligned_levels_per_base: np.ndarray,
                 reverse: bool) -> None:
        """`aligned_levels_per_base`: graph level assigned to each base of the
        read in its *original* (sequencing) orientation; -1 where the
        alignment put the base in a graph gap / left it unaligned."""
        t = self.truth.get(read_name)
        if t is None:
            return
        got = np.asarray(aligned_levels_per_base)
        if len(got) != len(t):
            return
        mask = t >= 0
        tot = int(mask.sum())
        corr = int(((got >= 0) & (np.abs(got - t) <= self.tolerance)
                    & mask).sum())
        self.total += tot
        self.correct += corr
        self.per_read[read_name] = (tot, corr)

    def accuracy(self) -> float:
        return self.correct / self.total if self.total else 0.0
