"""Samples: paired Illumina-like reads of two planted haplotypes.

A numpy rewrite, frozen here, of the port's read simulator
(``hla_la_tpu_torch/sim/read_sim.py``, after the reference's
``readSimulator``): fragment lengths ~ Normal, per-base qualities from the
default Illumina-like profile (mostly Q37-Q40, degrading toward the 3'
end), a base error with the probability its quality states, and rare
one-base insertions and short deletions.  Every array is drawn in bulk.

A sample is drawn from ``(seed, index)`` alone: its planted pair of
haplotypes, its read positions, qualities and errors.  The number of pairs
follows from the backbone's bases under the sampled windows, so every seed
gives the same amount of work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .panel import BASES, GAP, Panel

QUAL_CHARS = np.frombuffer(b"#07;FI", dtype=np.uint8)  # Q2,15,22,26,37,40
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


def quality_cdf(read_length: int) -> np.ndarray:
    """[L, 6] cumulative distribution of the quality characters by read
    position."""
    deg = np.arange(read_length) / max(1, read_length - 1)
    probs = np.stack([0.002 + 0.02 * deg, 0.005 + 0.03 * deg,
                      0.01 + 0.05 * deg, 0.04 + 0.10 * deg,
                      np.full(read_length, 0.35), 0.593 - 0.20 * deg], 1)
    probs /= probs.sum(axis=1, keepdims=True)
    return np.cumsum(probs, axis=1)


def p_correct() -> np.ndarray:
    """[256] probability that a base of quality character q is right."""
    q = np.arange(256, dtype=np.float64)
    return np.clip(1.0 - 10.0 ** (-(q - 33) / 10.0), 0.0, 1.0)


@dataclass
class Sample:
    index: int
    haps: tuple[int, int]
    names: list[str]
    seq1: list[str]
    qual1: list[str]
    seq2: list[str]
    qual2: list[str]
    truth: dict[str, list[str]]         # locus -> planted alleles

    @property
    def n_pairs(self) -> int:
        return len(self.names)


def _strings(block: np.ndarray) -> list[str]:
    n, L = block.shape
    text = np.ascontiguousarray(block).tobytes().decode()
    return [text[i * L:(i + 1) * L] for i in range(n)]


def sequence(rng: np.random.Generator, src: np.ndarray, starts: np.ndarray,
             L: int, ins_rate: float, del_rate: float
             ) -> tuple[np.ndarray, np.ndarray]:
    """Reads of length L at `starts` of `src` (plus strand): bases and
    quality characters, [n, L] uint8 each.  A read carries one indel with
    the probability that L bases at these rates give at least one; an
    indel that would run past the source is dropped."""
    n = len(starts)
    idx = starts[:, None] + np.arange(L)[None, :]
    p_indel = 1.0 - (1.0 - ins_rate - del_rate) ** L
    has = np.nonzero(rng.random(n) < p_indel)[0]
    at = rng.integers(1, L - 1, len(has))
    is_del = rng.random(len(has)) < del_rate / (ins_rate + del_rate)
    skip = rng.geometric(0.5, len(has))
    ins_base = BASES[rng.integers(0, 4, len(has))]
    col = np.arange(L)[None, :]
    moved = np.where(is_del, skip, -1)[:, None] * (col >= (at + (~is_del))[:, None])
    new_idx = idx[has] + moved
    fits = new_idx.max(axis=1) < len(src)
    has, at, is_del, ins_base = has[fits], at[fits], is_del[fits], ins_base[fits]
    idx[has] = new_idx[fits]
    bases = src[idx]
    ins = has[~is_del]
    bases[ins, at[~is_del]] = ins_base[~is_del]
    cdf = quality_cdf(L)
    qi = (rng.random((n, L))[:, :, None] > cdf[None, :, :]).sum(axis=2)
    quals = QUAL_CHARS[np.minimum(qi, len(QUAL_CHARS) - 1)]
    err = rng.random((n, L)) > p_correct()[quals]
    code = np.searchsorted(BASES, bases[err])
    bases[err] = BASES[(code + rng.integers(1, 4, len(code))) % 4]
    return bases, quals


def windows(panel: Panel, traffic: dict, genes: list[str]
            ) -> list[tuple[int, int]]:
    """Column ranges [lo, hi] that a sample's reads are drawn from."""
    if traffic["windows"] == "whole":
        return [(0, panel.rows.shape[1] - 1)]
    return [panel.gene_window(g, int(traffic["flank"])) for g in genes]


def draw_sample(panel: Panel, cfg: dict, traffic: dict, seed: int,
                index: int) -> Sample:
    """Sample `index` of a run with `seed`."""
    rng = np.random.default_rng([int(seed), int(index)])
    haps = tuple(sorted(int(h) for h in rng.choice(
        np.arange(1, panel.n_rows), 2, replace=False)))
    L = int(cfg["read_length"])
    cov = float(cfg["coverage"]) / 2.0          # per haplotype
    wins = windows(panel, traffic, list(cfg["genes"]))
    names, s1, q1, s2, q2 = [], [], [], [], []
    for h in haps:
        seq, levels = panel.linearized(h)
        for gi, (lo, hi) in enumerate(wins):
            sel = np.nonzero((levels >= lo) & (levels <= hi))[0]
            src = seq[sel[0]:sel[-1] + 1]
            bb = int(np.count_nonzero(panel.rows[0, max(lo, 0):hi + 1]
                                      != GAP))
            n = int(round(cov * bb / (2.0 * L)))
            frag = np.maximum(rng.normal(cfg["fragment_mean"],
                                         cfg["fragment_sd"], n
                                         ).astype(np.int64), L + 2)
            frag = np.minimum(frag, len(src) - 1)
            starts = rng.integers(0, len(src) - frag)
            fb, fq = sequence(rng, src, starts, L, cfg["ins_rate_reads"],
                              cfg["del_rate_reads"])
            rb, rq = sequence(rng, src, starts + frag - L, L,
                              cfg["ins_rate_reads"], cfg["del_rate_reads"])
            rb, rq = _COMP[rb[:, ::-1]], rq[:, ::-1]
            swap = rng.random(n) < 0.5
            a_b = np.where(swap[:, None], rb, fb)
            a_q = np.where(swap[:, None], rq, fq)
            b_b = np.where(swap[:, None], fb, rb)
            b_q = np.where(swap[:, None], fq, rq)
            names += [f"h{h}g{gi}:::{i}" for i in range(n)]
            s1 += _strings(a_b)
            q1 += _strings(a_q)
            s2 += _strings(b_b)
            q2 += _strings(b_q)
    return Sample(index, haps, names, s1, q1, s2, q2, panel.truth(haps))
