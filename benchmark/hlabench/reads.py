"""Samples: reads of two planted haplotypes, paired Illumina-like reads or,
for a configuration with ``long_reads``, unpaired long reads.

Paired reads: a numpy rewrite, frozen here, of the port's read simulator
(``hla_la_tpu_torch/sim/read_sim.py``, after the reference's
``readSimulator``): fragment lengths ~ Normal, per-base qualities from the
default Illumina-like profile (mostly Q37-Q40, degrading toward the 3'
end), a base error with the probability its quality states, and rare
one-base insertions and short deletions.  Every array is drawn in bulk.

Long reads (``long_reads`` "ont2d" or "pacbio"): a numpy rewrite, frozen
here, of the port's ``sim/worlds.py::_long_bench_reads``.  For each window
and planted haplotype, reads of log-normal length about
``read_length_median`` (sigma ``read_length_sigma``, clipped to
``read_length_min``-``read_length_max``) at uniform starts, drawn until
their bases meet the window's target, then ``extra_long_reads`` reads of
``extra_long_min``-``extra_long_max`` bases.  A long-read configuration
states every one of these keys (``LONG_KEYS``): its read-length profile is
part of the deployment, as ``read_length`` is for short reads.  Each base
step of a read is a deletion run (``del_rate_reads``; geometric length,
p = 0.5), a random inserted base (``ins_rate_reads``) or the source base,
with a substitution at the rate its quality states.  The reads are drawn
whole: the harness cuts them as the CLI does (``cli._split_long_reads``,
50 kb pieces, HLA-LA.pl:503-524).  Departures from the port's function,
each to keep a sample a function of ``(seed, index)`` and its work the
same from seed to seed:

- the window target is the configuration's coverage per haplotype times
  the backbone's bases under the window (the port: its coverage times
  the haplotype's bases there);
- the extra long reads take a random strand too (the port's are all on the
  plus strand);
- every base's quality comes from the last position of the Illumina-like
  profile, as all but the first 101 bases of the port's reads do;
- one ``numpy.random.Generator`` per sample draws the reads' arrays in
  bulk, in another order than the port's per-base loop.

A sample is drawn from ``(seed, index)`` alone: its planted pair of
haplotypes, its read positions, qualities and errors.  The number of pairs
follows from the backbone's bases under the sampled windows, so every seed
gives the same amount of work; long reads meet a target of bases.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
    # unpaired reads (long-read configurations), before any split
    u_names: list[str] = field(default_factory=list)
    u_seq: list[str] = field(default_factory=list)
    u_qual: list[str] = field(default_factory=list)

    @property
    def n_pairs(self) -> int:
        return len(self.names)

    @property
    def n_unpaired(self) -> int:
        return len(self.u_names)


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
    if cfg.get("long_reads"):
        return _long_sample(rng, panel, cfg, traffic, index, haps)
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


# the read-length profile that a long-read configuration states
LONG_KEYS = ("read_length_median", "read_length_sigma", "read_length_min",
             "read_length_max", "extra_long_reads", "extra_long_min",
             "extra_long_max")


def long_read(rng: np.random.Generator, src: np.ndarray, L: int,
              ins_rate: float, del_rate: float
              ) -> tuple[np.ndarray, np.ndarray] | None:
    """One read of L bases from a uniform start in `src`, on a random
    strand: bases and quality characters, uint8 each; None where its
    deletions run past the source."""
    start = int(rng.integers(0, max(1, len(src) - L)))
    # base steps: enough that L of them are not deletions
    S = int(np.ceil(L / (1.0 - del_rate) + 8.0 * np.sqrt(L) + 16))
    is_del = rng.random(S) < del_rate
    is_ins = ~is_del & (rng.random(S) < ins_rate)
    skip = rng.geometric(0.5, S)
    out = np.nonzero(~is_del)[0]
    if len(out) < L:
        raise ValueError(f"{S} steps gave {len(out)} of {L} bases")
    used = out[L - 1] + 1
    advance = np.where(is_del, skip, (~is_ins).astype(np.int64))[:used]
    pos = start + np.cumsum(advance) - advance      # before each step
    if pos[-1] >= len(src):
        return None
    out = out[:L]
    ins = is_ins[out]
    bases = src[pos[out]]
    cdf = quality_cdf(2)[-1]                # the profile's last position
    qi = (rng.random(L)[:, None] > cdf[None, :]).sum(axis=1)
    quals = QUAL_CHARS[np.minimum(qi, len(QUAL_CHARS) - 1)]
    err = (rng.random(L) > p_correct()[quals]) & ~ins
    code = np.searchsorted(BASES, bases[err])
    bases[err] = BASES[(code + rng.integers(1, 4, len(code))) % 4]
    bases[ins] = BASES[rng.integers(0, 4, int(ins.sum()))]
    if rng.random() < 0.5:
        bases, quals = _COMP[bases[::-1]], quals[::-1]
    return bases, quals


def _long_sample(rng: np.random.Generator, panel: Panel, cfg: dict,
                 traffic: dict, index: int, haps: tuple[int, int]
                 ) -> Sample:
    missing = [k for k in LONG_KEYS if k not in cfg]
    if missing:
        raise KeyError(f"a long-read configuration states {missing}")
    cov = float(cfg["coverage"]) / 2.0          # per haplotype
    ins, dels = cfg["ins_rate_reads"], cfg["del_rate_reads"]
    median = float(cfg["read_length_median"])
    sigma = float(cfg["read_length_sigma"])
    lo_len, hi_len = int(cfg["read_length_min"]), int(cfg["read_length_max"])
    xl_lo, xl_hi = int(cfg["extra_long_min"]), int(cfg["extra_long_max"])
    names, seqs, quals = [], [], []

    def add(name, read):
        names.append(name)
        seqs.append(read[0].tobytes().decode())
        quals.append(read[1].tobytes().decode())

    for h in haps:
        seq, levels = panel.linearized(h)
        for gi, (lo, hi) in enumerate(windows(panel, traffic,
                                              list(cfg["genes"]))):
            sel = np.nonzero((levels >= lo) & (levels <= hi))[0]
            src = seq[sel[0]:sel[-1] + 1]
            bb = int(np.count_nonzero(panel.rows[0, max(lo, 0):hi + 1]
                                      != GAP))
            target, made, i = cov * bb, 0, 0
            while made < target:
                L = int(np.clip(rng.lognormal(np.log(median), sigma),
                                lo_len, hi_len))
                read = long_read(rng, src, L, ins, dels)
                if read is None:
                    continue
                add(f"h{h}g{gi}:::{i}", read)
                made += L
                i += 1
            for j in range(int(cfg["extra_long_reads"])):
                read = long_read(rng, src, int(rng.integers(xl_lo, xl_hi)),
                                 ins, dels)
                if read is not None:
                    add(f"h{h}g{gi}xl:::{j}", read)
    return Sample(index, haps, [], [], [], [], [], panel.truth(haps),
                  names, seqs, quals)
