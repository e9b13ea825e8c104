"""Illumina paired-read simulator (reference: simulator/readSimulator.{h,cpp}).

Model (readSimulator.h:20-41 design note): reads start ~Poisson(coverage),
fragment length ~Normal(mean, sd); per-base quality is drawn from an empirical
quality matrix (readLength/qualityScore/positionInRead/N/ExpectedCorrect/
EmpiricalCorrect, the format of predefinedQualityMatrices/I101_NA12878.txt);
conditional on quality, a Bernoulli trial decides base correctness; small
indel rates inject novel gaps.  Truth output: graph level per emitted base
(the `.levels` files consumed by TrueReadLevels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fastq import FastqRead

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP_TABLE = bytes.maketrans(b"ACGTUacgtuNRYSWKMBVDHryswkmbvdh",
                              b"TGCAAtgcaaNYRSWMKVBHDyrswmkvbhd")


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP_TABLE)[::-1].decode()


@dataclass
class QualityProfile:
    """Per-(position, quality) empirical model.

    `quality_dist[pos]` is a (quality_chars, probs) pair; `p_correct[q]` maps
    a quality char to empirical correctness.  `default()` builds a synthetic
    Illumina-like profile (high quality, mild 3' degradation).
    """

    read_length: int
    quality_chars: np.ndarray          # [Q] uint8
    quality_probs: np.ndarray          # [L, Q] float
    p_correct: dict[int, float]

    @classmethod
    def default(cls, read_length: int = 101) -> "QualityProfile":
        # quality ramp: mostly Q37-Q41, degrading toward the 3' end
        quals = np.array([ord("#"), ord("0"), ord("7"), ord(";"), ord("F"),
                          ord("I")], dtype=np.uint8)   # Q2,15,22,26,37,40
        L = read_length
        probs = np.zeros((L, len(quals)))
        for pos in range(L):
            degrade = pos / max(1, L - 1)
            probs[pos] = np.array([
                0.002 + 0.02 * degrade,
                0.005 + 0.03 * degrade,
                0.01 + 0.05 * degrade,
                0.04 + 0.10 * degrade,
                0.35,
                0.593 - 0.20 * degrade,
            ])
            probs[pos] /= probs[pos].sum()
        p_correct = {int(q): 1.0 - 10.0 ** (-(int(q) - 33) / 10.0) for q in quals}
        return cls(read_length, quals, probs, p_correct)

    @classmethod
    def from_matrix_file(cls, path: str, read_length: int) -> "QualityProfile":
        """Load the reference's empirical quality matrix format."""
        counts: dict[int, dict[int, float]] = {}
        emp: dict[int, list[tuple[float, float]]] = {}
        with open(path) as fh:
            header = fh.readline().rstrip("\n").split("\t")
            idx = {h: i for i, h in enumerate(header)}
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if not f or len(f) < len(header):
                    continue
                if int(f[idx["readLength"]]) != read_length:
                    continue
                q = ord(f[idx["qualityScore"]][0])
                pos = int(f[idx["positionInRead"]])
                n = float(f[idx["N"]])
                e = float(f[idx["EmpiricalCorrect"]])
                counts.setdefault(pos, {})[q] = n
                emp.setdefault(q, []).append((n, e))
        all_q = sorted({q for d in counts.values() for q in d})
        quals = np.array(all_q, dtype=np.uint8)
        probs = np.zeros((read_length, len(all_q)))
        for pos in range(read_length):
            row = counts.get(pos, {})
            for j, q in enumerate(all_q):
                probs[pos, j] = row.get(q, 0.0)
            s = probs[pos].sum()
            probs[pos] = probs[pos] / s if s > 0 else 1.0 / len(all_q)
        p_correct = {}
        for q, pairs in emp.items():
            tot = sum(n for n, _ in pairs)
            p_correct[q] = (sum(n * e for n, e in pairs) / tot) if tot > 0 else 0.99
        return cls(read_length, quals, probs, p_correct)


@dataclass
class SimulatedRead:
    name: str
    seq: str                 # as sequenced (already reverse-complemented if minus)
    qual: str
    levels: np.ndarray       # graph level per base of `seq` in sequencing
                             # orientation (-1 for inserted bases)
    reverse: bool
    start_pos: int           # 0-based position in the (gap-free) source string

    def to_fastq(self) -> FastqRead:
        return FastqRead(self.name, self.seq, self.qual)


@dataclass
class SimulatedPair:
    r1: SimulatedRead
    r2: SimulatedRead


@dataclass
class ReadSimulator:
    rng: np.random.Generator
    read_length: int = 101
    profile: QualityProfile = None
    insertion_rate: float = 0.0005
    deletion_rate: float = 0.0005
    fragment_mean: float = 300.0
    fragment_sd: float = 30.0
    with_error: bool = True
    name_sep: str = ":::"    # readName_field_separator equivalent

    def __post_init__(self):
        if self.profile is None:
            self.profile = QualityProfile.default(self.read_length)

    # ------------------------------------------------------------- one read
    def _sequence_read(self, source: str, source_levels: np.ndarray,
                       start: int, require_indel: bool = False
                       ) -> tuple[str, str, np.ndarray] | None:
        """Emit read_length bases starting at `start` in the gap-free source.
        Returns (seq, qual, levels) in plus orientation, or None if the
        source is exhausted.  require_indel=True conditions on >= 1 indel
        (rejection sampling): the vectorised pair path pre-flags reads
        with P(>=1 indel) and re-simulating unconditionally would square
        that probability (~10x too few indel reads at default rates)."""
        for _ in range(1000 if require_indel else 1):
            res = self._sequence_read_once(source, source_levels, start)
            if res is None:
                return None
            if not require_indel or res[3] > 0:
                return res[:3]
        return res[:3]

    def _sequence_read_once(self, source: str, source_levels: np.ndarray,
                            start: int):
        L = self.read_length
        seq = []
        qual = []
        levels = []
        pos = start
        n_indels = 0
        rng = self.rng
        while len(seq) < L:
            if pos >= len(source):
                return None
            if self.with_error and rng.random() < self.deletion_rate:
                skip = max(1, int(rng.geometric(0.5)))
                pos += skip
                n_indels += 1
                continue
            if self.with_error and rng.random() < self.insertion_rate:
                seq.append(chr(BASES[rng.integers(0, 4)]))
                q = self._draw_quality(len(seq) - 1)
                qual.append(chr(q))
                levels.append(-1)
                n_indels += 1
                continue
            q = self._draw_quality(len(seq))
            base = source[pos]
            if self.with_error and rng.random() > self.profile.p_correct.get(int(q), 0.99):
                base = chr(BASES[(np.searchsorted(BASES, ord(base)) +
                                  rng.integers(1, 4)) % 4])
            seq.append(base)
            qual.append(chr(q))
            levels.append(int(source_levels[pos]))
            pos += 1
        return ("".join(seq), "".join(qual),
                np.asarray(levels, dtype=np.int64), n_indels)

    def _draw_quality(self, pos_in_read: int) -> int:
        p = self.profile
        pos = min(pos_in_read, p.read_length - 1)
        j = self.rng.choice(len(p.quality_chars), p=p.quality_probs[pos])
        return int(p.quality_chars[j])

    # ------------------------------------------------------ vectorised reads
    def _sequence_reads_vectorized(self, source: str,
                                   source_levels: np.ndarray,
                                   starts: np.ndarray):
        """Error model applied to a batch of no-indel reads at `starts`
        (vectorised); returns (seqs [N, L] bytes, quals [N, L] bytes,
        levels [N, L]).  Indel-carrying reads are handled by the slow path."""
        L = self.read_length
        N = len(starts)
        src = np.frombuffer(source.encode(), dtype=np.uint8)
        idx = starts[:, None] + np.arange(L)[None, :]
        bases = src[idx]                                # [N, L]
        levels = np.asarray(source_levels)[idx]
        p = self.profile
        # qualities: inverse-CDF sample per position
        quals = np.empty((N, L), dtype=np.uint8)
        u = self.rng.random((N, L))
        cum = np.cumsum(p.quality_probs, axis=1)        # [Lp, Q]
        for l in range(L):
            pos = min(l, p.read_length - 1)
            qi = np.searchsorted(cum[pos], u[:, l])
            qi = np.minimum(qi, len(p.quality_chars) - 1)
            quals[:, l] = p.quality_chars[qi]
        if self.with_error:
            pc = np.asarray([p.p_correct.get(int(q), 0.99)
                             for q in range(256)])
            err = self.rng.random((N, L)) > pc[quals]
            if err.any():
                base_idx = np.searchsorted(BASES, bases)
                shift = self.rng.integers(1, 4, size=int(err.sum()))
                new_idx = (base_idx[err] + shift) % 4
                bases = bases.copy()
                bases[err] = BASES[new_idx]
        return bases, quals, levels

    # ---------------------------------------------------------------- pairs
    def simulate_pairs_from_string(self, source: str, source_levels: np.ndarray,
                                   haploid_coverage: float,
                                   name_prefix: str = "sim"
                                   ) -> list[SimulatedPair]:
        """Poisson read starts along `source` (gap-free string with per-base
        graph levels); fragment ~ Normal; R1 plus-strand / R2 minus-strand
        with random swap (like real libraries).  Reads without indels go
        through the vectorised error model; indel-carrying reads (rare) use
        the per-base path."""
        L = self.read_length
        n_pairs_exp = haploid_coverage * len(source) / (2.0 * L)
        n_pairs = int(self.rng.poisson(n_pairs_exp))
        if n_pairs == 0:
            return []
        frags = np.maximum(
            self.rng.normal(self.fragment_mean, self.fragment_sd,
                            n_pairs).astype(np.int64), L + 2)
        starts = self.rng.integers(
            0, np.maximum(1, len(source) - frags))
        rev_starts = starts + frags - L
        ok = rev_starts + L <= len(source)
        starts, rev_starts = starts[ok], rev_starts[ok]
        n = len(starts)
        p_indel_read = 1.0 - (1.0 - self.insertion_rate
                              - self.deletion_rate) ** L \
            if self.with_error else 0.0
        has_indel = (self.rng.random((n, 2)) < p_indel_read)

        fwd_b, fwd_q, fwd_l = self._sequence_reads_vectorized(
            source, source_levels, starts)
        rev_b, rev_q, rev_l = self._sequence_reads_vectorized(
            source, source_levels, rev_starts)
        swap = self.rng.random(n) < 0.5

        out: list[SimulatedPair] = []
        for i in range(n):
            name = f"{name_prefix}{self.name_sep}{i}"
            if has_indel[i, 0]:
                r = self._sequence_read(source, source_levels,
                                        int(starts[i]), require_indel=True)
                if r is None:
                    continue
                f_seq, f_qual, f_lv = r
            else:
                f_seq = bytes(fwd_b[i]).decode()
                f_qual = bytes(fwd_q[i]).decode()
                f_lv = fwd_l[i]
            if has_indel[i, 1]:
                r = self._sequence_read(source, source_levels,
                                        int(rev_starts[i]),
                                        require_indel=True)
                if r is None:
                    continue
                rv_seq, rv_qual, rv_lv = r
            else:
                rv_seq = bytes(rev_b[i]).decode()
                rv_qual = bytes(rev_q[i]).decode()
                rv_lv = rev_l[i]
            r1 = SimulatedRead(name, f_seq, f_qual,
                               np.asarray(f_lv, dtype=np.int64), False,
                               int(starts[i]))
            r2 = SimulatedRead(name, revcomp(rv_seq), rv_qual[::-1],
                               np.asarray(rv_lv, dtype=np.int64)[::-1], True,
                               int(rev_starts[i]))
            pair = SimulatedPair(r2, r1) if swap[i] else SimulatedPair(r1, r2)
            out.append(pair)
        return out

    def _simulate_pairs_slow(self, source: str, source_levels: np.ndarray,
                             haploid_coverage: float,
                             name_prefix: str = "sim"
                             ) -> list[SimulatedPair]:
        n_pairs_exp = haploid_coverage * len(source) / (2.0 * self.read_length)
        n_pairs = int(self.rng.poisson(n_pairs_exp))
        out: list[SimulatedPair] = []
        for i in range(n_pairs):
            frag = max(int(self.rng.normal(self.fragment_mean, self.fragment_sd)),
                       self.read_length + 2)
            start = int(self.rng.integers(0, max(1, len(source) - frag)))
            fwd = self._sequence_read(source, source_levels, start)
            rev_start = start + frag - self.read_length
            rev = self._sequence_read(source, source_levels, rev_start)
            if fwd is None or rev is None:
                continue
            name = f"{name_prefix}{self.name_sep}{i}"
            # mate 2 is sequenced on the minus strand
            r2_seq = revcomp(rev[0])
            r2_qual = rev[1][::-1]
            r2_levels = rev[2][::-1]
            p = SimulatedPair(
                SimulatedRead(name, fwd[0], fwd[1], fwd[2], False, start),
                SimulatedRead(name, r2_seq, r2_qual, r2_levels, True, rev_start),
            )
            if self.rng.random() < 0.5:
                # swap which physical read is mate 1
                p = SimulatedPair(
                    SimulatedRead(name, p.r2.seq, p.r2.qual, p.r2.levels,
                                  p.r2.reverse, p.r2.start_pos),
                    SimulatedRead(name, p.r1.seq, p.r1.qual, p.r1.levels,
                                  p.r1.reverse, p.r1.start_pos),
                )
            out.append(p)
        return out

    def simulate_unpaired_from_string(self, source: str, source_levels: np.ndarray,
                                      haploid_coverage: float, read_length: int,
                                      name_prefix: str = "simlong"
                                      ) -> list[SimulatedRead]:
        """Long unpaired reads (the long-read mode input)."""
        saved = self.read_length
        self.read_length = read_length
        try:
            n_exp = haploid_coverage * len(source) / read_length
            n = int(self.rng.poisson(n_exp))
            out = []
            for i in range(n):
                start = int(self.rng.integers(0, max(1, len(source) - read_length)))
                r = self._sequence_read(source, source_levels, start)
                if r is None:
                    continue
                reverse = bool(self.rng.random() < 0.5)
                name = f"{name_prefix}{self.name_sep}{i}"
                if reverse:
                    out.append(SimulatedRead(name, revcomp(r[0]), r[1][::-1],
                                             r[2][::-1], True, start))
                else:
                    out.append(SimulatedRead(name, r[0], r[1], r[2], False, start))
            return out
        finally:
            self.read_length = saved


def write_levels_file(path: str, reads: list[SimulatedRead]) -> None:
    """Write the `.levels` truth file: readName TAB space-separated levels
    (simulator::simulateFromGraph output convention)."""
    with open(path, "w") as fh:
        for r in reads:
            fh.write(r.name + "\t" + " ".join(map(str, r.levels.tolist())) + "\n")


def read_levels_file(path: str) -> dict[str, np.ndarray]:
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            name, levels = line.split("\t")
            out[name] = np.asarray([int(x) for x in levels.split(" ")],
                                   dtype=np.int64)
    return out
