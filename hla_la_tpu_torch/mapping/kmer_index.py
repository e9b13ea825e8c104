"""Exact k-mer index over the linearized PRG haplotypes.

This is the native replacement for the external linear mapper (the reference
shells out to `bwa mem -a` against mapping_PRGonly/referenceGenome.fa,
BWAmapper.cpp:67-140; its own dormant native index is GraphAndEdgeIndex).
Design: 2-bit-packed k-mers over the concatenated reference, sorted arrays +
binary search — O(1)-ish vectorised batch queries with numpy, no external
processes, and the hit lists feed diagonal chaining (seeder.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_CODE = np.full(256, 255, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i
    _CODE[b + 32] = i  # lowercase


def encode_kmers(seq_bytes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mer codes of a uint8 sequence.  Returns (codes uint64, valid bool)
    — invalid where any base is non-ACGT."""
    from .. import native
    if native.available():
        res = native.encode_kmers(seq_bytes, k)
        if res is not None:
            return res
    codes2 = _CODE[seq_bytes]
    n = len(seq_bytes) - k + 1
    if n <= 0:
        return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool))
    out = np.zeros(n, dtype=np.uint64)
    bad = np.zeros(n, dtype=bool)
    for i in range(k):
        c = codes2[i:i + n]
        out = (out << np.uint64(2)) | c.astype(np.uint64)
        bad |= c == 255
    return out, ~bad


_COMP_BYTES = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP_BYTES[_a] = _b


def revcomp_bytes(seq_bytes: np.ndarray) -> np.ndarray:
    return _COMP_BYTES[seq_bytes][::-1]


@dataclass
class KmerIndex:
    k: int
    seq_names: list[str]
    seq_offsets: np.ndarray        # [S+1] global offsets of each sequence
    sorted_codes: np.ndarray       # [M] uint64
    sorted_pos: np.ndarray         # [M] int64 global positions
    max_occurrences: int = 64      # k-mers more frequent than this are skipped

    @classmethod
    def build(cls, seqs: dict[str, str], k: int = 20,
              max_occurrences: int = 64) -> "KmerIndex":
        names = list(seqs)
        offsets = np.zeros(len(names) + 1, dtype=np.int64)
        codes_all = []
        pos_all = []
        cursor = 0
        for i, name in enumerate(names):
            b = np.frombuffer(seqs[name].encode(), dtype=np.uint8)
            offsets[i] = cursor
            codes, valid = encode_kmers(b, k)
            p = np.nonzero(valid)[0]
            codes_all.append(codes[p])
            pos_all.append(p + cursor)
            cursor += len(b) + 1  # +1 gap so k-mers never span sequences
        offsets[len(names)] = cursor
        codes_cat = np.concatenate(codes_all) if codes_all else np.zeros(0, np.uint64)
        pos_cat = np.concatenate(pos_all) if pos_all else np.zeros(0, np.int64)
        order = np.argsort(codes_cat, kind="stable")
        return cls(k=k, seq_names=names, seq_offsets=offsets,
                   sorted_codes=codes_cat[order], sorted_pos=pos_cat[order],
                   max_occurrences=max_occurrences)

    _prefix_starts: np.ndarray | None = None
    _prefix_bits: int = 0

    def prefix_table(self, pbits: int | None = None
                     ) -> tuple[np.ndarray, int]:
        """Cached bucket-start table over the top `pbits` of each code —
        queries then binary-search only within one bucket (hla_seed_chain).
        Sized so buckets average <=8 entries (min 16 bits, max 24)."""
        if pbits is None:
            pbits = 16
            while (pbits < 24 and pbits < 2 * self.k
                   and (len(self.sorted_codes) >> pbits) > 8):
                pbits += 2
            pbits = min(pbits, 2 * self.k)
        if self._prefix_starts is None or self._prefix_bits != pbits:
            shift = 2 * self.k - pbits
            bounds = np.arange((1 << pbits) + 1, dtype=np.uint64) << np.uint64(shift)
            # boundary (1<<pbits)<<shift may overflow the code width; clamp
            bounds[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
            starts = np.searchsorted(self.sorted_codes, bounds, side="left")
            starts[-1] = len(self.sorted_codes)
            self._prefix_starts = starts.astype(np.int64)
            self._prefix_bits = pbits
        return self._prefix_starts, self._prefix_bits

    def save(self, path: str) -> None:
        """Persist to npz (the `ref_is_indexed` on-disk index cache role,
        BWAmapper.cpp:53-65)."""
        # names as a unicode ARRAY: numpy strips trailing NULs from a
        # joined scalar string, so empty/trailing-empty names (and the
        # zero-sequence case) would corrupt the round-trip
        np.savez(path, k=self.k,
                 names_arr=np.asarray(self.seq_names, dtype="U"),
                 seq_offsets=self.seq_offsets,
                 sorted_codes=self.sorted_codes, sorted_pos=self.sorted_pos,
                 max_occurrences=self.max_occurrences)

    @classmethod
    def load(cls, path: str) -> "KmerIndex":
        with np.load(path) as z:
            if "names_arr" in z.files:
                names = [str(x) for x in z["names_arr"]]
            else:   # legacy caches (joined-scalar format)
                names = str(z["names"]).split("\x00")
            return cls(k=int(z["k"]), seq_names=names,
                       seq_offsets=z["seq_offsets"],
                       sorted_codes=z["sorted_codes"],
                       sorted_pos=z["sorted_pos"],
                       max_occurrences=int(z["max_occurrences"]))

    def locate(self, global_pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global position -> (seq index, position within sequence)."""
        si = np.searchsorted(self.seq_offsets, global_pos, side="right") - 1
        return si.astype(np.int32), (global_pos - self.seq_offsets[si])

    def query_codes(self, codes: np.ndarray, valid: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """For each query k-mer: ref hits.  Returns (query_idx, global_pos)
        arrays (one row per hit), capped at max_occurrences per k-mer."""
        lo = np.searchsorted(self.sorted_codes, codes, side="left")
        hi = np.searchsorted(self.sorted_codes, codes, side="right")
        counts = hi - lo
        counts = np.where(valid & (counts <= self.max_occurrences), counts, 0)
        total = int(counts.sum())
        qidx = np.repeat(np.arange(len(codes)), counts)
        # ranges -> flat indices
        starts = np.repeat(lo, counts)
        within = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts)
        return qidx.astype(np.int64), self.sorted_pos[starts + within]

    def query_read(self, seq: str) -> dict[bool, tuple[np.ndarray, np.ndarray]]:
        """Hits for both strands: {is_reverse: (read_kmer_pos, global_ref_pos)}.

        For the reverse strand, read_kmer_pos is the k-mer start within the
        *reverse-complemented* read.
        """
        b = np.frombuffer(seq.encode(), dtype=np.uint8)
        out = {}
        for is_rev, bb in ((False, b), (True, revcomp_bytes(b))):
            codes, valid = encode_kmers(bb, self.k)
            qi, gp = self.query_codes(codes, valid)
            out[is_rev] = (qi, gp)
        return out
