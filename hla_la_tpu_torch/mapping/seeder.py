"""Seed candidate generation: k-mer hits -> diagonal-consistent candidates.

Produces, per read, a small set of (sequence, strand, window offset)
candidates — the role the bwa `-a` multi-hit output plays in the reference
(protoSeeds grouping, processBAM.cpp:521-701).  Each candidate later becomes
one banded-NW alignment against the haplotype window, projected into graph
coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .kmer_index import KmerIndex


@dataclass
class Candidate:
    seq_idx: int          # index into index.seq_names
    reverse: bool
    ref_start: int        # window anchor: position in the haplotype that the
                          # first base of the (oriented) read aligns to
    n_kmers: int          # chaining support
    span: int             # read-span covered by the chain

    @property
    def key(self) -> tuple:
        return (self.seq_idx, self.reverse, self.ref_start)


@dataclass
class Seeder:
    index: KmerIndex
    max_candidates: int = 6      # candidates kept per read (bwa -a analogue)
    diagonal_slack: int = 12     # hits within this diagonal band chain together
    min_chain_kmers: int = 2
    kmer_stride: int = 2         # query every stride-th read position: a
                                 # 100bp read still contributes ~40 k-mers
                                 # per strand, plenty for chaining, at half
                                 # the index-query cost (recall covered by
                                 # the truth-accuracy + held-out tests)

    _EMPTY = (np.zeros(0, np.int64), np.zeros(0, np.int64),
              np.zeros(0, bool), np.zeros(0, np.int64),
              np.zeros(0, np.int64), np.zeros(0, np.int64))

    def candidates_batch(self, seqs: list[str]) -> list[list[Candidate]]:
        """Selected candidates as per-read Candidate lists (the object API;
        the hot alignment path uses candidates_batch_arrays instead)."""
        read_l, seq_a, rev_a, start_a, nk_a, span_a = \
            self.candidates_batch_arrays(seqs)
        per_read: list[list[Candidate]] = [[] for _ in seqs]
        seq_l = seq_a.tolist()
        rev_l = rev_a.tolist()
        start_l = start_a.tolist()
        nk_l = nk_a.tolist()
        span_l = span_a.tolist()
        new = Candidate.__new__
        for i, r in enumerate(read_l.tolist()):
            c = new(Candidate)
            c.__dict__ = {"seq_idx": seq_l[i], "reverse": rev_l[i],
                          "ref_start": start_l[i], "n_kmers": nk_l[i],
                          "span": span_l[i]}
            per_read[r].append(c)
        return per_read

    def candidates_batch_arrays(self, seqs: list[str]):
        """Vectorised candidate generation for a whole read batch: one k-mer
        encode + one index query + one lexsort across all (read, strand)
        hits.  Returns the SELECTED candidates as SoA arrays
        (read_of ascending, selection order within read):
        (read_of, seq_idx, reverse, ref_start, n_kmers, span)."""
        from .kmer_index import encode_kmers, revcomp_bytes
        k = self.index.k
        if not seqs:
            return self._EMPTY
        # concatenate reads with 1-byte separators; the reverse strand is the
        # revcomp of the whole concatenation (read i lands mirrored at
        # total - off_i - len_i, and its k-mer positions are positions within
        # revcomp(read_i) — exactly what the window math expects)
        g_read, g_seq, g_rev, g_start, g_nk, g_span = ([], [], [], [], [], [])
        lens_arr = np.asarray([len(s) for s in seqs], dtype=np.int64)
        fwd_offsets = np.concatenate(
            [[0], np.cumsum(lens_arr + 1)]).astype(np.int64)
        total = int(fwd_offsets[-1])
        # latin-1 keeps 1 char = 1 byte for arbitrary input (non-ACGT
        # bytes are invalid in k-mers anyway); unencodable chars -> '?'
        cat_fwd = np.frombuffer(
            ("\x00".join(seqs) + "\x00").encode("latin-1", "replace"),
            dtype=np.uint8)
        assert len(cat_fwd) == total
        cat_rev_full = revcomp_bytes(cat_fwd)
        from .. import native
        use_native = native.available()
        for is_rev in (False, True):
            if not is_rev:
                cat = cat_fwd
                offsets = fwd_offsets
                read_index_of_slot = None
            else:
                # rev start of read i = total - off_i - len_i (its slice of
                # the reversed concat IS revcomp(read_i))
                cat = cat_rev_full
                rev_starts = total - fwd_offsets[:-1] - lens_arr
                order_slots = np.argsort(rev_starts)
                offsets = np.concatenate(
                    [rev_starts[order_slots], [total]]).astype(np.int64)
                read_index_of_slot = order_slots
            if use_native:
                pstarts, pbits = self.index.prefix_table()
                res = native.seed_chain(
                    cat, self.index.sorted_codes,
                    self.index.sorted_pos, self.index.max_occurrences,
                    self.index.seq_offsets, pstarts, pbits,
                    slot_offsets=offsets,
                    slot_to_read=read_index_of_slot,
                    n_reads=len(seqs), slack=self.diagonal_slack,
                    min_chain=self.min_chain_kmers, k=k,
                    stride=self.kmer_stride)
                if res is not None:
                    r_a, s_a, st_a, nk_a2, sp_a = res
                    g_read.append(r_a)
                    g_seq.append(s_a)
                    g_rev.append(np.full(len(r_a), is_rev, dtype=bool))
                    g_start.append(st_a)
                    g_nk.append(nk_a2)
                    g_span.append(sp_a)
                    continue
            codes, valid = encode_kmers(cat, k)
            if self.kmer_stride > 1:
                # stride applies in READ coordinates (position within slot)
                all_i = np.arange(len(codes))
                slot_all = np.searchsorted(offsets, all_i,
                                           side="right") - 1
                rp_all = all_i - offsets[slot_all]
                valid = valid & (rp_all % self.kmer_stride == 0)
            qi, gp = self.index.query_codes(codes, valid)
            if len(qi) == 0:
                continue
            slot = (np.searchsorted(offsets, qi, side="right") - 1)
            read_pos = qi - offsets[slot]
            read_of = (slot if read_index_of_slot is None
                       else read_index_of_slot[slot])
            seq_idx, ref_pos = self.index.locate(gp)
            diag = ref_pos - read_pos
            qdiag = diag // self.diagonal_slack
            n_kmers_per_read = np.bincount(read_of, minlength=len(seqs))
            # NOTE a second `qdiag+1` pass would regroup identically
            # (constant key offset) — one pass suffices
            key = (read_of.astype(np.int64) * (1 << 50)
                   + seq_idx.astype(np.int64) * (1 << 33)
                   + qdiag)
            order = np.lexsort((diag, key))
            ks = key[order]
            starts = np.concatenate([[0],
                                     np.nonzero(np.diff(ks))[0] + 1])
            ends = np.concatenate([starts[1:], [len(ks)]])
            rp_sorted = read_pos[order]
            diag_sorted = diag[order]
            # per-group stats fully vectorised (no per-group np calls):
            # distinct read-kmer count via a second sort by (key, rp)
            order2 = np.lexsort((read_pos, key))
            rp2 = read_pos[order2]
            new_grp = np.concatenate([[True],
                                      np.diff(key[order2]) != 0])
            distinct = (new_grp | np.concatenate(
                [[True], np.diff(rp2) != 0])).astype(np.int64)
            n_uniq_g = np.add.reduceat(distinct, starts)
            rp_min_g = np.minimum.reduceat(rp_sorted, starts)
            rp_max_g = np.maximum.reduceat(rp_sorted, starts)
            mid_diag_g = diag_sorted[(starts + ends) // 2]
            first_read = read_of[order[starts]]
            first_seq = seq_idx[order[starts]]
            sizes = ends - starts
            req = np.where(n_kmers_per_read[first_read]
                           >= self.min_chain_kmers,
                           self.min_chain_kmers, 1)
            m = sizes >= req
            g_read.append(first_read[m])
            g_seq.append(first_seq[m])
            g_rev.append(np.full(int(m.sum()), is_rev, dtype=bool))
            g_start.append(mid_diag_g[m])
            g_nk.append(n_uniq_g[m])
            g_span.append(rp_max_g[m] - rp_min_g[m] + k)
        if not g_read:
            return self._EMPTY
        read_a = np.concatenate(g_read)
        seq_a = np.concatenate(g_seq)
        rev_a = np.concatenate(g_rev)
        start_a = np.concatenate(g_start)
        nk_a = np.concatenate(g_nk)
        span_a = np.concatenate(g_span)

        from .. import native
        sel = (native.seed_select(read_a, seq_a, rev_a, start_a, nk_a,
                                  span_a, len(seqs), self.max_candidates,
                                  self.diagonal_slack * 2)
               if native.available() else None)
        if sel is not None:
            out_idx, out_counts = sel
            # flatten the selection (per-element np indexing at 300k
            # candidates is slow, so keep it one fancy-index pass)
            rs = np.nonzero(out_counts)[0]
            cnts = out_counts[rs]
            total_sel = int(cnts.sum())
            # ragged arange without a per-read python loop
            col = (np.arange(total_sel, dtype=np.int64)
                   - np.repeat(np.concatenate([[0], np.cumsum(cnts)[:-1]]),
                               cnts)) if total_sel else \
                np.empty(0, dtype=np.int64)
            gsel = out_idx[np.repeat(rs, cnts), col]
            return (np.repeat(rs, cnts).astype(np.int64), seq_a[gsel],
                    rev_a[gsel], start_a[gsel], nk_a[gsel], span_a[gsel])

        per_read: list[list[Candidate]] = [[] for _ in seqs]
        for gi in range(len(read_a)):
            per_read[int(read_a[gi])].append(Candidate(
                seq_idx=int(seq_a[gi]), reverse=bool(rev_a[gi]),
                ref_start=int(start_a[gi]), n_kmers=int(nk_a[gi]),
                span=int(span_a[gi])))
        sel_lists = [self._select(c) for c in per_read]
        read_of = np.asarray([r for r, cs in enumerate(sel_lists)
                              for _ in cs], dtype=np.int64)
        flat = [c for cs in sel_lists for c in cs]
        return (read_of,
                np.asarray([c.seq_idx for c in flat], dtype=np.int64),
                np.asarray([c.reverse for c in flat], dtype=bool),
                np.asarray([c.ref_start for c in flat], dtype=np.int64),
                np.asarray([c.n_kmers for c in flat], dtype=np.int64),
                np.asarray([c.span for c in flat], dtype=np.int64))

    def _select(self, cands: list[Candidate]) -> list[Candidate]:
        cands.sort(key=lambda c: (-c.n_kmers, -c.span))
        kept: list[Candidate] = []
        for c in cands:
            dup = False
            for kc in kept:
                if (kc.seq_idx == c.seq_idx and kc.reverse == c.reverse
                        and abs(kc.ref_start - c.ref_start)
                        <= self.diagonal_slack * 2):
                    dup = True
                    break
            if not dup:
                kept.append(c)
            if len(kept) >= self.max_candidates:
                break
        return kept

    def candidates(self, seq: str) -> list[Candidate]:
        return self.candidates_batch([seq])[0]
