"""Linear-ALT typing (the KIR module).

Reference: linearALTs/linearALTs.{h,cpp} — typing against a panel of
equal-length linear ALT haplotypes: reads are extracted per region, mapped to
the panel, and a diploid haplotype-pair likelihood model picks the best pair
(`haplotypeLikelihoods`, linearALTs.h:29); reads can also be assigned to genes
by interval overlap (`reads2Genes`, linearALTs.h:30).

The port's counterpart of ``hla_la_tpu/models/linear_alts.py``, with one
explicit ``device``.  The (read, candidate) NW jobs of ALL reads of a call
are gathered and run through the batched banded-NW forward on the device
(``NWRunner``: K1 on a card at the band of 32), in calls of
``jobs_per_call`` jobs rather than one call per read; backtrace and scoring
stay on the host, batched, and give the reference's per-read numbers.  The
diploid pair reduction goes through ``ops/pair_ll.pair_ll_reduction`` (K3 on
a card) with haplotypes as "clusters".

With ``sharded`` (a ``parallel.mesh.Mesh``: the reference's
``backend="sharded"``) every rank of the mesh makes the typer over the same
reads and calls it in the same order: each NW call's jobs are split over
all ranks (``parallel.mesh.ShardedNW``) and every rank gets the whole
result back, and the pair reduction runs over the mesh's reads x clusters
axes (``pair_ll_reduction_sharded``: reads over "data", K3's tile list over
"model").  Seeding, backtrace, scoring and the gene assignment stay host
work, repeated on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .._lazy import torch
from ..io.fastq import FastqRead
from ..mapping.kmer_index import KmerIndex
from ..mapping.seeder import Seeder
from ..ops.banded_nw import banded_nw_backtrace
from ..ops.pair_ll import pair_ll_reduction, pair_tiles
from ..sim.read_sim import revcomp
from ..utils.phred import phred_to_p_correct_table
from ..utils.timing import log_progress
from .aligner import NWRunner, gather_ref_windows

_ENC = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _ENC[b] = i
    _ENC[b + 32] = i
# revcomp of a one-base string is its complement
_COMP = np.frombuffer(b"".join(revcomp(chr(b)).encode() if b < 128
                               else bytes([b]) for b in range(256)),
                      dtype=np.uint8)
# jobs of one NW group are padded to its longest read; a group holds reads
# down to this share of that length
_GROUP_MIN_SHARE = 0.5


@dataclass
class LinearALTsResult:
    hap1: str
    hap2: str
    posterior: float
    pair_ll: np.ndarray          # [H, H]
    hap_names: list[str]
    read_gene_counts: dict[str, int]


class LinearALTsTyper:
    # a list while a caller holds one run to another (the tests, chip_smoke):
    # each NW call's scores and each pair reduction's L [H, R] and pair
    # matrix are appended, in call order
    trace: list | None = None

    def __init__(self, haplotypes: dict[str, str], band: int = 32,
                 kmer_k: int = 20,
                 genes: dict[str, tuple[int, int]] | None = None,
                 n_is_gap: bool = False, *, device: str | torch.device,
                 sharded=None):
        """haplotypes: {name: sequence} — the equal-length ALT panel
        (equal length is the reference's convention; not required here).
        genes: {gene: (start, stop)} intervals in panel coordinates.
        device: where the NW forward and the pair reduction run; with
        `sharded` (a rank's parallel.mesh.Mesh) the rank's own device.

        Alignment gaps ('-'/'_'/'.', plus 'N' when `n_is_gap` — the
        KirPackage equal-length block stores gaps as N) are STRIPPED for
        seeding/alignment/scoring: a gap is known absence of sequence, and
        scoring reads against gap placeholders made a haplotype's own
        deletion an unalignable NW wall — reads spanning it scored better
        on OTHER haplotypes, flipping true homozygous calls to confident
        wrong hets (caught by the randomized soak; regression test
        test_linear_alts.py::test_deletion_haplotype_homozygous_call).
        Anchors/insert distances live in ungapped coordinates; gene
        interval checks translate back to panel coordinates per
        haplotype."""
        self.names = list(haplotypes)
        self.seqs = [haplotypes[n] for n in self.names]
        gap_chars = "-_." + ("N" if n_is_gap else "")
        self.useqs: list[str] = []
        self.u2a: list[np.ndarray] = []
        for s in self.seqs:
            arr = np.frombuffer(s.upper().encode(), dtype=np.uint8)
            keep = ~np.isin(arr, np.frombuffer(gap_chars.encode(),
                                               dtype=np.uint8))
            self.useqs.append(arr[keep].tobytes().decode())
            self.u2a.append(np.flatnonzero(keep))
        self.index = KmerIndex.build(
            dict(zip(self.names, self.useqs)), k=kmer_k)
        self.seeder = Seeder(self.index)
        self.band = band
        self.genes = genes or {}
        self.sharded = sharded
        self._nw = NWRunner(device if sharded is None else sharded.device)
        self.device = self._nw.device
        self.stats = self._nw.stats
        self._table = phred_to_p_correct_table(conservative_cap=0.999,
                                               floor=1e-5)
        # the ungapped haplotypes end to end, as characters (scoring) and
        # as NW codes (windows)
        self._hap_lens = np.asarray([len(s) for s in self.useqs],
                                    dtype=np.int64)
        self._hap_offsets = np.concatenate(
            [[0], np.cumsum(self._hap_lens)])[:-1].astype(np.int64)
        self._hap_ascii = np.frombuffer("".join(self.useqs).encode(),
                                        dtype=np.uint8)
        self._hap_enc = _ENC[self._hap_ascii]
        # _score_ops's two base terms per quality character, each the very
        # float64 sum it adds
        log_mm = np.log(1 - 0.002)
        self._ll_match = np.empty(256, dtype=np.float64)
        self._ll_mismatch = np.empty(256, dtype=np.float64)
        for q in range(256):
            pc = float(self._table[q])
            self._ll_match[q] = log_mm + np.log(pc)
            self._ll_mismatch[q] = log_mm + np.log((1 - pc) / 3.0)

    def _panel_pos(self, hap_idx: int, upos: int) -> int:
        """Ungapped position -> panel (aligned) coordinate."""
        m = self.u2a[hap_idx]
        if len(m) == 0:
            return 0
        return int(m[min(max(upos, 0), len(m) - 1)])

    # --------------------------------------------------------------- scoring
    def _read_ll_rows(self, reads: list[FastqRead]
                      ) -> tuple[np.ndarray, list, np.ndarray]:
        """LL of every read under each panel haplotype ([R, H]; best
        alignment per haplotype, len * log(1/4) where no seed), the best
        (hap, ref_start) per read (None where nothing aligned) and the
        per-haplotype best anchor positions ([R, H] int64, -1 = unseeded).
        The reference's per-read pass (seeds, windows, one NW job per
        candidate, backtrace, score, first best in candidate order) with
        the jobs of all reads in shared NW calls."""
        R, H = len(reads), len(self.names)
        lens = np.asarray([len(r.seq) for r in reads], dtype=np.int64)
        rows = np.repeat((lens * np.log(0.25))[:, None], H, axis=1)
        pos_rows = np.full((R, H), -1, dtype=np.int64)
        anchors: list = [None] * R
        read_of, seq_idx, reverse, ref_start, _, _ = \
            self.seeder.candidates_batch_arrays([r.seq for r in reads])
        if not len(read_of):
            return rows, anchors, pos_rows
        W = self.band
        lo = ref_start - W // 2
        job_ll = np.full(len(read_of), -np.inf, dtype=np.float64)
        job_live = np.zeros(len(read_of), dtype=bool)
        for jobs in _length_groups(lens[read_of]):
            self._score_jobs(reads, lens, read_of[jobs], seq_idx[jobs],
                             reverse[jobs], lo[jobs], jobs, job_ll, job_live)
        best_ll = np.full(R, -np.inf)
        for r, h, ll, anchor in zip(
                read_of[job_live].tolist(), seq_idx[job_live].tolist(),
                job_ll[job_live].tolist(),
                (lo[job_live] + W // 2).tolist()):
            if ll > rows[r, h]:
                rows[r, h] = ll
                pos_rows[r, h] = anchor
            if ll > best_ll[r]:
                best_ll[r] = ll
                anchors[r] = (h, anchor)
        return rows, anchors, pos_rows

    def _score_jobs(self, reads, lens, read_of, seq_idx, reverse, lo, jobs,
                    job_ll, job_live) -> None:
        """Forward, backtrace and score of one length group's jobs; fills
        job_ll[jobs] and job_live[jobs] (False: no alignment, score NEG)."""
        W = self.band
        n = len(read_of)
        self.stats.n_chain_extensions += n
        L = int(lens[read_of].max())
        # oriented reads as characters, qualities and NW codes, one row per
        # read and strand in use
        keys, job_row = np.unique(read_of * 2 + reverse, return_inverse=True)
        seq_u = np.zeros((len(keys), L), dtype=np.uint8)
        qual_u = np.zeros((len(keys), L), dtype=np.uint8)
        for row, key in enumerate(keys.tolist()):
            r = reads[key >> 1]
            s = np.frombuffer(r.seq.encode("latin-1", "replace"), np.uint8)
            q = np.frombuffer(r.qual.encode("latin-1", "replace"), np.uint8)
            if key & 1:
                s, q = _COMP[s[::-1]], q[::-1]
            seq_u[row, :len(s)] = s
            qual_u[row, :len(q)] = q
        codes_u = _ENC[seq_u]
        codes_u[np.arange(L)[None, :] >= lens[keys >> 1][:, None]] = 4
        reads_arr = self._nw.host_buffer("st_reads", (n, L), np.uint8,
                                         crosses=True)
        np.take(codes_u, job_row, axis=0, out=reads_arr)
        lens_arr = self._nw.host_buffer("st_lens", (n,), np.int64,
                                        crosses=True)
        lens_arr[:] = lens[read_of]
        refs_arr = self._nw.host_buffer("st_refs", (n, L + W), np.uint8,
                                        crosses=True)
        gather_ref_windows(self._hap_enc, self._hap_offsets, self._hap_lens,
                           seq_idx, lo, L + W, refs_arr)
        from .. import native
        for a, b, (scores, end_k, end_state, pointers) in self._run_jobs(
                reads_arr, lens_arr, refs_arr):
            if LinearALTsTyper.trace is not None:
                LinearALTsTyper.trace.append(("nw_scores", scores.copy()))
            live = scores > -1e29
            sl = slice(a, b)
            bt = (native.nw_backtrace_batch(pointers, lens_arr[sl], end_k,
                                            end_state,
                                            scratch=self._nw.scratch)
                  if native.available() else None)
            if bt is None:
                ops, n_ops = _backtrace_python(pointers, lens_arr[sl], end_k,
                                               end_state, live)
            else:
                ops, n_ops = bt
            ll = self._score_ops_batch(
                ops, np.where(live, n_ops, 0), seq_u[job_row[sl]],
                qual_u[job_row[sl]], seq_idx[sl], lo[sl])
            job_ll[jobs[sl]] = ll
            job_live[jobs[sl]] = live

    def _run_jobs(self, reads_arr, lens_arr, refs_arr):
        """NWRunner.run_jobs: the forward over all jobs in calls of
        jobs_per_call jobs.  With a mesh each call goes through ShardedNW:
        its jobs split over every rank, the whole result on each."""
        if self.sharded is None:
            yield from self._nw.run_jobs(reads_arr, lens_arr, refs_arr)
            return
        from ..parallel.mesh import ShardedNW
        n, L = reads_arr.shape
        W = refs_arr.shape[1] - L
        sharded_nw = ShardedNW(self.sharded.all_data(), L, W,
                               self._nw.scoring, self.stats)
        step = self._nw.jobs_per_call(L, W)
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            yield lo, hi, sharded_nw(reads_arr[lo:hi], lens_arr[lo:hi],
                                     refs_arr[lo:hi])

    def _score_ops_batch(self, ops: np.ndarray, n_ops: np.ndarray,
                         oriented: np.ndarray, qual: np.ndarray,
                         seq_idx: np.ndarray, window_start: np.ndarray
                         ) -> np.ndarray:
        """_score_ops for a batch of jobs: ops [B, max_ops, 3] (op, read
        pos, window-relative ref pos) of which n_ops[b] count, oriented and
        qual [B, L] characters.  Op t of every job is added in one step, so
        each job's float64 sum runs in _score_ops's order and gives its
        value bit for bit."""
        log_ins = np.log(0.001) + np.log(0.25)
        log_del = np.log(0.001)
        ll = np.zeros(len(n_ops), dtype=np.float64)
        b = np.arange(len(n_ops))
        hap_len = self._hap_lens[seq_idx]
        hap_off = self._hap_offsets[seq_idx]
        last = len(self._hap_ascii) - 1
        for t in range(int(n_ops.max(initial=0))):
            active = t < n_ops
            op = ops[:, t, 0]
            rp = np.where(active, ops[:, t, 1], 0)
            p = window_start + ops[:, t, 2]
            inside = (p >= 0) & (p < hap_len)
            hap_c = self._hap_ascii[np.clip(hap_off + p, 0, last)]
            q = qual[b, rp]
            base = np.where(inside & (hap_c == oriented[b, rp]),
                            self._ll_match[q], self._ll_mismatch[q])
            term = np.where(op == 0, base,
                            np.where(op == 1, log_ins, log_del))
            ll += np.where(active, term, 0.0)
        return ll

    def _score_ops(self, ops, oriented: str, qual: str, hap: str,
                   window_start: int) -> float:
        log_ins = np.log(0.001) + np.log(0.25)
        log_del = np.log(0.001)
        log_mm = np.log(1 - 0.002)
        ll = 0.0
        for op, rp, ref_p in ops:
            if op == 0:
                p = window_start + ref_p
                pc = float(self._table[ord(qual[rp])])
                if 0 <= p < len(hap) and hap[p] == oriented[rp]:
                    ll += log_mm + np.log(pc)
                else:
                    ll += log_mm + np.log((1 - pc) / 3.0)
            elif op == 1:
                ll += log_ins
            else:
                ll += log_del
        return ll

    # ---------------------------------------------------------------- typing
    def haplotype_likelihoods(self, reads: list[FastqRead]
                              ) -> tuple[np.ndarray, list]:
        """[H, R] log-likelihood matrix + per-read best anchors."""
        rows, anchors, _pos = self._read_ll_rows(reads)
        return np.ascontiguousarray(rows.T), anchors

    def _call(self, L: np.ndarray, anchors: list) -> LinearALTsResult:
        """Best pair and its posterior over the upper triangle of the pair
        reduction of L [H, R], and the reads counted per gene."""
        if self.sharded is not None:
            m = self.sharded
            (t_lo, t_n), (r_lo, r_hi) = m.pair_share(*L.shape)
            log_progress(
                f"linear-ALT pair reduction on rank {m.rank} of a "
                f"{m.shape['data']} x {m.shape['model']} mesh (data x "
                f"model): {L.shape[0]} haplotypes, tiles [{t_lo}, "
                f"{t_lo + t_n}) of K3's {pair_tiles(L.shape[0])}, reads "
                f"[{r_lo}, {r_hi}) of {L.shape[1]}")
        pair = pair_ll_reduction(L, self.device, sharded=self.sharded)
        if LinearALTsTyper.trace is not None:
            LinearALTsTyper.trace.append(("pair", L, pair))
        H = len(self.names)
        iu = np.triu_indices(H)
        vals = pair[iu]
        best = int(np.argmax(vals))
        h1, h2 = int(iu[0][best]), int(iu[1][best])
        p = np.exp(vals - vals.max())
        p /= p.sum()

        gene_counts: dict[str, int] = {g: 0 for g in self.genes}
        for anchor in anchors:
            if anchor is None:
                continue
            hi_, pos = anchor
            pos = self._panel_pos(hi_, pos)
            for g, (lo, hi) in self.genes.items():
                if lo <= pos < hi:
                    gene_counts[g] += 1
        return LinearALTsResult(
            hap1=self.names[h1], hap2=self.names[h2],
            posterior=float(p[best]), pair_ll=pair,
            hap_names=self.names, read_gene_counts=gene_counts)

    def type_diploid(self, reads: list[FastqRead]) -> LinearALTsResult:
        """Diploid ALT-pair model (processCollectedAlignments /
        haplotypeLikelihoods semantics): LL(h1,h2) = sum_r logavg."""
        L, anchors = self.haplotype_likelihoods(reads)
        return self._call(L, anchors)

    def estimate_insert(self, pairs: list[tuple[FastqRead, FastqRead]],
                        max_pairs: int = 500) -> tuple[float, float]:
        """Insert-size estimate from mate anchor distances on the panel
        (estimateInsertSize_noGraph role, processBAM.cpp:866-989): weighted
        median for the mean, (q80-q20)/2 for the spread."""
        pairs = pairs[:max_pairs]
        _, _, pos = self._read_ll_rows([r for p in pairs for r in p])
        dists = []
        for i, (r1, r2) in enumerate(pairs):
            p1, p2 = pos[2 * i], pos[2 * i + 1]
            both = (p1 >= 0) & (p2 >= 0)
            if both.any():
                d = _outer_span(p1, p2, len(r1.seq), len(r2.seq))[both]
                dists.append(float(np.median(d)))
        if not dists:
            return 300.0, 75.0
        arr = np.asarray(dists)
        mean = float(np.median(arr))
        q20, q80 = np.quantile(arr, [0.2, 0.8])
        sd = max(float((q80 - q20) / 2.0), 1.0)
        return mean, sd

    def type_diploid_paired(self, pairs: list[tuple[FastqRead, FastqRead]],
                            insert_mean: float, insert_sd: float
                            ) -> LinearALTsResult:
        """Paired-end ALT-pair model with the insert-size term
        (processCollectedAlignments, linearALTs.h:69: per-haplotype pair
        likelihood = both mates' alignment LLs + Normal(insert) LL of their
        distance on that haplotype).  Pairs whose mates do not both anchor
        on a haplotype get the 4-sigma tail penalty instead."""
        H = len(self.names)
        sd = max(float(insert_sd), 1e-6)
        norm = -0.5 * np.log(2 * np.pi) - np.log(sd)

        def logpdf(d):
            return norm - 0.5 * ((d - insert_mean) / sd) ** 2

        tail = float(logpdf(insert_mean + 4.0 * sd))
        rows, mate_anchors, pos = self._read_ll_rows(
            [r for p in pairs for r in p])
        cols = []
        anchors = []
        for i, (r1, r2) in enumerate(pairs):
            row1, a1, p1 = rows[2 * i], mate_anchors[2 * i], pos[2 * i]
            row2, a2, p2 = (rows[2 * i + 1], mate_anchors[2 * i + 1],
                            pos[2 * i + 1])
            both = (p1 >= 0) & (p2 >= 0)
            # outer fragment span (leftmost start -> rightmost end), the
            # same metric as BAM TLEN — cli.py feeds a TLEN-derived
            # insert_mean here; a start-to-start distance would sit one
            # read length off the model for every concordant pair
            dist = _outer_span(p1, p2, len(r1.seq),
                               len(r2.seq)).astype(np.float64)
            ins = np.where(both, np.maximum(logpdf(dist), tail), tail)
            cols.append(row1 + row2 + ins)
            anchors.append(a1 if a1 is not None else a2)
        L = (np.stack(cols).T if cols
             else np.zeros((H, 0), dtype=np.float64))
        return self._call(L, anchors)

    def reads_to_genes(self, reads: list[FastqRead]) -> dict[str, list[str]]:
        """Assign each read to the gene its best alignment overlaps
        (reads2Genes equivalent)."""
        out: dict[str, list[str]] = {g: [] for g in self.genes}
        _, anchors = self.haplotype_likelihoods(reads)
        for r, anchor in zip(reads, anchors):
            if anchor is None:
                continue
            hi_, pos = anchor
            pos = self._panel_pos(hi_, pos)
            for g, (lo, hi) in self.genes.items():
                if lo <= pos < hi:
                    out[g].append(r.name)
        return out


def _length_groups(job_len: np.ndarray) -> list[np.ndarray]:
    """Job indices cut into groups of similar read length, longest first:
    a group is padded to its longest read and holds reads down to
    _GROUP_MIN_SHARE of it.  Reads of one length make one group, in job
    order."""
    order = np.argsort(-job_len, kind="stable")
    sorted_len = job_len[order]
    groups = []
    lo = 0
    while lo < len(order):
        floor = sorted_len[lo] * _GROUP_MIN_SHARE
        hi = lo + int(np.searchsorted(-sorted_len[lo:], -floor,
                                      side="right"))
        groups.append(np.sort(order[lo:hi]))
        lo = hi
    return groups


def _backtrace_python(pointers, lens, end_k, end_state, live):
    """nw_backtrace_batch's (ops [B, max_ops, 3], n_ops [B]) from the
    per-job Python backtrace, where the native library is not built."""
    B, Lp1, W = pointers.shape
    ops = np.zeros((B, 2 * (Lp1 - 1) + W, 3), dtype=np.int32)
    n_ops = np.zeros(B, dtype=np.int32)
    for bi in np.flatnonzero(live).tolist():
        one = banded_nw_backtrace(pointers[bi], int(lens[bi]),
                                  int(end_k[bi]), int(end_state[bi]))
        n_ops[bi] = len(one)
        if one:
            ops[bi, :len(one)] = one
    return ops, n_ops


def _outer_span(p1: np.ndarray, p2: np.ndarray, len1: int,
                len2: int) -> np.ndarray:
    """Fragment outer span per haplotype: leftmost mate start to rightmost
    mate end — the |TLEN| metric (invalid anchors produce garbage values
    that callers mask via `both`)."""
    return (np.maximum(p1 + len1, p2 + len2) - np.minimum(p1, p2))
