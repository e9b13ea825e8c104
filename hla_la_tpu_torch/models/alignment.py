"""Graph alignment records and linear->graph projection.

`GraphAlignment` is the dense equivalent of the reference's verboseSeedChain
(mapper/reads/verboseSeedChain.h:22-120): parallel arrays of graph levels
(-1 = insertion relative to the graph), graph characters ('_' = gap) and
sequence characters ('_' = gap), plus orientation and mapQ fields.

`project_linear_alignment` turns a banded-NW linear alignment against a
linearized haplotype into graph coordinates using the haplotype's
level-translation array — the role of transformBAMreadToInternalAlignment +
PRGContigAlignment2Seed (processBAM.cpp:4794, 2491): haplotype level-skips
become intrinsic graph gap columns ('_'/'_' with real levels, zero cost).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..ops.banded_nw import CIGAR_D, CIGAR_I, CIGAR_M
from ..utils.phred import phred_to_p_correct_table

GAP = ord("_")


@dataclass
class GraphAlignment:
    levels: np.ndarray       # [C] int64 graph level per column (-1 = insertion)
    graph_c: np.ndarray      # [C] uint8 graph char ('_' = gap)
    seq_c: np.ndarray        # [C] uint8 read char in alignment orientation
    seq_qual: np.ndarray     # [C] uint8 quality byte (0 where seq gap)
    reverse: bool
    seq_idx: int = -1        # underlying haplotype (prg_id); -1 unknown
    mapq: float = 1.0
    mapq_per_pos: np.ndarray | None = None  # [C] float posterior per column
    from_first_read: bool = True
    log_likelihood: float = 0.0

    @property
    def n_columns(self) -> int:
        return len(self.levels)

    _first_level: int | None = None
    _last_level: int | None = None
    _pos_keys: np.ndarray | None = None   # cached _position_keys (aligner)
    _lv2: np.ndarray | None = None        # [4] first/second/penult/last level

    def first_level(self) -> int:
        if self._first_level is None:
            m = self.levels[self.levels >= 0]
            self._first_level = int(m[0]) if len(m) else -1
            self._last_level = int(m[-1]) if len(m) else -1
        return self._first_level

    def last_level(self) -> int:
        if self._last_level is None:
            self.first_level()
        return self._last_level

    def graph_str(self) -> str:
        return bytes(self.graph_c).decode()

    def seq_str(self) -> str:
        return bytes(self.seq_c).decode()

    def check_concordance(self, oriented_read: str) -> None:
        """verboseSeedChain::checkChainConcordanceWithSequence equivalent."""
        s = bytes(self.seq_c[self.seq_c != GAP]).decode()
        assert s == oriented_read[:len(s)] or s in oriented_read, \
            f"alignment sequence {s!r} not concordant with read"

    def aligned_levels_per_base(self, read_length: int) -> np.ndarray:
        """Graph level for each base of the read in *sequencing* orientation
        (-1 where unaligned / inserted) — the TrueReadLevels contract."""
        out = np.full(read_length, -1, dtype=np.int64)
        base_cols = np.nonzero(self.seq_c != GAP)[0]
        i = np.arange(len(base_cols))
        keep = i < read_length
        idx = (read_length - 1 - i) if self.reverse else i
        out[idx[keep]] = self.levels[base_cols[keep]]
        return out


def project_linear_alignment(ops, oriented_read: str, oriented_qual: str,
                             hap_seq: str, hap_levels: np.ndarray,
                             window_start: int, reverse: bool,
                             seq_idx: int) -> GraphAlignment | None:
    """ops: banded-NW backtrace [(op, read_pos, window_ref_pos)] (list or
    [n, 3] int array); absolute haplotype position = window_start +
    window_ref_pos.  Fully vectorised: intrinsic graph-gap columns ('_'/'_'
    with real levels) are interleaved wherever the haplotype skips levels."""
    ops_arr = np.asarray(ops, dtype=np.int64)
    if ops_arr.size == 0:
        return None
    op = ops_arr[:, 0]
    read_pos = ops_arr[:, 1]
    ref_pos = ops_arr[:, 2]
    rb = np.frombuffer(oriented_read.encode(), dtype=np.uint8)
    qb = np.frombuffer(oriented_qual.encode(), dtype=np.uint8)
    hb = np.frombuffer(hap_seq.encode(), dtype=np.uint8)

    is_md = op != CIGAR_I
    p = window_start + ref_pos
    if is_md.any():
        pm = p[is_md]
        if pm.min() < 0 or pm.max() >= len(hb):
            return None
        lv_md = hap_levels[pm]
    else:
        lv_md = np.zeros(0, dtype=np.int64)

    # gap run before each op: for the k-th M/D op (k>0), levels skipped since
    # the previous M/D op; insertions and the first M/D op get 0
    gap_runs = np.zeros(len(op), dtype=np.int64)
    md_idx = np.nonzero(is_md)[0]
    if len(md_idx) > 1:
        gap_runs[md_idx[1:]] = np.maximum(np.diff(lv_md) - 1, 0)
    n_cols = int(gap_runs.sum()) + len(op)
    offsets = np.cumsum(gap_runs + 1) - 1        # column index of each op

    levels = np.full(n_cols, -1, dtype=np.int64)
    graph_c = np.full(n_cols, GAP, dtype=np.uint8)
    seq_c = np.full(n_cols, GAP, dtype=np.uint8)
    quals = np.zeros(n_cols, dtype=np.uint8)

    # gap columns: for op k with run g>0, columns offsets[k]-g .. offsets[k]-1
    # carry levels lv_prev+1 .. lv_now-1 (graph '_', seq '_')
    with_gaps = np.nonzero(gap_runs > 0)[0]
    if len(with_gaps):
        runs = gap_runs[with_gaps]
        total = int(runs.sum())
        # start level of each run = level of this op - run length
        start_lv = hap_levels[p[with_gaps]] - runs
        rep_start = np.repeat(start_lv, runs)
        rep_off = np.repeat(offsets[with_gaps] - runs, runs)
        within = np.arange(total) - np.repeat(np.cumsum(runs) - runs, runs)
        levels[rep_off + within] = rep_start + within

    # op columns
    md_cols = offsets[is_md]
    levels[md_cols] = lv_md
    graph_c[md_cols] = hb[p[is_md]]
    m_mask = op == CIGAR_M
    m_cols = offsets[m_mask]
    seq_c[m_cols] = rb[read_pos[m_mask]]
    quals[m_cols] = qb[read_pos[m_mask]]
    i_mask = op == CIGAR_I
    i_cols = offsets[i_mask]
    seq_c[i_cols] = rb[read_pos[i_mask]]
    quals[i_cols] = qb[read_pos[i_mask]]

    return GraphAlignment(
        levels=levels, graph_c=graph_c, seq_c=seq_c, seq_qual=quals,
        reverse=reverse, seq_idx=seq_idx,
    )


def project_batch_raw(ops: np.ndarray, n_ops: np.ndarray,
                      job_seq: np.ndarray, window_start: np.ndarray,
                      reads_ascii: np.ndarray, quals_ascii: np.ndarray,
                      hap_codes_cat: np.ndarray, hap_levels_cat: np.ndarray,
                      hap_offsets: np.ndarray, hap_lens: np.ndarray,
                      reverse: np.ndarray, long_read_mode: bool):
    """Native projection+scoring returning the raw SoA tuple
    (levels, graph_c, seq_c, qual_c, pos_keys, col_counts, col_starts,
    ll, first_lv, last_lv, lv2 [B,4], bad) — or None when the native
    library is unavailable.  The SoA pair-selection path consumes this
    directly; project_and_score_batch wraps it into GraphAlignments.

    NOTE the scoring constants/formulas appear three times (here, the
    vectorised fallback in project_and_score_batch, and score_alignment)
    and must stay in sync; they CANNOT be unified into one table helper
    because the fallback paths take logs in float32 while this path is
    float64 — changing either's rounding breaks the byte-stable output
    snapshot (tests/test_output_snapshot.py)."""
    from .. import native
    if not native.available():
        return None
    p_err = 0.075 if long_read_mode else 0.001
    log_mm = math.log(1.0 - 2 * p_err)
    table = phred_to_p_correct_table(conservative_cap=0.999, floor=1e-5)
    tab64 = table.astype(np.float64)
    return native.project_score_batch(
        ops, n_ops, job_seq, window_start, reads_ascii, quals_ascii,
        hap_codes_cat, hap_levels_cat, hap_offsets, hap_lens, reverse,
        log_mm + np.log(tab64), log_mm + np.log((1.0 - tab64) / 3.0),
        math.log(p_err) + math.log(0.25), math.log(p_err))


def project_and_score_batch(ops: np.ndarray, n_ops: np.ndarray,
                            job_seq: np.ndarray, window_start: np.ndarray,
                            reads_ascii: np.ndarray, quals_ascii: np.ndarray,
                            hap_codes_cat: np.ndarray,
                            hap_levels_cat: np.ndarray,
                            hap_offsets: np.ndarray, hap_lens: np.ndarray,
                            reverse: np.ndarray, prg_ids: np.ndarray,
                            long_read_mode: bool
                            ) -> list[GraphAlignment | None]:
    """Vectorised projection + scoring for a whole job batch.

    ops: [B, max_ops, 3] backtrace (op, read_pos, window_ref_pos); n_ops [B].
    job_seq: [B] haplotype index per job; hap_*_cat are the concatenated
    haplotype code/level arrays with [S+1] offsets and [S] lengths.
    Returns one GraphAlignment (viewing shared column arrays) per job, or
    None for empty/out-of-range jobs.  Semantics identical to
    project_linear_alignment + score_alignment per job.
    """
    B, max_ops, _ = ops.shape

    from .. import native
    if native.available():
        res = project_batch_raw(ops, n_ops, job_seq, window_start,
                                reads_ascii, quals_ascii, hap_codes_cat,
                                hap_levels_cat, hap_offsets, hap_lens,
                                reverse, long_read_mode)
        if res is not None:
            (levels, graph_c, seq_c, qual_c, pos_keys, col_counts,
             col_starts, ll, first_lv, last_lv, lv2, bad) = res
            # scalar columns -> Python lists ONCE (per-element np scalar
            # indexing in the loop is far slower), and skip the dataclass
            # __init__ by assembling each instance __dict__ directly
            skip = (bad | (col_counts == 0)).tolist()
            s_l = col_starts.tolist()
            e_l = (col_starts + col_counts).tolist()
            rev_l = reverse.tolist()
            pid_l = prg_ids.astype(np.int64).tolist()
            fl_l = first_lv.tolist()
            ll_l = last_lv.tolist()
            llh_l = ll.tolist()
            new = GraphAlignment.__new__
            out: list[GraphAlignment | None] = []
            for b in range(B):
                if skip[b]:
                    out.append(None)
                    continue
                s = s_l[b]
                e = e_l[b]
                al = new(GraphAlignment)
                al.__dict__ = {
                    "levels": levels[s:e], "graph_c": graph_c[s:e],
                    "seq_c": seq_c[s:e], "seq_qual": qual_c[s:e],
                    "reverse": rev_l[b], "seq_idx": pid_l[b],
                    "mapq": 1.0, "mapq_per_pos": None,
                    "from_first_read": True, "log_likelihood": llh_l[b],
                    "_first_level": fl_l[b], "_last_level": ll_l[b],
                    "_lv2": lv2[b], "_pos_keys": pos_keys[s:e],
                }
                out.append(al)
            return out

    valid = np.arange(max_ops)[None, :] < n_ops[:, None]
    job_f, k_f = np.nonzero(valid)             # sorted by job, then op order
    if len(job_f) == 0:
        return [None] * B
    op_f = ops[job_f, k_f, 0]
    read_pos_f = ops[job_f, k_f, 1]
    ref_pos_f = ops[job_f, k_f, 2]

    seq_f = job_seq[job_f]
    p_local = window_start[job_f] + ref_pos_f
    is_md = op_f != CIGAR_I

    # job validity: all M/D hap positions in range
    md_ok = (~is_md) | ((p_local >= 0) & (p_local < hap_lens[seq_f]))
    bad_jobs = np.zeros(B, dtype=bool)
    np.logical_or.at(bad_jobs, job_f, ~md_ok)
    bad_jobs |= n_ops == 0
    keep_f = ~bad_jobs[job_f]
    job_f, op_f, read_pos_f, ref_pos_f, seq_f, p_local, is_md = (
        a[keep_f] for a in (job_f, op_f, read_pos_f, ref_pos_f, seq_f,
                            p_local, is_md))
    if len(job_f) == 0:
        return [None] * B

    p_global = hap_offsets[seq_f] + p_local
    lv_op = np.zeros(len(job_f), dtype=np.int64)
    lv_op[is_md] = hap_levels_cat[p_global[is_md]]

    # gap run before each M/D op (reset at job boundaries)
    gap_runs = np.zeros(len(job_f), dtype=np.int64)
    md_pos = np.nonzero(is_md)[0]
    if len(md_pos) > 1:
        lv_md = lv_op[md_pos]
        same_job = job_f[md_pos[1:]] == job_f[md_pos[:-1]]
        g = np.maximum(np.diff(lv_md) - 1, 0)
        gap_runs[md_pos[1:]] = np.where(same_job, g, 0)

    col_counts = gap_runs + 1
    col_offsets = np.cumsum(col_counts) - 1      # column index of each op
    total_cols = int(col_counts.sum())

    levels = np.full(total_cols, -1, dtype=np.int64)
    graph_c = np.full(total_cols, GAP, dtype=np.uint8)
    seq_c = np.full(total_cols, GAP, dtype=np.uint8)
    qual_c = np.zeros(total_cols, dtype=np.uint8)

    with_gaps = np.nonzero(gap_runs > 0)[0]
    if len(with_gaps):
        runs = gap_runs[with_gaps]
        total = int(runs.sum())
        start_lv = lv_op[with_gaps] - runs
        rep_start = np.repeat(start_lv, runs)
        rep_off = np.repeat(col_offsets[with_gaps] - runs, runs)
        within = np.arange(total) - np.repeat(np.cumsum(runs) - runs, runs)
        levels[rep_off + within] = rep_start + within

    md_cols = col_offsets[is_md]
    levels[md_cols] = lv_op[is_md]
    graph_c[md_cols] = hap_codes_cat[p_global[is_md]]
    consumes_read = op_f != CIGAR_D
    cr_cols = col_offsets[consumes_read]
    seq_c[cr_cols] = reads_ascii[job_f[consumes_read],
                                 read_pos_f[consumes_read]]
    qual_c[cr_cols] = quals_ascii[job_f[consumes_read],
                                  read_pos_f[consumes_read]]

    # ---- scoring (scoreOneAlignment, vectorised over all columns)
    p_err = 0.075 if long_read_mode else 0.001
    log_ins = np.log(p_err) + np.log(0.25)
    log_del = np.log(p_err)
    log_mm = np.log(1.0 - 2 * p_err)
    table = phred_to_p_correct_table(conservative_cap=0.999, floor=1e-5)
    p_corr = table[qual_c]
    sgap = seq_c == GAP
    ggap = graph_c == GAP
    ll_col = np.zeros(total_cols)
    ins_m = (~sgap) & ggap
    ll_col[ins_m] = log_ins
    both = (~sgap) & (~ggap)
    mt = both & (seq_c == graph_c)
    mm = both & (seq_c != graph_c)
    ll_col[mt] = log_mm + np.log(p_corr[mt])
    ll_col[mm] = log_mm + np.log((1.0 - p_corr[mm]) / 3.0)
    ll_col[sgap & (~ggap)] = log_del

    job_of_col = np.repeat(job_f, col_counts)
    ll_per_job = np.bincount(job_of_col, weights=ll_col, minlength=B)
    cols_per_job = np.bincount(job_of_col, minlength=B)
    job_col_start = np.concatenate([[0], np.cumsum(cols_per_job)])[:-1]

    # first/last level per job from M/D levels (nondecreasing within job)
    first_lv = np.full(B, -1, dtype=np.int64)
    last_lv = np.full(B, -1, dtype=np.int64)
    md_jobs = job_f[is_md]
    if len(md_jobs):
        lv_md_all = lv_op[is_md]
        # first occurrence per job (md order is job-sorted)
        firsts = np.concatenate([[0], np.nonzero(np.diff(md_jobs))[0] + 1])
        first_lv[md_jobs[firsts]] = lv_md_all[firsts]
        lasts = np.concatenate([np.nonzero(np.diff(md_jobs))[0],
                                [len(md_jobs) - 1]])
        last_lv[md_jobs[lasts]] = lv_md_all[lasts]

    out: list[GraphAlignment | None] = []
    for b in range(B):
        if bad_jobs[b] or cols_per_job[b] == 0:
            out.append(None)
            continue
        s = int(job_col_start[b])
        e = s + int(cols_per_job[b])
        al = GraphAlignment(
            levels=levels[s:e], graph_c=graph_c[s:e], seq_c=seq_c[s:e],
            seq_qual=qual_c[s:e], reverse=bool(reverse[b]),
            seq_idx=int(prg_ids[b]),
        )
        al._first_level = int(first_lv[b])
        al._last_level = int(last_lv[b])
        al.log_likelihood = float(ll_per_job[b])
        out.append(al)
    return out


def score_alignment(al: GraphAlignment, long_read_mode: bool = False) -> float:
    """Per-column alignment log-likelihood — faithful vectorised port of
    extensionAligner::scoreOneAlignment (extensionAligner.cpp:52-185):
    insertion rate 0.001 (0.075 long reads) + log(1/4) per inserted base,
    deletion ditto, match log(pCorrect) / mismatch log((1-pCorrect)/3) with
    pCorrect capped at 0.999, floored at 1e-5."""
    p = 0.075 if long_read_mode else 0.001
    log_ins = np.log(p)
    log_del = np.log(p)
    log_mm = np.log(1.0 - 2 * p)

    seq_gap = al.seq_c == GAP
    graph_gap = al.graph_c == GAP

    table = phred_to_p_correct_table(conservative_cap=0.999, floor=1e-5)
    p_corr = table[al.seq_qual]

    ll = np.zeros(al.n_columns, dtype=np.float64)
    # seq non-gap, graph gap: insertion
    ins = (~seq_gap) & graph_gap
    ll[ins] = log_ins + np.log(0.25)
    # both defined: match/mismatch
    both = (~seq_gap) & (~graph_gap)
    match = both & (al.seq_c == al.graph_c)
    mism = both & (al.seq_c != al.graph_c)
    ll[match] = log_mm + np.log(p_corr[match])
    ll[mism] = log_mm + np.log((1.0 - p_corr[mism]) / 3.0)
    # seq gap, graph non-gap: deletion
    dele = seq_gap & (~graph_gap)
    ll[dele] = log_del
    # seq gap + graph gap: intrinsic graph gap, likelihood 1
    return float(ll.sum())


def alignment_fraction_ok(al: GraphAlignment) -> float:
    """HLATyper::alignmentFractionOK (HLATyper.cpp:3082-3101)."""
    both_gap = (al.graph_c == GAP) & (al.seq_c == GAP)
    checked = ~both_gap
    n_checked = int(checked.sum())
    if n_checked == 0:
        return 0.0
    ok = checked & (al.graph_c == al.seq_c)
    return float(ok.sum()) / n_checked


def fraction_ok_batch(chains: list[GraphAlignment]) -> np.ndarray:
    """Vectorised alignment_fraction_ok over many chains: one concatenated
    pass + per-chain reduceat counts (integer counts, so the result is
    bit-identical to the scalar form for any non-empty chain).  Fills each
    chain's _frac_ok cache; cached chains are skipped."""
    out = np.empty(len(chains), dtype=np.float64)
    todo = []
    for i, c in enumerate(chains):
        f = getattr(c, "_frac_ok", None)
        if f is None:
            todo.append(i)
        else:
            out[i] = f
    if not todo:
        return out
    gc = np.concatenate([chains[i].graph_c for i in todo])
    sc = np.concatenate([chains[i].seq_c for i in todo])
    lens = np.fromiter((chains[i].n_columns for i in todo), np.int64,
                       len(todo))
    offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
    both_gap = (gc == GAP) & (sc == GAP)
    checked = ~both_gap
    ok = checked & (gc == sc)
    n_checked = np.add.reduceat(checked, offs)
    n_ok = np.add.reduceat(ok, offs)
    vals = np.where(n_checked > 0, n_ok / np.maximum(n_checked, 1), 0.0)
    for k, i in enumerate(todo):
        v = float(vals[k])
        chains[i]._frac_ok = v
        out[i] = v
    return out


def alignment_weighted_ok_fraction(al: GraphAlignment) -> float:
    """HLATyper::alignmentWeightedOKFraction: 1 - weightedMismatches /
    consideredPositions, where a graph-gap opposite a base counts 1, a
    mismatch counts pCorrect (HLATyper.cpp:3001-3080).  Cached per object."""
    cached = getattr(al, "_wok", None)
    if cached is not None:
        return cached
    table = phred_to_p_correct_table(conservative_cap=None, floor=None)
    seq_base = al.seq_c != GAP
    graph_gap = al.graph_c == GAP
    considered = int(seq_base.sum())
    if considered == 0:
        return 0.0
    p_corr = table[al.seq_qual]
    ins = seq_base & graph_gap
    mism = seq_base & (~graph_gap) & (al.seq_c != al.graph_c)
    weighted = float(ins.sum()) + float(np.maximum(p_corr[mism], 0.0).sum())
    out = 1.0 - weighted / considered
    al._wok = out
    return out


def weighted_ok_fractions_batch(chains: list[GraphAlignment]) -> np.ndarray:
    """Vectorised alignment_weighted_ok_fraction over many chains: ONE
    concatenated pass + per-chain bincount sums (a Python loop over tens of
    thousands of chains is slow at WGS scale).  Fills each chain's _wok
    cache so later scalar calls are hits.  Summation runs per chain in
    column order — last-ulp rounding may differ from the scalar np.sum
    (pairwise) path, which never observes the same chain twice because of
    the cache."""
    out = np.empty(len(chains), dtype=np.float64)
    todo = []
    for i, c in enumerate(chains):
        w = getattr(c, "_wok", None)
        if w is None:
            todo.append(i)
        else:
            out[i] = w
    if not todo:
        return out
    table = phred_to_p_correct_table(conservative_cap=None, floor=None)
    seq_c = np.concatenate([chains[i].seq_c for i in todo])
    graph_c = np.concatenate([chains[i].graph_c for i in todo])
    qual = np.concatenate([chains[i].seq_qual for i in todo])
    lens = np.asarray([chains[i].n_columns for i in todo], dtype=np.int64)
    cid = np.repeat(np.arange(len(todo)), lens)
    nt = len(todo)
    seq_base = seq_c != GAP
    graph_gap = graph_c == GAP
    considered = np.bincount(cid, weights=seq_base.astype(np.float64),
                             minlength=nt)
    ins = (seq_base & graph_gap).astype(np.float64)
    mism = seq_base & (~graph_gap) & (seq_c != graph_c)
    wm = np.where(mism, np.maximum(table[qual], 0.0), 0.0)
    weighted = (np.bincount(cid, weights=ins, minlength=nt)
                + np.bincount(cid, weights=wm, minlength=nt))
    vals = np.where(considered > 0,
                    1.0 - weighted / np.maximum(considered, 1.0), 0.0)
    for k, i in enumerate(todo):
        v = float(vals[k])
        chains[i]._wok = v
        out[i] = v
    return out


def strands_valid(a1: GraphAlignment, a2: GraphAlignment) -> bool:
    """alignerBase::alignedReadPair_strandsValid (alignerBase.cpp:213-244)."""
    if a1.first_level() == -1 or a2.first_level() == -1:
        return False
    if a1.reverse == a2.reverse:
        return False
    if not a1.reverse:
        return a1.first_level() < a2.first_level()
    return a1.last_level() > a2.last_level()


def pair_distance_graph_levels(a1: GraphAlignment, a2: GraphAlignment) -> int:
    """alignerBase::alignedReadPair_pairsDistanceInGraphLevels
    (alignerBase.cpp:246-288)."""
    if a1.first_level() < a2.first_level():
        return a2.first_level() - a1.last_level() - 1
    return a1.first_level() - a2.last_level() - 1


def _anchors(al: GraphAlignment, from_end: bool, scan: int,
             level_to_seqpos: dict[int, dict[int, int]]) -> dict[int, int]:
    if scan == 2 and al._lv2 is not None:
        f1, f2, l2, l1 = al._lv2.tolist()
        order = [x for x in ((l1, l2) if from_end else (f1, f2)) if x >= 0]
    else:
        lv = al.levels[al.levels >= 0]
        if len(lv) == 0:
            return {}
        take = lv[-scan:] if from_end else lv[:scan]
        order = (reversed(take.tolist()) if from_end
                 else iter(take.tolist()))
    out: dict[int, int] = {}
    for l in order:
        m = level_to_seqpos.get(int(l))
        if m:
            for sid, pos in m.items():
                out.setdefault(sid, pos)
    return out


def pair_distances_underlying(a1: GraphAlignment, a2: GraphAlignment,
                              level_to_seqpos: dict[int, dict[int, int]]
                              ) -> set[int]:
    """alignerBase::alignedReadPair_pairsDistancesUnderlyingSequences
    (alignerBase.cpp:290-334): distance between mate end/start positions on
    each shared underlying linearized sequence."""
    scan = 2
    if a1.first_level() < a2.first_level():
        end1 = _anchors(a1, True, scan, level_to_seqpos)
        beg2 = _anchors(a2, False, scan, level_to_seqpos)
        return {beg2[sid] - p - 1 for sid, p in end1.items() if sid in beg2}
    end2 = _anchors(a2, True, scan, level_to_seqpos)
    beg1 = _anchors(a1, False, scan, level_to_seqpos)
    return {beg1[sid] - p - 1 for sid, p in end2.items() if sid in beg1}
