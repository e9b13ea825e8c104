"""Chain-enriched global alignment of one query against one reference.

Reference: globalAlignment.pl — bwa/minimap2-seeded chains, a chain-
compatibility DP (scores S_match=1, S_mismatch=-1, S_gap=-1, lines 13-15 +
119-260), then stitching the chosen chains into ONE global alignment; output
is three lines: "n_mismatches refStart-refStop strand0-queryEnd", the
aligned reference string, the aligned query string (lines 487-505).

TPU-native form: k-mer diagonal chains from the same index the production
seeder uses; the chain DP in numpy; inter-chain and intra-chain stitching
via the batched banded-NW kernel with unit scoring."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.banded_nw import (CIGAR_D, CIGAR_I, CIGAR_M, NWScoring,
                             banded_nw_backtrace, banded_nw_forward)
from ..sim.read_sim import revcomp
from .kmer_index import KmerIndex, encode_kmers

_ENC = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _ENC[b] = i
    _ENC[b + 32] = i

UNIT = NWScoring(match=1.0, mismatch=-1.0, gap_open=-1.0, gap_extend=-1.0)
S_MATCH, S_MISMATCH, S_GAP = 1.0, -1.0, -1.0


@dataclass
class _Chain:
    q_first: int
    q_last: int
    r_first: int
    r_last: int
    n_kmers: int


def _collect_chains(query: str, ref_index: KmerIndex, k: int,
                    slack: int = 24) -> list[_Chain]:
    qb = np.frombuffer(query.encode("latin-1", "replace"), dtype=np.uint8)
    codes, valid = encode_kmers(qb, k)
    qi, gp = ref_index.query_codes(codes, valid)
    if len(qi) == 0:
        return []
    _, rpos = ref_index.locate(gp)
    diag = rpos - qi
    band = diag // slack
    order = np.lexsort((qi, band))
    b_sorted = band[order]
    starts = np.concatenate([[0], np.nonzero(np.diff(b_sorted))[0] + 1])
    ends = np.concatenate([starts[1:], [len(b_sorted)]])
    chains = []
    for s, e in zip(starts, ends):
        idx = order[s:e]
        q0, q1 = int(qi[idx].min()), int(qi[idx].max()) + k - 1
        r0 = int(rpos[idx].min())
        r1 = int(rpos[idx].max()) + k - 1
        chains.append(_Chain(q0, q1, r0, r1, len(idx)))
    return chains


def _chain_dp(chains: list[_Chain], q_len: int, r_len: int
              ) -> list[_Chain]:
    """Pick a compatible (strictly increasing in query AND reference) chain
    subset maximizing anchored score minus inter-chain gap penalties,
    with SYMMETRIC entry and exit gap costs
    (globalAlignment.pl:172-260 semantics — without the exit term the
    selection strands query/reference tails for free)."""
    chains = sorted(chains, key=lambda c: (c.r_first, c.q_first))
    n = len(chains)
    best = np.full(n, -np.inf)
    prev = np.full(n, -1, dtype=np.int64)
    for i, c in enumerate(chains):
        anchor = S_MATCH * c.n_kmers
        # entry: gaps to the start of query+reference
        best[i] = anchor + S_GAP * (c.q_first + c.r_first)
        for j in range(i):
            p = chains[j]
            # allow a small boundary overlap (adjacent chains share up to
            # k-1 end-extension bases; the stitcher trims it) but require
            # strictly increasing ends
            oq = p.q_last - c.q_first + 1
            orr = p.r_last - c.r_first + 1
            if (oq < 24 and orr < 24 and p.q_last < c.q_last
                    and p.r_last < c.r_last):
                dq = max(c.q_first - p.q_last - 1, 0)
                dr = max(c.r_first - p.r_last - 1, 0)
                cand = best[j] + anchor + S_GAP * abs(dq - dr) \
                    + S_MISMATCH * min(dq, dr) * 0.5
                if cand > best[i]:
                    best[i] = cand
                    prev[i] = j
    if n == 0:
        return []
    exit_scores = best + S_GAP * np.asarray(
        [(q_len - 1 - c.q_last) + (r_len - 1 - c.r_last) for c in chains])
    i = int(np.argmax(exit_scores))
    out = []
    while i >= 0:
        out.append(chains[i])
        i = int(prev[i])
    return list(reversed(out))


def _nw_pair(a: str, b: str) -> tuple[str, str]:
    """Global unit-score alignment of two (short-ish) segments via the
    banded kernel; band covers the length difference."""
    if not a and not b:
        return "", ""
    if not a:
        return "-" * len(b), b
    if not b:
        return a, "-" * len(a)
    W = max(16, abs(len(a) - len(b)) + 16)
    if len(a) * (W + 2) > 50_000_000:
        # the banded DP is O(len(a) * W); wildly different lengths (e.g.
        # the no-seed fallback of a short query vs a multi-Mb reference)
        # would allocate a multi-GB pointer tensor — emit a full indel
        # alignment instead
        return a + "-" * len(b), "-" * len(a) + b
    # round band up to even to keep the kernel's center placement stable
    reads = np.full((1, len(a)), 4, dtype=np.uint8)
    reads[0] = _ENC[np.frombuffer(a.encode("latin-1", "replace"),
                                  np.uint8)]
    lens = np.asarray([len(a)], dtype=np.int64)
    refs = np.full((1, len(a) + W), 4, dtype=np.uint8)
    rb = _ENC[np.frombuffer(b.encode("latin-1", "replace"), np.uint8)]
    off = W // 2
    usable = min(len(b), len(a) + W - off)
    refs[0, off:off + usable] = rb[:usable]
    scores, end_k, end_state, pointers = banded_nw_forward(
        reads, lens, refs, UNIT)
    if scores[0] <= -1e29:
        # no banded path: emit as full indel
        return a + "-" * len(b), "-" * len(a) + b
    ops = banded_nw_backtrace(pointers[0], len(a), int(end_k[0]),
                              int(end_state[0]))
    a_out, b_out = [], []
    b_seen = set()
    for op, apos, rpos in ops:
        bpos = rpos - off
        if op == CIGAR_M:
            a_out.append(a[apos])
            if 0 <= bpos < len(b):
                b_out.append(b[bpos])
                b_seen.add(bpos)
            else:
                b_out.append("-")
        elif op == CIGAR_I:       # query-consuming
            a_out.append(a[apos])
            b_out.append("-")
        else:                     # CIGAR_D: reference-consuming
            a_out.append("-")
            if 0 <= bpos < len(b):
                b_out.append(b[bpos])
                b_seen.add(bpos)
            else:
                b_out.append("-")
    # b positions the banded path never visited (pads outside the band):
    # emit as pure insertions in b at the appropriate end.  b_seen holds a
    # contiguous-ish visited span; only positions before its min / after
    # its max can be missing, so two range slices suffice (per-position
    # min()/max() scans were O(len(b) * |b_seen|))
    if b_seen:
        b_lo, b_hi = min(b_seen), max(b_seen)
        missing_head = [i for i in range(min(b_lo, len(b)))
                        if i not in b_seen]
        missing_tail = [i for i in range(b_hi + 1, len(b))
                        if i not in b_seen]
    else:
        missing_head = list(range(len(b)))
        missing_tail = []
    head_a = "-" * len(missing_head)
    head_b = "".join(b[i] for i in missing_head)
    tail_a = "-" * len(missing_tail)
    tail_b = "".join(b[i] for i in missing_tail)
    return head_a + "".join(a_out) + tail_a, \
        head_b + "".join(b_out) + tail_b


def global_alignment(query: str, reference: str, k: int = 16
                     ) -> tuple[str, str, int, tuple[int, int], str]:
    """-> (aligned_reference, aligned_query, n_mismatches,
    (ref_first, ref_last), strand)."""
    ref_index = KmerIndex.build({"ref": reference}, k=k)
    best = None
    for strand, q in (("+", query), ("-", revcomp(query))):
        chains = _chain_dp(_collect_chains(q, ref_index, k),
                           len(q), len(reference))
        if not chains:
            continue
        score_proxy = sum(c.n_kmers for c in chains)
        if best is None or score_proxy > best[0]:
            best = (score_proxy, strand, q, chains)
    if best is None:
        # no seeds at all: full-length NW (unit scores)
        a_q, a_r = _nw_pair(query, reference)
        mism = sum(1 for x, y in zip(a_q, a_r)
                   if x != "-" and y != "-" and x.upper() != y.upper())
        return a_r, a_q, mism, (0, len(reference) - 1), "+"
    _, strand, q, chains = best

    ref_parts, q_parts = [], []
    last_q = last_r = -1
    for c in chains:
        # trim any small boundary overlap with the previous chain (the
        # chain DP tolerates up to k-1 shared end-extension bases)
        t = max(last_q + 1 - c.q_first, last_r + 1 - c.r_first, 0)
        q_first, r_first = c.q_first + t, c.r_first + t
        if q_first > c.q_last or r_first > c.r_last:
            continue
        # stitch the gap before this chain
        q_seg = q[last_q + 1:q_first]
        r_seg = reference[last_r + 1:r_first]
        a_q, a_r = _nw_pair(q_seg, r_seg)
        q_parts.append(a_q)
        ref_parts.append(a_r)
        # the chain body: equal-length diagonal run (allow mismatches)
        q_body = q[q_first:c.q_last + 1]
        r_body = reference[r_first:c.r_last + 1]
        if len(q_body) == len(r_body):
            q_parts.append(q_body)
            ref_parts.append(r_body)
        else:
            a_q, a_r = _nw_pair(q_body, r_body)
            q_parts.append(a_q)
            ref_parts.append(a_r)
        last_q, last_r = c.q_last, c.r_last
    # tails
    a_q, a_r = _nw_pair(q[last_q + 1:], reference[last_r + 1:])
    q_parts.append(a_q)
    ref_parts.append(a_r)

    aligned_q = "".join(q_parts)
    aligned_r = "".join(ref_parts)
    assert aligned_q.replace("-", "") == q
    assert aligned_r.replace("-", "") == reference
    mism = sum(1 for x, y in zip(aligned_q, aligned_r)
               if x != "-" and y != "-" and x.upper() != y.upper())
    ref_cols = [i for i, ch in enumerate(aligned_r) if ch != "-"]
    q_cols = [i for i, ch in enumerate(aligned_q) if ch != "-"]
    lo = 0
    hi = len(reference) - 1
    # emitted reference span bounded by where the query actually aligns
    if q_cols:
        first_qc, last_qc = q_cols[0], q_cols[-1]
        r_before = sum(1 for i in ref_cols if i < first_qc)
        r_inside = sum(1 for i in ref_cols if first_qc <= i <= last_qc)
        lo = r_before
        hi = r_before + max(r_inside - 1, 0)
    return aligned_r, aligned_q, mism, (lo, hi), strand


def write_global_alignment(path: str, query: str, reference: str,
                           k: int = 16) -> tuple[int, str]:
    """globalAlignment.pl output contract (lines 487-505): header line
    'n_mismatches refFirst-refLast strand0-queryLen', aligned reference,
    aligned query."""
    a_r, a_q, mism, (lo, hi), strand = global_alignment(query, reference, k)
    with open(path, "w") as fh:
        # query end is the LAST 0-based index (maxPos_contig,
        # globalAlignment.pl:488)
        fh.write(f"{mism} {lo}-{hi} {strand}0-{len(query) - 1}\n")
        fh.write(a_r + "\n")
        fh.write(a_q + "\n")
    return mism, strand
