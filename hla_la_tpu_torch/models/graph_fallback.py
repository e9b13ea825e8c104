"""Graph-space re-alignment fallback.

The production path aligns each read linearly against candidate haplotype
windows (docs/DESIGN.md §2).  A read sampled from a *recombinant* path — a
crossover between panel haplotypes inside the window — scores poorly against
every single haplotype.  This module re-aligns such reads with the faithful
graph-space DP (ops/graph_dp.py, the extendSeedChain equivalent): anchor at a
confident match column of the best linear chain, then extend left+right
through the graph, where the DP is free to switch paths mid-read.

Haplotype node paths (graph node entered at every level, per linearized
haplotype) are reconstructed once per package by walking the graph along the
haplotype emissions — the information the reference carries implicitly in
its bwa-seed projection (processBAM::alignment2Chain).
"""

from __future__ import annotations

import numpy as np

from ..graph.compile import CompiledPRG
from ..ops.graph_dp import extend_graph_dp
from .alignment import GraphAlignment, score_alignment

GAP = ord("_")


def walk_haplotype(cprg: CompiledPRG, hap_seq: str, hap_levels: np.ndarray,
                   lv_lo: int = 0, lv_hi: int | None = None
                   ) -> np.ndarray | None:
    """Node entered at each level in [lv_lo, lv_hi] (default whole graph)
    for a path that emits this haplotype (char at its levels, '_'
    elsewhere).  BFS with parent pointers from every node at lv_lo (any
    consistent path through the window); returns None if none exists.
    Windowing keeps realignment O(read window), not O(graph), on
    multi-M-level PRGs."""
    n_levels = cprg.n_levels
    if lv_hi is None:
        lv_hi = n_levels - 1
    # window-local emission row (row[i] = emission at level lv_lo+i):
    # building a GLOBAL row made every walk O(graph) on 3M-level PRGs
    # (np.full + full scatter + whole-haplotype encode per call)
    row = np.full(lv_hi - lv_lo, GAP, dtype=np.uint8)
    s = int(np.searchsorted(hap_levels, lv_lo))
    e = int(np.searchsorted(hap_levels, lv_hi))
    if e > s:
        row[hap_levels[s:e] - lv_lo] = np.frombuffer(
            hap_seq[s:e].encode(), dtype=np.uint8)

    from .. import native
    if native.available():
        return native.walk_haplotype(cprg, row, lv_lo, lv_hi)

    frontier = {int(n): None for n in range(cprg.level_offsets[lv_lo],
                                            cprg.level_offsets[lv_lo + 1])}
    parents: list[dict[int, int | None]] = [dict(frontier)]
    for lv in range(lv_lo, lv_hi):
        want = row[lv - lv_lo]
        nxt: dict[int, int] = {}
        for node in frontier:
            for e in cprg.out_edges[cprg.out_offsets[node]:
                                    cprg.out_offsets[node + 1]]:
                if cprg.edge_emission[e] == want:
                    tgt = int(cprg.edge_to[e])
                    if tgt not in nxt:
                        nxt[tgt] = node
        if not nxt:
            return None
        parents.append(nxt)
        frontier = nxt
    # backtrack one complete path over the window
    path = np.empty(lv_hi - lv_lo + 1, dtype=np.int64)
    node = next(iter(frontier))
    for i in range(lv_hi - lv_lo, -1, -1):
        path[i] = node
        node = parents[i][node]
    return path


class GraphRealigner:
    def __init__(self, cprg: CompiledPRG, hap_seqs: list[str],
                 hap_levels: list[np.ndarray]):
        self.cprg = cprg
        self.hap_seqs = hap_seqs
        self.hap_levels = hap_levels
        self._paths: dict[int, np.ndarray | None] = {}

    # windowed path cache: levels are bucketed into blocks so nearby reads
    # on the same haplotype share one walk (O(block), not O(graph))
    _BLOCK = 65536
    _MARGIN = 2048

    def _node_path_window(self, hap_idx: int, lv: int
                          ) -> tuple[np.ndarray, int] | None:
        """(path, lv_lo) covering at least [lv - MARGIN, lv + MARGIN]."""
        blk = lv // self._BLOCK
        key = (hap_idx, blk)
        if key not in self._paths:
            if len(self._paths) >= 256:
                # bound the cache (~560KB/entry): fallback reads scattered
                # over many (haplotype, block) pairs on a multi-M-level
                # graph would otherwise retain GBs for the aligner's life
                self._paths.clear()
            lv_lo = max(0, blk * self._BLOCK - self._MARGIN)
            lv_hi = min(self.cprg.n_levels - 1,
                        (blk + 1) * self._BLOCK + self._MARGIN)
            path = walk_haplotype(self.cprg, self.hap_seqs[hap_idx],
                                  self.hap_levels[hap_idx], lv_lo, lv_hi)
            self._paths[key] = (path, lv_lo) if path is not None else None
        return self._paths[key]

    def realign(self, chain: GraphAlignment, hap_idx: int,
                oriented_read: str, oriented_qual: str,
                long_reads: bool = False) -> GraphAlignment | None:
        """Re-align the read through the graph, anchored at the best match
        column of the linear chain.  Returns a new GraphAlignment (rescored)
        or None if no better alignment was found."""
        # anchor: middle-most matching column
        match_cols = np.nonzero(
            (chain.seq_c == chain.graph_c) & (chain.seq_c != GAP)
            & (chain.levels >= 0))[0]
        if len(match_cols) == 0:
            return None
        c_star = int(match_cols[len(match_cols) // 2])
        lv = int(chain.levels[c_star])
        # read position consumed through column c_star (0-based)
        y_after = int((chain.seq_c[:c_star + 1] != GAP).sum())

        win = self._node_path_window(hap_idx, lv)
        if win is None:
            return None
        path, lv_lo = win
        z_right = int(path[lv + 1 - lv_lo]
                      - self.cprg.level_offsets[lv + 1])
        z_left = int(path[lv - lv_lo] - self.cprg.level_offsets[lv])

        right = extend_graph_dp(self.cprg, oriented_read, y_after, lv + 1,
                                z_right, positive=True)
        left = extend_graph_dp(self.cprg, oriented_read, y_after - 1, lv,
                               z_left, positive=False)

        cols_lv: list[int] = []
        cols_g: list[int] = []
        cols_s: list[int] = []
        cols_q: list[int] = []
        qb = oriented_qual.encode()
        rb = oriented_read.encode()

        def push(levels, gchars, schars, read_base_start):
            i = read_base_start
            for l, g, s in zip(levels, gchars.encode(), schars.encode()):
                cols_lv.append(l)
                cols_g.append(g)
                cols_s.append(s)
                if s != GAP:
                    cols_q.append(qb[i])
                    i += 1
                else:
                    cols_q.append(0)
            return i

        def pad_unaligned(lo, hi):
            # read bases the local extension did not cover: insertion columns
            # (extendToFullSequenceLength equivalent)
            for i in range(lo, hi):
                cols_lv.append(-1)
                cols_g.append(GAP)
                cols_s.append(rb[i])
                cols_q.append(qb[i])

        n_left_bases = y_after - 1
        if left is not None:
            covered = sum(1 for s in left.seq_chars if s != "_")
            pad_unaligned(0, n_left_bases - covered)
            push(left.levels, left.graph_chars, left.seq_chars,
                 n_left_bases - covered)
        else:
            pad_unaligned(0, n_left_bases)
        # anchor column
        cols_lv.append(lv)
        cols_g.append(int(chain.graph_c[c_star]))
        cols_s.append(rb[y_after - 1])
        cols_q.append(qb[y_after - 1])
        if right is not None:
            end = push(right.levels, right.graph_chars, right.seq_chars,
                       y_after)
            pad_unaligned(end, len(oriented_read))
        else:
            pad_unaligned(y_after, len(oriented_read))

        al = GraphAlignment(
            levels=np.asarray(cols_lv, dtype=np.int64),
            graph_c=np.asarray(cols_g, dtype=np.uint8),
            seq_c=np.asarray(cols_s, dtype=np.uint8),
            seq_qual=np.asarray(cols_q, dtype=np.uint8),
            reverse=chain.reverse, seq_idx=chain.seq_idx)
        al.from_first_read = chain.from_first_read
        al.log_likelihood = score_alignment(al, long_reads)
        if al.log_likelihood <= chain.log_likelihood:
            return None
        return al
