"""Graph-space banded extension DP — faithful reimplementation of the
reference's fullNeedleman_diagonal_extension_gapJumper
(extensionAligner.cpp:335-1557).

Role in this framework: the production path aligns reads linearly against
candidate haplotype windows (ops/banded_nw.py) and projects; this module is
the *graph-aware* DP that (a) verifies the fast path, (b) serves as fallback
for reads whose best linear alignment is poor (mosaic/recombinant reads), and
(c) powers the testChainExtension exactness property.

Semantics preserved: 3 states D / GraphGap / SequenceGap over cells
(level x, seqpos y, node-in-level z); diagonal-wise sweep; per-diagonal
pruning (drop cells > 15 below the diagonal max); stop after 40 diagonals
without maximum improvement; cells below -16 not propagated; gap-jumper
transitions through precomputed all-gap edge paths (zero cost, S_graphGap=0).
Tie-breaking is deterministic (first max) — the reference randomises equal
maxima, so bit-exactness was never a reference property (SURVEY.md §7)."""

from __future__ import annotations

from dataclasses import dataclass

from ..graph.compile import CompiledPRG
from ..utils.config import DPScoring

NEG = -1e30
GAP = ord("_")

# state indices
D, GG, SG = 0, 1, 2


@dataclass
class GraphExtension:
    graph_chars: str      # aligned graph characters ('_' = gap)
    levels: list[int]     # per column; -1 for insertion columns
    seq_chars: str        # aligned read characters ('_' = gap)
    score: float
    end_level: int
    end_seq: int
    end_z: int


def _succ(cprg: CompiledPRG, level: int, z: int):
    node = cprg.node_of(level, z)
    out = []
    for e in cprg.out_edges[cprg.out_offsets[node]:cprg.out_offsets[node + 1]]:
        out.append((int(cprg.node_z[cprg.edge_to[e]]),
                    int(cprg.edge_emission[e])))
    return out


def _pred(cprg: CompiledPRG, level: int, z: int):
    node = cprg.node_of(level, z)
    out = []
    for e in cprg.in_edges[cprg.in_offsets[node]:cprg.in_offsets[node + 1]]:
        out.append((int(cprg.node_z[cprg.edge_from[e]]),
                    int(cprg.edge_emission[e])))
    return out


def _jumps(cprg: CompiledPRG, level: int, z: int, positive: bool):
    node = cprg.node_of(level, z)
    out = []
    if positive:
        for j in cprg.jump_out[cprg.jump_out_offsets[node]:
                               cprg.jump_out_offsets[node + 1]]:
            tgt = int(cprg.jump_to[j])
            out.append((int(cprg.node_level[tgt]), int(cprg.node_z[tgt]),
                        int(cprg.jump_len[j])))
    else:
        for j in cprg.jump_in[cprg.jump_in_offsets[node]:
                              cprg.jump_in_offsets[node + 1]]:
            src = int(cprg.jump_from[j])
            out.append((int(cprg.node_level[src]), int(cprg.node_z[src]),
                        int(cprg.jump_len[j])))
    return out


def extend_graph_dp(cprg: CompiledPRG, sequence: str, start_seq: int,
                    start_level: int, start_z: int, positive: bool,
                    max_level: int | None = None,
                    max_seq: int | None = None,
                    sc: DPScoring = DPScoring()) -> GraphExtension | None:
    """Local extension from (start_level, start_z, start_seq) in the given
    direction; returns the best-scoring extension (None if no positive
    score).  Coordinates follow the reference: cell (x, y, z) = alignment
    consuming graph levels up to x and sequence prefix y."""
    seq_b = sequence.encode()
    n_levels = cprg.n_levels
    if positive:
        lim_level = n_levels - 1 if max_level is None else max_level
        lim_seq = len(sequence) if max_seq is None else max_seq
    else:
        lim_level = 0 if max_level is None else max_level
        lim_seq = 0 if max_seq is None else max_seq

    from .. import native
    if native.available():
        res = native.graph_extend(cprg, sequence, start_seq, start_level,
                                  start_z, positive, lim_level, lim_seq, sc)
        if res is False:
            return None
        if res is not None:
            g, lv, s, score, ex, ey, ez = res
            return GraphExtension(graph_chars=g, levels=lv, seq_chars=s,
                                  score=score, end_level=ex, end_seq=ey,
                                  end_z=ez)

    # scores[(x,y,z)] = [D, GG, SG]; backtrace[(x,y,z,state)] =
    #   (px,py,pz,pstate, emit_graph, emit_seq, emit_levels)
    scores: dict[tuple, list[float]] = {
        (start_level, start_seq, start_z): [0.0, NEG, NEG]}
    backtrace: dict[tuple, tuple] = {}

    current_max = 0.0
    maxima: list[tuple] = [(start_level, start_seq, start_z)]
    last_improve = 0
    frontier_m1 = [(start_level, start_seq, start_z)]
    frontier_m2: list[tuple] = []

    step = 1 if positive else -1

    def in_bounds(x, y):
        if positive:
            return x <= lim_level and y <= lim_seq
        return x >= lim_level and y >= lim_seq

    diagonals = len(sequence) + n_levels
    for diag in range(1, diagonals + 1):
        if diag - last_improve > sc.max_nonincrease_diagonals:
            break
        cand: dict[tuple, list[list[tuple[float, tuple]]]] = {}

        def push(cell, state, score, bt):
            slot = cand.setdefault(cell, [[], [], []])
            slot[state].append((score, bt))

        # from m-2 diagonal: match/mismatch
        for (px, py, pz) in frontier_m2:
            nx, ny = px + step, py + step
            if not in_bounds(nx, ny):
                continue
            s_em = seq_b[py] if positive else seq_b[py - 1]
            prev_d = scores[(px, py, pz)][D]
            if prev_d <= NEG / 2:
                continue
            nbrs = _succ(cprg, px, pz) if positive else _pred(cprg, px, pz)
            for nz, em in nbrs:
                val = prev_d + (sc.match if em == s_em else sc.mismatch)
                push((nx, ny, nz), D, val,
                     (px, py, pz, D, em, s_em, nx - 1 if positive else nx))

        # from m-1 diagonal: gaps and jumps
        for (px, py, pz) in frontier_m1:
            sc_prev = scores[(px, py, pz)]
            # gap in graph (consume sequence char)
            nx, ny = px, py + step
            if in_bounds(nx, ny):
                s_em = seq_b[py] if positive else seq_b[py - 1]
                if sc_prev[D] > NEG / 2:
                    push((nx, ny, pz), GG,
                         sc_prev[D] + sc.open_gap + sc.extend_gap,
                         (px, py, pz, D, GAP, s_em, -1))
                if sc_prev[GG] > NEG / 2:
                    push((nx, ny, pz), GG, sc_prev[GG] + sc.extend_gap,
                         (px, py, pz, GG, GAP, s_em, -1))
            # gap in sequence (consume graph edge)
            nx, ny = px + step, py
            if in_bounds(nx, ny):
                nbrs = _succ(cprg, px, pz) if positive else _pred(cprg, px, pz)
                for nz, em in nbrs:
                    lvl = px if positive else nx
                    if em != GAP:
                        if sc_prev[D] > NEG / 2:
                            push((nx, ny, nz), SG,
                                 sc_prev[D] + sc.open_gap + sc.extend_gap,
                                 (px, py, pz, D, em, GAP, lvl))
                        if sc_prev[SG] > NEG / 2:
                            push((nx, ny, nz), SG,
                                 sc_prev[SG] + sc.extend_gap,
                                 (px, py, pz, SG, em, GAP, lvl))
                    else:
                        # graph gap edge: SequenceGap extension at graph-gap
                        # cost; non-affine D->D step (extensionAligner.cpp:
                        # 713-754)
                        if sc_prev[SG] > NEG / 2:
                            push((nx, ny, nz), SG, sc_prev[SG] + sc.graph_gap,
                                 (px, py, pz, SG, em, GAP, lvl))
                        if sc_prev[D] > NEG / 2:
                            push((nx, ny, nz), D, sc_prev[D] + sc.graph_gap,
                                 (px, py, pz, D, em, GAP, lvl))
            # gap jumps (consume many all-gap graph levels at zero cost)
            if sc_prev[D] > NEG / 2:
                for jx, jz, jlen in _jumps(cprg, px, pz, positive):
                    if in_bounds(jx, py):
                        push((jx, py, jz), D,
                             sc_prev[D] + jlen * sc.graph_gap,
                             (px, py, pz, D, -2, -2, jlen))

        # resolve candidates per cell
        new_cells = []
        for cell, slots in cand.items():
            cur = scores.get(cell)
            vals = [NEG, NEG, NEG]
            bts = [None, None, None]
            for st in (GG, SG):
                if slots[st]:
                    best = max(slots[st], key=lambda t: t[0])
                    vals[st], bts[st] = best
            # D candidates include closing from GG/SG at same cell
            d_cands = list(slots[D])
            if vals[GG] > NEG / 2:
                d_cands.append((vals[GG], (cell[0], cell[1], cell[2], GG,
                                           -1, -1, -1)))
            if vals[SG] > NEG / 2:
                d_cands.append((vals[SG], (cell[0], cell[1], cell[2], SG,
                                           -1, -1, -1)))
            if d_cands:
                best = max(d_cands, key=lambda t: t[0])
                vals[D], bts[D] = best
            if vals[D] < sc.stop_threshold:
                continue
            changed = False
            if cur is None:
                scores[cell] = vals
                cur = vals
                changed = True
                for st in (D, GG, SG):
                    if bts[st] is not None:
                        backtrace[(cell, st)] = bts[st]
            else:
                for st in (D, GG, SG):
                    if vals[st] > cur[st]:
                        cur[st] = vals[st]
                        backtrace[(cell, st)] = bts[st]
                        changed = True
            if changed:
                new_cells.append(cell)
                if cur[D] > current_max:
                    current_max = cur[D]
                    maxima = [cell]
                    last_improve = diag
                elif cur[D] == current_max and cur[D] > 0:
                    maxima.append(cell)
                    last_improve = diag

        # diagonal filtering: drop cells > threshold below diagonal max
        if new_cells:
            dmax = max(scores[c][D] for c in new_cells)
            new_cells = [c for c in new_cells
                         if dmax - scores[c][D] <= sc.diagonal_filter]
        frontier_m2 = frontier_m1
        frontier_m1 = new_cells

    if current_max <= 0:
        return None
    end = max(maxima, key=lambda c: scores[c][D])

    # backtrace
    graph_chars: list[int] = []
    seq_chars: list[int] = []
    levels: list[int] = []
    x, y, z = end
    st = D
    start_cell = (start_level, start_seq, start_z)
    while (x, y, z) != start_cell or st != D:
        bt = backtrace.get(((x, y, z), st))
        if bt is None:
            break
        px, py, pz, pst, em_g, em_s, lvl = bt
        if em_g == -1:
            pass  # matrix switch, no emission
        elif em_g == -2:
            # gap jump of lvl levels: emit '_'/'_' columns with real levels
            base = px if positive else x
            jump_levels = list(range(base, base + lvl))
            if not positive:
                jump_levels = list(range(x, x + lvl))
            for l in (reversed(jump_levels) if positive else jump_levels):
                graph_chars.append(GAP)
                seq_chars.append(GAP)
                levels.append(l)
        else:
            graph_chars.append(em_g)
            seq_chars.append(em_s)
            levels.append(lvl)
        x, y, z, st = px, py, pz, pst

    if positive:
        graph_chars.reverse()
        seq_chars.reverse()
        levels.reverse()
    return GraphExtension(
        graph_chars=bytes(graph_chars).decode(),
        levels=levels,
        seq_chars=bytes(seq_chars).decode(),
        score=float(scores[end][D]),
        end_level=end[0], end_seq=end[1], end_z=end[2])
