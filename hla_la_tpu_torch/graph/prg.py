"""Population Reference Graph (PRG) core.

The PRG is a level-structured DAG: every node sits at an integer level,
every edge connects level l -> l+1 and emits exactly one character ('_' for a
gap column).  The reference keeps it as pointer sets (Graph.h:80-82,
Node.h:60-89, Edge.h:30-64); here it is parsed directly into dense numpy
arrays — node ids are level-major indices, edges live in CSR adjacency —
which is both faster on the host and the form the TPU kernels consume.

File format (text `PRG/graph.txt`) compatibility with the reference
(Graph.cpp:2225-2330 write, 2329-2545 read):

    CODE:
    <locus>|||<alleleString>|||<int code>
    NODES:
    <idx>|||<level>|||<terminal 0/1>
    EDGES:
    <idx>|||<locusID>|||<count>|||<code char>|||<fromIdx>|||<toIdx>[|||<label>|||<pgf 0/1>]

The emission field holds the single *code byte* assigned in the CODE section;
'|' is escaped as 'SLASH' inside '|||...|||' (see problematic_part handling,
Graph.cpp:2340-2366).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

import numpy as np

GAP = ord("_")

_SEP = "|||"
_PROBLEM = "|||||||"
_SUBST = "|||SLASH|||"
_SLASH = "SLASH"


@dataclass
class PRG:
    """Dense level-structured sequence graph.

    Node ids are 0-based and sorted level-major (all nodes of level 0, then
    level 1, ...).  Edge ids are 0-based, sorted by (from_level, from_node).
    """

    # nodes
    node_level: np.ndarray          # [N] int32
    node_terminal: np.ndarray       # [N] bool
    level_offsets: np.ndarray       # [n_levels+1] int32 — nodes of level l are
                                    #   ids level_offsets[l]:level_offsets[l+1]
    # edges
    edge_from: np.ndarray           # [E] int32 node id
    edge_to: np.ndarray             # [E] int32 node id
    edge_emission: np.ndarray       # [E] uint8 character byte ('_' = gap)
    edge_locus: np.ndarray          # [E] int32 index into locus_names
    locus_names: list[str]
    edge_label: list[str] = field(default_factory=list)
    edge_pgf_protect: np.ndarray | None = None

    # CSR adjacency (built in __post_init__)
    out_offsets: np.ndarray = None  # [N+1]
    out_edges: np.ndarray = None    # [E] edge ids sorted by from-node
    in_offsets: np.ndarray = None   # [N+1]
    in_edges: np.ndarray = None     # [E] edge ids sorted by to-node

    # gap-edge path index (computed by compute_gap_edge_paths)
    gap_paths: list[tuple[int, int, np.ndarray]] | None = None

    def __post_init__(self):
        n = len(self.node_level)
        e = len(self.edge_from)
        order = np.argsort(self.edge_from, kind="stable")
        self.out_edges = order.astype(np.int32)
        self.out_offsets = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self.out_offsets, self.edge_from + 1, 1)
        self.out_offsets = np.cumsum(self.out_offsets).astype(np.int64)
        order_in = np.argsort(self.edge_to, kind="stable")
        self.in_edges = order_in.astype(np.int32)
        self.in_offsets = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self.in_offsets, self.edge_to + 1, 1)
        self.in_offsets = np.cumsum(self.in_offsets).astype(np.int64)
        assert self.out_offsets[-1] == e and self.in_offsets[-1] == e

    # ------------------------------------------------------------------ basic
    @property
    def n_nodes(self) -> int:
        return len(self.node_level)

    @property
    def n_edges(self) -> int:
        return len(self.edge_from)

    @property
    def n_levels(self) -> int:
        return len(self.level_offsets) - 1

    def nodes_at_level(self, level: int) -> np.ndarray:
        return np.arange(self.level_offsets[level], self.level_offsets[level + 1],
                         dtype=np.int32)

    def z_of_node(self, node: int) -> int:
        """Index of the node within its level (the DP 'z' coordinate)."""
        return int(node - self.level_offsets[self.node_level[node]])

    def node_of_z(self, level: int, z: int) -> int:
        return int(self.level_offsets[level] + z)

    def out_edge_ids(self, node: int) -> np.ndarray:
        return self.out_edges[self.out_offsets[node]:self.out_offsets[node + 1]]

    def in_edge_ids(self, node: int) -> np.ndarray:
        return self.in_edges[self.in_offsets[node]:self.in_offsets[node + 1]]

    # ----------------------------------------------------------- consistency
    def check_structure(self) -> None:
        """Structure checks mirroring Graph::checkStructure (Graph.cpp:517+):
        levels contiguous, edges span exactly one level, every non-final node
        has outgoing edges, every non-first node has incoming edges, single
        connected frame from level 0 to the last level."""
        assert self.n_levels >= 2, "graph needs at least one edge level"
        lv_from = self.node_level[self.edge_from]
        lv_to = self.node_level[self.edge_to]
        assert np.all(lv_to == lv_from + 1), "edges must span exactly one level"
        out_deg = np.diff(self.out_offsets)
        in_deg = np.diff(self.in_offsets)
        last = self.n_levels - 1
        non_final = self.node_level < last
        assert np.all(out_deg[non_final] > 0), "non-final node without outgoing edge"
        non_first = self.node_level > 0
        assert np.all(in_deg[non_first] > 0), "non-first node without incoming edge"
        assert np.all(out_deg[~non_final] == 0), "final-level node with outgoing edge"
        bad = np.nonzero(np.diff(self.level_offsets) <= 0)[0]
        assert len(bad) == 0, f"empty level {int(bad[0]) if len(bad) else -1}"

    # ------------------------------------------------------------- traversal
    def simulate_random_paths(self, n: int, rng: np.random.Generator
                              ) -> list[tuple[str, np.ndarray, np.ndarray]]:
        """Sample n uniform random source->sink paths.

        Returns (sequence_with_gaps, edge_ids, node_ids) per path; the
        sequence includes '_' characters for traversed gap edges (one char per
        level).  Reference: Graph::simulateHaplotypes (Graph.cpp:1441+).
        """
        out = []
        for _ in range(n):
            first_nodes = self.nodes_at_level(0)
            node = int(rng.choice(first_nodes))
            chars = []
            edge_ids = []
            node_ids = [node]
            for _lv in range(self.n_levels - 1):
                es = self.out_edge_ids(node)
                e = int(es[rng.integers(len(es))])
                edge_ids.append(e)
                chars.append(chr(self.edge_emission[e]))
                node = int(self.edge_to[e])
                node_ids.append(node)
            out.append(("".join(chars), np.asarray(edge_ids, dtype=np.int32),
                        np.asarray(node_ids, dtype=np.int32)))
        return out

    def simulate_random_diploid_path(self, rng: np.random.Generator):
        """Two independent random paths (Graph::simulateRandomDiploidPath,
        Graph.cpp:1482)."""
        return self.simulate_random_paths(2, rng)

    def path_emits(self, seq_with_gaps: str, start_level: int = 0) -> bool:
        """True iff `seq_with_gaps` (one char per level, '_' allowed) is
        emittable along some path starting at start_level.

        Reference: sequence-presence checks, Graph.cpp:162-346.
        """
        want = np.frombuffer(seq_with_gaps.encode(), dtype=np.uint8)
        frontier = set(self.nodes_at_level(start_level).tolist())
        for c in want:
            nxt = set()
            for node in frontier:
                for e in self.out_edge_ids(node):
                    if self.edge_emission[e] == c:
                        nxt.add(int(self.edge_to[e]))
            if not nxt:
                return False
            frontier = nxt
        return True

    # -------------------------------------------------------- gap-path index
    def compute_gap_edge_paths(self) -> list[tuple[int, int, np.ndarray]]:
        """Enumerate maximal all-gap edge paths and return them as
        (first_node, last_node, edge_ids) triples.

        A path starts at a node u with a gap out-edge, follows gap edges, and
        completes at the first node that has a non-gap out-edge (or the final
        level).  Only one path per (first_node, last_node) pair is kept — same
        dedup as the reference (Graph.cpp:347-475).  The aligner uses these as
        O(1) "jump" pseudo-edges across long graph gaps.
        """
        if self.gap_paths is not None:
            return self.gap_paths
        is_gap = self.edge_emission == GAP
        # Only nodes with a gap out-edge or a live run through them matter —
        # visiting every node of every level is wasted on gene-localised
        # gap structure at 3M levels.  Node iteration order within a level
        # stays ascending (sorted(cand)), so run starts, the per-(target,
        # first) dedup, and the completed order are identical to the dense
        # sweep.
        gap_cnt = np.bincount(self.edge_from[is_gap],
                              minlength=self.n_nodes) if is_gap.any() \
            else np.zeros(self.n_nodes, dtype=np.int64)
        gap_nodes = np.nonzero(gap_cnt)[0]          # sorted = level-major
        gn_lv = self.node_level[gap_nodes]
        gn_starts = np.searchsorted(gn_lv, np.arange(self.n_levels + 1))
        # running[v] = {first_node: edge_id_list}
        running: dict[int, dict[int, list[int]]] = {}
        completed: list[tuple[int, int, np.ndarray]] = []
        last_level = self.n_levels - 1
        lv = int(gn_lv[0]) if len(gn_lv) else self.n_levels
        while lv < self.n_levels:
            running_next: dict[int, dict[int, list[int]]] = {}
            cand = gap_nodes[gn_starts[lv]:gn_starts[lv + 1]].tolist()
            if running:
                cand = sorted(set(cand).union(running))
            for node in cand:
                es = self.out_edge_ids(node)
                gap_es = es[is_gap[es]] if len(es) else es
                n_non_gap = len(es) - len(gap_es)
                paths_here = running.get(node)
                if paths_here:
                    for e in gap_es.tolist():
                        tgt = int(self.edge_to[e])
                        slot = running_next.setdefault(tgt, {})
                        for first, elist in paths_here.items():
                            if first not in slot:
                                slot[first] = elist + [e]
                    if n_non_gap > 0 or lv == last_level:
                        for first, elist in paths_here.items():
                            completed.append(
                                (first, node,
                                 np.asarray(elist, dtype=np.int32)))
                else:
                    # fresh maximal runs start only at nodes not themselves
                    # reached by a gap run (Graph.cpp:431-456 seen_gap_edge)
                    for e in gap_es.tolist():
                        tgt = int(self.edge_to[e])
                        slot = running_next.setdefault(tgt, {})
                        if node not in slot:
                            slot[node] = [e]
            running = running_next
            lv += 1
            if not running:
                # jump to the next level with a gap-edge start
                nxt = np.searchsorted(gn_lv, lv)
                if nxt == len(gn_lv):
                    break
                lv = int(gn_lv[nxt])
        self.gap_paths = completed
        return completed

    # ------------------------------------------------------------------- I/O
    @classmethod
    def from_file(cls, path: str) -> "PRG":
        with open(path, "r") as fh:
            return cls.from_text(fh.read())

    @classmethod
    def from_text(cls, text: str) -> "PRG":
        fast = cls._from_text_fast(text)
        if fast is not None:
            return fast
        return cls._from_text_slow(text)

    @classmethod
    def _from_text_fast(cls, text: str) -> "PRG | None":
        """Vectorised parse of the common file shape: the three sections in
        CODE/NODES/EDGES order, uniform 8-field (or 6-field) edge lines, no
        '|||||||' ambiguity and no SLASH escapes.  Returns None for anything
        else (the general line-by-line parser handles it) — output is
        identical, just built with numpy column passes instead of ~10
        python objects per line (the line parser is the dominant
        prepareGraph item on a 3M-level PRG)."""
        if _PROBLEM in text or _SLASH in text:
            return None
        ic = text.find("CODE:\n")
        inn = text.find("NODES:\n")
        ie = text.find("EDGES:\n")
        if not (0 <= ic < inn < ie):
            return None
        # markers must sit at line starts
        for pos in (ic, inn, ie):
            if pos > 0 and text[pos - 1] != "\n":
                return None
        from .. import native as _nat
        use_native = _nat.available()
        if not use_native:
            # duplicate markers would contaminate the sections; the native
            # parsers reject a stray marker line (no fields), but the
            # python column splitters cannot — scan only on that path
            # (each find re-scans the multi-hundred-MB text)
            for pos, tag in ((ic, "CODE:\n"), (inn, "NODES:\n"),
                             (ie, "EDGES:\n")):
                if text.find(tag, pos + 1) != -1:
                    return None

        # CODE: locus ||| allele ||| code — parsed AFTER the edges (the
        # locus table comes from there); real PRGs carry one locus per
        # level, so this section has millions of lines
        csec = text[ic + 6:inn]


        # NODES: orig ||| level ||| terminal — native section parser when
        # available (threaded byte-range scan; same field rules), else the
        # numpy column path
        nsec = text[inn + 7:ie]
        orig = None
        if use_native:
            res = _nat.parse_prg_nodes(nsec.encode())
            if res is None:
                # the native parser validates per-row field counts; a
                # rejected section must go to the LINE parser — the column
                # splitter below cannot detect row misalignment (e.g. a
                # 2-field line plus a 4-field line still splits to a
                # multiple of 3) and could misparse silently
                return None
            orig, lv, term_u8 = res
            term = term_u8.astype(bool)
        if orig is None:
            if "\n\n" in nsec:   # blank lines: let the line parser skip them
                return None
            flat = nsec.replace("\n", _SEP).split(_SEP)
            while flat and flat[-1] == "":
                flat.pop()
            if len(flat) % 3:
                return None
            try:
                orig = np.asarray(flat[0::3], dtype=np.int64)
                lv = np.asarray(flat[1::3], dtype=np.int64)
            except ValueError:
                return None
            term_s = np.asarray(flat[2::3], dtype=object)
            term = ~((term_s == "0") | (term_s == ""))
        # files we wrote ourselves (and the reference's) store nodes
        # already (level, orig)-sorted — a stable lexsort of sorted input
        # is the identity, so skip the sort AND the gathers then
        nodes_sorted = bool(len(lv) == 0 or np.all(
            (lv[1:] > lv[:-1]) | ((lv[1:] == lv[:-1])
                                  & (orig[1:] >= orig[:-1]))))
        if nodes_sorted:
            node_level = lv.astype(np.int32)
            node_terminal = term.astype(bool)
            o_in_new = orig
        else:
            order = np.lexsort((orig, lv))
            node_level = lv[order].astype(np.int32)
            node_terminal = term[order].astype(bool)
            o_in_new = orig[order]
        n_levels = int(node_level.max()) + 1 if len(node_level) else 0
        level_offsets = np.searchsorted(
            node_level, np.arange(n_levels + 1)).astype(np.int64)
        # orig id -> new id lookup (orig ids are unique but arbitrary);
        # the common case orig == 0..n-1 in new order needs no sort at all
        n_nodes = len(o_in_new)
        off = int(o_in_new[0]) if n_nodes else 0
        if nodes_sorted and n_nodes \
                and np.array_equal(o_in_new, np.arange(off, off + n_nodes)):
            # consecutive ids (to_text writes 1-based consecutive): the
            # orig->new map is a constant shift — no sort, no searchsorted
            def map_ids(q: np.ndarray) -> np.ndarray:
                if len(q) and (int(q.min()) < off
                               or int(q.max()) >= off + n_nodes):
                    raise ValueError("edge references unknown node")
                return q - off if off else q
        else:
            o_sort = np.argsort(o_in_new)
            o_sorted = o_in_new[o_sort]
            if len(np.unique(o_sorted)) != len(o_sorted):
                return None

            def map_ids(q: np.ndarray) -> np.ndarray:
                p = np.searchsorted(o_sorted, q)
                if (p >= len(o_sorted)).any() or (o_sorted[p] != q).any():
                    raise ValueError("edge references unknown node")
                return o_sort[p]

        # EDGES: eid ||| locus ||| 1 ||| code ||| from ||| to
        #        [||| label ||| pgf]
        esec = text[ie + 7:]
        nat_e = _nat.parse_prg_edges(esec.encode()) if use_native else None
        if use_native and nat_e is None:
            return None      # malformed rows: line parser (see NODES note)
        loc_blob = loc_off = None
        if nat_e is not None:
            (fr0, to0, cc_b, lid0, pg_u8, lab_l, names0,
             loc_blob, loc_off) = nat_e
            try:
                fr = map_ids(fr0)
                to = map_ids(to0)
            except ValueError:
                return None
            if len(fr) == 0 or bool(np.all(fr[1:] >= fr[:-1])):
                # already from-sorted (to_text's own order): a stable
                # argsort is the identity — skip it and all five gathers
                # plus the 3.7M-element label permutation
                eorder = None
                la = lid0.astype(np.int64)
                codes = cc_b.astype(np.int64)
                e_lab = lab_l
                e_pgf = pg_u8.astype(bool)
            else:
                eorder = np.argsort(fr, kind="stable")
                la = lid0.astype(np.int64)[eorder]
                codes = cc_b.astype(np.int64)[eorder]
                e_lab = [lab_l[i] for i in eorder.tolist()]
                e_pgf = pg_u8[eorder].astype(bool)
        else:
            if "\n\n" in esec:
                return None
            rows = esec.split("\n")
            while rows and rows[-1] == "":
                rows.pop()
            if not rows or "" in rows:
                return None
            eflat = _SEP.join(rows).split(_SEP)
            ncols, rem = divmod(len(eflat), len(rows))
            if rem or ncols not in (6, 8):
                return None
            try:
                fr = map_ids(np.asarray(eflat[4::ncols], dtype=np.int64))
                to = map_ids(np.asarray(eflat[5::ncols], dtype=np.int64))
            except ValueError:
                return None
            loc_s = eflat[1::ncols]
            cc_s = eflat[3::ncols]
            if any(len(c) != 1 for c in cc_s):
                return None
            eorder = None if (len(fr) == 0
                              or bool(np.all(fr[1:] >= fr[:-1]))) \
                else np.argsort(fr, kind="stable")
            # map locus strings to file-order first-occurrence ids so the
            # shared tail below treats both paths identically
            loc_first: dict[str, int] = {}
            for s in loc_s:
                if s not in loc_first:
                    loc_first[s] = len(loc_first)
            names0 = [None] * len(loc_first)
            for s, i in loc_first.items():
                names0[i] = s
            la = np.fromiter((loc_first[s] for s in loc_s), np.int64,
                             len(loc_s))
            codes = np.fromiter((ord(c) for c in cc_s), np.int64,
                                len(cc_s))
            if eorder is not None:
                la = la[eorder]
                codes = codes[eorder]
            if ncols == 8:
                lab_l = eflat[6::ncols]
                pgf_s = np.asarray(eflat[7::ncols], dtype=object)
                if eorder is not None:
                    e_lab = [lab_l[i] for i in eorder.tolist()]
                    pgf_s = pgf_s[eorder]
                else:
                    e_lab = lab_l
                e_pgf = ~((pgf_s == "0") | (pgf_s == ""))
            else:
                e_lab = [""] * len(rows)
                e_pgf = np.zeros(len(rows), dtype=bool)
        # locus ids by first occurrence in from-sorted edge order.  Both
        # sources assign ids by first occurrence in FILE row order, so
        # with no re-sort (eorder None) the ranking is the identity
        if eorder is None:
            e_loc = la.astype(np.int32)
            locus_names = list(names0)
        else:
            uniq_loc, first_idx, loc_inv = np.unique(
                la, return_index=True, return_inverse=True)
            by_first = np.argsort(first_idx, kind="stable")
            rank = np.empty(len(uniq_loc), dtype=np.int64)
            rank[by_first] = np.arange(len(uniq_loc))
            e_loc = rank[loc_inv].astype(np.int32)
            locus_names = np.asarray(names0,
                                     dtype=object)[uniq_loc[by_first]
                                                   ].tolist()
        # emissions, vectorised: CODE rows keyed by (file locus id, code);
        # a later CODE row overwrites an earlier one (dict semantics);
        # unmatched (locus, code) pairs emit the code char itself
        if len(codes) and int(codes.max()) > 255:
            return None
        c_all = a0 = alen = None
        c_fid = None
        if loc_blob is not None:
            nat_c = _nat.parse_prg_code(csec.encode(), loc_blob, loc_off)
            if nat_c is None:
                return None  # malformed rows: line parser (see NODES note)
            c_fid, c_code, a0, alen = nat_c
        if c_fid is None:
            # python CODE columns (native unavailable or section malformed
            # in a way the native parser rejects)
            if "\n\n" in csec:
                return None
            cflat = csec.replace("\n", _SEP).split(_SEP)
            while cflat and cflat[-1] == "":
                cflat.pop()
            if len(cflat) % 3:
                return None
            c_loc = cflat[0::3]
            c_all = cflat[1::3]
            try:
                c_code = np.asarray(cflat[2::3], dtype=np.int64) \
                    if cflat else np.zeros(0, dtype=np.int64)
            except ValueError:
                return None
            name_to_fid = {s: i for i, s in enumerate(names0)}
            c_fid = np.fromiter((name_to_fid.get(s, -1) for s in c_loc),
                                np.int64, len(c_loc))
        if len(c_code) and (int(c_code.min()) < 0
                            or int(c_code.max()) > 255):
            return None
        ckey = c_fid * 256 + c_code
        corder = np.argsort(ckey, kind="stable")
        ckeys_s = ckey[corder]
        ekey = la * 256 + codes
        pos = np.searchsorted(ckeys_s, ekey, side="right") - 1
        hit = pos >= 0
        if len(ckeys_s):
            hit &= ckeys_s[np.maximum(pos, 0)] == ekey
        else:
            hit &= False
        em = codes.astype(np.uint8)
        hit_idx = np.nonzero(hit)[0]
        if len(hit_idx):
            src = corder[pos[hit_idx]]             # CODE row per hit edge
            used, src_inv = np.unique(src, return_inverse=True)
            if a0 is not None:
                if (alen[used] != 1).any():
                    return None   # non-unit emission: slow path asserts
                uord = a0[used].astype(np.int64)
            else:
                ua = [c_all[u] for u in used.tolist()]
                if any(len(a) != 1 for a in ua):
                    return None   # non-unit emission: slow path asserts
                uord = np.fromiter((ord(a) for a in ua), np.int64, len(ua))
            if len(uord) and int(uord.max()) > 255:
                return None
            em[hit_idx] = uord[src_inv].astype(np.uint8)
        return cls(
            node_level=node_level,
            node_terminal=node_terminal,
            level_offsets=level_offsets,
            edge_from=(fr if eorder is None else fr[eorder]
                       ).astype(np.int32),
            edge_to=(to if eorder is None else to[eorder]
                     ).astype(np.int32),
            edge_emission=em,
            edge_locus=e_loc,
            locus_names=locus_names,
            edge_label=e_lab,
            edge_pgf_protect=e_pgf.astype(bool),
        )

    @classmethod
    def _from_text_slow(cls, text: str) -> "PRG":
        code_lines, node_lines, edge_lines = [], [], []
        mode = None
        for line in text.splitlines():
            line = line.rstrip("\r\n")
            if not line:
                continue
            if _PROBLEM in line:
                line = line.replace(_PROBLEM, _SUBST, 1)
            if line == "CODE:":
                mode = "code"
            elif line == "NODES:":
                mode = "node"
            elif line == "EDGES:":
                mode = "edge"
            else:
                {"code": code_lines, "node": node_lines,
                 "edge": edge_lines}[mode].append(line)

        # CODE: (locus, code byte) -> allele string
        decode: dict[tuple[str, int], str] = {}
        for line in code_lines:
            locus, allele, code = line.split(_SEP)
            if allele == _SLASH:
                allele = "|"
            decode[(locus, int(code))] = allele

        # NODES
        idx2node: dict[int, int] = {}
        levels = []
        terminals = []
        raw = []
        for line in node_lines:
            f = line.split(_SEP)
            raw.append((int(f[0]), int(f[1]), f[2] not in ("0", "")))
        # sort level-major, stable by original idx
        raw.sort(key=lambda t: (t[1], t[0]))
        for new_id, (orig, lv, term) in enumerate(raw):
            idx2node[orig] = new_id
            levels.append(lv)
            terminals.append(term)
        node_level = np.asarray(levels, dtype=np.int32)
        node_terminal = np.asarray(terminals, dtype=bool)
        n_levels = int(node_level.max()) + 1 if len(node_level) else 0
        level_offsets = np.searchsorted(
            node_level, np.arange(n_levels + 1)).astype(np.int64)

        # EDGES
        e_from, e_to, e_em, e_loc, e_lab, e_pgf = [], [], [], [], [], []
        locus_ids: dict[str, int] = {}
        recs = []
        for line in edge_lines:
            f = line.split(_SEP)
            if len(f) not in (6, 8):
                raise ValueError(f"bad edge line: {line!r}")
            locus = f[1]
            code_char = f[3]
            if code_char == _SLASH:
                code_char = "|"
            allele = decode.get((locus, ord(code_char[0])), code_char[0])
            assert len(allele) == 1, f"non-unit emission {allele!r}"
            label = f[6].replace(_SLASH, "|") if len(f) > 6 else ""
            pgf = (f[7] not in ("0", "")) if len(f) > 6 else False
            recs.append((idx2node[int(f[4])], idx2node[int(f[5])],
                         ord(allele), locus, label, pgf))
        recs.sort(key=lambda t: t[0])
        for fr, to, em, locus, label, pgf in recs:
            e_from.append(fr)
            e_to.append(to)
            e_em.append(em)
            if locus not in locus_ids:
                locus_ids[locus] = len(locus_ids)
            e_loc.append(locus_ids[locus])
            e_lab.append(label)
            e_pgf.append(pgf)

        locus_names = [None] * len(locus_ids)
        for name, i in locus_ids.items():
            locus_names[i] = name

        return cls(
            node_level=node_level,
            node_terminal=node_terminal,
            level_offsets=level_offsets,
            edge_from=np.asarray(e_from, dtype=np.int32),
            edge_to=np.asarray(e_to, dtype=np.int32),
            edge_emission=np.asarray(e_em, dtype=np.uint8),
            edge_locus=np.asarray(e_loc, dtype=np.int32),
            locus_names=locus_names,
            edge_label=e_lab,
            edge_pgf_protect=np.asarray(e_pgf, dtype=bool),
        )

    def to_file(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(self.to_text())

    def to_text(self) -> str:
        """Serialise in the reference text format.  Codes are allocated per
        (locus, allele) as printable single bytes (the reference allocates via
        LocusCodeAllocation; any byte works as long as CODE declares it)."""
        buf = io.StringIO()
        # allocate codes: use the allele character itself when it is a safe
        # printable byte, otherwise allocate from a counter.  Allocation
        # runs over distinct (locus, emission) pairs in first-occurrence
        # edge order — identical to the original per-edge loop
        code_of: dict[tuple[str, str], int] = {}
        used: dict[str, set[int]] = {}
        pair_arr = (self.edge_locus.astype(np.int64) * 256
                    + self.edge_emission)
        uniq_p, first_i = np.unique(pair_arr, return_index=True)
        for pid in uniq_p[np.argsort(first_i, kind="stable")].tolist():
            locus = self.locus_names[pid >> 8]
            allele = chr(pid & 255)
            key = (locus, allele)
            u = used.setdefault(locus, set())
            c = ord(allele)
            if c < 33 or c > 126 or c in u:
                c = 33
                while c in u or chr(c) in "|":
                    c += 1
            code_of[key] = c
            u.add(c)
        buf.write("CODE:\n")
        for (locus, allele), c in code_of.items():
            a = _SLASH if allele == "|" else allele
            buf.write(f"{locus}{_SEP}{a}{_SEP}{c}\n")
        buf.write("NODES:\n")
        lv_l = self.node_level.tolist()
        t_l = self.node_terminal.astype(np.int64).tolist()
        buf.write("".join(
            [f"{i + 1}{_SEP}{lv}{_SEP}{t}\n"
             for i, (lv, t) in enumerate(zip(lv_l, t_l))]))
        buf.write("EDGES:\n")
        # plain-python column lists + a per-(locus, emission) code cache:
        # numpy scalar indexing per edge is slow at 3M levels
        lnames = self.locus_names
        eloc_l = self.edge_locus.tolist()
        eem_l = self.edge_emission.tolist()
        efrom_l = (self.edge_from.astype(np.int64) + 1).tolist()
        eto_l = (self.edge_to.astype(np.int64) + 1).tolist()
        labels = self.edge_label if self.edge_label \
            else [""] * self.n_edges
        pgf_l = (self.edge_pgf_protect.astype(np.int64).tolist()
                 if self.edge_pgf_protect is not None
                 else [0] * self.n_edges)
        cc_cache: dict[int, str] = {}
        for li, em in {(li, em) for li, em in zip(eloc_l, eem_l)}:
            cc = chr(code_of[(lnames[li], chr(em))])
            cc_cache[li * 256 + em] = _SLASH if cc == "|" else cc
        cc_l = [cc_cache[li * 256 + em] for li, em in zip(eloc_l, eem_l)]
        lname_l = [lnames[li] for li in eloc_l]
        # '|' is the field separator: escape it like the CODE section
        # does (a label literally containing 'SLASH' is ambiguous —
        # the same limitation the reference format has)
        lab_l = [lb.replace("|", _SLASH) if "|" in lb else lb
                 for lb in labels]
        buf.write("\n".join(
            [f"{e}{_SEP}{ln}{_SEP}1{_SEP}{cc}{_SEP}{fr}{_SEP}{to}"
             f"{_SEP}{lb}{_SEP}{pg}"
             for e, ln, cc, fr, to, lb, pg in zip(
                 range(1, self.n_edges + 1), lname_l, cc_l, efrom_l,
                 eto_l, lab_l, pgf_l)]))
        return buf.getvalue()


def prg_from_haplotypes(haplotypes: list[str], locus_names: list[str] | None = None,
                        merge: bool = True) -> PRG:
    """Build a PRG from equal-length aligned haplotype strings ('_' = gap).

    Column i becomes edge level i.  Construction is PRG-style (the role of
    Graph::buildFromHaplotypes, Graph.cpp:567, fed by the graphFromMFA
    toolchain): haplotypes sharing a character path through a polymorphic run
    share nodes, and ALL paths re-merge into a single node at every
    monomorphic column — variant bubbles open and close, so recombinant
    mosaics of the panel are valid graph paths (the defining property of a
    population reference graph).
    """
    assert haplotypes, "need at least one haplotype"
    L = len(haplotypes[0])
    assert all(len(h) == L for h in haplotypes)
    if locus_names is None:
        locus_names = [f"L{i}" for i in range(L)]
    assert len(locus_names) == L

    node_level: list[int] = []

    def new_node(level: int) -> int:
        node_level.append(level)
        return len(node_level) - 1

    n_h = len(haplotypes)
    all_h = frozenset(range(n_h))
    e_from, e_to, e_em, e_loc = [], [], [], []
    # frontier: group (frozenset of haplotypes) -> node id
    frontier: dict[frozenset, int] = {all_h: new_node(0)}
    for lv in range(L):
        chars = [haplotypes[h][lv] for h in range(n_h)]
        monomorphic = merge and len(set(chars)) == 1
        nxt: dict[frozenset, int] = {}
        if monomorphic:
            tgt = new_node(lv + 1)
            nxt[all_h] = tgt
            for grp, node in frontier.items():
                e_from.append(node)
                e_to.append(tgt)
                e_em.append(ord(chars[0]))
                e_loc.append(lv)
        else:
            for grp, node in frontier.items():
                by_char: dict[str, list[int]] = {}
                for h in grp:
                    by_char.setdefault(chars[h], []).append(h)
                for ch, hs in by_char.items():
                    tgt_grp = frozenset(hs)
                    if tgt_grp not in nxt:
                        nxt[tgt_grp] = new_node(lv + 1)
                    e_from.append(node)
                    e_to.append(nxt[tgt_grp])
                    e_em.append(ord(ch))
                    e_loc.append(lv)
        frontier = nxt

    node_level_arr = np.asarray(node_level, dtype=np.int32)
    order = np.argsort(node_level_arr, kind="stable")
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    node_level_sorted = node_level_arr[order]
    level_offsets = np.searchsorted(node_level_sorted,
                                    np.arange(L + 2)).astype(np.int64)
    e_from = remap[np.asarray(e_from)]
    e_to = remap[np.asarray(e_to)]
    eorder = np.argsort(e_from, kind="stable")

    return PRG(
        node_level=node_level_sorted,
        node_terminal=(node_level_sorted == L),
        level_offsets=level_offsets,
        edge_from=e_from[eorder].astype(np.int32),
        edge_to=e_to[eorder].astype(np.int32),
        edge_emission=np.asarray(e_em, dtype=np.uint8)[eorder],
        edge_locus=np.asarray(e_loc, dtype=np.int32)[eorder],
        locus_names=list(locus_names),
    )
