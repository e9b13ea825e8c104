"""PRG -> dense array compilation (the TPU-native `prepareGraph`).

The reference serialises its pointer graph with Boost archives and computes the
gap-edge path index at prepare time ("a few hours, up to 40 GB",
README.md:113-117; HLA-LA.cpp:1341-1385).  Here `compile_prg` lowers a PRG to
flat numpy arrays — CSR adjacency keyed by (level, z) coordinates plus a
gap-jump table — stored as a single .npz.  Loading is mmap-fast and the arrays
are directly gatherable when building fixed-shape DP windows for TPU kernels.

Coordinates: the DP cell space is (level x, z) where z is the index of a node
within its level (reference: nodesPerLevel_ordered, alignerBase.cpp:27-37).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .prg import PRG


@dataclass
class CompiledPRG:
    n_levels: int
    # per node (level-major ids)
    node_level: np.ndarray        # [N] int32
    node_z: np.ndarray            # [N] int32
    level_offsets: np.ndarray     # [n_levels+1] node-id offsets
    # edges, CSR by from-node and by to-node
    edge_from: np.ndarray         # [E] int32
    edge_to: np.ndarray           # [E] int32
    edge_emission: np.ndarray     # [E] uint8
    out_offsets: np.ndarray       # [N+1]
    out_edges: np.ndarray         # [E] edge ids
    in_offsets: np.ndarray        # [N+1]
    in_edges: np.ndarray          # [E] edge ids
    # gap-jump pseudo-edges (forward): jump j goes first_node -> last_node
    # crossing path_len all-gap levels
    jump_from: np.ndarray         # [J] int32 node id
    jump_to: np.ndarray           # [J] int32 node id
    jump_len: np.ndarray          # [J] int32
    jump_out_offsets: np.ndarray  # [N+1] CSR over jump_from
    jump_out: np.ndarray          # [J]
    jump_in_offsets: np.ndarray   # [N+1] CSR over jump_to
    jump_in: np.ndarray           # [J]

    @property
    def n_nodes(self) -> int:
        return len(self.node_level)

    @property
    def max_z(self) -> int:
        return int(np.max(np.diff(self.level_offsets)))

    def node_of(self, level: int, z: int) -> int:
        return int(self.level_offsets[level] + z)

    # ---------------------------------------------------------------- window
    def window_tables(self, lv_lo: int, lv_hi: int, z_pad: int, deg_pad: int):
        """Padded successor tables for levels [lv_lo, lv_hi).

        Returns dict with:
          succ_z   [W, z_pad, deg_pad] int32  (next-level z, -1 invalid)
          succ_em  [W, z_pad, deg_pad] uint8  (0 invalid)
          pred_z   [W, z_pad, deg_pad] int32  (prev-level z of nodes at lv+1)
          pred_em  [W, z_pad, deg_pad] uint8
          z_count  [W+1] int32 nodes per level lv_lo..lv_hi
        where W = lv_hi - lv_lo counts *edge levels* (transitions lv -> lv+1).
        """
        W = lv_hi - lv_lo
        # padding must COVER the window — silent truncation would make a
        # DP kernel built on these tables unable to traverse the dropped
        # nodes/edges (a wrong answer with no error)
        max_z = int(np.max(np.diff(self.level_offsets[lv_lo:lv_hi + 2])))
        if max_z > z_pad:
            raise ValueError(f"window_tables: z_pad {z_pad} < widest level "
                             f"{max_z} in [{lv_lo}, {lv_hi}]")
        max_deg = 0
        n0, n1 = int(self.level_offsets[lv_lo]), \
            int(self.level_offsets[min(lv_hi + 1, len(self.level_offsets)
                                       - 1)])
        if n1 > n0:
            max_deg = max(
                int(np.max(np.diff(self.out_offsets[n0:n1 + 1]))),
                int(np.max(np.diff(self.in_offsets[n0:n1 + 1]))))
        if max_deg > deg_pad:
            raise ValueError(f"window_tables: deg_pad {deg_pad} < max "
                             f"degree {max_deg} in [{lv_lo}, {lv_hi}]")
        succ_z = np.full((W, z_pad, deg_pad), -1, dtype=np.int32)
        succ_em = np.zeros((W, z_pad, deg_pad), dtype=np.uint8)
        pred_z = np.full((W, z_pad, deg_pad), -1, dtype=np.int32)
        pred_em = np.zeros((W, z_pad, deg_pad), dtype=np.uint8)
        z_count = np.zeros(W + 1, dtype=np.int32)
        for wi in range(W + 1):
            lv = lv_lo + wi
            z_count[wi] = self.level_offsets[lv + 1] - self.level_offsets[lv]
        for wi in range(W):
            lv = lv_lo + wi
            for z in range(min(int(z_count[wi]), z_pad)):
                node = self.node_of(lv, z)
                es = self.out_edges[self.out_offsets[node]:self.out_offsets[node + 1]]
                for k, e in enumerate(es[:deg_pad]):
                    succ_z[wi, z, k] = self.node_z[self.edge_to[e]]
                    succ_em[wi, z, k] = self.edge_emission[e]
            for z in range(min(int(z_count[wi + 1]), z_pad)):
                node = self.node_of(lv + 1, z)
                es = self.in_edges[self.in_offsets[node]:self.in_offsets[node + 1]]
                for k, e in enumerate(es[:deg_pad]):
                    pred_z[wi, z, k] = self.node_z[self.edge_from[e]]
                    pred_em[wi, z, k] = self.edge_emission[e]
        return dict(succ_z=succ_z, succ_em=succ_em,
                    pred_z=pred_z, pred_em=pred_em, z_count=z_count)

    # ------------------------------------------------------------------- I/O
    def save(self, path: str) -> None:
        # uncompressed: single-stream zlib slows prepareGraph at 3M levels
        # to save ~110 MB of disk; loads get faster too
        np.savez(
            path,
            n_levels=np.int64(self.n_levels),
            node_level=self.node_level, node_z=self.node_z,
            level_offsets=self.level_offsets,
            edge_from=self.edge_from, edge_to=self.edge_to,
            edge_emission=self.edge_emission,
            out_offsets=self.out_offsets, out_edges=self.out_edges,
            in_offsets=self.in_offsets, in_edges=self.in_edges,
            jump_from=self.jump_from, jump_to=self.jump_to,
            jump_len=self.jump_len,
            jump_out_offsets=self.jump_out_offsets, jump_out=self.jump_out,
            jump_in_offsets=self.jump_in_offsets, jump_in=self.jump_in,
        )

    @classmethod
    def load(cls, path: str) -> "CompiledPRG":
        z = np.load(path)
        return cls(n_levels=int(z["n_levels"]), **{
            k: z[k] for k in z.files if k != "n_levels"})


def _csr(keys: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    order = np.argsort(keys, kind="stable").astype(np.int32)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.add.at(offsets, keys + 1, 1)
    return np.cumsum(offsets).astype(np.int64), order


def compile_prg(prg: PRG) -> CompiledPRG:
    """Lower a PRG to its dense compiled form, including the gap-jump index
    (the reference's computeGapEdgePaths + pseudoEdges, Graph.cpp:347-475)."""
    prg.check_structure()
    # z = index within level; nodes are level-major so this is one gather
    node_z = (np.arange(prg.n_nodes, dtype=np.int64)
              - prg.level_offsets[prg.node_level]).astype(np.int32)

    paths = prg.compute_gap_edge_paths()
    if paths:
        jf = np.asarray([p[0] for p in paths], dtype=np.int32)
        jt = np.asarray([p[1] for p in paths], dtype=np.int32)
        jl = np.asarray([len(p[2]) for p in paths], dtype=np.int32)
    else:
        jf = jt = jl = np.zeros(0, dtype=np.int32)
    jo_off, jo = _csr(jf, prg.n_nodes) if len(jf) else (
        np.zeros(prg.n_nodes + 1, dtype=np.int64), np.zeros(0, dtype=np.int32))
    ji_off, ji = _csr(jt, prg.n_nodes) if len(jt) else (
        np.zeros(prg.n_nodes + 1, dtype=np.int64), np.zeros(0, dtype=np.int32))

    return CompiledPRG(
        n_levels=prg.n_levels,
        node_level=prg.node_level.astype(np.int32),
        node_z=node_z,
        level_offsets=prg.level_offsets.astype(np.int64),
        edge_from=prg.edge_from, edge_to=prg.edge_to,
        edge_emission=prg.edge_emission,
        out_offsets=prg.out_offsets, out_edges=prg.out_edges,
        in_offsets=prg.in_offsets, in_edges=prg.in_edges,
        jump_from=jf, jump_to=jt, jump_len=jl,
        jump_out_offsets=jo_off, jump_out=jo,
        jump_in_offsets=ji_off, jump_in=ji,
    )
