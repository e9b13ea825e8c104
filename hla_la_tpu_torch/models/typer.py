"""HLA typing with the likelihood model on the port's device.

``TorchHLATyper`` is the reference ``HLATyper`` (observation collection,
filters, pileups, posteriors, QC, G-group translation and every output file
inherited) with the per-locus step routed to the port's operations:

- ``_type_locus`` is the reference's own text
  (``hla_la_tpu/models/typer.py:1179-1436``) with two call sites changed:
  ``cluster_read_ll`` and ``pair_ll_reduction`` are the port's and run on
  ``self.device``.  The backend name is ``"torch"``, so the reference's
  dispatch line keeps the dense one-hot formula on both devices (the sparse
  delta path is for the host backends ``auto`` and ``numpy`` only).
  ``tests/test_torch_guards.py`` holds the text to the reference.
- ``_type_loci_parallel`` returns None: the reference's per-locus worker
  processes would type with the reference typer, so loci are typed
  serially here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hla_la_tpu import native
from hla_la_tpu.models.typer import (DELTA_DISPATCH_FLOPS, HLATyper,
                                     LocusResult)
from hla_la_tpu.ops.pair_ll import (cluster_channel_codes, cluster_delta_plan,
                                    cluster_onehot, cluster_read_ll_delta,
                                    pair_min_mismatch_row)
from hla_la_tpu.utils.config import TyperConfig
from hla_la_tpu.utils.timing import log_progress

from ..device import resolve
from ..ops.pair_ll import cluster_read_ll, pair_ll_reduction

BACKEND = "torch"


class TorchHLATyper(HLATyper):
    def __init__(self, pkg, cfg: TyperConfig | None = None,
                 g_nomenclature_path: str | None = None, *,
                 device: str | torch.device):
        super().__init__(pkg, cfg, g_nomenclature_path, backend=BACKEND)
        self.device = resolve(device)

    def _type_loci_parallel(self, *args, **kwargs):
        return None

    def _type_locus(self, locus, raw_pairs, aligned_pairs, raw_unpaired,
                    aligned_unpaired, insert_mean, insert_sd, output_dir,
                    cfg: TyperConfig, long_reads: bool,
                    kmer_counts: dict, hist_fh) -> LocusResult | None:
        levels, exon_idx, exon_pos, combined = self._combined_exon_matrix(locus)
        if not combined:
            return None
        lv_min, lv_max = int(levels.min()), int(levels.max())
        cluster_seqs, clusters, allele_to_cluster = \
            self._cluster_alleles(combined)
        C = len(cluster_seqs)
        J = len(levels)

        # ---- pileups per read (pair mates merged; reference 1386-1500)
        # quality predicate + weightedOK fractions are locus-independent —
        # computed once per run (type_all / the typing worker)
        pq = getattr(self, "_pair_quality", None)
        if pq is None and aligned_pairs:
            pq = self._compute_pair_quality(aligned_pairs, insert_mean,
                                            insert_sd, cfg)
        if getattr(self, "_pair_ranges", None) is not None and raw_pairs:
            f1, l1, f2, l2, _, _ = self._pair_ranges
            n = len(aligned_pairs)
            ov = (((f1[:n] <= lv_max) & (l1[:n] >= lv_min) & (f1[:n] >= 0))
                  | ((f2[:n] <= lv_max) & (l2[:n] >= lv_min) & (f2[:n] >= 0)))
        else:
            ov = np.ones(len(aligned_pairs), dtype=bool)
        # every quality-OK pair writes its histogram lines for this locus —
        # the reference emits them OUTSIDE the has-exon-positions check
        # (HLATyper.cpp:1426-1430), so pairs with no overlap with this
        # locus's exons still appear.  In the per-locus worker fan-out the
        # full-set fractions arrive via _hist_override (workers only hold
        # the gene-range read subset).
        hist = getattr(self, "_hist_override", None)
        if hist is None and pq is not None:
            ok_a, w1_a, w2_a = pq
            oki = np.nonzero(ok_a)[0]
            hist = (w1_a[oki], w2_a[oki])
        if hist is not None:
            # the weightedOK fractions are heavily quantised (most reads sit
            # at a handful of values): format each distinct (w1, w2) pair's
            # 3-line block once and emit by index — float formatting per
            # pair was ~0.2 s/locus at real-PRG scale
            key = np.asarray(hist[0]) + 1j * np.asarray(hist[1])
            uv, inv = np.unique(key, return_inverse=True)
            blocks = [f"{locus}\tread{w1}\n{locus}\tread{w2}\n"
                      f"{locus}\treadPair{(w1 + w2) / 2}\n"
                      for w1, w2 in zip(uv.real.tolist(), uv.imag.tolist())]
            hist_fh.write("".join([blocks[i] for i in inv.tolist()]))
        soa = self._collect_locus_obs(raw_pairs, aligned_pairs, raw_unpaired,
                                      aligned_unpaired, ov, pq, levels,
                                      lv_min, lv_max, cfg)

        # ---- filters ----------------------------------------------------
        ignore_read_ids: set[str] = set()
        ignore_alleles: dict[int, set[str]] = {}
        if cfg.filter_first20 and not long_reads:
            n_erased = self._filter_first20(None, ignore_read_ids,
                                            ignore_alleles, cfg, soa=soa)
            if n_erased:
                log_progress(
                    f"  WARNING {locus}: filterFirst20 removed an allele "
                    f"carrying >={cfg.filter_first20_erasure_warn_frac:.0%} "
                    f"of observations at {n_erased} position(s) — possible "
                    f"novel allele with uniformly down-weighted reads "
                    f"(inspect R1_pileup_{locus}.txt)")
        counts_post, strand_freqs, read1_freqs = self._allele_filters(
            None, ignore_read_ids, ignore_alleles, cfg, long_reads,
            soa=soa)

        # ---- final pileup ------------------------------------------------
        kept_mask = soa.base_used_mask(
            ignore_read_ids, ignore_alleles,
            cfg.minimum_per_position_mapping_quality) \
            if soa.n_obs else np.zeros(0, dtype=bool)
        used_mask = kept_mask & (soa.run_novel < 2) if long_reads \
            else kept_mask
        used_idx = np.nonzero(used_mask)[0]
        utilized_reads = {soa.names[i]
                          for i in np.unique(soa.name_id[used_idx]).tolist()}
        # per-obs histogram lines (chain-constant value -> cached string)
        wcache: dict[float, str] = {}
        parts: list[str] = []
        for v in soa.wok[used_idx].tolist():
            s = wcache.get(v)
            if s is None:
                s = wcache[v] = f"{locus}\tbase{v}\n"
            parts.append(s)
        hist_fh.write("".join(parts))
        self._write_pileup(locus, soa, used_idx, exon_idx, exon_pos,
                           strand_freqs, read1_freqs, output_dir)
        with open(os.path.join(output_dir, f"R1_readIDs_{locus}.txt"),
                  "w") as fh:
            for rid in sorted(utilized_reads):
                fh.write(rid + "\n")

        # ---- likelihood tensors ------------------------------------------
        p_ins = 0.075 if long_reads else 0.001
        R = soa.n_reads
        # chunk reads so the [Rc, J, 6] contribution tensors stay bounded
        # (~200 MB) even for very wide typed segments
        chunk = max(16, int(2e8 / max(J * 24, 1)))
        # sparse-delta dispatch: above ~2e10 dense flops (IMGT-scale
        # matrices; every suite/soak-scale world stays on the byte-stable
        # BLAS path) AND when the clusters are similar enough that the
        # consensus-delta form does >=8x less work — the reference's
        # segment matrices differ in a few % of columns, so the dense
        # one-hot sgemm wastes ~100x flops (HLATyper.cpp:1198-1299)
        delta_plan = None
        if self.backend in ("auto", "numpy") \
                and C * J * 6.0 * R > DELTA_DISPATCH_FLOPS:
            codes = cluster_channel_codes(cluster_seqs)
            plan = cluster_delta_plan(codes)
            if (len(plan[2]) + J) * 8 < C * J * 6.0:
                delta_plan = (codes, plan)
        onehot = cluster_onehot(cluster_seqs) if delta_plan is None else None

        # all big tensors come from the per-typer scratch pool and outputs
        # are written straight into [C, R] column slices — fresh 100MB+
        # allocations per call intermittently cost seconds of page-fault
        # stime on this VM (measured: 7-28s CPU for a 1.2s kernel)
        LLmat = self._scratch("LL", (C, R))
        MMmat = self._scratch("MM", (C, R))
        used_count = 0
        for lo in range(0, R, chunk):
            hi2 = min(lo + chunk, R)
            rr = None if (lo, hi2) == (0, R) else (lo, hi2)
            Rc = hi2 - lo
            tshape = (J * 6, Rc) if delta_plan is not None else (Rc, J, 6)
            contrib, mismatch, used_c = self._build_read_tensors(
                None, J, cfg, ignore_read_ids, ignore_alleles,
                long_reads, p_ins, soa=soa, kept_mask=kept_mask,
                read_range=rr, transposed=delta_plan is not None,
                out=(self._scratch("contrib", tshape),
                     self._scratch("mismatch", tshape)))
            used_count += used_c
            if delta_plan is not None:
                cluster_read_ll_delta(delta_plan[0], contrib, mismatch,
                                      plan=delta_plan[1],
                                      out_ll=LLmat[:, lo:hi2],
                                      out_mm=MMmat[:, lo:hi2])
            else:
                LLmat[:, lo:hi2], MMmat[:, lo:hi2] = cluster_read_ll(
                    onehot, contrib, mismatch, device=self.device)
        log_progress(f"  {locus}: {C} clusters x {R} reads")
        dump_dir = os.environ.get("HLA_LLMAT_DUMP")
        if dump_dir:      # kernel-tuning diagnostic: the real LL matrix
            np.save(os.path.join(dump_dir, f"LLmat_{locus}.npy"), LLmat)
            if soa.n_obs:   # each read's first typed-segment position
                first = np.r_[True, soa.read_idx[1:] != soa.read_idx[:-1]]
                np.save(os.path.join(dump_dir, f"readpos_{locus}.npy"),
                        soa.pos[first])

        # ---- pair reduction ----------------------------------------------
        pair_LL = pair_ll_reduction(LLmat, device=self.device)
        iu = np.triu_indices(C)
        pair_vals = pair_LL[iu]                    # ordered (c1 <= c2)
        max_ll = float(pair_vals.max()) if len(pair_vals) else 0.0
        P = np.exp(pair_vals - max_ll)
        s = P.sum()
        P = P / s if s > 0 else np.full_like(P, 1.0 / len(P))

        # marginal per-cluster posterior (HLATyper.cpp:2489-2517)
        marg = np.zeros(C)
        np.add.at(marg, iu[0], P)
        sec = iu[1] != iu[0]
        np.add.at(marg, iu[1][sec], P[sec])
        best1 = int(np.argmax(marg))

        # conditional second allele (2519-2538); triangular index of the
        # (a<=b) pair in row-major upper-triangle order
        def tri_idx(a, b):
            return a * C - (a * (a - 1)) // 2 + (b - a)
        c2s = np.arange(C)
        a_arr = np.minimum(best1, c2s)
        b_arr = np.maximum(best1, c2s)
        cand_P = P[tri_idx(a_arr, b_arr)]
        best2_p = float(cand_P.max())
        mm_min_row = pair_min_mismatch_row(MMmat, best1)
        tie = np.nonzero(cand_P == best2_p)[0]
        best2 = int(tie[np.argmax(-mm_min_row[tie])])

        mism_rowsums = MMmat.sum(axis=1)
        mism_avg = 0.5 * (mism_rowsums[iu[0]] + mism_rowsums[iu[1]])

        # ---- outputs: pair posterior dump --------------------------------
        # LL descending, ties by ascending Mismatches_avg (the reference's
        # sort comparator, HLATyper.cpp:2382-2404; its std::sort leaves
        # deeper ties unspecified — lexsort is stable and ~20x faster than
        # the structured argsort on the 2.4M-pair IMGT-scale dump)
        order = np.lexsort((mism_avg, -pair_vals))
        cluster_ids = [";".join(sorted(c)) for c in clusters]
        pp_path = os.path.join(output_dir, f"R1_PP_{locus}_pairs.txt")
        iu0_o, iu1_o = iu[0][order], iu[1][order]
        P_o, LL_o, MM_o = P[order], pair_vals[order], mism_avg[order]

        def write_pp():
            with open(pp_path, "wb") as fh:
                fh.write(b"ClusterID\tP\tLL\tMismatches_avg\n")
                # native bulk formatter (hla_format_pairs): threaded C++
                # CPython-repr layout, byte-identical to the python path
                # below (locked by tests/test_native_parity.py + the
                # snapshot suite)
                body = native.format_pairs(
                    iu0_o, iu1_o, P_o, LL_o, MM_o,
                    [s.encode() for s in cluster_ids])
                if body is not None:
                    fh.write(body)
                    return
                # chunked bulk formatting: at IMGT scale this file is
                # C(C+1)/2 ~ 2.4M lines (~120 MB); a per-line write loop
                # costs ~20 s.  .tolist() floats repr identically to the
                # scalar f-string (same shortest-round-trip algorithm)
                for lo in range(0, len(order), 262144):
                    hi = lo + 262144
                    fh.write("".join(
                        f"{cluster_ids[a]}/{cluster_ids[b]}\t{p}\t{v}\t{m}\n"
                        for a, b, p, v, m in zip(
                            iu0_o[lo:hi].tolist(), iu1_o[lo:hi].tolist(),
                            P_o[lo:hi].tolist(), LL_o[lo:hi].tolist(),
                            MM_o[lo:hi].tolist())).encode())

        aout = getattr(self, "_async_out", None)
        if aout is not None:
            aout.submit(write_pp)       # overlaps QC + the next locus
        else:
            write_pp()

        # ---- QC ----------------------------------------------------------
        allele1_id = cluster_ids[best1]
        allele2_id = cluster_ids[best2]
        allele1_one = sorted(clusters[best1])[0]
        allele2_one = sorted(clusters[best2])[0]
        qc = self._column_qc(locus, cluster_seqs[best1], cluster_seqs[best2],
                             soa, used_idx, counts_post, exon_idx, exon_pos,
                             kmer_counts, combined[allele1_one],
                             combined[allele2_one], cfg, output_dir)

        res = LocusResult(
            locus=locus,
            allele1_id=allele1_id, allele2_id=allele2_id,
            q1_allele1=float(marg[best1]), q1_allele2=best2_p,
            q2=float(-mm_min_row[best2]),
            avg_coverage=used_count / J if J else 0.0,
            first_decile_coverage=qc["decile"],
            min_coverage=qc["min_cov"],
            prop_kmers_covered_1=qc["kmers1"],
            prop_kmers_covered_2=qc["kmers2"],
            avg_column_error=qc["avg_err"],
            n_columns_unaccounted=qc["unaccounted"],
            n_clusters=C, n_reads_used=R,
        )
        if self.can_translate_locus(locus):
            res.allele1_g, res.g1_perfect = self.translate_to_g(
                sorted(clusters[best1]))
            res.allele2_g, res.g2_perfect = self.translate_to_g(
                sorted(clusters[best2]))
        return res
