"""Read alignment pipeline: seeds -> banded NW -> projection -> pair selection.

This is the L3/L5 workhorse replacing processBAM (mapper/processBAM.cpp):

  1. seed candidates per read via the native k-mer index (bwa `-a` analogue);
  2. one fixed-shape banded-NW job per (read, candidate) — batched across the
     whole read set, forward pass on the aligner's device
     (ops/banded_nw.banded_nw_forward_torch: K1 for bands up to 32, K2 for
     the long-read band of 256, the plain version on the CPU);
  3. projection into graph coordinates (models/alignment.py);
  4. per-pair combination selection: chain log-likelihoods + insert-size
     log-likelihood over underlying-sequence distances, posterior mapQ per
     chain and per position (alignOneReadPair, processBAM.cpp:3129-3616;
     assignMappingQualities, processBAM.cpp:4062-4310);
  5. insert-size estimation from up to 4000 pairs via the weighted-median
     histogram rule (estimateInsertSize, processBAM.cpp:991-1182).

The counterpart of ``hla_la_tpu/models/aligner.py`` without its ``use_jax``
machinery: one explicit ``device``, and the jobs of one NW call bounded by
their pointer bytes (``jobs_per_call``), one rule for short and long reads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .._lazy import torch
from ..device import resolve
from ..graph.package import GraphPackage
from ..io.fastq import FastqRead
from ..mapping.kmer_index import KmerIndex
from ..mapping.seeder import Seeder
from ..ops.banded_nw import (DEFAULT_SCORING, banded_nw_backtrace,
                             banded_nw_forward_torch)
from ..sim.read_sim import revcomp
from ..utils.config import RunConfig
from ..utils.timing import Stats, span
from .alignment import (GraphAlignment, pair_distances_underlying,
                        project_linear_alignment, score_alignment,
                        strands_valid)

GAP_ORD = ord("_")
MAX_JOBS = 65536    # jobs of one NW call, whatever their size
# Pointer bytes, B * (L + 1) * W, that one NW call may hold.  The u8 pointer
# tensor lives on the card and again on the host for the native backtrace,
# so this bounds both.  2 GiB keeps MAX_JOBS jobs per call for short reads
# (3.2 KB each) and gives 838 jobs at L = 10,000 and W = 256, about six K2
# blocks for each of an H100's 132 SMs.
NW_POINTER_BUDGET = 2 << 30
_ENC = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _ENC[b] = i
    _ENC[b + 32] = i


def jobs_per_call(L: int, W: int, max_jobs: int = MAX_JOBS) -> int:
    """Jobs of read length up to `L` and band `W` that one NW call takes:
    at most `max_jobs`, at most NW_POINTER_BUDGET of pointers, at least 1."""
    return max(1, min(max_jobs, NW_POINTER_BUDGET // ((L + 1) * W)))


def gather_ref_windows(enc_cat: np.ndarray, hap_offsets: np.ndarray,
                       hap_lens: np.ndarray, job_seq: np.ndarray,
                       win_start: np.ndarray, width: int,
                       out: np.ndarray) -> None:
    """out[b] = the `width` codes of haplotype job_seq[b] from win_start[b]
    on, cut from the encoded concatenated haplotypes; columns outside the
    haplotype get the padding code 4.  Per-job clamped memcpy (native),
    else one global numpy gather."""
    from .. import native
    gw = (native.gather_windows(enc_cat, hap_offsets, hap_lens, job_seq,
                                win_start, width)
          if native.available() else None)
    if gw is not None:
        out[:] = gw
        return
    pos = win_start[:, None] + np.arange(width)
    in_range = (pos >= 0) & (pos < hap_lens[job_seq, None])
    gp = hap_offsets[job_seq, None] + np.where(in_range, pos, 0)
    out[:] = np.where(in_range, enc_cat[gp], 4)


class NWRunner:
    """The banded NW forward for host callers, shared by the read aligner
    and the linear-ALT and assembly typers: numpy job arrays go to `device`
    (K1 or K2 on a card by the band, the plain version on the CPU) and
    numpy results come back, from a card through page-locked buffers the
    runner owns.  `stats` counts the jobs as ``nw_jobs_on_<device>``."""

    def __init__(self, device: str | torch.device,
                 scoring: dict = DEFAULT_SCORING, stats: Stats | None = None):
        self.device = resolve(device)
        self.scoring = scoring
        self.stats = Stats() if stats is None else stats
        self.scratch: dict = {}

    def host_buffer(self, name: str, shape, dtype,
                    crosses: bool = False) -> np.ndarray:
        """A [shape] view of a host buffer the runner owns, grown only when
        a call needs more.  A buffer that `crosses` to or from a card is
        page-locked, so its copy runs at the bus's rate and needs no staging
        copy; every other, and every buffer on the CPU device, is a plain
        numpy array."""
        dtype = np.dtype(dtype)
        need = int(np.prod(shape)) * dtype.itemsize
        buf = self.scratch.get(name)
        if buf is None or buf.nbytes < need:
            if crosses and self.device.type == "cuda":
                buf = torch.empty(max(need, 1), dtype=torch.uint8,
                                  pin_memory=True).numpy()
            else:
                buf = np.empty(max(need, 1), dtype=np.uint8)
            self.scratch[name] = buf
        return buf[:need].view(dtype).reshape(shape)

    def run(self, reads_arr, lens_arr, refs_arr, pointers: bool = True,
            out=None):
        """One forward call: (score f32, end_k i32, end_state i32, pointers
        u8 [B, L + 1, W] C-contiguous, or None unless `pointers`) as numpy
        arrays.  From a card they come back into the runner's page-locked
        buffers, which the next call overwrites: every batch is consumed
        before the next.  The pointer tensor, by far the largest, is copied
        only when asked for.  `out`: host arrays of those shapes that take
        the results in place of the runner's buffers (the device server
        passes a worker's region)."""
        res = banded_nw_forward_torch(reads_arr, lens_arr, refs_arr,
                                      self.scoring, self.device)
        self.stats.bump(f"nw_jobs_on_{self.device.type}", len(reads_arr))
        if not pointers:
            res = res[:3]
        if self.device.type != "cuda":
            host = [t.cpu().numpy() for t in res]
            if out is not None:
                for dst, src in zip(out, host):
                    np.copyto(dst, src)
                host = list(out[:len(host)])
        else:
            host = []
            for i, (name, dtype, t) in enumerate(zip(
                    ("dev_score", "dev_end_k", "dev_end_state",
                     "dev_pointers"),
                    (np.float32, np.int32, np.int32, np.uint8), res)):
                view = (out[i] if out is not None else
                        self.host_buffer(name, tuple(t.shape), dtype,
                                         crosses=True))
                torch.from_numpy(view).copy_(t, non_blocking=True)
                host.append(view)
            torch.cuda.current_stream(self.device).synchronize()
        return tuple(host) if pointers else (*host, None)

    def jobs_per_call(self, L: int, W: int) -> int:
        """Jobs of read length up to `L` and band `W` in one call."""
        return jobs_per_call(L, W)

    def run_jobs(self, reads_arr, lens_arr, refs_arr, pointers: bool = True):
        """The forward pass over any number of jobs, in calls of
        self.jobs_per_call(L, W) jobs: yields (lo, hi, results of run() for
        jobs lo..hi).  Each yield's arrays are overwritten by the next
        call."""
        n, L = reads_arr.shape
        step = self.jobs_per_call(L, refs_arr.shape[1] - L)
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            yield lo, hi, self.run(reads_arr[lo:hi], lens_arr[lo:hi],
                                   refs_arr[lo:hi], pointers)

    def scores(self, reads_arr, lens_arr, refs_arr) -> np.ndarray:
        """The final scores [n] alone, no pointer tensor copied."""
        out = np.empty(len(reads_arr), dtype=np.float32)
        for lo, hi, res in self.run_jobs(reads_arr, lens_arr, refs_arr,
                                         pointers=False):
            out[lo:hi] = res[0]
        return out


def _longest(all_reads, job_read) -> int:
    return max((len(all_reads[r].seq) for r in set(job_read.tolist())),
               default=0)


def _uniq_oriented_reads(job_read: np.ndarray, job_rev: np.ndarray,
                         all_reads) -> tuple[list[tuple], np.ndarray]:
    """Deduplicate a job slice to its distinct (read, strand) oriented
    sequences: returns (uniq [(seq, qual)], job_row int64 index per job).
    Shared by the SoA and object job pipelines so the key encoding and
    revcomp/qual-reversal rules cannot desynchronise."""
    keys, job_row = np.unique(job_read * 2 + job_rev, return_inverse=True)
    uniq = []
    for key in keys.tolist():
        r = all_reads[key >> 1]
        if key & 1:
            uniq.append((revcomp(r.seq), r.qual[::-1]))
        else:
            uniq.append((r.seq, r.qual))
    return uniq, job_row.astype(np.int64)


@dataclass
class AlignedPair:
    read_id: str
    chain1: GraphAlignment
    chain2: GraphAlignment
    mapq: float  # pair-level posterior


@dataclass
class _Job:
    pair_idx: int
    mate: int              # 1 or 2
    cand_seq: int
    reverse: bool
    window_start: int
    oriented_seq: str
    oriented_qual: str


class ReadAligner:
    def __init__(self, pkg: GraphPackage, cfg: RunConfig | None = None,
                 band: int | None = None, kmer_k: int = 20,
                 graph_fallback: bool = True, decoy=None, *,
                 device: str | torch.device, sharded=None, nw_runner=None):
        """`nw_runner`: the NW forward to use in place of an NWRunner on
        `device` (a worker's ServedNWRunner); `device` is then the
        server's (a device_server.ServedDevice), and this process makes no
        CUDA call."""
        self.pkg = pkg
        self.device = resolve(device) if nw_runner is None else device
        # a parallel.mesh.Mesh: every NW call is split over all its ranks
        self.sharded = sharded
        self._sharded_nw = None
        self.scoring = DEFAULT_SCORING
        self.cfg = cfg or RunConfig()
        self.band = 32 if band is None else band
        fasta = pkg.prg_fasta()
        self.seq_infos = pkg.sequences()
        self.hap_names = [s.fasta_id for s in self.seq_infos]
        self.hap_seqs = [fasta[n] for n in self.hap_names]
        self.hap_codes = [np.frombuffer(s.encode(), dtype=np.uint8)
                          for s in self.hap_seqs]
        self.hap_levels = [pkg.translation(s.prg_id) for s in self.seq_infos]
        self.prg_ids = [s.prg_id for s in self.seq_infos]
        # concatenated haplotype arrays for batched projection
        self.hap_lens = np.asarray([len(h) for h in self.hap_codes],
                                   dtype=np.int64)
        self.hap_offsets = np.concatenate(
            [[0], np.cumsum(self.hap_lens)])[:-1]
        self.hap_codes_cat = (np.concatenate(self.hap_codes)
                              if self.hap_codes else np.zeros(0, np.uint8))
        self.hap_enc_cat = _ENC[self.hap_codes_cat]  # 0-4 codes for NW
        self.hap_levels_cat = (np.concatenate(self.hap_levels)
                               if self.hap_levels else np.zeros(0, np.int64))
        self.index = self._load_or_build_index(kmer_k)
        self.seeder = Seeder(self.index)
        self.level_to_seqpos = pkg.level_to_seqpos()
        self.long_reads = bool(self.cfg.long_reads)
        if self.long_reads and band is None:
            # the reference maps long reads with bwa's indel-tolerant
            # presets (-x ont2d/pacbio, HLA-LA.pl:481-530); our fixed DP
            # band tuned for 100-150bp Illumina reads (32) cannot absorb
            # the indel drift of a 50kb split chunk — net drift is
            # ±4σ ≈ 126 columns at 1% indels over 50kb (σ=√(2·rate·L)).
            # Widen to 256 in long-read mode (mode constant, so serial
            # and worker-chunked runs stay deterministic); an explicit
            # band= override (any value, incl. 32) wins — band=None is
            # the 'pick per mode' sentinel.  Measured at 3M levels / 25kb
            # reads, 0.5% ins+del: per-base level accuracy 0.46 at band
            # 32 → 0.90+ at 160+.
            self.band = 256
        if nw_runner is None:
            self.stats = Stats()
            self._nw = NWRunner(self.device, self.scoring, self.stats)
        else:
            self.stats = nw_runner.stats
            self._nw = nw_runner
        self.graph_fallback = graph_fallback
        self._realigner = None
        # paralog defense (mapAgainstCompleteGenome equivalent,
        # HLA-LA.cpp:617-779): DecoyIndex or None
        self.decoy = decoy
        # reuse pool of the staging buffers and the native backtrace ops,
        # which would otherwise be freshly allocated per batch; each batch
        # is fully consumed (projected) before the next starts
        self._nw_scratch = self._nw.scratch

    def _load_or_build_index(self, kmer_k: int) -> KmerIndex:
        """Disk-cached k-mer index in the package dir (freshness rule as for
        serializedGRAPH; the bwa `ref_is_indexed` analogue)."""
        import os
        cache = os.path.join(self.pkg.dir, "mapping_PRGonly",
                             f"kmerIndex_k{kmer_k}.npz")
        # freshness source = the actual sequence content input: the PRG-only
        # FASTA when present, else sequences.txt (ADVICE r1: sequences.txt
        # mtime misses FASTA regeneration)
        src = os.path.join(self.pkg.dir, "mapping_PRGonly",
                           "referenceGenome.fa")
        if not os.path.exists(src):
            src = os.path.join(self.pkg.dir, "sequences.txt")
        try:
            if (os.path.exists(cache) and os.path.exists(src)
                    and os.path.getmtime(cache) >= os.path.getmtime(src)):
                idx = KmerIndex.load(cache)
                if idx.seq_names == self.hap_names and idx.k == kmer_k:
                    return idx
        except Exception:  # noqa: BLE001 — fall back to a fresh build
            pass
        idx = KmerIndex.build(dict(zip(self.hap_names, self.hap_seqs)),
                              k=kmer_k)
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            idx.save(cache)
        except OSError:
            pass
        return idx

    # ------------------------------------------------------------- NW batch
    def _host_buffer(self, name: str, shape, dtype,
                     crosses: bool = False) -> np.ndarray:
        return self._nw.host_buffer(name, shape, dtype, crosses)

    def _run_nw(self, reads_arr, lens_arr, refs_arr):
        """The forward pass on self.device (NWRunner.run): numpy arrays
        for the native backtrace, overwritten by the next call.  With a
        mesh, the device-sharded forward over all its ranks as one "data"
        axis (SURVEY §2.3), each rank's slice on that rank's device."""
        if self.sharded is None:
            return self._nw.run(reads_arr, lens_arr, refs_arr)
        L = reads_arr.shape[1]
        W = refs_arr.shape[1] - L
        if self._sharded_nw is None or \
                (self._sharded_nw.L, self._sharded_nw.W) != (L, W):
            from ..parallel.mesh import ShardedNW
            self._sharded_nw = ShardedNW(self.sharded.all_data(), L, W,
                                         self.scoring, self.stats)
        return self._sharded_nw(reads_arr, lens_arr, refs_arr)

    def _make_jobs(self, pair_idx: int, mate: int, read: FastqRead,
                   cands=None) -> list[_Job]:
        if cands is None:
            cands = self.seeder.candidates(read.seq)
        jobs = []
        rc = None
        half_band = self.band // 2
        new = _Job.__new__
        for c in cands:
            if c.reverse:
                if rc is None:
                    rc = (revcomp(read.seq), read.qual[::-1])
                oriented, qual = rc
            else:
                oriented, qual = read.seq, read.qual
            j = new(_Job)
            j.__dict__ = {"pair_idx": pair_idx, "mate": mate,
                          "cand_seq": c.seq_idx, "reverse": c.reverse,
                          "window_start": c.ref_start - half_band,
                          "oriented_seq": oriented, "oriented_qual": qual}
            jobs.append(j)
        self.stats.considered_chains += len(jobs)
        return jobs

    def _jobs_to_alignments(self, jobs: list[_Job]
                            ) -> list[GraphAlignment | None]:
        """Object-API wrapper over _align_core (estimate_insert_size and
        dev actions build _Job lists; the hot path uses
        _align_jobs_arrays)."""
        if not jobs:
            return []
        MAX_B = self._nw.jobs_per_call(
            max(len(j.oriented_seq) for j in jobs), self.band)
        if len(jobs) > MAX_B:
            out: list[GraphAlignment | None] = []
            for lo in range(0, len(jobs), MAX_B):
                out.extend(self._jobs_to_alignments(jobs[lo:lo + MAX_B]))
            return out
        nb = len(jobs)
        # unique oriented reads (jobs of one read share the string object) ->
        # one padded stack + a single fancy-index per array
        row_of: dict[int, int] = {}
        uniq: list[tuple] = []
        job_row = np.empty(nb, dtype=np.int64)
        for bi, j in enumerate(jobs):
            key = id(j.oriented_seq)
            row = row_of.get(key)
            if row is None:
                row = row_of[key] = len(uniq)
                uniq.append((j.oriented_seq, j.oriented_qual))
            job_row[bi] = row
        return self._align_core(
            uniq, job_row,
            np.asarray([j.cand_seq for j in jobs], dtype=np.int64),
            np.asarray([j.window_start for j in jobs], dtype=np.int64),
            np.asarray([j.reverse for j in jobs], dtype=bool),
            np.asarray([j.mate == 1 for j in jobs], dtype=bool))

    def _align_jobs_arrays(self, job_read: np.ndarray, job_seq: np.ndarray,
                           job_rev: np.ndarray, win_start: np.ndarray,
                           all_reads, unpaired: bool = False
                           ) -> list[GraphAlignment | None]:
        """SoA job assembly (no Candidate/_Job objects): job_read indexes
        all_reads (paired layout: even = mate 1; unpaired: every read is
        'first'); candidates stay numpy end-to-end."""
        if not len(job_read):
            return []
        MAX_B = self._nw.jobs_per_call(_longest(all_reads, job_read),
                                       self.band)
        if len(job_read) > MAX_B:
            out: list[GraphAlignment | None] = []
            for lo in range(0, len(job_read), MAX_B):
                sl = slice(lo, lo + MAX_B)
                out.extend(self._align_jobs_arrays(
                    job_read[sl], job_seq[sl], job_rev[sl], win_start[sl],
                    all_reads, unpaired))
            return out
        uniq, job_row = _uniq_oriented_reads(job_read, job_rev, all_reads)
        ffr = (np.ones(len(job_read), dtype=bool) if unpaired
               else job_read % 2 == 0)
        return self._align_core(uniq, job_row.astype(np.int64), job_seq,
                                win_start, job_rev, ffr)

    def _align_jobs_soa(self, job_read: np.ndarray, job_seq: np.ndarray,
                        job_rev: np.ndarray, win_start: np.ndarray,
                        all_reads, unpaired: bool = False) -> dict | None:
        """SoA twin of _align_jobs_arrays: the projection results stay flat
        arrays — no GraphAlignment objects (those are built only for the
        ~2 chains/pair that survive selection, of ~6 candidate jobs per
        read).
        Returns None when the native projection path is unavailable.

        Keys: per-job  valid, s, e (column ranges), ll, f_lv, l_lv,
        lv2 [n,4], rev, prg_id, ffr;  flat columns  levels, graph_c,
        seq_c, qual_c, pos_keys."""
        from .. import native
        if not native.available():
            return None
        from .alignment import project_batch_raw
        n = len(job_read)
        MAX_B = self._nw.jobs_per_call(_longest(all_reads, job_read),
                                       self.band)
        chunks = []
        col_base = 0
        for lo in range(0, n, MAX_B):
            sl = slice(lo, lo + MAX_B)
            jr, js, jv, ws = (job_read[sl], job_seq[sl], job_rev[sl],
                              win_start[sl])
            uniq, job_row = _uniq_oriented_reads(jr, jv, all_reads)
            raw = self._align_core_raw(uniq, job_row, js, ws, jv)
            if raw["ops"] is None:
                return None
            # (n_chain_extensions bumped inside _align_core_raw)
            with span("align.select"):
                res = project_batch_raw(
                    raw["ops"], raw["n_ops"], raw["job_seq"],
                    raw["win_start"], raw["reads_ascii"], raw["quals_ascii"],
                    self.hap_codes_cat, self.hap_levels_cat,
                    self.hap_offsets, self.hap_lens, raw["reverse"],
                    self.long_reads)
            if res is None:
                return None
            (levels, graph_c, seq_c, qual_c, pos_keys, col_counts,
             col_starts, ll, first_lv, last_lv, lv2, bad) = res
            chunks.append(dict(
                levels=levels, graph_c=graph_c, seq_c=seq_c, qual_c=qual_c,
                pos_keys=pos_keys,
                valid=~((bad != 0) | (col_counts == 0)),
                s=col_starts + col_base, cnt=col_counts,
                ll=ll, f_lv=first_lv, l_lv=last_lv, lv2=lv2,
                # copies: raw's arrays are views of the staging scratch,
                # which the NEXT chunk's _align_core_raw overwrites
                rev=raw["reverse"].copy(), prg_id=raw["prg_ids"].copy()))
            col_base += len(levels)
        if not chunks:
            z = np.zeros(0, dtype=np.int64)
            return dict(levels=z, graph_c=z.astype(np.uint8),
                        seq_c=z.astype(np.uint8), qual_c=z.astype(np.uint8),
                        pos_keys=z, valid=np.zeros(0, dtype=bool),
                        s=z, e=z, ll=np.zeros(0), f_lv=z, l_lv=z,
                        lv2=np.zeros((0, 4), dtype=np.int64),
                        rev=np.zeros(0, dtype=np.uint8), prg_id=z,
                        ffr=np.zeros(0, dtype=bool))
        out = {k: (np.concatenate([c[k] for c in chunks])
                   if len(chunks) > 1 else chunks[0][k])
               for k in chunks[0]}
        out["e"] = out.pop("cnt") + out["s"]
        out["ffr"] = (np.ones(n, dtype=bool) if unpaired
                      else job_read % 2 == 0)
        return out

    def _al_from_soa(self, soa: dict, j: int) -> GraphAlignment:
        """Materialise job j of an _align_jobs_soa result as a
        GraphAlignment (identical fields to the project_and_score_batch
        assembly)."""
        s = int(soa["s"][j])
        e = int(soa["e"][j])
        al = GraphAlignment.__new__(GraphAlignment)
        al.__dict__ = {
            "levels": soa["levels"][s:e], "graph_c": soa["graph_c"][s:e],
            "seq_c": soa["seq_c"][s:e], "seq_qual": soa["qual_c"][s:e],
            "reverse": bool(soa["rev"][j]), "seq_idx": int(soa["prg_id"][j]),
            "mapq": 1.0, "mapq_per_pos": None,
            "from_first_read": bool(soa["ffr"][j]),
            "log_likelihood": float(soa["ll"][j]),
            "_first_level": int(soa["f_lv"][j]),
            "_last_level": int(soa["l_lv"][j]),
            "_lv2": soa["lv2"][j], "_pos_keys": soa["pos_keys"][s:e],
        }
        return al

    def _align_core_raw(self, uniq: list[tuple], job_row: np.ndarray,
                        job_seq_in: np.ndarray, win_start_in: np.ndarray,
                        reverse_in: np.ndarray):
        """Staging + batched NW + native backtrace for one job slice.
        Returns a dict of per-job arrays feeding the projection step, or
        None when the native backtrace is unavailable (callers fall back
        to the per-job python loop)."""
        with span("align.nw", jobs=len(job_row)):
            nb = len(job_row)
            L = max(len(s) for s, _ in uniq)
            W = self.band
            B = nb
            # staging buffers come from the aligner's scratch pool (no fresh
            # multi-MB allocations per chunk); every buffer is re-filled below
            # and fully consumed before the next batch
            def stage(name, shape, dtype, fill, crosses=False):
                v = self._host_buffer(name, shape, dtype, crosses)
                v.fill(fill)
                return v

            # the three inputs of the forward pass go to the device
            reads_arr = stage("st_reads", (B, L), np.uint8, 4, crosses=True)
            reads_ascii = stage("st_rascii", (B, L), np.uint8, 0)
            quals_ascii = stage("st_qascii", (B, L), np.uint8, 0)
            lens_arr = stage("st_lens", (B,), np.int64, 0, crosses=True)
            refs_arr = stage("st_refs", (B, L + W), np.uint8, 4, crosses=True)
            job_seq = stage("st_jseq", (B,), np.int64, 0)
            win_start = stage("st_wstart", (B,), np.int64, 0)
            reverse_arr = stage("st_rev", (B,), bool, 0)
            prg_id_arr = stage("st_prg", (B,), np.int64, 0)
            Rn = len(uniq)
            # vectorised stacking: one big encode + one scatter (no python loop
            # over the ~10k unique reads of a batch)
            lens_u = np.asarray([len(s) for s, _ in uniq], dtype=np.int64)
            cat_seq = np.frombuffer(
                "".join(s for s, _ in uniq).encode("latin-1", "replace"),
                dtype=np.uint8)
            cat_qual = np.frombuffer(
                "".join(q for _, q in uniq).encode("latin-1", "replace"),
                dtype=np.uint8)
            offs = np.concatenate([[0], np.cumsum(lens_u)])
            rows = np.repeat(np.arange(Rn), lens_u)
            cols = np.arange(len(cat_seq)) - offs[rows]
            ascii_u = stage("st_ascii_u", (Rn, L), np.uint8, 0)
            qual_u = stage("st_qual_u", (Rn, L), np.uint8, 0)
            ascii_u[rows, cols] = cat_seq
            qual_u[rows, cols] = cat_qual
            reads_u = stage("st_reads_u", (Rn, L), np.uint8, 4)
            reads_u[rows, cols] = _ENC[cat_seq]
            np.take(reads_u, job_row, axis=0, out=reads_arr[:nb])
            np.take(ascii_u, job_row, axis=0, out=reads_ascii[:nb])
            np.take(qual_u, job_row, axis=0, out=quals_ascii[:nb])
            np.take(lens_u, job_row, out=lens_arr[:nb])
            job_seq[:nb] = job_seq_in
            win_start[:nb] = win_start_in
            reverse_arr[:nb] = reverse_in
            prg_id_arr[:nb] = np.asarray(self.prg_ids)[job_seq[:nb]]
            # reference windows
            if len(self.hap_codes_cat):
                gather_ref_windows(self.hap_enc_cat, self.hap_offsets,
                                   self.hap_lens, job_seq[:nb], win_start[:nb],
                                   L + W, refs_arr[:nb])
            scores, end_k, end_state, pointers = self._run_nw(
                reads_arr, lens_arr, refs_arr)
            self.stats.n_chain_extensions += nb

        with span("align.select"):
            from .. import native
            native_bt = None
            if native.available():
                native_bt = native.nw_backtrace_batch(pointers, lens_arr,
                                                      end_k, end_state,
                                                      scratch=self._nw_scratch)
            if native_bt is None:
                ops_b = n_ops_b = None
            else:
                ops_b, n_ops_b = native_bt
                n_ops_b = n_ops_b.astype(np.int64).copy()
                n_ops_b[scores[:B] <= -1e29] = 0
                ops_b, n_ops_b = ops_b[:nb], n_ops_b[:nb]
        return dict(ops=ops_b, n_ops=n_ops_b,
                    job_seq=job_seq[:nb], win_start=win_start[:nb],
                    reads_ascii=reads_ascii[:nb],
                    quals_ascii=quals_ascii[:nb],
                    reverse=reverse_arr[:nb], prg_ids=prg_id_arr[:nb],
                    uniq=uniq, job_row=job_row, scores=scores,
                    end_k=end_k, end_state=end_state, pointers=pointers,
                    lens=lens_arr)

    def _align_core(self, uniq: list[tuple], job_row: np.ndarray,
                    job_seq_in: np.ndarray, win_start_in: np.ndarray,
                    reverse_in: np.ndarray, ffr_in: np.ndarray
                    ) -> list[GraphAlignment | None]:
        """Batched NW + backtrace + projection for one job slice.  uniq:
        unique (oriented_seq, oriented_qual) rows; job_row maps each job to
        its row; the remaining arrays are per job."""
        raw = self._align_core_raw(uniq, job_row, job_seq_in, win_start_in,
                                   reverse_in)
        with span("align.select"):
            ffr_l = ffr_in.tolist()
            if raw["ops"] is not None:
                from .alignment import project_and_score_batch
                out = project_and_score_batch(
                    raw["ops"], raw["n_ops"], raw["job_seq"], raw["win_start"],
                    raw["reads_ascii"], raw["quals_ascii"],
                    self.hap_codes_cat, self.hap_levels_cat, self.hap_offsets,
                    self.hap_lens, raw["reverse"], raw["prg_ids"],
                    self.long_reads)
                for al, ffr in zip(out, ffr_l):
                    if al is not None:
                        al.from_first_read = ffr
                return out
            return self._align_core_pyloop(raw, ffr_l)

    def _align_core_pyloop(self, raw: dict, ffr_l: list
                           ) -> list[GraphAlignment | None]:
        """Per-job python backtrace+projection (no native library)."""
        scores, pointers, lens_arr = raw["scores"], raw["pointers"], \
            raw["lens"]
        end_k, end_state = raw["end_k"], raw["end_state"]
        job_seq, win_start = raw["job_seq"], raw["win_start"]
        uniq, job_row = raw["uniq"], raw["job_row"]
        reverse_arr = raw["reverse"]
        out: list[GraphAlignment | None] = []
        for bi in range(len(job_row)):
            if scores[bi] <= -1e29:
                out.append(None)
                continue
            ops = banded_nw_backtrace(pointers[bi], int(lens_arr[bi]),
                                      int(end_k[bi]), int(end_state[bi]))
            seq_i = int(job_seq[bi])
            s, q = uniq[int(job_row[bi])]
            al = project_linear_alignment(
                ops, s, q,
                self.hap_seqs[seq_i], self.hap_levels[seq_i],
                int(win_start[bi]), bool(reverse_arr[bi]),
                self.prg_ids[seq_i])
            if al is not None:
                al.from_first_read = ffr_l[bi]
                al.log_likelihood = score_alignment(al, self.long_reads)
            out.append(al)
        return out

    def _graph_realign(self, chain: GraphAlignment, read: FastqRead
                       ) -> GraphAlignment | None:
        if self._realigner is None:
            from .graph_fallback import GraphRealigner
            self._realigner = GraphRealigner(self.pkg.compiled(),
                                             self.hap_seqs, self.hap_levels)
        hap_idx = self.prg_ids.index(chain.seq_idx) \
            if chain.seq_idx in self.prg_ids else -1
        if hap_idx < 0:
            return None
        oriented = revcomp(read.seq) if chain.reverse else read.seq
        qual = read.qual[::-1] if chain.reverse else read.qual
        try:
            return self._realigner.realign(chain, hap_idx, oriented, qual,
                                           self.long_reads)
        except Exception:  # noqa: BLE001 — fallback must never break typing
            return None

    # ------------------------------------------------------ paired pipeline
    def align_pairs(self, pairs: list[tuple[FastqRead, FastqRead]],
                    insert_mean: float, insert_sd: float,
                    truth=None) -> list[AlignedPair]:
        all_reads = [r for p in pairs for r in p]
        with span("align.seed", reads=len(all_reads)):
            (read_of, seq_idx_a, rev_a, start_a, nk_a, _span_a) = \
                self.seeder.candidates_batch_arrays([r.seq for r in all_reads])
        if self.decoy is not None:
            from ..mapping.decoy import filter_decoy_pairs
            prg_best = np.zeros(len(all_reads), dtype=np.int64)
            np.maximum.at(prg_best, read_of, nk_a)
            keep = filter_decoy_pairs(
                self.decoy, [(r1.seq, r2.seq) for r1, r2 in pairs], prg_best)
            n_drop = int((~keep).sum())
            if n_drop:
                self.stats.bump("decoy_dropped_pairs", n_drop)
                m = keep[read_of // 2]
                read_of, seq_idx_a, rev_a, start_a = (
                    read_of[m], seq_idx_a[m], rev_a[m], start_a[m])
        win_start = start_a - self.band // 2
        self.stats.considered_chains += len(read_of)
        soa = self._align_jobs_soa(read_of, seq_idx_a, rev_a, win_start,
                                   all_reads)
        if soa is not None:
            with span("align.select"):
                out = self._align_pairs_soa(pairs, all_reads, read_of, soa,
                                            insert_mean, insert_sd, truth)
            if out is not None:
                return out
        alignments = self._align_jobs_arrays(read_of, seq_idx_a, rev_a,
                                             win_start, all_reads)

        per_pair: dict[int, tuple[list, list]] = {}
        for r, al in zip(read_of.tolist(), alignments):
            if al is None:
                continue
            slot = per_pair.setdefault(r >> 1, ([], []))
            slot[r & 1].append(al)
        # dedup chains that project to the same PRG span, keeping the best
        # likelihood (skipIdenticalCoordinates, processBAM.cpp:3233-3246)
        for slot in per_pair.values():
            for m in (0, 1):
                best: dict[tuple, GraphAlignment] = {}
                for al in slot[m]:
                    key = (al.first_level(), al.last_level(), al.reverse)
                    cur = best.get(key)
                    if cur is None or al.log_likelihood > cur.log_likelihood:
                        best[key] = al
                slot[m][:] = list(best.values())

        # graph-space fallback for reads that align poorly against every
        # single haplotype (recombinant reads; docs/DESIGN.md §2)
        if self.graph_fallback:
            for pi, slot in per_pair.items():
                r1, r2 = pairs[pi]
                for m, read in ((0, r1), (1, r2)):
                    if not slot[m]:
                        continue
                    best_al = max(slot[m], key=lambda a: a.log_likelihood)
                    n_bases = max(int((best_al.seq_c != ord("_")).sum()), 1)
                    if best_al.log_likelihood / n_bases >= -0.25:
                        continue
                    # fallback contract (VERDICT r2 weak #8): the graph DP
                    # runs iff the best chain has a confident anchor region
                    # — ANY window of k columns matching >= 90% (ends OR
                    # interior: the realigner anchors at the middle-most
                    # match, so a double-crossover read whose both ends are
                    # novel but whose interior matches is still realigned;
                    # a real anchor region is near-exact, while NW
                    # gap-juggling lifts pure chance matches to only
                    # ~0.85).  A read matching poorly EVERYWHERE is noise:
                    # skipped, counted in stats
                    # (graph_fallback_skipped_noise), and left to the
                    # typing quality gates with its poor linear score.
                    match = ((best_al.seq_c == best_al.graph_c)
                             & (best_al.seq_c != ord("_")))
                    k = min(30, len(match))
                    if k:
                        cs = np.cumsum(np.r_[0, match.astype(np.int64)])
                        win_best = (cs[k:] - cs[:-k]).max() / k
                        if win_best < 0.9:
                            self.stats.bump("graph_fallback_skipped_noise")
                            continue
                    re_al = self._graph_realign(best_al, read)
                    if re_al is not None:
                        slot[m].append(re_al)
                        self.stats.bump("graph_fallback_improved")

        out: list[AlignedPair] = []
        insert_sd = max(insert_sd, 1e-6)
        max_pen_log = _normal_logpdf(insert_mean + 8 * insert_sd,
                                     insert_mean, insert_sd)
        native_sel = self._select_pairs_native(pairs, per_pair, insert_mean,
                                               insert_sd, max_pen_log)
        for pi, (r1, r2) in enumerate(pairs):
            chains = per_pair.get(pi)
            if not chains or not chains[0] or not chains[1]:
                continue
            if native_sel is not None:
                ap = native_sel.get(pi)
            else:
                ap = self._select_pair(r1.name, chains[0], chains[1],
                                       insert_mean, insert_sd, max_pen_log)
            self.stats.n_align_calls += 1
            if truth is not None:
                for mate_i, (chain, read) in enumerate(
                        ((ap.chain1, r1), (ap.chain2, r2)), start=1):
                    truth.evaluate(f"{read.name}/{mate_i}",
                                   chain.aligned_levels_per_base(len(read.seq)),
                                   chain.reverse)
            out.append(ap)
        return out

    def _align_pairs_soa(self, pairs, all_reads, read_of, soa,
                         insert_mean, insert_sd, truth):
        """Object-free paired pipeline over an _align_jobs_soa result:
        dedup -> graph-fallback gate -> native combination selection all
        run on flat arrays; GraphAlignments are materialised only for the
        selected chains (and the rare fallback candidates).  Byte-identical
        to the object pipeline (same dedup key/tie rules, same selection
        inputs in the same order).  Returns None if the native pair
        selector is unavailable (caller falls back)."""
        from .. import native
        valid = soa["valid"]
        jidx = np.nonzero(valid)[0]
        out: list[AlignedPair] = []
        if len(jidx) == 0:
            return out
        r = read_of[jidx].astype(np.int64)
        f = soa["f_lv"][jidx]
        l = soa["l_lv"][jidx]
        rv = soa["rev"][jidx].astype(np.int64)
        ll = soa["ll"][jidx]
        # ---- dedup identical (first, last, rev) spans per read, keeping
        # the best likelihood, first-on-ties; surviving chains keep the
        # key's first-occurrence order (dict-insertion semantics of
        # skipIdenticalCoordinates, processBAM.cpp:3233-3246)
        local = np.arange(len(jidx))
        order = np.lexsort((local, -ll, rv, l, f, r))
        rs, fs, ls, vs = r[order], f[order], l[order], rv[order]
        new_grp = np.r_[True, (rs[1:] != rs[:-1]) | (fs[1:] != fs[:-1])
                        | (ls[1:] != ls[:-1]) | (vs[1:] != vs[:-1])]
        grp_start = np.nonzero(new_grp)[0]
        rep_local = order[grp_start]            # best-ll rep per group
        key_first = np.minimum.reduceat(order, grp_start)
        rep_read = rs[grp_start]
        srt = np.lexsort((key_first, rep_read))
        surv_job = jidx[rep_local[srt]]         # global job index
        surv_read = rep_read[srt]               # ascending; dedup order within
        # fallback extras: at most one realigned chain per read, keyed by
        # read (the gate below visits each poor read's best survivor once)
        ex_by_read: dict[int, GraphAlignment] = {}

        # ---- graph-space fallback gate (vectorised pre-filter) ----------
        if self.graph_fallback and len(soa["levels"]):
            nongap = soa["seq_c"] != GAP_ORD
            cs = np.r_[0, np.cumsum(nongap)]
            nb_all = cs[soa["e"]] - cs[soa["s"]]   # non-gap bases per job
            # best survivor per read, first-on-ties = the object path's
            # max(slot, key=ll); survivors are grouped by read in slot
            # order, so the earliest position within a read wins ties
            ll_s = soa["ll"][surv_job]
            bsort = np.lexsort((np.arange(len(surv_job)), -ll_s, surv_read))
            rd_sorted = surv_read[bsort]
            first = np.r_[True, rd_sorted[1:] != rd_sorted[:-1]]
            best_pos = bsort[first]                 # index into surv_*
            jb = surv_job[best_pos]
            poor = (ll_s[best_pos]
                    / np.maximum(nb_all[jb], 1)) < -0.25
            for p in np.nonzero(poor)[0].tolist():
                j = int(jb[p])
                rd = int(surv_read[best_pos[p]])
                s0, e0 = int(soa["s"][j]), int(soa["e"][j])
                seq_c = soa["seq_c"][s0:e0]
                match = ((seq_c == soa["graph_c"][s0:e0]) & (seq_c != GAP_ORD))
                k = min(30, len(match))
                if k:
                    cs2 = np.cumsum(np.r_[0, match.astype(np.int64)])
                    if (cs2[k:] - cs2[:-k]).max() / k < 0.9:
                        self.stats.bump("graph_fallback_skipped_noise")
                        continue
                re_al = self._graph_realign(self._al_from_soa(soa, j),
                                            all_reads[rd])
                if re_al is not None:
                    ex_by_read[rd] = re_al
                    self.stats.bump("graph_fallback_improved")

        # ---- selection input assembly (flat arrays, entry order =
        # per-pair c1 then c2, dedup order within each) -------------------
        # survivors are grouped by ascending read (surv_read sorted), so
        # the flat entry stream is just the survivor stream filtered to
        # selected pairs, with each read's extras (<=1 fallback chain,
        # created in ascending-read order) spliced after its job entries
        n_reads_tot = 2 * len(pairs)
        cnt = np.bincount(surv_read, minlength=n_reads_tot)
        ex_rd = np.asarray(sorted(ex_by_read), dtype=np.int64) \
            if ex_by_read else np.zeros(0, dtype=np.int64)
        cnt_tot = cnt.copy()
        if len(ex_rd):
            cnt_tot[ex_rd] += 1
        sel_mask_pair = (cnt_tot[0::2] > 0) & (cnt_tot[1::2] > 0)
        sel_idx = np.nonzero(sel_mask_pair)[0].tolist()
        if not sel_idx:
            return out
        sel_read = np.zeros(n_reads_tot, dtype=bool)
        sel_read[0::2] = sel_mask_pair
        sel_read[1::2] = sel_mask_pair
        keep_s = sel_read[surv_read]
        fj = surv_job[keep_s].astype(np.int64)
        extras: list[GraphAlignment] = []
        if len(ex_rd):
            ex_keep = ex_rd[sel_read[ex_rd]]
            extras = [ex_by_read[int(rd)] for rd in ex_keep.tolist()]
            # insert -(1+i) after the last job entry of each extra's read:
            # position = #selected survivor entries with read <= rd
            read_of_kept = surv_read[keep_s]
            ins_pos = np.searchsorted(read_of_kept, ex_keep, side="right")
            fj = np.insert(fj, ins_pos,
                           -(1 + np.arange(len(ex_keep), dtype=np.int64)))
        n_sel = np.asarray(sel_idx, dtype=np.int64)
        n1l = cnt_tot[2 * n_sel]
        n2l = cnt_tot[2 * n_sel + 1]
        is_job = fj >= 0
        gj = np.where(is_job, fj, 0)
        ll_f = soa["ll"][gj].astype(np.float64)
        f_f = soa["f_lv"][gj].astype(np.int64)
        l_f = soa["l_lv"][gj].astype(np.int64)
        rev_f = soa["rev"][gj].astype(np.uint8)
        lv2_f = soa["lv2"][gj].astype(np.int64)
        kstart = soa["s"][gj].astype(np.int64)
        klen = (soa["e"] - soa["s"])[gj].astype(np.int64)
        if extras:
            ex_keys = []
            ex_base = len(soa["pos_keys"])
            for p in np.nonzero(~is_job)[0].tolist():
                c = extras[-(1 + int(fj[p]))]
                ll_f[p] = c.log_likelihood
                f_f[p] = c.first_level()
                l_f[p] = c.last_level()
                rev_f[p] = c.reverse
                if c._lv2 is not None:
                    lv2_f[p] = c._lv2
                else:
                    v = c.levels[c.levels >= 0]
                    lv2_f[p] = ((v[0], v[1] if len(v) > 1 else -1,
                                 v[-2] if len(v) > 1 else -1, v[-1])
                                if len(v) else (-1, -1, -1, -1))
                k = _position_keys(c)
                kstart[p] = ex_base + sum(len(x) for x in ex_keys)
                klen[p] = len(k)
                ex_keys.append(k)
            key_src = np.concatenate([soa["pos_keys"]] + ex_keys)
        else:
            key_src = soa["pos_keys"]
        key_off = np.r_[0, np.cumsum(klen)].astype(np.int64)
        total_k = int(key_off[-1])
        flat_idx = (np.repeat(kstart - key_off[:-1], klen)
                    + np.arange(total_k, dtype=np.int64))
        keys = key_src[flat_idx]
        tr_off = np.concatenate([self.hap_offsets,
                                 [len(self.hap_levels_cat)]])
        insert_sd = max(insert_sd, 1e-6)
        max_pen_log = _normal_logpdf(insert_mean + 8 * insert_sd,
                                     insert_mean, insert_sd)
        res = native.select_pairs(
            np.asarray(n1l), np.asarray(n2l), ll_f, f_f, l_f, lv2_f, rev_f,
            key_off, keys, self.hap_levels_cat, tr_off,
            insert_mean, insert_sd, max_pen_log)
        if res is None:
            return None
        b1, b2, pm, m1, m2, conf = res

        # ---- materialise the winners only -------------------------------
        base = 0
        for k_i, pi in enumerate(sel_idx):
            ln1 = int(n1l[k_i])
            ln2 = int(n2l[k_i])
            g1 = base + int(b1[k_i])
            g2 = base + ln1 + int(b2[k_i])
            chs = []
            for g in (g1, g2):
                code = int(fj[g])
                ch = (extras[-(1 + code)] if code < 0
                      else self._al_from_soa(soa, code))
                ch.mapq_per_pos = conf[key_off[g]:key_off[g + 1]]
                chs.append(ch)
            ch1, ch2 = chs
            ch1.mapq = float(m1[k_i])
            ch2.mapq = float(m2[k_i])
            self.stats.considered_chain_pairs += ln1 * ln2
            self.stats.n_align_calls += 1
            ap = AlignedPair(pairs[pi][0].name, ch1, ch2, float(pm[k_i]))
            if truth is not None:
                r1, r2 = pairs[pi]
                for mate_i, (chain, read) in enumerate(
                        ((ap.chain1, r1), (ap.chain2, r2)), start=1):
                    truth.evaluate(f"{read.name}/{mate_i}",
                                   chain.aligned_levels_per_base(len(read.seq)),
                                   chain.reverse)
            out.append(ap)
            base += ln1 + ln2
        return out

    def _select_pairs_native(self, pairs, per_pair, insert_mean, insert_sd,
                             max_pen_log):
        """Batched C++ combination selection (hla_select_pairs; identical
        semantics to _select_pair).  Returns {pair_idx: AlignedPair} or
        None when the native library is unavailable."""
        from .. import native
        if not native.available():
            return None
        sel_idx = [pi for pi in range(len(pairs))
                   if per_pair.get(pi) and per_pair[pi][0]
                   and per_pair[pi][1]]
        if not sel_idx:
            return {}
        chains_flat: list[GraphAlignment] = []
        n1l, n2l = [], []
        for pi in sel_idx:
            c1, c2 = per_pair[pi]
            n1l.append(len(c1))
            n2l.append(len(c2))
            chains_flat.extend(c1)
            chains_flat.extend(c2)
        nch = len(chains_flat)
        ll = np.asarray([c.log_likelihood for c in chains_flat])
        f_lv = np.asarray([c.first_level() for c in chains_flat])
        l_lv = np.asarray([c.last_level() for c in chains_flat])
        rev = np.asarray([c.reverse for c in chains_flat], dtype=np.uint8)
        lv2 = np.empty((nch, 4), dtype=np.int64)
        keys_list = []
        key_off = np.zeros(nch + 1, dtype=np.int64)
        for ci, c in enumerate(chains_flat):
            if c._lv2 is not None:
                lv2[ci] = c._lv2
            else:
                v = c.levels[c.levels >= 0]
                lv2[ci] = ((v[0], v[1] if len(v) > 1 else -1,
                            v[-2] if len(v) > 1 else -1, v[-1])
                           if len(v) else (-1, -1, -1, -1))
            k = _position_keys(c)
            keys_list.append(k)
            key_off[ci + 1] = key_off[ci] + len(k)
        keys = (np.concatenate(keys_list) if keys_list
                else np.zeros(0, np.int64))
        tr_off = np.concatenate([self.hap_offsets,
                                 [len(self.hap_levels_cat)]])
        res = native.select_pairs(
            np.asarray(n1l), np.asarray(n2l), ll, f_lv, l_lv, lv2, rev,
            key_off, keys, self.hap_levels_cat, tr_off,
            insert_mean, insert_sd, max_pen_log)
        if res is None:
            return None
        b1, b2, pm, m1, m2, conf = res
        out: dict[int, AlignedPair] = {}
        base = 0
        for k_i, pi in enumerate(sel_idx):
            c1, c2 = per_pair[pi]
            ch1 = c1[int(b1[k_i])]
            ch2 = c2[int(b2[k_i])]
            ch1.mapq = float(m1[k_i])
            ch2.mapq = float(m2[k_i])
            g1 = base + int(b1[k_i])
            g2 = base + len(c1) + int(b2[k_i])
            ch1.mapq_per_pos = conf[key_off[g1]:key_off[g1 + 1]]
            ch2.mapq_per_pos = conf[key_off[g2]:key_off[g2 + 1]]
            self.stats.considered_chain_pairs += len(c1) * len(c2)
            out[pi] = AlignedPair(pairs[pi][0].name, ch1, ch2,
                                  float(pm[k_i]))
            base += len(c1) + len(c2)
        return out

    def _select_pair(self, read_id: str, chains1: list[GraphAlignment],
                     chains2: list[GraphAlignment], insert_mean: float,
                     insert_sd: float, max_pen_log: float) -> AlignedPair:
        """alignOneReadPair combination model (processBAM.cpp:3408-3540) +
        assignMappingQualities (processBAM.cpp:4062-4310)."""
        # per-chain caches: underlying-sequence anchors and position keys are
        # combo-independent (the reference recomputes them per combination)
        from .alignment import _anchors as _anchors_fn
        warm = getattr(self.level_to_seqpos, "warm", None)
        if warm is not None:
            lv_all = []
            for c in chains1 + chains2:
                if c._lv2 is not None:
                    lv_all.extend(c._lv2.tolist())
            warm(lv_all)
        anchor_cache: dict[int, tuple] = {}

        def anchors_of(al):
            key = id(al)
            if key not in anchor_cache:
                anchor_cache[key] = (
                    _anchors_fn(al, True, 2, self.level_to_seqpos),
                    _anchors_fn(al, False, 2, self.level_to_seqpos))
            return anchor_cache[key]

        def distances(c1, c2):
            if c1.first_level() < c2.first_level():
                end1 = anchors_of(c1)[0]
                beg2 = anchors_of(c2)[1]
                return {beg2[s] - p - 1 for s, p in end1.items() if s in beg2}
            end2 = anchors_of(c2)[0]
            beg1 = anchors_of(c1)[1]
            return {beg1[s] - p - 1 for s, p in end2.items() if s in beg1}

        combos = []
        lls = []
        for i1, c1 in enumerate(chains1):
            for i2, c2 in enumerate(chains2):
                self.stats.considered_chain_pairs += 1
                ll = c1.log_likelihood + c2.log_likelihood
                if strands_valid(c1, c2):
                    ds = distances(c1, c2)
                    if ds:
                        # the reference takes log(pdf) and only substitutes the
                        # 8-sigma penalty when the pdf underflows to 0
                        # (processBAM.cpp:3446-3468)
                        ll_is = max(max_pen_log if lp < -700.0 else lp
                                    for lp in (_normal_logpdf(d, insert_mean,
                                                              insert_sd)
                                               for d in ds))
                    else:
                        ll_is = max_pen_log
                else:
                    ll_is = max_pen_log
                combos.append((i1, i2))
                lls.append(ll + ll_is)
        lls = np.asarray(lls)
        best = int(np.argmax(lls))
        b1, b2 = combos[best]
        pp = np.exp(lls - lls[best])
        pp /= pp.sum()

        chain1 = chains1[b1]
        chain2 = chains2[b2]
        pair_mapq = float(pp[best])
        mapq1 = float(sum(p for (i1, _), p in zip(combos, pp) if i1 == b1))
        mapq2 = float(sum(p for (_, i2), p in zip(combos, pp) if i2 == b2))
        chain1.mapq = min(mapq1, 1.0)
        chain2.mapq = min(mapq2, 1.0)

        # per-position posterior: sum combination probabilities that place the
        # same (graph char, level, read index) at a column
        # (assignMappingQualities position IDs, processBAM.cpp:4183-4209).
        # Equivalent O(chains x columns) form: each chain's keys receive its
        # marginal combination weight (keys are combo-independent).
        for mate, (chains, bsel) in enumerate(((chains1, b1), (chains2, b2))):
            weights = np.zeros(len(chains))
            for (i1, i2), p in zip(combos, pp):
                weights[i1 if mate == 0 else i2] += p
            key_cache = [_position_keys(c) for c in chains]
            all_keys = np.concatenate(key_cache)
            all_w = np.concatenate([np.full(len(k), weights[ci])
                                    for ci, k in enumerate(key_cache)])
            uniq, inv = np.unique(all_keys, return_inverse=True)
            conf = np.zeros(len(uniq))
            np.add.at(conf, inv, all_w)
            sel = chains[bsel]
            sel_idx = np.searchsorted(uniq, key_cache[bsel])
            sel.mapq_per_pos = np.minimum(conf[sel_idx], 1.0)
        return AlignedPair(read_id, chain1, chain2, pair_mapq)

    # ----------------------------------------------------- unpaired (long)
    def align_unpaired(self, reads: list[FastqRead], truth=None
                       ) -> list[GraphAlignment | None]:
        """alignOneLongRead equivalent: no pair model; mapQ from chain-LL
        posteriors (processBAM.cpp:3618-3839)."""
        with span("align.seed", reads=len(reads)):
            (read_of, seq_idx_a, rev_a, start_a, nk_a, _span_a) = \
                self.seeder.candidates_batch_arrays([r.seq for r in reads])
        if self.decoy is not None:
            dec = self.decoy.best_chain_kmers([r.seq for r in reads])
            prg_best = np.zeros(len(reads), dtype=np.int64)
            np.maximum.at(prg_best, read_of, nk_a)
            has = np.zeros(len(reads), dtype=bool)
            has[read_of] = True
            drop = (np.asarray(dec) > prg_best) & has
            n_drop = int(drop.sum())
            if n_drop:
                self.stats.bump("decoy_dropped_reads", n_drop)
                m = ~drop[read_of]
                read_of, seq_idx_a, rev_a, start_a = (
                    read_of[m], seq_idx_a[m], rev_a[m], start_a[m])
        win_start = start_a - self.band // 2
        self.stats.considered_chains += len(read_of)
        alignments = self._align_jobs_arrays(read_of, seq_idx_a, rev_a,
                                             win_start, reads,
                                             unpaired=True)
        per_read: dict[int, list[GraphAlignment]] = {}
        for r, al in zip(read_of.tolist(), alignments):
            if al is not None:
                per_read.setdefault(r, []).append(al)
        out: list[GraphAlignment | None] = []
        for pi, r in enumerate(reads):
            chains = per_read.get(pi)
            if not chains:
                out.append(None)
                continue
            lls = np.asarray([c.log_likelihood for c in chains])
            best = int(np.argmax(lls))
            pp = np.exp(lls - lls[best])
            pp /= pp.sum()
            sel = chains[best]
            sel.mapq = float(pp[best])
            key_cache = [_position_keys(c) for c in chains]
            all_keys = np.concatenate(key_cache)
            all_w = np.concatenate([np.full(len(k), pp[ci])
                                    for ci, k in enumerate(key_cache)])
            uniq, inv = np.unique(all_keys, return_inverse=True)
            conf = np.zeros(len(uniq))
            np.add.at(conf, inv, all_w)
            sel_idx = np.searchsorted(uniq, key_cache[best])
            sel.mapq_per_pos = np.minimum(conf[sel_idx], 1.0)
            if truth is not None:
                truth.evaluate(r.name, sel.aligned_levels_per_base(len(r.seq)),
                               sel.reverse)
            out.append(sel)
        return out

    # ------------------------------------------------------- insert size
    def estimate_insert_size(self, pairs: list[tuple[FastqRead, FastqRead]],
                             max_pairs: int = 4000) -> tuple[float, float]:
        """estimateInsertSize (processBAM.cpp:1071-1182): primary alignment of
        each mate, underlying-sequence distances, weighted histogram ->
        (median, max(|median-q20|, |median-q80|))."""
        hist: dict[int, float] = {}
        used = 0
        # one batched NW over the primary candidate of every mate
        jobs: list[_Job] = []
        job_slots: list[tuple[int, int]] = []
        sel = pairs[:max_pairs]
        sel_reads = [r for p in sel for r in p]
        sel_cands = self.seeder.candidates_batch([r.seq for r in sel_reads])
        for pi, (r1, r2) in enumerate(sel):
            j1 = self._make_jobs(pi, 1, r1, sel_cands[2 * pi])[:1]
            j2 = self._make_jobs(pi, 2, r2, sel_cands[2 * pi + 1])[:1]
            if j1 and j2:
                jobs += j1 + j2
        als_all = self._jobs_to_alignments(jobs)
        per_pair: dict[int, list] = {}
        for j, al in zip(jobs, als_all):
            per_pair.setdefault(j.pair_idx, []).append(al)
        for pi in per_pair:
            als = per_pair[pi]
            if len(als) != 2 or als[0] is None or als[1] is None:
                continue
            a1, a2 = als
            if not strands_valid(a1, a2):
                continue
            ds = pair_distances_underlying(a1, a2, self.level_to_seqpos)
            if not ds:
                continue
            w = 1.0 / len(ds)
            for d in ds:
                hist[d] = hist.get(d, 0.0) + w
            used += 1
        if not hist:
            # the reference dies here (estimateInsertSize asserts a non-empty
            # histogram, processBAM.cpp:1071-1182); we fall back but loudly
            import sys
            print("WARNING: insert-size estimation found no usable proper "
                  "pairs — falling back to (mean=300, sd=100); pair selection "
                  "and the typer's insert gate may be miscalibrated",
                  file=sys.stderr, flush=True)
            return 300.0, 100.0
        return insert_size_from_histogram(hist)


def insert_size_from_histogram(hist: dict[int, float]) -> tuple[float, float]:
    """calculateInsertSizeFromHistogram (processBAM.cpp:991-1072)."""
    total = sum(hist.values())
    cum = 0.0
    median = q20 = q80 = None
    for d in sorted(hist):
        cum += hist[d]
        if q20 is None and cum >= total * 0.2:
            q20 = d
        if median is None and cum >= total * 0.5:
            median = d
        if q80 is None and cum >= total * 0.8:
            q80 = d
    sd = max(abs(median - q20), abs(median - q80))
    return float(median), float(max(sd, 1.0))


def _normal_logpdf(x: float, mean: float, sd: float) -> float:
    z = (x - mean) / sd
    return -0.5 * z * z - math.log(sd * math.sqrt(2 * math.pi))


def _position_keys(al: GraphAlignment) -> np.ndarray:
    """Column identity keys for per-position confidence accumulation
    (positionID strings, processBAM.cpp:4188), packed into int64:
    (graph char, graph level, strand, read index)."""
    if al._pos_keys is not None:
        return al._pos_keys
    seq_base = al.seq_c != ord("_")
    i_nogap = np.cumsum(seq_base) - 1
    n_bases = int(seq_base.sum())
    idx = np.where(seq_base,
                   (n_bases - i_nogap - 1) if al.reverse else i_nogap,
                   -1).astype(np.int64)
    return ((al.levels + 2) << 28) | ((idx + 2) << 10) | \
        (al.graph_c.astype(np.int64) << 1) | int(al.reverse)
