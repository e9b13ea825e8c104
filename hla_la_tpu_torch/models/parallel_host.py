"""Host-side process parallelism for the alignment pipeline: the
counterpart of ``hla_la_tpu/models/parallel_host.py``.

The reference is thread-ready around its per-read-pair loop (OpenMP pragmas,
commented out in the snapshot — processBAM.cpp:2076; typing uses
`--maxThreads`).  Reads are i.i.d., so the host work (seeding, staging,
backtrace, projection, pair selection) is spread over worker processes, each
owning a full ReadAligner built from the compiled graph package.

How the workers share one card: they do not touch it.  As the reference's
workers run on the host (``JAX_PLATFORMS=cpu`` and an aligner without JAX),
the port's are host-only: no CUDA call, no context, no page-locked memory.
Each worker's aligner sends its NW calls (K1 or K2) to the device server, a
thread of the parent that runs them on the parent's device through the same
``NWRunner`` the one-process run uses (``models/device_server.py``); the
typing workers taken from this pool send their cluster x read products and
pair reductions (K3) there too.  So no NW job is taken by a host forward,
and the card holds one context.  Workers are spawned, never forked.  Each
worker's region, through which its arrays reach the server, takes NW calls
of at most ``NW_POINTER_BUDGET / n_workers`` bytes: the regions of all
workers together hold what one process would pin, and since every NW job is
independent of how jobs are cut into calls, the alignments do not change.
A worker's counters (``Stats``, with the launches the server made for it as
``served_launches_<kernel>``) come back with every chunk and are summed in
the parent, with a report that the worker has not initialised CUDA (the
parent raises if one has); an exception in a worker or in the server
reaches the caller through the pool, and a worker that dies ends the run
(``DeviceServer.watch``).  In a traced sample (``utils/timing.py``) each
task carries the sample's span context, and the worker's spans come back
beside its counters.
"""

from __future__ import annotations

import multiprocessing as mp
import os

from ..utils import timing

_WORKER_ALIGNER = None
_STAT_FIELDS = ("n_align_calls", "considered_chains",
                "considered_chain_pairs", "n_chain_extensions",
                "selected_columns_total", "selected_columns_from_seed")


def kernel_launches() -> dict:
    """Launches of each kernel wrapper in this process, by kernel."""
    from ..ops.cuda_nw import banded_nw_cuda
    from ..ops.cuda_nw_long import banded_nw_long_cuda
    from ..ops.cuda_pair import pair_ll_diff_cuda
    return {"K1": banded_nw_cuda.launches, "K2": banded_nw_long_cuda.launches,
            "K3": pair_ll_diff_cuda.launches}


def stats_counters(st) -> dict:
    """A Stats record as one flat dict."""
    return {**{k: getattr(st, k) for k in _STAT_FIELDS}, **st.extras}


def _counters() -> dict:
    """The worker aligner's Stats (the served launches among them) as one
    flat dict of running totals."""
    return stats_counters(_WORKER_ALIGNER.stats)


def _counted(before: dict) -> dict:
    """What the counters gained since `before`."""
    return {k: v - before.get(k, 0) for k, v in _counters().items()
            if v != before.get(k, 0)}


def add_counters(stats, delta: dict) -> None:
    """Sum a worker's `delta` into the parent's `stats`."""
    for k, v in delta.items():
        if k in _STAT_FIELDS:
            setattr(stats, k, getattr(stats, k) + v)
        else:
            stats.bump(k, v)


def _init_worker(graph_dir: str, band, kmer_k: int, long_reads: str,
                 decoy_fasta: str = "", map_complete: bool = False,
                 server: tuple = (), region_share: int | None = None,
                 t_pool: int | None = None, trace: tuple | None = None):
    """A host-only alignment worker: its aligner's NW forward is the
    device server's (`server`: DeviceServer.initargs).  `t_pool`: the
    pool's start on timing.clock(); `trace`: the sample's
    timing.context(), under which the worker records its start as the
    spans worker.init, worker.imports, worker.connect and worker.package,
    sent back with its first task's result."""
    global _WORKER_ALIGNER
    t_enter = timing.clock()
    from ..graph.package import GraphPackage
    from ..utils.config import RunConfig
    from . import aligner, device_server
    cfg = RunConfig(long_reads=long_reads, decoy_fasta=decoy_fasta,
                    map_against_complete_genome=map_complete)
    served = device_server.connect(*server, region_share=region_share)
    t_connected = timing.clock()
    pkg = GraphPackage(graph_dir)
    from .pipeline import build_decoy
    decoy = build_decoy(pkg, cfg)   # cache-hit after the parent built it
    _WORKER_ALIGNER = aligner.ReadAligner(
        pkg, cfg, band=band, kmer_k=kmer_k, decoy=decoy,
        device=served.device, nw_runner=device_server.ServedNWRunner(served))
    t_ready = timing.clock()
    t_pool = t_pool or t_enter
    with timing.task(trace):
        init = timing.record("worker.init", t_pool, t_ready)
        timing.record("worker.imports", t_pool, t_enter, parent=init)
        timing.record("worker.connect", t_enter, t_connected, parent=init)
        timing.record("worker.package", t_connected, t_ready, parent=init)
    timing.log_progress(
        f"alignment worker {os.getpid()} ready, host-only, served on "
        f"{served.device} {(t_ready - t_pool) / 1e9:.1f} s after the pool "
        f"was made: process start and imports "
        f"{(t_enter - t_pool) / 1e9:.1f} s, connection to the device "
        f"server {(t_connected - t_enter) / 1e9:.1f} s, package and aligner "
        f"{(t_ready - t_connected) / 1e9:.1f} s; torch "
        f"imported: {device_server.torch_imported()}, CUDA initialised: "
        f"{device_server.cuda_initialized()}")


def _report() -> dict:
    from .device_server import client
    return client().report()


def _align_chunk(args):
    # a traced task's spans go back beside its counters (after its first
    # task, with the worker's start)
    idx, packed, insert_mean, insert_sd, *trace = args
    before = _counters()
    with timing.task(*trace), timing.span("align.chunk",
                                          pairs=packed[0] // 2):
        pack = pack_aligned_pairs(
            _WORKER_ALIGNER.align_pairs(unpack_read_pairs(packed),
                                        insert_mean, insert_sd))
    return (idx, pack, _counted(before), _report(),
            timing.drain() if trace else None)


def _align_unpaired_chunk(args):
    idx, packed, *trace = args
    before = _counters()
    with timing.task(*trace), timing.span("align.chunk", reads=packed[0]):
        out = _WORKER_ALIGNER.align_unpaired(unpack_reads(packed))
    return (idx, out, _counted(before), _report(),
            timing.drain() if trace else None)


def pack_reads(reads):
    """Count + three newline-joined strings instead of a list of FastqRead
    objects: pickling ~100k small dataclasses per dispatch is slow at
    real-PRG scale.  FASTQ/BAM fields never contain newlines.
    The explicit count disambiguates the n==1-with-empty-field case
    (\"\" joins to \"\" for both 0 and 1 reads) and guards truncation."""
    return (len(reads),
            "\n".join(r.name for r in reads),
            "\n".join(r.seq for r in reads),
            "\n".join(r.qual for r in reads))


def unpack_reads(t):
    from ..io.fastq import FastqRead
    n = t[0]
    if n == 0:
        return []
    cols = [s.split("\n") for s in t[1:]]
    for c in cols:
        assert len(c) == n, f"packed read chunk corrupt: {len(c)} != {n}"
    return [FastqRead(nm, sq, q) for nm, sq, q in zip(*cols)]


def pack_read_pairs(pairs):
    return pack_reads([r for p in pairs for r in p])


def unpack_read_pairs(t):
    rs = unpack_reads(t)
    return list(zip(rs[0::2], rs[1::2]))


def pack_chains(chains):
    """Serialise a list of GraphAlignment chains into large arrays (the
    shared layer under pack_aligned_pairs and the align-shard files)."""
    import numpy as np
    n_cols = np.asarray([c.n_columns for c in chains], dtype=np.int64)
    return dict(
        n_cols=n_cols,
        levels=(np.concatenate([c.levels for c in chains])
                if chains else np.zeros(0, np.int64)),
        graph_c=(np.concatenate([c.graph_c for c in chains])
                 if chains else np.zeros(0, np.uint8)),
        seq_c=(np.concatenate([c.seq_c for c in chains])
               if chains else np.zeros(0, np.uint8)),
        seq_qual=(np.concatenate([c.seq_qual for c in chains])
                  if chains else np.zeros(0, np.uint8)),
        mapq_pp=(np.concatenate(
            [c.mapq_per_pos if c.mapq_per_pos is not None
             else np.ones(c.n_columns) for c in chains])
            if chains else np.zeros(0)),
        reverse=np.asarray([c.reverse for c in chains], dtype=bool),
        seq_idx=np.asarray([c.seq_idx for c in chains], dtype=np.int64),
        mapq=np.asarray([c.mapq for c in chains]),
        ll=np.asarray([c.log_likelihood for c in chains]),
        ffr=np.asarray([c.from_first_read for c in chains], dtype=bool),
        first_lv=np.asarray([c.first_level() for c in chains],
                            dtype=np.int64),
        last_lv=np.asarray([c.last_level() for c in chains], dtype=np.int64),
        # per-chain quality fractions computed HERE (in the worker, in
        # parallel, over the already-concatenated arrays) so the typing
        # phase's weighted_ok/fraction_ok batch passes are all cache hits;
        # both batch functions are bit-identical to their lazy forms
        wok=_wok_of(chains),
        fok=_fok_of(chains),
    )


def pack_unpaired_chains(chains):
    """pack_chains without the quality-fraction caches.  A one-process run
    scores an unpaired chain by the scalar alignment_weighted_ok_fraction,
    whose pairwise sum can differ in the last digits from the batch form's
    column-order sum on a long read with many mismatches; shipping the batch
    value would make a shard merge or a typing worker print another
    weightedOK fraction than the one-process run.  (Pairs are scored by the
    batch form on every path.)"""
    d = pack_chains(chains)
    del d["wok"], d["fok"]
    return d


def _wok_of(chains):
    from .alignment import weighted_ok_fractions_batch
    return weighted_ok_fractions_batch(chains)


def _fok_of(chains):
    from .alignment import fraction_ok_batch
    return fraction_ok_batch(chains)


def pack_aligned_pairs(aps):
    """Serialise a list of AlignedPair into a handful of large arrays —
    pickling thousands of small per-chain arrays dominates IPC otherwise."""
    import numpy as np
    d = pack_chains([c for ap in aps for c in (ap.chain1, ap.chain2)])
    d["read_ids"] = "\n".join(ap.read_id for ap in aps)
    d["pair_mapq"] = np.asarray([ap.mapq for ap in aps])
    return d


def _chain_from_pack(d: dict, s: int, e: int, j: int):
    """One GraphAlignment from pack slice [s:e] / chain index j — the
    single construction point shared by unpack_chains and the lazy
    PackedAlignedPairs.chain (divergence here would desynchronise
    worker-unpacked and lazily-materialised chains)."""
    from .alignment import GraphAlignment
    al = GraphAlignment(
        levels=d["levels"][s:e], graph_c=d["graph_c"][s:e],
        seq_c=d["seq_c"][s:e], seq_qual=d["seq_qual"][s:e],
        reverse=bool(d["reverse"][j]), seq_idx=int(d["seq_idx"][j]),
        mapq=float(d["mapq"][j]), mapq_per_pos=d["mapq_pp"][s:e],
        from_first_read=bool(d["ffr"][j]),
        log_likelihood=float(d["ll"][j]))
    al._first_level = int(d["first_lv"][j])
    al._last_level = int(d["last_lv"][j])
    return al


def unpack_chains(d):
    import numpy as np
    offs = np.concatenate([[0], np.cumsum(d["n_cols"])])
    chains = []
    for i in range(len(d["n_cols"])):
        chains.append(_chain_from_pack(d, int(offs[i]), int(offs[i + 1]), i))
    # quality-fraction caches shipped with the pack (absent in pre-existing
    # align-shard files: stays lazy then)
    wok = d.get("wok")
    fok = d.get("fok")
    if wok is not None and fok is not None and len(wok) == len(chains):
        wok_l, fok_l = wok.tolist(), fok.tolist()
        for i, al in enumerate(chains):
            al._wok = wok_l[i]
            al._frac_ok = fok_l[i]
    return chains


def unpack_aligned_pairs(d):
    from .aligner import AlignedPair
    ids = d["read_ids"].split("\n") if d["read_ids"] else []
    chains = unpack_chains(d)
    return [AlignedPair(ids[i], chains[2 * i], chains[2 * i + 1],
                        float(d["pair_mapq"][i]))
            for i in range(len(ids))]


class PackedAlignedPairs:
    """Sequence façade over the packed SoA chain arrays — the align→typing
    seam closed (VERDICT r4 next #1).  The workers' flat chain arrays stay
    live through typing: per-pair/per-chain scalar arrays (level ranges,
    reverse flags, mapQ, weightedOK/fractionOK) are read straight off the
    pack with zero python loops, and `GraphAlignment`/`AlignedPair` objects
    materialise LAZILY — only for the chains a locus actually visits (obs
    extraction) or for explicit consumers (truth evaluation, BAM export).
    Matches the reference's in-memory handoff processBAM.cpp:1788-1923 →
    HLATyper.cpp:933 without the object puff-up in between.

    `pack` keys are exactly `pack_aligned_pairs`'s output; `subset()` and
    `from_chunks()` operate purely on the arrays, so fan-out shipping and
    shard merging never round-trip through objects either."""

    __slots__ = ("pack", "_offs", "_ids", "_pairs", "_chains")

    def __init__(self, pack: dict):
        self.pack = pack
        self._offs = None
        self._ids = None
        self._pairs = None
        self._chains = None

    def __getstate__(self):
        return self.pack      # pickle the arrays, never the lazy caches

    def __setstate__(self, pack):
        self.__init__(pack)

    # ------------------------------------------------------------ plumbing
    @classmethod
    def from_chunks(cls, packs: list[dict]) -> "PackedAlignedPairs":
        """Concatenate per-chunk packs (worker results) into one.  Only
        keys present in EVERY pack are kept: merging align-shard files
        from mixed builds (older shards lack the wok/fok caches) must
        drop the optional caches, not crash — consumers already guard on
        key presence."""
        import numpy as np
        if not packs:
            return cls(pack_aligned_pairs([]))
        if len(packs) == 1:
            return cls(packs[0])
        keys = set(packs[0])
        for p in packs[1:]:
            keys &= set(p)
        missing = {"n_cols", "levels", "pair_mapq", "read_ids"} - keys
        if missing:
            raise ValueError(f"align packs missing required keys: "
                             f"{sorted(missing)}")
        out = {k: np.concatenate([p[k] for p in packs])
               for k in keys if k != "read_ids"}
        out["read_ids"] = "\n".join(
            p["read_ids"] for p in packs if p["read_ids"])
        return cls(out)

    @property
    def offsets(self):
        import numpy as np
        if self._offs is None:
            self._offs = np.concatenate(
                [[0], np.cumsum(self.pack["n_cols"])])
        return self._offs

    @property
    def read_ids(self) -> list[str]:
        if self._ids is None:
            s = self.pack["read_ids"]
            self._ids = s.split("\n") if s else []
        return self._ids

    def __len__(self) -> int:
        return len(self.pack["pair_mapq"])

    # ------------------------------------------------- lazy materialisation
    def chain(self, j: int):
        """GraphAlignment for chain index j (pair i's mates are 2i, 2i+1),
        materialised on first touch and cached — obs extraction revisits
        the same chains across typing passes, and `_chain_records` caches
        live on the object."""
        if self._chains is None:
            self._chains = [None] * (2 * len(self))
        al = self._chains[j]
        if al is None:
            d = self.pack
            offs = self.offsets
            al = _chain_from_pack(d, int(offs[j]), int(offs[j + 1]), j)
            wok, fok = d.get("wok"), d.get("fok")
            if wok is not None and fok is not None \
                    and len(wok) == 2 * len(self):
                al._wok = float(wok[j])
                al._frac_ok = float(fok[j])
            self._chains[j] = al
        return al

    def __getitem__(self, i):
        from .aligner import AlignedPair
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if self._pairs is None:
            self._pairs = [None] * n
        ap = self._pairs[i]
        if ap is None:
            ap = AlignedPair(self.read_ids[i], self.chain(2 * i),
                             self.chain(2 * i + 1),
                             float(self.pack["pair_mapq"][i]))
            self._pairs[i] = ap
        return ap

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------- array surgery
    def subset(self, idx) -> "PackedAlignedPairs":
        """New PackedAlignedPairs with pairs `idx` (any order) — pure array
        gathers, no object round-trip."""
        import numpy as np
        idx = np.asarray(idx, dtype=np.int64)
        d = self.pack
        ci = np.empty(2 * len(idx), dtype=np.int64)
        ci[0::2] = 2 * idx
        ci[1::2] = 2 * idx + 1
        offs = self.offsets
        lens = d["n_cols"][ci]
        starts = offs[ci]
        total = int(lens.sum())
        ends_out = np.cumsum(lens)
        col_idx = (np.arange(total, dtype=np.int64)
                   - np.repeat(ends_out - lens, lens)
                   + np.repeat(starts, lens))
        ids = self.read_ids
        out = dict(
            n_cols=lens,
            levels=d["levels"][col_idx], graph_c=d["graph_c"][col_idx],
            seq_c=d["seq_c"][col_idx], seq_qual=d["seq_qual"][col_idx],
            mapq_pp=d["mapq_pp"][col_idx],
            reverse=d["reverse"][ci], seq_idx=d["seq_idx"][ci],
            mapq=d["mapq"][ci], ll=d["ll"][ci], ffr=d["ffr"][ci],
            first_lv=d["first_lv"][ci], last_lv=d["last_lv"][ci],
            read_ids="\n".join(ids[i] for i in idx.tolist()),
            pair_mapq=d["pair_mapq"][idx],
        )
        for k in ("wok", "fok"):
            if k in d:
                out[k] = d[k][ci]
        return PackedAlignedPairs(out)


def spawn_safe() -> bool:
    """A spawned child sets up its __main__ from the parent's: by module
    name (``python -m``), or by re-running the file ``__main__.__file__``
    names.  With an interactive / stdin main module that file does not
    exist and the child crash-loops; a main module with no ``__file__`` at
    all (``python -c``, an embedding runner) is not re-run, so there is
    nothing to go wrong.  Only parallelise when safe, and never from inside
    a worker (a child re-running unguarded __main__ code must not spawn
    grandchildren)."""
    import sys
    if os.environ.get("HLA_LA_IN_WORKER"):
        return False
    main = sys.modules.get("__main__")
    if getattr(getattr(main, "__spec__", None), "name", None):
        return True
    f = getattr(main, "__file__", None)
    return f is None or os.path.exists(f)


class ParallelAligner:
    """Drop-in align_pairs/align_unpaired over a process pool of host-only
    workers, whose device calls the parent's DeviceServer runs."""

    def __init__(self, graph_dir: str, n_workers: int,
                 band: int | None = None,
                 kmer_k: int = 20, long_reads: str = "",
                 decoy_fasta: str = "", map_complete: bool = False, *,
                 device):
        if not spawn_safe():
            raise RuntimeError(
                "ParallelAligner needs a file-backed __main__ module "
                "(multiprocessing spawn); use the serial ReadAligner")
        from ..device import resolve
        from ..utils.timing import Stats
        from . import aligner
        from .device_server import DeviceServer
        self.device = resolve(device)
        if self.device.type == "cuda":
            from .. import _build
            _build.library()
        ctx = mp.get_context("spawn")
        self.n_workers = max(1, n_workers)
        self.stats = Stats()     # the workers' counters, summed
        # each worker's last report (DeviceClient.report), by pid
        self.workers: dict[int, dict] = {}
        self.server = DeviceServer(self.device)
        # each worker's share of the bytes of NW calls in flight
        self.region_share = max(1, aligner.NW_POINTER_BUDGET
                                // self.n_workers)
        os.environ["HLA_LA_IN_WORKER"] = "1"   # inherited by children
        self.pool = None
        try:
            self.pool = ctx.Pool(self.n_workers, initializer=_init_worker,
                                 initargs=(graph_dir, band, kmer_k,
                                           long_reads, decoy_fasta,
                                           map_complete, self.server.initargs,
                                           self.region_share, timing.clock(),
                                           timing.context(outermost=True)))
        finally:
            del os.environ["HLA_LA_IN_WORKER"]
            if self.pool is None:
                self.server.stop()

    def note_worker(self, report: dict) -> None:
        """Keep a worker's report; a worker that initialised CUDA ends the
        run."""
        self.workers[report["pid"]] = report
        if report["cuda_initialized"]:
            raise RuntimeError(f"worker {report['pid']} initialised CUDA: "
                               "the workers must stay on the host")

    def align_pairs(self, pairs, insert_mean, insert_sd, truth=None):
        if not pairs:
            return []
        # ~6 chunks per worker: tail-imbalance costs more than the extra
        # IPC
        chunk = max(256, -(-len(pairs) // (self.n_workers * 6)))
        chunks = [pairs[i:i + chunk] for i in range(0, len(pairs), chunk)]
        # imap_unordered so the parent unpacks each chunk while workers are
        # still aligning the rest (pool.map would leave the parent idle and
        # then unpack everything serially); chunk ids restore the order
        slots = [None] * len(chunks)
        trace = timing.carry()
        for idx, res, counted, report, spans in self.server.watch(
                self.pool.imap_unordered(
                    _align_chunk,
                    [(i, pack_read_pairs(c), insert_mean, insert_sd, *trace)
                     for i, c in enumerate(chunks)])):
            slots[idx] = res
            add_counters(self.stats, counted)
            self.note_worker(report)
            timing.add(spans)
        # the packed chunk arrays stay live end-to-end (PackedAlignedPairs):
        # GraphAlignment objects materialise lazily, only where consumed
        out = PackedAlignedPairs.from_chunks(slots)
        if truth is not None:
            by_id = {ap.read_id: ap for ap in out}
            for r1, r2 in pairs:
                ap = by_id.get(r1.name)
                if ap is None:
                    continue
                truth.evaluate(f"{r1.name}/1",
                               ap.chain1.aligned_levels_per_base(len(r1.seq)),
                               ap.chain1.reverse)
                truth.evaluate(f"{r2.name}/2",
                               ap.chain2.aligned_levels_per_base(len(r2.seq)),
                               ap.chain2.reverse)
        return out

    def align_unpaired(self, reads, truth=None):
        if not reads:
            return []
        chunk = max(256, -(-len(reads) // (self.n_workers * 2)))
        chunks = [reads[i:i + chunk] for i in range(0, len(reads), chunk)]
        slots = [None] * len(chunks)
        trace = timing.carry()
        for idx, res, counted, report, spans in self.server.watch(
                self.pool.imap_unordered(
                    _align_unpaired_chunk,
                    [(i, pack_reads(c), *trace)
                     for i, c in enumerate(chunks)])):
            slots[idx] = res
            add_counters(self.stats, counted)
            self.note_worker(report)
            timing.add(spans)
        out = [al for res in slots for al in res]
        if truth is not None:
            for r, al in zip(reads, out):
                if al is not None:
                    truth.evaluate(r.name,
                                   al.aligned_levels_per_base(len(r.seq)),
                                   al.reverse)
        return out

    def close(self):
        """Stop the server, then the pool; log what the server ran and
        each worker's last report."""
        from ..utils.timing import log_progress
        self.server.stop()
        self.pool.close()
        self.pool.join()
        sv = self.server.served
        log_progress(
            f"device server on {self.device}: {sv['requests']} requests from "
            f"{len(self.server.region_peak)} workers, {sv['nw_jobs']} NW "
            f"jobs, launches " + ", ".join(
                f"{k} {n}" for k, n in sv["launches"].items()))
        for pid, rep in sorted(self.workers.items()):
            ms = {k: round(v, 3) for k, v in rep["device_ms"].items()}
            log_progress(
                f"alignment worker {pid}: CUDA initialised "
                f"{rep['cuda_initialized']} after its last task (torch "
                f"imported: {rep['torch_imported']}); {rep['requests']} "
                f"device requests, device ms by kernel {ms}; region "
                f"{rep['region_bytes'] / 2**20:.1f} MiB")
