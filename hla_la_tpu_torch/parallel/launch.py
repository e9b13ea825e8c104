"""One process per rank on this host: ``run_ranks`` spawns them, each joins
the process group through a file store, builds the data x model mesh (its
model axis derived from the rank count, ``mesh.model_axis``) and calls
``fn(mesh, *args)``; the results come back in rank order.

``fn`` and the ``rank_*`` functions below live here, in an importable module,
because a spawned child cannot import a function of the caller's script.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import tempfile
import time
import traceback

import torch

from . import mesh as mesh_mod


def _rank_entry(rank, world_size, init_method, device, timeout_s, fn,
                args_conn, conn):
    torch.set_num_threads(1)
    try:
        args = args_conn.recv()
        args_conn.close()
        try:
            dev = mesh_mod.init_ranks(rank, world_size, init_method, device,
                                      timeout_s)
            n_model = mesh_mod.model_axis(world_size)
            m = mesh_mod.make_mesh(world_size // n_model, n_model, device=dev)
            conn.send((True, fn(m, *args)))
        finally:
            mesh_mod.close_ranks()
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()


def run_ranks(fn, world_size: int, device: str = "cuda", args: tuple = (),
              timeout_s: float = mesh_mod.RENDEZVOUS_TIMEOUT_S) -> list:
    """fn(mesh, *args) on `world_size` spawned ranks of the data x model
    mesh of that many ranks (mesh.model_axis of them along "model");
    returns the ranks' results in rank order.  Raises if any rank
    failed, exited without a result or did not arrive at the rendezvous
    within `timeout_s`; a run of healthy ranks may take as long as it
    needs.  The rendezvous is a file in a temporary directory, never a TCP
    port."""
    from ..models.parallel_host import spawn_safe
    if not spawn_safe():
        raise RuntimeError("run_ranks needs a file-backed __main__ module "
                           "(multiprocessing spawn)")
    if torch.device(device).type == "cuda":
        # one build, here, before any rank asks for the library
        from .. import _build
        _build.library()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as td:
        init_method = "file://" + os.path.join(td, "rendezvous")
        procs, conns, arg_conns = [], [], []
        for rank in range(world_size):
            recv, send = ctx.Pipe(duplex=False)
            arg_recv, arg_send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_entry,
                            args=(rank, world_size, init_method, device,
                                  timeout_s, fn, arg_recv, send))
            p.start()
            send.close()
            arg_recv.close()
            procs.append(p)
            conns.append(recv)
            arg_conns.append(arg_send)
        # the arguments go to the ranks once all of them are starting: a
        # start's own pickle must stay small, or each start waits for the
        # previous rank to have imported its modules and read them
        for arg_send in arg_conns:
            try:
                arg_send.send(args)
            except OSError:
                pass    # the rank ended before reading them: reported below
            finally:
                arg_send.close()
        results, errors = [None] * world_size, []
        pending = {conn: rank for rank, conn in enumerate(conns)}
        try:
            # whichever rank answers first is read first: a failed rank
            # leaves the others waiting in a collective.  No wall limit: a
            # rank that dies closes its pipe, which wakes this wait
            while pending and not errors:
                for conn in mp_connection.wait(list(pending)):
                    rank = pending.pop(conn)
                    try:
                        ok, value = conn.recv()
                    except EOFError:
                        ok, value = False, "exited without a result"
                    if ok:
                        results[rank] = value
                    else:
                        errors.append(f"rank {rank}: {value}")
        finally:
            for p in procs:
                if errors and p.is_alive():
                    p.kill()
                p.join()
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return results


# ---- what a rank can be asked to do (tests, the smoke run, the CLI) ----
def rank_typing_step(m, onehot, contrib):
    return mesh_mod.sharded_typing_step(m)(onehot, contrib)


def rank_full_step(m, L, W, reads, lens, refs, onehot, contrib):
    return mesh_mod.full_step(m, L, W)(reads, lens, refs, onehot, contrib)


def rank_timed_full_step(m, L, W, reads, lens, refs, onehot, contrib,
                         iters):
    """full_step once (warm-up), then `iters` times on the host clock: the
    last call's (scores, pair), the seconds of each timed call (each ends
    with the gathered numpy result, so the devices have finished), and this
    rank's kernel launches."""
    from ..models.parallel_host import kernel_launches
    step = mesh_mod.full_step(m, L, W)
    out = step(reads, lens, refs, onehot, contrib)
    secs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = step(reads, lens, refs, onehot, contrib)
        secs.append(time.perf_counter() - t0)
    return out, secs, kernel_launches()


def rank_pair_reduction(m, L):
    return mesh_mod.pair_ll_reduction_sharded(L, m)


def rank_timed_pair_reduction(m, npy_path):
    """The sharded pair reduction of the [C, R] matrix saved at `npy_path`
    (each rank maps the file and reads its own share of it, rather than
    every rank being sent the whole matrix) twice on this rank (cold, then
    warm): rank 0's pair matrix, the walls, this rank's share (its range of
    K3's tile list as (first, count), its reads as [lo, hi)), its K3
    launches and, on a card, each warm launch's device milliseconds."""
    import numpy as np

    from ..models.parallel_host import kernel_launches
    from ..ops.cuda_pair import pair_ll_diff_cuda
    L = np.load(npy_path, mmap_mode="r")
    C, R = L.shape
    t0 = time.time()
    mesh_mod.pair_ll_reduction_sharded(L, m)
    cold = time.time() - t0
    if m.device.type == "cuda":
        pair_ll_diff_cuda.events = []
    try:
        t0 = time.time()
        pair = mesh_mod.pair_ll_reduction_sharded(L, m)
        warm = time.time() - t0
    finally:
        events, pair_ll_diff_cuda.events = pair_ll_diff_cuda.events, None
    if events:
        torch.cuda.synchronize(m.device)
    tiles, reads = m.pair_share(C, R)
    return {"rank": m.rank, "pair": pair if m.rank == 0 else None,
            "cold_s": cold, "warm_s": warm, "tile_range": list(tiles),
            "reads": list(reads),
            "launches": kernel_launches()["K3"],
            "k3_ms": [s.elapsed_time(e) for s, e in events or ()]}


def rank_sharded_nw(m, reads, lens, refs):
    L = reads.shape[1]
    return mesh_mod.ShardedNW(m, L, refs.shape[1] - L)(reads, lens, refs)


def rank_nw_and_pair(m, reads, lens, refs, L):
    """ShardedNW and the sharded pair reduction in one start of the ranks:
    (NW outputs, pair matrix, this process's kernel launches)."""
    from ..models.parallel_host import kernel_launches
    return (rank_sharded_nw(m, reads, lens, refs), rank_pair_reduction(m, L),
            kernel_launches())


def rank_hla_typing(m, graph, fastqs, out_dir, cfg,
                    min_reads_for_workers=None):
    """run_hla_typing on this rank of `m` with `cfg` (its workers, its
    typer's gate, its long-read mode) of the pairs of `fastqs` = (FASTQ1,
    FASTQ2), or of its unpaired reads = (FASTQU,); `min_reads_for_workers`
    sets the pool's read threshold (pipeline.MIN_READS_FOR_WORKERS) on this
    rank, for a world too small to start the pool.  Returns the calls as
    (locus, allele 1, allele 2, Q1, Q2), this process's kernel launches and
    its largest launch of each kernel."""
    from ..bench_common import largest_launches
    from ..graph.package import GraphPackage
    from ..io.fastq import read_fastq
    from ..models import pipeline
    from ..models.parallel_host import kernel_launches
    if min_reads_for_workers is not None:
        pipeline.MIN_READS_FOR_WORKERS = min_reads_for_workers
    if len(fastqs) == 2:
        reads = {"pairs": pipeline.pair_up_fastq(*fastqs)}
    else:
        reads = {"unpaired": list(read_fastq(*fastqs))}
    res = pipeline.run_hla_typing(GraphPackage(graph), **reads,
                                  output_dir=out_dir, cfg=cfg,
                                  device=m.device, sharded=m)
    return ([(r.locus, r.allele1_id, r.allele2_id, r.q1_allele1,
              r.q1_allele2) for r in res.results], kernel_launches(),
            largest_launches())


def rank_cli(m, argv, trace: bool = False):
    """The port's CLI on this rank of `m`: (exit code, this process's
    kernel launches, its largest launch of each kernel, and with `trace`
    the linear-ALT typer's trace of the run (``LinearALTsTyper.trace``)
    or else None)."""
    from .. import cli
    from ..bench_common import largest_launches
    from ..models.linear_alts import LinearALTsTyper
    from ..models.parallel_host import kernel_launches
    if trace:
        LinearALTsTyper.trace = []
    try:
        rc = cli.main(list(argv), mesh=m)
    finally:
        got, LinearALTsTyper.trace = LinearALTsTyper.trace, None
    return rc, kernel_launches(), largest_launches(), got
