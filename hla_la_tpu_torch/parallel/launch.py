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
import traceback

import torch

from . import mesh as mesh_mod


def _rank_entry(rank, world_size, init_method, device, timeout_s, fn, args,
                conn):
    torch.set_num_threads(1)
    try:
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
        procs, conns = [], []
        for rank in range(world_size):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_entry,
                            args=(rank, world_size, init_method, device,
                                  timeout_s, fn, args, send))
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
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


def rank_pair_reduction(m, L):
    return mesh_mod.pair_ll_reduction_sharded(L, m)


def rank_sharded_nw(m, reads, lens, refs):
    L = reads.shape[1]
    return mesh_mod.ShardedNW(m, L, refs.shape[1] - L)(reads, lens, refs)


def rank_nw_and_pair(m, reads, lens, refs, L):
    """ShardedNW and the sharded pair reduction in one start of the ranks:
    (NW outputs, pair matrix, this process's kernel launches)."""
    from ..models.parallel_host import kernel_launches
    return (rank_sharded_nw(m, reads, lens, refs), rank_pair_reduction(m, L),
            kernel_launches())


def rank_cli(m, argv):
    """The port's CLI on this rank of `m`: (exit code, this process's
    kernel launches)."""
    from .. import cli
    from ..models.parallel_host import kernel_launches
    rc = cli.main(list(argv), mesh=m)
    return rc, kernel_launches()
