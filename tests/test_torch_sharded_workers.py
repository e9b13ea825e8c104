"""``--sharded N --maxThreads M`` as the reference runs it, on the CPU: one
pool of M host-only workers, in rank 0, for the alignment, the align shard
and the typing fan-out; the other ranks take rank 0's alignments (and its
typing results) over a hand-over whose wait no group timeout limits.

One start of two gloo ranks (``launch.run_ranks``) runs every scenario, each
held to the port's one-process run with the same workers and configuration
(those runs are held to the reference by tests/test_torch_parallel.py):

  (b) ``run_hla_typing(..., sharded=mesh)`` with the typing workers' gate
      lowered: rank 0 types through its pool, rank 1 runs no typer; every
      file byte-equal;
  (c) ``align_shard`` on the ranks: the shard's arrays byte-equal to the
      shard written in one process; then ``merge_shards_and_type`` on the
      ranks with the gate lowered: the files of (b);
  (d) the ranks' process group has a timeout of TIMEOUT_S seconds, and
      rank 0's alignment is held back longer than that: rank 1 waits for
      it the whole time and the run still succeeds;
  (e) long reads (``--longReads ont2d``) with the pool's read threshold
      lowered on the ranks (the world's 32 reads would not start it; more
      than 512 long reads take minutes on the CPU): rank 0's workers align
      them, their K2 calls served by rank 0's server, rank 0 hands the
      unpaired chains over, and the gate fails, so both ranks type them
      in the sharded typer: the one-process run's files, Q and the pair
      dumps within the pair reduction's tolerance;
  (f) two hand-overs back to back, the first an 8 MB array: each rank
      holds rank 0's values, in order.

The case where the gate fails on short reads is
tests/test_torch_parallel.py::
test_cli_sharded_switch_matches_one_process_and_the_reference.
"""

import contextlib
import os
import re
import tempfile
import time
import zipfile

import numpy as np
import pytest
import torch

from test_torch_host_layers import _assert_runs_match

from hla_la_tpu_torch.graph.package import GraphPackage
from hla_la_tpu_torch.io.fastq import read_fastq, write_fastq
from hla_la_tpu_torch.models.parallel_host import spawn_safe
from hla_la_tpu_torch.models.pipeline import (align_shard,
                                              merge_shards_and_type,
                                              pair_up_fastq, run_hla_typing)
from hla_la_tpu_torch.parallel import launch
from hla_la_tpu_torch.parallel.mesh import from_rank0
from hla_la_tpu_torch.sim import (ReadSimulator, long_read_world,
                                  simulate_prg_package)
from hla_la_tpu_torch.utils.config import RunConfig, TyperConfig

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(not spawn_safe(),
                                reason="no file-backed __main__ to spawn from")

# the ranks' process-group timeout, and how long rank 0's alignment is held
# back beyond it
TIMEOUT_S = 10.0
HOLD_S = TIMEOUT_S + 1.0


def _cfg(lowered: bool) -> RunConfig:
    """Two workers; `lowered`: the typing workers' gate lowered so that
    this world's two loci fan out."""
    typer = (TyperConfig(min_reads_for_typing_workers=1,
                         min_loci_for_typing_workers=2)
             if lowered else TyperConfig())
    return RunConfig(max_threads=2, typer=typer)


@contextlib.contextmanager
def _stderr_into(sink: list):
    """What this process and its children write to file descriptor 2 (the
    ranks and workers log there directly) goes into `sink`."""
    saved = os.dup(2)
    with tempfile.TemporaryFile() as fh:
        os.dup2(fh.fileno(), 2)
        try:
            yield
        finally:
            os.dup2(saved, 2)
            os.close(saved)
            fh.seek(0)
            sink.append(fh.read().decode(errors="replace"))


def _held_back(fn):
    """`fn` after HOLD_S seconds: an alignment that outlasts the group's
    timeout on any machine."""
    def held(*args, **kwargs):
        time.sleep(HOLD_S)
        return fn(*args, **kwargs)
    return held


def _long_cfg() -> RunConfig:
    return RunConfig(max_threads=2, long_reads="ont2d")


def _results(res):
    return [(r.locus, r.allele1_id, r.allele2_id, r.q1_allele1,
             r.q1_allele2) for r in res.results]


def _rank_scenarios(m, graph, fq1, fq2, long_graph, long_fq, root):
    """(b) to (f) on this rank: what each rank saw."""
    from hla_la_tpu_torch.models import parallel_host, typer
    pkg = GraphPackage(graph)
    pairs = pair_up_fastq(fq1, fq2)
    typed = []
    type_all = typer.HLATyper.type_all

    def counted(self, *args, **kwargs):
        out = type_all(self, *args, **kwargs)
        # the rank that typed, and the worker processes that typed for it
        typed.append((self.sharded.rank, len(self.worker_runs)))
        return out

    typer.HLATyper.type_all = counted
    align = parallel_host.ParallelAligner.align_pairs
    parallel_host.ParallelAligner.align_pairs = _held_back(align)
    t0 = time.perf_counter()
    res = run_hla_typing(pkg, pairs=pairs, output_dir=os.path.join(root, "b"),
                         cfg=_cfg(True), device="cpu", sharded=m)
    seen = {"b_s": time.perf_counter() - t0,
            # this rank's alignment phase: on rank 1, its wait for rank 0's
            "b_align_s": 2 * len(pairs) / res.reads_per_sec,
            "b_typed": list(typed), "b_results": _results(res)}
    parallel_host.ParallelAligner.align_pairs = align
    del typed[:]
    seen["c_path"] = align_shard(pkg, pairs, [], os.path.join(root, "sh"), 0,
                                 1, _cfg(False), device="cpu", sharded=m)
    res = merge_shards_and_type(pkg, os.path.join(root, "sh"),
                                os.path.join(root, "c"), _cfg(True),
                                device="cpu", sharded=m)
    seen["c_typed"] = list(typed)
    seen["c_results"] = _results(res)
    del typed[:]
    # the pool's read threshold lowered to this world's 32 reads
    seen["e_results"], _, _ = launch.rank_hla_typing(
        m, long_graph, (long_fq,), os.path.join(root, "e"), _long_cfg(), 0)
    seen["e_typed"] = list(typed)
    # two hand-overs back to back, the first of 8 MB made after a second
    big = np.random.default_rng(5).integers(0, 1 << 15, 4 << 20,
                                            dtype=np.int16)
    if m.rank == 0:
        time.sleep(1.0)
    first = from_rank0(m, big if m.rank == 0 else None, "a large array")
    second = from_rank0(m, "second" if m.rank == 0 else None, "a string")
    seen["f_same"] = (first.dtype == big.dtype
                      and np.array_equal(first, big), second)
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world (two loci, more than 512 pairs so that the pool starts),
    its one-process runs with two workers, and the two ranks' run with
    their logs."""
    root = tmp_path_factory.mktemp("sharded_workers")
    rng = np.random.default_rng(31)
    sim = simulate_prg_package(rng, backbone_length=3000, n_haplotypes=5)
    pkg = sim.write_package(str(root / "g"))
    rs = ReadSimulator(rng, read_length=90, fragment_mean=300, fragment_sd=25)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 20.0,
                                               name_prefix=f"h{h}")
    assert len(pairs) > 512
    fq1, fq2 = str(root / "R_1.fq"), str(root / "R_2.fq")
    write_fastq(fq1, [p.r1.to_fastq() for p in pairs])
    write_fastq(fq2, [p.r2.to_fastq() for p in pairs])
    reads = pair_up_fastq(fq1, fq2)
    one = root / "one"
    res = run_hla_typing(pkg, pairs=reads, output_dir=str(one / "b"),
                         cfg=_cfg(True), device="cpu")
    shard = align_shard(pkg, reads, [], str(one / "sh"), 0, 1, _cfg(False),
                        device="cpu")
    world = long_read_world(str(root / "lw"), backbone=3000, n_alleles=12,
                            coverage=6.0, read_length=1200)
    long_res = run_hla_typing(GraphPackage(world.graph),
                              unpaired=list(read_fastq(world.fastq)),
                              output_dir=str(one / "e"), cfg=_long_cfg(),
                              device="cpu")
    log = []
    with _stderr_into(log):
        ranks = launch.run_ranks(_rank_scenarios, 2, "cpu",
                                 (pkg.dir, fq1, fq2, world.graph, world.fastq,
                                  str(root / "ranks")),
                                 timeout_s=TIMEOUT_S)
    return {"one": one, "ranks": root / "ranks", "shard": shard,
            "results": _results(res), "long_results": _results(long_res),
            "seen": ranks, "log": log[0]}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _assert_same_files(got, want):
    names = _files(want)
    assert _files(got) == names and len(names) >= 10
    for name in names:
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name


def test_rank0_types_in_its_pool_and_the_files_equal_one_process(runs):
    """(b): every file byte-equal to the one-process run with two workers;
    rank 0 alone ran a typer, and rank 1 returns rank 0's results."""
    _assert_same_files(runs["ranks"] / "b", runs["one"] / "b")
    r0, r1 = runs["seen"]
    assert r0["b_typed"] == [(0, 2)] and r1["b_typed"] == []
    assert r0["b_results"] == r1["b_results"] == runs["results"]
    assert len(runs["results"]) == 2


def test_one_pool_in_rank0_and_the_hand_over(runs):
    """The ranks' log: in (b) and (e), one pool of two host-only workers,
    started by rank 0, whose NW jobs rank 0's device server ran and
    counted into rank 0's statistics alone; (c)'s shard aligned in such a
    pool too; the typing fan-out of (b) and (c) went through rank 0's
    workers; rank 1 took the alignments, the typing results and the
    shard's path from rank 0."""
    log = runs["log"]
    assert log.count("aligning with 2 worker processes on cpu") == 2  # b, e
    assert log.count("rank 1: rank 0 aligns in its worker pool\n") == 2
    assert log.count("rank 1: rank 0 types the loci in worker "
                     "processes") == 2                                # b, c
    assert log.count("rank 0 handed over the alignments: ") == 2
    assert log.count("rank 1 took the alignments from rank 0: ") == 2
    assert log.count("rank 1 took the typing results from rank 0: ") == 2
    assert log.count("rank 1 took the shard's path from rank 0: ") == 1
    ready = [ln for ln in log.splitlines()
             if "alignment worker" in ln and "ready, host-only" in ln]
    assert len(ready) == 6 and all(                                # b, c, e
        "torch imported: False, CUDA initialised: False" in ln
        for ln in ready)
    assert log.count("served_nw_jobs: ") == 3                      # b, c, e


def test_the_wait_for_rank0_outlives_the_group_timeout(runs):
    """(d): rank 0's alignment was held back HOLD_S s, longer than the
    group's timeout; rank 1 waited for it that long in the hand-over's
    own group, and nothing timed out."""
    r0, r1 = runs["seen"]
    assert r0["b_align_s"] > HOLD_S > TIMEOUT_S
    assert r1["b_align_s"] > TIMEOUT_S


def test_hand_overs_arrive_whole_and_in_order(runs):
    """(f): rank 1 holds rank 0's 8 MB array bit for bit and then its
    string, each broadcast after rank 1 began to wait."""
    r0, r1 = runs["seen"]
    assert r0["f_same"] == r1["f_same"] == (True, "second")
    (n_bytes, waited), = re.findall(
        r"rank 1 took a large array from rank 0: (\d+) bytes after waiting "
        r"([0-9.]+) s", runs["log"])
    assert 8 << 20 < int(n_bytes) < (8 << 20) + 1024
    assert float(waited) > 0.5


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_align_shard_on_the_ranks_equals_one_process_and_merges(runs):
    """(c): rank 0 aligned host 0's slice in its pool and wrote the shard;
    every array of it byte-equal to the one-process shard's (the archive's
    member times differ); rank 1 returned the same path.  The merge on the
    ranks with the gate lowered types in rank 0's fresh workers: the files
    and calls of (b)."""
    r0, r1 = runs["seen"]
    assert r0["c_path"] == r1["c_path"] == str(
        runs["ranks"] / "sh" / os.path.basename(runs["shard"]))
    assert _members(r0["c_path"]) == _members(runs["shard"])
    assert r0["c_typed"] == [(0, 2)] and r1["c_typed"] == []
    assert r0["c_results"] == r1["c_results"] == runs["results"]
    _assert_same_files(runs["ranks"] / "c", runs["one"] / "b")


def test_long_reads_handed_over_type_to_the_one_process_files(runs):
    """(e): rank 0's two workers aligned the long reads, their NW jobs
    served by rank 0's server (K2's plain version on the CPU); rank 1 took
    the unpaired chains (packed without their quality caches) and both
    ranks typed them in the sharded typer: the one-process run's calls,
    Q within 1e-6, the pair dumps within the pair reduction's tolerance,
    every other file byte-equal."""
    r0, r1 = runs["seen"]
    assert r0["e_typed"] == [(0, 0)] and r1["e_typed"] == [(1, 0)]
    assert r0["e_results"] == r1["e_results"]
    assert [r[:3] for r in r0["e_results"]] == \
        [r[:3] for r in runs["long_results"]]
    # Q1 of this world's locus A is not 1 and its last digits follow the
    # float32 pair sums: the bestguess table is held field by field
    _assert_runs_match(str(runs["ranks"] / "e"), str(runs["one"] / "e"),
                       bestguess_bytes=False)
