"""The port's long-read (``--longReads``) ``--action HLA`` path on the CPU
against the reference: the aligner field for field against the host
aligner at the long-read band (256), slicing NW calls by pointer bytes,
and the port's CLI on unpaired FASTQ and on a BAM against the reference
CLI."""

import os

import numpy as np
import pytest
import torch

from hla_la_tpu.cli import main as ref_main
from hla_la_tpu.io.bam import (BamRecord, BamWriter, FLAG_PAIRED, FLAG_READ1,
                               FLAG_READ2)
from hla_la_tpu.io.fastq import write_fastq
from hla_la_tpu.models.aligner import ReadAligner
from hla_la_tpu.sim.graph_sim import simulate_prg_package
from hla_la_tpu.sim.read_sim import ReadSimulator
from hla_la_tpu.utils.config import RunConfig
from hla_la_tpu_torch import sim as port_sim
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.models import aligner as port_aligner
from hla_la_tpu_torch.models.aligner import ReadAligner as TorchReadAligner
from hla_la_tpu_torch.models.aligner import jobs_per_call

torch.set_num_threads(1)

Q_COLS = (3, 4)          # Q1, Q2: printed in full repr by the typer
CFG = RunConfig(long_reads="ont2d")


@pytest.fixture(scope="module")
def long_world(tmp_path_factory):
    """tests/test_long_reads.py's world, with its end-to-end reads
    (1,400 bp, 0.4% insertions and deletions) from haplotypes 1 and 2."""
    rng = np.random.default_rng(31337)
    sim = simulate_prg_package(rng, backbone_length=3000, n_haplotypes=4,
                               snp_rate=0.012)
    root = tmp_path_factory.mktemp("lr")
    pkg = sim.write_package(str(root / "pkg"))
    rs = ReadSimulator(rng, insertion_rate=0.004, deletion_rate=0.004)
    reads = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        reads += rs.simulate_unpaired_from_string(seq, levels, 6.0,
                                                  read_length=1400,
                                                  name_prefix=f"lr{h}")
    return root, pkg, [r.to_fastq() for r in reads]


def _fields_equal(a, b):
    assert a.__dict__.keys() == b.__dict__.keys()
    for k, va in a.__dict__.items():
        vb = b.__dict__[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, k


def _assert_same_alignments(got, want):
    assert len(got) == len(want)
    assert sum(a is not None for a in got) >= 0.9 * len(got)
    for x, y in zip(got, want):
        assert (x is None) == (y is None)
        if x is not None:
            _fields_equal(x, y)


def test_jobs_per_call():
    assert jobs_per_call(101, 32, 65536) == 65536
    assert jobs_per_call(150, 32, 65536) == 65536
    assert jobs_per_call(10000, 256, 65536) == 838
    assert jobs_per_call(50000, 256, 65536) == 167
    assert jobs_per_call(50000, 1024, 65536) == 41
    assert jobs_per_call(10 ** 9, 256, 65536) == 1


def test_aligner_field_identical_to_host(long_world):
    """Long-read mode picks the band of 256 in both aligners; the port runs
    the plain version of K2 and the reference its host forward."""
    _, pkg, fq = long_world
    port = TorchReadAligner(pkg, CFG, device="cpu")
    ref = ReadAligner(pkg, CFG)
    assert port.band == ref.band == 256
    got = port.align_unpaired(fq)
    _assert_same_alignments(got, ref.align_unpaired(fq))
    n_jobs = port.stats.n_chain_extensions
    assert port.stats.extras == {"nw_jobs_on_cpu": n_jobs} and n_jobs > 0


def test_slicing_by_pointer_bytes_keeps_alignments(long_world, monkeypatch):
    """Jobs are independent: a budget of three jobs per NW call gives the
    alignments of one call."""
    _, pkg, fq = long_world
    fq = fq[:8]
    whole = TorchReadAligner(pkg, CFG, device="cpu")
    want = whole.align_unpaired(fq)
    L = max(len(r.seq) for r in fq)
    monkeypatch.setattr(port_aligner, "NW_POINTER_BUDGET", 3 * (L + 1) * 256)
    sliced = TorchReadAligner(pkg, CFG, device="cpu")
    calls = []
    run_nw = sliced._run_nw

    def counting(reads_arr, lens_arr, refs_arr):
        calls.append(len(reads_arr))
        return run_nw(reads_arr, lens_arr, refs_arr)

    monkeypatch.setattr(sliced, "_run_nw", counting)
    got = sliced.align_unpaired(fq)
    assert len(calls) > 1 and max(calls) <= 3
    assert sum(calls) == whole.stats.n_chain_extensions
    _assert_same_alignments(got, want)


def test_jobs_per_call_follow_the_reads_of_each_call(long_world,
                                                     monkeypatch):
    """The jobs of one NW call are reckoned where the jobs are sliced, from
    the longest read of that call: the same aligner, under one budget,
    takes more jobs per NW call for shorter reads.  It keeps no read length
    between calls and has no jobs-per-call rule that knows none."""
    _, pkg, fq = long_world
    short = [type(r)(r.name, r.seq[:600], r.qual[:600]) for r in fq[:6]]
    L = max(len(r.seq) for r in fq[:6])
    monkeypatch.setattr(port_aligner, "NW_POINTER_BUDGET", 2 * (L + 1) * 256)
    port = TorchReadAligner(pkg, CFG, device="cpu")
    assert not hasattr(port, "_max_b") and not hasattr(port, "_nw_len")
    calls = []
    run_nw = port._run_nw

    def counting(reads_arr, lens_arr, refs_arr):
        calls.append(reads_arr.shape)
        return run_nw(reads_arr, lens_arr, refs_arr)

    monkeypatch.setattr(port, "_run_nw", counting)
    port.align_unpaired(fq[:6])
    long_calls, calls[:] = list(calls), []
    port.align_unpaired(short)
    assert max(b for b, _ in long_calls) == 2
    assert max(b for b, _ in calls) == jobs_per_call(600, 256, 65536) > 2
    assert {n for _, n in calls} == {600}


def _table(out_dir, name):
    with open(os.path.join(out_dir, name)) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def _assert_runs_match(got_dir, want_dir):
    assert _table(got_dir, "reads_per_level.txt") == \
        _table(want_dir, "reads_per_level.txt")
    got = _table(got_dir, os.path.join("hla", "R1_bestguess.txt"))
    want = _table(want_dir, os.path.join("hla", "R1_bestguess.txt"))
    assert len(got) == len(want) > 1
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if i in Q_COLS:
                assert abs(float(a) - float(b)) <= 1e-6, (i, a, b)
            else:
                assert a == b, (i, a, b)


def _cli_runs(root, pkg, inputs, tag):
    common = ["--action", "HLA", *inputs, "--graph", pkg.dir,
              "--sampleID", "S1", "--longReads", "ont2d"]
    port, ref = str(root / f"{tag}_port"), str(root / f"{tag}_ref")
    assert port_main(common + ["--outputDirectory", port,
                               "--device", "cpu"]) == 0
    assert ref_main(common + ["--outputDirectory", ref]) == 0
    return port, ref


def test_cli_long_reads_on_fastqu_matches_reference_cli(long_world):
    root, pkg, fq = long_world
    path = str(root / "R_U.fq")
    write_fastq(path, fq)
    port, ref = _cli_runs(root, pkg, ["--FASTQU", path], "fastqu")
    _assert_runs_match(port, ref)
    rows = _table(port, os.path.join("hla", "R1_bestguess.txt"))[1:]
    assert {r[0] for r in rows} == {"A", "B"}


def test_cli_long_reads_on_bam_matches_reference_cli(long_world):
    """A BAM in long-read mode: pairs are flattened into unpaired reads,
    as in the reference CLI."""
    root, pkg, fq = long_world
    contig_len = 100000
    with open(os.path.join(pkg.dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    bam = str(root / "long.bam")
    w = BamWriter(bam, [("chr6", contig_len)])
    for i, r in enumerate(fq):
        # every other pair of reads is written as the two mates of a pair
        if i % 4 < 2:
            flag = FLAG_PAIRED | (FLAG_READ1 if i % 2 == 0 else FLAG_READ2)
            name = f"pair{i // 2}"
        else:
            flag, name = 0, r.name
        w.write(BamRecord(name=name, flag=flag, ref_id=0, pos=0, mapq=60,
                          cigar=[(len(r.seq), 0)], seq=r.seq, qual=r.qual))
    w.close()
    port, ref = _cli_runs(root, pkg, ["--BAM", bam], "bam")
    _assert_runs_match(port, ref)


def test_long_read_world_is_cached_and_typed_to_its_planted_alleles(
        tmp_path):
    """The port's long-read world at a small size is reused from its cache,
    and the port's CLI on the CPU calls its planted alleles (each in one
    of the two called clusters: genes of 135 columns leave some alleles
    with identical exons)."""
    kw = dict(n_alleles=20, coverage=8.0, backbone=3000, read_length=1500)
    world = port_sim.long_read_world(str(tmp_path / "worlds"), **kw)
    stamp = os.path.getmtime(world.fastq)
    assert port_sim.long_read_world(str(tmp_path / "worlds"), **kw) == world
    assert os.path.getmtime(world.fastq) == stamp
    assert world.truth == {"A": ["A*02:01", "A*03:01"],
                           "B": ["B*02:01", "B*03:01"]}
    out = str(tmp_path / "out")
    assert port_main(["--action", "HLA", *world.cli_args(), "--graph",
                      world.graph, "--outputDirectory", out,
                      "--device", "cpu"]) == 0
    rows = _table(out, os.path.join("hla", "R1_bestguess.txt"))[1:]
    for locus, planted in world.truth.items():
        called = [r[2].split(";") for r in rows if r[0] == locus]
        assert len(called) == 2
        assert sorted(any(a in c for a in planted) for c in called) == \
            [True, True], locus
        assert all(any(a in c for c in called) for a in planted), locus
