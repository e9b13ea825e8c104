"""The port's paired short-read --action HLA slice on the CPU against the
reference: the aligner field for field against the XLA-scan and host
aligners, the whole typing run against ``run_hla_typing(backend="jax")``,
and the port's CLI against the reference CLI."""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hla_la_tpu.cli import main as ref_main
from hla_la_tpu.io.bam import (BamRecord, BamWriter, FLAG_PAIRED, FLAG_READ1,
                               FLAG_READ2)
from hla_la_tpu.io.fastq import write_fastq
from hla_la_tpu.models.aligner import ReadAligner
from hla_la_tpu.models.pipeline import run_hla_typing as ref_run_hla_typing
from hla_la_tpu.sim.graph_sim import simulate_prg_package
from hla_la_tpu.sim.read_sim import ReadSimulator
from hla_la_tpu_torch import sim as port_sim
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.models import aligner as port_aligner
from hla_la_tpu_torch.models.aligner import ReadAligner as TorchReadAligner
from hla_la_tpu_torch.models.pipeline import run_hla_typing
from hla_la_tpu_torch.ops import banded_nw as port_nw
from hla_la_tpu_torch.profile_e2e import device_summary

torch.set_num_threads(1)

Q_COLS = (3, 4)          # Q1, Q2: printed in full repr by the typer


def _fields_equal(a, b):
    assert a.__dict__.keys() == b.__dict__.keys()
    for k, va in a.__dict__.items():
        vb = b.__dict__[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, k


@pytest.fixture(scope="module")
def align_world(tmp_path_factory):
    """tests/test_aligner.py's world."""
    rng = np.random.default_rng(777)
    sim = simulate_prg_package(rng, backbone_length=1500, n_haplotypes=4)
    pkg = sim.write_package(str(tmp_path_factory.mktemp("pkg") / "g"))
    seq, levels = sim.linearized(1)
    rs = ReadSimulator(rng, read_length=75, with_error=True,
                       fragment_mean=260, fragment_sd=25)
    pairs = rs.simulate_pairs_from_string(seq, levels, 2.0)
    return pkg, [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]


def test_aligner_field_identical_to_xla_scan_and_host(align_world):
    pkg, fq = align_world
    got = TorchReadAligner(pkg, device="cpu").align_pairs(
        fq, insert_mean=260, insert_sd=25)
    assert len(got) >= 0.8 * len(fq)
    for ref in (ReadAligner(pkg, use_jax=True), ReadAligner(pkg)):
        want = ref.align_pairs(fq, insert_mean=260, insert_sd=25)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert (x.read_id, x.mapq) == (y.read_id, y.mapq)
            _fields_equal(x.chain1, y.chain1)
            _fields_equal(x.chain2, y.chain2)


def test_aligner_long_band_runs_plain_nw(align_world, monkeypatch):
    """A band wider than K1's 32 runs the plain version on the CPU (K2's
    on the card) and aligns as the host forward does."""
    pkg, fq = align_world
    bands = []
    plain = port_nw.banded_nw_plain

    def recording(reads, read_lens, refs, sc):
        bands.append(refs.shape[1] - reads.shape[1])
        return plain(reads, read_lens, refs, sc)

    monkeypatch.setattr(port_nw, "banded_nw_plain", recording)
    port = TorchReadAligner(pkg, device="cpu", band=48)
    got = port.align_pairs(fq[:40], insert_mean=260, insert_sd=25)
    want = ReadAligner(pkg, band=48).align_pairs(fq[:40], insert_mean=260,
                                                 insert_sd=25)
    assert bands and set(bands) == {48}
    assert port.stats.extras["nw_jobs_on_cpu"] == \
        port.stats.n_chain_extensions
    assert [x.read_id for x in got] == [y.read_id for y in want]
    for x, y in zip(got, want):
        assert x.mapq == y.mapq
        _fields_equal(x.chain1, y.chain1)
        _fields_equal(x.chain2, y.chain2)


def test_cpu_aligner_pins_no_memory_and_returns_the_plain_arrays(
        align_world, monkeypatch):
    """On the CPU device the aligner's host buffers are plain numpy arrays
    (nothing is page-locked) and _run_nw hands back what the plain forward
    computes, as C-contiguous numpy arrays of the native backtrace's
    types."""
    pkg, fq = align_world
    empty = torch.empty

    def no_pinning(*args, **kwargs):
        assert not kwargs.get("pin_memory"), "page-locked memory on the CPU"
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_pinning)
    port = TorchReadAligner(pkg, device="cpu")
    seen = []
    run_nw = port._run_nw

    def keeping(reads_arr, lens_arr, refs_arr):
        out = run_nw(reads_arr, lens_arr, refs_arr)
        want = port_nw.banded_nw_plain(
            torch.from_numpy(reads_arr.copy()),
            torch.from_numpy(lens_arr.copy()),
            torch.from_numpy(refs_arr.copy()), port.scoring)
        for a, t in zip(out, want):
            assert isinstance(a, np.ndarray) and a.flags.c_contiguous
            np.testing.assert_array_equal(a, t.numpy())
        seen.append([a.dtype for a in out])
        return out

    monkeypatch.setattr(port, "_run_nw", keeping)
    got = port.align_pairs(fq[:30], insert_mean=260, insert_sd=25)
    assert got and seen
    assert all(d == [np.float32, np.int32, np.int32, np.uint8] for d in seen)
    assert port._nw_scratch
    for name, buf in port._nw_scratch.items():
        assert isinstance(buf, np.ndarray), name
        assert not torch.from_numpy(buf[:1]).is_pinned() \
            if buf.dtype == np.uint8 else True, name
    # the staged arrays are views of those buffers, reused by the next call
    v1 = port._host_buffer("st_reads", (4, 10), np.uint8)
    v2 = port._host_buffer("st_reads", (2, 8), np.uint8)
    assert np.shares_memory(v1, v2)


def _count_nw_calls(aligner, monkeypatch):
    """Jobs of each NW call the aligner makes from now on."""
    calls = []
    run_nw = aligner._run_nw

    def counting(reads_arr, lens_arr, refs_arr):
        calls.append(len(reads_arr))
        return run_nw(reads_arr, lens_arr, refs_arr)

    monkeypatch.setattr(aligner, "_run_nw", counting)
    return calls


def _budget_of_jobs(monkeypatch, n_jobs, L, W=32):
    monkeypatch.setattr(port_aligner, "NW_POINTER_BUDGET",
                        n_jobs * (L + 1) * W)


@pytest.mark.parametrize("path", ["soa", "arrays"])
def test_slicing_by_pointer_bytes_keeps_paired_alignments(align_world,
                                                          monkeypatch, path):
    """Both of the reference's paired slicing entry points (the flat
    _align_jobs_soa and, when it is not available, _align_jobs_arrays) give
    the same pairs under a budget of five jobs per NW call."""
    pkg, fq = align_world
    fq = fq[:20]
    want = TorchReadAligner(pkg, device="cpu").align_pairs(
        fq, insert_mean=260, insert_sd=25)
    _budget_of_jobs(monkeypatch, 5, max(len(r.seq) for p in fq for r in p))
    sliced = TorchReadAligner(pkg, device="cpu")
    if path == "arrays":
        monkeypatch.setattr(sliced, "_align_jobs_soa", lambda *a: None)
    calls = _count_nw_calls(sliced, monkeypatch)
    got = sliced.align_pairs(fq, insert_mean=260, insert_sd=25)
    assert len(calls) > 1 and max(calls) <= 5
    assert sum(calls) == sliced.stats.n_chain_extensions
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert (x.read_id, x.mapq) == (y.read_id, y.mapq)
        _fields_equal(x.chain1, y.chain1)
        _fields_equal(x.chain2, y.chain2)


def test_slicing_by_pointer_bytes_keeps_insert_size(align_world,
                                                    monkeypatch):
    """The insert-size estimate aligns through _jobs_to_alignments, the
    third slicing entry point."""
    pkg, fq = align_world
    want = TorchReadAligner(pkg, device="cpu").estimate_insert_size(fq)
    _budget_of_jobs(monkeypatch, 3, max(len(r.seq) for p in fq for r in p))
    sliced = TorchReadAligner(pkg, device="cpu")
    calls = _count_nw_calls(sliced, monkeypatch)
    assert sliced.estimate_insert_size(fq) == want
    assert len(calls) > 1 and max(calls) <= 3


@pytest.fixture(scope="module")
def typing_world(tmp_path_factory):
    """Two loci (A, B), 30 alleles each, diploid reads from haplotypes
    1 and 2."""
    rng = np.random.default_rng(4243)
    sim = simulate_prg_package(rng, backbone_length=2000, n_haplotypes=5,
                               snp_rate=0.012, n_gene_alleles=30)
    root = tmp_path_factory.mktemp("typing")
    pkg = sim.write_package(str(root / "pkg"))
    rs = ReadSimulator(rng, read_length=100, fragment_mean=320,
                       fragment_sd=30, with_error=True)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 12.0,
                                               name_prefix=f"hap{h}")
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    return root, pkg, fq


def _bestguess(out_dir):
    with open(os.path.join(out_dir, "hla", "R1_bestguess.txt")) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def _assert_bestguess_match(got_dir, want_dir, q_tol):
    got, want = _bestguess(got_dir), _bestguess(want_dir)
    assert len(got) == len(want) > 1
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if i in Q_COLS:
                assert abs(float(a) - float(b)) <= q_tol, (i, a, b)
            else:
                assert a == b, (i, a, b)


def test_typing_run_matches_jax_backend(typing_world):
    root, pkg, fq = typing_world
    got = run_hla_typing(pkg, pairs=fq, output_dir=str(root / "port"),
                         device="cpu")
    want = ref_run_hla_typing(pkg, pairs=fq, output_dir=str(root / "jax"),
                              backend="jax")
    assert len(got.results) == len(want.results) == 2
    assert got.n_pairs_aligned == want.n_pairs_aligned
    for g, w in zip(got.results, want.results):
        assert (g.locus, g.allele1_id, g.allele2_id) == \
            (w.locus, w.allele1_id, w.allele2_id)
        assert abs(g.q1_allele1 - w.q1_allele1) <= 1e-6
        assert abs(g.q1_allele2 - w.q1_allele2) <= 1e-6
        assert g.n_clusters == w.n_clusters >= 20
    _assert_bestguess_match(str(root / "port"), str(root / "jax"), 1e-6)


def test_cli_hla_on_fastq_matches_reference_cli(typing_world):
    root, pkg, fq = typing_world
    fq1, fq2 = str(root / "R_1.fq"), str(root / "R_2.fq")
    write_fastq(fq1, [a for a, _ in fq])
    write_fastq(fq2, [b for _, b in fq])
    common = ["--action", "HLA", "--FASTQ1", fq1, "--FASTQ2", fq2,
              "--graph", pkg.dir, "--sampleID", "S1"]
    assert port_main(common + ["--outputDirectory", str(root / "cli_port"),
                               "--device", "cpu"]) == 0
    assert ref_main(common + ["--outputDirectory", str(root / "cli_ref"),
                              "--backend", "jax"]) == 0
    _assert_bestguess_match(str(root / "cli_port"), str(root / "cli_ref"),
                            1e-6)


def _bam_cli_runs(root, pkg, fq, tag, singleton_every=0):
    """Write `fq` as a BAM on a knownReferences-matched contig (dropping
    mate 2 of every `singleton_every`-th pair), type it with the port's and
    the reference's CLI, and return both output directories."""
    contig_len = 100000
    with open(os.path.join(pkg.dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    bam = str(root / f"{tag}.bam")
    w = BamWriter(bam, [("chr6", contig_len)])
    for i, (r1, r2) in enumerate(fq):
        mates = [(FLAG_READ1, r1), (FLAG_READ2, r2)]
        if singleton_every and i % singleton_every == 0:
            mates = mates[:1]
        for mate, r in mates:
            w.write(BamRecord(name=r.name, flag=FLAG_PAIRED | mate, ref_id=0,
                              pos=0, mapq=60, cigar=[(len(r.seq), 0)],
                              seq=r.seq, qual=r.qual))
    w.close()
    common = ["--action", "HLA", "--BAM", bam, "--graph", pkg.dir,
              "--sampleID", "S1"]
    port, ref = str(root / f"{tag}_port"), str(root / f"{tag}_ref")
    assert port_main(common + ["--outputDirectory", port,
                               "--device", "cpu"]) == 0
    assert ref_main(common + ["--outputDirectory", ref,
                              "--backend", "jax"]) == 0
    return port, ref


def test_cli_hla_on_bam_matches_reference_cli(typing_world):
    """BAM input: the knownReferences match and extraction are the
    reference CLI's; the port must type the extracted pairs identically."""
    root, pkg, fq = typing_world
    port, ref = _bam_cli_runs(root, pkg, fq, "bam")
    _assert_bestguess_match(port, ref, 1e-6)


def test_cli_hla_on_bam_types_singletons_as_unpaired(typing_world):
    """Reads whose mate is not in the BAM go to the typing run as unpaired
    reads, as in the reference CLI: the coverage track and the summary
    statistics (which count every aligned unpaired read) and the calls are
    the reference's."""
    root, pkg, fq = typing_world
    port, ref = _bam_cli_runs(root, pkg, fq, "bam_singletons",
                              singleton_every=4)
    _assert_bestguess_match(port, ref, 1e-6)
    for name in ("reads_per_level.txt", os.path.join("hla",
                                                     "summaryStatistics.txt")):
        texts = []
        for d in (port, ref):
            with open(os.path.join(d, name)) as fh:
                texts.append(fh.read())
        assert texts[0] == texts[1], name
    n_unpaired = re.search(r"Total number \(unpaired\) alignments:\s+(\d+)",
                           texts[0])
    assert int(n_unpaired.group(1)) >= len(fq) // 8


def test_typing_world_is_cached_and_typed_to_its_planted_alleles(tmp_path):
    """The port's simulated world (stress_imgt.py's recipe at a small size)
    is reused from its cache, and the port's CLI calls its planted
    alleles."""
    kw = dict(n_alleles=24, coverage=15.0, backbone=2000)
    world = port_sim.typing_world(str(tmp_path / "worlds"), **kw)
    stamp = os.path.getmtime(world.fastq1)
    assert port_sim.typing_world(str(tmp_path / "worlds"), **kw) == world
    assert os.path.getmtime(world.fastq1) == stamp
    assert world.truth == {"A": ["A*02:01", "A*03:01"],
                           "B": ["B*02:01", "B*03:01"]}
    out = str(tmp_path / "out")
    assert port_main(["--action", "HLA", "--FASTQ1", world.fastq1,
                      "--FASTQ2", world.fastq2, "--graph", world.graph,
                      "--outputDirectory", out, "--device", "cpu"]) == 0
    rows = _bestguess(out)[1:]
    for locus, planted in world.truth.items():
        called = [set(r[2].split(";")) for r in rows if r[0] == locus]
        assert len(called) == 2
        assert all(any(a in c for c in called) for a in planted), locus


def test_profile_summary_counts_device_events_only():
    """A host op's device time is that of the kernels and copies it
    launched, so only device events enter the busy time."""
    from torch.autograd import DeviceType

    def ev(key, us, n, dev):
        return SimpleNamespace(key=key, self_device_time_total=us, count=n,
                               device_type=dev)

    prof = SimpleNamespace(key_averages=lambda: [
        ev("aten::copy_", 600.0, 4, DeviceType.CPU),
        ev("Memcpy DtoH", 400.0, 2, DeviceType.CUDA),
        ev("pair_ll_kernel", 1500.0, 1, DeviceType.CUDA),
        ev("cudaLaunchKernel", 3.0, 9, DeviceType.CPU)])
    assert device_summary(prof) == [("pair_ll_kernel", 1.5, 1),
                                    ("Memcpy DtoH", 0.4, 2)]


def test_cli_refuses_unported_action(capsys):
    """Every action of the reference is ported: an action neither CLI
    knows exits 2 with the reference's message."""
    for main in (port_main, ref_main):
        assert main(["--action", "findKIRinBAMs"]) == 2
        assert capsys.readouterr().err == "unknown action findKIRinBAMs\n"
