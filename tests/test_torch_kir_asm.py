"""The port's linear-ALT (``--action KIR``) and assembly (``--action ASM``)
typing on the CPU against the JAX package, on the same inputs made from a
numpy seed at small sizes.

The reference's typers call the host NW forward once per read or per exon
window; the port gathers the jobs of a whole call into shared NW calls on
its device (here the CPU: the plain PyTorch version).  Held here: the
per-read numbers are the reference's (likelihood rows bit for bit, anchors
and positions equal), the pair reduction agrees with the reference's
``backend="jax"`` (float32 difference term, as the port's) and
``backend="numpy"`` (float64) within ``rtol=1e-6, atol=1e-2`` with the same
call and the posterior within 1e-3, the assembly typer's calls and output
files are identical, and every CLI action writes what the reference CLI
writes.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from hla_la_tpu.cli import main as ref_main
from hla_la_tpu.graph.package import GraphPackage as RefGraphPackage
from hla_la_tpu.io.bam import (BamRecord, BamWriter, FLAG_PAIRED, FLAG_READ1,
                               FLAG_READ2, FLAG_REVERSE)
from hla_la_tpu.io.fasta import write_fasta
from hla_la_tpu.io.fastq import write_fastq
from hla_la_tpu.models.asm import EDIT_SCORING as REF_EDIT_SCORING
from hla_la_tpu.models.asm import AssemblyTyper as RefAssemblyTyper
from hla_la_tpu.models.kir_package import build_kir_package
from hla_la_tpu.models.linear_alts import LinearALTsTyper as RefTyper
from hla_la_tpu.ops.banded_nw import banded_nw_forward as ref_nw_forward
from hla_la_tpu.ops.pallas_nw import make_pallas_banded_nw_long
from hla_la_tpu.sim.graph_sim import simulate_prg_package
from hla_la_tpu.sim.read_sim import ReadSimulator, revcomp
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.graph.package import GraphPackage
from hla_la_tpu_torch.models import aligner as port_aligner
from hla_la_tpu_torch.models.aligner import NWRunner
from hla_la_tpu_torch.models.asm import AssemblyTyper
from hla_la_tpu_torch.models.linear_alts import LinearALTsTyper
from hla_la_tpu_torch.ops.banded_nw import banded_nw_plain

torch.set_num_threads(1)
PAIR_RTOL, PAIR_ATOL = 1e-6, 1e-2
POSTERIOR_TOL = 1e-3
EDIT = {"match": 0.0, "mismatch": -1.0, "gap_open": -1.0, "gap_extend": -1.0}


# ------------------------------------------------------------ linear ALTs
def _panel(rng, n_haps, length, n_snps, deletion=None):
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, length))
    haps = {}
    for hi in range(n_haps):
        s = list(base)
        for _ in range(n_snps):
            s[int(rng.integers(0, length))] = "ACGT"[int(rng.integers(0, 4))]
        if deletion and hi % 2:
            s[deletion[0]:deletion[1]] = "-" * (deletion[1] - deletion[0])
        haps[f"ALT{hi}"] = "".join(s)
    return haps


def _reads(rng, seq, coverage, prefix, read_length=100):
    rs = ReadSimulator(rng, read_length=read_length, fragment_mean=300,
                       fragment_sd=30)
    seq = seq.replace("-", "").replace("N", "")
    return [(p.r1.to_fastq(), p.r2.to_fastq())
            for p in rs.simulate_pairs_from_string(
                seq, np.arange(len(seq)), coverage, name_prefix=prefix)]


def _mixed_world():
    """Six haplotypes without gaps; reads of 60, 100 and 151 bases from
    two of them (three length groups in the port's batched pass), and one
    read that seeds nowhere."""
    rng = np.random.default_rng(2027)
    haps = _panel(rng, 6, 2500, 50)
    pairs = (_reads(rng, haps["ALT1"], 4.0, "a", 100)
             + _reads(rng, haps["ALT4"], 4.0, "b", 151)
             + _reads(rng, haps["ALT1"], 2.0, "c", 60))
    stray = type(pairs[0][0])("stray", "ACGT" * 20, "I" * 80)
    pairs.append((stray, pairs[0][1]))
    return haps, {}, pairs


def _deletion_world():
    """Four haplotypes in the equal-length block's form: every second one
    lacks a gene-sized stretch, stored as N (n_is_gap=True); reads from a
    haplotype with the deletion and one without."""
    rng = np.random.default_rng(2028)
    haps = _panel(rng, 4, 3000, 60, deletion=(1200, 1700))
    haps = {n: s.replace("-", "N") for n, s in haps.items()}
    pairs = (_reads(rng, haps["ALT1"], 5.0, "d")
             + _reads(rng, haps["ALT2"], 5.0, "e"))
    return haps, {"n_is_gap": True,
                  "genes": {"G1": (300, 900), "G2": (1200, 1700),
                            "G3": (2000, 2800)}}, pairs


@pytest.fixture(scope="module", params=["mixed_lengths", "deletion"])
def alt_rows(request):
    """One world typed per read by the reference (its _read_ll_row loop)
    and in one batched pass by the port."""
    haps, kwargs, pairs = (_mixed_world() if request.param == "mixed_lengths"
                           else _deletion_world())
    reads = [r for p in pairs for r in p]
    ref = RefTyper(haps, **kwargs)
    port = LinearALTsTyper(haps, **kwargs, device="cpu")
    want = [ref._read_ll_row(r, len(r.seq) * np.log(0.25)) for r in reads]
    got = port._read_ll_rows(reads)
    return ref, port, reads, pairs, want, got


def test_haplotype_likelihoods_equal_the_per_read_loop(alt_rows):
    ref, port, reads, _, want, _ = alt_rows
    L_ref, anchors_ref = ref.haplotype_likelihoods(reads)
    L, anchors = port.haplotype_likelihoods(reads)
    assert L.shape == L_ref.shape == (len(ref.names), len(reads))
    np.testing.assert_allclose(L, L_ref, rtol=0, atol=1e-9)
    assert anchors == anchors_ref
    assert sum(a is None for a in anchors) >= (len(ref.names) == 6)
    assert len({len(r.seq) for r in reads}) >= (3 if len(ref.names) == 6
                                                else 1)


def test_likelihood_rows_are_bit_identical(alt_rows):
    _, _, _, _, want, (rows, _, _) = alt_rows
    np.testing.assert_array_equal(rows, np.stack([w[0] for w in want]))


def test_anchor_positions_equal_the_per_read_loop(alt_rows):
    _, _, _, _, want, (_, anchors, pos_rows) = alt_rows
    np.testing.assert_array_equal(pos_rows, np.stack([w[2] for w in want]))
    assert anchors == [w[1] for w in want]
    assert (pos_rows >= 0).any() and (pos_rows < 0).any()


def test_every_nw_job_ran_in_shared_calls(alt_rows, monkeypatch):
    """The jobs of all reads share NW calls: one per length group here, not
    one per read; the stats count the jobs on the device."""
    _, port, reads, _, _, _ = alt_rows
    calls = []
    run = port._nw.run
    monkeypatch.setattr(port._nw, "run", lambda *a, **k: (
        calls.append(len(a[0])), run(*a, **k))[1])
    before = port.stats.extras["nw_jobs_on_cpu"]
    port.haplotype_likelihoods(reads)
    n_groups = len({len(r.seq) for r in reads})
    assert 1 <= len(calls) <= n_groups
    assert sum(calls) == port.stats.extras["nw_jobs_on_cpu"] - before
    assert sum(calls) > len(reads)
    assert port.stats.n_chain_extensions == \
        port.stats.extras["nw_jobs_on_cpu"]


def test_rows_without_the_native_library(alt_rows, monkeypatch):
    """Where the native library is not built, seeding, window gathering
    and the backtrace take their Python forms and give the same rows."""
    from hla_la_tpu_torch import native
    _, port, reads, _, _, (rows, anchors, pos_rows) = alt_rows
    monkeypatch.setattr(native, "available", lambda: False)
    got = port._read_ll_rows(reads[:40])
    np.testing.assert_array_equal(got[0], rows[:40])
    assert got[1] == anchors[:40]
    np.testing.assert_array_equal(got[2], pos_rows[:40])


def test_estimate_insert_equals_reference(alt_rows):
    ref, port, _, pairs, _, _ = alt_rows
    assert port.estimate_insert(pairs) == ref.estimate_insert(pairs)
    assert port.estimate_insert(pairs, max_pairs=7) == \
        ref.estimate_insert(pairs, max_pairs=7)
    assert port.estimate_insert([]) == (300.0, 75.0)


def _same_call(got, want):
    assert (got.hap1, got.hap2) == (want.hap1, want.hap2)
    assert got.hap_names == want.hap_names
    assert got.read_gene_counts == want.read_gene_counts
    np.testing.assert_allclose(got.pair_ll, want.pair_ll, rtol=PAIR_RTOL,
                               atol=PAIR_ATOL)
    assert abs(got.posterior - want.posterior) <= POSTERIOR_TOL


@pytest.mark.parametrize("backend", ["jax", "numpy"])
def test_type_diploid_equals_reference(alt_rows, backend):
    """Reference backend "jax": its float32 XLA scan, the form the port's
    device half has; "numpy": its float64 form, the reference's default."""
    ref, port, reads, _, _, _ = alt_rows
    ref.backend = backend
    _same_call(port.type_diploid(reads), ref.type_diploid(reads))


@pytest.mark.parametrize("backend", ["jax", "numpy"])
def test_type_diploid_paired_equals_reference(alt_rows, backend):
    ref, port, _, pairs, _, _ = alt_rows
    ref.backend = backend
    mean, sd = ref.estimate_insert(pairs)
    want = ref.type_diploid_paired(pairs, mean, sd)
    _same_call(port.type_diploid_paired(pairs, mean, sd), want)
    # columns are row1 + row2 + insert term: magnitudes of several hundred
    assert np.abs(want.pair_ll).max() > 1e3


def test_reads_to_genes_equals_reference(alt_rows):
    ref, port, reads, _, _, _ = alt_rows
    assert port.reads_to_genes(reads) == ref.reads_to_genes(reads)


def test_typers_without_reads(alt_rows):
    ref, port, _, _, _, _ = alt_rows
    L, anchors = port.haplotype_likelihoods([])
    assert L.shape == (len(ref.names), 0) and anchors == []
    got, want = port.type_diploid([]), ref.type_diploid([])
    assert (got.hap1, got.hap2) == (want.hap1, want.hap2)
    np.testing.assert_array_equal(got.pair_ll, want.pair_ll)


# --------------------------------------------------------------- assembly
@pytest.fixture(scope="module")
def asm_world(tmp_path_factory):
    """tests/test_asm.py's world with 12 alleles per locus, and an assembly
    of a forward contig, a reverse-complemented one and a mutated one."""
    rng = np.random.default_rng(99)
    sim = simulate_prg_package(rng, backbone_length=2000, n_haplotypes=4,
                               n_gene_alleles=12)
    root = tmp_path_factory.mktemp("asm")
    pkg_dir = sim.write_package(str(root / "pkg")).dir
    mutated = list(sim.linearized(3)[0])
    for _ in range(3):
        p = int(rng.integers(100, len(mutated) - 100))
        mutated[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[mutated[p]]
    contigs = {"fwd_h2": sim.linearized(2)[0],
               "rc_h1": revcomp(sim.linearized(1)[0]),
               "mut_h3": "".join(mutated)}
    truth = {"A": ("A*03:01", "A*05:01"), "B": ("B*02:01", "B*07")}
    return root, pkg_dir, contigs, truth


def _paralog_world(root):
    """tests/test_asm.py::test_gene_positions_paralog_decoy_not_hijacked's
    world: a decoy copy of an exon window that out-seeds the true site."""
    rng = np.random.default_rng(4242)
    sim = simulate_prg_package(rng, backbone_length=2400, n_haplotypes=4)
    cols_e2 = [i for i, n in enumerate(sim.column_names)
               if "_gene_A_" in n and "exon_2" in n]
    row1 = list(sim.haplotypes[1])
    nongap_e2 = [c for c in cols_e2 if row1[c] != "_"]
    step = len(nongap_e2) // 5
    mut = {"A": "C", "C": "G", "G": "T", "T": "A"}
    for c in nongap_e2[step::step][:4]:
        row1[c] = mut[row1[c]]
    contig = "".join(ch for ch in row1 if ch != "_")
    decoy = [row1[c] for c in nongap_e2]
    mid = len(decoy) // 2
    for j in range(mid - 3, mid + 4):
        decoy[j] = mut[decoy[j]]
    row3 = list(sim.haplotypes[3])
    plant_lo = int(0.47 * len(row3))
    row3[plant_lo:plant_lo + len(decoy)] = decoy
    sim.haplotypes[3] = "".join(row3)
    return sim.write_package(str(root / "paralog_pkg")).dir, \
        {"novel": contig}, None


@pytest.fixture(scope="module", params=["three_contigs", "paralog"])
def asm_runs(request, asm_world):
    root, pkg_dir, contigs, truth = asm_world
    if request.param == "paralog":
        pkg_dir, contigs, truth = _paralog_world(root)
    ref = RefAssemblyTyper(RefGraphPackage(pkg_dir))
    port = AssemblyTyper(GraphPackage(pkg_dir), device="cpu")
    out = {}
    for name, typer in (("ref", ref), ("port", port)):
        calls = typer.type_contigs(contigs, truth=truth)
        out_dir = str(root / f"{request.param}_{name}")
        typer.write_outputs(calls, out_dir, contigs=contigs)
        out[name] = (calls, out_dir)
    return request.param, port, out


def test_assembly_calls_equal_reference(asm_runs):
    world, _, out = asm_runs
    got, want = out["port"][0], out["ref"][0]
    assert len(got) == len(want) >= (6 if world == "three_contigs" else 1)
    for a, b in zip(got, want):
        # every field, exon hits included
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    if world == "three_contigs":
        by = {(c.contig, c.locus): c for c in got}
        assert by[("fwd_h2", "A")].alleles_at_min[0] == "A*03:01"
        assert by[("rc_h1", "B")].edit_distance == 0
        assert all(h.reverse for h in by[("rc_h1", "A")].exon_hits.values())
        assert by[("fwd_h2", "A")].min_dist_assembly_truth == 0


@pytest.mark.parametrize("name", ["summary.txt", "genePositions.tab"])
def test_assembly_output_files_are_byte_identical(asm_runs, name):
    _, _, out = asm_runs
    with open(os.path.join(out["port"][1], name), "rb") as fh:
        got = fh.read()
    with open(os.path.join(out["ref"][1], name), "rb") as fh:
        assert got == fh.read()
    assert got.count(b"\n") >= 2


def test_assembly_scores_come_from_the_device_runner(asm_runs):
    """Every edit distance came through NWRunner (band 48, unit scoring),
    scores alone: no call asked for the pointer tensor."""
    _, port, _ = asm_runs
    assert port.band == 48 and port._nw.scoring == EDIT
    assert port.stats.extras["nw_jobs_on_cpu"] == \
        port.stats.n_chain_extensions > 0
    assert "dev_pointers" not in port._nw.scratch


# -------------------------------------------------------------------- CLI
def _both(argv_tail, tmp_path, capsys, out_flag="--outputDirectory"):
    """The reference CLI and the port's CLI on one command line; returns
    ((rc, stdout, out_dir) of the reference, of the port)."""
    res = []
    for name, main, dev in (("ref", ref_main, []),
                            ("port", port_main, ["--device", "cpu"])):
        out_dir = str(tmp_path / f"out_{name}")
        rc = main(argv_tail + [out_flag, out_dir] + dev)
        res.append((rc, capsys.readouterr().out, out_dir))
    return res


def _read(out_dir, name):
    with open(os.path.join(out_dir, name)) as fh:
        return fh.read()


def _same_kir_outputs(ref, port, with_genes):
    assert ref[0] == port[0] == 0
    a = _read(ref[2], "KIR_haplotypes.txt").splitlines()
    b = _read(port[2], "KIR_haplotypes.txt").splitlines()
    assert a[0] == b[0] and len(a) == len(b) == 2
    fa, fb = a[1].split("\t"), b[1].split("\t")
    assert fa[:2] == fb[:2]
    assert abs(float(fa[2]) - float(fb[2])) <= POSTERIOR_TOL
    assert os.path.exists(os.path.join(ref[2], "reads2Genes.txt")) == \
        with_genes
    if with_genes:
        assert _read(ref[2], "reads2Genes.txt") == \
            _read(port[2], "reads2Genes.txt")
    _same_stdout(ref[1], port[1])


def _same_stdout(a: str, b: str):
    """Equal but for the posterior, which may differ by POSTERIOR_TOL."""
    pat = re.compile(r"posterior ([0-9.]+)")
    assert pat.sub("posterior P", a) == pat.sub("posterior P", b)
    for x, y in zip(pat.findall(a), pat.findall(b)):
        assert abs(float(x) - float(y)) <= POSTERIOR_TOL


@pytest.fixture(scope="module")
def kir_files(tmp_path_factory):
    """A four-haplotype aligned panel with two genes and a deletion (the
    recipe of tests/test_linear_alts.py), as package, bare FASTA, aligned
    FASTA + annotation TSV, BAM and FASTQ files."""
    rng = np.random.default_rng(515)
    root = tmp_path_factory.mktemp("kir")
    haps = _panel(rng, 4, 2400, 40, deletion=(1200, 1210))
    ann = {h: [("KIR2DL1", 300, 700), ("KIR3DL2", 1500, 2000)] for h in haps}
    pkg_dir = str(root / "pkg")
    build_kir_package(pkg_dir, haps, ann,
                      covered_regions={"chr19": (0, 100000)})
    write_fasta(str(root / "aligned.fa"), haps)
    write_fasta(str(root / "bare.fa"),
                {n: s.replace("-", "") for n, s in haps.items()})
    with open(root / "ann.tsv", "w") as fh:
        fh.write("haplotypeID\tgene\tstart0\tstop0\n")
        for h, spans in ann.items():
            for g, a, b in spans:
                fh.write(f"{h}\t{g}\t{a}\t{b}\n")
    rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                       fragment_sd=30)
    w = BamWriter(str(root / "in.bam"), [("chr19", 200000)])
    fq1, fq2 = [], []
    for h in ("ALT1", "ALT2"):
        seq = haps[h].replace("-", "")
        for p in rs.simulate_pairs_from_string(seq, np.arange(len(seq)), 6.0,
                                               name_prefix=h):
            fq1.append(p.r1.to_fastq())
            fq2.append(p.r2.to_fastq())
            tlen = abs(p.r2.start_pos - p.r1.start_pos) + len(p.r2.seq)
            for mf, r, tl in ((FLAG_READ1, p.r1, tlen),
                              (FLAG_READ2, p.r2, -tlen)):
                s, q, flag = r.seq, r.qual, FLAG_PAIRED | mf
                if r.reverse:
                    s, q, flag = revcomp(s), q[::-1], flag | FLAG_REVERSE
                w.write(BamRecord(name=r.name, flag=flag, ref_id=0,
                                  pos=max(r.start_pos, 0), mapq=60,
                                  cigar=[(len(s), 0)], seq=s, qual=q,
                                  tlen=tl))
    for j in range(10):         # outside the covered region
        s = "".join(rng.choice(list("ACGT"), 100))
        w.write(BamRecord(name=f"far{j}", flag=0, ref_id=0,
                          pos=150000 + j * 10, mapq=60, cigar=[(100, 0)],
                          seq=s, qual="I" * 100))
    w.close()
    write_fastq(str(root / "R_1.fq"), fq1)
    write_fastq(str(root / "R_2.fq"), fq2)
    write_fastq(str(root / "R_U.fq"), fq1[:60])
    return root, pkg_dir


def test_cli_kir_on_package_and_bam(kir_files, tmp_path, capsys):
    root, pkg_dir = kir_files
    ref, port = _both(["--action", "KIR", "--ALTpanel", pkg_dir, "--BAM",
                       str(root / "in.bam"), "--sampleID", "K1"], tmp_path,
                      capsys)
    _same_kir_outputs(ref, port, with_genes=True)
    r2g = _read(port[2], "reads2Genes.txt")
    assert "KIR2DL1" in r2g and "far0" not in r2g
    assert _read(port[2], "KIR_haplotypes.txt").splitlines()[1].split(
        "\t")[:2] == ["ALT1", "ALT2"]


def test_cli_kir_on_bare_fasta_and_fastq_pair(kir_files, tmp_path, capsys):
    root, _ = kir_files
    ref, port = _both(["--action", "KIR", "--ALTpanel", str(root / "bare.fa"),
                       "--FASTQ1", str(root / "R_1.fq"), "--FASTQ2",
                       str(root / "R_2.fq")], tmp_path, capsys)
    _same_kir_outputs(ref, port, with_genes=False)


def test_cli_kir_on_unpaired_fastq(kir_files, tmp_path, capsys):
    root, pkg_dir = kir_files
    ref, port = _both(["--action", "KIR", "--ALTpanel", pkg_dir, "--FASTQU",
                       str(root / "R_U.fq")], tmp_path, capsys)
    _same_kir_outputs(ref, port, with_genes=True)


def test_cli_kir_default_output_directory_and_missing_input(kir_files,
                                                            tmp_path):
    root, pkg_dir = kir_files
    assert port_main(["--action", "KIR", "--ALTpanel", pkg_dir, "--FASTQU",
                      str(root / "R_U.fq"), "--sampleID", "K9",
                      "--workingDir", str(tmp_path), "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "K9_KIR" / "KIR_haplotypes.txt")
    with pytest.raises(SystemExit, match="ALTpanel"):
        port_main(["--action", "KIR", "--device", "cpu"])
    with pytest.raises(SystemExit, match="FASTQ"):
        port_main(["--action", "KIR", "--ALTpanel", pkg_dir, "--device",
                   "cpu"])


@pytest.mark.parametrize("with_package", [True, False])
def test_cli_kir_simulation(kir_files, tmp_path, capsys, with_package):
    _, pkg_dir = kir_files
    argv = ["--action", "KIRsimulation", "--seed", "5"]
    if with_package:
        argv += ["--ALTpanel", pkg_dir]
    ref, port = _both(argv, tmp_path, capsys)
    assert ref[0] == port[0] == 0
    _same_stdout(ref[1], port[1])
    assert "called" in port[1]
    assert ("reads2Genes accuracy" in port[1]) == with_package


def test_cli_build_kir_panel(kir_files, tmp_path, capsys):
    root, pkg_dir = kir_files
    ref, port = _both(["--action", "buildKIRpanel", "--ASMfasta",
                       str(root / "aligned.fa"), "--annotations",
                       str(root / "ann.tsv")], tmp_path, capsys,
                      out_flag="--ALTpanel")
    assert ref[0] == port[0] == 0
    assert ref[1].replace(ref[2], "") == port[1].replace(port[2], "")
    n_files = 0
    for base, _, files in os.walk(ref[2]):
        for name in files:
            if name.endswith((".npz", ".bin")) or "serialized" in name:
                continue    # compiled caches: not the panel's text
            rel = os.path.relpath(os.path.join(base, name), ref[2])
            with open(os.path.join(base, name), "rb") as fa, \
                    open(os.path.join(port[2], rel), "rb") as fb:
                assert fa.read() == fb.read(), rel
            n_files += 1
    assert n_files >= 8
    with pytest.raises(SystemExit, match="buildKIRpanel"):
        port_main(["--action", "buildKIRpanel", "--device", "cpu"])


def test_cli_check_kir_graph(kir_files, capsys):
    _, pkg_dir = kir_files
    graph = os.path.join(pkg_dir, "geneGraph")
    out = []
    for main, dev in ((ref_main, []), (port_main, ["--device", "cpu"])):
        assert main(["--action", "checkKIRgraph", "--graph", graph]
                    + dev) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[1].startswith("graph OK: ")


@pytest.mark.parametrize("true_hla", [True, False])
def test_cli_asm(asm_world, tmp_path, capsys, true_hla):
    root, pkg_dir, contigs, truth = asm_world
    fasta = str(tmp_path / "contigs.fa")
    write_fasta(fasta, contigs)
    argv = ["--action", "ASM", "--graph", pkg_dir, "--ASMfasta", fasta,
            "--sampleID", "S1"]
    if true_hla:
        table = str(tmp_path / "truth.txt")
        with open(table, "w") as fh:
            fh.write("IndividualID\tA\tA\tB\tB\n")
            fh.write("S1\t" + "\t".join(truth["A"] + truth["B"]) + "\n")
        argv += ["--trueHLA", table]
    ref, port = _both(argv, tmp_path, capsys)
    assert ref[0] == port[0] == 0
    assert ref[1] == port[1] and ("truthED=" in port[1]) == true_hla
    for name in ("summary.txt", "genePositions.tab"):
        assert _read(ref[2], name) == _read(port[2], name)
    assert len(_read(port[2], "summary.txt").splitlines()) == 7
    with pytest.raises(SystemExit, match="ASMfasta"):
        port_main(["--action", "ASM", "--graph", pkg_dir, "--device", "cpu"])


# ------------------------------------------------ NW under unit scoring
def _exon_jobs(seed, B, L, W):
    """Allele sequences of ragged lengths, padded with code 4, against one
    contig window (as AssemblyTyper._exon_distances builds them)."""
    rng = np.random.default_rng(seed)
    window = rng.integers(0, 4, L + W).astype(np.uint8)
    lens = rng.integers(L - 9, L + 1, B).astype(np.int64)
    lens[0] = L
    reads = np.full((B, L), 4, np.uint8)
    for b in range(B):
        a = window[W // 2:W // 2 + L].copy()
        flips = rng.integers(0, L, int(rng.integers(0, 5)))
        a[flips] = (a[flips] + 1) % 4
        if b % 4 == 3:
            a = np.delete(a, int(rng.integers(1, L - 10)))
        lens[b] = min(lens[b], len(a))
        reads[b, :lens[b]] = a[:lens[b]]
    return reads, lens, np.repeat(window[None], B, axis=0)


def _plain_numpy(reads, lens, refs, sc):
    return [t.numpy() for t in banded_nw_plain(
        torch.from_numpy(reads), torch.from_numpy(lens),
        torch.from_numpy(refs), sc)]


@pytest.mark.parametrize("against", ["numpy", "pallas_interpret"])
def test_plain_nw_under_unit_scoring_equals_reference(against):
    """W = 48 and EDIT_SCORING, where D, IY and IX tie in most cells:
    scores, ends and every pointer byte up to each read's last row equal
    the reference's numpy forward and its long Pallas kernel in interpret
    mode."""
    B, L, W = 16, 64, 48
    assert EDIT == {"match": REF_EDIT_SCORING.match,
                    "mismatch": REF_EDIT_SCORING.mismatch,
                    "gap_open": REF_EDIT_SCORING.gap_open,
                    "gap_extend": REF_EDIT_SCORING.gap_extend}
    reads, lens, refs = _exon_jobs(3, B, L, W)
    got = _plain_numpy(reads, lens, refs, EDIT)
    if against == "numpy":
        want = ref_nw_forward(reads, lens, refs, REF_EDIT_SCORING,
                              use_native=False)
    else:
        fwd = make_pallas_banded_nw_long(L, W, **EDIT, rc=16,
                                         interpret=True)
        want = [np.asarray(x) for x in fwd(reads, lens, refs)]
    for name, a, b in zip(("score", "end_k", "end_state"), got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    for b in range(B):
        np.testing.assert_array_equal(got[3][b, :lens[b] + 1],
                                      np.asarray(want[3])[b, :lens[b] + 1])
    assert (got[0] <= 0).all() and len(set(got[0].tolist())) > 3


@pytest.mark.parametrize("pointers", [True, False])
def test_nw_runner_slices_equal_one_call(monkeypatch, pointers):
    """NWRunner.run_jobs across a jobs_per_call boundary (a budget of five
    jobs per call) gives the results of one call, slice by slice; the
    pointer tensor comes back only when asked for."""
    B, L, W = 13, 40, 48
    reads, lens, refs = _exon_jobs(5, B, L, W)
    want = _plain_numpy(reads, lens, refs, EDIT)
    monkeypatch.setattr(port_aligner, "NW_POINTER_BUDGET", 5 * (L + 1) * W)
    runner = NWRunner("cpu", EDIT)
    spans = []
    for lo, hi, out in runner.run_jobs(reads, lens, refs, pointers):
        spans.append((lo, hi))
        for a, b in zip(out[:3], want[:3]):
            np.testing.assert_array_equal(a, b[lo:hi])
        if pointers:
            np.testing.assert_array_equal(out[3], want[3][lo:hi])
        else:
            assert out[3] is None
    assert spans == [(0, 5), (5, 10), (10, 13)]
    assert runner.stats.extras == {"nw_jobs_on_cpu": B}
    np.testing.assert_array_equal(runner.scores(reads, lens, refs), want[0])
