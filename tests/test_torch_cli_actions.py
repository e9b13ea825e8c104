"""Each action of the reference CLI besides HLA, KIR, ASM, KIRsimulation,
buildKIRpanel and checkKIRgraph (whose tests live in test_torch_host_layers
and test_torch_kir_asm) through both CLIs on the CPU: the same printed lines
(with the working directory's name replaced, and without the rate field of
``testPRGMapping``) and the same files (BAMs as decoded records, the
pair-posterior dumps value by value as test_torch_host_layers holds them,
every other file byte for byte).  Also the unknown action."""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from hla_la_tpu.cli import main as ref_main
from hla_la_tpu.io import bam as ref_bam
from hla_la_tpu_torch import sim as port_sim
from hla_la_tpu_torch.cli import ACTIONS
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.io.fastq import read_fastq
from test_torch_host_layers import _pp_table, _read, _tree

torch.set_num_threads(1)
RATE = re.compile(r", [0-9.]+ reads/s")
SMALL = {"n_alleles": 12, "coverage": 6.0, "backbone": 1800}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return port_sim.cohort_world(str(tmp_path_factory.mktemp("cohort")),
                                 **SMALL)


def _records(path):
    return [vars(r) for r in ref_bam.BamReader(path)]


def _same_trees(port_dir, ref_dir):
    """The same files under both directories: BAMs as decoded records,
    pair-posterior dumps within the pair reduction's tolerances, the rest
    byte for byte.  Returns how many files were held."""
    names = _tree(ref_dir)
    assert _tree(port_dir) == names
    for name in sorted(names):
        got, want = (os.path.join(d, name) for d in (port_dir, ref_dir))
        if name.endswith(".bam"):
            assert _records(got) == _records(want), name
        elif "_PP_" in name:
            g, w = _pp_table(got), _pp_table(want)
            assert g.keys() == w.keys(), name
            for key, (p, ll, mm) in w.items():
                assert abs(g[key][0] - p) <= 1e-6, (name, key)
                assert abs(g[key][1] - ll) <= 1e-2 + 1e-6 * abs(ll)
                assert g[key][2] == mm, (name, key)
        else:
            assert _read(got) == _read(want), name
    return len(names)


def _both(capsys, tmp_path, argv, setup=None):
    """`argv(work_dir)` through the port's CLI (on the CPU) and the
    reference CLI, each in a working directory of its own that `setup`
    (if given) fills first.  Returns {tag: (exit code, printed lines with
    the working directory named WD)} and the two directories."""
    out, dirs = {}, {}
    for tag, main, extra in (("port", port_main, ["--device", "cpu"]),
                             ("ref", ref_main, [])):
        work = str(tmp_path / tag)
        os.makedirs(work)
        if setup is not None:
            setup(work)
        capsys.readouterr()
        rc = main(argv(work) + extra)
        lines = capsys.readouterr().out.replace(work, "WD").splitlines()
        out[tag], dirs[tag] = (rc, lines), work
    return out, dirs


def _check(capsys, tmp_path, argv, setup=None, min_files=0):
    out, dirs = _both(capsys, tmp_path, argv, setup)
    assert out["port"] == out["ref"] and out["port"][0] == 0, out
    assert _same_trees(dirs["port"], dirs["ref"]) >= min_files
    return out["port"][1], dirs["port"]


def test_every_reference_action_dispatches():
    src = open(os.path.join(os.path.dirname(ref_main.__code__.co_filename),
                            "cli.py")).read()
    assert set(re.findall(r'if action == "(\w+)"', src)) == set(ACTIONS)
    assert len(ACTIONS) == 24


def test_unknown_action(capsys):
    for main in (port_main, ref_main):
        assert main(["--action", "noSuchAction"]) == 2
        assert capsys.readouterr().err.strip() == \
            "unknown action noSuchAction"


def test_test_binary(capsys, tmp_path):
    lines, _ = _check(capsys, tmp_path, lambda d: ["--action", "testBinary"])
    assert lines == ["hla-la-tpu binary functional!"]


@pytest.mark.parametrize("action", ["simulate", "oneSimulationFromPRG"])
def test_simulate(capsys, tmp_path, action):
    lines, _ = _check(capsys, tmp_path, lambda d: [
        "--action", action, "--workingDir", d, "--seed", "3"],
        min_files=10)
    assert lines[0].startswith("simulated package + ")


def test_simulate_from_normal_genome(capsys, tmp_path):
    rng = np.random.default_rng(5)
    genome = ">g1\n" + "".join(rng.choice(list("ACGT"), 3000)) + "\n"

    def setup(d):
        with open(os.path.join(d, "genome.fa"), "w") as fh:
            fh.write(genome)
    lines, _ = _check(capsys, tmp_path, lambda d: [
        "--action", "simulateFromNormalGenome", "--ASMfasta",
        os.path.join(d, "genome.fa"), "--workingDir", d], setup, 5)
    assert lines[0].startswith("simulated ") and "from 1 contigs" in lines[0]


def test_prepare_graph(capsys, tmp_path, cohort):
    lines, _ = _check(capsys, tmp_path, lambda d: [
        "--action", "prepareGraph", "--graph", os.path.join(d, "g")],
        lambda d: shutil.copytree(cohort.graph, os.path.join(d, "g")), 10)
    assert lines == []


@pytest.mark.parametrize("which", ["self_test", "sequences"])
def test_check_sequence_presence(capsys, tmp_path, cohort, which):
    extra = []
    if which == "sequences":
        fasta = tmp_path / "seqs.fa"
        fasta.write_text(">in\nACGTTT\n>out\n" + "ACGT" * 400 + "\n")
        extra = ["--ASMfasta", str(fasta)]
    out, _ = _both(capsys, tmp_path, lambda d: [
        "--action", "checkSequencePresence", "--graph", cohort.graph,
        *extra])
    assert out["port"] == out["ref"]
    assert out["port"][1] and out["port"][0] == (0 if not extra else 1)


def test_global_alignment(capsys, tmp_path):
    rng = np.random.default_rng(8)
    ref = "".join(rng.choice(list("ACGT"), 1500))
    query = ref[200:900] + "A" + ref[900:1300]

    def setup(d):
        with open(os.path.join(d, "q.fa"), "w") as fh:
            fh.write(f">q\n{query}\n")
        with open(os.path.join(d, "r.fa"), "w") as fh:
            fh.write(f">r\n{ref}\n")
    lines, _ = _check(capsys, tmp_path, lambda d: [
        "--action", "globalAlignment", "--ASMfasta",
        os.path.join(d, "q.fa"), "--ref", os.path.join(d, "r.fa"),
        "--workingDir", d], setup, 3)
    assert lines[0].startswith("globalAlignment: ")


def test_graph_from_mfa(capsys, tmp_path):
    def setup(d):
        with open(os.path.join(d, "panel.mfa"), "w") as fh:
            fh.write(">h1\nACGTAACGTACGTACGTACGTACGT\n"
                     ">h2\nACGTTACGTACG-ACGTACGTACGT\n"
                     ">h3\nACGTAACGTACGGACG-ACGTACGT\n")
    lines, _ = _check(capsys, tmp_path, lambda d: [
        "--action", "graphFromMFA", "--ASMfasta",
        os.path.join(d, "panel.mfa"), "--graph", os.path.join(d, "g")],
        setup, 5)
    assert lines[0].startswith("graph package written to WD/g: ")


def test_find_kir_in_bam(capsys, tmp_path, cohort):
    fasta = tmp_path / "panel.fa"
    first = next(iter(read_fastq(
        os.path.join(os.path.dirname(cohort.graph), "R_1.fq")))).seq
    fasta.write_text(f">hit\n{first}\n>miss\n{'ACGT' * 30}\n")
    out, _ = _both(capsys, tmp_path, lambda d: [
        "--action", "findKIRinBAM", "--BAM", cohort.samples[0].bam,
        "--ALTpanel", str(fasta)])
    assert out["port"] == out["ref"]
    counts = dict(line.split("\t") for line in out["port"][1])
    assert int(counts["hit"]) > 0 and counts["miss"] == "0"


def test_extract_kmer_counts(capsys, tmp_path, cohort):
    fq = os.path.dirname(cohort.graph)
    lines, _ = _check(capsys, tmp_path, lambda d: [
        "--action", "extractkMerCounts", "--graph", cohort.graph,
        "--FASTQ1", os.path.join(fq, "R_1.fq"), "--FASTQ2",
        os.path.join(fq, "R_2.fq"), "--outputDirectory", d], min_files=1)
    assert lines[0].startswith("wrote WD/kMerCounts.txt (")


def test_validate(capsys, tmp_path, cohort):
    lines, work = _check(capsys, tmp_path, lambda d: [
        "--action", "validate", *cohort.cli_args(), "--workingDir", d],
        min_files=20)
    assert lines == ["cohort accuracy: 87.50% over 2 samples (1 discordant "
                     "calls)"]
    sample, locus, _ = cohort.wrong
    with open(os.path.join(work, "validation",
                           f"pileup_analysis_{sample}_{locus}.txt")) as fh:
        assert len(fh.read().splitlines()) > 2


@pytest.mark.parametrize("host", ["0", "1"])
def test_validate_selects_cohort_rows_by_host(capsys, tmp_path, cohort,
                                              host):
    """--nHosts 2 --hostIdx I types cohort rows I, I + 2, ... alone and
    writes report files of its own."""
    lines, work = _check(capsys, tmp_path, lambda d: [
        "--action", "validate", *cohort.cli_args(), "--workingDir", d,
        "--nHosts", "2", "--hostIdx", host], min_files=10)
    sample = cohort.samples[int(host)].sample_id
    assert sorted(os.listdir(os.path.join(work, "validation"))) == sorted(
        [sample] + [f"validation_{n}_host{host}.txt"
                    for n in ("report", "calibration", "allele_stats")]
        + ([f"pileup_analysis_{sample}_B.txt"] if sample == "S2" else []))
    assert lines[0].endswith("over 1 samples (%d discordant calls)"
                             % (sample == "S2"))


@pytest.fixture(scope="module")
def validate_one_process(tmp_path_factory, cohort):
    """The port's validate without --maxThreads or --sharded: (printed
    lines, working directory)."""
    work = str(tmp_path_factory.mktemp("validate_one"))
    assert port_main(["--action", "validate", *cohort.cli_args(),
                      "--workingDir", work, "--device", "cpu"]) == 0
    return work


@pytest.mark.parametrize("flag", [["--maxThreads", "2"],
                                  ["--maxThreads", "2", "--sharded", "2"]])
def test_validate_refuses_the_hla_actions_process_options(
        capfd, tmp_path, cohort, validate_one_process, flag):
    """The parity test of validate's --maxThreads, under its old name (the
    port refused the flag; the reference takes it and types each sample in
    one process): alone or beside --sharded 2 (two ranks), it is taken, one
    log line says it starts no workers, and the printed cohort accuracy and
    every file are those of the run without it and of the reference CLI
    given the same flags (--sharded 2 is its --backend sharded)."""
    ref_flag = ["--maxThreads", "2"] + (
        ["--backend", "sharded"] if "--sharded" in flag else [])
    runs = {}
    for tag, main, extra in (("port", port_main, ["--device", "cpu", *flag]),
                             ("ref", ref_main, ref_flag)):
        work = str(tmp_path / tag)
        capfd.readouterr()
        assert main(["--action", "validate", *cohort.cli_args(),
                     "--workingDir", work, *extra]) == 0, tag
        out = capfd.readouterr()
        runs[tag] = out.out.splitlines(), out.err, work
    lines, log, work = runs["port"]
    assert lines == runs["ref"][0] == [
        "cohort accuracy: 87.50% over 2 samples (1 discordant calls)"]
    assert log.count("--action validate types each sample in one process: "
                     "--maxThreads 2 starts no workers") == 1
    assert "aligning with" not in log
    assert _same_trees(work, validate_one_process) >= 20
    assert _same_trees(work, runs["ref"][2]) >= 20


@pytest.mark.parametrize("input_kind", ["bam", "cram"])
def test_remap_and_reduce(capsys, tmp_path, cohort, input_kind):
    bam = cohort.samples[0].bam
    extra = []
    if input_kind == "cram":
        from hla_la_tpu.io.cram_write import write_cram
        rng = np.random.default_rng(4)
        contig = port_sim.worlds.BAM_CONTIG
        genome = "".join(rng.choice(list("ACGT"), contig[1]))
        (tmp_path / "genome.fa").write_text(f">{contig[0]}\n{genome}\n")
        bam = str(tmp_path / "in.cram")
        write_cram(bam, [contig], list(ref_bam.BamReader(
            cohort.samples[0].bam)), {contig[0]: genome}, per_slice=500)
        extra = ["--ref", str(tmp_path / "genome.fa")]
    lines, work = _check(capsys, tmp_path, lambda d: [
        "--action", "remapAndReduce", "--BAM", bam, "--graph", cohort.graph,
        "--out", os.path.join(d, "prg.bam"), *extra], min_files=1)
    m = re.fullmatch(r"remapAndReduce: (\d+) pairs \+ 0 unpaired reads "
                     r"remapped to PRG coordinates -> WD/prg.bam", lines[0])
    recs = list(ref_bam.BamReader(os.path.join(work, "prg.bam")))
    assert m and len(recs) == 2 * int(m.group(1)) > 100
    assert [r.pos for r in recs] == sorted(r.pos for r in recs)


@pytest.mark.parametrize("how", [["--fraction", "0.4"],
                                 ["--targetGigabases", "2e-6"]])
def test_downsample_bam(capsys, tmp_path, cohort, how):
    lines, _ = _check(capsys, tmp_path, lambda d: [
        "--action", "downsampleBAM", "--BAM", cohort.samples[1].bam,
        "--out", os.path.join(d, "out" if how[0] == "--targetGigabases"
                              else "out.bam"), "--seed", "4", *how],
        min_files=1)
    assert lines[0].startswith("downsampleBAM: ")


def test_test_prg_mapping(capsys, tmp_path):
    out, dirs = _both(capsys, tmp_path, lambda d: [
        "--action", "testPRGMapping", "--workingDir", d])
    got, want = ([RATE.sub("", line) for line in out[t][1]]
                 for t in ("port", "ref"))
    assert got == want and got[-1] == "OK" and out["port"][0] == 0
    assert RATE.search(out["port"][1][0])
    assert _same_trees(dirs["port"], dirs["ref"]) >= 10


@pytest.mark.parametrize("action", ["testPRGMappingUnpaired",
                                    "testAlignments2Chains",
                                    "testChainExtension", "TestHLATyping"])
def test_aligning_self_test(capsys, tmp_path, action):
    lines, _ = _check(capsys, tmp_path, lambda d: [
        "--action", action, "--workingDir", d], min_files=10)
    assert lines[-1] == "OK" or lines[-1].endswith(" — OK")
