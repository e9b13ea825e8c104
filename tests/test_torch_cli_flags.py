"""The ``--action HLA`` flags of the port's CLI against the reference CLI on
the CPU, one test per flag: the paralog defence (``--decoyFasta``,
``--mapAgainstCompleteGenome``), ``--trueHLA`` concordance,
``--keepExtractedFastq``, ``--extractExonkMerCounts`` (refused, loudly), and
a world with a planted ambiguity, where the Q1/Q2 bar of 1e-3 binds."""

import os
import re
import shutil

import pytest
import torch

from hla_la_tpu.cli import main as ref_main
from hla_la_tpu_torch import sim as port_sim
from hla_la_tpu_torch.cli import main as port_main
from test_torch_host_layers import _assert_runs_match, _read

torch.set_num_threads(1)
Q_TOL = 1e-3


@pytest.fixture(scope="module")
def decoy(tmp_path_factory):
    return port_sim.decoy_world(str(tmp_path_factory.mktemp("decoy")))


def _hla(main, world, out_dir, *extra, inputs=None):
    argv = ["--action", "HLA", *(inputs or world.cli_args()), "--graph",
            world.graph, "--sampleID", "S1", "--outputDirectory", out_dir,
            *extra]
    if main is port_main:
        argv += ["--device", "cpu"]
    return main(argv)


def _dropped(log):
    m = re.search(r"decoy_dropped_pairs: (\d+)", log)
    return int(m.group(1)) if m else 0


def _read_ids(out_dir):
    """Every read id named in a run's readIDs files."""
    text = ""
    for d, _, files in os.walk(out_dir):
        for f in files:
            if "readID" in f:
                with open(os.path.join(d, f)) as fh:
                    text += fh.read()
    return text


@pytest.mark.parametrize("flag", ["decoyFasta", "mapAgainstCompleteGenome"])
def test_cli_paralog_defence_matches_the_reference(decoy, tmp_path, capfd,
                                                   flag):
    """The world of tests/test_decoy.py: with the defence the port drops
    the pairs the reference drops (nearly all of the paralog's) and calls
    what it calls, no paralog read reaches the typing outputs; without it
    they align."""
    world = decoy
    fastqs = world.cli_args()[:4]
    if flag == "decoyFasta":
        extra = ["--decoyFasta", world.decoy_fasta]
    else:
        # the package's own extended reference genome is the decoy source
        graph = str(tmp_path / "pkg")
        shutil.copytree(world.graph, graph)
        os.makedirs(os.path.join(graph, "extendedReferenceGenome"))
        shutil.copy(world.decoy_fasta,
                    os.path.join(graph, "extendedReferenceGenome",
                                 "extendedReferenceGenome.fa"))
        world = port_sim.DecoyWorld(**{**world.__dict__, "graph": graph})
        extra = ["--mapAgainstCompleteGenome", "1"]
    logs = {}
    for tag, main in (("port", port_main), ("ref", ref_main)):
        assert _hla(main, world, str(tmp_path / tag), *extra,
                    inputs=fastqs) == 0
        logs[tag] = capfd.readouterr().err
        assert "paralog defense active" in logs[tag]
    assert _dropped(logs["port"]) == _dropped(logs["ref"]) \
        >= 0.9 * world.n_paralog_pairs
    _assert_runs_match(str(tmp_path / "port"), str(tmp_path / "ref"))
    assert "para" not in _read_ids(str(tmp_path / "port"))
    with open(tmp_path / "port" / "hla" / "R1_bestguess.txt") as fh:
        rows = [line.split("\t") for line in fh][1:]
    assert sorted(r[2] for r in rows if r[0] == "A") == world.truth["A"]
    # the flag is what turns the defence on
    assert _hla(port_main, world, str(tmp_path / "off"), inputs=fastqs) == 0
    off = capfd.readouterr().err
    assert "paralog defense active" not in off and _dropped(off) == 0


def test_cli_true_hla_concordance_line_matches_the_reference(decoy, tmp_path,
                                                             capfd):
    world = decoy
    loci = sorted(world.truth)
    truth = tmp_path / "truth.txt"
    # one allele of locus B is deliberately wrong: 3 of 4 alleles agree
    planted = {**world.truth, "B": [world.truth["B"][0], "B*99:99"]}
    truth.write_text(
        "IndividualID\t" + "\t".join(lc for lc in loci for _ in range(2))
        + "\nS1\t" + "\t".join(a for lc in loci for a in planted[lc]) + "\n")
    lines = {}
    for tag, main in (("port", port_main), ("ref", ref_main)):
        assert _hla(main, world, str(tmp_path / tag), "--trueHLA",
                    str(truth)) == 0
        out = capfd.readouterr().out.splitlines()
        lines[tag] = [ln for ln in out if ln.startswith("truth concordance")]
    assert lines["port"] == lines["ref"]
    assert lines["port"] == ["truth concordance: 3/4 alleles (75.0%) over "
                             "2 loci"]


def test_cli_keeps_the_extracted_fastq(decoy, tmp_path):
    world = decoy
    for tag, main in (("port", port_main), ("ref", ref_main)):
        assert _hla(main, world, str(tmp_path / tag),
                    "--keepExtractedFastq", "1") == 0
    for name in ("R_1.fastq", "R_2.fastq"):
        got = _read(str(tmp_path / "port" / name))
        assert got == _read(str(tmp_path / "ref" / name)) and len(got) > 1000
    assert not os.path.exists(tmp_path / "port" / "R_U.fastq")
    assert _read(str(tmp_path / "port" / "R_1.fastq")) == _read(world.fastq1)


def test_cli_refuses_exon_kmer_counts_loudly(decoy, tmp_path):
    """--extractExonkMerCounts parses, and exits non-zero before any work
    with a message that names what the package lacks; on sharded and on
    long-read runs it keeps the reference's own refusals."""
    world = decoy
    with pytest.raises(SystemExit) as exc:
        _hla(port_main, world, str(tmp_path / "a"),
             "--extractExonkMerCounts", "1")
    assert exc.value.code not in (0, None)
    assert "tools.extract_kmer_counts" in str(exc.value.code)
    assert not os.path.exists(tmp_path / "a" / "hla")
    refusals = []
    for main in (port_main, ref_main):
        for extra in (["--nHosts", "2"], ["--mergeShards", str(tmp_path)],
                      ["--longReads", "ont2d"]):
            with pytest.raises(SystemExit) as exc:
                _hla(main, world, str(tmp_path / "b"),
                     "--extractExonkMerCounts", "1", *extra)
            refusals.append(str(exc.value.code))
    assert refusals[:3] == refusals[3:]
    assert "sharded" in refusals[0] and "short-read" in refusals[2]


def test_ambiguous_world_matches_the_reference(tmp_path):
    """A call that is not certain: at least one Q1 strictly inside
    (0.05, 0.95), and the port's Q1/Q2 within 1e-3 of the reference's with
    every other column equal."""
    world = port_sim.ambiguous_world(str(tmp_path / "w"))
    tables = {}
    for tag, main in (("port", port_main), ("ref", ref_main)):
        assert _hla(main, world, str(tmp_path / tag)) == 0
        with open(tmp_path / tag / "hla" / "R1_bestguess.txt") as fh:
            tables[tag] = [line.rstrip("\n").split("\t") for line in fh]
    inside = port_sim.ambiguous_q1(tables["port"])
    assert inside and all(0.05 < q < 0.95 for q in inside)
    assert len(tables["port"]) == len(tables["ref"]) == 5
    for got, want in zip(tables["port"][1:], tables["ref"][1:]):
        for i, (a, b) in enumerate(zip(got, want)):
            if i in (3, 4):
                assert abs(float(a) - float(b)) <= Q_TOL, (i, a, b)
            else:
                assert a == b, (i, a, b)
    with pytest.raises(AssertionError, match="no Q1 inside"):
        port_sim.ambiguous_q1([tables["port"][0],
                               ["A", "1", "x", "1.0"], ["A", "2", "y", "0.0"]])
