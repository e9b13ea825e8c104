"""The sharded backend on the last actions that take it (``--action KIR``,
``KIRsimulation``, ``TestHLATyping`` on ``--sharded N`` gloo ranks on the
CPU), the reference's ``--backend`` flag on the port's CLI, and
``--sharded`` on an action that runs in one process.

Each rank run is held to the port's one-process run and to the reference
CLI's ``--backend sharded`` (conftest gives JAX 8 virtual CPU devices):
calls equal and the posterior within 1e-3, the pair log-likelihoods within
rtol 1e-6 / atol 1e-2, NW scores and likelihood rows bit for bit, files
as test_torch_kir_asm and test_torch_host_layers hold them."""

import os
import re

import numpy as np
import pytest
import torch

from hla_la_tpu.cli import main as ref_main
from hla_la_tpu.models.kir_package import build_kir_package
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.models.linear_alts import LinearALTsTyper
from hla_la_tpu_torch.models.parallel_host import spawn_safe
from hla_la_tpu_torch.ops.pair_ll import pair_tiles
from hla_la_tpu_torch.parallel import launch
from test_torch_host_layers import _assert_runs_match, _read, _tree
from test_torch_kir_asm import (PAIR_ATOL, PAIR_RTOL, _panel,  # noqa: F401
                                _same_kir_outputs, _same_stdout, kir_files)

torch.set_num_threads(1)
needs_spawn = pytest.mark.skipif(not spawn_safe(),
                                 reason="no file-backed __main__ to spawn "
                                        "from")
REDUCTION = re.compile(r"linear-ALT pair reduction on rank (\d) of a (\d) x "
                       r"(\d) mesh \(data x model\): (\d+) haplotypes, tiles "
                       r"\[(\d+), (\d+)\) of K3's (\d+), reads \[(\d+), "
                       r"(\d+)\) of (\d+)")


def _traced_one_process(argv):
    """The port's CLI in this process with the linear-ALT trace on:
    (exit code, trace)."""
    LinearALTsTyper.trace = []
    try:
        rc = port_main(argv)
    finally:
        trace, LinearALTsTyper.trace = LinearALTsTyper.trace, None
    return rc, trace


def _same_trace(got, want):
    """NW scores and likelihood rows bit for bit, pair matrices within the
    reduction's tolerance, in the same call order."""
    assert [t[0] for t in got] == [t[0] for t in want]
    assert [t[0] for t in want].count("pair") == 1
    for g, w in zip(got, want):
        if g[0] == "nw_scores":
            np.testing.assert_array_equal(g[1], w[1])
        else:
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_allclose(g[2], w[2], rtol=PAIR_RTOL,
                                       atol=PAIR_ATOL)


@needs_spawn
def test_kir_on_two_ranks_matches_one_process_and_the_reference(
        kir_files, tmp_path, capfd):
    """--action KIR --sharded 2 on the package and BAM of
    test_torch_kir_asm (the paired model with the BAM's insert size, and
    reads2Genes): each NW call split over both ranks, the pair reduction
    over the reads of each."""
    root, pkg_dir = kir_files
    common = ["--action", "KIR", "--ALTpanel", pkg_dir, "--BAM",
              str(root / "in.bam"), "--sampleID", "K1"]
    runs = {}
    one = str(tmp_path / "one")
    capfd.readouterr()
    rc, want = _traced_one_process(common + ["--outputDirectory", one,
                                             "--device", "cpu"])
    runs["one"] = (rc, capfd.readouterr().out, one)
    sharded = str(tmp_path / "sharded")
    ranks = launch.run_ranks(launch.rank_cli, 2, "cpu", (
        common + ["--outputDirectory", sharded, "--device", "cpu",
                  "--sharded", "2"], True), timeout_s=120)
    out = capfd.readouterr()
    runs["sharded"] = (ranks[0][0], out.out, sharded)
    assert [r[0] for r in ranks] == [0, 0]
    for rank in ranks:
        _same_trace(rank[3], want)
    shares = sorted(REDUCTION.findall(out.err))
    R = next(t[1] for t in want if t[0] == "pair").shape[1]
    assert shares == [("0", "2", "1", "4", "0", "1", "1", "0", str(R // 2),
                       str(R)),
                      ("1", "2", "1", "4", "0", "1", "1", str(R // 2),
                       str(R), str(R))]
    ref = str(tmp_path / "ref")
    capfd.readouterr()
    rc = ref_main(common + ["--outputDirectory", ref, "--backend",
                            "sharded"])
    runs["ref"] = (rc, capfd.readouterr().out, ref)
    for tag in ("one", "ref"):
        _same_kir_outputs(runs[tag], runs["sharded"], with_genes=True)
    assert _tree(sharded) == {"KIR_haplotypes.txt", "reads2Genes.txt"}


@pytest.fixture(scope="module")
def wide_panel(tmp_path_factory):
    """A package of 66 haplotypes with two genes: more than one 64 x 64
    tile of pairs, so that K3's tile list (3 tiles) is split."""
    rng = np.random.default_rng(616)
    root = tmp_path_factory.mktemp("wide")
    haps = _panel(rng, 66, 1200, 24)
    ann = {h: [("G1", 100, 500), ("G2", 700, 1100)] for h in haps}
    build_kir_package(str(root / "pkg"), haps, ann)
    return str(root / "pkg")


@needs_spawn
def test_kir_simulation_on_four_ranks_splits_the_tile_list(wide_panel,
                                                           capfd):
    """--action KIRsimulation --sharded 4: a 2 x 2 mesh, each model rank a
    range of K3's tile list on half the reads, against the reference CLI's
    --backend sharded and the port in one process."""
    argv = ["--action", "KIRsimulation", "--seed", "5", "--ALTpanel",
            wide_panel]
    printed = {}
    for tag, main, extra in (
            ("sharded", port_main, ["--device", "cpu", "--sharded", "4"]),
            ("one", port_main, ["--device", "cpu"]),
            ("ref", ref_main, ["--backend", "sharded"])):
        capfd.readouterr()
        assert main(argv + extra) == 0, tag
        printed[tag] = capfd.readouterr()
    for tag in ("one", "ref"):
        _same_stdout(printed[tag].out, printed["sharded"].out)
    assert "(OK, posterior" in printed["sharded"].out
    shares = {int(m[0]): m[1:] for m in
              REDUCTION.findall(printed["sharded"].err)}
    assert sorted(shares) == [0, 1, 2, 3]
    assert pair_tiles(66) == 3
    R = int(shares[0][-1])
    for rank, share in shares.items():
        data, model = divmod(rank, 2)
        tiles = [("0", "1"), ("1", "3")][model]
        reads = [("0", str(R // 2)), (str(R // 2), str(R))][data]
        assert share == ("2", "2", "66", *tiles, "3", *reads, str(R)), rank
    assert len(re.findall(r"rank \d: exit code 0, kernel launches",
                          printed["sharded"].err)) == 4


@needs_spawn
def test_test_hla_typing_on_two_ranks(tmp_path, capfd):
    """--action TestHLATyping --sharded 2: the same calls as one process
    and as the reference CLI's --backend sharded; every output file of the
    typing run as one process's (the pair dumps within the reduction's
    tolerance); the other rank writes nothing into the working
    directory."""
    runs = {}
    for tag, main, extra in (
            ("sharded", port_main, ["--device", "cpu", "--sharded", "2"]),
            ("one", port_main, ["--device", "cpu"]),
            ("ref", ref_main, ["--backend", "sharded"])):
        work = str(tmp_path / tag)
        capfd.readouterr()
        assert main(["--action", "TestHLATyping", "--workingDir", work]
                    + extra) == 0, tag
        runs[tag] = (capfd.readouterr().out.splitlines(), work)
    assert runs["sharded"][0] == runs["one"][0] == runs["ref"][0]
    assert runs["sharded"][0][-1] == "OK" and len(runs["sharded"][0]) == 3
    for tag in ("one", "ref"):
        _assert_runs_match(
            os.path.join(runs["sharded"][1], "testTyping_out"),
            os.path.join(runs[tag][1], "testTyping_out"))
    assert sorted(os.listdir(runs["sharded"][1])) == ["testTyping_graph",
                                                      "testTyping_out"]


# --backend as the reference's command lines write it: (flags, --device,
# ranks) of the port, and the log line that names the translation
BACKENDS = [
    (["--backend", "auto"], "cuda", 0),
    (["--backend", "jax"], "cuda", 0),
    (["--backend", "jax", "--device", "cpu"], "cpu", 0),
    (["--backend", "numpy"], "cpu", 0),
    (["--backend", "numpy", "--device", "cpu", "--sharded", "0"], "cpu", 0),
    (["--backend", "sharded", "--device", "cpu"], "cpu", 1),
    (["--backend", "sharded"], "cuda", 1),
    (["--backend", "sharded", "--sharded", "3"], "cuda", 3),
]
CONTRADICTIONS = [
    (["--backend", "numpy", "--device", "cuda"], "contradicts --device cuda"),
    (["--backend", "numpy", "--sharded", "2"], "contradicts --sharded 2"),
    (["--backend", "jax", "--sharded", "2"], "contradicts --sharded 2"),
    (["--backend", "auto", "--sharded", "4"], "contradicts --sharded 4"),
    (["--backend", "sharded", "--sharded", "0"], "contradicts --sharded 0"),
]


@pytest.mark.parametrize("flags,device,ranks", BACKENDS,
                         ids=[" ".join(f) for f, _, _ in BACKENDS])
def test_backend_maps_to_device_and_ranks(flags, device, ranks, monkeypatch,
                                          capsys):
    """Each --backend of the reference is taken and mapped as the table in
    cli._apply_backend says; the run sees one card here, as the card host
    does (torch.cuda.device_count() patched: this host has none)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    seen = {}
    monkeypatch.setattr(
        "hla_la_tpu_torch.cli.ACTIONS",
        {"probe": lambda args: seen.update(vars(args)) or 0})
    assert port_main(["--action", "probe", *flags]) == 0
    assert (seen["device"], seen["sharded"]) == (device, ranks)
    want = f"{flags[1]}: --device {device}, " + (
        f"--sharded {ranks}" if ranks else "one process")
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("flags,message", CONTRADICTIONS,
                         ids=[" ".join(f) for f, _ in CONTRADICTIONS])
def test_backend_that_contradicts_device_or_sharded_ends_the_run(
        flags, message, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=message):
        port_main(["--action", "testBinary", *flags])


def test_backend_sharded_without_a_card_ends_the_run(monkeypatch, capsys):
    """No silent step onto the CPU: --backend sharded on cuda with no card
    visible stops; --device cpu is the way to one rank on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="sees no card"):
        port_main(["--action", "testBinary", "--backend", "sharded"])
    assert capsys.readouterr().out == ""


def test_sharded_on_an_action_without_ranks_runs_in_one_process(
        tmp_path, capsys):
    """--sharded 2 on --action simulate: one log line says the action runs
    in one process, and it writes what it writes without the flag."""
    dirs = {}
    for tag, extra in (("one", []), ("sharded", ["--sharded", "2"])):
        dirs[tag] = str(tmp_path / tag)
        assert port_main(["--action", "simulate", "--seed", "3",
                          "--workingDir", dirs[tag], "--device", "cpu",
                          *extra]) == 0
        out = capsys.readouterr()
        dirs[tag + "_out"] = out.out.replace(dirs[tag], "WD")
        dirs[tag + "_err"] = out.err
    assert dirs["one_out"] == dirs["sharded_out"]
    assert "--action simulate runs in one process: --sharded 2 starts " \
        "ranks for --action HLA, validate, KIR, KIRsimulation, " \
        "TestHLATyping only" in dirs["sharded_err"]
    assert "runs in one process" not in dirs["one_err"]
    names = _tree(dirs["one"])
    assert _tree(dirs["sharded"]) == names and len(names) >= 10
    for name in names:
        a, b = (os.path.join(dirs[t], name) for t in ("one", "sharded"))
        if name.endswith(".npz"):       # a zip's entries carry their time
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files, name
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k])
        else:
            assert _read(a) == _read(b), name
