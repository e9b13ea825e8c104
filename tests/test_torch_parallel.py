"""The port's many-process paths on the CPU, each against the reference on
the same numpy-seeded inputs and against the port's own one-process path:
the sharded steps of ``parallel/mesh.py`` on 2 and 4 gloo ranks (the
counterparts of tests/test_parallel.py), worker processes for alignment and
per-locus typing, align shards and their merge, and the CLI's switches (the
counterparts of tests/test_cli.py's shard and sharded-backend tests).

Tolerances: NW outputs bit-exact; pair log-likelihoods rtol 1e-6 / atol 1e-2
(rtol 1e-4 / atol 1e-3 for the typing step against float64 numpy, the
reference test's bar); the marginal atol 1e-4 against the host formula; Q1
and Q2 within 1e-3; every file of a worker or shard run byte-equal to the
one-process run."""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from hla_la_tpu.cli import main as ref_main
from hla_la_tpu.models import parallel_host as ref_parallel_host
from hla_la_tpu.models.aligner import ReadAligner as RefAligner
from hla_la_tpu.models.typer import HLATyper as RefTyper
from hla_la_tpu.ops.pair_ll import pair_ll_reduction_numpy
from hla_la_tpu.parallel import mesh as ref_mesh
from hla_la_tpu.utils.config import TyperConfig as RefTyperConfig
from hla_la_tpu_torch import _build
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.io.fastq import FastqRead, write_fastq
from hla_la_tpu_torch.models.aligner import (AlignedPair, NWRunner,
                                             ReadAligner)
from hla_la_tpu_torch.models.alignment import GraphAlignment
from hla_la_tpu_torch.models.parallel_host import (PackedAlignedPairs,
                                                   ParallelAligner,
                                                   pack_aligned_pairs,
                                                   spawn_safe)
from hla_la_tpu_torch.models.typer import HLATyper
from hla_la_tpu_torch.ops.pair_ll import pair_ll_reduction
from hla_la_tpu_torch.parallel import launch
from hla_la_tpu_torch.sim import ReadSimulator, simulate_prg_package
from hla_la_tpu_torch.utils.config import TyperConfig
from test_torch_host_layers import _assert_runs_match, _read, _tree

torch.set_num_threads(1)
# (ranks, of them along "model": what model_axis derives from the count)
MESHES = [(2, 1), (4, 2)]
needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="the reference mesh needs 8 virtual "
                                    "devices")
needs_spawn = pytest.mark.skipif(not spawn_safe(),
                                 reason="no file-backed __main__ to spawn "
                                        "from")


def _ranks(fn, world, *args):
    """fn on every rank of a gloo mesh on the CPU; all ranks must return
    the same arrays, which are returned once."""
    res = launch.run_ranks(fn, world, "cpu", args, timeout_s=120)
    first = res[0] if isinstance(res[0], tuple) else (res[0],)
    for other in res[1:]:
        other = other if isinstance(other, tuple) else (other,)
        for a, b in zip(first, other):
            np.testing.assert_array_equal(a, b)
    return res[0]


def _marginal_host(pair):
    """The host formula (typer: triu softmax over unordered pairs)."""
    C = len(pair)
    iu = np.triu_indices(C)
    P = np.exp(pair[iu] - pair[iu].max())
    P /= P.sum()
    marg = np.zeros(C)
    np.add.at(marg, iu[0], P)
    sec = iu[1] != iu[0]
    np.add.at(marg, iu[1][sec], P[sec])
    return marg


@needs_spawn
@needs_8
@pytest.mark.parametrize("world,n_model", MESHES)
def test_sharded_typing_matches_numpy_and_the_reference(world, n_model):
    rng = np.random.default_rng(12345)
    C, R, K = 8, 16, 24
    onehot = (rng.random((C, K)) < 0.2).astype(np.float32)
    contrib = rng.normal(-1, 0.5, (R, K)).astype(np.float32)
    pair, marg = _ranks(launch.rank_typing_step, world, onehot,
                        contrib)
    L = (onehot @ contrib.T).astype(np.float64)
    want = pair_ll_reduction_numpy(L)
    np.testing.assert_allclose(pair, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(marg, _marginal_host(want), atol=1e-4)
    ref_pair, ref_marg = ref_mesh.sharded_typing_step(
        ref_mesh.make_mesh(world // n_model, n_model))(onehot, contrib)
    np.testing.assert_allclose(pair, np.asarray(ref_pair), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(marg, np.asarray(ref_marg), atol=1e-4)
    # the one-process path on the same likelihoods
    np.testing.assert_allclose(
        pair, pair_ll_reduction(L.astype(np.float32), "cpu"), rtol=1e-6,
        atol=1e-2)


@needs_spawn
@needs_8
def test_full_step_matches_the_reference():
    rng = np.random.default_rng(12345)
    B, L, W = 8, 16, 8
    C, R, K = 8, 16, 24
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L, dtype=np.int64)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    onehot = (rng.random((C, K)) < 0.2).astype(np.float32)
    contrib = rng.normal(-1, 0.5, (R, K)).astype(np.float32)
    scores, pair = _ranks(launch.rank_full_step, 4, L, W, reads, lens,
                          refs, onehot, contrib)
    assert scores.shape == (B,) and pair.shape == (C, C)
    ref_scores, ref_pair = ref_mesh.full_step(ref_mesh.make_mesh(4, 2), L, W)(
        reads, lens, refs, onehot, contrib)
    np.testing.assert_array_equal(scores, np.asarray(ref_scores))
    np.testing.assert_allclose(pair, np.asarray(ref_pair), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(
        scores, NWRunner("cpu").run(reads, lens, refs)[0])


@needs_spawn
@pytest.mark.parametrize("world,n_model", MESHES)
def test_sharded_pair_reduction_matches_numpy(world, n_model):
    """Odd sizes: the reads of a rank and the tile list do not divide."""
    L = np.random.default_rng(5).normal(-30, 6, (13, 101))
    got = _ranks(launch.rank_pair_reduction, world, L)
    np.testing.assert_allclose(got, pair_ll_reduction_numpy(L), rtol=1e-6,
                               atol=1e-2)
    np.testing.assert_allclose(got, pair_ll_reduction(L, "cpu"), rtol=1e-6,
                               atol=1e-2)
    np.testing.assert_array_equal(got, got.T)


@needs_spawn
@needs_8
def test_sharded_pair_reduction_nontoy_shape():
    """C = 600 is 55 tiles of K3's tile list over two model ranks, R = 1,024
    over two data ranks; against numpy, the one-process path and the
    reference's sharded reduction."""
    L = np.random.default_rng(11).normal(-40, 8, (600, 1024))
    got = _ranks(launch.rank_pair_reduction, 4, L)
    want = pair_ll_reduction_numpy(L)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-2)
    np.testing.assert_allclose(got, pair_ll_reduction(L, "cpu"), rtol=1e-6,
                               atol=1e-2)
    np.testing.assert_allclose(got, ref_mesh.pair_ll_reduction_sharded(L),
                               rtol=1e-6, atol=1e-2)


@needs_spawn
@pytest.mark.parametrize("world,n_model", MESHES)
def test_sharded_nw_matches_single_device(world, n_model):
    """ShardedNW (data-axis slices + batch padding) is bit-equal to
    NWRunner.run at a production shape with B not divisible by the ranks,
    and to the reference's ShardedNW."""
    rng = np.random.default_rng(12345)
    L, W, B = 128, 32, 101
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(60, L + 1, B).astype(np.int64)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    got = _ranks(launch.rank_sharded_nw, world, reads, lens, refs)
    want = NWRunner("cpu").run(reads, lens, refs)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if len(jax.devices()) >= 8:
        ref = ref_mesh.ShardedNW(ref_mesh.make_mesh(8), L, W)(reads, lens,
                                                              refs)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)


def test_model_axis_follows_the_reference_rule():
    """The run's model axis from its rank count: 2 for an even count above
    2, else 1, as the reference derives it from its device count
    (pair_ll_reduction_sharded without a mesh)."""
    from hla_la_tpu_torch.parallel.mesh import model_axis
    assert [model_axis(n) for n in (1, 2, 3, 4, 6, 7, 8)] == \
        [1, 1, 1, 2, 2, 1, 2]
    assert all(model_axis(world) == n_model for world, n_model in MESHES)


def test_the_mesh_and_the_sharded_reduction_take_no_default_device():
    """A rank computes where it was told to, never on a device picked from
    the group's backend."""
    from hla_la_tpu_torch.parallel import mesh
    with pytest.raises(TypeError, match="device"):
        mesh.make_mesh(1, 1)
    with pytest.raises(TypeError, match="mesh"):
        mesh.pair_ll_reduction_sharded(np.zeros((2, 2)))


def _rank_raises(m):
    raise ValueError(f"rank {m.rank} was told to fail")


def _rank_one_dies(m):
    if m.rank == 1:
        os._exit(3)
    return float(m.all_reduce(torch.ones(1))[0])


@needs_spawn
@pytest.mark.parametrize("fn,message", [
    (_rank_raises, "was told to fail"),
    (_rank_one_dies, "rank 1: exited without a result")])
def test_a_failed_rank_ends_the_run(fn, message):
    """A rank that raises, or dies with no word while the others wait for
    it in a collective, ends run_ranks with its message; the launcher sets
    no limit on how long healthy ranks may run."""
    with pytest.raises(RuntimeError, match=message):
        launch.run_ranks(fn, 2, "cpu", timeout_s=120)
    assert not hasattr(launch, "JOIN_TIMEOUT_S")


def test_a_lost_rank_fails_the_others(tmp_path):
    """A rank that never arrives makes init_process_group raise after its
    timeout instead of hanging."""
    from hla_la_tpu_torch.parallel import mesh
    with pytest.raises(Exception, match="(?i)timeout|timed out|wait"):
        try:
            mesh.init_ranks(0, 2, f"file://{tmp_path}/rendezvous", "cpu",
                            timeout_s=2)
        finally:
            mesh.close_ranks()


def test_from_chunks_mixed_optional_keys():
    """Merging packs from mixed builds (older align shards lack the
    wok/fok caches) must drop the optional caches, not crash; required
    keys missing must raise."""

    def mk_pair(i):
        def chain():
            n = 10
            return GraphAlignment(
                levels=np.arange(n, dtype=np.int64),
                graph_c=np.full(n, ord("A"), np.uint8),
                seq_c=np.full(n, ord("A"), np.uint8),
                seq_qual=np.full(n, 70, np.uint8), reverse=False,
                seq_idx=0, mapq=1.0, mapq_per_pos=None,
                from_first_read=True, log_likelihood=-1.0)
        return AlignedPair(f"r{i}", chain(), chain(), 1.0)

    new = pack_aligned_pairs([mk_pair(0)])
    old = pack_aligned_pairs([mk_pair(1)])
    del old["wok"], old["fok"]          # pre-wok-era shard
    merged = PackedAlignedPairs.from_chunks([new, old])
    assert len(merged) == 2
    assert "wok" not in merged.pack     # dropped, not crashed
    assert merged[0].chain1.n_columns == 10
    assert merged[1].read_id == "r1"
    bad = dict(new)
    del bad["pair_mapq"]
    with pytest.raises(ValueError, match="required keys"):
        PackedAlignedPairs.from_chunks([new, bad])


@pytest.fixture(scope="module")
def four_loci(tmp_path_factory):
    """tests/test_parallel.py's world: four loci, so the typing workers'
    gate passes; paired reads and two long unpaired fragments."""
    rng = np.random.default_rng(31)
    sim = simulate_prg_package(
        rng, backbone_length=5000, n_haplotypes=6,
        genes={"A": (0.08, 0.26), "B": (0.30, 0.48), "C": (0.52, 0.70),
               "DQA1": (0.74, 0.92)})
    pkg = sim.write_package(str(tmp_path_factory.mktemp("four_loci") / "g"))
    rs = ReadSimulator(rng, read_length=90, fragment_mean=260, fragment_sd=25)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 8.0,
                                               name_prefix=f"h{h}")
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    seq1, _ = sim.linearized(1)
    rawu = [FastqRead(f"u{i}", seq1[s:s + 1400], "I" * 1400)
            for i, s in enumerate((100, 1900))]
    return pkg, fq, rawu


def _typed(four_loci, tmp_path, tag, n_workers, typer=None, ref=False):
    """type_all into <tmp_path>/<tag>/hla (a CLI run's layout) by the
    port's aligner and typer, or with ref=True by the reference's."""
    pkg, fq, rawu = four_loci
    al = RefAligner(pkg) if ref else ReadAligner(pkg, device="cpu")
    aligned = al.align_pairs(fq, 260, 25)
    unal = al.align_unpaired(rawu)
    # an unpaired read with no alignment: a None slot in the workers' packs
    rawu = rawu + [FastqRead("u_none", "A" * 60, "I" * 60)]
    unal = unal + [None]
    if ref:
        typer = RefTyper(pkg, RefTyperConfig(min_reads_for_typing_workers=1))
    typer = typer or HLATyper(
        pkg, TyperConfig(min_reads_for_typing_workers=1), device="cpu")
    out = str(tmp_path / tag / "hla")
    typer.type_all(fq, aligned, rawu, unal, 260.0, 25.0, out,
                   n_workers=n_workers)
    return out


@needs_spawn
def test_parallel_typing_matches_serial(four_loci, tmp_path):
    """Per-locus typing in two worker processes writes every file the
    serial typer writes, byte for byte, and what the reference's typer
    writes with two workers on the same inputs (where the reference cannot
    spawn it types serially, into the same files)."""
    serial = _typed(four_loci, tmp_path, "serial", 1)
    par = _typed(four_loci, tmp_path, "par", 2)
    _typed(four_loci, tmp_path, "ref", 2, ref=True)
    _assert_runs_match(str(tmp_path / "par"), str(tmp_path / "ref"),
                       bestguess_bytes=False)
    names = _tree(serial)
    assert _tree(par) == names
    assert len([n for n in names if n.startswith("R1_")]) >= 8
    assert "histogram_matchesPerRead.txt" in names
    for name in sorted(names):
        assert filecmp.cmp(os.path.join(serial, name),
                           os.path.join(par, name), shallow=False), name


@needs_spawn
def test_a_failing_typing_worker_ends_the_run(four_loci, tmp_path,
                                              monkeypatch):
    """A worker that cannot reach its device raises in the parent: the
    typer does not quietly type serially instead (the reference does)."""
    pkg, _, _ = four_loci
    typer = HLATyper(pkg, TyperConfig(min_reads_for_typing_workers=1),
                     device="cpu")
    # the workers are told to type on a card, and this machine has none
    typer.device = torch.device("cuda")
    monkeypatch.setattr(_build, "library", lambda: None)
    with pytest.raises(RuntimeError, match="is_available"):
        _typed(four_loci, tmp_path, "failing", 2, typer=typer)
    assert not os.path.exists(
        tmp_path / "failing" / "hla" / "R1_bestguess.txt")


@needs_spawn
def test_parallel_aligner_packs_equal_the_serial_aligner(four_loci):
    """ParallelAligner's packed result holds exactly what the serial
    aligner's pairs pack to, its workers' counters sum to the serial
    aligner's, and unpaired reads come back in order; the packs also equal
    the reference's on the same reads (its ParallelAligner's where it can
    spawn, else its serial aligner's pairs through its own packer)."""
    pkg, fq, rawu = four_loci
    serial = ReadAligner(pkg, device="cpu")
    want = pack_aligned_pairs(serial.align_pairs(fq, 260, 25))
    want_u = serial.align_unpaired(rawu)
    par = ParallelAligner(pkg.dir, 2, device="cpu")
    try:
        got = par.align_pairs(fq, 260, 25)
        got_u = par.align_unpaired(rawu)
    finally:
        par.close()
    assert len(fq) > 256            # more than one chunk
    assert got.pack.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, str):
            assert got.pack[key] == value, key
        else:
            np.testing.assert_array_equal(got.pack[key], value, err_msg=key)
    assert [u.log_likelihood for u in got_u] == \
        [u.log_likelihood for u in want_u]
    for key in ("n_chain_extensions", "considered_chains",
                "considered_chain_pairs", "n_align_calls"):
        assert getattr(par.stats, key) == getattr(serial.stats, key), key
    assert par.stats.extras["nw_jobs_on_cpu"] == \
        par.stats.n_chain_extensions == serial.stats.n_chain_extensions
    if ref_parallel_host.spawn_safe():
        ref_par = ref_parallel_host.ParallelAligner(pkg.dir, 2)
        try:
            ref_pack = ref_par.align_pairs(fq, 260, 25).pack
            ref_u = ref_par.align_unpaired(rawu)
        finally:
            ref_par.close()
    else:
        ref_serial = RefAligner(pkg)
        ref_pack = ref_parallel_host.pack_aligned_pairs(
            ref_serial.align_pairs(fq, 260, 25))
        ref_u = ref_serial.align_unpaired(rawu)
    assert got.pack.keys() == ref_pack.keys()
    for key, value in ref_pack.items():
        if isinstance(value, str):
            assert got.pack[key] == value, key
        else:
            np.testing.assert_array_equal(got.pack[key], value, err_msg=key)
    assert [u.log_likelihood for u in got_u] == \
        [u.log_likelihood for u in ref_u]


def test_a_worker_takes_its_share_of_the_pointer_budget(four_loci,
                                                        monkeypatch):
    """n workers together pin what one process would: each divides the
    aligner's pointer budget by n, and builds the port's aligner on the
    device it was given."""
    from hla_la_tpu_torch.models import aligner, parallel_host
    pkg, _, _ = four_loci
    monkeypatch.setattr(aligner, "NW_POINTER_BUDGET", 1000)
    monkeypatch.setattr(parallel_host, "_WORKER_ALIGNER", None)
    parallel_host._init_worker(pkg.dir, None, 20, "", device="cpu",
                               n_workers=4)
    assert aligner.NW_POINTER_BUDGET == 250
    worker = parallel_host._WORKER_ALIGNER
    assert isinstance(worker, ReadAligner) and worker.device.type == "cpu"
    assert aligner.jobs_per_call(9, 5) == 5      # 250 // (10 * 5)


def test_spawn_safe_follows_the_main_module(monkeypatch, tmp_path):
    """Safe from a file that exists, from ``python -m`` and from a main
    module with no file to re-run (``python -c``); not from a main module
    whose file is gone (stdin), and never inside a worker."""
    import sys
    import types
    main = types.ModuleType("__main__")
    monkeypatch.setitem(sys.modules, "__main__", main)
    monkeypatch.delenv("HLA_LA_IN_WORKER", raising=False)
    assert spawn_safe()                          # no __file__ at all
    main.__file__ = str(tmp_path / "gone.py")
    assert not spawn_safe()
    (tmp_path / "gone.py").write_text("")
    assert spawn_safe()
    main.__file__ = "<stdin>"
    assert not spawn_safe()
    main.__spec__ = types.SimpleNamespace(name="hla_la_tpu_torch.__main__")
    assert spawn_safe()
    monkeypatch.setenv("HLA_LA_IN_WORKER", "1")
    assert not spawn_safe()


# ------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """More than 512 pairs, so --maxThreads starts its workers."""
    root = tmp_path_factory.mktemp("cli_world")
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
    write_fastq(str(root / "R_1.fq"), [p.r1.to_fastq() for p in pairs])
    write_fastq(str(root / "R_2.fq"), [p.r2.to_fastq() for p in pairs])
    common = ["--action", "HLA", "--graph", pkg.dir, "--sampleID", "S1",
              "--FASTQ1", str(root / "R_1.fq"), "--FASTQ2",
              str(root / "R_2.fq")]
    single = str(root / "single")
    assert port_main(common + ["--device", "cpu", "--outputDirectory",
                               single]) == 0
    return root, pkg, common, single


def _assert_same_files(got_dir, want_dir, skip=()):
    names = {n for n in _tree(want_dir) if not n.startswith(skip)}
    assert {n for n in _tree(got_dir) if not n.startswith(skip)} == names
    assert len(names) >= 10
    for name in sorted(names):
        assert _read(os.path.join(got_dir, name)) == \
            _read(os.path.join(want_dir, name)), name


@needs_spawn
def test_cli_max_threads_matches_one_process(cli_world, capfd):
    """--maxThreads 2: every file of the one-process run, byte for byte,
    and the reference CLI's --maxThreads 2 run as the whole-CLI parity
    test holds two runs equal."""
    root, _, common, single = cli_world
    out = str(root / "workers")
    assert port_main(common + ["--device", "cpu", "--outputDirectory", out,
                               "--maxThreads", "2"]) == 0
    log = capfd.readouterr().err
    assert "aligning with 2 worker processes on cpu" in log
    jobs = [int(line.split(":")[1]) for line in log.splitlines()
            if "n_chain_extensions" in line or "nw_jobs_on_cpu" in line]
    assert len(jobs) == 2 and jobs[0] == jobs[1] > 0
    _assert_same_files(out, single)
    ref_out = str(root / "ref_workers")
    assert ref_main(common + ["--outputDirectory", ref_out,
                              "--maxThreads", "2"]) == 0
    _assert_runs_match(out, ref_out)


def test_cli_shards_and_merge_match_one_process_and_the_reference(cli_world):
    """Two hosts each align their read slice (--nHosts/--hostIdx/
    --shardDir), then --mergeShards types from the shards: byte-equal to
    the one-process run, and equal to the reference's shard + merge as the
    whole-CLI parity test holds two runs equal."""
    root, pkg, common, single = cli_world
    merged = {}
    for tag, main, device in (("port", port_main, ["--device", "cpu"]),
                              ("ref", ref_main, [])):
        shard_dir = str(root / f"shards_{tag}")
        for host in ("0", "1"):
            assert main(common + device + [
                "--outputDirectory", str(root / f"{tag}_h{host}"),
                "--nHosts", "2", "--hostIdx", host,
                "--shardDir", shard_dir]) == 0
        assert sorted(os.listdir(shard_dir)) == ["align_shard_0of2.npz",
                                                 "align_shard_1of2.npz"]
        merged[tag] = str(root / f"merged_{tag}")
        assert main(["--action", "HLA", "--graph", pkg.dir, "--sampleID",
                     "S1", "--outputDirectory", merged[tag],
                     "--mergeShards", shard_dir] + device) == 0
    _assert_same_files(merged["port"], single)
    _assert_runs_match(merged["port"], merged["ref"])


def test_cli_shards_of_long_reads_match_one_process(tmp_path):
    """The unpaired half of a shard file (packed chains, the reads' input
    positions): long reads aligned as two shards and merged give every file
    of the one-process run, byte for byte."""
    from hla_la_tpu_torch.sim import long_read_world
    world = long_read_world(str(tmp_path / "w"), backbone=3000, n_alleles=12,
                            coverage=6.0, read_length=1200)
    common = ["--action", "HLA", "--graph", world.graph, "--sampleID", "S1",
              "--device", "cpu"]
    single = str(tmp_path / "single")
    assert port_main(common + world.cli_args()
                     + ["--outputDirectory", single]) == 0
    for host in ("0", "1"):
        assert port_main(common + world.cli_args() + [
            "--outputDirectory", str(tmp_path / f"h{host}"), "--nHosts", "2",
            "--hostIdx", host, "--shardDir", str(tmp_path / "sh")]) == 0
    merged = str(tmp_path / "merged")
    assert port_main(common + ["--longReads", "ont2d", "--outputDirectory",
                               merged, "--mergeShards",
                               str(tmp_path / "sh")]) == 0
    _assert_same_files(merged, single)


def test_cli_merge_refuses_an_incomplete_shard_set(cli_world, tmp_path):
    root, pkg, common, _ = cli_world
    assert port_main(common + ["--device", "cpu", "--outputDirectory",
                               str(tmp_path / "h1"), "--nHosts", "2",
                               "--hostIdx", "1", "--shardDir",
                               str(tmp_path / "sh")]) == 0
    with pytest.raises(SystemExit, match="incomplete shard set"):
        port_main(["--action", "HLA", "--graph", pkg.dir, "--device", "cpu",
                   "--outputDirectory", str(tmp_path / "m"),
                   "--mergeShards", str(tmp_path / "sh")])
    with pytest.raises(ValueError, match="hostIdx"):
        port_main(common + ["--device", "cpu", "--outputDirectory",
                            str(tmp_path / "h2"), "--nHosts", "2",
                            "--hostIdx", "2"])


@needs_spawn
@needs_8
def test_cli_sharded_switch_matches_one_process_and_the_reference(cli_world):
    """--sharded 4 (four gloo ranks: NW batches split over all of them, the
    pair reduction over the 2 x 2 mesh derived from their count, rank 0
    writing):
    every file byte-equal to the one-process run except the pair-posterior
    dumps, which hold the one-process values within the reduction's
    tolerance; and equal in the same sense to the reference's --backend
    sharded."""
    root, _, common, single = cli_world
    out = str(root / "sharded")
    assert port_main(common + ["--device", "cpu", "--outputDirectory", out,
                               "--sharded", "4"]) == 0
    _assert_runs_match(out, single)
    _assert_same_files(out, single, skip=("hla/R1_PP_",))
    ref_out = str(root / "ref_sharded")
    assert ref_main(common + ["--outputDirectory", ref_out, "--backend",
                              "sharded"]) == 0
    _assert_runs_match(out, ref_out)
