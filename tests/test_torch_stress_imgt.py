"""stress_imgt.py's twin (``stress_imgt_torch.py``) against the JAX side
(its worlds: test_torch_imgt_worlds.py).

The twin runs in a process of its own with jax and hla_la_tpu blocked, on
the CPU, at 24 alleles, a backbone of 2,000 and 15x, with 2 workers, the
checks' floors cut to that size and the typing fan-out's gate lowered to
one read: once with ``--sharded`` on 2 ranks (its checks pass, the fan-out
is byte-identical), once with ``--long``.  Its serial typing output is held
to the JAX package's own one-process run on the same reads (``ReadAligner``
and ``HLATyper.type_all``): every file byte for byte, except the PP dumps
and bestguess tables, held value by value.  Its pair reductions, one device
and 2 gloo ranks, are held to ``pair_ll_reduction(L, backend="jax")``."""

import os

import numpy as np
import pytest
import torch

from hla_la_tpu_torch import sim as port_sim
from hla_la_tpu_torch.sim import worlds as port_worlds
from test_torch_real_scale import run_twin
from test_torch_stress_wgs import assert_same_typing_output

torch.set_num_threads(1)
N_ALLELES, BACKBONE, COVERAGE = 24, 2000, 15.0
TWIN_PATCHES = {"N_ALLELES": N_ALLELES, "COVERAGE": COVERAGE,
                "BACKBONE": BACKBONE, "MAX_WORKERS": 2, "C_MIN": 2,
                "READS_PER_EXON": 20, "SHARDED_RANKS": 2,
                "TYPER_CFG": "TyperConfig(min_reads_for_typing_workers=1)"}


@pytest.fixture(scope="module")
def imgt_twin(tmp_path_factory):
    """(record of the --sharded run, record of the --long run, cache)."""
    cache = str(tmp_path_factory.mktemp("stress_imgt"))
    setup = "from hla_la_tpu_torch.utils.config import TyperConfig"
    patches = {"CACHE": repr(cache), **TWIN_PATCHES}
    runs = []
    for flags, ok in ((["--sharded"], "STRESS_IMGT OK"),
                      (["--long"], "STRESS_IMGT_LONG OK")):
        lines, rec = run_twin("stress_imgt_torch", patches,
                              ["--device", "cpu", *flags], setup=setup)
        assert lines[-2] == ok
        runs.append(rec)
    return runs[0], runs[1], cache


def test_stress_imgt_torch_on_the_cpu(imgt_twin):
    rec, long_rec, _ = imgt_twin
    assert {"mode", "genes", "alleles", "pairs", "pairs_aligned",
            "align_workers", "pool_ready_s", "align_s", "reads_per_s",
            "type_serial_s", "type_fanout_s", "fanout_ran",
            "typing_workers", "fanout_gate", "typing_worker_runs", "files",
            "peak_rss_gb", "C_max", "R_max", "launches_parent",
            "launches_workers", "n_chain_extensions", "nw_jobs_on_cpu",
            "loci", "calls", "sharded", "pair_reduction", "device",
            "card"} <= set(rec)
    assert rec["mode"] == "default" and rec["genes"] == ["A", "B"]
    assert rec["nw_jobs_on_cpu"] == rec["n_chain_extensions"] > 0
    assert rec["pairs_aligned"] > 0.95 * rec["pairs"] > 200
    # the gate lowered to one read: the fan-out ran, over both loci
    assert rec["fanout_ran"] and rec["fanout_gate"] == [1, 2]
    assert rec["fanout_gate_lowered"] and 1 <= rec["typing_workers"] <= 2
    assert sorted(lc for run in rec["typing_worker_runs"]
                  for lc in run["loci"]) == ["A", "B"]
    assert all(0 < run["ready_s"] <= run["done_s"]
               for run in rec["typing_worker_runs"])
    assert rec["files"] >= 10
    assert rec["launches_workers"] == {"K1": 0, "K3": 0}
    # the align and typing workers are host-only: none imported torch, and
    # the align pool's device server ran every NW job they counted
    assert len(rec["workers_torch_imported"]) >= 2
    assert not any(rec["workers_torch_imported"] +
                   rec["workers_cuda_initialized"])
    assert rec["served"]["nw_jobs"] == rec["n_chain_extensions"]
    sh = rec["sharded"]
    assert sh["ranks"] == 2 and sh["mesh"] == "2x1" and sh["backend"] == "gloo"
    assert [r["reads"] for r in sh["per_rank"]] == \
        [[0, rec["R_max"] // 2], [rec["R_max"] // 2, rec["R_max"]]]
    assert sh["vs_one_device_max_abs"] <= 1e-2
    pr = rec["pair_reduction"]
    assert (pr["C"], pr["R"]) == (rec["C_max"], rec["R_max"])
    assert pr["numpy_s_is"] == "measured"       # R under the slice's 512
    assert pr["k3_vs_numpy_slice_max_abs"] <= 1e-4 + 1e-6 * 1e4

    assert long_rec["mode"] == "long" and long_rec["aligned"] >= \
        0.9 * long_rec["reads"] > 40
    assert long_rec["nw_jobs_on_cpu"] == long_rec["n_chain_extensions"] > 0
    assert 1500 <= long_rec["longest_read"] <= 4000
    for locus, (a1, a2) in long_rec["calls"].items():
        called = set(a1.split(";")) | set(a2.split(";"))
        assert {f"{locus}*02:01", f"{locus}*03:01"} <= called, locus


def test_stress_imgt_torch_agrees_with_the_jax_package(imgt_twin, tmp_path):
    """The JAX package's own one-process run (its ReadAligner, then its
    HLATyper.type_all serially, as stress_imgt.py types) on the twin's
    world: the same pairs aligned and the same typing output."""
    from hla_la_tpu.graph.package import GraphPackage
    from hla_la_tpu.models.aligner import ReadAligner
    from hla_la_tpu.models.typer import HLATyper
    rec, _, cache = imgt_twin
    world = port_sim.typing_world(cache, N_ALLELES, COVERAGE, BACKBONE)
    fq = [(a, b) for a, b in zip(port_worlds.read_fastq(world.fastq1),
                                 port_worlds.read_fastq(world.fastq2))]
    assert len(fq) == rec["pairs"]
    pkg = GraphPackage(world.graph)
    aligned = ReadAligner(pkg).align_pairs(fq, 100, 25)
    aligned = [ap for ap in aligned if ap is not None]
    assert len(aligned) == rec["pairs_aligned"]
    ids = {ap.read_id for ap in aligned}
    kept = [p for p in fq if p[0].name in ids]
    out = str(tmp_path / "jax_out")
    HLATyper(pkg).type_all(kept, aligned, [], [], 100.0, 25.0, out,
                           n_workers=1)
    assert_same_typing_output(os.path.join(os.path.dirname(world.graph),
                                           "out"), out, 2)


def test_pair_reductions_agree_with_the_jax_reduction():
    """time_pair_reduction (K3's plain version on the CPU, native, numpy)
    and time_sharded_reduction on 2 gloo ranks, at C = 70 (two tile rows)
    and R = 300, against the JAX package's XLA reduction."""
    import stress_imgt_torch as twin
    from hla_la_tpu.ops.pair_ll import pair_ll_reduction
    L = twin.reduction_input(70, 300)
    want = pair_ll_reduction(L, backend="jax")
    rec, got = twin.time_pair_reduction(L, "cpu")
    assert np.allclose(got, want, rtol=1e-6, atol=1e-2)
    assert rec["numpy_s_is"] == "measured" and rec["numpy_slice_R"] == 300
    rec, got = twin.time_sharded_reduction(L, "cpu", ranks=2)
    assert np.allclose(got, want, rtol=1e-6, atol=1e-2)
    assert rec["backend"] == "gloo" and rec["mesh"] == "2x1"
    assert [r["tile_range"] for r in rec["per_rank"]] == [[0, 3], [0, 3]]
    assert [r["launches"] for r in rec["per_rank"]] == [0, 0]
