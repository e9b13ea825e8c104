"""tpu_e2e.py's twin (``e2e_torch.py``) and its world against the JAX
package, on the CPU.

The world (``sim.e2e_world``) is held to tpu_e2e.py's recipe drawn through
``hla_la_tpu.sim`` (seed 30303, 6 haplotypes, SNPs at 1%, 100 bp pairs at
20x along haplotypes 1 and 2): the package byte for byte, the pairs by
name, sequence and quality.  At the script's 20,000 levels the three runs
of the twin and the JAX run take about two minutes, so the backbone is cut
to 10,000 through the twin's BACKBONE; the pair reduction's shape is cut to
C = 70, R = 300 through PAIR_SHAPE.  The twin runs in a process of its own
with jax and hla_la_tpu blocked (``--device cpu``: no health gate, every
run on the CPU): identical calls over its three runs, the record written to
``--out`` and printed last.  Its host run's calls equal the JAX
``run_hla_typing(backend="numpy")`` calls on the same pairs, Q within
1e-3."""

import json
import os

import numpy as np
import pytest
import torch

from hla_la_tpu_torch import sim as port_sim
from hla_la_tpu_torch.sim import worlds as port_worlds
from test_torch_real_scale import _same_package, run_twin

torch.set_num_threads(1)
BACKBONE = 10_000


@pytest.fixture(scope="module")
def e2e_twin(tmp_path_factory):
    """(stdout lines, record, cache, --out path) of the twin's CPU run."""
    cache = str(tmp_path_factory.mktemp("e2e"))
    out = os.path.join(cache, "record", "e2e.json")
    lines, rec = run_twin(
        "e2e_torch", {"CACHE": repr(cache), "BACKBONE": BACKBONE,
                      "PAIR_SHAPE": (70, 300)},
        ["--device", "cpu", "--out", out])
    return lines, rec, cache, out


def _jax_recipe(backbone):
    """tpu_e2e.py:89-100 at `backbone`, through the JAX package."""
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator
    rng = np.random.default_rng(30303)
    sim = simulate_prg_package(rng, backbone_length=backbone, n_haplotypes=6,
                               snp_rate=0.01)
    rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                       fragment_sd=25, with_error=True)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 20.0,
                                               name_prefix=f"h{h}")
    return sim, [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]


def test_e2e_world_is_tpu_e2e_recipe(tmp_path):
    """A world of its own: a run leaves caches in the package it reads."""
    assert (port_worlds.E2E_SEED, port_worlds.E2E_BACKBONE,
            port_worlds.E2E_HAPLOTYPES, port_worlds.E2E_COVERAGE) == \
        (30303, 20_000, 6, 20.0)
    world = port_sim.e2e_world(str(tmp_path / "port"), BACKBONE)
    sim, want = _jax_recipe(BACKBONE)
    sim.write_package(str(tmp_path / "pkg"))
    _same_package(world.graph, str(tmp_path / "pkg"))
    got = list(zip(port_worlds.read_fastq(world.fastq1),
                   port_worlds.read_fastq(world.fastq2)))
    assert [((a.name, a.seq, a.qual), (b.name, b.seq, b.qual))
            for a, b in got] == \
        [((a.name, a.seq, a.qual), (b.name, b.seq, b.qual)) for a, b in want]
    assert world.truth == {"A": ["A*02:01", "A*03:01"],
                           "B": ["B*02:01", "B*03:01"]}


def test_e2e_torch_on_the_cpu(e2e_twin):
    lines, rec, _, out = e2e_twin
    # tpu_e2e.py's keys, with its chip's name read as the device's
    assert {"date", "chip_health", "forced_on_degraded_chip",
            "kernel_gcells_per_s", "world", "host_e2e_s",
            "device_e2e_cold_s", "device_e2e_warm_s",
            "reads_per_s_device_warm", "calls_identical", "calls", "note",
            "pair_C", "pair_R", "pair_s", "pair_cold_s", "pair_gcells_per_s",
            "device", "card"} <= set(rec)
    assert rec["card"] == "cpu" and rec["kernel_gcells_per_s"] is None
    assert rec["world"]["levels"] == BACKBONE and rec["world"]["loci"] == 2
    assert rec["calls_identical"] and rec["max_abs_dq1"] <= 1e-3
    assert (rec["pair_C"], rec["pair_R"]) == (70, 300)
    with open(out) as fh:
        assert json.load(fh) == rec


def test_e2e_torch_agrees_with_jax_run_hla_typing(e2e_twin, tmp_path):
    from hla_la_tpu.graph.package import GraphPackage
    from hla_la_tpu.models.pipeline import run_hla_typing
    _, rec, cache, _ = e2e_twin
    world = port_sim.e2e_world(cache, BACKBONE)
    fq = list(zip(port_worlds.read_fastq(world.fastq1),
                  port_worlds.read_fastq(world.fastq2)))
    assert len(fq) == rec["world"]["pairs"]
    res = run_hla_typing(GraphPackage(world.graph), pairs=fq,
                         output_dir=str(tmp_path / "jax"),
                         backend="numpy").results
    assert sorted([r.locus, r.allele1_id, r.allele2_id] for r in res) == \
        rec["calls"]
    with open(os.path.join(cache, "runs", "host", "hla",
                           "R1_bestguess.txt")) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()[1:]]
    q1 = {(row[0], row[1]): float(row[3]) for row in rows}
    for r in res:
        assert abs(q1[(r.locus, "1")] - r.q1_allele1) <= 1e-3
        assert abs(q1[(r.locus, "2")] - r.q1_allele2) <= 1e-3
