"""The port's real-PRG-scale worlds against the JAX scripts that define
them, and bench.py's twin on the CPU.

Each world recipe of ``hla_la_tpu_torch/sim/worlds.py`` (``bench_world``,
``wgs_world``, ``long_bench_reads``) is held to its script's own recipe
(``bench.build_real_scale_cache``, ``stress_wgs.build_cache``,
``stress_long.build_reads``), run with the scripts' module attributes
patched to a cut backbone and a temporary cache: the packages byte for
byte, the reads (names, sequences, qualities) and their truth levels
equal.  Sizes (the least at which each recipe runs and ends): the bench
and WGS recipes at 60,000 levels (17 loci of 240 columns); the long-read
recipe at 1,000,000 levels and 0.5x, its windows of 50,000 bases too short
for the 60-90 kb reads, which the recipe then skips, as the script does.

``bench_torch.py`` runs in a process of its own with jax and hla_la_tpu
blocked in ``sys.modules``, on the CPU, at 300,000 levels (~3,000 pairs;
at less the 1x reads leave a locus too thin for exact calls), with 2
workers and in one process, one measured pass each, on one build of the
world shared by the module: its gates (truth accuracy over 0.95, exact
calls) pass and its JSON line holds every key.  The one-process run is held
to bench.py's own ``real_scale_bench`` on the same world (one process, one
pass each): the same aligned pairs, truth accuracy and calls.  The twins of
stress_wgs.py and stress_long.py are in test_torch_stress_wgs.py and
test_torch_stress_long.py."""

import ast
import filecmp
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hla_la_tpu_torch import sim as port_sim

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_package(got, want):
    names = _tree(want)
    assert _tree(got) == names and len(names) >= 10
    for name in names:
        assert filecmp.cmp(os.path.join(got, name), os.path.join(want, name),
                           shallow=False), name


def _raw_pairs(world):
    return [((a.name, a.seq, a.qual), (b.name, b.seq, b.qual))
            for a, b in world.pairs()]


def test_bench_world_is_bench_py_recipe(tmp_path, monkeypatch):
    import bench
    n = 60_000
    monkeypatch.setattr(bench, "CACHE", str(tmp_path / "ref"))
    monkeypatch.setattr(bench, "N_LEVELS", n)
    bench.build_real_scale_cache()
    world = port_sim.bench_world(str(tmp_path / "port"), n_levels=n)
    _same_package(world.graph, str(tmp_path / "ref" / "pkg"))
    with open(tmp_path / "ref" / "pairs.pkl", "rb") as fh:
        assert _raw_pairs(world) == pickle.load(fh)
    with open(tmp_path / "ref" / "truth.pkl", "rb") as fh:
        want = pickle.load(fh)
    got = port_sim.load_levels(world.truth_levels)
    assert got.keys() == want.keys() and len(got) > 1000
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert world.truth == {"A": ["A*02:01", "A*03:01"],
                           "B": ["B*02:01", "B*03:01"]}
    # cached: a second call builds nothing
    assert port_sim.bench_world(str(tmp_path / "port"), n_levels=n) == world


def test_wgs_world_is_stress_wgs_recipe(tmp_path, monkeypatch):
    import stress_wgs
    n, coverage = 60_000, 2.0
    monkeypatch.setattr(stress_wgs, "CACHE", str(tmp_path / "ref"))
    monkeypatch.setattr(stress_wgs, "N_LEVELS", n)
    stress_wgs.build_cache(coverage)
    world = port_sim.wgs_world(str(tmp_path / "port"), coverage, n_levels=n)
    _same_package(world.graph, str(tmp_path / "ref" / "pkg"))
    with open(tmp_path / "ref" / "pairs.pkl", "rb") as fh:
        assert _raw_pairs(world) == pickle.load(fh)
    assert sorted(world.truth) == sorted(stress_wgs.GENES)
    assert port_sim.worlds.WGS_GENES == stress_wgs.GENES
    assert all(world.truth[lc] == [f"{lc}*02:01", f"{lc}*03:01"]
               for lc in world.truth)


def test_long_bench_reads_are_stress_long_recipe(tmp_path, monkeypatch):
    import stress_long
    n, coverage = 1_000_000, 0.5
    monkeypatch.setattr(stress_long, "N_LEVELS", n)
    monkeypatch.setattr(stress_long, "COVERAGE", coverage)
    want = stress_long.build_reads()
    reads = port_sim.long_bench_reads(str(tmp_path), n, coverage)
    got = list(port_sim.worlds.read_fastq(reads.fastq))
    assert [(r.name, r.seq, r.qual) for r in got] == \
        [(r.name, r.seq, r.qual) for r in want]
    levels = port_sim.load_levels(reads.truth_levels)
    assert list(levels) == [r.name for r in want]
    assert all(np.array_equal(levels[r.name], r.levels) for r in want)
    assert len(want) >= 4 and any(r.reverse for r in want)
    assert reads.truth == {"A": ["A*02:01", "A*03:01"],
                           "B": ["B*02:01", "B*03:01"]}
    # the panel's package, written beside the reads: bench_world's
    assert port_sim.worlds.GraphPackage(reads.graph).prg().n_levels >= n
    # the truth of split reads, as stress_long.py cuts it
    long_levels = {"r": np.arange(120_000), "s": np.arange(10)}
    split = port_sim.split_levels(long_levels)
    assert list(split) == ["r:::chunk0", "r:::chunk1", "r:::chunk2", "s"]
    assert np.array_equal(split["r:::chunk2"], np.arange(100_000, 120_000))


def run_twin(module: str, patches: dict, argv: list, setup: str = "",
             timeout: float = 900) -> tuple[list[str], dict]:
    """`module`.main(argv) in a process of its own with jax and hla_la_tpu
    blocked in sys.modules and the module's attributes `patches` set;
    returns its stdout lines and the JSON object of its last line."""
    code = "\n".join(
        ["import sys", "sys.modules['jax'] = None",
         "sys.modules['hla_la_tpu'] = None", "import torch",
         "torch.set_num_threads(1)", setup, f"import {module} as m"]
        + [f"m.{k} = {v}" for k, v in patches.items()]
        + [f"sys.exit(m.main({argv!r}))"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "cpu"            # the card's line comes first
    return lines, json.loads(lines[-1])


BENCH_LEVELS = 300_000


@pytest.fixture(scope="module")
def bench_twin(tmp_path_factory):
    """workers -> (stdout lines, JSON record) of bench_torch.py on the CPU
    at BENCH_LEVELS, one measured pass each; the world is built once, here,
    and every run (and bench.py's, through ``world``) reads that build."""
    cache = str(tmp_path_factory.mktemp("bench"))
    world = port_sim.bench_world(cache, BENCH_LEVELS)
    runs = {}

    def run(workers):
        if workers not in runs:
            runs[workers] = run_twin("bench_torch", {
                "CACHE": repr(cache), "N_LEVELS": BENCH_LEVELS,
                "MAX_WORKERS": 2, "ALIGN_WARMUP": 0, "ALIGN_REPS": 1,
                "TYPE_WARMUP": 0, "TYPE_REPS": 1},
                ["--device", "cpu", "--workers", str(workers)])
        return runs[workers]
    run.world = world
    return run


@pytest.mark.parametrize("workers", [2, 1])
def test_bench_torch_on_the_cpu(bench_twin, workers):
    """2: a worker pool (the default is min(CPUs, 8)); 1: this process
    alone, bench.py's other engine and the run to profile by layer."""
    lines, rec = bench_twin(workers)
    assert rec["metric"] == "e2e_reads_per_sec_real_prg_scale"
    assert {"value", "unit", "median", "best", "window_reads_per_s",
            "align_reads_per_s", "window", "reps", "init_s", "warmup_reps",
            "n_reads", "n_levels", "workers", "pairs_aligned",
            "truth_accuracy", "calls", "launches_workers", "launches_parent",
            "n_chain_extensions", "nw_jobs_on_cpu", "device",
            "card"} <= set(rec)
    assert rec["n_levels"] == BENCH_LEVELS and rec["workers"] == workers
    assert rec["truth_accuracy"] > 0.95
    assert rec["nw_jobs_on_cpu"] == rec["n_chain_extensions"] > 0
    assert all(len(v) == 1 for v in rec["reps"].values())
    assert rec["warmup_reps"] == {"align_s": [], "type_s": []}
    assert rec["median"] > 0 and rec["n_reads"] > 5000
    # one measured pass each: the window's mean is its median
    assert rec["window_reads_per_s"] == rec["median"]
    # no kernel launches on the CPU: every wrapper took its plain version
    assert rec["launches_workers"] == {"K1": 0, "K3": 0}
    # a pool's workers are host-only; one process has none
    assert len(rec["workers_torch_imported"]) == (0 if workers == 1 else 2)
    assert not any(rec["workers_torch_imported"] +
                   rec["workers_cuda_initialized"])


# bench.py in one process (one CPU: its ReadAligner engine), with JAX on
# the CPU and the measurement cut to one pass each, on the world of
# `cache`; its result on stdout, its log on stderr
BENCH_PY_RUNNER = """import json, os, sys
sys.path.insert(0, {repo!r})
os.cpu_count = lambda: 1
import jax
jax.config.update("jax_platforms", "cpu")
import bench
bench.CACHE, bench.N_LEVELS = {cache!r}, {n_levels}
bench.ALIGN_WARMUP, bench.ALIGN_REPS = 0, 1
bench.TYPE_WARMUP, bench.TYPE_REPS = 0, 1
if __name__ == "__main__":
    print(json.dumps(bench.real_scale_bench()))
"""


def test_bench_torch_agrees_with_bench_py(bench_twin, tmp_path):
    """bench.py's own real_scale_bench on the same world, in bench.py's
    cache layout: the package, the pairs and the truth levels that
    ``build_real_scale_cache`` writes (test_bench_world_is_bench_py_recipe
    holds the two recipes equal).  The twin's one-process run aligns the
    same number of pairs, at the same truth accuracy (bench.py logs four
    decimals), and calls the same alleles."""
    world = bench_twin.world
    cache = tmp_path / "bench_py"
    shutil.copytree(world.graph, cache / "pkg")
    with open(cache / "pairs.pkl", "wb") as fh:
        pickle.dump(_raw_pairs(world), fh)
    with open(cache / "truth.pkl", "wb") as fh:
        pickle.dump(port_sim.load_levels(world.truth_levels), fh)
    runner = tmp_path / "run_bench_py.py"
    runner.write_text(BENCH_PY_RUNNER.format(
        repo=str(REPO), cache=str(cache), n_levels=BENCH_LEVELS))
    proc = subprocess.run([sys.executable, str(runner)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=900,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.splitlines()[-1])
    log = proc.stderr
    aligned, n_pairs, accuracy = re.search(
        r"aligned (\d+)/(\d+) pairs, truth accuracy ([\d.]+)", log).groups()
    calls = ast.literal_eval(re.search(r"calls (\{.*\})", log).group(1))

    _, rec = bench_twin(1)
    assert rec["n_reads"] == want["n_reads"] == 2 * int(n_pairs)
    assert rec["pairs_aligned"] == int(aligned)
    assert f"{rec['truth_accuracy']:.4f}" == accuracy
    assert {k: tuple(v) for k, v in rec["calls"].items()} == calls
    assert {k: set(v) for k, v in calls.items()} == \
        {k: set(v) for k, v in world.truth.items()}
