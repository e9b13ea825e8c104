"""stress_wgs.py's twin (``stress_wgs_torch.py``) on the CPU, in a process
of its own with jax and hla_la_tpu blocked in ``sys.modules``: at 1,000,000
levels and a diploid coverage of 2 (~9,800 pairs, 17 loci; at less, allele
rows of the short exons tie and a locus is called with a tied list, which
the twin's exact-call check rightly refuses), with 2 workers and the typing
fan-out's gate lowered (its real gate, 50,000 aligned reads, is for the
card: chip_smoke (x)).  Its checks pass (exact calls at all 17 loci, the
fan-out's files byte-identical to the serial run's, every NW job on the
CPU) and its JSON line holds every key.

The twin runs once for the module; stress_wgs.py's own ``main`` then runs
on the same world (2 workers, JAX on the CPU), in its cache layout, and
its serial typing output is held to the twin's: the same files, each byte
for byte but the pair-posterior dumps and the bestguess tables, held value
by value (their likelihoods come from different float32 reductions: P and
Q within 1e-6, LL within the pair reduction's rtol 1e-6 / atol 1e-2, every
other field equal).  Measured at this size: Q at most 4e-12 apart.  ~2.5
min for the two runs."""

import os
import pickle
import shutil
import subprocess
import sys

import pytest

from hla_la_tpu_torch import sim as port_sim
from test_torch_real_scale import REPO, _raw_pairs, run_twin

N_LEVELS, COVERAGE = 1_000_000, 2.0
Q_COLS = (3, 4)          # Q1, Q2 of the bestguess tables


@pytest.fixture(scope="module")
def wgs_twin(tmp_path_factory):
    """(stdout lines, JSON record, cache directory) of the twin's run."""
    cache = str(tmp_path_factory.mktemp("wgs"))
    lines, rec = run_twin(
        "stress_wgs_torch",
        {"CACHE": repr(cache), "N_LEVELS": N_LEVELS,
         "MAX_WORKERS": 2,
         "TYPER_CFG": "TyperConfig(min_reads_for_typing_workers=1, "
                      "min_loci_for_typing_workers=2)"},
        ["--device", "cpu", "--coverage", f"{COVERAGE:g}"],
        setup="from hla_la_tpu_torch.utils.config import TyperConfig")
    return lines, rec, cache


def test_stress_wgs_torch_on_the_cpu(wgs_twin):
    lines, rec, _ = wgs_twin
    assert lines[-2] == "STRESS_WGS OK"
    assert {"coverage", "n_levels", "workers", "pairs", "pairs_aligned",
            "align_s", "reads_per_s", "type_serial_s", "type_fanout_s",
            "typing_workers", "files", "fanout_gate", "launches_parent",
            "launches_workers", "n_chain_extensions", "nw_jobs_on_cpu",
            "loci", "device", "card"} <= set(rec)
    assert len(rec["loci"]) == 17 and rec["typing_workers"] == 2
    assert rec["fanout_gate"] == [1, 2]
    assert rec["pairs_aligned"] > 0.95 * rec["pairs"] > 9000
    assert rec["nw_jobs_on_cpu"] == rec["n_chain_extensions"] > 0
    assert rec["files"] >= 17
    # host-only align and typing workers, served by the parent
    assert len(rec["workers_torch_imported"]) >= 3
    assert not any(rec["workers_torch_imported"] +
                   rec["workers_cuda_initialized"])
    assert rec["served"]["nw_jobs"] == rec["n_chain_extensions"]


# stress_wgs.py's main with two CPUs (a pool of 2 workers), on the world
# of `cache`; the script sets JAX on the CPU itself
STRESS_WGS_RUNNER = """import os, sys
sys.path.insert(0, {repo!r})
os.cpu_count = lambda: 2
import stress_wgs
stress_wgs.CACHE, stress_wgs.N_LEVELS = {cache!r}, {n_levels}
if __name__ == "__main__":
    sys.argv = ["stress_wgs.py", "--coverage", "{coverage:g}"]
    stress_wgs.main()
"""


def _table(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def _pp_table(path):
    """ClusterID -> (P, LL, Mismatches_avg) of a pair-posterior dump."""
    rows = _table(path)
    assert rows[0] == ["ClusterID", "P", "LL", "Mismatches_avg"]
    return {r[0]: tuple(float(x) for x in r[1:]) for r in rows[1:]}


def test_stress_wgs_torch_agrees_with_stress_wgs_py(wgs_twin, tmp_path):
    """stress_wgs.py's own main on the twin's world, in the layout its
    ``build_cache`` writes (test_wgs_world_is_stress_wgs_recipe holds the
    two recipes equal): its checks pass, and its serial output is the
    twin's, file for file."""
    _, rec, port_cache = wgs_twin
    world = port_sim.wgs_world(port_cache, COVERAGE, N_LEVELS)
    cache = tmp_path / "stress_wgs_py"
    shutil.copytree(world.graph, cache / "pkg")
    with open(cache / "pairs.pkl", "wb") as fh:
        pickle.dump(_raw_pairs(world), fh)
    runner = tmp_path / "run_stress_wgs_py.py"
    runner.write_text(STRESS_WGS_RUNNER.format(
        repo=str(REPO), cache=str(cache), n_levels=N_LEVELS,
        coverage=COVERAGE))
    proc = subprocess.run([sys.executable, str(runner)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=900,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "STRESS_WGS OK"
    assert f"({rec['pairs_aligned']}/{rec['pairs']} pairs aligned)" in \
        proc.stderr

    assert_same_typing_output(
        os.path.join(port_cache, "wgs_runs", "out_serial"),
        cache / "out_serial", 17)


def assert_same_typing_output(got_dir, want_dir, n_loci: int) -> None:
    """Two typing runs' output directories hold the same files, each byte
    for byte but the pair-posterior dumps and the bestguess tables, held
    value by value: P and Q within 1e-6, LL within the pair reduction's
    rtol 1e-6 / atol 1e-2, every other field equal."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and len(names) >= n_loci
    n_pp = 0
    for name in names:
        got, want = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if "_PP_" in name:
            g, w = _pp_table(got), _pp_table(want)
            assert g.keys() == w.keys() and w, name
            for key, (p, ll, mm) in w.items():
                assert abs(g[key][0] - p) <= 1e-6, (name, key)
                assert abs(g[key][1] - ll) <= 1e-2 + 1e-6 * abs(ll)
                assert g[key][2] == mm, (name, key)
            n_pp += 1
        elif "bestguess" in name:
            g, w = _table(got), _table(want)
            assert len(g) == len(w) and g[0] == w[0], name
            # two rows per locus (bestguess_G may hold its header alone)
            assert name != "R1_bestguess.txt" or len(w) == 1 + 2 * n_loci
            for gr, wr in zip(g[1:], w[1:]):
                assert len(gr) == len(wr), (name, gr, wr)
                for i, (a, b) in enumerate(zip(gr, wr)):
                    if i in Q_COLS:
                        assert abs(float(a) - float(b)) <= 1e-6, (name, gr)
                    else:
                        assert a == b, (name, gr, wr)
        else:
            with open(got, "rb") as a, open(want, "rb") as b:
                assert a.read() == b.read(), name
    assert n_pp == n_loci
