"""bench_scaling.py's twin (``bench_scaling_torch.py``) on the CPU, against
the JAX package's ``full_step``.

At cut sizes (B0 = 16 reads of L = 24 per data rank at a band of 8,
C = 70 clusters, two tile rows of K3, K = 32), ``scaling("cpu", (1, 2,
4))`` starts each rank count's gloo ranks once through ``run_ranks`` (4
ranks: model 2 x data 2).  Each count's NW scores are bit-equal to the JAX
``full_step`` on a 1 x 1 CPU mesh on the same inputs, and its pair matrix
is within rtol 1e-6 / atol 1e-2 of it; its line holds bench_scaling.py's
keys plus cards, ranks_per_card and backend."""

import numpy as np
import pytest
import torch

import bench_scaling_torch as twin

torch.set_num_threads(1)
CUT = {"B0": 16, "L": 24, "W": 8, "C": 70, "K": 32}


@pytest.fixture(scope="module")
def scaling_runs():
    saved = {k: getattr(twin, k) for k in CUT}
    for k, v in CUT.items():
        setattr(twin, k, v)
    try:
        yield twin.scaling("cpu", (1, 2, 4))
    finally:
        for k, v in saved.items():
            setattr(twin, k, v)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_scaling_step_agrees_with_the_jax_full_step(scaling_runs, index):
    from hla_la_tpu.parallel.mesh import full_step, make_mesh
    run = scaling_runs[index]
    n = (1, 2, 4)[index]
    assert run["devices"] == n
    assert run["mesh"] == {1: "1x1", 2: "2x1", 4: "2x2"}[n]
    reads, lens, refs, onehot, contrib = run["inputs"]
    assert reads.shape == (CUT["B0"] * int(run["mesh"][0]), CUT["L"])
    scores, pair = run["out"]
    want_scores, want_pair = full_step(make_mesh(1, 1), CUT["L"], CUT["W"])(
        reads, lens, refs, onehot, contrib)
    assert np.array_equal(scores, np.asarray(want_scores))
    assert np.allclose(pair, np.asarray(want_pair), rtol=1e-6, atol=1e-2)
    assert {"devices", "mesh", "platform", "reads_per_sec",
            "scaling_efficiency", "total_speedup_vs_1dev", "cards",
            "ranks_per_card", "backend", "physical_cores",
            "core_bound", "note"} <= set(run)
    assert run["platform"] == "cpu" and run["backend"] == "gloo"
    assert run["cards"] == 0 and run["ranks_per_card"] is None
    assert run["reads_per_sec"] > 0 and run["pair_max_abs_err"] <= 1e-2
    assert "not scaling across cards" in run["note"]
    assert len(run["launches_per_rank"]) == n
