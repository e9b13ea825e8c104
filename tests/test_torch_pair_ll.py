"""The port's typing likelihood model on the CPU (the plain side of K3 and
the float32 matrix products) against the reference's numpy float64 path,
its XLA scan and its Pallas kernel in interpret mode, at the reference
tests' own tolerances."""

import numpy as np
import pytest
import torch

from hla_la_tpu.ops.pair_ll import (LOG_HALF, cluster_onehot,
                                    cluster_read_ll as ref_cluster_read_ll,
                                    pair_ll_reduction as ref_pair_ll_reduction,
                                    pair_ll_reduction_numpy)
from hla_la_tpu.ops.pallas_pair import pair_ll_reduction_pallas
from hla_la_tpu_torch.ops.pair_ll import (PLAIN_CELLS, cluster_read_ll,
                                          pair_ll_diff_plain,
                                          pair_ll_reduction, plain_chunk)

torch.set_num_threads(1)


def test_reduction_matches_numpy_f64_at_c520():
    """tests/test_imgt_scale.py:93-102's working point and bar."""
    L = np.random.default_rng(11).normal(-40, 8, (520, 120))
    want = pair_ll_reduction_numpy(L)
    got = pair_ll_reduction(L, "cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("C,R", [(9, 37), (19, 45), (64, 300)])
def test_reduction_matches_xla_scan(C, R):
    """tests/test_typer.py:95-101's bar against backend="jax"."""
    L = np.random.default_rng(C).normal(-30, 5, (C, R))
    want = ref_pair_ll_reduction(L, backend="jax")
    np.testing.assert_allclose(pair_ll_reduction(L, "cpu"), want,
                               rtol=1e-4, atol=1e-3)


def test_reduction_matches_pallas_interpret():
    """tests/test_typer.py:135-142's world and bar."""
    L = np.random.default_rng(5).normal(-30, 5, (19, 45))
    want = pair_ll_reduction_pallas(L, tc=8, tr=16)
    np.testing.assert_allclose(pair_ll_reduction(L, "cpu"), want,
                               rtol=1e-4, atol=1e-3)


def test_reduction_symmetric_and_tied_likelihoods():
    L = np.random.default_rng(6).normal(-40, 1, (30, 77))
    L[3] = L[4]                                   # d = 0 for one pair
    got = pair_ll_reduction(L, "cpu")
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_allclose(got, pair_ll_reduction_numpy(L),
                               rtol=1e-6, atol=1e-5)


def test_padding_cancels():
    """Zero-padded reads add log 2 each to the device term and LOG_HALF
    each to the host constant: the padded sum equals the unpadded one."""
    C, R = 11, 37
    L = np.random.default_rng(7).normal(-30, 5, (C, R)).astype(np.float32)
    acc, rpad = pair_ll_diff_plain(torch.from_numpy(L), chunk=16)
    assert rpad == 48
    acc_exact, rpad_exact = pair_ll_diff_plain(torch.from_numpy(L),
                                               chunk=R)
    assert rpad_exact == R
    np.testing.assert_allclose(
        acc.double().numpy() + LOG_HALF * rpad,
        acc_exact.double().numpy() + LOG_HALF * rpad_exact,
        rtol=0, atol=1e-3)
    np.testing.assert_allclose(pair_ll_reduction(L, "cpu"),
                               pair_ll_reduction_numpy(L),
                               rtol=1e-6, atol=1e-4)


def test_chunk_bound_at_c2000():
    """tests/test_imgt_scale.py:129-137: at C ~ 2000 the plain version's
    [C, C, chunk] intermediate stays ~0.5 GB."""
    C, R = 2000, 20000
    chunk = plain_chunk(C, R)
    assert chunk * C * C <= 1.4e8 and chunk * C * C <= PLAIN_CELLS
    assert chunk == 32
    assert plain_chunk(9, 5) == 5                # never wider than R
    assert plain_chunk(20000, 10) == 1           # and never below 1


def test_empty_inputs():
    assert pair_ll_reduction(np.zeros((0, 5)), "cpu").shape == (0, 0)
    np.testing.assert_array_equal(pair_ll_reduction(np.zeros((3, 0)), "cpu"),
                                  np.zeros((3, 3)))


def test_cluster_read_ll_matches_jax_on_toy():
    """The toy of tests/test_typer.py:104-124: exact."""
    onehot = cluster_onehot(["ACG_", "ACGT", "TCG*"])
    contrib = np.zeros((2, 4, 6), dtype=np.float32)
    mism = np.zeros((2, 4, 6), dtype=np.float32)
    contrib[0, 0, 0] = -1.0
    contrib[0, 0, 5] = -7.0
    contrib[1, 3, 4] = -2.0
    mism[0, 0, 5] = 1.0
    ll, mm = cluster_read_ll(onehot, contrib, mism, "cpu")
    ll_j, mm_j = ref_cluster_read_ll(onehot, contrib, mism, backend="jax")
    np.testing.assert_array_equal(ll, ll_j)
    np.testing.assert_array_equal(mm, mm_j)
    assert ll.dtype == np.float32 and ll.shape == (3, 2)
    assert (ll[0, 0], ll[2, 0], ll[0, 1], ll[1, 1]) == (-1.0, 0.0, -2.0, 0.0)
    assert mm.sum() == 0.0


def test_cluster_read_ll_matches_jax_random():
    rng = np.random.default_rng(8)
    C, J, R = 23, 40, 57
    seqs = ["".join(rng.choice(list("ACGT_*"), J)) for _ in range(C)]
    onehot = cluster_onehot(seqs)
    contrib = rng.normal(-1, 1, (R, J, 6)).astype(np.float32)
    mism = (rng.random((R, J, 6)) < 0.1).astype(np.float32)
    ll, mm = cluster_read_ll(onehot, contrib, mism, "cpu")
    ll_j, mm_j = ref_cluster_read_ll(onehot, contrib, mism, backend="jax")
    np.testing.assert_allclose(ll, ll_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(mm, mm_j)       # small integer sums
