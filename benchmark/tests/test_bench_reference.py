"""The plain reference on hand cases, against the port's plain versions,
and its control one precision below."""

import math

import numpy as np
import pytest
import torch

from hlabench import check, reference

SC = {"match": 2.0, "mismatch": -5.0, "gap_open": -6.0, "gap_extend": -2.0}
CODE = {c: i for i, c in enumerate("ACGTN")}


def enc(s):
    return np.array([[CODE[c] for c in s]], dtype=np.uint8)


def test_nw_exact_match_on_a_shifted_diagonal():
    score, k, st, ptr = reference.nw_forward(enc("ACGT"), np.array([4]),
                                             enc("TTACGTTT"), SC)
    assert score[0] == 8.0 and k[0] == 2 and st[0] == 0
    assert ptr.shape == (1, 5, 4)


def test_nw_one_mismatch_and_one_deletion():
    # ACGT with its G read as T: the mismatch (2 + 2 - 5 + 2 = 1) loses to
    # skipping the ref's G and matching the next T (2 + 2 - 6 + 2 + 2)
    s, _, _, _ = reference.nw_forward(enc("ACTT"), np.array([4]),
                                      enc("TTACGTTT"), SC)
    assert s[0] == 2
    # one mismatch inside a longer read: a pair of gaps would cost more
    s, _, _, _ = reference.nw_forward(enc("ACGTACGT"), np.array([8]),
                                      enc("TTACGAACGTTT"), SC)
    assert s[0] == 7 * 2 - 5
    # read ACGT against ACXGT: a gap of one ref base costs -6
    s, _, _, _ = reference.nw_forward(enc("ACGTAC"), np.array([6]),
                                      enc("ACAGTACTTT"), SC)
    assert s[0] == 12 - 6


def test_nw_ref_pad_is_unalignable_and_read_len_sets_the_end():
    s, _, _, _ = reference.nw_forward(enc("ACGT"), np.array([4]),
                                      enc("NNNNNNNN"), SC)
    assert s[0] < -1e29
    s, k, _, _ = reference.nw_forward(enc("ACGN"), np.array([3]),
                                      enc("ACGTTTTT"), SC)
    assert s[0] == 6 and k[0] == 0


def random_jobs(rng, B, L, W):
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    reads = refs[:, W // 2:W // 2 + L].copy()
    flip = rng.random((B, L)) < 0.05
    reads[flip] = (reads[flip] + 1) % 4
    reads[rng.random((B, L)) < 0.01] = 4
    refs[rng.random((B, L + W)) < 0.003] = 4
    lens = rng.integers(L - 5, L + 1, B)
    return reads, lens, refs


def test_nw_matches_the_ports_plain_and_numpy_forward_bit_for_bit():
    from hla_la_tpu_torch.ops.banded_nw import (NWScoring, banded_nw_forward,
                                                banded_nw_plain)
    rng = np.random.default_rng(3)
    reads, lens, refs = random_jobs(rng, 96, 40, 12)
    ref = reference.nw_forward(reads, lens, refs, SC)
    plain = [t.numpy() for t in banded_nw_plain(
        torch.from_numpy(reads), torch.from_numpy(lens),
        torch.from_numpy(refs), SC)]
    host = banded_nw_forward(reads, lens, refs, NWScoring(), use_native=False)
    for got in (plain, host):
        assert np.array_equal(got[0], ref[0])
        assert np.array_equal(got[1], ref[1])
        assert np.array_equal(got[2], ref[2])
        rows = np.arange(41)[None, :, None]
        live = (rows >= 1) & (rows <= lens[:, None, None])
        assert not ((got[3] != ref[3]) & live).any()


def test_pair_diff_hand_case():
    L = np.array([[0.0], [1.0]], dtype=np.float32)
    acc = reference.pair_diff(L, rpad=2)
    one = 0.5 + math.log1p(math.exp(-1.0))
    assert acc[0, 1] == pytest.approx(one + math.log(2), rel=1e-12)
    assert acc[0, 0] == pytest.approx(2 * math.log(2), rel=1e-12)


def test_pair_diff_matches_the_ports_plain_version():
    from hla_la_tpu_torch.ops.pair_ll import pair_ll_diff_plain
    rng = np.random.default_rng(5)
    L = rng.normal(-60, 15, (70, 300)).astype(np.float32)
    acc, rpad = pair_ll_diff_plain(torch.from_numpy(L))
    ref = reference.pair_diff(L, rpad, cells=1e5)
    assert np.abs(acc.numpy() - ref).max() / np.abs(ref).max() < 1e-6


def test_control_one_precision_below_reads_far_wider():
    rng = np.random.default_rng(6)
    L = rng.normal(-60, 15, (40, 500)).astype(np.float32)
    exact = reference.pair_diff(L, 512)
    cap = [{"L": L, "acc": exact.astype(np.float32), "rpad": 512,
            "tile_range": None}]
    assert check.k3_rel_gap(cap) < 1e-6
    ctl = check.control([], cap, [])
    assert ctl["k3_rel_gap"] > 1e-3


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                  1.0 + 3 * 2.0 ** -11, -3.0 - 2.0 ** -12], dtype=np.float32)
    assert reference.tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0,
                                          1.0 + 2.0 ** -9, -3.0]


def _gemm_case(rng, C=30, R=80, J=50):
    onehot = np.zeros((C, J, 6), dtype=np.float32)
    onehot[np.arange(C)[:, None], np.arange(J)[None, :],
           rng.integers(0, 6, (C, J))] = 1.0
    contrib = rng.normal(-3.0, 2.0, (R, J, 6)).astype(np.float32)
    mismatch = (rng.random((R, J, 6)) < 0.3).astype(np.float32)
    return onehot, contrib, mismatch


def test_cluster_ll_hand_case_and_the_ports_gemm():
    from hla_la_tpu_torch.ops.pair_ll import cluster_read_ll
    onehot = np.zeros((2, 2, 6), dtype=np.float32)
    onehot[0, 0, 1] = onehot[0, 1, 4] = onehot[1, 0, 0] = onehot[1, 1, 4] = 1
    rows = np.arange(12, dtype=np.float32).reshape(1, 2, 6)
    assert reference.cluster_ll(onehot, rows).tolist() == [[1 + 10],
                                                           [0 + 10]]
    rng = np.random.default_rng(8)
    onehot, contrib, mismatch = _gemm_case(rng)
    LL, MM = cluster_read_ll(onehot, contrib, mismatch, "cpu")
    cap = [{"onehot": onehot, "contrib": contrib, "mismatch": mismatch,
            "LL": LL, "MM": MM}]
    assert check.ll_rel_gap(cap) < 1e-6
    ctl = check.control([], [], [], ll=cap)
    assert ctl["ll_rel_gap"] > 1e-5
    bad = dict(cap[0], onehot=onehot * 2)
    assert check.ll_rel_gap([bad]) >= 1.0


def test_calls_wrong_counts_loci_without_both_planted_alleles():
    truth = {"A": ["A*01:01", "A*02:01"], "B": ["B*03:01", "B*04:01"]}
    called = {"A": ["A*02:01", "A*01:01;A*09:01"], "B": ["B*03:01",
                                                         "B*05:01"]}
    assert check.calls_wrong([{"truth": truth, "called": called}]) == 1
    assert check.calls_wrong([{"truth": truth, "called": {}}]) == 2
