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


def padded_jobs(rng, B, L, W):
    """random_jobs with ref pads at a window's start and end, as windows
    off a haplotype's ends have, and some reads shorter than L."""
    reads, lens, refs = random_jobs(rng, B, L, W)
    refs[0, :W // 2 + 3] = 4
    refs[1, L // 2:] = 4
    lens[2] = L // 3
    return reads, lens, refs


def same_forward(a, b, lens):
    L = a[3].shape[1] - 1
    rows = np.arange(L + 1)[None, :, None]
    live = (rows >= 1) & (rows <= np.asarray(lens)[:, None, None])
    return (all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
            and not ((a[3] != b[3]) & live).any())


@pytest.mark.parametrize("W", [3, 10, 31, 32, 33, 100, 256])
def test_wide_nw_is_the_step_by_step_forward_bit_for_bit(W):
    rng = np.random.default_rng(W)
    reads, lens, refs = padded_jobs(rng, 12, 60, W)
    assert same_forward(reference.nw_forward_wide(reads, lens, refs, SC),
                        reference.nw_forward(reads, lens, refs, SC), lens)
    # float32 past 256 too: K1's reads of 150 and K2's rows
    long = padded_jobs(rng, 6, 180, W)
    assert same_forward(reference.nw_forward_wide(*long, SC),
                        reference.nw_forward(*long, SC), long[1])
    # bfloat16 under 256, where it holds every integer: each sum rounded
    # as PyTorch's bfloat16 arithmetic rounds it
    assert same_forward(
        reference.nw_forward_wide(reads, lens, refs, SC, "bfloat16"),
        reference.nw_forward(reads, lens, refs, SC, dtype=torch.bfloat16),
        lens)


def test_wide_nw_matches_the_ports_plain_version_at_long_reads_band():
    from hla_la_tpu_torch.ops.banded_nw import banded_nw_plain
    rng = np.random.default_rng(11)
    reads, lens, refs = padded_jobs(rng, 6, 300, 256)
    plain = [t.numpy() for t in banded_nw_plain(
        torch.from_numpy(reads), torch.from_numpy(lens),
        torch.from_numpy(refs), SC)]
    assert same_forward(reference.nw_forward_wide(reads, lens, refs, SC),
                        plain, lens)


def captured_k2(reads, lens, refs, out):
    """Jobs as probes.Capture.take_k2 keeps them: live rows only."""
    W = refs.shape[1] - reads.shape[1]
    return [{"reads": reads[b, :n], "len": int(n), "refs": refs[b, :n + W],
             "scoring": SC, "score": float(out[0][b]),
             "end_k": int(out[1][b]), "end_state": int(out[2][b]),
             "pointers": out[3][b, :n + 1]} for b, n in enumerate(lens)]


def test_k2_jobs_differ_counts_jobs_and_the_control_fails_long_reads():
    rng = np.random.default_rng(12)
    reads, lens, refs = padded_jobs(rng, 5, 700, 256)
    out = reference.nw_forward(reads, lens, refs, SC)
    jobs = captured_k2(reads, lens, refs, out)
    found = check.numbers([], [], [], k2=jobs)
    assert (found["k2_jobs_differ"], found["k2_jobs_compared"]) == (0, 5)
    assert found["k1_jobs_compared"] == 0
    jobs[3] = dict(jobs[3], score=jobs[3]["score"] + 2)
    ptr = jobs[4]["pointers"].copy()
    ptr[lens[4], 7] ^= 8                   # the last live row
    jobs[4] = dict(jobs[4], pointers=ptr)
    assert check.nw_jobs_differ(check._k2_batches(jobs)) == (2, 5)
    # scores past 256 are not integers in bfloat16
    assert out[0][3:].max() > 256
    ctl = check.control([], [], [], k2=captured_k2(reads, lens, refs, out))
    assert ctl["k2_jobs_compared"] == 5 and ctl["k2_jobs_differ"] >= 3


def test_k1_and_k2_jobs_go_through_one_comparison():
    """K1's batches and K2's padded ones give the same verdicts on the
    same jobs."""
    rng = np.random.default_rng(13)
    reads, lens, refs = padded_jobs(rng, 6, 150, 31)
    out = reference.nw_forward(reads, lens, refs, SC)
    score = out[0].copy()
    score[4] += 2                          # an alignable job
    k1 = [{"reads": reads, "lens": lens.astype(np.int64), "refs": refs,
           "scoring": SC, "score": score, "end_k": out[1],
           "end_state": out[2], "pointers": out[3]}]
    k2 = captured_k2(reads, lens, refs, (score, *out[1:]))
    assert check.nw_jobs_differ(check._k1_batches(k1)) == (1, 6)
    assert check.nw_jobs_differ(check._k2_batches(k2)) == (1, 6)


def test_judge_holds_a_cell_to_the_numbers_its_limits_name():
    found = {"k1_jobs_differ": 0, "k1_jobs_compared": 0,
             "k2_jobs_differ": 0, "k2_jobs_compared": 16,
             "ll_rel_gap": 1e-7, "ll_calls_compared": 6,
             "k3_rel_gap": 1e-7, "k3_launches_compared": 2,
             "calls_wrong": 0, "loci_compared": 17}
    long_limits = {"k2_jobs_differ": 0, "ll_rel_gap": 1e-5,
                   "k3_rel_gap": 1e-4, "calls_wrong": 0}
    ok, rows = check.judge(found, long_limits)
    assert ok and [r[0] for r in rows] == list(long_limits)
    # K1 named, but no K1 job captured: nothing compared, not correct
    assert not check.judge(found, {**long_limits, "k1_jobs_differ": 0})[0]
    assert not check.judge(dict(found, k2_jobs_compared=0), long_limits)[0]
    assert not check.judge(dict(found, k2_jobs_differ=1), long_limits)[0]
    # K1 jobs captured in a run whose limits leave K1 out: not judged, so
    # not correct
    assert not check.judge(dict(found, k1_jobs_compared=64), long_limits)[0]
    assert not check.judge(found, {k: v for k, v in long_limits.items()
                                   if k != "k3_rel_gap"})[0]
    assert not check.judge(found, {})[0]
    with pytest.raises(ValueError):
        check.judge(found, {"k4_jobs_differ": 0})
