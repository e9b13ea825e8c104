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
from hla_la_tpu_torch.ops.pair_ll import (PAIR_TILE, PLAIN_CELLS,
                                          cluster_read_ll,
                                          pair_ll_diff_plain,
                                          pair_ll_reduction,
                                          pair_min_mismatch_row, pair_tiles,
                                          plain_chunk)

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


@pytest.mark.parametrize("C,R", [(13, 101), (150, 300), (200, 77)])
def test_plain_tile_ranges_sum_to_the_whole_exactly(C, R):
    """The plain version with K3's tile-range argument: the ranges that 2,
    3 and 4 model ranks take (one of them possibly empty) sum to the whole
    tile list's matrix bit for bit, which is the matrix of the call without
    a range; each range writes only its tiles and their mirrors."""
    L = torch.from_numpy(np.random.default_rng(C).normal(
        -30, 6, (C, R)).astype(np.float32))
    n = pair_tiles(C)
    assert n == (-(-C // PAIR_TILE)) * (-(-C // PAIR_TILE) + 1) // 2
    whole, rpad = pair_ll_diff_plain(L, tile_range=(0, n))
    assert torch.equal(whole, pair_ll_diff_plain(L)[0])
    assert torch.equal(whole, whole.T)
    for ranks in (2, 3, 4):
        total = torch.zeros_like(whole)
        touched = torch.zeros_like(whole)
        for j in range(ranks):
            lo, hi = n * j // ranks, n * (j + 1) // ranks
            part, rp = pair_ll_diff_plain(L, tile_range=(lo, hi - lo))
            assert rp == rpad
            total += part
            touched += (part != 0).float()
        assert torch.equal(total, whole)
        assert touched.max() == 1       # no cell in two ranges
    empty, _ = pair_ll_diff_plain(L, tile_range=(n, 0))
    assert not empty.any()
    for bad in ((-1, 1), (0, n + 1), (n, 1)):
        with pytest.raises(ValueError, match="tile range"):
            pair_ll_diff_plain(L, tile_range=bad)


# ------------------------------------------------------------ pair epilogue
def _parent_pairs(pair_LL, MM):
    """The typer's pair step as it stood before pair_epilogue: the
    triangle, the posterior, the marginals, best1 and best2, and the
    dump's columns by np.lexsort, all on the host."""
    C = MM.shape[0]
    iu = np.triu_indices(C)
    pair_vals = pair_LL[iu]
    max_ll = float(pair_vals.max()) if len(pair_vals) else 0.0
    P = np.exp(pair_vals - max_ll)
    s = P.sum()
    P = P / s if s > 0 else np.full_like(P, 1.0 / len(P))
    marg = np.zeros(C)
    np.add.at(marg, iu[0], P)
    sec = iu[1] != iu[0]
    np.add.at(marg, iu[1][sec], P[sec])
    best1 = int(np.argmax(marg))
    c2s = np.arange(C)
    a, b = np.minimum(best1, c2s), np.maximum(best1, c2s)
    cand_P = P[a * C - (a * (a - 1)) // 2 + (b - a)]
    best2_p = float(cand_P.max())
    mm_min_row = pair_min_mismatch_row(MM, best1)
    tie = np.nonzero(cand_P == best2_p)[0]
    best2 = int(tie[np.argmax(-mm_min_row[tie])])
    mrs = MM.sum(axis=1)
    mism_avg = 0.5 * (mrs[iu[0]] + mrs[iu[1]])
    order = np.lexsort((mism_avg, -pair_vals))
    return {"a": iu[0][order], "b": iu[1][order], "P_o": P[order],
            "LL_o": pair_vals[order], "MM_o": mism_avg[order],
            "pair_vals": pair_vals, "marg": marg, "best1": best1,
            "best2": best2, "q1": (float(marg[best1]), best2_p),
            "q2": float(-mm_min_row[best2])}


def _epilogue_case(name):
    """(L, MM, K3's difference term or None): None runs the plain version,
    an array stands in for it, for inputs whose plain run is long."""
    rng = np.random.default_rng(len(name))
    if name == "c520":
        L = rng.normal(-40, 8, (520, 120)).astype(np.float32)
        MM = rng.integers(0, 6, (520, 120)).astype(np.float32)
        return L, MM, None
    if name == "c2200_tied":
        # IMGT clusters: many identical rows, so that nearly every pair
        # value is tied and the order rests on Mismatches_avg (rows tied
        # apart from the LL rows') and the triangle index; the difference
        # term of the 40 distinct rows, spread to their copies
        base = rng.integers(0, 40, 2200)
        Ld = rng.normal(-35, 2, (40, 180)).astype(np.float32)
        MMd = rng.integers(0, 3, (40, 180)).astype(np.float32)
        acc, _ = pair_ll_diff_plain(torch.from_numpy(Ld))
        return (Ld[base], MMd[rng.integers(0, 40, 2200)],
                acc[base][:, base])
    if name == "c1":
        return (rng.normal(-30, 5, (1, 50)).astype(np.float32),
                np.ones((1, 50), np.float32), None)
    if name == "all_equal":
        return (np.full((37, 64), -12.5, np.float32),
                np.zeros((37, 64), np.float32), None)
    assert name == "no_reads"
    return np.zeros((9, 0), np.float32), np.zeros((9, 0), np.float32), None


@pytest.mark.parametrize("case", ["c520", "c2200_tied", "c1", "all_equal",
                                  "no_reads"])
def test_pair_epilogue_card_steps_match_the_host_bit_for_bit(case,
                                                             monkeypatch):
    """The card route's PyTorch steps, run on CPU tensors with K3's plain
    version standing in, against the host route and the typer's pair step
    as it was: the dump's columns, order and bytes, the triangle's values,
    the marginals, best1, best2, Q1 and Q2, all bit for bit."""
    from hla_la_tpu_torch import native
    from hla_la_tpu_torch.ops import pair_ll as port_pair
    L, MM, acc = _epilogue_case(case)
    C, R = L.shape
    if acc is not None:
        real = port_pair._pair_ll_diff
        chunk = plain_chunk(C, R)
        rpad = -(-R // chunk) * chunk
        monkeypatch.setattr(port_pair, "_pair_ll_diff",
                            lambda t: (acc, rpad) if t.shape == (C, R)
                            else real(t))
    want = _parent_pairs(pair_ll_reduction(L, "cpu"), MM)
    mrs = MM.sum(axis=1)
    calls = port_pair.pair_epilogue.card_calls
    host = port_pair.pair_epilogue(L, mrs, "cpu")
    card = port_pair._pair_epilogue_card(L, mrs, torch.device("cpu"))
    assert port_pair.pair_epilogue.card_calls == calls
    ids = [f"c{i};x{i % 7}".encode() for i in range(C)]
    dumps = set()
    for got in (host, card):
        a, b, LL_o, MM_o, pair_vals = got
        assert (a.dtype, b.dtype, LL_o.dtype, MM_o.dtype, pair_vals.dtype) \
            == (np.int32, np.int32, np.float64, np.float32, np.float64)
        for k, v in zip(("a", "b", "LL_o", "MM_o", "pair_vals"), got):
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        post = port_pair.pair_posterior(pair_vals, LL_o, MM)
        assert post.P_o.tobytes() == want["P_o"].tobytes()
        assert post.marg.tobytes() == want["marg"].tobytes()
        assert (post.best1, post.best2) == (want["best1"], want["best2"])
        assert (float(post.marg[post.best1]), post.best2_p) == want["q1"]
        assert float(-post.mm_min_row[post.best2]) == want["q2"]
        dumps.add(native.format_pairs(a, b, post.P_o, LL_o, MM_o, ids))
    assert dumps == {native.format_pairs(want["a"], want["b"], want["P_o"],
                                         want["LL_o"], want["MM_o"], ids)}
    assert None not in dumps and len(next(iter(dumps)).splitlines()) == \
        C * (C + 1) // 2


@pytest.mark.parametrize("route", ["cpu", "served", "sharded", "card"])
def test_pair_epilogue_dispatch(route, monkeypatch):
    """Only a process that owns a CUDA device keeps K3's output on the
    card: a CPU device, a served typer (the device server's reduction) and
    a mesh's ranks take the host route."""
    from hla_la_tpu_torch.ops import pair_ll as port_pair
    L = np.random.default_rng(3).normal(-30, 5, (6, 20)).astype(np.float32)
    mrs = np.arange(6, dtype=np.float32)
    seen = []

    def reduction(L, device, sharded=None):
        seen.append((device, sharded))
        return pair_ll_reduction(L, "cpu")

    monkeypatch.setattr(port_pair, "pair_ll_reduction", reduction)
    monkeypatch.setattr(port_pair, "resolve", torch.device)
    monkeypatch.setattr(port_pair, "_pair_epilogue_card",
                        lambda L, m, dev: ("card", dev))
    device, kw = {"cpu": ("cpu", {}),
                  "served": ("cuda", {"reduce": reduction}),
                  "sharded": ("cuda", {"sharded": "mesh"}),
                  "card": ("cuda:0", {})}[route]
    calls = port_pair.pair_epilogue.card_calls
    got = port_pair.pair_epilogue(L, mrs, device, **kw)
    on_card = port_pair.epilogue_on_card(device, kw.get("sharded"),
                                         kw.get("reduce"))
    assert on_card == (route == "card")
    assert port_pair.pair_epilogue.card_calls == calls + on_card
    if on_card:
        assert got == ("card", torch.device("cuda:0")) and seen == []
    else:
        assert seen == [(device, kw.get("sharded"))] and len(got) == 5
